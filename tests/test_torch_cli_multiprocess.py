"""Both multi-process lanes of the port's CLI, on the CPU, in subprocesses
(each waited on with a timeout; the transports' deadlines are short, so a
hung peer fails the test instead of holding the run):

* the shard lane — two ``randomForestBuilder`` processes under
  ``AVENIR_TPU_SHARD=i/2`` and a file transport over the rafo9s fixture's
  CSV and keys write the fixture's trees, and shard 0 its registry version
  (JSON bytes, npz arrays); the quarantine files and ``BadRecords``
  counters add up to the fixture's; each pays the collectives the JAX
  package's shard lane pays for the same job;
* the joined run — two gloo ranks from torchrun's environment: the
  streamed sharded forest gives the same trees with the counters summed,
  and ``modelPredictor`` over two halves of the rafo9 requests writes
  ``part-m-00000`` and ``part-m-00001``, which concatenate to the
  single-process output;
* the input rules of a joined run: the gather spool for distinct inputs
  and none for an identical one;
* the refusals: ``dtb.streaming.shard=on`` without a multi-shard run, a
  shard count above 1 with no transport, a missing peer past the deadline
  (non-zero exit), the per-level builder and the monolithic forest under
  ``AVENIR_TPU_SHARD``, and in a joined run the ``refuse`` jobs, a gather
  job whose peer failed to read or was given no input, identical inputs
  to a ``map`` job and distinct ones to the row-range sharded build."""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from avenir_tpu_torch.cli import jobs as pjobs
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core.config import Config
from avenir_tpu_torch.parallel import distributed as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
PROPS = os.path.join(RES, "rafo.properties")
SCHEMA = os.path.join(RES, "call_hangup.json")
RAFO9 = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9")
RAFO9S = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9s")
VERSION = os.path.join("rafo9s", "v_000001")
STREAM_KEYS = ("-Ddtb.streaming.ingest=true",
               "-Ddtb.streaming.block.rows=777",
               "-Ddtb.streaming.checkpoint.blocks=2",
               "-Dbadrecords.policy=quarantine",
               "-Ddtb.model.quantize=true", "-Ddtb.baseline.publish=true")
LANE_KEYS = ("AVENIR_TPU_SHARD", "AVENIR_TPU_ALLREDUCE_DIR", "RANK",
             "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _env(extra):
    env = {k: v for k, v in os.environ.items() if k not in LANE_KEYS}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["AVENIR_TPU_ALLREDUCE_TIMEOUT_S"] = "60"
    env.update(extra)
    return env


def _run_all(cmds, timeout=240):
    """Start every (argv, env) at once and drain each on its own thread (a
    peer blocked on a full pipe would stall the collectives); return their
    (returncode, stdout, stderr).  A process past ``timeout`` is killed
    and the test fails."""
    procs = [subprocess.Popen(argv, env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv, env in cmds]
    out = [None] * len(procs)

    def wait(i, p):
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out[i] = (p.returncode, so, se)
    waiters = [threading.Thread(target=wait, args=(i, p))
               for i, p in enumerate(procs)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    return out


def _dump(stdout):
    """The Hadoop-style counter dump a job printed, as {group: {name: v}}."""
    groups, cur = {}, None
    for line in stdout.splitlines():
        if line.startswith("\t") and cur is not None and "=" in line:
            k, _, v = line.strip().partition("=")
            groups[cur][k] = int(v)
        elif line and not line.startswith(("\t", "[")):
            cur = line.strip()
            groups.setdefault(cur, {})
    return groups


def _rafo9s_cli(package, reg, ck, out, extra=()):
    return [sys.executable, "-m", f"{package}.cli.run",
            "org.avenir.tree.RandomForestBuilder", f"-Dconf.path={PROPS}",
            f"-Ddtb.feature.schema.file.path={SCHEMA}",
            f"-Ddtb.model.registry.dir={reg}", "-Ddtb.model.name=rafo9s",
            f"-Ddtb.streaming.checkpoint.dir={ck}", *STREAM_KEYS, *extra,
            os.path.join(RAFO9S, "train.csv"), out]


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


def _same_rafo9s(out, reg=None):
    for t in range(9):
        assert _read(os.path.join(out, f"tree_{t}.json")) == \
            _read(os.path.join(RAFO9S, f"tree_{t}.json")), (out, t)
    if reg is None:
        return
    for f in ("meta.json", "baseline.json", "quantized.json"):
        assert _read(os.path.join(reg, VERSION, f), "rb") == \
            _read(os.path.join(RAFO9S, "registry", VERSION, f), "rb"), f
    for f in ("arrays.npz", "baseline.npz", "quantized.npz"):
        with np.load(os.path.join(reg, VERSION, f)) as got, \
                np.load(os.path.join(RAFO9S, "registry", VERSION, f)) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_shard_lane_over_rafo9s_reproduces_the_fixture(tmp_path):
    reg, ck = str(tmp_path / "reg"), str(tmp_path / "ck")
    rdir = str(tmp_path / "reduce")
    res = _run_all([
        (_rafo9s_cli("avenir_tpu_torch", reg, ck, str(tmp_path / f"out{i}"),
                     ("-Dplatform=cpu",)),
         _env({"AVENIR_TPU_SHARD": f"{i}/2",
               "AVENIR_TPU_ALLREDUCE_DIR": rdir}))
        for i in range(2)])
    for rc, _, se in res:
        assert rc == 0, se[-3000:]
    dumps = [_dump(so) for _, so, _ in res]
    for i in range(2):
        _same_rafo9s(str(tmp_path / f"out{i}"))
    _same_rafo9s(str(tmp_path / "out0"), reg)
    quarantined = "".join(
        _read(str(tmp_path / f"out{i}" / "_quarantine" / "part-q-00000"))
        for i in range(2))
    assert quarantined == _read(os.path.join(RAFO9S, "part-q-00000"))
    want = json.loads(_read(os.path.join(RAFO9S, "train_counters.json")))
    for name, total in want["BadRecords"].items():
        assert sum(d["BadRecords"][name] for d in dumps) == total
    assert dumps[0]["Random forest"] == want["Random forest"]
    assert dumps[0]["Shard"] == {"Count": 2} and "Shard" not in dumps[1]
    assert "RegistryVersion" not in dumps[1]["Random forest"]
    # per shard: 4 levels (depth 4) + the row-count and baseline allgathers
    assert dumps[0]["Collectives"]["AllReduces"] == \
        dumps[1]["Collectives"]["AllReduces"] == 6
    # shard 0 alone persists counters.json; per-shard checkpoint dirs
    assert os.path.exists(str(tmp_path / "out0") + ".counters.json")
    assert not os.path.exists(str(tmp_path / "out1") + ".counters.json")
    assert sorted(os.listdir(ck)) == ["shard-0-of-2", "shard-1-of-2"]


TINY_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "c1", "ordinal": 1, "dataType": "categorical", "feature": True,
     "maxSplit": 2, "cardinality": ["a", "b", "c"]},
    {"name": "n1", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 600, "splitScanInterval": 150},
    {"name": "cls", "ordinal": 3, "dataType": "categorical",
     "cardinality": ["T", "F"]}]}


def test_shard_lane_pays_the_reference_collectives(tmp_path):
    """The same small job (400 rows, 100-row blocks, depth 3, a published
    baseline) through both packages' shard lanes: the same trees, and each
    process's Collectives.AllReduces equal to the JAX package's."""
    rng = np.random.default_rng(3)
    lines = []
    for i in range(400):
        c = ["a", "b", "c"][rng.integers(0, 3)]
        v = int(rng.integers(0, 600))
        lines.append(f"r{i},{c},{v},{'T' if (v > 300) ^ (c == 'c') else 'F'}")
    csv = tmp_path / "d.csv"
    csv.write_text("\n".join(lines) + "\n")
    schema = tmp_path / "s.json"
    schema.write_text(json.dumps(TINY_SCHEMA))
    props = tmp_path / "rf.properties"
    props.write_text(
        "field.delim.regex=,\nfield.delim.out=,\n"
        f"dtb.feature.schema.file.path={schema}\n"
        "dtb.num.trees=3\ndtb.random.seed=7\n"
        "dtb.max.depth.limit=3\ndtb.path.stopping.strategy=maxDepth\n"
        "dtb.streaming.ingest=true\ndtb.streaming.block.rows=100\n"
        "dtb.baseline.publish=true\ndtb.model.name=tiny\n")
    cmds = []
    for pkg in ("avenir_tpu_torch", "avenir_tpu"):
        for i in range(2):
            extra = {"AVENIR_TPU_SHARD": f"{i}/2",
                     "AVENIR_TPU_ALLREDUCE_DIR": str(tmp_path / f"r_{pkg}")}
            if pkg == "avenir_tpu":
                extra.update(JAX_PLATFORMS="cpu", XLA_FLAGS="")
            cmds.append(([sys.executable, "-m", f"{pkg}.cli.run",
                          "randomForestBuilder", f"-Dconf.path={props}",
                          "-Dplatform=cpu", "-Ddtb.streaming.shard=on",
                          f"-Ddtb.model.registry.dir={tmp_path}/reg_{pkg}",
                          str(csv), str(tmp_path / f"o_{pkg}{i}")],
                         _env(extra)))
    res = _run_all(cmds)
    for rc, _, se in res:
        assert rc == 0, se[-3000:]
    counts = [_dump(so)["Collectives"]["AllReduces"] for _, so, _ in res]
    assert counts == [5, 5, 5, 5]       # 3 levels + 2 allgathers
    for i in range(2):
        for t in range(3):
            assert _read(str(tmp_path / f"o_avenir_tpu_torch{i}" /
                              f"tree_{t}.json")) == \
                _read(str(tmp_path / f"o_avenir_tpu{i}" / f"tree_{t}.json"))
    base = os.path.join("tiny", "v_000001", "baseline.json")
    assert _read(str(tmp_path / "reg_avenir_tpu_torch" / base)) == \
        _read(str(tmp_path / "reg_avenir_tpu" / base))


def _joined(i, port, extra=None):
    return _env({"RANK": str(i), "WORLD_SIZE": "2", "LOCAL_RANK": str(i),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 **(extra or {})})


def test_joined_run_streamed_forest_and_predictor_parts(tmp_path):
    """Two gloo ranks: the row-range sharded rafo9s build (the counters
    summed over the ranks), then modelPredictor over two halves of the
    rafo9 requests into one output dir."""
    reg, ck = str(tmp_path / "reg"), str(tmp_path / "ck")
    port = _free_port()
    res = _run_all([
        (_rafo9s_cli("avenir_tpu_torch", reg, ck, str(tmp_path / f"out{i}"),
                     ("-Dplatform=cpu",)), _joined(i, port))
        for i in range(2)])
    for rc, _, se in res:
        assert rc == 0, se[-3000:]
    for i in range(2):
        _same_rafo9s(str(tmp_path / f"out{i}"))
    _same_rafo9s(str(tmp_path / "out0"), reg)
    dump = _dump(res[0][1])
    assert _dump(res[1][1]) == {}            # process 0 alone prints
    want = json.loads(_read(os.path.join(RAFO9S, "train_counters.json")))
    assert dump["BadRecords"] == want["BadRecords"]
    assert dump["Shard"] == {"Count": 2}
    assert dump["Collectives"]["AllReduces"] == 2 * 6   # summed over ranks

    requests = _read(os.path.join(RAFO9, "requests.csv")).splitlines(True)
    halves = [requests[:777], requests[777:]]
    for i, part in enumerate(halves):
        (tmp_path / f"req{i}.csv").write_text("".join(part))
    out = str(tmp_path / "pred")
    port = _free_port()
    res = _run_all([
        ([sys.executable, "-m", "avenir_tpu_torch.cli.run", "modelPredictor",
          f"-Dconf.path={PROPS}", f"-Dmop.model.dir.path={RAFO9}",
          f"-Dmop.feature.schema.file.path={SCHEMA}", "-Dplatform=cpu",
          str(tmp_path / f"req{i}.csv"), out], _joined(i, port))
        for i in range(2)])
    for rc, _, se in res:
        assert rc == 0, se[-3000:]
    assert sorted(os.listdir(out)) == ["part-m-00000", "part-m-00001"]
    assert _read(os.path.join(out, "part-m-00000")) + \
        _read(os.path.join(out, "part-m-00001")) == \
        _read(os.path.join(RAFO9, "pred.csv"))


def test_missing_peer_fails_with_a_non_zero_exit(tmp_path):
    """Shard 1 of 2 never starts: shard 0 exits non-zero within its 2 s
    deadline, naming the transport step it waited on."""
    res = _run_all([(
        _rafo9s_cli("avenir_tpu_torch", str(tmp_path / "reg"),
                    str(tmp_path / "ck"), str(tmp_path / "out0"),
                    ("-Dplatform=cpu",)),
        _env({"AVENIR_TPU_SHARD": "0/2",
              "AVENIR_TPU_ALLREDUCE_DIR": str(tmp_path / "r"),
              "AVENIR_TPU_ALLREDUCE_TIMEOUT_S": "2"}))], timeout=120)
    rc, _, se = res[0]
    assert rc != 0 and "within 2.0s" in se, se[-3000:]


def test_refusals_without_a_multi_shard_run(tmp_path, monkeypatch):
    for k in LANE_KEYS:
        monkeypatch.delenv(k, raising=False)
    csv = os.path.join(RAFO9S, "train.csv")
    base = {"dtb.feature.schema.file.path": SCHEMA, "dtb.num.trees": "1",
            "dtb.streaming.ingest": "true"}
    with pytest.raises(ValueError, match="multi-shard"):
        pjobs.random_forest_builder(
            Config(dict(base, **{"dtb.streaming.shard": "on"})), csv,
            str(tmp_path / "o"))
    # a shard count above 1 with no transport: the reducer refuses
    monkeypatch.setenv("AVENIR_TPU_SHARD", "0/2")
    with pytest.raises(ValueError, match="never combine"):
        pjobs.random_forest_builder(Config(dict(base)), csv,
                                    str(tmp_path / "o"))
    # and a path with no form on the lane refuses, naming the lane
    with pytest.raises(pjobs.JobNotPorted,
                       match="shard lane .AVENIR_TPU_SHARD=0/2"):
        pjobs.random_forest_builder(
            Config(dict(base, **{"dtb.streaming.shard": "off"})), csv,
            str(tmp_path / "o"))
    with pytest.raises(pjobs.JobNotPorted, match="AVENIR_TPU_SHARD=0/2"):
        pjobs.random_forest_builder(
            Config(dict(base, **{"dtb.streaming.ingest": "false"})), csv,
            str(tmp_path / "o"))
    with pytest.raises(pjobs.JobNotPorted, match="AVENIR_TPU_SHARD=0/2"):
        port_run.main(["decisionTreeBuilder",
                       f"-Dconf.path={os.path.join(RES, 'detr.properties')}",
                       f"-Ddtb.feature.schema.file.path={SCHEMA}",
                       "-Dplatform=cpu", csv, str(tmp_path / "dt")])
    assert not os.path.exists(tmp_path / "o")


@pytest.fixture()
def joined(monkeypatch):
    """A two-process joined run as ``cli.run`` sees it: the process
    identity and the allgather patched, the peer's digest chosen by the
    test (``peer[0]``: "same" or "other")."""
    peer = ["same"]
    monkeypatch.setattr(D, "is_multiprocess", lambda: True)
    def gather(obj):
        if peer[0] == "same" or not isinstance(obj[1], str):
            return [obj, obj]
        return [obj, (obj[0], "other")]
    monkeypatch.setattr(D, "allgather_object", gather)
    return peer


@pytest.mark.parametrize("job", ["sameTypeSimilarity", "nearestNeighbor"])
def test_joined_run_refuses_gather_jobs(joined, tmp_path, job, monkeypatch):
    """A gather job refuses on every process when the processes disagree
    on whether an input was given, or when a peer fails to read its
    input: none spools a partial view or waits in a collective."""
    fn = pjobs.resolve(job)
    assert pjobs.dist_mode(fn) == "gather"
    monkeypatch.setattr(D, "allgather_object",
                        lambda obj: [obj, (False, "")])
    with pytest.raises(RuntimeError, match="disagree"):
        port_run._apply_dist_mode(fn, job, str(tmp_path), Config())
    (tmp_path / "shard.csv").write_text("a\n")

    def peer_fails(obj):
        if isinstance(obj[1], str):            # the digest exchange
            return [obj, (True, "peer-digest")]
        return [obj, ("process 1: OSError: file vanished", [])]
    monkeypatch.setattr(D, "allgather_object", peer_fails)
    monkeypatch.setattr(port_run.tempfile, "mkdtemp", _no_spool)
    with pytest.raises(RuntimeError, match="1 process.*file vanished"):
        port_run._apply_dist_mode(fn, job, str(tmp_path / "shard.csv"),
                                  Config())


def _no_spool(*a, **k):
    raise AssertionError("a spool was made")


@pytest.mark.parametrize("job", ["sameTypeSimilarity", "nearestNeighbor",
                                 "groupedRecordSimilarity"])
def test_joined_gather_spools_distinct_inputs(joined, tmp_path, job,
                                              monkeypatch):
    """Distinct inputs: every process's files, read as bytes, in a spool
    directory of ``<basename>.p<process>`` files (the train prefix kept);
    an identical input is used as it is, with no spool."""
    fn = pjobs.resolve(job)
    assert pjobs.dist_mode(fn) == "gather"
    indir = tmp_path / "in"
    indir.mkdir()
    (indir / "tr-part").write_bytes(b"a\n\xff\n")
    (indir / "test").write_text("c\n")
    assert port_run._apply_dist_mode(fn, job, str(indir), Config()) == \
        (str(indir), None)

    def peer_differs(obj):
        if isinstance(obj[1], str):
            return [obj, (True, "peer-digest")]
        return [obj, (None, [("tr-part", b"x\ny\n")])]
    monkeypatch.setattr(D, "allgather_object", peer_differs)
    monkeypatch.setattr(port_run.tempfile, "tempdir", str(tmp_path))
    spool, cleanup = port_run._apply_dist_mode(fn, job, str(indir), Config())
    assert spool == cleanup and os.path.dirname(spool) == str(tmp_path)
    assert sorted(os.listdir(spool)) == ["test.p0", "tr-part.p0",
                                         "tr-part.p1"]
    assert _read(os.path.join(spool, "tr-part.p0"), "rb") == b"a\n\xff\n"
    assert _read(os.path.join(spool, "tr-part.p1"), "rb") == b"x\ny\n"


@pytest.mark.parametrize("job", ["predictionService", "driftMonitor",
                                 "predictDriftScore"])
def test_joined_run_refuses_refuse_jobs(joined, tmp_path, job):
    fn = pjobs.resolve(job)
    assert pjobs.dist_mode(fn) == "refuse"
    with pytest.raises(RuntimeError, match="not multi-process safe"):
        port_run._apply_dist_mode(fn, job, str(tmp_path), Config())


def test_joined_run_input_rules(joined, tmp_path, monkeypatch):
    """map: identical inputs refused, distinct ones pass; the row-range
    sharded build: the reverse; partition: identical pass, distinct ones
    go through the spool."""
    csv = os.path.join(RAFO9S, "train.csv")
    mp = pjobs.resolve("modelPredictor")
    rf = pjobs.resolve("randomForestBuilder")
    knn = pjobs.resolve("knnPipeline")
    assert (pjobs.dist_mode(mp), pjobs.dist_mode(rf),
            pjobs.dist_mode(knn)) == ("map", "sharded", "partition")
    streamed = Config({"dtb.streaming.ingest": "true"})
    with pytest.raises(RuntimeError, match="IDENTICAL"):
        port_run._apply_dist_mode(mp, "modelPredictor", csv, Config())
    assert port_run._apply_dist_mode(rf, "rf", csv, streamed) == (csv, None)
    assert port_run._apply_dist_mode(knn, "knn", csv, Config()) == \
        (csv, None)
    joined[0] = "other"
    assert port_run._apply_dist_mode(mp, "modelPredictor", csv,
                                     Config()) == (csv, None)
    with pytest.raises(RuntimeError, match="DISTINCT"):
        port_run._apply_dist_mode(rf, "rf", csv, streamed)
    assert port_run._apply_dist_mode(
        rf, "rf", csv, Config({"dtb.streaming.ingest": "true",
                               "dtb.streaming.shard": "off"})) == (csv, None)
    monkeypatch.setattr(port_run.tempfile, "tempdir", str(tmp_path))
    spool, cleanup = port_run._apply_dist_mode(knn, "knn", csv, Config())
    assert spool == cleanup and os.path.dirname(spool) == str(tmp_path)
    # the patched peer sent this process's own files back
    assert sorted(os.listdir(spool)) == ["train.csv.p0", "train.csv.p1"]
    assert _read(os.path.join(spool, "train.csv.p1"), "rb") == \
        _read(csv, "rb")
