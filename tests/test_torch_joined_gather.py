"""The joined run's gather and partition jobs, on the CPU: two real gloo
ranks (torchrun's environment, each a subprocess waited on with a timeout)
against the JAX package's single-process job over the spool layout.

* ``sameTypeSimilarity``, ``nearestNeighbor`` and
  ``groupedRecordSimilarity`` over distinct per-rank inputs: each rank
  writes the output of one process over a directory that holds every
  rank's files as ``<basename>.p<rank>``, byte for byte;
* ``knnPipeline`` over distinct inputs: each rank classifies its slice of
  the spooled test rows, and the two part files concatenate to the single
  process's output; over an identical input, no spool is made;
* every spool is removed when its job ends, and a rank whose input read
  fails makes every rank fail;
* ``groupedRecordSimilarity`` in one process equals the JAX package's job,
  and every ported job keeps the JAX package's multi-process mode.
"""

import json
import os
import shutil
import sys

import pytest

from avenir_tpu.cli import jobs as jax_jobs
from avenir_tpu.cli import run as jax_run

from avenir_tpu_torch.cli import jobs as port_jobs
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.parallel import distributed as D
from tests.test_torch_cli_multiprocess import (_dump, _env, _free_port,
                                               _run_all)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
KNN_PROPS = os.path.join(RES, "knn.properties")
ELEARN = os.path.join(RES, "elearn.json")
GOLDEN_KNN = os.path.join(ROOT, "tests", "golden", "fixtures", "knn")
ELEARN_KNN = os.path.join(ROOT, "tests", "torch_fixtures", "elearn_knn")

# one joined process: its runs in order, each on its own rendezvous port;
# ``fail_reads`` makes the spool's file reads fail on this rank
WORKER = r"""
import json, os, sys
spec = json.load(open(sys.argv[1]))
if spec["fail_reads"]:
    from avenir_tpu_torch.parallel import distributed as D

    def _refuse(path, *args, **kwargs):
        raise OSError(f"injected read failure on {os.path.basename(path)}")
    D.open = _refuse
from avenir_tpu_torch.cli import run
for argv, port in spec["runs"]:
    os.environ["MASTER_PORT"] = str(port)
    try:
        rc = run.main(argv)
    except Exception as exc:
        print(f"JOB_ERROR {type(exc).__name__}: {exc}", flush=True)
        rc = 1
    print(f"JOB_RC {rc}", flush=True)
"""


def run_joined(tmp_path, runs, fail_reads=(False, False), timeout=180):
    """Two gloo ranks, rank i running ``runs[i]`` (lists of CLI argv, the
    same jobs in the same order on both ranks) with its own ``TMPDIR``
    (``tmp_path/tmp<i>``).  Returns each rank's (returncode, stdout,
    stderr, [each job's exit code])."""
    ports = [_free_port() for _ in runs[0]]
    cmds = []
    for i, argvs in enumerate(runs):
        spec = tmp_path / f"spec{i}.json"
        spec.write_text(json.dumps({"runs": [list(r) for r in
                                             zip(argvs, ports)],
                                    "fail_reads": fail_reads[i]}))
        tmp = tmp_path / f"tmp{i}"
        tmp.mkdir(exist_ok=True)
        cmds.append(([sys.executable, "-c", WORKER, str(spec)],
                     _env({"RANK": str(i), "WORLD_SIZE": "2",
                           "LOCAL_RANK": str(i), "MASTER_ADDR": "127.0.0.1",
                           "TMPDIR": str(tmp)})))
    out = []
    for rc, so, se in _run_all(cmds, timeout):
        rcs = [int(line.split()[1]) for line in so.splitlines()
               if line.startswith("JOB_RC ")]
        out.append((rc, so, se, rcs))
    return out


def _read(*parts):
    with open(os.path.join(*parts), "rb") as fh:
        return fh.read()


def _write_lines(path, lines):
    with open(path, "w") as fh:
        fh.write("".join(lines))


def _lines(path):
    with open(path) as fh:
        return fh.read().splitlines(True)


def _spool_layout(dest, per_rank):
    """A directory laid out as the spool: each file of rank r's input (a
    file, or a directory's files) as ``<basename>.p<r>``."""
    os.makedirs(dest)
    for rank, src in enumerate(per_rank):
        files = [os.path.join(src, b) for b in sorted(os.listdir(src))] \
            if os.path.isdir(src) else [src]
        for f in files:
            shutil.copy(f, os.path.join(dest,
                                        D.spool_name(os.path.basename(f),
                                                     rank)))
    return dest


def _sts(data, out):
    return ["sameTypeSimilarity", f"-Dconf.path={KNN_PROPS}",
            f"-Dsts.same.schema.file.path={ELEARN}", data, out]


def _nn(data, out):
    return ["nearestNeighbor", f"-Dconf.path={KNN_PROPS}", data, out]


def _grs(data, out):
    return ["groupedRecordSimilarity", f"-Dconf.path={KNN_PROPS}",
            f"-Dsts.same.schema.file.path={ELEARN}",
            "-Dgrs.group.field.ordinals=5", data, out]


def _knn(data, out):
    return ["knnPipeline", f"-Dconf.path={KNN_PROPS}",
            f"-Dsts.same.schema.file.path={ELEARN}", data, out]


JOBS = {"sts": _sts, "nn": _nn, "grs": _grs, "knn": _knn}


@pytest.fixture(scope="module")
def joined_gather(tmp_path_factory):
    """Each job over distinct per-rank inputs on two ranks, then
    knnPipeline over one input both ranks share; and each job in the JAX
    package over the spool layout of the ranks' inputs."""
    d = tmp_path_factory.mktemp("joined_gather")
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.elearn_gen import generate
    rows = [r + "\n" for r in generate(130, 14)]
    dist = _lines(os.path.join(GOLDEN_KNN, "dist.csv"))
    knn_train = _lines(os.path.join(ELEARN_KNN, "data", "tr_part"))
    knn_test = _lines(os.path.join(ELEARN_KNN, "data", "test_part"))
    inputs = {k: [] for k in JOBS}
    for i in range(2):
        sim = d / f"sim{i}"
        sim.mkdir()
        _write_lines(sim / "tr_part", rows[50 * i:50 * i + 50])
        _write_lines(sim / "test_part", rows[100 + 15 * i:115 + 15 * i])
        kp = d / f"kp{i}"
        kp.mkdir()
        _write_lines(kp / "tr_part", knn_train[1000 * i:1000 * i + 1000])
        _write_lines(kp / "test_part", knn_test[250 * i:250 * i + 250])
        half = len(dist) // 2
        _write_lines(d / f"nn{i}.csv", dist[:half] if i == 0
                     else dist[half:])
        # two groups of more than 32 rows (ROADMAP §C: smaller groups
        # of four numeric features take another order in the JAX package)
        _write_lines(d / f"grs{i}.csv", rows[50 * i:50 * i + 50])
        inputs["sts"].append(str(sim))
        inputs["nn"].append(str(d / f"nn{i}.csv"))
        inputs["grs"].append(str(d / f"grs{i}.csv"))
        inputs["knn"].append(str(kp))
    same = os.path.join(ELEARN_KNN, "data")
    res = run_joined(d, [
        [JOBS[k](inputs[k][i], str(d / f"{k}_out{i}")) + ["-Dplatform=cpu"]
         for k in JOBS]
        + [_knn(same, str(d / "knn_same")) + ["-Dplatform=cpu"]]
        for i in range(2)])
    want = {}
    for k, job in JOBS.items():
        spool = _spool_layout(str(d / f"{k}_spool"), inputs[k])
        assert jax_run.main(job(spool, str(d / f"{k}_jax"))) == 0
        want[k] = _read(d, f"{k}_jax", "part-r-00000")
    return d, res, want


def test_both_ranks_ran_every_job(joined_gather):
    _, res, _ = joined_gather
    for rc, _, se, rcs in res:
        assert rc == 0 and rcs == [0] * 5, se[-3000:]


@pytest.mark.parametrize("job", ["sts", "nn", "grs"])
@pytest.mark.parametrize("rank", [0, 1])
def test_gather_job_writes_the_spool_layouts_output(joined_gather, job,
                                                   rank):
    d, _, want = joined_gather
    assert sorted(os.listdir(d / f"{job}_out{rank}")) == ["part-r-00000"]
    assert _read(d, f"{job}_out{rank}", "part-r-00000") == want[job]


def test_gather_outputs_are_the_golden_knn_files(joined_gather):
    """The ranks' inputs are the golden knn data split in two, so the
    spool layout's outputs are the golden files."""
    _, _, want = joined_gather
    assert want["sts"] == _read(GOLDEN_KNN, "dist.csv")
    assert want["nn"] == _read(GOLDEN_KNN, "pred.csv")


def test_gather_counters_are_not_summed(joined_gather):
    """Rank 0 prints the counters of one process's job: the ranks each
    computed the whole answer, so nothing is summed."""
    d, res, _ = joined_gather
    dumps = res[0][1].split("JOB_RC 0\n")
    lines = _read(d, "grs_jax", "part-r-00000").decode().splitlines()
    assert _dump(dumps[2])["Similarity"] == {"Groups": 2,
                                             "Pairs": len(lines)}
    assert "Similarity" not in _dump(res[1][1])


@pytest.mark.parametrize("out", ["knn_out", "knn_same"])
def test_knn_pipeline_parts_concatenate_to_one_process(joined_gather, out):
    """Distinct inputs (through the spool) and one shared input: each rank
    writes its work slice, and the two parts are the single-process
    output, which over these inputs is the JAX-made fixture's."""
    d, _, want = joined_gather
    base = [str(d / f"{out}0"), str(d / f"{out}1")] if out == "knn_out" \
        else [str(d / out)] * 2
    got = b"".join(_read(base[i], f"part-r-0000{i}") for i in range(2))
    assert got == want["knn"] == _read(ELEARN_KNN, "inter_euclidean.csv")


def test_identical_input_uses_no_spool_and_spools_are_removed(joined_gather):
    d, res, _ = joined_gather
    assert res[0][2].count("input identical on all 2 processes") == 1
    assert res[0][2].count("gathered") == 4
    for i in range(2):
        assert os.listdir(d / f"tmp{i}") == []


def test_peer_read_error_fails_every_rank(tmp_path):
    """Rank 1 cannot read its input while spooling: both ranks raise,
    naming rank 1's error, and none waits in a collective."""
    sims = []
    for i in range(2):
        (tmp_path / f"s{i}").mkdir()
        (tmp_path / f"s{i}" / "tr_part").write_text(f"S{i},1.0,2.0,3,4,pass\n")
        sims.append(str(tmp_path / f"s{i}"))
    res = run_joined(tmp_path, [[_sts(sims[i], str(tmp_path / f"o{i}"))
                                 + ["-Dplatform=cpu"]] for i in range(2)],
                     fail_reads=(False, True), timeout=120)
    for _, so, se, rcs in res:
        assert rcs == [1], se[-3000:]
        assert ("input gather failed on 1 process(es): process 1: OSError: "
                "injected read failure on tr_part") in so
    assert not os.path.exists(tmp_path / "o0")
    assert os.listdir(tmp_path / "tmp0") == os.listdir(tmp_path / "tmp1") \
        == []


def _grs_run(tmp_path, rows, ords, metric, schema=ELEARN):
    """groupedRecordSimilarity over ``rows`` in one process through both
    packages: (port lines, JAX lines, port counters, JAX counters)."""
    src = tmp_path / "recs.csv"
    src.write_text("\n".join(rows) + "\n")
    args = ["groupedRecordSimilarity", f"-Dconf.path={KNN_PROPS}",
            f"-Dsts.same.schema.file.path={schema}",
            f"-Dgrs.group.field.ordinals={ords}",
            f"-Dsts.distance.metric={metric}", str(src)]
    assert port_run.main(args + ["-Dplatform=cpu", str(tmp_path / "p")]) == 0
    assert jax_run.main(args + [str(tmp_path / "j")]) == 0
    out = []
    for side in ("p", "j"):
        out.append(_read(tmp_path, side, "part-r-00000").decode()
                   .splitlines())
    for side in ("p", "j"):
        with open(tmp_path / f"{side}.counters.json") as fh:
            out.append(json.load(fh)["Similarity"])
    return out


def _elearn_rows(n, seed):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.elearn_gen import generate
    return generate(n, seed)


@pytest.mark.parametrize("ords,metric", [
    ("5", "euclidean"), ("5", "manhattan"), ("3", "manhattan"),
    ("3,5", "manhattan")])
def test_grouped_record_similarity_equals_the_jax_job(tmp_path, ords,
                                                      metric):
    """One process: the port's groupedRecordSimilarity writes the JAX
    package's lines and counters: euclidean over two groups of more than
    32 rows, and manhattan over groups of any size."""
    port, jax_, pc, jc = _grs_run(tmp_path, _elearn_rows(150, 5), ords,
                                  metric)
    assert port == jax_ and pc == jc
    assert len(port) == pc["Pairs"] > 0


def test_reference_grouped_similarity_takes_its_order_from_the_padding(
        tmp_path):
    """Euclidean over four numeric features in 17 groups of 2 to 33 rows:
    the JAX package pads a group to 8, 16 or 32 rows, where XLA's CPU dot
    sums the four products in other orders than the top-k order it takes
    at 64 rows and more (ROADMAP §C), and 18 of its 3,411 distances differ
    from the port's, by one or two.  Every differing line is in a group of
    5 to 32 rows."""
    port, jax_, pc, jc = _grs_run(tmp_path, _elearn_rows(300, 5), "4",
                                  "euclidean")
    assert pc == jc and len(port) == len(jax_) == pc["Pairs"] == 3411
    sizes = {}
    for line in port:
        g = line.split(",")[0]
        sizes[g] = sizes.get(g, 0) + 1
    diff = [(p.split(","), j.split(",")) for p, j in zip(port, jax_)
            if p != j]
    assert len(diff) == 18
    for p, j in diff:
        assert p[:3] == j[:3] and 1 <= abs(int(p[3]) - int(j[3])) <= 2
        n = int((1 + (1 + 8 * sizes[p[0]]) ** 0.5) / 2)  # n(n-1)/2 pairs
        assert 5 <= n <= 32


def test_every_ported_job_keeps_the_reference_dist_mode():
    for name, fn in port_jobs.JOBS.items():
        assert port_jobs.dist_mode(fn) == \
            jax_jobs.dist_mode(jax_jobs.resolve(name)), name


@pytest.mark.parametrize("fail", [False, True])
def test_allgather_files_in_one_process(tmp_path, fail):
    (tmp_path / "a").write_bytes(b"\xff\n")
    paths = [str(tmp_path / "a")] + ([str(tmp_path / "gone")] if fail
                                     else [])
    if fail:
        with pytest.raises(RuntimeError,
                           match="x failed on 1 process.*process 0: "
                                 "FileNotFoundError"):
            D.allgather_files(paths, "x")
    else:
        assert D.allgather_files(paths) == [[("a", b"\xff\n")]]
    assert D.spool_name("tr_part", 3) == "tr_part.p3"
