"""The tree builders over per-process inputs in a joined run, on the CPU:
two real gloo ranks, each given its own CSV, against the JAX package's
single-process job over the two CSVs concatenated.

* the monolithic ``randomForestBuilder`` (rafo keys) with the conf's
  ``withReplace`` bootstrap, without sub-sampling, and over unequal files,
  and the streamed one with ``dtb.streaming.shard=off``: every rank writes
  the single process's trees; rank 0 publishes its registry version,
  baseline and int8 sidecar, the sidecar's budget held on rank 0's rows;
* ``decisionTreeBuilder`` (detr keys), three levels of the ``detr.sh``
  rotation: every rank writes the single process's decision paths, and
  the ranks' record part files concatenate to the single process's;
* ``build_forest(reducer=)`` over per-process tables of any sizes, the
  processes as threads over the file transport, batched and per tree:
  every process returns the JAX package's single-process forest of the
  concatenated table;
* the JAX package's own joined run (two ``jax.distributed`` processes,
  one CPU device each, launched as ``tests/multiproc_worker.py`` launches
  them): its bootstrap forests differ from its single-process ones, and
  unequal files raise ``ValueError`` (ROADMAP §C).
"""

import json
import os
import sys

import numpy as np
import pytest

from avenir_tpu.cli import run as jax_run
from avenir_tpu.core import table as jtable
from avenir_tpu.models import forest as jforest
from avenir_tpu.parallel.mesh import MeshContext as JaxMeshContext
from avenir_tpu.parallel.mesh import make_mesh as jax_make_mesh

from avenir_tpu_torch.core.table import load_csv
from avenir_tpu_torch.models.forest import build_forest
from avenir_tpu_torch.parallel.collectives import AllReducer
from avenir_tpu_torch.parallel.distributed import ShardSpec
from tests.test_torch_cli_multiprocess import _dump, _free_port, _run_all
from tests.test_torch_joined_gather import run_joined
from tests.test_torch_stream_sharded import (_jax_params, _params, _schemas,
                                             _threads, _write_csv)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
RAFO = os.path.join(RES, "rafo.properties")
DETR = os.path.join(RES, "detr.properties")
SCHEMA = os.path.join(RES, "call_hangup.json")
TRAIN = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9s", "train.csv")
VERSION = os.path.join("hangup", "v_000001")
PUBLISH = ("-Ddtb.model.name=hangup", "-Ddtb.baseline.publish=true",
           "-Ddtb.model.quantize=true")
STREAM_OFF = ("-Ddtb.streaming.ingest=true", "-Ddtb.streaming.shard=off",
              "-Ddtb.streaming.block.rows=777")
NONE = ("-Ddtb.sub.sampling.strategy=none",)
# forest runs: name -> (input pair, extra keys, publishes)
FORESTS = {"mono": ("equal", PUBLISH, True), "none": ("equal", NONE, False),
           "unequal": ("unequal", (), False),
           "soff": ("equal", STREAM_OFF + PUBLISH, True)}
DT_LEVELS = 3

# one jax.distributed process of the JAX package's joined run: its runs in
# order, each exit code or exception printed
JAX_WORKER = r"""
import json, os, sys
pid, port, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.update(JAX_PLATFORMS="cpu",
                  XLA_FLAGS="--xla_force_host_platform_device_count=1",
                  JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                  JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
import jax
jax.config.update("jax_platforms", "cpu")
from avenir_tpu.cli import run
for argv in json.load(open(spec))[pid]:
    try:
        print(f"JOB_RC {run.main(argv)}", flush=True)
    except Exception as exc:
        print(f"JOB_ERROR {type(exc).__name__}: {exc}", flush=True)
"""


def _rf(src, out, extra=()):
    return ["randomForestBuilder", f"-Dconf.path={RAFO}",
            f"-Ddtb.feature.schema.file.path={SCHEMA}",
            "-Dbadrecords.policy=skip", *extra, src, out]


def _dt(src, out, dec_out, dec_in=None):
    return (["decisionTreeBuilder", f"-Dconf.path={DETR}",
             f"-Ddtb.feature.schema.file.path={SCHEMA}",
             "-Dbadrecords.policy=skip",
             f"-Ddtb.decision.file.path.out={dec_out}"]
            + ([f"-Ddtb.decision.file.path.in={dec_in}"] if dec_in else [])
            + [src, out])


def _read(*parts):
    with open(os.path.join(*parts), "rb") as fh:
        return fh.read()


def _trees(out):
    return [_read(out, f"tree_{t}.json") for t in range(9)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The first 4,000 lines of the rafo9s CSV (four malformed records):
    two files of 2,000 lines, and two of 2,000 and 1,500; each pair's
    concatenation beside it."""
    d = tmp_path_factory.mktemp("joined_trees")
    with open(TRAIN) as fh:
        lines = fh.read().splitlines(True)[:4000]
    pairs = {"equal": (lines[:2000], lines[2000:]),
             "unequal": (lines[:2000], lines[2000:3500])}
    files = {}
    for name, parts in pairs.items():
        files[name] = []
        for i, part in enumerate(parts):
            (d / f"{name}{i}.csv").write_text("".join(part))
            files[name].append(str(d / f"{name}{i}.csv"))
        (d / f"{name}.csv").write_text("".join(parts[0] + parts[1]))
    return d, files


@pytest.fixture(scope="module")
def joined(data):
    """Every job on two gloo ranks, each rank over its own file."""
    d, files = data
    runs = []
    for i in range(2):
        rank = [_rf(files[src][i], str(d / f"{name}{i}"),
                    extra + ((f"-Ddtb.model.registry.dir={d}/reg_{name}",)
                             if pub else ()) + ("-Dplatform=cpu",))
                for name, (src, extra, pub) in FORESTS.items()]
        for lv in range(DT_LEVELS):
            rank.append(_dt(files["equal"][i], str(d / f"dt{lv}"),
                            str(d / f"dec{lv}_{i}.json"),
                            str(d / f"dec{lv - 1}_{i}.json") if lv else None)
                        + ["-Dplatform=cpu"])
        runs.append(rank)
    return run_joined(d, runs, timeout=240)


@pytest.fixture(scope="module")
def single(data):
    """The JAX package's single-process jobs over the concatenations."""
    d, _ = data
    for name, (src, extra, pub) in FORESTS.items():
        if name == "soff":
            continue   # the streamed single-process forest is the
            # monolithic one (tests/test_torch_stream_forest.py)
        assert jax_run.main(_rf(
            str(d / f"{src}.csv"), str(d / f"one_{name}"),
            extra + ((f"-Ddtb.model.registry.dir={d}/reg_one",)
                     if pub else ()))) == 0
    for lv in range(DT_LEVELS):
        assert jax_run.main(_dt(
            str(d / "equal.csv"), str(d / f"one_dt{lv}"),
            str(d / f"one_dec{lv}.json"),
            str(d / f"one_dec{lv - 1}.json") if lv else None)) == 0
    return d


def test_both_ranks_ran_every_job(joined):
    for rc, _, se, rcs in joined:
        assert rc == 0 and rcs == [0] * (len(FORESTS) + DT_LEVELS), \
            se[-3000:]


@pytest.mark.parametrize("name", list(FORESTS))
@pytest.mark.parametrize("rank", [0, 1])
def test_every_rank_trains_the_concatenations_forest(joined, single, name,
                                                     rank):
    want = "mono" if name == "soff" else name
    assert _trees(str(single / f"{name}{rank}")) == \
        _trees(str(single / f"one_{want}"))


@pytest.mark.parametrize("name", ["mono", "soff"])
def test_rank0_publishes_the_single_process_version(joined, single, name):
    """meta.json, the baseline (the ranks' counts summed) and the int8
    arrays are the single process's bytes; the sidecar's mismatch is held
    on rank 0's 1,998 rows, within the budget."""
    got = str(single / f"reg_{name}" / VERSION)
    want = str(single / "reg_one" / VERSION)
    assert sorted(os.listdir(single / f"reg_{name}" / "hangup")) == \
        ["v_000001"]
    for f in ("meta.json", "baseline.json"):
        assert _read(got, f) == _read(want, f), f
    for f in ("arrays.npz", "baseline.npz", "quantized.npz"):
        with np.load(os.path.join(got, f)) as g, \
                np.load(os.path.join(want, f)) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    qg = json.loads(_read(got, "quantized.json"))
    qw = json.loads(_read(want, "quantized.json"))
    assert qg.pop("mismatch") <= qg["budget"]
    qw.pop("mismatch")
    assert qg == qw


def test_joined_forest_counters(joined):
    """Rank 0 prints the counters summed over the ranks: the bad records
    of both files, and Trees P x T as in the JAX package's joined run."""
    dumps = [_dump(part) for part in joined[0][1].split("JOB_RC 0\n")]
    mono = dumps[0]
    assert mono["Random forest"]["Trees"] == 18
    assert mono["Random forest"]["QuantizedSampleRows"] == 1998
    assert mono["BadRecords"] == {"Malformed": 4, "Skipped": 4}
    # per rank: the row-count allgather, 4 levels, the baseline allgather
    assert mono["Collectives"]["AllReduces"] == 2 * 6
    assert dumps[3]["Random forest"]["Trees"] == 18
    assert "Shard" not in mono
    # rank 1 prints no counters
    assert {line.split()[0] for line in joined[1][1].splitlines()} == \
        {"JOB_RC"}


@pytest.mark.parametrize("level", range(DT_LEVELS))
@pytest.mark.parametrize("rank", [0, 1])
def test_every_rank_writes_the_single_process_decision_paths(
        joined, single, level, rank):
    assert _read(single, f"dec{level}_{rank}.json") == \
        _read(single, f"one_dec{level}.json")


@pytest.mark.parametrize("level", range(DT_LEVELS))
def test_decision_tree_record_parts_concatenate(joined, single, level):
    out = single / f"dt{level}"
    assert sorted(os.listdir(out)) == ["part-r-00000", "part-r-00001"]
    assert _read(out, "part-r-00000") + _read(out, "part-r-00001") == \
        _read(single, f"one_dt{level}", "part-r-00000")


@pytest.fixture(scope="module")
def reference_joined(data, single):
    """The JAX package's joined run: the monolithic bootstrap forest over
    the equal files, the streamed one with shard=off, and the monolithic
    one over the unequal files."""
    d, files = data
    spec = [[_rf(files["equal"][i], str(d / f"jax_mono{i}"),
                 ("-Ddistributed.mode=1",)),
             _rf(files["equal"][i], str(d / f"jax_soff{i}"),
                 STREAM_OFF + ("-Ddistributed.mode=1",)),
             _rf(files["unequal"][i], str(d / f"jax_unequal{i}"),
                 ("-Ddistributed.mode=1",))] for i in range(2)]
    (d / "jax_spec.json").write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    port = str(_free_port())
    res = _run_all([([sys.executable, "-c", JAX_WORKER, str(i), port,
                      str(d / "jax_spec.json")], env) for i in range(2)],
                   timeout=240)
    for rc, _, se in res:
        assert rc == 0, se[-3000:]
    return [[line for line in so.splitlines()
             if line.startswith(("JOB_RC", "JOB_ERROR"))]
            for _, so, _ in res]


@pytest.mark.parametrize("name", ["mono", "soff"])
def test_reference_joined_bootstrap_differs_from_one_process(
        reference_joined, single, name):
    """The JAX package's monolithic builder draws each process's bootstrap
    over that process's own rows, from the same seed: both processes
    agree, and all 9 trees differ from one process over the
    concatenation, which the port's joined run gives."""
    idx = 0 if name == "mono" else 1
    for rank in range(2):
        assert reference_joined[rank][idx] == "JOB_RC 0"
    got = [_trees(str(single / f"jax_{name}{r}")) for r in range(2)]
    want = _trees(str(single / "one_mono"))
    assert got[0] == got[1]
    assert all(g != w for g, w in zip(got[0], want))


def test_reference_joined_refuses_unequal_files(reference_joined):
    """The JAX package's global-array ingest needs equal blocks: files of
    1,998 and 1,498 good rows raise on both processes, where the port
    trains the concatenation's forest."""
    for rank in range(2):
        assert reference_joined[rank][2] == (
            "JOB_ERROR ValueError: per-process local shapes differ: "
            "[[1998, 4], [1498, 4]] — equalize the input shards (pad or "
            "rebalance rows; fix column-count drift) before ingest; "
            "mismatched blocks silently corrupt the global array")


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("cuts", [(0, 150, 401), (0, 40, 300, 401),
                                  (0, 200, 200, 401)])
def test_forest_over_per_process_tables_is_the_concatenations(
        tmp_path, batched, cuts):
    """Two or three processes (threads, file transport) each holding rows
    ``cuts[i]:cuts[i + 1]`` of one table, one of them empty in the last
    case: every process returns the JAX package's forest of the whole
    table, the bootstrap included."""
    schema, jschema = _schemas()
    csv = _write_csv(tmp_path / "d.csv", 401)
    full = load_csv(csv, schema, ",")
    P = len(cuts) - 1

    def rank(i):
        red = AllReducer(spec=ShardSpec(i, P), name="mono",
                         transport_dir=str(tmp_path / "r"), timeout_s=120)
        return [m.to_json() for m in build_forest(
            full.take_rows(cuts[i], cuts[i + 1]), _params(), device="cpu",
            batched=batched, reducer=red)]
    got, errs = _threads(rank, P)
    assert not errs, errs
    want = [m.to_json() for m in jforest.build_forest(
        jtable.load_csv(csv, jschema, ","), _jax_params(),
        JaxMeshContext(jax_make_mesh(1)), batched=batched)]
    for i in range(P):
        assert got[i] == want
