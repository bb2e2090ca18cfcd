"""Streamed forest training on one process, port against the JAX package on
the CPU: ``build_forest_from_stream`` gives the trees of the port's
monolithic build and of the JAX package's streamed build at every block
size, and a teed baseline equals the monolithic one; a checkpoint written
by either package (the JAX one on its 8-device test mesh, pad rows
included) resumes in the other to the same trees; the port's CLI crashed
at ``chunk_read@3`` (the native reader) or ``chunk_encode@3`` (the python
reader) and run again with ``--resume`` gives the trees and quarantine of
an uninterrupted run; every resume refusal keeps the
reference's message; and both builders' monolithic skip/quarantine paths
equal the reference's."""

import json
import os
import warnings

import numpy as np
import pytest

from avenir_tpu.cli import jobs as jjobs
from avenir_tpu.cli import run as jax_run
from avenir_tpu.core import faults as jfaults
from avenir_tpu.core import table as jtable
from avenir_tpu.core.checkpoint import CheckpointManager as JaxCkpt
from avenir_tpu.core.config import Config as JaxConfig
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import forest as jforest
from avenir_tpu.models.tree import TreeParams as JaxTreeParams
from avenir_tpu.monitor.baseline import BaselineBuilder as JaxBaseline

from avenir_tpu_torch.cli import jobs as pjobs
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core import faults as pfaults
from avenir_tpu_torch.core import table as ptable
from avenir_tpu_torch.core.checkpoint import CheckpointManager
from avenir_tpu_torch.core.config import Config
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.models import forest as pforest
from avenir_tpu_torch.models.tree import TreeBuilder, TreeParams
from avenir_tpu_torch.monitor.baseline import BaselineBuilder

SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "age", "ordinal": 1, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "splitScanInterval": 20, "maxSplit": 3},
    {"name": "color", "ordinal": 2, "dataType": "categorical",
     "feature": True, "maxSplit": 2, "cardinality": ["x", "y", "z"]},
    {"name": "score", "ordinal": 3, "dataType": "double", "feature": True,
     "min": 0.0, "max": 1.0, "splitScanInterval": 0.25},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["0", "1"]},
]}
N_ROWS = 700
GARBLED = (3, 150, 151, 420)
TRUNCATED = (77, 690)
TREE_KW = dict(split_algorithm="giniIndex",
               attr_select_strategy="randomNotUsedYet",
               split_select_strategy="randomAmongTop",
               sub_sampling="withReplace", sub_sampling_rate=90.0,
               stopping_strategy="maxDepth", max_depth=3)
PROPS = ("field.delim.regex=,\n"
         "field.delim.out=,\n"
         "dtb.split.algorithm=giniIndex\n"
         "dtb.split.attribute.selection.strategy=randomNotUsedYet\n"
         "dtb.split.select.strategy=randomAmongTop\n"
         "dtb.path.stopping.strategy=maxDepth\n"
         "dtb.max.depth.limit=3\n"
         "dtb.num.trees=5\n"
         "dtb.sub.sampling.strategy=withReplace\n"
         "dtb.sub.sampling.rate=90\n"
         "dtb.random.seed=11\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A CSV with malformed records (corrupted by the JAX package's
    ``corrupt_csv_rows``), its schema file and both schemas."""
    d = tmp_path_factory.mktemp("stream_forest")
    schema_path = d / "schema.json"
    schema_path.write_text(json.dumps(SCHEMA))
    rng = np.random.default_rng(17)
    age = rng.integers(0, 100, N_ROWS)
    color = rng.integers(0, 4, N_ROWS)
    score = rng.random(N_ROWS)
    label = (rng.random(N_ROWS) < 0.2 + 0.5 * (age > 50) * (score > .3))
    lines = [f"r{i},{age[i]},{'xyzw'[color[i]]},{score[i]:.3f},"
             f"{int(label[i])}" for i in range(N_ROWS)]
    csv = d / "train.csv"
    csv.write_text("\n".join(lines) + "\n")
    bad = jfaults.corrupt_csv_rows(str(csv), GARBLED, seed=2, field=1)
    bad += jfaults.corrupt_csv_rows(str(csv), TRUNCATED, seed=2,
                                    mode="truncate")
    return {"csv": str(csv), "schema_path": str(schema_path),
            "fs": FeatureSchema.load(str(schema_path)),
            "jfs": JaxSchema.load(str(schema_path)), "bad": bad}


def _params(T=5, seed=11):
    return (pforest.ForestParams(tree=TreeParams(**TREE_KW), num_trees=T,
                                 seed=seed),
            jforest.ForestParams(tree=JaxTreeParams(**TREE_KW), num_trees=T,
                                 seed=seed))


def _json(trees):
    return [t.to_json() for t in trees]


def _port_stream(data, chunk, use_native=True, **kw):
    stats = {}
    blocks = ptable.prefetch_chunks(ptable.iter_csv_chunks(
        data["csv"], data["fs"], chunk_rows=chunk, use_native=use_native,
        bad_records=ptable.BadRecordPolicy("skip"),
        start_row=kw.pop("start_row", 0)),
        stats=stats, consumer_wait_key=None)
    trees = pforest.build_forest_from_stream(blocks, data["fs"], _params()[0],
                                             device="cpu", stats=stats, **kw)
    return trees, stats


def _jax_stream(data, chunk, ctx, use_native=False, **kw):
    blocks = jtable.prefetch_chunks(jtable.iter_csv_chunks(
        data["csv"], data["jfs"], chunk_rows=chunk, use_native=use_native,
        bad_records=jtable.BadRecordPolicy("skip"),
        start_row=kw.pop("start_row", 0)), consumer_wait_key=None)
    return jforest.build_forest_from_stream(blocks, data["jfs"], _params()[1],
                                            ctx, fuse=False, **kw)


@pytest.fixture(scope="module")
def port_mono(data):
    table = ptable.load_csv(data["csv"], data["fs"],
                            bad_records=ptable.BadRecordPolicy("skip"))
    return _json(pforest.build_forest(table, _params()[0], device="cpu"))


@pytest.mark.parametrize("chunk", [1, 64, 257, 10 ** 6])
def test_streamed_forest_equals_the_monolithic_forest(data, port_mono,
                                                      chunk):
    trees, stats = _port_stream(data, chunk)
    assert _json(trees) == port_mono
    for key in ("parse_s", "stage_wait_s", "transfer_s", "queue_wait_s",
                "ingest_compute_s", "ingest_wall_s", "build_s"):
        assert stats[key] >= 0, key
    assert stats["ingest_wall_s"] > 0 and stats["build_s"] > 0


@pytest.mark.parametrize("chunk", [97, 10 ** 6])
def test_streamed_forest_and_baseline_equal_the_jax_package(data, port_mono,
                                                            mesh_ctx, chunk):
    pb = BaselineBuilder(data["fs"], device="cpu")
    jb = JaxBaseline(data["jfs"])
    trees, _ = _port_stream(data, chunk, baseline=pb)
    want = _jax_stream(data, chunk, mesh_ctx, baseline=jb)
    assert _json(trees) == _json(want) == port_mono
    got_b, want_b = pb.finalize(), jb.finalize()
    assert got_b.n_rows == want_b.n_rows == N_ROWS - 6
    np.testing.assert_array_equal(got_b.counts, want_b.counts)
    mono = BaselineBuilder(data["fs"], device="cpu").update(ptable.load_csv(
        data["csv"], data["fs"], bad_records=ptable.BadRecordPolicy("skip")))
    np.testing.assert_array_equal(got_b.counts, mono.finalize().counts)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(data, port_mono, mesh_ctx,
                                            tmp_path, writer):
    """A streamed build crashed at block 4 (a checkpoint every block)
    resumes in the other package to the trees of an uninterrupted build.
    The JAX package's checkpoint comes from its 8-device test mesh, so
    every 97-row block carries 7 pad rows; the port writes 96-row blocks,
    whose rows the 8-device mesh it resumes on accepts (the reference
    refuses a checkpoint its mesh does not divide).  Both packages read
    with the python reader here, whose blocks hold ``chunk`` good rows and
    pass ``chunk_encode``; the native reader's crash and resume is
    ``test_native_checkpoint_resumes_in_both_packages``."""
    ck = str(tmp_path / "ck")
    spec = "chunk_encode@4=raise:RuntimeError"
    chunk = 97 if writer == "jax" else 96
    if writer == "jax":
        jfaults.install(jfaults.FaultInjector.parse(spec))
        try:
            with pytest.raises(RuntimeError, match="chunk_encode@4"):
                _jax_stream(data, 97, mesh_ctx, checkpoint=JaxCkpt(ck),
                            checkpoint_every=1)
        finally:
            jfaults.uninstall()
    else:
        pfaults.install(pfaults.FaultInjector.parse(spec))
        try:
            with pytest.raises(RuntimeError, match="chunk_encode@4"):
                _port_stream(data, chunk, use_native=False,
                             checkpoint=CheckpointManager(ck),
                             checkpoint_every=1)
        finally:
            pfaults.uninstall()
    if writer == "jax":
        step, arrays, meta = CheckpointManager(ck).restore()
        assert (arrays["mask"] == 0).sum() == 4 * 7      # pad rows
        trees, _ = _port_stream(data, 97,
                                start_row=meta["source_rows_done"],
                                resume_state=(arrays, meta))
    else:
        step, arrays, meta = JaxCkpt(ck).restore()
        assert arrays["mask"].all()
        trees = _jax_stream(data, chunk, mesh_ctx,
                            start_row=meta["source_rows_done"],
                            resume_state=(arrays, meta))
    assert step == 4 and meta["n_rows"] == 4 * chunk
    assert not meta["ingest_complete"]
    assert _json(trees) == port_mono


def test_native_checkpoint_resumes_in_both_packages(data, port_mono,
                                                    tmp_path):
    """The native reader's block parse passes ``chunk_read``: a build
    crashed at block 4 (a checkpoint every block) has read 4 blocks of 96
    source rows, the bad ones among them dropped, and resumes to the
    trees of an uninterrupted build in the port and in the JAX package
    (one device: the reference refuses a checkpoint its mesh does not
    divide), both reading natively."""
    from avenir_tpu.parallel.mesh import MeshContext as JaxMeshContext
    from avenir_tpu.parallel.mesh import make_mesh as jax_make_mesh
    ck = str(tmp_path / "ck")
    pfaults.install(pfaults.FaultInjector.parse(
        "chunk_read@4=raise:RuntimeError,chunk_encode@*=raise:RuntimeError"))
    try:
        with pytest.raises(RuntimeError, match="chunk_read@4"):
            _port_stream(data, 96, checkpoint=CheckpointManager(ck),
                         checkpoint_every=1)
    finally:
        pfaults.uninstall()
    step, arrays, meta = CheckpointManager(ck).restore()
    dropped = sum(1 for b in GARBLED + TRUNCATED if b < 4 * 96)
    assert step == 4 and meta["source_rows_done"] == 4 * 96
    assert meta["n_rows"] == 4 * 96 - dropped and arrays["mask"].all()
    trees, _ = _port_stream(data, 96, start_row=meta["source_rows_done"],
                            resume_state=(arrays, meta))
    assert _json(trees) == port_mono
    _, jarrays, jmeta = JaxCkpt(ck).restore()
    jtrees = _jax_stream(data, 96, JaxMeshContext(jax_make_mesh(1)),
                         use_native=True,
                         start_row=jmeta["source_rows_done"],
                         resume_state=(jarrays, jmeta))
    assert _json(jtrees) == port_mono


def test_restored_pad_rows_weigh_by_mask_position(data):
    """``_expand_weights`` places the weights drawn over the true rows at
    the mask's valid positions, zero on pad rows."""
    b = TreeBuilder.from_stream(
        iter([ptable.load_csv(data["csv"], data["fs"],
                              bad_records=ptable.BadRecordPolicy("skip"))]),
        data["fs"], TreeParams(), device="cpu")
    b.mask_np = np.asarray([1, 0, 1, 1, 0, 1], np.float32)
    b.n_rows, b.n_padded = 4, 6
    np.testing.assert_array_equal(
        b._expand_weights(np.asarray([5, 6, 7, 8], np.float32)),
        [5, 0, 6, 7, 0, 8])
    np.testing.assert_array_equal(b._expand_weights(None),
                                  [1, 0, 1, 1, 0, 1])


@pytest.mark.parametrize("case", ["empty", "width", "shard"])
def test_from_stream_refusals_match_the_reference(data, mesh_ctx, case):
    from avenir_tpu.models.tree import TreeBuilder as JaxBuilder
    table = ptable.load_csv(data["csv"], data["fs"],
                            bad_records=ptable.BadRecordPolicy("skip"))
    S = TreeBuilder.from_stream(iter([table]), data["fs"], TreeParams(),
                                device="cpu").split_set.n_splits
    arrays = {"branches": np.zeros((3, S + 1 if case == "width" else S),
                                   np.int32),
              "cls_codes": np.zeros(3, np.int32),
              "mask": np.ones(3, np.float32)}
    meta = {"n_rows": 3, "blocks_done": 1, "source_rows_done": 3}
    if case == "shard":
        meta["shard"] = {"index": 0, "count": 2}
    resume = None if case == "empty" else (arrays, meta)
    errs = []
    for build, schema, tp, kw in (
            (TreeBuilder.from_stream, data["fs"], TreeParams(),
             {"device": "cpu"}),
            (JaxBuilder.from_stream, data["jfs"], JaxTreeParams(),
             {"ctx": mesh_ctx, "fuse": False})):
        with pytest.raises(ValueError) as exc:
            build(iter([]), schema, tp, resume_state=resume, **kw)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


# --------------------------------------------------------------------------
# the CLI: crash and --resume, refusals, monolithic bad records
# --------------------------------------------------------------------------

def _props(tmp_path, data, ck, qdir, extra=""):
    p = tmp_path / "job.properties"
    p.write_text(PROPS + f"dtb.feature.schema.file.path="
                 f"{data['schema_path']}\n"
                 "dtb.streaming.ingest=true\n"
                 "dtb.streaming.block.rows=48\n"
                 f"dtb.streaming.checkpoint.dir={ck}\n"
                 "dtb.streaming.checkpoint.blocks=1\n"
                 "badrecords.policy=quarantine\n"
                 f"badrecords.quarantine.path={qdir}\n" + extra)
    return str(p)


def _trees(out):
    return {n: open(os.path.join(out, n)).read()
            for n in sorted(os.listdir(out)) if n.endswith(".json")}


def _cli_crash_then_resume(data, port_mono, tmp_path, monkeypatch, reader):
    """A clean CLI run; a run with a transient quarantine write fault and a
    crash at block 3 on ``reader``'s fault point; then ``--resume``: the
    trees and quarantine bytes of the clean run, every block read by
    ``reader``."""
    monkeypatch.setattr(pfaults, "RETRY_BASE_S", 0.0)
    if reader == "python":
        orig = ptable.iter_csv_chunks

        def python_reader(*a, **kw):
            kw["use_native"] = False
            return orig(*a, **kw)
        monkeypatch.setattr(ptable, "iter_csv_chunks", python_reader)
    point = "chunk_read" if reader == "native" else "chunk_encode"
    other = "chunk_encode" if reader == "native" else "chunk_read"
    clean = str(tmp_path / "clean")
    props = _props(tmp_path, data, tmp_path / "ck_clean", tmp_path / "qc")
    assert port_run.main(["randomForestBuilder", f"-Dconf.path={props}",
                          "-Dplatform=cpu", data["csv"], clean]) == 0
    want = _trees(clean)
    assert list(want.values()) == port_mono
    with open(tmp_path / "qc" / "part-q-00000") as fh:
        assert fh.read().splitlines() == sorted(
            data["bad"], key=lambda l: int(l.split(",")[0][1:]))
    with open(clean + ".counters.json") as fh:
        readers = json.load(fh)["IngestReaders"]
    assert readers[f"{reader}.blocks"] == -(-N_ROWS // 48) \
        if reader == "native" else readers[f"{reader}.blocks"] > 0
    assert set(readers) <= {f"{reader}.blocks", f"{reader}.rows",
                            "python.asked"}

    props = _props(tmp_path, data, tmp_path / "ck", tmp_path / "q")
    out = str(tmp_path / "out")
    # a transient quarantine write fault (retried) and a crash at block 3
    pfaults.install(pfaults.FaultInjector.parse(
        f"artifact_write@0=raise:OSError,{point}@3=raise:RuntimeError,"
        f"{other}@*=raise:RuntimeError"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match=f"{point}@3"):
                port_run.main(["randomForestBuilder", f"-Dconf.path={props}",
                               "-Dplatform=cpu", data["csv"], out])
    finally:
        pfaults.uninstall()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    step, _, meta = mgr.restore()
    assert step == 3 and not meta["ingest_complete"]
    assert port_run.main(["randomForestBuilder", f"-Dconf.path={props}",
                          "--resume", "-Dplatform=cpu", data["csv"],
                          out]) == 0
    assert _trees(out) == want
    # a checkpoint every block: no bad record reported twice
    assert (tmp_path / "q" / "part-q-00000").read_bytes() == \
        (tmp_path / "qc" / "part-q-00000").read_bytes()
    assert mgr.restore()[2]["ingest_complete"] is True
    with open(out + ".counters.json") as fh:
        assert json.load(fh)["Checkpoint"] == {
            "ResumedFromStep": 3,
            "ResumedSourceRows": meta["source_rows_done"]}


def test_cli_crash_then_resume_equals_an_uninterrupted_run(
        data, port_mono, tmp_path, monkeypatch):
    """The python reader (``chunk_encode@3``)."""
    _cli_crash_then_resume(data, port_mono, tmp_path, monkeypatch, "python")


def test_cli_native_crash_then_resume_equals_an_uninterrupted_run(
        data, port_mono, tmp_path, monkeypatch):
    """The job's default, native reader (``chunk_read@3``)."""
    _cli_crash_then_resume(data, port_mono, tmp_path, monkeypatch, "native")


def _refusal_cfg(case, data, tmp_path):
    keys = {"dtb.feature.schema.file.path": data["schema_path"],
            "dtb.num.trees": "3", "dtb.max.depth.limit": "2",
            "dtb.path.stopping.strategy": "maxDepth"}
    ck = str(tmp_path / "ck")
    if case == "resume_without_ingest":
        keys["dtb.streaming.resume"] = "true"
    elif case == "resume_without_checkpoint_dir":
        keys.update({"dtb.streaming.ingest": "true",
                     "dtb.streaming.resume": "true"})
    elif case == "every_step_torn":
        keys.update({"dtb.streaming.ingest": "true",
                     "dtb.streaming.resume": "true",
                     "dtb.streaming.checkpoint.dir": ck})
        for s in (2, 4):
            d = os.path.join(ck, f"step_{s:08d}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "state.npz"), "wb") as fh:
                fh.write(b"torn")
    elif case == "shard_on_single_process":
        keys.update({"dtb.streaming.ingest": "true",
                     "dtb.streaming.shard": "on"})
    elif case == "shard_on_without_ingest":
        keys["dtb.streaming.shard"] = "on"
    elif case == "shard_knob_value":
        keys["dtb.streaming.shard"] = "sometimes"
    elif case == "quarantine_without_a_path":
        keys["badrecords.policy"] = "quarantine"
    return keys


@pytest.mark.parametrize("case", [
    "resume_without_ingest", "resume_without_checkpoint_dir",
    "every_step_torn", "shard_on_single_process", "shard_on_without_ingest",
    "shard_knob_value", "quarantine_without_a_path"])
def test_resume_refusals_keep_the_reference_message(data, tmp_path, case):
    keys = _refusal_cfg(case, data, tmp_path)
    out = None if case == "quarantine_without_a_path" else \
        str(tmp_path / "o")
    got = want = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            pjobs.random_forest_builder(Config(keys), data["csv"], out)
        except Exception as exc:
            got = (type(exc).__name__, str(exc))
        try:
            jjobs.random_forest_builder(JaxConfig(keys), data["csv"], out)
        except Exception as exc:
            # the port's joined run is torch.distributed's
            want = (type(exc).__name__,
                    str(exc).replace("jax.distributed", "torch.distributed"))
    assert got is not None and got == want


@pytest.mark.parametrize("job", ["randomForestBuilder",
                                 "decisionTreeBuilder"])
@pytest.mark.parametrize("policy", ["skip", "quarantine"])
def test_monolithic_bad_records_equal_the_reference(data, tmp_path, job,
                                                    policy):
    props = tmp_path / "mono.properties"
    props.write_text(PROPS + f"dtb.feature.schema.file.path="
                     f"{data['schema_path']}\n"
                     f"badrecords.policy={policy}\n"
                     f"dtb.decision.file.path.out={tmp_path}/dec.json\n")
    res = {}
    for name, main in (("port", port_run.main), ("jax", jax_run.main)):
        out = str(tmp_path / name)
        extra = ["-Dplatform=cpu"] if name == "port" else []
        assert main([job, f"-Dconf.path={props}", *extra, data["csv"],
                     out]) == 0
        files = {}
        for root, _, names in os.walk(out):
            for n in names:
                with open(os.path.join(root, n), "rb") as fh:
                    files[os.path.relpath(os.path.join(root, n), out)] = \
                        fh.read()
        if job == "decisionTreeBuilder":
            with open(tmp_path / "dec.json", "rb") as fh:
                files["dec.json"] = fh.read()
        with open(out + ".counters.json") as fh:
            c = json.load(fh)
        res[name] = (files, c["BadRecords"],
                     c.get("Random forest", c.get("Decision tree")))
    assert res["port"] == res["jax"]
    assert res["port"][1]["Malformed"] == len(GARBLED) + len(TRUNCATED)
    if policy == "quarantine":
        assert os.path.join("_quarantine", "part-q-00000") in res["port"][0]
