"""Row-range sharded streamed training, port against the JAX package on the
CPU, shards as threads over the file transport: the shards' ingest streams
(``iter_csv_chunks(shard=)``) are the reference's, block for block, and
together the whole stream, bad rows on a split point included; a
two-shard and a three-shard build (one shard empty) give the trees of the
JAX package's thread build and of the single-process build, and the
rafo9s fixture's over two shards; a single-shard build pays the
reference's collectives (one a level plus the row-count allgather); a
shard killed mid-ingest resumes shard-relative to the same trees; and the
summed baseline partials equal the monolithic baseline."""

import os
import threading

import numpy as np
import pytest

from avenir_tpu.core import table as jtable
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models import forest as jforest
from avenir_tpu.models.tree import TreeParams as JaxTreeParams
from avenir_tpu.monitor import baseline as jbaseline
from avenir_tpu.parallel.collectives import AllReducer as JaxAllReducer
from avenir_tpu.parallel.distributed import ShardSpec as JaxShardSpec
from avenir_tpu.parallel.mesh import (MeshContext as JaxMeshContext,
                                      make_mesh as jax_make_mesh,
                                      set_runtime_context as jax_set_context)
from avenir_tpu.utils.tracing import transfer_ledger as jax_ledger

from avenir_tpu_torch.cli.jobs import _tree_params
from avenir_tpu_torch.core.checkpoint import CheckpointManager
from avenir_tpu_torch.core.config import load_config
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import (BadRecordPolicy, ColumnarTable,
                                         count_source_rows, iter_csv_chunks,
                                         load_csv)
from avenir_tpu_torch.models.forest import (ForestParams, build_forest,
                                            build_forest_from_stream)
from avenir_tpu_torch.models.tree import TreeBuilder, TreeParams
from avenir_tpu_torch.monitor.baseline import (BaselineBuilder,
                                               allreduce_partials)
from avenir_tpu_torch.parallel.collectives import AllReducer
from avenir_tpu_torch.parallel.distributed import ShardSpec, shard_rows
from avenir_tpu_torch.utils.tracing import transfer_ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
RAFO9S = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9s")

SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "c1", "ordinal": 1, "dataType": "categorical", "feature": True,
     "maxSplit": 2, "cardinality": ["a", "b", "c"]},
    {"name": "n1", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 600, "splitScanInterval": 150},
    {"name": "cls", "ordinal": 3, "dataType": "categorical",
     "cardinality": ["T", "F"]},
]}
TREE_KW = dict(split_algorithm="giniIndex",
               attr_select_strategy="randomNotUsedYet",
               split_select_strategy="randomAmongTop",
               sub_sampling="withReplace", sub_sampling_rate=90.0,
               stopping_strategy="maxDepth", max_depth=3)


def _write_csv(path, n, seed=3, bad_rows=()):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        if i in bad_rows:
            lines.append(f"r{i},a,NOT_A_NUMBER,T" if i % 2 else f"r{i},b")
            continue
        c = ["a", "b", "c"][rng.integers(0, 3)]
        v = int(rng.integers(0, 600))
        cls = "T" if (v > 300) ^ (c == "c") else "F"
        lines.append(f"r{i},{c},{v},{cls}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def _schemas():
    return FeatureSchema.from_dict(SCHEMA), JaxSchema.from_dict(SCHEMA)


def _params(trees=3, seed=7):
    return ForestParams(tree=TreeParams(**TREE_KW), num_trees=trees,
                        seed=seed)


def _jax_params(trees=3, seed=7):
    return jforest.ForestParams(tree=JaxTreeParams(**TREE_KW),
                                num_trees=trees, seed=seed)


@pytest.fixture()
def jax_one_device():
    """The JAX package's thread-simulated shards need one-device programs
    (see tests/test_sharded_stream.py)."""
    jax_set_context(JaxMeshContext(jax_make_mesh(1)))
    yield
    jax_set_context(None)


def _threads(fn, n, timeout=240):
    out, errs = {}, {}

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as exc:   # re-raised on the test's thread
            errs[i] = exc
    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a shard hung"
    return out, errs


# --------------------------------------------------------------------------
# the sharded ingest
# --------------------------------------------------------------------------

@pytest.mark.parametrize("count,chunk", [(1, 64), (2, 64), (3, 64),
                                         (7, 64), (2, 100), (5, 37)])
def test_shard_streams_equal_the_reference(tmp_path, count, chunk):
    """Each shard's stream on the port's native reader equals the
    reference's native shard block for block, and the reference's python
    shard as one table (its blocks hold ``chunk`` good rows, the native
    ones ``chunk`` source rows); the port's python shard equals the
    reference's block for block."""
    schema, jschema = _schemas()
    csv = _write_csv(tmp_path / "d.csv", 499, bad_rows={5, 200, 201})
    whole = []

    def shard(pkg, use_native, i):
        if pkg == "port":
            return list(iter_csv_chunks(
                csv, schema, ",", chunk_rows=chunk, use_native=use_native,
                bad_records=BadRecordPolicy("skip"), shard=(i, count)))
        return list(jtable.iter_csv_chunks(
            csv, jschema, ",", chunk_rows=chunk, use_native=use_native,
            bad_records=jtable.BadRecordPolicy("skip"), shard=(i, count)))
    for i in range(count):
        runs = {(pkg, nat): shard(pkg, nat, i)
                for pkg in ("port", "jax") for nat in (True, False)}
        for nat in (True, False):
            got, want = runs["port", nat], runs["jax", nat]
            assert [(c.n_rows, c.source_row_end) for c in got] == \
                [(c.n_rows, c.source_row_end) for c in want]
            for g, w in zip(got, want):
                for o in w.columns:
                    np.testing.assert_array_equal(g.columns[o], w.columns[o])
        got = runs["port", True]
        if runs["jax", False]:
            mine = ColumnarTable.from_chunks(got)
            ref = jtable.ColumnarTable.from_chunks(runs["jax", False])
            for o in ref.columns:
                np.testing.assert_array_equal(mine.columns[o],
                                              ref.columns[o])
        else:
            assert sum(c.n_rows for c in got) == 0
        lo, hi = shard_rows(499, i, count, chunk)
        assert all(lo < c.source_row_end <= hi for c in got)
        whole.extend(got)
    full = load_csv(csv, schema, ",", bad_records=BadRecordPolicy("skip"))
    union = ColumnarTable.from_chunks(whole)
    assert union.n_rows == full.n_rows == 496
    for o in full.columns:
        np.testing.assert_array_equal(union.columns[o], full.columns[o])


def test_bad_rows_on_split_points_are_reported_once(tmp_path):
    """Bad records on and around the split points (3 shards of 300 rows at
    64-row blocks split at 128 and 192) land in exactly one shard: the
    tallies and the quarantined lines add up to the single stream's."""
    schema, _ = _schemas()
    bad = {0, 63, 64, 127, 128, 191, 192, 299}
    csv = _write_csv(tmp_path / "d.csv", 300, bad_rows=bad)

    def run(shard, tag):
        counters = Counters()
        pol = BadRecordPolicy("quarantine", str(tmp_path / f"q_{tag}"),
                              counters)
        rows = sum(c.n_rows for c in iter_csv_chunks(
            csv, schema, ",", chunk_rows=64, bad_records=pol, shard=shard))
        q = tmp_path / f"q_{tag}" / "part-q-00000"
        return rows, counters, q.read_text() if q.exists() else ""

    rows_full, c_full, q_full = run(None, "full")
    assert c_full.get("BadRecords", "Malformed") == len(bad)
    parts = [run((i, 3), f"s{i}") for i in range(3)]
    assert sum(p[0] for p in parts) == rows_full == 300 - len(bad)
    assert [p[1].get("BadRecords", "Malformed") for p in parts] == \
        [sum(1 for b in bad if lo <= b < hi)
         for lo, hi in (shard_rows(300, i, 3, 64) for i in range(3))]
    # shards in order: their quarantine files concatenate to the single one
    assert "".join(p[2] for p in parts) == q_full


def test_shard_composes_with_start_row_and_refuses_stop_row(tmp_path):
    schema, jschema = _schemas()
    csv = _write_csv(tmp_path / "d.csv", 300)
    lo, hi = shard_rows(300, 1, 2, 64)
    cut = lo + 70
    got = ColumnarTable.from_chunks(list(iter_csv_chunks(
        csv, schema, ",", chunk_rows=64, shard=(1, 2), start_row=cut)))
    for use_native in (False, True):
        want = jtable.ColumnarTable.from_chunks(list(jtable.iter_csv_chunks(
            csv, jschema, ",", chunk_rows=64, use_native=use_native,
            shard=(1, 2), start_row=cut)))
        assert got.n_rows == want.n_rows == hi - cut
        for o in want.columns:
            np.testing.assert_array_equal(got.columns[o], want.columns[o])
    assert list(iter_csv_chunks(csv, schema, ",", chunk_rows=64,
                                shard=(1, 2), start_row=hi + 5)) == []
    stopped = list(iter_csv_chunks(csv, schema, ",", chunk_rows=64,
                                   stop_row=100))
    assert sum(c.n_rows for c in stopped) == 100
    assert stopped[-1].source_row_end == 100
    with pytest.raises(ValueError, match="not both"):
        list(iter_csv_chunks(csv, schema, ",", shard=(0, 2), stop_row=10))


def test_count_source_rows(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text("a,b\n\n  \nc,d\ne,f")
    assert count_source_rows(str(p)) == jtable.count_source_rows(str(p)) == 3


# --------------------------------------------------------------------------
# the sharded build
# --------------------------------------------------------------------------

def _port_shards(csv, schema, params, P, rdir, chunk=64, **kw):
    def shard(i):
        red = AllReducer(spec=ShardSpec(i, P), name="rf",
                         transport_dir=rdir, timeout_s=120)
        models = build_forest_from_stream(
            iter_csv_chunks(csv, schema, ",", chunk_rows=chunk,
                            shard=(i, P), **kw),
            schema, params, device="cpu", reducer=red)
        return [m.to_json() for m in models]
    out, errs = _threads(shard, P)
    assert not errs, errs
    return out


def _jax_shards(csv, jschema, params, P, rdir, chunk=64, use_native=False):
    def shard(i):
        red = JaxAllReducer(spec=JaxShardSpec(i, P), name="rf",
                            transport_dir=rdir, timeout_s=120)
        models = jforest.build_forest_from_stream(
            jtable.iter_csv_chunks(csv, jschema, ",", chunk_rows=chunk,
                                   use_native=use_native, shard=(i, P)),
            jschema, params, ctx=JaxMeshContext(jax_make_mesh(1)),
            reducer=red, fuse=False)
        return [m.to_json() for m in models]
    out, errs = _threads(shard, P)
    assert not errs, errs
    return out


@pytest.mark.parametrize("P,n", [(2, 401), (3, 90)])
def test_sharded_build_equals_the_reference_and_one_process(
        tmp_path, jax_one_device, P, n):
    """Two shards over 401 rows (a tail block), and three over 90 rows at
    64-row blocks, where one shard owns no block and still joins every
    collective."""
    schema, jschema = _schemas()
    csv = _write_csv(tmp_path / "d.csv", n)
    if P == 3:
        assert any(lo == hi for lo, hi in
                   (shard_rows(n, i, P, 64) for i in range(P)))
    single = [m.to_json() for m in build_forest(
        load_csv(csv, schema, ","), _params(), device="cpu")]
    got = _port_shards(csv, schema, _params(), P, str(tmp_path / "p"))
    for use_native in (False, True):
        want = _jax_shards(csv, jschema, _jax_params(), P,
                           str(tmp_path / f"j{use_native}"),
                           use_native=use_native)
        for i in range(P):
            assert got[i] == want[i] == single


def test_one_shard_pays_the_reference_collectives(tmp_path, jax_one_device):
    """At shard count 1 the sharded build is the single-process one and
    records the same collectives as the JAX package's: one a level (root
    and two more at depth 3) plus the row-count allgather."""
    schema, jschema = _schemas()
    csv = _write_csv(tmp_path / "d.csv", 400)
    with transfer_ledger() as led:
        got = build_forest_from_stream(
            iter_csv_chunks(csv, schema, ",", chunk_rows=128, shard=(0, 1)),
            schema, _params(), device="cpu",
            reducer=AllReducer(spec=ShardSpec(0, 1)))
    for use_native in (False, True):
        with jax_ledger() as jled:
            jforest.build_forest_from_stream(
                jtable.iter_csv_chunks(csv, jschema, ",", chunk_rows=128,
                                       use_native=use_native, shard=(0, 1)),
                jschema, _jax_params(),
                ctx=JaxMeshContext(jax_make_mesh(1)),
                reducer=JaxAllReducer(spec=JaxShardSpec(0, 1)), fuse=False)
        assert led.allreduces == jled.snapshot()["allreduces"] == 4
    assert led.ingest_snapshot() == {"native.blocks": 4, "native.rows": 400}
    assert [m.to_json() for m in got] == [m.to_json() for m in build_forest(
        load_csv(csv, schema, ","), _params(), device="cpu")]


def _rafo9s_params():
    cfg = load_config(os.path.join(RES, "rafo.properties"))
    return ForestParams(tree=_tree_params(cfg),
                        num_trees=cfg.get_int("dtb.num.trees"),
                        seed=cfg.get_int("dtb.random.seed"))


def test_rafo9s_over_two_shards_gives_the_fixture(tmp_path):
    """The rafo9s forest (bootstrap draws over the global row count, bad
    records skipped) trained over two thread shards at 777-row blocks."""
    schema = FeatureSchema.load(os.path.join(RES, "call_hangup.json"))
    csv = os.path.join(RAFO9S, "train.csv")
    want = [open(os.path.join(RAFO9S, f"tree_{i}.json")).read()
            for i in range(9)]
    got = _port_shards(csv, schema, _rafo9s_params(), 2,
                       str(tmp_path / "r"), chunk=777,
                       bad_records=BadRecordPolicy("skip"))
    assert got[0] == got[1] == want


def test_killed_shard_resumes_shard_relative(tmp_path):
    """Shard 1 dies after its first block; shard 0 fails at the next
    collective within its deadline.  Both resume from their own
    checkpoints (each carrying its shard spec) to the single-process
    trees; a resume under another shard count is refused."""
    schema, _ = _schemas()
    csv = _write_csv(tmp_path / "d.csv", 400)
    params = _params(trees=2)
    ref = [m.to_json() for m in build_forest(load_csv(csv, schema, ","),
                                             params, device="cpu")]
    mgrs = [CheckpointManager(str(tmp_path / f"ck{i}")) for i in range(2)]

    class Boom(RuntimeError):
        pass

    def killed_blocks(i):
        for bi, c in enumerate(iter_csv_chunks(csv, schema, ",",
                                               chunk_rows=64, shard=(i, 2))):
            if i == 1 and bi == 1:
                raise Boom("injected shard crash")
            yield c

    def crash(i):
        red = AllReducer(spec=ShardSpec(i, 2), name="rfc",
                         transport_dir=str(tmp_path / "r1"), timeout_s=3)
        build_forest_from_stream(killed_blocks(i), schema, params,
                                 device="cpu", reducer=red,
                                 checkpoint=mgrs[i], checkpoint_every=1)

    _, errs = _threads(crash, 2)
    assert isinstance(errs.get(1), Boom)
    assert isinstance(errs.get(0), RuntimeError) and \
        "never" in str(errs[0])
    for i in range(2):
        assert mgrs[i].restore()[2]["shard"] == {"index": i, "count": 2}
    assert not mgrs[1].restore()[2]["ingest_complete"]
    assert mgrs[0].restore()[2]["ingest_complete"]

    _, arrays, meta = mgrs[0].restore()
    with pytest.raises(ValueError, match="SAME process count"):
        TreeBuilder.from_stream(
            iter([]), schema, params.tree, device="cpu",
            reducer=AllReducer(spec=ShardSpec(0, 3),
                               transport_dir=str(tmp_path / "bad")),
            resume_state=(arrays, meta))
    with pytest.raises(ValueError, match="SAME process count"):
        TreeBuilder.from_stream(iter([]), schema, params.tree, device="cpu",
                                resume_state=(arrays, meta))

    def resume(i):
        _, arrays, meta = mgrs[i].restore()
        start = int(meta.get("source_rows_done") or 0)
        lo, hi = shard_rows(400, i, 2, 64)
        assert lo <= start <= hi
        red = AllReducer(spec=ShardSpec(i, 2), name="rfr",
                         transport_dir=str(tmp_path / "r2"), timeout_s=120)
        models = build_forest_from_stream(
            iter_csv_chunks(csv, schema, ",", chunk_rows=64, shard=(i, 2),
                            start_row=start),
            schema, params, device="cpu", reducer=red, checkpoint=mgrs[i],
            checkpoint_every=1, resume_state=(arrays, meta))
        return [m.to_json() for m in models]

    out, errs = _threads(resume, 2)
    assert not errs, errs
    assert out[0] == out[1] == ref


def test_allreduce_partials_equals_the_monolithic_baseline(tmp_path):
    """Each shard profiles its own blocks; after the partial sum every
    shard finalises the monolithic baseline, and the JAX package's sum of
    the same partials agrees."""
    schema, jschema = _schemas()
    csv = _write_csv(tmp_path / "d.csv", 401, bad_rows={10, 300})
    skip = BadRecordPolicy("skip")
    mono = BaselineBuilder(schema, device="cpu").update(
        load_csv(csv, schema, ",", bad_records=skip)).finalize()

    def shard(i):
        b = BaselineBuilder(schema, device="cpu")
        for c in iter_csv_chunks(csv, schema, ",", chunk_rows=64,
                                 bad_records=BadRecordPolicy("skip"),
                                 shard=(i, 3)):
            b.update(c)
        red = AllReducer(spec=ShardSpec(i, 3), name="base",
                         transport_dir=str(tmp_path / "r"), timeout_s=60)
        return allreduce_partials(b, reducer=red).finalize()

    def jshard(i, use_native):
        b = jbaseline.BaselineBuilder(jschema)
        for c in jtable.iter_csv_chunks(
                csv, jschema, ",", chunk_rows=64, use_native=use_native,
                bad_records=jtable.BadRecordPolicy("skip"), shard=(i, 3)):
            b.update(c)
        red = JaxAllReducer(spec=JaxShardSpec(i, 3),
                            name=f"base{int(use_native)}",
                            transport_dir=str(tmp_path / "j"), timeout_s=60)
        return jbaseline.allreduce_partials(b, reducer=red).finalize()

    got, errs = _threads(shard, 3)
    assert not errs, errs
    for use_native in (False, True):
        want, errs = _threads(lambda i: jshard(i, use_native), 3)
        assert not errs, errs
        for i in range(3):
            assert got[i].n_rows == want[i].n_rows == mono.n_rows == 399
            np.testing.assert_array_equal(got[i].counts, mono.counts)
            np.testing.assert_array_equal(got[i].counts, want[i].counts)
            assert got[i].to_sidecar()["baseline.json"] == \
                mono.to_sidecar()["baseline.json"]
    # one process: the identity; a numeric feature without min/max refuses
    solo = BaselineBuilder(schema, device="cpu")
    assert allreduce_partials(solo) is solo
    loose = dict(SCHEMA, fields=[dict(f) for f in SCHEMA["fields"]])
    del loose["fields"][2]["min"]
    red = AllReducer(spec=ShardSpec(0, 2), transport_dir=str(tmp_path / "x"))
    with pytest.raises(ValueError, match="min/max"):
        allreduce_partials(BaselineBuilder(FeatureSchema.from_dict(loose),
                                           device="cpu"), reducer=red)
