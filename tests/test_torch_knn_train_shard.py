"""The lock-step KNN merge over processes, port against the JAX package on
the CPU: ``AllReducer.merge_topk`` (the top-k merge kernel's plain version
here) gives the JAX package's merged lists for ties across shards, shards
shorter than k, empty shards and dead (+inf, -1) slots; the train-sharded
``pairwise_topk`` (shards as threads over the file transport) equals the
single-process scan and the JAX package's sharded scan, with one
collective a test chunk; real +inf distances give the single-process
answer, where the JAX package's merge lifts a dead slot of a later shard
to a train row (ROADMAP queue C); and ``knnPipeline
nen.train.shard=true`` at shard count 1 writes the default job's bytes."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.core.table import ColumnarTable as JaxTable
from avenir_tpu.ops.distance import DistanceComputer as JaxDistance
from avenir_tpu.parallel.collectives import AllReducer as JaxAllReducer
from avenir_tpu.parallel.distributed import ShardSpec as JaxShardSpec
from avenir_tpu.parallel.mesh import (MeshContext as JaxMeshContext,
                                      make_mesh as jax_make_mesh,
                                      set_runtime_context as jax_set_context)

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import ColumnarTable
from avenir_tpu_torch.kernels import topk as ptopk
from avenir_tpu_torch.ops.distance import DistanceComputer
from avenir_tpu_torch.parallel.collectives import AllReducer
from avenir_tpu_torch.parallel.distributed import ShardSpec, shard_rows
from avenir_tpu_torch.utils.tracing import transfer_ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELEARN_KNN = os.path.join(ROOT, "tests", "torch_fixtures", "elearn_knn")

KNN_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "x", "ordinal": 1, "dataType": "double", "feature": True,
     "min": 0, "max": 10},
    {"name": "c", "ordinal": 2, "dataType": "categorical", "feature": True,
     "cardinality": ["p", "q"]},
    {"name": "cls", "ordinal": 3, "dataType": "categorical",
     "cardinality": ["A", "B"]}]}


@pytest.fixture()
def jax_one_device():
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
    if errs:
        raise next(iter(errs.values()))
    return out


def _merge_both(lists, k, tmp_path):
    """Each shard's (d, global i) list through both packages'
    ``merge_topk`` over the file transport, shards as threads."""
    P = len(lists)

    def port(i):
        red = AllReducer(spec=ShardSpec(i, P), name="m",
                         transport_dir=str(tmp_path / "p"), timeout_s=60)
        return red.merge_topk(*lists[i], k, device="cpu")

    def ref(i):
        red = JaxAllReducer(spec=JaxShardSpec(i, P), name="m",
                            transport_dir=str(tmp_path / "j"), timeout_s=60)
        return red.merge_topk(*lists[i], k)

    return _threads(port, P), _threads(ref, P)


def _sorted_list(rng, nt, w, lo, hi, pool):
    """A B5-shaped list: w distinct train rows of [lo, hi) per test row,
    distances drawn from ``pool`` (repeats: ties), ascending by (d, i)."""
    d = np.empty((nt, w), np.float32)
    i = np.empty((nt, w), np.int32)
    for r in range(nt):
        rows = rng.choice(np.arange(lo, hi), size=w, replace=False)
        dist = rng.choice(pool, size=w)
        order = np.lexsort((rows, dist))
        d[r], i[r] = dist[order], rows[order]
    return d, i


@pytest.mark.parametrize("case", ["ties", "short", "empty", "dead_first",
                                  "one_shard", "k_above_total"])
def test_merge_equals_the_reference(tmp_path, case):
    rng = np.random.default_rng(len(case))
    pool = np.array([0.0, 1.0, 2.0, 2.0, 3.0, 7.0], np.float32)
    nt, k = 9, 5
    sizes = {"ties": [40, 40, 40], "short": [40, 3, 40],
             "empty": [40, 0, 25], "dead_first": [40, 40],
             "one_shard": [40], "k_above_total": [2, 1, 0]}[case]
    lists, base = [], 0
    for n in sizes:
        w = min(k, n)
        lists.append(_sorted_list(rng, nt, w, base, base + n, pool))
        base += n
    if case == "dead_first":
        # shard 0 (base 0) with dead tails: (+inf, -1) in both packages
        d, i = lists[0]
        d[:, 3:], i[:, 3:] = np.inf, -1
    got, want = _merge_both(lists, k, tmp_path)
    for s in range(len(sizes)):
        np.testing.assert_array_equal(got[s][0], want[s][0])
        np.testing.assert_array_equal(got[s][1], want[s][1])
        assert got[s][0].shape == (nt, min(k, sum(min(k, n)
                                                  for n in sizes)))


@pytest.mark.parametrize("P", [65, 130])
def test_merge_above_64_processes_equals_a_stable_sort(P):
    """More lists than one merge launch takes (64): the merge runs in
    rounds and still equals a numpy stable sort of the concatenated lists
    (ties to the lowest global index, dead slots (+inf, -1) dead) and the
    JAX package's host sort.  The P lists come from a stubbed allgather."""
    rng = np.random.default_rng(P)
    pool = np.array([0.0, 1.0, 2.0, 2.0, 3.0, 7.0], np.float32)
    nt, k, rows = 6, 4, 9
    lists = []
    for s in range(P):
        d, i = _sorted_list(rng, nt, k, s * rows, (s + 1) * rows, pool)
        if s % 7 == 3:                    # a short shard: dead tails
            d[:, 2:], i[:, 2:] = np.inf, -1
        lists.append((d, i))
    cd = np.concatenate([d for d, _ in lists], axis=1)
    ci = np.concatenate([i for _, i in lists], axis=1)
    order = np.argsort(cd, axis=1, kind="stable")[:, :k]
    want_d = np.take_along_axis(cd, order, 1)
    want_i = np.where(np.isinf(want_d), -1, np.take_along_axis(ci, order, 1))
    red = AllReducer(spec=ShardSpec(0, 1))
    red.allgather = lambda obj: lists
    with transfer_ledger() as led:
        d, i = red.merge_topk(*lists[0], k, device="cpu")
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(i, want_i)
    assert led.backend_snapshot() == {"knn.process_merge.torch": 1}
    jred = JaxAllReducer(spec=JaxShardSpec(0, 1))
    jred.allgather = lambda obj: lists
    jd, ji = jred.merge_topk(*lists[0], k)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    # the rounds: ceil(P / 64) merges, then one more
    calls = []
    orig = ptopk.topk_merge

    def count(ds, *a, **kw):
        calls.append(len(ds))
        return orig(ds, *a, **kw)
    ptopk.topk_merge = count
    try:
        ptopk.topk_merge_rounds(
            [torch.from_numpy(x) for x, _ in lists],
            [torch.from_numpy(x) for _, x in lists], k)
    finally:
        ptopk.topk_merge = orig
    assert max(calls) <= 64 and sum(calls) == P + -(-P // 64)


def test_merge_launches_the_kernel_form_recorded(tmp_path):
    """The merge records its dispatch site and the form that ran (the
    plain version on the CPU) and one collective."""
    lists = [_sorted_list(np.random.default_rng(1), 4, 3, 0, 10,
                          np.arange(5, dtype=np.float32))]
    red = AllReducer(spec=ShardSpec(0, 1))
    with transfer_ledger() as led:
        d, i = red.merge_topk(*lists[0], 3, device="cpu")
    np.testing.assert_array_equal(d, lists[0][0])
    np.testing.assert_array_equal(i, lists[0][1])
    assert led.allreduces == 1
    assert led.backend_snapshot() == {"knn.process_merge.torch": 1}


def _tables(n_train=173, n_test=37, extreme=()):
    def tbl(n, seed, schema, cls):
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 10, n).astype(np.float64)   # many ties
        for r, v in extreme:
            if seed == 1 and r < n:
                x[r] = v
        return cls(schema=schema, n_rows=n, columns={
            1: x, 2: rng.integers(0, 2, n).astype(np.int32),
            3: rng.integers(0, 2, n).astype(np.int32)},
            str_columns={0: [f"r{i}" for i in range(n)]})
    ps, js = FeatureSchema.from_dict(KNN_SCHEMA), \
        JaxSchema.from_dict(KNN_SCHEMA)
    return (ps, tbl(n_train, 1, ps, ColumnarTable),
            tbl(n_test, 2, ps, ColumnarTable),
            js, tbl(n_train, 1, js, JaxTable), tbl(n_test, 2, js, JaxTable))


def _sharded_port(schema, train, test, k, P, rdir, chunk=16):
    def shard(i):
        red = AllReducer(spec=ShardSpec(i, P), name="knn",
                         transport_dir=rdir, timeout_s=60)
        lo, hi = shard_rows(train.n_rows, i, P)
        return DistanceComputer(schema, device="cpu").pairwise_topk(
            test, train.take_rows(lo, hi), k, test_chunk=chunk,
            shard_reducer=red, shard_base=lo)
    return _threads(shard, P)


def _sharded_jax(schema, train, test, k, P, rdir, chunk=16):
    def shard(i):
        red = JaxAllReducer(spec=JaxShardSpec(i, P), name="knn",
                            transport_dir=rdir, timeout_s=60)
        lo, hi = shard_rows(train.n_rows, i, P)
        return JaxDistance(schema).pairwise_topk(
            test, train.take_rows(lo, hi), k, test_chunk=chunk,
            shard_reducer=red, shard_base=lo)
    return _threads(shard, P)


@pytest.mark.parametrize("P,k", [(2, 9), (3, 9), (4, 60), (7, 1)])
def test_train_sharded_topk_equals_one_process_and_the_reference(
        tmp_path, jax_one_device, P, k):
    """Train rows over P shards (at k = 60 some shards hold fewer than k
    rows); rows repeat values, so ties cross shards."""
    ps, ptrain, ptest, js, jtrain, jtest = _tables()
    ref_d, ref_i = DistanceComputer(ps, device="cpu").pairwise_topk(
        ptest, ptrain, k, test_chunk=16)
    got = _sharded_port(ps, ptrain, ptest, k, P, str(tmp_path / "p"))
    want = _sharded_jax(js, jtrain, jtest, k, P, str(tmp_path / "j"))
    for i in range(P):
        np.testing.assert_array_equal(got[i][0], ref_d)
        np.testing.assert_array_equal(got[i][1], ref_i)
        np.testing.assert_array_equal(got[i][0], want[i][0])
        np.testing.assert_array_equal(got[i][1], want[i][1])


def test_one_collective_a_test_chunk():
    ps, ptrain, ptest = _tables()[:3]
    ref = DistanceComputer(ps, device="cpu").pairwise_topk(ptest, ptrain, 9,
                                                           test_chunk=16)
    ptopk.merge_launches = 0
    with transfer_ledger() as led:
        got = DistanceComputer(ps, device="cpu").pairwise_topk(
            ptest, ptrain, 9, test_chunk=16,
            shard_reducer=AllReducer(spec=ShardSpec(0, 1)), shard_base=0)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert led.allreduces == 3                      # ceil(37 / 16)
    assert led.site_snapshot()["knn.process_merge"] == 3
    assert ptopk.merge_launches == 0                # no card here


def test_infinite_distances_give_the_single_process_answer(
        tmp_path, jax_one_device):
    """Train rows at +-3e38 in the second shard have infinite distances:
    the scan leaves their slots dead (+inf, -1), and the merge keeps them
    dead, as one process does.  The JAX package's merge lifts shard 1's
    dead slots to train row ``base - 1`` (its ``i + shard_base`` applies to
    dead slots too): a reference fault, pinned here (ROADMAP queue C)."""
    extreme = [(r, v) for r in range(100, 173)
               for v in ((3e38,) if r % 2 else (-3e38,))]
    ps, ptrain, ptest, js, jtrain, jtest = _tables(extreme=extreme)
    k = 120                      # above the 100 rows at finite distance
    with np.errstate(invalid="ignore"):
        ref_d, ref_i = DistanceComputer(ps, device="cpu").pairwise_topk(
            ptest, ptrain, k, test_chunk=16)
        got = _sharded_port(ps, ptrain, ptest, k, 2, str(tmp_path / "p"))
        want = _sharded_jax(js, jtrain, jtest, k, 2, str(tmp_path / "j"))
        jax_one = JaxDistance(js).pairwise_topk(jtest, jtrain, k,
                                                test_chunk=16)
    np.testing.assert_array_equal(ref_i, jax_one[1])
    assert (ref_i[:, 100:] == -1).all()
    lo1 = shard_rows(173, 1, 2)[0]
    for i in range(2):
        np.testing.assert_array_equal(got[i][1], ref_i)
        np.testing.assert_array_equal(got[i][0][:, :100], ref_d[:, :100])
        # the reference's sharded lists: finite part equal, dead slots
        # lifted to train row lo1 - 1
        np.testing.assert_array_equal(want[i][1][:, :100], ref_i[:, :100])
        assert (want[i][1][:, 100:] == lo1 - 1).all()


def test_knn_pipeline_train_shard_at_count_one_is_the_default_job(tmp_path):
    """``nen.train.shard=true`` in one process: the merge is the identity,
    and the predictions and counters are the default job's byte for
    byte, over the elearn_knn fixture (inter-set) and one of its files
    (intra-set)."""
    schema = os.path.join(ROOT, "resource", "elearn.json")
    props = os.path.join(ROOT, "resource", "knn.properties")
    data = os.path.join(ELEARN_KNN, "data")
    for tag, src in (("inter", data),
                     ("intra", os.path.join(data, "tr_part"))):
        outs = {}
        for mode, extra in (("plain", []),
                            ("shard", ["-Dnen.train.shard=true"])):
            out = str(tmp_path / f"{tag}_{mode}")
            assert port_run.main(["knnPipeline", f"-Dconf.path={props}",
                                  f"-Dsts.same.schema.file.path={schema}",
                                  "-Dplatform=cpu", *extra, src, out]) == 0
            with open(os.path.join(out, "part-r-00000")) as fh:
                text = fh.read()
            with open(out + ".counters.json") as fh:
                counters = json.load(fh)
            outs[mode] = (text, counters)
        plain, shard = outs["plain"], outs["shard"]
        assert shard[0] == plain[0]
        for g in ("Neighborhood", "Validation"):
            assert shard[1].get(g) == plain[1].get(g)
        assert shard[1]["Collectives"]["AllReduces"] == \
            shard[1]["Dispatches"]["knn.topk"]
