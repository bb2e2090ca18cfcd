"""The port's KNN modules against the JAX package, on the CPU.

``DistanceComputer`` (``avenir_tpu_torch/ops/distance.py``): the encoded
arrays, ``pairwise`` (the sameTypeSimilarity order) on the golden knn data
and at 1000 x 2000 e-learning rows, ``pairwise_topk`` (kernel B5's path,
several test chunks) and its ledger counts.  ``models/knn.py``: kernel
scores, top-k classification over per-row and shared candidate sets, the
decision threshold, the cost-based classifier and the three regression
modes.  Exact equality everywhere.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.core.schema import FeatureSchema
from avenir_tpu.core.table import load_csv_text
from avenir_tpu.models import knn as jax_knn
from avenir_tpu.ops.distance import DistanceComputer as JaxDistance
from avenir_tpu.ops.pallas.dispatch import force_backend
from avenir_tpu_torch.core.schema import FeatureSchema as PortSchema
from avenir_tpu_torch.core.table import load_csv_text as port_load
from avenir_tpu_torch.models import knn as port_knn
from avenir_tpu_torch.ops import distance as port_distance
from avenir_tpu_torch.ops.distance import DistanceComputer
from avenir_tpu_torch.utils.tracing import transfer_ledger
from avenir_tpu_torch.weights import knn_train_from_arrays

from test_torch_topk import (ALLCAT_SCHEMA, BENCH_SCHEMA, make_table,
                             schema_of)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
ELEARN = os.path.join(RES, "elearn.json")


def elearn_rows(n, seed):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.elearn_gen import generate
    return "\n".join(generate(n, seed))


def port_schema(name):
    if name == "elearn":
        return PortSchema.load(ELEARN)
    return PortSchema.from_dict(BENCH_SCHEMA if name == "bench"
                                else ALLCAT_SCHEMA)


def port_table(jax_table, name):
    """The JAX package's table as the port's (same columns)."""
    from avenir_tpu_torch.core.table import ColumnarTable
    return ColumnarTable(schema=port_schema(name), n_rows=jax_table.n_rows,
                         columns=dict(jax_table.columns),
                         str_columns=dict(jax_table.str_columns))


def pair(name, n_test, n_train, seed=0, dup=True):
    """(jax test, jax train, port test, port train) tables."""
    test = make_table(name, n_test, seed + 1)
    train = make_table(name, n_train, seed + 2, dup=dup)
    return test, train, port_table(test, name), port_table(train, name)


# --------------------------------------------------------------------------
# DistanceComputer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["elearn", "bench", "allcat"])
def test_encode_equals_jax(name):
    table = make_table(name, 300, 7)
    want_n, want_oh = JaxDistance(schema_of(name)).encode(table)
    got_n, got_oh = DistanceComputer(port_schema(name), device="cpu").encode(
        port_table(table, name))
    assert got_n.dtype == np.float32 and got_oh.dtype == np.int8
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got_oh, want_oh)
    if name != "elearn":       # unknown codes (-1) leave their block empty
        assert (got_oh.sum(1) < len(DistanceComputer(
            port_schema(name), device="cpu").cat_fields)).any()


def test_table_class_codes_and_take_rows_match_jax():
    text = elearn_rows(40, 3)
    want = load_csv_text(text, FeatureSchema.load(ELEARN)).take_rows(5, 17)
    got = port_load(text, port_schema("elearn")).take_rows(5, 17)
    assert got.n_rows == want.n_rows == 12
    np.testing.assert_array_equal(got.class_codes(), want.class_codes())
    assert got.str_columns == want.str_columns
    for o, col in want.columns.items():
        np.testing.assert_array_equal(got.columns[o], col)


def golden_tables():
    rows = elearn_rows(130, 14).split("\n")
    schema = FeatureSchema.load(ELEARN)
    train = load_csv_text("\n".join(rows[:100]), schema)
    test = load_csv_text("\n".join(rows[100:]), schema)
    return (test, train, port_load("\n".join(rows[100:]), port_schema(
        "elearn")), port_load("\n".join(rows[:100]), port_schema("elearn")))


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("size", ["golden", "1000x2000"])
def test_pairwise_equals_jax(size, metric):
    if size == "golden":
        test, train, ptest, ptrain = golden_tables()
    else:
        schema = FeatureSchema.load(ELEARN)
        test = load_csv_text(elearn_rows(1000, 5), schema)
        train = load_csv_text(elearn_rows(2000, 6), schema)
        ptest, ptrain = port_table(test, "elearn"), port_table(train,
                                                               "elearn")
    want = JaxDistance(schema_of("elearn"), metric=metric).pairwise(test,
                                                                    train)
    got = DistanceComputer(port_schema("elearn"), metric=metric,
                           device="cpu").pairwise(ptest, ptrain, tile=384)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["bench", "allcat"])
def test_pairwise_equals_jax_on_mixed_schemas(name):
    test, train, ptest, ptrain = pair(name, 90, 140)
    for metric in ("euclidean", "manhattan"):
        want = JaxDistance(schema_of(name), metric=metric).pairwise(test,
                                                                    train)
        got = DistanceComputer(port_schema(name), metric=metric,
                               device="cpu").pairwise(ptest, ptrain)
        np.testing.assert_array_equal(got, want)


def test_pairwise_shape_where_xla_takes_the_topk_order():
    """The JAX package's full-matrix euclidean takes its summation order
    from the shape: at 200 x 500 e-learning rows it is the top-k order (FMA
    dot), not the paired dot it takes at the golden, 300 x 1000 and
    1000 x 2000 shapes.  The port fixes the paired order for ``pairwise``,
    so here it differs from the JAX package in 858 of 100,000 distances
    (ROADMAP queue C), while the top-k order matches it exactly."""
    schema = FeatureSchema.load(ELEARN)
    test = load_csv_text(elearn_rows(200, 5), schema)
    train = load_csv_text(elearn_rows(500, 6), schema)
    comp = JaxDistance(schema)
    want = comp.pairwise(test, train)
    got = DistanceComputer(port_schema("elearn"), device="cpu").pairwise(
        port_table(test, "elearn"), port_table(train, "elearn"))
    assert int((got != want).sum()) == 858
    arrays = [torch.from_numpy(a) for a in (*comp.encode(test),
                                            *comp.encode(train))]
    topk_order = port_distance.euclid_topk(
        *arrays, comp._n_cat, comp._denom, comp._fscale).numpy()
    np.testing.assert_array_equal(topk_order.astype(np.int32), want)


@pytest.mark.parametrize("size,want", [("golden", (7, 0)),
                                       ("1000x2000", (964, 47))])
def test_reference_pairwise_and_topk_orders_disagree(size, want):
    """The JAX package's two KNN paths disagree with each other on
    e-learning data (ROADMAP queue C): the k = 7 nearest taken from
    ``pairwise`` (paired dot) differ from ``pairwise_topk`` (FMA dot) in
    ``want`` = (distances, indices) of the 210 / 7,000 entries.  The port
    mirrors each path, so it shows the same disagreement."""
    if size == "golden":
        test, train, ptest, ptrain = golden_tables()
    else:
        schema = FeatureSchema.load(ELEARN)
        test = load_csv_text(elearn_rows(1000, 5), schema)
        train = load_csv_text(elearn_rows(2000, 6), schema)
        ptest, ptrain = port_table(test, "elearn"), port_table(train,
                                                               "elearn")
    for comp, te, tr in ((JaxDistance(schema_of("elearn")), test, train),
                         (DistanceComputer(port_schema("elearn"),
                                           device="cpu"), ptest, ptrain)):
        full = comp.pairwise(te, tr)
        d, i = comp.pairwise_topk(te, tr, 7)
        order = np.argsort(full, axis=1, kind="stable")[:, :7]
        got = (int((d != np.take_along_axis(full, order, 1)).sum()),
               int((i != order).sum()))
        assert got == want


TOPK_CASES = [("elearn", 300, 1000, 7, 128), ("bench", 65, 900, 10, 32),
              ("allcat", 40, 300, 9, 16), ("bench", 17, 5, 9, 64)]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("case", TOPK_CASES,
                         ids=[f"{c[0]}-t{c[1]}r{c[2]}k{c[3]}c{c[4]}"
                              for c in TOPK_CASES])
def test_pairwise_topk_equals_jax(case, metric, backend):
    name, n_test, n_train, k, chunk = case
    test, train, ptest, ptrain = pair(name, n_test, n_train)
    with force_backend(backend):
        want_d, want_i = JaxDistance(schema_of(name), metric=metric) \
            .pairwise_topk(test, train, k, test_chunk=chunk)
    got_d, got_i = DistanceComputer(port_schema(name), metric=metric,
                                    device="cpu").pairwise_topk(
        ptest, ptrain, k, test_chunk=chunk)
    assert got_d.dtype == np.int32 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)


def test_pairwise_topk_empty_sides():
    test, train, ptest, ptrain = pair("bench", 0, 50)
    comp = DistanceComputer(port_schema("bench"), device="cpu")
    d, i = comp.pairwise_topk(ptest, ptrain, 5)
    assert d.shape == (0, 5) and i.shape == (0, 5)
    _, _, ptest, pempty = pair("bench", 6, 0)
    d, i = comp.pairwise_topk(ptest, pempty, 5)
    assert d.shape == (6, 0) and i.shape == (6, 0)


def test_pairwise_topk_dispatch_and_transfer_counts():
    """One B5 call and 2 H2D per test chunk, one concat dispatch for more
    than one chunk, 2 D2H per call; the warm train cache drops the train
    upload (2 H2D) on the second call."""
    _, _, ptest, ptrain = pair("bench", 64, 2500)
    comp = DistanceComputer(port_schema("bench"), device="cpu")
    with transfer_ledger() as cold:
        d1, i1 = comp.pairwise_topk(ptest, ptrain, 7, test_chunk=32)
    assert cold.dispatches == 3 and cold.dispatch_sites["knn.topk"] == 2
    assert cold.d2h_transfers == 2
    assert cold.h2d_transfers == 2 + 2 * 2
    assert cold.backend_snapshot() == {"knn.topk.torch": 2}
    with transfer_ledger() as warm:
        d2, i2 = comp.pairwise_topk(ptest, ptrain, 7, test_chunk=32)
    assert warm.dispatches == 3 and warm.d2h_transfers == 2
    assert warm.h2d_transfers == 2 * 2
    assert warm.h2d_bytes < cold.h2d_bytes
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    with transfer_ledger() as one:
        comp.pairwise_topk(ptest, ptrain, 5)
    assert one.dispatches == 1 and one.d2h_transfers == 2


def test_train_cache_rebinds_to_a_new_table():
    _, _, ptest, ptrain = pair("elearn", 20, 200)
    _, _, _, other = pair("elearn", 20, 150, seed=9)
    comp = DistanceComputer(port_schema("elearn"), device="cpu")
    comp.pairwise_topk(ptest, ptrain, 3)
    d, i = comp.pairwise_topk(ptest, other, 3)
    fresh = DistanceComputer(port_schema("elearn"), device="cpu")
    np.testing.assert_array_equal((d, i), fresh.pairwise_topk(ptest, other,
                                                              3))
    assert i.max() < 150


def test_jax_encoded_train_set_primes_the_port(monkeypatch):
    """weights.knn_train_from_arrays: the JAX package's encode of the train
    set is the port's model — no port encode of the train table runs."""
    test, train, ptest, ptrain = pair("bench", 30, 400)
    jc = JaxDistance(schema_of("bench"))
    want = jc.pairwise_topk(test, train, 7)
    comp = DistanceComputer(port_schema("bench"), device="cpu")
    rn, roh = knn_train_from_arrays(comp, ptrain, *jc.encode(train))
    assert rn.dtype == torch.float32 and roh.dtype == torch.int8
    assert rn.device.type == "cpu" and tuple(roh.shape) == (400, 7)
    real_encode = comp.encode
    monkeypatch.setattr(comp, "encode", lambda t: (
        pytest.fail("train re-encoded") if t is ptrain else real_encode(t)))
    got = comp.pairwise_topk(ptest, ptrain, 7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        knn_train_from_arrays(comp, ptrain, *jc.encode(test))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        DistanceComputer(port_schema("elearn"))


def test_unknown_metric_raises():
    _, _, ptest, ptrain = pair("bench", 5, 20)
    comp = DistanceComputer(port_schema("bench"), metric="cosine",
                            device="cpu")
    for call in (lambda: comp.pairwise(ptest, ptrain),
                 lambda: comp.pairwise_topk(ptest, ptrain, 3)):
        with pytest.raises(ValueError, match="metric"):
            call()


# --------------------------------------------------------------------------
# models/knn.py
# --------------------------------------------------------------------------

KERNELS = [("none", -1), ("linearMultiplicative", -1),
           ("linearAdditive", -1), ("gaussian", 7), ("gaussian", 300)]


@pytest.mark.parametrize("kernel,param", KERNELS)
def test_kernel_scores_equal_jax(kernel, param):
    d = np.concatenate([np.arange(0, 3000), [2 ** 20, 2 ** 30 - 1]]
                       ).astype(np.int32)
    want = np.asarray(jax_knn.kernel_scores(jnp.asarray(d), kernel, param))
    got = port_knn.kernel_scores(torch.from_numpy(d), kernel, param).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def neighbor_lists(seed=0, n=240, m=12, C=3):
    rng = np.random.default_rng(seed)
    dmat = rng.integers(0, 60, (n, m)).astype(np.int64)
    dmat[rng.random((n, m)) < 0.1] = jax_knn.PAD_DISTANCE
    cmat = rng.integers(0, C, (n, m)).astype(np.int32)
    fmat = np.where(rng.random((n, m)) < 0.5, rng.random((n, m)),
                    -1.0).astype(np.float32)
    return dmat, cmat, fmat


PARAM_CASES = {
    "plain": {},
    "threshold": dict(decision_threshold=1.3),
    "cost": dict(use_cost_based_classifier=True, false_pos_cost=1,
                 false_neg_cost=3),
    "idw": dict(inverse_distance_weighted=True),
    "classcond": dict(class_cond_weighted=True),
    "classcond_idw": dict(class_cond_weighted=True,
                          inverse_distance_weighted=True),
}


def assert_results_equal(got, want):
    assert got.pred_class == want.pred_class
    for f in ("class_distr", "weighted_class_distr", "pos_class_prob",
              "pred_value"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel,param", KERNELS)
@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_classify_grouped_equals_jax(case, kernel, param):
    dmat, cmat, fmat = neighbor_lists()
    kw = dict(top_match_count=7, kernel_function=kernel, kernel_param=param,
              pos_class="b", neg_class="a", **PARAM_CASES[case])
    want = jax_knn.classify_grouped(dmat, cmat, ["a", "b", "c"],
                                    jax_knn.KnnParams(**kw), fmat)
    got = port_knn.classify_grouped(dmat, cmat, ["a", "b", "c"],
                                    port_knn.KnnParams(**kw), fmat)
    assert_results_equal(got, want)


@pytest.mark.parametrize("kernel,param", KERNELS)
def test_classify_topk_and_shared_set_equal_jax(kernel, param):
    rng = np.random.default_rng(3)
    dist = rng.integers(0, 40, (50, 80)).astype(np.int32)   # ties abound
    train_cls = rng.integers(0, 2, 80).astype(np.int32)
    kw = dict(top_match_count=9, kernel_function=kernel, kernel_param=param,
              pos_class="pass", neg_class="fail")
    cv = ["fail", "pass"]
    assert_results_equal(
        port_knn.classify(dist, train_cls, cv, port_knn.KnnParams(**kw)),
        jax_knn.classify(dist, train_cls, cv, jax_knn.KnnParams(**kw)))
    nd = np.sort(dist, axis=1)[:, :9]
    ncls = train_cls[np.argsort(dist, axis=1, kind="stable")[:, :9]]
    assert_results_equal(
        port_knn.classify_topk(nd, ncls, cv, port_knn.KnnParams(**kw)),
        jax_knn.classify_topk(nd, ncls, cv, jax_knn.KnnParams(**kw)))


@pytest.mark.parametrize("method", ["average", "median", "linearRegression"])
def test_regress_grouped_equals_jax(method):
    dmat, _, _ = neighbor_lists(seed=5)
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 500, dmat.shape).astype(np.float64)
    kw = dict(top_match_count=5, prediction_mode="regression",
              regression_method=method)
    extra = {}
    if method == "linearRegression":
        extra = dict(regr_input=rng.random(dmat.shape[0]) * 10,
                     neighbor_input=rng.random(dmat.shape) * 10)
    want = jax_knn.regress_grouped(dmat, vals, jax_knn.KnnParams(**kw),
                                   **extra)
    got = port_knn.regress_grouped(dmat, vals, port_knn.KnnParams(**kw),
                                   **extra)
    np.testing.assert_array_equal(got, want)
    shared = dmat[:, :8]
    train_vals = rng.integers(0, 99, 8).astype(np.float64)
    train_regr = rng.random(8) * 10 if extra else None
    np.testing.assert_array_equal(
        port_knn.regress(shared, train_vals, port_knn.KnnParams(**kw),
                         regr_input=extra.get("regr_input"),
                         train_regr_input=train_regr),
        jax_knn.regress(shared, train_vals, jax_knn.KnnParams(**kw),
                        regr_input=extra.get("regr_input"),
                        train_regr_input=train_regr))


def test_sigmoid_and_unknown_kernels_raise_like_jax():
    dmat, cmat, _ = neighbor_lists(n=4)
    for mod in (jax_knn, port_knn):
        with pytest.raises(NotImplementedError):
            mod.classify_grouped(dmat, cmat, ["a", "b", "c"], mod.KnnParams(
                kernel_function="sigmoid"))
        with pytest.raises(ValueError):
            mod.classify_grouped(dmat, cmat, ["a", "b", "c"], mod.KnnParams(
                kernel_function="cosine"))
