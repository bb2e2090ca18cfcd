"""The level histogram's plain PyTorch version (avenir_tpu_torch/kernels/
histogram.py) against the JAX package on the CPU: bit-identical to
``models.forest._count_body`` and to the Pallas ``forest_level_counts`` in
interpret mode, with inactive (-1/-2) and out-of-range node ids, unknown
classes, zero weights, uint8 and float32 weights and empty inputs; and the
port's single-tree counts (T = 1 with the unknown-class fold) equal to the
reference's ``make_level_count_kernel``.  Every comparison is exact."""

import numpy as np
import pytest
import torch

import jax

from avenir_tpu.models.forest import _count_body
from avenir_tpu.models.tree import make_level_count_kernel
from avenir_tpu.ops.pallas.histogram import forest_level_counts as pallas_counts

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import ColumnarTable
from avenir_tpu_torch.kernels import histogram
from avenir_tpu_torch.models.tree import TreeBuilder, TreeParams

_COUNT_JIT = jax.jit(_count_body, static_argnums=(4, 5, 6))

# (n, T, N, S, B, C): the shapes tests/test_pallas_kernels.py holds the
# Pallas kernel at, and the rafo forest's level shape
SHAPES = [
    (1000, 3, 4, 5, 3, 2),
    (64, 1, 1, 1, 1, 1),
    (17, 2, 3, 19, 3, 2),
    (3000, 16, 8, 19, 3, 2),
    (2000, 9, 8, 19, 2, 2),
]


def _inputs(seed, n, T, N, S, B, C, edges):
    """Seeded inputs; ``edges`` adds node ids -2, -1 and N, class -1 and
    branch B (each must add nothing) besides the zero weights a bootstrap
    draw always has."""
    rng = np.random.default_rng(seed)
    nid = rng.integers(-2 if edges else 0, N + 1 if edges else N, (n, T)
                       ).astype(np.int32)
    br = rng.integers(0, B + 1 if edges else B, (n, S)).astype(np.int32)
    cls = rng.integers(-1 if edges else 0, C, (n,)).astype(np.int32)
    w = rng.integers(0, 5, (n, T)).astype(np.uint8)
    return nid, br, cls, w


def _plain(nid, br, cls, w, N, B, C):
    return histogram.forest_level_counts_torch(
        torch.from_numpy(nid), torch.from_numpy(br), torch.from_numpy(cls),
        torch.from_numpy(w), N, B, C).numpy()


@pytest.mark.parametrize("edges", [False, True], ids=["valid", "edges"])
@pytest.mark.parametrize("wdtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "n{}T{}N{}S{}B{}C{}"
                         .format(*s))
def test_plain_matches_count_body_and_pallas(shape, wdtype, edges):
    n, T, N, S, B, C = shape
    nid, br, cls, w = _inputs(sum(shape), *shape, edges)
    w = w.astype(wdtype)
    got = _plain(nid, br, cls, w, N, B, C)
    assert got.shape == (T, N, S, B, C) and got.dtype == np.float32
    want = np.asarray(_COUNT_JIT(nid, br, cls, w, N, B, C))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(pallas_counts(nid, br, cls, w, N, B, C,
                                      interpret=True)))
    # every active (row, tree) adds its weight once per split with a valid
    # branch — the count total, from the inputs alone
    ok_tree = (nid >= 0) & (nid < N) & (cls >= 0)[:, None]
    per_row = ((br >= 0) & (br < B)).sum(axis=1)
    assert got.sum() == (w.astype(np.float64) * ok_tree * per_row[:, None]
                         ).sum()


def test_plain_row_chunks_do_not_change_counts(monkeypatch):
    nid, br, cls, w = _inputs(3, 5000, 9, 8, 19, 2, 2, True)
    whole = _plain(nid, br, cls, w, 8, 2, 2)
    monkeypatch.setattr(histogram, "_TORCH_CHUNK_ELEMS", 1000)
    np.testing.assert_array_equal(_plain(nid, br, cls, w, 8, 2, 2), whole)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    nid, br, cls, w = _inputs(5, 700, 4, 3, 7, 2, 3, True)
    before = histogram.launches
    got = histogram.forest_level_counts(
        torch.from_numpy(nid), torch.from_numpy(br), torch.from_numpy(cls),
        torch.from_numpy(w), 3, 2, 3)
    np.testing.assert_array_equal(got.numpy(), _plain(nid, br, cls, w, 3, 2,
                                                       3))
    assert histogram.launches == before


def test_empty_input_gives_zeros():
    z = torch.zeros((0, 2), dtype=torch.int32)
    out = histogram.forest_level_counts(
        z, torch.zeros((0, 3), dtype=torch.int32),
        torch.zeros((0,), dtype=torch.int32),
        torch.zeros((0, 2), dtype=torch.uint8), 4, 3, 2)
    assert out.shape == (2, 4, 3, 3, 2) and not out.any()
    want = np.asarray(pallas_counts(
        np.zeros((0, 2), np.int32), np.zeros((0, 3), np.int32),
        np.zeros((0,), np.int32), np.zeros((0, 2), np.float32), 4, 3, 2,
        interpret=True))
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("bad", ["node_dtype", "weight_dtype", "rows",
                                 "cls_dim", "zero_nodes"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    nid, br, cls, w = (torch.from_numpy(a) for a in
                       _inputs(1, 10, 2, 3, 4, 2, 2, False))
    n_nodes = 3
    if bad == "node_dtype":
        nid = nid.long()
    elif bad == "weight_dtype":
        w = w.to(torch.float64)
    elif bad == "rows":
        br = br[:9]
    elif bad == "cls_dim":
        cls = cls[:, None]
    else:
        n_nodes = 0
    with pytest.raises(ValueError, match="forest_level_counts"):
        histogram.forest_level_counts(nid, br, cls, w, n_nodes, 2, 2)


def test_cuda_launch_rejects_non_contiguous_input():
    nid, br, cls, w = (torch.from_numpy(a) for a in
                       _inputs(2, 10, 2, 3, 4, 2, 2, False))
    with pytest.raises(ValueError, match="contiguous"):
        histogram._launch(nid.t().contiguous().t(), br, cls, w, 3, 2, 2)


# --------------------------------------------------------------------------
# the single tree: T = 1 with make_level_count_kernel's unknown-class fold
# --------------------------------------------------------------------------

_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "c1", "ordinal": 1, "dataType": "categorical", "feature": True,
     "maxSplit": 2, "cardinality": ["a", "b", "c"]},
    {"name": "n1", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 600, "splitScanInterval": 120},
    {"name": "cls", "ordinal": 3, "dataType": "categorical",
     "cardinality": ["T", "F", "M"]},
]}


def _builder(cls_codes, seed=0):
    n = len(cls_codes)
    rng = np.random.default_rng(seed)
    table = ColumnarTable(
        schema=FeatureSchema.from_dict(_SCHEMA), n_rows=n,
        columns={1: rng.integers(-1, 3, n).astype(np.int32),
                 2: rng.integers(0, 600, n).astype(np.float64),
                 3: np.asarray(cls_codes, np.int32)})
    return TreeBuilder(table, TreeParams(seed=seed), device="cpu")


def _reference_single(b, nid, w, n_nodes):
    S, B, C = b.branches.shape[1], b.split_set.max_branches, b.C
    return np.asarray(make_level_count_kernel(S, B, C)(
        nid, b.branches.numpy(), b.cls_codes.numpy(), w, n_nodes),
        dtype=np.float64)


@pytest.mark.parametrize("chunk", [None, 100])
def test_single_tree_counts_match_make_level_count_kernel(chunk):
    rng = np.random.default_rng(11)
    n, N = 900, 5
    b = _builder(rng.integers(-1, 3, n))         # about a quarter unknown
    nid = rng.integers(-2, N, n).astype(np.int32)
    w = rng.integers(0, 4, n).astype(np.float32)
    got = b.level_counts(torch.from_numpy(nid[:, None].copy()),
                         torch.from_numpy(w[:, None].astype(np.uint8)), N,
                         chunk=chunk)
    np.testing.assert_array_equal(got, _reference_single(b, nid, w, N))


def test_single_tree_and_forest_differ_on_unknown_class_as_reference():
    """node ids [0,1,1], classes [1,-1,0], branches [0,1,0], unit weights:
    the single-tree count keeps the unknown-class row (in node 0's last
    class), the forest count drops it — in both packages."""
    b = _builder([1, -1, 0])
    b.branches = torch.tensor([[0], [1], [0]], dtype=torch.int32)
    nid = np.array([0, 1, 1], np.int32)
    ones = np.ones(3, np.float32)
    single = b.level_counts(torch.from_numpy(nid[:, None].copy()),
                            torch.ones((3, 1), dtype=torch.uint8), 2)
    want = _reference_single(b, nid, ones, 2)
    np.testing.assert_array_equal(single, want)
    assert single.sum() == 3 and single[0, 0, 1, 2] == 1
    forest = _plain(nid[:, None], b.branches.numpy(), b.cls_codes.numpy(),
                    ones[:, None], 2, 2, 3)
    np.testing.assert_array_equal(
        forest, np.asarray(_COUNT_JIT(nid[:, None], b.branches.numpy(),
                                      b.cls_codes.numpy(), ones[:, None], 2,
                                      2, 3)))
    assert forest.sum() == 2
