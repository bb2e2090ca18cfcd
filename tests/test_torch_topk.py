"""Kernel B5's plain version against the JAX package, on the CPU.

``topk_scan_torch`` (``avenir_tpu_torch/kernels/topk.py``) must equal the
JAX ``topk_scan`` (Pallas, interpret mode) and the XLA scan
(``ops/distance._topk_scan_kernel``) exactly — distances and indices — on
the same seeded inputs: the e-learning schema (Fn=4, Fc=0), the bench
schema (Fn=2, Fc=7) and an all-categorical one (Fn=0), both metrics,
duplicated train rows to force ties, k = 1, 7, 10 and k = n_train.  The
exact float32 FMA it is built on is held against rational arithmetic,
including crafted midpoint cases where a float64 emulation rounds wrong.
The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``.
"""

import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.core.schema import FeatureSchema
from avenir_tpu.core.table import ColumnarTable, load_csv_text
from avenir_tpu.ops.distance import DistanceComputer as JaxDistance
from avenir_tpu.ops.distance import _topk_scan_kernel
from avenir_tpu.ops.pallas.topk import topk_scan as jax_topk_scan
from avenir_tpu_torch.kernels import topk
from avenir_tpu_torch.ops.distance import fma_f32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")

BENCH_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "c1", "ordinal": 1, "dataType": "categorical", "feature": True,
     "cardinality": ["a", "b", "c"]},
    {"name": "c2", "ordinal": 2, "dataType": "categorical", "feature": True,
     "cardinality": ["x", "y", "z", "w"]},
    {"name": "n1", "ordinal": 3, "dataType": "int", "feature": True,
     "min": 0, "max": 600},
    {"name": "n2", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 0, "max": 100},
    {"name": "cls", "ordinal": 5, "dataType": "categorical",
     "cardinality": ["T", "F"]}]}
CAT_CARDS = (3, 5, 2)
ALLCAT_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"}] + [
    {"name": f"c{j}", "ordinal": j + 1, "dataType": "categorical",
     "feature": True, "cardinality": [str(v) for v in range(card)]}
    for j, card in enumerate(CAT_CARDS)] + [
    {"name": "cls", "ordinal": len(CAT_CARDS) + 1,
     "dataType": "categorical", "cardinality": ["T", "F"]}]}


def schema_of(name):
    if name == "elearn":
        return FeatureSchema.load(os.path.join(RES, "elearn.json"))
    return FeatureSchema.from_dict(BENCH_SCHEMA if name == "bench"
                                   else ALLCAT_SCHEMA)


def make_table(name, n, seed, dup=False):
    """n seeded rows in schema ``name``; with ``dup`` the second half of
    the rows repeats the first (identical distances force ties)."""
    schema = schema_of(name)
    rng = np.random.default_rng(seed)
    if name == "elearn":
        if RES not in sys.path:
            sys.path.insert(0, RES)
        from gen.elearn_gen import generate
        table = load_csv_text("\n".join(generate(n, seed)), schema)
    elif name == "bench":
        table = ColumnarTable(schema=schema, n_rows=n, columns={
            1: rng.integers(-1, 3, n).astype(np.int32),
            2: rng.integers(0, 4, n).astype(np.int32),
            3: rng.integers(0, 600, n).astype(np.float64),
            4: rng.integers(0, 100, n).astype(np.float64),
            5: rng.integers(0, 2, n).astype(np.int32)})
    else:
        cols = {j + 1: rng.integers(-1, c, n).astype(np.int32)
                for j, c in enumerate(CAT_CARDS)}
        cols[len(CAT_CARDS) + 1] = rng.integers(0, 2, n).astype(np.int32)
        table = ColumnarTable(schema=schema, n_rows=n, columns=cols)
    if dup:
        h = n // 2
        for o, col in table.columns.items():
            col = col.copy()
            col[h:2 * h] = col[:h]
            table.columns[o] = col
    return table


def encoded(name, metric, n_test, n_train, seed=0):
    comp = JaxDistance(schema_of(name), metric=metric, scale=1000)
    tn, toh = comp.encode(make_table(name, n_test, seed + 1))
    rn, roh = comp.encode(make_table(name, n_train, seed + 2, dup=True))
    return (tn, toh, rn, roh), (comp._n_cat, comp._denom, comp._fscale)


def xla_scan(arrays, k, metric, consts, tile=64):
    """The JAX package's XLA scan over ``tile``-row train tiles."""
    tn, toh, rn, roh = arrays
    n_train = rn.shape[0]
    T = -(-n_train // tile)
    pad = T * tile - n_train
    rn_t = np.pad(rn, ((0, pad), (0, 0))).reshape(T, tile, rn.shape[1])
    roh_t = np.pad(roh, ((0, pad), (0, 0))).reshape(T, tile, roh.shape[1])
    base = np.arange(T, dtype=np.int32) * tile
    nvalid = np.minimum(n_train - base, tile).astype(np.int32)
    d, i = _topk_scan_kernel(k, metric, *consts)(
        *(jnp.asarray(a) for a in (tn, toh, rn_t, roh_t, base, nvalid)))
    return np.asarray(d), np.asarray(i)


def port_scan(arrays, k, metric, consts):
    d, i = topk.topk_scan(*(torch.from_numpy(a) for a in arrays), k, metric,
                          *consts)
    return d.numpy(), i.numpy()


CASES = [(37, 101, 1), (37, 101, 7), (129, 700, 10), (20, 45, 45)]


@pytest.mark.parametrize("n_test,n_train,k", CASES,
                         ids=[f"t{a}r{b}k{c}" for a, b, c in CASES])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("name", ["elearn", "bench", "allcat"])
def test_plain_topk_equals_jax_pallas_and_xla(name, metric, n_test, n_train,
                                               k):
    arrays, consts = encoded(name, metric, n_test, n_train)
    got_d, got_i = port_scan(arrays, k, metric, consts)
    assert got_d.shape == (n_test, k) and got_i.dtype == np.int32
    pal_d, pal_i = (np.asarray(a) for a in jax_topk_scan(
        *(jnp.asarray(a) for a in arrays), k, metric, *consts,
        interpret=True))
    np.testing.assert_array_equal(got_d, pal_d)
    np.testing.assert_array_equal(got_i, pal_i)
    xla_d, xla_i = xla_scan(arrays, k, metric, consts)
    np.testing.assert_array_equal(got_d, xla_d)
    np.testing.assert_array_equal(got_i, xla_i)


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_plain_topk_ties_go_to_the_lowest_index(metric):
    """Every train row duplicated: each equal pair keeps its lower index
    first, whatever the tile boundaries of the plain scan."""
    arrays, consts = encoded("bench", metric, 50, 300)
    d, i = port_scan(arrays, 20, metric, consts)
    full_d = np.stack([port_scan((arrays[0][j:j + 1], arrays[1][j:j + 1],
                                  arrays[2], arrays[3]), 300, metric,
                                 consts)[0][0] for j in range(3)])
    assert (np.diff(d, axis=1) >= 0).all()
    ties = (d[:, 1:] == d[:, :-1])
    assert ties.any()
    assert (i[:, 1:][ties] > i[:, :-1][ties]).all()
    np.testing.assert_array_equal(d[:3], full_d[:, :20])


@pytest.mark.parametrize("pairs", [1, 7, 100_000])
def test_plain_topk_tile_size_does_not_change_the_answer(monkeypatch, pairs):
    arrays, consts = encoded("elearn", "euclidean", 33, 257)
    want = port_scan(arrays, 10, "euclidean", consts)
    monkeypatch.setattr(topk, "_TORCH_TILE_PAIRS", pairs)
    got = port_scan(arrays, 10, "euclidean", consts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_topk_on_cpu_tensors_runs_the_plain_version():
    arrays, consts = encoded("bench", "euclidean", 9, 40)
    before = topk.launches
    got = port_scan(arrays, 5, "euclidean", consts)
    plain = topk.topk_scan_torch(*(torch.from_numpy(a) for a in arrays), 5,
                                 "euclidean", *consts)
    assert topk.launches == before
    np.testing.assert_array_equal(got[0], plain[0].numpy())
    np.testing.assert_array_equal(got[1], plain[1].numpy())


def test_topk_k_above_train_count_leaves_inf_slots():
    arrays, consts = encoded("elearn", "manhattan", 4, 3)
    d, i = port_scan(arrays, 5, "manhattan", consts)
    assert np.isinf(d[:, 3:]).all() and (i[:, 3:] == -1).all()
    assert np.isfinite(d[:, :3]).all() and (i[:, :3] >= 0).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "metric"])
def test_topk_refuses_bad_inputs(bad):
    arrays, consts = encoded("bench", "euclidean", 4, 8)
    t = [torch.from_numpy(a) for a in arrays]
    metric = "euclidean"
    if bad == "dtype":
        t[1] = t[1].to(torch.float32)
    elif bad == "shape":
        t[2] = t[2][:, :1]
    else:
        metric = "cosine"
    with pytest.raises(ValueError):
        topk.topk_scan(*t, 3, metric, *consts)


@pytest.mark.parametrize("k,size,reg", [(1, 8, True), (7, 8, True),
                                        (10, 16, True), (64, 64, True),
                                        (65, 0, False)])
def test_kernel_list_size_and_row_path(k, size, reg):
    """The kernel's register list sizes (k above 64 keeps the list in
    global memory) and the register-row limit (Fn <= 8, Fc <= 64)."""
    assert topk.list_size(k) == size
    Fn, Fc = (4, 0) if reg else (16, 64)
    assert topk.register_rows(Fn, Fc) is reg
    assert topk.register_rows(8, 65) is False


# --------------------------------------------------------------------------
# the exact float32 FMA
# --------------------------------------------------------------------------

def round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational ``x``, ties to an even last bit."""
    y = np.float32(float(x))
    cands = [np.nextafter(y, np.float32(-np.inf)), y,
             np.nextafter(y, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    pick = [c for c, dd in zip(cands, dist) if dd == best]
    if len(pick) > 1:
        pick = [c for c in pick if int(c.view(np.uint32)) % 2 == 0]
    return pick[0]


def exact_fma(a, b, c):
    return np.array([round_f32(Fraction(float(x)) * Fraction(float(y))
                               + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def crafted_midpoints():
    """a = b = 1 + k 2^-12: a*a is a float32 midpoint when k is odd, and
    c = ±2^-80 breaks the tie one way or the other — below float64's
    resolution, so float32(float64(a)*b + c) rounds the tie to even."""
    k = np.arange(1, 4096, 2, dtype=np.float64)
    a = (1.0 + k * 2.0 ** -12).astype(np.float32)
    c = np.where(np.arange(k.size) % 2 == 0, 2.0 ** -80,
                 -(2.0 ** -80)).astype(np.float32)
    return a, a.copy(), c


def test_fma_f32_exact_on_crafted_midpoints():
    a, b, c = crafted_midpoints()
    want = exact_fma(a, b, c)
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    # the double-rounding emulation gets these wrong, which is why
    # fma_f32 does not use it
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).sum() >= a.size // 8


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3, 1e12])
def test_fma_f32_exact_on_random_operands(scale):
    rng = np.random.default_rng(int(scale * 7) % 1000 + 3)
    n = 3000
    a = (rng.standard_normal(n) * scale).astype(np.float32)
    b = (rng.standard_normal(n) * scale).astype(np.float32)
    c = (rng.standard_normal(n) * scale * scale).astype(np.float32)
    c[::7] = -(a[::7].astype(np.float64) * b[::7]).astype(np.float32)
    c[::11] = 0.0
    want = exact_fma(a, b, c)
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
