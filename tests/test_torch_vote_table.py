"""The vote kernel's table form (``avenir_tpu_torch/kernels/vote.py``
``table_form``) against the JAX package, on the CPU.

The CUDA kernel (``csrc/vote.cu``) runs the table form on the card, where
``chip_smoke.py`` holds it against the plain version.  Here a plain
PyTorch emulation of its lookup — one bin a feature, ``#{u < v}`` (NaN:
the last bin), the AND of the features' numeric and categorical path
masks, the lowest set bit (path 0 when none) — reads the ``table_form``
arrays and must give tallies and votes IDENTICAL to the JAX
``_member_votes_body`` / ``_ensemble_vote_body`` and the port's
``ensemble_vote_torch``; the int8 form IDENTICAL to
``_quantized_vote_body``.  Inputs hit every edge of the bins: NaN and
+-inf values, values equal to a threshold, codes -1 and >= C, negative
integer weights, the pad members of ``shard_stacked_arrays`` (S = 2, 4),
the published forest's shape and P > 32 (several mask words).

Tolerance: exact (integer-valued float32 tallies).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.models.forest import _ensemble_vote_body, _member_votes_body
from avenir_tpu.serving.quantized import _quantized_vote_body
from avenir_tpu_torch.kernels import vote

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAFO9 = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9")
RAFO9Q = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9q")


def _forest(rng, T, P, F, C, K, weights="int"):
    """A random stacked forest (real paths, the always-match sentinel,
    never-match pad paths) with thresholds on a small integer grid and
    some -inf / +inf bounds."""
    lo = rng.integers(-4, 4, (T, P, F)).astype(np.float32)
    hi = lo + rng.integers(0, 5, (T, P, F)).astype(np.float32)
    lo[rng.random((T, P, F)) < 0.1] = -np.inf
    hi[rng.random((T, P, F)) < 0.1] = np.inf
    num_r = rng.random((T, P, F)) < 0.5
    cat_m = rng.random((T, P, F, C)) < 0.6
    cat_r = rng.random((T, P, F)) < 0.4
    cls_oh = np.zeros((T, P, K), np.float32)
    cls_oh[np.arange(T)[:, None], np.arange(P)[None, :],
           rng.integers(0, K, (T, P))] = 1.0
    for t in range(T):
        real = int(rng.integers(1, P))
        lo[t, real], hi[t, real] = -np.inf, np.inf
        num_r[t, real] = cat_r[t, real] = False
        lo[t, real + 1:], hi[t, real + 1:] = np.inf, -np.inf
        num_r[t, real + 1:], cat_r[t, real + 1:] = True, False
        cls_oh[t, real + 1:] = 0.0
    wvec = (np.ones(T, np.float32) if weights == "ones"
            else rng.integers(-3, 6, T).astype(np.float32))
    return lo, hi, num_r, cat_m, cat_r, cls_oh, wvec


def _rows(rng, n, F, C):
    """n request rows whose values sit on the thresholds' grid (so many
    equal a threshold), between its points, at +-inf and NaN; codes from
    -2 to C + 2."""
    pool = np.concatenate([np.arange(-5, 10, 0.5), [-np.inf, np.inf, np.nan]])
    vals = rng.choice(pool, (n, F)).astype(np.float32)
    codes = rng.integers(-2, C + 3, (n, F)).astype(np.int32)
    return vals, codes


def table_tallies(vals, codes, tables, cls_oh, wvec):
    """The table lookup in plain PyTorch: (n, K) float32 tallies."""
    u, ntab, ctab = (torch.from_numpy(np.asarray(a)) for a in tables)
    F, _ = u.shape
    T, _, NB, PW = ntab.shape
    C = ctab.shape[2] - 1
    v = torch.as_tensor(vals).to(torch.float32)
    c = torch.as_tensor(codes).long()
    b = (u[None] < v[:, :, None]).sum(2)                       # (n, F)
    b = torch.where(torch.isnan(v), NB - 1, b)
    cb = torch.where(c < 0, C, c.clamp(max=C - 1))
    f = torch.arange(F)[None, :]
    words = 0xFFFFFFFF
    nm = ntab.long()[:, f, b] & words                          # (T,n,F,PW)
    cm = ctab.long()[:, f, cb] & words
    m = torch.full(nm.shape[:2] + (PW,), words, dtype=torch.int64)
    for j in range(F):
        m &= nm[:, :, j] & cm[:, :, j]
    nz = m != 0
    wi = nz.to(torch.uint8).argmax(-1)                         # (T, n)
    mw = torch.gather(m, 2, wi[..., None])[..., 0]
    bit = torch.log2((mw & -mw).clamp_min(1).double()).long()
    hit = torch.where(nz.any(-1), wi * 32 + bit, 0).T          # (n, T)
    sel = torch.from_numpy(cls_oh)[torch.arange(T)[None, :], hit]
    return (sel * torch.from_numpy(wvec)[None, :, None]).sum(1)


def _jax(fn, *arrays):
    return np.asarray(fn(*[jnp.asarray(a) for a in arrays]))


CASES = [
    # T, P, F, C, K, n, weights
    (9, 17, 4, 4, 3, 400, "int"),      # the published forest's shape
    (9, 17, 4, 4, 3, 400, "ones"),     # ties
    (6, 70, 3, 5, 4, 300, "int"),      # P > 32: three mask words
    (5, 33, 5, 40, 6, 200, "int"),     # P = 33 and two categorical words
]


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "T{}P{}F{}C{}K{}n{}{}".format(*c))
def test_table_lookup_matches_jax_body(case, S):
    """Each tree slice's table tallies equal the JAX member tally; the
    slices' summed tallies finalize to the JAX vote and the port's plain
    vote, at min_odds 1.0 and 1.5."""
    T, P, F, C, K, n, weights = case
    rng = np.random.default_rng(CASES.index(case) * 10 + S)
    stacked = _forest(rng, T, P, F, C, K, weights)
    vals, codes = _rows(rng, n, F, C)
    total = torch.zeros((n, K))
    for part in vote.shard_stacked_arrays(stacked, S):
        tables = vote.table_form(*part[:5])
        assert tables is not None
        got = table_tallies(vals, codes, tables, part[5], part[6])
        want = _jax(_member_votes_body, vals, codes, *part)
        np.testing.assert_array_equal(got.numpy(), want)
        total += got
    for min_odds in (1.0, 1.5):
        got = vote.vote_finalize_torch(total, min_odds).numpy()
        np.testing.assert_array_equal(
            got, _jax(_ensemble_vote_body, vals, codes, *stacked,
                      np.float32(min_odds)))
        np.testing.assert_array_equal(
            got, vote.ensemble_vote_torch(
                torch.from_numpy(vals), torch.from_numpy(codes),
                *(torch.from_numpy(a) for a in stacked), min_odds).numpy())


def _quantized(rng, T, P, F, C, K):
    """A random int8 forest (thresholds on the full int8 range, -128 / 127
    sentinels, pad paths q_lo = 127) and rows over every int8 value."""
    lo, hi, num_r, cat_m, cat_r, cls_oh, wvec = _forest(rng, T, P, F, C, K)
    q_lo = rng.integers(-128, 127, (T, P, F))
    q_hi = np.minimum(q_lo + rng.integers(0, 120, (T, P, F)), 127)
    q_lo = np.where(np.isneginf(lo), -128, np.where(np.isposinf(lo), 127,
                                                     q_lo)).astype(np.int8)
    q_hi = np.where(np.isposinf(hi), 127, np.where(np.isneginf(hi), -128,
                                                    q_hi)).astype(np.int8)
    return q_lo, q_hi, num_r, cat_m, cat_r, cls_oh.astype(np.uint8), wvec


@pytest.mark.parametrize("shape", [(9, 17, 4, 4, 3), (4, 40, 3, 6, 5)],
                         ids=["rafo", "P40"])
def test_quantized_table_lookup_matches_jax_body(shape):
    T, P, F, C, K = shape
    rng = np.random.default_rng(T * P)
    stacked = _quantized(rng, T, P, F, C, K)
    qv = np.concatenate([np.arange(-128, 128), rng.integers(-128, 128, 512)])
    qv = np.stack([np.roll(qv, 37 * f) for f in range(F)], 1).astype(np.int8)
    qc = rng.integers(-1, C + 3, qv.shape).astype(np.int8)
    tables = vote.table_form(*stacked[:5])
    assert tables is not None
    tallies = table_tallies(qv, qc, tables, stacked[5].astype(np.float32),
                            stacked[6])
    for min_odds in (1.0, 1.5):
        got = vote.vote_finalize_torch(tallies, min_odds).numpy()
        np.testing.assert_array_equal(
            got, _jax(_quantized_vote_body, qv, qc, *stacked,
                      np.float32(min_odds)))
        np.testing.assert_array_equal(
            got, vote.quantized_vote_torch(
                torch.from_numpy(qv), torch.from_numpy(qc),
                *(torch.from_numpy(a) for a in stacked), min_odds).numpy())


def _rafo9_model(quantized):
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.forest import EnsembleModel
    from avenir_tpu_torch.models.tree import DecisionTreeModel
    from avenir_tpu_torch.weights import load_model_dir
    if quantized:
        from avenir_tpu_torch.serving.quantized import load_quantized
        from avenir_tpu_torch.serving.registry import ModelRegistry
        qf = load_quantized(ModelRegistry(os.path.join(RAFO9Q, "registry")),
                            "rafo9", 1)
        return qf.prepare("cpu").model
    fs = FeatureSchema.load(os.path.join(ROOT, "resource", "call_hangup.json"))
    ens = EnsembleModel([DecisionTreeModel(pl, fs, device="cpu")
                         for pl in load_model_dir(RAFO9)], device="cpu")
    return ens._stacked


def _random_model(shape, nan=False):
    T, P, F, C, K = shape
    stacked = list(_forest(np.random.default_rng(1), T, P, F, C, K))
    if nan:
        stacked[0][0, 0, 0], stacked[2][0, 0, 0] = np.nan, True
    return vote.prepare_vote_model(*stacked, "cpu")


@pytest.mark.parametrize("name,form", [
    ("rafo9", "table"), ("rafo9q", "table"),
    ("wide", "scan"),            # chip_smoke.py's wide shape: tables > 48 KB
    ("F17", "scan"),             # more features than the kernel holds
    ("nan_threshold", "scan"),   # a restricted NaN bound has no bin
    ("rafo_shape", "table")])
def test_vote_form_follows_the_shape(name, form):
    if name in ("rafo9", "rafo9q"):
        model = _rafo9_model(name == "rafo9q")
        assert model.shape[:3] == (9, 17, 4)
    else:
        shape = {"wide": (64, 257, 16, 16, 8), "F17": (2, 3, 17, 2, 2),
                 "nan_threshold": (9, 17, 4, 4, 3),
                 "rafo_shape": (9, 17, 4, 4, 3)}[name]
        model = _random_model(shape, nan=name == "nan_threshold")
    assert vote.vote_form(model) == form
    if form == "table":
        assert 0 < model.table_bytes() <= 8 * 1024    # a few KB
        assert model.u.shape[1] & (model.u.shape[1] - 1) == 0
