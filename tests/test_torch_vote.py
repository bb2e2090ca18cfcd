"""The port's ensemble vote (avenir_tpu_torch/kernels/vote.py) against the
JAX package's: the plain PyTorch version must give int32 votes IDENTICAL to
``avenir_tpu.models.forest._ensemble_vote_body`` and to the Pallas
``ensemble_vote`` in interpret mode.  The CUDA kernel itself runs only on
the card (chip_smoke.py); here its packed predicate form is held against
the same oracle through a line-by-line numpy transcription of the
kernel's loops.

Tolerance: exact.  Vote tallies are sums of integer-valued float32 weights,
so every summation order gives the same bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.models.forest import _ensemble_vote_body
from avenir_tpu.ops.pallas.vote import ensemble_vote as pallas_ensemble_vote
from avenir_tpu_torch.kernels import vote


def _stacked(rng, T, P, F, C, K, n, weights="int"):
    """Random stacked forest (stacked_host layout: real paths, the
    always-match sentinel, never-match pad paths) and n request rows with
    NaNs, negative codes and codes >= C."""
    lo = rng.integers(-4, 4, (T, P, F)).astype(np.float32)
    hi = lo + rng.integers(0, 6, (T, P, F)).astype(np.float32)
    lo[rng.random((T, P, F)) < 0.1] = -np.inf
    hi[rng.random((T, P, F)) < 0.1] = np.inf
    num_r = rng.random((T, P, F)) < 0.4
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
    if weights == "ones":      # equal weights: exact ties are common
        wvec = np.ones(T, np.float32)
    else:                      # negative integer weights included
        wvec = rng.integers(-3, 6, T).astype(np.float32)
    vals = rng.integers(-6, 10, (n, F)).astype(np.float32)
    vals[rng.random((n, F)) < 0.08] = np.nan
    codes = rng.integers(-2, C + 3, (n, F)).astype(np.int32)
    return (lo, hi, num_r, cat_m, cat_r, cls_oh, wvec), vals, codes


def _jax_vote(stacked, vals, codes, min_odds):
    return np.asarray(_ensemble_vote_body(
        jnp.asarray(vals), jnp.asarray(codes),
        *[jnp.asarray(a) for a in stacked], jnp.float32(min_odds)))


def _torch_vote(stacked, vals, codes, min_odds):
    return vote.ensemble_vote_torch(
        torch.from_numpy(vals), torch.from_numpy(codes),
        *[torch.from_numpy(a) for a in stacked], min_odds).numpy()


CASES = [
    # T, P, F, C, K, n, weights
    (9, 17, 4, 4, 3, 257, "int"),     # the published forest's shape
    (9, 17, 4, 4, 3, 257, "ones"),    # ties
    (6, 5, 3, 2, 2, 13, "ones"),      # K = 2, even T: top == second ties
    (5, 9, 6, 7, 5, 101, "int"),      # K = 5
    (4, 6, 3, 3, 5, 1, "int"),        # a single row
    (4, 6, 3, 3, 2, 0, "int"),        # no rows
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "T{}P{}F{}C{}K{}n{}{}"
                         .format(*c))
@pytest.mark.parametrize("min_odds", [1.0, 1.5])
def test_plain_vote_matches_jax_body(case, min_odds):
    *shape, n, weights = case
    rng = np.random.default_rng(CASES.index(case) * 10 + int(min_odds * 2))
    stacked, vals, codes = _stacked(rng, *shape, n, weights)
    got = _torch_vote(stacked, vals, codes, min_odds)
    want = _jax_vote(stacked, vals, codes, min_odds)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3]],
                         ids=["rafo", "K2_ties", "K5"])
def test_plain_vote_matches_pallas_interpret(case):
    *shape, n, weights = case
    rng = np.random.default_rng(7)
    stacked, vals, codes = _stacked(rng, *shape, n, weights)
    got = _torch_vote(stacked, vals, codes, 1.2)
    want = np.asarray(pallas_ensemble_vote(
        jnp.asarray(vals), jnp.asarray(codes),
        *[jnp.asarray(a) for a in stacked], jnp.float32(1.2),
        interpret=True))
    np.testing.assert_array_equal(got, want)


def test_veto_and_ties_are_exercised():
    """The cases above really hit the veto index K and first-max ties."""
    rng = np.random.default_rng(3)
    stacked, vals, codes = _stacked(rng, 6, 5, 3, 2, 2, 400, "ones")
    out = _torch_vote(stacked, vals, codes, 1.5)
    assert (out == 2).any() and (out < 2).any()


def _kernel_loops(vals, codes, stacked, min_odds):
    """csrc/vote.cu's per-row loops transcribed to numpy over the packed
    form that prepare_vote_model uploads for CUDA devices."""
    lo, hi, num_r, cat_m, cat_r, cls_oh, w = stacked
    T, P, F, C = cat_m.shape
    K = cls_oh.shape[2]
    flags, catw, cls = vote.kernel_form(num_r, cat_m, cat_r, cls_oh)
    catw = catw.view(np.uint32)
    out = np.zeros(len(vals), np.int32)
    for r in range(len(vals)):
        tally = np.zeros(K, np.float32)
        for t in range(T):
            hit = 0
            for q in range(P):
                ok = True
                for f in range(F):
                    if not ok:
                        break
                    if flags[t, q, f] & 1:
                        x = vals[r, f]
                        ok = bool(x > lo[t, q, f] and x <= hi[t, q, f])
                    if ok and flags[t, q, f] & 2:
                        c = int(codes[r, f])
                        s = min(c, C - 1)
                        ok = c >= 0 and bool(
                            (int(catw[t, q, f, s >> 5]) >> (s & 31)) & 1)
                if ok:
                    hit = q
                    break
            if cls[t, hit] >= 0:
                tally[cls[t, hit]] += w[t]
        best = int(np.argmax(tally))
        second = max([tally[k] for k in range(K) if k != best],
                     default=np.float32(-np.inf))
        veto = np.float32(min_odds) > 1 and (
            tally[best] / np.maximum(np.float32(second), np.float32(1e-12))
            <= np.float32(min_odds))
        out[r] = K if veto else best
    return out


@pytest.mark.parametrize("shape", [(9, 17, 4, 4, 3), (3, 4, 2, 40, 6)],
                         ids=["rafo", "two_mask_words"])
def test_kernel_packed_form_matches_jax_body(shape):
    rng = np.random.default_rng(11)
    stacked, vals, codes = _stacked(rng, *shape, 60)
    for min_odds in (1.0, 1.5):
        np.testing.assert_array_equal(
            _kernel_loops(vals, codes, stacked, min_odds),
            _jax_vote(stacked, vals, codes, min_odds))


def test_wrapper_on_cpu_tensors_runs_plain_version():
    rng = np.random.default_rng(5)
    stacked, vals, codes = _stacked(rng, 9, 17, 4, 4, 3, 50)
    model = vote.prepare_vote_model(*stacked, "cpu")
    assert model.cls is None          # kernel form is built for CUDA only
    before = vote.launches
    got = vote.ensemble_vote(torch.from_numpy(vals), torch.from_numpy(codes),
                             model, 1.5).numpy()
    assert vote.launches == before    # no kernel launch on the CPU
    np.testing.assert_array_equal(got, _jax_vote(stacked, vals, codes, 1.5))


def test_prepare_rejects_non_onehot_classes():
    rng = np.random.default_rng(6)
    stacked, _, _ = _stacked(rng, 3, 4, 2, 3, 3, 1)
    bad = list(stacked)
    bad[5] = bad[5].copy()
    bad[5][0, 0] = [1.0, 1.0, 0.0]
    with pytest.raises(ValueError, match="one-hot"):
        vote.prepare_vote_model(*bad, "cpu")
