"""The Naive Bayes slice's primitives against the JAX package on the CPU:

* every function of ``avenir_tpu_torch/ops/histogram.py`` against
  ``avenir_tpu/ops/histogram.py`` on the same seeded inputs (invalid and
  out-of-range codes, masks): counts bit-equal; ``class_moments`` bit-equal
  where its float32 sums are exact integers (below 2^24) and within rtol
  1e-6 of the JAX package's otherwise (the BLAS library's order is not
  XLA's); ``entropy`` and ``gini`` bit-equal;
* ``utils/xla_math.xla_exp_f32`` against ``jax.numpy.exp`` (XLA's CPU
  float32 exp): bit-equal on a strided sweep over every float32 bit
  pattern, on every float32 in the windows where the result overflows,
  underflows to 0 or crosses the smallest normal, and on the special
  values.  ``python tests/test_torch_bayes_ops.py --full`` sweeps all 2^32
  patterns (about 8 minutes on 8 CPU cores);
* the tokenizer against the JAX package's, on the Lucene cases of
  ``tests/test_bayes_text.py`` and on seeded random strings.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avenir_tpu.ops import histogram as J
from avenir_tpu.text import wordcount as jwc

from avenir_tpu_torch.ops import histogram as T
from avenir_tpu_torch.text import wordcount as twc
from avenir_tpu_torch.utils.xla_math import xla_exp_f32

# (n, F, C, B) shapes, each with codes outside every alphabet
SHAPES = [(1, 1, 1, 1), (7, 3, 2, 5), (1000, 4, 3, 7), (5000, 6, 4, 33)]


def _codes(seed, n, F, C, B):
    rng = np.random.default_rng(seed)
    cc = rng.integers(-1, C + 2, n).astype(np.int32)
    bc = rng.integers(-2, B + 3, (n, F)).astype(np.int32)
    mask = rng.random(n) < 0.8
    return cc, bc, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_class_bin_histogram(shape, masked):
    n, F, C, B = shape
    cc, bc, m = _codes(n + F, n, F, C, B)
    m = m if masked else None
    want = J.class_bin_histogram(cc, bc, C, B, m)
    got = T.class_bin_histogram(_t(cc), _t(bc), C, B,
                                None if m is None else _t(m))
    _bits_equal(got.numpy(), want)
    # the one-hot oracle of both packages (an unknown class is a zero
    # one-hot row)
    want1 = J._class_bin_histogram_onehot(cc, bc, C, B, m)
    got1 = T._class_bin_histogram_onehot(_t(cc), _t(bc), C, B,
                                         None if m is None else _t(m))
    _bits_equal(got1.numpy(), want1)


@pytest.mark.parametrize("chunk", [1, 7, 777, 1 << 18])
def test_class_bin_histogram_chunked(chunk):
    cc, bc, m = _codes(3, 3000, 4, 3, 9)
    want = J.class_bin_histogram_chunked(cc, bc, 3, 9, m, chunk=chunk)
    got = T.class_bin_histogram_chunked(_t(cc), _t(bc), 3, 9, _t(m),
                                        chunk=chunk)
    _bits_equal(got.numpy(), want)
    _bits_equal(got.numpy(), T.class_bin_histogram(_t(cc), _t(bc), 3, 9,
                                                   _t(m)).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_feature_bin_counts(shape):
    n, F, _, B = shape
    _, bc, m = _codes(n * 3, n, F, 1, B)
    _bits_equal(T.feature_bin_counts(_t(bc), B, _t(m)).numpy(),
                J.feature_bin_counts(bc, B, m))


@pytest.mark.parametrize("shape", SHAPES)
def test_joint_histogram(shape):
    n, _, A, B = shape
    cc, bc, m = _codes(n * 5, n, 1, A, B)
    _bits_equal(T.joint_histogram(_t(cc), _t(bc[:, 0]), A, B,
                                  _t(m)).numpy(),
                J.joint_histogram(cc, bc[:, 0], A, B, m))


@pytest.mark.parametrize("masked", [False, True])
def test_class_moments_exact_integers(masked):
    """Integer values whose every sum stays below 2^24: both packages'
    float32 contractions are exact, so bit-equal; the float64 form the
    port's train uses gives the same integers."""
    cc, _, m = _codes(11, 2000, 1, 3, 1)
    vals = np.random.default_rng(12).integers(0, 80, (2000, 3)) \
        .astype(np.float32)
    m = m if masked else None
    tm = None if m is None else _t(m)
    want = np.asarray(J.class_moments(cc, vals, 3, m))
    assert want.max() < 2 ** 24
    got = T.class_moments(_t(cc), _t(vals), 3, tm)
    _bits_equal(got.numpy(), want)
    got64 = T.class_moments(_t(cc), _t(vals), 3, tm, dtype=torch.float64)
    np.testing.assert_array_equal(got64.numpy(), want.astype(np.float64))


def test_class_moments_float_sums_within_rtol():
    cc, _, m = _codes(13, 5000, 1, 3, 1)
    vals = np.random.default_rng(14).normal(0, 100, (5000, 4)) \
        .astype(np.float32)
    want = np.asarray(J.class_moments(cc, vals, 3, m))
    got = T.class_moments(_t(cc), _t(vals), 3, _t(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("width", [1, 2, 5, 10])
def test_entropy_and_gini(width):
    rng = np.random.default_rng(width)
    p = rng.random((64, width)).astype(np.float32)
    p /= p.sum(axis=1, keepdims=True)
    p[0, 0] = 0.0
    p[1] = 0.0
    _bits_equal(T.entropy(_t(p)).numpy(), J.entropy(jnp.asarray(p)))
    _bits_equal(T.gini(_t(p)).numpy(), J.gini(jnp.asarray(p)))
    # along another axis
    _bits_equal(T.entropy(_t(p.T.copy()), axis=0).numpy(),
                J.entropy(jnp.asarray(p.T), axis=0))


# ---- xla_exp_f32 --------------------------------------------------------

_JAX_EXP = jax.jit(jnp.exp)


def _exp_mismatches(bits: np.ndarray) -> np.ndarray:
    """The float32 inputs (given as uint32 bit patterns) whose
    xla_exp_f32 differs from XLA's CPU exp in any bit (NaN equals NaN)."""
    x = bits.view(np.float32)
    want = np.asarray(_JAX_EXP(x))
    got = xla_exp_f32(torch.from_numpy(x)).numpy()
    bad = (want.view(np.int32) != got.view(np.int32)) \
        & ~(np.isnan(want) & np.isnan(got))
    return x[bad]


def _window(lo: float, hi: float) -> np.ndarray:
    """Every float32 bit pattern between two floats of one sign."""
    a, b = sorted(int(np.float32(v).view(np.uint32)) for v in (lo, hi))
    return np.arange(a, b + 1, dtype=np.uint64).astype(np.uint32)


def test_xla_exp_strided_sweep():
    bits = np.arange(0, 1 << 32, 1021, dtype=np.uint64).astype(np.uint32)
    assert _exp_mismatches(bits).size == 0


@pytest.mark.parametrize("lo,hi", [
    (88.0, 89.0),          # the last finite results and overflow to inf
    (-87.0, -88.5),        # the smallest normal results, then 0
    (-103.0, -104.5),      # where a correctly rounded exp is subnormal
    (0.0, 1e-30),          # tiny and subnormal inputs: 1.0
    (-0.0, -1e-30),
    (1e-30, 0.36),         # inside the first range-reduction interval
    (-1e-30, -0.36),
])
def test_xla_exp_windows(lo, hi):
    bits = _window(lo, hi)
    # every float32 of the narrow windows; about 4M of the wide ones
    bits = bits[::max(1, bits.size >> 22)]
    assert _exp_mismatches(bits).size == 0


def test_xla_exp_special_values():
    x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                  np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
                  1e-45, -1e-45, np.finfo(np.float32).max,
                  -np.finfo(np.float32).max, -87.8, 88.8, 88.72284,
                  -87.33655, 1.0, -1.0], np.float32)
    assert _exp_mismatches(x.view(np.uint32)).size == 0
    got = xla_exp_f32(torch.from_numpy(x)).numpy()
    assert got[0] == got[1] == 1.0 and got[2] == np.inf and got[3] == 0.0
    assert np.isnan(got[4])


def test_torch_exp_is_not_xla_exp():
    """Why the port carries its own exp: torch's differs from XLA's in
    the last bit on a share of inputs, which moves a printed percent or a
    feature-prob string."""
    x = np.random.default_rng(0).uniform(-60, 60, 100_000) \
        .astype(np.float32)
    want = np.asarray(_JAX_EXP(x))
    torch_exp = torch.exp(torch.from_numpy(x)).numpy()
    assert (torch_exp.view(np.int32) != want.view(np.int32)).sum() > 1000
    assert _exp_mismatches(x.view(np.uint32)).size == 0


# ---- tokenizer -----------------------------------------------------------

LUCENE_CASES = [
    ("The quick brown fox jumps over the lazy dog",
     ["quick", "brown", "fox", "jumps", "over", "lazy", "dog"]),
    ("Don't split O'Neill's contraction",
     ["don't", "split", "o'neill's", "contraction"]),
    ("state-of-the-art design", ["state", "art", "design"]),
    ("Version 3.14 costs 1,000 dollars",
     ["version", "3.14", "costs", "1", "000", "dollars"]),
    ("AT&T and IBM", ["t", "ibm"]),
    ("Café menu", ["café", "menu"]),
    ("foo_bar baz_1", ["foo_bar", "baz_1"]),
    ("e-mail support@example.com",
     ["e", "mail", "support", "example.com"]),
    ("C++ and F81 runtimes", ["c", "f81", "runtimes"]),
    ("it it's", ["it's"]),
    ("'quoted' words", ["quoted", "words"]),
]


@pytest.mark.parametrize("text,expected", LUCENE_CASES)
def test_tokenizer_lucene_parity(text, expected):
    assert twc.tokenize(text) == expected
    assert twc.tokenize(text) == jwc.tokenize(text)


def test_tokenizer_random_strings_match_jax():
    rng = np.random.default_rng(5)
    alphabet = list("abcXYZ019 _-'.,’&@éß") + ["  ", "the ", "it's "]
    for _ in range(2000):
        s = "".join(rng.choice(alphabet, rng.integers(0, 30)))
        assert twc.tokenize(s) == jwc.tokenize(s), s
    assert twc.STANDARD_STOPWORDS == jwc.STANDARD_STOPWORDS


def full_sweep() -> int:
    """Every float32 bit pattern: the count of mismatches (0 expected)."""
    total = 0
    step = 1 << 24
    for lo in range(0, 1 << 32, step):
        bits = np.arange(lo, lo + step, dtype=np.uint64).astype(np.uint32)
        bad = _exp_mismatches(bits)
        total += bad.size
        if bad.size:
            print(f"block {lo:#010x}: {bad.size} mismatches, e.g. {bad[:4]}",
                  flush=True)
    return total


if __name__ == "__main__" and "--full" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    n_bad = full_sweep()
    print(f"xla_exp_f32 vs jax.numpy.exp over all 2^32 float32 bit "
          f"patterns: {n_bad} mismatches")
    sys.exit(1 if n_bad else 0)
