"""``avenir_tpu_torch/utils/xla_math.py`` against XLA's CPU float32
arithmetic, the rounding the JAX package's drift scores are made in.

``xla_log_f32`` must equal ``jax.jit(jnp.log)`` bit for bit on every input
of a seeded sweep: [1e-6, 1] log-uniform, (0, 1) uniform, around 1, random
bit patterns (every exponent, NaNs, infinities, subnormals) and the
special values.  The FMA is computed in float64 and rounded once to
float32; where that double rounding could differ from one rounding the
sweep would show a mismatch: none is allowed (measured: 0 of 4.2M, my
CPU run).  The left-to-right row sums and the FMA-fused product sums
must equal XLA's on seeded rows of the widths where XLA's CPU code runs
them that way: plain sums up to 9 bins, fused product sums at 3, 4 and 9
(XLA's CPU code leaves the product unfused at 5 and 7 bins and
vectorises wider rows — at 33 bins, the default monitor width, neither
order holds; ``tests/test_torch_drift.py`` bounds what that costs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avenir_tpu_torch.utils import xla_math


def _sweep(seed, n):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return np.concatenate([
        (10 ** rng.uniform(-6, 0, n)).astype(f32),
        rng.random(n).astype(f32),
        (1 + rng.uniform(-1e-3, 1e-3, n)).astype(f32),
        rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
            np.uint32).view(f32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 1e-45, 1e-40,
                  1.17e-38, np.finfo(f32).tiny, 1.0, 0.5, 2.0,
                  np.finfo(f32).max, 1e-6, 0.70710677, 0.70710683], f32)])


def _same_bits(a, b):
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                      & np.isnan(b))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_xla_log_f32_is_xla_log_bit_for_bit(seed):
    xs = _sweep(seed, 250_000)
    want = np.asarray(jax.jit(jnp.log)(xs))
    got = xla_math.xla_log_f32(torch.from_numpy(xs)).numpy()
    same = _same_bits(want, got)
    assert same.all(), (xs[~same][:5], want[~same][:5], got[~same][:5])


def test_xla_log_differs_from_torch_log():
    """The emulation is needed: torch.log and XLA's polynomial disagree on
    a large share of the probabilities a drift score takes the log of."""
    xs = _sweep(7, 100_000)[:100_000]           # the [1e-6, 1] part
    want = np.asarray(jax.jit(jnp.log)(xs))
    torch_log = torch.log(torch.from_numpy(xs)).numpy()
    assert np.mean(~_same_bits(want, torch_log)) > 0.01   # 3%, my CPU run


@pytest.mark.parametrize("B", [1, 3, 5, 7, 9])
def test_seq_row_sum_is_xla_row_sum(B):
    rng = np.random.default_rng(B)
    x = (rng.standard_normal((4000, B)) * 10 ** rng.uniform(
        -3, 3, (4000, 1))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    got = xla_math.seq_row_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [3, 4, 9])
def test_fma_row_sum_is_xla_fused_product_sum(B):
    rng = np.random.default_rng(100 + B)
    a = rng.standard_normal((4000, B)).astype(np.float32)
    b = rng.standard_normal((4000, B)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: jnp.sum(x * y, axis=1))(a, b))
    got = xla_math.fma_row_sum(torch.from_numpy(a),
                               torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    # the fusion matters: the unfused sum differs on these rows
    plain = xla_math.seq_row_sum(torch.from_numpy(a * b)).numpy()
    assert (plain != want).any()


@pytest.mark.parametrize("B", [3, 7, 9])
def test_seq_cumsum_is_xla_cumsum(B):
    rng = np.random.default_rng(200 + B)
    x = rng.standard_normal((3000, B)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    got = xla_math.seq_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_folded_log_is_xla_constant_folded_log():
    """A log of compile-time constants (the baseline's log(pc) in the drift
    kernel) is folded by XLA before the kernel runs, not computed by its
    polynomial: folded_log_f32 must equal the folded value."""
    xs = _sweep(9, 20_000)
    xs = xs[np.isfinite(xs) & (xs > np.finfo(np.float32).tiny)]
    const = jnp.asarray(xs)
    want = np.asarray(jax.jit(lambda: jnp.log(const))())
    np.testing.assert_array_equal(xla_math.folded_log_f32(xs), want)
    runtime = np.asarray(jax.jit(jnp.log)(xs))
    assert (runtime != want).any()


def test_fma_f32_rounds_once():
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-1.0], dtype=torch.float32)
    # a*a - 1 = 2^-11 + 2^-24: the unfused product rounds the 2^-24 away
    assert xla_math.fma_f32(a, a, c).item() == 2.0 ** -11 + 2.0 ** -24
    assert (a * a + c).item() == 2.0 ** -11


@pytest.mark.parametrize("seed", [0, 1])
def test_sqrt_f32_is_xla_sqrt(seed):
    """The correctly rounded float32 root, XLA's ``vsqrtps``, on every
    input class: the jitted JAX root bit for bit."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.random(200_000).astype(np.float32),
        (rng.random(200_000) * 1e6).astype(np.float32),
        # just above 1/4, where the root lies a hair below a midpoint
        np.float32(0.25) + np.arange(1, 2001, dtype=np.float32) * 2 ** -25,
        np.array([0.0, np.inf, 1.0, 2.0, 3.4e38, 1.2e-38], np.float32)])
    want = np.asarray(jax.jit(jnp.sqrt)(x))
    np.testing.assert_array_equal(
        xla_math.sqrt_f32(torch.from_numpy(x)).numpy(), want)


def test_nearest_root_corrects_a_guess_one_ulp_off():
    """A first guess one ulp above or below the root (the CPU's float64
    root can be that far off on a first call, ROADMAP §C) comes back as
    the correctly rounded root."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.random(100_000).astype(np.float32) * 1e4,
        np.float32(0.25) + np.arange(1, 2001, dtype=np.float32) * 2 ** -25]))
    want = torch.from_numpy(np.sqrt(x.numpy()))
    for toward in (float("inf"), 0.0):
        guess = torch.nextafter(want, torch.full_like(want, toward))
        assert (guess != want).all()
        assert torch.equal(xla_math.nearest_root_f32(x, guess), want)
