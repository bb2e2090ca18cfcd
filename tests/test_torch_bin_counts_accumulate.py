"""The bin counts' in-place accumulate (``kernels/histogram.py``
``bin_counts(..., out=)``, kernel B4's form on the drift monitor's path)
held against the JAX package on the CPU.

The drift accumulator adds every absorbed block into its window matrix as
``counts + feature_bin_counts(codes, B, mask)``
(``avenir_tpu/monitor/accumulator.py``): one float32 add a cell.  The
port's ``out=`` must give those bits, also where the carry is above 2^24
and the add rounds.  Inputs are made from a seed with numpy; the JAX side
runs the XLA twin and the interpret-mode Pallas kernel.  Exact equality
everywhere.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.ops.histogram import feature_bin_counts
from avenir_tpu.ops.pallas.histogram import bin_counts as pallas_bin_counts

from avenir_tpu_torch.kernels import histogram

# carries: zero, small integers, just below and above 2^24 (where a float32
# add of a count rounds), and non-integers (a decayed long window)
CARRIES = {
    "zero": lambda rng, R, B: np.zeros((R, B), np.float32),
    "small": lambda rng, R, B: rng.integers(0, 1000, (R, B)).astype(
        np.float32),
    "below_2p24": lambda rng, R, B: (
        2.0 ** 24 - rng.integers(1, 40, (R, B))).astype(np.float32),
    "above_2p24": lambda rng, R, B: (
        2.0 ** 24 + 2 * rng.integers(0, 40, (R, B))
        + rng.integers(0, 2, (R, B)) * 2.0 ** 25).astype(np.float32),
    "fraction": lambda rng, R, B: (rng.random((R, B)) * 3e7).astype(
        np.float32),
}
SHAPES = [(0, 3, 4), (1, 5, 7), (64, 5, 7), (513, 5, 7), (2048, 5, 7),
          (300, 33, 33), (100, 1, 3)]


def _inputs(seed, n, R, B, masked):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-2, B + 2, (n, R), dtype=np.int32)
    mask = (rng.random(n) < 0.6) if masked else None
    return rng, codes, mask


def _jax_add(carry, codes, B, mask):
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(jnp.asarray(carry) + feature_bin_counts(
        jnp.asarray(codes), B, m))


@pytest.mark.parametrize("carry", sorted(CARRIES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_out_equals_reference_add(carry, shape, masked):
    n, R, B = shape
    rng, codes, mask = _inputs(zlib.crc32(repr((carry, shape, masked))
                                          .encode()),
                               n, R, B, masked)
    c0 = CARRIES[carry](rng, R, B)
    c, m = torch.from_numpy(codes), None if mask is None \
        else torch.from_numpy(mask)
    out = torch.from_numpy(c0.copy())
    got = histogram.bin_counts(c, B, m, out=out)
    assert got is out                       # in place
    want = _jax_add(c0, codes, B, mask)
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain version with out= is bitwise out + its own counts
    plain = histogram.bin_counts_torch(c, B, m,
                                       out=torch.from_numpy(c0.copy()))
    assert torch.equal(plain, torch.from_numpy(c0)
                       + histogram.bin_counts_torch(c, B, m))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_out_equals_pallas_interpret_add(masked):
    rng, codes, mask = _inputs(5, 700, 5, 7, masked)
    c0 = CARRIES["above_2p24"](rng, 5, 7)
    want = np.asarray(jnp.asarray(c0) + pallas_bin_counts(
        jnp.asarray(codes), 7, None if mask is None else jnp.asarray(mask),
        interpret=True))
    got = histogram.bin_counts(
        torch.from_numpy(codes), 7,
        None if mask is None else torch.from_numpy(mask),
        out=torch.from_numpy(c0.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_above_2p24_carry_really_rounds():
    """The case is live: at least one cell's add rounds, so a wrong order
    of adds (count into carry vs carry into count) would show."""
    rng, codes, _ = _inputs(8, 2000, 5, 7, False)
    c0 = CARRIES["above_2p24"](rng, 5, 7)
    counts = histogram.bin_counts_torch(torch.from_numpy(codes), 7).numpy()
    exact = c0.astype(np.float64) + counts
    assert (np.float32(c0) + counts != exact).any()


def test_rows_past_bin_rows_max_chunk_into_out(monkeypatch):
    """More rows than BIN_ROWS_MAX: each chunk adds into ``out`` in turn,
    and no launch is counted on the CPU."""
    rng, codes, mask = _inputs(11, 1000, 5, 7, True)
    c0 = CARRIES["small"](rng, 5, 7)
    c, m = torch.from_numpy(codes), torch.from_numpy(mask)
    whole = histogram.bin_counts(c, 7, m, out=torch.from_numpy(c0.copy()))
    before = histogram.bin_counts_launches
    monkeypatch.setattr(histogram, "BIN_ROWS_MAX", 64)
    chunked = histogram.bin_counts(c, 7, m, out=torch.from_numpy(c0.copy()))
    assert histogram.bin_counts_launches == before
    assert torch.equal(whole, chunked)
    np.testing.assert_array_equal(chunked.numpy(),
                                  _jax_add(c0, codes, 7, mask))


def test_rows_per_launch_keeps_codes_under_2p30():
    assert histogram._rows_per_launch(5) == histogram.BIN_ROWS_MAX
    assert histogram._rows_per_launch(1000) * 1000 < 2 ** 30
    assert histogram._rows_per_launch(1 << 31) == 1


def test_out_checks():
    c = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="out"):
        histogram.bin_counts(c, 5, out=torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="out"):
        histogram.bin_counts(c, 5, out=torch.zeros((3, 5),
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="old"):
        histogram.bin_counts(c, 5, old=True)     # the old kernel: CUDA only
