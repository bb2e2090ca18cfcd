"""A twin of ``jax.random`` (JAX 0.9.0, ``threefry2x32`` with
``jax_threefry_partitionable=True``): the same keys and the same draws,
bit for bit, so that the port's stochastic jobs follow the JAX package's
streams.

A key is an int64 tensor of shape ``(2,)`` holding two unsigned 32-bit
words, on the device the draws are made on; a batch of keys is
``(..., 2)`` and draws for it are taken key by key (``jax.vmap`` of the
draw over the keys).  Every function is plain: the device is the key's.

* :func:`PRNGKey` — ``(0, seed mod 2^32)`` (JAX without x64 converts the
  seed to 32 bits first);
* :func:`split` — the hash of the flat index ``i`` of each new key, its
  two output words the new key (``_threefry_split_foldlike``);
* :func:`fold_in` — the hash of the counter pair ``(0, data)``;
* :func:`random_bits` — ``bits1 ^ bits2`` over the flat index of each
  element (the partitionable 32-bit draw);
* :func:`uniform`, :func:`normal`, :func:`randint`, :func:`permutation`,
  :func:`gumbel`, :func:`categorical` — ``jax/_src/random.py``'s
  transforms of those bits.  The float transforms depend only on
  ``bits >> 9``; their arithmetic rounds as XLA's CPU code does
  (:mod:`.xla_math`: the multiply-add of ``uniform`` is one FMA, ``normal``
  is XLA's ``erf_inv``, ``gumbel`` XLA's ``log``).

The hash itself is :func:`threefry_hash`: the CUDA kernel
``csrc/threefry.cu`` for keys on a CUDA device, its plain version for
keys on the CPU — :func:`threefry2x32_torch`, int64 torch ops masked to
32 bits, which is also the kernel's oracle on the card, and for CPU
tensors the same rounds in numpy uint32 (:func:`threefry2x32_np`), which
a one-step draw of a simulated-annealing run calls a dozen times.  ``launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.dispatch import (BACKEND_CUDA, count_launches, note_backend,
                                resolve_backend)
from ..runtime import resolve_device
from .xla_math import fma_f32, xla_erf_inv_f32, xla_log_f32

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# kernel launches since the last reset (bumped under dispatch's lock)
launches = 0

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


# ---------------------------------------------------------------------------
# the hash
# ---------------------------------------------------------------------------

def threefry2x32_torch(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words ``x0, x1`` under key
    words ``k0, k1``: int64 tensors of unsigned 32-bit values, broadcast
    together.  Returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def threefry2x32_np(k0, k1, x0, x1):
    """:func:`threefry2x32_torch` in numpy uint32 arithmetic (which wraps
    by itself): the same rounds at a fraction of the per-operation cost,
    for keys on the CPU."""
    k0, k1 = k0.astype(np.uint32), k1.astype(np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = x0.astype(np.uint32) + k0
    x1 = x1.astype(np.uint32) + k1
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _iota_words(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the same bits as int32."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _hash_torch(keys, c0, c1, n: int, mode: int) -> torch.Tensor:
    """The kernel's plain version: ``keys`` (B, 2), counters ``(c0, c1)``
    of length n or None for the flat index; mode 0 -> (B, n) int32
    ``bits1 ^ bits2``, mode 1 -> (B, n, 2) int64 word pairs."""
    if c0 is None:
        c0, c1 = _iota_words(n, keys.device)
    if keys.device.type == "cpu":
        kh = keys.numpy()
        with np.errstate(over="ignore"):
            b0, b1 = threefry2x32_np(kh[:, 0:1], kh[:, 1:2],
                                     c0.numpy()[None, :],
                                     c1.numpy()[None, :])
        if mode == 0:
            return torch.from_numpy((b0 ^ b1).view(np.int32))
        return torch.from_numpy(np.stack([b0, b1], axis=-1)
                                .astype(np.int64))
    b0, b1 = threefry2x32_torch(keys[:, 0:1], keys[:, 1:2], c0[None, :],
                                c1[None, :])
    if mode == 0:
        return _to_int32_bits(b0 ^ b1)
    return torch.stack([b0, b1], dim=-1)


_entry = None


def _lib():
    global _entry
    if _entry is None:
        from ..kernels.build import load
        fn = load("threefry").avenir_threefry
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _hash_cuda(keys, c0, c1, n: int, mode: int) -> torch.Tensor:
    dev = keys.device
    B = keys.shape[0]
    for t in (keys,) + ((c0, c1) if c0 is not None else ()):
        if t.dtype != torch.int64 or not t.is_contiguous() or \
                t.device != dev:
            raise ValueError("threefry kernel takes contiguous int64 keys "
                             "and counters on the keys' device")
    out = torch.empty((B, n) if mode == 0 else (B, n, 2),
                      dtype=torch.int32 if mode == 0 else torch.int64,
                      device=dev)
    if B * n == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _lib()(keys.data_ptr(), c0.data_ptr() if c0 is not None else None,
                 c1.data_ptr() if c1 is not None else None, n, B, mode,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    count_launches(globals(), ("launches",))
    return out


def threefry_hash(keys: torch.Tensor, n: int, mode: int,
                  c0: Optional[torch.Tensor] = None,
                  c1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hash n counters under each of the (B, 2) ``keys``: the flat index
    (``c0 = c1 = None``) or the given int64 counter words.  Mode 0 gives
    (B, n) int32 ``bits1 ^ bits2``, mode 1 (B, n, 2) int64 word pairs.
    The kernel for CUDA keys, the plain version for CPU keys."""
    backend = resolve_backend(keys.device)
    note_backend("threefry", backend)
    if backend == BACKEND_CUDA:
        return _hash_cuda(keys, c0, c1, n, mode)
    return _hash_torch(keys, c0, c1, n, mode)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=resolve_device(device))


def _batch(key: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    if key.shape[-1] != 2:
        raise ValueError(f"a key is (..., 2) words; got {tuple(key.shape)}")
    lead = tuple(key.shape[:-1])
    return key.reshape(-1, 2).contiguous(), lead


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., num, 2) keys."""
    keys, lead = _batch(key)
    return threefry_hash(keys, int(num), 1).reshape(*lead, int(num), 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``."""
    dev = key.device
    c0 = torch.zeros(1, dtype=torch.int64, device=dev)
    c1 = torch.full((1,), int(data) & M32, dtype=torch.int64, device=dev)
    keys, lead = _batch(key)
    return threefry_hash(keys, 1, 1, c0, c1).reshape(*lead, 2)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def _bits32(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """(*lead, *shape) int32 bit patterns of the 32-bit draw."""
    shape = _shape(shape)
    keys, lead = _batch(key)
    n = math.prod(shape)
    return threefry_hash(keys, n, 0).reshape(lead + shape)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` at 32 bits, as int64 values in
    [0, 2^32)."""
    return _bits32(key, shape).to(torch.int64) & M32


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """The mantissa transform: ``bits >> 9 | 0x3F800000`` as float32,
    minus 1 — a float in [0, 1) from the top 23 bits."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def _f32(v: float) -> float:
    return float(np.float32(v))


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """``uniform``'s transform of int32 bits: ``max(min, fma(f, max -
    min, min))`` in float32 (XLA contracts the multiply-add)."""
    lo, hi = _f32(minval), _f32(maxval)
    f = _unit(bits)
    if (lo, hi) == (0.0, 1.0):
        return f
    span = _f32(np.float32(hi) - np.float32(lo))
    return torch.clamp(fma_f32(f, span, lo), min=lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)``, float32."""
    return uniform_from_bits(_bits32(key, shape), minval, maxval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = _f32(math.sqrt(2.0))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``normal``'s transform: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform_from_bits(bits, _NORMAL_LO, 1.0)
    return xla_erf_inv_f32(u) * _SQRT2


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape)``, float32."""
    return normal_from_bits(_bits32(key, shape))


_TINY = float(np.finfo(np.float32).tiny)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``gumbel``'s low mode: ``-log(-log(u))``, ``u`` uniform on
    ``[tiny, 1)``, with XLA's ``log``."""
    u = uniform_from_bits(bits, _TINY, 1.0)
    return -xla_log_f32(-xla_log_f32(u))


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)``, float32."""
    return gumbel_from_bits(_bits32(key, shape))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` (with replacement,
    one draw a batch row): the argmax over ``axis`` of Gumbel noise of
    ``logits``' shape plus the float32 logits."""
    logits = logits.float()
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits, dim=axis)


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32
    output and scalar bounds: two 32-bit draws from ``split(key)``,
    ``(hi % span * ((2^16 % span)^2 % span) + lo % span) % span`` in
    wrapping uint32 arithmetic, plus ``minval``.  Up to a span of 2^16
    nothing wraps (every term stays below ``span^2``), so the masks are
    left out there."""
    shape = _shape(shape)
    out_of_range = int(maxval) > _I32_MAX
    lo = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi = min(max(int(maxval), _I32_MIN), _I32_MAX)
    span = (hi - lo) & M32
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & M32
    keys, lead = _batch(key)
    sub = split(keys, 2)                            # (B, 2, 2)
    bits = _bits32(sub, shape).to(torch.int64) & M32  # (B, 2, *shape)
    higher, lower = bits[:, 0], bits[:, 1]
    if span == 0:       # 2^32: the remainders have no effect
        offset = lower
    elif span <= 1 << 16:
        mult = (1 << 16) % span * ((1 << 16) % span) % span
        offset = ((higher % span) * mult + lower % span) % span
    else:
        mult = (((2 ** 16 % span) ** 2) & M32) % span
        offset = (((higher % span) * mult) & M32) + (lower % span)
        offset = (offset & M32) % span
    out = offset + lo
    if span == 0 or lo < 0 or lo + span > 2 ** 31:
        out = _to_int32_bits(out & M32)
    else:
        out = out.to(torch.int32)
    return out.reshape(lead + shape)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2^32 - 1))``
    rounds of a fresh ``split``, 32-bit sort keys and a stable sort.
    Returns int64 indices."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.float64(M32))))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key, 2)
        sort_keys = random_bits(sub, (n,))
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x
