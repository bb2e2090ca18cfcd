"""Samplers: port of ``avenir_tpu/stats/samplers.py`` (reference
python/lib/sampler.py and weighted_rec_sampler.py): Gaussian and
non-parametric rejection samplers, weighted index draws, and the
Metropolis sampler over a histogram target.

Every draw goes through the port's threefry twin
(:mod:`..utils.threefry`), so the samples are the JAX package's bit for
bit: a key is the twin's ``(2,)`` int64 tensor and the draws run on its
device (the CUDA threefry kernel on the card).  The float32 arithmetic
around the draws rounds as the JAX package's compiled programs do on the
CPU (:mod:`..utils.xla_math`: XLA's ``exp`` and ``log``, its FMAs).

Rejection sampling proposes a batch everywhere and keeps the accepted
values (a host loop for the rare shortfall).  The Metropolis sampler runs
``n_chains`` chains as a batch; the JAX package's ``lax.scan`` over
``skip`` transitions is a loop on the device here, the accepted count
kept there and read once a call.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import threefry as tf
from ..utils.xla_math import fma_f32, xla_erf_inv_f32, xla_exp_f32, \
    xla_log_f32
from .histogram import Histogram


def _f32(v: float) -> float:
    return float(np.float32(v))


def _scalar(v: float, device) -> torch.Tensor:
    return torch.tensor(_f32(v), dtype=torch.float32, device=device)


def _uniform_between(key, n: int, lo: torch.Tensor, hi: torch.Tensor):
    """``jax.random.uniform(key, (n,), minval=lo, maxval=hi)`` for float32
    bounds computed at run time: ``max(lo, fma(f, hi - lo, lo))``."""
    f = tf.uniform(key, (n,))
    return torch.maximum(lo, fma_f32(f, hi - lo, lo))


# -------------------- rejection samplers --------------------

_SQRT_2PI = float(np.sqrt(np.float32(2.0 * math.pi)))
_SQRT2 = _f32(math.sqrt(2.0))


def _gauss_reject_batch(key, mean: float, std: float, n_draw: int):
    """Candidates over [mean +- 3 sigma] x [0, 1.05 fmax], accept y < f(x)
    (sampler.py:33-53 GaussianRejectSampler, batched)."""
    dev = key.device
    m, s = _scalar(mean, dev), _scalar(std, dev)
    kx, ky = tf.split(key, 2)
    xmin = fma_f32(s, -3.0, m)
    xmax = fma_f32(s, 3.0, m)
    fmax = 1.0 / (s * _SQRT_2PI)
    x = _uniform_between(kx, n_draw, xmin, xmax)
    y = tf.uniform(ky, (n_draw,)) * (fmax * 1.05)
    d = x - m
    f = fmax * xla_exp_f32(-(d * d) / ((s * 2.0) * s))
    return x, y < f


def gaussian_reject_sample(key, mean: float, std: float, n: int
                           ) -> np.ndarray:
    """n samples from N(mean, std) truncated to +-3 sigma by rejection."""
    out = np.empty((0,), dtype=np.float64)
    # acceptance is about 0.38; oversample 3x
    while len(out) < n:
        key, sub = tf.split(key, 2)
        x, ok = _gauss_reject_batch(sub, mean, std, 3 * n)
        out = np.concatenate([out, x[ok].cpu().numpy().astype(np.float64)])
    return out[:n]


def _nonparam_reject_batch(key, xmin: float, bin_width: float,
                           values: torch.Tensor, n_draw: int):
    dev = key.device
    lo, bw = _scalar(xmin, dev), _scalar(bin_width, dev)
    kx, ky = tf.split(key, 2)
    n_bins = values.shape[0]
    xmax = fma_f32(bw, float(n_bins - 1), lo)
    fmax = values.max()
    x = _uniform_between(kx, n_draw, lo, xmax + bw)
    y = tf.uniform(ky, (n_draw,)) * fmax
    k = torch.clamp(((x - lo) / bw).to(torch.int32), 0, n_bins - 1)
    return x, y < values[k.long()]


def nonparam_reject_sample(key, xmin: float, bin_width: float,
                           values: Sequence[float], n: int) -> np.ndarray:
    """n samples from the piecewise-constant density of per-bin weights
    (sampler.py:58-83 NonParamRejectSampler, batched; continuous within
    bins)."""
    vals = torch.as_tensor(np.asarray(values, dtype=np.float32),
                           device=key.device)
    out = np.empty((0,), dtype=np.float64)
    while len(out) < n:
        key, sub = tf.split(key, 2)
        x, ok = _nonparam_reject_batch(sub, xmin, bin_width, vals, 4 * n)
        out = np.concatenate([out, x[ok].cpu().numpy().astype(np.float64)])
    return out[:n]


WEIGHTED_CHUNK_ELEMS = 1 << 26


def weighted_indices(key, weights: Sequence[float], n: int) -> np.ndarray:
    """n record indices drawn with probability proportional to weight
    (weighted_rec_sampler.py sample()): the Gumbel-max trick, the argmax
    of ``log(w) + gumbel`` over each row of an (n, len(w)) draw.  Row i's
    draws are those of the flat indices ``i*len(w) ...``, so the rows are
    drawn in chunks of at most WEIGHTED_CHUNK_ELEMS values on the
    device."""
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32),
                        device=key.device)
    L = w.shape[0]
    logw = xla_log_f32(torch.clamp(w, min=0.0))
    keys = key.reshape(1, 2).contiguous()
    step = max(1, WEIGHTED_CHUNK_ELEMS // max(L, 1))
    out = torch.empty(n, dtype=torch.int64, device=key.device)
    for a in range(0, n, step):
        b = min(n, a + step)
        idx = torch.arange(a * L, b * L, dtype=torch.int64,
                           device=key.device)
        bits = tf.threefry_hash(keys, (b - a) * L, 0, idx >> 32,
                                idx & tf.M32).reshape(b - a, L)
        g = tf.gumbel_from_bits(bits)
        out[a:b] = torch.argmax(logw[None, :] + g, dim=1)
    return out.cpu().numpy().astype(np.int32)


# -------------------- Metropolis sampler --------------------

class MetropolisSampler:
    """Metropolis chains over a histogram target (sampler.py:86-157):
    proposal = current + N(0, prop_std) (optionally a mixture with a wider
    global proposal), clamped to the target's support, accepted with
    min(1, f(next)/f(cur)).  ``n_chains`` independent chains as a batch on
    ``device`` (the process default when None); ``sub_sample(skip)``
    advances ``skip`` full transitions and returns the last state."""

    def __init__(self, prop_std: float, xmin: float, bin_width: float,
                 values: Sequence[float], n_chains: int = 1, seed: int = 0,
                 device=None):
        from ..runtime import resolve_device
        self.device = resolve_device(device)
        self.hist = Histogram.create_initialized(xmin, bin_width, values)
        self.prop_std = float(prop_std)
        self.n_chains = n_chains
        self.key = tf.PRNGKey(seed, self.device)
        self.mixture_threshold: Optional[float] = None
        self.global_prop_std: Optional[float] = None
        self._vals = torch.as_tensor(self.hist.bins.astype(np.float32),
                                     device=self.device)
        self._xmin = float(xmin)
        self._bw = float(bin_width)
        self._xmax = float(self.hist.xmax)
        self.initialize()

    def initialize(self) -> None:
        self.key, sub = tf.split(self.key, 2)
        self.cur = tf.uniform(sub, (self.n_chains,), minval=self._xmin,
                              maxval=self._xmax)
        self.trans_count = 0

    def set_global_proposal(self, global_std: float,
                            threshold: float) -> None:
        """Mixture proposal (sampler.py:110-114): with prob threshold the
        local proposal, else the wider global one."""
        self.global_prop_std = float(global_std)
        self.mixture_threshold = float(threshold)

    def sample(self) -> np.ndarray:
        return self.sub_sample(1)

    def sub_sample(self, skip: int) -> np.ndarray:
        self.key, sub = tf.split(self.key, 2)
        mix = self.mixture_threshold is not None
        self.cur, n_acc = _metropolis_step(
            sub, self.cur, self._vals, self._xmin, self._bw, self._xmax,
            self.prop_std, self.global_prop_std if mix else 0.0,
            self.mixture_threshold if mix else 1.0, skip, mix)
        self.trans_count += int(n_acc)
        return self.cur.cpu().numpy()

    def run(self, steps: int, skip: int = 1) -> np.ndarray:
        """(steps, n_chains) trace."""
        return np.stack([self.sub_sample(skip) for _ in range(steps)])


def _metropolis_step(key, cur, vals, xmin, bw, xmax, prop_std,
                     global_std, threshold, skip: int, mixture: bool):
    """``skip`` full Metropolis transitions (propose + accept each); the
    accepted count accumulates on the device over all of them."""
    dev = cur.device
    lo, width, hi = (_scalar(v, dev) for v in (xmin, bw, xmax))
    ps, gs = _scalar(prop_std, dev), _scalar(global_std, dev)
    n_bins = vals.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def density(x):
        k = torch.clamp(((x - lo) / width).to(torch.int32), 0, n_bins - 1)
        return vals[k.long()]

    def erf_inv(k):
        # normal(k) / sqrt(2): XLA moves the normal's sqrt(2) onto the
        # proposal's sigma; a lone proposal fuses into one FMA, a mixture
        # selects between the two rounded steps before the add
        return xla_erf_inv_f32(tf.uniform_from_bits(
            tf._bits32(k, shape), tf._NORMAL_LO, 1.0))

    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    x = cur
    shape = tuple(x.shape)
    ps2, gs2 = ps * _SQRT2, gs * _SQRT2
    for k in tf.split(key, skip):
        kp, km, ka = tf.split(k, 3)
        if mixture:
            use_local = tf.uniform(tf.fold_in(km, 1), shape) < \
                _f32(threshold)
            step = x + torch.where(use_local, erf_inv(kp) * ps2,
                                   erf_inv(km) * gs2)
        else:
            step = fma_f32(erf_inv(kp), ps2, x)
        nxt = torch.minimum(torch.maximum(step, lo), hi)
        ratio = density(nxt) / torch.maximum(density(x), zero)
        accept = tf.uniform(ka, shape) < torch.minimum(
            ratio, torch.ones_like(ratio))
        x = torch.where(accept, nxt, x)
        n_acc = n_acc + accept.sum()
    return x, n_acc
