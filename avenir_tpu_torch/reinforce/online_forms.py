"""Device-state forms of the host bandit learners: port of
``avenir_tpu/reinforce/online_forms.py``.

The online learning plane (:mod:`avenir_tpu_torch.online`) keeps the
host learners' per-arm statistics as three ``(A,)`` float32 tensors and
scores a whole served window at once.  The arithmetic is the JAX
package's compiled program's, as XLA's CPU backend emits it, so that the
port's decisions and statistics are the JAX package's bit for bit:

* ``ucb1`` calls the shared body :func:`.learners.ucb1_upper_bound` with
  XLA's ``log`` (:func:`..utils.xla_math.xla_log_f32`) and the correctly
  rounded ``sqrt`` (:func:`..utils.xla_math.sqrt_f32`);
* ``softMax`` scores ``log(softmax_weight(mean)) + gumbel``.  XLA folds
  ``log(exp(a))`` to ``a`` and the division by the temperature into a
  product with its float32 reciprocal, so the compiled score is
  ``min(mean * (1/tau), 700) + gumbel``, which :func:`bandit_scores`
  evaluates;
* ``sampsonSampler`` draws :func:`.learners.sampson_sample`'s
  ``mean + sigma / sqrt(n) * z`` with ``z = sqrt(2) * erf_inv(u)``.  XLA
  rewrites it to ``fma(sigma * rsqrt(n) * sqrt(2), erf_inv(u), mean)``,
  its ``rsqrt`` the CPU's 12-bit estimate and two Newton steps
  (:func:`xla_rsqrt_f32`), and the variance's ``total_sq - n * mean *
  mean`` into an FMA.

Randomness threads a key of the port's threefry twin
(:mod:`..utils.threefry`): ``gumbel`` and ``normal`` of shape (B, A), B
the padded window, drawn by the CUDA kernel for keys on the card.

:func:`absorb_rewards` is the JAX package's scatter-add of a window's
rewards.  XLA's CPU scatter adds the rows in order, one at a time; a
CUDA ``index_add_`` adds duplicates by atomics in no fixed order.  The
port adds them in row order on every device: each arm's k-th reward of
the window lands in step k.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import threefry as tf
from ..utils.xla_math import fma_f32, sqrt_f32, xla_erf_inv_f32, \
    xla_log_f32
from .learners import ucb1_upper_bound

# the device-resident subset of the factory's algorithm names
ONLINE_ALGORITHMS = ("ucb1", "softMax", "sampsonSampler")

_SQRT2 = float(np.float32(np.sqrt(2.0)))
# the seed of XLA's rsqrt: the CPU's estimate, good to 12 bits
_RSQRT_SEED_MASK = ~((1 << 11) - 1)


def init_arm_stats(n_arms: int) -> Dict[str, np.ndarray]:
    """Fresh per-arm statistics: count / reward sum / reward sum-sq."""
    return {
        "counts": np.zeros(n_arms, np.float32),
        "totals": np.zeros(n_arms, np.float32),
        "total_sqs": np.zeros(n_arms, np.float32),
    }


def arm_means(counts, totals):
    return totals / torch.clamp(counts, min=1.0)


def arm_sigmas(counts, totals, total_sqs):
    """ActionStat.std_dev vectorised with the sampsonSampler's ``std_dev
    or 1.0`` floor.  XLA contracts ``total_sq - (n * mean) * mean`` into
    one FMA."""
    mean = arm_means(counts, totals)
    var = fma_f32(-(counts * mean), mean, total_sqs) / \
        torch.clamp(counts - 1.0, min=1.0)
    sd = sqrt_f32(torch.clamp(var, min=0.0))
    return torch.where(sd > 0.0, sd, torch.ones_like(sd))


def xla_rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``rsqrt``: a 12-bit estimate, then two Newton
    steps ``y += (-y/2) * fma(x * y, y, -1)``.  The estimate here is the
    correctly rounded root cut to 12 bits, not the CPU's own table, so a
    result may sit one ulp from XLA's (about 4% of integer inputs)."""
    x = x.float()
    seed = (1.0 / torch.sqrt(x.double())).float()
    y = (seed.view(torch.int32) & _RSQRT_SEED_MASK).view(torch.float32)
    for _ in range(2):
        e = fma_f32(x * y, y, -1.0)
        y = fma_f32(y * -0.5, e, y)
    return y


def softmax_scale(temp_constant: float) -> float:
    """The float32 reciprocal XLA folds the division by ``tau`` into."""
    return float(np.float32(1.0) / np.float32(temp_constant))


def bandit_scores(algorithm: str, counts, totals, total_sqs, key,
                  n_rows: int, temp_constant: float = 0.1):
    """Per-row selection scores ``(n_rows, A)``; the chosen arm of row i is
    ``argmax(scores[i])`` (the first on ties).  Untried arms score +inf —
    the host learners' try-everything-once rule."""
    A = counts.shape[0]
    mean = arm_means(counts, totals)
    untried = counts < 0.5
    inf = torch.full_like(mean, float("inf"))
    if algorithm == "ucb1":
        N = torch.clamp(counts.sum(), min=1.0)
        ub = ucb1_upper_bound(mean, torch.clamp(counts, min=1.0), N,
                              log=xla_log_f32, sqrt=sqrt_f32)
        scores = torch.where(untried, inf, ub)
        return scores.expand(n_rows, A)
    if algorithm == "softMax":
        logw = torch.clamp(mean * softmax_scale(temp_constant), max=700.0)
        g = tf.gumbel(key, (n_rows, A))
        return torch.where(untried[None, :], inf[None, :],
                           logw[None, :] + g)
    if algorithm == "sampsonSampler":
        sigma = arm_sigmas(counts, totals, total_sqs)
        scale = sigma * xla_rsqrt_f32(torch.clamp(counts, min=1.0)) * _SQRT2
        e = xla_erf_inv_f32(tf.uniform_from_bits(
            tf._bits32(key, (n_rows, A)), tf._NORMAL_LO, 1.0))
        draw = fma_f32(scale[None, :], e, mean[None, :])
        return torch.where(untried[None, :], inf[None, :], draw)
    raise ValueError(f"algorithm {algorithm!r} has no device form; "
                     f"known: {ONLINE_ALGORITHMS}")


def absorb_plan(arms: np.ndarray, mask: np.ndarray, n_arms: int
                ) -> Tuple[np.ndarray, int]:
    """The host half of :func:`absorb_rewards` for a padded batch:
    ``(rank, steps)``, each unmasked row's rank among its arm's unmasked
    rows in row order (masked rows ``steps``) and the most unmasked rows
    one arm holds.  The host that joined the rewards plans the absorb, so
    the device needs no read-back for it."""
    valid = np.asarray(mask) != 0
    seen = np.zeros(n_arms, np.int64)
    rank = np.zeros(len(valid), np.int64)
    for i in np.flatnonzero(valid):
        a = int(arms[i])
        rank[i] = seen[a]
        seen[a] += 1
    steps = int(seen.max()) if valid.any() else 0
    rank[~valid] = steps
    return rank, steps


def absorb_rewards(counts, totals, total_sqs, arms, rewards, mask,
                   rank: torch.Tensor, steps: int):
    """ActionStat.add vectorised over a padded reward batch, in row order:
    ``counts[a] += w``, ``totals[a] += r * w`` and ``total_sqs[a] += r *
    (r * w)`` (each product rounded, as XLA materialises them) for every
    row, the rows of one arm added one after another: an arm's k-th
    reward of the window lands in step k.  ``rank`` and ``steps`` are
    :func:`absorb_plan`'s.  Masked rows add nothing."""
    A = counts.shape[0]
    w = mask.to(counts.dtype)
    r = rewards.to(counts.dtype) * w
    sq = rewards.to(counts.dtype) * r
    arms = arms.long()
    acc = torch.stack([counts, totals, total_sqs])
    if steps:
        # one slot a (step, arm); masked rows go to the spare step
        grid = torch.zeros((steps + 1, 3, A), dtype=counts.dtype,
                           device=counts.device)
        grid[rank.long(), :, arms] = torch.stack([w, r, sq], 1)
        for g in grid[:steps].unbind(0):
            acc = acc + g
    return acc[0], acc[1], acc[2]
