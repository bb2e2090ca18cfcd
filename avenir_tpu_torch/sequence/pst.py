"""Probabilistic suffix tree, GSP candidate generation and CTMC statistics:
the port of ``avenir_tpu/sequence/pst.py``.

Parity targets:
  * ProbabilisticSuffixTreeGenerator — context -> next-symbol counts for
    contexts up to a max depth (host).
  * CandidateGenerationWithSelfJoin — GSP k-candidates: join (k-1)-frequent
    sequences whose tail and head (k-2)-sequences match (host).
  * StateTransitionRate / ContTimeStateTransitionStats — per-key CTMC
    generator matrices (numpy) and uniformization: the powers of
    ``M = I + Q/q`` in float32 on the device, each product an FMA chain in
    the order XLA's CPU dot emitter runs it (``utils.xla_math.fma_matmul``),
    so the float64 statistics summed from them on the host are the JAX
    package's to the last bit.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import DeviceLike, resolve_device
from ..utils.tracing import fetch
from ..utils.xla_math import fma_matmul, window_sum


class ProbabilisticSuffixTree:
    """Context -> next-symbol counts for contexts up to max_depth symbols."""

    def __init__(self, max_depth: int = 3):
        self.max_depth = max_depth
        # context tuple (possibly empty) -> {symbol: count}
        self.counts: Dict[Tuple[str, ...], Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))

    def add_sequences(self, sequences: Sequence[Sequence[str]]) -> None:
        for seq in sequences:
            for i, sym in enumerate(seq):
                for d in range(0, self.max_depth + 1):
                    if i - d < 0:
                        break
                    self.counts[tuple(seq[i - d:i])][sym] += 1

    def prob(self, context: Sequence[str], symbol: str) -> float:
        """P(symbol | longest known suffix of context)."""
        ctx = tuple(context[-self.max_depth:]) if context else ()
        while True:
            if ctx in self.counts:
                dist = self.counts[ctx]
                total = sum(dist.values())
                if total > 0:
                    return dist.get(symbol, 0) / total
            if not ctx:
                return 0.0
            ctx = ctx[1:]

    def sequence_log_prob(self, seq: Sequence[str], eps: float = 1e-12
                          ) -> float:
        lp = 0.0
        for i, sym in enumerate(seq):
            p = self.prob(seq[max(0, i - self.max_depth):i], sym)
            lp += math.log(max(p, eps))
        return lp

    def to_lines(self, delim: str = ",") -> List[str]:
        """One line per (context, symbol): 'ctx1:ctx2,symbol,count'."""
        lines = []
        for ctx in sorted(self.counts.keys()):
            for sym, cnt in sorted(self.counts[ctx].items()):
                lines.append(delim.join([":".join(ctx), sym, str(cnt)]))
        return lines

    @classmethod
    def from_lines(cls, lines: Sequence[str], max_depth: int = 3,
                   delim: str = ",") -> "ProbabilisticSuffixTree":
        t = cls(max_depth)
        for line in lines:
            ctx_s, sym, cnt = line.split(delim)
            ctx = tuple(ctx_s.split(":")) if ctx_s else ()
            t.counts[ctx][sym] += int(cnt)
        return t


def gsp_candidates(frequent: Sequence[Sequence[str]]) -> List[List[str]]:
    """GSP self-join: for (k-1)-sequences a, b where a[1:] == b[:-1], emit
    a + b[-1:], first occurrence order."""
    out: List[List[str]] = []
    seen = set()
    by_prefix: Dict[Tuple[str, ...], List[Sequence[str]]] = defaultdict(list)
    for b in frequent:
        by_prefix[tuple(b[:-1])].append(b)
    for a in frequent:
        for b in by_prefix.get(tuple(a[1:]), []):
            cand = tuple(list(a) + [b[-1]])
            if cand not in seen:
                seen.add(cand)
                out.append(list(cand))
    return out


def _uniform_matrix(Q: np.ndarray, q: float, dev: torch.device
                    ) -> torch.Tensor:
    """``I + Q/q`` computed in float64, rounded to float32, on ``dev``."""
    M = torch.from_numpy(np.asarray(np.eye(Q.shape[0]) + Q / q, np.float32))
    return M.to(dev)


def ctmc_transition_probabilities(rate_matrix: np.ndarray, t: float,
                                  n_terms: Optional[int] = None,
                                  device: DeviceLike = None) -> np.ndarray:
    """CTMC P(t) by uniformization: q = max |Q_ii|, M = I + Q/q,
    P(t) = sum_k e^{-qt} (qt)^k / k! * M^k, the series length adapted to
    q*t.  float32 as the JAX package's scan: the weights rounded to
    float32, each term ``w_k * M^k`` a float32 product, the terms summed in
    XLA's windows of 32 over k."""
    dev = resolve_device(device)
    Q = np.asarray(rate_matrix, dtype=np.float64)
    q = float(np.max(-np.diag(Q)))
    if q <= 0:
        return np.eye(Q.shape[0])
    qt = q * t
    if n_terms is None:
        n_terms = max(32, int(math.ceil(qt + 10.0 * math.sqrt(qt) + 20.0)))
    M = _uniform_matrix(Q, q, dev)
    ks = np.arange(n_terms)
    log_w = -qt + ks * math.log(max(qt, 1e-300)) - \
        np.array([math.lgamma(k + 1) for k in ks])
    w = torch.from_numpy(np.exp(log_w).astype(np.float32)).to(dev)
    Mk = torch.eye(M.shape[0], dtype=torch.float32, device=dev)
    terms = []
    for k in range(n_terms):
        terms.append(w[k] * Mk)
        Mk = fma_matmul(Mk, M)
    stacked = torch.stack(terms).reshape(n_terms, -1).T      # (S*S, k)
    return fetch(window_sum(stacked, 1)).astype(np.float64).reshape(
        Q.shape)


def _power_chain(M: torch.Tensor, k: int) -> torch.Tensor:
    """(k, S, S) float32 M^1..M^k, each the previous power times M."""
    cur = torch.eye(M.shape[0], dtype=torch.float32, device=M.device)
    powers = []
    for _ in range(k):
        cur = fma_matmul(cur, M)
        powers.append(cur)
    return torch.stack(powers) if powers else \
        torch.zeros((0,) + tuple(M.shape), dtype=torch.float32,
                    device=M.device)


def _uniformization_powers(rate_matrix: np.ndarray, t: float,
                           device: DeviceLike = None
                           ) -> Tuple[float, np.ndarray, int]:
    """(q, powers, limit): q = max |Q_ii|; powers[k] = (I + Q/q)^k for
    k = 0..limit with limit = 4 + 6*sqrt(qt) + qt (the Spark job's series
    length), the float32 power chain read back as float64."""
    dev = resolve_device(device)
    Q = np.asarray(rate_matrix, dtype=np.float64)
    q = float(np.max(-np.diag(Q)))
    n = Q.shape[0]
    if q <= 0:
        return 0.0, np.eye(n)[None], 0
    count = q * t
    limit = int(4 + 6 * math.sqrt(count) + count)
    chain = fetch(_power_chain(_uniform_matrix(Q, q, dev), limit))
    powers = np.concatenate([np.eye(n)[None], chain.astype(np.float64)],
                            axis=0)
    return q, powers, limit


def _poisson_weights(count: float, limit: int) -> np.ndarray:
    ks = np.arange(limit + 1)
    log_w = -count + ks * math.log(max(count, 1e-300)) - \
        np.array([math.lgamma(k + 1) for k in ks])
    return np.exp(log_w)


def ctmc_state_dwell_time(rate_matrix: np.ndarray, time_horizon: float,
                          init_state: int, target_state: int,
                          end_state: Optional[int] = None,
                          precomputed=None, device: DeviceLike = None
                          ) -> float:
    """Expected dwell time in ``target_state`` over the horizon (the
    'stateDwellTime' branch): sum_i (T/(i+1)) * Pois(i) *
    sum_j P^j[init,target] * P^{i-j}[target,end].  ``precomputed`` takes a
    cached :func:`_uniformization_powers` result."""
    q, powers, limit = (precomputed if precomputed is not None
                        else _uniformization_powers(rate_matrix,
                                                    time_horizon, device))
    if limit == 0:
        return time_horizon if init_state == target_state else 0.0
    A = powers[:, init_state, target_state]
    B = (powers[:, target_state, end_state] if end_state is not None
         else np.ones(limit + 1))
    inner = np.convolve(A, B)[:limit + 1]
    pois = _poisson_weights(q * time_horizon, limit)
    i = np.arange(limit + 1)
    return float(((time_horizon / (i + 1)) * inner * pois).sum())


MS_PER_RATE_UNIT = {"hour": 3_600_000.0, "day": 86_400_000.0,
                    "week": 604_800_000.0}


def ctmc_rate_matrices(key_idx: np.ndarray, times_ms: np.ndarray,
                       state_idx: np.ndarray, n_keys: int, n_states: int,
                       rate_unit: str = "week") -> np.ndarray:
    """Per-key CTMC generator matrices from timestamped state observations
    (the StateTransitionRate job): events sorted by time within each key;
    each consecutive pair adds one cur->next transition and its elapsed
    time to cur's dwell; each visited row is scaled to transitions per
    rate unit and the diagonal set to -sum(off-diagonal).  A state with
    zero total dwell gets a zero row (the reference would print Inf), as
    in the JAX package.  numpy, as there: one lexsort and two bincounts.
    Returns (n_keys, S, S) float64."""
    ms_per_unit = MS_PER_RATE_UNIT.get(rate_unit)
    if ms_per_unit is None:
        raise ValueError(f"invalid rate time unit {rate_unit!r}; known: "
                         f"{sorted(MS_PER_RATE_UNIT)}")
    order = np.lexsort((np.asarray(times_ms), np.asarray(key_idx)))
    k = np.asarray(key_idx, dtype=np.int64)[order]
    t = np.asarray(times_ms, dtype=np.float64)[order]
    s = np.asarray(state_idx, dtype=np.int64)[order]
    same = k[1:] == k[:-1]
    kk, cur, nxt = k[:-1][same], s[:-1][same], s[1:][same]
    dt = (t[1:] - t[:-1])[same] / ms_per_unit
    counts = np.bincount((kk * n_states + cur) * n_states + nxt,
                         minlength=n_keys * n_states * n_states
                         ).reshape(n_keys, n_states, n_states).astype(float)
    duration = np.bincount(kk * n_states + cur, weights=dt,
                           minlength=n_keys * n_states
                           ).reshape(n_keys, n_states)
    visited = duration > 0
    scale = np.where(visited, 1.0 / np.where(visited, duration, 1.0), 0.0)
    rates = counts * scale[:, :, None]
    idx = np.arange(n_states)
    rates[:, idx, idx] = 0.0
    # + 0.0 turns a never-dwelt row's -0.0 into 0.0 for printing
    rates[:, idx, idx] = -rates.sum(axis=2) + 0.0
    return rates


def ctmc_transition_count(rate_matrix: np.ndarray, time_horizon: float,
                          init_state: int, target_one: int, target_two: int,
                          end_state: Optional[int] = None,
                          precomputed=None, device: DeviceLike = None
                          ) -> float:
    """Expected number of target_one -> target_two transitions over the
    horizon (the 'StateTransitionCount' branch): sum_i Pois(i) *
    sum_j P^j[init,t1] * M[t1,t2] * P^{i-1-j}[t2,end].  The inner sum runs
    to i-1 (the JAX package's correction of the reference, which weights
    A[j] by P(N >= j))."""
    q, powers, limit = (precomputed if precomputed is not None
                        else _uniformization_powers(rate_matrix,
                                                    time_horizon, device))
    if limit == 0:
        return 0.0
    A = powers[:, init_state, target_one]
    B = (powers[:, target_two, end_state] if end_state is not None
         else np.ones(limit + 1))
    step_pr = powers[1, target_one, target_two]
    inner = np.convolve(A, B)[:limit + 1] * step_pr
    pois = _poisson_weights(q * time_horizon, limit)
    return float((inner[:-1] * pois[1:]).sum())
