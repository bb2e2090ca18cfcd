"""MCMC convergence diagnostics: the port of ``avenir_tpu/stats/mcconverge.py``
(numpy, copied).  Reference python/lib/mcconverge.py:
Geweke z-scores over a burn-in sweep and Raftery-Lewis burn-in/sample-size
estimation.  The reference's Raftery-Lewis code is python-2 pseudocode with
typos (np.qeros, undefined vars); this is the corrected standard method —
binarize the chain at a quantile threshold, fit the 2-state transition
matrix, and derive sizes from its mixing rate."""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Sequence, Tuple

import numpy as np


class GewekeConvergence:
    """Modified Geweke z-score for each candidate burn-in size
    (mcconverge.py:13-37): compare the mean of the first 10% window after
    burn-in against the last 50% window, scaled by their standard errors.
    |z| < ~2 indicates the post-burn-in chain is stationary."""

    def __init__(self, burn_in_sizes: Sequence[int],
                 window_a: float = 0.1, window_b: float = 0.5):
        self.burn_in_sizes = list(burn_in_sizes)
        self.window_a = window_a
        self.window_b = window_b
        self.zscores: List[Tuple[int, int, float]] = []

    def calculate_zscore(self, data: Sequence[float]) -> List[Tuple[int, int, float]]:
        x = np.asarray(data, dtype=np.float64)
        n = len(x)
        self.zscores = []  # one chain per call; no cross-chain mixing
        for bi in self.burn_in_sizes:
            if bi >= n:
                continue
            a = x[bi: bi + int((n - bi) * self.window_a)]
            b = x[n - int((n - bi) * self.window_b):]
            if len(a) < 2 or len(b) < 2:
                continue
            se = math.sqrt(a.var() / len(a) + b.var() / len(b))
            z = (a.mean() - b.mean()) / se if se > 0 else 0.0
            self.zscores.append((n, bi, float(z)))
        return self.zscores

    def get_zscores(self) -> List[Tuple[int, int, float]]:
        return self.zscores


class RafteryLewisConvergence:
    """Raftery-Lewis run-length control (mcconverge.py:40-87).

    Parameters mirror the reference: k = thinning_interval,
    s = percent_value_prob (probability the quantile estimate is within r),
    r = percent_value_conf_interval (tolerance), e = trans_prob_conf_limit
    (how close the binarized chain must be to stationarity at burn-in end).
    """

    def __init__(self, thinning_interval: int, percent_value_prob: float,
                 percent_value_conf_interval: float,
                 trans_prob_conf_limit: float, quantile: float = 0.025):
        self.thinning_interval = thinning_interval
        self.percent_value_prob = percent_value_prob
        self.percent_value_conf_interval = percent_value_conf_interval
        self.trans_prob_conf_limit = trans_prob_conf_limit
        self.quantile = quantile

    def find_sample_size(self, data: Sequence[float]) -> Tuple[float, float]:
        """(burn_in_size, sample_size) in un-thinned iterations."""
        x = np.asarray(data, dtype=np.float64)
        u = np.quantile(x, self.quantile)
        z = (x < u).astype(np.int64)

        # 2x2 transition counts of the binarized chain
        tr = np.zeros((2, 2), dtype=np.float64)
        np.add.at(tr, (z[:-1], z[1:]), 1.0)
        row0, row1 = tr[0].sum(), tr[1].sum()
        if row0 == 0 or row1 == 0:
            return 0.0, float(len(x))
        alpha = tr[0, 1] / row0            # P(0 -> 1)
        beta = tr[1, 0] / row1             # P(1 -> 0)
        if alpha <= 0 or beta <= 0 or alpha + beta >= 1:
            return 0.0, float(len(x))

        lam = 1.0 - alpha - beta           # second eigenvalue: mixing rate
        burn_in = (math.log(self.trans_prob_conf_limit * (alpha + beta)
                            / max(alpha, beta)) / math.log(abs(lam)))
        burn_in *= self.thinning_interval

        phi = NormalDist().inv_cdf(0.5 * (1.0 + self.percent_value_prob))
        n = (alpha * beta * (2.0 - alpha - beta) / (alpha + beta) ** 3
             / (self.percent_value_conf_interval / phi) ** 2)
        n *= self.thinning_interval
        return max(burn_in, 0.0), n
