"""Drift scoring: port of ``avenir_tpu/monitor/drift.py``.

A finalized window is a (R, B) count matrix in the baseline's stacked
layout (``monitor/baseline.py``): numeric features, categorical features,
and the prediction-class distribution as the last row.  One scoring pass
covers every row.  Statistics per row, over the row's valid bins (the pad
bins out to B_max hold 1.0 on both sides and add exactly zero):

  * ``psi``  — population stability index, sum (q~ - p~) ln(q~/p~) with
    empty bins floored at ``eps``;
  * ``kl``   — KL(q~ || p~), same floored distributions;
  * ``js``   — Jensen-Shannon divergence (nats, at most ln 2);
  * ``ks``   — binned Kolmogorov-Smirnov max |CDF_p - CDF_q| over the
    unfloored distributions (numeric rows);
  * ``chi2`` — chi-square distance sum (q - p)^2 / p over the bins the
    baseline populated (classic statistic divided by the window count).

:func:`_score_kernel` computes them in float32 on the scorer's device in
the rounding of the reference's jitted kernel as XLA compiles it for the
CPU (``utils/xla_math.py``): the baseline-only operands (``pc``,
``log(pc)``, ``1/pc``) are the constants XLA folds; ``log`` of the window
side is XLA's polynomial; every row sum runs left to right with its
products fused (``acc = fma(a, b, acc)``); the chi-square divide is a
multiply by the folded reciprocal; ``js`` is ``(A + B) * 0.5``, the
form XLA's simplifier gives ``0.5*A + 0.5*B`` (the same value).
:meth:`DriftScorer.score_table` counts through the bin-counts kernel (B4).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels.histogram import bin_counts
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch
from ..utils.xla_math import (fma_row_sum, folded_log_f32, seq_cumsum,
                              seq_row_sum, xla_log_f32)
from .baseline import Baseline, CLASS, NUMERIC, PREDICTION_SCOPE

STATS = ("psi", "kl", "js", "ks", "chi2")
DEFAULT_EPS = 1e-6

# which statistics the policy treats as meaningful per row kind: KS needs
# ordered bins; chi-square is the categorical/prior test (psi/kl/js apply
# everywhere)
STAT_KINDS = {
    "psi": ("numeric", "categorical", "class"),
    "kl": ("numeric", "categorical", "class"),
    "js": ("numeric", "categorical", "class"),
    "ks": ("numeric",),
    "chi2": ("categorical", "class"),
}


@dataclass
class RowScore:
    """One monitored row's drift scores for one window."""
    scope: str                  # feature name, or __prediction__
    kind: str                   # numeric | categorical | class
    stats: Dict[str, float]

    def applicable(self, stat: str) -> bool:
        return self.kind in STAT_KINDS[stat]


@dataclass
class DriftReport:
    """All rows of one scored window."""
    index: int
    kind: str                   # window | longterm
    n_rows: int
    rows: List[RowScore] = dc_field(default_factory=list)

    def row(self, scope: str) -> RowScore:
        for r in self.rows:
            if r.scope == scope:
                return r
        raise KeyError(f"no scored row {scope!r}")

    def max_stat(self, stat: str) -> float:
        vals = [r.stats[stat] for r in self.rows if r.applicable(stat)]
        return max(vals) if vals else 0.0


@dataclass
class ScoreConstants:
    """The baseline side of the score, on the scorer's device: what XLA
    folds at compile time in the reference (all (R, B) float32 but
    ``valid`` / ``populated`` bool)."""
    p: torch.Tensor             # baseline probabilities
    valid: torch.Tensor         # bins < the row's n_bins
    populated: torch.Tensor     # valid & p > 0 (chi-square's bins)
    pc: torch.Tensor            # where(valid, max(p, eps), 1)
    log_pc: torch.Tensor        # folded log(pc)
    inv_pc: torch.Tensor        # folded 1 / pc
    eps: float                  # float32 eps

    @classmethod
    def build(cls, p: np.ndarray, valid: np.ndarray, eps: float,
              device) -> "ScoreConstants":
        p = np.asarray(p, np.float32)
        eps32 = np.float32(eps)
        pc = np.where(valid, np.maximum(p, eps32), np.float32(1.0))
        pc = pc.astype(np.float32)
        inv_pc = (np.float32(1.0) / pc).astype(np.float32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(p=dev(p), valid=dev(valid), populated=dev(valid & (p > 0)),
                   pc=dev(pc), log_pc=dev(folded_log_f32(pc)),
                   inv_pc=dev(inv_pc), eps=float(eps32))


def _score_kernel(k: ScoreConstants, q_counts: torch.Tensor) -> torch.Tensor:
    """(..., R, B) float32 window counts -> (..., R, 5) float32 statistics,
    in the order of :data:`STATS`.  Every operation is elementwise or along
    the bins, so windows stacked on the leading axes score in one pass
    with the same bits as one at a time."""
    totals = seq_row_sum(q_counts)
    q = torch.where(k.valid, q_counts / torch.clamp(totals, min=1.0)[..., None],
                    torch.zeros_like(q_counts))
    qc = torch.where(k.valid, torch.clamp(q, min=k.eps), torch.ones_like(q))
    m = (qc + k.pc) * 0.5
    log_qc, log_m = xla_log_f32(torch.stack([qc, m]))
    log_ratio = log_qc - k.log_pc
    d = q - k.p
    sq = torch.where(k.populated, d * d, torch.zeros_like(d))
    pc = k.pc.expand_as(qc)
    # the five fused product sums ride one float64 pass a bin
    sums = fma_row_sum(
        torch.stack([qc - k.pc, qc, pc, qc, sq]),
        torch.stack([log_ratio, log_ratio, k.log_pc - log_m, log_qc - log_m,
                     k.inv_pc.expand_as(qc)]))
    psi, kl, chi2 = sums[0], sums[1], sums[4]
    js = (sums[2] + sums[3]) * 0.5
    ks = seq_cumsum(k.p - q).abs().amax(dim=-1)
    return torch.stack([psi, kl, js, ks, chi2], dim=-1)


class DriftScorer:
    """Scores stacked window count matrices against one baseline.

    The baseline's constants are built once on ``device`` (default: the
    process device, ``cuda`` unless a caller asks for the CPU); every
    window is then one scoring pass and one (R, 5) readback."""

    def __init__(self, baseline: Baseline, eps: float = DEFAULT_EPS,
                 device=None):
        self.baseline = baseline
        self.eps = float(eps)
        self.device = resolve_device(device)
        r, b = baseline.counts.shape
        valid = np.zeros((r, b), dtype=bool)
        for i, s in enumerate(baseline.specs):
            valid[i, :s.n_bins] = True
        self._k = ScoreConstants.build(baseline.probabilities(), valid,
                                       self.eps, self.device)

    def score_device(self, counts: torch.Tensor) -> torch.Tensor:
        """(..., R, 5) float32 statistics of (..., R, B) window counts,
        moved to the scorer's device (no readback)."""
        return _score_kernel(self._k, counts.to(self.device, torch.float32))

    def score_counts(self, window_counts: np.ndarray, n_rows: int,
                     index: int = 0, kind: str = "window") -> DriftReport:
        """Score one finalized (R, B) window count matrix."""
        return self.score_many([(window_counts, n_rows, index, kind)])[0]

    def score_many(self, windows) -> List[DriftReport]:
        """Score several finalized windows, ``[(counts, n_rows, index,
        kind), ...]``, in one pass and one readback (a tumbling window and
        its long window close together)."""
        for counts, *_ in windows:
            if counts.shape != self.baseline.counts.shape:
                raise ValueError(
                    f"window shape {counts.shape} does not match "
                    f"baseline {self.baseline.counts.shape}")
        note_dispatch(site="drift.score", n=len(windows))
        q = torch.from_numpy(np.stack(
            [np.asarray(c, np.float32) for c, *_ in windows]))
        mats = fetch(self.score_device(q))
        return [self.report(mat, n, index, kind)
                for mat, (_, n, index, kind) in zip(mats, windows)]

    def report(self, mat: np.ndarray, n_rows: int, index: int = 0,
               kind: str = "window") -> DriftReport:
        """A DriftReport from an (R, 5) statistics matrix."""
        report = DriftReport(index=index, kind=kind, n_rows=int(n_rows))
        for i, s in enumerate(self.baseline.specs):
            scope = PREDICTION_SCOPE if s.kind == CLASS else s.name
            row_kind = NUMERIC if s.kind == NUMERIC else s.kind
            report.rows.append(RowScore(
                scope=scope, kind=row_kind,
                stats={name: float(mat[i, j])
                       for j, name in enumerate(STATS)}))
        return report

    def score_table(self, table, index: int = 0,
                    class_codes: Optional[np.ndarray] = None) -> DriftReport:
        """One-shot: encode + count (B4) + score a table as one window."""
        from .baseline import encode_monitor_codes
        codes = encode_monitor_codes(table, self.baseline.specs,
                                     class_codes=class_codes)
        counts = bin_counts(torch.from_numpy(codes).to(self.device),
                            self.baseline.n_bins_max)
        mat = fetch(self.score_device(counts))
        return self.report(mat, table.n_rows, index=index)
