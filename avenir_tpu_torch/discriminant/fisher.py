"""Univariate Fisher linear discriminant: the port of
``avenir_tpu/discriminant/fisher.py``.

Reference: discriminant/FisherDiscriminant.java — reuses the chombo
``NumericalAttrStats`` MR (per-(attr, classValue) count/mean/variance) and in
the reducer cleanup emits, per attribute, the two-class boundary:

  pooledVariance = (var0*n0 + var1*n1) / (n0+n1)
  logOddsPrior   = ln(n0/n1)
  discrimValue   = (mean0+mean1)/2 - logOddsPrior * pooledVariance / meanDiff

(FisherDiscriminant.java:44-55).  Class order follows first-seen in the
reference reducer; here it is the schema cardinality order, which is
deterministic.

The class-conditional moments for ALL attributes are two one-hot
contractions — onehot(class).T @ X and onehot(class).T @ X² — one pass on
the device over the centered float32 values.  They sum in float64 there
and round to float32 (the JAX package sums in float32 in XLA's dot order,
which the port does not reproduce: its boundaries are held to a
tolerance); mean and variance follow in float32 as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..core.table import ColumnarTable
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch, note_h2d


@dataclass
class FisherResult:
    attr_ordinals: List[int]
    counts: np.ndarray        # (2,) per-class record counts
    means: np.ndarray         # (2, F)
    variances: np.ndarray     # (2, F)

    def boundary(self, fi: int) -> Tuple[float, float, float]:
        """(logOddsPrior, pooledVariance, discrimValue) for feature index."""
        n0, n1 = float(self.counts[0]), float(self.counts[1])
        v0, v1 = float(self.variances[0, fi]), float(self.variances[1, fi])
        m0, m1 = float(self.means[0, fi]), float(self.means[1, fi])
        pooled = (v0 * n0 + v1 * n1) / (n0 + n1)
        log_odds = math.log(n0 / n1)
        mean_diff = m0 - m1
        # a constant feature (equal class means) has no prior-shift term; the
        # midpoint is the only defensible boundary rather than a div-by-zero
        discrim = (m0 + m1) / 2 - \
            (log_odds * pooled / mean_diff if mean_diff != 0.0 else 0.0)
        return log_odds, pooled, discrim

    def to_lines(self, delim: str = ",") -> List[str]:
        lines = []
        for fi, o in enumerate(self.attr_ordinals):
            lo, pv, dv = self.boundary(fi)
            lines.append(f"{o}{delim}{lo:.9g}{delim}{pv:.9g}{delim}{dv:.9g}")
        return lines


def class_moments(X: np.ndarray, cls_onehot: np.ndarray, device=None):
    """(counts (2,), mean (2, F), var (2, F)) float32 of float32 ``X`` by
    class: the sums on the device in float64, then rounded."""
    dev = resolve_device(device)
    note_h2d(X.nbytes + cls_onehot.nbytes, transfers=2)
    Xd = torch.from_numpy(np.ascontiguousarray(X)).to(dev).double()
    oh = torch.from_numpy(np.ascontiguousarray(cls_onehot)).to(dev).double()
    note_dispatch()
    packed = torch.cat([oh.sum(0)[:, None], oh.T @ Xd, oh.T @ (Xd * Xd)],
                       dim=1)
    packed = fetch(packed).astype(np.float32)
    F = X.shape[1]
    counts, s1, s2 = packed[:, 0], packed[:, 1:1 + F], packed[:, 1 + F:]
    safe = np.maximum(counts, np.float32(1.0))[:, None]
    mean = s1 / safe
    var = s2 / safe - mean * mean
    return counts, mean, var


def fisher_discriminant(table: ColumnarTable, device=None) -> FisherResult:
    schema = table.schema
    num_fields = [f for f in schema.feature_fields if f.is_numeric]
    if not num_fields:
        raise ValueError("Fisher discriminant needs numeric feature fields")
    card = schema.class_attr_field.cardinality or []
    if len(card) != 2:
        raise ValueError("Fisher discriminant is two-class "
                         f"(class cardinality = {len(card)})")
    X = np.stack([table.columns[f.ordinal] for f in num_fields],
                 axis=1).astype(np.float64)
    cls = table.class_codes()
    onehot = np.zeros((table.n_rows, 2))
    valid = cls >= 0
    onehot[np.arange(table.n_rows)[valid], cls[valid]] = 1.0
    # shift by the global per-feature mean before the one-pass moment
    # contraction: E[x²]-E[x]² in float32 cancels catastrophically for
    # features with large means; variance is shift-invariant, so centering
    # first keeps the f32 device path accurate
    shift = X.mean(axis=0)
    counts, mean, var = class_moments((X - shift).astype(np.float32),
                                      onehot.astype(np.float32), device)
    mean = np.asarray(mean, np.float64) + shift
    counts_np = np.asarray(counts, np.float64)
    if counts_np.min() <= 0:
        missing = card[int(np.argmin(counts_np))]
        raise ValueError(f"class {missing!r} has no rows; Fisher boundary "
                         "needs both classes present")
    return FisherResult(attr_ordinals=[f.ordinal for f in num_fields],
                        counts=counts_np,
                        means=mean,
                        variances=np.asarray(var, np.float64))


def classify(result: FisherResult, table: ColumnarTable, fi: int) -> np.ndarray:
    """Classify by the univariate boundary on feature index fi: class 0 when
    the value is on mean0's side of discrimValue."""
    _, _, dv = result.boundary(fi)
    x = table.columns[result.attr_ordinals[fi]].astype(np.float64)
    m0, m1 = result.means[0, fi], result.means[1, fi]
    side0 = x >= dv if m0 >= m1 else x < dv
    return np.where(side0, 0, 1)
