"""Correlation / association measures between attributes: the port of
``avenir_tpu/explore/correlations.py``.  The contingency counts are the
port's ``ops.histogram.joint_histogram`` on the device (exact float32
counts, as the JAX package's); the measures are its host float64 code.
The moment pass of :func:`numerical_correlations` sums in float64 on the
device and rounds the sums to float32: counts and the moments of
integer-valued attributes are exact at any size, and equal to the JAX
package's float32 sums wherever those are exact (below 2^24).

Parity targets (SURVEY.md §2.4):
  * ContingencyMatrix measures — cramerIndex, concentrationCoeff
    (Goodman-Kruskal tau), uncertaintyCoeff — with the reference's exact
    formulas including its quirks (util/ContingencyMatrix.java:86-186:
    cramer has no sqrt; uncertainty uses log10 and multiplies by the column
    marginal where the textbook divides — parity over propriety).
  * CramerCorrelation job (explore/CramerCorrelation.java): categorical
    attr pairs -> contingency matrix -> cramer index.
  * NumericalCorrelation (explore/NumericalCorrelation.java:87-179):
    Pearson via (n, Σx, Σy, Σxy, Σx², Σy²) tuple algebra; the combiner is
    the per-shard partial sum XLA already does.
  * HeterogeneityReductionCorrelation: concentration ('gini') or
    uncertainty ('entropy') coefficient per attr pair.
  * CategoricalClassAffinity (explore/CategoricalClassAffinity.java):
    per categorical value, affinity to each class value.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.table import ColumnarTable
from ..ops.histogram import joint_histogram
from ..runtime import resolve_device
from ..utils.tracing import fetch, layer, note_dispatch, note_h2d


def _codes(col: np.ndarray, dev) -> torch.Tensor:
    note_h2d(col.nbytes)
    return torch.from_numpy(np.ascontiguousarray(col)).to(dev)


def _joint_counts(a: np.ndarray, b: np.ndarray, num_a: int, num_b: int,
                  device=None) -> np.ndarray:
    """float32 (num_a, num_b) joint histogram of two code columns."""
    dev = resolve_device(device)
    note_dispatch()
    return fetch(joint_histogram(_codes(a, dev), _codes(b, dev), num_a,
                                 num_b))


class ContingencyMatrix:
    """Exact port of the measures of util/ContingencyMatrix.java (the counts
    themselves come from a device joint histogram)."""

    def __init__(self, table: np.ndarray):
        self.table = np.asarray(table, dtype=np.float64)

    def _aggregates(self):
        row = self.table.sum(axis=1)
        col = self.table.sum(axis=0)
        total = self.table.sum()
        row = np.where(row == 0, 1, row)
        col = np.where(col == 0, 1, col)
        return row, col, total

    def cramer_index(self) -> float:
        """(sum n_ij^2/(r_i c_j) - 1) / (min(R,C)-1)  (:86-124; no sqrt)."""
        row, col, _ = self._aggregates()
        pearson = (self.table ** 2 / (row[:, None] * col[None, :])).sum() - 1.0
        smaller = min(self.table.shape)
        return float(pearson / (smaller - 1))

    def concentration_coeff(self) -> float:
        """Goodman-Kruskal tau (:141-163)."""
        row, col, total = self._aggregates()
        rp = row / total
        cp = col / total
        p = self.table / total
        sum_one = ((p ** 2).sum(axis=1) / rp).sum()
        sum_two = (cp ** 2).sum()
        return float((sum_one - sum_two) / (1.0 - sum_two))

    def uncertainty_coeff(self) -> float:
        """Theil's U with the reference's formula verbatim (:165-186):
        log10, and the joint term is p_ij*log10(p_ij * c_j / r_i)."""
        row, col, total = self._aggregates()
        rp = row / total
        cp = col / total
        p = self.table / total
        with np.errstate(divide="ignore", invalid="ignore"):
            inner = p * np.log10(np.where(p > 0, p * cp[None, :] / rp[:, None], 1.0))
        sum_one = np.where(p > 0, inner, 0.0).sum()
        sum_two = (cp * np.log10(np.where(cp > 0, cp, 1.0))).sum()
        return float(sum_one / sum_two)


def categorical_pair_matrix(table: ColumnarTable, ord_a: int, ord_b: int,
                            device=None) -> ContingencyMatrix:
    """Joint histogram of two categorical columns on the device."""
    fa = table.schema.find_field_by_ordinal(ord_a)
    fb = table.schema.find_field_by_ordinal(ord_b)
    return ContingencyMatrix(_joint_counts(
        table.columns[ord_a], table.columns[ord_b],
        len(fa.cardinality or []), len(fb.cardinality or []), device))


def cramer_correlations(table: ColumnarTable, ordinals: Sequence[int],
                        device=None) -> List[Tuple[int, int, float]]:
    out = []
    for i, a in enumerate(ordinals):
        for b in ordinals[i + 1:]:
            out.append((a, b, categorical_pair_matrix(table, a, b, device)
                        .cramer_index()))
    return out


def heterogeneity_correlations(table: ColumnarTable, ordinals: Sequence[int],
                               algorithm: str = "gini", device=None
                               ) -> List[Tuple[int, int, float]]:
    """'gini' -> concentration coeff, 'entropy' -> uncertainty coeff
    (HeterogeneityReductionCorrelation.java:76-86)."""
    out = []
    for i, a in enumerate(ordinals):
        for b in ordinals[i + 1:]:
            m = categorical_pair_matrix(table, a, b, device)
            v = m.concentration_coeff() if algorithm == "gini" \
                else m.uncertainty_coeff()
            out.append((a, b, v))
    return out


def moments(X: torch.Tensor, m: torch.Tensor):
    """(n, F) masked moment pass (the JAX package's ``_moment_kernel``):
    n, Σx, Σx², Σ x_i x_j, summed in float64 on X's device."""
    X = X.double()
    Xm = X * m.double()[:, None]
    return m.double().sum(), Xm.sum(0), (Xm * X).sum(0), Xm.T @ X


def moment_sums(table: ColumnarTable, ordinals: Sequence[int], device=None,
                profile=None) -> np.ndarray:
    """This process's moment sums packed as one float64 vector
    ``[n, Σx (F), Σx² (F), Σxx (F*F)]``: the values a joined run
    all-reduces."""
    dev = resolve_device(device)
    with layer(profile, "encode"):
        X = np.stack([table.columns[o] for o in ordinals],
                     axis=1).astype(np.float64).astype(np.float32)
    with layer(profile, "h2d"):
        note_h2d(X.nbytes)
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
        mask = torch.ones(X.shape[0], dtype=torch.float32, device=dev)
    with layer(profile, "device"):
        note_dispatch()
        parts = moments(Xd, mask)
        packed = torch.cat([p.reshape(-1) for p in parts])
    with layer(profile, "readback"):
        return fetch(packed)


def numerical_correlations(table: ColumnarTable, ordinals: Sequence[int],
                           device=None, reduce=None, profile=None
                           ) -> List[Tuple[int, int, float]]:
    """Pearson r per pair via a single device moment pass
    (NumericalCorrelation.java:87-179's (n,Σx,Σy,Σxy,Σx²,Σy²) algebra), in
    the JAX package's float32 numpy arithmetic over the float32 sums;
    ``reduce`` sums the packed moments across processes first."""
    packed = moment_sums(table, ordinals, device, profile)
    if reduce is not None:
        packed = reduce(packed)
    F = len(ordinals)
    packed = packed.astype(np.float32)
    n = packed[0]
    s1, s2 = packed[1:1 + F], packed[1 + F:1 + 2 * F]
    cross = packed[1 + 2 * F:].reshape(F, F)
    out = []
    for i in range(len(ordinals)):
        for j in range(i + 1, len(ordinals)):
            num = n * cross[i, j] - s1[i] * s1[j]
            den = np.sqrt(n * s2[i] - s1[i] ** 2) * np.sqrt(n * s2[j] - s1[j] ** 2)
            out.append((ordinals[i], ordinals[j],
                        float(num / den) if den > 0 else 0.0))
    return out


def class_affinity(table: ColumnarTable, ordinals: Sequence[int],
                   device=None) -> Dict[int, np.ndarray]:
    """Per categorical attr: P(class | value) matrix (value, class) —
    the value->class affinity scores of CategoricalClassAffinity.java."""
    schema = table.schema
    cls_field = schema.class_attr_field
    C = len(cls_field.cardinality or [])
    out = {}
    for o in ordinals:
        f = schema.find_field_by_ordinal(o)
        counts = _joint_counts(table.columns[o], table.class_codes(),
                               len(f.cardinality or []), C, device)
        row = counts.sum(axis=1, keepdims=True)
        out[o] = counts / np.maximum(row, 1.0)
    return out
