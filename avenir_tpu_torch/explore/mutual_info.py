"""Mutual information distributions + feature-selection scores: the port of
``avenir_tpu/explore/mutual_info.py``.

Capability parity with explore/MutualInformation.java (SURVEY.md §2.4): one
pass computes class / feature / feature-pair / feature-class / pair-class
distributions, then entropies, mutual informations (natural log, matching
Math.log at MutualInformation.java:730,765,813) and the selection scores of
explore/MutualInformationScore.java:

  * MIM   — rank by I(X;C)                                   (:98)
  * MIFS  — greedy I(X;C) - beta * sum I(X;X_sel)            (:116)
  * JMI   — greedy sum I(X,X_sel;C)                          (:177)
  * DISR  — greedy sum I(X,X_sel;C)/H(X,X_sel,C)             (:185)
  * mRMR  — greedy I(X;C) - mean I(X;X_sel)                  (:265)

All the pairwise joint histograms come from one-hot contractions on the
device (the JAX package's ``_mi_kernel``): per row chunk, the (n, F*B)
feature one-hot times itself gives every pair's counts, and once more
weighted by each class column the class-augmented counts.  The products
are 0/1 and a chunk holds fewer than 2^24 rows, so every float32 count is
exact, as the JAX package's are; the chunks add up in float64 on the host
and the entropies and scores are the JAX package's host float64 code.  In
a joined run the counts are all-reduced before the normalization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..core.table import ColumnarTable
from ..runtime import resolve_device
from ..utils.tracing import fetch, layer, note_dispatch, note_h2d


def _entropy(p: np.ndarray) -> float:
    """Natural-log entropy over the flattened distribution."""
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def _mi(joint: np.ndarray, pa: np.ndarray, pb: np.ndarray) -> float:
    """I(A;B) = sum p(a,b) ln(p(a,b)/(p(a)p(b)))."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = joint / (pa[:, None] * pb[None, :])
        term = np.where(joint > 0, joint * np.log(np.where(joint > 0, ratio, 1.0)),
                        0.0)
    return float(term.sum())


@dataclass
class MutualInfoStats:
    feature_ordinals: List[int]
    class_values: List[str]
    # distributions (normalized)
    class_p: np.ndarray                      # (C,)
    feature_p: np.ndarray                    # (F, B)  (padded bins are 0)
    feature_class_p: np.ndarray              # (F, B, C)
    pair_p: np.ndarray                       # (F, F, B, B)
    pair_class_p: np.ndarray                 # (F, F, B, B, C)
    num_bins: List[int]

    # ---- entropies / MI ----
    def class_entropy(self) -> float:
        return _entropy(self.class_p)

    def feature_entropy(self, fi: int) -> float:
        return _entropy(self.feature_p[fi])

    def feature_class_mi(self, fi: int) -> float:
        return _mi(self.feature_class_p[fi], self.feature_p[fi], self.class_p)

    def pair_mi(self, fi: int, fj: int) -> float:
        return _mi(self.pair_p[fi, fj], self.feature_p[fi], self.feature_p[fj])

    def pair_class_mi(self, fi: int, fj: int) -> float:
        """I(Xi,Xj;C): joint (B*B, C) vs marginal pair dist and class dist."""
        joint = self.pair_class_p[fi, fj].reshape(-1, len(self.class_p))
        pair = self.pair_p[fi, fj].reshape(-1)
        return _mi(joint, pair, self.class_p)

    def pair_class_entropy(self, fi: int, fj: int) -> float:
        """H(Xi,Xj,C) (MutualInformation.java:815)."""
        return _entropy(self.pair_class_p[fi, fj])


def _mi_counts(bc: torch.Tensor, cc: torch.Tensor, B: int, C: int):
    """All MI counts of one row chunk on its device (the JAX package's
    ``_mi_kernel``): feature (F, B), class (C,), feature-class (F, B, C),
    pair (F, F, B, B) and pair-class (F, F, B, B, C), float32."""
    n, F = bc.shape
    dev = bc.device
    oh = (bc.long()[:, :, None] == torch.arange(B, device=dev)).float()
    ohc = (cc.long()[:, None] == torch.arange(C, device=dev)).float()
    flat = oh.reshape(n, F * B)
    feat = oh.sum(0)
    cls_counts = ohc.sum(0)
    feat_cls = (flat.T @ ohc).reshape(F, B, C)
    pair = (flat.T @ flat).reshape(F, B, F, B).permute(0, 2, 1, 3)
    pair_cls = torch.stack([(flat * ohc[:, c:c + 1]).T @ flat
                            for c in range(C)], dim=-1)
    pair_cls = pair_cls.reshape(F, B, F, B, C).permute(0, 2, 1, 3, 4)
    return feat, cls_counts, feat_cls, pair, pair_cls


def count_stats(table: ColumnarTable, device=None, chunk: int = 1 << 18,
                profile=None):
    """The raw counts of :func:`compute_stats` over this process's rows:
    (fields, feat, cls_counts, feat_cls, pair, pair_cls), float64."""
    dev = resolve_device(device)
    schema = table.schema
    fields = [f for f in schema.feature_fields if f.is_binned]
    F = len(fields)
    nbins = [f.num_bins for f in fields]
    B = max(nbins) if nbins else 1
    C = len(schema.class_attr_field.cardinality or [])
    with layer(profile, "encode"):
        bin_codes = np.stack([table.binned_codes(f.ordinal) for f in fields],
                             axis=1).astype(np.int32) if fields else \
            np.zeros((table.n_rows, 0), np.int32)
        cls = np.ascontiguousarray(
            table.columns[schema.class_attr_field.ordinal], np.int32)
    with layer(profile, "h2d"):
        note_h2d(bin_codes.nbytes + cls.nbytes, transfers=2)
        d_bins = torch.from_numpy(np.ascontiguousarray(bin_codes)).to(dev)
        d_cls = torch.from_numpy(cls).to(dev)
    shapes = ((F, B), (C,), (F, B, C), (F, F, B, B), (F, F, B, B, C))
    acc = [torch.zeros(s, dtype=torch.float64, device=dev) for s in shapes]
    with layer(profile, "device"):
        for s in range(0, table.n_rows, chunk):
            note_dispatch()
            for a, part in zip(acc, _mi_counts(d_bins[s:s + chunk],
                                               d_cls[s:s + chunk], B, C)):
                a += part.double()
    with layer(profile, "readback"):
        out = [fetch(a) for a in acc]
    return (fields, *out)


def compute_stats(table: ColumnarTable, device=None, chunk: int = 1 << 18,
                  reduce=None, profile=None) -> MutualInfoStats:
    """All distributions in one (chunked) pass over the rows on ``device``;
    ``reduce`` (an element-wise sum across processes, e.g.
    ``parallel.distributed.all_reduce_host_array``) makes them global
    before they are normalized."""
    fields, feat, cls_counts, feat_cls, pair, pair_cls = count_stats(
        table, device, chunk, profile)
    if reduce is not None:
        parts = [feat, cls_counts, feat_cls, pair, pair_cls]
        flat = reduce(np.concatenate([p.ravel() for p in parts]))
        splits = np.cumsum([p.size for p in parts])[:-1]
        feat, cls_counts, feat_cls, pair, pair_cls = (
            seg.reshape(p.shape) for seg, p in zip(np.split(flat, splits),
                                                   parts))
    total = max(cls_counts.sum(), 1e-12)
    return MutualInfoStats(
        feature_ordinals=[f.ordinal for f in fields],
        class_values=list(table.schema.class_attr_field.cardinality or []),
        class_p=cls_counts / total, feature_p=feat / total,
        feature_class_p=feat_cls / total, pair_p=pair / total,
        pair_class_p=pair_cls / total, num_bins=[f.num_bins for f in fields])


# --------------------------------------------------------------------------
# selection scores (host-side greedy loops over the small MI tables)
# --------------------------------------------------------------------------

def mim_score(stats: MutualInfoStats) -> List[Tuple[int, float]]:
    """Mutual information maximization: rank I(X;C) descending."""
    F = len(stats.feature_ordinals)
    scores = [(stats.feature_ordinals[i], stats.feature_class_mi(i))
              for i in range(F)]
    return sorted(scores, key=lambda t: -t[1])


def _greedy(stats: MutualInfoStats, score_fn) -> List[Tuple[int, float]]:
    F = len(stats.feature_ordinals)
    selected: List[int] = []
    out: List[Tuple[int, float]] = []
    while len(selected) < F:
        best, best_score = None, -np.inf
        for i in range(F):
            if i in selected:
                continue
            s = score_fn(i, selected)
            if s > best_score:
                best, best_score = i, s
        selected.append(best)
        out.append((stats.feature_ordinals[best], best_score))
    return out


def mifs_score(stats: MutualInfoStats, redundancy_factor: float = 1.0
               ) -> List[Tuple[int, float]]:
    """MIFS: greedy I(X;C) - beta * sum_sel I(X;X_s)."""
    rel = [stats.feature_class_mi(i) for i in range(len(stats.feature_ordinals))]

    def score(i, selected):
        red = sum(stats.pair_mi(i, j) for j in selected)
        return rel[i] - redundancy_factor * red

    return _greedy(stats, score)


def jmi_score(stats: MutualInfoStats) -> List[Tuple[int, float]]:
    """JMI: first pick = max relevance, then greedy sum I(X,X_sel;C)."""
    return _jmi_helper(stats, disr=False)


def disr_score(stats: MutualInfoStats) -> List[Tuple[int, float]]:
    """DISR: like JMI but each term normalized by H(X,X_sel,C)."""
    return _jmi_helper(stats, disr=True)


def _jmi_helper(stats: MutualInfoStats, disr: bool) -> List[Tuple[int, float]]:
    F = len(stats.feature_ordinals)
    ranked = mim_score(stats)
    first_ord, first_score = ranked[0]
    first = stats.feature_ordinals.index(first_ord)
    selected = [first]
    out = [(first_ord, first_score)]
    while len(selected) < F:
        best, best_score = None, -np.inf
        for i in range(F):
            if i in selected:
                continue
            s = 0.0
            for j in selected:
                v = stats.pair_class_mi(i, j)
                if disr:
                    h = stats.pair_class_entropy(i, j)
                    v = v / h if h > 0 else 0.0
                s += v
            if s > best_score:
                best, best_score = i, s
        selected.append(best)
        out.append((stats.feature_ordinals[best], best_score))
    return out


def mrmr_score(stats: MutualInfoStats) -> List[Tuple[int, float]]:
    """mRMR: greedy I(X;C) - mean_sel I(X;X_s)."""
    rel = [stats.feature_class_mi(i) for i in range(len(stats.feature_ordinals))]

    def score(i, selected):
        if not selected:
            return rel[i]
        red = sum(stats.pair_mi(i, j) for j in selected) / len(selected)
        return rel[i] - red

    return _greedy(stats, score)


SCORE_ALGORITHMS = {
    "mutual.info.maximization": lambda s, rf: mim_score(s),
    "mutual.info.feature.selection": lambda s, rf: mifs_score(s, rf),
    "joint.mutual.info": lambda s, rf: jmi_score(s),
    "double.input.symmetrical.relevance": lambda s, rf: disr_score(s),
    "min.redundancy.max.relevance": lambda s, rf: mrmr_score(s),
}
