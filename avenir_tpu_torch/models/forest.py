"""Random-forest prediction: port of the predict half of
``avenir_tpu/models/forest.py``.

  * ``EnsembleModel``   == model/EnsemblePredictiveModel.java:69-113 —
    weighted majority vote, min-odds-ratio veto (ambiguous -> None);
  * ``model_predictor`` == model/ModelPredictor.java:46-82 — output modes
    withRecord / withKId / withActualClassAttr, optional error counting.

Device path: all members' predicate tensors are stacked (padded to the
widest member, plus one always-match fallback sentinel path each) and the
whole vote is one launch of the ensemble-vote kernel per batch
(``kernels/vote.py``).  Ensembles the stacked form rejects — a degenerate
member, bounds that are not float32-exact, non-integer weights — vote on
the host in float64 (``_predict_host``); that is the reference's own
semantics for them, not a fallback, and every run of it is recorded as
``ensemble.vote.host`` in the KernelBackends ledger.  Training forests is
not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.metrics import Counters
from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable
from ..kernels.dispatch import note_backend, resolve_backend
from ..kernels.vote import ensemble_vote, prepare_vote_model
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch
from .tree import DecisionPathList, DecisionTreeModel, FeatureCache


class EnsembleModel:
    """Weighted-vote ensemble with min-odds veto
    (model/EnsemblePredictiveModel.java:69-113).  The reference requires an
    odd number of models for unweighted votes; we keep that check."""

    def __init__(self, models: List[DecisionTreeModel],
                 weights: Optional[Sequence[float]] = None,
                 min_odds_ratio: float = 1.0,
                 require_odd: bool = True,
                 stack: bool = True,
                 device=None):
        if require_odd and weights is None and len(models) % 2 == 0:
            raise ValueError("need odd number of models in ensemble")
        self.models = models
        self.weights = list(weights) if weights is not None \
            else [1.0] * len(models)
        self.min_odds_ratio = min_odds_ratio
        self.device = resolve_device(device)
        # vote vocabulary is fixed by the member models; "" is the no-paths
        # sentinel a degenerate member can emit
        self.classes = sorted({c for m in models for c in m.matrix.classes}
                              | {""})
        self._cls_arr = np.array(self.classes)
        # vote-index -> label decode (trailing None = min-odds veto): one
        # table for the batch path and the serving layer
        self._lut = np.concatenate([self._cls_arr.astype(object), [None]])
        self._vote_backend = resolve_backend(self.device)
        # stack=False skips device placement (callers that only need the
        # stacked layout)
        self._stacked = self._stack_members() if stack else None

    def stacked_host(self):
        """The HOST (numpy) form of the stacked member tensors
        ``(lo, hi, num_r, cat_m, cat_r, cls_oh)`` — layout identical to the
        JAX package's.  None when any member is degenerate (no
        paths/classes), bounds are not f32-exact, or the vote weights are
        not small integers — fractional weights must accumulate in the host
        path's float64 (f32 vote sums could flip argmax/veto decisions near
        ties)."""
        mats = [m.matrix for m in self.models]
        if not mats or any(m.n_paths == 0 or not m.classes or
                           not m._bounds_f32_exact for m in mats):
            return None
        if any(w != round(w) or abs(w) >= float(1 << 24)
               for w in self.weights):
            return None
        F = len(mats[0].feat_ordinals)
        cmax = max(m.cat_mask.shape[2] for m in mats)
        P = max(m.n_paths for m in mats) + 1          # + fallback sentinel
        T, K = len(mats), len(self.classes)
        cls_idx = {c: i for i, c in enumerate(self.classes)}
        lo = np.full((T, P, F), np.inf, dtype=np.float32)   # pad: never match
        hi = np.full((T, P, F), -np.inf, dtype=np.float32)
        num_r = np.ones((T, P, F), dtype=bool)
        cat_m = np.zeros((T, P, F, cmax), dtype=bool)
        cat_r = np.zeros((T, P, F), dtype=bool)
        cls_oh = np.zeros((T, P, K), dtype=np.float32)
        for t, m in enumerate(mats):
            p = m.n_paths
            lo[t, :p] = m.lo.astype(np.float32)
            hi[t, :p] = m.hi.astype(np.float32)
            num_r[t, :p] = m.num_restricted
            cat_m[t, :p, :, :m.cat_mask.shape[2]] = m.cat_mask
            cat_r[t, :p] = m.cat_restricted
            for pi in range(p):
                cls_oh[t, pi, cls_idx[m.classes[m.path_cls[pi]]]] = 1.0
            # sentinel: always matches, votes the member's fallback class
            lo[t, p] = -np.inf
            hi[t, p] = np.inf
            num_r[t, p] = False
            cls_oh[t, p, cls_idx[m.classes[int(m.fallback_cls)]]] = 1.0
        return lo, hi, num_r, cat_m, cat_r, cls_oh

    def _stack_members(self):
        """:meth:`stacked_host` placed on the device once, in the vote
        kernel's layout (None passes through: the host vote serves those
        ensembles)."""
        host = self.stacked_host()
        if host is None:
            return None
        return prepare_vote_model(*host, np.asarray(self.weights, np.float32),
                                  self.device)

    def device_inputs(self, table: ColumnarTable, cache=None):
        """The single gate for the device vote: (d_vals, d_codes) when this
        table can take it — members stacked, rows present, and features
        f32-exact — else None (host vote).  Shared by predict() and the
        serving layer so the two paths can never disagree on WHEN the
        kernel applies."""
        if self._stacked is None or table.n_rows == 0:
            return None
        cache = cache if cache is not None else FeatureCache()
        m0 = self.models[0].matrix
        vals, codes = cache.host(m0, table)
        if not m0._f32_safe(vals):
            return None
        return cache.device(vals, codes, self.device)

    def predict(self, table: ColumnarTable) -> List[Optional[str]]:
        """Weighted vote: device kernel when available, else one (n, K)
        host reduction over per-member predictions."""
        cache = FeatureCache()
        dev = self.device_inputs(table, cache)
        if dev is not None:
            return list(self._lut[fetch(self.vote_device(*dev))])
        return self._predict_host(table, cache)

    def vote_device(self, d_vals, d_codes) -> torch.Tensor:
        """(n,) int32 vote indices on the device: ONE kernel launch for the
        whole batch (the kernel keeps no (n,T,P) intermediate, so there is
        nothing to chunk)."""
        note_dispatch(site="ensemble.vote")
        note_backend("ensemble.vote", self._vote_backend)
        return ensemble_vote(d_vals, d_codes, self._stacked,
                             self.min_odds_ratio)

    def _predict_host(self, table: ColumnarTable,
                      cache) -> List[Optional[str]]:
        note_backend("ensemble.vote", "host")
        n = table.n_rows
        cls_arr = self._cls_arr
        mat = np.zeros((n, len(cls_arr)), dtype=np.float64)
        rows = np.arange(n)
        for model, w in zip(self.models, self.weights):
            pred, _ = model.predict(table, features=cache)
            idx = np.searchsorted(cls_arr, np.asarray(pred))
            # (rows, idx) pairs are unique within one model's votes, so plain
            # fancy-index += is exact
            mat[rows, idx] += w
        order = np.argsort(-mat, axis=1)
        best = cls_arr[order[:, 0]]
        out = best.astype(object)
        if self.min_odds_ratio > 1.0 and mat.shape[1] > 1:
            top = mat[rows, order[:, 0]]
            second = np.maximum(mat[rows, order[:, 1]], 1e-12)
            out[top / second <= self.min_odds_ratio] = None
        return list(out)


OUTPUT_WITH_RECORD = "withRecord"
OUTPUT_WITH_ID = "withKId"
OUTPUT_WITH_CLASS_ATTR = "withActualClassAttr"


def model_predictor(table: ColumnarTable, schema: FeatureSchema,
                    path_lists: List[DecisionPathList],
                    output_mode: str = OUTPUT_WITH_RECORD,
                    id_ordinal: int = 0,
                    class_attr_ordinal: Optional[int] = None,
                    error_counting: bool = False,
                    weights: Optional[Sequence[float]] = None,
                    min_odds_ratio: float = 1.0,
                    out_delim: str = ",",
                    counters: Optional[Counters] = None,
                    device=None) -> List[str]:
    """The generic predictor job body: ensemble (or single-model) prediction
    with the reference's output modes (model/ModelPredictor.java:87-150) and
    optional per-member vote weights (:144-151)."""
    device = resolve_device(device)
    models = [DecisionTreeModel(pl, schema, device=device)
              for pl in path_lists]
    if len(models) == 1:
        preds, _ = models[0].predict(table)
        pred_list: List[Optional[str]] = list(preds)
    else:
        pred_list = EnsembleModel(models, weights=weights,
                                  min_odds_ratio=min_odds_ratio,
                                  require_odd=min_odds_ratio <= 1.0 and
                                  weights is None,
                                  device=device).predict(table)
    raw = table.raw_rows
    preds = [p if p is not None else "ambiguous" for p in pred_list]
    if output_mode == OUTPUT_WITH_RECORD and raw is not None:
        lines = [out_delim.join(r) + out_delim + p
                 for r, p in zip(raw, preds)]
    elif output_mode == OUTPUT_WITH_ID:
        rids = table.str_columns[id_ordinal] \
            if id_ordinal in table.str_columns \
            else map(str, range(table.n_rows))
        lines = [rid + out_delim + p for rid, p in zip(rids, preds)]
    elif output_mode == OUTPUT_WITH_CLASS_ATTR and raw is not None:
        if class_attr_ordinal is not None:
            lines = [f"{i}{out_delim}{r[class_attr_ordinal]}{out_delim}{p}"
                     for i, (r, p) in enumerate(zip(raw, preds))]
        else:
            lines = [f"{i}{out_delim}{out_delim}{p}"
                     for i, p in enumerate(preds)]
    else:
        lines = list(preds)
    if error_counting and class_attr_ordinal is not None and raw is not None:
        actual = np.fromiter((r[class_attr_ordinal] for r in raw),
                             dtype=object, count=table.n_rows)
        errors = int((np.asarray(pred_list, dtype=object) != actual).sum())
        if counters is not None:
            counters.increment("Prediction", "Error count", errors)
            counters.increment("Prediction", "Total count", table.n_rows)
    return lines
