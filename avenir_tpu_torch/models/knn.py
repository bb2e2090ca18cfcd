"""K nearest neighbor: top-k classification and regression, the port of
``avenir_tpu/models/knn.py``.

Parity with org.avenir.knn (as the JAX package implements it):

  * top-k neighbors per test record (knn/NearestNeighbor.java), selected
    with a stable sort so ties go to the lower index, as ``lax.top_k``
    breaks them (``torch.topk`` promises no tie order);
  * kernels none / linearMultiplicative / linearAdditive / gaussian with
    the reference's integer score arithmetic (knn/Neighborhood.java:150-200:
    KERNEL_SCALE=100, d==0 -> 2*scale, integer division for
    linearMultiplicative); the reference's 'sigmoid' branch is an empty
    stub and raises here;
  * class-conditional probability weighting and inverse-distance
    weighting, the decision threshold on the pos/neg score ratio and the
    cost-based arbitration;
  * regression: average / median / per-test-record simple linear
    regression.

The (n, k) neighbor arrays are small; the score sums run as torch ops on
the host, the rest is numpy as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.metrics import CostBasedArbitrator
from ..telemetry.trace import span

KERNEL_SCALE = 100
PROB_SCALE = 100
# sentinel distance for ragged per-test neighbor lists (rows padded to the
# max candidate count); entries at/above it contribute nothing
PAD_DISTANCE = 1 << 30

_KERNELS = ("none", "linearMultiplicative", "linearAdditive", "gaussian")


@dataclass
class KnnParams:
    """The nen.* knobs (resource/knn.properties)."""
    top_match_count: int = 10
    kernel_function: str = "none"    # none|linearMultiplicative|linearAdditive|gaussian
    kernel_param: int = -1
    class_cond_weighted: bool = False
    inverse_distance_weighted: bool = False
    decision_threshold: float = -1.0
    pos_class: Optional[str] = None
    neg_class: Optional[str] = None
    use_cost_based_classifier: bool = False
    false_pos_cost: int = 1
    false_neg_cost: int = 1
    prediction_mode: str = "classification"   # classification | regression
    regression_method: str = "average"        # average|median|linearRegression


def _sigmoid_stub() -> NotImplementedError:
    return NotImplementedError(
        "kernel 'sigmoid' is an empty stub in the reference "
        "(knn/Neighborhood.java:195) and is not supported")


def kernel_scores(distances: torch.Tensor, kernel: str,
                  kernel_param: int) -> torch.Tensor:
    """int32 neighbor scores per the reference kernels (``distances``: the
    scaled int distances)."""
    d = torch.as_tensor(distances).to(torch.int32)
    if kernel == "none":
        return torch.ones_like(d)
    if kernel == "linearMultiplicative":
        return torch.where(d == 0, 2 * KERNEL_SCALE,
                           KERNEL_SCALE // torch.clamp_min(d, 1)
                           ).to(torch.int32)
    if kernel == "linearAdditive":
        return (KERNEL_SCALE - d).to(torch.int32)
    if kernel == "gaussian":
        t = d.to(torch.float32) / float(kernel_param)
        e = torch.exp((-0.5 * t * t).to(torch.float64)).to(torch.float32)
        return (KERNEL_SCALE * e).to(torch.int32)
    if kernel == "sigmoid":
        raise _sigmoid_stub()
    raise ValueError(f"unknown kernel function {kernel!r}")


@dataclass
class KnnResult:
    pred_class: Optional[List[str]] = None           # classification
    pred_value: Optional[np.ndarray] = None          # regression (int)
    class_distr: Optional[np.ndarray] = None         # (n, C) int scores
    weighted_class_distr: Optional[np.ndarray] = None  # (n, C) float
    pos_class_prob: Optional[np.ndarray] = None      # (n,) int percent


def _stable_topk(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row, ties to the lower
    index (``lax.top_k`` over ``-d``)."""
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def _distr_kernel(nd, ncls, nfpp, kernel_function: str, kernel_param: int,
                  C: int, inverse_distance_weighted: bool):
    """Neighbor scores -> (class_distr int32 (n, C), weighted float32
    (n, C)); the per-class sums run over the k neighbors in order."""
    nd = torch.as_tensor(nd)
    valid = nd < PAD_DISTANCE
    scores = kernel_scores(nd, kernel_function, kernel_param)
    scores = scores * valid.to(scores.dtype)
    ncls = torch.as_tensor(ncls).long()
    oh = (ncls[..., None] == torch.arange(C)).to(torch.int32)  # (n, k, C)
    nfpp = torch.as_tensor(nfpp, dtype=torch.float32)
    wscores = torch.where(nfpp > 0, scores * nfpp, scores.to(torch.float32))
    if inverse_distance_weighted:
        wscores = wscores / torch.clamp_min(nd.to(torch.float32), 1e-9)
    n, k = nd.shape
    class_distr = torch.zeros((n, C), dtype=torch.int32)
    weighted = torch.zeros((n, C), dtype=torch.float32)
    for j in range(k):
        class_distr += scores[:, j, None] * oh[:, j]
        weighted = weighted + wscores[:, j, None] * oh[:, j].to(torch.float32)
    return class_distr, weighted


def classify(distances: np.ndarray,            # (n_test, n_train) int
             train_classes: np.ndarray,        # (n_train,) int codes
             class_values: Sequence[str],
             params: KnnParams,
             feature_post_prob: Optional[np.ndarray] = None,  # (n_train,)
             ) -> KnnResult:
    """Classification over a SHARED train set: every test row draws its
    neighbors from the same train vectors."""
    fpp = feature_post_prob if feature_post_prob is not None else \
        np.full((distances.shape[1],), -1.0, dtype=np.float32)
    k = min(params.top_match_count, distances.shape[1])
    d = torch.as_tensor(np.asarray(distances))
    idx = _stable_topk(d, k)
    nd = torch.gather(d, 1, idx).numpy()
    ncls = np.asarray(train_classes)[idx.numpy()]
    nfpp = np.asarray(fpp, dtype=np.float32)[idx.numpy()]
    return _classify_topk(nd, ncls, nfpp, class_values, params)


def classify_topk(nd: np.ndarray, ncls: np.ndarray,
                  class_values: Sequence[str], params: KnnParams,
                  fpp: Optional[np.ndarray] = None) -> KnnResult:
    """Classify from already-selected top-k neighbors per test row (the
    entry for ``DistanceComputer.pairwise_topk`` results)."""
    if fpp is None:
        fpp = np.full(nd.shape, -1.0, dtype=np.float32)
    return _classify_topk(nd, ncls, fpp, class_values, params)


def _topk_rows(dmat: np.ndarray, k: int, *mats: Optional[np.ndarray]):
    """Stable nearest-k selection within each row; returns (nd, gathered
    mats) where a None mat stays None."""
    k = min(k, dmat.shape[1])
    idx = np.argsort(dmat, axis=1, kind="stable")[:, :k]
    nd = np.take_along_axis(dmat, idx, axis=1)
    out = [np.take_along_axis(m, idx, axis=1) if m is not None else None
           for m in mats]
    return (nd, *out)


def classify_grouped(dmat: np.ndarray, cmat: np.ndarray,
                     class_values: Sequence[str], params: KnnParams,
                     fmat: Optional[np.ndarray] = None) -> KnnResult:
    """Per-row neighbor lists (the nearestNeighbor job's input layout,
    where each test entity carries its own candidate set): top-k within
    each row."""
    nd, ncls, nfpp = _topk_rows(dmat, params.top_match_count, cmat, fmat)
    if nfpp is None:
        nfpp = np.full_like(nd, -1.0, dtype=np.float32)
    return _classify_topk(nd, ncls, nfpp, class_values, params)


def _classify_topk(nd: np.ndarray, ncls: np.ndarray, nfpp: np.ndarray,
                   class_values: Sequence[str], params: KnnParams
                   ) -> KnnResult:
    """Kernel scores -> per-class sums -> classify/arbitrate, given the
    already-selected top-k neighbors per test row; spans
    ``knn.class_scores`` and ``knn.class_pick`` a call."""
    C = len(class_values)
    if params.kernel_function == "sigmoid":
        raise _sigmoid_stub()
    if params.kernel_function not in _KERNELS:
        raise ValueError(f"unknown kernel function {params.kernel_function!r}")

    n = len(nd)
    with span("knn.class_scores", cat="knn", rows=n):
        class_distr, weighted = (x.numpy() for x in _distr_kernel(
            torch.from_numpy(np.ascontiguousarray(nd, np.int32)),
            torch.from_numpy(np.ascontiguousarray(ncls)),
            torch.from_numpy(np.ascontiguousarray(nfpp, np.float32)),
            params.kernel_function, params.kernel_param, C,
            params.inverse_distance_weighted))
    with span("knn.class_pick", cat="knn", rows=n):
        return _pick_classes(nd, ncls, class_distr, weighted, class_values,
                             params)


def _pick_classes(nd: np.ndarray, ncls: np.ndarray, class_distr: np.ndarray,
                  weighted: np.ndarray, class_values: Sequence[str],
                  params: KnnParams) -> KnnResult:
    """The per-class sums -> classify/arbitrate (or the regression over
    the neighbours' values)."""
    if params.prediction_mode == "regression":
        vals = np.asarray(
            [[float(class_values[c]) for c in row] for row in ncls])
        return KnnResult(pred_value=_regress(vals, nd, params,
                                             valid=nd < PAD_DISTANCE))

    cls_index = {v: i for i, v in enumerate(class_values)}
    if params.class_cond_weighted:
        best = np.argmax(weighted, axis=1)
        pred = [class_values[b] for b in best]
        totals = weighted.sum(axis=1)
        pos_prob = None
        if params.pos_class is not None:
            pi = cls_index[params.pos_class]
            pos_prob = ((weighted[:, pi] * PROB_SCALE) /
                        np.maximum(totals, 1e-12)).astype(np.int32)
    else:
        pos_prob = None
        if params.pos_class is not None:
            pi = cls_index[params.pos_class]
            totals = class_distr.sum(axis=1)
            pos_prob = ((class_distr[:, pi] * PROB_SCALE) //
                        np.maximum(totals, 1)).astype(np.int32)
        if params.decision_threshold > 0:
            pi = cls_index[params.pos_class]
            ni = cls_index[params.neg_class]
            with np.errstate(divide="ignore"):
                ratio = class_distr[:, pi] / np.maximum(class_distr[:, ni],
                                                        1e-12)
            pred = [params.pos_class if r > params.decision_threshold
                    else params.neg_class for r in ratio]
        else:
            best = np.argmax(class_distr, axis=1)
            pred = [class_values[b] for b in best]

    if params.use_cost_based_classifier:
        arb = CostBasedArbitrator(params.neg_class, params.pos_class,
                                  params.false_neg_cost, params.false_pos_cost)
        pred = [arb.classify(int(p)) for p in pos_prob]

    return KnnResult(pred_class=pred, class_distr=class_distr,
                     weighted_class_distr=weighted, pos_class_prob=pos_prob)


def _regress(vals: np.ndarray, dists: np.ndarray, params: KnnParams,
             regr_input: Optional[np.ndarray] = None,
             neighbor_input: Optional[np.ndarray] = None,
             valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Regression over neighbor values (integer results like the reference,
    which divides by the count of REAL neighbors).  ``valid`` masks
    ragged-padding entries out of every statistic."""
    v = valid if valid is not None else np.ones(vals.shape, dtype=bool)
    cnt = np.maximum(v.sum(axis=1), 1)
    if params.regression_method == "average":
        return ((vals * v).sum(axis=1) / cnt).astype(np.int64)
    if params.regression_method == "median":
        out = np.zeros((vals.shape[0],), dtype=np.int64)
        for i in range(vals.shape[0]):
            s = np.sort(vals[i][v[i]]).astype(np.int64)
            mid = len(s) // 2
            out[i] = s[mid] if len(s) % 2 == 1 else (s[mid - 1] + s[mid]) // 2
        return out
    if params.regression_method == "linearRegression":
        # per-test-row simple regression y ~ x over the neighbors
        # (Neighborhood.doRegression, SimpleRegression closed form),
        # evaluated at the test record's regression input
        if neighbor_input is None:
            raise ValueError(
                "linearRegression requires per-neighbor regression input "
                "values (the trainRegrNumFld column of the reference layout)")
        x = np.where(v, neighbor_input, 0.0).astype(np.float64)
        y = np.where(v, vals, 0.0)
        xm = (x.sum(axis=1) / cnt)[:, None]
        ym = (y.sum(axis=1) / cnt)[:, None]
        cov = (((x - xm) * (y - ym)) * v).sum(axis=1)
        var = (((x - xm) ** 2) * v).sum(axis=1)
        slope = np.where(var > 0, cov / np.maximum(var, 1e-12), 0.0)
        intercept = ym[:, 0] - slope * xm[:, 0]
        x0 = regr_input if regr_input is not None else np.zeros(len(slope))
        return (intercept + slope * x0).astype(np.int64)
    raise ValueError(f"unknown regression method {params.regression_method!r}")


def regress_grouped(dmat: np.ndarray, vals: np.ndarray, params: KnnParams,
                    regr_input: Optional[np.ndarray] = None,
                    neighbor_input: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """KNN regression over per-row neighbor lists: top-k then
    :func:`_regress`.  ``vals`` (n, m) neighbor target values;
    PAD_DISTANCE entries are masked."""
    nd, nv, ni = _topk_rows(dmat, params.top_match_count,
                            vals.astype(np.float64), neighbor_input)
    return _regress(nv, nd, params, regr_input=regr_input, neighbor_input=ni,
                    valid=nd < PAD_DISTANCE)


def regress(distances: np.ndarray, train_values: np.ndarray,
            params: KnnParams, regr_input: Optional[np.ndarray] = None,
            train_regr_input: Optional[np.ndarray] = None) -> np.ndarray:
    """KNN regression over a shared train set: top-k then
    :func:`_regress`."""
    n_train = distances.shape[1]
    vals = np.broadcast_to(train_values.astype(np.float64),
                           (distances.shape[0], n_train))
    ni = np.broadcast_to(train_regr_input, distances.shape) \
        if train_regr_input is not None else None
    return regress_grouped(distances, vals, params, regr_input=regr_input,
                           neighbor_input=ni)
