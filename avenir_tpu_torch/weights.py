"""Weight carry-over: the JAX package's forests as the port's.

A forest's "weights" are its trees.  The JAX package stores them as
``DecisionPathList`` JSON — ``tree_<i>.json`` files from the
``randomForestBuilder`` job, or the ``model_json`` of a registry version's
``meta.json`` — and, on the device, as the stacked predicate arrays
``(lo, hi, num_r, cat_m, cat_r, cls_oh)`` that ``EnsembleModel.stacked_host()``
returns, plus the member weight vector ``wvec``.  Both forms load here:
the JSON into the port's ``DecisionPathList`` objects, the arrays into a
``VoteModel`` on the chosen device in the layout the vote kernel takes.

A published version's sidecars carry more: the int8 forest
(``QuantizedForest``: quantized thresholds, the grid, the class order) and
the monitor baseline (``Baseline``: row specs, counts, quantiles).  Their
fields — numpy arrays and plain metadata, the same in both packages — load
here into the port's objects (:func:`quantized_from_arrays`,
:func:`baseline_from_arrays`).

For KNN the model is the encoded train set: the JAX package's
``DistanceComputer.encode`` arrays (numeric float32, one-hot int8) prime a
port :class:`~avenir_tpu_torch.ops.distance.DistanceComputer`
(:func:`knn_train_from_arrays`).

A Naive Bayes model is its count tables and Gaussian parameters: the JAX
package's ``NaiveBayesModel`` and ``TextBayesModel`` fields, as numpy
arrays and lists, become the port's models (:func:`bayes_from_arrays`,
:func:`text_bayes_from_arrays`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from .core.schema import FeatureSchema
from .core.table import ColumnarTable
from .kernels.vote import VoteModel, prepare_vote_model
from .models.bayes import NaiveBayesModel
from .models.bayes_text import TextBayesModel
from .models.tree import DecisionPathList
from .monitor.baseline import QUANTILE_QS, Baseline, RowSpec
from .ops.distance import DistanceComputer
from .runtime import resolve_device
from .serving.quantized import DEFAULT_BUDGET, QuantizedForest

_TREE_FILE = re.compile(r"tree_(\d+)\.json")


def tree_files(model_dir: str) -> List[str]:
    """The forest builder's ``tree_<i>.json`` names in ``model_dir``, in
    numeric order."""
    matches = [(int(m.group(1)), f) for f in os.listdir(model_dir)
               if (m := _TREE_FILE.fullmatch(f))]
    return [f for _, f in sorted(matches)]


def load_tree_files(paths: Sequence[str]) -> List[DecisionPathList]:
    """Tree JSON files -> path lists (the modelPredictor input)."""
    out = []
    for p in paths:
        with open(p) as fh:
            out.append(DecisionPathList.from_json(fh.read()))
    return out


def load_model_dir(model_dir: str) -> List[DecisionPathList]:
    names = tree_files(model_dir)
    if not names:
        raise FileNotFoundError(f"no tree_<i>.json models in {model_dir!r}")
    return load_tree_files([os.path.join(model_dir, n) for n in names])


def from_model_json(model_json) -> List[DecisionPathList]:
    """A registry ``meta.json`` ``model_json`` object (``{"trees": [...]}``,
    or the whole meta dict, or a path to ``meta.json``) -> path lists."""
    if isinstance(model_json, str):
        with open(model_json) as fh:
            model_json = json.load(fh)
    if "model_json" in model_json:
        model_json = model_json["model_json"]
    return [DecisionPathList.from_json(json.dumps(t))
            for t in model_json["trees"]]


def vote_model_from_stacked(stacked, weights: Optional[Sequence[float]] = None,
                            device=None) -> VoteModel:
    """``stacked_host()`` arrays — six, with ``weights`` (default all 1.0),
    or seven with ``wvec`` last — -> a :class:`VoteModel` on ``device``
    (default: the process device, ``cuda`` unless asked otherwise)."""
    arrays = [np.asarray(a) for a in stacked]
    if len(arrays) == 7:
        if weights is not None:
            raise ValueError("pass wvec inside stacked or as weights, "
                             "not both")
        *arrays, wvec = arrays
    elif len(arrays) == 6:
        T = arrays[0].shape[0]
        wvec = np.asarray(weights if weights is not None else [1.0] * T,
                          np.float32)
    else:
        raise ValueError(f"expected 6 or 7 stacked arrays, got {len(arrays)}")
    return prepare_vote_model(*arrays, wvec, resolve_device(device))


def quantized_from_arrays(q_lo, q_hi, num_r, cat_m, cat_r, cls_oh, wvec,
                          scale, fmin, classes: Sequence[str],
                          min_odds: float = 1.0,
                          budget: float = DEFAULT_BUDGET,
                          mismatch: float = 0.0) -> QuantizedForest:
    """The JAX package's ``QuantizedForest`` fields (its dataclass fields,
    by name) -> the port's, with the sidecar's dtypes pinned: int8
    thresholds, bool masks, uint8 leaf votes, float32 weights, float64
    grid."""
    return QuantizedForest(
        q_lo=np.asarray(q_lo, np.int8), q_hi=np.asarray(q_hi, np.int8),
        num_r=np.asarray(num_r, bool), cat_m=np.asarray(cat_m, bool),
        cat_r=np.asarray(cat_r, bool), cls_oh=np.asarray(cls_oh, np.uint8),
        wvec=np.asarray(wvec, np.float32), scale=np.asarray(scale, np.float64),
        fmin=np.asarray(fmin, np.float64), classes=list(classes),
        min_odds=float(min_odds), budget=float(budget),
        mismatch=float(mismatch))


def baseline_from_arrays(rows: Sequence[Dict], counts, n_rows: int,
                         quantile_qs: Sequence[float] = QUANTILE_QS,
                         quantiles=None) -> Baseline:
    """The JAX package's ``Baseline`` fields -> the port's: ``rows`` are
    the row specs as dicts (``RowSpec.to_dict``, the ``baseline.json``
    form), ``counts`` (R, B_max) and ``quantiles`` (R, Q) float64."""
    return Baseline(specs=[RowSpec.from_dict(d) for d in rows],
                    counts=np.asarray(counts, np.float64),
                    n_rows=int(n_rows), quantile_qs=tuple(quantile_qs),
                    quantiles=None if quantiles is None
                    else np.asarray(quantiles, np.float64))


def knn_train_from_arrays(comp: DistanceComputer, train: ColumnarTable,
                          num, oh):
    """Prime ``comp`` with the JAX package's encoding of ``train`` —
    ``DistanceComputer.encode``'s (numeric (n, Fn) float32, one-hot
    (n, sum_card) int8) arrays — and return the train side's device
    tensors (rn, roh) on ``comp.device``.  Later ``pairwise`` /
    ``pairwise_topk`` calls with ``train`` use these arrays."""
    num = np.asarray(num)
    oh = np.asarray(oh)
    want = ((train.n_rows, len(comp.num_fields)), (train.n_rows,
                                                   sum(comp.cards)))
    if num.shape != want[0] or oh.shape != want[1] \
            or num.dtype != np.float32 or oh.dtype != np.int8:
        raise ValueError(f"knn train arrays must be float32 {want[0]} and "
                         f"int8 {want[1]}, got {num.dtype} {num.shape} and "
                         f"{oh.dtype} {oh.shape}")
    comp.prime_train(train, num, oh)
    return comp.train_device()


def bayes_from_arrays(schema, class_values: Sequence[str],
                      binned_ordinals: Sequence[int],
                      cont_ordinals: Sequence[int], num_bins: Sequence[int],
                      post_counts, class_counts, prior_counts, total: float,
                      cont_post_mean, cont_post_std, cont_prior_mean,
                      cont_prior_std) -> NaiveBayesModel:
    """The JAX package's ``NaiveBayesModel`` fields (by name) -> the port's.
    ``schema`` is a port ``FeatureSchema`` or its dict form
    (``to_dict``); the tables keep their dtypes (float64 from a train)."""
    if not isinstance(schema, FeatureSchema):
        schema = FeatureSchema.from_dict(schema)
    return NaiveBayesModel(
        schema=schema, class_values=list(class_values),
        binned_ordinals=[int(o) for o in binned_ordinals],
        cont_ordinals=[int(o) for o in cont_ordinals],
        num_bins=[int(b) for b in num_bins],
        post_counts=np.asarray(post_counts),
        class_counts=np.asarray(class_counts),
        prior_counts=np.asarray(prior_counts), total=float(total),
        cont_post_mean=np.asarray(cont_post_mean),
        cont_post_std=np.asarray(cont_post_std),
        cont_prior_mean=np.asarray(cont_prior_mean),
        cont_prior_std=np.asarray(cont_prior_std))


def text_bayes_from_arrays(class_values: Sequence[str],
                           vocab: Sequence[str], token_counts,
                           class_counts) -> TextBayesModel:
    """The JAX package's ``TextBayesModel`` fields -> the port's."""
    return TextBayesModel(class_values=list(class_values), vocab=list(vocab),
                          token_counts=np.asarray(token_counts),
                          class_counts=np.asarray(class_counts))
