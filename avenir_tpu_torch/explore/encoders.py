"""Supervised categorical encoding + boosting weight updates: the port of
``avenir_tpu/explore/encoders.py``.  The per-value class counts are the
port's device joint histogram (exact float32 counts, as the JAX
package's); the rest is its host code, copied.

Parity targets:
  * CategoricalContinuousEncoding (explore/CategoricalContinuousEncoding.java
    :185-250): per (attr, value) positive/negative class counts ->
      supervisedRatio:   pos * scale / total   (integer division)
      weightOfEvidence:  int(scale * ln((pos/allPos) / (max(neg,1)/allNeg)))
    output lines 'ordinal,value,encoded'.
  * AdaBoostError (explore/AdaBoostError.java:110-165): weighted error of a
    prediction column vs actual column; error = errorSum (weight-normalized)
    or errorSum/errorCount.
  * AdaBoostUpdate (explore/AdaBoostUpdate.java:117-137): per-record weight
    *= exp(±alpha) when error < 0.5, else reset to the initial weight;
    alpha = 0.5 ln((1-e)/e).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..core.table import ColumnarTable
from .correlations import _joint_counts

SUPERVISED_RATIO = "supervisedRatio"
WEIGHT_OF_EVIDENCE = "weightOfEvidence"


def categorical_continuous_encoding(table: ColumnarTable,
                                    attr_ordinals: Sequence[int],
                                    class_attr_ordinal: int,
                                    pos_class_value: str,
                                    strategy: str = SUPERVISED_RATIO,
                                    scale: int = 100, device=None
                                    ) -> List[Tuple[int, str, int]]:
    """(ordinal, categorical value, encoded int) triples."""
    schema = table.schema
    cls_field = schema.find_field_by_ordinal(class_attr_ordinal)
    pos_code = cls_field.cat_code(pos_class_value)
    if pos_code < 0:
        raise ValueError(f"positive class value {pos_class_value!r} not in "
                         f"class cardinality")
    cls = table.columns[class_attr_ordinal]
    is_pos = (cls == pos_code).astype(np.int64)
    all_pos = int(is_pos.sum())
    all_neg = int(len(cls) - all_pos)
    out: List[Tuple[int, str, int]] = []
    for o in attr_ordinals:
        f = schema.find_field_by_ordinal(o)
        card = f.cardinality or []
        counts = _joint_counts(table.columns[o], is_pos.astype(np.int32),
                               len(card), 2, device)
        for vi, value in enumerate(card):
            neg, pos = counts[vi, 0], counts[vi, 1]
            total = pos + neg
            if total == 0:
                continue
            if strategy == WEIGHT_OF_EVIDENCE:
                woe = (pos / max(all_pos, 1)) / (max(neg, 1.0) / max(all_neg, 1))
                enc = int(math.log(woe) * scale) if woe > 0 else 0
            else:  # supervisedRatio
                enc = int(pos * scale) // int(total)
            out.append((o, value, enc))
    return out


def adaboost_error(actual: Sequence[str], predicted: Sequence[str],
                   weights: np.ndarray, weight_normalized: bool = True) -> float:
    """Weighted misclassification error (AdaBoostError semantics)."""
    wrong = np.asarray([a != p for a, p in zip(actual, predicted)])
    err_sum = float(weights[wrong].sum())
    if weight_normalized:
        return err_sum
    return err_sum / max(len(actual), 1)


def adaboost_alpha(error: float) -> float:
    """alpha = 0.5 ln((1-e)/e)."""
    e = min(max(error, 1e-12), 1 - 1e-12)
    return 0.5 * math.log((1 - e) / e)


def adaboost_update(weights: np.ndarray, actual: Sequence[str],
                    predicted: Sequence[str], error: float,
                    initial_weight: float = 1.0) -> np.ndarray:
    """New per-record boost weights (AdaBoostUpdate.java:117-137)."""
    if error >= 0.5:
        return np.full_like(np.asarray(weights, dtype=np.float64), initial_weight)
    alpha = adaboost_alpha(error)
    wrong = np.asarray([a != p for a, p in zip(actual, predicted)])
    return np.where(wrong, weights * math.exp(alpha), weights * math.exp(-alpha))
