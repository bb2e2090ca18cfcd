"""Metrics channel: Hadoop-style counters.

The reference uses Hadoop Counters / Spark accumulators as its metrics channel
(SURVEY.md §5; bayesian/BayesianPredictor.java:170-180).  Here metrics are
plain dicts of integers accumulated host-side and rendered the same way Hadoop
prints counter groups.  A copy of ``avenir_tpu/core/metrics.py``'s
``Counters``, ``ConfusionMatrix`` and ``CostBasedArbitrator``: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import threading
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np


class Counters:
    """Hadoop-counter-style metrics: (group, name) -> int.

    Updates are atomic under one internal lock: serving loops mutate
    counters from several threads while the metrics snapshot thread reads
    them mid-flight, so read-modify-write races (lost increments, a
    high-water mark going DOWN) must be impossible by construction."""

    def __init__(self):
        self._c: Dict[Tuple[str, str], int] = defaultdict(int)
        self._lock = threading.Lock()

    def increment(self, group: str, name: str, amount: int = 1) -> None:
        with self._lock:
            self._c[(group, name)] += int(amount)

    def set(self, group: str, name: str, value: int) -> None:
        with self._lock:
            self._c[(group, name)] = int(value)

    def max(self, group: str, name: str, value: int) -> int:
        """Atomically raise the counter to ``value`` if it is larger;
        returns the resulting value.  The high-water-mark update (e.g.
        Serving/MaxBatchObserved) as ONE operation — a get-then-set from
        two threads could publish the smaller of two observations."""
        with self._lock:
            key = (group, name)
            cur = self._c.get(key, 0)
            if int(value) > cur:
                cur = int(value)
                self._c[key] = cur
            return cur

    def get(self, group: str, name: str) -> int:
        return self._c.get((group, name), 0)

    def update_group(self, group: str, values: Dict[str, int]) -> None:
        """Set a whole group at once (e.g. a TransferLedger export)."""
        for name, v in values.items():
            self.set(group, name, v)

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            items = sorted(self._c.items())
        out: Dict[str, Dict[str, int]] = defaultdict(dict)
        for (g, n), v in items:
            out[g][n] = v
        return dict(out)

    def render(self) -> str:
        """Render like Hadoop's end-of-job counter dump."""
        lines = []
        for g, names in self.as_dict().items():
            lines.append(f"{g}")
            for n, v in names.items():
                lines.append(f"\t{n}={v}")
        return "\n".join(lines)

    # ---- machine-readable export (stable key order) ----
    def to_json(self) -> str:
        """One compact JSON object {group: {name: value}} with groups and
        names sorted — jobs and the bench harness consume this instead of
        parsing render() text, and identical counters always serialize to
        identical bytes (diffable artifacts)."""
        return json.dumps(self.as_dict(), sort_keys=True,
                          separators=(",", ":"))


class ConfusionMatrix:
    """Binary confusion matrix with the reference's integer-percent metrics
    (util/ConfusionMatrix.java:30-75).  Constructor arg order is
    (negClass, posClass), as in the reference."""

    def __init__(self, neg_class: str, pos_class: str):
        self.neg_class = neg_class
        self.pos_class = pos_class
        self.true_pos = 0
        self.false_pos = 0
        self.true_neg = 0
        self.false_neg = 0

    def report(self, pred_class: str, actual_class: str) -> None:
        if pred_class == self.pos_class:
            if actual_class == self.pos_class:
                self.true_pos += 1
            else:
                self.false_pos += 1
        else:
            if actual_class == self.neg_class:
                self.true_neg += 1
            else:
                self.false_neg += 1

    def report_batch(self, pred_is_pos: np.ndarray, actual_is_pos: np.ndarray,
                     actual_is_neg: np.ndarray) -> None:
        """Vectorized report: boolean arrays per record.  actual_is_neg is
        passed separately because the reference treats 'not neg' (e.g. an
        unknown label) as a false negative when the prediction is
        negative."""
        pp = np.asarray(pred_is_pos, dtype=bool)
        ap = np.asarray(actual_is_pos, dtype=bool)
        an = np.asarray(actual_is_neg, dtype=bool)
        self.true_pos += int(np.sum(pp & ap))
        self.false_pos += int(np.sum(pp & ~ap))
        self.true_neg += int(np.sum(~pp & an))
        self.false_neg += int(np.sum(~pp & ~an))

    # integer-percent metrics, matching reference integer division (plus a
    # zero-denominator guard the reference lacks)
    def recall(self) -> int:
        denom = self.true_pos + self.false_neg
        return (100 * self.true_pos) // denom if denom else 0

    def precision(self) -> int:
        denom = self.true_pos + self.false_pos
        return (100 * self.true_pos) // denom if denom else 0

    def accuracy(self) -> int:
        total = self.true_pos + self.true_neg + self.false_pos + self.false_neg
        return (100 * (self.true_pos + self.true_neg)) // total if total else 0

    def export(self, counters: Counters, group: str = "Validation") -> None:
        """Export with the reference's counter names (including its
        'TrueNagative' typo, bayesian/BayesianPredictor.java:174)."""
        counters.increment(group, "TruePositive", self.true_pos)
        counters.increment(group, "FalseNegative", self.false_neg)
        counters.increment(group, "TrueNagative", self.true_neg)
        counters.increment(group, "FalsePositive", self.false_pos)
        counters.increment(group, "Accuracy", self.accuracy())
        counters.increment(group, "Recall", self.recall())
        counters.increment(group, "Precision", self.precision())


class CostBasedArbitrator:
    """Misclassification-cost arbitration (util/CostBasedArbitrator.java:25-65).
    Probabilities are integer percents, as in the reference."""

    def __init__(self, neg_class: str, pos_class: str,
                 false_neg_cost: int, false_pos_cost: int):
        self.neg_class = neg_class
        self.pos_class = pos_class
        self.false_neg_cost = false_neg_cost
        self.false_pos_cost = false_pos_cost

    def arbitrate(self, pos_prob: int, neg_prob: int) -> str:
        neg_cost = self.false_neg_cost * pos_prob + neg_prob
        pos_cost = self.false_pos_cost * neg_prob + pos_prob
        return self.pos_class if pos_cost < neg_cost else self.neg_class

    def classify(self, pos_prob: int) -> str:
        threshold = (self.false_pos_cost * 100) // (self.false_pos_cost
                                                    + self.false_neg_cost)
        return self.pos_class if pos_prob > threshold else self.neg_class
