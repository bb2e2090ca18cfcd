"""Threshold policy over drift reports: port of
``avenir_tpu/monitor/policy.py``.

Per statistic there is a warn and an alert threshold (defaults follow the
industry PSI bands: 0.1 warn / 0.25 alert, with matching bands for the
other divergences).  A level must hold for ``consecutive`` windows of the
same (window kind, scope, statistic) before its record emits.  Emitted
records are structured (:class:`AlertRecord`), counted through the
``Counters`` channel, logged, and optionally handed to an action
callback — the serving guardrails:

  * :func:`refresh_action` — re-probe the registry for a newer intact
    version (``PredictionService.refresh``);
  * :func:`degrade_action` — ``PredictionService.mark_degraded``: keep
    answering but flag the model;
  * :func:`retrain_action` — hand the alert to a
    ``control.RetrainController``'s intake (the closed retrain loop).

Delayed-label model quality rides the same policy: :class:`AccuracyTracker`
folds (predicted, actual) label pairs through
``ConfusionMatrix.report_batch`` per window and reports the integer
accuracy percent as the ``accuracy`` statistic (inverted comparison — LOW
accuracy alerts).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.metrics import ConfusionMatrix, Counters
from ..utils.tracing import get_logger
from .drift import DriftReport, STATS

# PSI's classic 0.1/0.25 bands; the others scaled to comparable
# sensitivity on the same synthetic shifts (tests/test_monitor.py pins a
# mean-shifted numeric + reweighted categorical firing and a
# same-distribution stream staying quiet under these defaults)
DEFAULT_WARN = {"psi": 0.10, "kl": 0.10, "js": 0.02, "ks": 0.10,
                "chi2": 0.05}
DEFAULT_ALERT = {"psi": 0.25, "kl": 0.50, "js": 0.10, "ks": 0.25,
                 "chi2": 0.20}

WARN = "warn"
ALERT = "alert"
ACCURACY_STAT = "accuracy"


@dataclass
class AlertRecord:
    """One structured finding: a statistic held a level long enough."""
    window_index: int
    window_kind: str            # window | longterm | quality
    scope: str                  # feature name | __prediction__ | __model__
    stat: str
    value: float
    threshold: float
    level: str                  # warn | alert
    streak: int                 # consecutive windows at >= this level
    n_rows: int

    def to_json(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)


class DriftPolicy:
    """Stateful thresholding over a report stream."""

    def __init__(self, warn: Optional[Dict[str, float]] = None,
                 alert: Optional[Dict[str, float]] = None,
                 consecutive: int = 2,
                 counters: Optional[Counters] = None,
                 on_alert: Optional[Callable[[AlertRecord], None]] = None,
                 accuracy_warn: int = 0, accuracy_alert: int = 0,
                 debug_on: bool = False):
        if consecutive < 1:
            raise ValueError(f"consecutive must be >= 1, got {consecutive}")
        self.warn = dict(DEFAULT_WARN)
        self.warn.update(warn or {})
        self.alert = dict(DEFAULT_ALERT)
        self.alert.update(alert or {})
        self.consecutive = int(consecutive)
        self.counters = counters if counters is not None else Counters()
        self.on_alert = on_alert
        self.accuracy_warn = int(accuracy_warn)
        self.accuracy_alert = int(accuracy_alert)
        self._log = get_logger("avenir_tpu_torch.monitor", debug_on)
        # (window_kind, scope, stat) -> consecutive counts per level
        self._warn_streak: Dict[Tuple[str, str, str], int] = {}
        self._alert_streak: Dict[Tuple[str, str, str], int] = {}
        self.alerts: List[AlertRecord] = []

    # ---- drift reports ----
    def observe(self, report: DriftReport) -> List[AlertRecord]:
        """Threshold every (row, statistic) of one report; returns the
        records that cleared debounce this window (also retained in
        ``self.alerts`` and counted)."""
        fired: List[AlertRecord] = []
        for row in report.rows:
            for stat in STATS:
                if not row.applicable(stat):
                    continue
                value = row.stats[stat]
                key = (report.kind, row.scope, stat)
                fired.extend(self._step(
                    key, value, value >= self.alert[stat],
                    value >= self.warn[stat],
                    report, self.warn[stat], self.alert[stat]))
        return fired

    # ---- delayed-label quality ----
    def observe_accuracy(self, window_index: int, accuracy: int,
                         n_rows: int = 0) -> List[AlertRecord]:
        """Inverted thresholding: accuracy BELOW the bar for
        ``consecutive`` windows fires.  Disabled until accuracy_warn /
        accuracy_alert are set (> 0)."""
        if self.accuracy_warn <= 0 and self.accuracy_alert <= 0:
            return []
        report = DriftReport(index=window_index, kind="quality",
                             n_rows=n_rows)
        key = ("quality", "__model__", ACCURACY_STAT)
        return self._step(
            key, float(accuracy),
            self.accuracy_alert > 0 and accuracy < self.accuracy_alert,
            self.accuracy_warn > 0 and accuracy < self.accuracy_warn,
            report, float(self.accuracy_warn), float(self.accuracy_alert))

    # ---- shared streak machinery ----
    def _step(self, key, value: float, is_alert: bool, is_warn: bool,
              report: DriftReport, warn_th: float, alert_th: float
              ) -> List[AlertRecord]:
        self._warn_streak[key] = self._warn_streak.get(key, 0) + 1 \
            if is_warn else 0
        self._alert_streak[key] = self._alert_streak.get(key, 0) + 1 \
            if is_alert else 0
        fired: List[AlertRecord] = []
        if self._alert_streak[key] >= self.consecutive:
            fired.append(self._emit(key, value, ALERT, alert_th,
                                    self._alert_streak[key], report))
        elif self._warn_streak[key] >= self.consecutive:
            fired.append(self._emit(key, value, WARN, warn_th,
                                    self._warn_streak[key], report))
        return fired

    def _emit(self, key, value: float, level: str, threshold: float,
              streak: int, report: DriftReport) -> AlertRecord:
        kind, scope, stat = key
        rec = AlertRecord(window_index=report.index, window_kind=kind,
                          scope=scope, stat=stat, value=float(value),
                          threshold=float(threshold), level=level,
                          streak=streak, n_rows=report.n_rows)
        self.alerts.append(rec)
        self.counters.increment(
            "DriftMonitor", "Alerts" if level == ALERT else "Warnings")
        log = self._log.warning if level == ALERT else self._log.info
        log("drift %s: %s %s=%.4g (threshold %.4g, %d consecutive "
            "windows)", level, scope, stat, value, threshold, streak)
        if level == ALERT and self.on_alert is not None:
            self.on_alert(rec)
        return rec


# --------------------------------------------------------------------------
# serving guardrail actions
# --------------------------------------------------------------------------

def refresh_action(service, counters: Optional[Counters] = None
                   ) -> Callable[[AlertRecord], None]:
    """On alert, re-probe the registry for a newer intact model version
    (hot-swap if one exists) — the 'a retrain already landed, pick it
    up' guardrail."""
    def act(rec: AlertRecord) -> None:
        swapped = service.refresh()
        if counters is not None:
            counters.increment("DriftMonitor", "RefreshProbes")
            if swapped:
                counters.increment("DriftMonitor", "RefreshSwaps")
    return act


def degrade_action(service, counters: Optional[Counters] = None
                   ) -> Callable[[AlertRecord], None]:
    """On alert, mark the serving model degraded (it keeps answering;
    operators and the counter dump see the flag)."""
    def act(rec: AlertRecord) -> None:
        service.mark_degraded(f"{rec.scope} {rec.stat}={rec.value:.4g} "
                              f">= {rec.threshold:.4g}")
        if counters is not None:
            counters.increment("DriftMonitor", "Degradations")
    return act


def retrain_action(controller, counters: Optional[Counters] = None
                   ) -> Callable[[AlertRecord], None]:
    """On alert, hand the record to the retrain controller's
    control-plane intake (``RetrainController.submit_alert``) — the
    policy -> controller wiring that closes the loop.  The handoff is a
    queue append: a retrain NEVER runs inline on the serving/monitor
    thread (the controller's own loop — ``run_pending``/``start()`` —
    picks the alert up)."""
    def act(rec: AlertRecord) -> None:
        controller.submit_alert(rec)
        if counters is not None:
            counters.increment("DriftMonitor", "RetrainRequests")
    return act


# --------------------------------------------------------------------------
# delayed-label accuracy
# --------------------------------------------------------------------------

class AccuracyTracker:
    """Windowed model-quality tracking from delayed labels.

    Outcomes arrive as (predicted label, actual label) pairs — possibly
    long after the prediction was served.  Every ``window`` outcomes the
    tracker folds the batch through ``ConfusionMatrix.report_batch``
    (vectorized, the reference's integer-percent semantics) and reports
    the window accuracy to the policy."""

    def __init__(self, pos_class: str, neg_class: str, policy: DriftPolicy,
                 window: int = 512):
        if window < 1:
            # record() drains by 'len(buffer) >= window'; zero would
            # spin forever on the first labeled batch
            raise ValueError(f"window must be >= 1, got {window}")
        self.pos_class = pos_class
        self.neg_class = neg_class
        self.policy = policy
        self.window = int(window)
        self._pred: List[str] = []
        self._actual: List[str] = []
        self._index = 0

    def record(self, pred_labels, actual_labels) -> List[AlertRecord]:
        self._pred.extend(pred_labels)
        self._actual.extend(actual_labels)
        fired: List[AlertRecord] = []
        while len(self._pred) >= self.window:
            fired.extend(self._close(self.window))
        return fired

    def close(self) -> List[AlertRecord]:
        """Score whatever partial window remains."""
        if not self._pred:
            return []
        return self._close(len(self._pred))

    def _close(self, n: int) -> List[AlertRecord]:
        pred = np.asarray(self._pred[:n])
        actual = np.asarray(self._actual[:n])
        del self._pred[:n], self._actual[:n]
        cm = ConfusionMatrix(self.neg_class, self.pos_class)
        cm.report_batch(pred == self.pos_class, actual == self.pos_class,
                        actual == self.neg_class)
        self.policy.counters.increment("DriftMonitor", "LabeledOutcomes", n)
        fired = self.policy.observe_accuracy(self._index, cm.accuracy(),
                                             n_rows=n)
        self._index += 1
        return fired
