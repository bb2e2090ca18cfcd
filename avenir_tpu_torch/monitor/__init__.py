"""Drift and model-quality monitoring: port of ``avenir_tpu/monitor``.

  * :mod:`.baseline`    — training-time feature/class profiles, published
    as a ``baseline.json`` + ``baseline.npz`` registry sidecar;
  * :mod:`.accumulator` — tumbling + exponential-decay windows (one
    in-place bin-counts launch a block, one readback a window) and the
    ``ServingMonitor`` PredictionService hook;
  * :mod:`.drift`       — one scoring pass over a window against the
    baseline: PSI, KL, Jensen-Shannon, binned KS, chi-square, in the
    reference's float32 rounding;
  * :mod:`.policy`      — warn/alert thresholds with debounce, structured
    alert records, the refresh / degrade guardrails, delayed-label
    accuracy.

``tee_blocks`` feeds a baseline from a streamed training ingest.  The
reference's ``retrain_action`` (its ``control`` package) is not ported.
CLI: ``driftMonitor`` and ``predictDriftScore`` (``cli/monitor_jobs.py``).
"""

from .baseline import (BASELINE_JSON, BASELINE_NPZ, Baseline,
                       BaselineBuilder, PREDICTION_SCOPE, RowSpec,
                       compute_baseline, load_baseline, monitor_specs,
                       publish_baseline, tee_blocks)
from .accumulator import (DriftAccumulator, ServingMonitor,
                          StreamDriftMonitor)
from .drift import STATS, DriftReport, DriftScorer, RowScore
from .policy import (AccuracyTracker, AlertRecord, DriftPolicy,
                     DEFAULT_ALERT, DEFAULT_WARN, degrade_action,
                     refresh_action)

__all__ = [
    "BASELINE_JSON", "BASELINE_NPZ", "Baseline", "BaselineBuilder",
    "PREDICTION_SCOPE", "RowSpec", "compute_baseline", "load_baseline",
    "monitor_specs", "publish_baseline", "tee_blocks", "DriftAccumulator",
    "ServingMonitor", "StreamDriftMonitor", "STATS", "DriftReport",
    "DriftScorer", "RowScore", "AccuracyTracker", "AlertRecord",
    "DriftPolicy", "DEFAULT_ALERT", "DEFAULT_WARN", "degrade_action",
    "refresh_action",
]
