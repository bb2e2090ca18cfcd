"""Closed-loop model lifecycle control: port of ``avenir_tpu/control``
(the retrain loop; the online plane's supervisor comes with the online
plane).

The control plane above monitor/ and serving/: a drift alert becomes a
retrained, validated, published, hot-swapped model — or a refused one,
or (when it underperforms live) an automatically rolled-back one.  The
controller journals every transition tmp-then-rename so a crash at any
stage resumes without double-publishing, half-swapping, or touching the
data path (serving workers never wait on the controller).

  * :mod:`.journal`    — :class:`CycleJournal`, the one-file atomic
    state machine record (stages, outcomes, bounded history);
  * :mod:`.controller` — :class:`RetrainController` (the loop),
    :class:`RetrainPolicy` (its knobs), :class:`WireFleetLink`
    (addressed-reload swap link for out-of-process fleets), the
    alerts.jsonl / RESP intake helpers, and the shared
    :func:`accuracy_pct` delayed-label scorer.

Wire a live policy with ``monitor.policy.retrain_action(controller)``;
run the batch form with the ``retrainController`` CLI job
(``cli/control_jobs.py``).
"""

from .controller import (FULL, INCREMENTAL, RetrainController,
                         RetrainPolicy, WireFleetLink, accuracy_pct,
                         alert_from_json, alerts_from_jsonl,
                         alerts_from_resp)
from .journal import (ABANDONED, ACTIVE_STAGES, CANDIDATE_VALIDATE,
                      COMPLETE, CycleJournal, FLEET_SWAP, IDLE, PROBATION,
                      PUBLISHED, REFUSED, REGISTRY_PUBLISH, RETRAIN_BUILD,
                      ROLLBACK, ROLLED_BACK, STAGES)

__all__ = [
    "RetrainController", "RetrainPolicy", "WireFleetLink",
    "CycleJournal", "accuracy_pct", "alert_from_json",
    "alerts_from_jsonl", "alerts_from_resp", "INCREMENTAL", "FULL",
    "IDLE", "RETRAIN_BUILD", "CANDIDATE_VALIDATE", "REGISTRY_PUBLISH",
    "FLEET_SWAP", "PROBATION", "ROLLBACK", "COMPLETE", "STAGES",
    "ACTIVE_STAGES", "PUBLISHED", "REFUSED", "ROLLED_BACK", "ABANDONED",
]
