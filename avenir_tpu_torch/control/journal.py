"""The retrain controller's crash journal: port of
``avenir_tpu/control/journal.py`` (the cycle journal; the online plane's
``OnlineJournal`` comes with the online plane).

The controller is a state machine whose every transition must survive a
kill at any instant.  This journal is the whole durability story: ONE
small JSON file under the controller's state directory, rewritten
atomically (write ``controller.json.tmp.<pid>``, ``os.replace`` into
place) BEFORE each stage's work starts — so a crash mid-stage leaves a
journal that names exactly the stage to re-enter — and again when the
stage's durable result lands (candidate saved, version published, pin
written).  The file's bytes are the JAX package's (``indent=2``,
sorted keys).

The journal does not hold model payloads (the candidate lives in its own
tmp-then-renamed ``cycle_<n>/candidate`` directory) or serving state (the
registry pin is the serving tier's source of truth; resume re-derives
what actually happened from the registry).

Stage order (each active stage is a fault point)::

    idle -> retrain_build -> candidate_validate -> canary_validate
         -> registry_publish -> fleet_swap -> probation -> complete
                                           \\-> rollback -> complete

``canary_validate`` is a policy-gated live-traffic gate: the candidate
serves a deterministic x% canary split on a ``models=`` fleet and must
match the champion's accuracy on its own outcome series before publish;
``RetrainPolicy.canary_outcomes == 0`` records a journaled skip.

Terminal outcomes recorded at ``complete``: ``published``, ``refused``
(validation said the candidate is worse — champion untouched),
``rolled_back`` (probation said the candidate underperforms live — pin
back to the champion), ``abandoned`` (resume found the cycle
unfinishable — champion untouched).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

# stages
IDLE = "idle"
RETRAIN_BUILD = "retrain_build"
CANDIDATE_VALIDATE = "candidate_validate"
CANARY_VALIDATE = "canary_validate"
REGISTRY_PUBLISH = "registry_publish"
FLEET_SWAP = "fleet_swap"
PROBATION = "probation"
ROLLBACK = "rollback"
COMPLETE = "complete"

STAGES = (IDLE, RETRAIN_BUILD, CANDIDATE_VALIDATE, CANARY_VALIDATE,
          REGISTRY_PUBLISH, FLEET_SWAP, PROBATION, ROLLBACK, COMPLETE)
# the resumable (mid-cycle) stages, in order
ACTIVE_STAGES = (RETRAIN_BUILD, CANDIDATE_VALIDATE, CANARY_VALIDATE,
                 REGISTRY_PUBLISH, FLEET_SWAP, PROBATION, ROLLBACK)

# outcomes
PUBLISHED = "published"
REFUSED = "refused"
ROLLED_BACK = "rolled_back"
ABANDONED = "abandoned"

JOURNAL_FILE = "controller.json"
FORMAT_VERSION = 1
_KEEP_HISTORY = 64


class CycleJournal:
    """Load/advance/persist the controller's one-cycle-at-a-time state."""

    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self.path = os.path.join(state_dir, JOURNAL_FILE)
        self._state: Dict[str, Any] = self._fresh()
        self._load()

    # ---- persistence ----
    @staticmethod
    def _fresh() -> Dict[str, Any]:
        return {
            "format_version": FORMAT_VERSION,
            "cycle": 0,
            "stage": IDLE,
            "outcome": None,
            "trigger": None,           # AlertRecord dict that opened the cycle
            "mode": None,              # incremental | full
            "champion_version": None,  # serving version at cycle start
            "champion_accuracy": None,
            "candidate_accuracy": None,
            "candidate_sha": None,     # model fingerprint, set BEFORE publish
            "candidate_version": None,  # set AFTER publish commits
            "probation": None,         # {floor, needed, seen, windows}
            "canary": None,            # {needed, percent, opened_unix, ...}
            "history": [],             # bounded completed-cycle summaries
        }

    def _load(self) -> None:
        try:
            with open(self.path) as fh:
                state = json.load(fh)
        except FileNotFoundError:
            return
        except Exception:
            # a torn journal can only be the pre-rename tmp surviving a
            # crash plus a damaged final — never written by this class;
            # treat as fresh rather than wedging the controller forever
            import warnings
            warnings.warn(
                f"controller journal {self.path!r} is unreadable; "
                f"starting from an idle state (the registry pin, not the "
                f"journal, is the serving source of truth)",
                RuntimeWarning)
            return
        if isinstance(state, dict) and state.get("stage") in STAGES:
            base = self._fresh()
            base.update(state)
            self._state = base

    def write(self) -> None:
        tmp = self.path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self._state, fh, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    # ---- views ----
    def __getitem__(self, key: str) -> Any:
        return self._state[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self._state.get(key, default)

    @property
    def stage(self) -> str:
        return self._state["stage"]

    @property
    def cycle(self) -> int:
        return int(self._state["cycle"])

    @property
    def pending(self) -> bool:
        """True when a crash (or a stop) left a cycle mid-flight."""
        return self.stage in ACTIVE_STAGES

    def cycle_dir(self, cycle: Optional[int] = None) -> str:
        return os.path.join(self.state_dir,
                            f"cycle_{self.cycle if cycle is None else cycle:06d}")

    @property
    def history(self) -> List[Dict[str, Any]]:
        return list(self._state.get("history") or [])

    # ---- transitions ----
    def open_cycle(self, trigger: Optional[Dict[str, Any]], mode: str,
                   champion_version: Optional[int]) -> int:
        """Start cycle N+1 at retrain_build.  Refuses while a cycle is
        mid-flight — the controller runs ONE cycle at a time (alerts
        arriving meanwhile coalesce)."""
        if self.pending:
            raise RuntimeError(
                f"cycle {self.cycle} is still at stage {self.stage!r}; "
                f"resume or abandon it before opening a new one")
        self._state.update(
            cycle=self.cycle + 1, stage=RETRAIN_BUILD, outcome=None,
            trigger=trigger, mode=mode,
            champion_version=champion_version,
            champion_accuracy=None, candidate_accuracy=None,
            candidate_sha=None, candidate_version=None, probation=None,
            canary=None)
        self.write()
        return self.cycle

    def advance(self, stage: str, **fields: Any) -> None:
        """Record entering ``stage`` (plus any durable result fields) —
        ALWAYS before the stage's side effects, so the crash window of
        every stage re-enters that stage, never skips it."""
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}")
        self._state["stage"] = stage
        self._state.update(fields)
        self.write()

    def update(self, **fields: Any) -> None:
        self._state.update(fields)
        self.write()

    def close_cycle(self, outcome: str, **fields: Any) -> None:
        """Terminal transition: record the outcome, append the bounded
        history summary, return to a resumable-idle complete state."""
        self._state.update(fields)
        self._state["stage"] = COMPLETE
        self._state["outcome"] = outcome
        summary = {k: self._state[k] for k in
                   ("cycle", "outcome", "mode", "champion_version",
                    "candidate_version", "champion_accuracy",
                    "candidate_accuracy")}
        hist = list(self._state.get("history") or [])
        hist.append(summary)
        self._state["history"] = hist[-_KEEP_HISTORY:]
        self.write()
