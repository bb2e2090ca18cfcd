"""The closed loop: drift alert -> retrain -> validate -> publish -> swap
-> probation -> (rollback); port of ``avenir_tpu/control/controller.py``
(everything but the online plane's ``OnlineSupervisor``).

``RetrainController`` is a crash-resumable state machine over pieces the
port already has: ``DriftPolicy`` fires debounced AlertRecords,
``build_forest_from_stream`` checkpoints and resumes bit-identically,
the registry publishes (with a delta against the champion) and pins
atomically, and a ``ServingFleet`` converges on a version.  The
controller never sits on the data path: its only side effects are
registry writes (publish, serving pin) and a reload nudge; workers keep
their device state and keep answering through any controller crash.

On the card a cycle launches three of the port's kernels: the level
histogram (B1, ``kernels/histogram.py``) in the streamed build, the
monitor bin counts (B4) in the candidate's baseline and the drift
re-score, and the forest vote (B2, ``kernels/vote.py``) in validation
and in the fleet's batches.

Cycle shape (journal.py names the stages; each is a fault point)::

  alert -> retrain_build        train the candidate: incremental (resume
                                ``build_forest_from_stream`` from its own
                                checkpoint over the fresh window, served
                                through the ``.avtc`` cache) or a
                                scheduled full rebuild
        -> candidate_validate   champion-vs-candidate on a delayed-label
                                holdout via ``AccuracyTracker`` + a drift
                                re-score; worse candidate -> REFUSED,
                                champion untouched
        -> canary_validate      optional live split on a models= fleet
        -> registry_publish     atomic versioned publish + baseline
                                sidecar; resume dedups by the candidate
                                sha journaled BEFORE publishing, so a
                                crash in the publish window can never
                                double-publish
        -> fleet_swap           pin the serving version + ``refresh``;
                                swap-ack = fleet convergence
        -> probation            watch live delayed-label accuracy; a
                                candidate under the journaled floor
                                AUTO-ROLLS-BACK (pin back to the
                                champion, re-converge the fleet)
        -> complete             outcome: published | refused |
                                rolled_back | abandoned

Crash contract: every transition journals tmp-then-rename BEFORE its
side effects.  A controller killed at ANY stage resumes (or safely
abandons) from the journal: builds restart from their checkpoint,
publishes dedup by sha, pins and reloads are idempotent.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from ..core.faults import fault_point
from ..core.metrics import Counters
from ..monitor.policy import (ALERT, DEFAULT_ALERT, AccuracyTracker,
                              AlertRecord, DriftPolicy)
from ..telemetry import instant, span
from .journal import (ABANDONED, CANARY_VALIDATE, CANDIDATE_VALIDATE,
                      FLEET_SWAP, PROBATION, PUBLISHED, REFUSED,
                      REGISTRY_PUBLISH, RETRAIN_BUILD, ROLLBACK,
                      ROLLED_BACK, CycleJournal)

CANDIDATE_DIR = "candidate"
CANDIDATE_META = "meta.json"
INCREMENTAL = "incremental"
FULL = "full"


@dataclass
class RetrainPolicy:
    """The controller's knobs (CLI twin: the ``dtb.retrain.*`` keys).

    Validation: the candidate is REFUSED when its holdout accuracy falls
    more than ``accuracy_margin`` integer points below the champion's,
    or when its normalized drift re-score (worst statistic / its alert
    threshold, over the holdout window vs each model's own baseline) is
    worse than the champion's by more than ``drift_margin``.

    Probation: ``probation_outcomes`` delayed-label outcomes per window,
    ``probation_windows`` windows; ANY window below the journaled floor
    (champion holdout accuracy - ``probation_margin``) rolls back.
    ``probation_outcomes=0`` disables probation (complete at swap)."""
    full_rebuild_every: int = 0      # every Nth cycle rebuilds in full; 0=never
    accuracy_margin: int = 2         # integer accuracy points
    drift_margin: float = 0.25       # normalized drift-score slack
    probation_outcomes: int = 0      # outcomes per probation window
    probation_windows: int = 1
    probation_margin: int = 5        # live floor = champion acc - this
    # a probation that never receives outcomes (mis-wired delayed-label
    # lane) must not wedge the controller forever: past the timeout the
    # cycle completes as published-with-a-warning (no evidence AGAINST
    # the candidate ever arrived).  0 = wait indefinitely;
    # resolve_probation() is the operator escape either way.
    probation_timeout_s: float = 24 * 3600.0
    # canary validation: with canary_outcomes > 0 and a
    # models= fleet attached, a validated candidate serves a
    # deterministic canary_percent% live split (pre-publish, from the
    # in-memory payload) and must score within accuracy_margin of the
    # journaled champion accuracy over canary_outcomes candidate-arm
    # outcomes before the cycle publishes.  0 = journaled skip (the
    # canary_validate stage records why and passes straight through).
    canary_outcomes: int = 0
    canary_percent: int = 10
    canary_timeout_s: float = 3600.0
    swap_ack_timeout_s: float = 30.0
    cooldown_s: float = 0.0          # min seconds between cycle starts
    chunk_rows: int = 1 << 16        # streaming build block size
    checkpoint_blocks: int = 1       # checkpoint cadence (blocks)
    baseline_bins: int = 32
    cache_policy: str = "use"        # .avtc policy for retrain reads
    retire_keep_last: int = 0        # >0: registry GC after each cycle

    def __post_init__(self):
        if self.probation_outcomes < 0 or self.probation_windows < 1:
            raise ValueError("probation_outcomes must be >= 0 and "
                             "probation_windows >= 1")
        if self.canary_outcomes < 0 \
                or not 0 <= self.canary_percent <= 100:
            raise ValueError("canary_outcomes must be >= 0 and "
                             "canary_percent 0..100")
        if self.checkpoint_blocks < 1 or self.chunk_rows < 1:
            raise ValueError("chunk_rows and checkpoint_blocks must be "
                             ">= 1")


class WireFleetLink:
    """Addressed-reload swap link for OUT-of-process fleets: one
    ``reload,<host_label>`` per host (the multi-host convergence
    protocol; a bare ``reload`` when no hosts are named) pushed onto the
    request queue.  No ack surface — the controller counts
    ``SwapAckUnavailable`` and trusts the fleets' own refresh loop."""

    def __init__(self, client, request_queue: str = "requestQueue",
                 hosts: Iterable[str] = ()):
        self.client = client
        self.request_queue = request_queue
        self.hosts = [h for h in hosts if h]

    def refresh(self) -> bool:
        msgs = [f"reload,{h}" for h in self.hosts] or ["reload"]
        for m in msgs:
            self.client.lpush(self.request_queue, m)
        return True


# --------------------------------------------------------------------------
# alert intake helpers (the RESP / alerts.jsonl stream sources)
# --------------------------------------------------------------------------

def alert_from_json(line: str) -> AlertRecord:
    return AlertRecord(**json.loads(line))


def alerts_from_jsonl(path: str) -> List[AlertRecord]:
    """Parse a ``driftMonitor``/``predictDriftScore`` alerts.jsonl file;
    malformed lines are skipped with a warning (a monitoring artifact
    must not wedge the controller)."""
    out: List[AlertRecord] = []
    try:
        with open(path) as fh:
            for ln, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(alert_from_json(line))
                except Exception as exc:
                    warnings.warn(
                        f"alerts stream {path!r} line {ln}: unparseable "
                        f"record skipped ({type(exc).__name__}: {exc})",
                        RuntimeWarning)
    except FileNotFoundError:
        pass
    return out


def alerts_from_resp(client, queue: str, max_batch: int = 256
                     ) -> List[AlertRecord]:
    """Drain whatever alert JSON lines sit on a RESP list queue right
    now (the live-monitor wire lane).  A literal 'stop' drained here is
    RE-PUSHED for whatever consumer the sentinel was aimed at (this
    reader is a tap, not the queue's owner), and the rest of the popped
    batch is still parsed — records already popped must never be
    dropped on the floor."""
    out: List[AlertRecord] = []
    msgs = client.rpop_many(queue, max_batch)
    for m in msgs:
        if m == "stop":
            try:
                client.lpush(queue, "stop")
            except Exception:
                pass
            continue
        try:
            out.append(alert_from_json(m))
        except Exception as exc:
            warnings.warn(f"alert queue {queue!r}: unparseable record "
                          f"skipped ({type(exc).__name__}: {exc})",
                          RuntimeWarning)
    return out


# --------------------------------------------------------------------------
# the controller
# --------------------------------------------------------------------------

class RetrainController:
    """One model's closed retraining loop (see module docstring).

    ``train_source``/``full_source``/``holdout_source`` are CSV paths (or
    zero-arg callables returning one): the fresh drifted window to retrain
    on, the full dataset for scheduled rebuilds (defaults to the fresh
    window), and the delayed-label holdout the validation stage scores
    champion vs candidate on (defaults to the fresh window — in
    production, point it at held-back labeled traffic).

    ``fleet`` is the swap link, duck-typed: anything with ``refresh()``
    (``ServingFleet``, ``PredictionService``, :class:`WireFleetLink`), an
    optional ``converged_version()``/``version`` ack surface.  ``None``
    means pin-only — standalone services converge at their own next
    refresh."""

    def __init__(self, registry, model_name: str, schema, *,
                 state_dir: str,
                 train_source,
                 holdout_source=None,
                 full_source=None,
                 forest_params=None,
                 fleet=None,
                 policy: Optional[RetrainPolicy] = None,
                 counters: Optional[Counters] = None,
                 delim_regex: str = ","):
        self.registry = registry
        self.model_name = model_name
        self.schema = schema
        self.policy = policy or RetrainPolicy()
        self.counters = counters if counters is not None else Counters()
        self.delim_regex = delim_regex
        self.fleet = fleet
        self._train_source = train_source
        self._holdout_source = holdout_source or train_source
        self._full_source = full_source or train_source
        if forest_params is None:
            from ..models.forest import ForestParams
            forest_params = ForestParams()
        self.forest_params = forest_params
        self.journal = CycleJournal(state_dir)
        self._lock = threading.Lock()
        # the pending-alert slot has its OWN tiny lock: submit_alert runs
        # on the monitor/serving thread and must never wait behind the
        # cycle lock (held for a whole retrain by run_pending)
        self._alert_lock = threading.Lock()
        self._pending_alert: Optional[AlertRecord] = None
        self._last_cycle_end = 0.0
        # probation outcome buffers (live delayed labels)
        self._prob_pred: List[str] = []
        self._prob_actual: List[str] = []
        # canary_validate live state: True only while THIS process has
        # the canary installed on the fleet (deliberately not journaled
        # — a restarted controller re-installs on resume; buffered
        # outcomes restart with it)
        self._canary_live = False
        self._can_pred: Dict[str, List[str]] = {}
        self._can_actual: Dict[str, List[str]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- alert intake (control plane; never blocks the caller on a
    # retrain — the serving/monitor thread hands off and returns) ----
    def submit_alert(self, rec: AlertRecord) -> bool:
        """Queue an alert for the next :meth:`run_pending`.  Only
        level=alert records trigger (warnings are counted and ignored);
        while a cycle is active or an alert is already queued, later
        alerts coalesce into one pending trigger."""
        if rec.level != ALERT:
            self.counters.increment("Controller", "AlertsIgnored")
            return False
        with self._alert_lock:
            if self._pending_alert is not None:
                self.counters.increment("Controller", "AlertsCoalesced")
                self._pending_alert = rec
                return False
            self._pending_alert = rec
            self.counters.increment("Controller", "Alerts")
        return True

    def consume(self, records: Iterable[AlertRecord]) -> int:
        """Submit a batch (the alerts.jsonl / RESP stream lane)."""
        return sum(1 for r in records if self.submit_alert(r))

    # ---- the run surface ----
    def run_pending(self) -> Optional[Dict[str, Any]]:
        """One control-loop tick: resume a mid-flight cycle if the
        journal holds one, else start a cycle for the pending alert (if
        any, and the cooldown passed).  Returns the cycle summary dict,
        a probation-waiting marker, or None when there is nothing to
        do."""
        with self._lock:
            if self.journal.pending:
                if self.journal.stage == CANARY_VALIDATE \
                        and self._canary_live:
                    # WAITING on live canary outcomes, not crashed:
                    # record_canary_outcome drives it.  Past the timeout
                    # the candidate proceeds to publish — no evidence
                    # against it ever arrived (the probation-timeout
                    # rationale, one stage earlier).
                    can = self.journal["canary"] or {}
                    opened = float(can.get("opened_unix") or 0)
                    if self.policy.canary_timeout_s > 0 and opened \
                            and time.time() - opened \
                            > self.policy.canary_timeout_s:
                        return self._resolve_canary_locked(timed_out=True)
                    return None
                if self.journal.stage == PROBATION:
                    # not a crash to resume: the cycle is WAITING on live
                    # delayed labels (record_outcome drives it); alerts
                    # arriving meanwhile stay coalesced.  A probation
                    # past its timeout resolves as kept — no evidence
                    # against the candidate ever arrived, and a wedged
                    # controller is worse than an unprobed swap.
                    prob = self.journal["probation"] or {}
                    opened = float(prob.get("opened_unix") or 0)
                    if self.policy.probation_timeout_s > 0 and opened \
                            and time.time() - opened \
                            > self.policy.probation_timeout_s:
                        return self._resolve_probation_locked(keep=True,
                                                              timed_out=True)
                    return None
                return self._resume_locked()
            with self._alert_lock:
                alert = self._pending_alert
                if alert is None:
                    return None
                if time.monotonic() - self._last_cycle_end \
                        < self.policy.cooldown_s:
                    return None
                self._pending_alert = None
            return self._run_cycle_locked(alert)

    def force_cycle(self, mode: Optional[str] = None
                    ) -> Optional[Dict[str, Any]]:
        """Operator override: run one cycle now without an alert (the
        CLI's ``dtb.retrain.trigger=force``).  A CRASHED cycle resumes
        first; a cycle WAITING in probation is left exactly in place
        (returns None, buffered outcomes preserved) — forcing must not
        reset a partially-scored probation window and buy a bad
        candidate a fresh one."""
        with self._lock:
            if self.journal.pending:
                if self.journal.stage == PROBATION or \
                        (self.journal.stage == CANARY_VALIDATE
                         and self._canary_live):
                    return None
                return self._resume_locked()
            return self._run_cycle_locked(None, mode=mode)

    # ---- background loop (the live deployment shape) ----
    def start(self, poll_s: float = 0.5) -> "RetrainController":
        if self._thread is not None:
            if self._thread.is_alive() and not self._stop.is_set():
                return self            # already running
            # a previous loop may still be finishing its cycle after a
            # timed-out stop(): wait for it BEFORE clearing the stop
            # flag, or the old loop would see the cleared flag and keep
            # ticking alongside the new one — two concurrent control
            # loops double-evaluating every resume and timeout
            self._thread.join()
            self._thread = None
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.run_pending()
                except Exception as exc:
                    # the loop must survive a failing cycle: the journal
                    # already holds the resumable state, the next tick
                    # retries — exactly the chaos-drill resume path
                    warnings.warn(
                        f"retrain controller cycle failed "
                        f"({type(exc).__name__}: {exc}); will resume",
                        RuntimeWarning)
                self._stop.wait(poll_s)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="avenir-retrain-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
            if t.is_alive():
                # mid-cycle: the loop exits at its next tick (the stop
                # flag is set).  Keep the handle so a later start()
                # joins it instead of racing a second loop against it.
                warnings.warn(
                    "retrain controller loop is still finishing its "
                    "cycle; it exits at the next tick (journal state is "
                    "safe to resume)", RuntimeWarning)
            else:
                self._thread = None

    # ---- cycle machinery ----
    def _decide_mode(self, next_cycle: int) -> str:
        every = self.policy.full_rebuild_every
        if every > 0 and next_cycle % every == 0:
            return FULL
        return INCREMENTAL

    def _source_path(self, source) -> str:
        return source() if callable(source) else source

    def _run_cycle_locked(self, alert: Optional[AlertRecord],
                          mode: Optional[str] = None) -> Dict[str, Any]:
        champion = self.registry.serving_version(self.model_name)
        if champion is None:
            raise FileNotFoundError(
                f"no intact versions of {self.model_name!r} in "
                f"{self.registry.base_dir!r}: the controller retrains an "
                f"existing champion, it does not bootstrap one")
        mode = mode or self._decide_mode(self.journal.cycle + 1)
        self.journal.open_cycle(
            alert.__dict__ if alert is not None else None, mode, champion)
        self.counters.increment("Controller", "Cycles")
        instant("controller.decision", cat="controller",
                action="cycle_start", cycle=self.journal.cycle, mode=mode,
                champion_version=champion,
                trigger=(alert.scope if alert is not None else "operator"))
        return self._advance(RETRAIN_BUILD, resuming=False)

    def _resume_locked(self) -> Dict[str, Any]:
        self.counters.increment("Controller", "Resumes")
        stage = self.journal.stage
        instant("controller.decision", cat="controller", action="resume",
                cycle=self.journal.cycle, stage=stage)
        return self._advance(stage, resuming=True)

    def _advance(self, stage: str, resuming: bool) -> Dict[str, Any]:
        """Run the state machine from ``stage`` to a terminal state (or
        to probation-wait).  Candidate payloads travel in-memory along
        the happy path and reload from the cycle directory on resume."""
        # every stage executes under ONE taxonomy span
        # (``controller.stage``, args naming the stage + cycle): the
        # control plane's decisions become correlatable with the
        # data-plane latencies they cause in the same merged timeline —
        # the stages already journal, so tracing is just this wrapper
        models = baseline = None
        if stage == RETRAIN_BUILD:
            with span("controller.stage", cat="controller",
                      stage=RETRAIN_BUILD, cycle=self.journal.cycle):
                models, baseline = self._stage_build(resuming)
            stage = CANDIDATE_VALIDATE
        if stage in (CANDIDATE_VALIDATE, CANARY_VALIDATE,
                     REGISTRY_PUBLISH) and models is None:
            cand = self._load_candidate()
            if cand is None:
                # resume found no usable candidate payload: published
                # already?  (publish crash after commit, candidate dir
                # lost) — else the cycle is unfinishable; abandon with
                # the champion untouched
                v = self._find_published(self.journal["candidate_sha"])
                if stage == REGISTRY_PUBLISH and v is not None:
                    self.journal.advance(FLEET_SWAP, candidate_version=v)
                    stage = FLEET_SWAP
                else:
                    return self._abandon("candidate payload missing or "
                                         "torn at resume")
            else:
                models, baseline = cand
        if stage == CANDIDATE_VALIDATE:
            with span("controller.stage", cat="controller",
                      stage=CANDIDATE_VALIDATE, cycle=self.journal.cycle):
                verdict = self._stage_validate(models, baseline)
            if verdict is not None:
                return verdict           # refused
            stage = CANARY_VALIDATE
        if stage == CANARY_VALIDATE:
            with span("controller.stage", cat="controller",
                      stage=CANARY_VALIDATE, cycle=self.journal.cycle):
                waiting = self._stage_canary(models)
            if waiting:
                # the cycle now WAITS on live canary outcomes —
                # record_canary_outcome (or the timeout) decides it
                return {"cycle": self.journal.cycle,
                        "stage": CANARY_VALIDATE,
                        "canary": self.journal["canary"]}
            stage = REGISTRY_PUBLISH
        if stage == REGISTRY_PUBLISH:
            with span("controller.stage", cat="controller",
                      stage=REGISTRY_PUBLISH, cycle=self.journal.cycle):
                self._stage_publish(models, baseline)
            stage = FLEET_SWAP
        if stage == FLEET_SWAP:
            with span("controller.stage", cat="controller",
                      stage=FLEET_SWAP, cycle=self.journal.cycle):
                waiting = self._stage_swap()
            if waiting:
                return {"cycle": self.journal.cycle, "stage": PROBATION,
                        "candidate_version":
                            self.journal["candidate_version"]}
            return self._complete(PUBLISHED)
        # no PROBATION branch: a probation-waiting journal never reaches
        # _advance (run_pending/force_cycle return before resuming it —
        # record_outcome and the timeout are its only drivers)
        if stage == ROLLBACK:
            return self._stage_rollback()
        raise RuntimeError(f"unexpected controller stage {stage!r}")

    # ---- stage: retrain_build ----
    def _faulted_blocks(self, blocks):
        for b in blocks:
            fault_point("retrain_build")
            yield b

    def _stage_build(self, resuming: bool):
        from ..core.checkpoint import CheckpointManager
        from ..core.table import (BadRecordPolicy, iter_csv_chunks,
                                  prefetch_chunks)
        from ..models.forest import build_forest_from_stream
        from ..monitor.baseline import BaselineBuilder
        jr = self.journal
        fault_point("retrain_build")
        cycle_dir = jr.cycle_dir()
        os.makedirs(cycle_dir, exist_ok=True)
        src = self._source_path(
            self._full_source if jr["mode"] == FULL else self._train_source)
        mgr = CheckpointManager(os.path.join(cycle_dir, "ckpt"))
        resume_state, start_row = None, 0
        if resuming:
            try:
                step, arrays, meta = mgr.restore()
            except FileNotFoundError:
                pass    # crashed before the first checkpoint: cold build
            else:
                resume_state = (arrays, meta)
                start_row = int(meta.get("source_rows_done") or 0)
                self.counters.increment("Controller", "BuildResumes")
        def cache_policy():
            if self.policy.cache_policy == "off":
                return None
            from ..io.colcache import CachePolicy
            return CachePolicy(policy=self.policy.cache_policy,
                               counters=self.counters)
        baseline_builder = BaselineBuilder(
            self.schema, n_bins=self.policy.baseline_bins)
        if start_row > 0:
            # the checkpoint restores the MODEL's progress but not the
            # baseline's (stream checkpoints carry no baseline counts),
            # and the stream below restarts at start_row — re-profile
            # the already-consumed head first, or the candidate ships a
            # tail-only baseline that silently skews every later drift
            # score.  A warm .avtc sidecar serves the head at memcpy
            # speed (the cached iterator honors stop_row; a bounded
            # read never BUILDS a cache — a head must not masquerade
            # as a full sidecar).
            for head in iter_csv_chunks(
                    src, self.schema, self.delim_regex,
                    chunk_rows=self.policy.chunk_rows,
                    bad_records=BadRecordPolicy("skip", None,
                                                self.counters),
                    cache=cache_policy(), stop_row=start_row):
                baseline_builder.update(head)
        blocks = prefetch_chunks(iter_csv_chunks(
            src, self.schema, self.delim_regex,
            chunk_rows=self.policy.chunk_rows,
            bad_records=BadRecordPolicy("skip", None, self.counters),
            start_row=start_row, cache=cache_policy()),
            consumer_wait_key=None)
        models = build_forest_from_stream(
            self._faulted_blocks(blocks), self.schema, self.forest_params,
            checkpoint=mgr,
            checkpoint_every=self.policy.checkpoint_blocks,
            resume_state=resume_state, baseline=baseline_builder)
        baseline = baseline_builder.finalize()
        sha = _models_sha(models)
        self._save_candidate(models, baseline, sha)
        jr.advance(CANDIDATE_VALIDATE, candidate_sha=sha)
        return models, baseline

    # ---- candidate persistence (resume survives a post-build crash) ----
    def _candidate_dir(self) -> str:
        return os.path.join(self.journal.cycle_dir(), CANDIDATE_DIR)

    def _save_candidate(self, models, baseline, sha: str) -> None:
        from ..monitor.baseline import BASELINE_JSON, BASELINE_NPZ
        final = self._candidate_dir()
        tmp = final + f".tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, m in enumerate(models):
            with open(os.path.join(tmp, f"tree_{i}.json"), "w") as fh:
                fh.write(m.to_json())
        sidecar = baseline.to_sidecar()
        for fname in (BASELINE_JSON, BASELINE_NPZ):
            with open(os.path.join(tmp, fname), "wb") as fh:
                fh.write(sidecar[fname])
        with open(os.path.join(tmp, CANDIDATE_META), "w") as fh:
            json.dump({"sha": sha, "n_trees": len(models)}, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    def _load_candidate(self):
        """(models, baseline) from the cycle dir, or None when missing /
        torn / sha-mismatched (a damaged candidate must never be
        published)."""
        from ..models.tree import DecisionPathList
        from ..monitor.baseline import BASELINE_JSON, BASELINE_NPZ, Baseline
        d = self._candidate_dir()
        try:
            with open(os.path.join(d, CANDIDATE_META)) as fh:
                meta = json.load(fh)
            models = []
            for i in range(int(meta["n_trees"])):
                with open(os.path.join(d, f"tree_{i}.json")) as fh:
                    models.append(DecisionPathList.from_json(fh.read()))
            if _models_sha(models) != meta["sha"] \
                    or meta["sha"] != self.journal["candidate_sha"]:
                return None
            with open(os.path.join(d, BASELINE_JSON), "rb") as fh:
                bj = fh.read()
            with open(os.path.join(d, BASELINE_NPZ), "rb") as fh:
                bn = fh.read()
            return models, Baseline.from_sidecar(bj, bn)
        except Exception:
            return None

    # ---- stage: candidate_validate ----
    def _stage_validate(self, models, baseline) -> Optional[Dict[str, Any]]:
        from ..core.table import BadRecordPolicy, load_csv
        from ..monitor.baseline import load_baseline
        jr = self.journal
        fault_point("candidate_validate")
        holdout = load_csv(self._source_path(self._holdout_source),
                           self.schema, self.delim_regex,
                           bad_records=BadRecordPolicy("skip", None,
                                                       self.counters))
        champ = self.registry.load(self.model_name,
                                   jr["champion_version"])
        champ_acc = self._accuracy_table(champ.model, holdout)
        cand_acc = self._accuracy_table(models, holdout)
        cand_norm = _drift_norm(baseline, holdout)
        champ_norm = None
        try:
            champ_baseline = load_baseline(self.registry, self.model_name,
                                           jr["champion_version"])
            champ_norm = _drift_norm(champ_baseline, holdout)
        except FileNotFoundError:
            pass   # pre-baseline champion: accuracy alone decides
        worse_acc = cand_acc < champ_acc - self.policy.accuracy_margin
        worse_drift = champ_norm is not None and \
            cand_norm > champ_norm + self.policy.drift_margin
        jr.update(champion_accuracy=champ_acc,
                  candidate_accuracy=cand_acc)
        instant("controller.decision", cat="controller",
                action="validate", cycle=jr.cycle,
                champion_accuracy=champ_acc, candidate_accuracy=cand_acc,
                candidate_drift=round(cand_norm, 4),
                champion_drift=(round(champ_norm, 4)
                                if champ_norm is not None else None),
                refused=bool(worse_acc or worse_drift))
        if worse_acc or worse_drift:
            self.counters.increment("Controller", "Refused")
            warnings.warn(
                f"retrain cycle {jr.cycle}: candidate refused "
                f"(accuracy {cand_acc} vs champion {champ_acc}, "
                f"margin {self.policy.accuracy_margin}; drift "
                f"{cand_norm:.3g} vs "
                f"{champ_norm if champ_norm is not None else 'n/a'}); "
                f"champion stays", RuntimeWarning)
            return self._complete(REFUSED)
        jr.advance(CANARY_VALIDATE)
        return None

    def _accuracy_table(self, models, table) -> int:
        """Delayed-label holdout accuracy (integer percent) through the
        SAME AccuracyTracker/ConfusionMatrix path the live monitor uses."""
        labels, actual = predict_outcomes(models, self.schema, table)
        card = list(self.schema.class_attr_field.cardinality or [])
        return accuracy_pct(labels, actual,
                            neg_class=card[0], pos_class=card[1])

    # ---- stage: canary_validate (live outcomes drive it) ----
    def _canary_fleet(self):
        """The fleet link, iff it speaks the multi-model canary verbs."""
        f = self.fleet
        if f is not None and hasattr(f, "install_canary") \
                and hasattr(f, "record_canary_outcome"):
            return f
        return None

    def _stage_canary(self, models) -> bool:
        """Install the candidate as a live canary (pre-publish, from the
        in-memory payload) and wait for outcomes.  Returns True when the
        cycle now waits; False when the stage was a journaled skip
        (policy disabled, or no canary-capable fleet attached) and the
        cycle proceeds straight to publish."""
        jr = self.journal
        fault_point("canary_validate")
        fleet = self._canary_fleet()
        if self.policy.canary_outcomes <= 0 or fleet is None:
            reason = ("disabled" if self.policy.canary_outcomes <= 0
                      else "no canary-capable fleet")
            # journaled skip: the durable record says the stage ran and
            # WHY it passed through, so a resumed cycle replays the
            # same decision instead of inventing a canary it never had
            jr.advance(REGISTRY_PUBLISH, canary={"skipped": True,
                                                 "reason": reason})
            self.counters.increment("Controller", "CanarySkipped")
            instant("controller.decision", cat="controller",
                    action="canary_skip", cycle=jr.cycle, reason=reason)
            return False
        from ..serving.predictor import ForestPredictor
        card = list(self.schema.class_attr_field.cardinality or [])
        pred = ForestPredictor(models, self.schema)
        fleet.install_canary(self.model_name, predictor=pred,
                             percent=self.policy.canary_percent,
                             pos_class=card[1], neg_class=card[0],
                             window=max(1, self.policy.canary_outcomes))
        self._can_pred = {"champion": [], "candidate": []}
        self._can_actual = {"champion": [], "candidate": []}
        self._canary_live = True
        jr.advance(CANARY_VALIDATE, canary={
            "needed": self.policy.canary_outcomes,
            "percent": self.policy.canary_percent,
            "opened_unix": time.time()})
        self.counters.increment("Controller", "CanaryInstalled")
        instant("controller.decision", cat="controller",
                action="canary_start", cycle=jr.cycle,
                percent=self.policy.canary_percent,
                needed=self.policy.canary_outcomes)
        return True

    def record_canary_outcome(self, rid, predicted: str, actual: str
                              ) -> Optional[Dict[str, Any]]:
        """Feed one live delayed-label outcome for a canaried request.
        The arm is re-derived from the request id by the SAME
        deterministic split that routed it (no routing journal needed).
        Collecting ``canary_outcomes`` candidate-arm outcomes decides
        the stage: candidate accuracy within ``accuracy_margin`` of the
        journaled champion accuracy proceeds to publish (synchronously,
        on this thread — the control-plane lane, like probation's
        deciding outcome); below it the cycle completes REFUSED and the
        champion keeps 100%.  No-op (None) outside canary-wait."""
        with self._lock:
            if self.journal.stage != CANARY_VALIDATE \
                    or not self._canary_live:
                return None
            fleet = self._canary_fleet()
            arm = None
            if fleet is not None:
                arm = fleet.record_canary_outcome(
                    self.model_name, rid, predicted, actual)
            if arm is None:
                from ..serving.router import canary_split
                arm = "candidate" if canary_split(
                    rid, self.policy.canary_percent) else "champion"
            self._can_pred[arm].append(predicted)
            self._can_actual[arm].append(actual)
            if len(self._can_pred["candidate"]) \
                    < self.policy.canary_outcomes:
                return None
            return self._resolve_canary_locked(timed_out=False)

    def _teardown_canary(self) -> None:
        fleet = self._canary_fleet()
        if fleet is not None and self._canary_live:
            try:
                fleet.clear_canary(self.model_name)
            except Exception as exc:
                warnings.warn(
                    f"retrain cycle {self.journal.cycle}: canary "
                    f"teardown failed ({type(exc).__name__}: {exc})",
                    RuntimeWarning)
        self._canary_live = False

    def _resolve_canary_locked(self, timed_out: bool
                               ) -> Optional[Dict[str, Any]]:
        jr = self.journal
        card = list(self.schema.class_attr_field.cardinality or [])
        cand_n = len(self._can_pred["candidate"])
        cand_acc = accuracy_pct(self._can_pred["candidate"],
                                self._can_actual["candidate"],
                                neg_class=card[0], pos_class=card[1]) \
            if cand_n else None
        champ_n = len(self._can_pred["champion"])
        champ_acc = accuracy_pct(self._can_pred["champion"],
                                 self._can_actual["champion"],
                                 neg_class=card[0], pos_class=card[1]) \
            if champ_n else None
        floor = max(0, (jr["champion_accuracy"] or 0)
                    - self.policy.accuracy_margin)
        refused = not timed_out and cand_acc is not None \
            and cand_acc < floor
        can = dict(jr["canary"] or {})
        can.update(candidate_accuracy=cand_acc,
                   candidate_outcomes=cand_n,
                   champion_accuracy=champ_acc,
                   champion_outcomes=champ_n,
                   floor=floor, timed_out=timed_out)
        jr.update(canary=can)
        self._teardown_canary()
        self.counters.increment(
            "Controller",
            "CanaryTimeouts" if timed_out else "CanaryWindows")
        instant("controller.decision", cat="controller",
                action="canary_verdict", cycle=jr.cycle,
                candidate_accuracy=cand_acc, floor=floor,
                candidate_outcomes=cand_n, champion_outcomes=champ_n,
                refused=refused, timed_out=timed_out)
        if timed_out:
            warnings.warn(
                f"retrain cycle {jr.cycle}: canary received only "
                f"{cand_n}/{self.policy.canary_outcomes} candidate "
                f"outcomes within {self.policy.canary_timeout_s}s; "
                f"proceeding to publish (no evidence against the "
                f"candidate — wire the delayed-label lane)",
                RuntimeWarning)
        if refused:
            self.counters.increment("Controller", "Refused")
            warnings.warn(
                f"retrain cycle {jr.cycle}: candidate refused at canary "
                f"(live accuracy {cand_acc} under floor {floor} over "
                f"{cand_n} outcomes); champion keeps 100%",
                RuntimeWarning)
            return self._complete(REFUSED)
        jr.advance(REGISTRY_PUBLISH)
        return self._advance(REGISTRY_PUBLISH, resuming=False)

    # ---- stage: registry_publish ----
    def _find_published(self, sha: Optional[str]) -> Optional[int]:
        """A committed version already carrying THIS cycle's candidate
        (the no-double-publish probe resume runs before writing).  The
        match is (candidate sha AND this journal cycle number, both
        stamped into the version's params at publish) over versions
        newer than this cycle's champion — only this cycle's own
        crashed publish attempt can satisfy all three, so a
        bit-identical model published by an EARLIER cycle (same window,
        same seed — and possibly already rolled back) is never adopted:
        it gets a fresh version with an honest audit trail."""
        if not sha:
            return None
        champion = self.journal["champion_version"] or 0
        from ..serving.registry import META_FILE
        for v in reversed(self.registry.versions(self.model_name)):
            if v <= champion:
                break
            d = self.registry.version_dir(self.model_name, v)
            try:
                with open(os.path.join(d, META_FILE)) as fh:
                    meta = json.load(fh)
            except Exception:
                continue
            params = meta.get("params") or {}
            if params.get("candidate_sha") == sha \
                    and params.get("controller_cycle") == self.journal.cycle \
                    and self.registry.is_intact(self.model_name, v):
                return v
        return None

    def _stage_publish(self, models, baseline) -> None:
        from ..monitor.baseline import BASELINE_JSON, publish_baseline
        from ..serving.registry import META_FILE
        jr = self.journal
        fault_point("registry_publish")
        sha = jr["candidate_sha"]
        version = self._find_published(sha)
        if version is None:
            params = {"controller_cycle": jr.cycle,
                      "candidate_sha": sha,
                      "retrain_mode": jr["mode"]}
            champion = jr["champion_version"]
            if champion is not None:
                # O(delta) distribution: a retrained candidate
                # is the champion's child, so publish it WITH a delta
                # sidecar against the champion — fleet refreshes then
                # patch only the changed trees instead of re-shipping
                # the forest.  publish_delta is a full publish plus a
                # best-effort sidecar: a delta that cannot be built
                # (kind/schema mismatch) warns and the version still
                # commits, so this branch never loses a publish.
                version = self.registry.publish_delta(
                    self.model_name, models, parent_version=champion,
                    schema=self.schema, params=params)
                if self.registry.delta_info(self.model_name,
                                            version) is not None:
                    self.counters.increment("Controller", "DeltaPublished")
            else:
                version = self.registry.publish(
                    self.model_name, models, schema=self.schema,
                    params=params)
            self.counters.increment("Controller", "Published")
        else:
            # a pre-journal crash landed AFTER the commit: adopt it
            self.counters.increment("Controller", "PublishDeduped")
        # the baseline sidecar may be missing when the crash hit between
        # publish and add_sidecar; attaching is idempotent
        d = self.registry.version_dir(self.model_name, version)
        with open(os.path.join(d, META_FILE)) as fh:
            files = json.load(fh).get("files") or []
        if BASELINE_JSON not in files:
            publish_baseline(self.registry, self.model_name, version,
                             baseline)
        # THE double-publish window: committed but not yet journaled — a
        # kill here must dedup by sha on resume, never publish twice
        fault_point("registry_publish")
        jr.advance(FLEET_SWAP, candidate_version=version)

    # ---- stage: fleet_swap ----
    def _reload_fleet(self) -> None:
        if self.fleet is None:
            return
        self.fleet.refresh()

    def _wait_converged(self, version: int) -> bool:
        """Swap-ack: poll the link's convergence surface until every
        worker serves ``version`` (True), or the timeout passes (False —
        serving is unharmed; workers converge at their next poll)."""
        f = self.fleet
        if f is None:
            return True
        probe: Optional[Callable[[], Optional[int]]] = None
        if hasattr(f, "converged_version"):
            probe = f.converged_version
        elif hasattr(f, "version"):
            probe = lambda: f.version      # noqa: E731
        if probe is None:
            self.counters.increment("Controller", "SwapAckUnavailable")
            return True
        deadline = time.monotonic() + self.policy.swap_ack_timeout_s
        while time.monotonic() < deadline:
            if probe() == version:
                return True
            time.sleep(0.01)
        return False

    def _stage_swap(self) -> bool:
        """Pin + reload + ack.  Returns True when the cycle now waits in
        probation, False when it completes immediately."""
        jr = self.journal
        fault_point("fleet_swap")
        version = jr["candidate_version"]
        self.registry.pin_version(self.model_name, version)
        self._reload_fleet()
        if not self._wait_converged(version):
            self.counters.increment("Controller", "SwapAckTimeouts")
            warnings.warn(
                f"retrain cycle {jr.cycle}: fleet did not ack version "
                f"{version} within {self.policy.swap_ack_timeout_s}s; "
                f"workers converge at their next poll", RuntimeWarning)
        self.counters.increment("Controller", "Swaps")
        instant("controller.decision", cat="controller", action="swap",
                cycle=jr.cycle, candidate_version=version,
                champion_version=jr["champion_version"])
        if self.policy.probation_outcomes > 0:
            floor = max(0, (jr["champion_accuracy"] or 0)
                        - self.policy.probation_margin)
            jr.advance(PROBATION, probation={
                "floor": floor,
                "needed": self.policy.probation_outcomes,
                "windows": self.policy.probation_windows,
                "windows_done": 0,
                "opened_unix": time.time()})
            self._prob_pred.clear()
            self._prob_actual.clear()
            return True
        return False

    # ---- stage: probation (live outcomes drive it) ----
    def record_outcome(self, predicted: str, actual: str
                       ) -> Optional[Dict[str, Any]]:
        """Feed one live delayed-label outcome (predicted, actual).
        Outside probation this is a no-op.  Closing a probation window
        below the journaled floor AUTO-ROLLS-BACK; surviving all windows
        completes the cycle as published.  Returns the terminal summary
        when this outcome decided the cycle.

        The deciding outcome executes the rollback (pin + reload + ack
        wait, up to ``swap_ack_timeout_s``) SYNCHRONOUSLY on the
        caller's thread — feed outcomes from the delayed-label lane
        (control plane), never from a request-serving thread.  Alert
        intake stays responsive meanwhile: ``submit_alert`` takes only
        the alert-slot lock, not this cycle lock."""
        with self._lock:
            if self.journal.stage != PROBATION:
                return None
            self._prob_pred.append(predicted)
            self._prob_actual.append(actual)
            prob = dict(self.journal["probation"] or {})
            needed = int(prob.get("needed") or 1)
            if len(self._prob_pred) < needed:
                return None
            card = list(self.schema.class_attr_field.cardinality or [])
            acc = accuracy_pct(self._prob_pred[:needed],
                               self._prob_actual[:needed],
                               neg_class=card[0], pos_class=card[1])
            del self._prob_pred[:needed], self._prob_actual[:needed]
            prob["windows_done"] = int(prob.get("windows_done", 0)) + 1
            prob["last_accuracy"] = acc
            self.counters.increment("Controller", "ProbationWindows")
            self.journal.update(probation=prob)
            instant("controller.decision", cat="controller",
                    action="probation_window", cycle=self.journal.cycle,
                    accuracy=acc, floor=prob["floor"],
                    window=prob["windows_done"])
            if acc < int(prob["floor"]):
                self.journal.advance(ROLLBACK)
                return self._stage_rollback()
            if prob["windows_done"] >= int(prob.get("windows") or 1):
                return self._complete(PUBLISHED)
            return None

    def resolve_probation(self, keep: bool = True
                          ) -> Optional[Dict[str, Any]]:
        """Operator escape hatch for a probation whose outcome stream
        never materialized (or a judgment call): ``keep=True`` completes
        the cycle as published on the candidate; ``keep=False`` rolls
        back to the champion NOW.  No-op (None) outside probation."""
        with self._lock:
            if self.journal.stage != PROBATION:
                return None
            return self._resolve_probation_locked(keep=keep,
                                                  timed_out=False)

    def _resolve_probation_locked(self, keep: bool, timed_out: bool
                                  ) -> Dict[str, Any]:
        self.counters.increment(
            "Controller",
            "ProbationTimeouts" if timed_out else "ProbationResolved")
        instant("controller.decision", cat="controller",
                action="probation_resolved", cycle=self.journal.cycle,
                keep=keep, timed_out=timed_out)
        if timed_out:
            warnings.warn(
                f"retrain cycle {self.journal.cycle}: probation received "
                f"no verdict within {self.policy.probation_timeout_s}s; "
                f"keeping the candidate (wire the delayed-label lane or "
                f"call resolve_probation)", RuntimeWarning)
        if keep:
            return self._complete(PUBLISHED)
        self.journal.advance(ROLLBACK)
        return self._stage_rollback()

    # ---- stage: rollback ----
    def _stage_rollback(self) -> Dict[str, Any]:
        # spanned HERE, not in _advance: probation outcomes trigger
        # rollback from record_outcome/check_probation_timeout too, and
        # every entry path must land on the timeline
        with span("controller.stage", cat="controller", stage=ROLLBACK,
                  cycle=self.journal.cycle):
            return self._rollback_locked()

    def _rollback_locked(self) -> Dict[str, Any]:
        jr = self.journal
        fault_point("rollback")
        champion = jr["champion_version"]
        try:
            self.registry.pin_version(self.model_name, champion)
        except ValueError:
            # the rollback target is GONE (an operator GC retired the
            # journaled champion mid-cycle — retire() only knows the
            # pin/serving versions, not a journal's).  There is nothing
            # to roll back TO; wedging here would re-raise on every
            # resume forever.  Un-pin so serving resolves the newest
            # intact version and close the cycle honestly as abandoned.
            self.counters.increment("Controller", "RollbackTargetMissing")
            self.registry.clear_pin(self.model_name)
            self._reload_fleet()
            warnings.warn(
                f"retrain cycle {jr.cycle}: rollback target v{champion} "
                f"no longer exists in the registry (retired by an "
                f"external GC?); serving stays on the newest intact "
                f"version — run GC between cycles, not during probation",
                RuntimeWarning)
            return self._abandon(f"rollback target v{champion} missing")
        self._reload_fleet()
        if not self._wait_converged(champion):
            self.counters.increment("Controller", "SwapAckTimeouts")
        self.counters.increment("Controller", "Rollbacks")
        instant("controller.decision", cat="controller", action="rollback",
                cycle=jr.cycle, champion_version=champion,
                candidate_version=jr["candidate_version"])
        warnings.warn(
            f"retrain cycle {jr.cycle}: candidate v"
            f"{jr['candidate_version']} rolled back to champion "
            f"v{champion} (live accuracy under the probation floor)",
            RuntimeWarning)
        return self._complete(ROLLED_BACK)

    # ---- terminal ----
    def _abandon(self, reason: str) -> Dict[str, Any]:
        self.counters.increment("Controller", "Abandoned")
        warnings.warn(f"retrain cycle {self.journal.cycle} abandoned: "
                      f"{reason}; champion untouched", RuntimeWarning)
        return self._complete(ABANDONED)

    def _complete(self, outcome: str) -> Dict[str, Any]:
        jr = self.journal
        self._teardown_canary()   # no-op unless a canary is still live
        cycle_dir = jr.cycle_dir()
        jr.close_cycle(outcome)
        self._last_cycle_end = time.monotonic()
        # the cycle's working set (checkpoints + candidate payload) is
        # dead weight once the outcome journaled; dropping it bounds the
        # state dir at one in-flight cycle (the journal keeps the
        # bounded history)
        shutil.rmtree(cycle_dir, ignore_errors=True)
        if self.policy.retire_keep_last > 0:
            retired = self.registry.retire(
                self.model_name, keep_last=self.policy.retire_keep_last)
            if retired:
                self.counters.increment("Controller", "VersionsRetired",
                                        len(retired))
        instant("controller.decision", cat="controller",
                action="cycle_end", cycle=jr.cycle, outcome=outcome,
                candidate_version=jr["candidate_version"],
                champion_version=jr["champion_version"])
        return {"cycle": jr.cycle, "outcome": outcome,
                "champion_version": jr["champion_version"],
                "candidate_version": jr["candidate_version"],
                "champion_accuracy": jr["champion_accuracy"],
                "candidate_accuracy": jr["candidate_accuracy"]}


# --------------------------------------------------------------------------
# shared scoring helpers
# --------------------------------------------------------------------------

def predict_outcomes(models, schema, table):
    """(predicted_labels, actual_labels) for a labeled table — THE one
    ensemble-predict + class-code decode used by validation, and by the
    CLI job's probation replay (one label convention: ambiguous/veto
    predictions and unknown actual codes both become '', which the
    binary ConfusionMatrix scores as not-that-class)."""
    from ..models.forest import EnsembleModel
    from ..models.tree import DecisionTreeModel
    ens = EnsembleModel(
        [DecisionTreeModel(pl, schema) for pl in models],
        require_odd=len(models) % 2 == 1)
    labels = [lab or "" for lab in ens.predict(table)]
    card = list(schema.class_attr_field.cardinality or [])
    actual = [card[c] if c >= 0 else "" for c in table.class_codes()]
    return labels, actual


def accuracy_pct(pred_labels, actual_labels, *, neg_class: str,
                 pos_class: str) -> int:
    """Integer-percent accuracy through the real delayed-label machinery:
    one AccuracyTracker window over a capture policy whose alert bar sits
    above 100, so the quality AlertRecord ALWAYS fires and its ``value``
    IS the ConfusionMatrix accuracy — validation and probation score
    through the identical path the live monitor alerts on."""
    import logging
    if not len(pred_labels):
        return 0
    policy = DriftPolicy(consecutive=1, accuracy_alert=101,
                         counters=Counters())
    # the always-firing capture alert is a measurement, not a finding:
    # route it to a silenced logger so every validation does not print a
    # fake "drift alert" line into the operator log
    probe_log = logging.getLogger(
        "avenir_tpu_torch.control._accuracy_probe")
    if not probe_log.handlers:
        probe_log.addHandler(logging.NullHandler())
        probe_log.propagate = False
    policy._log = probe_log
    tracker = AccuracyTracker(pos_class=pos_class, neg_class=neg_class,
                              policy=policy, window=len(pred_labels))
    recs = tracker.record(list(pred_labels), list(actual_labels))
    return int(recs[-1].value)


def _drift_norm(baseline, table) -> float:
    """Worst normalized drift statistic of one window vs one baseline:
    max over applicable (row, stat) of value / alert threshold — 1.0 ==
    'exactly at the alert bar'.  The validation re-score: a candidate
    whose OWN baseline still alerts on the fresh window did not fix the
    drift it was trained for."""
    from ..monitor.drift import STATS, DriftScorer
    report = DriftScorer(baseline).score_table(table)
    worst = 0.0
    for row in report.rows:
        for stat in STATS:
            if row.applicable(stat):
                worst = max(worst, row.stats[stat] / DEFAULT_ALERT[stat])
    return worst


def _models_sha(models) -> str:
    h = hashlib.sha256()
    for m in models:
        h.update(m.to_json().encode())
    return h.hexdigest()
