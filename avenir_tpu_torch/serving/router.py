"""Multi-model, multi-tenant routing over co-resident PredictionServices:
port of ``avenir_tpu/serving/router.py``.

One :class:`ModelRouter` holds N **resident** registry models — several
families and several versions, each behind its own
:class:`~avenir_tpu_torch.serving.service.PredictionService` with its own
warm bucketed predictor (the quantized sidecar riding per model) — and
routes each request by the optional wire field ``m=<model[:version]>``
(``telemetry/reqtrace.parse_model``; absent = the default model, byte for
byte what a single-model service answers).  The native data plane never
routes: a well-formed ``m=`` token hands the whole batch to the Python
plane.

Per-tenant isolation:

  * **admission** — each resident gets its own ``BatchPolicy`` copy with a
    per-model queue depth (``ps.model.<name>.queue.max.depth``, defaulting
    to ``ps.queue.max.depth``): a noisy tenant is answered ``busy`` at ITS
    depth while quiet tenants keep their full budget.
  * **observability** — every sub-service binds ``model``-labelled metric
    series, counts land in the shared Counters under ``Model/<name>/...``,
    and ``model_queue_depths()`` feeds the autoscaler's per-model sensing.

Deployment policies as routing rules:

  * **canary** (:meth:`ModelRouter.install_canary`) — a deterministic
    per-request-id x% split (``canary_split``: crc32(rid) % 100 < percent)
    routes to a candidate version; everyone else stays on the champion.
    Every worker, every plane and the judging controller derive the same
    assignment from the id alone.  Outcomes recorded through
    :meth:`ModelRouter.record_canary_outcome` feed one
    :class:`~avenir_tpu_torch.monitor.policy.AccuracyTracker` per arm, and
    the per-arm series are scrape-observable (``avenir_canary``).
  * **shadow** (:meth:`ModelRouter.install_shadow`) — the candidate scores
    every request for its model, its replies are discarded (the champion
    answers the wire), and label divergence is counted
    (``Model/<name>/ShadowDivergence``).

Each resident sits on the worker's placement (``device`` or
``serve_mesh``); the JAX package's cross-model executable sharing
(``shared_cores``) is a compile cache with no counterpart here.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.metrics import Counters
from ..telemetry import instant
from ..utils.tracing import StepTimer
from .predictor import DEFAULT_BUCKETS, make_predictor
from .service import BatchPolicy, PredictionService

UNKNOWN_MODEL_LABEL = "error"


def parse_model_spec(spec) -> Tuple[str, Optional[int]]:
    """``"name"`` / ``"name:3"`` / ``(name, version)`` -> (name, ver)."""
    if isinstance(spec, (tuple, list)):
        name, ver = spec
        return str(name), (None if ver is None else int(ver))
    spec = str(spec)
    if ":" in spec:
        name, _, ver = spec.rpartition(":")
        return name, int(ver)
    return spec, None


def canary_bucket(rid) -> int:
    """The deterministic 0..99 split bucket for a request id.  crc32 —
    stable across processes, platforms and python hash randomization —
    so every worker AND the judging controller agree on the assignment
    from the id alone."""
    return zlib.crc32(str(rid).encode("utf-8")) % 100


def canary_split(rid, percent: int) -> bool:
    """True when ``rid`` belongs to the canary arm at ``percent``%."""
    return canary_bucket(rid) < int(percent)


def _probe_tracker(pos_class: str, neg_class: str, window: int):
    """An AccuracyTracker whose capture policy ALWAYS fires (alert bar
    above 100, silenced logger) — the controller's accuracy_pct shape:
    a measurement probe, not a finding."""
    import logging

    from ..monitor.policy import AccuracyTracker, DriftPolicy
    policy = DriftPolicy(consecutive=1, accuracy_alert=101,
                         counters=Counters())
    probe_log = logging.getLogger("avenir_tpu_torch.serving._canary_probe")
    if not probe_log.handlers:
        probe_log.addHandler(logging.NullHandler())
        probe_log.propagate = False
    policy._log = probe_log
    return AccuracyTracker(pos_class=pos_class, neg_class=neg_class,
                           policy=policy, window=window)


class _Canary:
    """Live canary state for one model name."""

    __slots__ = ("service", "version", "percent", "trackers", "accuracy",
                 "outcomes", "correct")

    def __init__(self, service: PredictionService, version: Optional[int],
                 percent: int, trackers: Dict[str, object]):
        self.service = service
        self.version = version
        self.percent = int(percent)
        # arm -> AccuracyTracker (or None when no pos/neg classes given)
        self.trackers = trackers
        # arm -> last closed-window accuracy pct (None until one closes)
        self.accuracy: Dict[str, Optional[int]] = {"champion": None,
                                                   "candidate": None}
        self.outcomes: Dict[str, int] = {"champion": 0, "candidate": 0}
        self.correct: Dict[str, int] = {"champion": 0, "candidate": 0}


class _Shadow:
    __slots__ = ("service", "version")

    def __init__(self, service: PredictionService, version: Optional[int]):
        self.service = service
        self.version = version


class ModelRouter:
    """N resident models behind one PredictionService-shaped surface.

    Duck-types the service verbs the fleet drain, the autoscaler and the
    controller link already speak (``submit`` / ``stats`` / ``refresh``
    / ``mark_degraded`` / ``start`` / ``stop`` / ``policy`` / ``timer``
    / ``counters`` / ``version`` / ``degraded``), plus the routed entry
    :meth:`submit_routed` for requests carrying a wire ``m=`` tag."""

    def __init__(self, registry, models: Sequence, *,
                 default_model: Optional[str] = None,
                 policy: Optional[BatchPolicy] = None,
                 model_depths: Optional[Dict[str, int]] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 counters: Optional[Counters] = None,
                 timer: Optional[StepTimer] = None,
                 warm: bool = True,
                 delim: str = ",",
                 name: Optional[str] = None,
                 host_label: Optional[str] = None,
                 metrics=None,
                 latency_window: int = 8192,
                 quantized: bool = False,
                 wire_native: str = "auto",
                 device=None,
                 serve_mesh=None,
                 own_stream: bool = True):
        if not models:
            raise ValueError("ModelRouter needs at least one resident "
                             "model spec")
        self.registry = registry
        self.policy = policy or BatchPolicy()
        self.delim = delim
        self.name = name
        self.host_label = host_label
        self.counters = counters if counters is not None else Counters()
        self._buckets = tuple(buckets)
        self._warm = warm
        self._metrics = metrics
        self._latency_window = int(latency_window)
        self._quantized = bool(quantized)
        self._wire_native = wire_native
        self._own_stream = bool(own_stream)
        # one placement for every resident: a router is one worker, its
        # residents share the worker's device or mesh
        self._device = device
        self._serve_mesh = serve_mesh
        self._depths = dict(model_depths or {})
        self._lock = threading.Lock()
        # model name -> resident services for that name, spec order
        # (first one is the name's default — usually the
        # follow-the-registry resident)
        self._residents: Dict[str, List[PredictionService]] = {}
        self._order: List[PredictionService] = []
        self._canaries: Dict[str, _Canary] = {}
        self._shadows: Dict[str, _Shadow] = {}
        self._canary_binding = None
        specs = [parse_model_spec(s) for s in models]
        for mname, ver in specs:
            svc = self._make_resident(mname, ver)
            self._residents.setdefault(mname, []).append(svc)
            self._order.append(svc)
        default_model = default_model or specs[0][0]
        if default_model not in self._residents:
            raise ValueError(f"default model {default_model!r} is not in "
                             f"the resident set {sorted(self._residents)}")
        self.default_model = default_model
        self._default = self._residents[default_model][0]
        if metrics is not None:
            self._bind_canary_metrics(metrics)

    # ---- residents ----
    def _sub_policy(self, mname: str) -> BatchPolicy:
        """The model's own admission policy: the shared BatchPolicy with
        a per-model queue depth (ps.model.<name>.queue.max.depth,
        defaulting to the fleet-wide ps.queue.max.depth) — the tenant
        isolation boundary."""
        depth = int(self._depths.get(mname,
                                     self.policy.max_queue_depth) or 0)
        return dataclasses.replace(self.policy, max_queue_depth=depth)

    def _make_resident(self, mname: str, ver: Optional[int],
                       sub: str = "") -> PredictionService:
        base = f"{self.name}.{mname}" if self.name else mname
        if ver is not None:
            base = f"{base}:{ver}"
        common = dict(policy=self._sub_policy(mname), warm=self._warm,
                      delim=self.delim, name=base + sub,
                      host_label=self.host_label, model_label=mname,
                      counters=self.counters,
                      timer=StepTimer(keep_samples=self._latency_window),
                      metrics=self._metrics,
                      wire_native=self._wire_native,
                      own_stream=self._own_stream)
        if ver is None:
            # follow the registry's serving version (hot-swap refresh
            # converges this resident like any single-model service)
            return PredictionService(
                registry=self.registry, model_name=mname,
                buckets=self._buckets, quantized=self._quantized,
                device=self._device, serve_mesh=self._serve_mesh,
                **common)
        # version-pinned resident: fixed predictor, refresh is a no-op
        svc = PredictionService(self._pinned_predictor(mname, ver),
                                **common)
        svc.version = ver
        svc.model_name = mname
        return svc

    def _pinned_predictor(self, mname: str, ver: int):
        """A fixed predictor of ``mname`` v``ver`` on the worker's
        placement."""
        return make_predictor(self.registry.load(mname, ver),
                              buckets=self._buckets, delim=self.delim,
                              quantized=self._quantized,
                              device=self._device,
                              serve_mesh=self._serve_mesh)

    def models(self) -> List[str]:
        """Resident model names, spec order."""
        return list(self._residents)

    def _resolve(self, tag) -> Optional[PredictionService]:
        if tag is None:
            return self._default
        mname, ver = tag
        svcs = self._residents.get(mname)
        if not svcs:
            return None
        if ver is None:
            return svcs[0]
        for s in svcs:
            if s.version == ver:
                return s
        return None

    # ---- request entries ----
    def submit(self, row, trace=None, sample_local: bool = True):
        """Unrouted submit: the default model (the single-model wire
        contract for requests carrying no ``m=`` field)."""
        return self.submit_routed(row, trace=trace,
                                  sample_local=sample_local)

    def submit_routed(self, row, rid=None, model_tag=None, trace=None,
                      sample_local: bool = True):
        """Route one request: resolve the ``m=`` tag (None = default
        model), apply the model's canary split and shadow policy, submit
        to the owning sub-service (whose OWN admission depth answers
        ``busy``).  An unknown tag resolves to an immediately-answered
        ``error`` future plus ``Serving/UnknownModel`` — never a
        silently mis-routed prediction."""
        svc = self._resolve(model_tag)
        if svc is None:
            from concurrent.futures import Future
            self.counters.increment("Serving", "UnknownModel")
            tag = model_tag[0] if model_tag else "?"
            instant("serve.unknown_model", cat="serving", model=tag)
            fut: "Future[str]" = Future()
            fut.set_result(self.error_label)
            return fut
        mname = svc.model_label or self.default_model
        self.counters.increment("Model", f"{mname}/Requests")
        can = self._canaries.get(mname)
        if can is not None and rid is not None \
                and canary_split(rid, can.percent):
            self.counters.increment("Model", f"{mname}/CanaryRequests")
            svc = can.service
        fut = svc.submit(row, trace=trace, sample_local=sample_local)
        if fut.done():
            # admission rejects (and late sheds) resolve synchronously:
            # attribute them to the tenant as well as the aggregate
            try:
                if fut.result(timeout=0) == svc.busy_label:
                    self.counters.increment("Model", f"{mname}/Rejected")
                    instant("serve.rejected", cat="serving", model=mname)
            except Exception:
                pass
        sh = self._shadows.get(mname)
        if sh is not None and svc is not can_service(can):
            self._shadow_score(sh, mname, row, fut)
        return fut

    def _shadow_score(self, sh: _Shadow, mname: str, row, champ_fut):
        """Submit a copy to the shadow candidate; its reply is DISCARDED
        (the champion answers the wire), divergence from the champion's
        label is counted once both resolve."""
        shadow_fut = sh.service.submit(list(row), trace=None,
                                       sample_local=False)

        def when_shadow(sf):
            # chain (not two callbacks racing on "both done"): the
            # comparison runs exactly once, after both resolved
            def when_champ(cf):
                try:
                    a = cf.result(timeout=0)
                    b = sf.result(timeout=0)
                except Exception:
                    return
                self.counters.increment("Model",
                                        f"{mname}/ShadowRequests")
                if a != b:
                    self.counters.increment(
                        "Model", f"{mname}/ShadowDivergence")
            champ_fut.add_done_callback(when_champ)
        shadow_fut.add_done_callback(when_shadow)

    # ---- deployment policies ----
    def install_canary(self, mname: str, version: Optional[int] = None,
                       percent: int = 10,
                       predictor=None,
                       pos_class: Optional[str] = None,
                       neg_class: Optional[str] = None,
                       window: int = 32) -> None:
        """Start canarying ``mname``: a deterministic ``percent``% of its
        requests (by request id) route to the candidate — ``version``
        from the registry, or an explicit ``predictor`` (the retrain
        controller hands its just-built candidate directly, pre-publish).
        With ``pos_class``/``neg_class`` given, one AccuracyTracker per
        arm judges outcomes recorded via :meth:`record_canary_outcome`."""
        if mname not in self._residents:
            raise ValueError(f"model {mname!r} is not resident")
        if not 0 <= int(percent) <= 100:
            raise ValueError(f"canary percent must be 0..100, "
                             f"got {percent}")
        if predictor is None:
            if version is None:
                raise ValueError("install_canary needs version= or "
                                 "predictor=")
            predictor = self._pinned_predictor(mname, version)
        base = f"{self.name}.{mname}" if self.name else mname
        svc = PredictionService(
            predictor, policy=self._sub_policy(mname), warm=self._warm,
            delim=self.delim, name=f"{base}.canary",
            host_label=self.host_label, model_label=mname,
            counters=self.counters,
            timer=StepTimer(keep_samples=self._latency_window),
            metrics=self._metrics, wire_native=self._wire_native,
            own_stream=self._own_stream)
        svc.version = version
        svc.start()
        trackers = {"champion": None, "candidate": None}
        if pos_class is not None and neg_class is not None:
            trackers = {
                arm: _probe_tracker(pos_class, neg_class, window)
                for arm in ("champion", "candidate")}
        with self._lock:
            old = self._canaries.get(mname)
            self._canaries[mname] = _Canary(svc, version, percent,
                                            trackers)
        if old is not None:
            old.service.stop(drain_s=1.0)

    def clear_canary(self, mname: str) -> Optional[_Canary]:
        """End ``mname``'s canary (champion takes 100% again).  Returns
        the retired state (final per-arm accuracy/outcome counts)."""
        with self._lock:
            can = self._canaries.pop(mname, None)
        if can is not None:
            can.service.stop(drain_s=1.0)
        return can

    def record_canary_outcome(self, mname: str, rid, predicted: str,
                              actual: str) -> Optional[str]:
        """Attribute one delayed-label outcome to its canary arm — the
        SAME deterministic split that routed the request re-derives the
        arm from the id — and fold it into that arm's AccuracyTracker
        window.  Returns the arm, or None when no canary is live."""
        can = self._canaries.get(mname)
        if can is None:
            return None
        arm = "candidate" if canary_split(rid, can.percent) \
            else "champion"
        can.outcomes[arm] += 1
        if predicted == actual:
            can.correct[arm] += 1
        tracker = can.trackers.get(arm)
        if tracker is not None:
            recs = tracker.record([predicted], [actual])
            if recs:
                can.accuracy[arm] = int(recs[-1].value)
        return arm

    def canary_state(self, mname: str) -> Optional[Dict]:
        """Scrape-shaped snapshot of a live canary: per-arm outcome
        counts, running accuracy, last closed AccuracyTracker window."""
        can = self._canaries.get(mname)
        if can is None:
            return None
        out = {"version": can.version, "percent": can.percent, "arms": {}}
        for arm in ("champion", "candidate"):
            n = can.outcomes[arm]
            out["arms"][arm] = {
                "outcomes": n,
                "correct": can.correct[arm],
                "running_accuracy":
                    (100.0 * can.correct[arm] / n) if n else None,
                "window_accuracy": can.accuracy[arm],
            }
        return out

    def install_shadow(self, mname: str,
                       version: Optional[int] = None,
                       predictor=None) -> None:
        """Shadow a candidate behind ``mname``: every request for the
        model also scores on the candidate; replies come ONLY from the
        champion, divergence is counted."""
        if mname not in self._residents:
            raise ValueError(f"model {mname!r} is not resident")
        if predictor is None:
            if version is None:
                raise ValueError("install_shadow needs version= or "
                                 "predictor=")
            predictor = self._pinned_predictor(mname, version)
        base = f"{self.name}.{mname}" if self.name else mname
        svc = PredictionService(
            predictor, policy=self._sub_policy(mname), warm=self._warm,
            delim=self.delim, name=f"{base}.shadow",
            host_label=self.host_label, model_label=mname,
            counters=self.counters,
            timer=StepTimer(keep_samples=self._latency_window),
            metrics=self._metrics, wire_native=self._wire_native,
            own_stream=self._own_stream)
        svc.version = version
        svc.start()
        with self._lock:
            old = self._shadows.get(mname)
            self._shadows[mname] = _Shadow(svc, version)
        if old is not None:
            old.service.stop(drain_s=1.0)

    def clear_shadow(self, mname: str) -> None:
        with self._lock:
            sh = self._shadows.pop(mname, None)
        if sh is not None:
            sh.service.stop(drain_s=1.0)

    # ---- canary scrape series ----
    def _bind_canary_metrics(self, registry) -> None:
        g = registry.gauge(
            "avenir_canary",
            "per-arm canary deployment state (accuracy pct, outcome "
            "counts, split percent)",
            labels=("host", "model", "arm", "key"))
        host = self.host_label or ""

        def probe():
            for mname in list(self._canaries):
                st = self.canary_state(mname)
                if st is None:
                    continue
                for arm, a in st["arms"].items():
                    g.set(a["outcomes"], host=host, model=mname,
                          arm=arm, key="outcomes")
                    if a["running_accuracy"] is not None:
                        g.set(a["running_accuracy"], host=host,
                              model=mname, arm=arm, key="accuracy")
                    if a["window_accuracy"] is not None:
                        g.set(a["window_accuracy"], host=host,
                              model=mname, arm=arm,
                              key="window_accuracy")
                g.set(st["percent"], host=host, model=mname,
                      arm="candidate", key="percent")
        registry.register_probe(probe)
        self._canary_binding = (registry, probe, g)

    # ---- service-shaped surface (fleet/autoscaler/controller verbs) ----
    @property
    def version(self) -> Optional[int]:
        return self._default.version

    @property
    def model_name(self) -> Optional[str]:
        return self.default_model

    @property
    def degraded(self) -> Optional[str]:
        return self._default.degraded

    @property
    def error_label(self) -> str:
        return self._default.error_label

    @property
    def busy_label(self) -> str:
        return self._default.busy_label

    @property
    def late_label(self) -> str:
        return self._default.late_label

    def record_request_trace(self, ctx) -> None:
        """Close one sampled wire request's trace (fleet flush calls
        this after the reply pushed).  The default resident owns the
        component histograms — routed requests' spans already carry
        their model label from the serving service itself."""
        self._default.record_request_trace(ctx)

    @property
    def timer(self) -> StepTimer:
        """One merged StepTimer over every resident's samples — built on
        read (stats callers, the autoscaler's p99 sense).  ``calls`` are
        SUMMED from the sub-timers so staleness checks see a monotonic
        count even when the bounded sample windows are full."""
        merged = StepTimer(keep_samples=self._latency_window
                           * max(1, len(self._order)))
        for svc in self._all_services():
            for sname, dq in list(svc.timer.samples.items()):
                for _ in range(3):
                    try:
                        samples = list(dq)
                        break
                    except RuntimeError:
                        continue
                else:
                    samples = []
                for s in samples:
                    merged.record(sname, s)
        totals: Dict[str, float] = {}
        calls: Dict[str, int] = {}
        for svc in self._all_services():
            for sname, c in svc.timer.calls.items():
                calls[sname] = calls.get(sname, 0) + c
            for sname, t in svc.timer.totals.items():
                totals[sname] = totals.get(sname, 0.0) + t
        merged.calls.update(calls)
        merged.totals.update(totals)
        return merged

    def model_timers(self) -> Dict[str, StepTimer]:
        """model name -> that resident's own StepTimer (per-tenant
        p99)."""
        return {mname: svcs[0].timer
                for mname, svcs in self._residents.items()}

    def _all_services(self) -> List[PredictionService]:
        with self._lock:
            extra = [c.service for c in self._canaries.values()] \
                + [s.service for s in self._shadows.values()]
        return self._order + extra

    def model_queue_depths(self) -> Dict[str, int]:
        """model name -> queued-request depth (summed over that name's
        residents) — the autoscaler's per-tenant pressure sensor."""
        out: Dict[str, int] = {}
        for mname, svcs in self._residents.items():
            out[mname] = sum(s.stats()["queue_depth"] for s in svcs)
        return out

    def stats(self) -> Dict:
        """Aggregate snapshot in the PredictionService shape (the fleet
        sums these keys across workers) plus a ``per_model`` breakdown
        keyed by model name."""
        per = {}
        for mname, svcs in self._residents.items():
            st = {"queue_depth": 0, "in_flight": 0, "model_version": None}
            for s in svcs:
                ss = s.stats()
                st["queue_depth"] += ss["queue_depth"]
                st["in_flight"] += ss["in_flight"]
            st["model_version"] = svcs[0].version
            st["requests"] = self.counters.get("Model", f"{mname}/Requests")
            st["rejected"] = self.counters.get("Model", f"{mname}/Rejected")
            per[mname] = st
        return {
            "queue_depth": sum(p["queue_depth"] for p in per.values()),
            "in_flight": sum(p["in_flight"] for p in per.values()),
            "served": self.counters.get("Serving", "Requests"),
            "errors": self.counters.get("Serving", "BadRequests"),
            "batches": self.counters.get("Serving", "Batches"),
            "hot_swaps": self.counters.get("Serving", "HotSwaps"),
            "rejected": self.counters.get("Serving", "Rejected"),
            "window_ms": self._default._adaptive_wait_ms,
            "degraded": self.degraded,
            "model_version": self.version,
            "host": self.host_label or "",
            "model": self.default_model,
            "models": list(self._residents),
            "per_model": per,
        }

    def refresh(self) -> bool:
        """Converge every follow-the-registry resident onto its model's
        serving version (version-pinned residents stay pinned).  Returns
        whether ANY resident swapped."""
        swapped = False
        for svc in self._order:
            try:
                swapped = bool(svc.refresh()) or swapped
            except Exception:
                raise
        return swapped

    def mark_degraded(self, reason: str) -> None:
        for svc in self._order:
            svc.mark_degraded(reason)

    def start(self) -> "ModelRouter":
        for svc in self._all_services():
            svc.start()
        return self

    def stop(self, drain_s: float = 5.0) -> None:
        if self._canary_binding is not None:
            registry, probe, g = self._canary_binding
            self._canary_binding = None
            registry.unregister_probe(probe)
        for svc in self._all_services():
            svc.stop(drain_s=drain_s)


def can_service(can: Optional[_Canary]):
    """The canary's candidate service, or None — so identity checks
    against "the service that answered" read cleanly at the call site."""
    return can.service if can is not None else None
