"""The serving fleet: N workers draining ONE RESP queue (or a ring of
broker shards); port of ``avenir_tpu/serving/fleet.py``.

The tier above :class:`~avenir_tpu_torch.serving.service.PredictionService`
(the reference avenir's Storm topology role: many workers drain one
request queue).  Each worker owns:

  * its OWN :class:`PredictionService` (continuous or drain batching per
    the shared :class:`BatchPolicy`) with its own warm bucketed predictor
    built from the SHARED model registry, and its own CUDA stream
    (``service.py``): a worker's read-back waits for its own launches
    only;
  * its own queue client draining the request queue with pipelined
    ``rpop_many`` and parking on ``brpop`` when idle;
  * its own metrics identity (``<model>-w<i>``): per-worker labelled
    gauges and a per-worker ``/healthz/<name>`` target.

Fleet-level semantics:

  * **coordinated hot-swap** — a ``reload`` seen by ANY worker bumps one
    shared generation counter; every worker refreshes off the registry at
    its next poll (a delta patches only that worker's predictor), so the
    fleet converges to the serving version; in-flight batches finish on
    the model they started on.
  * **degraded parking** — a worker whose service was ``mark_degraded``
    stops pulling while a healthy unparked peer keeps draining: it answers
    what it accepted, then parks until a hot-swap clears the flag.  Its
    ``/healthz/<name>`` answers 503.  The last active worker never parks.
  * **admission control** — the bounded service queue is the admission
    point: a submit past ``policy.max_queue_depth`` resolves ``busy`` and
    the worker answers ``<id>,busy``.  Every popped request is answered
    with something (a class, ``error`` or ``busy``).
  * **horizontal tier** — ``redis.server.endpoints`` listing M broker
    shards makes every worker drain a
    :class:`~avenir_tpu_torch.io.respq.ShardedRespClient` ring (a dead
    shard lands as ``Broker/BrokerShardDown`` in the merged dump);
    ``host_label`` stamps every series and ``stats()``; ``scale_to`` /
    ``add_worker`` are the autoscaler's actuator (parked workers keep
    their warm services; the last worker is never parked).  One fleet per
    OS process: ``python -m avenir_tpu_torch.serving.fleet_host``.

Placement (``device_map``): None = every worker on the process device;
``round_robin`` = worker i on ``parallel.mesh.worker_device(i)``;
``sharded`` = every worker's forest tree-sharded over the runtime
context's mesh (``parallel.mesh.runtime_context``: every visible card, or
the mesh a caller installed).  ``reward_sink`` (online reward intake)
passes to every worker's service; it does not combine with ``models=``.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

from ..core.metrics import Counters
from ..telemetry import reqtrace
from ..utils.tracing import StepTimer
from .predictor import DEFAULT_BUCKETS, Predictor
from .router import ModelRouter, parse_model_spec
from .service import BatchPolicy, PredictionService


class _Worker:
    """One fleet member: service + wire connection + drain thread."""

    __slots__ = ("index", "name", "service", "client", "thread",
                 "seen_gen", "pending", "parked", "down_since", "unsent")

    def __init__(self, index: int, name: str, service: PredictionService):
        self.index = index
        self.name = name
        self.service = service
        self.client = None
        self.thread: Optional[threading.Thread] = None
        self.seen_gen = 0
        # (request_id, future, trace_ctx_or_None) in submit order;
        # service batches complete in order, so FIFO head-flush is
        # completion order
        self.pending: "deque[tuple]" = deque()
        # broker-outage grace: when the WHOLE ring is unreachable the
        # drain parks and retries (down_since starts the grace clock);
        # replies whose push failed mid-outage wait in unsent rather
        # than being dropped
        self.down_since: Optional[float] = None
        self.unsent: List[str] = []
        # autoscaler parking: a parked worker stops PULLING but keeps
        # its warm service (model on the device, buckets warmed) so
        # unparking is instant — distinct from degraded parking (health
        # stays OK)
        self.parked = threading.Event()


class ServingFleet:
    """Run ``n_workers`` PredictionService workers against one RESP
    request queue.  Construct around a shared ``registry`` +
    ``model_name`` (hot-swap enabled) or a ``predictor_factory``
    returning a fresh per-worker :class:`Predictor` (no registry, reload
    is a no-op) — then :meth:`start`, feed the request queue, and
    :meth:`stop` (or push a literal ``stop`` message, which stops every
    worker after the requests already popped are answered)."""

    def __init__(self, registry=None, model_name: Optional[str] = None, *,
                 predictor_factory: Optional[Callable[[], Predictor]] = None,
                 schema=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 policy: Optional[BatchPolicy] = None,
                 n_workers: int = 2,
                 config: Optional[Dict] = None,
                 warm: bool = True,
                 delim: str = ",",
                 metrics=None,
                 latency_window: int = 8192,
                 idle_sleep_s: float = 0.002,
                 max_idle_sleep_s: float = 0.05,
                 broker_grace_s: float = 10.0,
                 quantized: bool = False,
                 host_label: Optional[str] = None,
                 wire_native: str = "auto",
                 models: Optional[Sequence] = None,
                 model_depths: Optional[Dict[str, int]] = None,
                 device_map: Optional[str] = None,
                 reward_sink=None,
                 own_stream: bool = True):
        # multi-model residency: models= lists the resident
        # set ("name" or "name:version" specs); every worker then runs a
        # ModelRouter over N co-resident services instead of one
        # PredictionService, and predict messages carrying the optional
        # wire field m=<name[:version]> route per request.  model_name
        # (or the first spec) is the default model — requests without an
        # m= field serve it byte for byte as a single-model fleet would.
        self.models_spec = list(models) if models else None
        self._model_depths = dict(model_depths or {})
        # timing-only: False launches every worker on the card's current
        # stream instead of a stream of its own
        self._own_stream = bool(own_stream)
        if self.models_spec:
            if registry is None:
                raise ValueError("models= needs registry=")
            if model_name is None:
                model_name = parse_model_spec(self.models_spec[0])[0]
        elif predictor_factory is None and (registry is None
                                            or model_name is None):
            raise ValueError("need registry= + model_name=, or "
                             "predictor_factory=")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        cfg = dict(config or {})
        self.registry = registry
        self.model_name = model_name
        self.predictor_factory = predictor_factory
        self._schema = schema
        self._buckets = tuple(buckets)
        self.policy = policy or BatchPolicy()
        self.n_workers = int(n_workers)
        self._warm = warm
        self.delim = delim
        self._metrics = metrics
        self._quantized = bool(quantized)
        # ps.wire.native: every worker service shares one mode (the
        # native batch assembler is per-service state; the mode is
        # config) — fleet _ingest keeps its python parse, the codec
        # rides inside each worker's process_batch
        self._wire_native = wire_native
        # online reward intake: every worker's service hands
        # ``reward,<id>,<v>`` rows to the sink
        if reward_sink is not None and models:
            raise ValueError("reward_sink= does not combine with models=")
        self._reward_sink = reward_sink
        # device placement (registry-built predictors only: a
        # predictor_factory owns its own placement)
        if device_map not in (None, "round_robin", "sharded"):
            raise ValueError(
                "device_map must be None, 'round_robin' or 'sharded', "
                f"got {device_map!r}")
        if device_map is not None and predictor_factory is not None:
            raise ValueError(
                "device_map= does not combine with predictor_factory= "
                "(the factory owns placement)")
        self.device_map = device_map
        self._latency_window = int(latency_window)
        self.idle_sleep_s = float(idle_sleep_s)
        self.max_idle_sleep_s = float(max_idle_sleep_s)
        # total-ring-loss grace: a kill-and-restart drill routinely
        # leaves EVERY shard unreachable for a beat (the replacement is
        # still binding / replaying its journal), and the sharded
        # client recovers on its own once one comes back — so a drain
        # thread parks and retries for this long before treating the
        # outage as permanent and exiting
        self.broker_grace_s = float(broker_grace_s)
        self.host = cfg.get("redis.server.host", "127.0.0.1")
        self.port = int(cfg.get("redis.server.port", 6379))
        # the broker ring: with redis.server.endpoints listing M shards
        # every worker drains through a ShardedRespClient (consistent-
        # hash fan-out); single host/port keeps the plain client
        self._wire_cfg = cfg
        self.request_q = cfg.get("redis.request.queue", "requestQueue")
        self.prediction_q = cfg.get("redis.prediction.queue",
                                    "predictionQueue")
        # ps.broker.lease.timeout.s : > 0 switches the drain
        # to leased at-least-once delivery — requests are acquired
        # under a visibility-timeout LEASE and acked by the reply
        # ACKPUSH, so a worker killed mid-batch redelivers instead of
        # stranding its popped requests.  0 (default) keeps the classic
        # destructive rpop/brpop/lpush path, byte for byte.
        self.lease_timeout_s = float(
            cfg.get("redis.lease.timeout.s", 0.0) or 0.0)
        # multi-host identity: labels every worker's metric series and
        # rides stats() so N fleets scraped into one registry stay
        # disjoint (None = single-host, this process's hostname)
        import socket as _socket
        self.host_label = host_label or _socket.gethostname()
        self._reload_gen = 0
        self._stop = threading.Event()
        # set alongside _stop ONLY by a wire 'stop': gates the
        # drain-then-stop ring sweep.  A programmatic stop() means
        # "stop pulling" — it must not start draining the whole broker.
        self._wire_stop = False
        self._scale_lock = threading.Lock()
        self.workers: List[_Worker] = []

    # ---- lifecycle ----
    def _placement(self, index: int) -> Dict:
        """device=/serve_mesh= kwargs for worker ``index`` under the
        fleet's device_map (empty dict = the old default placement)."""
        if self.device_map == "round_robin":
            from ..parallel.mesh import worker_device
            return {"device": worker_device(index)}
        if self.device_map == "sharded":
            from ..parallel.mesh import runtime_context
            return {"serve_mesh": runtime_context().mesh}
        return {}

    def _make_service(self, wname: str, index: int = 0):
        placement = self._placement(index)
        if self.models_spec:
            # one router per worker: N resident models, each with its
            # own warm predictor
            return ModelRouter(self.registry, self.models_spec,
                               default_model=self.model_name,
                               policy=self.policy,
                               model_depths=self._model_depths,
                               buckets=self._buckets,
                               counters=Counters(),
                               warm=self._warm, delim=self.delim,
                               name=wname,
                               host_label=self.host_label,
                               metrics=self._metrics,
                               latency_window=self._latency_window,
                               quantized=self._quantized,
                               wire_native=self._wire_native,
                               own_stream=self._own_stream,
                               **placement)
        common = dict(policy=self.policy, warm=self._warm,
                      delim=self.delim, name=wname,
                      host_label=self.host_label,
                      model_label=self.model_name,
                      counters=Counters(),
                      timer=StepTimer(keep_samples=self._latency_window),
                      metrics=self._metrics,
                      wire_native=self._wire_native,
                      reward_sink=self._reward_sink,
                      own_stream=self._own_stream)
        if self.predictor_factory is not None:
            return PredictionService(self.predictor_factory(), **common)
        return PredictionService(registry=self.registry,
                                 model_name=self.model_name,
                                 schema=self._schema,
                                 buckets=self._buckets,
                                 quantized=self._quantized,
                                 **placement, **common)

    def _make_client(self, counters=None):
        from ..io.respq import make_queue_client
        cfg = dict(self._wire_cfg)
        cfg.setdefault("redis.server.host", self.host)
        cfg.setdefault("redis.server.port", self.port)
        # the worker's counters ride into the sharded client so a dead
        # broker shard lands as Broker/BrokerShardDown in the fleet's
        # merged dump
        return make_queue_client(cfg, delim=self.delim, counters=counters)

    def start(self) -> "ServingFleet":
        if self.workers:
            return self
        self._stop.clear()
        base = self.model_name or "fleet"
        for i in range(self.n_workers):
            wname = f"{base}-w{i}"
            w = _Worker(i, wname, self._make_service(wname, i))
            w.service.start()
            w.client = self._make_client(w.service.counters)
            self.workers.append(w)
        # connect everything before pulling: a worker that starts draining
        # while a peer is still warming would skew the first measurements
        for w in self.workers:
            w.thread = threading.Thread(target=self._drain, args=(w,),
                                        daemon=True,
                                        name=f"avenir-fleet-{w.name}")
            w.thread.start()
        return self

    # ---- the autoscaler's actuator surface ----
    def _add_worker_locked(self) -> "_Worker":
        i = len(self.workers)
        wname = f"{self.model_name or 'fleet'}-w{i}"
        w = _Worker(i, wname, self._make_service(wname, i))
        w.service.start()
        w.client = self._make_client(w.service.counters)
        self.workers.append(w)
        w.thread = threading.Thread(target=self._drain, args=(w,),
                                    daemon=True,
                                    name=f"avenir-fleet-{w.name}")
        w.thread.start()
        return w

    def add_worker(self) -> "_Worker":
        """Grow the fleet by one live worker mid-run (warm-started: the
        service warms its buckets before the drain thread pulls)."""
        with self._scale_lock:
            return self._add_worker_locked()

    def active_workers(self) -> int:
        return sum(1 for w in self.workers if not w.parked.is_set())

    def scale_to(self, n: int) -> int:
        """Set the ACTIVE (pulling) worker count — the autoscaler's
        actuator.  Scale-up unparks before it adds: a parked worker
        keeps its warm predictor (service thread and device model stay
        resident), so re-admitting it is repointing traffic, not a cold
        start.  Scale-down parks the tail workers (they flush everything
        already accepted first — parking never drops a request).  Never
        parks the last worker.  Returns the new active count."""
        n = max(1, int(n))
        with self._scale_lock:
            if self.workers:
                while len(self.workers) < n:
                    self._add_worker_locked()
            for i, w in enumerate(self.workers):
                if i < n:
                    w.parked.clear()
                else:
                    w.parked.set()
            return self.active_workers()

    def request_reload(self) -> None:
        """Coordinated hot-swap: every worker refreshes from the shared
        registry at its next poll (the caller may be any worker's drain
        thread, or operator code)."""
        self._reload_gen += 1

    # ---- guardrail-action + controller surface ----
    # The monitor's refresh_action/degrade_action (and the retrain
    # controller's fleet link) duck-type against a PredictionService;
    # these three methods give the fleet the same verbs so a policy wired
    # at fleet scope converges ALL workers instead of touching one.
    def refresh(self) -> bool:
        """Fleet-addressed refresh: bump the generation counter so every
        worker (parked ones included — the generation check precedes the
        park check in the drain loop) re-resolves the registry's serving
        version at its next poll.  Returns whether a swap is actually
        due (some worker is off the registry's serving version) — the
        same will-it-swap meaning `PredictionService.refresh` returns,
        so a counter like `DriftMonitor/RefreshSwaps` is not inflated by
        alerts that had nothing to swap to.  The swap itself is
        asynchronous per worker; :meth:`converged_version` is the ack."""
        self.request_reload()
        if self.registry is None or self.model_name is None:
            return False
        target = self.registry.serving_version(self.model_name)
        return target is not None and \
            any(w.service.version != target for w in self.workers)

    def mark_degraded(self, reason: str) -> None:
        """Flag EVERY worker's service degraded (drift-policy guardrail at
        fleet scope).  The parking rules of the drain loop then apply per worker: a
        degraded worker parks only while a healthy unparked peer keeps
        pulling, and the last active worker keeps serving flagged — a
        fleet-wide degrade never stops the fleet answering."""
        for w in self.workers:
            w.service.mark_degraded(reason)

    def converged_version(self) -> Optional[int]:
        """The single model version every worker is serving, or None
        while workers disagree (mid-swap) — the controller's swap-ack:
        poll until this equals the version it published/pinned."""
        versions = {w.service.version for w in self.workers}
        if len(versions) == 1:
            return versions.pop()
        return None

    # ---- multi-model deployment surface ----
    # Present only on a models= fleet (workers are ModelRouters); the
    # retrain controller's canary_validate stage and operator tooling
    # address deployment policies at fleet scope so every worker's
    # router applies the same split.
    def _routers(self) -> List[ModelRouter]:
        return [w.service for w in self.workers
                if isinstance(w.service, ModelRouter)]

    def install_canary(self, mname: str, version: Optional[int] = None,
                       percent: int = 10, **kw) -> None:
        """Canary ``mname`` on EVERY worker: the split is deterministic
        on the request id, so N workers each applying it locally is one
        fleet-wide x% split — no coordination traffic."""
        routers = self._routers()
        if not routers:
            raise ValueError("install_canary needs a models= fleet")
        for r in routers:
            r.install_canary(mname, version=version, percent=percent,
                             **kw)

    def clear_canary(self, mname: str):
        out = None
        for r in self._routers():
            got = r.clear_canary(mname)
            out = out or got
        return out

    def install_shadow(self, mname: str, version: Optional[int] = None,
                       **kw) -> None:
        routers = self._routers()
        if not routers:
            raise ValueError("install_shadow needs a models= fleet")
        for r in routers:
            r.install_shadow(mname, version=version, **kw)

    def clear_shadow(self, mname: str) -> None:
        for r in self._routers():
            r.clear_shadow(mname)

    def record_canary_outcome(self, mname: str, rid, predicted: str,
                              actual: str):
        """Outcome labels land on ONE router's trackers (the first
        worker's) — the arm attribution is re-derived from the id, so
        any router gives the same answer; one series, not N copies."""
        routers = self._routers()
        if not routers:
            return None
        return routers[0].record_canary_outcome(mname, rid, predicted,
                                                actual)

    def canary_state(self, mname: str):
        routers = self._routers()
        return routers[0].canary_state(mname) if routers else None

    def model_queue_depths(self) -> Dict[str, int]:
        """model name -> queued depth summed across workers — the
        autoscaler's per-tenant pressure sensor (empty for a
        single-model fleet)."""
        out: Dict[str, int] = {}
        for r in self._routers():
            for mname, d in r.model_queue_depths().items():
                out[mname] = out.get(mname, 0) + d
        return out

    def wait(self, timeout_s: float = 60.0) -> bool:
        """Block until every drain thread exited (a wire ``stop`` message
        or :meth:`stop` ended the fleet); True when all did."""
        deadline = time.monotonic() + timeout_s
        ok = True
        for w in self.workers:
            if w.thread is not None:
                w.thread.join(timeout=max(0.0, deadline - time.monotonic()))
                ok = ok and not w.thread.is_alive()
        return ok

    def stop(self, drain_s: float = 5.0) -> None:
        """Stop pulling, answer everything already accepted (pending wire
        replies flushed, then each service's queued requests served in
        ``max_batch`` chunks), tear down connections.  Workers stay
        listed for post-run ``stats()``/``merged_counters()`` reads; a
        stopped fleet is not restartable."""
        self._stop.set()
        self.wait(timeout_s=max(drain_s, 0.1) + 30.0)
        for w in self.workers:
            w.service.stop(drain_s=drain_s)
            if w.client is not None:
                try:
                    w.client.close()
                except OSError:
                    pass

    # ---- observability ----
    def stats(self) -> Dict:
        """Aggregate + per-worker snapshot: total served/rejected/errors,
        per-worker model versions (converged after a coordinated
        hot-swap), queue depths, degraded flags."""
        per = {w.name: w.service.stats() for w in self.workers}
        per_model: Dict[str, Dict] = {}
        for s in per.values():
            # multi-model workers (ModelRouter) expose a per_model
            # breakdown; fold the per-tenant numbers across workers
            for mname, ms in (s.get("per_model") or {}).items():
                agg = per_model.setdefault(
                    mname, {"queue_depth": 0, "requests": 0,
                            "rejected": 0, "model_version": None})
                agg["queue_depth"] += ms["queue_depth"]
                agg["requests"] += ms["requests"]
                agg["rejected"] += ms["rejected"]
                agg["model_version"] = ms["model_version"]
        return {
            "host": self.host_label,
            "per_model": per_model,
            "workers": len(self.workers),
            "active_workers": self.active_workers(),
            "parked": {w.name: w.parked.is_set() for w in self.workers},
            "reload_generation": self._reload_gen,
            "served": sum(s["served"] for s in per.values()),
            "rejected": sum(s["rejected"] for s in per.values()),
            "errors": sum(s["errors"] for s in per.values()),
            "queue_depth": sum(s["queue_depth"] for s in per.values()),
            "model_versions": {n: s["model_version"]
                               for n, s in per.items()},
            "per_worker": per,
        }

    def merged_counters(self) -> Counters:
        """One Counters summing every worker's Serving group (the job
        dump view; per-worker splits stay on the metrics registry)."""
        out = Counters()
        for w in self.workers:
            for grp, names in w.service.counters.as_dict().items():
                for n, v in names.items():
                    if n.startswith("Max"):
                        # high-water marks (MaxBatchObserved) merge by
                        # max — summing two workers' 16s would report a
                        # 32-row batch nothing ever served
                        out.max(grp, n, v)
                    else:
                        out.increment(grp, n, v)
        out.set("Serving", "Workers", len(self.workers)
                or self.n_workers)
        return out

    def merged_timer(self) -> StepTimer:
        """One StepTimer holding every worker's latency samples (fleet
        percentiles; per-worker percentiles stay on each service).
        Sized by the LIVE worker count, not the constructed one — an
        autoscaled fleet that grew past n_workers must not evict the
        early workers' samples from the merged window."""
        merged = StepTimer(keep_samples=self._latency_window
                           * max(1, len(self.workers) or self.n_workers))
        for w in self.workers:
            for name, dq in list(w.service.timer.samples.items()):
                # the worker's predict thread appends concurrently; a
                # live-stats caller must not crash on a mutating deque
                for _ in range(3):
                    try:
                        samples = list(dq)
                        break
                    except RuntimeError:
                        continue
                else:
                    samples = []
                for s in samples:
                    merged.record(name, s)
        return merged

    # ---- the drain loop (one thread per worker) ----
    def _drain(self, w: _Worker) -> None:
        svc = w.service
        sleep_s = self.idle_sleep_s
        try:
            while not self._stop.is_set():
                if w.seen_gen != self._reload_gen:
                    w.seen_gen = self._reload_gen
                    try:
                        svc.refresh()
                    except Exception as exc:
                        warnings.warn(
                            f"fleet {w.name}: hot-swap refresh failed "
                            f"({type(exc).__name__}: {exc}); serving "
                            f"stays on version {svc.version}",
                            RuntimeWarning)
                if w.parked.is_set() and \
                        any(not p.parked.is_set() for p in self.workers
                            if p is not w):
                    # autoscaler parking: stop pulling, answer what was
                    # already accepted, keep the warm service resident
                    # for the unpark.  Like degraded parking, never the
                    # last worker (scale_to can't park it, but guard
                    # against racing list mutation anyway).
                    self._flush(w, wait=True)
                    svc.counters.increment("Serving", "ParkedPolls")
                    time.sleep(self.max_idle_sleep_s)
                    continue
                if svc.degraded is not None and \
                        any(p.service.degraded is None
                            and not p.parked.is_set()
                            for p in self.workers if p is not w):
                    # a degraded worker stops pulling WHILE a healthy
                    # UNPARKED peer keeps draining: answer what it
                    # already accepted, then park (a hot-swap clears the
                    # flag via refresh above).  When every other worker
                    # is degraded OR autoscale-parked the last active
                    # one keeps serving (flagged, /healthz 503) —
                    # otherwise a scaled-down fleet whose sole active
                    # worker degrades would have NOBODY pulling (parked
                    # peers wait for an active one, the degraded one
                    # waits for a healthy peer) and the queue would
                    # wedge unanswered, unreachable even by the wire
                    # 'reload' recovery path.
                    self._flush(w, wait=True)
                    svc.counters.increment("Serving", "ParkedPolls")
                    time.sleep(self.max_idle_sleep_s)
                    continue
                try:
                    if self.lease_timeout_s > 0:
                        msgs = w.client.lease_many(self.request_q,
                                                   svc.policy.max_batch,
                                                   self.lease_timeout_s)
                    else:
                        msgs = w.client.rpop_many(self.request_q,
                                                  svc.policy.max_batch)
                except (ConnectionError, OSError, RuntimeError) as exc:
                    # a sharded client degrades around ONE dead shard on
                    # its own; reaching here means the whole broker tier
                    # is unreachable RIGHT NOW — park and retry within
                    # the grace window (a restarting shard rejoins the
                    # ring on a later verb), exit only when it stays gone
                    if self._broker_gone(w, exc):
                        break
                    continue
                w.down_since = None
                svc.counters.increment("Serving", "Polls")
                if msgs:
                    sleep_s = self.idle_sleep_s
                    self._ingest(w, msgs)
                else:
                    svc.counters.increment("Serving", "EmptyPolls")
                    try:
                        self._flush(w, wait=False)
                    except (ConnectionError, OSError,
                            RuntimeError) as exc:
                        if self._broker_gone(w, exc):
                            break
                        continue
                    # park on the server instead of spin-polling; keep
                    # the park short while replies are still pending so
                    # a batch finishing mid-park is flushed promptly
                    park = 0.001 if w.pending else sleep_s
                    try:
                        if self.lease_timeout_s > 0:
                            got = w.client.lease_many(
                                self.request_q, 1, self.lease_timeout_s,
                                block_s=park)
                            v = got[0] if got else None
                        else:
                            v = w.client.brpop(self.request_q,
                                               timeout_s=park)
                    except (ConnectionError, OSError,
                            RuntimeError) as exc:
                        if self._broker_gone(w, exc):
                            break
                        continue
                    w.down_since = None
                    if v is not None:
                        sleep_s = self.idle_sleep_s
                        self._ingest(w, [v])
                    elif not w.pending:
                        sleep_s = min(sleep_s * 2.0, self.max_idle_sleep_s)
                try:
                    self._flush(w, wait=False)
                except (ConnectionError, OSError, RuntimeError) as exc:
                    if self._broker_gone(w, exc):
                        break
            # drain-then-stop: the single-queue FIFO invariant
            # ("everything queued before the stop was already popped")
            # does NOT hold across a shard ring — the stop lands on ONE
            # shard while tail requests sit on others.  Sweep the ring
            # empty before exiting so a WIRE stop never strands
            # accepted traffic (a surplus stop swept up here is
            # re-pushed for its own fleet by _ingest; a programmatic
            # stop() does not sweep — it means "stop pulling").
            if self._wire_stop:
                try:
                    while True:
                        msgs = w.client.rpop_many(self.request_q,
                                                  svc.policy.max_batch)
                        if not msgs:
                            break
                        # requests get answered; surplus stops are
                        # re-pushed for their own fleets by _ingest
                        self._ingest(w, msgs)
                        self._flush(w, wait=False)
                        if all(m == "stop" for m in msgs):
                            break   # only (re-pushed) stops remain —
                            # don't ping-pong with our own re-push
                except (ConnectionError, OSError, RuntimeError) as exc:
                    warnings.warn(
                        f"fleet {w.name}: stop-drain sweep cut short "
                        f"({type(exc).__name__}: {exc})", RuntimeWarning)
        finally:
            # answer everything this worker accepted before it exits —
            # the no-drop guarantee holds through 'stop' and crashes
            try:
                self._flush(w, wait=True)
            except Exception as exc:
                warnings.warn(f"fleet {w.name}: final flush failed "
                              f"({type(exc).__name__}: {exc})",
                              RuntimeWarning)

    def _broker_gone(self, w: _Worker, exc: BaseException) -> bool:
        """Total-ring-loss triage for a drain thread: every broker shard
        is unreachable at this instant.  A kill-and-restart drill passes
        through this state routinely (the replacement shard needs a beat
        to bind and replay its journal) and the sharded client CAN
        recover — its rejoin probe folds a revived shard back into the
        ring on a later verb — so park briefly and retry; only a ring
        that stays empty past ``broker_grace_s`` is a real outage, and
        then the worker exits (answering what it already accepted).
        Returns True when the worker should exit."""
        now = time.monotonic()
        if w.down_since is None:
            w.down_since = now
            warnings.warn(
                f"fleet {w.name}: broker tier unreachable "
                f"({type(exc).__name__}: {exc}); parking to retry for "
                f"up to {self.broker_grace_s:.0f}s", RuntimeWarning)
        w.service.counters.increment("Serving", "BrokerRetries")
        if now - w.down_since >= self.broker_grace_s:
            warnings.warn(
                f"fleet {w.name}: broker unreachable for "
                f"{now - w.down_since:.1f}s ({type(exc).__name__}: "
                f"{exc}); worker exiting", RuntimeWarning)
            return True
        if self._stop.is_set():
            return True   # stopping anyway — don't sit out the grace
        time.sleep(0.05)
        return False

    def _ingest(self, w: _Worker, msgs: List[str]) -> None:
        svc = w.service
        for m in msgs:
            if m == "stop":
                # fleet-wide: peers see the event at their next poll.
                # Everything queued BEFORE the stop was already popped
                # (FIFO) by someone and will be answered.
                if self._stop.is_set():
                    # a SECOND stop drained by this fleet was aimed at
                    # another fleet process (multi-host topologies push
                    # one per host): put it back instead of eating it
                    try:
                        w.client.lpush(self.request_q, "stop")
                    except Exception:
                        pass
                else:
                    self._wire_stop = True
                    self._stop.set()
                continue
            parts = m.split(svc.delim)
            if parts[0] == "reload":
                # 'reload' (unaddressed) swaps THIS fleet;
                # 'reload,<host_label>' is multi-host convergence: one
                # addressed copy per host (ShardedRespClient.broadcast
                # alone cannot converge N hosts — one host's workers,
                # parked across every shard, can pop all the copies).
                # A copy addressed to a peer host is re-pushed for it.
                if len(parts) > 1 and parts[1] \
                        and parts[1] != self.host_label:
                    try:
                        w.client.lpush(self.request_q, m)
                    except Exception:
                        pass
                else:
                    self.request_reload()
            elif parts[0] == "predict" and len(parts) >= 3:
                # admission happens inside submit(): past the depth
                # threshold the future comes back already resolved
                # 'busy' and the flush answers <id>,busy.  A sampled
                # request (optional wire trace field) gets its
                # worker-pop flow step here and rides its context into
                # the service batch.  The optional m=<model[:version]>
                # field routes a multi-model worker; a
                # single-model service serves its one model for any tag.
                rid, row, ctx, deadline_us, model_tag = \
                    reqtrace.split_predict_route(parts)
                if ctx is not None:
                    ctx.t_pop_us = reqtrace.now_us()
                    mspec = ""
                    if model_tag:
                        mspec = model_tag[0] + (
                            f":{model_tag[1]}"
                            if model_tag[1] is not None else "")
                    reqtrace.emit_flow("t", rid, "pop",
                                       ts_us=ctx.t_pop_us,
                                       worker=w.name,
                                       host=self.host_label,
                                       model=mspec)
                if deadline_us is not None \
                        and reqtrace.now_us() > deadline_us:
                    # deadline-aware admission : past-deadline
                    # requests — fresh, replayed, or redelivered —
                    # answer late BEFORE a device dispatch, so a
                    # replayed backlog can't brown out fresh traffic
                    svc.counters.increment("Broker", "LateShed")
                    fut: "Future[str]" = Future()
                    fut.set_result(svc.late_label)
                    w.pending.append((rid, fut, ctx))
                    continue
                if hasattr(svc, "submit_routed"):
                    fut = svc.submit_routed(row, rid=rid,
                                            model_tag=model_tag,
                                            trace=ctx,
                                            sample_local=False)
                else:
                    fut = svc.submit(row, trace=ctx, sample_local=False)
                w.pending.append((rid, fut, ctx))
            else:
                svc.counters.increment("Serving", "BadRequests")
                warnings.warn(f"fleet {w.name}: dropping malformed "
                              f"message {m!r}", RuntimeWarning)

    def _flush(self, w: _Worker, wait: bool,
               timeout_s: float = 120.0) -> None:
        """Answer completed futures onto the prediction queue, in FIFO
        order, as ONE pipelined variadic LPUSH per flush (a whole served
        batch costs one wire round trip, not one per reply).  ``wait=True``
        blocks until every pending future resolved (shutdown / parking);
        ``wait=False`` only flushes the done head."""
        svc = w.service
        # replies whose push failed during a broker outage were parked
        # in w.unsent — re-offer them ahead of the newly completed head
        # (they are older, so FIFO order is preserved)
        replies: List[str] = w.unsent
        w.unsent = []
        traced = None
        while w.pending:
            rid, fut, ctx = w.pending[0]
            if not fut.done() and not wait:
                break
            try:
                label = fut.result(timeout=timeout_s)
            except Exception:
                # per-request isolation already counted it; the waiter
                # still gets a reply line
                label = svc.error_label
            replies.append(f"{rid}{svc.delim}{label}")
            if ctx is not None:
                if traced is None:
                    traced = []
                traced.append(ctx)
            w.pending.popleft()
        if replies:
            try:
                if self.lease_timeout_s > 0:
                    # the ack piggybacks on the reply push (ONE trip):
                    # every answered request's lease is released, and a
                    # duplicate answer (redelivery race) is dropped
                    # broker-side
                    w.client.ackpush(self.prediction_q, self.request_q,
                                     replies)
                else:
                    w.client.lpush_many(self.prediction_q, replies)
            except (ConnectionError, OSError, RuntimeError):
                # broker tier momentarily gone: an ANSWERED request is
                # never dropped — buffer the replies on the worker and
                # let the drain loop's grace retry re-offer them once a
                # shard rejoins the ring
                w.unsent = replies
                raise
            if traced:
                # the replies are actually on the wire now: stamp the
                # reply-push time and close each sampled request's flow
                # (+ component histograms/exemplars) at its service
                t = reqtrace.now_us()
                for ctx in traced:
                    ctx.t_reply_us = t
                    svc.record_request_trace(ctx)
