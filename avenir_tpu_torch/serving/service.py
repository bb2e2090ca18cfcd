"""Micro-batched prediction serving: port of
``avenir_tpu/serving/service.py`` (``BatchPolicy``, ``PredictionService``
and the RESP wire loop ``RespPredictionLoop``).

Single-row requests are coalesced into device batches under a
max-latency/max-batch policy: the first queued request opens a batch window
of ``max_wait_ms``; the batch closes when ``max_batch`` requests are queued
or the window expires, whichever is first.  One bucketed predict then
answers the whole batch.

Batching modes (``BatchPolicy.batching``) of the in-process transport:

  * ``continuous`` (default) — double-buffered over asynchronous CUDA
    launches: the loop launches batch N without waiting for its result,
    gathers + encodes + launches batch N+1 while N is on the device, then
    reads N back.  ``Serving/OverlappedBatches`` counts batches whose
    assembly overlapped a predict in flight.  With a batch in flight the
    coalescing window is skipped — the in-flight predict IS the window.
  * ``drain`` — assemble, predict, repeat, each batch read back before the
    next gather.

SLO-adaptive coalescing (``BatchPolicy.slo_p99_ms``) and admission control
(``BatchPolicy.max_queue_depth``: a submit against a full queue is answered
``busy_label`` at once) behave as in the reference.  ``monitor=`` attaches
the drift monitor's hook (``monitor.accumulator.ServingMonitor``).

Transports:

  * in-process — ``submit()`` returns a future; a daemon worker thread
    runs the coalescing loop.
  * the wire (:class:`RespPredictionLoop`) — RESP-list queues polled like
    the reference's Redis spout (requests ``rpop``ed from the request
    queue, or leased with ``ps.broker.lease.timeout.s``; replies
    ``lpush``ed to the prediction queue, or ``ACKPUSH``ed), against
    ``io/respq.RespServer`` or a real Redis.  Each drained batch goes
    through :meth:`PredictionService.process_batch`: the native codec
    (``io/native_wire``, ``ps.wire.native``) assembles it in one C pass,
    or the Python plane does (``ps.wire.native=off``, and every batch the
    codec's fallback verdict hands back).

Message formats (delim-joined):
  request:    'predict,<requestId>[,t=<us>:<0|1>][,d=<us>],<field0>,...'
              (a full record; the optional request-trace and deadline
              fields are ``telemetry/reqtrace``'s)
              'predictq,<requestId>[,t=...][,d=...],<F>,<qv...>,<qc...>'
              (the int8 pre-binned form, ``serving/quantized.py``; served
              when the model carries a quantized sidecar, else answered
              ``error``)
  response:   '<requestId>,<predictedClass>' ('error' for an unservable
              request, 'late' past its deadline)
  control:    'reload' -> hot-swap to the registry's serving version, by a
                          delta patch where the new version carries one
                          whose parent is the served version
              'stop'   -> end the wire loop

Observability: :meth:`PredictionService.stats` and :meth:`health` are the
``/metrics`` and ``/healthz`` sources; :meth:`bind_metrics` registers the
service's labelled gauges (``host``, ``service``, ``model``), its health
provider and, for head-sampled requests, the component histograms with
request-id exemplars on a ``telemetry.MetricsRegistry`` — the ``metrics=``
argument, else the process default registry ``cli/run.py`` installs from
``telemetry.metrics.port``.

CUDA streams: each service launches on a stream of its own
(``own_stream``, on by default on a CUDA device): its model's H2D, warm-up,
kernel launches and read-backs all run under ``torch.cuda.stream(s)``, so
the read-back of one fleet worker's batch waits for that worker's work
only, not for every launch queued on the card.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import warnings
import weakref
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.faults import fault_point, with_retry
from ..core.metrics import Counters
from ..io import native_wire
from ..telemetry import instant, reqtrace, span
from ..telemetry.metrics import get_default_registry
from ..utils.tracing import StepTimer
from .predictor import AMBIGUOUS, DEFAULT_BUCKETS, Predictor, make_predictor
from .quantized import QUANTIZED_VERB, wire_decode_tokens
from .registry import ModelRegistry

# adaptive-window hysteresis band: shrink above SHRINK*slo, grow back below
# GROW*slo, hold in between
_SLO_SHRINK_FRACTION = 0.6
_SLO_GROW_FRACTION = 0.35

# one warning per affected batch, identical text on both data planes (the
# differential tests compare recorded warnings too)
_NO_PREBINNED_WARNING = (
    "serving: predictq message(s) but the served model has no quantized "
    "sidecar (ps.quantized); replying error")


@dataclass
class BatchPolicy:
    """Coalescing knobs: a batch closes at ``max_batch`` requests or
    ``max_wait_ms`` after its first request, whichever comes first.

    ``batching`` selects the loop shape (``continuous`` double-buffered
    assembly, or ``drain``-first).  ``slo_p99_ms > 0`` enables the adaptive
    window (``min_wait_ms`` is its floor; ``max_wait_ms`` its ceiling).
    ``max_queue_depth > 0`` bounds the request queue: submits past it are
    answered ``busy``."""
    max_batch: int = 64
    max_wait_ms: float = 2.0
    batching: str = "continuous"       # "continuous" | "drain"
    slo_p99_ms: float = 0.0            # 0 = fixed window
    min_wait_ms: float = 0.05          # adaptive-window floor
    max_queue_depth: int = 0           # 0 = unbounded (no admission control)

    def __post_init__(self):
        if self.batching not in ("continuous", "drain"):
            raise ValueError(f"BatchPolicy.batching must be 'continuous' "
                             f"or 'drain', got {self.batching!r}")


def _stamp_dispatch(ctxs, rows: int) -> None:
    """Stamp dispatch time + emit the flow ``t`` step for every sampled
    context entering a device batch.  Lazy timestamp: an untraced batch
    costs one None-check per member, no clock, no allocation."""
    t = None
    for tr in ctxs:
        if tr is not None and tr.t_dispatch_us is None:
            if t is None:
                t = reqtrace.now_us()
            tr.t_dispatch_us = t
            reqtrace.emit_flow("t", tr.rid, "dispatch", ts_us=t, rows=rows)


def _stamp_done(ctxs) -> None:
    """Stamp readback-complete time for every sampled context in a
    finished batch (same lazy-clock discipline)."""
    t = None
    for tr in ctxs:
        if tr is not None:
            if t is None:
                t = reqtrace.now_us()
            tr.t_done_us = t


def _mark_dispatch(batch, rows: int) -> None:
    _stamp_dispatch((r.trace for r in batch), rows)


def _mark_done(batch) -> None:
    _stamp_done(r.trace for r in batch)


def _mark_popped(req) -> None:
    """Stamp queue-pop time for a sampled request the batch loop just
    dequeued, so an in-process request's queue backlog reads as queue
    wait, not coalesce time."""
    tr = req.trace
    if tr is not None and tr.t_pop_us is None:
        tr.t_pop_us = reqtrace.now_us()
        reqtrace.emit_flow("t", tr.rid, "pop", ts_us=tr.t_pop_us)


class _Request:
    __slots__ = ("row", "t_submit", "future", "trace")

    def __init__(self, row: List[str], trace=None):
        self.row = row
        self.t_submit = time.perf_counter()
        self.future: "Future[Optional[str]]" = Future()
        # reqtrace.RequestTrace for a head-sampled request, else None
        self.trace = trace


class PredictionService:
    """The serving bolt: coalesce, predict, respond.

    Construct either around a ready ``predictor`` or around a ``registry`` +
    ``model_name`` (which enables :meth:`refresh` hot-swap to the
    registry's serving version; ``quantized`` serves each loaded version's
    int8 sidecar, ``serve_mesh`` shards each loaded version's vote over a
    device mesh).  ``wire_native`` (``auto`` | ``on`` | ``off``, the
    ``ps.wire.native`` knob; ``auto`` follows ``native_wire.set_mode``)
    selects the wire data plane of :meth:`process_batch`.

    ``name``, ``host_label`` and ``model_label`` are the service's identity
    on a metrics registry (fleet workers are ``<model>-w<i>``).
    ``own_stream=False`` launches on the device's current stream instead of
    a stream of the service's own: a timing-only switch (the per-worker
    stream's comparison run).  ``reward_sink`` (online reward intake): a
    callable taking a list of raw ``reward,<id>,<value>`` messages; with
    one set, the reward rows drained alongside predicts go to it (counted
    in ``Serving/RewardsRouted``, no reply) instead of counting as bad
    requests."""

    def __init__(self, predictor: Optional[Predictor] = None, *,
                 registry: Optional[ModelRegistry] = None,
                 model_name: Optional[str] = None,
                 schema=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 policy: Optional[BatchPolicy] = None,
                 counters: Optional[Counters] = None,
                 timer: Optional[StepTimer] = None,
                 warm: bool = True,
                 delim: str = ",",
                 ambiguous_label: str = AMBIGUOUS,
                 error_label: str = "error",
                 busy_label: str = "busy",
                 late_label: str = "late",
                 device=None,
                 quantized: bool = False,
                 serve_mesh=None,
                 monitor=None,
                 wire_native: str = "auto",
                 name: Optional[str] = None,
                 host_label: Optional[str] = None,
                 model_label: Optional[str] = None,
                 metrics=None,
                 reward_sink=None,
                 own_stream: bool = True):
        if predictor is None and (registry is None or model_name is None):
            raise ValueError("need a predictor, or registry= + model_name=")
        if wire_native not in native_wire.MODES:
            raise ValueError(
                f"wire_native must be one of {native_wire.MODES}, "
                f"got {wire_native!r}")
        self.registry = registry
        self.model_name = model_name
        self._schema = schema
        self._buckets = tuple(buckets)
        # placement of registry-built predictors: ``device`` pins one
        # device, ``serve_mesh`` shards the vote over a device mesh
        # (ForestPredictor); exclusive
        self._device = device
        self._serve_mesh = serve_mesh
        # ps.quantized: registry loads (the first and every hot-swap) serve
        # the version's int8 sidecar; a version without one warns and
        # serves float
        self._quantized = bool(quantized)
        self.policy = policy or BatchPolicy()
        self.counters = counters if counters is not None else Counters()
        self.timer = timer if timer is not None else \
            StepTimer(keep_samples=8192)
        self._warm = warm
        self.delim = delim
        self.ambiguous_label = ambiguous_label
        self.error_label = error_label
        self.busy_label = busy_label
        # deadline-aware admission: a request whose wire deadline field
        # has passed answers this label before any device dispatch
        self.late_label = late_label
        self.version: Optional[int] = None
        # drift/quality hook (monitor.accumulator.ServingMonitor): every
        # answered micro-batch records through it; None = unmonitored
        self.monitor = monitor
        # online reward intake: the native codec declines any batch
        # holding the verb, so the sink only fires from the Python plane
        self.reward_sink = reward_sink
        # set by mark_degraded (a drift policy's degrade_action); cleared
        # by a hot-swap
        self.degraded: Optional[str] = None
        # metrics identity (defaults to the model name in bind_metrics);
        # the host and model labels keep several fleets' and several
        # residents' series disjoint on one registry
        self.name = name
        self.host_label = host_label
        self.model_label = model_label
        self._swap_lock = threading.Lock()
        self._stream = self._make_stream(predictor) if own_stream else None
        if predictor is None:
            predictor = self._load(must=True)
        elif warm:
            with self._on_stream():
                predictor.warm()
        self.predictor = predictor
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if monitor is not None and warm and hasattr(monitor, "warm"):
            monitor.warm()   # the monitor's first build off the live path
        # adaptive coalescing state (only moves when slo_p99_ms is set)
        self._adaptive_wait_ms = self.policy.max_wait_ms
        self._hold_ema_ms = 0.0
        # the native wire codec is built lazily per predictor (schema,
        # buckets and pre-binned width are the predictor's) and rebuilt
        # on hot-swap
        self.wire_native = wire_native
        self._wire_codec = None
        self._wire_codec_pred = None   # weakref to the codec's predictor
        # rows inside a device predict right now (stats and the in-flight
        # gauge)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # (registry, probe, health key, families, labels) while bound
        self._metrics_binding = None
        # (component histogram, labels) while bound; read and cleared under
        # _comp_lock so a sampled request closing during stop() never
        # observes into a series the unbind already swept
        self._comp_binding = None
        self._comp_lock = threading.Lock()
        reg = metrics if metrics is not None else get_default_registry()
        if reg is not None:
            self.bind_metrics(reg)

    # ---- the service's CUDA stream ----
    def _make_stream(self, predictor):
        """A CUDA stream of this service's own on the device it serves from
        (a given predictor's, the mesh's first, ``device``, or the process
        default), or None off CUDA."""
        import torch
        if predictor is not None:
            dev = getattr(predictor, "device", None)
        elif self._serve_mesh is not None:
            from .predictor import ForestPredictor
            dev = ForestPredictor._resolve_serve_mesh(
                self._serve_mesh).devices[0]
        else:
            from ..runtime import resolve_device
            dev = resolve_device(self._device)
        if dev is None or torch.device(dev).type != "cuda":
            return None
        return torch.cuda.Stream(device=torch.device(dev))

    def _on_stream(self):
        """``torch.cuda.stream`` of the service's stream (a null context
        without one): H2D, launches and read-backs under it are ordered on
        that stream alone.  The registry loads, warm-ups and delta patches
        run under it too, so a model tensor freed by a hot-swap goes back
        to this stream's pool and is reused only after the batches already
        launched on it.  A given predictor was built elsewhere with
        blocking copies; it lives until the service does."""
        if self._stream is None:
            return contextlib.nullcontext()
        import torch
        return torch.cuda.stream(self._stream)

    # ---- model lifecycle ----
    def _load(self, must: bool = False) -> Optional[Predictor]:
        latest = self.registry.serving_version(self.model_name)
        if latest is None:
            if must:
                raise FileNotFoundError(
                    f"no intact versions of {self.model_name!r} in "
                    f"{self.registry.base_dir!r}")
            return None
        loaded = self.registry.load(self.model_name, latest)
        with self._on_stream():
            pred = make_predictor(loaded, schema=self._schema,
                                  buckets=self._buckets, delim=self.delim,
                                  device=self._device,
                                  quantized=self._quantized,
                                  serve_mesh=self._serve_mesh)
            if self._warm:
                pred.warm()
        self.version = latest
        return pred

    def refresh(self) -> bool:
        """Hot-swap reload onto the registry's SERVING version (newest
        intact, or the pinned one).  The replacement predictor is built and
        warmed off the request path and swapped in atomically; in-flight
        batches finish on the old one.  Returns whether a swap happened.

        Delta path: when the new version carries a delta sidecar whose
        parent is the served version, the resident predictor patches the
        changed trees (:meth:`_try_delta`) instead of loading the full
        artifact; any mismatch in the sha chain, or a failure mid-patch,
        takes the full load below."""
        if self.registry is None:
            return False
        latest = self.registry.serving_version(self.model_name)
        if latest is None or latest == self.version:
            return False
        if self._try_delta(latest):
            return True
        loaded = self.registry.load(self.model_name, latest)
        with self._on_stream():
            pred = make_predictor(loaded, schema=self._schema,
                                  buckets=self._buckets, delim=self.delim,
                                  device=self._device,
                                  quantized=self._quantized,
                                  serve_mesh=self._serve_mesh)
            if self._warm:
                pred.warm()
        with self._swap_lock:
            self.predictor = pred
            self.version = latest
        self.degraded = None   # a fresh model clears the degraded flag
        self.counters.increment("Serving", "HotSwaps")
        return True

    def _try_delta(self, latest: int) -> bool:
        """Delta patch onto the resident predictor.  True only when the
        patch fully applied and ``latest`` is now serving; False means
        "take the full load" (quantized serving, no delta sidecar, another
        parent, a predictor without patch support, or a failure mid-apply —
        ``apply_delta`` swaps nothing until every slice is on the device,
        so the old model serves in every failure case)."""
        pred = self.predictor
        if (self._quantized or pred is None
                or not hasattr(pred, "apply_delta")):
            return False
        dmeta = self.registry.delta_info(self.model_name, latest)
        if dmeta is None or dmeta.get("parent_version") != self.version:
            return False
        try:
            with self._swap_lock, self._on_stream():
                fault_point("swap_patch")
                dmeta, arrays = self.registry.load_delta(
                    self.model_name, latest)
                moved = pred.apply_delta(dmeta, arrays)
                self.version = latest
        except Exception as exc:   # any tear -> full load
            self.counters.increment("Serving", "DeltaSwapTorn")
            warnings.warn(
                f"serving: delta patch onto v{self.version} failed "
                f"({exc}); falling back to full artifact load",
                RuntimeWarning, stacklevel=2)
            return False
        self.degraded = None
        self.counters.increment("Serving", "HotSwaps")
        self.counters.increment("Serving", "DeltaSwaps")
        self.counters.increment("Serving", "DeltaH2DBytes", int(moved))
        instant("swap.patch", cat="serving", model=self.model_name or "",
                version=int(latest), parent=int(dmeta["parent_version"]),
                changed=len(dmeta.get("changed", ())),
                h2d_bytes=int(moved))
        return True

    def mark_degraded(self, reason: str) -> None:
        """Flag the served model as degraded (drift policy guardrail).
        Serving continues; a successful :meth:`refresh` hot-swap clears
        it."""
        self.degraded = reason
        self.counters.increment("Serving", "Degraded")
        instant("serving.degraded", cat="serving", reason=reason,
                model_version=self.version)

    # ---- observability snapshot (the /healthz and /metrics source) ----
    def stats(self) -> Dict:
        """The serving loop's state: queue depth (accepted, not yet
        drained), in-flight rows (inside a device predict now), served,
        error and batch counts, hot-swaps, rejections, the coalescing
        window, the degraded reason (None = healthy), the model version
        and the identity labels.  Counter reads and a qsize: cheap enough
        for every scrape."""
        with self._inflight_lock:
            inflight = self._inflight
        return {
            "queue_depth": self._queue.qsize(),
            "in_flight": inflight,
            "served": self.counters.get("Serving", "Requests"),
            "errors": self.counters.get("Serving", "BadRequests"),
            "batches": self.counters.get("Serving", "Batches"),
            "hot_swaps": self.counters.get("Serving", "HotSwaps"),
            "rejected": self.counters.get("Serving", "Rejected"),
            "window_ms": self._adaptive_wait_ms,
            "degraded": self.degraded,
            "model_version": self.version,
            "host": self.host_label or "",
            "model": self.model_label or "",
        }

    def health(self):
        """Health-provider contract (``MetricsRegistry.add_health``):
        ``(ok, payload)``, ok == not degraded; the payload is
        :meth:`stats`, so a 503 body says why."""
        st = self.stats()
        st["degraded"] = st["degraded"] or ""
        return self.degraded is None, st

    def bind_metrics(self, registry) -> None:
        """Register this service's gauges and health on a
        ``telemetry.MetricsRegistry``: queue depth, in-flight rows, served,
        error, batch, hot-swap and rejection totals, the window, the
        degraded flag, the model version and latency percentiles, every
        series labelled ``host``, ``service`` and ``model``; plus the
        sampled-request component histogram.  One binding at a time (a
        rebind releases the old one first), and the service label is made
        unique against the registry's health providers, so two services
        never share one series."""
        self._unbind_metrics()
        base = self.name or self.model_name or "predictor"
        # a host-labelled service's health key is host-qualified, so two
        # fleets with the same worker names on one registry keep both
        # providers; /healthz/<name> reaches them by worker name or by
        # <host>:<name> (MetricsRegistry.health_one)
        host = self.host_label or ""

        def _health_key(label: str) -> str:
            return f"serving:{host}:{label}" if host \
                else f"serving:{label}"
        svc_label, n = base, 1
        while registry.has_health(_health_key(svc_label)):
            svc_label = f"{base}-{n}"
            n += 1
        mlabel = self.model_label or ""
        ident = {"host": host, "service": svc_label, "model": mlabel}
        g = registry.gauge("avenir_serving", "prediction service state",
                           labels=("host", "service", "model", "key"))
        gl = registry.gauge("avenir_serving_latency_ms",
                            "serving latency percentiles",
                            labels=("host", "service", "model", "step",
                                    "quantile"))

        def probe():
            st = self.stats()
            for key in ("queue_depth", "in_flight", "served", "errors",
                        "batches", "hot_swaps", "rejected", "window_ms"):
                g.set(st[key], key=key, **ident)
            g.set(0 if st["degraded"] is None else 1, key="degraded",
                  **ident)
            g.set(st["model_version"] or 0, key="model_version", **ident)
            for step in ("serve.request", "serve.batch"):
                if self.timer.samples.get(step):
                    for q in (50, 95, 99):
                        gl.set(self.timer.percentile_ms(step, q), step=step,
                               quantile=f"p{q}", **ident)
        registry.register_probe(probe)
        health_key = _health_key(svc_label)
        registry.add_health(health_key, self.health)
        ch = registry.histogram(
            "avenir_request_component_seconds",
            "sampled-request latency decomposition (queue_wait/"
            "coalesce/device/reply/total), exemplar = request id",
            labels=("host", "service", "model", "component"))
        self._comp_binding = (ch, ident)
        self._metrics_binding = (registry, probe, health_key, (g, gl, ch),
                                 ident)

    def _unbind_metrics(self) -> None:
        """Release the binding: probe, health provider and the bound series
        (matched on host, service and model, so another host's worker of
        the same name keeps its own)."""
        if self._metrics_binding is None:
            return
        reg, probe, health_key, families, ident = self._metrics_binding
        self._metrics_binding = None
        with self._comp_lock:
            self._comp_binding = None
        reg.unregister_probe(probe)
        reg.remove_health(health_key)
        for fam in families:
            fam.drop_series(**ident)

    # ---- per-request trace closure ----
    def record_request_trace(self, ctx) -> None:
        """Close one sampled request's trace: stamp the reply time if the
        transport has not, count it, observe the component histograms with
        the request id as exemplar (when metrics are bound) and, with a
        tracer installed, emit the flow ``f`` finish carrying the component
        decomposition.  Called by
        :meth:`_reply` for in-process requests and by
        :meth:`process_batch` for wire requests, as their replies go out."""
        if ctx.t_reply_us is None:
            ctx.t_reply_us = reqtrace.now_us()
        self.counters.increment("Serving", "TracedRequests")
        if self._comp_binding is None \
                and reqtrace.current_tracer() is None:
            return
        comps = ctx.components_ms()
        with self._comp_lock:
            binding = self._comp_binding
            if binding is not None:
                hist, ident = binding
                for comp, ms in comps.items():
                    # clamped at 0: queue_wait crosses the client's clock
                    hist.observe(max(ms, 0.0) / 1e3, exemplar=ctx.rid,
                                 component=comp, **ident)
        reqtrace.emit_flow("f", ctx.rid, "reply", ts_us=ctx.t_reply_us,
                           **{f"{k}_ms": round(v, 3)
                              for k, v in comps.items()})

    # ---- prediction ----
    def _label(self, pred: Optional[str]) -> str:
        return pred if pred is not None else self.ambiguous_label

    def predict_rows(self, rows: List[List[str]], *,
                     _pred=None) -> List[str]:
        """One coalesced device batch for ``rows``, with transient-error
        retry."""
        if _pred is None:
            with self._swap_lock:
                _pred = self.predictor
        t0 = time.perf_counter()
        with span("serve.predict", cat="serving", rows=len(rows),
                  model=self.model_label or ""), self._on_stream():
            out = with_retry(lambda: _pred.predict_rows(rows),
                             what="serving predict batch")
        self.timer.record("serve.batch", time.perf_counter() - t0)
        self.counters.increment("Serving", "Requests", len(rows))
        self.counters.increment("Serving", "Batches")
        return [self._label(p) for p in out]

    def _predict_isolating(self, rows: List[List[str]], pred=None):
        """('ok', label) | ('err', exc) per row.  The whole batch runs as
        one launch when it is clean; if anything in it fails (a short
        record, a non-numeric token), fall back to per-row isolation so one
        malformed request cannot take down its batchmates."""
        with self._inflight_lock:
            self._inflight += len(rows)
        try:
            try:
                results = [("ok", lab) for lab in
                           self.predict_rows(rows, _pred=pred)]
                self._record_monitor(rows, results)
                return results
            except Exception as exc:
                warnings.warn(
                    f"serving: batch predict failed ({type(exc).__name__}: "
                    f"{exc}); isolating per row", RuntimeWarning)
            if pred is None:
                with self._swap_lock:
                    pred = self.predictor
            return self._isolated_pass(pred, rows)
        finally:
            with self._inflight_lock:
                self._inflight -= len(rows)

    def _isolated_pass(self, pred, rows: List[List[str]]):
        """Per-row isolation after a whole-batch failure: one launch per
        row.  Accounts as ONE isolated batch."""
        t0 = time.perf_counter()
        out = []
        for row in rows:
            try:
                with self._on_stream():
                    lab = with_retry(lambda r=row: pred.predict_rows([r]),
                                     what="serving predict row")[0]
                out.append(("ok", self._label(lab)))
            except Exception as exc:
                self.counters.increment("Serving", "BadRequests")
                out.append(("err", exc))
        self.timer.record("serve.batch", time.perf_counter() - t0)
        self.counters.increment("Serving", "Requests", len(rows))
        self.counters.increment("Serving", "Batches")
        self.counters.increment("Serving", "IsolatedBatches")
        self._record_monitor(rows, out)
        return out

    def _record_monitor(self, rows, results) -> None:
        """Feed the answered (row, label) pairs to the drift monitor hook.
        The hook only buffers on this path; its failures are warned, never
        propagated: observability must not take serving down."""
        if self.monitor is None:
            return
        try:
            ok_rows = [r for r, (st, _) in zip(rows, results) if st == "ok"]
            ok_labels = [v for st, v in results if st == "ok"]
            if ok_rows:
                self.monitor.record_batch(ok_rows, ok_labels)
        except Exception as exc:
            warnings.warn(f"serving: monitor hook failed "
                          f"({type(exc).__name__}: {exc}); continuing "
                          f"unmonitored for this batch", RuntimeWarning)

    # ---- message contract (the wire transport's) ----
    def process(self, message: str) -> Optional[str]:
        """Serve ONE wire message synchronously (micro-batching callers use
        :meth:`process_batch`)."""
        return (self.process_batch([message]) or [None])[0]

    def process_batch(self, messages: List[str]) -> List[str]:
        """Coalesce a drained message batch: the predict messages run as
        one device batch and the predictq messages as one int8 batch,
        reply lines returned in arrival order.  A malformed or unknown
        message is counted + warned and skipped — it must not take down
        the valid requests drained alongside it.  A 'reload' in the drain
        applies AFTER the batch is answered, so the new model takes effect
        from the next batch.

        The batch runs through the native wire codec when it is on
        (``wire_native``): one C pass classifies and assembles the whole
        drain.  Any input the native pass is not bit-certain about re-runs
        the WHOLE batch through the Python plane, so replies and
        BadRequests counts are those of the Python plane by
        construction."""
        if not messages:
            return []
        with self._swap_lock:
            pred = self.predictor
        codec = self._wire_codec_for(pred)
        if codec is not None:
            out = self._process_batch_native(pred, codec, messages)
            if out is not None:
                return out
        return self._process_batch_python(pred, messages)

    def _process_batch_python(self, pred, messages: List[str]) -> List[str]:
        """The Python data plane — the semantics oracle the native codec
        defers to, and the serving path under ``ps.wire.native=off`` or a
        drift monitor (which needs the token rows)."""
        # (form, rid, slot): "f" float row, "q" decoded pre-binned row,
        # "e" error reply, "l" late reply — arrival order
        entries: List[tuple] = []
        rows: List[List[str]] = []
        q_rows: List[tuple] = []
        traced = None
        reload_requested = False
        reward_msgs: List[str] = []
        q_width = pred.prebinned_width \
            if getattr(pred, "supports_prebinned", False) else 0
        warned_no_prebinned = False
        with span("serve.assemble", cat="serving", rows=len(messages)):
            for message in messages:
                parts = message.split(self.delim)
                is_predict = parts[0] == "predict"
                if (is_predict or parts[0] == QUANTIZED_VERB) \
                        and len(parts) >= 3:
                    # the optional trace and deadline fields are stripped
                    # whether acted on or not
                    rid, row, ctx, deadline_us = \
                        reqtrace.split_predict_deadline(parts)
                    if ctx is not None:
                        ctx.t_pop_us = reqtrace.now_us()
                        reqtrace.emit_flow("t", rid, "pop",
                                           ts_us=ctx.t_pop_us)
                        if traced is None:
                            traced = []
                        traced.append(ctx)
                    if deadline_us is not None \
                            and reqtrace.now_us() > deadline_us:
                        # past deadline: answer late, never dispatch
                        self.counters.increment("Broker", "LateShed")
                        entries.append(("l", rid, -1))
                        continue
                    if is_predict:
                        entries.append(("f", rid, len(rows)))
                        rows.append(row)
                    elif q_width <= 0:
                        self.counters.increment("Serving", "BadRequests")
                        if not warned_no_prebinned:
                            warned_no_prebinned = True
                            warnings.warn(_NO_PREBINNED_WARNING,
                                          RuntimeWarning)
                        entries.append(("e", rid, -1))
                    else:
                        decoded = wire_decode_tokens(row, q_width)
                        if decoded is None:
                            self.counters.increment("Serving",
                                                    "BadRequests")
                            warnings.warn(
                                f"serving: malformed predictq payload "
                                f"{message!r}", RuntimeWarning)
                            entries.append(("e", rid, -1))
                        else:
                            entries.append(("q", rid, len(q_rows)))
                            q_rows.append(decoded)
                elif parts[0] == "reload":
                    reload_requested = True
                elif parts[0] == "reward" and self.reward_sink is not None:
                    # the sink owns the reward's parse and join; a reward
                    # gets no reply line
                    reward_msgs.append(message)
                else:
                    self.counters.increment("Serving", "BadRequests")
                    warnings.warn(f"serving: dropping malformed message "
                                  f"{message!r}", RuntimeWarning)
        if reward_msgs:
            self.counters.increment("Serving", "RewardsRouted",
                                    len(reward_msgs))
            self.reward_sink(reward_msgs)
        if not entries:
            if reload_requested:
                self.refresh()
            return []
        if traced:
            _stamp_dispatch(traced, len(rows) + len(q_rows))
        t0 = time.perf_counter()
        results_f = self._predict_isolating(rows, pred=pred) if rows \
            else []
        if q_rows:
            results_q = self._serve_prebinned(
                pred, np.stack([v for v, _ in q_rows]),
                np.stack([c for _, c in q_rows]))
        else:
            results_q = []
        dt = time.perf_counter() - t0
        if traced:
            _stamp_done(traced)
        with span("serve.reply", cat="serving", rows=len(entries)):
            self._record_request_times(traced, dt)
            out = []
            for form, rid, slot in entries:
                if form == "f":
                    status, val = results_f[slot]
                elif form == "q":
                    status, val = results_q[slot]
                elif form == "l":
                    out.append(f"{rid}{self.delim}{self.late_label}")
                    continue
                else:
                    status, val = "err", None
                lab = val if status == "ok" else self.error_label
                out.append(f"{rid}{self.delim}{lab}")
        if traced:
            # the reply lines push right after this returns: close the
            # flows here
            for ctx in traced:
                self.record_request_trace(ctx)
        if reload_requested:
            self.refresh()
        return out

    def _process_batch_native(self, pred, codec,
                              messages: List[str]) -> Optional[List[str]]:
        """The native data plane: the batch was classified and assembled by
        ONE C pass (``codec.parse``) — what remains here is per-message
        bookkeeping (counters, trace contexts) and the reply join.  Returns
        None when the codec declined the batch (its fallback verdict): the
        caller re-runs the Python plane on the SAME messages."""
        pb = codec.parse(messages)
        if pb is None:
            return None
        traced = None
        n_replies = pb.n_float + pb.n_q
        with span("serve.assemble", cat="serving", rows=len(messages),
                  native=1):
            # per-message work only where the batch has exceptions: the
            # all-clean case (every message a decoded predict/predictq)
            # skips the scans the C pass already did
            if n_replies + pb.n_reload != pb.n_msgs:
                for i in np.nonzero(pb.kind == native_wire.MSG_BAD)[0]:
                    self.counters.increment("Serving", "BadRequests")
                    warnings.warn(f"serving: dropping malformed message "
                                  f"{messages[i]!r}", RuntimeWarning)
                unsup = np.nonzero((pb.kind == native_wire.MSG_PREDICTQ)
                                   & (pb.slot < 0))[0]
                if len(unsup):
                    # no quantized sidecar on the served model: answered
                    # error, never decoded — as on the Python plane
                    n_replies += len(unsup)
                    self.counters.increment("Serving", "BadRequests",
                                            len(unsup))
                    warnings.warn(_NO_PREBINNED_WARNING, RuntimeWarning)
            if pb.trace_sampled.any():
                traced = []
                for i in np.nonzero(pb.trace_sampled)[0]:
                    ctx = reqtrace.RequestTrace(pb.rids[i],
                                                float(pb.trace_us[i]),
                                                wire=True)
                    ctx.t_pop_us = reqtrace.now_us()
                    reqtrace.emit_flow("t", ctx.rid, "pop",
                                       ts_us=ctx.t_pop_us)
                    traced.append(ctx)
        if n_replies == 0:
            if pb.n_reload:
                self.refresh()
            return []
        if traced:
            _stamp_dispatch(traced, pb.n_float + pb.n_q)
        t0 = time.perf_counter()
        results_f = self._serve_prepared_native(
            pred, pb.prepared, pb.n_float,
            lambda: self._retokenize_float_rows(messages, pb)) \
            if pb.n_float else []
        results_q = self._serve_prebinned(pred, pb.qv, pb.qc) \
            if pb.n_q else []
        dt = time.perf_counter() - t0
        if traced:
            _stamp_done(traced)
        with span("serve.reply", cat="serving", rows=n_replies, native=1):
            self._record_request_times(traced, dt)
            delim = self.delim
            err = self.error_label
            labs_f = [v if s == "ok" else err for s, v in results_f]
            if pb.n_float == pb.n_msgs:
                # all-float batch: slots ARE the arrival order
                out = [f"{r}{delim}{lab}"
                       for r, lab in zip(pb.rids, labs_f)]
            else:
                labs_q = [v if s == "ok" else err for s, v in results_q]
                out = []
                for i in range(pb.n_msgs):
                    k = pb.kind[i]
                    if k == native_wire.MSG_PREDICT:
                        lab = labs_f[pb.slot[i]]
                    elif k == native_wire.MSG_PREDICTQ:
                        s = pb.slot[i]
                        lab = labs_q[s] if s >= 0 else err
                    else:
                        continue
                    out.append(f"{pb.rids[i]}{delim}{lab}")
        if traced:
            for ctx in traced:
                self.record_request_trace(ctx)
        if pb.n_reload:
            self.refresh()
        return out

    def _retokenize_float_rows(self, messages: List[str], pb):
        """Token rows (slot order) for the native path's per-row isolation
        — built ONLY when a whole-batch predict failed."""
        rows = []
        for i in range(pb.n_msgs):
            if pb.kind[i] == native_wire.MSG_PREDICT:
                _, row, _ = reqtrace.split_predict(
                    messages[i].split(self.delim))
                rows.append(row)
        return rows

    def _serve_prepared_native(self, pred, prepared, n_rows: int,
                               row_thunk):
        """:meth:`_predict_isolating` for natively assembled float
        batches: the same counters, timer and span, but the token rows are
        materialized (``row_thunk``) only if the whole-batch predict fails
        and per-row isolation must run."""
        with self._inflight_lock:
            self._inflight += n_rows
        try:
            t0 = time.perf_counter()
            try:
                with span("serve.predict", cat="serving", rows=n_rows,
                          model=self.model_label or ""), self._on_stream():
                    out = with_retry(
                        lambda: pred.predict_prepared(prepared),
                        what="serving predict batch")
            except Exception as exc:
                warnings.warn(
                    f"serving: batch predict failed "
                    f"({type(exc).__name__}: {exc}); isolating per row",
                    RuntimeWarning)
                return self._isolated_pass(pred, row_thunk())
            self.timer.record("serve.batch", time.perf_counter() - t0)
            self.counters.increment("Serving", "Requests", n_rows)
            self.counters.increment("Serving", "Batches")
            return [("ok", self._label(p)) for p in out]
        finally:
            with self._inflight_lock:
                self._inflight -= n_rows

    def _serve_prebinned(self, pred, qv, qc):
        """('ok', label) | ('err', exc) per pre-binned int8 row — BOTH data
        planes land predictq rows here.  No per-row isolation: a decoded
        int8 row has no per-row failure mode (arity and range were checked
        at decode), so a predict failure fails the whole q-batch."""
        n = len(qv)
        with self._inflight_lock:
            self._inflight += n
        try:
            t0 = time.perf_counter()
            try:
                with span("serve.predict", cat="serving", rows=n,
                          model=self.model_label or ""), self._on_stream():
                    out = with_retry(
                        lambda: pred.predict_prebinned(qv, qc),
                        what="serving predictq batch")
            except Exception as exc:
                warnings.warn(
                    f"serving: pre-binned batch predict failed "
                    f"({type(exc).__name__}: {exc}); failing the q-batch",
                    RuntimeWarning)
                self.counters.increment("Serving", "BadRequests", n)
                return [("err", exc)] * n
            self.timer.record("serve.batch", time.perf_counter() - t0)
            self.counters.increment("Serving", "Requests", n)
            self.counters.increment("Serving", "Batches")
            return [("ok", self._label(p)) for p in out]
        finally:
            with self._inflight_lock:
                self._inflight -= n

    def _record_request_times(self, traced, dt: float) -> None:
        """``serve.request`` samples of a wire batch: traced requests
        record their wire-derived latency (reply time minus the client's
        enqueue stamp), one sample each; an untraced batch records ONE
        ``dt`` sample."""
        if traced:
            t_now = reqtrace.now_us()
            for ctx in traced:
                self.timer.record("serve.request",
                                  max(t_now - ctx.enqueue_us, 0.0) / 1e6)
        else:
            self.timer.record("serve.request", dt)

    def _wire_codec_for(self, pred):
        """The native batch assembler bound to the CURRENT predictor,
        rebuilt on hot-swap.  None = the Python plane: mode off, a drift
        monitor attached (it needs the token rows), or no usable schema
        or delimiter.  Building the codec's library raises on a failed
        build."""
        mode = self.wire_native if self.wire_native != "auto" \
            else native_wire.get_mode()
        if mode == "off" or self.monitor is not None:
            return None
        schema = getattr(pred, "schema", None)
        if schema is None or not getattr(schema, "fields", None):
            return None
        if self._wire_codec is not None \
                and self._wire_codec_pred is not None \
                and self._wire_codec_pred() is pred:
            return self._wire_codec
        native_wire.get_lib()
        q_width = pred.prebinned_width \
            if getattr(pred, "supports_prebinned", False) else 0
        codec = native_wire.WireCodec(schema, delim=self.delim,
                                      buckets=tuple(pred.buckets),
                                      q_width=q_width)
        if not codec.usable:
            return None
        self._wire_codec = codec
        self._wire_codec_pred = weakref.ref(pred)
        return codec

    # ---- in-process micro-batch loop ----
    def submit(self, row, trace=None,
               sample_local: bool = True) -> "Future[str]":
        """Queue one record (tokenized row or delim-joined line); the worker
        thread answers the future with the class label.  Past
        ``policy.max_queue_depth`` the future is answered ``busy_label`` at
        once — backpressure the caller can see.  ``trace`` carries a wire
        request's ``reqtrace.RequestTrace``; without one, in-process head
        sampling applies (one global read when ``ps.trace.sample`` is
        off).  Wire transports pass ``sample_local=False``: sampling is a
        HEAD decision, never re-made mid-path."""
        if isinstance(row, str):
            row = row.split(self.delim)
        if trace is None and sample_local:
            trace = reqtrace.maybe_sample_local()
        req = _Request(list(row), trace=trace)
        dmax = self.policy.max_queue_depth
        if dmax and self._queue.qsize() >= dmax:
            self.counters.increment("Serving", "Rejected")
            instant("serve.reject", cat="serving",
                    queue_depth=self._queue.qsize())
            req.future.set_result(self.busy_label)
            # a rejected sampled request still closes its flow (busy IS
            # the reply); a wire context closes at the transport's push
            if trace is not None and not trace.wire:
                self.record_request_trace(trace)
            return req.future
        if trace is not None:
            instant("serve.admit", cat="serving", rid=trace.rid)
        self._queue.put(req)
        return req.future

    def start(self) -> "PredictionService":
        if self._thread is not None:
            return self
        self._stop.clear()
        target = self._loop_continuous \
            if self.policy.batching == "continuous" else self._loop
        self._thread = threading.Thread(target=target, daemon=True,
                                        name="avenir-serve-loop")
        self._thread.start()
        return self

    def stop(self, drain_s: float = 5.0) -> None:
        """Stop the worker; queued requests are still served (bounded by
        ``drain_s``, in ``policy.max_batch`` chunks) so no accepted request
        is dropped on shutdown.  Also unbinds the service's metrics: a
        stopped service is not probed by later scrapes."""
        self._unbind_metrics()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(drain_s, 0.1) + 5.0)
            self._thread = None
        deadline = time.monotonic() + drain_s
        max_b = max(1, self.policy.max_batch)
        batch: List[_Request] = []
        while time.monotonic() < deadline:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                break
            _mark_popped(leftover)
            batch.append(leftover)
            if len(batch) >= max_b:
                self._serve(batch)
                batch = []
        if batch:
            self._serve(batch)

    # how many of the newest serve.request samples steer the adaptive window
    _ADAPT_SAMPLES = 256

    def _recent_p99_ms(self) -> float:
        s = self.timer.samples.get("serve.request")
        if not s:
            return 0.0
        # the reply path appends to this bounded deque concurrently: retry a
        # mutated-during-iteration copy, and report "no pressure" on
        # persistent contention
        for _ in range(3):
            try:
                recent = list(s)[-self._ADAPT_SAMPLES:]
                break
            except RuntimeError:
                continue
        else:
            return 0.0
        if not recent:
            return 0.0
        return float(np.percentile(np.asarray(recent), 99)) * 1000.0

    def _effective_wait_ms(self) -> float:
        """The coalescing window for the NEXT batch: ``policy.max_wait_ms``
        unless an SLO budget is set.  Under one: recent p99 past the shrink
        fraction with the window's own hold a real part of it -> shrink
        x0.5; past it but the hold is not the cost -> grow x1.5; under the
        grow fraction -> grow x1.5; in between -> hold."""
        pol = self.policy
        if not pol.slo_p99_ms:
            return pol.max_wait_ms
        w = self._adaptive_wait_ms
        try:
            p99 = self._recent_p99_ms()
            if p99 >= _SLO_SHRINK_FRACTION * pol.slo_p99_ms:
                if self._hold_ema_ms >= 0.1 * pol.slo_p99_ms:
                    w = max(pol.min_wait_ms, w * 0.5)
                else:
                    w = min(pol.max_wait_ms, max(w * 1.5, pol.min_wait_ms))
            elif p99 and p99 < _SLO_GROW_FRACTION * pol.slo_p99_ms:
                w = min(pol.max_wait_ms, max(w * 1.5, pol.min_wait_ms))
        except Exception:
            # advisory: keep the current window rather than kill the loop
            return w
        self._adaptive_wait_ms = w
        return w

    def _gather(self, first: _Request,
                skip_hold: bool = False) -> List[_Request]:
        """Assemble one batch starting from ``first``: everything already
        queued, then hold the window open for stragglers — bounded by the
        FIRST request's age.  ``skip_hold`` (continuous mode with a batch in
        flight) takes only what is queued."""
        pol = self.policy
        batch = [first]
        with span("serve.assemble", cat="serving") as sp:
            while len(batch) < pol.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            # pop stamps BEFORE the straggler hold: queue backlog reads as
            # queue wait, the hold as coalesce
            for r in batch:
                _mark_popped(r)
            hold_ms = 0.0
            if not skip_hold:
                deadline = first.t_submit + \
                    self._effective_wait_ms() / 1000.0
                t_hold = time.perf_counter()
                while len(batch) < pol.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        straggler = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    _mark_popped(straggler)
                    batch.append(straggler)
                hold_ms = (time.perf_counter() - t_hold) * 1000.0
            self._hold_ema_ms += 0.1 * (hold_ms - self._hold_ema_ms)
            sp.add(rows=len(batch))
        return batch

    def _loop(self) -> None:
        """Drain-first: assemble, predict, repeat."""
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.02)
            except queue.Empty:
                continue
            self._serve(self._gather(first))

    def _loop_continuous(self) -> None:
        """Continuous batching: stage batch N (encode + launch, no wait),
        gather+encode+launch batch N+1 while N is on the device, THEN read
        N back."""
        staged = None
        try:
            while not self._stop.is_set():
                try:
                    first = self._queue.get(
                        timeout=0.0005 if staged is not None else 0.02)
                except queue.Empty:
                    if staged is not None:
                        item, staged = staged, None
                        self._complete(item)
                    continue
                batch = self._gather(first, skip_hold=staged is not None)
                nxt = self._stage(batch)
                if staged is not None:
                    if staged[2] is not None:
                        self.counters.increment("Serving",
                                                "OverlappedBatches")
                    self._complete(staged)
                staged = nxt
        finally:
            if staged is not None:
                self._complete(staged)

    def _stage(self, batch: List[_Request]):
        """The launch half of a continuous-mode batch: snapshot the
        predictor (a hot-swap mid-flight finishes this batch on the model
        that encoded it), encode, and launch.  Returns ``(batch, pred,
        handle, t0)``; a prepare/dispatch failure (malformed row) stages
        ``None`` and completes via the sync isolating path."""
        with self._swap_lock:
            pred = self.predictor
        dispatch = getattr(pred, "dispatch_prepared", None)
        if dispatch is not None:
            try:
                with span("serve.dispatch", cat="serving",
                          rows=len(batch)), self._on_stream():
                    handle = dispatch(
                        pred.prepare_rows([r.row for r in batch]))
            except Exception:
                pass   # fall through to the sync isolating completion
            else:
                _mark_dispatch(batch, len(batch))
                with self._inflight_lock:
                    self._inflight += len(batch)
                return (batch, pred, handle, time.perf_counter())
        return (batch, pred, None, time.perf_counter())

    def _complete(self, item) -> None:
        """The readback half: wait for the staged device result, account,
        reply.  A readback failure isolates per row."""
        batch, pred, handle, t0 = item
        if handle is None:
            self._serve(batch, pred=pred)
            return
        rows = [r.row for r in batch]
        try:
            try:
                with span("serve.predict", cat="serving", rows=len(rows),
                          model=self.model_label or ""), self._on_stream():
                    out = pred.readback_dispatched(handle)
                results = [("ok", self._label(p)) for p in out]
                self.timer.record("serve.batch", time.perf_counter() - t0)
                self.counters.increment("Serving", "Requests", len(rows))
                self.counters.increment("Serving", "Batches")
                self._record_monitor(rows, results)
            except Exception as exc:
                warnings.warn(
                    f"serving: dispatched batch readback failed "
                    f"({type(exc).__name__}: {exc}); isolating per row",
                    RuntimeWarning)
                results = self._isolated_pass(pred, rows)
        finally:
            with self._inflight_lock:
                self._inflight -= len(batch)
        _mark_done(batch)
        self._reply(batch, results)

    def _serve(self, batch: List[_Request], pred=None) -> None:
        # sync path: the whole predict runs here, so dispatch == entry
        _mark_dispatch(batch, len(batch))
        results = self._predict_isolating([r.row for r in batch], pred=pred)
        _mark_done(batch)
        self._reply(batch, results)

    def _reply(self, batch: List[_Request], results) -> None:
        now = time.perf_counter()
        with span("serve.reply", cat="serving", rows=len(batch)):
            for r, (status, val) in zip(batch, results):
                if r.future.set_running_or_notify_cancel():
                    if status == "ok":
                        self.timer.record("serve.request", now - r.t_submit)
                        r.future.set_result(val)
                    else:  # answer with the error, don't wedge the waiter
                        r.future.set_exception(val)
                # in-process sampled requests close here (the future IS
                # the reply); wire contexts close at the transport's push
                tr = r.trace
                if tr is not None and not tr.wire:
                    self.record_request_trace(tr)
        self.counters.max("Serving", "MaxBatchObserved", len(batch))


class RespPredictionLoop:
    """The serving loop over the wire: drain up to ``policy.max_batch``
    requests from the request queue per poll (one pipelined RPOP — the
    wire half of micro-batching), answer them as one device batch, and
    push the replies to the prediction queue as ONE variadic LPUSH.
    Config keys: redis.server.host, redis.server.port,
    redis.request.queue, redis.prediction.queue, redis.lease.timeout.s.
    A literal 'stop' on the request queue ends :meth:`run` after the
    requests drained alongside it are answered."""

    def __init__(self, service: PredictionService,
                 config: Optional[Dict] = None):
        from ..io.respq import RespClient
        cfg = dict(config or {})
        self.service = service
        # the service's counters ride in so this client's reconnects land
        # as Broker/Reconnects in the job dump
        self.client = RespClient(cfg.get("redis.server.host", "127.0.0.1"),
                                 int(cfg.get("redis.server.port", 6379)),
                                 delim=service.delim,
                                 counters=service.counters)
        self.request_q = cfg.get("redis.request.queue", "requestQueue")
        self.prediction_q = cfg.get("redis.prediction.queue",
                                    "predictionQueue")
        # > 0 drains under visibility-timeout leases and acks via the
        # reply push (ACKPUSH): a loop killed mid-batch gets its requests
        # redelivered.  0 keeps the destructive pops
        self.lease_timeout_s = float(
            cfg.get("redis.lease.timeout.s", 0.0) or 0.0)
        self.stopped = False

    def poll_once(self) -> int:
        """One spout pass; returns how many messages were consumed."""
        if self.lease_timeout_s > 0:
            msgs = self.client.lease_many(self.request_q,
                                          self.service.policy.max_batch,
                                          self.lease_timeout_s)
        else:
            msgs = self.client.rpop_many(self.request_q,
                                         self.service.policy.max_batch)
        if not msgs:
            return 0
        batch: List[str] = []
        for m in msgs:
            if m == "stop":
                # requests drained in the same pop as the stop are off the
                # queue already: they are still answered below
                self.stopped = True
            else:
                batch.append(m)
        if batch:
            out = self.service.process_batch(batch)
            if out:
                if self.lease_timeout_s > 0:
                    self.client.ackpush(self.prediction_q,
                                        self.request_q, out)
                else:
                    self.client.lpush_many(self.prediction_q, out)
        return len(msgs)

    def run(self, max_idle_s: float = 30.0,
            idle_sleep_s: float = 0.002,
            max_idle_sleep_s: float = 0.05) -> None:
        """Poll until a 'stop' message or ``max_idle_s`` without traffic.
        While the queue stays empty the sleep backs off exponentially
        (doubling from ``idle_sleep_s`` up to ``max_idle_sleep_s``) and
        resets on the first drained message; ``Serving/Polls`` and
        ``Serving/EmptyPolls`` count the polling economy."""
        counters = self.service.counters
        idle_since = time.monotonic()
        sleep_s = idle_sleep_s
        while not self.stopped:
            counters.increment("Serving", "Polls")
            if self.poll_once():
                idle_since = time.monotonic()
                sleep_s = idle_sleep_s
            elif time.monotonic() - idle_since > max_idle_s:
                break
            else:
                counters.increment("Serving", "EmptyPolls")
                time.sleep(sleep_s)
                sleep_s = min(sleep_s * 2.0, max_idle_sleep_s)

    def close(self) -> None:
        self.client.close()
