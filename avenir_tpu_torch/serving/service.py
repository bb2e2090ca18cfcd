"""Micro-batched prediction serving, in-process transport: port of
``avenir_tpu/serving/service.py`` (``BatchPolicy`` and ``PredictionService``'s
submit / start / stop / predict_rows and its drain and continuous loops).

Single-row requests are coalesced into device batches under a
max-latency/max-batch policy: the first queued request opens a batch window
of ``max_wait_ms``; the batch closes when ``max_batch`` requests are queued
or the window expires, whichever is first.  One bucketed predict then
answers the whole batch.

Batching modes (``BatchPolicy.batching``):

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
the drift monitor's hook (``monitor.accumulator.ServingMonitor``): every
answered batch's rows and labels are recorded through it, and a failing
hook is warned, never raised into serving.  The wire transports (RESP,
native codec), request tracing and metrics binding are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..core.faults import with_retry
from ..core.metrics import Counters
from ..utils.tracing import StepTimer
from .predictor import AMBIGUOUS, DEFAULT_BUCKETS, Predictor, make_predictor
from .registry import ModelRegistry

# adaptive-window hysteresis band: shrink above SHRINK*slo, grow back below
# GROW*slo, hold in between
_SLO_SHRINK_FRACTION = 0.6
_SLO_GROW_FRACTION = 0.35


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


class _Request:
    __slots__ = ("row", "t_submit", "future")

    def __init__(self, row: List[str]):
        self.row = row
        self.t_submit = time.perf_counter()
        self.future: "Future[Optional[str]]" = Future()


class PredictionService:
    """The serving bolt: coalesce, predict, respond.

    Construct either around a ready ``predictor`` or around a ``registry`` +
    ``model_name`` (which enables :meth:`refresh` hot-swap to the
    registry's serving version; ``quantized`` serves each loaded version's
    int8 sidecar, ``serve_mesh`` shards each loaded version's vote over a
    device mesh)."""

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
                 busy_label: str = "busy",
                 device=None,
                 quantized: bool = False,
                 serve_mesh=None,
                 monitor=None):
        if predictor is None and (registry is None or model_name is None):
            raise ValueError("need a predictor, or registry= + model_name=")
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
        self.busy_label = busy_label
        self.version: Optional[int] = None
        # drift/quality hook (monitor.accumulator.ServingMonitor): every
        # answered micro-batch records through it; None = unmonitored
        self.monitor = monitor
        # set by mark_degraded (a drift policy's degrade_action); cleared
        # by a hot-swap
        self.degraded: Optional[str] = None
        self._swap_lock = threading.Lock()
        if predictor is None:
            predictor = self._load(must=True)
        elif warm:
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
        batches finish on the old one.  Returns whether a swap happened."""
        if self.registry is None:
            return False
        latest = self.registry.serving_version(self.model_name)
        if latest is None or latest == self.version:
            return False
        loaded = self.registry.load(self.model_name, latest)
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

    def mark_degraded(self, reason: str) -> None:
        """Flag the served model as degraded (drift policy guardrail).
        Serving continues; a successful :meth:`refresh` hot-swap clears
        it."""
        self.degraded = reason
        self.counters.increment("Serving", "Degraded")

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

    def _isolated_pass(self, pred, rows: List[List[str]]):
        """Per-row isolation after a whole-batch failure: one launch per
        row.  Accounts as ONE isolated batch."""
        t0 = time.perf_counter()
        out = []
        for row in rows:
            try:
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

    # ---- in-process micro-batch loop ----
    def submit(self, row) -> "Future[str]":
        """Queue one record (tokenized row or delim-joined line); the worker
        thread answers the future with the class label.  Past
        ``policy.max_queue_depth`` the future is answered ``busy_label`` at
        once — backpressure the caller can see."""
        if isinstance(row, str):
            row = row.split(self.delim)
        req = _Request(list(row))
        dmax = self.policy.max_queue_depth
        if dmax and self._queue.qsize() >= dmax:
            self.counters.increment("Serving", "Rejected")
            req.future.set_result(self.busy_label)
            return req.future
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
        is dropped on shutdown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(drain_s, 0.1) + 5.0)
            self._thread = None
        deadline = time.monotonic() + drain_s
        max_b = max(1, self.policy.max_batch)
        batch: List[_Request] = []
        while time.monotonic() < deadline:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
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
        while len(batch) < pol.max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        hold_ms = 0.0
        if not skip_hold:
            deadline = first.t_submit + self._effective_wait_ms() / 1000.0
            t_hold = time.perf_counter()
            while len(batch) < pol.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            hold_ms = (time.perf_counter() - t_hold) * 1000.0
        self._hold_ema_ms += 0.1 * (hold_ms - self._hold_ema_ms)
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
                handle = dispatch(pred.prepare_rows([r.row for r in batch]))
            except Exception:
                pass   # fall through to the sync isolating completion
            else:
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
        self._reply(batch, results)

    def _serve(self, batch: List[_Request], pred=None) -> None:
        results = self._predict_isolating([r.row for r in batch], pred=pred)
        self._reply(batch, results)

    def _reply(self, batch: List[_Request], results) -> None:
        now = time.perf_counter()
        for r, (status, val) in zip(batch, results):
            if r.future.set_running_or_notify_cancel():
                if status == "ok":
                    self.timer.record("serve.request", now - r.t_submit)
                    r.future.set_result(val)
                else:  # answer with the error, don't wedge the waiter
                    r.future.set_exception(val)
        self.counters.max("Serving", "MaxBatchObserved", len(batch))
