"""Tracing utilities: the port's copy of what forest serving and training
call in ``avenir_tpu/utils/tracing.py``.

- :class:`StepTimer` — named wall-clock step accounting that exports into
  the job Counters channel (millisecond totals/counts; percentile samples
  for serving latencies).
- :class:`TransferLedger` — host<->device traffic and launch accounting
  recorded at the instrumented sites: H2D/D2H bytes, tagged dispatches
  (``Dispatches`` group; training sites ``forest.level``, ``tree.level``,
  ``tree.reassign``, ``baseline.absorb``; serving sites ``ensemble.vote``,
  ``quantized.vote``, ``knn.topk``; the sharded paths add one
  ``serve.predict`` + one ``serve.shard_merge`` a served batch and one
  ``knn.topk`` + one ``knn.shard_merge`` a KNN test chunk), which kernel
  form actually ran at each hot site (``KernelBackends`` group, keys
  ``<site>.<backend>`` with backend in ``cuda | torch | host``, and
  ``serve.predict.quantized`` for the int8 serve), so a fallback never
  passes for a kernel result, and the in-process merges of a mesh's shards
  (``Collectives`` group: ``Gathers`` and the ``GatherBytes`` copied onto
  the merge device, exported when a run made any), and the cross-process
  collectives of ``parallel.collectives.AllReducer`` (the same group's
  ``AllReduces`` and ``AllReduceBytes``, the JAX package's names: one a
  tree level, one row-count allgather after a sharded ingest, one a KNN
  test chunk; exported when a run made any), and which CSV reader read
  each block (``IngestReaders`` group: ``<reader>.blocks`` and
  ``<reader>.rows`` for ``native``, ``python`` and ``cache``, and
  ``python.<reason>`` counting the Python blocks by why the native reader
  did not read them), so a Python fallback never passes for the native
  reader.
- :class:`LayerProfile` — per-level wall time of the training layers,
  taken only when a caller passes one to a builder.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

import numpy as np


class TransferLedger:
    """Measured link-traffic ledger for the current scope.  Recording
    helpers write into EVERY active ledger (a job-level one from cli.run
    and a caller's own can nest); the stack is global, not thread-local,
    so the serving loop's worker thread records into its spawner's scope."""

    __slots__ = ("h2d_bytes", "d2h_bytes", "h2d_transfers", "d2h_transfers",
                 "dispatches", "dispatch_sites", "kernel_backends", "gathers",
                 "gather_bytes", "allreduces", "allreduce_bytes", "ingest",
                 "_lock")

    def __init__(self):
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h2d_transfers = 0
        self.d2h_transfers = 0
        self.dispatches = 0
        self.dispatch_sites: Dict[str, int] = defaultdict(int)
        self.kernel_backends: Dict[str, int] = defaultdict(int)
        self.gathers = 0
        self.gather_bytes = 0
        self.allreduces = 0
        self.allreduce_bytes = 0
        self.ingest: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def record_h2d(self, nbytes: int, transfers: int = 1) -> None:
        with self._lock:
            self.h2d_bytes += int(nbytes)
            self.h2d_transfers += int(transfers)

    def record_d2h(self, nbytes: int, transfers: int = 1) -> None:
        with self._lock:
            self.d2h_bytes += int(nbytes)
            self.d2h_transfers += int(transfers)

    def record_dispatch(self, n: int = 1, site: Optional[str] = None) -> None:
        with self._lock:
            self.dispatches += int(n)
            if site:
                self.dispatch_sites[site] += int(n)

    def record_kernel_backend(self, site: str, backend: str,
                              n: int = 1) -> None:
        with self._lock:
            self.kernel_backends[f"{site}.{backend}"] += int(n)

    def record_gather(self, nbytes: int, n: int = 1) -> None:
        """One in-process merge of a mesh's shards: ``nbytes`` copied from
        the other shards' devices onto the merge device."""
        with self._lock:
            self.gathers += int(n)
            self.gather_bytes += int(nbytes)

    def record_allreduce(self, nbytes: int, n: int = 1) -> None:
        """One cross-process collective carrying ``nbytes`` of payload."""
        with self._lock:
            self.allreduces += int(n)
            self.allreduce_bytes += int(nbytes)

    def record_ingest(self, reader: str, rows: int,
                      reason: Optional[str] = None) -> None:
        """One block of ``rows`` rows read by ``reader`` (``native``,
        ``python`` or ``cache``); ``reason`` says why a Python block was
        not read natively."""
        with self._lock:
            self.ingest[f"{reader}.blocks"] += 1
            self.ingest[f"{reader}.rows"] += int(rows)
            if reason:
                self.ingest[f"{reader}.{reason}"] += 1

    def snapshot(self) -> Dict[str, int]:
        """The scalar tallies (the key set of the JAX package's ledger,
        which ``MetricsRegistry.attach_ledger`` renders)."""
        with self._lock:
            return {"h2d_bytes": self.h2d_bytes,
                    "d2h_bytes": self.d2h_bytes,
                    "h2d_transfers": self.h2d_transfers,
                    "d2h_transfers": self.d2h_transfers,
                    "dispatches": self.dispatches,
                    "allreduces": self.allreduces,
                    "allreduce_bytes": self.allreduce_bytes}

    def ingest_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.ingest)

    def site_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.dispatch_sites)

    def backend_snapshot(self) -> Dict[str, int]:
        """Per-site executed-backend counts, keys ``<site>.<backend>``."""
        with self._lock:
            return dict(self.kernel_backends)

    def export(self, counters, group: str = "Transfers") -> None:
        """Into the job Counters channel, Hadoop-dump style."""
        counters.update_group(group, {
            "H2DBytes": self.h2d_bytes, "D2HBytes": self.d2h_bytes,
            "H2DTransfers": self.h2d_transfers,
            "D2HTransfers": self.d2h_transfers,
            "Dispatches": self.dispatches})
        if self.gathers:
            counters.update_group("Collectives", {
                "Gathers": self.gathers, "GatherBytes": self.gather_bytes})
        if self.allreduces:
            counters.update_group("Collectives", {
                "AllReduces": self.allreduces,
                "AllReduceBytes": self.allreduce_bytes})
        if self.dispatch_sites:
            counters.update_group("Dispatches",
                                  dict(sorted(self.dispatch_sites.items())))
        if self.kernel_backends:
            counters.update_group("KernelBackends",
                                  dict(sorted(self.kernel_backends.items())))
        if self.ingest:
            counters.update_group("IngestReaders",
                                  dict(sorted(self.ingest.items())))


_ledgers: List[TransferLedger] = []
_ledgers_lock = threading.Lock()


@contextlib.contextmanager
def transfer_ledger(ledger: Optional[TransferLedger] = None
                    ) -> Iterator[TransferLedger]:
    """Activate a TransferLedger for the dynamic scope (fresh one by
    default); nests — inner scopes record into outer ledgers too."""
    led = ledger if ledger is not None else TransferLedger()
    with _ledgers_lock:
        _ledgers.append(led)
    try:
        yield led
    finally:
        with _ledgers_lock:
            _ledgers.remove(led)


def note_h2d(nbytes: int, transfers: int = 1) -> None:
    for led in list(_ledgers):
        led.record_h2d(nbytes, transfers)


def note_d2h(nbytes: int, transfers: int = 1) -> None:
    for led in list(_ledgers):
        led.record_d2h(nbytes, transfers)


def note_dispatch(n: int = 1, site: Optional[str] = None) -> None:
    for led in list(_ledgers):
        led.record_dispatch(n, site=site)


def note_kernel_backend(site: str, backend: str, n: int = 1) -> None:
    for led in list(_ledgers):
        led.record_kernel_backend(site, backend, n)


def note_ingest(reader: str, rows: int, reason: Optional[str] = None) -> None:
    for led in list(_ledgers):
        led.record_ingest(reader, rows, reason)


def note_gather(nbytes: int, n: int = 1) -> None:
    for led in list(_ledgers):
        led.record_gather(nbytes, n)


def note_allreduce(nbytes: int, n: int = 1) -> None:
    for led in list(_ledgers):
        led.record_allreduce(nbytes, n)


def fetch(tensor) -> np.ndarray:
    """Device tensor -> host numpy with D2H accounting: the one way the
    instrumented hot paths read a result back (it synchronises)."""
    note_d2h(tensor.element_size() * tensor.nelement())
    return tensor.cpu().numpy()


class LayerProfile:
    """Wall time of the training path's layers, per tree level: the
    builders wrap each layer (reassign, level histogram, int32 accumulate,
    counts D2H, host split choice, ...) in :func:`layer`.  Each layer
    synchronizes the device before and after, so its time is its own and
    not the queue's; that serializes host and device, so a profiled build
    runs slower than an unprofiled one.  Layers outside any level (branch
    codes, weights H2D) land in ``setup``."""

    def __init__(self, device=None):
        import torch
        self._sync = (torch.cuda.synchronize
                      if torch.device(device or "cpu").type == "cuda"
                      else (lambda: None))
        self.setup: Dict[str, float] = defaultdict(float)
        self.levels: List[Dict[str, float]] = []

    def next_level(self) -> None:
        self.levels.append(defaultdict(float))

    @contextlib.contextmanager
    def layer(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dest = self.levels[-1] if self.levels else self.setup
            dest[name] += time.perf_counter() - t0

    def median_ms(self) -> Dict[str, float]:
        """Per layer, the median over levels of its milliseconds a level."""
        names = sorted({k for lv in self.levels for k in lv})
        return {k: float(np.median([lv.get(k, 0.0) for lv in self.levels]))
                * 1e3 for k in names}


def layer(profile: Optional[LayerProfile], name: str):
    """``profile.layer(name)``, or a no-op context when not profiling."""
    return profile.layer(name) if profile is not None \
        else contextlib.nullcontext()


class StepTimer:
    """Accumulate wall time per named step; ``keep_samples > 0`` also keeps
    a bounded window of per-call durations so serving percentiles
    (p50/p95/p99, exported as integer MICROseconds) are observable."""

    def __init__(self, keep_samples: int = 0):
        self.totals: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.keep_samples = keep_samples
        self.samples: Dict[str, deque] = {}

    @contextlib.contextmanager
    def step(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        """Account one completed step of ``seconds`` wall time."""
        self.totals[name] += seconds
        self.calls[name] += 1
        if self.keep_samples > 0:
            q = self.samples.get(name)
            if q is None:
                q = self.samples[name] = deque(maxlen=self.keep_samples)
            q.append(seconds)

    def percentile_ms(self, name: str, q: float) -> float:
        s = self.samples.get(name)
        if not s:
            return 0.0
        return float(np.percentile(np.asarray(s), q)) * 1000.0

    def export(self, counters, group: str = "Profiling") -> None:
        """Every step exports ``<name>.timeMs`` and ``<name>.calls``; steps
        with samples also ``<name>.p50Us/.p95Us/.p99Us``."""
        for name, total in sorted(self.totals.items()):
            counters.set(group, f"{name}.timeMs", int(round(total * 1000)))
            counters.set(group, f"{name}.calls", self.calls[name])
            if self.samples.get(name):
                for q in (50, 95, 99):
                    counters.set(
                        group, f"{name}.p{q}Us",
                        int(round(self.percentile_ms(name, q) * 1000)))


def get_logger(name: str = "avenir_tpu_torch", debug_on: bool = False
               ) -> logging.Logger:
    """The reference's debug.on gate: DEBUG level when set, WARN otherwise."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG if debug_on else logging.WARNING)
    logger.propagate = False  # our handler only: no doubling via root
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    return logger
