"""Streaming window accumulators: port of ``avenir_tpu/monitor/accumulator.py``.

Layout is the baseline's stacked (R, B_max) count matrix.  Absorbing a row
block is one bin-counts launch (``kernels/histogram.py`` ``bin_counts``,
kernel B4) that adds the block's counts in place into the window's float32
matrix on the device; ``finalize()`` is the only host readback.  Blocks
longer than ``BLOCK_ROWS`` (4,096, the reference's top bucket) split
there, as in the reference, so the float32 adds are the same ones.
The reference's padding of a block up to a power-of-two bucket only bounds
its jit's shapes; padded rows are masked out and add nothing, so the port
launches on the block as it is.

Windows:

  * tumbling — close after ``window_rows`` rows (and/or ``window_s``
    seconds); each closed window scores against the baseline.
  * exponential-decay long window — after each tumbling close,
    ``long = decay * long + window`` on the host in float64 (the
    just-read-back snapshot), scored as kind ``longterm``.

``ServingMonitor`` is the :class:`PredictionService` hook: per served
micro-batch it buffers rows and labels; every ``flush_rows`` requests the
buffer is encoded and absorbed (on a daemon thread unless
``async_flush=False``).  A failed flush is counted
(``DriftMonitor/RecordErrors``) and warned, never raised into serving.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.metrics import Counters
from ..core.table import ColumnarTable, encode_rows
from ..kernels.dispatch import note_backend, resolve_backend
from ..kernels.histogram import bin_counts
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch, note_h2d
from .baseline import Baseline, encode_monitor_codes
from .drift import DriftReport, DriftScorer

# the reference's top block bucket: the split of a long absorbed block
BLOCK_ROWS = 4096


@dataclass
class WindowSnapshot:
    """One finalized window: host counts + bookkeeping."""
    index: int
    counts: np.ndarray          # (R, B_max) float64
    n_rows: int
    t_start: float
    t_end: float


class DriftAccumulator:
    """A device (R, B_max) float32 window matrix and its in-place absorb."""

    def __init__(self, baseline: Baseline, device=None):
        self.baseline = baseline
        self.device = resolve_device(device)
        self._shape = baseline.counts.shape
        self._counts = torch.zeros(self._shape, dtype=torch.float32,
                                   device=self.device)
        self._n = 0

    @property
    def n_rows(self) -> int:
        return self._n

    def absorb_codes(self, codes: np.ndarray) -> None:
        """Add one (n, R) int32 code block: one B4 launch per
        ``BLOCK_ROWS`` slice of it, each adding into the window matrix in
        place."""
        n = codes.shape[0]
        if n == 0:
            return
        codes = np.ascontiguousarray(codes, dtype=np.int32)
        note_h2d(codes.nbytes)
        d_codes = torch.from_numpy(codes).to(self.device)
        backend = resolve_backend(self.device)
        for s in range(0, n, BLOCK_ROWS):
            note_dispatch(site="monitor.absorb")
            note_backend("monitor.absorb", backend)
            bin_counts(d_codes[s:s + BLOCK_ROWS], self._shape[1],
                       out=self._counts)
        self._n += n

    def absorb_table(self, table: ColumnarTable,
                     class_codes: Optional[np.ndarray] = None) -> None:
        self.absorb_codes(encode_monitor_codes(
            table, self.baseline.specs, class_codes=class_codes))

    def warm(self) -> "DriftAccumulator":
        """Build the kernel off the live path: one launch on an empty block
        into a scratch matrix (the window's state is untouched)."""
        scratch = torch.zeros(self._shape, dtype=torch.float32,
                              device=self.device)
        bin_counts(torch.zeros((0, self._shape[0]), dtype=torch.int32,
                               device=self.device), self._shape[1],
                   out=scratch)
        return self

    def finalize(self) -> "tuple[np.ndarray, int]":
        """The host sync: read the device matrix back and reset the
        accumulator (tumbling).  Returns (counts float64, n_rows)."""
        counts = fetch(self._counts).astype(np.float64)
        n = self._n
        self._counts.zero_()
        self._n = 0
        return counts, n


class StreamDriftMonitor:
    """Tumbling + exponential-decay windows over a code/table stream,
    scored on close and fed to an optional policy.

    ``observe_*`` absorbs rows, closing (and scoring) a window every
    ``window_rows`` rows or ``window_s`` seconds; each close also decays
    the long window and scores it as kind ``longterm``.  Reports are kept
    in ``self.reports`` (bounded); alerts accumulate in the policy."""

    def __init__(self, baseline: Baseline, scorer: Optional[DriftScorer]
                 = None, policy=None, window_rows: int = 4096,
                 window_s: Optional[float] = None, decay: float = 0.9,
                 counters: Optional[Counters] = None,
                 keep_reports: int = 256, device=None):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        if window_rows < 1:
            # observe_codes fills windows by remaining room; a
            # non-positive size would never make progress
            raise ValueError(f"window_rows must be >= 1, got {window_rows}")
        self.baseline = baseline
        self.scorer = scorer or DriftScorer(baseline, device=device)
        self.policy = policy
        self.window_rows = int(window_rows)
        self.window_s = window_s
        self.decay = float(decay)
        self.counters = counters if counters is not None else Counters()
        self.keep_reports = keep_reports
        self.acc = DriftAccumulator(baseline, device=self.scorer.device)
        self._long_counts = np.zeros_like(baseline.counts)
        self._long_n = 0.0
        self._window_start = time.monotonic()
        self._index = 0
        self.reports: List[DriftReport] = []

    def warm(self) -> "StreamDriftMonitor":
        """Build the absorb kernel and run the scorer once off the live
        path (no window, no policy, no report)."""
        self.acc.warm()
        self.scorer.score_counts(np.zeros_like(self.baseline.counts), 0)
        return self

    # ---- ingestion ----
    def observe_codes(self, codes: np.ndarray) -> None:
        n = codes.shape[0]
        s = 0
        while s < n:
            room = self.window_rows - self.acc.n_rows
            take = min(room, n - s)
            self.acc.absorb_codes(codes[s:s + take])
            s += take
            if self.acc.n_rows >= self.window_rows:
                self.close_window()
        if self.window_s is not None and self.acc.n_rows > 0 and \
                time.monotonic() - self._window_start >= self.window_s:
            self.close_window()

    def observe_table(self, table: ColumnarTable,
                      class_codes: Optional[np.ndarray] = None) -> None:
        self.observe_codes(encode_monitor_codes(
            table, self.baseline.specs, class_codes=class_codes))

    # ---- window close ----
    def close_window(self, force: bool = False) -> Optional[DriftReport]:
        """Finalize the current tumbling window (no-op when empty unless
        ``force``), score it, decay-merge it into the long window and
        score that too.  Returns the tumbling report."""
        if self.acc.n_rows == 0 and not force:
            return None
        counts, n = self.acc.finalize()
        return self._close(counts, n)

    def close_counts(self, counts: np.ndarray, n: int
                     ) -> Optional[DriftReport]:
        """Close one externally accumulated window through the same
        scoring / long-window decay / policy path as :meth:`close_window`.
        Refuses while the internal accumulator holds rows (one window must
        use one absorb path)."""
        if self.acc.n_rows:
            raise ValueError(
                f"close_counts with {self.acc.n_rows} internally "
                f"accumulated rows pending — one window must use one "
                f"absorb path")
        if n == 0:
            return None
        return self._close(np.asarray(counts, dtype=np.float64), int(n))

    def _close(self, counts: np.ndarray, n: int) -> DriftReport:
        now = time.monotonic()
        # the exponential-decay long window rides the just-read host copy;
        # the window and its long window score in one pass
        self._long_counts = self.decay * self._long_counts + counts
        self._long_n = self.decay * self._long_n + n
        report, long_report = self.scorer.score_many([
            (counts, n, self._index, "window"),
            (self._long_counts, int(self._long_n), self._index,
             "longterm")])
        self._remember(report)
        self._remember(long_report)
        self.counters.increment("DriftMonitor", "WindowsScored")
        self.counters.increment("DriftMonitor", "RowsSeen", n)
        if self.policy is not None:
            self.policy.observe(report)
            self.policy.observe(long_report)
        self._index += 1
        self._window_start = now
        return report

    def _remember(self, report: DriftReport) -> None:
        self.reports.append(report)
        if len(self.reports) > self.keep_reports:
            del self.reports[:len(self.reports) - self.keep_reports]


class ServingMonitor:
    """The PredictionService hook: record served (row, predicted-label)
    pairs and score them against the model's training baseline.

    ``record_batch`` runs on the serving thread and only buffers; every
    ``flush_rows`` requests the buffer goes to a daemon monitor thread that
    encodes once and absorbs once (``async_flush=False`` keeps it inline:
    deterministic, for tests and batch jobs).  Predicted labels map to
    class codes through the baseline's class-row vocabulary.  A failure
    inside a flush is caught, counted and warned."""

    def __init__(self, baseline: Baseline, schema,
                 policy=None, window_rows: int = 1024,
                 flush_rows: int = 256, decay: float = 0.9,
                 window_s: Optional[float] = None,
                 counters: Optional[Counters] = None,
                 async_flush: bool = True, device=None):
        self.schema = schema
        self.counters = counters if counters is not None else Counters()
        self.stream = StreamDriftMonitor(
            baseline, policy=policy, window_rows=window_rows,
            window_s=window_s, decay=decay, counters=self.counters,
            device=device)
        self.flush_rows = int(flush_rows)
        self._rows: List[List[str]] = []
        self._labels: List[str] = []
        self.async_flush = async_flush
        self._pending: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    @property
    def reports(self) -> List[DriftReport]:
        return self.stream.reports

    def warm(self) -> "ServingMonitor":
        """Build the kernel and run the scorer once so the first live
        flush does not pay for it on the serving path."""
        self.stream.warm()
        return self

    def record_batch(self, rows: List[List[str]],
                     labels: List[str]) -> None:
        """Request-path entry: buffer only."""
        self._rows.extend(rows)
        self._labels.extend(labels)
        if len(self._rows) >= self.flush_rows:
            self.flush()

    def flush(self) -> None:
        """Hand the buffer to the monitor thread (or absorb inline when
        ``async_flush=False``)."""
        if not self._rows:
            return
        rows, labels = self._rows, self._labels
        self._rows, self._labels = [], []
        if self.async_flush:
            self._pending.put((rows, labels))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain, daemon=True,
                    name="avenir-monitor-flush")
                self._thread.start()
        else:
            self._absorb(rows, labels)

    def _drain(self) -> None:
        while True:
            item = self._pending.get()
            if item is None:
                return
            self._absorb(*item)

    def _absorb(self, rows: List[List[str]], labels: List[str]) -> None:
        try:
            table = encode_rows(rows, self.schema)
            codes = self.stream.baseline.class_codes_for_labels(labels)
            self.stream.observe_table(table, class_codes=codes)
        except Exception as exc:
            self.counters.increment("DriftMonitor", "RecordErrors",
                                    len(rows))
            warnings.warn(
                f"monitor: dropping {len(rows)} recorded rows "
                f"({type(exc).__name__}: {exc}) — serving unaffected",
                RuntimeWarning)

    def close(self) -> Optional[DriftReport]:
        """Flush the buffer, drain the monitor thread, and score whatever
        partial window remains."""
        self.flush()
        if self._thread is not None:
            self._pending.put(None)
            self._thread.join(timeout=60)
            self._thread = None
        return self.stream.close_window()
