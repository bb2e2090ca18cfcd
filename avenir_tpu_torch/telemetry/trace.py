"""Span tracing: port of ``avenir_tpu/telemetry/trace.py`` — the per-run
Tracer and the process-global ``span()`` entry.

1. **Free when off.**  Every instrumented hot path calls ``span(...)``
   unconditionally; with no tracer installed and no capture annotated
   that is one module-global read and the return of a shared null
   context manager.  The paths are instrumented at batch, call or build
   granularity, never per row, and a span never synchronises a device.

2. **Events ARE Chrome trace events.**  The JSONL buffer flushes lines
   that are already catapult dicts (``ph: "X"`` complete events with
   epoch-anchored microsecond ``ts``/``dur``, ``ph: "i"`` instants,
   ``ph: "M"`` thread/process metadata, ``s``/``t``/``f`` flow legs), so
   the Chrome export is a sort + wrap, and a multi-process merge
   (:func:`merge_trace_files`) is a concatenation: every process anchors
   its monotonic clock to the epoch at tracer construction.

3. **Threads are lanes.**  ``tid`` is a stable small integer per thread
   (announced once via a ``thread_name`` metadata event).

4. **Spans reach the device capture.**  Inside :func:`annotate_capture`
   (``utils.tracing.trace`` opens it for the length of its
   ``torch.profiler`` capture) each span also opens a profiler range
   (``record_function``'s, in its C++ form) named ``av:<name>``, so the
   capture holds the program's spans beside its kernels.  Its host clock
   is the epoch's, as the tracer's is, so a span's JSONL ``ts`` and its
   range start agree to well under a millisecond.

The tracer is process-global (``install_tracer``), like the transfer
ledger's stack: threads a pipeline spawns land their spans in the run
that spawned them.  The files this module writes are the JAX package's
format, so either package's tools read either package's traces.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import weakref
from typing import Dict, Iterator, List, Optional

TRACE_SUFFIX = ".jsonl"
CHROME_SUFFIX = ".chrome.json"

# one encoder for every line: json.dumps with separators builds a new
# encoder per call, a third of a span's cost under a tracer
_line = json.JSONEncoder(separators=(",", ":")).encode

# Chrome trace-event schema subset this module emits (and the validator
# checks): complete spans, instants, metadata, and legacy flow events (s/t/f) carrying one sampled request's id across
# process lanes (client enqueue -> worker pop -> dispatch -> reply).
_REQUIRED_KEYS = {
    "X": ("name", "ph", "ts", "dur", "pid", "tid"),
    "i": ("name", "ph", "ts", "pid", "tid"),
    "B": ("name", "ph", "ts", "pid", "tid"),
    "E": ("ph", "ts", "pid", "tid"),
    "M": ("name", "ph", "pid"),
    "s": ("name", "ph", "ts", "pid", "tid", "id"),
    "t": ("name", "ph", "ts", "pid", "tid", "id"),
    "f": ("name", "ph", "ts", "pid", "tid", "id"),
}

FLOW_PHASES = ("s", "t", "f")


class Tracer:
    """Buffered span/event recorder for ONE process of ONE run.

    Writes ``trace-<run_id>.p<index>.jsonl`` under ``trace_dir`` — one
    JSON trace event per line, first line a ``process_name`` metadata
    event carrying the run id — and, on :meth:`close`, a ready-to-load
    Chrome export next to it (``...chrome.json``).  ``flush()`` is called
    automatically every ``buffer_events`` records, so a killed process
    leaves at most one buffer of spans unwritten (the survivors' stall
    events are what name it)."""

    def __init__(self, trace_dir: str, run_id: str = "run",
                 process_index: int = 0, buffer_events: int = 2048):
        os.makedirs(trace_dir, exist_ok=True)
        self.dir = trace_dir
        self.run_id = str(run_id)
        self.process_index = int(process_index)
        self.path = os.path.join(
            trace_dir, f"trace-{self.run_id}.p{self.process_index:05d}"
            f"{TRACE_SUFFIX}")
        self.buffer_events = int(buffer_events)
        self._buf: List[dict] = []
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        # weak keys: exited threads fall out instead of pinning their
        # Thread objects (and a recycled ident can never alias a lane)
        self._tids: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        # each thread's own lane id, cached where only that thread reads it
        self._lane = threading.local()
        self._next_tid = 1
        self._closed = False
        # epoch-anchored monotonic clock: ts = unix time at construction
        # plus a perf_counter delta — monotonic within the process, and
        # aligned across same-machine shard processes to wall-clock skew
        self._t0_unix_us = time.time() * 1e6
        self._t0_perf = time.perf_counter()
        # APPEND and announce the process lane: a resumed sharded run
        # derives the identical run id (cli.run hashes job+input so all
        # shards agree), so truncating here would destroy the crashed
        # attempt's timeline — including the allreduce.stall events that
        # name the dead shard, the exact evidence the operator is about
        # to look for.  Both attempts share the run id and epoch-anchored
        # clocks, so the merged timeline stays laminar per lane.
        with open(self.path, "ab") as fh:
            # a crashed attempt can leave a torn final line (killed
            # mid-flush, no trailing newline) — appending our header
            # straight onto it would fuse both into one unparseable
            # line; seal the torn tail first so only the fragment is
            # lost, not the resumed run's metadata too
            if fh.tell() > 0:
                with open(self.path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        fh.write(b"\n")
            fh.write((json.dumps({
                "ph": "M", "name": "process_name",
                "pid": self.process_index, "tid": 0,
                "args": {"name": f"{self.run_id} shard "
                                 f"{self.process_index}"},
                "run_id": self.run_id},
                separators=(",", ":")) + "\n").encode())

    # ---- clock ----
    def now_us(self) -> float:
        return self._t0_unix_us + \
            (time.perf_counter() - self._t0_perf) * 1e6

    # ---- recording ----
    def _tid(self) -> int:
        """Stable small lane id for the calling thread; announces a
        ``thread_name`` metadata event the first time a thread records.
        Keyed by the Thread OBJECT (weakly), not ``get_ident()``: the OS
        recycles idents, so a later thread reusing a dead staging
        thread's ident must get a fresh lane — not record its spans
        under the dead thread's name on the dead thread's lane."""
        tid = getattr(self._lane, "tid", None)
        if tid is None:
            tid = self._lane.tid = self._tid_for(threading.current_thread())
        return tid

    def _tid_for(self, thread: threading.Thread) -> int:
        tid = self._tids.get(thread)
        if tid is not None:
            return tid
        with self._lock:
            tid = self._tids.get(thread)
            if tid is None:
                tid = self._next_tid
                self._next_tid += 1
                self._tids[thread] = tid
                self._buf.append({
                    "ph": "M", "name": "thread_name",
                    "pid": self.process_index, "tid": tid,
                    "args": {"name": thread.name}})
        return tid

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._buf.append(ev)
            # after close() nothing will ever flush again, so write
            # through immediately: a straggler thread finishing its span
            # during teardown records the TAIL of an aborted job — the
            # part of the trace that matters most (the chrome export is
            # already written; the JSONL stays the source of truth and
            # a re-export reads it)
            need_flush = self._closed or \
                len(self._buf) >= self.buffer_events
        if need_flush:
            self.flush()

    def complete(self, name: str, t0_us: float, dur_us: float,
                 cat: Optional[str] = None, args: Optional[dict] = None
                 ) -> None:
        """One finished span as a Chrome complete ('X') event."""
        # to a tenth of a microsecond: round(x, 1) costs four times more
        ev = {"ph": "X", "name": name, "ts": int(t0_us * 10.0 + 0.5) / 10.0,
              "dur": int(max(dur_us, 0.0) * 10.0 + 0.5) / 10.0,
              "pid": self.process_index, "tid": self._tid()}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, name: str, cat: Optional[str] = None,
                on_thread: Optional[threading.Thread] = None,
                **args) -> None:
        """A point-in-time event (Chrome 'i', process scope) — stall
        events, degradation flips, hot-swaps.  ``on_thread`` pins the
        event to that thread's lane instead of the caller's: a watchdog
        Timer firing on behalf of a blocked caller must mark the
        CALLER's lane, not scatter one-event lanes named Thread-N."""
        lane = self._tid() if on_thread is None else \
            self._tid_for(on_thread)
        ev = {"ph": "i", "s": "p", "name": name,
              "ts": round(self.now_us(), 1),
              "pid": self.process_index, "tid": lane}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._append(ev)

    def flow(self, name: str, phase: str, flow_id,
             cat: Optional[str] = None, ts_us: Optional[float] = None,
             args: Optional[dict] = None) -> None:
        """One leg of a Chrome legacy flow (``s`` start / ``t`` step /
        ``f`` finish): the arrow connecting one sampled request's hops
        across process lanes.  All legs of one flow must share cat, name
        AND id (catapult binds on the triplet), so callers keep the name
        constant and put the hop label in ``args``.  ``ts_us`` pins the
        event to a timestamp the caller already took (a stamped wire
        enqueue time) instead of now."""
        if phase not in FLOW_PHASES:
            raise ValueError(f"flow phase must be one of {FLOW_PHASES}, "
                             f"got {phase!r}")
        ev = {"ph": phase, "name": name, "id": str(flow_id),
              "ts": round(self.now_us() if ts_us is None else ts_us, 1),
              "pid": self.process_index, "tid": self._tid()}
        if phase == "f":
            ev["bp"] = "e"   # bind to the enclosing slice, chrome-style
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._append(ev)

    # ---- persistence ----
    def flush(self) -> None:
        """Append the buffered events to the JSONL file.  IO runs outside
        the record lock so a slow disk never blocks the hot paths for
        longer than one buffer swap."""
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return
        lines = "".join(_line(ev) + "\n" for ev in buf)
        with self._io_lock:
            with open(self.path, "a") as fh:
                fh.write(lines)

    def chrome_export(self, out_path: Optional[str] = None) -> str:
        """Write the catapult JSON (``{"traceEvents": [...]}``, ts-sorted)
        for THIS process's trace file; returns the path written.
        Tmp-then-rename, so a crash mid-export never leaves a torn file
        that chrome://tracing would half-load."""
        self.flush()
        out = out_path or (self.path[:-len(TRACE_SUFFIX)] + CHROME_SUFFIX)
        events = read_trace_file(self.path)
        _write_chrome(out, events)
        return out

    def close(self) -> str:
        """Flush and write the Chrome export; idempotent."""
        if self._closed:
            return self.path
        self._closed = True
        self.flush()
        self.chrome_export()
        return self.path


# --------------------------------------------------------------------------
# the process-global tracer + the span() fast path
# --------------------------------------------------------------------------

# the name prefix of a span's range in a device capture: the program's own,
# apart from aten ops and from the ranges other owners of a capture open
RANGE_PREFIX = "av:"

_active: Optional[Tracer] = None
# open annotate_capture() scopes, and torch's range type while any is
_captures = 0
_range = None
_captures_lock = threading.Lock()
# the one global span() reads: a tracer installed or a capture annotated
_on = False


def _refresh() -> None:
    global _on
    _on = _active is not None or _captures > 0


def install_tracer(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-global recorder every ``span()`` call
    site writes into (one at a time — telemetry is per run)."""
    global _active
    _active = tracer
    _refresh()
    return tracer


def uninstall_tracer() -> Optional[Tracer]:
    global _active
    t, _active = _active, None
    _refresh()
    return t


def current_tracer() -> Optional[Tracer]:
    return _active


@contextlib.contextmanager
def annotate_capture() -> Iterator[None]:
    """The switch for an owner of a ``torch.profiler`` capture: while
    open, every ``span()`` also opens a profiler range named
    ``av:<name>`` that the capture records.  Open it only while a capture
    is live (a range costs time even with no profiler running).  Scopes
    nest and may overlap across threads; the last to close turns the
    ranges off."""
    global _captures, _range
    import torch
    # the C++ form of record_function (torch's compiler annotates with
    # it): about 2 us to enter and leave under a live capture, and nothing
    # on the device timeline.  The Python form costs tens of us there and
    # lays a copy of each range on the device timeline, which a reader of
    # the capture's kernels would count as device work: never that one
    ranges = torch._C._profiler._RecordFunctionFast
    # a process's first range pays the op's set-up, most of a millisecond
    # between the range's start and the span's clock: pay it here
    with ranges(RANGE_PREFIX + "annotate_capture"):
        pass
    with _captures_lock:
        _range = ranges
        _captures += 1
        _refresh()
    try:
        yield
    finally:
        with _captures_lock:
            _captures -= 1
            _refresh()


class _NullSpan:
    """The off path: a shared, reusable, do-nothing context manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **args) -> None:
        """No-op twin of _LiveSpan.add."""


NULL_SPAN = _NullSpan()


class _LiveSpan:
    """A span on the tracer, in the capture, or both (either may be
    None)."""
    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0", "_range")

    def __init__(self, tr: Optional[Tracer], name: str, cat: Optional[str],
                 args: Optional[dict], range_type):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args
        self._range = None if range_type is None else \
            range_type(RANGE_PREFIX + name)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._tr is not None:
            self._t0 = self._tr.now_us()
        return self

    def __exit__(self, *exc):
        if self._tr is not None:
            self._tr.complete(self._name, self._t0,
                              self._tr.now_us() - self._t0,
                              cat=self._cat, args=self._args)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def add(self, **args) -> None:
        """Attach attributes discovered mid-span (e.g. rows parsed)."""
        if self._args is None:
            self._args = dict(args)
        else:
            self._args.update(args)


def span(name: str, cat: Optional[str] = None, **args):
    """Context manager timing one pipeline stage.  THE instrumentation
    entry: ``with span("parse.chunk", cat="parse", block=i): ...``.
    Returns the shared null span when no tracer is installed and no
    capture is annotated."""
    if not _on:
        return NULL_SPAN
    return _LiveSpan(_active, name, cat, args or None,
                     _range if _captures else None)


def instant(name: str, cat: Optional[str] = None,
            on_thread: Optional[threading.Thread] = None, **args) -> None:
    """Record a point event on the installed tracer (no-op when off).
    ``on_thread`` pins the event to that thread's lane (watchdogs firing
    on behalf of a blocked caller)."""
    tr = _active
    if tr is not None:
        tr.instant(name, cat=cat, on_thread=on_thread, **args)


def flow(name: str, phase: str, flow_id, cat: Optional[str] = None,
         ts_us: Optional[float] = None, **args) -> None:
    """Record one flow leg on the installed tracer (no-op when off) —
    see :meth:`Tracer.flow`."""
    tr = _active
    if tr is not None:
        tr.flow(name, phase, flow_id, cat=cat, ts_us=ts_us,
                args=args or None)


# --------------------------------------------------------------------------
# trace-file reading / validation / merge
# --------------------------------------------------------------------------

def read_trace_file(path: str) -> List[dict]:
    """All events of one per-process JSONL trace file.  A torn final line
    (killed process mid-append) is dropped with the rest intact — exactly
    the crash the multi-shard stall scenario produces."""
    events: List[dict] = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail from a killed writer
    return events


def validate_trace_events(events: List[dict]) -> List[str]:
    """Check ``events`` against the Chrome trace-event schema subset this
    module emits; returns a list of problem strings (empty == valid).

    Rules: every event carries the required keys for its phase; ts/dur
    are non-negative numbers; within one (pid, tid) lane the 'X' spans
    form a laminar family — disjoint or fully nested, never partially
    crossing (spans on one lane come from a LIFO stack of context
    managers on one thread, so a crossing means the clock ran backwards,
    e.g. events with mixed epoch anchors merged into one lane); any
    legacy B/E duration events pair up per lane; per flow id, at most
    one ``s`` start and one ``f`` finish (a dangling ``t``/``f`` with
    no ``s`` is NOT flagged — one process's file is a legitimate
    partial view of a multi-process flow)."""
    problems: List[str] = []
    open_stacks: Dict[tuple, List[str]] = {}
    lane_spans: Dict[tuple, List[tuple]] = {}
    flow_counts: Dict[str, List[int]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in _REQUIRED_KEYS:
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        for key in _REQUIRED_KEYS[ph]:
            if key not in ev:
                problems.append(f"event {i} (ph={ph}): missing {key!r}")
        for key in ("ts", "dur"):
            if key in ev and (not isinstance(ev[key], (int, float))
                              or ev[key] < 0):
                problems.append(
                    f"event {i} (ph={ph}): {key} must be a non-negative "
                    f"number, got {ev[key]!r}")
        if ph in ("s", "f") and "id" in ev:
            cnt = flow_counts.setdefault(str(ev["id"]), [0, 0])
            cnt[0 if ph == "s" else 1] += 1
        if ph == "X" and isinstance(ev.get("ts"), (int, float)) \
                and isinstance(ev.get("dur"), (int, float)):
            lane_spans.setdefault(
                (ev.get("pid"), ev.get("tid")), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev.get("name"), i))
        elif ph == "B":
            open_stacks.setdefault(
                (ev.get("pid"), ev.get("tid")), []).append(ev.get("name"))
        elif ph == "E":
            stack = open_stacks.get((ev.get("pid"), ev.get("tid")), [])
            if not stack:
                problems.append(f"event {i}: 'E' with no open 'B' on its "
                                f"(pid, tid) lane")
            else:
                stack.pop()
    for (pid, tid), stack in open_stacks.items():
        for name in stack:
            problems.append(f"unmatched 'B' event {name!r} on lane "
                            f"(pid={pid}, tid={tid})")
    for fid, (n_s, n_f) in sorted(flow_counts.items()):
        if n_s > 1:
            problems.append(f"flow {fid!r}: {n_s} 's' start events "
                            f"(must be at most one)")
        if n_f > 1:
            problems.append(f"flow {fid!r}: {n_f} 'f' finish events "
                            f"(must be at most one)")
    # lane timeline check: 1µs slack absorbs the 0.1µs ts/dur rounding
    eps = 1.0
    for (pid, tid), spans in lane_spans.items():
        spans.sort(key=lambda s: (s[0], s[0] - s[1]))
        stack: List[tuple] = []
        for t0, t1, name, i in spans:
            while stack and t0 >= stack[-1][1] - eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                problems.append(
                    f"event {i} (ph=X): span {name!r} crosses "
                    f"{stack[-1][2]!r} on lane (pid={pid}, tid={tid}) — "
                    f"not a valid single-thread timeline")
                continue
            stack.append((t0, t1, name))
    return problems


def merge_trace_files(paths: List[str]) -> List[dict]:
    """Concatenate the events of several per-process trace files into one
    ts-sorted timeline.  Epoch-anchored timestamps make this a plain
    merge; distinct run ids are allowed because merging
    a re-run shard's tail onto a crashed run's lanes is sometimes exactly
    what the operator wants to look at."""
    events: List[dict] = []
    for p in paths:
        events.extend(read_trace_file(p))
    return _ts_sorted(events)


def _ts_sorted(events: List[dict]) -> List[dict]:
    # metadata events carry no ts; keep them first so lanes are named
    # before any span lands on them
    return sorted(events,
                  key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))


def _write_chrome(out_path: str, events: List[dict]) -> None:
    payload = {"traceEvents": _ts_sorted(events),
               "displayTimeUnit": "ms"}
    tmp = f"{out_path}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, separators=(",", ":"))
    os.replace(tmp, out_path)


def write_chrome_trace(out_path: str, events: List[dict]) -> str:
    """Public wrapper: write ``events`` as a catapult JSON file."""
    _write_chrome(out_path, events)
    return out_path
