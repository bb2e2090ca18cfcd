"""What every cell's run shares: finding a cell's files by name, the
closed-loop window, the spans the traced run opens around the program's
layers, the reading of the device capture, and the result line.

Files, all found by name (a later change adds files, it edits none):

* ``cells/<cell>.json`` — the configuration, the traffic kind, the traffic
  parameters and why the cell exists;
* ``configs/<config>.json`` — the deployment: schema, job settings, scale;
* ``traffic/<kind>.py`` — the closed loop of one traffic kind;
* ``metrics/<metric>.py`` — the reader of one per-layer metric;
* ``work/<kernel>.py`` — the work a kernel's problem needs, from shapes.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import json
import os
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
CHECKOUT = PACKAGE_DIR.parent

# top-level module names that may not be loaded in the process that prints
# a result: JAX and the JAX package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "avenir_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell_files(workload: str) -> Tuple[dict, dict]:
    """(cell, configuration) of ``workload``, by name."""
    cell = load_json(PACKAGE_DIR / "cells" / f"{workload}.json")
    config = load_json(PACKAGE_DIR / "configs" / f"{cell['config']}.json")
    return cell, config


def traffic_module(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py`` loaded by path (metric names hold dots)."""
    path = PACKAGE_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``workload`` reports: those that list it, and those that list no cells
    at all."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def forbidden_loaded(modules: Sequence[str]) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's."""
    return sorted({m for m in modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start time."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``seed``: which window calls the check compares."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.items: Dict[int, object] = {}
        self.seen = 0

    def wants(self, i: int) -> Optional[int]:
        """The slot call ``i`` should take, or None: decide before making
        the item, so an item that is not kept costs nothing."""
        self.seen += 1
        if len(self.items) < self.size:
            return i
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            return sorted(self.items)[j]
        return None

    def put(self, slot: int, i: int, item) -> None:
        self.items.pop(slot, None)
        self.items[i] = item


# --------------------------------------------------------------------------
# spans (traced runs only)
# --------------------------------------------------------------------------

class Spans:
    """Host spans around the program's layers in a traced run.  Each span
    synchronises the device at its start and its end, so the device work
    launched inside it runs inside it, and opens a
    ``torch.profiler.record_function`` named ``pb:<name>`` that the capture
    records.  Host seconds and counts are kept per name.

    It is also the ``profile=`` object of the forest builders: it has
    ``utils.tracing.LayerProfile``'s ``layer()`` and ``next_level()``."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.seconds: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    def next_level(self) -> None:
        pass

    @contextlib.contextmanager
    def layer(self, name: str):
        from torch.profiler import record_function
        self.sync()
        t0 = time.perf_counter()
        with record_function(f"pb:{name}"):
            try:
                yield
            finally:
                self.sync()
        self.seconds[name] += time.perf_counter() - t0
        self.count[name] += 1

    def wrap(self, module, attr: str, name: str) -> bool:
        """Replace ``module.attr`` by a call inside span ``name``; False
        (and nothing wrapped) when the program no longer has it."""
        fn = getattr(module, attr, None)
        if not callable(fn):
            return False

        def spanned(*args, **kwargs):
            with self.layer(name):
                return fn(*args, **kwargs)
        setattr(module, attr, spanned)
        return True


# --------------------------------------------------------------------------
# the device capture
# --------------------------------------------------------------------------

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(ev) -> str:
    """``kernel``, ``gpu_memcpy``, ``gpu_memset``, ``span`` (a ``pb:``
    span on the host) or ``other`` (host ops, and the device timeline's
    copies of the spans, which cover kernels but are none)."""
    on_device = "cuda" in str(ev.device_type()).lower()
    name = ev.name()
    if name.startswith("pb:"):
        return "other" if on_device else "span"
    if not on_device:
        return "other"
    kind = str(ev.activity_type()) if hasattr(ev, "activity_type") else ""
    if kind in DEVICE_KINDS:
        return kind
    if "annotation" in kind:
        return "other"
    return "gpu_memcpy" if name.startswith("Memcpy") else \
        "gpu_memset" if name.startswith("Memset") else "kernel"


# a CUDA API call on the host (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): the launch a kernel's correlation id points back to
_API_CALL = re.compile(r"cu(da)?[A-Z]")


def _corr(ev) -> Tuple[int, ...]:
    """An event's non-zero correlation ids (its own and the one it links
    to: a runtime call and the kernel it launched share one)."""
    ids = (getattr(ev, "correlation_id", lambda: 0)(),
           getattr(ev, "linked_correlation_id", lambda: 0)())
    return tuple(int(c) for c in ids if c)


def kernel_name(name: str) -> str:
    """A demangled kernel name without its return type, anonymous
    namespaces, template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0]


def union_ns(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Overlapping intervals merged, in order."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Capture:
    """The events of one ``torch.profiler`` capture, cut to the window the
    run marks with the span ``pb:window``: device intervals (kernels,
    memcpys, memsets), kernel names, and the ``pb:`` spans."""

    def __init__(self, events):
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.kinds: Dict[str, int] = defaultdict(int)
        device = []
        # host time of each runtime call, by correlation id: a kernel is
        # placed in the span its launch fell in, on the host's clock
        launched: Dict[int, int] = {}
        for ev in events:
            kind = _kind(ev)
            start = int(ev.start_ns())
            end = start + int(ev.duration_ns())
            activity = str(ev.activity_type()) if hasattr(
                ev, "activity_type") else kind
            self.kinds[activity] += 1
            if kind in DEVICE_KINDS:
                device.append((start, end, kind, ev.name(), _corr(ev)))
            elif kind == "span":
                self.spans[ev.name()[3:]].append((start, end))
            elif kind == "other" and _API_CALL.match(ev.name()):
                for c in _corr(ev):
                    launched[c] = start
        win = self.spans.get("window")
        if not win:
            raise RuntimeError("the capture holds no pb:window span")
        self.t0, self.t1 = win[0]
        self.device = [(a, b, kind, name, next(
            (launched[c] for c in corr if c in launched), None))
            for a, b, kind, name, corr in device
            if a < self.t1 and b > self.t0]
        self.kernels = [d for d in self.device if d[2] == "kernel"]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        return sum(min(b, self.t1) - max(a, self.t0) for a, b in
                   union_ns([(d[0], d[1]) for d in self.device])) / 1e9

    def kernel_s_in(self, span: str) -> Optional[float]:
        """Device seconds of the kernels launched inside a ``span`` span of
        the window (by the launch's host time; by the kernel's start where
        the capture lost the launch); None when the window holds no such
        span."""
        spans = sorted(s for s in self.spans.get(span, [])
                       if s[0] >= self.t0 and s[1] <= self.t1)
        if not spans:
            return None
        starts = np.array([s[0] for s in spans])
        ends = np.array([s[1] for s in spans])
        total = 0
        for a, b, _, _, launch in self.kernels:
            t = a if launch is None else launch
            j = np.searchsorted(starts, t, side="right") - 1
            if j >= 0 and t < ends[j]:
                total += b - a
        return total / 1e9

    def launches_found(self) -> int:
        """Kernels of the window whose launch the capture holds."""
        return sum(1 for d in self.kernels if d[4] is not None)

    def kernel_count(self, names: Sequence[str]) -> int:
        return sum(1 for d in self.kernels if kernel_name(d[3]) in names)

    def breakdown(self) -> dict:
        """The ten device operations with the most time in the window, and
        the idle time between device intervals by the innermost ``pb:``
        span the host was in at each gap's middle."""
        ops: Dict[str, float] = defaultdict(float)
        for a, b, _, name, _ in self.device:
            ops[kernel_name(name)] += (min(b, self.t1) - max(a, self.t0)) / 1e9
        # spans on one thread nest: the innermost holding a point is the
        # latest-starting one that has not ended by it (looked for among
        # the 512 latest, enough for the layers' siblings in one call)
        spans = sorted((a, b, name) for name, ss in self.spans.items()
                       if name != "window" for a, b in ss)
        starts = [sp[0] for sp in spans]
        gaps: Dict[str, float] = defaultdict(float)
        busy = union_ns([(max(d[0], self.t0), min(d[1], self.t1))
                         for d in self.device])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            label = "outside the spans"
            last = bisect.bisect_right(starts, mid) - 1
            for j in range(last, max(last - 512, -1), -1):
                if spans[j][1] > mid:
                    label = spans[j][2]
                    break
            gaps[label] += (b - a) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


# --------------------------------------------------------------------------
# what a reader sees
# --------------------------------------------------------------------------

class TracedRun:
    """The traced run as the per-layer readers see it: the traffic loop, the
    window's calls, the benchmark's spans (host seconds and counts) and
    the capture."""

    def __init__(self, loop, calls: int, spans: Spans, capture: Capture,
                 counts_agree: bool):
        self.loop = loop
        self.calls = calls
        self.spans = spans
        self.capture = capture
        self.counts_agree = counts_agree

    def span_ms_per_call(self, *names: str) -> Optional[float]:
        """Host milliseconds a window call spends in the named spans; None
        when none of them was opened."""
        if not any(self.spans.count.get(n) for n in names) or not self.calls:
            return None
        return sum(self.spans.seconds.get(n, 0.0) for n in names) \
            / self.calls * 1e3

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.capture.busy_s() / self.capture.window_s)

    def roofline_pct(self, span: str, bound_s: Optional[float]
                     ) -> Optional[float]:
        """100 x the least time the window's work in ``span`` needs over
        the device time of the kernels launched in it; None when either
        is missing or the launch counts disagreed with the capture."""
        dev = self.capture.kernel_s_in(span)
        if not self.counts_agree or dev is None or not dev or not bound_s:
            return None
        return 100.0 * bound_s / dev
