"""MetricsRegistry (port of ``avenir_tpu/telemetry/metrics.py``): one
counters/gauges/histograms API over the framework's three metric channels.

``core.metrics.Counters`` (Hadoop-style job counters),
``utils.tracing.TransferLedger`` (measured link traffic), and
``utils.tracing.StepTimer`` (wall-time + latency percentiles) each export
their own group; the registry unifies them behind one sampling surface
without changing any of them: ``attach_counters`` /
``attach_ledger`` / ``attach_timer`` register *probes* — callables run
before every render/snapshot that refresh gauges from the live source
objects.  The serving integration registers its own probe the same way
(queue depth, in-flight, degraded), so ``/metrics`` mid-job shows the
pipeline moving, not an end-of-job summary.

Exposition is Prometheus text format 0.0.4 (the de-facto scrape wire):
``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value`` samples,
histograms as cumulative ``_bucket{le=}`` series plus ``_sum``/``_count``.

A background snapshot thread (:meth:`MetricsRegistry.start_snapshots`)
re-runs the probes on an interval and optionally appends one JSON sample
line per tick — the flight recorder for jobs nobody was scraping.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")

DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def sanitize_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def sanitize_label(name: str) -> str:
    name = _LABEL_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label_value(v) -> str:
    """Label-value escaping per the Prometheus text-format spec:
    backslash first (or the other escapes would double up), then
    double-quote and newline.  A host label or service name carrying any
    of the three otherwise emits an unparseable scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP-text escaping per the spec (backslash and newline only —
    quotes are legal in HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [(n, v) for n, v in zip(names, values)] + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{sanitize_label(n)}="{_escape_label_value(v)}"'
                    for n, v in pairs)
    return "{" + body + "}"


class _Metric:
    """One named family: counter | gauge | histogram, with optional
    labels.  Values keyed by the label-value tuple; lock shared with the
    registry (metric updates are a few ops per multi-ms unit of work)."""

    __slots__ = ("name", "kind", "help", "label_names", "values",
                 "buckets", "exemplars", "_lock")

    def __init__(self, name: str, kind: str, help_text: str,
                 label_names: Sequence[str], lock: threading.Lock,
                 buckets: Sequence[float] = ()):
        self.name = sanitize_name(name)
        self.kind = kind
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = lock
        # counter/gauge: labels -> float
        # histogram: labels -> [bucket_counts..., sum, count]
        self.values: Dict[tuple, object] = {}
        self.buckets = tuple(sorted(buckets)) if kind == "histogram" else ()
        # histogram exemplars: labels -> {native bucket index
        # -> (trace_id, value, unix_ts)} — each bucket remembers the
        # LAST sampled observation that landed in it, so a p99 spike
        # resolves to a concrete request id in one step
        self.exemplars: Dict[tuple, Dict[int, tuple]] = {}

    def _key(self, labels: Dict[str, str]) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.label_names)}")
        return tuple(str(labels[n]) for n in self.label_names)

    # counter / gauge
    def inc(self, amount: float = 1.0, **labels) -> None:
        if self.kind == "histogram":
            raise TypeError(f"{self.name} is a histogram; use observe()")
        key = self._key(labels)
        with self._lock:
            self.values[key] = float(self.values.get(key, 0.0)) + amount

    def set(self, value: float, **labels) -> None:
        if self.kind != "gauge":
            raise TypeError(f"{self.name} is a {self.kind}; only gauges "
                            f"set()")
        key = self._key(labels)
        with self._lock:
            self.values[key] = float(value)

    def get(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            v = self.values.get(key, 0.0)
        return float(v) if not isinstance(v, list) else float(v[-1])

    def drop_series(self, **labels) -> int:
        """Remove every series whose label values match the given subset
        (e.g. ``drop_series(service="m1")``); returns how many were
        dropped.  An unbinding owner uses this so a retired source's
        last-written values do not render in every later scrape as if
        they were live."""
        idx = [self.label_names.index(n) for n in labels]
        want = [str(labels[n]) for n in labels]
        with self._lock:
            doomed = [k for k in self.values
                      if all(k[i] == w for i, w in zip(idx, want))]
            for k in doomed:
                del self.values[k]
                self.exemplars.pop(k, None)
        return len(doomed)

    # histogram
    def observe(self, value: float, exemplar=None, **labels) -> None:
        """One observation; ``exemplar`` (a sampled request's trace id)
        is remembered by the NATIVE bucket — the smallest bucket the
        value fits, last write wins — and rendered OpenMetrics-style on
        that ``_bucket`` line."""
        if self.kind != "histogram":
            raise TypeError(f"{self.name} is a {self.kind}; use inc()/set()")
        key = self._key(labels)
        with self._lock:
            st = self.values.get(key)
            if st is None:
                st = self.values[key] = [0] * len(self.buckets) + [0.0, 0]
            native = len(self.buckets)
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    st[i] += 1
                    if i < native:
                        native = i
            st[-2] += float(value)
            st[-1] += 1
            if exemplar is not None:
                self.exemplars.setdefault(key, {})[native] = (
                    str(exemplar), float(value), time.time())

    def _exemplar_suffix(self, ex: Optional[Dict[int, tuple]],
                         idx: int) -> str:
        """The OpenMetrics exemplar tail for one ``_bucket`` line:
        `` # {trace_id="<id>"} <value> <unix_ts>`` — metric spike to
        concrete request id in one scrape."""
        if not ex or idx not in ex:
            return ""
        rid, val, ts = ex[idx]
        return (f' # {{trace_id="{_escape_label_value(rid)}"}} '
                f"{_fmt_value(val)} {ts:.3f}")

    # exposition
    def render(self, openmetrics: bool = False) -> List[str]:
        """Text-format lines.  ``openmetrics=True`` renders the
        OpenMetrics dialect: exemplar tails on ``_bucket`` lines and the
        mandatory ``_total`` suffix on counter samples — both ILLEGAL /
        absent in the classic 0.0.4 exposition (whose parser rejects
        tokens after the value), so the default render stays classic."""
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        sample_name = self.name
        if openmetrics and self.kind == "counter":
            # OpenMetrics REQUIRES counter samples named <family>_total;
            # a bare-name counter fails the whole scrape at the parser
            sample_name = f"{self.name}_total"
        with self._lock:
            items = sorted(self.values.items())
            ex_copy = {k: dict(v) for k, v in self.exemplars.items()} \
                if openmetrics else {}
        for key, v in items:
            if self.kind == "histogram":
                ex = ex_copy.get(key)
                cum = 0
                for i, edge in enumerate(self.buckets):
                    cum = v[i]
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(self.label_names, key, [('le', _fmt_value(edge))])}"
                        f" {cum}{self._exemplar_suffix(ex, i)}")
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(self.label_names, key, [('le', '+Inf')])}"
                    f" {v[-1]}"
                    f"{self._exemplar_suffix(ex, len(self.buckets))}")
                lines.append(f"{self.name}_sum"
                             f"{_fmt_labels(self.label_names, key)}"
                             f" {_fmt_value(v[-2])}")
                lines.append(f"{self.name}_count"
                             f"{_fmt_labels(self.label_names, key)} {v[-1]}")
            else:
                lines.append(f"{sample_name}"
                             f"{_fmt_labels(self.label_names, key)}"
                             f" {_fmt_value(v)}")
        return lines


class MetricsRegistry:
    """The process's metric surface: create/lookup metric families, run
    refresh probes, render Prometheus text, host health providers."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._probes: List[Callable[[], None]] = []
        self._probe_strikes: Dict[int, int] = {}
        self._health: Dict[str, Callable[[], Tuple[bool, dict]]] = {}
        self._lock = threading.Lock()
        self._snap_thread: Optional[threading.Thread] = None
        self._snap_stop = threading.Event()
        self.snapshots_taken = 0

    # ---- metric families ----
    def _family(self, name: str, kind: str, help_text: str,
                labels: Sequence[str], buckets: Sequence[float] = ()
                ) -> _Metric:
        key = sanitize_name(name)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = _Metric(
                    name, kind, help_text, labels, threading.Lock(),
                    buckets)
            elif m.kind != kind or m.label_names != tuple(labels):
                raise ValueError(
                    f"metric {key} re-registered as {kind}{tuple(labels)}, "
                    f"was {m.kind}{m.label_names}")
            elif (kind == "histogram"
                  and m.buckets != tuple(sorted(buckets))):
                # silently serving the first caller's edges would bucket
                # the second caller's observations against the wrong grid
                raise ValueError(
                    f"histogram {key} re-registered with buckets "
                    f"{tuple(buckets)}, was {tuple(m.buckets)}")
        return m

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> _Metric:
        return self._family(name, "counter", help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> _Metric:
        return self._family(name, "gauge", help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Metric:
        return self._family(name, "histogram", help_text, labels, buckets)

    # ---- probes: refresh-before-read adapters ----
    def register_probe(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs before every render/snapshot to refresh gauges
        from a live source object.  A probe that raises is warned about
        and KEPT — probes read live objects without their writers' locks,
        so a scrape racing a hot-path mutation (deque append mid-read) is
        expected noise; only three CONSECUTIVE failures drop a probe,
        so a genuinely broken one cannot take the endpoint down but a
        single benign race never silently freezes the gauges forever."""
        with self._lock:
            self._probes.append(fn)

    _PROBE_MAX_STRIKES = 3

    def run_probes(self) -> None:
        import warnings
        with self._lock:
            probes = list(self._probes)
        dead = []
        for fn in probes:
            try:
                fn()
                with self._lock:
                    self._probe_strikes.pop(id(fn), None)
            except Exception as exc:
                with self._lock:
                    n = self._probe_strikes.get(id(fn), 0) + 1
                    self._probe_strikes[id(fn)] = n
                if n >= self._PROBE_MAX_STRIKES:
                    dead.append(fn)
                    warnings.warn(
                        f"telemetry: metrics probe {fn!r} failed "
                        f"{n} times in a row ({type(exc).__name__}: "
                        f"{exc}); dropping it", RuntimeWarning)
                else:
                    warnings.warn(
                        f"telemetry: metrics probe {fn!r} failed "
                        f"({type(exc).__name__}: {exc}); keeping it "
                        f"({n}/{self._PROBE_MAX_STRIKES} strikes)",
                        RuntimeWarning)
        if dead:
            with self._lock:
                self._probes = [p for p in self._probes if p not in dead]
                for fn in dead:
                    self._probe_strikes.pop(id(fn), None)

    def unregister_probe(self, fn: Callable[[], None]) -> None:
        """Remove a probe registered with :meth:`register_probe` — the
        unbind half a torn-down service needs so a dead object is not
        probed (and pinned in memory) for the process lifetime."""
        with self._lock:
            self._probes = [p for p in self._probes if p is not fn]
            self._probe_strikes.pop(id(fn), None)

    # ---- the three pre-existing channels ----
    def attach_counters(self, counters,
                        metric: str = "avenir_job_counter") -> None:
        """Export every (group, name) of a ``core.metrics.Counters`` as
        one labeled gauge family — the Hadoop dump, scrapeable live."""
        g = self.gauge(metric, "job counters (core.metrics.Counters)",
                       labels=("group", "name"))

        def probe():
            for grp, names in counters.as_dict().items():
                for n, v in names.items():
                    g.set(v, group=grp, name=n)
        self.register_probe(probe)

    def attach_ledger(self, ledger) -> None:
        """Gauges over a ``TransferLedger`` snapshot (h2d/d2h bytes,
        transfers, dispatches, collectives) — live link traffic."""
        g = self.gauge("avenir_transfer", "measured link traffic "
                       "(utils.tracing.TransferLedger)", labels=("key",))

        def probe():
            for k, v in ledger.snapshot().items():
                g.set(v, key=k)
        self.register_probe(probe)

    def attach_timer(self, timer, metric: str = "avenir_step") -> None:
        """Gauges over a ``StepTimer``: total seconds + calls per step,
        and p50/p95/p99 milliseconds for steps with a sample window."""
        gs = self.gauge(f"{metric}_seconds_total",
                        "per-step wall time (utils.tracing.StepTimer)",
                        labels=("step",))
        gc = self.gauge(f"{metric}_calls_total", "per-step call count",
                        labels=("step",))
        gp = self.gauge(f"{metric}_latency_ms", "per-step latency "
                        "percentiles", labels=("step", "quantile"))

        def probe():
            for name, total in list(timer.totals.items()):
                gs.set(total, step=name)
                gc.set(timer.calls.get(name, 0), step=name)
                if timer.samples.get(name):
                    for q in (50, 95, 99):
                        gp.set(timer.percentile_ms(name, q), step=name,
                               quantile=f"p{q}")
        self.register_probe(probe)

    # ---- health providers (consumed by server.MetricsServer) ----
    def add_health(self, name: str,
                   fn: Callable[[], Tuple[bool, dict]]) -> None:
        """Register a health source: ``fn() -> (ok, payload)``.  The
        ``/healthz`` endpoint is OK only when every provider is."""
        with self._lock:
            self._health[name] = fn

    def has_health(self, name: str) -> bool:
        """Whether a health provider is registered under ``name`` —
        lets a binder pick a non-colliding identity instead of silently
        overwriting another source's provider."""
        with self._lock:
            return name in self._health

    def remove_health(self, name: str) -> None:
        with self._lock:
            self._health.pop(name, None)

    def health_one(self, name: str) -> Optional[Tuple[bool, dict]]:
        """Run ONE health provider — looked up by its exact key, by the
        key minus a ``<kind>:`` prefix (so ``/healthz/churn-w0`` reaches
        the provider registered as ``serving:churn-w0``), or by the
        LAST ``:`` segment (so the same probe reaches a host-qualified
        ``serving:<host>:churn-w0``; with several hosts sharing one
        registry, disambiguate with ``/healthz/<host>:churn-w0`` — the
        prefix-stripped match).  First match wins.  None when no
        provider matches: the per-worker probe a load balancer points at
        one fleet member, where the aggregate :meth:`health` would flip
        every worker's target on one degraded peer."""
        with self._lock:
            fn = self._health.get(name)
            if fn is None:
                for key, cand in self._health.items():
                    if key.split(":", 1)[-1] == name \
                            or key.rsplit(":", 1)[-1] == name:
                        fn = cand
                        break
        if fn is None:
            return None
        try:
            ok, payload = fn()
        except Exception as exc:
            ok, payload = False, {"error": f"{type(exc).__name__}: {exc}"}
        return bool(ok), {"status": "ok" if ok else "degraded", **payload}

    def health(self) -> Tuple[bool, dict]:
        with self._lock:
            providers = dict(self._health)
        ok = True
        checks = {}
        for name, fn in providers.items():
            try:
                c_ok, payload = fn()
            except Exception as exc:
                c_ok, payload = False, {"error": f"{type(exc).__name__}: "
                                                 f"{exc}"}
            ok = ok and bool(c_ok)
            checks[name] = {"ok": bool(c_ok), **payload}
        return ok, {"status": "ok" if ok else "degraded",
                    "checks": checks}

    # ---- exposition ----
    def render(self) -> str:
        """Prometheus text format 0.0.4 of every family, probes run
        first so attached sources are fresh at scrape time.  NO
        exemplars — the classic parser rejects them; scrapers that want
        them negotiate :meth:`render_openmetrics` via Accept."""
        self.run_probes()
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """The OpenMetrics exposition: same families, ``_bucket`` lines
        carrying their exemplar tails, counters suffixed ``_total``,
        ``# EOF`` terminated — what a scraper sending ``Accept:
        application/openmetrics-text`` gets, and the ONLY text form
        exemplars legally ride."""
        self.run_probes()
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render(openmetrics=True))
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def sample(self) -> Dict[str, object]:
        """One probe-refreshed flat sample: {metric{labels}: value} plus
        a unix timestamp — the snapshot thread's JSONL record."""
        self.run_probes()
        out: Dict[str, object] = {"ts": time.time()}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                items = sorted(m.values.items())
            for key, v in items:
                label = _fmt_labels(m.label_names, key)
                if m.kind == "histogram":
                    out[f"{m.name}{label}.count"] = v[-1]
                    out[f"{m.name}{label}.sum"] = v[-2]
                else:
                    out[f"{m.name}{label}"] = v
        return out

    def exemplars_json(self) -> Dict[str, List[dict]]:
        """The ``/metrics``-adjacent JSON view of every histogram
        exemplar: ``{metric: [{labels, le, trace_id, value, unix_ts}]}``
        — what ``tracetool`` and dashboards resolve a p99 bucket's
        request id from without parsing the text exposition."""
        out: Dict[str, List[dict]] = {}
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        for m in metrics:
            if m.kind != "histogram":
                continue
            with m._lock:
                ex = {k: dict(v) for k, v in m.exemplars.items()}
            rows: List[dict] = []
            for key, by_bucket in sorted(ex.items()):
                labels = dict(zip(m.label_names, key))
                for i, (rid, val, ts) in sorted(by_bucket.items()):
                    le = "+Inf" if i >= len(m.buckets) \
                        else _fmt_value(m.buckets[i])
                    rows.append({"labels": labels, "le": le,
                                 "trace_id": rid, "value": val,
                                 "unix_ts": ts})
            if rows:
                out[m.name] = rows
        return out

    # ---- background snapshot thread ----
    def start_snapshots(self, interval_s: float = 5.0,
                        snapshot_path: Optional[str] = None
                        ) -> "MetricsRegistry":
        """Refresh the probes every ``interval_s`` on a daemon thread,
        appending one JSON sample line per tick to ``snapshot_path``
        when given — gauges stay fresh even with nobody scraping, and
        the JSONL is the post-mortem flight recorder."""
        if self._snap_thread is not None:
            return self
        self._snap_stop.clear()
        if snapshot_path:
            # one run, one recorder: truncate up front (same semantics as
            # the counters.json sibling) so a rerun with the same output
            # path never interleaves two runs' samples in one file
            try:
                open(snapshot_path, "w").close()
            except OSError:
                snapshot_path = None

        def loop():
            while not self._snap_stop.wait(interval_s):
                try:
                    rec = self.sample()
                    self.snapshots_taken += 1
                    if snapshot_path:
                        with open(snapshot_path, "a") as fh:
                            fh.write(json.dumps(
                                rec, separators=(",", ":"),
                                sort_keys=True) + "\n")
                except Exception:
                    # the flight recorder must never take the job down
                    pass

        self._snap_thread = threading.Thread(
            target=loop, daemon=True, name="avenir-metrics-snapshot")
        self._snap_thread.start()
        return self

    def stop_snapshots(self) -> None:
        if self._snap_thread is None:
            return
        self._snap_stop.set()
        self._snap_thread.join(timeout=5.0)
        self._snap_thread = None


# --------------------------------------------------------------------------
# the process-default registry (what serving binds to when cli.run opened
# a metrics endpoint for the job)
# --------------------------------------------------------------------------

_default: Optional[MetricsRegistry] = None


def set_default_registry(reg: Optional[MetricsRegistry]
                         ) -> Optional[MetricsRegistry]:
    global _default
    _default = reg
    return reg


def get_default_registry() -> Optional[MetricsRegistry]:
    return _default
