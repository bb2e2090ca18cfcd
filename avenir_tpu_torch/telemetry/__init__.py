"""Runtime telemetry (port of ``avenir_tpu/telemetry``), off by default and
one global read when off.

* **span tracing** (:mod:`.trace`) — a per-run :class:`Tracer` buffering
  ``span(stage, **attrs)`` events (the serving assemble / predict / reply
  steps among them) into a per-process JSONL trace file whose lines are
  Chrome trace events, one lane per thread; inside
  :func:`annotate_capture` each span is also a profiler range
  ``av:<name>`` in the live ``torch.profiler`` capture.
* **request tracing** (:mod:`.reqtrace`) — head-sampled serving requests
  carry a wire trace field end to end and leave Chrome flow events
  (:func:`flow`) with their latency decomposition.
* **metrics** (:mod:`.metrics`) — a :class:`MetricsRegistry` unifying the
  Counters / TransferLedger / StepTimer exports behind one counters,
  gauges and histograms API with probe-driven refresh, a background
  snapshot thread and Prometheus (and OpenMetrics) text exposition.
* **serving endpoint** (:mod:`.server`) — :class:`MetricsServer`, a stdlib
  ``http.server`` daemon thread serving ``/metrics``, ``/healthz``,
  ``/healthz/<name>`` and ``/exemplars``.

``cli/run.py`` installs the tracer and the registry from the
``telemetry.*`` keys; the serving services bind to the default registry.
"""

from .trace import (NULL_SPAN, Tracer, annotate_capture, current_tracer,
                    flow, install_tracer, instant, merge_trace_files,
                    read_trace_file, span, uninstall_tracer,
                    validate_trace_events, write_chrome_trace)

# metrics and server are lazy (PEP 562): every hot module imports
# span()/instant() from here, and must not pull http.server and the
# registry machinery into every process start
_LAZY = {
    "MetricsRegistry": ".metrics",
    "get_default_registry": ".metrics",
    "set_default_registry": ".metrics",
    "MetricsServer": ".server",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module
    return getattr(import_module(mod, __name__), name)


__all__ = [
    "Tracer", "span", "instant", "flow", "install_tracer",
    "uninstall_tracer", "current_tracer", "annotate_capture", "NULL_SPAN",
    "read_trace_file",
    "validate_trace_events", "merge_trace_files", "write_chrome_trace",
    "MetricsRegistry", "set_default_registry", "get_default_registry",
    "MetricsServer",
]
