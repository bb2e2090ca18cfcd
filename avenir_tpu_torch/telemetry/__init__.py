"""Runtime telemetry (port of ``avenir_tpu/telemetry``): span tracing and
per-request tracing, off by default and one global read when off.

* **span tracing** (:mod:`.trace`) — a per-run :class:`Tracer` buffering
  ``span(stage, **attrs)`` events (the serving assemble / predict / reply
  steps among them) into a per-process JSONL trace file whose lines are
  Chrome trace events, one lane per thread.
* **request tracing** (:mod:`.reqtrace`) — head-sampled serving requests
  carry a wire trace field end to end and leave Chrome flow events
  (:func:`flow`) with their latency decomposition.

The metrics registry and its ``/metrics`` endpoint (the reference's
``telemetry.metrics`` and ``telemetry.server``) are not ported yet; the
single-worker serving path binds metrics only where a default registry
is set, so it runs without them.
"""

from .trace import (NULL_SPAN, Tracer, current_tracer, flow,
                    install_tracer, instant, merge_trace_files,
                    read_trace_file, span, uninstall_tracer,
                    validate_trace_events, write_chrome_trace)

__all__ = [
    "Tracer", "span", "instant", "flow", "install_tracer",
    "uninstall_tracer", "current_tracer", "NULL_SPAN", "read_trace_file",
    "validate_trace_events", "merge_trace_files", "write_chrome_trace",
]
