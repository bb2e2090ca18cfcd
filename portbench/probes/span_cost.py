"""What one program span costs the host, in microseconds to enter and
leave: tracing off, under a JSONL ``Tracer``, annotated with no profiler
running, annotated under a live ``torch.profiler`` capture, and both.  No
cell runs this.

    python3 -m portbench.probes.span_cost [--loops 200000]

Prints one JSON line."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def _loop(span, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with span("knn.scan", cat="knn", rows=400):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loops", type=int, default=200000)
    n = ap.parse_args(argv).loops
    import torch
    from torch.profiler import ProfilerActivity, profile
    from avenir_tpu_torch.telemetry import trace as tt
    from avenir_tpu_torch.utils.tracing import layer
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = {"off_us": _loop(tt.span, n)}
    t0 = time.perf_counter()
    for _ in range(n):
        with layer(None, "b1"):
            pass
    out["layer_off_us"] = (time.perf_counter() - t0) / n * 1e6
    tracer = tt.install_tracer(tt.Tracer(tempfile.mkdtemp()))
    out["jsonl_us"] = _loop(tt.span, n)
    tt.uninstall_tracer()
    tracer.close()
    with tt.annotate_capture():
        out["annotated_no_profiler_us"] = _loop(tt.span, n // 4)
    with profile(activities=acts):
        with tt.annotate_capture():
            out["annotated_capture_us"] = _loop(tt.span, n // 10)
    with profile(activities=acts):
        tracer = tt.install_tracer(tt.Tracer(tempfile.mkdtemp()))
        with tt.annotate_capture():
            out["annotated_capture_jsonl_us"] = _loop(tt.span, n // 10)
        tt.uninstall_tracer()
        tracer.close()
    out["device"] = torch.cuda.get_device_name(0) \
        if torch.cuda.is_available() else "cpu"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
