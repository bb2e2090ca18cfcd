"""One run of a cell, as ``portbench.run`` makes it, with the program's own
spans read besides.  No cell runs this: it is how the split of each cell's
outside-timed blocks into the program's spans is measured again, until
the benchmark reads those spans itself.

    python3 -m portbench.probes.annotated_trace --cell <cell> --seed <n> \\
        [--seconds 30] [--mode annot|traced|plain|jsonl]

``annot``: traced, with ``telemetry.trace.annotate_capture()`` open while
the capture is live, so each program span is an ``av:<name>`` range in it.
``traced``: traced, the switch off (the benchmark's traced run as it is).
``plain``: untraced.  ``jsonl``: untraced, a JSONL ``Tracer`` installed,
so the program's spans are timed with none of the benchmark's
synchronising spans around them.

Prints one JSON line: the window's calls, the run's metrics and, traced,
the host milliseconds a call spends in each program span and ``pb:`` span,
the idle seconds by the innermost span of either kind at each gap's
middle (``Capture.breakdown``'s rule over both kinds), and the share of
the outside-timed spans (``score_call``, ``classify``, ``weights_h2d``)
that the program's spans inside them hold; with ``jsonl``, each program
span's milliseconds a call from the tracer's file, and KNN's upload by
chunk."""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

from .. import core
from .. import run as bench_run

PREFIX = "av:"


class ProgramCapture(core.Capture):
    """The benchmark's capture, keeping the window's ``av:`` ranges too."""

    last = None

    def __init__(self, events):
        events = list(events)
        super().__init__(events)
        self.program = defaultdict(list)
        for ev in events:
            name = ev.name()
            if name.startswith(PREFIX) and \
                    "cuda" not in str(ev.device_type()).lower():
                start = int(ev.start_ns())
                self.program[name[len(PREFIX):]].append(
                    (start, start + int(ev.duration_ns())))
        # device-timeline copies of ranges would be no device work; the
        # C++ range type lays none, and this counts any that appear
        self.range_copies = sum(1 for d in self.device
                                if d[3].startswith(PREFIX))
        ProgramCapture.last = self

    def in_window(self, spans):
        return [(a, b) for a, b in spans if a >= self.t0 and b <= self.t1]

    def idle_by_span(self) -> dict:
        spans = [(a, b, "pb:" + n) for n, ss in self.spans.items()
                 if n != "window" for a, b in ss]
        spans += [(a, b, PREFIX + n) for n, ss in self.program.items()
                  if n != "annotate_capture" for a, b in ss]
        spans.sort()
        starts = [s[0] for s in spans]
        busy = core.union_ns([(max(d[0], self.t0), min(d[1], self.t1))
                              for d in self.device])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            label = "outside the spans"
            last = bisect.bisect_right(starts, mid) - 1
            for j in range(last, max(last - 4096, -1), -1):
                if spans[j][1] > mid:
                    label = spans[j][2]
                    break
            gaps[label] += (b - a) / 1e9
        return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def annotated_profile(profile, annotate_capture):
    """``torch.profiler.profile`` with the program's switch open while the
    capture is live."""
    class Annotated(profile):
        def __enter__(self):
            out = super().__enter__()
            self._annotation = annotate_capture()
            self._annotation.__enter__()
            return out

        def __exit__(self, *exc):
            self._annotation.__exit__(*exc)
            return super().__exit__(*exc)
    return Annotated


def traced_summary(cap: ProgramCapture, calls: int) -> dict:
    per_call = lambda spans: sum(b - a for a, b in cap.in_window(spans)) \
        / 1e6 / calls
    program = {n: per_call(ss) for n, ss in cap.program.items()
               if n != "annotate_capture"}
    bench = {n: per_call(ss) for n, ss in cap.spans.items() if n != "window"}
    out = {"idle_s": cap.window_s - cap.busy_s(), "window_s": cap.window_s,
           "idle_by_span": cap.idle_by_span(), "program_ms": program,
           "program_n": {n: len(cap.in_window(ss)) / calls
                         for n, ss in cap.program.items()
                         if n != "annotate_capture"},
           "pb_ms": bench, "range_copies": cap.range_copies}
    cover = {}
    if "score_call" in bench:
        cover["score_call"] = sum(
            v for n, v in program.items()
            if n.startswith(("predictor.", "ensemble."))) / bench["score_call"]
    if "classify" in bench:
        cover["classify"] = (program.get("knn.class_scores", 0.0) +
                             program.get("knn.class_pick", 0.0)) \
            / bench["classify"]
    if "weights_h2d" in bench:
        cover["weights_h2d"] = (bench.get("bootstrap.draw", 0.0) +
                                bench.get("bootstrap.upload", 0.0)) \
            / bench["weights_h2d"]
    out["cover"] = cover
    return out


def jsonl_summary(path: str, calls: int) -> dict:
    """Each program span's milliseconds a call in the tracer's file, and
    ``knn.upload`` by its chunk's place in the call."""
    from avenir_tpu_torch.telemetry.trace import read_trace_file
    events = sorted((e for e in read_trace_file(path) if e["ph"] == "X"),
                    key=lambda e: e["ts"])
    total = defaultdict(float)
    chunks = defaultdict(list)
    chunk = 0
    for e in events:
        total[e["name"]] += e["dur"] / 1e3
        if e["name"] == "knn.encode":
            chunk = 0
        elif e["name"] == "knn.upload":
            chunks[chunk].append(e["dur"] / 1e3)
            chunk += 1
    # the warm call and the check's calls ran outside the window too: the
    # means are over every call the file holds
    opened = sum(1 for e in events if e["name"] in ("knn.encode",
                                                     "predictor.models",
                                                     "weights_h2d"))
    n = opened or calls
    return {"span_ms": {k: v / n for k, v in total.items()},
            "calls_in_file": opened,
            "upload_ms_by_chunk": {i: sum(v) / len(v)
                                   for i, v in sorted(chunks.items())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--mode", default="annot",
                    choices=("annot", "traced", "plain", "jsonl"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    import torch.profiler
    from avenir_tpu_torch.telemetry import trace as program_trace
    bench_run.cache_dirs()
    bench_run.threads(torch, core.cell_files(args.cell)[1])
    if args.mode == "annot":
        torch.profiler.profile = annotated_profile(
            torch.profiler.profile, program_trace.annotate_capture)
    bench_run.Capture = ProgramCapture
    tracer = None
    if args.mode == "jsonl":
        tracer = program_trace.install_tracer(program_trace.Tracer(
            tempfile.mkdtemp(prefix="annotated-trace-")))
    traced = args.mode in ("annot", "traced")
    sizes = None
    if args.device == "cpu":
        from ..tests.conftest import SMALL
        sizes = SMALL[args.cell]
    t0 = time.time()
    result, _ = bench_run.run_cell(args.cell, args.seed, args.seconds,
                                   traced, args.device, sizes)
    calls = result["attempted"]
    out = {"cell": args.cell, "seed": args.seed, "mode": args.mode,
           "calls": calls, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "wall_s": time.time() - t0}
    if tracer is not None:
        program_trace.uninstall_tracer()
        tracer.close()
        out.update(jsonl_summary(tracer.path, calls))
    if traced:
        out.update(traced_summary(ProgramCapture.last, calls))
    if args.device != "cpu":
        out["card"] = bench_run.power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
