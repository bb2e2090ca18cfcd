"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with a CUDA card.  The run loads
the cell and its configuration by name, makes its inputs from ``--seed``,
warms up the cell's own shapes, runs the cell's closed loop for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from spans the benchmark opens around the
program's layers and from one ``torch.profiler`` capture of the window.
Each compared number is printed beside its limit, as the last lines of
standard error and under the result's last key, ``checks``.

Exit codes: 0 with a result line; 1 without a CUDA card, or too few; 3
when JAX or the JAX package was loaded; anything else is an error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .core import (CHECKOUT, Capture, Spans, TracedRun, benchmark, cell_files,
                   cell_metrics, forbidden_loaded, metric_reader,
                   process_age_s, traffic_module)
from .traffic.common import Context, closed_loop


def cache_dirs() -> None:
    """Every build and kernel cache the program could write, at fixed
    paths inside the checkout (the port's own nvcc and g++ libraries
    already build into ``build/avenir_tpu_torch/`` there)."""
    base = CHECKOUT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def threads(torch, config: dict) -> None:
    """The program's torch CPU intra-op threads, as the configuration
    states them (``torch_threads``); torch's default where it states
    none."""
    if "torch_threads" in config:
        torch.set_num_threads(int(config["torch_threads"]))


def _launches(counters) -> Dict[str, Optional[int]]:
    import importlib
    out = {}
    for module, attr, _ in counters:
        value = getattr(importlib.import_module(module), attr, None)
        out[f"{module}.{attr}"] = value if isinstance(value, int) else None
    return out


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", sizes: Optional[dict] = None,
             bench: Optional[dict] = None) -> Tuple[dict, List[tuple]]:
    """One run: (the result line's object, [(name, value, limit)]).  The
    tests call it on the CPU at small ``sizes``."""
    import torch
    bench = bench or benchmark()
    cell, config = cell_files(workload)
    module = traffic_module(cell["kind"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        ctx = Context(cell=cell, config=config, seed=seed, device=device,
                      workdir=workdir, sizes=dict(sizes or {}))
        loop = module.Loop(ctx)
        loop.warm()
        sync()
        spans = prof = None
        window = getattr(module, "window", closed_loop)
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)
                spans = Spans(sync)
                loop.instrument(spans)
                counted = _launches(module.LAUNCH_COUNTERS)
                prof = stack.enter_context(profile(activities=[
                    ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if cuda else [])))
                stack.enter_context(record_function("pb:window"))
            # set-up less what it spent in the plain reference
            setup_s = process_age_s() - getattr(loop, "reference_s", 0.0)
            win = window(loop, seconds, sync)
        calls = win.calls
        result = {"correct": False, "attempted": calls, "failed": 0,
                  "metrics": {}, "device": device_info(torch, cuda, bench,
                                                       workload)}
        notes: List[str] = [window_note(win.ends)]
        if trace:
            capture = Capture(prof.profiler.kineto_results.events())
            del prof
            after = _launches(module.LAUNCH_COUNTERS)
            agree = True
            for module_name, attr, names in module.LAUNCH_COUNTERS:
                key = f"{module_name}.{attr}"
                if counted[key] is None or after[key] is None:
                    notes.append(f"launches {key}: the program has no such "
                                 f"counter")
                    continue
                n_prog = after[key] - counted[key]
                n_seen = capture.kernel_count(names)
                agree &= n_prog == n_seen
                notes.append(f"launches {key} {n_prog}, capture "
                             f"{'/'.join(names)} {n_seen}")
            notes.append(f"capture: {len(capture.device)} device events, "
                         f"{len(capture.kernels)} kernels in the window, "
                         f"{capture.launches_found()} with their launch; "
                         f"events by activity {dict(capture.kinds)}")
            view = TracedRun(loop, calls, spans, capture, agree)
            result["device"]["busy_s"] = capture.busy_s()
            result["device"]["window_s"] = capture.window_s
            result["metrics"] = per_layer(bench, workload, view, notes)
            result["breakdown"] = capture.breakdown()
            if not agree:
                notes.append("launch counts and the capture disagree: the "
                             "capture's per-layer numbers are withheld")
        else:
            result["metrics"] = end_to_end(bench, workload, setup_s,
                                           win.end_to_end(cell))
        if cuda:
            result["device"]["memory_peak_bytes"] = \
                torch.cuda.max_memory_allocated()
        loop.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        limits = cell["limits"]
        t_check = time.perf_counter()
        checks = [(name, value, limits[name]) for name, value in
                  loop.check()]
        notes.append(f"check: {time.perf_counter() - t_check:.1f} s")
    result["failed"] = sum(1 for _, v, lim in checks if not v <= lim)
    result["correct"] = result["failed"] == 0
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    result["notes"] = notes
    return result, checks


def window_note(ends: List[float]) -> str:
    """How steady the window was: the calls' times by quartile and the two
    halves' call rates."""
    import statistics
    durs = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    q = statistics.quantiles(durs, n=4) if len(durs) > 1 else durs * 3
    half = len(ends) // 2
    rates = (f"{half / ends[half - 1]:.4g} and "
             f"{(len(ends) - half) / (ends[-1] - ends[half - 1]):.4g} "
             f"calls/s") if half else "one call"
    return (f"window: {len(durs)} calls, call s quartiles "
            f"{', '.join(f'{x:.4g}' for x in q)}; halves {rates}")


def device_info(torch, cuda: bool, bench: dict, workload: str) -> dict:
    # a cell that BENCHMARK.json does not list yet (the CPU tests still
    # run its files) takes one chip
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == workload), 1)
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": 0}


def end_to_end(bench: dict, workload: str, setup_s: float,
               values: Dict[str, float]) -> dict:
    """The cell's end-to-end metrics: ``setup_s`` and what its window
    computed (``values``)."""
    values = {"setup_s": setup_s, **values}
    out = {}
    for m in cell_metrics(bench, workload, "end_to_end"):
        if m["name"] not in values:
            raise KeyError(f"{workload}'s window does not compute "
                           f"{m['name']}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(bench: dict, workload: str, view: TracedRun,
              notes: List[str]) -> dict:
    out = {}
    for m in cell_metrics(bench, workload, "per_layer"):
        reader = metric_reader(m["name"])
        value = reader.read(view) if (
            view.counts_agree or m["source"] != "device_trace") else None
        if value is None:
            notes.append(f"{m['name']}: null (nothing to read)")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
        if hasattr(reader, "yardstick"):
            notes.append(f"{m['name']} {value}: {reader.yardstick(view)}")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    bench = benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry[0]["chips"]:
        print(f"{args.workload} needs {entry[0]['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    threads(torch, cell_files(args.workload)[1])
    import avenir_tpu_torch
    if CHECKOUT not in Path(avenir_tpu_torch.__file__).resolve().parents:
        print(f"the program under test is not in this checkout: "
              f"{avenir_tpu_torch.__file__}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), bench=bench)
    found = forbidden_loaded(list(sys.modules))
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for note in result.pop("notes"):
        print(note, file=sys.stderr)
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
