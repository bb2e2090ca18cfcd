"""The readings a cell's limits are set from, in one process:

* ``--program``: the program's compared numbers over each seed, each seed
  a whole untraced run of ``--seconds`` (the readings below a limit);
* ``--control``: the control's over each seed: the plain reference put in
  the program's place and computed in the precision below the one the
  configuration states (the readings above a limit);
* ``--fault <name>``: the program's over each seed with that fault of
  ``faults.py`` planted where the window calls it, at the cell's size.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 --program --control
    python3 -m portbench.control --workload <cell> --seeds 11 12 13 --fault half_train

One JSON line a seed and side on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import List, Optional

from . import faults
from .core import cell_files, traffic_module
from .run import cache_dirs, run_cell, threads
from .traffic.common import Context


def control_readings(workload: str, seed: int, device: str = "cuda",
                     sizes: Optional[dict] = None) -> dict:
    """{name: value} of the control over one seed, at the cell's size
    unless ``sizes`` says otherwise."""
    cell, config = cell_files(workload)
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        ctx = Context(cell=cell, config=config, seed=seed, device=device,
                      workdir=workdir, sizes=dict(sizes or {}))
        return dict(traffic_module(cell["kind"]).Loop(ctx).control())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    args = ap.parse_args(argv)
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    threads(torch, cell_files(args.workload)[1])
    cell = cell_files(args.workload)[0]
    limits = cell["limits"]
    for seed in args.seeds:
        if args.program:
            res, checks = run_cell(args.workload, seed, args.seconds, False)
            print(json.dumps({"seed": seed, "side": "program",
                              "readings": {n: v for n, v, _ in checks},
                              "metrics": res["metrics"]}), flush=True)
        if args.control:
            got = control_readings(args.workload, seed)
            print(json.dumps({"seed": seed, "side": "control",
                              "readings": got,
                              "fails": sorted(n for n, v in got.items()
                                              if not v <= limits[n])}),
                  flush=True)
            torch.cuda.empty_cache()
        for fault in args.fault:
            patch = faults.Patch()
            faults.plant(patch, cell["kind"], fault)
            try:
                res, checks = run_cell(args.workload, seed, args.seconds,
                                       False)
            finally:
                patch.undo()
            print(json.dumps({"seed": seed, "side": f"fault {fault}",
                              "readings": {n: v for n, v, _ in checks},
                              "fails": sorted(n for n, v, lim in checks
                                              if not v <= lim)}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
