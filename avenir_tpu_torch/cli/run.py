"""Command-line runner of the port: drop-in replacement for the reference's
driver lines, like ``avenir_tpu/cli/run.py``.

    python -m avenir_tpu_torch.cli.run org.avenir.model.ModelPredictor \\
        -Dconf.path=rafo.properties <inPath> <outPath>

``--resume`` restarts a checkpointed streamed training job from its last
intact step (``-Ddtb.streaming.resume=true``).  ``AVENIR_TPU_FAULTS``
installs a fault injector for the run (``core/faults.py``).

Jobs run on the GPU (``cuda``) unless ``-Dplatform=cpu`` asks for the CPU;
the kernels run on the GPU, their plain versions on the CPU.  The same
device decides the job's runtime context (``parallel.mesh``): every
visible GPU for cuda, the CPU for cpu, unless the caller installed one
with ``set_runtime_context``.  Prints a
Hadoop-style counter dump and writes it as ``<outPath>.counters.json``.
A job that is not ported yet raises ``JobNotPorted``.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from ..core.config import Config, load_config
from . import jobs
from . import knn_jobs  # noqa: F401  (registers the KNN jobs)
from . import monitor_jobs  # noqa: F401  (registers the drift jobs)
from . import serving_jobs  # noqa: F401  (registers predictionService)


def write_counters_json(counters, out_path: Optional[str]) -> Optional[str]:
    """``<out>.counters.json`` (``Counters.to_json`` bytes, tmp-then-rename)
    NEXT TO the job output, never inside it."""
    if not out_path:
        return None
    dest = f"{out_path.rstrip('/' + os.sep)}.counters.json"
    tmp = f"{dest}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            fh.write(counters.to_json())
        os.replace(tmp, dest)
    except OSError as exc:
        print(f"[counters] could not persist {dest!r}: {exc}",
              file=sys.stderr)
        return None
    return dest


def parse_args(argv: List[str]):
    job_name: Optional[str] = None
    conf_path: Optional[str] = None
    overrides = {}
    positional: List[str] = []
    for a in argv:
        if a.startswith("-Dconf.path="):
            conf_path = a.split("=", 1)[1]
        elif a == "--resume":
            # restart a checkpointed streaming job from its last intact
            # step (sugar for -Ddtb.streaming.resume=true)
            overrides["dtb.streaming.resume"] = "true"
        elif a.startswith("-D"):
            k, _, v = a[2:].partition("=")
            overrides[k] = v
        elif job_name is None:
            job_name = a
        else:
            positional.append(a)
    # spark style: <in> <out> <file.conf> as last positional
    if conf_path is None and positional and positional[-1].endswith(".conf"):
        conf_path = positional.pop()
    return job_name, conf_path, overrides, positional


def main(argv: Optional[List[str]] = None) -> int:
    from ..runtime import platform_device, set_default_device
    from ..utils.tracing import StepTimer, transfer_ledger
    argv = list(sys.argv[1:] if argv is None else argv)
    job_name, conf_path, overrides, positional = parse_args(argv)
    if job_name is None:
        print("usage: python -m avenir_tpu_torch.cli.run <JobClassOrAlias> "
              "-Dconf.path=<conf> [<inPath>] <outPath>", file=sys.stderr)
        return 2
    fn = jobs.resolve(job_name)
    short = job_name.split(".")[-1]
    cfg = load_config(conf_path, app=short[0].lower() + short[1:]) \
        if conf_path else Config()
    cfg.update(overrides)
    if len(positional) >= 2:
        in_path, out_path = positional[0], positional[1]
    elif len(positional) == 1:
        in_path, out_path = None, positional[0]
    else:
        in_path = out_path = None
    platform = cfg.get("platform")
    # the process-level device, installed for the job and cleared after it
    # so one in-process run cannot leak it into the next
    set_default_device(platform_device(platform) if platform else None)
    try:
        timer = StepTimer()
        with transfer_ledger() as ledger:
            with timer.step("job"):
                counters = fn(cfg, in_path, out_path)
        if counters is not None:
            ledger.export(counters)
            timer.export(counters)
            print(counters.render())
            write_counters_json(counters, out_path)
    finally:
        set_default_device(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
