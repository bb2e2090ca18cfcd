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

Several processes (``parallel/distributed.py``): under torchrun's
environment (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) the runner joins a ``torch.distributed`` run (gloo) and
enforces the job's multi-process mode (:func:`_apply_dist_mode`); under
``AVENIR_TPU_SHARD=i/P`` the row-range sharded jobs exchange partials
through the file transport.  In either, each process drives one card,
``parallel.mesh.worker_device`` of its local index, and a joined run sums
the counters across processes (not for ``gather`` jobs, whose counters are
global already); process 0 prints them and shard 0 alone writes
``counters.json``.  A joined ``gather`` or ``partition`` job over distinct
per-process inputs reads them from a spool directory that holds every
process's files (:func:`_apply_dist_mode`), removed when the job ends.

Run-scoped telemetry (:func:`_telemetry_setup`) comes from the
``telemetry.*`` keys and their environment twins, as in the JAX package:
a span tracer writing ``trace-<run id>.p<shard>.jsonl`` under
``telemetry.trace.dir``, and a metrics registry (the serving services bind
to it) with a ``/metrics`` + ``/healthz`` endpoint on
``telemetry.metrics.port`` and a ``<outPath>.metrics.jsonl`` flight
recorder every ``telemetry.metrics.snapshot.s`` seconds.  The device
profile is ``profile.trace.dir`` (or ``AVENIR_TPU_TRACE_DIR``): a
``torch.profiler`` Chrome trace of the job, host and card, one file a
process (``utils.tracing.trace``).
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import sys
import tempfile
from typing import List, Optional, Tuple

from ..core.config import Config, load_config
from . import jobs
from . import association_jobs  # noqa: F401  (registers the Apriori jobs)
from . import bayes_jobs  # noqa: F401  (registers the Naive Bayes jobs)
from . import cluster_jobs  # noqa: F401  (registers the cluster jobs)
from . import control_jobs  # noqa: F401  (registers retrainController)
from . import discriminant_jobs  # noqa: F401  (registers the SVM, Fisher)
from . import explore_jobs  # noqa: F401  (registers the explore jobs)
from . import knn_jobs  # noqa: F401  (registers the KNN jobs)
from . import monitor_jobs  # noqa: F401  (registers the drift jobs)
from . import nn_jobs  # noqa: F401  (registers the MLP jobs)
from . import online_jobs  # noqa: F401  (registers onlineLearner)
from . import optimize_jobs  # noqa: F401  (registers the SA and GA jobs)
from . import partition_jobs  # noqa: F401  (registers the split jobs)
from . import regress_jobs  # noqa: F401  (registers the logistic jobs)
from . import reinforce_jobs  # noqa: F401  (registers the bandit jobs)
from . import sequence_jobs  # noqa: F401  (registers the sequence jobs)
from . import serving_jobs  # noqa: F401  (registers predictionService)
from . import text_jobs  # noqa: F401  (registers the text and rule jobs)


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


def _telemetry_setup(cfg, job_name: str, in_path: Optional[str]):
    """Install run-scoped telemetry from the ``telemetry.*`` keys; returns
    ``(tracer, metrics_server, registry)``, all None when telemetry is off
    (the default: spans are no-ops).

      telemetry.trace.dir      span tracing: per-process JSONL (Chrome
                               trace events) into this directory
      telemetry.run.id         the trace file's run id (default under a
                               shard spec: a hash of the job and the INPUT
                               path, which every shard shares, so all
                               shards agree; else the job, the time, the
                               pid and a random tail)
      telemetry.metrics.port   /metrics + /healthz endpoint port (0 =
                               ephemeral, printed on stderr; shard i of a
                               shard spec binds port + i)
      telemetry.metrics.host   the endpoint's bind address (default
                               127.0.0.1)
      telemetry.metrics.snapshot.s   the snapshot thread's period (the
                               JSONL flight recorder; 0 = off; works
                               without a port)
      profile.trace.dir        the device profile: a ``torch.profiler``
                               Chrome trace of the job step, one file a
                               process, into this directory (read by
                               :func:`main`, ``utils.tracing.trace``)

    Environment twins: AVENIR_TPU_TRACE_EVENTS_DIR, AVENIR_TPU_METRICS_PORT,
    AVENIR_TPU_METRICS_HOST, AVENIR_TPU_RUN_ID, AVENIR_TPU_TRACE_DIR (an
    empty value means unset)."""
    trace_dir = cfg.get("telemetry.trace.dir") or \
        os.environ.get("AVENIR_TPU_TRACE_EVENTS_DIR") or None
    port = cfg.get("telemetry.metrics.port") or \
        os.environ.get("AVENIR_TPU_METRICS_PORT") or None
    snap_s = cfg.get_float("telemetry.metrics.snapshot.s", 0.0)
    if not trace_dir and port is None and snap_s <= 0:
        return None, None, None
    from .. import telemetry
    from ..parallel.distributed import shard_spec
    spec = shard_spec()
    tracer = server = registry = None
    if trace_dir:
        run_id = cfg.get("telemetry.run.id") or \
            os.environ.get("AVENIR_TPU_RUN_ID")
        if not run_id:
            short = job_name.split(".")[-1]
            if spec.active:
                # every shard derives the same id from what they share
                run_id = short + "-" + hashlib.sha256(
                    f"{job_name}|{in_path}".encode()).hexdigest()[:8]
            else:
                import time
                import uuid
                run_id = f"{short}-{time.strftime('%Y%m%d%H%M%S')}" \
                         f"-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        tracer = telemetry.install_tracer(telemetry.Tracer(
            trace_dir, run_id=run_id, process_index=spec.index))
    if port is not None or snap_s > 0:
        try:
            registry = telemetry.MetricsRegistry()
            telemetry.set_default_registry(registry)
            if port is not None:
                host = cfg.get("telemetry.metrics.host") or \
                    os.environ.get("AVENIR_TPU_METRICS_HOST") or \
                    "127.0.0.1"
                bind_port = int(port)
                if bind_port != 0 and spec.active:
                    # one fixed port for several shards on one host would
                    # fail every bind but one
                    bind_port += spec.index
                server = telemetry.MetricsServer(
                    registry, port=bind_port, host=host).start()
        except Exception:
            # a failed endpoint start must not leak the process-global
            # tracer and registry into later in-process runs
            telemetry.set_default_registry(None)
            if tracer is not None:
                telemetry.uninstall_tracer()
                tracer.close()
            raise
        if server is not None:
            print(f"[telemetry] metrics endpoint "
                  f"http://{server.host}:{server.port}/metrics "
                  f"(+ /healthz)", file=sys.stderr)
    return tracer, server, registry


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


def file_sha(path: str, full: bool) -> str:
    """Content digest of an input file: all of it (``full``), or its size,
    head, tail and three interior samples — O(1) reads for the large
    inputs of sharded and map jobs."""
    h = hashlib.sha256()
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        if full:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        else:
            h.update(f"{size}:".encode())
            h.update(fh.read(1 << 16))
            if size > (1 << 16):
                for frac in (0.25, 0.5, 0.75):
                    fh.seek(int(size * frac))
                    h.update(fh.read(4096))
                fh.seek(-(1 << 16), os.SEEK_END)
                h.update(fh.read(1 << 16))
    return h.hexdigest()


def _apply_dist_mode(fn, job_name: str, in_path: Optional[str],
                     cfg: Optional[Config] = None
                     ) -> Tuple[Optional[str], Optional[str]]:
    """Enforce the job's multi-process mode in a joined run (the identity
    in a single process): ``sharded`` and ``map`` jobs read their own
    input; ``gather`` and ``partition`` jobs see the global input on every
    process; ``refuse`` jobs raise.  Returns ``(input path, spool dir or
    None)``; the caller removes the spool after the job.

    One digest exchange tells an input that is identical on every process
    (a shared-filesystem launch) from per-process inputs:

    * ``sharded`` / ``map``: identical inputs would make every process
      treat the whole file as its shard and inflate the results P-fold —
      refused (``AVENIR_TPU_ALLOW_IDENTICAL_SHARDS=1`` overrides), except
      for a job that splits one shared file by row range itself
      (``jobs.shards_by_row_range``), which in turn refuses distinct
      inputs (each process would split its own file and drop rows);
    * ``gather`` / ``partition``: an identical input already is the
      global one and is used as it is.  Distinct inputs are exchanged
      (``distributed.allgather_files``, which fails on every process if
      any read fails) and written to a spool directory of
      ``<basename>.p<process>`` files (``distributed.spool_name``): the
      basenames stay, since the similarity jobs key the train set on
      their prefix.  Their digest hashes whole files.

    Processes that disagree on whether an input was given at all raise on
    every process instead of leaving half of them in a collective."""
    from ..parallel.distributed import (allgather_files, allgather_object,
                                        is_multiprocess, process_index,
                                        spool_name)
    if not is_multiprocess():
        return in_path, None
    mode = jobs.dist_mode(fn)
    if mode not in ("sharded", "gather", "map", "partition"):
        raise RuntimeError(
            f"job {job_name} is not multi-process safe (dist mode "
            f"{mode!r}): running it in a joined run would emit shard-local "
            f"results; run it single-process")
    if in_path is None:
        paths = []
    elif os.path.isdir(in_path):
        paths = sorted(p for p in glob.glob(os.path.join(in_path, "*"))
                       if os.path.isfile(p))
    else:
        paths = [in_path]
    # gather and partition jobs need the global input view: a difference
    # anywhere in a file matters
    full = mode in ("gather", "partition")
    digest = hashlib.sha256(repr(
        [(os.path.basename(p), file_sha(p, full)) for p in paths]
    ).encode()).hexdigest()
    meta = allgather_object((in_path is not None, digest))
    flags = [has for has, _ in meta]
    if len(set(flags)) > 1:
        raise RuntimeError(
            f"job {job_name}: processes disagree on whether an input path "
            f"was given ({flags}); fix the per-process argv")
    if in_path is None:
        return None, None
    identical = len({d for _, d in meta}) == 1
    if full:
        if identical:
            if process_index() == 0:
                print(f"[dist] {job_name}: input identical on all "
                      f"{len(meta)} processes; using it as-is (no gather)",
                      file=sys.stderr)
            return in_path, None
        gathered = allgather_files(paths, f"job {job_name}: input gather")
        spool = tempfile.mkdtemp(prefix="avenir_dist_gather_")
        try:
            for proc, files in enumerate(gathered):
                for base, data in files:
                    with open(os.path.join(spool, spool_name(base, proc)),
                              "wb") as fh:
                        fh.write(data)
        except OSError:
            shutil.rmtree(spool, ignore_errors=True)
            raise
        if process_index() == 0:
            print(f"[dist] {job_name}: gathered "
                  f"{sum(len(f) for f in gathered)} input file(s) from "
                  f"{len(gathered)} processes", file=sys.stderr)
        return spool, spool
    row_range = cfg is not None and jobs.shards_by_row_range(fn, cfg)
    if row_range and not identical:
        raise RuntimeError(
            f"job {job_name}: dtb.streaming.shard is active but the "
            f"{len(meta)} processes were given DISTINCT inputs — the "
            f"row-range split assumes every process reads the SAME file "
            f"and would silently drop rows from each per-process file.  "
            f"Give every process the same input path, or set "
            f"dtb.streaming.shard=off")
    if identical and not row_range and not os.environ.get(
            "AVENIR_TPU_ALLOW_IDENTICAL_SHARDS"):
        raise RuntimeError(
            f"job {job_name} (dist mode {mode!r}): all {len(meta)} "
            f"processes were given IDENTICAL input — each would treat the "
            f"full file as its shard and the results would be silently "
            f"{len(meta)}x inflated.  Give each process its own input "
            f"shard (or set AVENIR_TPU_ALLOW_IDENTICAL_SHARDS=1 if the "
            f"shards are genuinely identical)")
    return in_path, None


def _process_device():
    """In a run of several shards, the card (or the CPU) this process
    drives, installed as the default device and a one-device runtime
    context unless the caller installed a context.  Returns True when it
    installed them."""
    from ..parallel.distributed import local_index, shard_spec
    from ..parallel.mesh import (DeviceMesh, MeshContext, installed_context,
                                 set_runtime_context, worker_device)
    from ..runtime import set_default_device
    if not shard_spec().active or installed_context() is not None:
        return False
    dev = worker_device(local_index())
    if dev.type == "cuda":
        # a bare "cuda" (pinned host memory, current streams) then means
        # this process's card too
        import torch
        torch.cuda.set_device(dev)
    set_default_device(dev)
    set_runtime_context(MeshContext(DeviceMesh([dev])))
    return True


def main(argv: Optional[List[str]] = None) -> int:
    from ..parallel.distributed import (all_reduce_counters, initialize,
                                        is_multiprocess, leave,
                                        process_index, shard_spec)
    from ..parallel.mesh import set_runtime_context
    from ..runtime import platform_device, set_default_device
    from ..utils.tracing import StepTimer, trace, transfer_ledger
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
    # a joined run when torchrun's environment says so (a partial one
    # raises); the identity in a single process.  A run this call joined
    # is left when the job succeeds
    joined_here = not is_multiprocess() and initialize()
    platform = cfg.get("platform")
    # the process-level device, installed for the job and cleared after it
    # so one in-process run cannot leak it into the next
    set_default_device(platform_device(platform) if platform else None)
    own_ctx = False
    spool = None
    tracer = metrics_server = registry = None
    try:
        orig_in_path = in_path   # the run id's anchor, not a spool dir
        in_path, spool = _apply_dist_mode(fn, job_name, in_path, cfg)
        own_ctx = _process_device()
        timer = StepTimer()
        tracer, metrics_server, registry = _telemetry_setup(
            cfg, job_name, orig_in_path)
        with transfer_ledger() as ledger:
            if registry is not None:
                # live sources: /metrics mid-job shows the ledger and the
                # step timer moving
                registry.attach_ledger(ledger)
                registry.attach_timer(timer)
                snap_s = cfg.get_float("telemetry.metrics.snapshot.s", 0.0)
                if snap_s > 0:
                    # beside the output, like counters.json, and from the
                    # owner process only under a shard spec
                    spec = shard_spec()
                    own = not spec.active or spec.index == 0
                    registry.start_snapshots(
                        snap_s,
                        snapshot_path=(
                            f"{out_path.rstrip('/' + os.sep)}"
                            f".metrics.jsonl"
                            if out_path and own else None))
            # the device profile (profile.trace.dir, else
            # AVENIR_TPU_TRACE_DIR; empty means unset) around the job step
            with trace(cfg.get("profile.trace.dir") or
                       os.environ.get("AVENIR_TPU_TRACE_DIR")):
                with timer.step("job"):
                    counters = fn(cfg, in_path, out_path)
        if counters is not None:
            # the ledger before the sum: each process moved its own bytes;
            # the step times after it: wall clocks do not add up
            ledger.export(counters)
            if jobs.dist_mode(fn) != "gather":
                counters = all_reduce_counters(counters)
            timer.export(counters)
            if registry is not None:
                registry.attach_counters(counters)
            spec = shard_spec()
            if process_index() == 0:
                print(counters.render())
                if not spec.active or spec.index == 0:
                    write_counters_json(counters, out_path)
        if joined_here:
            leave()
    finally:
        if registry is not None:
            registry.stop_snapshots()
        if metrics_server is not None:
            metrics_server.stop()
        if registry is not None:
            from ..telemetry import set_default_registry
            set_default_registry(None)
        if tracer is not None:
            from ..telemetry import uninstall_tracer
            uninstall_tracer()
            try:   # flush + Chrome export; telemetry never fails a job
                tracer.close()
            except Exception as exc:
                print(f"[telemetry] trace close failed: {exc}",
                      file=sys.stderr)
        set_default_device(None)
        if own_ctx:
            set_runtime_context(None)
        if spool is not None:
            # a spool holds a copy of the global input; chained jobs must
            # not pile them up
            shutil.rmtree(spool, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
