"""One fleet HOST as a runnable OS process (port of
``avenir_tpu/serving/fleet_host.py``):

    python -m avenir_tpu_torch.serving.fleet_host \
        --registry <dir> --model <name> \
        [--models name[:ver],name2...] [--model-depth name=N] \
        --endpoints host:port[,host:port...] \
        [--workers N] [--host-label h] [--batching continuous|drain] \
        [--max-batch 64] [--max-wait-ms 2.0] [--slo-p99-ms 0] \
        [--max-queue-depth 0] [--buckets 8,64] \
        [--autoscale MIN:MAX] [--autoscale-interval-s 0.25] \
        [--request-queue rq] [--prediction-queue pq] \
        [--max-idle-s 30] [--metrics-port -1] [--stats-out file.json]

Starts a :class:`~avenir_tpu_torch.serving.fleet.ServingFleet` (optionally
under a :class:`~avenir_tpu_torch.serving.autoscaler.FleetAutoscaler`)
draining the given broker ring against the SHARED registry directory, and
exits on a wire ``stop`` message or after ``--max-idle-s`` without
traffic, whichever first.  On exit it prints ONE JSON line of fleet stats
and merged counters to stdout (and to ``--stats-out`` when given).

N of these processes, all pointed at the same broker endpoints and the
same published registry, form the horizontal tier.  The hot-swap
converges per host: push one ADDRESSED ``reload,<host_label>`` per host
(a fleet that pops a copy addressed to a peer re-pushes it).

The process runs on the GPU unless ``$AVENIR_TPU_PLATFORM`` asks for
another platform (``cpu``), mapped through ``runtime.platform_device``.
``--metrics-port``: -1 = no endpoint, 0 = ephemeral (printed on stderr),
>0 = fixed (``--metrics-host 0.0.0.0`` to expose beyond loopback).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def _parse_args(argv):
    ap = argparse.ArgumentParser(prog="fleet_host", description=__doc__)
    ap.add_argument("--registry", required=True)
    ap.add_argument("--model", default=None,
                    help="single resident model (classic form); "
                         "required unless --models is given")
    ap.add_argument("--models", default=None,
                    help="comma-separated resident model specs "
                         "(name or name:version): every worker runs a "
                         "ModelRouter over the set and requests route "
                         "by the wire m=<name[:version]> field; "
                         "--model (or the first spec) is the default "
                         "model for untagged requests")
    ap.add_argument("--model-depth", action="append", default=[],
                    metavar="NAME=DEPTH",
                    help="per-model admission queue depth (tenant "
                         "isolation; repeatable; default "
                         "--max-queue-depth)")
    ap.add_argument("--endpoints", required=True,
                    help="comma-separated broker shard host:port list")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--host-label", default=None)
    ap.add_argument("--batching", default="continuous",
                    choices=("continuous", "drain"))
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--slo-p99-ms", type=float, default=0.0)
    ap.add_argument("--max-queue-depth", type=int, default=0)
    ap.add_argument("--buckets", default="8,64")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="enable the autoscaler between MIN and MAX "
                         "active workers (workers start at MIN)")
    ap.add_argument("--autoscale-interval-s", type=float, default=0.25)
    ap.add_argument("--request-queue", default="requestQueue")
    ap.add_argument("--prediction-queue", default="predictionQueue")
    ap.add_argument("--lease-timeout-s", type=float, default=0.0,
                    help="drain under visibility-timeout leases with "
                         "this expiry (at-least-once + broker-side "
                         "reply dedup = exactly-once effect); 0 keeps "
                         "the classic destructive-pop wire path")
    ap.add_argument("--max-idle-s", type=float, default=30.0)
    ap.add_argument("--metrics-port", type=int, default=-1)
    ap.add_argument("--metrics-host", default="127.0.0.1")
    ap.add_argument("--trace-dir", default=None,
                    help="span/flow tracing: write this host's "
                         "trace-<run-id>.p<trace-index>.jsonl here "
                         "(default: AVENIR_TPU_TRACE_EVENTS_DIR, else "
                         "off); sampled wire requests' flow events land "
                         "in it for the tracetool merged timeline")
    ap.add_argument("--run-id", default="serve",
                    help="trace run id — every process of one serving "
                         "run (clients included) must share it")
    ap.add_argument("--trace-index", type=int, default=None,
                    help="this process's trace lane index (unique per "
                         "process of the run; the client convention is "
                         "index 0).  Default: derived from the pid, so "
                         "two hosts launched without it never "
                         "interleave one trace file")
    ap.add_argument("--wire-native", default="auto",
                    choices=("auto", "on", "off"),
                    help="native serving data plane (the ps.wire.native "
                         "knob): one C pass per drained batch for "
                         "message parse/assembly and reply RESP encode; "
                         "'off' pins the pure-python path (a failed "
                         "build of the codec raises)")
    ap.add_argument("--stats-out", default=None)
    ap.add_argument("--ready-file", default=None,
                    help="touched once the fleet is draining — a parent "
                         "orchestrating several hosts waits on these "
                         "before offering load, so a slow-starting host "
                         "isn't measured as absent")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    platform = os.environ.get("AVENIR_TPU_PLATFORM")
    if platform:
        from ..runtime import platform_device, set_default_device
        set_default_device(platform_device(platform))
    from . import (AutoscalePolicy, BatchPolicy, FleetAutoscaler,
                   ModelRegistry, ServingFleet)
    from ..io.respq import make_queue_client

    wire_cfg = {"redis.server.endpoints": args.endpoints,
                "redis.request.queue": args.request_queue,
                "redis.prediction.queue": args.prediction_queue,
                "redis.lease.timeout.s": args.lease_timeout_s}
    scale = None
    n_workers = args.workers
    if args.autoscale:
        lo, _, hi = args.autoscale.partition(":")
        scale = (int(lo), int(hi or lo))
        n_workers = scale[0]
    policy = BatchPolicy(max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         batching=args.batching,
                         slo_p99_ms=args.slo_p99_ms,
                         max_queue_depth=args.max_queue_depth)
    registry = ModelRegistry(args.registry)
    tracer = None
    trace_dir = args.trace_dir or \
        os.environ.get("AVENIR_TPU_TRACE_EVENTS_DIR") or None
    if trace_dir:
        from ..telemetry import Tracer, install_tracer
        # unset index derives from hostname+pid: two fleet_hosts
        # launched without --trace-index — even on DIFFERENT machines
        # sharing an NFS trace dir, where bare pids can collide — must
        # never append into ONE lane file (interleaved lanes read as
        # false span-crossing problems and scramble the flow arrows)
        idx = args.trace_index
        if idx is None:
            import socket
            import zlib
            idx = (zlib.crc32(socket.gethostname().encode()) % 9000
                   + 1000) * 100000 + os.getpid() % 100000
        tracer = install_tracer(Tracer(trace_dir, run_id=args.run_id,
                                       process_index=idx))
        print(f"fleet_host: tracing to {tracer.path}", file=sys.stderr)
    metrics = msrv = None
    if args.metrics_port >= 0:
        from ..telemetry import MetricsRegistry, MetricsServer
        metrics = MetricsRegistry()
        msrv = MetricsServer(metrics, port=args.metrics_port,
                             host=args.metrics_host).start()
        print(f"fleet_host: /metrics on {msrv.url}", file=sys.stderr)
    from ..io import native_wire
    native_wire.set_mode(args.wire_native)
    if not args.model and not args.models:
        print("fleet_host: --model or --models is required",
              file=sys.stderr)
        return 2
    models = [s.strip() for s in (args.models or "").split(",")
              if s.strip()] or None
    depths = {}
    for spec in args.model_depth:
        mname, _, d = spec.partition("=")
        depths[mname.strip()] = int(d)
    fleet = ServingFleet(
        registry, args.model,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        policy=policy, n_workers=n_workers, config=wire_cfg,
        host_label=args.host_label, metrics=metrics,
        wire_native=args.wire_native,
        models=models, model_depths=depths or None)
    fleet.start()
    scaler = sensor = None
    if scale is not None:
        # the sensor needs its OWN broker connection (clients are
        # one-per-thread); autoscale SLO defaults to the batch policy's
        sensor = make_queue_client(wire_cfg, delim=fleet.delim)
        scaler = FleetAutoscaler(
            fleet, sensor, queue=args.request_queue,
            policy=AutoscalePolicy(min_workers=scale[0],
                                   max_workers=scale[1],
                                   slo_p99_ms=args.slo_p99_ms),
            interval_s=args.autoscale_interval_s,
            counters=fleet.workers[0].service.counters).start()
    rc = 0
    # graceful SIGTERM: break the wait loop instead of dying
    # mid-batch, so the finally path below runs fleet.stop() — pending
    # replies flushed (acking their leases in lease mode), accepted
    # requests answered, connections torn down — before the process
    # exits.  SIGKILL remains the chaos-drill crash; its leases expire
    # and redeliver broker-side.
    sigterm = {"hit": False}

    def _on_sigterm(signum, frame):  # noqa: ARG001 - signal signature
        sigterm["hit"] = True

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        pass  # not the main thread / platform without SIGTERM
    try:
        if args.ready_file:
            with open(args.ready_file, "w") as fh:
                fh.write("ready\n")
        # wait for a wire stop (fleet.wait returns once every drain
        # thread exited), SIGTERM, or the idle timeout
        idle_since = time.monotonic()
        last_served = -1
        while not fleet.wait(timeout_s=0.5):
            if sigterm["hit"]:
                print("fleet_host: SIGTERM, draining and exiting",
                      file=sys.stderr)
                break
            served = fleet.stats()["served"]
            if served != last_served:
                last_served = served
                idle_since = time.monotonic()
            elif time.monotonic() - idle_since > args.max_idle_s:
                print(f"fleet_host: idle {args.max_idle_s}s, exiting",
                      file=sys.stderr)
                break
    finally:
        if scaler is not None:
            scaler.stop()
        fleet.stop()
        stats = fleet.stats()
        stats["counters"] = fleet.merged_counters().as_dict()
        if scaler is not None:
            stats["autoscaler"] = {
                "decisions": len(scaler.decisions),
                "final_active": fleet.active_workers(),
            }
        line = json.dumps(stats, sort_keys=True)
        print(line)
        if args.stats_out:
            with open(args.stats_out, "w") as fh:
                fh.write(line + "\n")
        if sensor is not None:
            sensor.close()
        if msrv is not None:
            msrv.stop()
        if tracer is not None:
            from ..telemetry import uninstall_tracer
            uninstall_tracer()
            tracer.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
