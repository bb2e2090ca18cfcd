"""Online-serving jobs (org.avenir.serving.*), ported from
``avenir_tpu/cli/serving_jobs.py``.

``predictionService`` replays a file of request records through the
micro-batched serving loop: registry load, warm bucketed predictor,
coalescing policy, and, with ``ps.transport=resp``, the RESP wire: an
embedded ``RespServer``, the records pushed to its request queue as
``predict,<i>,<record>`` lines and a ``stop``, one ``RespPredictionLoop``
draining it, and the replies read back from the prediction queue.  With
``ps.workers`` > 1, ``ps.broker.shards`` > 1, ``ps.models`` or
``ps.autoscale`` the replay runs through the fleet tier instead: M
embedded broker shards on a consistent-hash ring and a ``ServingFleet``
of workers (each a ``ModelRouter`` under ``ps.models``) draining it.
Config keys (``ps.`` namespace, as in the reference):

  ps.model.registry.dir     registry base directory (required)
  ps.model.name             model name in the registry (required)
  ps.model.version          pin a version (default: the serving version)
  ps.feature.schema.file.path  override the artifact's embedded schema
  ps.batch.max.size         micro-batch close size (default 64)
  ps.batch.max.wait.ms      micro-batch window (default 2.0)
  ps.batching               continuous | drain (default continuous)
  ps.slo.p99.ms             p99 budget; >0 enables the adaptive window
  ps.queue.max.depth        admission threshold (default 0 = unbounded)
  ps.bucket.sizes           batch shape buckets (default 1,8,64,512)
  ps.warm.start             warm all buckets at load (default true)
  ps.latency.window         latency sample window (default 8192)
  ps.transport              inprocess | resp (default inprocess)
  ps.quantized              serve the version's int8-quantized forest
                            sidecar (default false; a version without an
                            intact sidecar warns and serves float)
  ps.models                 comma list of resident models for the
                            multi-model router, each ``name`` (follow the
                            registry's serving version) or ``name:version``
                            (pinned); requests route by the optional wire
                            field ``m=<name[:version]>``, and requests
                            without one serve the default model
                            (ps.model.name, else the first spec) byte for
                            byte.  Requires ps.transport=resp
  ps.model.<name>.queue.max.depth
                            per-model admission depth for resident <name>
                            (default ps.queue.max.depth)
  ps.canary.<name>.version  canary this version of resident <name>: the
                            deterministic crc32(request id) split routes
                            ps.canary.<name>.percent % (default 10) of the
                            model's traffic to it
  ps.shadow.<name>.version  shadow this version behind resident <name>: it
                            scores every request, replies come from the
                            champion, divergence is counted
  ps.client.model           stamp every replayed request with this
                            ``m=<name[:version]>`` routing field
  ps.workers                fleet size; > 1 serves through a ServingFleet
                            (default 1; requires ps.transport=resp)
  ps.broker.shards          embedded broker shards; > 1 puts every client
                            on the ShardedRespClient ring (default 1;
                            requires ps.transport=resp)
  ps.host.label             the fleet's host label on metric series and
                            stats (default: this host's name)
  ps.autoscale              run the fleet under the FleetAutoscaler
                            (default false; requires ps.transport=resp)
  ps.autoscale.min.workers / ps.autoscale.max.workers
                            active-worker bounds (default 1 / 4)
  ps.autoscale.interval.ms  the autoscaler's tick (default 250)
  ps.broker.durable         broker queue durability: off | commit | fsync
                            (env twin AVENIR_TPU_BROKER_DURABLE; default
                            off).  commit/fsync journal the embedded
                            broker under a temporary directory, removed
                            when the job ends; fsync also forces the OS
                            flush per batch
  ps.broker.lease.timeout.s the loop's pops become visibility-timeout
                            leases with this expiry, acked by the batched
                            reply push (default 30 when ps.broker.durable
                            != off, else 0 = destructive pops)
  ps.request.ttl.ms         stamp every request with an absolute deadline
                            this far in the future; a request past it
                            answers '<id>,late' before any device dispatch
                            (default 0 = none)
  ps.trace.sample           request-trace head sampling: every Nth request
                            carries the wire trace field and leaves flow
                            events (env twin AVENIR_TPU_TRACE_SAMPLE;
                            default 0 = off).  Sets the PROCESS sampling
                            rate, like the env twin
  ps.wire.native            auto | on | off (default auto): the native
                            serving data plane (one C pass a drained batch
                            for parse and assembly, and the reply encode);
                            ``off`` pins the Python plane, the
                            differential baseline.  A failed build of the
                            codec raises
  redis.request.queue / redis.prediction.queue   resp-queue names

``ps.broker.durable``, ``ps.broker.lease.timeout.s`` and
``ps.request.ttl.ms`` need ``ps.transport=resp``, as do the fleet keys.

The input file holds one record per line; the output is one
``<requestId><delim><predictedClass>`` line per request, requestId = 0-based
input line number.  Latency percentiles land in the counter dump (Serving
group).
"""

from __future__ import annotations

from typing import List

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from .jobs import _schema_path, _splitter, register


@register("org.avenir.serving.PredictionService", "predictionService",
          dist="refuse")
def prediction_service(cfg: Config, in_path: str, out_path: str) -> Counters:
    from ..io.respq import resolve_durable
    from ..serving.predictor import DEFAULT_BUCKETS, make_predictor
    from ..serving.registry import ModelRegistry
    from ..serving.service import BatchPolicy, PredictionService
    from ..utils.tracing import StepTimer
    transport = cfg.get("ps.transport", "inprocess")
    if transport not in ("inprocess", "resp"):
        raise ValueError(f"unknown ps.transport {transport!r} "
                         "(inprocess | resp)")
    n_workers = cfg.get_int("ps.workers", 1)
    n_shards = cfg.get_int("ps.broker.shards", 1)
    autoscale = cfg.get_boolean("ps.autoscale", False)
    models_spec = [m.strip() for m in
                   (cfg.get("ps.models") or "").split(",") if m.strip()]
    if n_workers > 1 and transport != "resp":
        raise ValueError("ps.workers > 1 requires ps.transport=resp "
                         "(the fleet drains a RESP request queue)")
    if models_spec and transport != "resp":
        raise ValueError("ps.models requires ps.transport=resp (the "
                         "model router serves through the fleet)")
    if (n_shards > 1 or autoscale) and transport != "resp":
        raise ValueError("ps.broker.shards > 1 / ps.autoscale require "
                         "ps.transport=resp (both live on the wire tier)")
    if n_shards < 1:
        raise ValueError(f"ps.broker.shards must be >= 1, got {n_shards}")
    if n_workers < 1:
        raise ValueError(f"ps.workers must be >= 1, got {n_workers}")
    durable = resolve_durable(cfg.get("ps.broker.durable"))
    lease_s = cfg.get_float("ps.broker.lease.timeout.s",
                            30.0 if durable != "off" else 0.0)
    ttl_ms = cfg.get_float("ps.request.ttl.ms", 0.0)
    if (durable != "off" or lease_s > 0 or ttl_ms > 0) \
            and transport != "resp":
        raise ValueError("ps.broker.durable / ps.broker.lease.timeout.s"
                         " / ps.request.ttl.ms require ps.transport=resp"
                         " (all three live on the wire tier)")
    counters = Counters()
    # an EXPLICIT ps.trace.sample always wins — including 0, which switches
    # sampling off over an exported AVENIR_TPU_TRACE_SAMPLE
    if "ps.trace.sample" in cfg:
        from ..telemetry import reqtrace
        reqtrace.set_sample_rate(cfg.get_int("ps.trace.sample", 0))
    wire_native = cfg.get("ps.wire.native", "auto")
    if "ps.wire.native" in cfg:
        # the explicit knob also sets the PROCESS default, so the feeder
        # client built below follows it
        from ..io import native_wire
        native_wire.set_mode(wire_native)
    registry = ModelRegistry(cfg.must_get("ps.model.registry.dir"))
    if models_spec:
        from ..serving.router import parse_model_spec
        model_names = [parse_model_spec(m)[0] for m in models_spec]
        name = cfg.get("ps.model.name") or model_names[0]
    else:
        model_names = []
        name = cfg.must_get("ps.model.name")
    schema = _schema_path(cfg, "ps.feature.schema.file.path") \
        if "ps.feature.schema.file.path" in cfg else None
    policy = BatchPolicy(
        max_batch=cfg.get_int("ps.batch.max.size", 64),
        max_wait_ms=cfg.get_float("ps.batch.max.wait.ms", 2.0),
        batching=cfg.get("ps.batching", "continuous"),
        slo_p99_ms=cfg.get_float("ps.slo.p99.ms", 0.0),
        max_queue_depth=cfg.get_int("ps.queue.max.depth", 0))
    timer = StepTimer(keep_samples=cfg.get_int("ps.latency.window", 8192))
    buckets = tuple(cfg.get_int_list("ps.bucket.sizes",
                                     list(DEFAULT_BUCKETS)))
    warm = cfg.get_boolean("ps.warm.start", True)
    version = cfg.get_int("ps.model.version", 0)
    if models_spec and version:
        raise ValueError("ps.models and ps.model.version are exclusive "
                         "— pin per model with name:version specs")
    quantized = cfg.get_boolean("ps.quantized", False)
    # tokenize with the INPUT delimiter (field.delim.regex, like every
    # other job); the service delimiter is field.delim.out
    split = _splitter(cfg.field_delim_regex)
    rows = [split(line) for line in artifacts.read_text_input(in_path)]
    od = cfg.field_delim_out
    if n_workers > 1 or n_shards > 1 or autoscale or models_spec:
        out = _serve_fleet(cfg, registry, name, model_names, models_spec,
                           schema, buckets, policy, warm, version,
                           quantized, wire_native, rows, counters, durable,
                           lease_s, ttl_ms, n_workers, n_shards, autoscale)
        artifacts.write_text_output(out_path, out, role="m")
        return counters
    common = dict(policy=policy, counters=counters, timer=timer, warm=warm,
                  delim=od, wire_native=wire_native)
    if version:
        # pinned serving: build the predictor for that exact version (a
        # pin is a pin: no hot-swap refresh)
        loaded = registry.load(name, version, schema=schema)
        svc = PredictionService(
            make_predictor(loaded, schema=schema, buckets=buckets, delim=od,
                           quantized=quantized),
            **common)
        svc.version = version
    else:
        svc = PredictionService(registry=registry, model_name=name,
                                schema=schema, buckets=buckets,
                                quantized=quantized, **common)
    counters.set("Serving", "ModelVersion", svc.version or 0)
    if transport == "resp":
        out = _serve_resp(cfg, svc, rows, counters, durable, lease_s,
                          ttl_ms)
    else:
        svc.start()
        futures = [svc.submit(row) for row in rows]
        results = []
        for f in futures:
            try:
                results.append(f.result(timeout=120))
            except Exception:
                # a malformed record costs ITS response line, not the
                # replay
                results.append(svc.error_label)
        svc.stop()
        out = [f"{i}{od}{r}" for i, r in enumerate(results)]
    artifacts.write_text_output(out_path, out, role="m")
    timer.export(counters, group="Serving")
    return counters


def _serve_resp(cfg: Config, svc, rows, counters, durable: str,
                lease_s: float, ttl_ms: float):
    """The replay over the wire: an embedded broker (journaled under a
    temporary directory when durable), the records pushed one LPUSH each
    and a ``stop``, one ``RespPredictionLoop`` run to the stop, and the
    replies read back and sorted by request id."""
    import shutil
    import tempfile
    from ..io.respq import RespClient, RespServer
    from ..serving.service import RespPredictionLoop
    od = svc.delim
    journal_root = tempfile.mkdtemp(prefix="avenir-broker-journal-") \
        if durable != "off" else None
    server = RespServer(durable=durable, journal_dir=journal_root,
                        counters=counters).start()
    try:
        req_q = cfg.get("redis.request.queue", "requestQueue")
        pred_q = cfg.get("redis.prediction.queue", "predictionQueue")
        loop = RespPredictionLoop(svc, {"redis.server.port": server.port,
                                        "redis.request.queue": req_q,
                                        "redis.prediction.queue": pred_q,
                                        "redis.lease.timeout.s": lease_s})
        feeder = RespClient(port=server.port, delim=od, counters=counters)
        msgs = [od.join(["predict", str(i)] + row)
                for i, row in enumerate(rows)]
        if ttl_ms > 0:
            from ..telemetry import reqtrace
            msgs = reqtrace.stamp_deadline(msgs, ttl_ms, delim=od)
        for m in msgs:
            feeder.lpush(req_q, m)
        feeder.lpush(req_q, "stop")
        loop.run(max_idle_s=30.0)
        out = []
        while True:
            v = feeder.rpop(pred_q)
            if v is None:
                break
            out.append(v)
        out.sort(key=lambda r: int(r.split(od, 1)[0]))
        loop.close()
        feeder.close()
    finally:
        server.stop()
        if journal_root is not None:
            shutil.rmtree(journal_root, ignore_errors=True)
    return out


def _serve_fleet(cfg: Config, registry, name, model_names, models_spec,
                 schema, buckets, policy, warm, version, quantized,
                 wire_native, rows, counters, durable, lease_s, ttl_ms,
                 n_workers, n_shards, autoscale) -> List[str]:
    """The replay through the fleet tier: ``n_shards`` embedded broker
    shards (journaled under a temporary directory when durable), a
    ``ServingFleet`` (a 1-worker fleet over a ring too), the canary and
    shadow policies from config, the autoscaler, the records pushed as one
    pipelined push and a ``stop``, and the replies read back, first reply
    an id wins.  The fleet's merged counters (read after the fleet
    stopped, so a shadow's last counts are in; the JAX package reads them
    before and can miss them) and latency percentiles, the shard count
    and the served version land in ``counters``."""
    import os
    import shutil
    import tempfile
    import warnings
    from ..io.respq import RespServer, dedup_replies, make_queue_client
    from ..serving.autoscaler import AutoscalePolicy, FleetAutoscaler
    from ..serving.fleet import ServingFleet
    od = cfg.field_delim_out
    model_depths = {
        m: cfg.get_int(f"ps.model.{m}.queue.max.depth",
                       policy.max_queue_depth)
        for m in model_names if f"ps.model.{m}.queue.max.depth" in cfg}

    def pinned_factory():
        # a pinned version is a pin: no hot-swap refresh
        from ..serving.predictor import make_predictor
        loaded = registry.load(name, version, schema=schema)
        return make_predictor(loaded, schema=schema, buckets=buckets,
                              delim=od, quantized=quantized)

    servers: List[RespServer] = []
    fleet = feeder = scaler = sensor = journal_root = None
    try:
        if durable != "off":
            journal_root = tempfile.mkdtemp(prefix="avenir-broker-journal-")
        for k in range(n_shards):
            jdir = os.path.join(journal_root, f"shard{k}") \
                if journal_root else None
            servers.append(RespServer(durable=durable, journal_dir=jdir,
                                      counters=counters).start())
        req_q = cfg.get("redis.request.queue", "requestQueue")
        pred_q = cfg.get("redis.prediction.queue", "predictionQueue")
        wire_cfg = {"redis.server.endpoints":
                    [f"127.0.0.1:{s.port}" for s in servers],
                    "redis.request.queue": req_q,
                    "redis.prediction.queue": pred_q,
                    "redis.lease.timeout.s": lease_s}
        start_workers = n_workers
        if autoscale:
            # the fleet starts at the configured floor, as fleet_host's
            # --autoscale MIN:MAX does
            start_workers = max(
                n_workers, cfg.get_int("ps.autoscale.min.workers", 1))
        pinned = bool(version) and not models_spec
        fleet = ServingFleet(
            registry=None if pinned else registry,
            model_name=None if pinned else name,
            predictor_factory=pinned_factory if pinned else None,
            schema=schema, buckets=buckets, policy=policy,
            n_workers=start_workers, config=wire_cfg, warm=warm,
            delim=od, quantized=quantized,
            host_label=cfg.get("ps.host.label"),
            latency_window=cfg.get_int("ps.latency.window", 8192),
            wire_native=wire_native, models=models_spec or None,
            model_depths=model_depths or None)
        fleet.start()
        for mname in model_names:
            cv = cfg.get_int(f"ps.canary.{mname}.version", 0)
            if cv:
                fleet.install_canary(
                    mname, version=cv,
                    percent=cfg.get_int(f"ps.canary.{mname}.percent", 10))
            sv = cfg.get_int(f"ps.shadow.{mname}.version", 0)
            if sv:
                fleet.install_shadow(mname, version=sv)
        if autoscale:
            # the sensor's own connection (a client is one thread's)
            sensor = make_queue_client(wire_cfg, delim=od)
            scaler = FleetAutoscaler(
                fleet, sensor, queue=req_q,
                policy=AutoscalePolicy(
                    min_workers=cfg.get_int("ps.autoscale.min.workers", 1),
                    max_workers=cfg.get_int("ps.autoscale.max.workers", 4),
                    slo_p99_ms=policy.slo_p99_ms),
                interval_s=cfg.get_float("ps.autoscale.interval.ms",
                                         250.0) / 1000.0,
                counters=counters).start()
        feeder = make_queue_client(wire_cfg, delim=od)
        msgs = [od.join(["predict", str(i)] + row)
                for i, row in enumerate(rows)]
        if ttl_ms > 0:
            from ..telemetry import reqtrace
            msgs = reqtrace.stamp_deadline(msgs, ttl_ms, delim=od)
        client_model = cfg.get("ps.client.model")
        if client_model:
            from ..telemetry import reqtrace
            msgs = reqtrace.stamp_model(msgs, client_model, delim=od)
        feeder.lpush_many(req_q, msgs)
        feeder.lpush(req_q, "stop")
        if not fleet.wait(timeout_s=300.0):
            # a wedged worker means an incomplete reply set: no part file
            raise RuntimeError(
                "predictionService fleet: worker(s) still draining after "
                "300s — replay aborted (partial output suppressed)")
        if scaler is not None:
            scaler.stop()
            counters.set("Autoscaler", "FinalActiveWorkers",
                         fleet.active_workers())
        replies: List[str] = []
        while True:
            v = feeder.rpop(pred_q)
            if v is None:
                break
            replies.append(v)
        # first reply an id wins: the client's reconnect is at-least-once
        # on writes, so a re-pushed request could answer twice
        by_id, dups = dedup_replies(replies, delim=od)
        if dups:
            warnings.warn(f"predictionService fleet: {dups} duplicate "
                          f"replies deduped (reconnect re-push window)",
                          RuntimeWarning)
        if len(by_id) != len(rows):
            raise RuntimeError(
                f"predictionService fleet: {len(by_id)} replies for "
                f"{len(rows)} requests — replay aborted (partial output "
                f"suppressed)")
        out = [f"{rid}{od}{by_id[rid]}" for rid in sorted(by_id, key=int)]
        # stop before reading the counters: a shadow's (or a canary's)
        # service may still be scoring the last requests the champion
        # already answered, and its counts land when it drains
        fleet.stop()
        for grp, names in fleet.merged_counters().as_dict().items():
            counters.update_group(grp, names)
        fleet.merged_timer().export(counters, group="Serving")
        counters.set("Broker", "Shards", n_shards)
        versions = [w.service.version or 0 for w in fleet.workers]
        counters.set("Serving", "ModelVersion",
                     version or min(versions, default=0))
    finally:
        # every path tears down: no worker left serving (and bound to the
        # default registry), no socket left open
        if scaler is not None:
            scaler.stop()
        if fleet is not None:
            fleet.stop()
        for cli in (feeder, sensor):
            if cli is not None:
                cli.close()
        for srv in servers:
            srv.stop()
        if journal_root is not None:
            shutil.rmtree(journal_root, ignore_errors=True)
    return out
