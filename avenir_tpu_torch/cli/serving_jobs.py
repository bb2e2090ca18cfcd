"""Online-serving jobs (org.avenir.serving.*), ported from
``avenir_tpu/cli/serving_jobs.py`` for one serving worker.

``predictionService`` replays a file of request records through the
micro-batched serving loop: registry load, warm bucketed predictor,
coalescing policy, and, with ``ps.transport=resp``, the RESP wire: an
embedded ``RespServer``, the records pushed to its request queue as
``predict,<i>,<record>`` lines and a ``stop``, one ``RespPredictionLoop``
draining it, and the replies read back from the prediction queue.
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
  ps.workers                1 (the only fleet size ported)
  ps.broker.shards          1 (the only broker count ported)
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
``ps.request.ttl.ms`` need ``ps.transport=resp``.  The keys of the tiers
not ported yet — fleets (``ps.workers`` > 1), the sharded broker
(``ps.broker.shards`` > 1), the autoscaler (``ps.autoscale``), the
multi-model router (``ps.models``, ``ps.client.model``,
``ps.model.<name>.queue.max.depth``) and its canary and shadow policies
(``ps.canary.*``, ``ps.shadow.*``) — are refused by name rather than
ignored.

The input file holds one record per line; the output is one
``<requestId><delim><predictedClass>`` line per request, requestId = 0-based
input line number.  Latency percentiles land in the counter dump (Serving
group).
"""

from __future__ import annotations

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from .jobs import JobNotPorted, _schema_path, _splitter, register

# keys of the serving tiers not ported yet: setting one must not be ignored
_UNPORTED_KEYS = ("ps.models", "ps.autoscale", "ps.client.model")
_UNPORTED_PREFIXES = ("ps.canary.", "ps.shadow.")
# fleet sizes past one worker and broker counts past one shard
_UNPORTED_COUNTS = ("ps.workers", "ps.broker.shards")


def _refuse_unported(cfg: Config) -> None:
    unported = [k for k in _UNPORTED_KEYS if k in cfg]
    unported += sorted(k for k in cfg.raw()
                       if k.startswith(_UNPORTED_PREFIXES)
                       or (k.startswith("ps.model.")
                           and k.endswith(".queue.max.depth")))
    unported += [f"{k}={cfg.get_int(k)}" for k in _UNPORTED_COUNTS
                 if k in cfg and cfg.get_int(k) != 1]
    if unported:
        raise JobNotPorted(f"predictionService keys {unported} belong to "
                           f"serving tiers not ported to avenir_tpu_torch "
                           f"yet")


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
    _refuse_unported(cfg)
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
    quantized = cfg.get_boolean("ps.quantized", False)
    # tokenize with the INPUT delimiter (field.delim.regex, like every
    # other job); the service delimiter is field.delim.out
    split = _splitter(cfg.field_delim_regex)
    rows = [split(line) for line in artifacts.read_text_input(in_path)]
    od = cfg.field_delim_out
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
