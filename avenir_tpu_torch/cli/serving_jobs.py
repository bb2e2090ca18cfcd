"""Online-serving jobs (org.avenir.serving.*), ported from
``avenir_tpu/cli/serving_jobs.py`` for the in-process transport.

``predictionService`` replays a file of request records through the
micro-batched serving loop: registry load, warm bucketed predictor,
coalescing policy.  Config keys (``ps.`` namespace, as in the reference):

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
  ps.transport              inprocess (the only transport ported so far)
  ps.quantized              serve the version's int8-quantized forest
                            sidecar (default false; a version without an
                            intact sidecar warns and serves float)

Keys of the unported serving tiers (RESP wire, fleets, brokers, routers)
are refused by name rather than ignored.

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

# keys whose serving tier is not ported: setting one must not be ignored
_UNPORTED_KEYS = ("ps.models", "ps.workers", "ps.broker.shards",
                  "ps.broker.durable", "ps.broker.lease.timeout.s",
                  "ps.request.ttl.ms", "ps.autoscale", "ps.client.model",
                  "ps.trace.sample")


@register("org.avenir.serving.PredictionService", "predictionService",
          dist="refuse")
def prediction_service(cfg: Config, in_path: str, out_path: str) -> Counters:
    from ..serving.predictor import DEFAULT_BUCKETS, make_predictor
    from ..serving.registry import ModelRegistry
    from ..serving.service import BatchPolicy, PredictionService
    from ..utils.tracing import StepTimer
    transport = cfg.get("ps.transport", "inprocess")
    if transport != "inprocess":
        raise JobNotPorted(f"predictionService ps.transport={transport!r} "
                           f"is not ported to avenir_tpu_torch yet "
                           f"(ported: inprocess)")
    unported = [k for k in _UNPORTED_KEYS if k in cfg]
    if unported:
        raise JobNotPorted(f"predictionService keys {unported} belong to "
                           f"serving tiers not ported to avenir_tpu_torch "
                           f"yet")
    counters = Counters()
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
                  delim=od)
    if version:
        # pinned serving: build the predictor for that exact version
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
    svc.start()
    futures = [svc.submit(row) for row in rows]
    results = []
    for f in futures:
        try:
            results.append(f.result(timeout=120))
        except Exception:
            # a malformed record costs ITS response line, not the replay
            results.append("error")
    svc.stop()
    out = [f"{i}{od}{r}" for i, r in enumerate(results)]
    artifacts.write_text_output(out_path, out, role="m")
    timer.export(counters, group="Serving")
    return counters
