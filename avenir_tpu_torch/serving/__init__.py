"""Online prediction serving (port of ``avenir_tpu/serving``): the model
registry (publish whole or as a delta, read, sidecars, the serving pin,
retention), warm bucketed predictors (float and int8, with the delta
patch), the micro-batched serving loop in-process and over the RESP wire
(``service.RespPredictionLoop``), and the fleet tier above it:

  * :mod:`.fleet`      — :class:`ServingFleet`, N workers draining one
    RESP request queue or a ring of broker shards, with coordinated
    hot-swap, degraded and autoscaler parking, admission control and
    per-worker ``/healthz/<name>`` targets;
  * :mod:`.router`     — :class:`ModelRouter`, N resident models per
    worker routed by the wire ``m=`` field, per-model admission depths,
    canary and shadow deployment;
  * :mod:`.autoscaler` — :class:`FleetAutoscaler`, the depth, derivative
    and p99 control loop acting through ``ServingFleet.scale_to``;
  * :mod:`.fleet_host` — one fleet per OS process.
"""

from .autoscaler import AutoscalePolicy, FleetAutoscaler
from .fleet import ServingFleet
from .predictor import (DEFAULT_BUCKETS, BayesPredictor, ForestPredictor,
                        LogisticPredictor, Predictor, make_predictor)
from .registry import ModelRegistry
from .router import ModelRouter, canary_split, parse_model_spec
from .service import BatchPolicy, PredictionService, RespPredictionLoop

__all__ = [
    "ModelRegistry", "DEFAULT_BUCKETS", "BayesPredictor", "ForestPredictor",
    "LogisticPredictor", "Predictor", "make_predictor", "BatchPolicy",
    "PredictionService", "RespPredictionLoop", "ModelRouter",
    "canary_split", "parse_model_spec",
    "ServingFleet", "AutoscalePolicy", "FleetAutoscaler",
]
