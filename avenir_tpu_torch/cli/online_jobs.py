"""The online learning job (org.avenir.online.*): port of
``avenir_tpu/cli/online_jobs.py``.

``onlineLearner`` replays a file of mixed wire messages through the
serve-and-learn plane (``online/``): every served window runs
absorb-rewards -> gradient-step -> predict as one dispatch (the
``online.window`` ledger site) on the job's device (``-Dplatform``), the
learner state staying there between windows.  Config keys (``ps.online.``
namespace; the shared ``ps.`` wire/transport keys keep their serving
meanings):

  ps.online.actions         comma list of bandit arm names (required)
  ps.online.algorithm       ucb1 | softMax | sampsonSampler (default
                            ucb1)
  ps.online.head            bandit | logistic | mlp (default bandit):
                            which head labels replies.  logistic/mlp
                            ALSO require ps.online.features > 0
  ps.online.features        numeric features per predict row (default 0)
  ps.online.learning.rate   SGD step size (default 0.05)
  ps.online.l2              L2 regularization (default 0)
  ps.online.temp            softMax temperature constant (default 0.1)
  ps.online.mlp.hidden      > 0 adds the MLP head (default 0)
  ps.online.mlp.classes     MLP output classes (default 2)
  ps.online.threshold       positive-class threshold for the logistic
                            head AND the outcome labeler (default 0.5)
  ps.online.window.size     messages drained per window (default 64)
  ps.online.seed            PRNG seed (default 42)
  ps.online.pending.capacity   bounded pending-outcome table size
                            (default 4096; full -> oldest evicted)
  ps.online.pending.ttl.s   decision TTL before shedding (default 300)
  ps.online.snapshot.every  supervised windows between registry
                            snapshots (default 32)
  ps.online.accuracy.floor  integer-percent probation floor; breached
                            for ps.online.floor.consecutive windows of
                            ps.online.floor.window outcomes -> rollback
                            to the pinned snapshot (default 0 = off)
  ps.online.floor.window    outcomes per probation window (default 256)
  ps.online.floor.consecutive  breach streak before rollback (default 2)
  ps.online.state.dir       supervisor journal directory (default: a
                            job temp dir — pass a real one to resume)
  ps.model.registry.dir     registry for snapshot/rollback versions;
                            with ps.model.name it enables the
                            supervisor (omit both = unsupervised)
  ps.model.name             the snapshot lineage name
  ps.bucket.sizes           window shape buckets (default 8,64,256)
  ps.transport              inprocess | resp (default inprocess): resp
                            runs the loop against an embedded broker
                            with leased delivery — predicts acked by
                            the reply push, rewards by snapshot-gated
                            ``reward:<id>`` tokens on
                            redis.rewardack.queue
  ps.broker.lease.timeout.s   lease expiry on the resp path (default 30)
  redis.request.queue / redis.prediction.queue / redis.rewardack.queue
                            resp-queue names

The input file holds one WIRE message per line —
``predict,<id>,<f1>,...,<fN>`` and ``reward,<id>,<value>`` interleaved
(a ``stop`` line ends the resp drain early); the output is one
``<id><delim><label>`` line per served prediction, in arrival order.
Counters land in the Online / OnlineProgramCache groups plus the usual
ledger rows.
"""

from __future__ import annotations

from typing import List

from ..core.config import Config
from ..core.metrics import Counters
from ..core import artifacts
from .jobs import register


@register("org.avenir.online.OnlineLearner", "onlineLearner",
          dist="refuse")
def online_learner(cfg: Config, in_path: str, out_path: str) -> Counters:
    import os
    import shutil
    import tempfile
    from ..online.plane import (DEFAULT_WINDOW_BUCKETS,
                                OnlineWindowPlane)
    from ..online.service import OnlineLearnerService, OnlineRespLoop
    from ..online.state import OnlineLearnerConfig

    counters = Counters()
    actions = tuple(s.strip() for s in
                    cfg.must_get("ps.online.actions").split(",")
                    if s.strip())
    ocfg = OnlineLearnerConfig(
        actions=actions,
        n_features=cfg.get_int("ps.online.features", 0),
        algorithm=cfg.get("ps.online.algorithm", "ucb1"),
        head=cfg.get("ps.online.head", "bandit"),
        temp_constant=cfg.get_float("ps.online.temp", 0.1),
        learning_rate=cfg.get_float("ps.online.learning.rate", 0.05),
        l2=cfg.get_float("ps.online.l2", 0.0),
        mlp_hidden=cfg.get_int("ps.online.mlp.hidden", 0),
        mlp_classes=cfg.get_int("ps.online.mlp.classes", 2),
        threshold=cfg.get_float("ps.online.threshold", 0.5),
        seed=cfg.get_int("ps.online.seed", 42))
    if ocfg.head in ("logistic", "mlp") and ocfg.n_features <= 0:
        raise ValueError(f"ps.online.head={ocfg.head} requires "
                         f"ps.online.features > 0")
    buckets = tuple(cfg.get_int_list("ps.bucket.sizes",
                                     list(DEFAULT_WINDOW_BUCKETS)))
    plane = OnlineWindowPlane(
        ocfg, buckets=buckets,
        pending_capacity=cfg.get_int("ps.online.pending.capacity", 4096),
        pending_ttl_s=cfg.get_float("ps.online.pending.ttl.s", 300.0))

    supervisor = None
    tmp_state = None
    reg_dir = cfg.get("ps.model.registry.dir")
    if reg_dir:
        from ..control.controller import (OnlineSupervisor,
                                          OnlineSupervisorPolicy)
        from ..serving.registry import ModelRegistry
        state_dir = cfg.get("ps.online.state.dir")
        if not state_dir:
            state_dir = tmp_state = tempfile.mkdtemp(
                prefix="avenir-online-state-")
        supervisor = OnlineSupervisor(
            ModelRegistry(reg_dir), cfg.must_get("ps.model.name"),
            state_dir,
            policy=OnlineSupervisorPolicy(
                snapshot_every=cfg.get_int("ps.online.snapshot.every",
                                           32),
                accuracy_floor=cfg.get_int("ps.online.accuracy.floor",
                                           0),
                floor_window=cfg.get_int("ps.online.floor.window", 256),
                floor_consecutive=cfg.get_int(
                    "ps.online.floor.consecutive", 2)),
            counters=counters)

    delim = cfg.field_delim_out
    service = OnlineLearnerService(plane, delim=delim,
                                   counters=counters,
                                   supervisor=supervisor)
    window = cfg.get_int("ps.online.window.size", 64)
    if window < 1:
        raise ValueError(f"ps.online.window.size must be >= 1, "
                         f"got {window}")
    messages = list(artifacts.read_text_input(in_path))
    transport = cfg.get("ps.transport", "inprocess")
    replies: List[str] = []
    try:
        if transport == "resp":
            from ..io.respq import RespServer, make_queue_client
            server = RespServer(counters=counters).start()
            client = make_queue_client(
                {"redis.server.host": "127.0.0.1",
                 "redis.server.port": server.port}, delim=delim,
                counters=counters)
            req_q = cfg.get("redis.request.queue", "requestQueue")
            pred_q = cfg.get("redis.prediction.queue", "predictionQueue")
            ack_q = cfg.get("redis.rewardack.queue", "rewardAckQueue")
            loop = OnlineRespLoop(
                service, client, request_queue=req_q,
                reply_queue=pred_q, reward_ack_queue=ack_q,
                batch=window,
                lease_s=cfg.get_float("ps.broker.lease.timeout.s",
                                      30.0))
            try:
                client.lpush_many(req_q, messages)
                loop.run()
                while True:
                    v = client.rpop(pred_q)
                    if v is None:
                        break
                    replies.append(v)   # lpush+rpop drains FIFO
            finally:
                client.close()
                server.stop()
        elif transport == "inprocess":
            for i in range(0, len(messages), window):
                out, _acks = service.process_window(
                    messages[i:i + window])
                replies.extend(out)
            service.flush_acks()
        else:
            raise ValueError(f"ps.transport must be inprocess or resp, "
                             f"got {transport!r}")
        artifacts.write_text_output(out_path, replies)
        service.export(counters)
    finally:
        if tmp_state:
            shutil.rmtree(tmp_state, ignore_errors=True)
    return counters
