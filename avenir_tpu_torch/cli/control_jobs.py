"""Closed-loop control jobs (org.avenir.control.*): port of
``avenir_tpu/cli/control_jobs.py``.

``retrainController`` runs the drift->retrain->validate->swap controller
(``control/controller.py``) as a batch job: resume a crashed cycle if
the journal holds one, otherwise consume alerts (an ``alerts.jsonl``
file from ``driftMonitor``/``predictDriftScore``, a RESP alert queue, or
an operator ``force`` trigger) and run ONE cycle to its terminal
outcome.  ``in_path`` is the fresh (drifted) labeled window the
incremental retrain trains on.  Its files are the JAX package's byte
for byte, outside the journal's wall-clock ``opened_unix`` fields.

Config keys (``dtb.retrain.*`` next to the builder's ``dtb.*``):

  dtb.model.registry.dir       registry base dir (required)
  dtb.model.name               model name (default forest)
  dtb.feature.schema.file.path schema (required)
  dtb.retrain.state.dir        journal + cycle dirs (default
                               <registry>/_controller/<model>: stable
                               across runs, which is what makes a crashed
                               job resumable by the next run)
  dtb.retrain.trigger          alerts | force (default alerts)
  dtb.retrain.alerts.path      alerts.jsonl to consume (trigger=alerts)
  dtb.retrain.alerts.source    file | resp (default file; resp drains
                               redis.alert.queue on the redis.server.*
                               broker)
  dtb.retrain.holdout.input    labeled delayed-label holdout CSV the
                               validation stage scores champion vs
                               candidate on (default: in_path)
  dtb.retrain.full.input       full dataset for scheduled full rebuilds
                               (default: in_path)
  dtb.retrain.full.rebuild.every  every Nth cycle rebuilds full (0=never)
  dtb.retrain.accuracy.margin  refusal slack, integer points (default 2)
  dtb.retrain.drift.margin     refusal slack, normalized drift (0.25)
  dtb.retrain.probation.outcomes  live outcomes per probation window
                               (0 = no probation, complete at swap)
  dtb.retrain.probation.windows   windows to survive (default 1)
  dtb.retrain.probation.margin    live floor = champion acc - this (5)
  dtb.retrain.probation.input  labeled CSV replayed as live delayed-label
                               outcomes against the SWAPPED serving
                               version — an underperforming candidate
                               auto-rolls-back mid-replay
  dtb.retrain.probation.timeout.s  a probation with NO outcomes resolves
                               as kept-with-a-warning after this long
                               (default 86400; 0 waits forever —
                               resolve_probation() is the escape)
  dtb.retrain.block.rows       streaming build block size (default 65536)
  dtb.retrain.checkpoint.blocks  checkpoint cadence (default 1)
  dtb.retrain.cache.policy     .avtc policy for retrain reads (use)
  dtb.retrain.retire.keep.last registry GC after each cycle (0 = off)
  dtb.retrain.cooldown.s       min seconds between cycle starts (0)
  dtb.retrain.swap.ack.timeout.s  fleet convergence wait (30)
  dtb.retrain.reload.hosts     comma list of fleet host labels for the
                               addressed-reload swap link (with
                               redis.server.* configured; empty = one
                               bare 'reload')
  dtb.num.trees / dtb.* tree keys   candidate forest hyper-parameters
                               (same keys as randomForestBuilder)

Output: ``<out>/decisions.jsonl`` (one line per completed cycle this run,
plus the journal's bounded history) and a one-line ``part-r-00000``
summary; counters in the universal ``<out>.counters.json`` sibling.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..core.config import Config
from ..core.metrics import Counters
from .jobs import _schema_path, _tree_params, register


def _wire_link(cfg: Config):
    """The out-of-process swap link: addressed reloads over the broker
    when one is configured (redis.server.host/endpoints present)."""
    if "redis.server.host" not in cfg and \
            "redis.server.endpoints" not in cfg:
        return None
    from ..control import WireFleetLink
    from ..io.respq import make_queue_client
    client = make_queue_client(
        {k: cfg.get(k) for k in ("redis.server.host", "redis.server.port",
                                 "redis.server.endpoints") if k in cfg})
    hosts = [h.strip() for h in
             (cfg.get("dtb.retrain.reload.hosts") or "").split(",")
             if h.strip()]
    return WireFleetLink(client,
                         request_queue=cfg.get("redis.request.queue",
                                               "requestQueue"),
                         hosts=hosts)


def _probation_replay(cfg: Config, controller, registry, name, schema,
                      counters: Counters) -> Optional[dict]:
    """Replay a labeled CSV as live delayed-label outcomes against the
    version the registry is NOW serving (the swapped candidate) — the
    batch-job stand-in for the fleet's outcome stream.  Stops the moment
    an outcome decides the cycle (probation passed, or rolled back)."""
    from ..control.controller import predict_outcomes
    from ..core.table import BadRecordPolicy, load_csv
    path = cfg.get("dtb.retrain.probation.input")
    if not path or controller.journal.stage != "probation":
        return None
    serving = registry.serving_version(name)
    loaded = registry.load(name, serving)
    table = load_csv(path, schema, cfg.field_delim_regex,
                     bad_records=BadRecordPolicy("skip", None, counters))
    # THE shared predict+decode (controller validation uses the same):
    # the replay must score the identical metric validation scored
    labels, actual = predict_outcomes(loaded.model, schema, table)
    counters.increment("Controller", "ProbationOutcomesReplayed",
                       len(labels))
    for pred, act in zip(labels, actual):
        verdict = controller.record_outcome(pred, act)
        if verdict is not None:
            return verdict
    return None


@register("org.avenir.control.RetrainController", "retrainController",
          dist="refuse")
def retrain_controller(cfg: Config, in_path: str, out_path: str
                       ) -> Counters:
    from ..control import (RetrainController, RetrainPolicy,
                           alerts_from_jsonl, alerts_from_resp)
    from ..serving.registry import ModelRegistry

    counters = Counters()
    registry = ModelRegistry(cfg.must_get("dtb.model.registry.dir"))
    name = cfg.get("dtb.model.name", "forest")
    schema = _schema_path(cfg, "dtb.feature.schema.file.path")
    from ..models.forest import ForestParams
    params = ForestParams(tree=_tree_params(cfg),
                          num_trees=cfg.get_int("dtb.num.trees", 5),
                          seed=cfg.get_int("dtb.random.seed", 0))
    state_dir = cfg.get("dtb.retrain.state.dir") or os.path.join(
        registry.base_dir, "_controller", name)
    policy = RetrainPolicy(
        full_rebuild_every=cfg.get_int("dtb.retrain.full.rebuild.every", 0),
        accuracy_margin=cfg.get_int("dtb.retrain.accuracy.margin", 2),
        drift_margin=cfg.get_float("dtb.retrain.drift.margin", 0.25),
        probation_outcomes=cfg.get_int("dtb.retrain.probation.outcomes", 0),
        probation_windows=cfg.get_int("dtb.retrain.probation.windows", 1),
        probation_margin=cfg.get_int("dtb.retrain.probation.margin", 5),
        probation_timeout_s=cfg.get_float(
            "dtb.retrain.probation.timeout.s", 24 * 3600.0),
        swap_ack_timeout_s=cfg.get_float("dtb.retrain.swap.ack.timeout.s",
                                         30.0),
        cooldown_s=cfg.get_float("dtb.retrain.cooldown.s", 0.0),
        chunk_rows=cfg.get_int("dtb.retrain.block.rows", 1 << 16),
        checkpoint_blocks=cfg.get_int("dtb.retrain.checkpoint.blocks", 1),
        baseline_bins=cfg.get_int("dtb.baseline.bins", 32),
        cache_policy=cfg.get("dtb.retrain.cache.policy", "use"),
        retire_keep_last=cfg.get_int("dtb.retrain.retire.keep.last", 0))
    link = _wire_link(cfg)
    controller = RetrainController(
        registry, name, schema, state_dir=state_dir,
        train_source=in_path,
        holdout_source=cfg.get("dtb.retrain.holdout.input"),
        full_source=cfg.get("dtb.retrain.full.input"),
        forest_params=params, fleet=link, policy=policy,
        counters=counters, delim_regex=cfg.field_delim_regex)

    try:
        trigger = cfg.get("dtb.retrain.trigger", "alerts")
        if trigger not in ("alerts", "force"):
            raise ValueError(f"dtb.retrain.trigger must be alerts|force, "
                             f"got {trigger!r}")
        summaries = []
        if controller.journal.pending:
            # a crashed prior run left a mid-flight cycle: resuming it wins
            # over starting anything new.  For a probation-wait this tick is
            # where the probation TIMEOUT gets evaluated (run_pending
            # returns None while genuinely waiting; the replay below feeds
            # outcomes when an input is configured)
            s = controller.run_pending()
            if s and "outcome" in s:
                summaries.append(s)
        elif trigger == "force":
            s = controller.force_cycle()
            if s and "outcome" in s:
                summaries.append(s)
        else:
            source = cfg.get("dtb.retrain.alerts.source", "file")
            if source == "resp":
                # the same broker resolution as the swap link: a sharded
                # deployment configured only with redis.server.endpoints
                # must drain its alert queue off the ring, not a
                # hard-coded single host
                from ..io.respq import make_queue_client
                client = make_queue_client(
                    {k: cfg.get(k) for k in
                     ("redis.server.host", "redis.server.port",
                      "redis.server.endpoints") if k in cfg})
                try:
                    controller.consume(alerts_from_resp(
                        client, cfg.get("redis.alert.queue", "alertQueue")))
                finally:
                    client.close()
            elif source == "file":
                apath = cfg.get("dtb.retrain.alerts.path")
                if not apath:
                    raise ValueError("dtb.retrain.trigger=alerts needs "
                                     "dtb.retrain.alerts.path (or "
                                     "dtb.retrain.alerts.source=resp)")
                controller.consume(alerts_from_jsonl(apath))
            else:
                raise ValueError(f"dtb.retrain.alerts.source must be "
                                 f"file|resp, got {source!r}")
            s = controller.run_pending()
            if s and "outcome" in s:
                summaries.append(s)
        verdict = _probation_replay(cfg, controller, registry, name, schema,
                                    counters)
        if verdict is not None:
            summaries.append(verdict)

        os.makedirs(out_path, exist_ok=True)
        with open(os.path.join(out_path, "decisions.jsonl"), "w") as fh:
            for s in summaries:
                fh.write(json.dumps({"this_run": True, **s},
                                    sort_keys=True) + "\n")
            for h in controller.journal.history:
                fh.write(json.dumps(h, sort_keys=True) + "\n")
        jr = controller.journal
        with open(os.path.join(out_path, "part-r-00000"), "w") as fh:
            od = cfg.field_delim_out
            fh.write(od.join([
                str(jr.cycle), jr.stage, str(jr["outcome"]),
                str(jr["champion_version"]), str(jr["candidate_version"]),
                str(registry.serving_version(name))]) + "\n")
        counters.set("Controller", "ServingVersion",
                     registry.serving_version(name) or 0)
        return counters
    finally:
        if link is not None:
            # the swap link's broker connection is job-scoped (the
            # alert drain closes its own): a cadenced runner must not
            # leak one socket per invocation
            try:
                link.client.close()
            except OSError:
                pass
