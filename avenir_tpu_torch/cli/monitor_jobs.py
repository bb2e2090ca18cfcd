"""Drift-monitoring jobs (org.avenir.monitor.*), ported from
``avenir_tpu/cli/monitor_jobs.py``.

``driftMonitor`` replays a record stream (a CSV file or a dir of part
files) against a registry model's training baseline and emits one
drift-score row per (window, monitored distribution).  Config keys
(``dm.`` namespace, as in the reference):

  dm.model.registry.dir      registry base directory (required)
  dm.model.name              model name in the registry (required)
  dm.model.version           pin a version (default: the serving version)
  dm.feature.schema.file.path  override the artifact's embedded schema
  dm.window.rows             tumbling window size (default 2048)
  dm.longterm.decay          exponential long-window decay (default 0.9)
  dm.consecutive.windows     debounce: windows at a level before an alert
                             record emits (default 2)
  dm.warn.<stat> / dm.alert.<stat>   threshold overrides per statistic
                             (psi, kl, js, ks, chi2)
  dm.score.predictions       also run the model per window: prediction-
                             class distribution + delayed-label accuracy
                             when the class column holds known labels
                             (default false)
  dm.accuracy.warn/.alert    integer accuracy percents (0 = disabled)
  dm.accuracy.window         outcomes per quality window (default:
                             dm.window.rows)
  dm.source                  file | resp (default file).  ``resp`` drains
                             the records from a RESP list queue
                             (redis.server.host / redis.server.port /
                             redis.request.queue) in pipelined pops until
                             a ``stop`` line or dm.resp.max.idle.s
                             (default 10) without traffic
  badrecords.policy          skip (default) | quarantine | fail

Output: ``<out>/part-r-00000`` rows ``windowIndex,windowKind,scope,
rowKind,nRows,psi,kl,js,ks,chi2,level`` and, on the first debounced
record, ``<out>/alerts.jsonl``; the counters land in ``<out>.counters.json``
(``cli/run.py``).  Every absorbed block is one bin-counts launch (kernel
B4) into the window's device matrix; with ``dm.score.predictions`` every
window is also one forest-vote batch (kernel B2, ``make_predictor``).

``predictDriftScore`` runs the predictions and the drift report in one
pass.  With ``dm.pipeline.fuse`` unset or true (the default) a forest of
several members scores each window as one chunk of
``pipeline.flows.PredictDriftFlow``: the vote (kernel B2) and the window's
bin counts (kernel B4) with the predicted classes spliced into the class
row on the device.  A window the flow's gate refuses, and every window
under ``dm.pipeline.fuse=false``, takes the unfused pair (a forest-vote
batch, then the absorb); both give the same bytes, and the
``PredictDrift`` counters say how many windows took each route.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..core.config import Config
from ..core.metrics import Counters
from .jobs import _splitter, register


def _threshold_overrides(cfg: Config, prefix: str):
    from ..monitor.drift import STATS
    out = {}
    for stat in STATS:
        key = f"{prefix}.{stat}"
        if key in cfg:
            out[stat] = cfg.get_float(key)
    return out


def _iter_line_windows(in_path: str, split, window_rows: int):
    """Token-row windows from a CSV file or a dir of part files, read line
    by line (never the whole stream in memory)."""
    if os.path.isdir(in_path):
        paths = sorted(os.path.join(in_path, p)
                       for p in os.listdir(in_path)
                       if os.path.isfile(os.path.join(in_path, p))
                       and not p.startswith(("_", ".")))
    else:
        paths = [in_path]
    rows: List[List[str]] = []
    for p in paths:
        with open(p, "r") as fh:
            for line in fh:
                line = line.rstrip("\r\n")
                if not line.strip():
                    continue
                rows.append(split(line))
                if len(rows) >= window_rows:
                    yield rows
                    rows = []
    if rows:
        yield rows


def _iter_resp_windows(cfg: Config, split, window_rows: int):
    """Token-row windows drained from a RESP list queue (pipelined pops,
    the serving loop's wire discipline); 'stop' or the idle timeout ends
    the stream."""
    from ..io.respq import RespClient
    client = RespClient(cfg.get("redis.server.host", "127.0.0.1"),
                        int(cfg.get("redis.server.port", 6379)))
    queue = cfg.get("redis.request.queue", "requestQueue")
    max_idle_s = cfg.get_float("dm.resp.max.idle.s", 10.0)
    idle_since = time.monotonic()
    stopped = False
    try:
        rows: List[List[str]] = []
        while not stopped:
            msgs = client.rpop_many(queue, window_rows)
            if not msgs:
                if time.monotonic() - idle_since > max_idle_s:
                    break
                time.sleep(0.002)
                continue
            idle_since = time.monotonic()
            for m in msgs:
                if m == "stop":
                    stopped = True
                else:
                    rows.append(split(m))
            while len(rows) >= window_rows:
                yield rows[:window_rows]
                rows = rows[window_rows:]
        if rows:
            yield rows
    finally:
        client.close()


# --------------------------------------------------------------------------
# shared plumbing of driftMonitor and predictDriftScore: model resolution,
# policy / monitor / tracker construction, the window source, bad-record
# filtering, report formatting and the per-window drain
# --------------------------------------------------------------------------

def _resolve_model_version(cfg: Config, registry, name: str) -> int:
    version: Optional[int] = cfg.get_int("dm.model.version", 0) or None
    if version is None:
        version = registry.serving_version(name)
        if version is None:
            raise FileNotFoundError(
                f"no intact versions of model {name!r} in "
                f"{registry.base_dir!r}")
    return version


def _monitor_schema(cfg: Config, registry, name: str, version: int,
                    loaded):
    """``dm.feature.schema.file.path`` wins; otherwise the artifact's
    embedded schema.  Returns (schema, loaded); the artifact is loaded at
    most once."""
    from ..core.schema import FeatureSchema
    if "dm.feature.schema.file.path" in cfg:
        return FeatureSchema.load(
            cfg.must_get("dm.feature.schema.file.path")), loaded
    if loaded is None:
        loaded = registry.load(name, version)
    schema = loaded.schema
    if schema is None:
        raise ValueError(
            f"model {name!r} v{version} embeds no schema; set "
            "dm.feature.schema.file.path")
    return schema, loaded


def _make_policy_monitor(cfg: Config, baseline, counters):
    """The dm.* policy/monitor pair; returns (policy, monitor,
    window_rows)."""
    from ..monitor.accumulator import StreamDriftMonitor
    from ..monitor.policy import DriftPolicy
    window_rows = cfg.get_int("dm.window.rows", 2048)
    policy = DriftPolicy(
        warn=_threshold_overrides(cfg, "dm.warn"),
        alert=_threshold_overrides(cfg, "dm.alert"),
        consecutive=cfg.get_int("dm.consecutive.windows", 2),
        counters=counters,
        accuracy_warn=cfg.get_int("dm.accuracy.warn", 0),
        accuracy_alert=cfg.get_int("dm.accuracy.alert", 0),
        debug_on=cfg.debug_on)
    monitor = StreamDriftMonitor(
        baseline, policy=policy, window_rows=window_rows,
        decay=cfg.get_float("dm.longterm.decay", 0.9),
        counters=counters)
    return policy, monitor, window_rows


def _make_accuracy_tracker(cfg: Config, schema, policy, window_rows: int):
    """(neg, pos) = the first two cardinality values, the reference's
    ConfusionMatrix convention; None when thresholds are off or the class
    attribute is not binarizable."""
    from ..monitor.policy import AccuracyTracker
    card = list(schema.class_attr_field.cardinality or [])
    if len(card) >= 2 and (policy.accuracy_warn > 0
                           or policy.accuracy_alert > 0):
        return AccuracyTracker(
            pos_class=card[1], neg_class=card[0], policy=policy,
            window=cfg.get_int("dm.accuracy.window", window_rows))
    return None


def _record_accuracy(tracker, cls_spec, table, labels) -> None:
    """Predicted-vs-actual outcomes for rows whose class column holds a
    known label (rows with an unknown class are skipped)."""
    if tracker is None:
        return
    actual_codes = np.asarray(table.class_codes())
    card = cls_spec.labels or []
    known = actual_codes >= 0
    if known.any():
        tracker.record(
            [lab for lab, k in zip(labels, known) if k],
            [card[c] for c, k in zip(actual_codes, known) if k])


def _window_source(cfg: Config, job: str, in_path: str, window_rows: int):
    split = _splitter(cfg.field_delim_regex)
    source = cfg.get("dm.source", "file")
    if source == "file":
        return _iter_line_windows(in_path, split, window_rows)
    if source == "resp":
        return _iter_resp_windows(cfg, split, window_rows)
    raise ValueError(f"{job}: unknown dm.source {source!r} (file | resp)")


def _make_bad_filter(cfg: Config, schema, out_path: str, counters):
    """Malformed records (short rows, unparseable numerics) default to
    badrecords.policy=skip, counted in the BadRecords group, instead of
    killing the replay; badrecords.policy=fail raises on the first."""
    from ..core.table import BadRecordPolicy, _bad_row_checker
    pol = cfg.get("badrecords.policy", "skip")
    qpath = cfg.get("badrecords.quarantine.path") or \
        os.path.join(out_path, "_quarantine")
    bad_records = None
    if pol != "fail":
        bad_records = BadRecordPolicy(
            pol, qpath if pol == "quarantine" else None, counters)
    return bad_records, _bad_row_checker(schema)


def _filter_bad(rows, bad_records, is_bad, od: str):
    if bad_records is None:
        return rows
    good = [r for r in rows if not is_bad(r)]
    if len(good) < len(rows):
        bad_records.record([od.join(r) for r in rows if is_bad(r)])
    return good


def _level_of(row, policy) -> str:
    """This window's immediate warn/alert standing for one report row."""
    from ..monitor.drift import STATS
    level = "ok"
    for stat in STATS:
        if not row.applicable(stat):
            continue
        if row.stats[stat] >= policy.alert[stat]:
            return "alert"
        if row.stats[stat] >= policy.warn[stat]:
            level = "warn"
    return level


def _drain(monitor, policy, part_fh, alerts_path: str, od: str) -> None:
    """Write the closed windows' report rows and the debounced alert
    records now; alerts.jsonl appears on the first alert."""
    from ..monitor.drift import STATS
    for report in monitor.reports:
        for row in report.rows:
            part_fh.write(od.join(
                [str(report.index), report.kind, row.scope, row.kind,
                 str(report.n_rows)]
                + [repr(round(row.stats[s], 6)) for s in STATS]
                + [_level_of(row, policy)]) + "\n")
    monitor.reports.clear()
    if policy.alerts:
        with open(alerts_path, "a") as fh:
            for rec in policy.alerts:
                fh.write(rec.to_json() + "\n")
        policy.alerts.clear()
    part_fh.flush()


def _fresh_alerts_path(out_path: str) -> str:
    # append-mode writes must not leave a previous run's alerts looking
    # like this run's (the file's existence is the signal)
    path = os.path.join(out_path, "alerts.jsonl")
    if os.path.exists(path):
        os.remove(path)
    return path


@register("org.avenir.monitor.DriftMonitor", "driftMonitor", dist="refuse")
def drift_monitor(cfg: Config, in_path: str, out_path: str) -> Counters:
    from ..core.table import encode_rows
    from ..monitor.baseline import load_baseline
    from ..serving.registry import ModelRegistry

    counters = Counters()
    registry = ModelRegistry(cfg.must_get("dm.model.registry.dir"))
    name = cfg.must_get("dm.model.name")
    version = _resolve_model_version(cfg, registry, name)
    baseline = load_baseline(registry, name, version)
    counters.set("DriftMonitor", "ModelVersion", version)
    score_predictions = cfg.get_boolean("dm.score.predictions", False)
    schema, loaded = _monitor_schema(cfg, registry, name, version, None)
    windows = _window_source(cfg, "driftMonitor", in_path,
                             cfg.get_int("dm.window.rows", 2048))
    policy, monitor, window_rows = _make_policy_monitor(cfg, baseline,
                                                        counters)

    predictor = None
    tracker = None
    if score_predictions:
        from ..serving.predictor import make_predictor
        if loaded is None:
            loaded = registry.load(name, version)
        predictor = make_predictor(loaded, schema=schema).warm()
        tracker = _make_accuracy_tracker(cfg, schema, policy, window_rows)
    cls_spec = baseline.specs[baseline.class_row]

    od = cfg.field_delim_out
    os.makedirs(out_path, exist_ok=True)
    alerts_path = _fresh_alerts_path(out_path)
    bad_records, is_bad = _make_bad_filter(cfg, schema, out_path, counters)

    with open(os.path.join(out_path, "part-r-00000"), "w") as part_fh:
        for rows in windows:
            rows = _filter_bad(rows, bad_records, is_bad, od)
            if not rows:
                continue
            table = encode_rows(rows, schema)
            class_codes = None
            if predictor is not None:
                labels = predictor.predict_rows(rows)
                # the serving hook's encoding: prediction-prior drift
                # scores the same offline and live
                class_codes = baseline.class_codes_for_labels(labels)
                _record_accuracy(tracker, cls_spec, table, labels)
            monitor.observe_table(table, class_codes=class_codes)
            _drain(monitor, policy, part_fh, alerts_path, od)
        monitor.close_window()       # score the partial tail window
        if tracker is not None:
            tracker.close()
        _drain(monitor, policy, part_fh, alerts_path, od)
    return counters


def _refuse_even_forest(loaded) -> None:
    """modelPredictor's rule, applied as the reference's job applies it: an
    even unweighted forest without a min-odds veto has no tie-break."""
    from ..serving.registry import FOREST
    if loaded.kind != FOREST or len(loaded.model) <= 1:
        return
    p = loaded.params
    if float(p.get("min_odds_ratio", 1.0)) <= 1.0 and \
            p.get("weights") is None and len(loaded.model) % 2 == 0:
        raise ValueError("need odd number of models in ensemble")


@register("org.avenir.monitor.PredictDriftScore", "predictDriftScore",
          dist="refuse")
def predict_drift_score(cfg: Config, in_path: str, out_path: str
                        ) -> Counters:
    """``predict + driftScore`` in one pass over the records.

    Fused (``dm.pipeline.fuse`` unset or true, a forest of more than one
    member): every window is one chunk of
    ``pipeline.flows.PredictDriftFlow``, the forest vote (B2) and the
    window's bin counts (B4) with the predicted classes flowing device to
    device into the class row, scored through ``close_counts``.  A
    window the flow's gate refuses (values that are not float32-exact, an
    ensemble with no stacked form) takes the unfused pair for that
    window.  Unfused (``dm.pipeline.fuse=false``, or any other model): per
    window one forest-vote batch (B2), then the window absorbed (B4) with
    the predicted classes as the class row.  Both routes go through the
    same ``StreamDriftMonitor`` scoring as ``driftMonitor`` and give the
    same bytes; ``PredictDrift/FusedWindows`` and ``UnfusedWindows``
    count them, and the fused flow writes its ``ProgramCache`` group.

    Output: ``<out>/part-r-00000`` and ``<out>/alerts.jsonl`` as
    ``driftMonitor``; predictions in ``<out>/predictions/part-m-00000``
    (the record, the output delimiter, the predicted class — ``ambiguous``
    for a min-odds veto).  Windows are re-cut after bad-record filtering,
    so their boundaries match ``driftMonitor``'s."""
    from ..core.table import encode_rows
    from ..monitor.baseline import load_baseline
    from ..serving.predictor import make_predictor
    from ..serving.registry import FOREST, ModelRegistry

    counters = Counters()
    registry = ModelRegistry(cfg.must_get("dm.model.registry.dir"))
    name = cfg.must_get("dm.model.name")
    version = _resolve_model_version(cfg, registry, name)
    baseline = load_baseline(registry, name, version)
    counters.set("DriftMonitor", "ModelVersion", version)
    loaded = registry.load(name, version)
    schema, loaded = _monitor_schema(cfg, registry, name, version, loaded)
    batches = _window_source(cfg, "predictDriftScore", in_path,
                             cfg.get_int("dm.window.rows", 2048))
    policy, monitor, window_rows = _make_policy_monitor(cfg, baseline,
                                                        counters)
    tracker = _make_accuracy_tracker(cfg, schema, policy, window_rows)
    cls_spec = baseline.specs[baseline.class_row]
    _refuse_even_forest(loaded)
    flow = None
    if cfg.get_boolean("dm.pipeline.fuse", True) \
            and loaded.kind == FOREST and len(loaded.model) > 1:
        from ..models.forest import EnsembleModel
        from ..models.tree import DecisionTreeModel
        from ..pipeline.flows import PredictDriftFlow
        p = loaded.params
        ensemble = EnsembleModel(
            [DecisionTreeModel(pl, schema) for pl in loaded.model],
            weights=p.get("weights"),
            min_odds_ratio=float(p.get("min_odds_ratio", 1.0)),
            require_odd=False)       # _refuse_even_forest applied the rule
        flow = PredictDriftFlow(ensemble, baseline, schema, window_rows)
    predictor = None

    def unfused_labels(rows):
        nonlocal predictor
        if predictor is None:
            predictor = make_predictor(loaded, schema=schema)
        return predictor.predict_rows(rows)

    bad_records, is_bad = _make_bad_filter(cfg, schema, out_path, counters)

    od = cfg.field_delim_out
    os.makedirs(out_path, exist_ok=True)
    pred_dir = os.path.join(out_path, "predictions")
    os.makedirs(pred_dir, exist_ok=True)
    alerts_path = _fresh_alerts_path(out_path)
    fused_windows = unfused_windows = 0

    def process_window(rows, part_fh, pred_fh) -> None:
        nonlocal fused_windows, unfused_windows
        table = encode_rows(rows, schema)
        res = flow.run_window(table) if flow is not None else None
        labels = res[0] if res is not None else unfused_labels(rows)
        # accuracy before the window closes, as driftMonitor records a
        # batch's outcomes ahead of observe_table
        _record_accuracy(tracker, cls_spec, table, labels)
        if res is not None:
            fused_windows += 1
            monitor.close_counts(res[1], table.n_rows)
        else:
            unfused_windows += 1
            monitor.observe_table(
                table, class_codes=baseline.class_codes_for_labels(labels))
            monitor.close_window()  # no-op when the absorb closed it
        for r, lab in zip(rows, labels):
            pred_fh.write(od.join(r) + od
                          + (lab if lab is not None else "ambiguous")
                          + "\n")
        _drain(monitor, policy, part_fh, alerts_path, od)
        pred_fh.flush()

    pending: List[List[str]] = []
    with open(os.path.join(out_path, "part-r-00000"), "w") as part_fh, \
            open(os.path.join(pred_dir, "part-m-00000"), "w") as pred_fh:
        for rows in batches:
            pending.extend(_filter_bad(rows, bad_records, is_bad, od))
            while len(pending) >= window_rows:
                process_window(pending[:window_rows], part_fh, pred_fh)
                pending = pending[window_rows:]
        if pending:
            process_window(pending, part_fh, pred_fh)
        if tracker is not None:
            tracker.close()
        _drain(monitor, policy, part_fh, alerts_path, od)
    counters.set("PredictDrift", "FusedWindows", fused_windows)
    counters.set("PredictDrift", "UnfusedWindows", unfused_windows)
    if flow is not None:
        flow.export(counters)
    return counters
