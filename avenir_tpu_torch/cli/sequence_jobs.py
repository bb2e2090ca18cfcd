"""Sequence-pack jobs (org.avenir.markov.*, org.avenir.sequence.*, the Spark
markov and sequence jobs): the port of ``avenir_tpu/cli/sequence_jobs.py``.

Input convention (the reference mappers'): each line is ``id fields...
[classLabel,] state,state,state,...`` with ``skip.field.count`` leading
fields ignored.  Every job runs on the process's device (``cuda`` unless
``-Dplatform=cpu``) and raises without a GPU when asked for one; the
host-only jobs resolve it too.  The jobs phase 68 of ``chip_smoke.py``
times take an optional ``profile`` (``utils.tracing.LayerProfile``) that
collects the wall of each layer: parse, encode, h2d, device, readback,
write.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..runtime import resolve_device
from ..utils.tracing import LayerProfile, fetch, layer, note_h2d
from .jobs import _splitter, register


def _read_split(in_path: str, split_line, profile=None):
    with layer(profile, "parse"):
        return [split_line(line) for line in artifacts.read_text_input(
            in_path)]


def _parse_sequences(rows, skip: int, class_ord: int = -1):
    """(sequences, labels, ids).  With a class label ordinal that field
    leaves the sequence and skip grows by one, as in the reference
    mapper."""
    seqs, labels, ids = [], [], []
    eff_skip = skip + (1 if class_ord >= 0 else 0)
    for it in rows:
        ids.append(it[0] if it else "")
        labels.append(it[class_ord] if class_ord >= 0 else None)
        seqs.append(it[eff_skip:])
    return seqs, labels, ids


@register("org.avenir.markov.MarkovStateTransitionModel",
          "markovStateTransitionModel", dist="gather")
def markov_state_transition_model(cfg: Config, in_path: str, out_path: str,
                                  profile: Optional[LayerProfile] = None
                                  ) -> Counters:
    """Markov transition-matrix trainer (mst.* keys: skip.field.count,
    class.label.field.ord, model.states, trans.prob.scale,
    output.states)."""
    from ..sequence import markov as MK
    dev = resolve_device()
    counters = Counters()
    rows = _read_split(in_path, _splitter(cfg.field_delim_regex), profile)
    skip = cfg.get_int("mst.skip.field.count", 0)
    class_ord = cfg.get_int("mst.class.label.field.ord", -1)
    states = cfg.must_get_list("mst.model.states")
    scale = cfg.get_int("mst.trans.prob.scale", 1000)
    seqs, labels, _ = _parse_sequences(rows, skip, class_ord)
    model = MK.build_model(seqs, states,
                           labels=labels if class_ord >= 0 else None,
                           scale=scale, device=dev, profile=profile)
    out_lines = model.to_lines(cfg.field_delim_out)
    if not cfg.get_boolean("mst.output.states", True):
        out_lines = out_lines[1:]
    with layer(profile, "write"):
        artifacts.write_text_output(out_path, out_lines)
    counters.increment("Markov", "Sequences", len(seqs))
    return counters


@register("org.avenir.markov.MarkovModelClassifier", "markovModelClassifier",
          dist="map")
def markov_model_classifier(cfg: Config, in_path: str, out_path: str,
                            profile: Optional[LayerProfile] = None
                            ) -> Counters:
    """Log-odds sequence classifier (mmc.* keys; output
    id[,actual],predClass,logOdds)."""
    from ..sequence import markov as MK
    dev = resolve_device()
    counters = Counters()
    od = cfg.field_delim_out
    skip = cfg.get_int("mmc.skip.field.count", 1)
    id_ord = cfg.get_int("mmc.id.field.ord", 0)
    validation = cfg.get_boolean("mmc.validation.mode", False)
    class_ord = cfg.get_int("mmc.class.label.field.ord", -1)
    if validation and class_ord < 0:
        raise ValueError("In validation mode actual class labels must be "
                         "provided")
    class_labels = cfg.must_get_list("mmc.class.labels")
    threshold = cfg.get_float("mmc.log.odds.threshold", 0.0)
    model_lines = artifacts.read_text_input(cfg.must_get("mmc.mm.model.path"))
    # the log-odds classifier always needs per-class matrices
    model = MK.MarkovModel.from_lines(model_lines, class_based=True)
    rows = _read_split(in_path, _splitter(cfg.field_delim_regex), profile)
    eff_skip = skip + (1 if validation else 0)
    ids = [it[id_ord] for it in rows]
    actuals = [it[class_ord] for it in rows] if validation else None
    seqs = [it[eff_skip:] for it in rows]
    pred, log_odds = MK.classify(model, seqs, class_labels, threshold,
                                 device=dev, profile=profile)
    with layer(profile, "write"):
        out = []
        for i, lo in enumerate(log_odds.tolist()):
            parts = [ids[i]]
            if validation:
                parts.append(actuals[i])
            parts.extend([pred[i], str(lo)])
            out.append(od.join(parts))
        if validation:
            correct = sum(p == a for p, a in zip(pred, actuals))
            if correct:
                counters.increment("Validation", "Correct", correct)
            if len(pred) - correct:
                counters.increment("Validation", "Incorrect",
                                   len(pred) - correct)
        artifacts.write_text_output(out_path, out, role="m")
    return counters


@register("org.avenir.markov.HiddenMarkovModelBuilder",
          "hiddenMarkovModelBuilder", dist="gather")
def hidden_markov_model_builder(cfg: Config, in_path: str, out_path: str,
                                profile: Optional[LayerProfile] = None
                                ) -> Counters:
    """Supervised HMM builder (hmmb.* keys).  Input lines alternate
    observation and state tokens after the skipped fields; the counts are
    host work, as in the JAX package."""
    from ..sequence import markov as MK
    resolve_device()
    counters = Counters()
    rows = _read_split(in_path, _splitter(cfg.field_delim_regex), profile)
    skip = cfg.get_int("hmmb.skip.field.count", 0)
    states = cfg.must_get_list("hmmb.model.states")
    observations = cfg.must_get_list("hmmb.model.observations")
    scale = cfg.get_int("hmmb.trans.prob.scale", 1000)
    with layer(profile, "encode"):
        tagged = []
        for it in rows:
            it = it[skip:]
            tagged.append([(it[i], it[i + 1])
                           for i in range(0, len(it) - 1, 2)])
        hmm = MK.build_hmm(tagged, states, observations, scale=scale)
    with layer(profile, "write"):
        artifacts.write_text_output(out_path,
                                    hmm.to_lines(cfg.field_delim_out))
    counters.increment("HMM", "Sequences", len(tagged))
    return counters


@register("org.avenir.markov.ViterbiStatePredictor", "viterbiStatePredictor",
          dist="map")
def viterbi_state_predictor(cfg: Config, in_path: str, out_path: str,
                            profile: Optional[LayerProfile] = None
                            ) -> Counters:
    """Viterbi decode of observation sequences (vsp.* keys; output
    id,state,state,...)."""
    from ..sequence import markov as MK
    dev = resolve_device()
    counters = Counters()
    od = cfg.field_delim_out
    skip = cfg.get_int("vsp.skip.field.count", 1)
    hmm = MK.HiddenMarkovModel.from_lines(
        artifacts.read_text_input(cfg.must_get("vsp.hmm.model.path")))
    rows = _read_split(in_path, _splitter(cfg.field_delim_regex), profile)
    ids = [it[0] for it in rows]
    decoded = MK.viterbi_decode(hmm, [it[skip:] for it in rows], device=dev,
                                profile=profile)
    with layer(profile, "write"):
        artifacts.write_text_output(
            out_path, [od.join([ids[i]] + decoded[i])
                       for i in range(len(ids))], role="m")
    return counters


@register("org.avenir.markov.ProbabilisticSuffixTreeGenerator",
          "probabilisticSuffixTreeGenerator", dist="gather")
def probabilistic_suffix_tree_generator(cfg: Config, in_path: str,
                                        out_path: str) -> Counters:
    """PST counts up to pstg.max.depth; output 'context,symbol,count'
    lines."""
    from ..sequence.pst import ProbabilisticSuffixTree
    resolve_device()
    counters = Counters()
    split_line = _splitter(cfg.field_delim_regex)
    skip = cfg.get_int("pstg.skip.field.count", 0)
    tree = ProbabilisticSuffixTree(max_depth=cfg.get_int("pstg.max.depth", 3))
    tree.add_sequences([split_line(l)[skip:]
                        for l in artifacts.read_text_input(in_path)])
    artifacts.write_text_output(out_path, tree.to_lines(cfg.field_delim_out))
    counters.increment("PST", "Contexts", len(tree.counts))
    return counters


@register("org.avenir.sequence.CandidateGenerationWithSelfJoin",
          "candidateGenerationWithSelfJoin", dist="gather")
def candidate_generation_with_self_join(cfg: Config, in_path: str,
                                        out_path: str) -> Counters:
    """GSP candidate generation from (k-1)-frequent sequence lines
    'item,item,...[,support]' (cgs.support.in.input)."""
    from ..sequence.pst import gsp_candidates
    resolve_device()
    counters = Counters()
    split_line = _splitter(cfg.field_delim_regex)
    has_support = cfg.get_boolean("cgs.support.in.input", False)
    freq = []
    for l in artifacts.read_text_input(in_path):
        it = split_line(l)
        freq.append(it[:-1] if has_support else it)
    cands = gsp_candidates(freq)
    od = cfg.field_delim_out
    artifacts.write_text_output(out_path, (od.join(c) for c in cands))
    counters.increment("GSP", "Candidates", len(cands))
    return counters


@register("org.avenir.sequence.SequencePositionalCluster",
          "sequencePositionalCluster", dist="gather")
def sequence_positional_cluster(cfg: Config, in_path: str, out_path: str
                                ) -> Counters:
    """Event-locality scoring in sliding time windows (the analyzer is the
    JAX package's re-specified hoidla equivalent, ``sequence.positional``).
    Keys (the reference's, typos kept): window.time.span,
    processing.time.step, quant.field.ordinal, seq.num..field.ordinal,
    wejghter.strategy, weighted.strategies (name=weight list),
    preferred.strategies, any.cond, min.occurence, max.interval.average,
    max.interval.max, min.range.length, min.event.time.interval,
    score.threshold, cond.expression."""
    from ..sequence.positional import LocalityConfig, positional_cluster
    resolve_device()
    counters = Counters()
    quant_ord = cfg.must_get_int("quant.field.ordinal",
                                 "missing quantity field ordinal")
    seq_ord = cfg.get_int("seq.num..field.ordinal",
                          cfg.get_int("seq.num.field.ordinal"))
    if seq_ord is None:
        raise ValueError("missing sequence field ordinal")
    weighted = cfg.get_boolean("wejghter.strategy",
                               cfg.get_boolean("weighted.strategy", False))
    wmap = {}
    for item in cfg.get_list("weighted.strategies", []):
        if "=" in item:
            name, w = item.split("=", 1)
            wmap[name.strip()] = float(w)
    config = LocalityConfig(
        window_time_span=cfg.must_get_int("window.time.span",
                                          "wondow time span must be specified"),
        time_step=cfg.must_get_int("processing.time.step",
                                   "missing window processing time step"),
        min_event_time_interval=cfg.get_int("min.event.time.interval", 100),
        weighted=weighted,
        weighted_strategies=wmap,
        preferred_strategies=cfg.get_list("preferred.strategies", ["count"]),
        any_cond=cfg.get_boolean("any.cond", True),
        min_occurence=cfg.get_int("min.occurence", 2),
        max_interval_average=cfg.get_float("max.interval.average", 0.0),
        max_interval_max=cfg.get_float("max.interval.max", 0.0),
        min_range_length=cfg.get_float("min.range.length", 0.0))
    threshold = cfg.must_get_float("score.threshold",
                                   "missing score threshold")
    rule = None
    cond_expr = cfg.get("cond.expression")
    if cond_expr:
        from ..explore.rules import RuleExpression
        # absolute field ordinals over the raw row, as ruleEvaluator's
        rule = RuleExpression.create(cond_expr + " > _",
                                     cfg.get("cond.delim", " and "))
    split_line = _splitter(cfg.field_delim_regex)
    records, flags, quants = [], [], {}
    for line in artifacts.read_text_input(in_path):
        line = line.strip()
        if not line:
            continue
        items = split_line(line)
        ts = int(items[seq_ord])
        records.append((ts, float(items[quant_ord])))
        flags.append(rule.evaluate(items) if rule is not None else True)
        quants[ts] = items[quant_ord]
    results = positional_cluster(records, config, threshold,
                                 condition_flags=flags)
    od = cfg.field_delim_out
    artifacts.write_text_output(
        out_path,
        [f"{ts}{od}{quants[ts]}{od}{score}" for ts, _, score in results])
    counters.increment("Locality", "scoredAboveThreshold", len(results))
    return counters


@register("org.avenir.spark.markov.StateTransitionRate",
          "stateTransitionRate", dist="gather")
def state_transition_rate(cfg: Config, in_path: str, out_path: str
                          ) -> Counters:
    """Per-key CTMC generator (rate) matrices from timestamped state events.
    Keys: key.field.ordinals, time.field.ordinal, state.field.ordinal,
    state.values, rate.time.unit (hour|day|week), input.time.unit
    (ms|sec|formatted + input.time.format), trans.rate.output.precision.
    Output lines (key fields, then the row-major rate matrix) feed
    contTimeStateTransitionStats's state.trans.file.path."""
    import datetime as _dt
    from ..sequence.pst import ctmc_rate_matrices
    from ..utils.timefmt import java_time_format
    resolve_device()
    counters = Counters()
    split_line = _splitter(cfg.get("field.delim.in", cfg.field_delim_regex))
    key_ords = [int(o) for o in cfg.must_get_list("key.field.ordinals")]
    time_ord = cfg.must_get_int("time.field.ordinal")
    state_ord = cfg.must_get_int("state.field.ordinal")
    states = cfg.must_get_list("state.values")
    state_code = {s: i for i, s in enumerate(states)}
    rate_unit = cfg.get("rate.time.unit", "week")
    in_unit = cfg.get("input.time.unit", "ms")
    fmt = (java_time_format(cfg.must_get("input.time.format"))
           if in_unit == "formatted" else None)
    key_of: Dict[tuple, int] = {}
    key_order: List[tuple] = []
    kidx, times, sidx = [], [], []
    for line in artifacts.read_text_input(in_path):
        line = line.strip()
        if not line:
            continue
        items = split_line(line)
        key = tuple(items[o] for o in key_ords)
        if key not in key_of:
            key_of[key] = len(key_order)
            key_order.append(key)
        ts = items[time_ord]
        if in_unit == "ms":
            epoch_ms = float(ts)
        elif in_unit == "sec":
            epoch_ms = float(ts) * 1000.0
        elif in_unit == "formatted":
            # the host's local timezone, as Java's SimpleDateFormat default
            epoch_ms = _dt.datetime.strptime(ts, fmt).timestamp() * 1000.0
        else:
            raise ValueError(f"invalid input time unit {in_unit!r}")
        kidx.append(key_of[key])
        times.append(epoch_ms)
        sidx.append(state_code[items[state_ord]])
    rates = ctmc_rate_matrices(np.asarray(kidx), np.asarray(times),
                               np.asarray(sidx), len(key_order), len(states),
                               rate_unit)
    prec = cfg.get_int("trans.rate.output.precision", 6)
    od = cfg.field_delim_out
    artifacts.write_text_output(
        out_path, [od.join(list(key_order[i]) +
                           [f"{v:.{prec}f}" for v in rates[i].ravel()])
                   for i in range(len(key_order))])
    counters.set("TransitionRate", "keys", len(key_order))
    counters.set("TransitionRate", "events", len(kidx))
    return counters


@register("org.avenir.spark.markov.ContTimeStateTransitionStats",
          "contTimeStateTransitionStats", dist="gather")
def cont_time_state_transition_stats(cfg: Config, in_path: str,
                                     out_path: str) -> Counters:
    """CTMC uniformization statistics.  Rate matrices per key come from
    state.trans.file.path (key fields, then the row-major rate matrix);
    input lines are key fields + initial state [+ end state]; output is key
    + the statistic.  Keys: key.field.len, state.values, time.horizon,
    state.trans.stat (stateDwellTime|StateTransitionCount),
    target.states.  One power series a rate matrix, on the device."""
    from ..sequence.pst import (_uniformization_powers,
                                ctmc_state_dwell_time,
                                ctmc_transition_count)
    dev = resolve_device()
    counters = Counters()
    key_len = cfg.must_get_int("key.field.len", "missing key field length")
    states = cfg.must_get_list("state.values", "missing state values")
    n = len(states)
    horizon = cfg.must_get_float("time.horizon", "missing time horizon")
    stat_kind = cfg.must_get("state.trans.stat", "missing stat kind")
    targets = [states.index(s) for s in cfg.get_list("target.states", [])]
    need = 2 if stat_kind == "StateTransitionCount" else 1
    if len(targets) < need:
        raise ValueError(f"target.states needs {need} state(s) for "
                         f"{stat_kind}, got {len(targets)}")
    split_line = _splitter(cfg.field_delim_regex)
    rates = {}
    for line in artifacts.read_text_input(
            cfg.must_get("state.trans.file.path",
                         "missing state transition rate file")):
        line = line.strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            line = line[1:-1]
        items = [t.strip() for t in split_line(line)]
        rates[tuple(items[:key_len])] = np.asarray(
            [float(v) for v in items[key_len:key_len + n * n]]).reshape(n, n)
    power_cache = {}
    out_lines = []
    od = cfg.field_delim_out
    for line in artifacts.read_text_input(in_path):
        line = line.strip()
        if not line:
            continue
        items = split_line(line)
        key = tuple(items[:key_len])
        init = states.index(items[key_len])
        end = (states.index(items[key_len + 1])
               if len(items) > key_len + 1 else None)
        Q = rates[key]
        if key not in power_cache:
            power_cache[key] = _uniformization_powers(Q, horizon, dev)
        pre = power_cache[key]
        if stat_kind == "stateDwellTime":
            stat = ctmc_state_dwell_time(Q, horizon, init, targets[0], end,
                                         precomputed=pre)
        elif stat_kind == "StateTransitionCount":
            stat = ctmc_transition_count(Q, horizon, init, targets[0],
                                         targets[1], end, precomputed=pre)
        else:
            raise ValueError(f"unknown state.trans.stat {stat_kind!r}")
        out_lines.append(od.join(list(key) + [f"{stat:.6f}"]))
        counters.increment("CTMC", "records")
    artifacts.write_text_output(out_path, out_lines)
    return counters


MS_HOUR = 3600 * 1000
MS_DAY = 24 * MS_HOUR
MS_WEEK = 7 * MS_DAY
# events a count launch
EVENT_CHUNK = 1 << 22


@register("org.avenir.spark.sequence.EventTimeDistribution",
          "eventTimeDistribution", dist="gather")
def event_time_distribution(cfg: Config, in_path: str, out_path: str,
                            profile: Optional[LayerProfile] = None
                            ) -> Counters:
    """Per-key event-time histogram: key = the id.field.ordinals tuple,
    value = the histogram of the record's time cycle, hourOfDay
    ((epoch ms % day) / hour, optionally / hour.granularity) or dayOfWeek
    ((epoch ms % week) / day: the JAX package's fix of the reference's
    collapsed division).  The reduceByKey is one int64 accumulator of
    (key, bin) counts on the device, a ``keyed_count`` of
    ``key * n_bins + bin`` added in per chunk of events and read back
    once.  Output: keyFields..., bin:count pairs (bins ascending)."""
    from ..parallel.collectives import keyed_count
    dev = resolve_device()
    counters = Counters()
    od = cfg.field_delim_out
    key_ords = [int(x) for x in cfg.must_get_list("id.field.ordinals")]
    time_ord = int(cfg.must_get("time.field.ordinal"))
    resolution = cfg.get("time.resolution", "hourOfDay")
    granularity = cfg.get_int("hour.granularity", 0)
    if resolution not in ("hourOfDay", "dayOfWeek"):
        raise ValueError(f"unknown time.resolution {resolution!r}")
    rows = _read_split(in_path, _splitter(cfg.field_delim_regex), profile)
    with layer(profile, "encode"):
        keys: List[str] = []
        key_idx: Dict[str, int] = {}
        codes = np.empty((len(rows),), dtype=np.int64)
        for i, items in enumerate(rows):
            key = od.join(items[o] for o in key_ords)
            c = key_idx.get(key)
            if c is None:
                c = key_idx[key] = len(keys)
                keys.append(key)
            codes[i] = c
        ts = np.fromiter((int(items[time_ord]) for items in rows),
                         dtype=np.int64, count=len(rows))
        if resolution == "hourOfDay":
            cycles = (ts % MS_DAY) // MS_HOUR
            if granularity > 0:
                cycles //= granularity
        else:
            cycles = (ts % MS_WEEK) // MS_DAY
    if not keys:
        artifacts.write_text_output(out_path, [])
        return counters
    n_keys, n_bins = len(keys), int(cycles.max()) + 1
    acc = torch.zeros((n_keys * n_bins,), dtype=torch.int64, device=dev)
    for s in range(0, len(codes), EVENT_CHUNK):
        with layer(profile, "h2d"):
            flat = codes[s:s + EVENT_CHUNK] * n_bins + \
                cycles[s:s + EVENT_CHUNK]
            t = torch.from_numpy(flat)
            if dev.type != "cpu":
                note_h2d(flat.nbytes)
                t = t.to(dev)
        with layer(profile, "device"):
            acc += keyed_count(t, n_keys * n_bins, dtype=torch.int64)
    with layer(profile, "readback"):
        hist = fetch(acc).reshape(n_keys, n_bins)
    with layer(profile, "write"):
        out_lines = []
        for ki, key in enumerate(keys):
            row = hist[ki]
            bins = [f"{b}:{int(row[b])}" for b in np.flatnonzero(row > 0)]
            out_lines.append(od.join([key] + bins))
        artifacts.write_text_output(out_path, out_lines)
    counters.increment("EventTime", "Keys", len(keys))
    counters.increment("EventTime", "Events", len(codes))
    return counters


@register("org.avenir.spark.sequence.SequenceGenerator", "sequenceGenerator",
          dist="gather")
def sequence_generator(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Event stream -> per-entity ordered sequences: records grouped by
    id.field.ordinals, ordered by seq.field (numeric when it parses, else
    lexicographic), emitting the val.field.ordinals fields of each event
    in order.  Output: keyFields..., then the ordered events' fields."""
    resolve_device()
    counters = Counters()
    od = cfg.field_delim_out
    key_ords = [int(x) for x in cfg.must_get_list("id.field.ordinals")]
    val_ords = [int(x) for x in cfg.must_get_list("val.field.ordinals")]
    seq_ord = int(cfg.must_get("seq.field"))
    split_line = _splitter(cfg.field_delim_regex)
    groups: Dict[str, List] = {}
    for line in artifacts.read_text_input(in_path):
        items = split_line(line)
        key = od.join(items[o] for o in key_ords)
        raw = items[seq_ord]
        try:
            sk = (0, float(raw), "")
        except ValueError:
            sk = (1, 0.0, raw)
        groups.setdefault(key, []).append((sk, [items[o] for o in val_ords]))
    out_lines = []
    for key in sorted(groups):
        events = sorted(groups[key], key=lambda e: e[0])
        out_lines.append(od.join([key] + [f for _, vals in events
                                          for f in vals]))
    artifacts.write_text_output(out_path, out_lines)
    counters.increment("SequenceGenerator", "Entities", len(groups))
    return counters
