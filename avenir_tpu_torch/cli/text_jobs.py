"""Text-pack and rule-evaluation jobs: the port of
``avenir_tpu/cli/text_jobs.py``.  Namespaces: text.* (WordCounter), rue.*
(RuleEvaluator), tef.* (chombo's TemporalFilter).  Host work; each job
resolves the process's device all the same (no GPU and no
``-Dplatform=cpu`` raises).
"""

from __future__ import annotations

import numpy as np

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..runtime import resolve_device
from .jobs import _splitter, register


@register("org.avenir.text.WordCounter", "wordCounter", dist="gather")
def word_counter(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Word count.  Keys: text.field.ordinal (the whole line when not
    positive)."""
    from ..text import word_count
    resolve_device()
    counters = Counters()
    ordinal = cfg.get_int("text.field.ordinal", 0)
    split = _splitter(cfg.field_delim_regex)
    texts = []
    for line in artifacts.read_text_input(in_path):
        line = line.rstrip("\n")
        if not line:
            continue
        texts.append(split(line)[ordinal] if ordinal > 0 else line)
    pairs = word_count(texts)
    delim = cfg.field_delim_out
    artifacts.write_text_output(out_path,
                                [f"{w}{delim}{c}" for w, c in pairs])
    counters.increment("WordCount", "distinctWords", len(pairs))
    counters.increment("WordCount", "totalWords", sum(c for _, c in pairs))
    return counters


@register("org.avenir.explore.RuleEvaluator", "ruleEvaluator",
          dist="gather")
def rule_evaluator(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Rule confidence and support.  Keys: rue.rule.names (list),
    rue.rule.<name> (each ``condition > consequent``), rue.class.attr.ord,
    rue.conf.strategy (confAccuracy|confEntropy), rue.data.size,
    rue.class.values, rue.cond.delim (the conjunct separator)."""
    from ..explore import rules as RU
    resolve_device()
    counters = Counters()
    sep = cfg.get("rue.cond.delim", RU.DEFAULT_CONJUNCT_SEP)
    names = cfg.must_get_list("rue.rule.names", "missing rule list")
    rules = {name: RU.RuleExpression.create(
        cfg.must_get(f"rue.rule.{name}", "missing rule definition"), sep)
        for name in names}
    class_ord = cfg.must_get_int("rue.class.attr.ord",
                                 "missing class attribute ordinal")
    strategy = cfg.must_get("rue.conf.strategy",
                            "missing confidence strategy list")
    data_size = cfg.must_get_int("rue.data.size", "missing data size")
    class_values = cfg.must_get_list("rue.class.values",
                                     "missing class values")
    split = _splitter(cfg.field_delim_regex)
    rows = [split(line.rstrip("\n"))
            for line in artifacts.read_text_input(in_path) if line.strip()]
    n_cols = max(len(r) for r in rows) if rows else 0
    columns = [np.asarray([r[i] if i < len(r) else "" for r in rows],
                          dtype=object) for i in range(n_cols)]
    results = RU.evaluate_rules(rules, columns, class_ord, data_size,
                                strategy, class_values)
    delim = cfg.field_delim_out
    artifacts.write_text_output(
        out_path, [f"{name}{delim}{conf:.3f}{delim}{sup:.3f}"
                   for name, conf, sup in results])
    counters.increment("Rules", "evaluated", len(results))
    return counters


@register("org.chombo.mr.TemporalFilter", "temporalFilter", dist="map")
def temporal_filter(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Time-range record filter (the chombo job the reference's fit flow
    runs before Apriori).  Keys: tef.time.stamp.field.ordinal,
    tef.time.range=<start>:<end> (epoch, inclusive), tef.time.stamp.in.mili,
    tef.time.zone.shift.hours, tef.seasonal.cycle.type (anyTimeRange
    only)."""
    resolve_device()
    counters = Counters()
    cycle = cfg.get("tef.seasonal.cycle.type", "anyTimeRange")
    if cycle != "anyTimeRange":
        raise ValueError(f"unsupported seasonal cycle type {cycle!r}; "
                         f"only anyTimeRange")
    ts_ord = cfg.must_get_int("tef.time.stamp.field.ordinal",
                              "missing timestamp field ordinal")
    lo, _, hi = cfg.must_get("tef.time.range",
                             "missing time range").partition(":")
    lo, hi = float(lo), float(hi)
    in_mili = cfg.get_boolean("tef.time.stamp.in.mili", False)
    shift_s = cfg.get_int("tef.time.zone.shift.hours", 0) * 3600
    split = _splitter(cfg.field_delim_regex)
    kept = []
    n_in = 0
    for line in artifacts.read_text_input(in_path):
        line = line.rstrip("\n")
        if not line.strip():
            continue
        n_in += 1
        ts = float(split(line)[ts_ord])
        if in_mili:
            ts /= 1000.0
        ts += shift_s
        if lo <= ts <= hi:
            kept.append(line)
    artifacts.write_text_output(out_path, kept, role="m")
    counters.set("TemporalFilter", "inputRecords", n_in)
    counters.set("TemporalFilter", "keptRecords", len(kept))
    return counters
