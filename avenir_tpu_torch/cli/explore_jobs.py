"""Explore-pack jobs (org.avenir.explore.*): the port of
``avenir_tpu/cli/explore_jobs.py``.

Each wraps the avenir_tpu_torch.explore implementations with the
reference's config-key namespaces (crc.*, nuc.*, hrc.*, mut.*, coe.*,
cbos.*, usb.*, ffr.*, abe.*, abu.* — see the setup() methods of the
matching reference classes under explore/).  Every job runs on the
process's device (``cuda`` unless ``-Dplatform=cpu``) and raises without
a GPU when asked for one; the host-only jobs resolve it too.
``mutualInformation``, ``numericalCorrelation`` and
``classBasedOverSampler`` take an optional ``profile``
(``utils.tracing.LayerProfile``) that collects the wall of each layer.
In a joined run the two ``sharded`` jobs sum their counts or moments
across the processes before the host math."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..core.table import load_csv
from ..runtime import resolve_device
from ..utils.tracing import LayerProfile, layer
from .jobs import _schema_path, _splitter, register


def _reducer():
    """The element-wise cross-process sum in a joined run, else None."""
    from ..parallel.distributed import all_reduce_host_array, is_multiprocess
    return all_reduce_host_array if is_multiprocess() else None


@register("org.avenir.explore.MutualInformation", "mutualInformation",
          dist="sharded")
def mutual_information(cfg: Config, in_path: str, out_path: str,
                       profile: Optional[LayerProfile] = None) -> Counters:
    """MI distributions + selection scores (explore/MutualInformation.java).
    Keys: mut.feature.schema.file.path, mut.mutual.info.score.algorithms,
    mut.mutual.info.redundancy.factor, mut.output.mutual.info."""
    from ..explore import mutual_info as MI
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "mut.feature.schema.file.path")
    with layer(profile, "parse"):
        table = load_csv(in_path, schema, cfg.field_delim_regex)
    stats = MI.compute_stats(table, dev, reduce=_reducer(), profile=profile)
    od = cfg.field_delim_out
    lines: List[str] = []
    if cfg.get_boolean("mut.output.mutual.info", True):
        lines.append(f"classEntropy{od}{stats.class_entropy():.6f}")
        for i, o in enumerate(stats.feature_ordinals):
            lines.append(f"entropy{od}{o}{od}{stats.feature_entropy(i):.6f}")
            lines.append(f"mutualInfo{od}{o}{od}{stats.feature_class_mi(i):.6f}")
        for i in range(len(stats.feature_ordinals)):
            for j in range(i + 1, len(stats.feature_ordinals)):
                oi, oj = stats.feature_ordinals[i], stats.feature_ordinals[j]
                lines.append(f"pairMutualInfo{od}{oi}{od}{oj}{od}"
                             f"{stats.pair_mi(i, j):.6f}")
                lines.append(f"pairClassMutualInfo{od}{oi}{od}{oj}{od}"
                             f"{stats.pair_class_mi(i, j):.6f}")
    algs = cfg.get_list("mut.mutual.info.score.algorithms",
                        ["mutual.info.maximization"])
    rf = cfg.get_float("mut.mutual.info.redundancy.factor", 1.0)
    for alg in algs:
        fn = MI.SCORE_ALGORITHMS.get(alg)
        if fn is None:
            raise ValueError(f"unknown MI score algorithm {alg!r}; known: "
                             f"{sorted(MI.SCORE_ALGORITHMS)}")
        for o, score in fn(stats, rf):
            lines.append(f"score{od}{alg}{od}{o}{od}{score:.6f}")
    with layer(profile, "write"):
        artifacts.write_text_output(out_path, lines)
    return counters


@register("org.avenir.explore.CramerCorrelation", "cramerCorrelation",
          dist="gather")
def cramer_correlation(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Cramér index between source and dest categorical attrs
    (explore/CramerCorrelation.java; crc.* keys).  Output scaled ints."""
    from ..explore.correlations import categorical_pair_matrix
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "crc.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    src = cfg.must_get_list("crc.source.attributes")
    dst = cfg.must_get_list("crc.dest.attributes")
    scale = cfg.get_int("crc.correlation.scale", 1000)
    od = cfg.field_delim_out
    lines = []
    for a in map(int, src):
        for b in map(int, dst):
            v = categorical_pair_matrix(table, a, b, dev).cramer_index()
            lines.append(f"{a}{od}{b}{od}{int(v * scale)}")
    artifacts.write_text_output(out_path, lines)
    return counters


@register("org.avenir.explore.NumericalCorrelation", "numericalCorrelation",
          dist="sharded")
def numerical_correlation(cfg: Config, in_path: str, out_path: str,
                          profile: Optional[LayerProfile] = None) -> Counters:
    """Pearson correlation for attr pairs (explore/NumericalCorrelation.java;
    nuc.attr.pairs = 'a:b,c:d' style pair list, or all feature pairs)."""
    from ..explore.correlations import numerical_correlations
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "nuc.schema.file.path")
    with layer(profile, "parse"):
        table = load_csv(in_path, schema, cfg.field_delim_regex)
    pairs_cfg = cfg.get("nuc.attr.pairs")
    od = cfg.field_delim_out
    if pairs_cfg:
        pairs = [tuple(map(int, p.split(":"))) for p in pairs_cfg.split(",")]
        ordinals = sorted({o for p in pairs for o in p})
    else:
        ordinals = [f.ordinal for f in schema.feature_fields if f.is_numeric]
        pairs = None
    corr = numerical_correlations(table, ordinals, dev, reduce=_reducer(),
                                  profile=profile)
    lines = []
    for a, b, v in corr:
        if pairs is None or (a, b) in pairs or (b, a) in pairs:
            lines.append(f"{a}{od}{b}{od}{v:.6f}")
    with layer(profile, "write"):
        artifacts.write_text_output(out_path, lines)
    return counters


@register("org.avenir.explore.HeterogeneityReductionCorrelation",
          "heterogeneityReductionCorrelation",
          dist="gather")
def heterogeneity_correlation(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Concentration/uncertainty coefficient per categorical pair
    (hrc.heterogeneity.algorithm = gini | entropy)."""
    from ..explore.correlations import heterogeneity_correlations
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "hrc.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    algo = cfg.get("hrc.heterogeneity.algorithm", "gini")
    ordinals = cfg.get_int_list("hrc.attributes") or \
        [f.ordinal for f in schema.feature_fields if f.is_categorical]
    od = cfg.field_delim_out
    lines = [f"{a}{od}{b}{od}{v:.6f}"
             for a, b, v in heterogeneity_correlations(table, ordinals, algo,
                                                       dev)]
    artifacts.write_text_output(out_path, lines)
    return counters


@register("org.avenir.explore.CategoricalClassAffinity",
          "categoricalClassAffinity",
          dist="gather")
def categorical_class_affinity(cfg: Config, in_path: str, out_path: str) -> Counters:
    """value -> class affinity scores (explore/CategoricalClassAffinity.java)."""
    from ..explore.correlations import class_affinity
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "cca.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    ordinals = cfg.get_int_list("cca.attributes") or \
        [f.ordinal for f in schema.feature_fields if f.is_categorical]
    aff = class_affinity(table, ordinals, dev)
    cls_vals = schema.class_attr_field.cardinality or []
    od = cfg.field_delim_out
    lines = []
    for o in ordinals:
        f = schema.find_field_by_ordinal(o)
        for vi, value in enumerate(f.cardinality or []):
            parts = [str(o), value]
            for ci, cv in enumerate(cls_vals):
                parts.append(cv)
                parts.append(f"{aff[o][vi, ci]:.6f}")
            lines.append(od.join(parts))
    artifacts.write_text_output(out_path, lines)
    return counters


@register("org.avenir.explore.CategoricalContinuousEncoding",
          "categoricalContinuousEncoding",
          dist="gather")
def categorical_continuous_encoding_job(cfg: Config, in_path: str,
                                        out_path: str) -> Counters:
    """Supervised encoding (coe.* keys; output 'ordinal,value,encoded')."""
    from ..explore.encoders import categorical_continuous_encoding
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "coe.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    enc = categorical_continuous_encoding(
        table,
        attr_ordinals=[int(o) for o in
                       cfg.must_get_list("coe.cat.attribute.ordinals")],
        class_attr_ordinal=cfg.must_get_int("coe.class.attr.ordinal"),
        pos_class_value=cfg.must_get("coe.pos.class.attr.value"),
        strategy=cfg.must_get("coe.encoding.strategy"),
        scale=cfg.must_get_int("coe.output.scale"), device=dev)
    od = cfg.field_delim_out
    artifacts.write_text_output(
        out_path, (f"{o}{od}{v}{od}{e}" for o, v, e in enc))
    return counters


@register("org.avenir.explore.ClassBasedOverSampler", "classBasedOverSampler",
          dist="gather")
def class_based_over_sampler(cfg: Config, in_path: str, out_path: str,
                             profile: Optional[LayerProfile] = None
                             ) -> Counters:
    """SMOTE oversampling of a minority class (cbos.* keys)."""
    from ..explore.samplers import smote_oversample
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "cbos.feature.schema.file.path")
    with layer(profile, "parse"):
        table = load_csv(in_path, schema, cfg.field_delim_regex,
                         keep_raw=True)
    syn = smote_oversample(
        table, cfg.must_get("cbos.minority.class.value"),
        k=cfg.get_int("cbos.neighbor.count", 5),
        multiplier=cfg.get_int("cbos.over.sampling.multiplier", 1),
        seed=cfg.get_int("cbos.random.seed", 0), device=dev,
        profile=profile)
    od = cfg.field_delim_out
    with layer(profile, "write"):
        lines = [od.join(r) for r in table.raw_rows] + \
            [od.join(r) for r in syn]
        artifacts.write_text_output(out_path, lines)
    counters.increment("Sampling", "Synthetic records", len(syn))
    return counters


@register("org.avenir.explore.UnderSamplingBalancer", "underSamplingBalancer",
          dist="gather")
def under_sampling_balancer(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Majority-class undersampling (usb.* keys)."""
    from ..explore.samplers import under_sample
    resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "usb.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex, keep_raw=True)
    keep = under_sample(table, cfg.must_get("usb.majority.class.value"),
                        rate=cfg.must_get_float("usb.sampling.rate"),
                        seed=cfg.get_int("usb.random.seed", 0))
    od = cfg.field_delim_out
    lines = [od.join(r) for r, k in zip(table.raw_rows, keep) if k]
    artifacts.write_text_output(out_path, lines)
    counters.increment("Sampling", "Kept", len(lines))
    counters.increment("Sampling", "Dropped", table.n_rows - len(lines))
    return counters


@register("org.avenir.explore.ReliefFeatureRelevance", "reliefFeatureRelevance",
          dist="gather")
def relief_feature_relevance(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Relief relevance scores (ffr.* keys; output 'ordinal,score')."""
    from ..explore.samplers import relief_relevance
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "ffr.attr.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    ordinals = cfg.must_get_list("ffr.attr.ordinals")
    scores = relief_relevance(table, [int(o) for o in ordinals],
                              sample_count=cfg.get_int("ffr.sample.count"),
                              seed=cfg.get_int("ffr.random.seed", 0),
                              device=dev)
    od = cfg.field_delim_out
    artifacts.write_text_output(
        out_path, (f"{o}{od}{scores[int(o)]:.3f}" for o in ordinals))
    return counters


@register("org.avenir.explore.AdaBoostError", "adaBoostError",
          dist="gather")
def adaboost_error_job(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Weighted boosting error (abe.* keys: actual/pred/boost ordinals)."""
    from ..explore.encoders import adaboost_error
    resolve_device()
    counters = Counters()
    delim = cfg.field_delim_regex
    lines_in = artifacts.read_text_input(in_path)
    a_ord = cfg.must_get_int("abe.actual.class.attr.ordinal")
    p_ord = cfg.must_get_int("abe.pred.class.attr.ordinal")
    b_ord = cfg.must_get_int("abe.boost.attr.ordinal")
    split_line = _splitter(delim)
    actual, pred, w = [], [], []
    for l in lines_in:
        it = split_line(l)
        actual.append(it[a_ord]); pred.append(it[p_ord])
        w.append(float(it[b_ord]))
    err = adaboost_error(actual, pred, np.asarray(w),
                         cfg.get_boolean("abe.weight.normalized", True))
    prec = cfg.get_int("abe.output.precision", 6)
    artifacts.write_text_output(out_path, [f"error={err:.{prec}f}"])
    return counters


@register("org.avenir.explore.AdaBoostUpdate", "adaBoostUpdate",
          dist="gather")
def adaboost_update_job(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Boosting weight update pass (abu.* keys) emitting records with the
    boost column rewritten (AdaBoostUpdate.java:117-137)."""
    from ..explore.encoders import adaboost_update
    resolve_device()
    counters = Counters()
    delim = cfg.field_delim_regex
    lines_in = artifacts.read_text_input(in_path)
    a_ord = cfg.must_get_int("abu.actual.class.attr.ordinal")
    p_ord = cfg.must_get_int("abu.pred.class.attr.ordinal")
    b_ord = cfg.must_get_int("abu.boost.attr.ordinal")
    error = cfg.must_get_float("abu.iteration.error")
    initial = cfg.get_float("abu.initial.weight", 1.0)
    prec = cfg.get_int("abu.output.precision", 6)
    rows = [_splitter(delim)(l) for l in lines_in]
    actual = [r[a_ord] for r in rows]
    pred = [r[p_ord] for r in rows]
    w = np.asarray([float(r[b_ord]) for r in rows])
    w2 = adaboost_update(w, actual, pred, error, initial)
    out = []
    for r, nw in zip(rows, w2):
        r[b_ord] = f"{nw:.{prec}f}"
        out.append(delim.join(r))
    artifacts.write_text_output(out_path, out)
    return counters


@register("org.avenir.explore.BaggingSampler", "baggingSampler",
          dist="gather")
def bagging_sampler(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Per-batch bagging (explore/BaggingSampler.java:90-124): stream rows in
    batches of bas.batch.size, emit batchSize uniform with-replacement draws
    from each batch (whole-dataset sampling would need global state the
    streaming reference cannot hold)."""
    from ..explore.samplers import bagging_sample
    resolve_device()
    counters = Counters()
    batch_size = cfg.get_int("bas.batch.size", 10000)
    seed = cfg.get_int("bas.random.seed", 0)
    lines_in = artifacts.read_text_input(in_path)
    out = []
    for b, start in enumerate(range(0, len(lines_in), batch_size)):
        batch = lines_in[start:start + batch_size]
        idx = bagging_sample(len(batch), 1.0, with_replacement=True,
                             seed=seed + b)
        out.extend(batch[i] for i in idx)
    artifacts.write_text_output(out_path, out)
    counters.set("Bagging", "inputRows", len(lines_in))
    counters.set("Bagging", "sampledRows", len(out))
    return counters


@register("org.avenir.explore.TopMatchesByClass", "topMatchesByClass",
          dist="gather")
def top_matches_by_class(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Per-record top-k nearest SAME-class neighbors, the SMOTE precursor
    (explore/TopMatchesByClass.java).  Input: pair-distance lines from the
    sameTypeSimilarity job (id1,id2,distance,class1,class2 — divergence: the
    reference reads sifarish's rank-last layout); each unordered pair feeds
    both directions (TopMatchesByClass.java:183-209).  Keys:
    tmc.top.match.count, tmc.nearest.by.count (false -> keep matches within
    tmc.match.distance), tmc.filer.class.value (reference key spelling)."""
    resolve_device()
    counters = Counters()
    delim = cfg.field_delim_regex
    od = cfg.field_delim_out
    by_count = cfg.get_boolean("tmc.nearest.by.count", True)
    top_k = cfg.get_int("tmc.top.match.count", 10)
    max_dist = cfg.get_int("tmc.match.distance", 200)
    filter_class = cfg.get("tmc.filer.class.value")
    split = _splitter(delim)
    neighbors: Dict[str, list] = {}
    classes: Dict[str, str] = {}
    for line in artifacts.read_text_input(in_path):
        it = split(line)
        id1, id2, dist, cls1, cls2 = it[0], it[1], int(it[2]), it[3], it[4]
        if cls1 != cls2:
            continue
        if filter_class is not None and cls1 != filter_class:
            continue
        classes[id1] = cls1
        classes[id2] = cls2
        neighbors.setdefault(id1, []).append((dist, id2))
        neighbors.setdefault(id2, []).append((dist, id1))
    out = []
    for src in sorted(neighbors):
        ranked = sorted(neighbors[src])
        if by_count:
            kept = ranked[:top_k]
        else:
            kept = [r for r in ranked if r[0] <= max_dist]
        for dist, trg in kept:
            out.append(od.join([src, classes[src], trg, str(dist)]))
        counters.increment("TopMatches", "records")
    artifacts.write_text_output(out_path, out)
    counters.set("TopMatches", "pairsEmitted", len(out))
    return counters
