"""The KNN jobs of the port (``resource/knn.sh``: the sifarish distance job,
then avenir's NearestNeighbor), from ``avenir_tpu/cli/jobs.py``:

* ``sameTypeSimilarity`` — all-pairs record distance lines
  ``trainId,testId,dist[,trainClass,testClass]``;
* ``nearestNeighbor`` — groups those lines per test row and classifies or
  regresses;
* ``groupedRecordSimilarity`` — the all-pairs distance within each group of
  records sharing the group fields;
* ``featureCondProbJoiner`` — joins ``bayesianPredictor``'s feature
  probabilities onto the distance lines: the class-conditional layout
  ``nearestNeighbor`` reads with ``nen.class.condition.weighted``;
* ``knnPipeline`` — the fused in-process flow: distance + top-k on the
  device (kernel B5), then the vote.  Under a runtime context of several
  devices (``-Dplatform=cuda`` on a host with several GPUs, or a mesh the
  caller installed) the train rows shard over them (kernel B7).

``sameTypeSimilarity``, ``nearestNeighbor``, ``groupedRecordSimilarity``
and ``featureCondProbJoiner`` are gather jobs: in a joined run every process computes the whole answer
over the union of the processes' inputs (``cli.run``'s spool).  Over
processes ``knnPipeline`` is a partition job: each process classifies
its ``work_slice`` of the test rows against the whole train set and writes
its own part file, or, with ``nen.train.shard=true``, scans every test row
against its row range of the train set and merges the lists with its peers
once a test chunk (kernel B7's merge), so every process writes the
single-process predictions.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import ConfusionMatrix, Counters
from ..core.schema import FeatureSchema
from ..core.table import load_csv_text
from .jobs import _schema_path, _splitter, register


def _load_train_test(in_path: str, prefix: str, schema: FeatureSchema,
                     delim: str):
    """Split a similarity-job input into (train, test, intra_set): files in
    a dir starting with ``prefix`` are the train/base set, the rest test; a
    single file (or a dir with only one kind) is intra-set."""
    intra_set = False
    if os.path.isdir(in_path):
        files = sorted(p for p in glob.glob(os.path.join(in_path, "*"))
                       if os.path.isfile(p))
        base = [p for p in files if os.path.basename(p).startswith(prefix)]
        other = [p for p in files
                 if not os.path.basename(p).startswith(prefix)]
        if not base or not other:
            base = other = files
            intra_set = True
    else:
        base = other = [in_path]
        intra_set = True

    def load_many(paths):
        lines = []
        for p in paths:
            lines.extend(artifacts.read_text_input(p))
        return load_csv_text("\n".join(lines), schema, delim)

    train = load_many(base)
    test = train if intra_set else load_many(other)
    return train, test, intra_set


@register("org.sifarish.feature.SameTypeSimilarity", "sameTypeSimilarity",
          "recordSimilarity", dist="gather")
def same_type_similarity(cfg: Config, in_path: str, out_path: str
                         ) -> Counters:
    """All-pairs record distance (the external sifarish job of
    resource/knn.sh:47).  Inter-set mode: files of the input dir starting
    with ``sts.base.set.split.prefix`` are the train/base set, the rest
    test.  Output lines ``trainId,testId,distance,trainClass[,testClass]``
    with the distance scaled by ``sts.distance.scale`` (default 1000);
    intra-set mode emits each unordered pair once (i < j)."""
    from ..ops.distance import DistanceComputer
    counters = Counters()
    schema = _schema_path(cfg, "sts.same.schema.file.path")
    delim = cfg.field_delim_regex
    prefix = cfg.get("sts.base.set.split.prefix", "tr")
    scale = cfg.get_int("sts.distance.scale", 1000)
    metric = cfg.get("sts.distance.metric", "euclidean")
    train, test, intra_set = _load_train_test(in_path, prefix, schema, delim)
    comp = DistanceComputer(schema, metric=metric, scale=scale)
    dmat = comp.pairwise(test, train)
    id_ord = schema.id_fields[0].ordinal if schema.id_fields else 0
    train_ids = train.str_columns.get(id_ord,
                                      [str(i) for i in range(train.n_rows)])
    test_ids = test.str_columns.get(id_ord,
                                    [str(i) for i in range(test.n_rows)])
    # class columns are optional: pure similarity mode has no class notion
    try:
        cvals = schema.class_attr_field.cardinality or []
        train_cls = [cvals[c] if c >= 0 else "?" for c in train.class_codes()]
        test_cls = [cvals[c] if c >= 0 else "?" for c in test.class_codes()]
    except ValueError:
        train_cls = test_cls = None
    od = cfg.field_delim_out
    lines = []
    for ti in range(test.n_rows):
        for ri in range(ti + 1 if intra_set else 0, train.n_rows):
            parts = [train_ids[ri], test_ids[ti], str(int(dmat[ti, ri]))]
            if train_cls is not None:
                parts.append(train_cls[ri])
                parts.append(test_cls[ti])
            lines.append(od.join(parts))
    artifacts.write_text_output(out_path, lines)
    counters.increment("Similarity", "Pairs", len(lines))
    return counters


@register("org.avenir.spark.similarity.GroupedRecordSimilarity",
          "groupedRecordSimilarity", dist="gather")
def grouped_record_similarity(cfg: Config, in_path: str, out_path: str
                              ) -> Counters:
    """Per-group all-pairs record distance
    (spark/.../similarity/GroupedRecordSimilarity.scala:34-103): records
    grouped by ``grs.group.field.ordinals``; within each group, in sorted
    group order, every unordered pair (i < j) gets the mixed-type distance
    of ``DistanceComputer.pairwise``, euclidean in the top-k order.

    The JAX package pads each group to a power of two rows for its compile
    cache, and XLA's CPU dot takes its summation order from the padded
    shape: over four numeric features the top-k order at 4 rows and at
    64 and more, other orders at 8-32, where a distance can differ by one
    or two (ROADMAP §C).  No shape changes the order here, so groups are
    not padded.

    Output lines ``group...,firstId,secondId,distance``."""
    from ..ops.distance import DistanceComputer
    counters = Counters()
    schema = _schema_path(cfg, "sts.same.schema.file.path")
    delim = cfg.field_delim_regex
    od = cfg.field_delim_out
    scale = cfg.get_int("sts.distance.scale", 1000)
    metric = cfg.get("sts.distance.metric", "euclidean")
    group_ords = [int(x) for x in cfg.must_get_list("grs.group.field.ordinals")]
    split_line = _splitter(delim)
    groups: Dict[str, List[str]] = {}
    for line in artifacts.read_text_input(in_path):
        items = split_line(line)
        groups.setdefault(od.join(items[o] for o in group_ords),
                          []).append(line)
    comp = DistanceComputer(schema, metric=metric, scale=scale)
    id_ord = schema.id_fields[0].ordinal if schema.id_fields else 0
    out_lines: List[str] = []
    for gkey in sorted(groups):
        glines = groups[gkey]
        n = len(glines)
        if n < 2:
            continue
        table = load_csv_text("\n".join(glines), schema, delim)
        dmat = comp.pairwise(table, table, topk_order=True)
        ids = table.str_columns.get(id_ord, [str(i) for i in range(n)])
        for i in range(n):
            for j in range(i + 1, n):
                out_lines.append(od.join(
                    [gkey, ids[i], ids[j], str(int(dmat[i, j]))]))
        counters.increment("Similarity", "Groups", 1)
    counters.increment("Similarity", "Pairs", len(out_lines))
    artifacts.write_text_output(out_path, out_lines)
    return counters


def _knn_params(cfg: Config):
    from ..models.knn import KnnParams
    params = KnnParams(
        top_match_count=cfg.get_int("nen.top.match.count", 10),
        kernel_function=cfg.get("nen.kernel.function", "none"),
        kernel_param=cfg.get_int("nen.kernel.param", -1),
        # the reference uses BOTH spellings: the mapper reads
        # nen.class.condition.weighted (NearestNeighbor.java:120), the
        # reducer the typo'd nen.class.condtion.weighted (:239)
        class_cond_weighted=cfg.get_boolean("nen.class.condtion.weighted",
                                            False)
        or cfg.get_boolean("nen.class.condition.weighted", False),
        inverse_distance_weighted=cfg.get_boolean(
            "nen.inverse.distance.weighted", False),
        decision_threshold=cfg.get_float("nen.decision.threshold", -1.0),
        use_cost_based_classifier=cfg.get_boolean(
            "nen.use.cost.based.classifier", False),
        prediction_mode=cfg.get("nen.prediction.mode", "classification"),
        regression_method=cfg.get("nen.regression.method", "average"),
    )
    cav = cfg.get_list("nen.class.attribute.values")
    if cav:
        params.pos_class, params.neg_class = cav[0], cav[1]
    if params.use_cost_based_classifier:
        costs = cfg.must_get_list("nen.misclassification.cost")
        params.false_pos_cost = int(costs[0])
        params.false_neg_cost = int(costs[1])
    return params


@register("org.avenir.knn.FeatureCondProbJoiner", "featureCondProbJoiner",
          dist="gather")
def feature_cond_prob_joiner(cfg: Config, in_path: str, out_path: str
                             ) -> Counters:
    """Join the Bayesian feature posterior probabilities onto nearest-
    neighbour lines (knn/FeatureCondProbJoiner.java; knn.sh's
    joinFeatureDistr step).

    The input dir holds two kinds of files: those whose name starts with
    ``fcb.feature.cond.prob.split.prefix`` (default ``condProb``) are
    ``bayesianPredictor``'s feature-prob output (itemID, P(x), class,
    P(x|c) pairs, actual class), the rest are distance lines
    (trainId,testId,distance,trainClass,testClass).  The output is the
    class-conditional layout ``nearestNeighbor`` reads: testId,
    testClassActual, trainId, distance, trainClass, P(x|trainClass)."""
    counters = Counters()
    prefix = cfg.get("fcb.feature.cond.prob.split.prefix", "condProb")
    split = _splitter(cfg.field_delim_regex)
    od = cfg.field_delim_out
    prob_lines: List[List[str]] = []
    neigh_lines: List[List[str]] = []
    files = sorted(glob.glob(os.path.join(in_path, "*"))) \
        if os.path.isdir(in_path) else [in_path]
    for p in files:
        base = os.path.basename(p)
        if not os.path.isfile(p) or base.startswith(("_", ".")):
            continue  # Hadoop-style markers (_SUCCESS, .crc)
        bucket = prob_lines if base.startswith(prefix) else neigh_lines
        bucket.extend(split(l) for l in artifacts.read_text_input(p))
    # train item -> (actual class, P(x|actual class))
    cls_prob: Dict[str, str] = {}
    for it in prob_lines:
        actual = it[-1]
        pairs = it[2:-1]
        for i in range(0, len(pairs) - 1, 2):
            if pairs[i] == actual:
                cls_prob[it[0]] = f"{actual}{od}{pairs[i + 1]}"
                break
    out = []
    for it in neigh_lines:
        train_id, test_id, dist = it[0], it[1], it[2]
        test_class = it[4] if len(it) > 4 else "?"
        joined = cls_prob.get(train_id)
        if joined is None:
            # a train item whose actual class had no (class, prob) pair:
            # bap.predict.class did not cover every class value
            counters.increment("Join", "unmatchedNeighbors")
            continue
        out.append(od.join([test_id, test_class, train_id, dist, joined]))
    artifacts.write_text_output(out_path, out)
    counters.set("Join", "joinedLines", len(out))
    return counters


@register("org.avenir.knn.KnnPipeline", "knnPipeline", "knnInProcess",
          dist="partition")
def knn_pipeline(cfg: Config, in_path: str, out_path: str) -> Counters:
    """The whole knn.sh pipeline fused in process: distance + running top-k
    on the device (``DistanceComputer.pairwise_topk``, kernel B5; sharded
    over the runtime context's devices when it has several) feeding
    the Neighborhood vote; the all-pairs CSV between the two jobs never
    exists.  Input like sameTypeSimilarity; inter-set output and
    validation counters match nearestNeighbor's.  Intra-set input gives
    every row its k nearest among ALL other rows (leave-one-out: k + 1
    neighbors, then the self-match dropped).  Class-conditional weighting
    and regression need the file flow's layout and are refused.

    ``nen.train.shard=true`` splits the TRAIN rows by the run's shards
    (``parallel.distributed.shard_spec``): each process scans the whole
    test set against its train range and the nearest lists merge once a
    test chunk (``DistanceComputer.pairwise_topk(shard_reducer=)``), so
    every shard writes the single-process predictions as ``part-r-00000``
    and shard 0 alone sets the counters.  Otherwise each process
    classifies its ``work_slice`` of the test rows and writes its own part
    file, with per-slice counters that a joined run sums."""
    from ..models import knn as K
    from ..ops.distance import DistanceComputer
    counters = Counters()
    params = _knn_params(cfg)
    if params.class_cond_weighted:
        raise ValueError(
            "knnPipeline has no Bayesian posterior join; run the file "
            "pipeline (sameTypeSimilarity -> featureCondProbJoiner -> "
            "nearestNeighbor) for class-conditional weighting")
    if params.prediction_mode == "regression":
        raise ValueError(
            "knnPipeline is classification-only; KNN regression needs the "
            "nearestNeighbor file layout's target columns")
    schema = _schema_path(cfg, "sts.same.schema.file.path")
    delim = cfg.field_delim_regex
    od = cfg.field_delim_out
    prefix = cfg.get("sts.base.set.split.prefix", "tr")
    scale = cfg.get_int("sts.distance.scale", 1000)
    metric = cfg.get("sts.distance.metric", "euclidean")
    validation = cfg.get_boolean("nen.validation.mode", True)
    output_class_distr = cfg.get_boolean("nen.output.class.distr", False)

    train, test, intra_set = _load_train_test(in_path, prefix, schema, delim)
    comp = DistanceComputer(schema, metric=metric, scale=scale)
    k = min(params.top_match_count, train.n_rows - (1 if intra_set else 0))
    knn_reducer = None
    t_lo = 0
    if cfg.get_boolean("nen.train.shard", False):
        from ..parallel.collectives import AllReducer
        from ..parallel.distributed import shard_spec
        spec = shard_spec()
        knn_reducer = AllReducer(spec=spec, name="knn-train")
        tr_lo, tr_hi = spec.range_for(train.n_rows)
        nd, idx = comp.pairwise_topk(
            test, train.take_rows(tr_lo, tr_hi), k + 1 if intra_set else k,
            shard_reducer=knn_reducer, shard_base=tr_lo)
    else:
        from ..parallel.distributed import work_slice
        t_lo, t_hi = work_slice(test.n_rows)
        test = test.take_rows(t_lo, t_hi)
        nd, idx = comp.pairwise_topk(test, train, k + 1 if intra_set else k)
    if intra_set:
        # drop the self-match (train index == global test row), keeping
        # the order
        self_col = (np.arange(test.n_rows) + t_lo)[:, None]
        keep = np.argsort(idx == self_col, axis=1, kind="stable")[:, :k]
        nd = np.take_along_axis(nd, keep, axis=1)
        idx = np.take_along_axis(idx, keep, axis=1)

    cardinality = list(schema.class_attr_field.cardinality or [])
    # vote over SORTED class values like nearestNeighbor (which sorts the
    # classes it observes); train rows with labels outside the cardinality
    # (code -1) vote as "?", their own class
    train_codes = train.class_codes()
    unknown = bool((train_codes < 0).any())
    class_values = sorted(set(cardinality) | ({"?"} if unknown else set()))
    if cardinality:
        remap = np.array([class_values.index(c) for c in cardinality],
                         dtype=np.int32)
        mapped = np.where(
            train_codes >= 0, remap[np.clip(train_codes, 0, None)],
            class_values.index("?") if unknown else 0).astype(np.int32)
    else:  # no cardinality: every label is unknown, all votes are "?"
        mapped = np.zeros_like(train_codes)
    res = K.classify_topk(nd, mapped[idx], class_values, params)

    id_ord = schema.id_fields[0].ordinal if schema.id_fields else 0
    test_ids = test.str_columns.get(
        id_ord, [str(i) for i in range(t_lo, t_lo + test.n_rows)])
    actual = None
    cm = None
    if validation:
        actual = [cardinality[c] if c >= 0 else "?"
                  for c in test.class_codes()]
        # (neg, pos) like nearestNeighbor: schema cardinality first
        # (NearestNeighbor.java:287-292), then nen.class.attribute.values,
        # then a degenerate-cardinality fallback
        if len(cardinality) >= 2:
            neg, pos = cardinality[0], cardinality[1]
        elif params.pos_class:
            neg, pos = params.neg_class, params.pos_class
        else:
            cvs = class_values if len(class_values) >= 2 else class_values * 2
            neg, pos = cvs[0], cvs[1]
        cm = ConfusionMatrix(neg, pos)
    out_lines = []
    for i in range(test.n_rows):
        parts = [test_ids[i]]
        if output_class_distr:
            for ci, cv in enumerate(class_values):
                parts.append(cv)
                parts.append(str(res.class_distr[i][ci]))
        if validation:
            parts.append(actual[i])
            cm.report(res.pred_class[i], actual[i])
        parts.append(res.pred_class[i])
        out_lines.append(od.join(parts))
    # train-sharded: every shard computed the whole, identical prediction
    # set, so shard 0 alone sets the counters (a joined run sums them)
    if knn_reducer is None or knn_reducer.spec.index == 0:
        if cm is not None:
            cm.export(counters)
        counters.increment("Neighborhood", "Test records", test.n_rows)
    artifacts.write_text_output(out_path, out_lines,
                                local_shard=knn_reducer is None)
    return counters


@register("org.avenir.knn.NearestNeighbor", "nearestNeighbor",
          "knnClassifier", dist="gather")
def nearest_neighbor(cfg: Config, in_path: str, out_path: str) -> Counters:
    """KNN classification/regression over precomputed neighbor lines
    (knn/NearestNeighbor.java; the knn.sh 'knnClassifier' step).

    Input layout (TopMatchesMapper :130-183):
      normal:            trainId,testId,distance,trainClass[,testClassActual]
      classCondWeighted: testId,testClassActual,trainId,distance,trainClass,postProb
    Output: testId[,classDistr...][,actualClass],predicted, with the
    Validation counters in validation mode."""
    from ..models import knn as K
    counters = Counters()
    params = _knn_params(cfg)
    validation = cfg.get_boolean("nen.validation.mode", True)
    output_class_distr = cfg.get_boolean("nen.output.class.distr", False)
    od = cfg.field_delim_out
    lines_in = artifacts.read_text_input(in_path)
    is_linreg = (params.prediction_mode == "regression" and
                 params.regression_method == "linearRegression")

    # group neighbor candidates per test entity (TopMatchesMapper layouts)
    split_line = _splitter(cfg.field_delim_regex)
    groups: Dict[str, Dict] = {}
    for line in lines_in:
        it = split_line(line)
        train_regr = test_regr = 0.0
        if params.class_cond_weighted:
            test_id, actual = it[0], it[1]
            dist, tclass, fpp = int(it[3]), it[4], float(it[5])
        else:
            test_id, dist, tclass = it[1], int(it[2]), it[3]
            idx = 4
            actual = ""
            if validation:
                actual = it[idx]
                idx += 1
            if is_linreg:
                train_regr, test_regr = float(it[idx]), float(it[idx + 1])
            fpp = -1.0
        g = groups.setdefault(test_id, {"actual": actual, "d": [], "c": [],
                                        "fpp": [], "trv": [],
                                        "tev": test_regr})
        g["d"].append(dist)
        g["c"].append(tclass)
        g["fpp"].append(fpp)
        g["trv"].append(train_regr)

    if not groups:
        artifacts.write_text_output(out_path, [])
        return counters

    class_values = sorted({c for g in groups.values() for c in g["c"]})
    cls_code = {c: i for i, c in enumerate(class_values)}
    test_ids = sorted(groups.keys())
    max_n = max(len(groups[t]["d"]) for t in test_ids)
    dmat = np.full((len(test_ids), max_n), K.PAD_DISTANCE, dtype=np.int64)
    cmat = np.zeros((len(test_ids), max_n), dtype=np.int32)
    fmat = np.full((len(test_ids), max_n), -1.0, dtype=np.float32)
    for i, t in enumerate(test_ids):
        g = groups[t]
        m = len(g["d"])
        dmat[i, :m] = g["d"]
        cmat[i, :m] = [cls_code[c] for c in g["c"]]
        fmat[i, :m] = g["fpp"]

    if params.prediction_mode == "regression":
        vals = np.array([[float(class_values[c]) for c in row]
                         for row in cmat])
        if is_linreg:
            nin = np.zeros_like(dmat, dtype=np.float64)
            x0 = np.zeros((len(test_ids),))
            for i, t in enumerate(test_ids):
                m = len(groups[t]["trv"])
                nin[i, :m] = groups[t]["trv"]
                x0[i] = groups[t]["tev"]
            pred_vals = K.regress_grouped(dmat, vals, params,
                                          regr_input=x0, neighbor_input=nin)
        else:
            pred_vals = K.regress_grouped(dmat, vals, params)
        out_lines = []
        for i, t in enumerate(test_ids):
            parts = [t]
            if validation:
                parts.append(groups[t]["actual"])
            parts.append(str(int(pred_vals[i])))
            out_lines.append(od.join(parts))
        artifacts.write_text_output(out_path, out_lines)
        return counters

    res = K.classify_grouped(dmat, cmat, class_values, params, fmat)
    cm = None
    if validation:
        # the reference builds the matrix from the schema's class
        # cardinality: ConfusionMatrix(cardinality[0], cardinality[1]) =
        # (neg, pos) (NearestNeighbor.java:287-292)
        if "nen.feature.schema.file.path" in cfg:
            card = _schema_path(cfg, "nen.feature.schema.file.path") \
                .class_attr_field.cardinality
            neg, pos = card[0], card[1]
        elif params.pos_class:
            neg, pos = params.neg_class, params.pos_class
        else:
            cvs = class_values if len(class_values) >= 2 else class_values * 2
            neg, pos = cvs[0], cvs[1]
        cm = ConfusionMatrix(neg, pos)
    out_lines: List[str] = []
    for i, t in enumerate(test_ids):
        parts = [t]
        if output_class_distr:
            distr = res.weighted_class_distr[i] if params.class_cond_weighted \
                else res.class_distr[i]
            for ci, cv in enumerate(class_values):
                parts.append(cv)
                parts.append(str(distr[ci]))
        if validation:
            parts.append(groups[t]["actual"])
        parts.append(res.pred_class[i])
        out_lines.append(od.join(parts))
        if cm is not None:
            cm.report(res.pred_class[i], groups[t]["actual"])
    if cm is not None:
        cm.export(counters)
    artifacts.write_text_output(out_path, out_lines)
    return counters
