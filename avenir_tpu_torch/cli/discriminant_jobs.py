"""Discriminant-pack jobs (org.avenir.discriminant.*): the port of
``avenir_tpu/cli/discriminant_jobs.py``.  Every job runs on the process's
device (``cuda`` unless ``-Dplatform=cpu``) and raises without a GPU when
asked for one.  ``supportVectorMachine`` takes an optional ``profile``
(``utils.tracing.LayerProfile``) that collects the wall of each layer.

Config keys follow the reference setup() methods: svm.* incl. the reference's
``svm.pnalty.factor`` typo (SupportVectorMachine.java:61-66) and the Fisher
job's reuse of the numeric-stats pipeline (FisherDiscriminant.java).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import ConfusionMatrix, Counters
from ..core.table import load_csv
from ..runtime import resolve_device
from ..utils.tracing import LayerProfile, layer
from .jobs import _schema_path, register


def _svm_xy(cfg: Config, table, schema):
    """Features + ±1 targets.  The reference expects the class column already
    numeric ±1 (parsed as double, SupportVectorMachine.java:97-100); we also
    accept a categorical class with svm.positive.class.value."""
    X = table.feature_matrix(dtype=np.float64)
    cf = schema.class_attr_field
    if cf.is_categorical:
        pos = cfg.must_get("svm.positive.class.value",
                           "categorical class needs svm.positive.class.value")
        y = np.where(table.class_codes() == cf.must_cat_code(pos), 1.0, -1.0)
    else:
        y = np.where(table.columns[cf.ordinal] > 0, 1.0, -1.0)
    return X, y


@register("org.avenir.discriminant.SupportVectorMachine",
          "supportVectorMachine",
          dist="gather")
def support_vector_machine(cfg: Config, in_path: str, out_path: str,
                           profile: Optional[LayerProfile] = None
                           ) -> Counters:
    """SMO training; emits support-vector rows (features..., target, alpha)
    plus a 'weights' model line for the linear predictor.  Keys:
    svm.feature.schema.file.path, svm.pnalty.factor, svm.tolerance, svm.eps,
    svm.kernel.type, svm.positive.class.value.

    ``svm.group.field.ordinals`` trains one SVM per distinct group key —
    the reference's per-mapper partitions (SupportVectorMachine.java:70-85)
    — with every output line prefixed by its group key.  ``svm.solver``
    picks the trainer: ``serial`` (Platt, the default) or ``batched`` (the
    lock-step maximal-violating-pair device SMO,
    discriminant/smo.py:train_groups_batched — ALL groups advance in one
    device loop; same optimum, so per-group weights/threshold/
    predictions agree with serial to optimization tolerance, though the
    support-vector line SETS may differ on degenerate margins)."""
    from ..discriminant import smo as S
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "svm.feature.schema.file.path")
    group_ords = [int(o) for o in
                  cfg.get_list("svm.group.field.ordinals") or []]
    solver = cfg.get("svm.solver", "serial")
    if solver not in ("serial", "batched"):
        raise ValueError(f"svm.solver must be serial|batched, got {solver!r}")
    with layer(profile, "parse"):
        table = load_csv(in_path, schema, cfg.field_delim_regex,
                         keep_raw=bool(group_ords))
    params = S.SMOParams(
        penalty_factor=cfg.get_float("svm.pnalty.factor",
                                     cfg.get_float("svm.penalty.factor", 0.05)),
        tolerance=cfg.get_float("svm.tolerance", 1e-3),
        eps=cfg.get_float("svm.eps", 1e-3),
        kernel_type=cfg.get("svm.kernel.type", S.KERNEL_LINEAR),
        seed=cfg.get_int("svm.random.seed", 0),
    )
    with layer(profile, "encode"):
        X, y = _svm_xy(cfg, table, schema)
    od = cfg.field_delim_out

    def weights_line(model, prefix=()):
        return od.join([*prefix, "weights"] +
                       [f"{w:.9g}" for w in model.weights] +
                       [f"{model.threshold:.9g}"])

    lines: List[str] = []
    if group_ords:
        row_idx: dict = {}
        for i, r in enumerate(table.raw_rows):
            row_idx.setdefault(od.join(r[o] for o in group_ords),
                               []).append(i)
        gxy = {g: (X[idx], y[idx]) for g, idx in row_idx.items()}
        with layer(profile, "device"):
            models = S.train_groups(gxy, params,
                                    batched=(solver == "batched"),
                                    device=dev)
        n_sv = 0
        for g in sorted(models):
            m = models[g]
            n_sv += len(m.sup_vec_idx)
            lines.extend(od.join([g, sv])
                         for sv in m.support_vector_lines(od))
            lines.append(weights_line(m, prefix=(g,)))
        counters.set("SVM", "groups", len(models))
        counters.set("SVM", "supportVectors", n_sv)
    else:
        with layer(profile, "device"):
            model = S.train_groups({"": (X, y)}, params,
                                   batched=(solver == "batched"),
                                   device=dev)[""]
        lines = model.support_vector_lines(od)
        lines.append(weights_line(model))
        counters.set("SVM", "supportVectors", len(model.sup_vec_idx))
    with layer(profile, "write"):
        artifacts.write_text_output(out_path, lines)
    counters.set("SVM", "rows", table.n_rows)
    return counters


@register("org.avenir.discriminant.SupportVectorPredictor",
          "supportVectorPredictor",
          dist="map")
def support_vector_predictor(cfg: Config, in_path: str, out_path: str
                             ) -> Counters:
    """Map-only linear-SVM prediction from the trained model's weights line;
    validation mode exports a confusion matrix.  Keys: svm.model.file.path
    plus the training keys."""
    from ..discriminant import smo as S
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "svm.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex, keep_raw=True)
    od = cfg.field_delim_out
    w = b = None
    for line in artifacts.read_text_input(cfg.must_get("svm.model.file.path")):
        parts = line.strip().split(od)
        if parts and parts[0] == "weights":
            vals = [float(v) for v in parts[1:]]
            w, b = np.array(vals[:-1]), vals[-1]
    if w is None:
        raise ValueError("model file has no weights line")
    model = S.SVMModel(weights=w, threshold=b,
                       sup_vec_idx=np.zeros(0, int),
                       alphas=np.zeros(0), X=np.zeros((0, len(w))),
                       y=np.zeros(0))
    X, _ = _svm_xy(cfg, table, schema)
    pred = S.predict(model, X, device=dev)
    cf = schema.class_attr_field
    pos = cfg.get("svm.positive.class.value")
    card = cf.cardinality or []
    neg = next((c for c in card if c != pos), "-1")
    labels = np.where(pred > 0, pos if pos else "1", neg)
    lines = [od.join(row + [str(labels[i])])
             for i, row in enumerate(table.raw_rows)]
    artifacts.write_text_output(out_path, lines, role="m")
    if cfg.get_boolean("validation.mode", False) and pos:
        cm = ConfusionMatrix(neg_class=neg, pos_class=pos)
        actual = [row[cf.ordinal] for row in table.raw_rows]
        cm.report_batch(pred > 0,
                        np.array([a == pos for a in actual]),
                        np.array([a == neg for a in actual]))
        cm.export(counters)
    return counters


@register("org.avenir.discriminant.FisherDiscriminant", "fisherDiscriminant",
          dist="gather")
def fisher_discriminant_job(cfg: Config, in_path: str, out_path: str
                            ) -> Counters:
    """Per-attribute two-class boundary lines
    ``attr,logOddsPrior,pooledVariance,discrimValue``
    (FisherDiscriminant.java:44-55).  Key: fid.feature.schema.file.path
    (falls back to feature.schema.file.path)."""
    from ..discriminant import fisher as F
    dev = resolve_device()
    counters = Counters()
    key = ("fid.feature.schema.file.path"
           if cfg.get("fid.feature.schema.file.path")
           else "feature.schema.file.path")
    schema = _schema_path(cfg, key)
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    res = F.fisher_discriminant(table, device=dev)
    artifacts.write_text_output(out_path, res.to_lines(cfg.field_delim_out))
    counters.set("Fisher", "attributes", len(res.attr_ordinals))
    return counters
