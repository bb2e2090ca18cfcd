"""Regress-pack jobs (org.avenir.regress.*): port of
``avenir_tpu/cli/regress_jobs.py``.

Config keys follow regress/LogisticRegressionJob.java
setup()/checkConvergence: feature.schema.file.path, coeff.file.path,
positive.class.value, convergence.criteria, iteration.limit,
convergence.threshold, plus the JAX package's learning.rate /
l2.regularization extensions (the reference has no step size).
"""

from __future__ import annotations

import os

import numpy as np

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import ConfusionMatrix, Counters
from ..core.table import load_csv
from .jobs import _schema_path, register


@register("org.avenir.regress.LogisticRegressionJob", "logisticRegression",
          dist="sharded")
def logistic_regression(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Train to convergence (the reference main()'s do-while over MR runs,
    collapsed into one in-process loop).  The coefficient history file is
    read if present (resume) and rewritten with one line per iteration.

    Multi-process (dist=sharded): each process loads its OWN rows; the
    per-iteration gradient sums are all-reduced inside
    ``regress.logistic.step``, so every process walks the same coefficient
    history."""
    from ..parallel.distributed import process_index
    from ..regress import logistic as LR
    counters = Counters()
    schema = _schema_path(cfg, "feature.schema.file.path")
    params = LR.LogisticParams(
        pos_class_value=cfg.must_get("positive.class.value"),
        learning_rate=cfg.get_float("learning.rate", 0.1),
        convergence_criteria=cfg.get("convergence.criteria", LR.ITER_LIMIT),
        iteration_limit=cfg.get_int("iteration.limit", 10),
        convergence_threshold=cfg.get_float("convergence.threshold", 5.0),
        l2=cfg.get_float("l2.regularization", 0.0),
    )
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    coeff_path = cfg.must_get("coeff.file.path")
    history = []
    if os.path.exists(coeff_path):
        history = LR.parse_history(artifacts.read_text_input(coeff_path),
                                   cfg.field_delim_out)
    w, history, iters = LR.train(table, schema, params, history)
    with open(coeff_path, "w") as fh:
        for h in history:
            fh.write(LR.format_coefficients(h, cfg.field_delim_out) + "\n")
    od = cfg.field_delim_out
    artifacts.write_text_output(out_path, [LR.format_coefficients(w, od)])
    # the same values on every process: set once, so the joined run's
    # counter sum is exact
    p0 = process_index() == 0
    counters.set("Regression", "iterations", iters if p0 else 0)
    counters.set("Regression", "historyLength", len(history) if p0 else 0)
    return counters


@register("org.avenir.regress.LogisticRegressionPredictor",
          "logisticRegressionPredictor", dist="map")
def logistic_regression_predictor(cfg: Config, in_path: str, out_path: str
                                  ) -> Counters:
    """Map-only prediction with the trained coefficient file (last history
    line); validation mode fills a confusion matrix like the other
    predictors."""
    from ..regress import logistic as LR
    counters = Counters()
    schema = _schema_path(cfg, "feature.schema.file.path")
    pos = cfg.must_get("positive.class.value")
    history = LR.parse_history(
        artifacts.read_text_input(cfg.must_get("coeff.file.path")),
        cfg.field_delim_out)
    if not history:
        raise ValueError("empty coefficient file")
    w = history[-1]
    table = load_csv(in_path, schema, cfg.field_delim_regex, keep_raw=True)
    threshold = cfg.get_float("decision.threshold", 0.5)
    probs = LR.predict_proba(table, schema, w)
    pos_code = schema.class_attr_field.cat_code(pos)
    card = schema.class_attr_field.cardinality or []
    neg_code = next((c for c in range(len(card)) if c != pos_code),
                    1 - pos_code)
    codes = np.where(probs > threshold, pos_code, neg_code)
    od = cfg.field_delim_out
    validate = cfg.get_boolean("validation.mode", False)
    cm = ConfusionMatrix(
        neg_class=next((c for c in card if c != pos), "0"), pos_class=pos)
    lines = []
    for i, row in enumerate(table.raw_rows):
        pred = card[int(codes[i])] if card else str(int(codes[i]))
        lines.append(od.join(row + [pred, f"{probs[i]:.3f}"]))
        if validate:
            cm.report(pred, row[schema.class_attr_field.ordinal])
    artifacts.write_text_output(out_path, lines, role="m")
    if validate:
        cm.export(counters)
    return counters
