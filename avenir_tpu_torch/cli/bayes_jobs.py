"""The Naive Bayes jobs of the port (org.avenir.bayesian), from
``avenir_tpu/cli/jobs.py``:

* ``bayesianDistribution`` — trains the model file (``part-r-00000``);
  with no schema key it trains the text mode over ``text,classLabel``
  lines;
* ``bayesianPredictor`` — scores records with a model file: the argmax
  with its percent, cost arbitration (``bap.predict.class.cost``), the
  ambiguity flag (``bap.class.prob.diff.threshold``), or the feature
  probabilities alone (``bap.output.feature.prob.only``, the input of
  ``featureCondProbJoiner`` in the knn.sh pipeline); with no schema key,
  the text mode.

In a joined ``torch.distributed`` run, ``bayesianDistribution`` is a
sharded job: each process reads its own file and one sum of the counts
makes every process write the model of one process over the
concatenated files.  The shard lane (``AVENIR_TPU_SHARD``) refuses it, and
so does a joined run of the text mode.  ``bayesianPredictor`` is a map
job: each process writes ``part-m-<process>`` over its own input.
"""

from __future__ import annotations

from typing import List

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import ConfusionMatrix, CostBasedArbitrator, Counters
from ..core.table import load_csv
from .jobs import (JobNotPorted, _bad_records_policy, _joined_reducer,
                   _refuse_multi_shard, _schema_path, register)


def _bayesian_predict_text(cfg: Config, in_path: str, out_path: str
                           ) -> Counters:
    """Text-mode prediction: tokenize each line's text, classify by summed
    token log-posteriors, echo the record and the prediction (+ validation
    counters when the class label column is present)."""
    from ..models import bayes_text
    counters = Counters()
    od = cfg.field_delim_out
    delim = cfg.field_delim_regex
    model = bayes_text.TextBayesModel.from_lines(
        artifacts.read_text_input(
            cfg.must_get("bap.bayesian.model.file.path")), od)
    lines_in = [l for l in artifacts.read_text_input(in_path) if l.strip()]
    texts, actuals = [], []
    for line in lines_in:
        text, _, label = line.rpartition(delim)
        if label.strip() in model.class_values and text:
            texts.append(text)
            actuals.append(label.strip())
        else:
            texts.append(line)
            actuals.append(None)
    pred, _scores = bayes_text.classify_text(model, texts)
    out = [f"{raw}{od}{p}" for raw, p in zip(lines_in, pred)]
    artifacts.write_text_output(out_path, out, role="m")
    known = [(a, p) for a, p in zip(actuals, pred) if a is not None]
    if known:
        correct = sum(1 for a, p in known if a == p)
        counters.set("Validation", "Correct", correct)
        counters.set("Validation", "Incorrect", len(known) - correct)
        counters.set("Validation", "Accuracy",
                     int(100 * correct / len(known)))
    return counters


@register("org.avenir.bayesian.BayesianDistribution", "bayesianDistribution",
          dist="sharded")
def bayesian_distribution(cfg: Config, in_path: str, out_path: str
                          ) -> Counters:
    """Naive Bayes training job (bayesian/BayesianDistribution.java).

    Keys (the reference's names): bad.feature.schema.file.path,
    field.delim.regex, field.delim.out, badrecords.policy.  With no schema
    file configured the input is text mode, ``text,classLabel`` lines with
    the token stream as the single feature."""
    from ..models import bayes
    from ..parallel.distributed import shard_spec
    _refuse_multi_shard("bayesianDistribution")
    counters = Counters()
    if cfg.get("bad.feature.schema.file.path") is None:
        if shard_spec().active:
            raise JobNotPorted(
                "bayesianDistribution text mode in a joined run: its "
                "vocabulary is built from one process's lines, so each "
                "process would write a model of its own file; run it "
                "single-process over the concatenated input")
        from ..models import bayes_text
        model_t = bayes_text.train_text(artifacts.read_text_input(in_path),
                                        cfg.field_delim_regex)
        artifacts.write_text_output(out_path,
                                    model_t.to_lines(cfg.field_delim_out))
        counters.set("Distribution Data", "Class prior",
                     len(model_t.class_values))
        counters.set("Distribution Data", "Vocabulary", len(model_t.vocab))
        return counters
    schema = _schema_path(cfg, "bad.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex,
                     bad_records=_bad_records_policy(cfg, counters, out_path))
    # every process counts the global model, as in the JAX package, so a
    # joined run's summed counters are the process count times one's
    model = bayes.train(table, counters=counters,
                        reducer=_joined_reducer("nb-train"))
    artifacts.write_text_output(out_path, model.to_lines(cfg.field_delim_out))
    return counters


@register("org.avenir.bayesian.BayesianPredictor", "bayesianPredictor",
          dist="map")
def bayesian_predictor(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Naive Bayes prediction job (bayesian/BayesianPredictor.java).

    Keys: bap.feature.schema.file.path, bap.bayesian.model.file.path,
    bap.predict.class, bap.predict.class.cost,
    bap.class.prob.diff.threshold, bap.output.feature.prob.only.  With no
    schema file configured the input is text mode: ``text[,classLabel]``
    lines classified by their token stream."""
    from ..models import bayes
    if cfg.get("bap.feature.schema.file.path") is None:
        return _bayesian_predict_text(cfg, in_path, out_path)
    counters = Counters()
    schema = _schema_path(cfg, "bap.feature.schema.file.path")
    delim = cfg.field_delim_regex
    out_delim = cfg.field_delim_out
    table = load_csv(in_path, schema, delim, keep_raw=True)
    model = bayes.NaiveBayesModel.from_lines(
        artifacts.read_text_input(cfg.must_get("bap.bayesian.model.file.path")),
        schema, delim)
    res = bayes.predict(model, table)

    # the predicting classes default to the first two of the class
    # cardinality (BayesianPredictor.java:151-159)
    feature_prob_only = cfg.get_boolean("bap.output.feature.prob.only", False)
    pred_classes = cfg.get_list("bap.predict.class") or model.class_values[:2]
    if feature_prob_only and not cfg.get_list("bap.predict.class"):
        # featureCondProbJoiner needs every class's posterior: a record
        # whose actual class is missing from the pairs drops all its
        # neighbours downstream
        pred_classes = list(model.class_values)
    neg_class, pos_class = pred_classes[0], pred_classes[1]
    prob_diff_threshold = cfg.get_int("bap.class.prob.diff.threshold", -1)

    arbitrator = None
    if cfg.get("bap.predict.class.cost") is not None:
        costs = cfg.must_get_list("bap.predict.class.cost", delim=out_delim)
        arbitrator = CostBasedArbitrator(neg_class, pos_class,
                                         int(costs[0]), int(costs[1]))

    cls_index = {v: i for i, v in enumerate(model.class_values)}
    actual_codes = table.class_codes()
    lines: List[str] = []

    if feature_prob_only:
        # BayesianPredictor.outputFeatureProb: itemID, P(x), then (class,
        # P(x|c)) pairs, then the actual class; no prediction, no
        # validation counters
        id_ord = schema.id_fields[0].ordinal if schema.id_fields else 0
        px = res.feature_prior_prob
        pxc = res.feature_post_prob
        for i, raw in enumerate(table.raw_rows):
            parts = [raw[id_ord], repr(float(px[i]))]
            for cv in pred_classes:
                parts.append(cv)
                parts.append(repr(float(pxc[i, cls_index[cv]])))
            parts.append(model.class_values[actual_codes[i]]
                         if actual_codes[i] >= 0 else "?")
            lines.append(out_delim.join(parts))
        artifacts.write_text_output(out_path, lines, role="m")
        return counters

    cm = ConfusionMatrix(neg_class, pos_class)
    pct = res.class_probs if arbitrator is not None else None
    for i, raw in enumerate(table.raw_rows):
        record = out_delim.join(raw)
        if arbitrator is not None:
            pred = arbitrator.arbitrate(int(pct[i, cls_index[pos_class]]),
                                        int(pct[i, cls_index[neg_class]]))
            prob = 100  # the reference's costArbitrate sets predProb=100
        else:
            pred = res.pred_class[i]
            prob = int(res.pred_prob[i])
        parts = [record, pred, str(prob)]
        if prob_diff_threshold > 0:
            parts.append("classified"
                         if res.class_prob_diff[i] > prob_diff_threshold
                         else "ambiguous")
        lines.append(out_delim.join(parts))
        actual = model.class_values[actual_codes[i]] \
            if actual_codes[i] >= 0 else "?"
        cm.report(pred, actual)
        if pred == actual:
            counters.increment("Validation", "Correct")
        else:
            counters.increment("Validation", "Incorrect")
    cm.export(counters)
    artifacts.write_text_output(out_path, lines, role="m")  # map-only job
    return counters
