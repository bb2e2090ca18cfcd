"""Make the nb9 fixture with the JAX package, on the CPU: Naive Bayes over
a schema with a Gaussian field, in every predictor output mode, the text
mode, the knn.sh class-conditional pipeline and a served registry version.

The schema (``schema.json``) is ``tests/test_knn_pipeline_full.py``'s two
bucketed fields (score, hours) plus one unbucketed int field (absences),
so the model file carries the continuous posterior and prior lines.  The
records are drawn with numpy from SEED: ``data/tr_part`` (TRAIN_ROWS) and
``data/test_part`` (TEST_ROWS), a few test values past the bucketed
alphabets (skipped by the predictor).

  model.csv          bayesianDistribution over data/tr_part
  pred.csv           bayesianPredictor over data/test_part: argmax, percent
  pred_cost.csv      ... with bap.predict.class.cost=COSTS
  pred_diff.csv      ... with bap.class.prob.diff.threshold=DIFF
  cond_prob.csv      ... over data/tr_part, bap.output.feature.prob.only
  joined.sha256      featureCondProbJoiner over cond_prob.csv and
                     sameTypeSimilarity's distance lines (the digest of
                     its part-r-00000 and its line count: the file holds
                     a line a train x test pair)
  nn_pred.csv        nearestNeighbor, nen.class.condition.weighted
  knn_pred.csv       knnPipeline over the same records (the fused job has
                     no class-conditional weighting: the plain vote)
  text/train.txt, text/test.txt
  text/model.csv     bayesianDistribution in text mode
  text/pred.csv      bayesianPredictor in text mode over text/test.txt
  registry/nb9/v_000001   the tabular model, ModelRegistry.publish
  served.csv         predictionService (ps.transport=inprocess) over
                     data/test_part
  counters.json      the jobs' Distribution Data, Validation and Join
                     counter groups

The port (``avenir_tpu_torch``) is held against these files on the CPU by
``tests/test_torch_bayes_slice.py`` and on the GPU by ``chip_smoke.py``.
Regenerate from the repo root (the test reruns it into a temporary
directory and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/nb9/make.py
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))

MODEL_NAME = "nb9"
SEED = 9
TRAIN_ROWS = 260
TEST_ROWS = 60
COSTS = "3,2"
DIFF = 30
SCHEMA = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "score", "ordinal": 1, "dataType": "int", "feature": True,
         "min": 0, "max": 99, "bucketWidth": 20},
        {"name": "hours", "ordinal": 2, "dataType": "int", "feature": True,
         "min": 0, "max": 39, "bucketWidth": 8},
        {"name": "absences", "ordinal": 3, "dataType": "int",
         "feature": True, "min": 0, "max": 40},
        {"name": "outcome", "ordinal": 4, "dataType": "categorical",
         "cardinality": ["fail", "pass"]},
    ]
}
# keys of the knn.sh flow (test_knn_pipeline_full.py), paths appended;
# knnPipeline takes them without the class-conditional weighting
KNN_KEYS = ("-Dsts.distance.scale=1000", "-Dnen.top.match.count=7",
            "-Dnen.class.attribute.values=fail,pass",
            "-Dnen.validation.mode=true")
WEIGHTED = "-Dnen.class.condition.weighted=true"
COUNTER_GROUPS = ("Distribution Data", "Validation", "Join")
TOPICS = {
    "sports": ("goal", "match", "team", "coach", "league", "score",
               "striker", "o'neill's", "season", "3.5", "final"),
    "tech": ("server", "kernel", "gpu", "compiler", "cache", "latency",
             "example.com", "c++", "runtime", "v2.1", "thread"),
    "food": ("recipe", "bake", "flour", "oven", "café", "spice", "don't",
             "dinner", "sauce", "bread", "salt"),
}
FILLER = ("the", "a", "and", "is", "of", "to", "with", "really", "new")


def records(rng, n, prefix, far=()):
    """``n`` lines of the schema; a pass skews to high score, hours and few
    absences.  Rows in ``far`` get a score past the bucketed alphabet."""
    lines = []
    for i in range(n):
        good = rng.random() < 0.5
        score = int(np.clip(rng.normal(72 if good else 38, 14), 0, 99))
        hours = int(np.clip(rng.normal(26 if good else 13, 6), 0, 39))
        absences = int(np.clip(rng.normal(4 if good else 11, 4), 0, 40))
        if i in far:
            score = 150 + 40 * i
        lines.append(f"{prefix}{i:04d},{score},{hours},{absences},"
                     f"{'pass' if good else 'fail'}")
    return lines


def documents(rng, n):
    """``text,label`` lines: words of one topic with filler and a few
    words of another."""
    names = sorted(TOPICS)
    lines = []
    for _ in range(n):
        label = names[rng.integers(len(names))]
        other = names[rng.integers(len(names))]
        words = list(rng.choice(TOPICS[label], 6)) \
            + list(rng.choice(FILLER, 3)) + list(rng.choice(TOPICS[other], 1))
        rng.shuffle(words)
        text = " ".join(words).capitalize()
        lines.append(f"{text},{label}")
    return lines


def write_lines(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def digest(path):
    with open(path, "rb") as fh:
        data = fh.read()
    return f"{hashlib.sha256(data).hexdigest()} {data.count(b'\n')}\n"


def counter_groups(path):
    with open(path) as fh:
        counters = json.load(fh)
    return {g: counters[g] for g in COUNTER_GROUPS if g in counters}


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.cli import run as cli_run
    from avenir_tpu.core.schema import FeatureSchema
    from avenir_tpu.core.table import load_csv
    from avenir_tpu.models import bayes
    from avenir_tpu.serving.registry import ModelRegistry
    rng = np.random.default_rng(SEED)
    schema_path = os.path.join(out_dir, "schema.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(schema_path, "w") as fh:
        json.dump(SCHEMA, fh, indent=2)
        fh.write("\n")
    train = os.path.join(out_dir, "data", "tr_part")
    test = os.path.join(out_dir, "data", "test_part")
    write_lines(train, records(rng, TRAIN_ROWS, "tr"))
    write_lines(test, records(rng, TEST_ROWS, "te", far=(3, 17)))
    write_lines(os.path.join(out_dir, "text", "train.txt"),
                documents(rng, 90))
    write_lines(os.path.join(out_dir, "text", "test.txt"),
                documents(rng, 30))
    counters = {}
    with tempfile.TemporaryDirectory() as work:
        def run(job, args, inp, name, part):
            out = os.path.join(work, name)
            assert cli_run.main([job, *args, inp, out]) == 0
            counters[name] = counter_groups(out + ".counters.json")
            return os.path.join(out, part)

        def keep(src, name):
            dest = os.path.join(out_dir, name)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copyfile(src, dest)

        model = run("bayesianDistribution",
                    [f"-Dbad.feature.schema.file.path={schema_path}"],
                    train, "model", "part-r-00000")
        keep(model, "model.csv")
        bap = [f"-Dbap.feature.schema.file.path={schema_path}",
               f"-Dbap.bayesian.model.file.path={model}"]
        for name, extra, inp in (
                ("pred", [], test),
                ("pred_cost", [f"-Dbap.predict.class.cost={COSTS}"], test),
                ("pred_diff", [f"-Dbap.class.prob.diff.threshold={DIFF}"],
                 test),
                ("cond_prob", ["-Dbap.output.feature.prob.only=true"],
                 train)):
            keep(run("bayesianPredictor", bap + extra, inp, name,
                     "part-m-00000"), f"{name}.csv")
        dist = run("sameTypeSimilarity",
                   [f"-Dsts.same.schema.file.path={schema_path}"],
                   os.path.dirname(train), "dist",
                   "part-r-00000")
        join_in = os.path.join(work, "join_in")
        os.makedirs(join_in)
        shutil.copyfile(os.path.join(out_dir, "cond_prob.csv"),
                        os.path.join(join_in, "condProb_part"))
        shutil.copyfile(dist, os.path.join(join_in, "neighbors"))
        joined = run("featureCondProbJoiner", [], join_in, "joined",
                     "part-r-00000")
        with open(os.path.join(out_dir, "joined.sha256"), "w") as fh:
            fh.write(digest(joined))
        keep(run("nearestNeighbor", [*KNN_KEYS, WEIGHTED],
                 os.path.dirname(joined), "nn", "part-r-00000"),
             "nn_pred.csv")
        keep(run("knnPipeline",
                 [f"-Dsts.same.schema.file.path={schema_path}", *KNN_KEYS],
                 os.path.dirname(train), "knn", "part-r-00000"),
             "knn_pred.csv")
        text_model = run("bayesianDistribution", [],
                         os.path.join(out_dir, "text", "train.txt"),
                         "text_model", "part-r-00000")
        keep(text_model, os.path.join("text", "model.csv"))
        keep(run("bayesianPredictor",
                 [f"-Dbap.bayesian.model.file.path={text_model}"],
                 os.path.join(out_dir, "text", "test.txt"), "text_pred",
                 "part-m-00000"), os.path.join("text", "pred.csv"))
        registry_dir = os.path.join(out_dir, "registry")
        shutil.rmtree(registry_dir, ignore_errors=True)
        schema = FeatureSchema.load(schema_path)
        nb = bayes.train(load_csv(train, schema))
        ModelRegistry(registry_dir).publish(MODEL_NAME, nb, schema=schema)
        keep(run("org.avenir.serving.PredictionService",
                 [f"-Dps.model.registry.dir={registry_dir}",
                  f"-Dps.model.name={MODEL_NAME}",
                  "-Dps.transport=inprocess"], test, "served",
                 "part-m-00000"), "served.csv")
    with open(os.path.join(out_dir, "counters.json"), "w") as fh:
        json.dump(counters, fh, indent=2, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
