"""Make the lr9 fixture with the JAX package, on the CPU: logistic
regression end to end over churn records.

The records are ``resource/gen/churn_svm_gen.py``'s model under
``resource/churn_svm.json`` (three integer features, ``status``
active/churned): TRAIN_ROWS rows with seed TRAIN_SEED (``train.csv``) and
TEST_ROWS rows with seed TEST_SEED (``test.csv``).  The jobs:

  coeff.txt, train/part-r-00000   logisticRegression with KEYS
                                  (averageBelowThreshold): one history
                                  line an iteration, the final weights
  resume/coeff.txt                logisticRegression again from the first
                                  RESUME_LINES lines of coeff.txt
  pred/part-m-00000               logisticRegressionPredictor
                                  (validation.mode=true) over test.csv
  registry/                       the final weights published as the
                                  ``logistic`` version lr9 v1
  served.csv                      predictionService (ps.transport=
                                  inprocess) over test.csv from it
  counters.json                   the jobs' Regression and Validation
                                  counter groups

The JAX package shards a table whose row count its device count divides
over its devices, which changes the order of the gradient sums; the
training jobs run in a child process on one CPU device, so the files do
not depend on the device count of the process that calls :func:`make`.
The port (``avenir_tpu_torch``) is held against these files on the CPU by
``tests/test_torch_logistic.py`` and on the GPU by ``chip_smoke.py``.
Regenerate from the repo root (the test reruns it into a temporary
directory and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/lr9/make.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
SCHEMA = os.path.join(RES, "churn_svm.json")

MODEL_NAME = "lr9"
TRAIN_ROWS, TRAIN_SEED = 2000, 9
TEST_ROWS, TEST_SEED = 302, 10
RESUME_LINES = 3
POSITIVE = "churned"
KEYS = (f"-Dfeature.schema.file.path={SCHEMA}",
        f"-Dpositive.class.value={POSITIVE}",
        "-Dlearning.rate=0.001",
        "-Dconvergence.criteria=averageBelowThreshold",
        "-Dconvergence.threshold=0.5")
COUNTER_GROUPS = ("Regression", "Validation")


def records(n, seed):
    sys.path.insert(0, RES)
    from gen.churn_svm_gen import generate
    return generate(n, seed)


def write_lines(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def counter_groups(path):
    with open(path) as fh:
        counters = json.load(fh)
    return {g: counters[g] for g in COUNTER_GROUPS if g in counters}


def run_job(args):
    """One JAX CLI job in a child process on one CPU device."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    code = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            f"sys.path.insert(0, {ROOT!r}); "
            "from avenir_tpu.cli import run; "
            "sys.exit(run.main(sys.argv[1:]))")
    subprocess.run([sys.executable, "-c", code, *args], env=env,
                   check=True, capture_output=True)


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.core.schema import FeatureSchema
    from avenir_tpu.regress.logistic import parse_history
    from avenir_tpu.serving.registry import ModelRegistry
    os.makedirs(out_dir, exist_ok=True)
    train = os.path.join(out_dir, "train.csv")
    test = os.path.join(out_dir, "test.csv")
    write_lines(train, records(TRAIN_ROWS, TRAIN_SEED))
    write_lines(test, records(TEST_ROWS, TEST_SEED))
    counters = {}
    with tempfile.TemporaryDirectory() as work:
        def run(job, args, inp, name):
            out = os.path.join(work, name)
            run_job([job, *args, inp, out])
            counters[name] = counter_groups(out + ".counters.json")
            dest = os.path.join(out_dir, name)
            shutil.rmtree(dest, ignore_errors=True)
            shutil.copytree(out, dest)

        coeff = os.path.join(out_dir, "coeff.txt")
        if os.path.exists(coeff):
            os.remove(coeff)
        run("logisticRegression", [*KEYS, f"-Dcoeff.file.path={coeff}"],
            train, "train")
        with open(coeff) as fh:
            head = fh.read().splitlines()[:RESUME_LINES]
        resumed = os.path.join(out_dir, "resume", "coeff.txt")
        write_lines(resumed, head)
        run("logisticRegression", [*KEYS, f"-Dcoeff.file.path={resumed}"],
            train, "resume_train")
        shutil.rmtree(os.path.join(out_dir, "resume_train"))
        run("logisticRegressionPredictor",
            [*KEYS, f"-Dcoeff.file.path={coeff}", "-Dvalidation.mode=true"],
            test, "pred")
        registry_dir = os.path.join(out_dir, "registry")
        shutil.rmtree(registry_dir, ignore_errors=True)
        with open(coeff) as fh:
            w = parse_history(fh.read().splitlines())[-1]
        ModelRegistry(registry_dir).publish(
            MODEL_NAME, w, schema=FeatureSchema.load(SCHEMA),
            params={"pos_class_value": POSITIVE})
        run("org.avenir.serving.PredictionService",
            [f"-Dps.model.registry.dir={registry_dir}",
             f"-Dps.model.name={MODEL_NAME}", "-Dps.transport=inprocess"],
            test, "served")
    with open(os.path.join(out_dir, "counters.json"), "w") as fh:
        json.dump(counters, fh, indent=2, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
