"""Make the mlp9 fixture with the JAX package, on the CPU: the MLP end to
end over lr9's churn records (``tests/torch_fixtures/lr9/train.csv`` and
``test.csv`` under ``resource/churn_svm.json``, read in place).

  <case>/model.csv        neuralNetwork's model file for each case:
                          a  batch, hidden 3, 1,000 iterations, validation
                             file test.csv (the job's defaults otherwise)
                          b  incr, 20 epochs
                          c  minibatch, batch 64, 50 epochs
                          d  case a as a checkpointed run in chunks of 200:
                             stopped after 400 iterations, then resumed
                             from its checkpoint to 1,000
  <case>/pred.csv         neuralNetworkPredictor over test.csv with the
                          case's model
  registry/               case a's parameters published as the ``mlp``
                          version mlp9 v1
  served.csv              predictionService (ps.transport=inprocess) over
                          test.csv (302 requests) from that version
  draws.npz               init_params of case a (seed 0), the first two
                          epoch permutations of case b, case a's
                          parameters after A5_ITERS batch iterations, and
                          train_ensemble over ENSEMBLE_SEEDS at
                          ENSEMBLE_ITERS iterations with its
                          ensemble_predict labels over test.csv, and
                          the incr and minibatch runs of SHORT (the
                          parameters and the validation-loss history)
  counters.json           the jobs' NeuralNetwork and Validation counters

The training jobs run in a child process on one CPU device.  The port
(``avenir_tpu_torch``) is held against these files on the CPU by
``tests/test_torch_mlp.py`` and on the GPU by ``chip_smoke.py``.
Regenerate from the repo root (the test reruns it into a temporary
directory and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/mlp9/make.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
LR9 = os.path.join(ROOT, "tests", "torch_fixtures", "lr9")
SCHEMA = os.path.join(ROOT, "resource", "churn_svm.json")
TRAIN = os.path.join(LR9, "train.csv")
TEST = os.path.join(LR9, "test.csv")
MODEL_NAME = "mlp9"
KEYS = (f"-Dfeature.schema.file.path={SCHEMA}", "-Dnn.hidden.units=3")
CASES = {
    "a": ("-Dnn.training.mode=batch", "-Dnn.iteration.count=1000",
          f"-Dnn.validation.data.file.path={TEST}"),
    "b": ("-Dnn.training.mode=incr", "-Dnn.iteration.count=20"),
    "c": ("-Dnn.training.mode=minibatch", "-Dnn.batch.size=64",
          "-Dnn.iteration.count=50"),
}
CHUNK, STOP_AT = 200, 400
A5_ITERS = 5
ENSEMBLE_SEEDS = (0, 1, 2, 3)
ENSEMBLE_ITERS = 5
# short incr and minibatch runs over the first rows of train.csv, with
# test.csv for validation: (rows, MLPConfig keys); minibatch's 120 rows
# leave a partial batch of 8 to drop an epoch, and an interval of 2
# keeps epochs 0 and 2 of the loss history
SHORT = {"incr": (48, {"mode": "incr", "iterations": 3,
                       "validation_interval": 2}),
         "minibatch": (120, {"mode": "minibatch", "iterations": 3,
                             "batch_size": 16, "validation_interval": 2})}
COUNTER_GROUPS = ("NeuralNetwork", "Validation")


def case_d_runs(ckpt):
    """The two invocations of case d: to STOP_AT, then to 1,000."""
    base = ("-Dnn.training.mode=batch",
            f"-Dnn.validation.data.file.path={TEST}",
            f"-Dnn.checkpoint.dir.path={ckpt}",
            f"-Dnn.checkpoint.interval={CHUNK}")
    return [(*base, f"-Dnn.iteration.count={STOP_AT}"),
            (*base, "-Dnn.iteration.count=1000")]


def train_xy(path):
    """(X, y) of a CSV as the trainer builds them (unknown labels
    dropped)."""
    from avenir_tpu.core.schema import FeatureSchema
    from avenir_tpu.core.table import load_csv
    t = load_csv(path, FeatureSchema.load(SCHEMA))
    X = t.feature_matrix(dtype=np.float32)
    y = np.asarray(t.class_codes()).astype(np.int32)
    return X[y >= 0], y[y >= 0]


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


def draws():
    import jax
    from avenir_tpu.nn import mlp
    X, y = train_xy(TRAIN)
    Xt, yt = train_xy(TEST)
    cfg = mlp.MLPConfig(hidden_dim=3, n_classes=2)
    out = {f"init_{k}": np.asarray(v)
           for k, v in mlp.init_params(X.shape[1], cfg).items()}
    key = jax.random.PRNGKey(cfg.seed + 1)
    for e in range(2):
        key, sub = jax.random.split(key)
        out[f"perm_{e}"] = np.asarray(jax.random.permutation(sub, len(y)))
    a5, _ = mlp.train(X, y, mlp.MLPConfig(hidden_dim=3, n_classes=2,
                                          iterations=A5_ITERS))
    out.update({f"a5_{k}": np.asarray(v) for k, v in a5.items()})
    ens = mlp.train_ensemble(X, y, mlp.MLPConfig(
        hidden_dim=3, n_classes=2, iterations=ENSEMBLE_ITERS),
        ENSEMBLE_SEEDS)
    out.update({f"ens_{k}": np.asarray(v) for k, v in ens.items()})
    out["ens_pred"] = np.asarray(mlp.ensemble_predict(ens, Xt))
    for mode, (rows, kw) in SHORT.items():
        p, hist = mlp.train(X[:rows], y[:rows], mlp.MLPConfig(
            hidden_dim=3, n_classes=2, **kw), X_val=Xt, y_val=yt)
        out.update({f"{mode}_{k}": np.asarray(v) for k, v in p.items()})
        out[f"{mode}_loss"] = np.asarray(hist)
    return out


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.core.schema import FeatureSchema
    from avenir_tpu.nn import mlp
    from avenir_tpu.serving.registry import ModelRegistry
    os.makedirs(out_dir, exist_ok=True)
    counters = {}
    with tempfile.TemporaryDirectory() as work:
        def keep(src, dest):
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copyfile(src, dest)

        def train(case, runs):
            out = os.path.join(work, case)
            for args in runs:
                shutil.rmtree(out, ignore_errors=True)
                run_job(["neuralNetwork", *KEYS, *args, TRAIN, out])
            counters[f"{case}/train"] = counter_groups(
                out + ".counters.json")
            model = os.path.join(out_dir, case, "model.csv")
            keep(os.path.join(out, "part-r-00000"), model)
            pred = os.path.join(work, case + "_pred")
            run_job(["neuralNetworkPredictor", *KEYS,
                     f"-Dnn.model.file.path={model}", TEST, pred])
            counters[f"{case}/pred"] = counter_groups(
                pred + ".counters.json")
            keep(os.path.join(pred, "part-m-00000"),
                 os.path.join(out_dir, case, "pred.csv"))

        for case, args in CASES.items():
            train(case, [args])
        train("d", case_d_runs(os.path.join(work, "ckpt_d")))
        registry_dir = os.path.join(out_dir, "registry")
        shutil.rmtree(registry_dir, ignore_errors=True)
        with open(os.path.join(out_dir, "a", "model.csv")) as fh:
            params = mlp.from_lines(fh.read().splitlines())
        ModelRegistry(registry_dir).publish(
            MODEL_NAME, {k: np.asarray(v) for k, v in params.items()},
            schema=FeatureSchema.load(SCHEMA))
        served = os.path.join(work, "served")
        run_job(["org.avenir.serving.PredictionService",
                 f"-Dps.model.registry.dir={registry_dir}",
                 f"-Dps.model.name={MODEL_NAME}", "-Dps.transport=inprocess",
                 TEST, served])
        keep(os.path.join(served, "part-m-00000"),
             os.path.join(out_dir, "served.csv"))
    np.savez(os.path.join(out_dir, "draws.npz"), **draws())
    with open(os.path.join(out_dir, "counters.json"), "w") as fh:
        json.dump(counters, fh, indent=2, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
