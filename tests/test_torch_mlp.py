"""The MLP in the port (``avenir_tpu_torch/nn/mlp.py``, the
``neuralNetwork`` / ``neuralNetworkPredictor`` jobs, the registry's
``mlp`` kind and ``MLPPredictor``) against the JAX package, on the CPU.

What is bit for bit: the initial parameters and every epoch's permutation
(both drawn through the threefry twin, ``utils/threefry.py``), and a
checkpointed run against an unchunked one inside each package.

What is held to a tolerance, and why it is small only early: XLA's CPU
``tanh``, ``log_softmax`` and the gradient's 2,000-row sums round
differently from torch's, so one step agrees to float32 rounding
(STEP_RTOL), and A5_ITERS batch steps, and the short incr and minibatch
runs of the fixture's SHORT (3 epochs each, over 48 and 120 rows), to
A5_RTOL of each array's largest value, the validation-loss history
too.  The reference's plain gradient descent over 2,000 unscaled churn
rows at lr 0.01 (the job's defaults) is chaotic: that first-step
difference of ~1e-5 grows to ~1e-2 by step 10 and to order one by step
100, so the 1,000-iteration mlp9 cases a-d share the JAX package's draws,
loss grid and file layout but not its trained digits: each test prints
how many of the model file's ``repr(float)`` strings differ (all of them,
at 1,000 iterations).  The predictor and the served ``mlp`` version run
the JAX package's trained models, where only the forward pass differs:
labels equal on every row whose top two logits are more than LOGIT_ATOL
apart, ``probs`` percent strings counted.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
from avenir_tpu.nn import mlp as J
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv
from avenir_tpu_torch.nn import mlp
from avenir_tpu_torch.serving.predictor import MLPPredictor, make_predictor
from avenir_tpu_torch.serving.registry import MLP, ModelRegistry
from avenir_tpu_torch.utils import threefry as tf

TESTS = os.path.dirname(os.path.abspath(__file__))
MLP9 = os.path.join(TESTS, "torch_fixtures", "mlp9")
CPU = "-Dplatform=cpu"
STEP_RTOL = 1e-5
A5_RTOL = 1e-4
LOGIT_ATOL = 1e-4


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "mlp9_make", os.path.join(MLP9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()
SCHEMA = FeatureSchema.load(MAKE.SCHEMA)


@pytest.fixture(autouse=True)
def cpu_default():
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    yield
    set_default_device(None)


def _read(path):
    with open(path) as fh:
        return fh.read()


def _draws():
    with np.load(os.path.join(MLP9, "draws.npz")) as z:
        return {k: z[k] for k in z.files}


def _xy(path):
    t = load_csv(path, SCHEMA)
    X = t.feature_matrix(dtype=np.float32)
    y = np.asarray(t.class_codes()).astype(np.int64)
    return X[y >= 0], y[y >= 0]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _strings_apart(got_lines, want_lines):
    diff = total = 0
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        gf, wf = g.split(","), w.split(",")
        assert len(gf) == len(wf)
        diff += sum(a != b for a, b in zip(gf, wf))
        total += len(gf)
    return diff, total


# --------------------------------------------------------------------------
# counterparts of tests/test_nn.py
# --------------------------------------------------------------------------

def make_moons(n=200, noise=0.15, seed=0):
    rng = np.random.default_rng(seed)
    n2 = n // 2
    t = rng.random(n2) * np.pi
    x_outer = np.c_[np.cos(t), np.sin(t)]
    x_inner = np.c_[1.0 - np.cos(t), 0.5 - np.sin(t)]
    X = np.vstack([x_outer, x_inner]) + rng.normal(0, noise, (n, 2))
    y = np.r_[np.zeros(n2, int), np.ones(n2, int)]
    return X.astype(np.float32), y


def _accuracy(params, X, y):
    return float((mlp.predict(params, torch.from_numpy(X)).numpy()
                  == y).mean())


def test_batch_mode_learns_moons():
    X, y = make_moons(240)
    cfg = mlp.MLPConfig(hidden_dim=6, learning_rate=0.01, iterations=800,
                        validation_interval=100)
    params, losses = mlp.train(X, y, cfg)
    assert _accuracy(params, X, y) > 0.9
    assert losses[-1] < losses[0]


def test_incr_mode_learns():
    X, y = make_moons(80, noise=0.08)
    cfg = mlp.MLPConfig(hidden_dim=8, learning_rate=0.1, reg_lambda=0.001,
                        iterations=50, mode="incr", validation_interval=5)
    params, _ = mlp.train(X, y, cfg)
    assert _accuracy(params, X, y) > 0.9


def test_minibatch_mode_learns():
    X, y = make_moons(200)
    cfg = mlp.MLPConfig(hidden_dim=6, learning_rate=0.02, iterations=40,
                        mode="minibatch", batch_size=32)
    params, _ = mlp.train(X, y, cfg)
    assert _accuracy(params, X, y) > 0.9


def test_validation_split_used():
    X, y = make_moons(200)
    Xv, yv = make_moons(60, seed=9)
    cfg = mlp.MLPConfig(hidden_dim=4, iterations=100, validation_interval=10)
    _, losses = mlp.train(X, y, cfg, X_val=Xv, y_val=yv)
    assert len(losses) == 10


def test_serialization_roundtrip():
    X, y = make_moons(100)
    params, _ = mlp.train(X, y, mlp.MLPConfig(hidden_dim=3, iterations=50))
    back = mlp.from_lines(mlp.to_lines(params))
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(), back[k].numpy())
    # the JAX package reads the port's lines to the same float32 values
    jback = J.from_lines(mlp.to_lines(params))
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jback[k]))


def test_ensemble_votes():
    X, y = make_moons(160)
    cfg = mlp.MLPConfig(hidden_dim=6, learning_rate=0.01, iterations=500)
    stacked = mlp.train_ensemble(X, y, cfg, seeds=[0, 1, 2])
    assert stacked["W1"].shape[0] == 3
    pred = mlp.ensemble_predict(stacked, X).numpy()
    assert (pred == y).mean() > 0.9


def test_invalid_mode_raises():
    X, y = make_moons(40)
    with pytest.raises(ValueError):
        mlp.train(X, y, mlp.MLPConfig(mode="bogus"))


def test_matches_numpy_oracle_one_step():
    """One batch step equals the reference's hand-written backprop
    (basic_nn.py:134-160) computed in numpy."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(16, 2)).astype(np.float32)
    y = rng.integers(0, 2, 16)
    cfg = mlp.MLPConfig(hidden_dim=3, learning_rate=0.05, reg_lambda=0.02)
    p0 = mlp.init_params(2, cfg)
    W1, b1 = p0["W1"].double().numpy(), p0["b1"].double().numpy()
    W2, b2 = p0["W2"].double().numpy(), p0["b2"].double().numpy()
    a1 = np.tanh(X @ W1 + b1)
    scores = np.exp(a1 @ W2 + b2)
    probs = scores / scores.sum(axis=1, keepdims=True)
    d3 = probs.copy()
    d3[np.arange(16), y] -= 1
    dW2 = a1.T @ d3 + cfg.reg_lambda * W2
    db2 = d3.sum(axis=0)
    d2 = (d3 @ W2.T) * (1 - a1 ** 2)
    dW1 = X.T @ d2 + cfg.reg_lambda * W1
    db1 = d2.sum(axis=0)
    p1 = mlp._grad_step(p0, torch.from_numpy(X), torch.from_numpy(y),
                        cfg.learning_rate, cfg.reg_lambda)
    for k, want in (("W1", W1 - cfg.learning_rate * dW1),
                    ("W2", W2 - cfg.learning_rate * dW2),
                    ("b1", b1 - cfg.learning_rate * db1),
                    ("b2", b2 - cfg.learning_rate * db2)):
        np.testing.assert_allclose(p1[k].numpy(), want, atol=1e-5)


# --------------------------------------------------------------------------
# counterparts of tests/test_nn_jobs.py
# --------------------------------------------------------------------------

JOB_SCHEMA = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "x1", "ordinal": 1, "dataType": "double", "feature": True},
        {"name": "x2", "ordinal": 2, "dataType": "double", "feature": True},
        {"name": "label", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["neg", "pos"]},
    ]
}


def gen_csv(path, n=240, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        pos = rng.random() < 0.5
        cx = 1.5 if pos else -1.5
        x1, x2 = rng.normal(cx, 1.0), rng.normal(cx, 1.0)
        lines.append(f"r{i},{x1:.4f},{x2:.4f},{'pos' if pos else 'neg'}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def test_nn_train_predict_pipeline(tmp_path):
    schema = tmp_path / "nn.json"
    schema.write_text(json.dumps(JOB_SCHEMA))
    train_csv = tmp_path / "train.csv"
    gen_csv(str(train_csv))
    model_file = tmp_path / "nn_model.csv"
    props = tmp_path / "nn.properties"
    props.write_text(f"""
field.delim.regex=,
feature.schema.file.path={schema}
nn.hidden.units=4
nn.iteration.count=300
nn.learning.rate=0.01
nn.training.mode=batch
nn.model.file.path={model_file}
""")
    assert port_run.main(["neuralNetwork", CPU, f"-Dconf.path={props}",
                          str(train_csv), str(tmp_path / "model_out")]) == 0
    assert model_file.exists()
    assert port_run.main(["neuralNetworkPredictor", CPU,
                          f"-Dconf.path={props}", str(train_csv),
                          str(tmp_path / "pred_out")]) == 0
    out_lines = (tmp_path / "pred_out" / "part-m-00000").read_text() \
        .splitlines()
    assert len(out_lines) == 240
    correct = sum(1 for ln in out_lines
                  if ln.split(",")[3] == ln.split(",")[4])
    assert correct / len(out_lines) > 0.9


def test_nn_incr_mode_via_cli(tmp_path):
    schema = tmp_path / "nn.json"
    schema.write_text(json.dumps(JOB_SCHEMA))
    train_csv = tmp_path / "train.csv"
    gen_csv(str(train_csv), n=100)
    props = tmp_path / "nn.properties"
    props.write_text(f"""
field.delim.regex=,
feature.schema.file.path={schema}
nn.hidden.units=3
nn.iteration.count=5
nn.learning.rate=0.02
nn.training.mode=incr
""")
    assert port_run.main(["org.avenir.supv.NeuralNetworkTrainer", CPU,
                          f"-Dconf.path={props}", str(train_csv),
                          str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "part-r-00000").exists()


# --------------------------------------------------------------------------
# bit for bit: the draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("F,H,C,seed", [(3, 3, 2, 0), (17, 6, 3, 7),
                                        (2, 8, 2, 2 ** 31 + 5)])
def test_init_params_bit_identical(F, H, C, seed):
    want = J.init_params(F, J.MLPConfig(hidden_dim=H, n_classes=C,
                                        seed=seed))
    got = mlp.init_params(F, mlp.MLPConfig(hidden_dim=H, n_classes=C,
                                           seed=seed))
    for k in mlp.NAMES:
        assert np.array_equal(got[k].numpy().view(np.int32),
                              np.asarray(want[k]).view(np.int32)), k


def test_mlp9_draws_bit_identical():
    """Case a's initial parameters and case b's first two epoch
    permutations (n = 2,000) equal the fixture's."""
    d = _draws()
    X, _ = _xy(MAKE.TRAIN)
    p = mlp.init_params(X.shape[1], mlp.MLPConfig())
    for k in mlp.NAMES:
        assert np.array_equal(p[k].numpy().view(np.int32),
                              d[f"init_{k}"].view(np.int32)), k
    key = tf.PRNGKey(1, "cpu")
    for e in range(2):
        key, sub = tf.split(key, 2)
        assert np.array_equal(tf.permutation(sub, len(X)).numpy(),
                              d[f"perm_{e}"])


def test_ensemble_seed_keys_are_uint32():
    """train_ensemble's PRNGKey of a uint32 seed at and above 2^31 is
    jax's vmapped PRNGKey."""
    seeds = np.array([0, 2 ** 31, 2 ** 32 - 1], np.uint32)
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(seeds)).astype(np.int64)
    got = np.stack([tf.PRNGKey(int(s), "cpu").numpy() for s in seeds])
    assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# to a tolerance: training
# --------------------------------------------------------------------------

def test_one_step_within_float32_rounding():
    X, y = _xy(MAKE.TRAIN)
    cfg = J.MLPConfig(hidden_dim=3, iterations=1, validation_interval=1000)
    want, wl = J.train(X, y.astype(np.int32), cfg)
    got, gl = mlp.train(X, y, mlp.MLPConfig(**cfg.__dict__))
    for k in mlp.NAMES:
        assert _rel(got[k].numpy(), want[k]) <= STEP_RTOL, k
    assert _rel(gl, wl) <= STEP_RTOL


def test_mlp9_first_iterations_within_tolerance():
    d = _draws()
    X, y = _xy(MAKE.TRAIN)
    got, _ = mlp.train(X, y, mlp.MLPConfig(iterations=MAKE.A5_ITERS))
    rels = {k: _rel(got[k].numpy(), d[f"a5_{k}"]) for k in mlp.NAMES}
    print(f"after {MAKE.A5_ITERS} batch iterations: {rels}")
    assert max(rels.values()) <= A5_RTOL


def test_mlp9_ensemble_within_tolerance():
    d = _draws()
    X, y = _xy(MAKE.TRAIN)
    Xt, _ = _xy(MAKE.TEST)
    ens = mlp.train_ensemble(X, y, mlp.MLPConfig(
        iterations=MAKE.ENSEMBLE_ITERS), MAKE.ENSEMBLE_SEEDS)
    for k in mlp.NAMES:
        assert ens[k].shape == d[f"ens_{k}"].shape
        assert _rel(ens[k].numpy(), d[f"ens_{k}"]) <= A5_RTOL, k
    assert np.array_equal(mlp.ensemble_predict(ens, Xt).numpy(),
                          d["ens_pred"])


@pytest.mark.parametrize("mode", sorted(MAKE.SHORT))
def test_mlp9_shuffled_modes_within_tolerance(mode):
    """incr and minibatch against the JAX package's, live: the same
    epoch permutations, one step an example or a batch of 16 (the
    partial batch dropped), the validation loss after every epoch
    sampled every 2; the parameters and the loss history within A5_RTOL
    over a horizon short enough that the descent has not spread the two
    packages' roundings."""
    rows, kw = MAKE.SHORT[mode]
    X, y = _xy(MAKE.TRAIN)
    Xv, yv = _xy(MAKE.TEST)
    want, wl = J.train(X[:rows], y[:rows].astype(np.int32),
                       J.MLPConfig(**kw), X_val=Xv,
                       y_val=yv.astype(np.int32))
    got, gl = mlp.train(X[:rows], y[:rows], mlp.MLPConfig(**kw),
                        X_val=Xv, y_val=yv)
    rels = {k: _rel(got[k].numpy(), want[k]) for k in mlp.NAMES}
    print(f"{mode} over {rows} rows, {kw['iterations']} epochs: {rels}, "
          f"loss {_rel(gl, wl):.3g}")
    assert max(rels.values()) <= A5_RTOL
    assert len(gl) == len(wl)
    assert _rel(gl, wl) <= A5_RTOL


def _train_case(tmp_path, case, runs):
    out = str(tmp_path / case)
    for args in runs:
        shutil.rmtree(out, ignore_errors=True)
        assert port_run.main(["neuralNetwork", CPU, *MAKE.KEYS, *args,
                              MAKE.TRAIN, out]) == 0
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)["NeuralNetwork"]
    return _read(os.path.join(out, "part-r-00000")).splitlines(), counters


@pytest.mark.parametrize("case", ["a", "b", "c"])
def test_mlp9_case_runs_on_the_jax_grid(tmp_path, case):
    """Cases a-c through the port's CLI: the model file's layout and the
    loss grid are the JAX package's; the trained digits part (chaotic
    descent, module docstring), and the test prints how many differ."""
    got, counters = _train_case(tmp_path, case, [MAKE.CASES[case]])
    want = _read(os.path.join(MLP9, case, "model.csv")).splitlines()
    assert [ln for ln in got if ln.startswith("#")] == \
        [ln for ln in want if ln.startswith("#")]
    diff, total = _strings_apart(got, want)
    with open(os.path.join(MLP9, "counters.json")) as fh:
        jc = json.load(fh)[f"{case}/train"]["NeuralNetwork"]
    assert counters["lossEvaluations"] == jc["lossEvaluations"]
    params = mlp.from_lines(got, device="cpu")
    assert all(torch.isfinite(v).all() for v in params.values())
    print(f"mlp9 {case}: {diff} of {total} model strings differ; "
          f"trainAccuracyPct {counters['trainAccuracyPct']} (JAX "
          f"{jc['trainAccuracyPct']}), finalLossE6 "
          f"{counters['finalLossE6']} (JAX {jc['finalLossE6']})")


def test_mlp9_resumed_run_equals_the_unchunked_one(tmp_path):
    """Case d (chunks of 200, stopped at 400, resumed to 1,000) writes the
    port's unchunked case a bit for bit, as the JAX package's d equals its
    a; its final loss and accuracy are a's, and it records the losses of
    the resumed invocation alone, as the JAX package's d does."""
    ckpt = str(tmp_path / "ckpt")
    got_d, cd = _train_case(tmp_path, "d", MAKE.case_d_runs(ckpt))
    got_a, ca = _train_case(tmp_path, "a", [MAKE.CASES["a"]])
    assert _read(os.path.join(MLP9, "a", "model.csv")) == \
        _read(os.path.join(MLP9, "d", "model.csv"))
    assert got_d == got_a
    with open(os.path.join(MLP9, "counters.json")) as fh:
        jd = json.load(fh)["d/train"]["NeuralNetwork"]
    assert cd["lossEvaluations"] == jd["lossEvaluations"]
    assert (cd["finalLossE6"], cd["trainAccuracyPct"]) == \
        (ca["finalLossE6"], ca["trainAccuracyPct"])


# --------------------------------------------------------------------------
# the predictor, the registry kind and serving
# --------------------------------------------------------------------------

def _top_two_gap(params, X):
    logits = mlp.forward_logits(params, torch.from_numpy(X)).numpy()
    s = np.sort(logits, axis=1)
    return s[:, -1] - s[:, -2]


@pytest.mark.parametrize("case", ["a", "b", "c", "d"])
def test_mlp9_predictor_over_the_jax_models(tmp_path, case):
    model = os.path.join(MLP9, case, "model.csv")
    out = str(tmp_path / "pred")
    assert port_run.main(["neuralNetworkPredictor", CPU, *MAKE.KEYS,
                          f"-Dnn.model.file.path={model}", MAKE.TEST,
                          out]) == 0
    got = _read(os.path.join(out, "part-m-00000")).splitlines()
    want = _read(os.path.join(MLP9, case, "pred.csv")).splitlines()
    assert len(got) == len(want)
    X = load_csv(MAKE.TEST, SCHEMA).feature_matrix(dtype=np.float32)
    gap = _top_two_gap(mlp.from_lines(_read(model).splitlines(),
                                     device="cpu"), X)
    labels = probs = 0
    for g, w, d in zip(got, want, gap):
        gf, wf = g.split(","), w.split(",")
        assert gf[:-2] == wf[:-2]
        if d > LOGIT_ATOL:
            assert gf[-2] == wf[-2]
        labels += gf[-2] != wf[-2]
        probs += gf[-1] != wf[-1]
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)["Validation"]
    with open(os.path.join(MLP9, "counters.json")) as fh:
        jc = json.load(fh)[f"{case}/pred"]["Validation"]
    if labels == 0:
        assert counters == jc
    print(f"mlp9 {case} predictor: {labels} labels and {probs} of "
          f"{len(got)} percent strings differ")


def test_mlp_kind_reads_and_writes_across_packages(tmp_path):
    """The JAX package's mlp9 version loads in the port; the port
    publishes the same parameters as the same meta.json bytes and arrays;
    the JAX package loads the port's version."""
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry
    reg = ModelRegistry(os.path.join(MLP9, "registry"))
    loaded = reg.load(MAKE.MODEL_NAME, 1)
    assert loaded.kind == MLP
    params = mlp.from_lines(_read(os.path.join(MLP9, "a", "model.csv"))
                            .splitlines(), device="cpu")
    for k in mlp.NAMES:
        np.testing.assert_array_equal(loaded.model[k], params[k].numpy())
    port_reg = ModelRegistry(str(tmp_path / "port"))
    assert port_reg.publish(MAKE.MODEL_NAME, params, schema=SCHEMA) == 1
    jax_reg = JaxRegistry(str(tmp_path / "jax"))
    jax_reg.publish(MAKE.MODEL_NAME,
                    {k: v.numpy() for k, v in params.items()},
                    schema=JaxSchema.load(MAKE.SCHEMA))
    for other in (jax_reg, reg):
        for f in ("meta.json",):
            assert _read(os.path.join(port_reg.version_dir(
                MAKE.MODEL_NAME, 1), f)) == _read(os.path.join(
                    other.version_dir(MAKE.MODEL_NAME, 1), f))
    back = JaxRegistry(port_reg.base_dir).load(MAKE.MODEL_NAME, 1)
    assert back.kind == "mlp"
    for k in mlp.NAMES:
        np.testing.assert_array_equal(np.asarray(back.model[k]),
                                      params[k].numpy())


def test_mlp_predictor_against_the_trainer():
    loaded = ModelRegistry(os.path.join(MLP9, "registry")).load(
        MAKE.MODEL_NAME, 1)
    pred = make_predictor(loaded, buckets=(8, 64))
    assert isinstance(pred, MLPPredictor)
    rows = [ln.split(",") for ln in _read(MAKE.TEST).splitlines()]
    X = load_csv(MAKE.TEST, SCHEMA).feature_matrix(dtype=np.float32)
    codes = mlp.predict(mlp.to_device(loaded.model, "cpu"),
                        torch.from_numpy(X)).numpy()
    card = SCHEMA.class_attr_field.cardinality
    assert pred.predict_rows(rows) == [card[c] for c in codes]


def test_mlp9_served_lines_match_the_fixture(tmp_path):
    """predictionService over the JAX package's mlp version answers the
    fixture's 302 served lines."""
    reg = str(tmp_path / "registry")
    shutil.copytree(os.path.join(MLP9, "registry"), reg)
    out = str(tmp_path / "served")
    assert port_run.main([
        "org.avenir.serving.PredictionService", CPU,
        f"-Dps.model.registry.dir={reg}",
        f"-Dps.model.name={MAKE.MODEL_NAME}", "-Dps.transport=inprocess",
        MAKE.TEST, out]) == 0
    got = _read(os.path.join(out, "part-m-00000"))
    assert len(got.splitlines()) == 302
    assert got == _read(os.path.join(MLP9, "served.csv"))


def test_make_reproduces_the_fixture(tmp_path):
    """Rerun the JAX package's maker into a temporary directory: every
    file it writes equals the committed one (the .npz by arrays)."""
    out = str(tmp_path / "mlp9")
    MAKE.make(out)
    for root, _, files in os.walk(out):
        for f in files:
            got = os.path.join(root, f)
            want = os.path.join(MLP9, os.path.relpath(got, out))
            if f.endswith(".npz"):
                with np.load(got) as a, np.load(want) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in a.files:
                        assert a[k].dtype == b[k].dtype
                        assert np.array_equal(a[k], b[k])
                continue
            with open(got, "rb") as a, open(want, "rb") as b:
                assert a.read() == b.read(), got
