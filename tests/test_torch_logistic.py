"""Logistic regression in the port (``avenir_tpu_torch/regress``, the
``logisticRegression`` / ``logisticRegressionPredictor`` jobs, the
registry's ``logistic`` kind and ``LogisticPredictor``) against the JAX
package, on the CPU.

The lr9 fixture (``tests/torch_fixtures/lr9/make.py``) holds the JAX
package's coefficient history over 2,000 churn rows (864 iterations under
``averageBelowThreshold``), a resume from its first three lines, the
predictor's lines and a served ``logistic`` registry version.

The JAX package's step is jitted XLA float32, the port's plain torch
float32: the two round differently in the last bits (XLA sums the
gradient's 2,000 products in eight-lane partial sums and computes its
``exp`` as a Cephes polynomial; torch's ``matmul`` and ``sigmoid`` take
other orders and roundings), and the iterations carry the differences
on.  So every line of the coefficient history is held to HISTORY_RTOL
relative to the line's largest coefficient (a coefficient passing near
zero has no relative error to speak of), and the predictor's labels
are held equal on every row whose ``|p - 0.5|`` exceeds PROBA_ATOL, its
probabilities within PROBA_ATOL.
Each test prints how many of the printed strings differ (``.9g``
coefficients, ``.3f`` probabilities).  Computing ``p`` the XLA way
(``utils/xla_math.xla_exp_f32`` over an FMA-ordered dot) does not bring
the strings to equality
(``test_xla_sigmoid_does_not_close_the_history``), so the port keeps
torch's ``sigmoid``.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

from avenir_tpu.regress import logistic as JLR
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv
from avenir_tpu_torch.regress import logistic as LR
from avenir_tpu_torch.serving.predictor import (LogisticPredictor,
                                                make_predictor)
from avenir_tpu_torch.serving.registry import LOGISTIC, ModelRegistry

TESTS = os.path.dirname(os.path.abspath(__file__))
LR9 = os.path.join(TESTS, "torch_fixtures", "lr9")
CPU = "-Dplatform=cpu"
HISTORY_RTOL = 1e-5
PROBA_ATOL = 1e-6


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "lr9_make", os.path.join(LR9, "make.py"))
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


def _history(path):
    return _read(path).splitlines()


def _strings_apart(got, want):
    """(differing comma-separated fields, fields) of two line lists."""
    diff = total = 0
    for g, w in zip(got, want):
        gf, wf = g.split(","), w.split(",")
        assert len(gf) == len(wf)
        diff += sum(a != b for a, b in zip(gf, wf))
        total += len(gf)
    return diff, total


def assert_history_close(got, want):
    assert len(got) == len(want)
    a = np.array([[float(v) for v in ln.split(",")] for ln in got])
    b = np.array([[float(v) for v in ln.split(",")] for ln in want])
    rel = np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)
    assert rel.max() <= HISTORY_RTOL, (int(rel.argmax()), rel.max())
    diff, total = _strings_apart(got, want)
    print(f"coefficient history: within {rel.max():.3g} per line; {diff} "
          f"of {total} .9g strings differ")
    return diff


def _train(tmp_path, coeff, extra=()):
    out = str(tmp_path / "train_out")
    shutil.rmtree(out, ignore_errors=True)
    assert port_run.main(["logisticRegression", CPU, *MAKE.KEYS,
                          f"-Dcoeff.file.path={coeff}", *extra,
                          os.path.join(LR9, "train.csv"), out]) == 0
    return out


# --------------------------------------------------------------------------
# the step and the criteria
# --------------------------------------------------------------------------

def test_gradient_step_oracle():
    """One step from a nonzero w equals the float64 ascent oracle
    ``w + lr * X^T (y - sigmoid(X w)) / n`` and the JAX package's step,
    within float32 rounding."""
    table = load_csv(os.path.join(LR9, "train.csv"), SCHEMA)
    params = LR.LogisticParams("churned", learning_rate=0.001, l2=0.5)
    X, y = LR.design_matrix(table, SCHEMA, "churned")
    w = np.array([0.02, -0.01, -0.008, 0.2])
    import torch
    got, ll = LR.step(w, torch.from_numpy(X), torch.from_numpy(y), params)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-(X64 @ w)))
    want = w + 0.001 * (X64.T @ (y64 - p) - 0.5 * w) / len(y)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ll_want = -np.mean(y64 * np.log(p + 1e-7)
                       + (1 - y64) * np.log(1 - p + 1e-7))
    assert ll == pytest.approx(ll_want, rel=1e-5)
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    from avenir_tpu.core.table import load_csv as jax_load_csv
    jschema = JaxSchema.load(MAKE.SCHEMA)
    trainer = JLR.LogisticTrainer(jschema, JLR.LogisticParams(
        "churned", learning_rate=0.001, l2=0.5))
    jX, jy = trainer.design_matrix(
        jax_load_csv(os.path.join(LR9, "train.csv"), jschema))
    assert np.array_equal(jX, X) and np.array_equal(jy, y)
    jw, jll = trainer.step(w, jX, jy)
    np.testing.assert_allclose(got, jw, rtol=1e-6)
    assert ll == pytest.approx(jll, rel=1e-6)


@pytest.mark.parametrize("crit", [LR.ITER_LIMIT, LR.ALL_BELOW_THRESHOLD,
                                  LR.AVERAGE_BELOW_THRESHOLD])
def test_convergence_criteria_match_the_jax_package(crit):
    hist = [np.array([1.0, 2.0, -3.0]), np.array([1.02, 2.5, -3.01]),
            np.array([1.021, 2.52, -3.0101])]
    for n in range(len(hist) + 1):
        for th in (0.1, 1.0, 5.0):
            p = LR.LogisticParams("x", convergence_criteria=crit,
                                  iteration_limit=2,
                                  convergence_threshold=th)
            jp = JLR.LogisticParams("x", convergence_criteria=crit,
                                    iteration_limit=2,
                                    convergence_threshold=th)
            assert LR.check_convergence(hist[:n], p) == \
                JLR.check_convergence(hist[:n], jp)
    np.testing.assert_array_equal(LR.percent_diff(hist[0], hist[1]),
                                  JLR.percent_diff(hist[0], hist[1]))
    with pytest.raises(ValueError, match="invalid convergence"):
        LR.check_convergence(hist, LR.LogisticParams(
            "x", convergence_criteria="bogus"))


def test_history_format_parse_roundtrip():
    w = np.array([0.0412925854, -0.0118318442, 1e-30, -2.5])
    line = LR.format_coefficients(w)
    assert line == JLR.format_coefficients(w)
    assert LR.parse_history([line, "", line])[1].tolist() == \
        JLR.parse_history([line, line])[1].tolist()


# --------------------------------------------------------------------------
# lr9: the port against the JAX package
# --------------------------------------------------------------------------

def test_lr9_history_within_tolerance(tmp_path):
    coeff = str(tmp_path / "coeff.txt")
    out = _train(tmp_path, coeff)
    got = _history(coeff)
    assert_history_close(got, _history(os.path.join(LR9, "coeff.txt")))
    # the final weights are the history's last line, and the counters
    # are the fixture's
    assert _read(os.path.join(out, "part-r-00000")).strip() == got[-1]
    import json
    want = json.loads(_read(os.path.join(LR9, "counters.json")))["train"]
    ctrs = json.loads(_read(out + ".counters.json"))
    assert ctrs["Regression"] == want["Regression"]


def test_lr9_resume_continues_the_history(tmp_path):
    """A history cut to its first lines resumes to the port's own full
    history bit for bit (the history file is the checkpoint), within
    tolerance of the JAX package's resumed history."""
    full = str(tmp_path / "full.txt")
    _train(tmp_path, full)
    resumed = str(tmp_path / "resumed.txt")
    with open(resumed, "w") as fh:
        fh.write("".join(ln + "\n" for ln in
                         _history(os.path.join(LR9, "coeff.txt"))
                         [:MAKE.RESUME_LINES]))
    out = _train(tmp_path, resumed)
    got = _history(resumed)
    assert got[:MAKE.RESUME_LINES] == \
        _history(os.path.join(LR9, "coeff.txt"))[:MAKE.RESUME_LINES]
    assert_history_close(got, _history(os.path.join(LR9, "resume",
                                                    "coeff.txt")))
    import json
    ctrs = json.loads(_read(out + ".counters.json"))
    want = json.loads(_read(os.path.join(LR9, "counters.json")))
    assert ctrs["Regression"] == want["resume_train"]["Regression"]
    # resuming from the port's own head gives the port's own history
    own = str(tmp_path / "own.txt")
    with open(own, "w") as fh:
        fh.write("".join(ln + "\n" for ln in
                         _history(full)[:MAKE.RESUME_LINES]))
    _train(tmp_path, own)
    assert _history(own) == _history(full)


def _pred_fields(path):
    return [ln.split(",") for ln in _read(path).splitlines()]


def test_lr9_predictor_labels_and_probabilities(tmp_path):
    """The predictor over the fixture's own coefficient file: the record
    echo equal, probabilities within PROBA_ATOL, labels equal wherever
    |p - 0.5| > PROBA_ATOL, and the validation counters equal."""
    out = str(tmp_path / "pred")
    assert port_run.main([
        "logisticRegressionPredictor", CPU, *MAKE.KEYS,
        f"-Dcoeff.file.path={os.path.join(LR9, 'coeff.txt')}",
        "-Dvalidation.mode=true", os.path.join(LR9, "test.csv"),
        out]) == 0
    got = _pred_fields(os.path.join(out, "part-m-00000"))
    want = _pred_fields(os.path.join(LR9, "pred", "part-m-00000"))
    assert len(got) == len(want) == MAKE.TEST_ROWS
    labels = probs = 0
    for g, w in zip(got, want):
        assert g[:-2] == w[:-2]
        pg, pw = float(g[-1]), float(w[-1])
        assert abs(pg - pw) <= 1e-3 + PROBA_ATOL
        if abs(pw - 0.5) > PROBA_ATOL:
            assert g[-2] == w[-2]
        labels += g[-2] != w[-2]
        probs += g[-1] != w[-1]
    print(f"predictor: {labels} labels and {probs} of {len(got)} .3f "
          f"probabilities differ from the JAX package's")
    # the exact probabilities, unrounded
    table = load_csv(os.path.join(LR9, "test.csv"), SCHEMA)
    w64 = LR.parse_history(_history(os.path.join(LR9, "coeff.txt")))[-1]
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    from avenir_tpu.core.table import load_csv as jax_load_csv
    jschema = JaxSchema.load(MAKE.SCHEMA)
    jp = JLR.LogisticTrainer(jschema, JLR.LogisticParams(
        "churned")).predict_proba(
        jax_load_csv(os.path.join(LR9, "test.csv"), jschema), w64)
    np.testing.assert_allclose(
        LR.predict_proba(table, SCHEMA, w64, device="cpu"), jp, rtol=0,
        atol=PROBA_ATOL)
    import json
    ctrs = json.loads(_read(out + ".counters.json"))
    want_c = json.loads(_read(os.path.join(LR9, "counters.json")))["pred"]
    assert ctrs["Validation"] == want_c["Validation"]


def test_xla_sigmoid_does_not_close_the_history():
    """XLA's ``exp`` does not bring the CPU strings to equality: the
    training loop with ``p`` computed as XLA computes it
    (an FMA-ordered dot, ``xla_exp_f32``, a float32 divide) still prints
    coefficient strings apart from the JAX package's: the gradient's sum
    order differs too.  The port keeps torch's ``sigmoid``."""
    import torch
    from avenir_tpu_torch.utils.xla_math import fma_row_sum, xla_exp_f32
    table = load_csv(os.path.join(LR9, "train.csv"), SCHEMA)
    X, y = (torch.from_numpy(a) for a in
            LR.design_matrix(table, SCHEMA, MAKE.POSITIVE))
    want = _history(os.path.join(LR9, "coeff.txt"))
    lr, n = torch.tensor(0.001), torch.tensor(float(len(y)))
    w = torch.zeros(4)
    got = []
    for _ in want:
        p = 1 / (1 + xla_exp_f32(-fma_row_sum(X, w.expand_as(X))))
        w = w + lr * (X.T @ (y - p)) / n
        got.append(LR.format_coefficients(w.numpy().astype(np.float64)))
    diff, total = _strings_apart(got, want)
    print(f"with XLA's sigmoid: {diff} of {total} .9g strings differ")
    assert diff > 0


# --------------------------------------------------------------------------
# the registry kind and serving
# --------------------------------------------------------------------------

def test_logistic_kind_reads_and_writes_across_packages(tmp_path):
    """The JAX package's lr9 version loads in the port; the port publishes
    the same weights as the same bytes (meta.json) and arrays, and the
    JAX package loads the port's version."""
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry
    reg = ModelRegistry(os.path.join(LR9, "registry"))
    loaded = reg.load(MAKE.MODEL_NAME, 1)
    assert loaded.kind == LOGISTIC
    w = LR.parse_history(_history(os.path.join(LR9, "coeff.txt")))[-1]
    assert loaded.model.dtype == np.float64
    np.testing.assert_array_equal(loaded.model, w)
    params = {"pos_class_value": MAKE.POSITIVE}
    port_reg = ModelRegistry(str(tmp_path / "port"))
    assert port_reg.publish("lr9", w, schema=SCHEMA, params=params) == 1
    jax_reg = JaxRegistry(str(tmp_path / "jax"))
    jax_reg.publish("lr9", w, schema=JaxSchema.load(MAKE.SCHEMA),
                    params=params)
    for reg_a, reg_b in ((port_reg, jax_reg),
                         (port_reg, reg)):
        with open(os.path.join(reg_a.version_dir("lr9", 1),
                               "meta.json"), "rb") as a, \
                open(os.path.join(reg_b.version_dir(
                    reg_b is reg and MAKE.MODEL_NAME or "lr9", 1),
                    "meta.json"), "rb") as b:
            got, want = a.read(), b.read()
        if reg_b is reg:
            got = got.replace(b'"name": "lr9"', b'"name": "NAME"')
            want = want.replace(b'"name": "%s"' % MAKE.MODEL_NAME.encode(),
                                b'"name": "NAME"')
        assert got == want
    back = jax_reg.__class__(port_reg.base_dir).load("lr9", 1)
    assert back.kind == LOGISTIC
    np.testing.assert_array_equal(back.model, w)


def test_logistic_predictor_against_the_trainer(tmp_path):
    """LogisticPredictor answers what the predictor job decides, over
    bucket-padded batches, and its probabilities are the trainer's (to
    float32 rounding: torch's product order follows the batch shape)."""
    loaded = ModelRegistry(os.path.join(LR9, "registry")).load(
        MAKE.MODEL_NAME, 1)
    pred = make_predictor(loaded, buckets=(8, 64))
    assert isinstance(pred, LogisticPredictor)
    rows = [ln.split(",") for ln in _read(os.path.join(LR9, "test.csv"))
            .splitlines()]
    table = load_csv(os.path.join(LR9, "test.csv"), SCHEMA)
    params = LR.LogisticParams(MAKE.POSITIVE)
    codes = LR.predict(table, SCHEMA, params, loaded.model)
    card = SCHEMA.class_attr_field.cardinality
    assert pred.predict_rows(rows) == [card[c] for c in codes]
    np.testing.assert_allclose(
        pred.predict_proba_rows(rows),
        LR.predict_proba(table, SCHEMA, loaded.model), rtol=0,
        atol=PROBA_ATOL)
    assert pred.predict_proba_rows([]).shape == (0,)


def test_lr9_served_lines_match_the_fixture(tmp_path):
    """predictionService (ps.transport=inprocess) over the fixture's
    logistic version answers the fixture's served lines."""
    reg = str(tmp_path / "registry")
    shutil.copytree(os.path.join(LR9, "registry"), reg)
    out = str(tmp_path / "served")
    assert port_run.main([
        "org.avenir.serving.PredictionService", CPU,
        f"-Dps.model.registry.dir={reg}",
        f"-Dps.model.name={MAKE.MODEL_NAME}", "-Dps.transport=inprocess",
        os.path.join(LR9, "test.csv"), out]) == 0
    assert _read(os.path.join(out, "part-m-00000")) == \
        _read(os.path.join(LR9, "served", "part-m-00000"))


def test_make_reproduces_the_fixture(tmp_path):
    """Rerun the JAX package's maker into a temporary directory: every
    file it writes equals the committed one (the .npz by arrays)."""
    out = str(tmp_path / "lr9")
    MAKE.make(out)
    for root, _, files in os.walk(out):
        for f in files:
            got = os.path.join(root, f)
            want = os.path.join(LR9, os.path.relpath(got, out))
            if f.endswith(".npz"):
                with np.load(got) as a, np.load(want) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in a.files:
                        assert a[k].dtype == b[k].dtype
                        assert np.array_equal(a[k], b[k])
                continue
            with open(got, "rb") as a, open(want, "rb") as b:
                assert a.read() == b.read(), got


# --------------------------------------------------------------------------
# the joined run
# --------------------------------------------------------------------------

def test_two_gloo_ranks_walk_the_one_process_history(tmp_path):
    """logisticRegression over two gloo ranks, each given half of the
    train rows: the packed [grad, ll, n] all-reduce makes both ranks
    write the same history, within HISTORY_RTOL of one process's over
    the whole file (the sums add in another order)."""
    from tests.test_torch_joined_gather import run_joined
    lines = _read(os.path.join(LR9, "train.csv")).splitlines(True)
    half = len(lines) // 2
    runs = []
    for i, part in enumerate((lines[:half], lines[half:])):
        src = tmp_path / f"train{i}.csv"
        src.write_text("".join(part))
        runs.append([["logisticRegression", CPU, *MAKE.KEYS,
                      f"-Dcoeff.file.path={tmp_path / f'coeff{i}.txt'}",
                      str(src), str(tmp_path / f"out{i}")]])
    res = run_joined(tmp_path, runs)
    for rc, so, se, rcs in res:
        assert rc == 0 and rcs == [0], se[-3000:]
    h0 = _history(tmp_path / "coeff0.txt")
    assert h0 == _history(tmp_path / "coeff1.txt")
    one = str(tmp_path / "one.txt")
    _train(tmp_path, one)
    assert_history_close(h0, _history(one))
