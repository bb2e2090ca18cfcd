"""The SVM and the Fisher discriminant in the port
(``avenir_tpu_torch/discriminant``, ``cli/discriminant_jobs.py``) against
the JAX package, on the CPU.

The serial Platt trainer is the JAX package's host float64 numpy with its
numpy draws: models and support-vector lines are byte for byte, in one
process or a spawn-mode pool, and the predictor's float32 ``X @ w - b``
(an FMA chain, as XLA's dot) equals the JAX package's bit for bit.  The
lock-step batched solver runs in a fixed float32 order of its own: where
it converges its weights are within ``W_TOL`` of the JAX package's
(relative to the largest), its thresholds within ``B_TOL``, and its
predictions equal.  Fisher's class moments sum in float64 and round to
float32 (XLA sums in float32): every boundary number within ``F_RTOL``.
End to end: the golden svm flow and the tail9 discriminant cases; without
``-Dplatform=cpu`` the jobs raise on a machine with no GPU.
"""

import os

import numpy as np
import pytest

from avenir_tpu.discriminant import fisher as JF
from avenir_tpu.discriminant import smo as JS
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.discriminant import fisher as F
from avenir_tpu_torch.discriminant import smo as S
from tests.test_torch_cluster import (CPU, MAKE, TAIL9, case_of,
                                      check_job_needs_a_gpu,
                                      check_job_registered, run_tail9_case)
from tests.test_torch_explore import _gen, _tables
from tests.test_torch_sequence import FLOWS, GOLDEN, _PortCLI

DISCRIMINANT_JOBS = ("supportVectorMachine", "supportVectorPredictor",
                     "fisherDiscriminant")
W_TOL = 1e-2
B_TOL = 1e-2
F_RTOL = 1e-4


def _xy(n, seed):
    jt, _ = _tables("churn_svm", _gen("churn_svm_gen", n, seed))
    X = jt.feature_matrix(dtype=np.float64)
    pos = jt.schema.class_attr_field.cat_code("churned")
    return X, np.where(jt.class_codes() == pos, 1.0, -1.0)


@pytest.mark.parametrize("C,seed", [(1.0, 5), (0.05, 0), (0.01, 3)])
def test_serial_smo_is_the_jax_trainer(C, seed):
    X, y = _xy(160, seed + 20)
    want = JS.SMOTrainer(JS.SMOParams(penalty_factor=C, seed=seed)).train(X, y)
    got = S.SMOTrainer(S.SMOParams(penalty_factor=C, seed=seed)).train(X, y)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.threshold == want.threshold
    np.testing.assert_array_equal(got.alphas, want.alphas)
    assert got.support_vector_lines() == want.support_vector_lines()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_decision_function_is_the_jax_float32(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 50, (3000, 1 + seed * 2))
    w = rng.normal(0, 1, X.shape[1])
    model = S.SVMModel(weights=w, threshold=float(rng.normal()),
                       sup_vec_idx=np.zeros(0, int), alphas=np.zeros(0),
                       X=np.zeros((0, len(w))), y=np.zeros(0))
    want = JS.decision_function(model, X)
    np.testing.assert_array_equal(S.decision_function(model, X, "cpu"), want)
    np.testing.assert_array_equal(S.predict(model, X, "cpu"),
                                  JS.predict(model, X))


def _groups(seed, sizes):
    X, y = _xy(sum(sizes), seed)
    out, lo = {}, 0
    for i, n in enumerate(sizes):
        out[f"g{i}"] = (X[lo:lo + n], y[lo:lo + n])
        lo += n
    return out


@pytest.mark.parametrize("seed,sizes", [(31, (120, 80, 150)),
                                        (32, (60,)), (33, (90, 90, 40, 70))])
def test_batched_smo_within_tolerance_of_the_jax_solver(seed, sizes):
    groups = _groups(seed, sizes)
    p = dict(penalty_factor=0.01, seed=5)
    want = JS.train_groups_batched(groups, JS.SMOParams(**p))
    stats = {}
    got = S.train_groups_batched(groups, S.SMOParams(**p), stats=stats,
                                 device="cpu")
    assert 0 < stats["iterations"] < 200 * max(sizes)
    for g, (X, _) in groups.items():
        w0 = want[g].weights
        assert np.abs(got[g].weights - w0).max() <= \
            W_TOL * np.abs(w0).max(), g
        assert abs(got[g].threshold - want[g].threshold) <= B_TOL, g
        np.testing.assert_array_equal(S.predict(got[g], X, "cpu"),
                                      JS.predict(want[g], X))


# svm.properties' C = 1.0: the lock-step solver does not converge on these
# groups and runs to its cap (max_sweeps x the largest group's rows), where
# the two float32 orders have wandered apart in some groups.  Each case
# pins the counts of groups whose weights or threshold lie outside
# W_TOL / B_TOL and of the rows whose predictions differ:
# (seed, sizes, max_sweeps, groups apart, predictions apart)
C1_CASES = [(41, (40, 30, 50), 40, 1, 7), (42, (30, 25), 200, 1, 1)]


@pytest.mark.parametrize("seed,sizes,sweeps,groups_apart,preds_apart",
                         C1_CASES)
def test_batched_smo_at_the_published_c_against_the_jax_solver(
        seed, sizes, sweeps, groups_apart, preds_apart):
    groups = _groups(seed, sizes)
    p = dict(penalty_factor=1.0, tolerance=0.001, eps=0.001, seed=5,
             max_sweeps=sweeps)
    want = JS.train_groups_batched(groups, JS.SMOParams(**p))
    stats = {}
    got = S.train_groups_batched(groups, S.SMOParams(**p), stats=stats,
                                 device="cpu")
    assert stats["iterations"] == sweeps * max(sizes)      # the cap
    apart = preds = rows = 0
    for g, (X, _) in groups.items():
        w0 = want[g].weights
        apart += bool(np.abs(got[g].weights - w0).max()
                      > W_TOL * np.abs(w0).max()
                      or abs(got[g].threshold - want[g].threshold) > B_TOL)
        preds += int((S.predict(got[g], X, "cpu")
                      != JS.predict(want[g], X)).sum())
        rows += len(X)
    print(f"C=1.0 seed {seed}: {apart} of {len(groups)} weight lines "
          f"apart, {preds} of {rows} predictions")
    assert apart <= groups_apart and preds <= preds_apart


def test_batched_smo_one_class_group_and_the_cap():
    """A group of one class has an empty I_up or I_low: b = 0, as the
    JAX package's; a cap of a few steps stops the loop there."""
    groups = _groups(34, (50, 40))
    X, y = groups["g1"]
    groups["g1"] = (X, np.ones_like(y))
    got = S.train_groups_batched(groups, S.SMOParams(penalty_factor=0.001),
                                 device="cpu")
    assert got["g1"].threshold == 0.0
    capped = S.train_groups_batched(
        groups, S.SMOParams(penalty_factor=0.01, max_sweeps=0), device="cpu")
    assert not capped["g0"].alphas.any()
    stats = {}
    S.train_groups_batched(groups, S.SMOParams(penalty_factor=1.0,
                                               max_sweeps=1),
                           stats=stats, device="cpu")
    assert stats["iterations"] == 50


def test_sharded_group_training_equals_batched():
    class _Reducer:   # two processes' allgather, as seen by process 0
        class spec:
            index, count = 0, 1

        @staticmethod
        def allgather(payload):
            return [payload]
    groups = _groups(35, (70, 50, 60))
    p = S.SMOParams(penalty_factor=0.01)
    a = S.train_groups_sharded(groups, p, _Reducer, device="cpu")
    b = S.train_groups_batched(groups, p, device="cpu")
    for g in groups:
        np.testing.assert_array_equal(a[g].weights, b[g].weights)
        assert a[g].threshold == b[g].threshold


def test_spawn_pool_equals_the_serial_loop():
    groups = _groups(36, (60, 50))
    p = S.SMOParams(penalty_factor=0.05, seed=2)
    a = S.train_groups(groups, p, workers=2)
    b = S.train_groups(groups, p)
    for g in groups:
        np.testing.assert_array_equal(a[g].weights, b[g].weights)
        assert a[g].support_vector_lines() == b[g].support_vector_lines()


@pytest.mark.parametrize("name,gen,seed", [("patient", "patient_gen", 1),
                                           ("churn_svm", "churn_svm_gen", 2),
                                           ("campaign", "campaign_gen", 3)])
def test_fisher_within_tolerance(name, gen, seed):
    jt, pt = _tables(name, _gen(gen, 500, seed))
    want = JF.fisher_discriminant(jt)
    got = F.fisher_discriminant(pt, device="cpu")
    np.testing.assert_array_equal(got.counts, want.counts)
    for a, b in zip(got.to_lines(), want.to_lines()):
        x = np.array(a.split(","), float)
        z = np.array(b.split(","), float)
        np.testing.assert_allclose(x, z, rtol=F_RTOL)
    for fi in range(len(got.attr_ordinals)):
        np.testing.assert_array_equal(F.classify(got, pt, fi),
                                      JF.classify(want, jt, fi))


# Fisher past 2^24 (the centred Σx² over 100,000 patients): (rows, the
# printed strings apart, of all); each within F_RTOL
FISHER_PAST_F32 = (100_000, 7, 16)


def test_fisher_past_float32_sums():
    """The JAX package's class moments are float32 contractions in
    Eigen's order; the port's float64 sums rounded to float32 differ from
    them in the stated count of the printed strings, each within
    ``F_RTOL``; the classifications are equal."""
    n, apart, total = FISHER_PAST_F32
    jt, pt = _tables("patient", _gen("patient_gen", n, 23))
    want = JF.fisher_discriminant(jt)
    got = F.fisher_discriminant(pt, device="cpu")
    np.testing.assert_array_equal(got.counts, want.counts)
    a = [x for line in got.to_lines() for x in line.split(",")]
    b = [x for line in want.to_lines() for x in line.split(",")]
    assert len(a) == total
    assert sum(x != y for x, y in zip(a, b)) == apart
    np.testing.assert_allclose(np.array(a, float), np.array(b, float),
                               rtol=F_RTOL)
    for fi in range(len(got.attr_ordinals)):
        np.testing.assert_array_equal(F.classify(got, pt, fi),
                                      JF.classify(want, jt, fi))


def test_fisher_refuses_a_missing_class():
    rows = [r for r in _gen("patient_gen", 200, 4) if r.endswith(",F")]
    _, pt = _tables("patient", rows)
    with pytest.raises(ValueError, match="no rows"):
        F.fisher_discriminant(pt, device="cpu")


def test_golden_svm_flow_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(FLOWS, "cli_run", _PortCLI)
    for rel, text in FLOWS.svm_flow(str(tmp_path)).items():
        with open(os.path.join(GOLDEN, rel)) as fh:
            assert text == fh.read(), rel


@pytest.mark.parametrize("case", case_of(DISCRIMINANT_JOBS))
def test_tail9_discriminant_case(tmp_path, case):
    """Byte for byte, save the maker's TOLERANCE cases (fisher, the
    batched solver's weights lines)."""
    text, counters, want, want_c = run_tail9_case(tmp_path, case)
    MAKE.compare(case, text, want)
    if not case.startswith("svm_") or case not in MAKE.TOLERANCE:
        assert counters == want_c
    if case == "svm_batched":
        # the port's model predicts what the JAX package's model predicts
        model = tmp_path / case / "part-r-00000"
        _, argv = MAKE.case_args("svm_batched_pred", TAIL9,
                                 str(tmp_path / "pred"))
        argv = [a if not a.startswith("-Dsvm.model.file.path=") else
                f"-Dsvm.model.file.path={model}" for a in argv]
        assert port_run.main(argv + [CPU]) == 0
        with open(tmp_path / "pred" / "svm_batched_pred" /
                  "part-m-00000") as fh, \
                open(os.path.join(TAIL9, "svm_batched_pred",
                                  "out.csv")) as want_fh:
            assert fh.read() == want_fh.read()


@pytest.mark.parametrize("job", DISCRIMINANT_JOBS)
def test_discriminant_job_registered(job):
    check_job_registered(job)


@pytest.mark.parametrize("job", DISCRIMINANT_JOBS)
def test_discriminant_job_raises_without_a_gpu_unless_asked_for_the_cpu(
        tmp_path, job):
    check_job_needs_a_gpu(tmp_path, job)
