"""The explore jobs in the port (``avenir_tpu_torch/explore``,
``cli/explore_jobs.py``) against the JAX package, on the CPU.

Module by module, on inputs drawn from numpy seeds: the mutual-information
counts (one-hot contractions, exact) and every score equal the JAX
package's; the contingency measures, the moment pass (exact float32 sums
of integer-valued attributes) and the class affinities equal its own; the
samplers draw its numpy streams and pick its neighbours (ties to the
lowest index) bit for bit.  End to end: the golden carm, hica and mi flows
and every tail9 explore case run through the port's CLI byte for byte —
save ``sts`` (an existing job, the SMOTE flow's first step), whose
pairwise order differs from XLA's in one distance of 11,175 (ROADMAP §C,
the three KNN distance orders); a joined run of two gloo ranks gives the
one-process MI and correlation lines; without ``-Dplatform=cpu`` the jobs
raise on a machine with no GPU.
"""

import os

import numpy as np
import pytest
import torch

from avenir_tpu.core.schema import FeatureSchema as JSchema
from avenir_tpu.explore import correlations as JCO
from avenir_tpu.explore import encoders as JEN
from avenir_tpu.explore import mutual_info as JMI
from avenir_tpu.explore import samplers as JSA
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.explore import correlations as CO
from avenir_tpu_torch.explore import encoders as EN
from avenir_tpu_torch.explore import mutual_info as MI
from avenir_tpu_torch.explore import samplers as SA
from tests.test_torch_cluster import (CPU, MAKE, ROOT, TAIL9, case_of,
                                      check_job_needs_a_gpu,
                                      check_job_registered, run_tail9_case)
from tests.test_torch_sequence import FLOWS, GOLDEN, _PortCLI

RES = os.path.join(ROOT, "resource")
EXPLORE_JOBS = (
    "mutualInformation", "numericalCorrelation", "cramerCorrelation",
    "heterogeneityReductionCorrelation", "categoricalClassAffinity",
    "categoricalContinuousEncoding", "classBasedOverSampler",
    "underSamplingBalancer", "reliefFeatureRelevance", "adaBoostError",
    "adaBoostUpdate", "baggingSampler", "topMatchesByClass")


def _one_device():
    from avenir_tpu.parallel.mesh import MeshContext, make_mesh
    return MeshContext(make_mesh(n_devices=1))


def _tables(name, rows):
    """(JAX table, port table) of generator rows under resource/<name>."""
    import sys
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from avenir_tpu.core.table import load_csv_text as jtext
    from avenir_tpu_torch.core.table import load_csv_text as ptext
    text = "\n".join(rows)
    path = os.path.join(RES, f"{name}.json")
    return (jtext(text, JSchema.load(path), keep_raw=True),
            ptext(text, FeatureSchema.load(path), keep_raw=True))


def _gen_module(mod):
    import importlib
    import sys
    if RES not in sys.path:
        sys.path.insert(0, RES)
    return importlib.import_module(f"gen.{mod}")


def _gen(mod, *args):
    return _gen_module(mod).generate(*args)


# --------------------------------------------------------------------------
# mutual information
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,gen,seed", [
    ("call_hangup", "call_hangup_gen", 1), ("hosp_readmit",
                                            "hosp_readmit_gen", 2),
    ("cust_call", "cust_call_gen", 3), ("patient", "patient_gen", 4)])
def test_mutual_info_matches_the_jax_package(name, gen, seed):
    jt, pt = _tables(name, _gen(gen, 700, seed))
    want = JMI.compute_stats(jt, _one_device())
    got = MI.compute_stats(pt, device="cpu", chunk=256)
    for k in ("class_p", "feature_p", "feature_class_p", "pair_p",
              "pair_class_p"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    for alg, fn in JMI.SCORE_ALGORITHMS.items():
        assert MI.SCORE_ALGORITHMS[alg](got, 0.7) == fn(want, 0.7), alg


def test_mutual_info_reduce_sums_the_counts():
    """``reduce`` sees the packed counts: two halves summed give the
    whole table's distributions."""
    _, pt = _tables("hosp_readmit", _gen("hosp_readmit_gen", 500, 5))
    whole = MI.compute_stats(pt, device="cpu")
    halves = [pt.take_rows(0, 200), pt.take_rows(200, 500)]
    other = MI.count_stats(halves[1], "cpu")[1:]
    flat_other = np.concatenate([p.ravel() for p in other])
    got = MI.compute_stats(halves[0], device="cpu",
                           reduce=lambda x: x + flat_other)
    for k in ("class_p", "feature_p", "pair_class_p"):
        np.testing.assert_array_equal(getattr(got, k), getattr(whole, k))


# --------------------------------------------------------------------------
# correlations and encoders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [6, 7, 8])
def test_contingency_measures_match(seed):
    jt, pt = _tables("cust_call", _gen("cust_call_gen", 400, seed))
    ords = [1, 2, 3, 4]
    assert CO.cramer_correlations(pt, ords, "cpu") == \
        JCO.cramer_correlations(jt, ords)
    for algo in ("gini", "entropy"):
        assert CO.heterogeneity_correlations(pt, ords, algo, "cpu") == \
            JCO.heterogeneity_correlations(jt, ords, algo)
    got, want = CO.class_affinity(pt, ords, "cpu"), JCO.class_affinity(
        jt, ords)
    for o in ords:
        np.testing.assert_array_equal(got[o], want[o])


@pytest.mark.parametrize("n", [50, 301, 2000])
def test_numerical_correlations_match(n):
    """The moments of integer attributes are exact float32 sums below
    2^24 on both sides: the Pearson values are equal."""
    jt, pt = _tables("hosp_readmit", _gen("hosp_readmit_gen", n, 9))
    ords = [1, 2, 4]
    assert CO.numerical_correlations(pt, ords, "cpu") == \
        JCO.numerical_correlations(jt, ords, _one_device())


def _hosp_rows(n, seed):
    """hosp_readmit rows drawn vectorised from its generator's model."""
    hr = _gen_module("hosp_readmit_gen")
    rng = np.random.default_rng(seed)
    age = np.clip(rng.normal(62, 18, n), 18, 95).astype(np.int64)
    los = np.clip(rng.gamma(2.0, 3.0, n), 1, 30).astype(np.int64)
    diag = rng.choice(5, n, p=[0.25, 0.2, 0.15, 0.15, 0.25])
    prior = np.clip(rng.poisson(1.0, n), 0, 9)
    disch = rng.choice(3, n, p=[0.6, 0.25, 0.15])
    risk = np.asarray([hr.DIAG_RISK[d] for d in hr.DIAGNOSES])
    p = risk[diag] + 0.08 * prior + 0.002 * (age - 60)
    readmit = rng.random(n) < np.clip(p, 0.02, 0.9)
    return [f"A{i:07d},{a},{s},{hr.DIAGNOSES[d]},{pr},{hr.DISCHARGE[ds]},"
            f"{'T' if r else 'F'}" for i, (a, s, d, pr, ds, r) in enumerate(
                zip(age.tolist(), los.tolist(), diag.tolist(),
                    prior.tolist(), disch.tolist(), readmit.tolist()))]


# Pearson lines (``a,b,r`` to 6 places) apart from the JAX package's past
# 2^24, where its float32 moment sums round and the port's float64 sums do
# not: (rows, lines apart of 3, largest |r| apart)
CORR_PAST_F32 = [(100_000, 1, 5e-5), (1_000_000, 2, 2e-3)]


@pytest.mark.parametrize("n,apart,atol", CORR_PAST_F32)
def test_numerical_correlations_past_float32_sums(n, apart, atol):
    """Past 2^24 (age^2 over 100,000 rows is ~4e8) the JAX package's
    float32 sums round in XLA's order, which the port does not reproduce:
    it sums in float64, so its r is the float64 Pearson r to 6 places,
    and its printed lines are the JAX package's save ``apart`` of them,
    each within ``atol``."""
    jt, pt = _tables("hosp_readmit", _hosp_rows(n, 9))
    ords = [1, 2, 4]
    got = CO.numerical_correlations(pt, ords, "cpu")
    want = JCO.numerical_correlations(jt, ords, _one_device())
    exact = np.corrcoef(np.stack([pt.columns[o] for o in ords]).astype(
        np.float64))
    lines = lambda c: [f"{a},{b},{v:.6f}" for a, b, v in c]  # noqa: E731
    assert sum(x != y for x, y in zip(lines(got), lines(want))) == apart
    for (a, b, v), (_, _, w) in zip(got, want):
        assert abs(v - exact[ords.index(a), ords.index(b)]) <= 1e-6
        assert abs(v - w) <= atol


def test_numerical_moments_are_exact_past_float32():
    """At sums past 2^24 the float64 pass keeps integer moments exact
    (the JAX package's float32 sums round there)."""
    rng = np.random.default_rng(10)
    X = rng.integers(0, 1000, (40_000, 3)).astype(np.float32)
    n, s1, s2, cross = CO.moments(torch.from_numpy(X),
                                  torch.ones(len(X)))
    Xd = X.astype(np.float64)
    assert float(n) == len(X)
    np.testing.assert_array_equal(s2.numpy(), (Xd * Xd).sum(0))
    np.testing.assert_array_equal(cross.numpy(), Xd.T @ Xd)


@pytest.mark.parametrize("strategy", ["supervisedRatio", "weightOfEvidence"])
@pytest.mark.parametrize("seed", [11, 12])
def test_categorical_continuous_encoding_matches(strategy, seed):
    jt, pt = _tables("delivery", _gen("delivery_gen", 500, seed))
    pos = JSchema.load(os.path.join(RES, "delivery.json")
                       ).find_field_by_ordinal(4).cardinality[1]
    kw = dict(attr_ordinals=[1, 3], class_attr_ordinal=4,
              pos_class_value=pos, strategy=strategy, scale=100)
    assert EN.categorical_continuous_encoding(pt, device="cpu", **kw) == \
        JEN.categorical_continuous_encoding(jt, **kw)


@pytest.mark.parametrize("error", [0.05, 0.3, 0.49, 0.5, 0.8])
def test_adaboost_matches(error):
    rng = np.random.default_rng(int(error * 100))
    actual = list(rng.choice(["a", "b"], 80))
    pred = list(rng.choice(["a", "b"], 80))
    w = rng.random(80) / 80
    for norm in (True, False):
        assert EN.adaboost_error(actual, pred, w, norm) == \
            JEN.adaboost_error(actual, pred, w, norm)
    assert EN.adaboost_alpha(error) == JEN.adaboost_alpha(error)
    np.testing.assert_array_equal(
        EN.adaboost_update(w, actual, pred, error, 0.25),
        JEN.adaboost_update(w, actual, pred, error, 0.25))


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_matches_by_class_match(k):
    """Same-class neighbours nearest first, ties to the lowest index, -1
    past a class's size; also for a subset of query rows."""
    rows = _gen("machine_failure_gen", 120, 13)
    rows += rows[:6]                      # exact duplicates: distance ties
    jt, pt = _tables("machine_failure", rows)
    want = JSA.top_matches_by_class(jt, k)
    np.testing.assert_array_equal(SA.top_matches_by_class(pt, k, device="cpu"),
                                  want)
    sub = np.array([3, 0, 7, 125, 60])
    np.testing.assert_array_equal(
        SA.top_matches_by_class(pt, k, device="cpu", rows=sub), want[sub])


def test_top_matches_tile_boundaries(monkeypatch):
    monkeypatch.setattr(SA, "TILE", 7)
    jt, pt = _tables("machine_failure", _gen("machine_failure_gen", 90, 14))
    np.testing.assert_array_equal(SA.top_matches_by_class(pt, 4, device="cpu"),
                                  JSA.top_matches_by_class(jt, 4))


@pytest.mark.parametrize("mult,seed", [(1, 0), (4, 7), (2, 19)])
def test_smote_matches(mult, seed):
    jt, pt = _tables("machine_failure", _gen("machine_failure_gen", 150, 15))
    assert SA.smote_oversample(pt, "T", 5, mult, seed, device="cpu") == \
        JSA.smote_oversample(jt, "T", 5, mult, seed)


@pytest.mark.parametrize("rate,seed", [(0.1, 1), (0.5, 2), (1.0, 3)])
def test_under_sample_and_bagging_match(rate, seed):
    jt, pt = _tables("machine_failure", _gen("machine_failure_gen", 100, 16))
    np.testing.assert_array_equal(SA.under_sample(pt, "F", rate, seed),
                                  JSA.under_sample(jt, "F", rate, seed))
    for repl in (True, False):
        np.testing.assert_array_equal(
            SA.bagging_sample(97, rate, repl, seed),
            JSA.bagging_sample(97, rate, repl, seed))


@pytest.mark.parametrize("samples", [None, 40, 500])
def test_relief_matches(samples):
    jt, pt = _tables("patient", _gen("patient_gen", 200, 17))
    ords = [1, 2, 3, 4, 5]
    assert SA.relief_relevance(pt, ords, samples, seed=3, device="cpu") == \
        JSA.relief_relevance(jt, ords, samples, seed=3)


def test_relief_with_one_class_takes_row_zero():
    """No row of another class: the nearest miss is row 0, as numpy's
    argmin over an all-excluded row."""
    rows = [r for r in _gen("machine_failure_gen", 80, 18) if r.endswith("F")]
    jt, pt = _tables("machine_failure", rows)
    assert SA.relief_relevance(pt, [1, 2, 3], device="cpu") == \
        JSA.relief_relevance(jt, [1, 2, 3])


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flow", ["carm", "hica", "mi"])
def test_golden_flow_byte_equal(tmp_path, monkeypatch, flow):
    monkeypatch.setattr(FLOWS, "cli_run", _PortCLI)
    outs = getattr(FLOWS, f"{flow}_flow")(str(tmp_path))
    assert outs
    for rel, text in outs.items():
        with open(os.path.join(GOLDEN, rel)) as fh:
            assert text == fh.read(), rel


@pytest.mark.parametrize("case", case_of(EXPLORE_JOBS + (
    "sameTypeSimilarity",)))
def test_tail9_explore_case(tmp_path, case):
    text, counters, want, want_c = run_tail9_case(tmp_path, case)
    assert counters == want_c
    assert MAKE.compare(case, text, want) == (
        MAKE.STS_LINES_APART if case == "sts" else 0)


@pytest.mark.parametrize("job", EXPLORE_JOBS)
def test_explore_job_registered(job):
    check_job_registered(job)


@pytest.mark.parametrize("job", EXPLORE_JOBS)
def test_explore_job_raises_without_a_gpu_unless_asked_for_the_cpu(
        tmp_path, job):
    check_job_needs_a_gpu(tmp_path, job)


def test_two_gloo_ranks_give_the_one_process_mi_and_correlations(tmp_path):
    """mutualInformation and numericalCorrelation over two gloo ranks,
    each with part of the rows: the counts and moments all-reduce, so both
    ranks write the one-process lines (the moments of these integer
    attributes are exact)."""
    from tests.test_torch_joined_gather import run_joined
    cases = ("mi_all", "numcorr")
    src = os.path.join(TAIL9, "data", "hosp.csv")
    rows = open(src).read().splitlines(True)
    runs = [[], []]
    for i, part in enumerate((rows[:120], rows[120:])):
        p = tmp_path / f"part{i}.csv"
        p.write_text("".join(part))
        for case in cases:
            _, argv = MAKE.case_args(case, TAIL9, str(tmp_path / f"r{i}"))
            runs[i].append(argv[:-2] + [CPU, str(p), argv[-1]])
    for rc, so, se, rcs in run_joined(tmp_path, runs):
        assert rc == 0 and rcs == [0, 0], se[-3000:]
    for case in cases:
        want = open(os.path.join(TAIL9, case, "out.csv")).read()
        for i in range(2):
            got = open(tmp_path / f"r{i}" / case / "part-r-00000").read()
            assert got == want, (case, i)
