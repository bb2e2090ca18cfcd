"""The sequence family in the port (``avenir_tpu_torch/sequence``,
``cli/sequence_jobs.py``, ``parallel.collectives.keyed_reduce``) against
the JAX package, on the CPU.

The port's CLI reproduces the golden markov, conv, buyhist, sup and visit
files and every sequence case of the seq9 fixture byte for byte
(``tests/torch_fixtures/seq9/make.py``).  Module by module, on inputs drawn
from numpy seeds: the classifier's float32 log odds are bit-equal to the
JAX package's ``_log_odds_kernel`` at every padded length from 2 to 64
(XLA's row-sum order changes at 30 and above 32 pairs), Viterbi paths are
equal (tables built to tie included), the uniformization powers are
bit-equal for 2-6 states and series lengths from 5 to about 200, and the
keyed reduce equals the JAX package's.  The registry holds the 17 jobs of
this family, association mining and the text jobs under every name the JAX
package registers, with its multi-process modes, as do the other 47 of
its 64 jobs; without ``-Dplatform=cpu`` the new jobs raise on a machine
with no GPU.
"""

import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from avenir_tpu.cli import jobs as jax_jobs
from avenir_tpu.cli import run as jax_run
from avenir_tpu.parallel import collectives as JC
from avenir_tpu.sequence import markov as JMK
from avenir_tpu.sequence import pst as JPS
from avenir_tpu_torch.cli import jobs as port_jobs
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.parallel.collectives import keyed_count, keyed_reduce
from avenir_tpu_torch.sequence import markov as MK
from avenir_tpu_torch.sequence import pst as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ9 = os.path.join(ROOT, "tests", "torch_fixtures", "seq9")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures")
CPU = "-Dplatform=cpu"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _load("seq9_make", os.path.join(SEQ9, "make.py"))
FLOWS = _load("golden_flows_port", os.path.join(ROOT, "tests", "golden",
                                                 "flows.py"))
SEQUENCE_JOBS = {"probabilisticSuffixTreeGenerator",
                 "candidateGenerationWithSelfJoin",
                 "sequencePositionalCluster", "sequenceGenerator",
                 "stateTransitionRate", "contTimeStateTransitionStats",
                 "eventTimeDistribution", "hiddenMarkovModelBuilder",
                 "viterbiStatePredictor", "markovStateTransitionModel",
                 "markovModelClassifier"}
# the jobs this family, association mining and the text jobs add
NEW_JOBS = sorted(SEQUENCE_JOBS | {
    "frequentItemsApriori", "infrequentItemMarker", "associationRuleMiner",
    "wordCounter", "ruleEvaluator", "temporalFilter"})


class _PortCLI:
    """``cli_run`` for tests/golden/flows.py: the port's runner on the
    CPU."""

    @staticmethod
    def main(argv):
        return port_run.main(list(argv) + [CPU])


def run_seq9_case(tmp_path, case):
    text, counters = MAKE.run_case(port_run.main, SEQ9, str(tmp_path), case,
                                   (CPU,))
    with open(os.path.join(SEQ9, case, "out.csv")) as fh:
        assert text == fh.read(), case
    with open(os.path.join(SEQ9, case, "counters.json")) as fh:
        assert counters == json.load(fh), case


# --------------------------------------------------------------------------
# end to end: the golden flows and seq9
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flow", ["markov", "conv", "buyhist", "sup",
                                  "visit"])
def test_golden_flow_byte_equal(tmp_path, monkeypatch, flow):
    monkeypatch.setattr(FLOWS, "cli_run", _PortCLI)
    outs = getattr(FLOWS, f"{flow}_flow")(str(tmp_path))
    assert outs
    for rel, text in outs.items():
        with open(os.path.join(GOLDEN, rel)) as fh:
            assert text == fh.read(), rel


@pytest.mark.parametrize("case", [c for c, (job, _, _) in MAKE.CASES.items()
                                  if job in SEQUENCE_JOBS])
def test_seq9_case_byte_equal(tmp_path, case):
    run_seq9_case(tmp_path, case)


def test_seq9_maker_reproduces_the_fixture(tmp_path):
    """The committed fixture is what the maker writes (in a fresh
    one-device process)."""
    import subprocess
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = (f"import sys; sys.path.insert(0, {SEQ9!r}); import make; "
            f"make.make({str(tmp_path)!r})")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   capture_output=True, cwd=ROOT, timeout=300)
    for case in MAKE.CASES:
        for f in ("out.csv", "counters.json"):
            with open(os.path.join(tmp_path, case, f)) as a, \
                    open(os.path.join(SEQ9, case, f)) as b:
                assert a.read() == b.read(), (case, f)
    for f in os.listdir(os.path.join(SEQ9, "data")):
        with open(os.path.join(tmp_path, "data", f)) as a, \
                open(os.path.join(SEQ9, "data", f)) as b:
            assert a.read() == b.read(), f


# --------------------------------------------------------------------------
# module level
# --------------------------------------------------------------------------

def _log_odds_inputs(L, seed, S=6, n=200):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, S, (n, L)).astype(np.int32)
    codes[rng.random((n, L)) < 0.03] = -1          # unknown states
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    lens[: n // 3] = L
    for i, ln in enumerate(lens):
        codes[i, ln:] = -1                         # padding
    m0 = rng.random((S, S)) * 1000
    m1 = rng.random((S, S)) * 1000
    m0[0, 1] = 0.0                                 # guarded to 1e-12
    m1[2, 3] = 0.0
    return codes, lens, m0, m1


@pytest.mark.parametrize("L", range(2, 65))
def test_log_odds_bit_equal_to_the_jax_kernel(L):
    codes, lens, m0, m1 = _log_odds_inputs(L, 100 + L)
    want = np.asarray(JMK._log_odds_kernel(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(m0),
        jnp.asarray(m1)))
    got = MK.log_odds(codes, lens, m0, m1, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_classify_threshold_and_labels_match():
    rng = np.random.default_rng(5)
    states = ["a", "b", "c", "d"]
    seqs = [list(rng.choice(states + ["z"], int(rng.integers(1, 40))))
            for _ in range(300)]
    labels = ["x" if i % 3 else "y" for i in range(300)]
    jm = JMK.build_model(seqs, states, labels=labels)
    pm = MK.build_model(seqs, states, labels=labels, device="cpu")
    assert pm.to_lines() == jm.to_lines()
    for thr in (0.0, -0.3, 0.25):
        jp, jlo = JMK.classify(jm, seqs, ["x", "y"], thr)
        pp, plo = MK.classify(pm, seqs, ["x", "y"], thr, device="cpu")
        assert pp == jp
        np.testing.assert_array_equal(plo, jlo)


def test_count_transitions_equal_across_chunks(monkeypatch):
    rng = np.random.default_rng(6)
    codes = rng.integers(-1, 5, (500, 17)).astype(np.int32)
    lens = rng.integers(0, 18, 500).astype(np.int32)
    cls = rng.integers(0, 3, 500).astype(np.int32)
    want = JMK.count_transitions(codes, lens, 5, cls, 3)
    np.testing.assert_array_equal(
        MK.count_transitions(codes, lens, 5, cls, 3, device="cpu"), want)
    monkeypatch.setattr(MK, "COUNT_CHUNK_PAIRS", 100)   # many launches
    np.testing.assert_array_equal(
        MK.count_transitions(codes, lens, 5, cls, 3, device="cpu"), want)


def _hmm(S, O, seed, tied=False):
    rng = np.random.default_rng(seed)
    if tied:
        tr = np.full((S, S), 250.0)
        np.fill_diagonal(tr, 500.0)
        em = np.full((S, O), 100.0)
        em[:, : O // 2] = 200.0
        init = np.full(S, 1000.0 / S)
    else:
        tr, em, init = (rng.random((S, S)) * 1000,
                        rng.random((S, O)) * 1000, rng.random(S) * 1000)
    return ([f"s{i}" for i in range(S)], [f"o{j}" for j in range(O)], tr,
            em, init)


@pytest.mark.parametrize("S,O,seed,tied", [(3, 6, 0, False),
                                          (4, 5, 1, False),
                                          (2, 3, 2, False),
                                          (6, 4, 3, False),
                                          (3, 6, 4, True),
                                          (5, 4, 5, True)])
def test_viterbi_paths_equal(S, O, seed, tied):
    states, obs, tr, em, init = _hmm(S, O, seed, tied)
    jh = JMK.HiddenMarkovModel(states, obs, tr, em, init)
    ph = MK.HiddenMarkovModel(states, obs, tr, em, init)
    rng = np.random.default_rng(seed + 50)
    seqs = [list(rng.choice(obs + ["unknown"], int(rng.integers(0, 30))))
            for _ in range(200)]
    assert MK.viterbi_decode(ph, seqs, device="cpu") == \
        JMK.viterbi_decode(jh, seqs)


def _rate_matrix(S, seed):
    rng = np.random.default_rng(seed)
    Q = rng.random((S, S)) * rng.uniform(0.2, 3.0)
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    return Q


@pytest.mark.parametrize("S", range(2, 7))
@pytest.mark.parametrize("count", [0.03, 3.0, 25.0, 125.0])
def test_uniformization_powers_bit_equal(S, count):
    """Series lengths 5 (count 0.03), 18, 59 and 200 (count 125)."""
    Q = _rate_matrix(S, 10 * S + int(count))
    q = float(np.max(-np.diag(Q)))
    t = count / q
    jq, jp, jl = JPS._uniformization_powers(Q, t)
    pq, pp, pl = PS._uniformization_powers(Q, t, device="cpu")
    assert (pq, pl) == (jq, jl)
    assert jl == int(4 + 6 * math.sqrt(q * t) + q * t)
    np.testing.assert_array_equal(pp, jp)
    for end in (None, S - 1):
        assert PS.ctmc_state_dwell_time(Q, t, 0, 1, end, precomputed=(
            pq, pp, pl)) == JPS.ctmc_state_dwell_time(Q, t, 0, 1, end)
        assert PS.ctmc_transition_count(Q, t, 0, 1, 0, end, precomputed=(
            pq, pp, pl)) == JPS.ctmc_transition_count(Q, t, 0, 1, 0, end)


@pytest.mark.parametrize("S", range(2, 7))
@pytest.mark.parametrize("t", [0.2, 1.5, 6.0])
def test_ctmc_transition_probabilities_bit_equal(S, t):
    Q = _rate_matrix(S, S)
    np.testing.assert_array_equal(
        PS.ctmc_transition_probabilities(Q, t, device="cpu"),
        JPS.ctmc_transition_probabilities(Q, t))


def test_rate_matrices_and_host_models_equal():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 5, 400)
    times = np.sort(rng.uniform(0, 1e10, 400))
    states = rng.integers(0, 3, 400)
    for unit in ("hour", "day", "week"):
        np.testing.assert_array_equal(
            PS.ctmc_rate_matrices(keys, times, states, 5, 3, unit),
            JPS.ctmc_rate_matrices(keys, times, states, 5, 3, unit))
    seqs = [list(rng.choice(list("abcd"), int(rng.integers(1, 12))))
            for _ in range(100)]
    pt, jt = PS.ProbabilisticSuffixTree(3), JPS.ProbabilisticSuffixTree(3)
    pt.add_sequences(seqs)
    jt.add_sequences(seqs)
    assert pt.to_lines() == jt.to_lines()
    assert pt.sequence_log_prob(seqs[0]) == jt.sequence_log_prob(seqs[0])
    assert PS.gsp_candidates(seqs[:30]) == JPS.gsp_candidates(seqs[:30])


@pytest.mark.parametrize("masked", [False, True])
def test_keyed_reduce_and_count_equal(masked):
    rng = np.random.default_rng(9)
    n, K, B = 5000, 7, 24
    keys = rng.integers(-1, K + 1, n).astype(np.int32)   # two drop
    bins = rng.integers(0, B, n)
    vals = np.zeros((n, B), np.float32)
    vals[np.arange(n), bins] = 1.0
    vals[:, 0] += rng.integers(0, 4, n)                  # integer sums
    mask = rng.random(n) < 0.7 if masked else None
    want = np.asarray(JC.keyed_reduce(
        jnp.asarray(vals), jnp.asarray(keys), K,
        None if mask is None else jnp.asarray(mask)))
    got = keyed_reduce(torch.from_numpy(vals), torch.from_numpy(keys), K,
                       None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    want_c = np.asarray(JC.keyed_count(
        jnp.asarray(keys), K, None if mask is None else jnp.asarray(mask)))
    got_c = keyed_count(torch.from_numpy(keys), K,
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got_c.numpy(), want_c)


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

def _jax_names():
    """JAX job function -> every name it is registered under."""
    assert jax_run  # the JAX CLI's import registers every job
    names = {}
    for name, fn in jax_jobs.JOBS.items():
        names.setdefault(fn, []).append(name)
    return names


@pytest.mark.parametrize("job", NEW_JOBS)
def test_new_job_resolves_under_every_reference_name(job):
    jfn = jax_jobs.resolve(job)
    pfn = port_jobs.resolve(job)
    for name in _jax_names()[jfn]:
        assert port_jobs.resolve(name) is pfn, name
    assert port_jobs.dist_mode(pfn) == jax_jobs.dist_mode(jfn)


def test_the_other_21_jobs_are_not_ported():
    """The 21 jobs this test once held unported are ported now: all 64 of
    the JAX package's jobs resolve in the port under every reference name,
    each with the JAX package's multi-process mode."""
    names = _jax_names()
    assert len(names) == 64
    for jfn, refs in names.items():
        pfns = {port_jobs.resolve(n) for n in refs}
        assert len(pfns) == 1, refs
        assert port_jobs.dist_mode(pfns.pop()) == jax_jobs.dist_mode(jfn), \
            refs


@pytest.mark.parametrize("job", NEW_JOBS)
def test_new_job_raises_without_a_gpu_unless_asked_for_the_cpu(tmp_path,
                                                               job):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        port_run.main([job, str(tmp_path / "in.csv"),
                       str(tmp_path / "out")])
