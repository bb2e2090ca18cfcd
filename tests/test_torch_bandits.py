"""The batch bandits in the port (``avenir_tpu_torch/reinforce``, the
``multiArmBandit`` job and the four named Hadoop bandit jobs) against the
JAX package, on the CPU.

The learners are host code drawing from ``random.Random`` seeded by
string, as the JAX package's do, so the batch jobs reproduce the golden
``bandit`` and ``price`` fixtures and every mab9 case
(``tests/torch_fixtures/mab9/make.py``) byte for byte.  ``VectorBandits``
draws through the threefry twin and selects the JAX package's actions at
the same key, call after call, for all 11 algorithms.  The first part of
this file is the port's counterpart of ``tests/test_reinforce.py`` and
``tests/test_reinforce_jobs.py``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.reinforce.learners import LEARNERS, create_learner
from avenir_tpu_torch.reinforce.batch import GroupedBandits, VectorBandits
from avenir_tpu_torch.reinforce.serving import ReinforcementLearnerService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures")
MAB9 = os.path.join(ROOT, "tests", "torch_fixtures", "mab9")
CPU = "-Dplatform=cpu"


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "mab9_make", os.path.join(MAB9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()


@pytest.fixture(autouse=True)
def cpu_default():
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    yield
    set_default_device(None)


ACTIONS = ["a", "b", "c"]
TRUE_MEANS = {"a": 0.2, "b": 0.5, "c": 0.8}


def run_learner(algorithm, rounds=800, seed=3):
    rng = np.random.default_rng(seed)
    learner = create_learner(algorithm, ACTIONS,
                             {"random.seed": seed, "min.trial": 3})
    picks = []
    for _ in range(rounds):
        a = learner.next_action()
        picks.append(a)
        r = float(np.clip(rng.normal(TRUE_MEANS[a], 0.1), 0, 1))
        learner.set_reward(a, r)
    return learner, picks


@pytest.mark.parametrize("algorithm", sorted(LEARNERS))
def test_learner_converges(algorithm):
    learner, picks = run_learner(algorithm)
    late = picks[-200:]
    frac_best = late.count("c") / len(late)
    assert frac_best > 0.5, f"{algorithm}: best-arm rate {frac_best}"


@pytest.mark.parametrize("algorithm", sorted(LEARNERS))
def test_state_roundtrip(algorithm):
    learner, _ = run_learner(algorithm, rounds=100)
    lines = learner.get_model()
    fresh = create_learner(algorithm, ACTIONS, {"random.seed": 1})
    fresh.build_model(lines)
    for a in ACTIONS:
        assert fresh.stats[a].count == learner.stats[a].count
        assert abs(fresh.stats[a].mean - learner.stats[a].mean) < 1e-9
    # extra state (weights/prefs/epochs) preserved
    assert fresh.get_model() == lines


def test_unknown_algorithm():
    with pytest.raises(ValueError):
        create_learner("bogus", ACTIONS)


def test_auer_greedy_variant():
    rng = np.random.default_rng(8)
    learner = create_learner("randomGreedy", ACTIONS,
                             {"random.seed": 8, "min.trial": 2,
                              "prob.reduction.algorithm": "auerGreedy",
                              "auer.greedy.constant": 0.3})
    picks = []
    for _ in range(600):
        a = learner.next_action()
        picks.append(a)
        learner.set_reward(a, float(np.clip(rng.normal(TRUE_MEANS[a], 0.1),
                                            0, 1)))
    assert picks[-150:].count("c") / 150 > 0.5


def test_group_seeding_deterministic_across_rounds():
    """Recreated learners must not replay identical random draws each round
    (regression for the salted-hash / replayed-stream bug)."""
    from avenir_tpu_torch.reinforce.batch import GroupedBandits
    draws = []
    state = None
    for round_no in range(3):
        gb = GroupedBandits("randomGreedy", ACTIONS,
                            {"random.seed": 11, "random.selection.prob": 1.0})
        if state:
            gb.load_state(state)
        else:
            gb.learner("g")
        acts = gb.next_actions(["g"])
        draws.append(acts[0])
        for a in acts[0].split(",")[1:]:
            gb.apply_rewards([f"g,{a},0.5"])
        state = gb.save_state()
    # with epsilon=1 every pick is random; streams must differ across rounds
    assert len(set(draws)) > 1


def test_grouped_bandits_flow():
    gb = GroupedBandits("randomGreedy", ACTIONS,
                        {"random.seed": 5, "random.selection.prob": 0.2})
    rng = np.random.default_rng(0)
    # simulate 2 groups with different best arms
    best = {"g1": "c", "g2": "a"}
    for _ in range(300):
        for line in gb.next_actions(["g1", "g2"]):
            parts = line.split(",")
            g, acts = parts[0], parts[1:]
            for a in acts:
                r = 0.9 if a == best[g] else 0.1
                gb.apply_rewards([f"{g},{a},{r + rng.normal(0, 0.05):.4f}"])
    state = gb.save_state()
    assert any(l.startswith("g1,") for l in state)
    # reload into a fresh instance and check the learned best arms
    gb2 = GroupedBandits("randomGreedy", ACTIONS, {"random.seed": 6,
                                                   "random.selection.prob": 0.0})
    gb2.load_state(state)
    assert gb2.learner("g1")._greedy() == "c"
    assert gb2.learner("g2")._greedy() == "a"


def test_vector_bandits_device_path():
    G, A = 64, 4
    vb = VectorBandits("ucb1", G, A, seed=2)
    rng = np.random.default_rng(2)
    best = rng.integers(0, A, G)
    for _ in range(150):
        acts = vb.next_actions()
        rewards = np.where(acts == best, 0.9, 0.1) + rng.normal(0, 0.02, G)
        vb.set_rewards(np.arange(G), acts, rewards.astype(np.float32))
    final = vb.next_actions()
    assert (final == best).mean() > 0.9


@pytest.mark.parametrize("algo", ["randomGreedy", "softMax", "sampsonSampler",
                                  "intervalEstimator", "ucb2",
                                  "optimisticSampsonSampler", "actionPursuit",
                                  "rewardComparison", "exponentialWeight",
                                  "exponentialWeightExpert"])
def test_vector_bandits_algorithms(algo):
    vb = VectorBandits(algo, 16, 3, seed=1)
    rng = np.random.default_rng(1)
    for _ in range(200):
        acts = vb.next_actions()
        rewards = np.where(acts == 2, 0.8, 0.2) + rng.normal(0, 0.05, 16)
        vb.set_rewards(np.arange(16), acts, rewards.astype(np.float32))
    mean = vb.sums / np.maximum(vb.counts, 1)
    assert (vb.counts.argmax(axis=1) == 2).mean() > 0.6


def test_serving_loop():
    svc = ReinforcementLearnerService("randomGreedy", ACTIONS,
                                      {"random.seed": 7,
                                       "decision.batch.size": 2})
    out = svc.process("round,1")
    parts = out.split(",")
    assert parts[0] == "1" and len(parts) == 3
    svc.process(f"reward,{parts[1]},0.9")
    assert svc.learner.stats[parts[1]].count == 1
    # async loop
    svc.start()
    svc.event_queue.put("round,2")
    got = svc.action_queue.get(timeout=2)
    assert got.split(",")[0] in ("1", "2")
    svc.stop()
    with pytest.raises(ValueError):
        svc.process("bogus,1")


def test_vector_bandits_cover_all_factory_algorithms():
    """VERDICT r2 #6: the device path supports every algorithm the factory
    creates (MultiArmBanditLearnerFactory.java:30-41)."""
    from avenir_tpu_torch.reinforce.learners import LEARNERS
    from avenir_tpu_torch.reinforce.batch import VectorBandits
    assert set(VectorBandits.ALGORITHMS) == set(LEARNERS)


def test_vector_ucb2_epoch_commitment():
    """ucb2 commits to an arm for tau(r+1)-tau(r)-1 rounds after choosing."""
    vb = VectorBandits("ucb2", 4, 3, {"alpha": 2.0}, seed=3)
    rng = np.random.default_rng(3)
    # warm all arms so the inf-untried phase passes
    for a in range(3):
        acts = np.full(4, a)
        vb.set_rewards(np.arange(4), acts, rng.random(4).astype(np.float32))
    first = vb.next_actions()
    # with alpha=2: after the first committed pick, tau jumps 1 -> 3, so the
    # next 1+ rounds replay the same arm per group
    second = vb.next_actions()
    assert (first == second).all()


def test_vector_exp3_weights_move_toward_best():
    vb = VectorBandits("exponentialWeight", 8, 3,
                       {"distr.constant": 0.2}, seed=4)
    rng = np.random.default_rng(4)
    for _ in range(300):
        acts = vb.next_actions()
        rewards = np.where(acts == 1, 1.0, 0.0)
        vb.set_rewards(np.arange(8), acts, rewards.astype(np.float32))
    assert (vb.weights.argmax(axis=1) == 1).mean() > 0.8


def test_vector_reward_comparison_reference_moves():
    vb = VectorBandits("rewardComparison", 2, 2,
                       {"preference.step": 0.5,
                        "reference.reward.step": 0.5}, seed=5)
    vb.set_rewards(np.array([0, 0]), np.array([0, 1]),
                   np.array([1.0, 1.0], dtype=np.float32))
    # first event: pref[0,0] += .5*(1-0)=.5, ref->.5;
    # second: pref[0,1] += .5*(1-.5)=.25, ref->.75 (order-sensitive)
    assert abs(vb.prefs[0, 0] - 0.5) < 1e-6
    assert abs(vb.prefs[0, 1] - 0.25) < 1e-6
    assert abs(vb.ref_reward[0] - 0.75) < 1e-6
    assert vb.ref_reward[1] == 0.0


def test_vector_serving_loop():
    from avenir_tpu_torch.reinforce.serving import VectorLearnerService
    svc = VectorLearnerService("randomGreedy", ["a", "b", "c"], 4,
                               {"random.selection.prob": 0.0}, seed=9)
    # teach every group that 'b' pays
    for g in range(4):
        for act in ("a", "b", "c"):
            svc.process(f"reward,{g},{act},{0.9 if act == 'b' else 0.1}")
    out = svc.process("round,7")
    lines = out.splitlines()
    assert len(lines) == 4
    for g, line in enumerate(lines):
        rnd, grp, act = line.split(",")
        assert (rnd, grp, act) == ("7", str(g), "b")
    assert svc.action_queue.qsize() == 4


def test_vector_exp3_no_overflow_long_run():
    """f32 EXP3 weights must survive thousands of rewarded rounds (they are
    renormalized per update; unnormalized they hit inf at ~2.5k)."""
    vb = VectorBandits("exponentialWeight", 2, 3, seed=6)
    g = np.array([0, 1])
    for _ in range(3000):
        acts = vb.next_actions()
        vb.set_rewards(g, acts, np.ones(2, dtype=np.float32))
    assert np.isfinite(vb.weights).all()
    probs = vb.last_probs
    assert np.isfinite(probs).all() and (probs > 0).all()


def test_vector_ucb2_survives_delayed_rewards():
    """ucb2 selection must stay finite when rounds outpace rewards (the
    serving pattern): epochs advance per pick but N tracks trials, so the
    bonus can never go NaN and later rewards still steer the arm."""
    vb = VectorBandits("ucb2", 1, 2, seed=7)
    vb.set_rewards(np.zeros(2, int), np.array([0, 1]),
                   np.array([0.5, 0.5], dtype=np.float32))
    for _ in range(80):  # many unrewarded selections
        acts = vb.next_actions()
    assert np.isfinite(vb.epochs).all()
    # arm 1 becomes clearly better; the learner must switch to it
    for _ in range(60):
        acts = vb.next_actions()
        vb.set_rewards(np.zeros(1, int), acts,
                       np.where(acts == 1, 1.0, 0.0).astype(np.float32))
    picks = [int(vb.next_actions()[0]) for _ in range(10)]
    assert 1 in picks


def test_exploration_counter_reference_semantics():
    """ExplorationCounter.java:52-98: windowed forced exploration with
    wrap-around, inactive once the budget is spent."""
    from avenir_tpu_torch.reinforce.learners import ExplorationCounter
    ec = ExplorationCounter("g", count=5, exploration_count=12, batch_size=4)
    ec.select_next_round(1)   # remaining 12 -> beg 12%5=2, end 5 -> wraps
    assert ec.is_in_exploration()
    assert ec.should_explore(2) and ec.should_explore(4)
    assert ec.should_explore(0)  # wrapped segment 0..0
    assert not ec.should_explore(1)
    ec.select_next_round(3)   # remaining 12-8=4 -> beg 4, end 7 -> wraps
    assert ec.should_explore(4) and ec.should_explore(2)
    ec.select_next_round(4)   # remaining 0 -> exploration over
    assert not ec.is_in_exploration()
    assert not ec.should_explore(0)


def test_exploration_counter_non_wrapping_window():
    """A batch that fits inside the item set selects one contiguous
    window; items outside it are not forced."""
    from avenir_tpu_torch.reinforce.learners import ExplorationCounter
    ec = ExplorationCounter("g", count=10, exploration_count=6, batch_size=3)
    ec.select_next_round(1)   # remaining 6 -> beg 6, end 8: no wrap
    assert ec.selections == [(6, 8)]
    assert all(ec.should_explore(i) for i in (6, 7, 8))
    assert not any(ec.should_explore(i) for i in (0, 5, 9))
    ec.select_next_round(2)   # remaining 3 -> beg 3, end 5
    assert ec.selections == [(3, 5)]
    ec.select_next_round(3)   # remaining 0: budget spent exactly
    assert not ec.is_in_exploration()


def test_exploration_counter_batch_spanning_whole_set():
    """batch_size == count sweeps every item each round until the
    budget runs out."""
    from avenir_tpu_torch.reinforce.learners import ExplorationCounter
    ec = ExplorationCounter("g", count=4, exploration_count=8, batch_size=4)
    ec.select_next_round(1)   # remaining 8 -> beg 0, end 3
    assert all(ec.should_explore(i) for i in range(4))
    ec.select_next_round(2)   # remaining 4 -> beg 0, end 3
    assert all(ec.should_explore(i) for i in range(4))
    ec.select_next_round(3)
    assert not ec.is_in_exploration()


def test_min_trial_forces_round_robin_first():
    """Every arm must reach min.trial pulls before the policy scores
    (selectActionBasedOnMinTrial)."""
    learner = create_learner("ucb1", ACTIONS, {"min.trial": 2})
    picks = []
    for _ in range(6):
        a = learner.next_action()
        picks.append(a)
        learner.set_reward(a, 0.0 if a != "a" else 1.0)
    assert picks == ["a", "a", "b", "b", "c", "c"]
    # budget spent: scoring takes over (all-zero rewards except "a")
    assert learner.next_action() == "a"


def test_ucb1_decide_is_the_shared_scoring_body():
    """next_action == argmax of ucb1_upper_bound over the same stats —
    the formula the device twin jit-compiles."""
    from avenir_tpu_torch.reinforce.learners import ucb1_upper_bound
    learner = create_learner("ucb1", ACTIONS)
    counts = {"a": 8, "b": 3, "c": 5}
    means = {"a": 0.40, "b": 0.55, "c": 0.50}
    for act in ACTIONS:
        learner.set_reward_stats(act, counts[act], means[act], 0.05)
    N = learner.total_trial_count + 1          # the pull being decided
    expect = max(ACTIONS,
                 key=lambda act: ucb1_upper_bound(means[act], counts[act],
                                                  max(N, 1)))
    assert learner.next_action() == expect


def test_ucb1_untried_arm_scores_infinite():
    learner = create_learner("ucb1", ACTIONS)
    learner.set_reward_stats("a", 50, 0.99, 0.0)
    learner.set_reward_stats("c", 50, 0.98, 0.0)
    assert learner.next_action() == "b"        # count 0 outranks any mean


def test_softmax_decide_is_the_shared_weight_body():
    """Replay the seeded RNG against softmax_weight: the learner's draw
    must land exactly where the shared body's distribution says."""
    import random as _random
    from avenir_tpu_torch.reinforce.learners import softmax_weight
    learner = create_learner("softMax", ACTIONS,
                             {"random.seed": 7, "temp.constant": 0.1})
    means = {"a": 0.2, "b": 0.6, "c": 0.4}
    for act in ACTIONS:
        learner.set_reward_stats(act, 5, means[act], 0.0)
    twin = _random.Random(7)
    for _ in range(20):
        probs = {act: softmax_weight(means[act], 0.1) for act in ACTIONS}
        total = sum(probs.values())
        r = twin.random() * total
        acc, expect = 0.0, ACTIONS[-1]
        for act in ACTIONS:
            acc += probs[act]
            if r <= acc:
                expect = act
                break
        assert learner.next_action() == expect


def test_sampson_decide_is_the_shared_sample_body():
    """Same replay for Thompson sampling: rng.gauss draws fed through
    sampson_sample pick the identical arm."""
    import math as _math
    import random as _random
    from avenir_tpu_torch.reinforce.learners import sampson_sample
    learner = create_learner("sampsonSampler", ACTIONS, {"random.seed": 11})
    for act, mean in (("a", 0.3), ("b", 0.5), ("c", 0.4)):
        learner.set_reward_stats(act, 9, mean, 0.2)
    twin = _random.Random(11)
    for _ in range(20):
        best, best_v = None, -float("inf")
        for act in ACTIONS:
            s = learner.stats[act]
            v = sampson_sample(s.mean, s.std_dev or 1.0, s.count,
                               twin.gauss(0.0, 1.0))
            if v > best_v:
                best, best_v = act, v
        assert learner.next_action() == best


def test_set_reward_accounting_matches_simple_stat():
    """count / total / total_sq accumulate exactly; mean and std_dev
    derive the sample statistics."""
    learner = create_learner("ucb1", ACTIONS)
    rewards = [0.5, 1.0, 0.25, 0.75]
    for r in rewards:
        learner.set_reward("b", r)
    s = learner.stats["b"]
    assert s.count == len(rewards)
    assert s.total == sum(rewards)
    assert s.total_sq == sum(r * r for r in rewards)
    assert abs(s.mean - np.mean(rewards)) < 1e-12
    assert abs(s.std_dev - np.std(rewards, ddof=1)) < 1e-12
    assert learner.rewarded


def test_set_reward_stats_reconstructs_mean_and_std():
    learner = create_learner("ucb1", ACTIONS)
    learner.set_reward_stats("a", 10, 0.6, 0.15)
    s = learner.stats["a"]
    assert s.count == 10
    assert abs(s.mean - 0.6) < 1e-12
    assert abs(s.std_dev - 0.15) < 1e-9


def test_next_actions_honors_decision_batch_size():
    learner = create_learner("softMax", ACTIONS,
                             {"random.seed": 1, "decision.batch.size": 5})
    batch = learner.next_actions()
    assert len(batch) == 5
    assert set(batch) <= set(ACTIONS)
    assert learner.total_trial_count == 5


# --------------------------------------------------------------------------
# counterparts of tests/test_reinforce_jobs.py
# --------------------------------------------------------------------------

def test_multi_arm_bandit_iterations(tmp_path):
    props = tmp_path / "mab.properties"
    props.write_text(
        "mab.action.list=x,y,z\n"
        "mab.algorithm=randomGreedy\n"
        "mab.random.selection.prob=0.3\n"
        "mab.decision.batch.size=4\n"
        "mab.random.seed=11\n"
        f"mab.model.state.file.in={tmp_path}/state_in\n"
        f"mab.model.state.file.out={tmp_path}/state_out\n"
        "mab.group.list=g1,g2\n")
    rng = np.random.default_rng(4)
    best = {"g1": "z", "g2": "x"}
    rewards_dir = tmp_path / "rewards"
    rewards_dir.mkdir()
    (rewards_dir / "part-r-00000").write_text("")  # first round: no feedback

    for it in range(12):
        rc = port_run.main(["multiArmBandit", CPU, f"-Dconf.path={props}",
                           str(rewards_dir), str(tmp_path / "decisions")])
        assert rc == 0
        decisions = (tmp_path / "decisions" / "part-r-00000"
                     ).read_text().splitlines()
        # simulate rewards for chosen actions
        lines = []
        for d in decisions:
            parts = d.split(",")
            g, acts = parts[0], parts[1:]
            for a in acts:
                r = 0.9 if a == best[g] else 0.1
                lines.append(f"{g},{a},{r + rng.normal(0, 0.05):.4f}")
        (rewards_dir / "part-r-00000").write_text("\n".join(lines))
        # rotate state
        os.replace(tmp_path / "state_out" / "part-r-00000",
                   tmp_path / "state_in")

    # after iterations the state should prefer the best arms
    state = (tmp_path / "state_in").read_text().splitlines()
    means = {}
    for l in state:
        if ",#" in l or l.split(",")[1].startswith("#"):
            continue
        g, a, c, t, tsq = l.split(",")
        if int(c) > 0:
            means.setdefault(g, {})[a] = float(t) / int(c)
    assert max(means["g1"], key=means["g1"].get) == "z"
    assert max(means["g2"], key=means["g2"].get) == "x"


def test_named_bandit_jobs(tmp_path):
    props = tmp_path / "p.properties"
    props.write_text("mab.action.list=a,b\nmab.group.list=g\n"
                     "mab.random.seed=1\n")
    for job in ("greedyRandomBandit", "softMaxBandit", "auerDeterministic",
                "randomFirstGreedyBandit"):
        out = tmp_path / job
        rc = port_run.main([job, CPU, f"-Dconf.path={props}",
                           str(tmp_path / "nonexistent"), str(out)])
        assert rc == 0
        lines = (out / "part-r-00000").read_text().splitlines()
        assert len(lines) == 1 and lines[0].startswith("g,")


# --------------------------------------------------------------------------
# byte for byte: the golden fixtures and mab9
# --------------------------------------------------------------------------

def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize("name,gen,args,props,akey", [
    ("bandit", "bandit_rewards_gen", (600, 22, 4), "bandit.properties",
     "actions.csv"),
    ("price", "price_revenue_gen", (1000, 44, 5), "price_opt.properties",
     "prices.csv")])
def test_golden_round_byte_for_byte(tmp_path, name, gen, args, props, akey):
    """tests/golden/flows.py's one-round MultiArmBandit flows (bandit,
    price) through the port's CLI."""
    import importlib
    if RES not in sys.path:
        sys.path.insert(0, RES)
    mod = importlib.import_module(f"gen.{gen}")
    rewards = tmp_path / "rewards.csv"
    rewards.write_text("\n".join(mod.generate(*args)))
    assert port_run.main([
        "org.avenir.spark.reinforce.MultiArmBandit", CPU,
        f"-Dconf.path={os.path.join(RES, props)}",
        "-Dmab.model.state.file.in=/nonexistent",
        f"-Dmab.model.state.file.out={tmp_path}/state/part",
        str(rewards), str(tmp_path / "actions")]) == 0
    assert _read(tmp_path / "actions" / "part-r-00000") == \
        _read(os.path.join(GOLDEN, name, akey))
    assert _read(tmp_path / "state" / "part" / "part-r-00000") == \
        _read(os.path.join(GOLDEN, name, "state.csv"))


@pytest.mark.parametrize("case", sorted(MAKE.cases()))
def test_mab9_rounds_byte_for_byte(tmp_path, case):
    job, extra = MAKE.cases()[case]
    got = MAKE.run_rounds(lambda a: port_run.main([a[0], CPU, *a[1:]]),
                          job, extra, str(tmp_path))
    with open(os.path.join(MAB9, "rounds.json")) as fh:
        assert got == json.load(fh)[case]


def test_mab9_vector_selections():
    """VectorBandits in the port selects the fixture's actions, three
    calls of every algorithm with rewards between them."""
    got = MAKE.run_vector(VectorBandits, device="cpu")
    with np.load(os.path.join(MAB9, "vector.npz")) as z:
        assert sorted(z.files) == sorted(got)
        for algo in z.files:
            np.testing.assert_array_equal(got[algo], z[algo], err_msg=algo)


@pytest.mark.parametrize("algo", VectorBandits.ALGORITHMS)
def test_vector_bandits_equal_the_jax_package(algo):
    """Same key, same state: the same actions call after call, and the
    same carried float32 state (pursuit probabilities, exp3/exp4 sampling
    probabilities, ucb2 epochs), bit for bit."""
    from avenir_tpu.reinforce.batch import VectorBandits as JaxVector
    cfg = {"random.selection.prob": 0.3, "temp.constant": 0.2}
    j = JaxVector(algo, 48, 5, cfg, seed=31)
    t = VectorBandits(algo, 48, 5, cfg, seed=31, device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(4):
        a = np.asarray(j.next_actions())
        np.testing.assert_array_equal(t.next_actions(), a)
        for name in ("probs", "last_probs", "epochs", "remaining",
                     "current", "trials"):
            if hasattr(j, name):
                np.testing.assert_array_equal(
                    np.asarray(getattr(t, name)).view(np.int32),
                    np.asarray(getattr(j, name)).view(np.int32), name)
        gi = np.concatenate([np.arange(48), rng.integers(0, 48, 20)])
        ai = np.concatenate([a, rng.integers(0, 5, 20)])
        r = rng.normal(0.5, 0.4, len(gi)).astype(np.float32)
        j.set_rewards(gi, ai, r)
        t.set_rewards(gi, ai, r)


def test_mab9_make_reproduces_the_fixture(tmp_path):
    out = str(tmp_path / "mab9")
    MAKE.make(out)
    assert _read(os.path.join(out, "rounds.json")) == \
        _read(os.path.join(MAB9, "rounds.json"))
    with np.load(os.path.join(out, "vector.npz")) as a, \
            np.load(os.path.join(MAB9, "vector.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_wire_serving_loop_over_the_ports_broker():
    """RedisServingLoop polls the port's RESP broker with the reference's
    verbs as in-process; the paying arm's mean leads, and the rewards
    queued before 'stop' still reach the learner."""
    from avenir_tpu_torch.io.respq import RespClient, RespServer
    from avenir_tpu_torch.reinforce.serving import RedisServingLoop
    server = RespServer().start()
    try:
        cfg = {"redis.server.port": server.port}
        svc = ReinforcementLearnerService(
            "randomGreedy", ["a", "b"],
            config={"current.decision.round": 1, "batch.size": 1,
                    "random.seed": 3})
        loop = RedisServingLoop(svc, cfg)
        env = RespClient(port=server.port)
        for rnd in range(1, 60):
            env.lpush("eventQueue", f"round,{rnd}")
            assert loop.poll_once()
            out = env.rpop("actionQueue")
            assert out is not None and out.split(",")[0] == str(rnd)
            action = out.split(",")[1]
            env.lpush("rewardQueue",
                      f"reward,{action},{1.0 if action == 'b' else 0.0}")
            assert loop.poll_once()
        env.lpush("rewardQueue", "reward,b,1.0")
        env.lpush("rewardQueue", "reward,a,0.0")
        env.lpush("eventQueue", "stop")
        loop.run(max_idle_s=1.0)
        assert loop.stopped
        assert env.llen("rewardQueue") == 0
        assert svc.learner.stats["b"].mean > svc.learner.stats["a"].mean
        loop.close()
        env.close()
    finally:
        server.stop()
