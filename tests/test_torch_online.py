"""The port's online learning plane (``avenir_tpu_torch/online``) on the
CPU: a counterpart of each test of ``tests/test_online.py``, the port
against the JAX package on the same inputs, and the online9 fixture
(``tests/torch_fixtures/online9/make.py``).

Tolerances: bandit and logistic heads none — decisions, probabilities,
counters and the state's bytes equal the JAX package's.  The MLP head's
parameters come from torch's autograd, not XLA's gradient, so they are
held within MLP_ATOL (absolute, float32) and its reply labels are counted
where they differ, each with its logit margin.

Inside pytest the JAX package sees 8 CPU devices: it pads every window to
a multiple of 8 and shards the rows over them, which changes its sums'
order.  The live side-by-side tests give its plane a one-device context
and buckets that are multiples of 8; the fixture is made in a fresh
one-device process.
"""

import contextlib
import importlib.util
import io
import math
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from avenir_tpu_torch.control.controller import (OnlineSupervisor,
                                                 OnlineSupervisorPolicy)
from avenir_tpu_torch.control.journal import (ONLINE_PROBATION,
                                              ONLINE_SNAPSHOT, OnlineJournal)
from avenir_tpu_torch.core import faults as port_faults
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.online.plane import (OnlineWindowPlane,
                                           PendingOutcomeTable,
                                           grad_block_order)
from avenir_tpu_torch.online.service import (OnlineLearnerService,
                                             OnlineRespLoop,
                                             reward_ack_token)
from avenir_tpu_torch.online.state import (OnlineLearnerConfig, init_state,
                                           state_from_bytes, state_to_bytes)
from avenir_tpu_torch.pipeline.cache import program_cache
from avenir_tpu_torch.runtime import set_default_device
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.utils.tracing import TransferLedger, transfer_ledger

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
ONLINE9 = os.path.join(TESTS, "torch_fixtures", "online9")
MLP_ATOL = 1e-5
_CLOCK = re.compile(rb'"pinned_unix": [0-9.e+-]+')


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "online9_make", os.path.join(ONLINE9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()


@pytest.fixture(autouse=True)
def _cpu_and_fresh_cache():
    """The port on the CPU, and an empty process-global ProgramCache:
    tallies must not depend on the tests run before."""
    set_default_device("cpu")
    program_cache().clear()
    yield
    set_default_device(None)
    port_faults.uninstall()


def _one_device():
    from avenir_tpu.parallel.mesh import MeshContext, make_mesh
    return MeshContext(make_mesh(n_devices=1))


def bandit_cfg(**kw):
    kw.setdefault("actions", ("a", "b", "c"))
    return OnlineLearnerConfig(**kw)


def req(rid, row=()):
    return (rid, np.asarray(row, np.float32))


# --------------------------------------------------------------------------
# config + state serialization
# --------------------------------------------------------------------------

def test_config_validation():
    with pytest.raises(ValueError, match="action"):
        OnlineLearnerConfig(actions=())
    with pytest.raises(ValueError, match="device form"):
        bandit_cfg(algorithm="epsilonGreedy")
    with pytest.raises(ValueError, match="head"):
        bandit_cfg(head="forest")
    with pytest.raises(ValueError, match="mlp_hidden"):
        bandit_cfg(head="mlp", n_features=4)
    with pytest.raises(ValueError, match="n_features"):
        bandit_cfg(head="mlp", mlp_hidden=8)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_features=3, head="mlp", mlp_hidden=4),
    dict(n_features=2, seed=2 ** 32 + 5, mlp_hidden=3, mlp_classes=3)])
def test_state_bytes_deterministic_and_equal_to_jax(kw):
    from avenir_tpu.online import state as jstate
    cfg = bandit_cfg(**kw)
    b1, b2 = state_to_bytes(init_state(cfg)), state_to_bytes(init_state(cfg))
    assert b1 == b2
    back = state_from_bytes(b1, init_state(cfg))
    assert state_to_bytes(back) == b1
    # the JAX package's bytes: the key as uint32, the MLP's draws
    assert b1 == jstate.state_to_bytes(jstate.init_state(
        jstate.OnlineLearnerConfig(**dict(kw, actions=("a", "b", "c")))))


def test_state_bytes_refuses_layout_mismatch():
    small = init_state(bandit_cfg(n_features=2))
    big_t = init_state(bandit_cfg(n_features=5))
    with pytest.raises(ValueError, match="payload|template|leaf"):
        state_from_bytes(state_to_bytes(small), big_t)
    with pytest.raises(ValueError, match="state payload"):
        state_from_bytes(b"junkbytes", small)


# --------------------------------------------------------------------------
# pending-outcome table
# --------------------------------------------------------------------------

def test_pending_table_join_orphan_evict():
    t = PendingOutcomeTable(capacity=2, ttl_s=0.0)
    t.put("a", np.zeros(1), (0, 0.5, -1))
    t.put("b", np.zeros(1), (1, 0.5, -1))
    t.put("c", np.zeros(1), (2, 0.5, -1))   # full: evicts "a"
    assert t.evicted == 1 and len(t) == 2
    assert t.join("a") is None and t.orphans == 1
    x, dec = t.join("b")
    assert dec == (1, 0.5, -1) and t.joined == 1
    assert t.stats() == {"pending": 1, "joined": 1, "orphans": 1,
                         "shed": 0, "evicted": 1}


def test_pending_table_ttl_shedding_uses_injected_clock():
    now = [0.0]
    t = PendingOutcomeTable(capacity=8, ttl_s=10.0, clock=lambda: now[0])
    t.put("a", np.zeros(1), (0, 0.5, -1))
    now[0] = 5.0
    t.put("b", np.zeros(1), (1, 0.5, -1))
    now[0] = 11.0
    assert t.shed_expired() == 1
    assert t.join("a") is None
    assert t.join("b") is not None
    assert t.shed == 1


def test_pending_table_re_decision_newest_wins():
    t = PendingOutcomeTable(capacity=4, ttl_s=0.0)
    t.put("a", np.zeros(1), (0, 0.1, -1))
    t.put("a", np.full(1, 7.0), (2, 0.9, -1))
    x, dec = t.join("a")
    assert dec == (2, 0.9, -1) and float(x[0]) == 7.0
    assert len(t) == 0


# --------------------------------------------------------------------------
# the window: one dispatch, warm windows allocate nothing
# --------------------------------------------------------------------------

def test_one_dispatch_per_window_at_the_online_site():
    plane = OnlineWindowPlane(bandit_cfg(), buckets=(4,))
    led = TransferLedger()
    with transfer_ledger(led):
        plane.run_window([req("r0"), req("r1")], [])
    assert led.site_snapshot() == {"online.window": 1}
    with transfer_ledger(led):
        plane.run_window([req("r2")], [("r0", 1.0)])
    assert led.site_snapshot() == {"online.window": 2}


def test_warm_windows_retrace_nothing():
    plane = OnlineWindowPlane(bandit_cfg(n_features=2), buckets=(4,))
    plane.run_window([req("r0", (0.5, 1.0))], [])
    cold = plane.run_stats()["retraces"]
    for t in range(1, 6):
        plane.run_window([req(f"r{t}", (0.1 * t, -1.0))],
                         [(f"r{t-1}", 1.0)])
    s = plane.run_stats()
    assert s["retraces"] == cold
    assert s["windows"] == 6 and s["joined"] == 5


def test_warm_windows_reuse_the_staging_buffers():
    """A hit hands back the same device tensors: nothing is allocated."""
    plane = OnlineWindowPlane(bandit_cfg(n_features=2), buckets=(4,))
    pipe = plane._pipeline
    with pipe.staged({"x": np.zeros((4, 3), np.float32)}) as first:
        pass
    with pipe.staged({"x": np.ones((4, 3), np.float32)}) as again:
        assert again["x"].data_ptr() == first["x"].data_ptr()
        assert float(again["x"].sum()) == 12.0


def test_a_staging_entry_has_one_holder_at_a_time():
    """Two planes of one config share the cache's buffers: the second
    waits for the first's window before it copies its inputs in."""
    import threading
    cfg = bandit_cfg(n_features=2)
    a = OnlineWindowPlane(cfg, buckets=(4,))._pipeline
    b = OnlineWindowPlane(cfg, buckets=(4,))._pipeline
    entered = threading.Event()
    seen = []

    def second():
        with b.staged({"x": np.ones((4, 3), np.float32)}) as got:
            entered.set()
            seen.append(float(got["x"].sum()))
    with a.staged({"x": np.zeros((4, 3), np.float32)}) as mine:
        t = threading.Thread(target=second)
        t.start()
        assert not entered.wait(0.3)
        assert float(mine["x"].sum()) == 0.0
    t.join(10)
    assert seen == [12.0]
    assert (a.run_stats()["misses"], b.run_stats()["hits"]) == (1, 1)


def test_bucket_padding_is_shape_stable_across_window_sizes():
    plane = OnlineWindowPlane(bandit_cfg(), buckets=(8, 16))
    plane.run_window([req("a")], [])
    cold = plane.run_stats()["retraces"]
    plane.run_window([req(f"b{i}") for i in range(3)], [])
    assert plane.run_stats()["retraces"] == cold
    plane.run_window([req(f"c{i}") for i in range(9)], [])
    assert plane.run_stats()["retraces"] > cold


def test_buckets_round_by_the_contexts_device_count():
    from avenir_tpu_torch.parallel.mesh import DeviceMesh, MeshContext
    plane = OnlineWindowPlane(bandit_cfg(), buckets=(5, 9),
                              ctx=MeshContext(DeviceMesh(["cpu"] * 4)))
    assert plane.buckets == (8, 12)
    assert OnlineWindowPlane(bandit_cfg(), buckets=(5, 9)).buckets == (5, 9)


def test_unknown_reward_is_a_counted_orphan_not_a_crash():
    plane = OnlineWindowPlane(bandit_cfg(), buckets=(4,))
    decisions, outcomes = plane.run_window([req("r0")], [("ghost", 1.0)])
    assert len(decisions) == 1 and outcomes == []
    assert plane.run_stats()["orphans"] == 1


# --------------------------------------------------------------------------
# the shared bodies and the host learners
# --------------------------------------------------------------------------

def _plant_stats(plane, counts, totals, total_sqs):
    carries = plane.carries
    bandit = {"counts": np.asarray(counts, np.float32),
              "totals": np.asarray(totals, np.float32),
              "total_sqs": np.asarray(total_sqs, np.float32)}
    plane._pipeline.install_carries((bandit,) + tuple(carries[1:]))


def test_ucb1_device_decision_matches_host_learner():
    from avenir_tpu_torch.reinforce.learners import create_learner
    actions = ("x", "y", "z")
    host = create_learner("ucb1", list(actions))
    counts = np.array([7, 3, 11], np.float64)
    means = np.array([0.4, 0.9, 0.2])
    for i, a in enumerate(actions):
        host.set_reward_stats(a, int(counts[i]), float(means[i]), 0.1)
    plane = OnlineWindowPlane(bandit_cfg(actions=actions), buckets=(4,))
    _plant_stats(plane, counts, counts * means,
                 counts * (0.1 ** 2 + means ** 2))
    decisions, _ = plane.run_window([req("r0")], [])
    assert actions[decisions[0][1]] == host.next_action()


def test_ucb1_shared_body_is_the_host_formula():
    from avenir_tpu_torch.reinforce.learners import ucb1_upper_bound
    assert ucb1_upper_bound(0.5, 4, 100) == \
        0.5 + math.sqrt(2.0 * math.log(100) / 4)


def test_softmax_shared_body_is_the_host_formula():
    from avenir_tpu_torch.reinforce.learners import softmax_weight
    assert softmax_weight(0.3, 0.1) == math.exp(min(0.3 / 0.1, 700))
    assert softmax_weight(1e6, 0.001) == math.exp(700)


def test_sampson_shared_body_is_the_host_formula():
    from avenir_tpu_torch.reinforce.learners import sampson_sample
    import random
    r1, r2 = random.Random(3), random.Random(3)
    mu, sigma, n = 0.4, 0.25, 9
    old = r1.gauss(mu, sigma / math.sqrt(n))
    new = sampson_sample(mu, sigma, n, r2.gauss(0.0, 1.0))
    assert old == new


@pytest.mark.parametrize("algorithm", ["ucb1", "softMax",
                                       "sampsonSampler"])
def test_absorb_matches_host_reward_accounting(algorithm):
    from avenir_tpu_torch.reinforce.learners import create_learner
    actions = ("x", "y")
    plane = OnlineWindowPlane(bandit_cfg(actions=actions,
                                         algorithm=algorithm), buckets=(4,))
    host = create_learner(algorithm, list(actions))
    rewards = [("x", 1.0), ("y", 0.25), ("x", 0.5), ("x", 0.0)]
    for a, v in rewards:
        host.set_reward(a, v)
    plane.run_window([req(f"r{i}") for i in range(len(rewards))], [])
    for i, (a, v) in enumerate(rewards):
        ent = plane.pending._entries[f"r{i}"]
        plane.pending._entries[f"r{i}"] = \
            (ent[0], (actions.index(a),) + ent[1][1:], ent[2])
    plane.run_window([], [(f"r{i}", v) for i, (a, v) in enumerate(rewards)])
    bandit = {k: v.numpy() for k, v in plane.carries[0].items()}
    for i, a in enumerate(actions):
        s = host.stats[a]
        assert bandit["counts"][i] == s.count
        np.testing.assert_allclose(bandit["totals"][i], s.total, rtol=1e-6)
        np.testing.assert_allclose(bandit["total_sqs"][i], s.total_sq,
                                   rtol=1e-6)


def test_absorb_adds_each_arms_rewards_in_window_order():
    """Many non-dyadic rewards for one arm in one window: float32 sums
    depend on the order, and the port's equal the JAX package's scatter
    (row order), while a reversed order differs."""
    from avenir_tpu.reinforce import online_forms as jforms
    from avenir_tpu_torch.reinforce import online_forms as pforms
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    R, A = 256, 8
    arms = rng.integers(0, 3, R).astype(np.int32)
    vals = rng.uniform(0, 1, R).round(4).astype(np.float32)
    mask = (rng.random(R) < 0.9).astype(np.float32)
    start = [rng.uniform(0, 50, A).astype(np.float32) for _ in range(3)]
    want = jforms.absorb_rewards(*(jnp.asarray(s) for s in start),
                                 jnp.asarray(arms), jnp.asarray(vals),
                                 jnp.asarray(mask))

    def port(arms, vals, mask):
        rank, steps = pforms.absorb_plan(arms, mask, A)
        return pforms.absorb_rewards(
            *(torch.from_numpy(s) for s in start), torch.from_numpy(arms),
            torch.from_numpy(vals), torch.from_numpy(mask),
            torch.from_numpy(rank), steps)
    got = port(arms, vals, mask)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              np.asarray(w).view(np.int32))
    rev = port(arms[::-1].copy(), vals[::-1].copy(), mask[::-1].copy())
    assert not np.array_equal(rev[1].numpy(), np.asarray(want[1]))


def test_absorb_plan_ranks_rows_within_their_arm():
    from avenir_tpu_torch.reinforce.online_forms import absorb_plan
    rank, steps = absorb_plan(np.array([2, 0, 2, 2, 1, 0]),
                              np.array([1, 1, 0, 1, 1, 1], np.float32), 3)
    assert rank.tolist() == [0, 0, 2, 1, 0, 1] and steps == 2
    rank, steps = absorb_plan(np.zeros(4, np.int32),
                              np.zeros(4, np.float32), 3)
    assert rank.tolist() == [0, 0, 0, 0] and steps == 0


def test_logistic_head_learns_a_separable_signal():
    cfg = bandit_cfg(n_features=1, head="logistic", learning_rate=0.5)
    plane = OnlineWindowPlane(cfg, buckets=(8,))
    rng = np.random.default_rng(0)
    prev = []
    for t in range(60):
        reqs = [(f"{t}:{i}", np.asarray([rng.uniform(-1, 1)], np.float32))
                for i in range(8)]
        plane.run_window(reqs, prev)
        prev = [(rid, 1.0 if float(row[0]) > 0 else 0.0)
                for (rid, row) in reqs]
    assert plane.logistic_w()[1] > 1.0
    decisions, _ = plane.run_window(
        [req("hi", (0.9,)), req("lo", (-0.9,))], prev)
    assert decisions[0][2] > 0.5 > decisions[1][2]


@pytest.mark.parametrize("R,nvec,first", [(8, 0, []), (16, 0, []),
                                          (64, 48, [0, 2, 4, 3, 1, 5]),
                                          (256, 224, [0, 4, 8, 12, 16, 20,
                                                      24, 5, 1, 9])])
def test_grad_block_order_is_xlas(R, nvec, first):
    got_nvec, order = grad_block_order(R)
    assert got_nvec == nvec and order[:len(first)] == first
    assert sorted(order) == list(range(nvec // 8))


# --------------------------------------------------------------------------
# the port against the JAX package, window by window
# --------------------------------------------------------------------------

def _stream(rng, windows, width):
    """(requests, rewards) per window: 4 features, 4-decimal rewards for
    60% of the still-pending requests, ghosts now and then."""
    pend, out = [], []
    for t in range(windows):
        n = int(rng.integers(1, width + 1))
        reqs = [(f"{t}:{i}", rng.normal(size=4).astype(np.float32) * 2)
                for i in range(n)]
        rw, keep = [], []
        for rid in pend:
            if rng.random() < 0.6:
                rw.append((rid, float(np.round(rng.uniform(-0.5, 1.5), 4))))
            else:
                keep.append(rid)
        if rng.random() < 0.2:
            rw.append((f"ghost{t}", 0.5))
        pend = keep + [r for r, _ in reqs]
        out.append((reqs, rw))
    return out


def _leaves(carries):
    from avenir_tpu_torch.online.state import _flatten, _host
    return {k: _host(v) for k, v in _flatten(carries)}


@pytest.mark.parametrize("algorithm,head,width", [
    ("ucb1", "bandit", 60), ("softMax", "bandit", 37),
    ("sampsonSampler", "bandit", 64), ("ucb1", "bandit", 250),
    ("softMax", "logistic", 64), ("sampsonSampler", "logistic", 250),
    ("ucb1", "mlp", 64)])
def test_windows_equal_the_jax_package(algorithm, head, width):
    """Every window's arms, probabilities and classes, and the state's
    bytes after it, equal the JAX plane's; the MLP head's parameters are
    held within MLP_ATOL and its differing classes counted."""
    from avenir_tpu.online.plane import OnlineWindowPlane as JPlane
    from avenir_tpu.online.state import OnlineLearnerConfig as JConfig
    kw = dict(actions=tuple("abcdefgh"), n_features=4, algorithm=algorithm,
              head=head, mlp_hidden=8 if head == "mlp" else 0,
              temp_constant=0.3, learning_rate=0.05,
              l2=0.01 if head == "mlp" else 0.0)
    buckets = (8, 64, 256)
    jp = JPlane(JConfig(**kw), buckets=buckets, ctx=_one_device())
    pp = OnlineWindowPlane(OnlineLearnerConfig(**kw), buckets=buckets)
    assert jp.buckets == pp.buckets
    cls_diffs = []
    for reqs, rw in _stream(np.random.default_rng(7), 25, width):
        dj, _ = jp.run_window(reqs, rw)
        dp, _ = pp.run_window(reqs, rw)
        if head != "mlp":
            assert dj == dp
            assert jp.state_bytes() == pp.state_bytes()
            continue
        assert [d[:3] for d in dj] == [d[:3] for d in dp]
        lj, lp = _leaves(jp.carries), _leaves(pp.carries)
        for k in lj:
            if "/mlp/" in k:
                np.testing.assert_allclose(lp[k], lj[k], rtol=0,
                                           atol=MLP_ATOL, err_msg=k)
            else:
                assert np.array_equal(lp[k], np.asarray(lj[k])), k
        cls_diffs += [d[0] for d, e in zip(dj, dp) if d[3] != e[3]]
    print(f"{algorithm}/{head}: MLP classes that differ: {cls_diffs}")


# --------------------------------------------------------------------------
# supervisor: snapshot cadence, rollback, resume, chaos
# --------------------------------------------------------------------------

def make_supervised(tmp_path, *, snapshot_every=2, floor=0,
                    floor_window=4, consecutive=1, head="bandit",
                    n_features=0, counters=None, name="onl"):
    cfg = bandit_cfg(head=head, n_features=n_features)
    plane = OnlineWindowPlane(cfg, buckets=(4,))
    reg = ModelRegistry(os.path.join(str(tmp_path), "registry"))
    sup = OnlineSupervisor(
        reg, name, os.path.join(str(tmp_path), "state"),
        policy=OnlineSupervisorPolicy(
            snapshot_every=snapshot_every, accuracy_floor=floor,
            floor_window=floor_window, floor_consecutive=consecutive,
            pos_class="a", neg_class="b"),
        counters=counters)
    svc = OnlineLearnerService(plane, supervisor=sup)
    return plane, reg, sup, svc


def test_attach_pins_the_first_snapshot(tmp_path):
    plane, reg, sup, svc = make_supervised(tmp_path)
    assert reg.pinned_version("onl") == 1
    assert sup.journal.stage == ONLINE_PROBATION
    assert reg.read_sidecar("onl", 1, "online_state.bin") == \
        plane.state_bytes()


def test_snapshot_restore_is_bit_identical(tmp_path):
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=100)
    svc.process_window(["predict,r0", "predict,r1"])
    svc.process_window(["reward,r0,1.0", "reward,r1,0.25"])
    v = sup.snapshot()
    before = plane.state_bytes()
    assert reg.read_sidecar("onl", v, "online_state.bin") == before
    svc.process_window(["predict,r2"])
    svc.process_window(["reward,r2,1.0"])
    assert plane.state_bytes() != before
    sup.rollback()
    assert plane.state_bytes() == before


def test_floor_breach_rolls_back_and_restarts_probation(tmp_path):
    counters = Counters()
    plane, reg, sup, svc = make_supervised(
        tmp_path, snapshot_every=100, floor=90, floor_window=4,
        counters=counters)
    pinned = plane.state_bytes()
    events = sup.on_window(["a", "a", "a", "a"], ["b", "b", "b", "b"])
    assert "rollback" in events
    assert plane.state_bytes() == pinned
    assert counters.get("Online", "FloorBreaches") == 1
    assert counters.get("Online", "Rollbacks") == 1
    assert sup.journal.stage == ONLINE_PROBATION
    assert sup.journal["rollbacks"] == 1
    assert sup.on_window(["a"] * 4, ["a"] * 4) == {}


def test_snapshot_cadence_counts_supervised_windows(tmp_path):
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=3)
    assert sup.on_window(["a"], ["a"]) == {}
    assert sup.on_window(["a"], ["a"]) == {}
    assert sup.on_window(["a"], ["a"]).get("snapshot") == 2
    assert reg.pinned_version("onl") == 2


def test_reward_acks_held_until_snapshot_commits(tmp_path):
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=3)
    replies, acks = svc.process_window(["predict,r0"])
    assert replies[0].startswith("r0,") and acks == []
    _, acks = svc.process_window(["reward,r0,1.0"])
    assert acks == []
    assert svc.stats()["held_acks"] == 1
    _, acks = svc.process_window(["predict,r1"])
    assert acks == [reward_ack_token("r0")]
    assert svc.stats()["held_acks"] == 0


def test_resume_restores_the_pinned_snapshot(tmp_path):
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=100)
    svc.process_window(["predict,r0"])
    svc.process_window(["reward,r0,1.0"])
    sup.snapshot()
    pinned = plane.state_bytes()
    svc.process_window(["predict,r1"])
    svc.process_window(["reward,r1,0.5"])
    plane2 = OnlineWindowPlane(bandit_cfg(), buckets=(4,))
    sup2 = OnlineSupervisor(
        reg, "onl", os.path.join(str(tmp_path), "state"),
        policy=OnlineSupervisorPolicy(snapshot_every=100))
    OnlineLearnerService(plane2, supervisor=sup2)
    assert plane2.state_bytes() == pinned
    assert sup2.journal.stage == ONLINE_PROBATION


def test_a_jax_snapshot_restores_in_the_port(tmp_path):
    """The registry sidecar the JAX supervisor wrote is the port's
    rollback target, byte for byte."""
    from avenir_tpu.online.plane import OnlineWindowPlane as JPlane
    from avenir_tpu.online.state import OnlineLearnerConfig as JConfig
    jp = JPlane(JConfig(actions=("a", "b", "c"), algorithm="softMax"),
                buckets=(8,), ctx=_one_device())
    jp.run_window([req("r0"), req("r1")], [])
    jp.run_window([req("r2")], [("r0", 0.3125), ("r1", 0.7071)])
    plane = OnlineWindowPlane(bandit_cfg(algorithm="softMax"), buckets=(8,))
    plane.restore(jp.state_bytes())
    assert plane.state_bytes() == jp.state_bytes()
    assert jp.run_window([req("r3")], [])[0] == \
        plane.run_window([req("r3")], [])[0]


@pytest.mark.faultinject
def test_chaos_kill_at_snapshot_fault_point(tmp_path):
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=100)
    svc.process_window(["predict,r0"])
    _, acks = svc.process_window(["reward,r0,1.0"])
    assert acks == []
    port_faults.install(port_faults.FaultInjector.parse(
        "online_snapshot@0=raise:RuntimeError"))
    with pytest.raises(RuntimeError, match="injected fault"):
        sup.snapshot()
    j = OnlineJournal(os.path.join(str(tmp_path), "state"))
    assert j.stage == ONLINE_SNAPSHOT and j.interrupted
    assert svc.stats()["held_acks"] == 1
    port_faults.uninstall()
    plane2 = OnlineWindowPlane(bandit_cfg(), buckets=(4,))
    sup2 = OnlineSupervisor(
        reg, "onl", os.path.join(str(tmp_path), "state"),
        policy=OnlineSupervisorPolicy(snapshot_every=100))
    svc2 = OnlineLearnerService(plane2, supervisor=sup2)
    assert reg.pinned_version("onl") == 1
    assert sup2.journal.stage == ONLINE_PROBATION
    replies, _ = svc2.process_window(["reward,r0,1.0"])
    assert replies == []
    assert plane2.run_stats()["orphans"] == 1


@pytest.mark.faultinject
def test_chaos_kill_at_restore_fault_point(tmp_path):
    counters = Counters()
    plane, reg, sup, svc = make_supervised(
        tmp_path, snapshot_every=100, floor=90, floor_window=4,
        counters=counters)
    pinned = plane.state_bytes()
    port_faults.install(port_faults.FaultInjector.parse(
        "online_restore@0=raise:RuntimeError"))
    with pytest.raises(RuntimeError, match="injected fault"):
        sup.on_window(["a"] * 4, ["b"] * 4)
    j = OnlineJournal(os.path.join(str(tmp_path), "state"))
    assert j.interrupted
    port_faults.uninstall()
    plane2 = OnlineWindowPlane(bandit_cfg(), buckets=(4,))
    sup2 = OnlineSupervisor(
        reg, "onl", os.path.join(str(tmp_path), "state"),
        policy=OnlineSupervisorPolicy(snapshot_every=100))
    OnlineLearnerService(plane2, supervisor=sup2)
    assert plane2.state_bytes() == pinned
    assert sup2.journal.stage == ONLINE_PROBATION


def test_restore_refuses_signature_mismatch():
    plane = OnlineWindowPlane(bandit_cfg(n_features=2), buckets=(4,))
    plane.run_window([req("r0", (0.1, 0.2))], [])
    other = OnlineWindowPlane(bandit_cfg(n_features=3), buckets=(4,))
    with pytest.raises(ValueError):
        plane.restore(other.state_bytes())


# --------------------------------------------------------------------------
# service parsing + the wire tier
# --------------------------------------------------------------------------

def test_service_strict_parse_counts_near_misses():
    svc = OnlineLearnerService(OnlineWindowPlane(bandit_cfg(n_features=2),
                                                 buckets=(4,)))
    bad = list(MAKE.MALFORMED)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        replies, acks = svc.process_window(bad + ["predict,r9,0.5,1.5"])
    assert len(replies) == 1 and replies[0].startswith("r9,")
    assert acks == []
    assert svc.counters.get("Online", "BadRequests") == len(bad)
    assert any("malformed" in str(x.message) for x in w)


def test_service_without_supervisor_acks_at_window_end():
    svc = OnlineLearnerService(OnlineWindowPlane(bandit_cfg(),
                                                 buckets=(4,)))
    svc.process_window(["predict,r0"])
    _, acks = svc.process_window(["reward,r0,1.0"])
    assert acks == [reward_ack_token("r0")]


def test_lease_rid_understands_reward():
    from avenir_tpu_torch.io.respq import _lease_rid
    assert _lease_rid("reward,r7,0.5", ",") == "reward:r7"
    assert _lease_rid("predict,r7,1,2", ",") == "r7"
    assert _lease_rid("reward,", ",") is None
    assert _lease_rid("reward", ",") is None
    assert _lease_rid("stop", ",") is None


def test_sharded_routing_sends_reward_to_its_requests_shard():
    from avenir_tpu_torch.io.respq import ShardedRespClient
    cli = ShardedRespClient.__new__(ShardedRespClient)
    cli._delim = ","
    assert cli.id_of("predict,r42,1,2") == "r42"
    assert cli.id_of("reward,r42,0.5") == "r42"
    assert cli.id_of("reward:r42,acked") == "r42"
    assert cli.id_of("stop") == "stop"


def _drain(cli, queue):
    out = []
    while True:
        v = cli.rpop(queue)
        if v is None:
            return out
        out.append(v)


def test_wire_e2e_leased_rewards_ack_on_snapshot(tmp_path):
    import time
    from avenir_tpu_torch.io.respq import RespClient, RespServer
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=2)
    server = RespServer().start()
    try:
        cli = RespClient(port=server.port)
        loop = OnlineRespLoop(svc, cli, batch=8, lease_s=0.15)
        cli.lpush_many("requestQueue", ["predict,r0", "predict,r1"])
        assert loop.run(max_windows=1) == 1
        assert {v.split(",")[0] for v in _drain(cli, "predictionQueue")} \
            == {"r0", "r1"}
        cli.lpush("requestQueue", "reward,r0,1.0")
        assert loop.run(max_windows=1) == 1
        assert cli.rpop("rewardAckQueue") == reward_ack_token("r0")
        time.sleep(0.25)
        assert cli.rpop("requestQueue") is None
        assert plane.run_stats()["joined"] == 1
        cli.close()
    finally:
        server.stop()


def test_wire_e2e_unacked_reward_redelivers_after_lease_expiry(tmp_path):
    import time
    from avenir_tpu_torch.io.respq import RespClient, RespServer
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=100)
    server = RespServer().start()
    try:
        cli = RespClient(port=server.port)
        loop = OnlineRespLoop(svc, cli, batch=8, lease_s=0.15)
        cli.lpush("requestQueue", "predict,r0")
        loop.run(max_windows=1)
        cli.lpush("requestQueue", "reward,r0,1.0")
        loop.run(max_windows=1)
        assert svc.stats()["held_acks"] == 1
        assert cli.rpop("rewardAckQueue") is None
        time.sleep(0.25)
        assert cli.rpop("requestQueue") == "reward,r0,1.0"
        cli.close()
    finally:
        server.stop()


def test_wire_stop_flushes_held_acks(tmp_path):
    from avenir_tpu_torch.io.respq import RespClient, RespServer
    plane, reg, sup, svc = make_supervised(tmp_path, snapshot_every=100)
    server = RespServer().start()
    try:
        cli = RespClient(port=server.port)
        loop = OnlineRespLoop(svc, cli, batch=8, lease_s=30.0)
        cli.lpush_many("requestQueue", ["predict,r0"])
        loop.run(max_windows=1)
        cli.lpush_many("requestQueue", ["reward,r0,1.0", "stop"])
        loop.run()
        assert cli.rpop("rewardAckQueue") == reward_ack_token("r0")
        assert svc.stats()["held_acks"] == 0
        cli.close()
    finally:
        server.stop()


def test_service_export_and_metrics_binding():
    from avenir_tpu_torch.telemetry.metrics import MetricsRegistry
    svc = OnlineLearnerService(OnlineWindowPlane(bandit_cfg(),
                                                 buckets=(4,)))
    svc.process_window(["predict,r0"])
    svc.process_window(["reward,r0,1.0"])
    c = Counters()
    svc.export(c)
    assert c.get("Online", "Joined") == 1
    assert c.get("OnlineProgramCache", "Chunks") == 2
    reg = MetricsRegistry()
    svc.bind_metrics(reg)
    text = reg.render()
    assert "avenir_online_state" in text
    assert 'key="windows"' in text


# --------------------------------------------------------------------------
# the CLI job
# --------------------------------------------------------------------------

def _port_main(args):
    from avenir_tpu_torch.cli import run as port_run
    with contextlib.redirect_stdout(io.StringIO()):
        return port_run.main([args[0], "-Dplatform=cpu", *args[1:]])


def _lines(out_dir):
    return [ln for f in sorted(os.listdir(out_dir)) if f.startswith("part-")
            for ln in open(os.path.join(out_dir, f)).read().splitlines()]


def test_online_learner_job_resolves_by_both_names():
    from avenir_tpu_torch.cli import run  # noqa: F401
    from avenir_tpu_torch.cli.jobs import resolve
    assert resolve("onlineLearner") is \
        resolve("org.avenir.online.OnlineLearner")


def test_online_learner_job_inprocess(tmp_path):
    msgs = []
    for i in range(6):
        msgs.append(f"predict,r{i}")
        if i >= 2:
            msgs.append(f"reward,r{i-2},1.0")
    src = tmp_path / "in.txt"
    src.write_text("\n".join(msgs) + "\n")
    out = tmp_path / "out"
    assert _port_main(["onlineLearner", "-Dps.online.actions=a,b",
                       "-Dps.online.window.size=4", str(src),
                       str(out)]) == 0
    lines = _lines(out)
    assert len(lines) == 6
    assert all(ln.split(",")[1] in ("a", "b") for ln in lines)
    import json
    with open(str(out) + ".counters.json") as fh:
        assert json.load(fh)["Online"]["Rewards"] == 4


def test_online_learner_job_resp_supervised(tmp_path):
    msgs = []
    for i in range(8):
        msgs.append(f"predict,r{i}")
        if i >= 1:
            msgs.append(f"reward,r{i-1},0.5")
    msgs.append("stop")
    src = tmp_path / "in.txt"
    src.write_text("\n".join(msgs) + "\n")
    out = tmp_path / "out"
    reg_dir = tmp_path / "registry"
    assert _port_main([
        "onlineLearner", "-Dps.online.actions=a,b,c",
        "-Dps.online.window.size=4", "-Dps.online.snapshot.every=1",
        "-Dps.transport=resp", f"-Dps.model.registry.dir={reg_dir}",
        "-Dps.model.name=onl", f"-Dps.online.state.dir={tmp_path / 'st'}",
        str(src), str(out)]) == 0
    lines = _lines(out)
    assert [ln.split(",")[0] for ln in lines] == [f"r{i}" for i in range(8)]
    assert ModelRegistry(str(reg_dir)).pinned_version("onl") >= 1


# --------------------------------------------------------------------------
# the online9 fixture
# --------------------------------------------------------------------------

def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_file(got, want):
    with open(got, "rb") as a, open(want, "rb") as b:
        return _CLOCK.sub(b'"pinned_unix": T', a.read()) == \
            _CLOCK.sub(b'"pinned_unix": T', b.read())


def _mlp_state_rel(got, want):
    """(largest MLP parameter gap, other leaves equal) of two state
    payloads."""
    from avenir_tpu_torch.online.state import _flatten, _host
    cfg = OnlineLearnerConfig(actions=tuple(MAKE.ACTIONS.split(",")),
                              n_features=MAKE.N_FEATURES, head="mlp",
                              mlp_hidden=8)
    t = init_state(cfg)
    g = dict(_flatten(state_from_bytes(got, t)))
    w = dict(_flatten(state_from_bytes(want, t)))
    gap = max(float(np.abs(g[k] - w[k]).max()) for k in g if "/mlp/" in k)
    rest = all(np.array_equal(_host(g[k]), _host(w[k]))
               for k in g if "/mlp/" not in k)
    return gap, rest


@pytest.mark.parametrize("case", MAKE.CASES)
def test_online9_case_matches_the_fixture(tmp_path, case):
    """The port's CLI over the case's inputs writes the fixture's files:
    replies, counters, the journal and every registry version's
    ``meta.json`` and state sidecar byte for byte (outside the pin's
    clock); case e's MLP parameters within MLP_ATOL."""
    work = str(tmp_path / "work")
    os.makedirs(work)
    MAKE.run_case(_port_main, port_faults, program_cache().clear, case,
                  work)
    got = str(tmp_path / "got")
    MAKE.keep(work, got, case)
    want = os.path.join(ONLINE9, case)
    assert _files(got) == _files(want)
    for rel in _files(want):
        g, w = os.path.join(got, rel), os.path.join(want, rel)
        if case == "e" and rel.endswith("online_state.bin"):
            with open(g, "rb") as a, open(w, "rb") as b:
                ga, wb = a.read(), b.read()
            hdr = 11 + int.from_bytes(wb[7:11], "little")
            assert ga[:hdr] == wb[:hdr], rel          # the header
            gap, rest = _mlp_state_rel(ga, wb)
            assert rest and gap <= MLP_ATOL, (rel, gap)
            continue
        assert _same_file(g, w), rel


def test_online9_fixture_cases_end_as_designed():
    import json
    for case in MAKE.CASES:
        with open(os.path.join(ONLINE9, case, "counters.json")) as fh:
            online = json.load(fh)["Online"]
        assert online["Requests"] == MAKE.N_PREDICTS
        assert online["BadRequests"] == len(MAKE.MALFORMED)
        assert online["Orphans"] > 0
    c = {k: json.load(open(os.path.join(ONLINE9, k, "counters.json")))
         for k in "fgh"}
    assert c["f"]["Online"]["Rollbacks"] >= 1
    assert c["g"]["Online"]["ResumedInterrupted"] == 1
    assert c["h"]["Online"]["Evicted"] > 0
    with open(os.path.join(ONLINE9, "g", "crashed.json")) as fh:
        assert json.load(fh)["stage"] == "snapshot"


def test_online9_warm_second_run_retraces_nothing(tmp_path):
    """Two runs of case a in one process: the second reuses every staging
    buffer (Retraces 0, Hits = its windows) and writes the same replies."""
    import json
    outs = []
    program_cache().clear()
    for k in range(2):
        work = str(tmp_path / f"w{k}")
        os.makedirs(work)
        src = os.path.join(work, "stream.txt")
        with open(src, "w") as fh:
            fh.write("\n".join(MAKE.stream()) + "\n")
        out = os.path.join(work, "out")
        keys = [a for a in MAKE.case_keys("a", work)
                if "registry" not in a and "model.name" not in a]
        assert _port_main(["onlineLearner", *keys, src, out]) == 0
        with open(out + ".counters.json") as fh:
            outs.append((_lines(out), json.load(fh)))
    (r1, c1), (r2, c2) = outs
    assert r1 == r2
    cache = c2["OnlineProgramCache"]
    assert cache["Retraces"] == 0 and cache["Misses"] == 0
    assert cache["Hits"] == c2["Online"]["Windows"] == cache["Chunks"]
    assert c1["OnlineProgramCache"]["Retraces"] > 0


def test_make_reproduces_the_fixture(tmp_path):
    """Rerun the JAX package's maker in a fresh one-device process into a
    temporary directory: every file equals the committed one (outside the
    pin's clock; samplers.npz array for array)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    out = str(tmp_path / "online9")
    res = subprocess.run([sys.executable, os.path.join(ONLINE9, "make.py"),
                          out], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    committed = [f for f in _files(ONLINE9) if f != "make.py"]
    assert _files(out) == committed
    for rel in committed:
        g, w = os.path.join(out, rel), os.path.join(ONLINE9, rel)
        if rel.endswith(".npz"):
            with np.load(g) as a, np.load(w) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert np.array_equal(a[k], b[k]), k
        else:
            assert _same_file(g, w), rel
