"""Group-wise batch bandit decisioning + the vectorized device path: port
of ``avenir_tpu/reinforce/batch.py``.

Parity targets (SURVEY.md §2.6):
  * Spark MultiArmBandit (spark/.../reinforce/MultiArmBandit.scala:61-146):
    per group, build a learner from saved model state, apply reward
    feedback, emit a batch of actions, save state back out.  GroupedBandits
    is that combineByKey/cogroup flow with plain dicts.
  * Hadoop GreedyRandomBandit / SoftMaxBandit etc. batch jobs: covered by
    the same flow with the matching algorithm.
  * The device path (VectorBandits): state as (groups, actions) arrays,
    one pass on the device selecting actions for every group at once — the
    reference's per-group JVM loops become gathers.  Its draws go through
    :mod:`..utils.threefry`, so it selects the JAX package's actions at the
    same key.

State file lines:   group,<learner state line>
Reward file lines:  group,action,reward
Action out lines:   group,action[,action...]
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..runtime import resolve_device
from ..utils import threefry as tf
from ..utils.xla_math import (fma_f32, fma_row_sum, seq_row_sum, sqrt_f32,
                              xla_log_f32)
from .learners import MultiArmBanditLearner, create_learner


class GroupedBandits:
    def __init__(self, algorithm: str, actions: Sequence[str],
                 config: Optional[Dict] = None):
        self.algorithm = algorithm
        self.actions = list(actions)
        self.config = dict(config or {})
        self.learners: Dict[str, MultiArmBanditLearner] = {}

    def learner(self, group: str) -> MultiArmBanditLearner:
        if group not in self.learners:
            cfg = dict(self.config)
            if cfg.get("random.seed") is not None:
                # distinct deterministic stream per group: string seeds hash
                # via sha512 inside random.Random — stable across processes
                # (builtin hash() is salted per process and must not be used)
                cfg["random.seed"] = f"{cfg['random.seed']}:{group}"
            self.learners[group] = create_learner(self.algorithm, self.actions,
                                                  cfg)
        return self.learners[group]

    # ---- state round trip (MultiArmBandit.scala:57-58,133-146) ----
    def load_state(self, lines: Sequence[str], delim: str = ",") -> None:
        per_group: Dict[str, List[str]] = {}
        for line in lines:
            group, _, rest = line.partition(delim)
            per_group.setdefault(group, []).append(rest)
        for group, state in per_group.items():
            learner = self.learner(group)
            learner.build_model(state)
            # advance the per-group stream past prior rounds so a restarted
            # job doesn't replay the identical random draws each round
            trials = sum(s.count for s in learner.stats.values())
            learner.total_trial_count = max(learner.total_trial_count, trials)
            if self.config.get("random.seed") is not None:
                learner.rng.seed(
                    f"{self.config['random.seed']}:{group}:{trials}")

    def save_state(self, delim: str = ",") -> List[str]:
        out = []
        for group in sorted(self.learners):
            for line in self.learners[group].get_model():
                out.append(f"{group}{delim}{line}")
        return out

    # ---- reward feedback ----
    def apply_rewards(self, lines: Sequence[str], delim: str = ",") -> None:
        for line in lines:
            group, action, reward = line.split(delim)[:3]
            self.learner(group).set_reward(action, float(reward))

    # ---- decisions ----
    def next_actions(self, groups: Optional[Sequence[str]] = None,
                     delim: str = ",") -> List[str]:
        groups = list(groups) if groups is not None else sorted(self.learners)
        out = []
        for g in groups:
            acts = self.learner(g).next_actions()
            out.append(delim.join([g] + acts))
        return out


class VectorBandits:
    """Device-vectorized bandits over (groups, actions) state arrays —
    all 11 factory algorithms (MultiArmBanditLearnerFactory.java:30-41).
    One call selects an action for every group at once on ``device``; the
    stateful algorithms (ucb2 epochs, pursuit probabilities, exp3/exp4
    weights, rewardComparison preferences) carry their extra state as
    (G, A)/(G, E) arrays updated by the same call or by ``set_rewards``.

    Each call splits the carried key (``split`` per call, on the device)
    and draws as the JAX package draws: ``normal`` (Thompson sampling),
    ``randint`` + ``uniform`` (epsilon-greedy), ``categorical`` (softmax,
    pursuit, reward comparison, exp3, exp4).  The float32 score arithmetic
    follows XLA's CPU code where a rounding could move an argmax: its
    ``log``, correctly rounded ``sqrt``, FMAs where XLA contracts a
    multiply-add.  Reward updates that are order-sensitive within a batch
    are applied in event order on the host, as in the JAX package.
    """

    ALGORITHMS = ("randomGreedy", "ucb1", "ucb2", "softMax",
                  "sampsonSampler", "optimisticSampsonSampler",
                  "intervalEstimator", "actionPursuit", "rewardComparison",
                  "exponentialWeight", "exponentialWeightExpert")

    def __init__(self, algorithm: str, n_groups: int, n_actions: int,
                 config: Optional[Dict] = None, seed: int = 0, device=None):
        if algorithm not in self.ALGORITHMS:
            raise ValueError(f"unknown bandit algorithm {algorithm!r}; "
                             f"known: {sorted(self.ALGORITHMS)}")
        self.algorithm = algorithm
        self.device = resolve_device(device)
        cfg = config or {}
        self.G, self.A = G, A = n_groups, n_actions
        self.counts = np.zeros((G, A), dtype=np.float32)
        self.sums = np.zeros((G, A), dtype=np.float32)
        self.sum_sqs = np.zeros((G, A), dtype=np.float32)
        self.epsilon = float(cfg.get("random.selection.prob", 0.1))
        self.temp = float(cfg.get("temp.constant", 0.1))
        self.bias = float(cfg.get("confidence.factor", 2.0))
        self.alpha = float(cfg.get("alpha", 0.1))
        self.learning_rate = float(cfg.get("learning.rate", 0.05))
        self.pref_step = float(cfg.get("preference.step", 0.1))
        self.ref_step = float(cfg.get("reference.reward.step", 0.1))
        self.distr_constant = float(cfg.get("distr.constant", 0.1))
        if algorithm == "ucb2":
            self.epochs = np.zeros((G, A), dtype=np.float32)
            self.remaining = np.zeros((G,), dtype=np.float32)
            self.current = np.zeros((G,), dtype=np.int32)
            # N counts selections, not rewards (the scalar learner's
            # total_trial_count)
            self.trials = np.zeros((G,), dtype=np.float32)
        elif algorithm == "actionPursuit":
            self.probs = np.full((G, A), 1.0 / A, dtype=np.float32)
        elif algorithm == "rewardComparison":
            self.prefs = np.zeros((G, A), dtype=np.float32)
            self.ref_reward = np.full(
                (G,), float(cfg.get("initial.reference.reward", 0.0)),
                dtype=np.float32)
        elif algorithm == "exponentialWeight":
            self.weights = np.ones((G, A), dtype=np.float32)
            self.last_probs = np.full((G, A), 1.0 / A, dtype=np.float32)
        elif algorithm == "exponentialWeightExpert":
            experts = cfg.get("experts")
            if experts is None:  # same default panel as the scalar learner
                experts = [[1.0 / A] * A]
                experts += [[1.0 if j == i else 0.0 for j in range(A)]
                            for i in range(A)]
            self.experts = np.asarray(experts, dtype=np.float32)   # (E, A)
            self.expert_weights = np.ones((G, self.experts.shape[0]),
                                          dtype=np.float32)
            self.last_probs = np.full((G, A), 1.0 / A, dtype=np.float32)
        self.key = tf.PRNGKey(seed, self.device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _select(self, key, counts, sums, sum_sqs):
        algo = self.algorithm
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        G, A = counts.shape
        inf = torch.full_like(counts, float("inf"))
        ones = torch.ones_like(counts)
        mean = sums / torch.maximum(counts, ones)
        untried = counts == 0

        def variance(mean):
            # XLA contracts sum_sqs - (counts * mean) * mean into an FMA
            return fma_f32(-(counts * mean), mean, sum_sqs) / \
                torch.maximum(counts - 1.0, ones)

        if algo == "randomGreedy":
            k1, k2 = tf.split(key, 2)
            greedy = torch.argmax(torch.where(untried, inf, mean), dim=1)
            rand = tf.randint(k1, (G,), 0, A).long()
            explore = tf.uniform(k2, (G,)) < f32(self.epsilon)
            return torch.where(explore, rand, greedy), {}
        if algo == "ucb1":
            N = torch.clamp(counts.sum(dim=1, keepdim=True), min=1.0)
            ub = mean + sqrt_f32(2.0 * xla_log_f32(N) /
                                 torch.maximum(counts, ones))
            return torch.argmax(torch.where(untried, inf, ub), dim=1), {}
        if algo == "ucb2":
            # epoch-committed UCB (UpperConfidenceBoundTwoLearner): while
            # remaining > 0 replay the committed arm, else pick by the
            # (1+a) bonus and commit for tau(r+1)-tau(r)-1 rounds
            epochs, remaining, current, trials = (
                self._t(self.epochs), self._t(self.remaining),
                self._t(self.current).long(), self._t(self.trials))
            base = f32(1 + self.alpha)

            def tau_of(r):
                return torch.ceil(torch.pow(torch.full_like(r, base), r))
            tau = tau_of(epochs)
            N = torch.clamp(trials, min=2.0)[:, None]
            arg = torch.clamp(f32(np.e) * N / tau, min=1.0)
            bonus = sqrt_f32(base * xla_log_f32(arg) / (2.0 * tau))
            ub = torch.where(untried, inf, mean + bonus)
            best = torch.argmax(ub, dim=1)
            sticky = remaining > 0
            action = torch.where(sticky, current, best)
            r_best = torch.gather(epochs, 1, best[:, None])[:, 0]
            span = tau_of(r_best + 1.0) - tau_of(r_best) - 1.0
            new_remaining = torch.where(sticky, remaining - 1.0,
                                        torch.clamp(span, min=0.0))
            bump = torch.nn.functional.one_hot(best, A).float() * \
                (~sticky)[:, None].float()
            return action, {"epochs": epochs + bump,
                            "remaining": new_remaining,
                            "current": action.int(), "trials": trials + 1.0}
        if algo == "softMax":
            return tf.categorical(key, mean / torch.full_like(
                mean, f32(self.temp)), axis=1), {}
        if algo in ("sampsonSampler", "optimisticSampsonSampler"):
            sd = sqrt_f32(torch.clamp(variance(mean), min=1e-12))
            z = tf.normal(key, (G, A))
            sample = mean + z * sd / sqrt_f32(torch.maximum(counts, ones))
            if algo == "optimisticSampsonSampler":
                sample = torch.maximum(sample, mean)  # floored at the mean
            return torch.argmax(torch.where(untried, inf, sample), dim=1), {}
        if algo == "intervalEstimator":
            sd = sqrt_f32(torch.clamp(variance(mean), min=0.0))
            ub = mean + f32(self.bias) * sd / sqrt_f32(
                torch.maximum(counts, ones))
            return torch.argmax(torch.where(untried, inf, ub), dim=1), {}
        if algo == "actionPursuit":
            # pursue the greedy arm toward probability 1, then sample
            probs = self._t(self.probs)
            greedy = torch.argmax(torch.where(untried, inf, mean), dim=1)
            oh = torch.nn.functional.one_hot(greedy, A).float()
            new_probs = fma_f32(oh - probs, f32(self.learning_rate), probs)
            action = tf.categorical(
                key, xla_log_f32(torch.clamp(new_probs, min=1e-30)), axis=1)
            return action, {"probs": new_probs}
        if algo == "rewardComparison":
            prefs = self._t(self.prefs)
            return tf.categorical(key, torch.clamp(prefs, max=700.0),
                                  axis=1), {}
        g, K = f32(self.distr_constant), A
        if algo == "exponentialWeight":
            weights = self._t(self.weights)
            sw = seq_row_sum(weights)[:, None]
            probs = f32(1 - g) * weights / sw + f32(g / K)
            action = tf.categorical(key, xla_log_f32(probs), axis=1)
            return action, {"last_probs": probs}
        if algo == "exponentialWeightExpert":
            ew = self._t(self.expert_weights)
            experts = self._t(self.experts)
            sw = seq_row_sum(ew)[:, None]
            share = ew / sw                                  # (G, E)
            # the (G, E) @ (E, A) product, each output a left-to-right FMA
            # chain over the experts
            mixed = fma_row_sum(share[:, None, :].expand(G, A, -1),
                                experts.T[None].expand(G, -1, -1))
            probs = fma_f32(mixed, f32(1 - g), f32(g / K))
            action = tf.categorical(key, xla_log_f32(probs), axis=1)
            return action, {"last_probs": probs}
        raise ValueError(f"algorithm {algo!r} has no vectorized form")

    def next_actions(self) -> np.ndarray:
        """(G,) action indices for every group."""
        self.key, sub = tf.split(self.key, 2)
        action, new = self._select(sub, self._t(self.counts),
                                   self._t(self.sums), self._t(self.sum_sqs))
        for name, val in new.items():
            setattr(self, name, val.cpu().numpy())
        return action.cpu().numpy()

    def set_rewards(self, group_idx: np.ndarray, action_idx: np.ndarray,
                    rewards: np.ndarray) -> None:
        np.add.at(self.counts, (group_idx, action_idx), 1.0)
        np.add.at(self.sums, (group_idx, action_idx), rewards)
        np.add.at(self.sum_sqs, (group_idx, action_idx), rewards ** 2)
        a = self.algorithm
        if a == "rewardComparison":
            # moving reference: order within the batch matters, like the
            # scalar learner's per-event updates
            for gi, ai, r in zip(group_idx, action_idx, rewards):
                delta = r - self.ref_reward[gi]
                self.prefs[gi, ai] += self.pref_step * delta
                self.ref_reward[gi] += self.ref_step * delta
        elif a == "exponentialWeight":
            g, K = self.distr_constant, self.A
            for gi, ai, r in zip(group_idx, action_idx, rewards):
                p = max(float(self.last_probs[gi, ai]), 1e-12)
                self.weights[gi, ai] *= np.exp(min(g * (r / p) / K, 60.0))
            # EXP3 sampling is invariant under per-group weight scaling;
            # renormalize so f32 weights can never overflow to inf over a
            # long serving run (they otherwise hit inf in ~2.5k rounds)
            self.weights /= np.maximum(
                self.weights.max(axis=1, keepdims=True), 1e-30)
        elif a == "exponentialWeightExpert":
            g, K = self.distr_constant, self.A
            for gi, ai, r in zip(group_idx, action_idx, rewards):
                p = max(float(self.last_probs[gi, ai]), 1e-12)
                xhat = r / p
                yhat = self.experts[:, ai] * xhat                # (E,)
                self.expert_weights[gi] *= np.exp(
                    np.minimum(g * yhat / K, 60.0))
            self.expert_weights /= np.maximum(
                self.expert_weights.max(axis=1, keepdims=True), 1e-30)
