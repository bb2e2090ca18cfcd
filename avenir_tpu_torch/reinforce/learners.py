"""Multi-arm bandit learners: port of ``avenir_tpu/reinforce/learners.py``,
the 11 algorithms of the reference.  Host code: each learner draws from
its own ``random.Random``, seeded as the JAX package seeds it, so a batch
job's decisions and state files are the JAX package's byte for byte.

Parity target: the MultiArmBanditLearner hierarchy
(reinforce/MultiArmBanditLearner.java:36-184) and its factory
(reinforce/MultiArmBanditLearnerFactory.java:30-41) with algorithm names:

  intervalEstimator, sampsonSampler, optimisticSampsonSampler, randomGreedy,
  ucb1, ucb2, softMax, actionPursuit, rewardComparison, exponentialWeight,
  exponentialWeightExpert

Each learner keeps per-action reward statistics (count, mean, std — chombo
SimpleStat), exposes ``next_action`` / ``next_actions(batch)`` /
``set_reward`` and round-trips its state through ``get_model`` /
``build_model`` text lines, the contract the batch jobs and the serving
loop rely on (:113,138,184).  ``merge`` combines distributed partials.

State lines: ``actionId,count,sum,sumSq`` (+ algorithm-specific extra
lines prefixed with '#<name>').
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple


# ---- shared score bodies (host + device twins) -------------------------
#
# The scoring formulas live here as functions of plain arguments (the
# math functions are parameters), so that a device form of a learner can
# evaluate the same bodies over tensors: the host learners call them with
# python scalars and ``math.*``.

def ucb1_upper_bound(mean, count, total_count, *, log=math.log,
                     sqrt=math.sqrt):
    """UCB1 upper bound: mean + sqrt(2 ln N / n)
    (UpperConfidenceBoundOneLearner.java)."""
    return mean + sqrt(2.0 * log(total_count) / count)


def softmax_weight(mean, temp_constant, *, exp=math.exp, minimum=min):
    """Boltzmann sampling weight: exp(mean / tau), argument clamped at
    700 before exponentiation (SoftMaxLearner.java:62-90)."""
    return exp(minimum(mean / temp_constant, 700))


def sampson_sample(mean, sigma, count, unit_normal, *, sqrt=math.sqrt):
    """Thompson posterior draw: mean + (sigma / sqrt(n)) * z, with
    ``sigma`` the observed std dev already floored at 1.0 for the
    degenerate no-variance arm (SampsonSamplerLearner.java).  ``z`` is a
    unit-normal draw supplied by the caller — the host learner feeds
    ``random.Random.gauss(0, 1)`` — so the deterministic body stays
    shared while each caller owns its randomness."""
    return mean + (sigma / sqrt(count)) * unit_normal


class ActionStat:
    """chombo SimpleStat equivalent: count / sum / sum of squares."""

    __slots__ = ("count", "total", "total_sq")

    def __init__(self, count=0, total=0.0, total_sq=0.0):
        self.count = count
        self.total = total
        self.total_sq = total_sq

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.total_sq += value * value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def std_dev(self) -> float:
        if self.count < 2:
            return 0.0
        var = (self.total_sq - self.count * self.mean ** 2) / (self.count - 1)
        return math.sqrt(max(var, 0.0))


class MultiArmBanditLearner:
    """Base learner (MultiArmBanditLearner.java surface)."""

    name = "base"

    def __init__(self, actions: Sequence[str], config: Optional[Dict] = None):
        config = config or {}
        self.actions = list(actions)
        self.stats: Dict[str, ActionStat] = {a: ActionStat() for a in actions}
        self.min_trial = int(config.get("min.trial", -1))
        self.batch_size = int(config.get("decision.batch.size", 1))
        self.reward_scale = int(config.get("reward.scale", 1))
        self.round_num = int(config.get("current.decision.round", 1))
        self.total_trial_count = (self.round_num - 1) * self.batch_size
        self.rng = random.Random(config.get("random.seed"))
        self.rewarded = False

    # ---- selection ----
    def next_action(self) -> str:
        raise NotImplementedError

    def next_actions(self) -> List[str]:
        return [self.next_action() for _ in range(self.batch_size)]

    def _min_trial_action(self) -> Optional[str]:
        """Any action below the min trial count gets tried first
        (selectActionBasedOnMinTrial)."""
        if self.min_trial > 0:
            for a in self.actions:
                if self.stats[a].count < self.min_trial:
                    return a
        return None

    # ---- learning ----
    def set_reward(self, action: str, reward: float) -> None:
        self.stats[action].add(reward)
        self.rewarded = True

    def set_reward_stats(self, action: str, count: int, mean: float,
                         std_dev: float) -> None:
        """Batch learning path (:162-170)."""
        s = self.stats[action]
        s.count = count
        s.total = mean * count
        s.total_sq = (std_dev ** 2) * max(count - 1, 0) + count * mean * mean

    def merge(self, other: "MultiArmBanditLearner") -> None:
        for a, st in other.stats.items():
            self.stats[a] = st

    # ---- state round trip ----
    def get_model(self) -> List[str]:
        lines = [f"{a},{s.count},{s.total},{s.total_sq}"
                 for a, s in self.stats.items()]
        return lines + self._extra_state()

    def build_model(self, lines: Sequence[str]) -> None:
        for line in lines:
            if line.startswith("#"):
                self._load_extra(line)
                continue
            a, c, t, tsq = line.split(",")
            self.stats[a] = ActionStat(int(c), float(t), float(tsq))
        self.rewarded = any(s.count > 0 for s in self.stats.values())

    def _extra_state(self) -> List[str]:
        return []

    def _load_extra(self, line: str) -> None:
        pass

    # helpers
    def _greedy(self) -> str:
        return max(self.actions, key=lambda a: self.stats[a].mean)

    def _random(self) -> str:
        return self.rng.choice(self.actions)

    def _sample_distr(self, probs: Dict[str, float]) -> str:
        total = sum(probs.values())
        r = self.rng.random() * total
        acc = 0.0
        for a in self.actions:
            acc += probs[a]
            if r <= acc:
                return a
        return self.actions[-1]


class IntervalEstimatorLearner(MultiArmBanditLearner):
    """Upper bound of the reward confidence interval
    (reinforce/IntervalEstimatorLearner.java)."""
    name = "intervalEstimator"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        self.bias_factor = float(cfg.get("confidence.factor", 2.0))

    def next_action(self) -> str:
        self.total_trial_count += 1
        a = self._min_trial_action()
        if a:
            return a
        def ub(a):
            s = self.stats[a]
            if s.count == 0:
                return float("inf")
            return s.mean + self.bias_factor * s.std_dev / math.sqrt(s.count)
        return max(self.actions, key=ub)


class SampsonSamplerLearner(MultiArmBanditLearner):
    """Thompson sampling from the per-action reward posterior
    (reinforce/SampsonSamplerLearner.java)."""
    name = "sampsonSampler"
    optimistic = False

    def next_action(self) -> str:
        self.total_trial_count += 1
        a = self._min_trial_action()
        if a:
            return a
        best, best_v = None, -float("inf")
        for act in self.actions:
            s = self.stats[act]
            if s.count == 0:
                v = float("inf") if not self.optimistic else 1e12
            else:
                v = sampson_sample(s.mean, s.std_dev or 1.0, s.count,
                                   self.rng.gauss(0.0, 1.0))
                if self.optimistic:
                    v = max(v, s.mean)
            if v > best_v:
                best, best_v = act, v
        return best


class OptimisticSampsonSamplerLearner(SampsonSamplerLearner):
    """Optimistic variant: sampled value floored at the observed mean
    (reinforce/OptimisticSampsonSamplerLearner.java)."""
    name = "optimisticSampsonSampler"
    optimistic = True


class RandomGreedyLearner(MultiArmBanditLearner):
    """epsilon-greedy with none/linear/logLinear epsilon decay and the Auer
    greedy variant (reinforce/RandomGreedyLearner.java:57-95,
    GreedyRandomBandit.java:150-205)."""
    name = "randomGreedy"
    PROB_RED_NONE = "none"
    PROB_RED_LINEAR = "linear"
    PROB_RED_LOG_LINEAR = "logLinear"

    AUER_GREEDY = "auerGreedy"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        self.random_selection_prob = float(cfg.get("random.selection.prob", 0.1))
        self.prob_red_algorithm = cfg.get("prob.reduction.algorithm", "none")
        self.prob_red_constant = float(cfg.get("prob.reduction.constant", 1.0))
        self.auer_constant = float(cfg.get("auer.greedy.constant", 1.0))

    def _current_prob(self) -> float:
        if self.prob_red_algorithm == self.PROB_RED_NONE:
            p = self.random_selection_prob
        elif self.prob_red_algorithm == self.PROB_RED_LINEAR:
            p = self.random_selection_prob * self.prob_red_constant / \
                max(self.total_trial_count, 1)
        elif self.prob_red_algorithm == self.PROB_RED_LOG_LINEAR:
            t = max(self.total_trial_count, 2)
            p = self.random_selection_prob * self.prob_red_constant * \
                math.log(t) / t
        else:
            raise ValueError("Invalid probability reduction algorithms")
        return min(p, self.random_selection_prob)

    def next_action(self) -> str:
        self.total_trial_count += 1
        a = self._min_trial_action()
        if a:
            return a
        if self.prob_red_algorithm == self.AUER_GREEDY:
            return self._auer_next()
        if self.rng.random() < self._current_prob():
            return self._random()
        return self._greedy()

    def _auer_next(self) -> str:
        """Auer's epsilon_n = min(1, cK/(d^2 n)) with d the normalized gap
        between the two best rewards (GreedyRandomBandit.greedyAuerSelect
        :270-310; equal top rewards force exploration)."""
        means = sorted((self.stats[a].mean for a in self.actions), reverse=True)
        max_r, next_r = means[0], means[1] if len(means) > 1 else means[0]
        if max_r <= 0 or max_r == next_r:
            prob = 1.0
        else:
            d = (max_r - next_r) / max_r
            prob = min(1.0, self.auer_constant * len(self.actions) /
                       (d * d * max(self.total_trial_count, 1)))
        if self.rng.random() < prob:
            return self._random()
        return self._greedy()


class UpperConfidenceBoundOneLearner(MultiArmBanditLearner):
    """UCB1: mean + sqrt(2 ln N / n)
    (reinforce/UpperConfidenceBoundOneLearner.java)."""
    name = "ucb1"

    def next_action(self) -> str:
        self.total_trial_count += 1
        a = self._min_trial_action()
        if a:
            return a
        N = max(self.total_trial_count, 1)
        def ub(act):
            s = self.stats[act]
            if s.count == 0:
                return float("inf")
            return ucb1_upper_bound(s.mean, s.count, N)
        return max(self.actions, key=ub)


class UpperConfidenceBoundTwoLearner(MultiArmBanditLearner):
    """UCB2 with epoch lengths tau(r) = ceil((1+alpha)^r)
    (reinforce/UpperConfidenceBoundTwoLearner.java)."""
    name = "ucb2"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        self.alpha = float(cfg.get("alpha", 0.1))
        self.epochs: Dict[str, int] = {a: 0 for a in actions}
        self.remaining = 0
        self.current: Optional[str] = None

    def _tau(self, r: int) -> int:
        return int(math.ceil((1 + self.alpha) ** r))

    def next_action(self) -> str:
        self.total_trial_count += 1
        if self.current is not None and self.remaining > 0:
            self.remaining -= 1
            return self.current
        N = max(self.total_trial_count, 2)
        def ub(act):
            s = self.stats[act]
            if s.count == 0:
                return float("inf")
            tau = self._tau(self.epochs[act])
            bonus = math.sqrt((1 + self.alpha) * math.log(math.e * N / tau)
                              / (2 * tau))
            return s.mean + bonus
        best = max(self.actions, key=ub)
        r = self.epochs[best]
        self.remaining = max(self._tau(r + 1) - self._tau(r) - 1, 0)
        self.epochs[best] = r + 1
        self.current = best
        return best

    def _extra_state(self):
        ep = ",".join(f"{a}:{self.epochs[a]}" for a in self.actions)
        return [f"#ucb2,{ep}"]

    def _load_extra(self, line):
        if line.startswith("#ucb2,"):
            for tok in line.split(",", 1)[1].split(","):
                a, r = tok.split(":")
                self.epochs[a] = int(r)


class SoftMaxLearner(MultiArmBanditLearner):
    """Boltzmann exploration: p ~ exp(mean / tempConstant)
    (reinforce/SoftMaxLearner.java:62-90)."""
    name = "softMax"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        self.temp_constant = float(cfg.get("temp.constant", 0.1))

    def next_action(self) -> str:
        self.total_trial_count += 1
        a = self._min_trial_action()
        if a:
            return a
        probs = {}
        for act in self.actions:
            mean = self.stats[act].mean
            probs[act] = softmax_weight(mean, self.temp_constant)
        return self._sample_distr(probs)


class ActionPursuitLearner(MultiArmBanditLearner):
    """Pursuit: probability of the greedy action pursued toward 1
    (reinforce/ActionPursuitLearner.java)."""
    name = "actionPursuit"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        self.learning_rate = float(cfg.get("learning.rate", 0.05))
        self.probs: Dict[str, float] = {a: 1.0 / len(actions) for a in actions}

    def next_action(self) -> str:
        self.total_trial_count += 1
        a = self._min_trial_action()
        if a:
            return a
        greedy = self._greedy()
        for act in self.actions:
            p = self.probs[act]
            if act == greedy:
                self.probs[act] = p + self.learning_rate * (1.0 - p)
            else:
                self.probs[act] = p - self.learning_rate * p
        return self._sample_distr(self.probs)

    def _extra_state(self):
        pr = ",".join(f"{a}:{self.probs[a]}" for a in self.actions)
        return [f"#pursuit,{pr}"]

    def _load_extra(self, line):
        if line.startswith("#pursuit,"):
            for tok in line.split(",", 1)[1].split(","):
                a, p = tok.split(":")
                self.probs[a] = float(p)


class RewardComparisonLearner(MultiArmBanditLearner):
    """Preference learning vs a moving reference reward; softmax over
    preferences (reinforce/RewardComparisonLearner.java)."""
    name = "rewardComparison"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        self.pref_step = float(cfg.get("preference.step", 0.1))
        self.ref_step = float(cfg.get("reference.reward.step", 0.1))
        self.ref_reward = float(cfg.get("initial.reference.reward", 0.0))
        self.prefs: Dict[str, float] = {a: 0.0 for a in actions}

    def next_action(self) -> str:
        self.total_trial_count += 1
        a = self._min_trial_action()
        if a:
            return a
        probs = {a: math.exp(min(self.prefs[a], 700)) for a in self.actions}
        return self._sample_distr(probs)

    def set_reward(self, action: str, reward: float) -> None:
        super().set_reward(action, reward)
        self.prefs[action] += self.pref_step * (reward - self.ref_reward)
        self.ref_reward += self.ref_step * (reward - self.ref_reward)

    def _extra_state(self):
        pr = ",".join(f"{a}:{self.prefs[a]}" for a in self.actions)
        return [f"#prefs,{pr}", f"#refReward,{self.ref_reward}"]

    def _load_extra(self, line):
        if line.startswith("#prefs,"):
            for tok in line.split(",", 1)[1].split(","):
                a, p = tok.split(":")
                self.prefs[a] = float(p)
        elif line.startswith("#refReward,"):
            self.ref_reward = float(line.split(",")[1])


class ExponentialWeightLearner(MultiArmBanditLearner):
    """EXP3 (reinforce/ExponentialWeightLearner.java:56-90): sampling
    distribution (1-g) w/sum(w) + g/K; weight update
    w *= exp(g * (r/p) / K)."""
    name = "exponentialWeight"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        self.distr_constant = float(cfg.get("distr.constant", 0.1))
        self.weights: Dict[str, float] = {a: 1.0 for a in actions}
        self.last_probs: Dict[str, float] = {a: 1.0 / len(actions)
                                             for a in actions}

    def _probs(self) -> Dict[str, float]:
        sw = sum(self.weights.values())
        K = len(self.actions)
        g = self.distr_constant
        return {a: (1 - g) * self.weights[a] / sw + g / K for a in self.actions}

    def next_action(self) -> str:
        self.total_trial_count += 1
        self.last_probs = self._probs()
        return self._sample_distr(self.last_probs)

    def set_reward(self, action: str, reward: float) -> None:
        super().set_reward(action, reward)
        K = len(self.actions)
        g = self.distr_constant
        p = max(self.last_probs.get(action, 1.0 / K), 1e-12)
        x = reward / p
        self.weights[action] *= math.exp(min(g * x / K, 700))

    def _extra_state(self):
        w = ",".join(f"{a}:{self.weights[a]}" for a in self.actions)
        return [f"#weights,{w}"]

    def _load_extra(self, line):
        if line.startswith("#weights,"):
            for tok in line.split(",", 1)[1].split(","):
                a, wv = tok.split(":")
                self.weights[a] = float(wv)


class ExponentialWeightExpertLearner(ExponentialWeightLearner):
    """EXP4 (reinforce/ExponentialWeightExpertLearner.java): expert advice
    vectors mixed by expert weights.  Experts are provided as a matrix of
    per-action probabilities via config 'experts' (list of lists); expert
    weights updated by the estimated reward of their advice."""
    name = "exponentialWeightExpert"

    def __init__(self, actions, config=None):
        super().__init__(actions, config)
        cfg = config or {}
        experts = cfg.get("experts")
        if experts is None:
            # default experts: one uniform + one per action (pure strategies)
            K = len(actions)
            experts = [[1.0 / K] * K]
            for i in range(K):
                experts.append([1.0 if j == i else 0.0 for j in range(K)])
        self.experts = [list(map(float, e)) for e in experts]
        self.expert_weights = [1.0] * len(self.experts)

    def _probs(self) -> Dict[str, float]:
        sw = sum(self.expert_weights)
        K = len(self.actions)
        g = self.distr_constant
        mixed = [0.0] * K
        for wi, advice in zip(self.expert_weights, self.experts):
            for j in range(K):
                mixed[j] += wi * advice[j] / sw
        return {a: (1 - g) * mixed[j] + g / K
                for j, a in enumerate(self.actions)}

    def set_reward(self, action: str, reward: float) -> None:
        MultiArmBanditLearner.set_reward(self, action, reward)
        K = len(self.actions)
        g = self.distr_constant
        j = self.actions.index(action)
        p = max(self.last_probs.get(action, 1.0 / K), 1e-12)
        xhat = reward / p
        for ei, advice in enumerate(self.experts):
            yhat = advice[j] * xhat
            self.expert_weights[ei] *= math.exp(min(g * yhat / K, 700))

    def _extra_state(self):
        w = ",".join(str(v) for v in self.expert_weights)
        return [f"#expertWeights,{w}"]

    def _load_extra(self, line):
        if line.startswith("#expertWeights,"):
            self.expert_weights = [float(v)
                                   for v in line.split(",", 1)[1].split(",")]


LEARNERS = {
    cls.name: cls for cls in [
        IntervalEstimatorLearner, SampsonSamplerLearner,
        OptimisticSampsonSamplerLearner, RandomGreedyLearner,
        UpperConfidenceBoundOneLearner, UpperConfidenceBoundTwoLearner,
        SoftMaxLearner, ActionPursuitLearner, RewardComparisonLearner,
        ExponentialWeightLearner, ExponentialWeightExpertLearner,
    ]
}


def create_learner(algorithm: str, actions: Sequence[str],
                   config: Optional[Dict] = None) -> MultiArmBanditLearner:
    """MultiArmBanditLearnerFactory.create (:30-41)."""
    cls = LEARNERS.get(algorithm)
    if cls is None:
        raise ValueError(f"unknown bandit algorithm {algorithm!r}; known: "
                         f"{sorted(LEARNERS)}")
    return cls(actions, config)


class ExplorationCounter:
    """Round-based exploration scheduling (reinforce/ExplorationCounter
    .java:27-118): a group of ``count`` items is force-explored for the
    first ``exploration_count`` selections, ``batch_size`` per round,
    sweeping item-index windows (wrapping at the group boundary) until the
    budget is spent."""

    def __init__(self, group_id: str, count: int, exploration_count: int,
                 batch_size: int):
        self.group_id = group_id
        self.count = count
        self.exploration_count = exploration_count
        self.batch_size = batch_size
        self.selections: List[Tuple[int, int]] = []

    def select_next_round(self, round_num: int) -> None:
        remaining = self.exploration_count - (round_num - 1) * self.batch_size
        self.selections = []
        if remaining > 0:
            beg = remaining % self.count
            end = beg + self.batch_size - 1
            if end >= self.count:  # batch wraps the item-set boundary
                self.selections.append((beg, self.count - 1))
                self.selections.append((0, end - self.count))
            else:
                self.selections.append((beg, end))

    def is_in_exploration(self) -> bool:
        return bool(self.selections)

    def should_explore(self, item_index: int) -> bool:
        return any(lo <= item_index <= hi for lo, hi in self.selections)
