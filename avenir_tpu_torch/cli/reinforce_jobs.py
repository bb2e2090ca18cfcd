"""Reinforce-pack jobs: port of ``avenir_tpu/cli/reinforce_jobs.py``, the
generic MultiArmBandit batch job + the named Hadoop bandit jobs as
algorithm presets (host code: the learners draw from ``random.Random``).

Parity targets: spark/.../reinforce/MultiArmBandit.scala:61-146 (generic,
model state round-tripped through files) and the Hadoop batch jobs
GreedyRandomBandit / SoftMaxBandit / AuerDeterministic /
RandomFirstGreedyBandit (reinforce/*.java), which are the same flow with a
fixed algorithm.

Config keys (mab.* namespace):
  mab.action.list           comma list of action ids (mandatory)
  mab.algorithm             factory name (default randomGreedy)
  mab.model.state.file.in   optional prior state file/dir
  mab.model.state.file.out  state output dir (default <out>/state)
  mab.decision.batch.size, mab.current.decision.round, mab.random.seed,
  plus algorithm knobs passed through (mab.random.selection.prob,
  mab.temp.constant, ...).
Input lines: group,action,reward  (reward feedback; may be empty dir).
Output: decisions 'group,action[,action...]' + saved state.
"""

from __future__ import annotations

import os
from typing import Dict

from ..core.config import Config
from ..core.metrics import Counters
from ..core import artifacts
from .jobs import register

_PASSTHROUGH_KEYS = [
    "min.trial", "decision.batch.size", "reward.scale",
    "current.decision.round", "random.seed", "random.selection.prob",
    "prob.reduction.algorithm", "prob.reduction.constant",
    "auer.greedy.constant",
    "confidence.factor", "temp.constant", "learning.rate", "alpha",
    "preference.step", "reference.reward.step", "initial.reference.reward",
    "distr.constant",
]


def _bandit_config(cfg: Config) -> Dict:
    out: Dict = {}
    for k in _PASSTHROUGH_KEYS:
        v = cfg.get(f"mab.{k}")
        if v is not None:
            out[k] = v
    if "random.seed" in out:
        out["random.seed"] = int(out["random.seed"])
    for ik in ("decision.batch.size", "min.trial", "current.decision.round",
               "reward.scale"):
        if ik in out:
            out[ik] = int(out[ik])
    return out


def _run_bandit(cfg: Config, in_path: str, out_path: str,
                algorithm: str) -> Counters:
    from ..reinforce.batch import GroupedBandits
    counters = Counters()
    actions = cfg.must_get_list("mab.action.list")
    gb = GroupedBandits(algorithm, actions, _bandit_config(cfg))
    delim = cfg.field_delim_out
    state_in = cfg.get("mab.model.state.file.in")
    if state_in and os.path.exists(state_in):
        gb.load_state(artifacts.read_text_input(state_in), delim)
    if in_path and os.path.exists(in_path):
        rewards = artifacts.read_text_input(in_path)
        gb.apply_rewards(rewards, delim)
        counters.increment("Bandit", "Rewards", len(rewards))
    if not gb.learners:
        groups = cfg.get_list("mab.group.list") or ["default"]
        for g in groups:
            gb.learner(g)
    decisions = gb.next_actions(delim=delim)
    artifacts.write_text_output(out_path, decisions)
    state_out = cfg.get("mab.model.state.file.out",
                        os.path.join(out_path, "state"))
    artifacts.write_text_output(state_out, gb.save_state(delim))
    counters.increment("Bandit", "Groups", len(gb.learners))
    return counters


@register("org.avenir.spark.reinforce.MultiArmBandit", "multiArmBandit",
          dist="gather")
def multi_arm_bandit(cfg: Config, in_path: str, out_path: str) -> Counters:
    return _run_bandit(cfg, in_path, out_path,
                       cfg.get("mab.algorithm", "randomGreedy"))


@register("org.avenir.reinforce.GreedyRandomBandit", "greedyRandomBandit",
          dist="gather")
def greedy_random_bandit(cfg: Config, in_path: str, out_path: str) -> Counters:
    """epsilon-greedy batch job (reinforce/GreedyRandomBandit.java:150-205)."""
    return _run_bandit(cfg, in_path, out_path, "randomGreedy")


@register("org.avenir.reinforce.SoftMaxBandit", "softMaxBandit",
          dist="gather")
def soft_max_bandit(cfg: Config, in_path: str, out_path: str) -> Counters:
    return _run_bandit(cfg, in_path, out_path, "softMax")


@register("org.avenir.reinforce.AuerDeterministic", "auerDeterministic",
          dist="gather")
def auer_deterministic(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Auer's deterministic UCB1 variant."""
    return _run_bandit(cfg, in_path, out_path, "ucb1")


@register("org.avenir.reinforce.RandomFirstGreedyBandit",
          "randomFirstGreedyBandit",
          dist="gather")
def random_first_greedy_bandit(cfg: Config, in_path: str,
                               out_path: str) -> Counters:
    """Random exploration first, then greedy: randomGreedy with linear
    epsilon decay."""
    cfg.set("mab.prob.reduction.algorithm",
            cfg.get("mab.prob.reduction.algorithm", "linear"))
    return _run_bandit(cfg, in_path, out_path, "randomGreedy")
