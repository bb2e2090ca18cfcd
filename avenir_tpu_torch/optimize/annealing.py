"""Simulated annealing: port of ``avenir_tpu/optimize/annealing.py``.

Parity target: spark/.../optimize/SimulatedAnnealing.scala:96-255.  Every
chain is a row of a batched state on one device and each iteration
advances all chains at once (a Python loop over iterations; the state,
the key and the counters never leave the device until the end).
Semantics as in the JAX package:

  * accept better always; accept worse with prob exp((cur-next)/temp)
    (:139-170), ``exp`` as XLA computes it (:func:`xla_exp_f32`) and the
    division by a temperature tensor of the chains' shape (a true
    division on the card too);
  * temperature updated every temp.update.interval iterations, geometric
    temp *= rate, or the reference's linear form temp -= initial -
    i*rate clamped at 0 (:172-184);
  * accumulators better/best/worse/accepted + cost-increase sum (:88-92),
    each iteration's outcomes kept on the device and summed once after
    the loop, the cost increases in the JAX package's float32 order
    (:func:`running_total`);
  * optional greedy local-descent pass (:197-232);
  * estimated initial temperature = mean cost increase of worse moves.

The key discipline is the JAX package's, draw for draw: each iteration
splits the carried key into 3 (or 4 when the step-size strategy draws),
so the golden SA fixture reproduces byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..runtime import resolve_device
from ..utils import threefry as tf
from ..utils.xla_math import fma_f32, xla_exp_f32
from .domain import SearchDomain, StepSize, window_sum

# chain-summed run counters (the reference's Spark accumulators); the SA
# job's empty-slice branch emits the same key set
COUNTER_KEYS = ("betterSolnCount", "bestSolnCount", "worseSolnCount",
                "worseSolnAcceptCount", "costIncreaseAcum")


@dataclass
class AnnealingParams:
    """The simulatedAnnealing block knobs (resource/opt.conf)."""
    max_num_iterations: int = 300
    num_optimizers: int = 8
    initial_temp: float = 30.0
    cooling_rate: float = 0.99
    cooling_rate_geometric: bool = True
    temp_update_interval: int = 2
    max_step_size: int = 1
    step_size_strategy: str = "constant"
    step_size_mean: float = 1.0
    step_size_std_dev: float = 1.0
    locally_optimize: bool = False
    max_num_local_iterations: int = 50
    seed: int = 0


@dataclass
class AnnealingResult:
    best_solutions: np.ndarray        # (chains, L)
    best_costs: np.ndarray            # (chains,)
    counters: Dict[str, float]
    estimated_initial_temp: float


def _f32(v: float) -> float:
    return float(np.float32(v))


def simulated_annealing(domain: SearchDomain, params: AnnealingParams,
                        start_solutions: Optional[np.ndarray] = None,
                        device=None) -> AnnealingResult:
    device = resolve_device(device)
    rng = np.random.default_rng(params.seed)
    k = params.num_optimizers
    cur = start_solutions if start_solutions is not None else \
        domain.initial_solutions(rng, k)
    cur = torch.as_tensor(np.asarray(cur, np.int64)).to(device)
    key = tf.PRNGKey(params.seed, device)
    step_size = StepSize(max_step_size=params.max_step_size,
                         strategy=params.step_size_strategy,
                         mean=params.step_size_mean,
                         std_dev=params.step_size_std_dev)
    cur_cost = domain.cost_batch(cur, form="eager")
    best, best_cost = cur, cur_cost
    temp = torch.full((cur.shape[0],), _f32(params.initial_temp),
                      dtype=torch.float32, device=device)
    # each iteration's outcomes, summed into the counters after the loop
    iters, chains = params.max_num_iterations, cur.shape[0]
    flags = torch.empty((iters, 3, chains), dtype=torch.bool, device=device)
    increases = torch.empty((iters, chains), dtype=torch.float32,
                            device=device)
    rate = _f32(params.cooling_rate)
    upd_counter = 0
    for i in range(params.max_num_iterations):
        # the constant (default) strategy draws no step key
        if step_size.strategy != "constant":
            key, k_mut, k_step, k_acc = tf.split(key, 4)
            steps = step_size.sample(k_step, cur.shape[0])
        else:
            key, k_mut, k_acc = tf.split(key, 3)
            steps = None
        nxt = domain.mutate(k_mut, cur, params.max_step_size,
                            step_sizes=steps)
        nxt_cost = domain.cost_batch(nxt, form="fused")

        better = nxt_cost < cur_cost
        is_best = nxt_cost < best_cost
        u = tf.uniform(k_acc, (cur.shape[0],))
        accept_worse = (~better) & (
            xla_exp_f32((cur_cost - nxt_cost) / temp) > u)
        take = better | accept_worse

        flags[i, 0], flags[i, 1], flags[i, 2] = better, is_best, accept_worse
        increases[i] = torch.where(~better, nxt_cost - cur_cost,
                                   torch.zeros_like(nxt_cost))

        cur = torch.where(take[:, None], nxt, cur)
        cur_cost = torch.where(take, nxt_cost, cur_cost)
        best = torch.where(is_best[:, None], nxt, best)
        best_cost = torch.where(is_best, nxt_cost, best_cost)

        upd_counter += 1
        if upd_counter == params.temp_update_interval:
            if params.cooling_rate_geometric:
                temp = temp * rate
            else:
                # reference linear form (:176-181), clamped at zero; XLA
                # contracts initial - (i + 1) * rate into one FMA
                drop = fma_f32(torch.full_like(temp, -(i + 1.0)), rate,
                               _f32(params.initial_temp))
                temp = torch.clamp(temp - drop, min=0.0)
            upd_counter = 0

    if params.locally_optimize:
        best, best_cost = local_descent(domain, best, best_cost,
                                        params.max_num_local_iterations,
                                        key)

    n_better, n_best, n_accept = (float(v) for v in
                                  flags.sum(dim=(0, 2)).tolist())
    n_worse_v = float(iters * chains) - n_better
    cost_inc = float(running_total(increases.cpu().numpy()))
    counters = dict(zip(COUNTER_KEYS,
                        (n_better, n_best, n_worse_v, n_accept, cost_inc)))
    est_temp = float(cost_inc) / n_worse_v if n_worse_v > 0 else 0.0
    return AnnealingResult(best_solutions=best.cpu().numpy().astype(np.int32),
                           best_costs=best_cost.cpu().numpy(),
                           counters=counters,
                           estimated_initial_temp=est_temp)


def running_total(rows: np.ndarray) -> np.float32:
    """The JAX package's ``cost_inc`` carry: float32, each iteration's
    row of cost increases summed in XLA's order (:func:`window_sum`: left
    to right up to 32 chains, in windows of 32 above) and added to the
    carry in turn."""
    sums = window_sum(torch.from_numpy(np.asarray(rows, np.float32)))
    acc = np.float32(0.0)
    for v in sums.numpy():
        acc = np.float32(acc + v)
    return acc


def local_descent(domain: SearchDomain, solutions: torch.Tensor,
                  costs: torch.Tensor, iterations: int,
                  key: torch.Tensor):
    """Greedy pass: accept only improvements (the optional second
    mapPartitions of the reference, :197-232)."""
    cur, cur_cost = solutions, costs
    for _ in range(iterations):
        key, k_mut = tf.split(key, 2)
        nxt = domain.mutate(k_mut, cur, 1)
        nxt_cost = domain.cost_batch(nxt, form="fused")
        better = nxt_cost < cur_cost
        cur = torch.where(better[:, None], nxt, cur)
        cur_cost = torch.where(better, nxt_cost, cur_cost)
    return cur, cur_cost
