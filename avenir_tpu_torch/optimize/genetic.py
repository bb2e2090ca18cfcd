"""Genetic algorithm: port of ``avenir_tpu/optimize/genetic.py``.

Parity target: spark/.../optimize/GeneticAlgorithm.scala:69-176 — per
partition, a population evolves by binary tournament selection,
single-point crossover with probability, and mutation with probability.
The islands are the leading axis of an (islands, pop, L) tensor on one
device and one generation evolves all of them at once.  Each island draws
from its own key exactly as the JAX package's ``vmap`` does: per
generation ``split(key, I + 1)``, then per island ``split(k, 7)`` and the
tournament, crossover and mutation draws (the twin's batched keys are
that ``vmap``); elitism keeps each island's best in slot 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import resolve_device
from ..utils import threefry as tf
from .domain import SearchDomain, set_components


@dataclass
class GeneticParams:
    num_generations: int = 100
    population_size: int = 32
    num_islands: int = 4
    crossover_prob: float = 0.8
    mutation_prob: float = 0.2
    seed: int = 0


@dataclass
class GeneticResult:
    best_solution: np.ndarray
    best_cost: float
    island_best: np.ndarray           # (islands, L)
    island_best_costs: np.ndarray     # (islands,)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i, j]]`` over the island axis: (I, P, ...) by (I, Q)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def genetic_algorithm(domain: SearchDomain, params: GeneticParams,
                      device=None) -> GeneticResult:
    device = resolve_device(device)
    rng = np.random.default_rng(params.seed)
    I, P = params.num_islands, params.population_size
    L, C = domain.n_components, domain.n_choices
    pop = domain.initial_solutions(rng, I * P).reshape(I, P, -1)
    pop = torch.as_tensor(np.asarray(pop, np.int64)).to(device)
    key = tf.PRNGKey(params.seed, device)
    arange_l = torch.arange(L, device=device)
    cx_p = float(np.float32(params.crossover_prob))
    mut_p = float(np.float32(params.mutation_prob))

    def costs_of(pop):
        return domain.cost_batch(pop.reshape(I * P, L),
                                 form="fused").reshape(I, P)

    for _ in range(params.num_generations):
        keys = tf.split(key, I + 1)
        key, iskeys = keys[0], keys[1:]
        costs = costs_of(pop)
        (k_t1, k_t2, k_cx, k_cxp, k_mut, k_mutv,
         k_mutp) = tf.split(iskeys, 7).unbind(1)
        # binary tournament per offspring slot (SolutionPopulation.java:117)
        a = tf.randint(k_t1, (P, 2), 0, P).long()
        b = tf.randint(k_t2, (P, 2), 0, P).long()
        ca, cb = _take(costs, a.reshape(I, -1)).reshape(I, P, 2), \
            _take(costs, b.reshape(I, -1)).reshape(I, P, 2)
        pa = torch.where((ca[..., 0] < ca[..., 1])[..., None],
                         _take(pop, a[..., 0]), _take(pop, a[..., 1]))
        pb = torch.where((cb[..., 0] < cb[..., 1])[..., None],
                         _take(pop, b[..., 0]), _take(pop, b[..., 1]))
        # crossover with probability
        point = tf.randint(k_cx, (P, 1), 1, L)
        crossed = torch.where(arange_l < point, pa, pb)
        do_cx = tf.uniform(k_cxp, (P, 1)) < cx_p
        child = torch.where(do_cx, crossed, pa)
        # mutation with probability (independent position and value keys)
        mpos = tf.randint(k_mut, (P,), 0, L)
        mval = tf.randint(k_mutv, (P,), 0, C)
        mutated = set_components(child, mpos, mval)
        do_mut = tf.uniform(k_mutp, (P, 1)) < mut_p
        new_pop = torch.where(do_mut, mutated, child)
        # elitism: keep each island's best in slot 0
        best_idx = torch.argmin(costs, dim=1)
        new_pop[:, 0, :] = pop[torch.arange(I, device=device), best_idx]
        pop = new_pop

    costs = costs_of(pop).cpu().numpy()
    pop = pop.cpu().numpy().astype(np.int32)
    island_best_idx = costs.argmin(axis=1)
    island_best = pop[np.arange(I), island_best_idx]
    island_best_costs = costs[np.arange(I), island_best_idx]
    gi = int(island_best_costs.argmin())
    return GeneticResult(best_solution=island_best[gi],
                         best_cost=float(island_best_costs[gi]),
                         island_best=island_best,
                         island_best_costs=island_best_costs)
