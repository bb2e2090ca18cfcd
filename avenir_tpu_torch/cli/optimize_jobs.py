"""Optimize-pack jobs: port of ``avenir_tpu/cli/optimize_jobs.py``,
simulatedAnnealing / geneticAlgorithm, on the process device.

Invocation matches the Spark driver convention (resource/opt.sh:9-16):
``python -m avenir_tpu_torch.cli.run simulatedAnnealing <outputPath>
<opt.conf>``
with the HOCON block keys of resource/opt.conf.  The domain callback class
name maps to our domain registry (org.avenir.examples.TaskScheduleSearch ->
TaskScheduleDomain).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..core.config import Config
from ..core.metrics import Counters
from ..core import artifacts
from .jobs import register

DOMAIN_REGISTRY: Dict[str, str] = {
    "org.avenir.examples.TaskScheduleSearch":
        "avenir_tpu_torch.optimize.task_schedule:TaskScheduleDomain",
    "taskSchedule":
        "avenir_tpu_torch.optimize.task_schedule:TaskScheduleDomain",
}


def load_domain(class_name: str, config_file: str):
    target = DOMAIN_REGISTRY.get(class_name)
    if target is None:
        raise KeyError(f"unknown domain callback {class_name!r}; known: "
                       f"{sorted(DOMAIN_REGISTRY)}")
    mod_name, _, cls_name = target.partition(":")
    import importlib
    mod = importlib.import_module(mod_name)
    return getattr(mod, cls_name).load(config_file)


def _safe_int(v: float) -> int:
    """Counter-safe conversion: inf/nan (e.g. every chain stuck on invalid
    solutions) clamp instead of raising OverflowError/ValueError."""
    if np.isnan(v):
        return 0
    return int(np.clip(v, -(2 ** 62), 2 ** 62))


def _parse_start(domain, line: str, od: str) -> np.ndarray:
    """Parse a starting solution; tolerates re-ingesting our own output lines,
    which append ``<od><cost>`` to the solution string (the reference's
    iterate-on-prior-solutions workflow feeds output back as input)."""
    line = line.strip()
    try:
        return domain.from_string(line)
    except (ValueError, IndexError):
        head, sep, _ = line.rpartition(od)
        if not sep:
            raise
        return domain.from_string(head)


@register("org.avenir.spark.optimize.SimulatedAnnealing", "simulatedAnnealing",
          dist="partition")
def simulated_annealing_job(cfg: Config, in_path: str, out_path: str) -> Counters:
    """SA over the configured domain (opt.conf keys; SURVEY.md §3.3).
    in_path may hold starting solutions (one per line, reference component
    format); otherwise num.optimizers random starts are generated.

    Multi-process: each process anneals its ``work_slice`` of the chains
    with a process-folded seed (distinct streams — the reference's Spark
    executors each draw their own rng,
    spark SimulatedAnnealing.scala:96-255), then the per-chain bests are
    allgathered so every process writes the identical merged output.
    Single-process output is byte-identical to the pre-partition job (the
    golden SA fixture): slice = all chains, seed fold = +0, allgather =
    identity."""
    from ..optimize.annealing import (COUNTER_KEYS, AnnealingParams,
                                      simulated_annealing)
    from ..parallel.distributed import allgather_object, work_slice
    counters = Counters()
    params = AnnealingParams(
        max_num_iterations=cfg.get_int("max.num.iterations", 300),
        num_optimizers=cfg.get_int("num.optimizers", 8),
        initial_temp=cfg.get_float("initial.temp", 30.0),
        cooling_rate=cfg.get_float("cooling.rate.value", 0.99),
        cooling_rate_geometric=cfg.get_boolean("cooling.rate.geometric", True),
        temp_update_interval=cfg.get_int("temp.update.interval", 2),
        max_step_size=cfg.get_int("max.step.size", 1),
        step_size_strategy=cfg.get("step.size.strategy", "constant"),
        step_size_mean=cfg.get_float("step.size.mean", 1.0),
        step_size_std_dev=cfg.get_float("step.size.std.dev", 1.0),
        locally_optimize=cfg.get_boolean("locally.optimize", False),
        max_num_local_iterations=cfg.get_int("max.num.local.iterations", 50),
        seed=cfg.get_int("random.seed", 0),
    )
    domain = load_domain(cfg.must_get("domain.callback.class.name"),
                         cfg.must_get("domain.callback.config.file"))
    starts = None
    if in_path and os.path.exists(in_path):
        lines = artifacts.read_text_input(in_path)
        if lines:
            od = cfg.field_delim_out
            starts = np.stack([_parse_start(domain, l, od) for l in lines])
            params.num_optimizers = len(lines)
    lo, hi = work_slice(params.num_optimizers)
    owns_first = lo == 0 and hi > lo
    params.num_optimizers = hi - lo
    params.seed += lo  # fold by chain offset: distinct per-process streams
    if starts is not None:
        starts = starts[lo:hi]
    od = cfg.field_delim_out
    local = ([], 0.0, 0.0)
    if hi > lo:
        res = simulated_annealing(domain, params, start_solutions=starts)
        local = ([(float(res.best_costs[i]),
                   domain.to_string(res.best_solutions[i]))
                  for i in range(hi - lo)],
                 res.counters["costIncreaseAcum"],
                 res.counters["worseSolnCount"])
        for k, v in res.counters.items():
            counters.set("Annealing", k, _safe_int(v))
    else:  # more processes than chains: empty slice, counter keys must
        for k in COUNTER_KEYS:
            counters.set("Annealing", k, 0)  # still match for the reduce
    gathered = allgather_object(local)
    merged = [p for sols, _, _ in gathered for p in sols]
    merged.sort(key=lambda cs: cs[0])
    out_lines = [f"{sol}{od}{cost:.3f}" for cost, sol in merged]
    artifacts.write_text_output(out_path, out_lines)
    # initial-temp diagnostic = total cost increase / total worse count,
    # derived from the GLOBAL sums (a slice-local ratio would silently
    # change meaning with pod size); emitted once for the counter reduce
    total_inc = sum(ci for _, ci, _ in gathered)
    total_worse = sum(nw for _, _, nw in gathered)
    est = total_inc / total_worse if total_worse > 0 else 0.0
    counters.set("Annealing", "estimatedInitialTemp",
                 _safe_int(est) if owns_first else 0)
    return counters


@register("org.avenir.spark.optimize.GeneticAlgorithm", "geneticAlgorithm",
          dist="partition")
def genetic_algorithm_job(cfg: Config, in_path: str, out_path: str) -> Counters:
    """GA over the configured domain (GeneticAlgorithm.scala:69-176).

    Multi-process: each process evolves its ``work_slice`` of the islands
    with an island-offset seed (the reference's num.partitions IS its
    executor fan-out, GeneticAlgorithm.scala:69), then island bests are
    allgathered so every process writes the identical merged output.
    Single-process output is byte-identical to the pre-partition job."""
    from ..optimize.genetic import GeneticParams, genetic_algorithm
    from ..parallel.distributed import allgather_object, work_slice
    counters = Counters()
    params = GeneticParams(
        num_generations=cfg.get_int("num.generations", 100),
        population_size=cfg.get_int("population.size", 32),
        num_islands=cfg.get_int("num.partitions", 4),
        crossover_prob=cfg.get_float("crossover.prob", 0.8),
        mutation_prob=cfg.get_float("mutation.prob", 0.2),
        seed=cfg.get_int("random.seed", 0),
    )
    domain = load_domain(cfg.must_get("domain.callback.class.name"),
                         cfg.must_get("domain.callback.config.file"))
    lo, hi = work_slice(params.num_islands)
    owns_first = lo == 0 and hi > lo
    params.num_islands = hi - lo
    params.seed += lo  # fold by island offset: distinct per-process streams
    od = cfg.field_delim_out
    local = []
    if hi > lo:
        res = genetic_algorithm(domain, params)
        local = [(float(res.island_best_costs[i]),
                  domain.to_string(res.island_best[i]))
                 for i in range(hi - lo)]
    merged = [p for proc in allgather_object(local) for p in proc]
    merged.sort(key=lambda cs: cs[0])
    out_lines = [f"{sol}{od}{cost:.3f}" for cost, sol in merged]
    artifacts.write_text_output(out_path, out_lines)
    # global best emitted exactly once (the cross-process counter reduce
    # SUMS values; every process setting it would P-fold it)
    counters.set("Genetic", "bestCost",
                 _safe_int(merged[0][0]) if owns_first and merged else 0)
    return counters
