"""Make the opt9 fixture with the JAX package, on the CPU: the optimize
jobs over the repo's own ``resource/taskSched.json`` (12 tasks, 8
employees) and ``resource/opt.conf`` (SA: 16 chains, 2,000 iterations,
local descent; GA: 4 islands of 24, 120 generations).

Each case is an opt.conf with a few keys changed (``CASES``) and writes
``<case>/out.csv`` (the job's output lines) and ``<case>/counters.json``
(its Annealing or Genetic counter group):

  sa            simulatedAnnealing as configured
  sa_uniform    step.size.strategy uniform, max.step.size 3
  sa_gaussian   step.size.strategy gaussian (mean 1.5, std 1), max 3
  sa_linear     linear cooling at rate 0.02
  sa_starts     the sa case's own output lines as its starting solutions
  ga            geneticAlgorithm as configured
  sa_2proc      simulatedAnnealing over 2 processes (dist=partition)
  ga_2proc      geneticAlgorithm over 2 processes

The JAX package's joined runs need a multi-process JAX runtime, so the
two 2-process cases are made as the job makes them, slice by slice in
one process: each process's ``work_slice`` (chains or islands ``[lo,
hi)``) run with the seed folded by ``lo``, the per-slice results merged
and sorted by cost as ``allgather_object`` hands them to every process,
the counters summed as the joined run's counter reduce sums them
(``estimatedInitialTemp`` and ``bestCost`` from the global values, set by
the process that owns the first slice).

The port (``avenir_tpu_torch``) is held against these files byte for byte
on the CPU by ``tests/test_torch_optimize.py`` and on the GPU by
``chip_smoke.py``.  Regenerate from the repo root (the test reruns it
into a temporary directory and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/opt9/make.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
DOMAIN = os.path.join(RES, "taskSched.json")
PROCS = 2
STEP3 = ("max.step.size = 2", "max.step.size = 3")
CASES = {
    "sa": ("simulatedAnnealing", ()),
    "sa_uniform": ("simulatedAnnealing", (
        STEP3, ("cooling.rate.geometric",
                'step.size.strategy = "uniform"\n  cooling.rate.geometric'))),
    "sa_gaussian": ("simulatedAnnealing", (
        STEP3, ("cooling.rate.geometric",
                'step.size.strategy = "gaussian"\n  step.size.mean = 1.5\n'
                '  step.size.std.dev = 1.0\n  cooling.rate.geometric'))),
    "sa_linear": ("simulatedAnnealing", (
        ("cooling.rate.geometric = true", "cooling.rate.geometric = false"),
        ("cooling.rate.value = 0.98", "cooling.rate.value = 0.02"))),
    "sa_starts": ("simulatedAnnealing", ()),
    "ga": ("geneticAlgorithm", ()),
}
JOINED = {"sa_2proc": "simulatedAnnealing", "ga_2proc": "geneticAlgorithm"}
GROUP = {"simulatedAnnealing": "Annealing", "geneticAlgorithm": "Genetic"}


def conf_text(changes=()):
    """resource/opt.conf with the domain file's path made absolute and the
    ``(old, new)`` text changes applied."""
    with open(os.path.join(RES, "opt.conf")) as fh:
        text = fh.read().replace('"taskSched.json"', json.dumps(DOMAIN))
    for old, new in changes:
        assert old in text, old
        text = text.replace(old, new)
    return text


def write_conf(path, changes=()):
    with open(path, "w") as fh:
        fh.write(conf_text(changes))
    return path


def run_job(args):
    """One JAX CLI job in a child process on one CPU device."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    code = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            f"sys.path.insert(0, {ROOT!r}); "
            "from avenir_tpu.cli import run; "
            "sys.exit(run.main(sys.argv[1:]))")
    subprocess.run([sys.executable, "-c", code, *args], env=env,
                   check=True, capture_output=True)


def write_case(out_dir, case, lines, counters):
    d = os.path.join(out_dir, case)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "out.csv"), "w") as fh:
        fh.write("".join(ln + "\n" for ln in lines))
    with open(os.path.join(d, "counters.json"), "w") as fh:
        json.dump(counters, fh, indent=2, sort_keys=True)
        fh.write("\n")


def slices(n, procs=PROCS):
    """Each process's ``work_slice(n)``."""
    return [(n * p // procs, n * (p + 1) // procs) for p in range(procs)]


def joined(job, conf_path):
    """(lines, counters) of ``job`` over PROCS processes, made slice by
    slice (module docstring)."""
    from avenir_tpu.cli.optimize_jobs import _safe_int, load_domain
    from avenir_tpu.core.config import load_config
    from avenir_tpu.optimize.annealing import (AnnealingParams,
                                               simulated_annealing)
    from avenir_tpu.optimize.genetic import GeneticParams, genetic_algorithm
    cfg = load_config(conf_path, job)
    domain = load_domain(cfg.must_get("domain.callback.class.name"),
                         cfg.must_get("domain.callback.config.file"))
    od = cfg.field_delim_out
    seed = cfg.get_int("random.seed", 0)
    merged, counters = [], {}
    if job == "simulatedAnnealing":
        total_inc = total_worse = 0.0
        for lo, hi in slices(cfg.get_int("num.optimizers", 8)):
            p = AnnealingParams(
                max_num_iterations=cfg.get_int("max.num.iterations", 300),
                num_optimizers=hi - lo,
                initial_temp=cfg.get_float("initial.temp", 30.0),
                cooling_rate=cfg.get_float("cooling.rate.value", 0.99),
                cooling_rate_geometric=cfg.get_boolean(
                    "cooling.rate.geometric", True),
                temp_update_interval=cfg.get_int("temp.update.interval", 2),
                max_step_size=cfg.get_int("max.step.size", 1),
                step_size_strategy=cfg.get("step.size.strategy",
                                           "constant"),
                step_size_mean=cfg.get_float("step.size.mean", 1.0),
                step_size_std_dev=cfg.get_float("step.size.std.dev", 1.0),
                locally_optimize=cfg.get_boolean("locally.optimize", False),
                max_num_local_iterations=cfg.get_int(
                    "max.num.local.iterations", 50),
                seed=seed + lo)
            res = simulated_annealing(domain, p)
            merged += [(float(res.best_costs[i]),
                        domain.to_string(res.best_solutions[i]))
                       for i in range(hi - lo)]
            for k, v in res.counters.items():
                counters[k] = counters.get(k, 0) + _safe_int(v)
            total_inc += res.counters["costIncreaseAcum"]
            total_worse += res.counters["worseSolnCount"]
        est = total_inc / total_worse if total_worse > 0 else 0.0
        counters["estimatedInitialTemp"] = _safe_int(est)
    else:
        for lo, hi in slices(cfg.get_int("num.partitions", 4)):
            p = GeneticParams(
                num_generations=cfg.get_int("num.generations", 100),
                population_size=cfg.get_int("population.size", 32),
                num_islands=hi - lo,
                crossover_prob=cfg.get_float("crossover.prob", 0.8),
                mutation_prob=cfg.get_float("mutation.prob", 0.2),
                seed=seed + lo)
            res = genetic_algorithm(domain, p)
            merged += [(float(res.island_best_costs[i]),
                        domain.to_string(res.island_best[i]))
                       for i in range(hi - lo)]
    merged.sort(key=lambda cs: cs[0])
    if job == "geneticAlgorithm":
        counters["bestCost"] = _safe_int(merged[0][0])
    lines = [f"{sol}{od}{cost:.3f}" for cost, sol in merged]
    return lines, {GROUP[job]: counters}


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:
        for case, (job, changes) in CASES.items():
            conf = write_conf(os.path.join(work, case + ".conf"), changes)
            out = os.path.join(work, case)
            args = [job, out, conf]
            if case == "sa_starts":
                args = [job, os.path.join(out_dir, "sa", "out.csv"), out,
                        conf]
            run_job(args)
            with open(os.path.join(out, "part-r-00000")) as fh:
                lines = fh.read().splitlines()
            with open(out + ".counters.json") as fh:
                counters = json.load(fh)
            write_case(out_dir, case, lines,
                       {GROUP[job]: counters[GROUP[job]]})
            shutil.rmtree(out)
        for case, job in JOINED.items():
            conf = write_conf(os.path.join(work, case + ".conf"))
            write_case(out_dir, case, *joined(job, conf))


if __name__ == "__main__":
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
