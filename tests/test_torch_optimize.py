"""The optimize jobs in the port (``avenir_tpu_torch/optimize``,
``simulatedAnnealing`` and ``geneticAlgorithm``) against the JAX package,
on the CPU, byte for byte.

Simulated annealing accepts a worse move on ``exp((cur - next) / temp) >
u``, so one ulp of a cost can change a whole trajectory: the port draws
every key and value through the threefry twin as the JAX package draws
them, adds each solution's component costs in XLA's order
(``MatrixCostDomain.cost_batch``: left to right outside the compiled loop
and for the 12 x 8 domain inside it, in 8 lanes for the golden fixture's
8 x 5 one) and multiplies by the folded float32 1/L, and computes ``exp``
and the linear cooling's FMA as XLA does.  The golden ``sa`` fixture and
every opt9 case (``tests/torch_fixtures/opt9/make.py``) reproduce byte
for byte, output lines and counters, the two 2-process cases over two
gloo ranks of the port's CLI.
"""

import importlib.util
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from avenir_tpu.optimize.domain import MatrixCostDomain as JaxMatrixDomain
from avenir_tpu.optimize.task_schedule import \
    TaskScheduleDomain as JaxTaskDomain
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.optimize import task_schedule as TS
from avenir_tpu_torch.optimize.annealing import (AnnealingParams,
                                                 simulated_annealing)
from avenir_tpu_torch.optimize.domain import MatrixCostDomain, StepSize
from avenir_tpu_torch.optimize.genetic import (GeneticParams,
                                               genetic_algorithm)
from avenir_tpu_torch.utils import threefry as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
OPT9 = os.path.join(ROOT, "tests", "torch_fixtures", "opt9")
GOLDEN_SA = os.path.join(ROOT, "tests", "golden", "fixtures", "sa")
DOMAIN = os.path.join(RES, "taskSched.json")
CPU = "-Dplatform=cpu"
if RES not in sys.path:
    sys.path.insert(0, RES)


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "opt9_make", os.path.join(OPT9, "make.py"))
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


def _read(path):
    with open(path) as fh:
        return fh.read()


# --------------------------------------------------------------------------
# counterparts of tests/test_optimize.py
# --------------------------------------------------------------------------

def toy_domain(L=10, C=6, seed=0):
    rng = np.random.default_rng(seed)
    cm = rng.uniform(1, 10, (L, C))
    return MatrixCostDomain(cost_matrix=cm), cm.min(axis=1).mean()


def test_sa_converges_to_optimum():
    domain, opt = toy_domain()
    params = AnnealingParams(max_num_iterations=2000, num_optimizers=16,
                             initial_temp=5.0, cooling_rate=0.995, seed=1)
    res = simulated_annealing(domain, params)
    assert res.best_costs.min() < opt + 0.3
    assert res.counters["betterSolnCount"] > 0
    assert res.counters["worseSolnCount"] > 0
    assert res.estimated_initial_temp > 0


def test_sa_with_start_solutions():
    domain, _ = toy_domain()
    starts = domain.initial_solutions(np.random.default_rng(0), 4)
    res = simulated_annealing(domain, AnnealingParams(
        max_num_iterations=500, num_optimizers=4, seed=2),
        start_solutions=starts)
    assert res.best_solutions.shape == (4, 10)


def test_sa_local_descent():
    domain, opt = toy_domain()
    p = AnnealingParams(max_num_iterations=300, num_optimizers=8,
                        locally_optimize=True, max_num_local_iterations=200,
                        seed=3)
    res = simulated_annealing(domain, p)
    assert res.best_costs.min() < opt + 0.5


def test_ga_converges():
    domain, opt = toy_domain(seed=4)
    params = GeneticParams(num_generations=150, population_size=32,
                           num_islands=4, seed=4)
    res = genetic_algorithm(domain, params)
    assert res.best_cost < opt + 0.3
    assert res.island_best.shape == (4, 10)


def test_invalid_solution_cost_replaces():
    cm = np.ones((3, 2))
    conflict = np.zeros((3, 3))
    conflict[0, 1] = conflict[1, 0] = 1.0
    d = MatrixCostDomain(cost_matrix=cm, conflict=conflict,
                         conflict_penalty=150.0)
    sols = torch.tensor([[0, 0, 1],    # tasks 0,1 share employee 0
                         [0, 1, 1]])   # valid
    costs = d.cost_batch(sols).numpy()
    assert costs[0] == 150.0
    assert abs(costs[1] - 1.0) < 1e-6


def test_geo_distance():
    d = TS.geo_distance(40.7128, -74.0060, 42.3601, -71.0589)
    assert 180 < d < 200


def test_task_schedule_from_the_repo_json():
    """Load the repo's taskSched.json (the reference's shape, trailing
    commas tolerated): the port's cost matrix and conflicts are the JAX
    package's."""
    domain = TS.TaskScheduleDomain.load(DOMAIN)
    assert domain.n_components == len(domain.task_ids) == 12
    assert domain.n_choices == len(domain.employee_ids) == 8
    assert np.isfinite(domain.cost_matrix).all()
    assert domain.cost_matrix.min() >= 0
    jd = JaxTaskDomain.load(DOMAIN)
    np.testing.assert_array_equal(domain.cost_matrix, jd.cost_matrix)
    np.testing.assert_array_equal(domain.conflict, jd.conflict)
    sol = domain.initial_solutions(np.random.default_rng(0), 1)[0]
    s = domain.to_string(sol)
    assert ":" in s and ";" in s
    np.testing.assert_array_equal(domain.from_string(s), sol)
    assert TS._lenient_json('{"a": [1, 2,],}') == {"a": [1, 2]}


def test_sa_cli_job_with_the_repo_conf(tmp_path):
    """Drive simulatedAnnealing like opt.sh: HOCON conf + output path over
    the repo's taskSched.json; the best beats a random solution's mean."""
    conf = tmp_path / "opt.conf"
    conf.write_text(
        'simulatedAnnealing {\n'
        '  field.delim.out = ","\n'
        '  max.num.iterations = 400\n'
        '  num.optimizers = 8\n'
        '  max.step.size = 1\n'
        '  initial.temp = 30.0\n'
        '  cooling.rate.value = 0.97\n'
        '  cooling.rate.geometric = true\n'
        '  temp.update.interval = 2\n'
        '  domain.callback.class.name = '
        '"org.avenir.examples.TaskScheduleSearch"\n'
        f'  domain.callback.config.file = "{DOMAIN}"\n'
        '  locally.optimize = false\n'
        '}\n')
    assert port_run.main(["simulatedAnnealing", CPU, str(tmp_path / "out"),
                          str(conf)]) == 0
    lines = (tmp_path / "out" / "part-r-00000").read_text().splitlines()
    assert len(lines) == 8
    best = float(lines[0].rsplit(",", 1)[1])
    assert best <= float(lines[-1].rsplit(",", 1)[1])
    domain = TS.TaskScheduleDomain.load(DOMAIN)
    rand = domain.initial_solutions(np.random.default_rng(9), 64)
    assert best < float(domain.cost_batch(torch.from_numpy(rand)).mean())


def test_step_size_strategies():
    key = tf.PRNGKey(0, "cpu")
    c = StepSize(max_step_size=4, strategy="constant")
    assert (c.sample(key, 100).numpy() == 4).all()
    su = StepSize(max_step_size=4, strategy="uniform").sample(key, 1000)
    su = su.numpy()
    assert su.min() >= 1 and su.max() <= 4
    assert len(np.unique(su)) == 4
    sg = StepSize(max_step_size=6, strategy="gaussian", mean=3.0,
                  std_dev=2.0).sample(key, 1000).numpy()
    assert sg.min() >= 1 and sg.max() <= 6
    assert 2.0 < sg.mean() < 4.0


def test_step_sizes_are_the_jax_packages():
    import jax
    from avenir_tpu.optimize.domain import StepSize as JaxStepSize
    for strat in ("uniform", "gaussian"):
        for seed in (0, 5, 11):
            want = JaxStepSize(max_step_size=6, strategy=strat, mean=3.0,
                               std_dev=2.0).sample(jax.random.PRNGKey(seed),
                                                   500)
            got = StepSize(max_step_size=6, strategy=strat, mean=3.0,
                           std_dev=2.0).sample(tf.PRNGKey(seed, "cpu"), 500)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_annealing_with_uniform_step_size():
    rng = np.random.default_rng(0)
    cm = rng.random((12, 5)).astype(np.float32)
    dom = MatrixCostDomain(cost_matrix=cm)
    params = AnnealingParams(max_num_iterations=1500, num_optimizers=8,
                             max_step_size=3,
                             step_size_strategy="uniform", seed=1)
    res = simulated_annealing(dom, params)
    optimal = cm.min(axis=1).mean()
    random_mean = float(dom.cost_batch(torch.from_numpy(
        dom.initial_solutions(np.random.default_rng(2), 64))).mean())
    assert res.best_costs.min() < (optimal + random_mean) / 2


# --------------------------------------------------------------------------
# the cost's summation order
# --------------------------------------------------------------------------

# one shape or more for every branch of the port's fused order
# (domain.fused_sum_width): left to right, 4 and 8 lanes at L <= 32 and
# their dependence on C, windows of 32 with and without padding above
ORDER_SHAPES = [(8, 5), (12, 8), (3, 5), (4, 5), (7, 3), (8, 9), (16, 4),
                (16, 12), (20, 5), (21, 12), (24, 9), (28, 2), (28, 5),
                (30, 12), (32, 32), (40, 5), (64, 4), (64, 8), (64, 32),
                (96, 3), (65, 12)]


def _one_conflict_domains(T, E, seed=0):
    """The JAX package's and the port's cost domains over random costs
    with one conflicting pair (positions 0 and 1), and solutions that
    keep the pair apart, so that every cost is a sum."""
    rng = np.random.default_rng(seed)
    cm = (rng.uniform(1, 3000, (T, E)) *
          rng.choice([1e-2, 1.0, 1e2], (T, E))).astype(np.float32)
    conf = np.zeros((T, T))
    conf[0, 1] = conf[1, 0] = 1
    kw = dict(cost_matrix=cm, conflict=conf, conflict_penalty=1e9)
    return JaxMatrixDomain(**kw), MatrixCostDomain(**kw)


def _one_device():
    from avenir_tpu.parallel.mesh import MeshContext, make_mesh
    return MeshContext(make_mesh(n_devices=1))


@pytest.mark.parametrize("T,E", ORDER_SHAPES)
def test_cost_batch_adds_in_xla_order(T, E):
    """The port's eager and fused costs equal the JAX package's eager
    and jitted costs bit for bit: over the golden 8 x 5 and the repo's
    12 x 8 task domains (random solutions: valid ones carry the sum,
    invalid ones the penalty), and over random costs at every other
    shape (every solution valid)."""
    import jax
    rng = np.random.default_rng(0)
    if (T, E) in ((8, 5), (12, 8)):
        from gen.task_sched_gen import generate
        cfg = generate(T, E, 4) if (T, E) == (8, 5) else \
            TS._lenient_json(_read(DOMAIN))
        jd, pd = JaxTaskDomain(cfg), TS.TaskScheduleDomain(cfg)
        sols = rng.integers(0, E, (4096, T)).astype(np.int32)
    else:
        jd, pd = _one_conflict_domains(T, E)
        sols = rng.integers(0, E, (4096, T)).astype(np.int32)
        sols[:, 1] = (sols[:, 0] + 1) % E
    want_eager = np.asarray(jd.cost_batch(jnp.asarray(sols)))
    want_fused = np.asarray(jax.jit(jd.cost_batch)(jnp.asarray(sols)))
    got_eager = pd.cost_batch(torch.from_numpy(sols), form="eager").numpy()
    got_fused = pd.cost_batch(torch.from_numpy(sols), form="fused").numpy()
    assert np.array_equal(got_eager.view(np.int32),
                          want_eager.view(np.int32))
    assert np.array_equal(got_fused.view(np.int32),
                          want_fused.view(np.int32))


@pytest.mark.parametrize("T,E,chains", [(20, 5, 16), (16, 12, 16),
                                        (40, 5, 64), (64, 4, 100),
                                        (64, 32, 16)])
def test_short_annealing_follows_the_jax_package(T, E, chains):
    """A short annealing run at shapes whose fused cost sums in 4 or 8
    lanes or in windows, and at chain counts whose cost-increase sum is
    windowed: the best costs, solutions and counters equal the JAX
    package's on one device (as its jobs run here) bit for bit."""
    from avenir_tpu.optimize import annealing as JA
    jd, pd = _one_conflict_domains(T, E, seed=T * E)
    kw = dict(max_num_iterations=300, num_optimizers=chains,
              initial_temp=2000.0, seed=3)
    want = JA.simulated_annealing(jd, JA.AnnealingParams(**kw),
                                  ctx=_one_device())
    got = simulated_annealing(pd, AnnealingParams(**kw))
    assert np.array_equal(got.best_costs.view(np.int32),
                          np.asarray(want.best_costs).view(np.int32))
    assert np.array_equal(got.best_solutions,
                          np.asarray(want.best_solutions))
    assert got.counters == want.counters


@pytest.mark.parametrize("T,E", [(20, 5), (64, 4)])
def test_short_genetic_run_follows_the_jax_package(T, E):
    """20 generations of 2 islands x 16 at shapes whose fused cost sums
    in lanes or windows: each island's best cost and solution equal the
    JAX package's bit for bit."""
    from avenir_tpu.optimize import genetic as JG
    jd, pd = _one_conflict_domains(T, E, seed=T + E)
    kw = dict(num_generations=20, population_size=16, num_islands=2,
              seed=5)
    want = JG.genetic_algorithm(jd, JG.GeneticParams(**kw),
                                ctx=_one_device())
    got = genetic_algorithm(pd, GeneticParams(**kw))
    assert np.array_equal(np.asarray(got.island_best_costs).view(np.int32),
                          np.asarray(want.island_best_costs).view(np.int32))
    assert np.array_equal(np.asarray(got.island_best),
                          np.asarray(want.island_best))


def test_toy_domain_costs_match():
    cm = np.random.default_rng(3).uniform(1, 10, (10, 6))
    sols = np.random.default_rng(4).integers(0, 6, (256, 10)).astype(
        np.int32)
    want = np.asarray(JaxMatrixDomain(cost_matrix=cm).cost_batch(
        jnp.asarray(sols)))
    got = MatrixCostDomain(cost_matrix=cm).cost_batch(
        torch.from_numpy(sols), form="eager").numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# --------------------------------------------------------------------------
# the fixtures, byte for byte
# --------------------------------------------------------------------------

def test_golden_sa_fixture_byte_for_byte(tmp_path):
    """tests/golden/flows.py sa_flow through the port's CLI."""
    from gen.task_sched_gen import generate
    domain = tmp_path / "taskSched.json"
    domain.write_text(json.dumps(generate(8, 5, 4)))
    conf = tmp_path / "opt.conf"
    conf.write_text(_read(os.path.join(RES, "opt.conf"))
                    .replace('"taskSched.json"', f'"{domain}"')
                    .replace("max.num.iterations = 2000",
                             "max.num.iterations = 200"))
    assert port_run.main(["org.avenir.spark.optimize.SimulatedAnnealing",
                          CPU, str(tmp_path / "out"), str(conf)]) == 0
    assert _read(str(tmp_path / "out" / "part-r-00000")) == \
        _read(os.path.join(GOLDEN_SA, "solutions.csv"))


@pytest.mark.parametrize("case", sorted(MAKE.CASES))
def test_opt9_case_byte_for_byte(tmp_path, case):
    job, changes = MAKE.CASES[case]
    conf = MAKE.write_conf(str(tmp_path / "opt.conf"), changes)
    out = str(tmp_path / "out")
    args = [job, CPU, out, conf]
    if case == "sa_starts":
        args = [job, CPU, os.path.join(OPT9, "sa", "out.csv"), out, conf]
    assert port_run.main(args) == 0
    assert _read(os.path.join(out, "part-r-00000")) == \
        _read(os.path.join(OPT9, case, "out.csv"))
    with open(out + ".counters.json") as fh:
        got = json.load(fh)
    group = MAKE.GROUP[job]
    assert {group: got[group]} == json.loads(
        _read(os.path.join(OPT9, case, "counters.json")))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dump(stdout):
    groups, cur = {}, None
    for line in stdout.splitlines():
        if line.startswith("\t") and cur is not None and "=" in line:
            k, _, v = line.strip().partition("=")
            groups[cur][k] = int(v)
        elif line and not line.startswith(("\t", "[")):
            cur = line.strip()
            groups.setdefault(cur, {})
    return groups


@pytest.mark.parametrize("case", sorted(MAKE.JOINED))
def test_opt9_two_process_case_byte_for_byte(tmp_path, case):
    """Two gloo ranks of the port's CLI: each anneals (or evolves) its
    work_slice with the seed folded by its offset, and both write the
    fixture's merged lines; rank 0 prints the summed counters."""
    job = MAKE.JOINED[case]
    conf = MAKE.write_conf(str(tmp_path / "opt.conf"))
    port = _free_port()
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
            "MASTER_PORT", "AVENIR_TPU_SHARD")
    procs = []
    for i in range(2):
        env = {k: v for k, v in os.environ.items() if k not in keys}
        env.update({"PYTHONPATH": ROOT, "RANK": str(i), "WORLD_SIZE": "2",
                    "LOCAL_RANK": str(i), "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": str(port)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "avenir_tpu_torch.cli.run", job, CPU,
             str(tmp_path / f"out{i}"), conf], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    want = _read(os.path.join(OPT9, case, "out.csv"))
    for i in range(2):
        assert _read(str(tmp_path / f"out{i}" / "part-r-00000")) == want
    group = MAKE.GROUP[job]
    assert {group: _dump(outs[0][0])[group]} == json.loads(
        _read(os.path.join(OPT9, case, "counters.json")))


def test_make_reproduces_the_fixture(tmp_path):
    out = str(tmp_path / "opt9")
    MAKE.make(out)
    for root, _, files in os.walk(out):
        for f in files:
            got = os.path.join(root, f)
            want = os.path.join(OPT9, os.path.relpath(got, out))
            assert _read(got) == _read(want), got


def test_work_slices_are_the_jobs():
    from avenir_tpu_torch.parallel import distributed as D
    assert D.work_slice(16) == (0, 16)
    assert MAKE.slices(16) == [(0, 8), (8, 16)]
    assert MAKE.slices(5, 2) == [(0, 2), (2, 5)]
    assert math.isclose(sum(hi - lo for lo, hi in MAKE.slices(7, 3)), 7)
