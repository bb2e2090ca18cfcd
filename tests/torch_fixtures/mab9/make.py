"""Make the mab9 fixture with the JAX package, on the CPU: the batch
bandits end to end.

  rounds.json   for each case, three rounds of state rotation: round r
                runs the case's job with ``resource/bandit.properties``
                (4 creatives, groups g0-g3, seed 11) over
                ``bandit_rewards_gen(ROUND_EVENTS, seed 100 + r)`` rewards,
                ``mab.current.decision.round=r`` and
                ``mab.decision.batch.size=BATCH``, reading the previous
                round's state (none in round 1); it keeps each round's
                decisions and state lines.  Cases: ``multiArmBandit`` with
                each of the 11 algorithms, then greedyRandomBandit,
                softMaxBandit, auerDeterministic and
                randomFirstGreedyBandit.
  vector.npz    ``VectorBandits`` at G groups x A actions, every
                algorithm, seed VECTOR_SEED: three calls of next_actions,
                after each the rewards of every group's chosen action and
                EXTRA_EVENTS random (group, action) events, drawn from
                ``numpy.random.default_rng(VECTOR_REWARD_SEED)``.  Holds
                each call's actions.

The learners draw from ``random.Random`` seeded by string, so the batch
jobs need no JAX random numbers; ``VectorBandits`` draws ``jax.random``
and the port's twin.  The port (``avenir_tpu_torch``) is held against
these files byte for byte on the CPU by ``tests/test_torch_bandits.py``
and on the GPU by ``chip_smoke.py``.  Regenerate from the repo root (the
test reruns it into a temporary directory and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/mab9/make.py
"""

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
PROPS = os.path.join(RES, "bandit.properties")
ALGORITHMS = ("intervalEstimator", "sampsonSampler",
              "optimisticSampsonSampler", "randomGreedy", "ucb1", "ucb2",
              "softMax", "actionPursuit", "rewardComparison",
              "exponentialWeight", "exponentialWeightExpert")
NAMED = ("greedyRandomBandit", "softMaxBandit", "auerDeterministic",
         "randomFirstGreedyBandit")
ROUNDS = 3
ROUND_EVENTS = 300
BATCH = 3
G, A = 64, 4
VECTOR_SEED = 9
VECTOR_REWARD_SEED = 17
EXTRA_EVENTS = 32
VECTOR_CALLS = 3


def cases():
    """case name -> (job, extra -D keys)."""
    out = {f"mab_{a}": ("multiArmBandit", (f"-Dmab.algorithm={a}",))
           for a in ALGORITHMS}
    out.update({n: (n, ()) for n in NAMED})
    return out


def rewards(r):
    sys.path.insert(0, RES)
    from gen.bandit_rewards_gen import generate
    return generate(ROUND_EVENTS, 100 + r)


def round_args(job, extra, work, r):
    """The job's arguments in round ``r`` under ``work``; returns (args,
    decisions dir, state-out file)."""
    rw = os.path.join(work, f"rewards{r}.csv")
    with open(rw, "w") as fh:
        fh.write("\n".join(rewards(r)))
    state_in = os.path.join(work, f"state{r - 1}", "part-r-00000") \
        if r > 1 else "/nonexistent"
    state_out = os.path.join(work, f"state{r}")
    out = os.path.join(work, f"actions{r}")
    args = [job, f"-Dconf.path={PROPS}", *extra,
            f"-Dmab.current.decision.round={r}",
            f"-Dmab.decision.batch.size={BATCH}",
            f"-Dmab.model.state.file.in={state_in}",
            f"-Dmab.model.state.file.out={state_out}", rw, out]
    return args, out, os.path.join(state_out, "part-r-00000")


def run_rounds(main, job, extra, work):
    """Three rounds through a CLI ``main``: [{actions, state}, ...]."""
    out = []
    for r in range(1, ROUNDS + 1):
        args, actions, state = round_args(job, extra, work, r)
        if main(args) != 0:
            raise RuntimeError(f"{job} round {r} failed")
        with open(os.path.join(actions, "part-r-00000")) as a, \
                open(state) as s:
            out.append({"actions": a.read(), "state": s.read()})
    return out


def vector_events(rng, actions):
    gi = np.concatenate([np.arange(G), rng.integers(0, G, EXTRA_EVENTS)])
    ai = np.concatenate([actions, rng.integers(0, A, EXTRA_EVENTS)])
    r = rng.normal(1.0, 0.5, len(gi)).astype(np.float32)
    return gi, ai, r


def run_vector(cls, **kw):
    """{algorithm: (VECTOR_CALLS, G) actions} of a VectorBandits class."""
    out = {}
    for algo in ALGORITHMS:
        vb = cls(algo, G, A, {"random.selection.prob": 0.3},
                 seed=VECTOR_SEED, **kw)
        rng = np.random.default_rng(VECTOR_REWARD_SEED)
        calls = []
        for _ in range(VECTOR_CALLS):
            acts = np.asarray(vb.next_actions()).astype(np.int64)
            calls.append(acts)
            vb.set_rewards(*vector_events(rng, acts))
        out[algo] = np.stack(calls)
    return out


def jax_main(args):
    """The JAX package's CLI, in this process (the batch bandits are host
    code: nothing depends on the device count)."""
    from avenir_tpu.cli import run
    return run.main(args)


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.reinforce.batch import VectorBandits
    os.makedirs(out_dir, exist_ok=True)
    rounds = {}
    for case, (job, extra) in cases().items():
        with tempfile.TemporaryDirectory() as work:
            rounds[case] = run_rounds(jax_main, job, extra, work)
    with open(os.path.join(out_dir, "rounds.json"), "w") as fh:
        json.dump(rounds, fh, indent=1, sort_keys=True)
        fh.write("\n")
    np.savez(os.path.join(out_dir, "vector.npz"), **run_vector(VectorBandits))


if __name__ == "__main__":
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
