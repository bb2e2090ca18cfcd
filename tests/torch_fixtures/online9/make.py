"""Make the online9 fixture with the JAX package, on the CPU, in one fresh
one-device process: the ``onlineLearner`` job over one stream of wire
messages, in eight cases.

  stream.txt    the input, drawn with numpy from SEED (:func:`stream`):
                N_PREDICTS ``predict,<id>,f1..f4`` rows; a reward for
                REWARD_P of them, 1-3 nominal windows of LAG_WINDOW
                messages late, its value 4-decimal and tied to the
                features (:func:`reward_value`); a second reward for some
                ids (an orphan, the first one joined), ``ghost`` rewards
                for ids never served, and the near-miss malformed lines
                of the JAX package's strict-parse test (:data:`MALFORMED`)
  <case>/       for each of CASES (:func:`case_keys`; actions 0..7, four
                features):
                  a  ucb1, window 64          b  softMax, window 37
                  c  sampsonSampler           d  the logistic head
                  e  the MLP head, hidden 8   h  pending.capacity 16
                  f  ps.transport=resp, supervised: snapshot.every 2, an
                     accuracy floor (FLOOR % of FLOOR_WINDOW outcomes)
                     the bandit replies miss, so it rolls back
                  g  f killed at its ONLINE_FAULT snapshot, then resumed
                every case is supervised (a registry and a journal; a-e
                and h snapshot every SNAPSHOT_EVERY windows and have no
                floor, so supervision leaves their replies alone).  Kept:
                ``replies.txt`` (the job's output), ``counters.json`` (the
                COUNTER_GROUPS of its counters), ``online.json`` (the
                journal), ``crashed.json`` (g: the journal the killed run
                left) and ``registry/`` (every version's ``meta.json`` and
                ``online_state.bin`` sidecar, and the pin)

  samplers.npz  ``stats/samplers.py`` at SAMPLER_SEEDS (:func:`samplers`):
                each rejection sampler, ``weighted_indices`` and the
                Metropolis sampler (plain and with the mixture proposal)

The ProgramCache is process-global: every case starts from an empty one
(``reset``), so its OnlineProgramCache counters are its own.  The port
(``avenir_tpu_torch``) is held against these files on the CPU by
``tests/test_torch_online.py`` and on the GPU by ``chip_smoke.py``.
Regenerate from the repo root (the test reruns it into a temporary
directory in a subprocess and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/online9/make.py
"""

import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))

SEED = 20261018
N_PREDICTS = 600
N_FEATURES = 4
REWARD_P = 0.8
DUP_P = 0.05
GHOSTS = 12
LAG_WINDOW = 48
MALFORMED = ("reward,r0", "reward,r0,notanum", "reward,r0,inf",
             "reward,,1.0", "reward,r0,1.0,extra", "predict,r1,0.5",
             "predict,r2,0.5,x", "bogus,1,2")
ACTIONS = ",".join(str(i) for i in range(8))
FLOOR = 60
FLOOR_WINDOW = 32
ONLINE_FAULT = "online_snapshot@3=raise:RuntimeError"
MODEL_NAME = "onl9"
SNAPSHOT_EVERY = 4
CASES = ("a", "b", "c", "d", "e", "f", "g", "h")
WIRE = ("f", "g")
COUNTER_GROUPS = ("Online", "OnlineProgramCache")
BETA = np.asarray([0.8, -1.1, 0.5, 0.3], np.float64)


def reward_value(x: np.ndarray, u: float) -> float:
    """A reward tied to the features: sigmoid(x . BETA) plus noise, in
    [0, 2) with 4 decimals (the logistic head's positive class is >= 0.5,
    the MLP head's class the integer part)."""
    p = 1.0 / (1.0 + np.exp(-float(x @ BETA)))
    return round(min(max(p + 0.6 * (u - 0.5), 0.0), 1.9999) * 1.3, 4)


def stream():
    """The message lines (``stream.txt``)."""
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(N_PREDICTS, N_FEATURES)).round(4)
    timed = []          # (position, order, message)
    pos = 0.0
    for i in range(N_PREDICTS):
        pos += 1.0
        rid = f"q{i}"
        timed.append((pos, len(timed), "predict," + rid + "," +
                      ",".join(f"{v:.4f}" for v in X[i])))
        if rng.random() < REWARD_P:
            lag = LAG_WINDOW * rng.uniform(1.0, 3.0)
            val = reward_value(X[i], rng.random())
            timed.append((pos + lag, len(timed), f"reward,{rid},{val:.4f}"))
            if rng.random() < DUP_P:
                timed.append((pos + lag + rng.uniform(1, 40), len(timed),
                              f"reward,{rid},{val:.4f}"))
    for g in range(GHOSTS):
        timed.append((rng.uniform(0, pos), len(timed),
                      f"reward,ghost{g},{rng.uniform(0, 1):.4f}"))
    for m in MALFORMED:
        timed.append((rng.uniform(0, pos), len(timed), m))
    timed.sort()
    return [m for _, _, m in timed]


def case_keys(case: str, work: str):
    """The job's -D arguments for one case (its registry and journal
    under ``work``)."""
    keys = [f"-Dps.online.actions={ACTIONS}",
            f"-Dps.online.features={N_FEATURES}",
            "-Dps.online.window.size=64", "-Dps.online.seed=9",
            f"-Dps.model.registry.dir={os.path.join(work, 'registry')}",
            f"-Dps.model.name={MODEL_NAME}",
            f"-Dps.online.state.dir={os.path.join(work, 'state')}"]
    extra = {
        "a": ["-Dps.online.algorithm=ucb1"],
        "b": ["-Dps.online.algorithm=softMax", "-Dps.online.temp=0.3",
              "-Dps.online.window.size=37"],
        "c": ["-Dps.online.algorithm=sampsonSampler"],
        "d": ["-Dps.online.head=logistic", "-Dps.online.learning.rate=0.2"],
        "e": ["-Dps.online.head=mlp", "-Dps.online.mlp.hidden=8",
              "-Dps.online.learning.rate=0.05", "-Dps.online.l2=0.01"],
        "h": ["-Dps.online.algorithm=softMax",
              "-Dps.online.pending.capacity=16"],
    }
    if case in WIRE:
        return keys + [
            "-Dps.online.algorithm=ucb1", "-Dps.transport=resp",
            "-Dps.online.snapshot.every=2",
            f"-Dps.online.accuracy.floor={FLOOR}",
            f"-Dps.online.floor.window={FLOOR_WINDOW}",
            "-Dps.online.floor.consecutive=2"]
    return keys + extra[case] + [
        f"-Dps.online.snapshot.every={SNAPSHOT_EVERY}"]


def run_case(main, faults, reset, case: str, work: str):
    """Run one case through a CLI ``main`` (either package's, with its
    ``core.faults`` module and a ``reset`` that empties its ProgramCache)
    in ``work``; returns the output directory."""
    src = os.path.join(work, "stream.txt")
    with open(src, "w") as fh:
        fh.write("\n".join(stream()) + "\n")
    out = os.path.join(work, "out")
    args = ["onlineLearner", *case_keys(case, work), src, out]
    reset()
    if case == "g":
        faults.install(faults.FaultInjector.parse(ONLINE_FAULT))
        try:
            main(args)
        except RuntimeError as exc:
            assert "injected fault" in str(exc), exc
        else:
            raise AssertionError("the injected snapshot fault did not fire")
        finally:
            faults.uninstall()
        shutil.copyfile(os.path.join(work, "state", "online.json"),
                        os.path.join(work, "crashed.json"))
        shutil.rmtree(out, ignore_errors=True)
        reset()
    assert main(args) == 0
    return out


def keep(work: str, dest: str, case: str) -> None:
    """Copy one case's kept files from ``work`` to ``dest``."""
    out = os.path.join(work, "out")
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    with open(os.path.join(dest, "replies.txt"), "w") as fh:
        for f in sorted(os.listdir(out)):
            if f.startswith("part-"):
                with open(os.path.join(out, f)) as part:
                    fh.write(part.read())
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)
    with open(os.path.join(dest, "counters.json"), "w") as fh:
        json.dump({g: counters[g] for g in COUNTER_GROUPS if g in counters},
                  fh, indent=2, sort_keys=True)
        fh.write("\n")
    shutil.copyfile(os.path.join(work, "state", "online.json"),
                    os.path.join(dest, "online.json"))
    if os.path.exists(os.path.join(work, "crashed.json")):
        shutil.copyfile(os.path.join(work, "crashed.json"),
                        os.path.join(dest, "crashed.json"))
    src = os.path.join(work, "registry", MODEL_NAME)
    for name in sorted(os.listdir(src)):
        s = os.path.join(src, name)
        if os.path.isdir(s):
            for f in ("meta.json", "online_state.bin"):
                d = os.path.join(dest, "registry", name, f)
                os.makedirs(os.path.dirname(d), exist_ok=True)
                shutil.copyfile(os.path.join(s, f), d)
        else:
            os.makedirs(os.path.join(dest, "registry"), exist_ok=True)
            shutil.copyfile(s, os.path.join(dest, "registry", name))


SAMPLER_SEEDS = (3, 11)
TARGET = (1.0, 2.0, 4.0, 8.0, 4.0, 2.0, 0.0)
WEIGHTS = (1.0, 2.0, 7.0, 0.0, 3.3, 0.25, 5.5)


def samplers(mod, key_of, **device) -> dict:
    """{name: array} of a samplers module (either package's) with keys
    from ``key_of(seed)``; ``device`` goes to MetropolisSampler."""
    out = {}
    for seed in SAMPLER_SEEDS:
        out[f"gauss_{seed}"] = mod.gaussian_reject_sample(
            key_of(seed), 5.0, 2.0, 2000)
        out[f"nonparam_{seed}"] = mod.nonparam_reject_sample(
            key_of(seed), 0.5, 1.3, TARGET[:5], 2000)
        out[f"weighted_{seed}"] = np.asarray(mod.weighted_indices(
            key_of(seed), WEIGHTS, 3000)).astype(np.int32)
        for mix in (False, True):
            m = mod.MetropolisSampler(1.5, 0.0, 1.0, TARGET, n_chains=32,
                                      seed=seed, **device)
            if mix:
                m.set_global_proposal(4.0, 0.8)
            trace = m.run(12, skip=3)
            name = f"metropolis{'_mix' if mix else ''}_{seed}"
            out[name] = trace
            out[name + "_accepted"] = np.int64(m.trans_count)
    return out


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import tempfile
    from avenir_tpu.cli import run as cli_run
    from avenir_tpu.core import faults
    from avenir_tpu.pipeline.cache import program_cache
    import jax
    from avenir_tpu.stats import samplers as jax_samplers
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "samplers.npz"),
             **samplers(jax_samplers, jax.random.PRNGKey))
    with open(os.path.join(out_dir, "stream.txt"), "w") as fh:
        fh.write("\n".join(stream()) + "\n")
    for case in CASES:
        with tempfile.TemporaryDirectory() as work:
            run_case(cli_run.main, faults, program_cache().clear, case,
                     work)
            keep(work, os.path.join(out_dir, case), case)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms",
                      os.environ.get("JAX_PLATFORMS") or "cpu")
    if len(jax.devices()) != 1:
        raise SystemExit(f"make the fixture in a one-device process, not "
                         f"{jax.devices()}")
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
