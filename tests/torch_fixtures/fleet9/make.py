"""Make the fleet9 fixture with the JAX package, on the CPU: the rafo9
forest served by the fleet tier of ``predictionService`` over the RESP
wire.

  registry/rafo9/      the wire9 fixture's registry: v1 (the 9-tree rafo9
                       forest with its baseline and int8 quantized
                       sidecars), v2 (a delta of v1: four trees replaced)
                       and serving.json pinning v1
  registry/backup/v_000001/   a byte copy of rafo9 v1 published under the
                       name ``backup`` (a second resident model)
  <case>.csv           the part file (one ``<id>,<class>`` line per record
                       of ../wire9/records.csv: 300 records of
                       ../rafo9/requests.csv and two malformed ones) of
                       the case's ``predictionService ps.transport=resp``
                       job over a copy of the registry, for the cases of
                       CASES but ``f``
  counters.json        per case, the job's counters that do not depend on
                       timing (COUNTER_KEYS)

CASES:

  a  ps.workers=2 ps.broker.shards=2
  b  ps.models=rafo9,backup ps.client.model=backup
  c  ps.models=rafo9,backup, canary rafo9 v1 at 25% while v2 serves (the
     copy's pin cleared)
  d  ps.models=rafo9,backup, shadow rafo9 v1 while v2 serves
  e  ps.workers=2 ps.quantized=true (v1's int8 sidecar)
  f  ps.workers=2 ps.queue.max.depth=4: which requests are shed depends on
     timing, so nothing is stored; the rule is that every id is answered,
     with case a's class or ``busy``

:func:`run_case` takes the package's ``cli.run`` module as an argument, so
the port's tests run the same jobs through ``avenir_tpu_torch``
(``tests/test_torch_fleet.py``, ``tests/test_torch_router.py``).
Regenerate from the repo root:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/fleet9/make.py
"""

import json
import os
import shutil
import sys
import tempfile
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
WIRE9 = os.path.join(HERE, "..", "wire9")
RECORDS = os.path.join(WIRE9, "records.csv")
PROPS = os.path.join(ROOT, "resource", "rafo.properties")
MODEL_NAME = "rafo9"
BACKUP = "backup"
N_RECORDS = 302
MULTI = (f"-Dps.models={MODEL_NAME},{BACKUP}",)
# case -> (job keys, whether the registry copy's v1 pin is cleared so that
# v2 serves)
CASES = {
    "a": (("-Dps.workers=2", "-Dps.broker.shards=2"), False),
    "b": (MULTI + (f"-Dps.client.model={BACKUP}",), False),
    "c": (MULTI + (f"-Dps.canary.{MODEL_NAME}.version=1",
                   f"-Dps.canary.{MODEL_NAME}.percent=25"), True),
    "d": (MULTI + (f"-Dps.shadow.{MODEL_NAME}.version=1",), True),
    "e": (("-Dps.workers=2", "-Dps.quantized=true"), False),
    "f": (("-Dps.workers=2", "-Dps.queue.max.depth=4"), False),
}
STORED = ("a", "b", "c", "d", "e")
COUNTER_KEYS = {
    "Serving": ("Requests",),
    "Model": tuple(f"{m}/{k}" for m in (MODEL_NAME, BACKUP)
                   for k in ("Requests", "CanaryRequests",
                             "ShadowDivergence")),
    "Broker": ("Shards",),
}


def case_registry(src: str, dest: str, case: str) -> str:
    """A copy of the registry ``src`` at ``dest`` for ``case`` (the pin
    cleared where the case serves v2)."""
    shutil.copytree(src, dest)
    if CASES[case][1]:
        os.remove(os.path.join(dest, MODEL_NAME, "serving.json"))
    return dest


def run_case(cli_run, registry_src: str, work: str, case: str,
             extra=()):
    """``predictionService`` of ``case`` through ``cli_run.main`` over a
    copy of ``registry_src`` under ``work``; returns (the part file's
    text, the counters of COUNTER_KEYS that the job wrote)."""
    reg = case_registry(registry_src, os.path.join(work, f"reg_{case}"),
                        case)
    out = os.path.join(work, f"out_{case}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rc = cli_run.main([
            "org.avenir.serving.PredictionService", f"-Dconf.path={PROPS}",
            f"-Dps.model.registry.dir={reg}",
            f"-Dps.model.name={MODEL_NAME}", "-Dps.transport=resp",
            *CASES[case][0], *extra, RECORDS, out])
    assert rc == 0, (case, rc)
    with open(os.path.join(out, "part-m-00000")) as fh:
        text = fh.read()
    with open(out + ".counters.json") as fh:
        c = json.load(fh)
    counters = {g: {k: c[g][k] for k in keys if k in c.get(g, {})}
                for g, keys in COUNTER_KEYS.items()}
    return text, {g: v for g, v in counters.items() if v}


def answered_or_busy(text: str, full: str) -> bool:
    """Case f's rule: line i of ``text`` is line i of ``full`` (case a's
    part file) or ``<i>,busy``, for every id."""
    got, want = text.splitlines(), full.splitlines()
    return len(got) == len(want) == N_RECORDS and all(
        g == w or g == f"{i},busy"
        for i, (g, w) in enumerate(zip(got, want)))


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.cli import run as cli_run
    os.makedirs(out_dir, exist_ok=True)
    reg_dir = os.path.join(out_dir, "registry")
    shutil.rmtree(reg_dir, ignore_errors=True)
    shutil.copytree(os.path.join(WIRE9, "registry"), reg_dir)
    shutil.copytree(os.path.join(reg_dir, MODEL_NAME, "v_000001"),
                    os.path.join(reg_dir, BACKUP, "v_000001"))
    counters = {}
    with tempfile.TemporaryDirectory() as work:
        texts = {}
        for case in CASES:
            texts[case], c = run_case(cli_run, reg_dir, work, case)
            if case in STORED:
                with open(os.path.join(out_dir, f"{case}.csv"), "w") as fh:
                    fh.write(texts[case])
                counters[case] = c
        assert answered_or_busy(texts["f"], texts["a"])
    with open(os.path.join(out_dir, "counters.json"), "w") as fh:
        json.dump(counters, fh, indent=2, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
