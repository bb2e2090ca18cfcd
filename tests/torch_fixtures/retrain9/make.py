"""Make the retrain9 fixture with the JAX package, on the CPU: the
``retrainController`` job closing the drift loop of the rafo9 forest.

The champion is the ``rafo9q`` registry's ``rafo9`` v1 (9 trees of
``resource/rafo.properties``, with its training baseline), copied afresh
for every case.  The fresh window is ``drift9/stream.csv`` (the drifted
record stream, malformed lines included; they are skipped and counted),
the tree keys are ``rafo.properties``' and the stream is read in
BLOCK_ROWS-row blocks.  Four cases, each in its own directory:

  a   dtb.retrain.trigger=force, no probation: the cycle publishes v2
      with a delta against v1, pins it and completes ``published``
  b   an alert-driven cycle from ``drift9/drift/alerts.jsonl``
  c   a probation replay (dtb.retrain.probation.outcomes=PROBATION) over
      the stream with its labels flipped (:func:`flip_labels`): the
      candidate underperforms and the cycle rolls back to v1
  d   AVENIR_TPU_FAULTS=registry_publish@2=raise:RuntimeError kills the
      job after the publish committed; a second run resumes the cycle,
      adopts the committed version (PublishDeduped 1) and completes

Each case keeps ``decisions.jsonl`` and ``part-r-00000`` (the job's
output), ``counters.json`` (the COUNTER_GROUPS of its counters),
``controller.json`` (the journal) and ``registry/serving.json`` (the
serving pin).  Every case publishes the same v2 (one window, one seed),
so case a alone keeps ``registry/v_000002``; v1 is the champion's copy
and is left out.  Case d also keeps ``crashed.json``, the journal the
killed run left.  The port (``avenir_tpu_torch``) is held against these
files on the CPU by ``tests/test_torch_retrain9.py`` and on the GPU by
``chip_smoke.py``.  Regenerate from the repo root (the test reruns it
into a temporary directory and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/retrain9/make.py
"""

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
FIXTURES = os.path.dirname(HERE)
CHAMPION = os.path.join(FIXTURES, "rafo9q", "registry")
STREAM = os.path.join(FIXTURES, "drift9", "stream.csv")
ALERTS = os.path.join(FIXTURES, "drift9", "drift", "alerts.jsonl")

MODEL_NAME = "rafo9"
BLOCK_ROWS = 1024
PROBATION = 200
FAULT = "registry_publish@2=raise:RuntimeError"
CASES = ("a", "b", "c", "d")
COUNTER_GROUPS = ("BadRecords", "Controller")


def flip_labels(src: str, dest: str) -> None:
    """The stream with every T/F class label flipped (malformed lines
    kept as they are): the probation replay's delayed labels."""
    with open(src) as fh, open(dest, "w") as out:
        for line in fh:
            f = line.rstrip("\n").split(",")
            if len(f) == 6 and f[5] in ("T", "F"):
                f[5] = "F" if f[5] == "T" else "T"
            out.write(",".join(f) + "\n")


def case_args(case: str, registry: str, state: str, work: str):
    """The job's -D arguments for one case."""
    args = [f"-Dconf.path={os.path.join(RES, 'rafo.properties')}",
            f"-Ddtb.feature.schema.file.path="
            f"{os.path.join(RES, 'call_hangup.json')}",
            f"-Ddtb.model.registry.dir={registry}",
            f"-Ddtb.model.name={MODEL_NAME}",
            f"-Ddtb.retrain.state.dir={state}",
            f"-Ddtb.retrain.block.rows={BLOCK_ROWS}"]
    if case == "b":
        return args + [f"-Ddtb.retrain.alerts.path={ALERTS}"]
    args.append("-Ddtb.retrain.trigger=force")
    if case == "c":
        flipped = os.path.join(work, "flipped.csv")
        flip_labels(STREAM, flipped)
        args += [f"-Ddtb.retrain.probation.outcomes={PROBATION}",
                 f"-Ddtb.retrain.probation.input={flipped}"]
    return args


def run_case(main, faults, case: str, work: str):
    """Run one case through a CLI ``main`` (either package's, with its
    ``core.faults`` module) in ``work``; returns the output directory.
    The registry is ``work/registry`` and the journal's state directory
    ``work/state``."""
    registry = os.path.join(work, "registry")
    shutil.copytree(CHAMPION, registry)
    state = os.path.join(work, "state")
    stream = os.path.join(work, "stream.csv")
    shutil.copyfile(STREAM, stream)
    args = case_args(case, registry, state, work)
    out = os.path.join(work, "out")
    if case == "d":
        faults.install(faults.FaultInjector.parse(FAULT))
        try:
            main(["retrainController", *args, stream, out])
        except RuntimeError as exc:
            assert "injected fault" in str(exc), exc
        else:
            raise AssertionError("the injected publish fault did not fire")
        finally:
            faults.uninstall()
        shutil.copyfile(os.path.join(state, "controller.json"),
                        os.path.join(work, "crashed.json"))
    assert main(["retrainController", *args, stream, out]) == 0
    return out


def keep(work: str, dest: str, versions: bool) -> None:
    """Copy one case's kept files from its work directory to ``dest``
    (the published version directories too when ``versions``)."""
    out = os.path.join(work, "out")
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    for f in ("decisions.jsonl", "part-r-00000"):
        shutil.copyfile(os.path.join(out, f), os.path.join(dest, f))
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)
    with open(os.path.join(dest, "counters.json"), "w") as fh:
        json.dump({g: counters[g] for g in COUNTER_GROUPS if g in counters},
                  fh, indent=2, sort_keys=True)
        fh.write("\n")
    shutil.copyfile(os.path.join(work, "state", "controller.json"),
                    os.path.join(dest, "controller.json"))
    if os.path.exists(os.path.join(work, "crashed.json")):
        shutil.copyfile(os.path.join(work, "crashed.json"),
                        os.path.join(dest, "crashed.json"))
    src = os.path.join(work, "registry", MODEL_NAME)
    for name in sorted(os.listdir(src)):
        if name == "v_000001" or (name.startswith("v_") and not versions):
            continue
        s, d = os.path.join(src, name), os.path.join(dest, "registry", name)
        if os.path.isdir(s):
            shutil.copytree(s, d)
        else:
            os.makedirs(os.path.dirname(d), exist_ok=True)
            shutil.copyfile(s, d)


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.cli import run as cli_run
    from avenir_tpu.core import faults
    for case in CASES:
        with tempfile.TemporaryDirectory() as work:
            run_case(cli_run.main, faults, case, work)
            keep(work, os.path.join(out_dir, case), versions=case == "a")


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
