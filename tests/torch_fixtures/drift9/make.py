"""Make the drift9 fixture with the JAX package, on the CPU: a drifted
record stream replayed against the rafo9q registry's rafo9 model and its
training baseline, through ``driftMonitor`` and ``predictDriftScore``.

The stream (``stream.csv``) is drawn from ``resource/gen/call_hangup_gen.py``'s
model with a new seed: QUIET_ROWS rows from the training distribution, then
DRIFT_ROWS rows with ``queueTimeSec`` mean-shifted (QUEUE_SHIFT seconds
added) and ``issueType`` reweighted (DRIFT_ISSUE_P), with MALFORMED lines
(a short row, a non-numeric field) mixed in.  Both jobs run with
``dm.window.rows=512`` (the tail window is partial), ``dm.score.predictions``
and the accuracy thresholds of ``KEYS``; the malformed lines are skipped
(``badrecords.policy`` defaults to skip) and counted:

  drift/part-r-00000, drift/alerts.jsonl      driftMonitor's report + alerts
  drift_counters.json                         its BadRecords, DriftMonitor
                                              and PredictDrift counters
  predict/part-r-00000, predict/alerts.jsonl  predictDriftScore
  predict/predictions/part-m-00000            (dm.pipeline.fuse=false)
  predict_counters.json

The quiet windows raise no alert record; the drifted ones raise warn and
alert records.  The port (``avenir_tpu_torch``) is held against these files
on the CPU by ``tests/test_torch_drift_jobs.py`` and on the GPU by
``chip_smoke.py``.  Regenerate from the repo root
(``tests/test_torch_drift_jobs.py`` reruns it into a temporary directory
and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/drift9/make.py
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
REGISTRY = os.path.join(HERE, "..", "rafo9q", "registry")

MODEL_NAME = "rafo9"
SEED = 91
QUIET_ROWS = 2048
DRIFT_ROWS = 2300
QUEUE_SHIFT = 600
DRIFT_ISSUE_P = (0.1, 0.1, 0.1, 0.7)
MALFORMED = ("K9000000,billing,120", "K9000001,outage,soon,0,1,F",
             "K9000002,other,300,x,2,T", "K9000003")
# the forest's predicted class mix sits ~0.1 psi from the training mix on
# undrifted records: the psi and chi2 warn bars are raised above it
KEYS = ("-Ddm.window.rows=512", "-Ddm.score.predictions=true",
        "-Ddm.warn.psi=0.2", "-Ddm.warn.chi2=0.18",
        "-Ddm.accuracy.warn=62", "-Ddm.accuracy.alert=55")
COUNTER_GROUPS = ("BadRecords", "DriftMonitor", "PredictDrift")


def stream_rows():
    """The record lines, in order (call_hangup_gen's model; the drifted
    part with its queue time shifted and its issue mix reweighted)."""
    sys.path.insert(0, RES)
    from gen.call_hangup_gen import ISSUES, ISSUE_P, PATIENCE
    rng = np.random.default_rng(SEED)
    rows = []
    for i in range(QUIET_ROWS + DRIFT_ROWS):
        drifted = i >= QUIET_ROWS
        p = DRIFT_ISSUE_P if drifted else ISSUE_P
        issue = ISSUES[rng.choice(len(ISSUES), p=p)]
        queue = rng.exponential(420) + (QUEUE_SHIFT if drifted else 0)
        queue = int(np.clip(queue, 0, 1800))
        transfers = int(np.clip(rng.poisson(0.7), 0, 4))
        prior = int(np.clip(rng.poisson(1.0), 0, 9))
        annoyance = queue / PATIENCE[issue] + 0.5 * transfers + 0.3 * prior
        hung = rng.random() < 1.0 / (1.0 + np.exp(-3.5 * (annoyance - 1.1)))
        rows.append(f"S{i:07d},{issue},{queue},{transfers},{prior},"
                    f"{'T' if hung else 'F'}")
    # the malformed lines land inside the first quiet window and the first
    # drifted one
    for j, line in enumerate(MALFORMED):
        at = 100 + 37 * j if j < 2 else QUIET_ROWS + 50 * j
        rows.insert(at, line)
    return rows


def counter_groups(path):
    with open(path) as fh:
        counters = json.load(fh)
    return {g: counters[g] for g in COUNTER_GROUPS if g in counters}


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.cli import run as cli_run
    os.makedirs(out_dir, exist_ok=True)
    stream = os.path.join(out_dir, "stream.csv")
    with open(stream, "w") as fh:
        fh.write("\n".join(stream_rows()) + "\n")
    with tempfile.TemporaryDirectory() as work:
        registry = os.path.join(work, "registry")
        shutil.copytree(REGISTRY, registry)
        common = [f"-Ddm.model.registry.dir={registry}",
                  f"-Ddm.model.name={MODEL_NAME}", *KEYS]
        for job, sub, extra in (("driftMonitor", "drift", ()),
                                ("predictDriftScore", "predict",
                                 ("-Ddm.pipeline.fuse=false",))):
            out = os.path.join(work, sub)
            assert cli_run.main([job, *common, *extra, stream, out]) == 0
            dest = os.path.join(out_dir, sub)
            shutil.rmtree(dest, ignore_errors=True)
            shutil.copytree(out, dest)
            with open(os.path.join(out_dir, f"{sub}_counters.json"),
                      "w") as fh:
                json.dump(counter_groups(out + ".counters.json"), fh,
                          indent=2, sort_keys=True)
                fh.write("\n")


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
