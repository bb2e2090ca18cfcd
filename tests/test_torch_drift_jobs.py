"""The port's drift jobs (``avenir_tpu_torch/cli/monitor_jobs.py``) on the
CPU against the ``drift9`` fixture, which the JAX package made
(``tests/torch_fixtures/drift9/make.py``).

Held to: every non-statistic field of ``part-r-00000`` (index, kind,
scope, row kind, n_rows, level) byte-equal and the statistics within rtol
1e-5 / atol 1e-7 of the reference's (the count of differing six-decimal
strings is printed and bounded; on this fixture it is 0);
``alerts.jsonl``'s records equal apart from ``value`` (within the same
tolerance); the ``BadRecords``, ``DriftMonitor`` and ``PredictDrift``
counters equal; ``predictDriftScore``'s predictions byte-equal.  Both jobs
refuse an unknown ``dm.source`` by name, and ``predictDriftScore`` refuses
the fused default.  A rerun of ``make.py`` into a temporary directory must
reproduce the fixture's files.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

from avenir_tpu_torch.cli import run as cli_run
from avenir_tpu_torch.cli.jobs import JobNotPorted

TESTS = os.path.dirname(os.path.abspath(__file__))
DRIFT9 = os.path.join(TESTS, "torch_fixtures", "drift9")
REGISTRY = os.path.join(TESTS, "torch_fixtures", "rafo9q", "registry")
RTOL, ATOL = 1e-5, 1e-7
N_STATS = 5


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "drift9_make", os.path.join(DRIFT9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()


def compare_report(got_path, want_path):
    """Non-statistic fields equal, statistics within tolerance; returns
    (differing six-decimal strings, statistics compared)."""
    with open(got_path) as a, open(want_path) as b:
        got, want = a.read().splitlines(), b.read().splitlines()
    assert len(got) == len(want)
    strings = 0
    for g, w in zip(got, want):
        gf, wf = g.split(","), w.split(",")
        assert gf[:5] + gf[5 + N_STATS:] == wf[:5] + wf[5 + N_STATS:], g
        for a, b in zip(gf[5:5 + N_STATS], wf[5:5 + N_STATS]):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL,
                                       atol=ATOL)
            strings += a != b
    return strings, len(got) * N_STATS


def compare_alerts(got_path, want_path):
    with open(got_path) as a, open(want_path) as b:
        got = [json.loads(line) for line in a]
        want = [json.loads(line) for line in b]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.pop("value"), w.pop("value"),
                                   rtol=RTOL, atol=ATOL)
        assert g == w


def counter_groups(path):
    with open(path) as fh:
        counters = json.load(fh)
    return {g: counters[g] for g in MAKE.COUNTER_GROUPS if g in counters}


def _run(job, tmp_path, *extra):
    reg = tmp_path / "registry"
    if not reg.exists():
        shutil.copytree(REGISTRY, reg)
    out = tmp_path / job
    rc = cli_run.main([job, "-Dplatform=cpu",
                       f"-Ddm.model.registry.dir={reg}",
                       f"-Ddm.model.name={MAKE.MODEL_NAME}", *MAKE.KEYS,
                       *extra, os.path.join(DRIFT9, "stream.csv"), str(out)])
    assert rc == 0
    return out


@pytest.mark.parametrize("job,sub,extra", [
    ("driftMonitor", "drift", ()),
    ("predictDriftScore", "predict", ("-Ddm.pipeline.fuse=false",))])
def test_job_matches_fixture(tmp_path, job, sub, extra):
    out = _run(job, tmp_path, *extra)
    want = os.path.join(DRIFT9, sub)
    strings, n = compare_report(out / "part-r-00000",
                                os.path.join(want, "part-r-00000"))
    print(f"{job}: {strings} of {n} six-decimal statistics differ")
    assert strings <= 0.01 * n
    compare_alerts(out / "alerts.jsonl", os.path.join(want, "alerts.jsonl"))
    got_c = counter_groups(f"{out}.counters.json")
    with open(os.path.join(DRIFT9, f"{sub}_counters.json")) as fh:
        assert got_c == json.load(fh)
    if sub == "predict":
        with open(out / "predictions" / "part-m-00000", "rb") as a, \
                open(os.path.join(want, "predictions", "part-m-00000"),
                     "rb") as b:
            assert a.read() == b.read()


def test_fixture_has_quiet_windows_then_warn_and_alert():
    with open(os.path.join(DRIFT9, "drift", "alerts.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    first_drift_window = MAKE.QUIET_ROWS // 512
    assert min(r["window_index"] for r in recs) > first_drift_window
    assert {r["level"] for r in recs} == {"warn", "alert"}
    with open(os.path.join(DRIFT9, "drift_counters.json")) as fh:
        assert json.load(fh)["BadRecords"]["Skipped"] == len(MAKE.MALFORMED)


@pytest.mark.parametrize("job", ["driftMonitor", "predictDriftScore"])
def test_resp_source_is_refused_by_name(tmp_path, job):
    """``dm.source=resp`` is ported (``tests/test_torch_wire_serving.py``
    holds it against ``file``); a source that is neither is refused by
    name."""
    with pytest.raises(ValueError, match="dm.source 'kafka'"):
        _run(job, tmp_path, "-Ddm.source=kafka", "-Ddm.pipeline.fuse=false")


@pytest.mark.parametrize("fuse", [(), ("-Ddm.pipeline.fuse=true",)])
def test_predict_drift_score_refuses_the_fused_path(tmp_path, fuse):
    with pytest.raises(JobNotPorted, match="PredictDriftFlow"):
        _run("predictDriftScore", tmp_path, *fuse)


def test_bad_records_fail_policy_raises(tmp_path):
    """badrecords.policy=fail: the malformed records (a short row, a
    non-numeric field) kill the replay in the first window's encode."""
    with pytest.raises((IndexError, ValueError)):
        _run("driftMonitor", tmp_path, "-Dbadrecords.policy=fail")


def test_make_reproduces_the_fixture(tmp_path):
    """Rerun the JAX package's maker into a temporary directory: every
    file it writes equals the committed one."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = tmp_path / "drift9"
    MAKE.make(str(out))
    for root, _, files in os.walk(out):
        for f in files:
            got = os.path.join(root, f)
            rel = os.path.relpath(got, out)
            with open(got, "rb") as a, open(os.path.join(DRIFT9, rel),
                                            "rb") as b:
                assert a.read() == b.read(), rel
