"""The port's CLI telemetry keys (``avenir_tpu_torch/cli/run.py``
``_telemetry_setup``) against the JAX package's, on the CPU.

``predictionService`` over the RESP wire with ``-Dtelemetry.trace.dir``
and ``-Dps.trace.sample=2`` writes a trace file on both packages, with
the same multiset of event names, categories and phases and the same
sampled request ids in its flow events.  ``telemetry.metrics.port=0`` and
``telemetry.metrics.snapshot.s`` on a port job serve ``/metrics`` and
``/healthz`` while the job runs and write ``<out>.metrics.jsonl``; the
environment twins work as the keys do, and everything is torn down after
the job.
"""

import collections
import glob
import json
import os
import shutil
import time
import urllib.request
import warnings

import pytest

from avenir_tpu.cli import run as jax_run
from avenir_tpu_torch.cli import jobs as port_jobs
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.io import native_wire
from avenir_tpu_torch.telemetry import current_tracer, metrics, reqtrace
from avenir_tpu_torch.telemetry import server as port_server
from avenir_tpu_torch.telemetry.trace import read_trace_file

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
WIRE9 = os.path.join(TESTS, "torch_fixtures", "wire9")
PROPS = os.path.join(ROOT, "resource", "rafo.properties")


@pytest.fixture(autouse=True)
def restore_modes():
    yield
    native_wire.set_mode("auto")
    reqtrace.set_sample_rate(0)
    from avenir_tpu.io import native_wire as jax_wire
    from avenir_tpu.telemetry import reqtrace as jax_reqtrace
    jax_wire.set_mode("auto")
    jax_reqtrace.set_sample_rate(0)


def _trace_summary(trace_dir):
    files = sorted(glob.glob(os.path.join(trace_dir, "*.jsonl")))
    events = [e for f in files for e in read_trace_file(f)]
    kinds = collections.Counter((e.get("name"), e.get("cat"), e.get("ph"))
                                for e in events)
    flow_ids = sorted({e["id"] for e in events
                       if e.get("ph") in ("s", "t", "f")})
    return len(files), kinds, flow_ids


@pytest.mark.parametrize("plane", ["on", "off"])
def test_trace_dir_writes_the_reference_trace(tmp_path, plane):
    """Both packages' jobs write one trace file with equal event kinds
    and equal sampled ids (timestamps and pids differ)."""
    out = {}
    for pkg, run, extra in (("jax", jax_run, ()),
                            ("torch", port_run, ("-Dplatform=cpu",))):
        reg = tmp_path / f"reg_{pkg}"
        shutil.copytree(os.path.join(WIRE9, "registry"), reg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert run.main([
                "predictionService", f"-Dconf.path={PROPS}", *extra,
                f"-Dps.model.registry.dir={reg}", "-Dps.model.name=rafo9",
                "-Dps.transport=resp", "-Dps.trace.sample=2",
                f"-Dps.wire.native={plane}",
                f"-Dtelemetry.trace.dir={tmp_path / f'trace_{pkg}'}",
                "-Dtelemetry.run.id=cmp",
                os.path.join(WIRE9, "records.csv"),
                str(tmp_path / f"out_{pkg}")]) == 0
        out[pkg] = _trace_summary(tmp_path / f"trace_{pkg}")
    assert out["torch"] == out["jax"]
    n_files, kinds, ids = out["torch"]
    assert n_files == 1 and len(ids) == 151
    assert kinds[("request", "request", "f")] == 151
    assert current_tracer() is None


def _probe_job(seen):
    """A job that scrapes the run's endpoint from inside the run and waits
    for one snapshot."""
    def job(cfg, in_path, out_path):
        from avenir_tpu_torch.core.metrics import Counters
        from avenir_tpu_torch.serving.service import PredictionService

        class Stub:
            def warm(self):
                return self

            def predict_rows(self, rows):
                return ["y"] * len(rows)
        reg = metrics.get_default_registry()
        svc = PredictionService(Stub(), warm=False, name="probe")
        svc.process_batch(["predict,0,a", "predict,1,b"])
        srv = seen["servers"][-1]
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            seen["metrics"] = r.read().decode()
        with urllib.request.urlopen(srv.url + "/healthz/probe",
                                    timeout=10) as r:
            seen["healthz"] = r.status
        deadline = time.monotonic() + 30.0
        while reg.snapshots_taken < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        svc.stop(drain_s=0.5)
        c = Counters()
        c.increment("Probe", "Ran")
        return c
    return job


@pytest.mark.parametrize("how", ["keys", "env"])
def test_metrics_port_serves_during_the_job(tmp_path, monkeypatch, how):
    seen = {"servers": []}
    start = port_server.MetricsServer.start

    def capture(self):
        seen["servers"].append(self)
        return start(self)
    monkeypatch.setattr(port_server.MetricsServer, "start", capture)
    monkeypatch.setitem(port_jobs.JOBS, "telemetryProbe", _probe_job(seen))
    args = ["-Dtelemetry.metrics.snapshot.s=0.02", "-Dplatform=cpu"]
    if how == "keys":
        args += ["-Dtelemetry.metrics.port=0",
                 "-Dtelemetry.metrics.host=127.0.0.1"]
    else:
        monkeypatch.setenv("AVENIR_TPU_METRICS_PORT", "0")
        monkeypatch.setenv("AVENIR_TPU_METRICS_HOST", "127.0.0.1")
    out = tmp_path / "out"
    assert port_run.main(["telemetryProbe", *args, str(out)]) == 0
    assert 'avenir_serving{host="",service="probe",model="",' \
           'key="served"} 2' in seen["metrics"]
    assert 'avenir_transfer{key="h2d_bytes"}' in seen["metrics"]
    assert 'avenir_step_calls_total' in seen["metrics"]
    assert seen["healthz"] == 200
    with open(f"{out}.metrics.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    assert recs and all("ts" in r for r in recs)
    assert json.loads(open(f"{out}.counters.json").read())["Probe"] == \
        {"Ran": 1}
    # torn down: no default registry, the endpoint closed
    assert metrics.get_default_registry() is None
    with pytest.raises(OSError):
        urllib.request.urlopen(seen["servers"][-1].url + "/metrics",
                               timeout=2)


def test_fleet_job_with_metrics_and_snapshots(tmp_path):
    """A real fleet job under the telemetry keys: the same bytes as
    without them, and the flight recorder written beside the output."""
    reg = tmp_path / "reg"
    shutil.copytree(os.path.join(WIRE9, "registry"), reg)
    out = tmp_path / "out"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert port_run.main([
            "predictionService", f"-Dconf.path={PROPS}", "-Dplatform=cpu",
            f"-Dps.model.registry.dir={reg}", "-Dps.model.name=rafo9",
            "-Dps.transport=resp", "-Dps.workers=2",
            "-Dtelemetry.metrics.port=0",
            "-Dtelemetry.metrics.snapshot.s=0.01",
            os.path.join(WIRE9, "records.csv"), str(out)]) == 0
    with open(out / "part-m-00000") as a, \
            open(os.path.join(WIRE9, "job_replies.csv")) as b:
        assert a.read() == b.read()
    assert os.path.exists(f"{out}.metrics.jsonl")
    assert metrics.get_default_registry() is None
