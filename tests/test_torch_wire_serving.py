"""The port's serving over the RESP wire (``serving/service.py``
``RespPredictionLoop``, ``cli/serving_jobs.py`` ``ps.transport=resp``,
``cli/monitor_jobs.py`` ``dm.source=resp``) on the CPU, against the JAX
package's outputs.

Held to, byte for byte: the golden ``wire`` fixture from the port's
encoders; the ``wire9`` fixture (``tests/torch_fixtures/wire9/make.py``,
made by the JAX package) — its replies from the port's loop on the native
and the Python plane, in lease mode and on a durable broker, with the
fixture's counters, and its job replies from the port's
``predictionService ps.transport=resp``; the port's ``dm.source=resp``
drift report against its ``dm.source=file`` one.  The TTL answers
``late`` before any dispatch, head-sampled requests leave flow events that
pass ``validate_trace_events``, and the fleet-tier keys that the
single-worker slice refused by name are accepted, each giving the
single-worker bytes on this registry.
"""

import importlib.util
import json
import os
import shutil
import warnings

import numpy as np
import pytest

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.io import native_wire, respq
from avenir_tpu_torch.io.respq import _encode_command
from avenir_tpu_torch.serving import service
from avenir_tpu_torch.serving.quantized import QuantizedForest, \
    wire_encode_rows
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.telemetry import (Tracer, install_tracer, reqtrace,
                                        uninstall_tracer,
                                        validate_trace_events)
from avenir_tpu_torch.telemetry.trace import read_trace_file

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
WIRE9 = os.path.join(TESTS, "torch_fixtures", "wire9")
GOLDEN_WIRE = os.path.join(TESTS, "golden", "fixtures", "wire")
DRIFT9 = os.path.join(TESTS, "torch_fixtures", "drift9")
RAFO9Q_REG = os.path.join(TESTS, "torch_fixtures", "rafo9q", "registry")
PROPS = os.path.join(ROOT, "resource", "rafo.properties")


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _module(os.path.join(WIRE9, "make.py"), "wire9_make")


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


def _lines(path):
    return _read(path).splitlines()


def restart_sampling_counters():
    """Both packages count predict pushes for head sampling in a
    process-global counter; restart them, so the ids a test samples do
    not depend on the tests run before it in the same process."""
    import itertools
    from avenir_tpu.telemetry import reqtrace as jax_reqtrace
    reqtrace.reset_sampling()
    jax_reqtrace._counter = itertools.count(1)


@pytest.fixture(autouse=True)
def cpu_default():
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    restart_sampling_counters()
    yield
    set_default_device(None)
    native_wire.set_mode("auto")
    reqtrace.set_sample_rate(0)


@pytest.fixture()
def registry(tmp_path):
    d = tmp_path / "registry"
    shutil.copytree(os.path.join(WIRE9, "registry"), d)
    return ModelRegistry(str(d))


# --------------------------------------------------------------------------
# the golden wire fixture
# --------------------------------------------------------------------------

def test_golden_wire_fixture_from_the_port_encoders():
    """tests/golden/flows.py wire_flow's inputs through the port's
    QuantizedForest, wire_encode_rows and _encode_command (and the native
    encode_lpush): the committed bytes."""
    qf = QuantizedForest(
        q_lo=np.zeros((1, 1, 4), np.int8), q_hi=np.zeros((1, 1, 4), np.int8),
        num_r=np.zeros((1, 1, 4), bool), cat_m=np.zeros((1, 1, 4, 1), bool),
        cat_r=np.zeros((1, 1, 4), bool), cls_oh=np.zeros((1, 1, 2), np.uint8),
        wvec=np.ones((1,), np.float32),
        scale=np.array([0.5, 2.0, 10.0, 0.25]),
        fmin=np.array([-10.0, 0.0, -100.0, 1.0]), classes=["T", "F"])
    vals = np.array([[-10.0, 0.0, -100.0, 1.0], [-9.75, 1.0, -95.0, 1.125],
                     [117.0, 508.0, 2440.0, 64.5], [1e9, -1e9, 0.0, -1e9],
                     [np.inf, -np.inf, np.nan, 2.0]])
    codes = np.array([[0, 1, 2, 3], [-1, -5, 0, 1], [127, 200, 7, 0],
                      [3, 1, 4, 1], [0, 0, 0, 0]], np.int32)
    qv, qc = qf.quantize_rows(vals, codes)
    lines = wire_encode_rows([0, 1, 2, 3, 4], qv, qc)
    assert "\n".join(lines) + "\n" == \
        _read(os.path.join(GOLDEN_WIRE, "predictq.csv"))
    replies = [f"{i},{lab}" for i, lab in
               enumerate(["T", "F", "T", "error", "__AMBIG__"])]
    resp = _encode_command(["LPUSH", "predictionQueue"] + replies)
    assert repr(resp) + "\n" == \
        _read(os.path.join(GOLDEN_WIRE, "resp_lpush.txt"))
    assert native_wire.encode_lpush("predictionQueue", replies) == resp


# --------------------------------------------------------------------------
# the wire9 fixture
# --------------------------------------------------------------------------

def test_make_reproduces_the_fixture(tmp_path):
    """make.py rerun into a temporary directory: every file equal (the
    .npz files array for array; serving.json by its version — it stamps
    the write time)."""
    out = tmp_path / "wire9"
    MAKE.make(str(out))
    for dirpath, _, files in os.walk(WIRE9):
        rel = os.path.relpath(dirpath, WIRE9)
        for f in files:
            if f == "make.py" or "__pycache__" in rel:
                continue
            want, got = os.path.join(dirpath, f), os.path.join(out, rel, f)
            if f.endswith(".npz"):
                with np.load(want) as a, np.load(got) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in a.files:
                        np.testing.assert_array_equal(a[k], b[k])
            elif f == "serving.json":
                assert json.loads(_read(got))["version"] == \
                    json.loads(_read(want))["version"] == 1
            else:
                assert _read(got, "rb") == _read(want, "rb"), (rel, f)


FLOWS = [("replies", False, "on", 0.0, None),
         ("replies", False, "off", 0.0, None),
         ("replies_q", True, "on", 0.0, None),
         ("replies_q", True, "off", 0.0, None),
         ("replies", False, "on", 30.0, None),
         ("replies", False, "on", 30.0, "commit"),
         ("replies_q", True, "off", 30.0, "commit")]


@pytest.mark.parametrize("name,quantized,plane,lease_s,durable", FLOWS)
def test_wire9_replies(registry, tmp_path, name, quantized, plane, lease_s,
                       durable):
    lines = _lines(os.path.join(WIRE9, "requests.txt"))
    kw = {"durable": durable, "journal_dir": str(tmp_path / "journal")} \
        if durable else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        replies, counters, svc = MAKE.wire_flow(
            respq, service, registry, lines, quantized=quantized,
            wire_native=plane, lease_s=lease_s, server_kw=kw)
    assert replies == _lines(os.path.join(WIRE9, f"{name}.txt"))
    want = json.loads(_read(os.path.join(WIRE9, "counters.json")))[name]
    assert counters == want
    assert svc.version == 2
    assert (svc._wire_codec is not None) == (plane == "on")


def test_wire9_delta_reload_patches_the_served_forest(registry):
    """The reload of the float flow is a delta patch onto the resident
    forest; every reply after it equals a fresh full load of v2."""
    lines = _lines(os.path.join(WIRE9, "requests.txt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        replies, counters, svc = MAKE.wire_flow(respq, service, registry,
                                                lines)
    assert counters["Serving"]["DeltaSwaps"] == 1
    fresh = service.PredictionService(registry=registry, model_name="rafo9")
    assert fresh.version == 2
    seg3 = list(MAKE.segments(lines))[2][:-1]
    tail = replies[-len(fresh.process_batch(seg3)):]
    assert tail == fresh.process_batch(seg3)
    np.testing.assert_array_equal(
        np.concatenate([a.ravel() for a in svc.predictor.ensemble._host]),
        np.concatenate([a.ravel()
                        for a in fresh.predictor.ensemble._host]))


def _job(registry_dir, out, *extra, inp=None):
    rc = port_run.main([
        "predictionService", f"-Dconf.path={PROPS}", "-Dplatform=cpu",
        f"-Dps.model.registry.dir={registry_dir}", "-Dps.model.name=rafo9",
        *extra, inp or os.path.join(WIRE9, "records.csv"), str(out)])
    assert rc == 0
    return json.loads(_read(f"{out}.counters.json"))


@pytest.mark.parametrize("extra", [
    ("-Dps.wire.native=on",), ("-Dps.wire.native=off",),
    ("-Dps.broker.lease.timeout.s=30",),
    ("-Dps.broker.durable=commit",),
    ("-Dps.broker.durable=fsync", "-Dps.wire.native=off")])
def test_wire9_job_replies(registry, tmp_path, extra):
    out = tmp_path / "out"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        c = _job(registry.base_dir, out, "-Dps.transport=resp",
                 "-Dps.request.ttl.ms=600000", *extra)
    assert _read(out / "part-m-00000") == \
        _read(os.path.join(WIRE9, "job_replies.csv"))
    want = json.loads(_read(os.path.join(WIRE9, "counters.json")))["job"]
    assert {k: c["Serving"].get(k, 0) for k in want} == want
    durable = any("durable" in e for e in extra)
    assert ("JournalReplayed" in c.get("Broker", {})) == durable


def test_ttl_answers_late_before_dispatch(registry, tmp_path):
    out = tmp_path / "out"
    c = _job(registry.base_dir, out, "-Dps.transport=resp",
             "-Dps.request.ttl.ms=0.001")
    lines = _lines(out / "part-m-00000")
    assert lines == [f"{i},late" for i in range(302)]
    assert c["Broker"]["LateShed"] == 302
    assert c["Serving"].get("Requests", 0) == 0


def test_trace_sample_flow_events_validate(registry, tmp_path):
    """ps.trace.sample=3 with a tracer installed: every third predict push
    is stamped at the client, and each sampled request leaves one ``s``
    (enqueue), ``t`` legs (pop, dispatch) and one ``f`` (reply) — a trace
    validate_trace_events accepts — with answers unchanged."""
    tracer = install_tracer(Tracer(str(tmp_path / "trace"), run_id="w9"))
    try:
        out = tmp_path / "out"
        c = _job(registry.base_dir, out, "-Dps.transport=resp",
                 "-Dps.trace.sample=3")
    finally:
        uninstall_tracer()
        tracer.close()
    assert _read(out / "part-m-00000") == \
        _read(os.path.join(WIRE9, "job_replies.csv"))
    events = read_trace_file(tracer.path)
    assert validate_trace_events(events) == []
    flows = [e for e in events if e.get("name") == "request"]
    starts = {e["id"] for e in flows if e["ph"] == "s"}
    finishes = {e["id"] for e in flows if e["ph"] == "f"}
    assert starts == finishes and len(starts) == 302 // 3
    assert c["Serving"]["TracedRequests"] == 302 // 3
    steps = {e["args"]["step"] for e in flows if e["ph"] == "t"}
    assert steps == {"pop", "dispatch"}
    f = next(e for e in flows if e["ph"] == "f")
    assert set(f["args"]) >= {"queue_wait_ms", "coalesce_ms", "device_ms",
                              "reply_ms", "total_ms"}


def test_drift_monitor_resp_source_equals_file(tmp_path):
    """driftMonitor over drift9's stream pushed to a RespServer (one LPUSH
    a record, then stop) writes the report and alert bytes and the
    counters that dm.source=file writes."""
    drift = _module(os.path.join(DRIFT9, "make.py"), "drift9_make")
    reg = tmp_path / "registry"
    shutil.copytree(RAFO9Q_REG, reg)
    stream = os.path.join(DRIFT9, "stream.csv")
    server = respq.RespServer().start()
    try:
        feeder = respq.RespClient(port=server.port)
        feeder.lpush_many("driftQueue", _lines(stream) + ["stop"])
        feeder.close()
        outs = {}
        for source, extra in (
                ("file", ()),
                ("resp", ("-Ddm.source=resp",
                          f"-Dredis.server.port={server.port}",
                          "-Dredis.request.queue=driftQueue"))):
            out = tmp_path / source
            assert port_run.main([
                "driftMonitor", "-Dplatform=cpu",
                f"-Ddm.model.registry.dir={reg}",
                f"-Ddm.model.name={drift.MODEL_NAME}", *drift.KEYS, *extra,
                stream, str(out)]) == 0
            outs[source] = out
    finally:
        server.stop()
    for f in ("part-r-00000", "alerts.jsonl"):
        assert _read(outs["resp"] / f, "rb") == _read(outs["file"] / f, "rb")
    cf = json.loads(_read(f"{outs['file']}.counters.json"))
    cr = json.loads(_read(f"{outs['resp']}.counters.json"))
    for g in drift.COUNTER_GROUPS:
        assert cr.get(g) == cf.get(g), g


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", [
    "-Dps.models=rafo9", "-Dps.autoscale=true", "-Dps.client.model=rafo9",
    "-Dps.workers=2", "-Dps.broker.shards=2",
    "-Dps.canary.rafo9.version=2", "-Dps.shadow.rafo9.version=2",
    "-Dps.model.rafo9.queue.max.depth=8"])
def test_unported_serving_tiers_refuse_by_name(registry, tmp_path, key):
    """Each key this test once saw refused by name is ported: the job runs
    (the fleet tier for the fleet keys; the canary, shadow and per-model
    depth keys act only under ps.models, as in the JAX package) and gives
    the single-worker replies."""
    out = tmp_path / "o"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _job(registry.base_dir, out, "-Dps.transport=resp", key)
    assert _read(out / "part-m-00000") == \
        _read(os.path.join(WIRE9, "job_replies.csv"))


@pytest.mark.parametrize("key", [
    "-Dps.broker.durable=commit", "-Dps.broker.lease.timeout.s=5",
    "-Dps.request.ttl.ms=100"])
def test_wire_keys_need_the_resp_transport(registry, tmp_path, key):
    with pytest.raises(ValueError, match="require ps.transport=resp"):
        _job(registry.base_dir, tmp_path / "o", key)


def test_one_worker_and_one_shard_are_the_ported_sizes(registry, tmp_path):
    out = tmp_path / "o"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _job(registry.base_dir, out, "-Dps.transport=resp",
             "-Dps.workers=1", "-Dps.broker.shards=1")
    assert _read(out / "part-m-00000") == \
        _read(os.path.join(WIRE9, "job_replies.csv"))
