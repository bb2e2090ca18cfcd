"""The port's metrics registry and endpoint (``avenir_tpu_torch/telemetry/
metrics.py`` and ``server.py``) against the JAX package's, on the CPU.

One script of counter, gauge, histogram, probe, health and exemplar
operations runs on both registries with a fixed clock: ``render()``,
``render_openmetrics()``, ``exemplars_json()`` and the snapshot sample
are equal.  The JAX package's registry tests run as cases on both
packages; the port's ``MetricsServer`` is scraped over HTTP (classic and
OpenMetrics by ``Accept``, ``/healthz`` 200 then 503, ``/healthz/<name>``,
``/exemplars``), and a port ``PredictionService`` binds its labelled
series, its health and its component histograms.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

import avenir_tpu.telemetry.metrics as jax_metrics
import avenir_tpu.telemetry.server as jax_server
import avenir_tpu_torch.telemetry.metrics as port_metrics
import avenir_tpu_torch.telemetry.server as port_server
from avenir_tpu.core.metrics import Counters as JaxCounters
from avenir_tpu.utils.tracing import StepTimer as JaxTimer
from avenir_tpu.utils.tracing import TransferLedger as JaxLedger
from avenir_tpu_torch.core.metrics import Counters as PortCounters
from avenir_tpu_torch.utils.tracing import StepTimer as PortTimer
from avenir_tpu_torch.utils.tracing import TransferLedger as PortLedger

PKGS = {
    "jax": (jax_metrics, jax_server, JaxCounters, JaxLedger, JaxTimer),
    "torch": (port_metrics, port_server, PortCounters, PortLedger,
              PortTimer),
}
FIXED_T = 1_700_000_123.25


class _Clock:
    """The ``time`` module the registry sees, with a fixed wall clock."""

    @staticmethod
    def time():
        return FIXED_T

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture()
def fixed_clock(monkeypatch):
    for mod in (jax_metrics, port_metrics):
        monkeypatch.setattr(mod, "time", _Clock())


def _script(pkg):
    """The same operations on a fresh registry of ``pkg``."""
    metrics, _, Counters, Ledger, Timer = PKGS[pkg]
    reg = metrics.MetricsRegistry()
    c = reg.counter("avenir_served", "served \"requests\"\nall",
                    labels=("model", "host"))
    c.inc(5, model="forest", host='h"1')
    c.inc(2.5, model="bayes", host="h\\2")
    reg.gauge("serve.queue-depth", "depth").set(3)
    g = reg.gauge("avenir_state", "state", labels=("key",))
    g.set(1e16, key="big")
    g.set(-0.125, key="frac")
    g.set(7, key="gone")
    g.drop_series(key="gone")
    h = reg.histogram("avenir_lat", "latency", labels=("svc",),
                      buckets=(0.1, 0.001, 0.01))
    for v, ex in ((0.005, "r1"), (0.007, "r2"), (0.05, "r3"), (5.0, "rInf"),
                  (0.0005, None), (0.02, None)):
        h.observe(v, exemplar=ex, svc="a")
    h.observe(0.003, exemplar="b1", svc="b")
    counters = Counters()
    counters.increment("Serving", "Requests", 7)
    counters.increment("Broker", "Shards", 2)
    ledger = Ledger()
    ledger.record_h2d(1024)
    ledger.record_d2h(64, 2)
    timer = Timer(keep_samples=16)
    for s in (0.002, 0.004, 0.001):
        timer.record("serve.batch", s)
    reg.attach_counters(counters)
    reg.attach_ledger(ledger)
    reg.attach_timer(timer)
    ticks = []
    tg = reg.gauge("avenir_ticks", "probe ticks")
    reg.register_probe(lambda: (ticks.append(1), tg.set(len(ticks))))
    reg.add_health("serving:w0", lambda: (True, {"n": 1}))
    reg.add_health("serving:h1:w1", lambda: (False, {"why": "drift"}))
    return reg, counters


@pytest.mark.parametrize("view", ["render", "render_openmetrics",
                                  "exemplars_json", "sample", "health",
                                  "health_one"])
def test_same_script_same_output(fixed_clock, view):
    got = {}
    for pkg in PKGS:
        reg, counters = _script(pkg)
        if view == "health_one":
            got[pkg] = [reg.health_one(n) for n in
                        ("w0", "w1", "h1:w1", "serving:w0", "nope")]
        else:
            first = getattr(reg, view)()
            counters.increment("Serving", "Requests", 3)   # live source
            got[pkg] = (first, getattr(reg, view)())
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_render_types_sanitize_and_refusals(pkg):
    metrics = PKGS[pkg][0]
    reg = metrics.MetricsRegistry()
    reg.counter("avenir_served_total", "served", labels=("model",)) \
        .inc(5, model="forest")
    reg.gauge("avenir_queue_depth", "depth").set(3)
    h = reg.histogram("avenir_req_seconds", "latency", buckets=(0.01, 0.1))
    h.observe(0.05)
    h.observe(0.005)
    text = reg.render()
    assert "# TYPE avenir_served_total counter" in text
    assert 'avenir_req_seconds_bucket{le="+Inf"} 2' in text
    assert metrics.sanitize_name("serve.batch-p99") == "serve_batch_p99"
    with pytest.raises(ValueError):
        reg.counter("avenir_queue_depth", "now a counter")
    with pytest.raises(ValueError):
        reg.histogram("avenir_req_seconds", "other edges", buckets=(1.0,))
    with pytest.raises(TypeError):
        h.inc(1)
    with pytest.raises(ValueError):
        reg.gauge("avenir_queue_depth").set(1, extra="x")


@pytest.mark.parametrize("pkg", list(PKGS))
def test_snapshot_thread_writes_jsonl(pkg, tmp_path):
    metrics = PKGS[pkg][0]
    reg = metrics.MetricsRegistry()
    g = reg.gauge("avenir_x", "x")
    ticks = []
    reg.register_probe(lambda: (ticks.append(1), g.set(len(ticks))))
    snap = str(tmp_path / "metrics.jsonl")
    reg.start_snapshots(0.05, snapshot_path=snap)
    deadline = time.monotonic() + 5.0
    while reg.snapshots_taken < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    reg.stop_snapshots()
    assert reg.snapshots_taken >= 2
    with open(snap) as fh:
        recs = [json.loads(line) for line in fh]
    assert recs and all("ts" in r and "avenir_x" in r for r in recs)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_failing_probe_dropped_after_three_strikes(pkg):
    metrics = PKGS[pkg][0]
    reg = metrics.MetricsRegistry()
    calls = []

    def bad():
        calls.append(1)
        raise RuntimeError("racy read")
    reg.register_probe(bad)
    with pytest.warns(RuntimeWarning):
        for _ in range(5):
            reg.render()
    assert len(calls) == 3


def _get(url, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept
                                 else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], \
                resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers["Content-Type"], exc.read().decode()


def test_metrics_server_scrape():
    """The port's endpoint: classic /metrics without exemplars,
    OpenMetrics by Accept with them, /exemplars, /healthz 200 then 503
    after a provider degrades, /healthz/<name> per provider, 404s."""
    reg = port_metrics.MetricsRegistry()
    reg.histogram("avt_e2e", "x").observe(0.002, exemplar="req-9")
    state = {"ok": True}
    reg.add_health("serving:w0", lambda: (state["ok"], {"n": 1}))
    reg.add_health("serving:w1", lambda: (True, {}))
    srv = port_server.MetricsServer(reg, port=0).start()
    try:
        code, ctype, body = _get(srv.url + "/metrics")
        assert code == 200 and "version=0.0.4" in ctype
        assert "# {" not in body and "avt_e2e_count 1" in body
        code, ctype, body = _get(srv.url + "/metrics",
                                 "application/openmetrics-text")
        assert "openmetrics-text" in ctype
        assert '# {trace_id="req-9"}' in body
        assert body.rstrip().endswith("# EOF")
        code, _, body = _get(srv.url + "/exemplars")
        assert json.loads(body)["avt_e2e"][0]["trace_id"] == "req-9"
        assert _get(srv.url + "/healthz")[0] == 200
        state["ok"] = False
        code, _, body = _get(srv.url + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "degraded"
        assert _get(srv.url + "/healthz/w0")[0] == 503
        assert _get(srv.url + "/healthz/w1")[0] == 200
        assert _get(srv.url + "/healthz/nope")[0] == 404
        assert _get(srv.url + "/nope")[0] == 404
    finally:
        srv.stop()
    srv.stop()   # idempotent


class _StubPredictor:
    """Class 'y' when field0 == 'x', raising on 'boom' (per-row
    isolation)."""

    def warm(self):
        return self

    def predict_rows(self, rows):
        out = []
        for r in rows:
            if r[0] == "boom":
                raise ValueError("boom row")
            out.append("y" if r[0] == "x" else "n")
        return out


def _service(pkg, **kw):
    from avenir_tpu.serving import service as js
    from avenir_tpu_torch.serving import service as ps
    mod = js if pkg == "jax" else ps
    return mod.PredictionService(
        _StubPredictor(), warm=False,
        policy=mod.BatchPolicy(max_batch=8, max_wait_ms=1.0), **kw)


def test_service_stats_and_health_equal_the_reference():
    got = {}
    for pkg in PKGS:
        svc = _service(pkg, host_label="h0", model_label="m")
        svc.version = 4
        out = svc.process_batch(["predict,0,x,p", "predict,1,z,q",
                                 "predict,2,boom,q"])
        before = svc.stats()
        svc.mark_degraded("drift: psi over threshold")
        got[pkg] = (out, before, svc.health())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["0,y", "1,n", "2,error"]
    assert got["torch"][2][0] is False


def _untimed(text):
    """A render with the measured latencies' values taken out."""
    return "\n".join(line.rsplit(" ", 1)[0]
                     if line.startswith("avenir_serving_latency_ms{")
                     else line for line in text.splitlines())


def test_service_binding_scrape_equals_the_reference(fixed_clock):
    """Two services per package on one registry (the same name: the
    second is uniquified) render the same series (latency values aside);
    stop() unbinds one."""
    texts = {}
    for pkg, metrics in (("jax", jax_metrics), ("torch", port_metrics)):
        reg = metrics.MetricsRegistry()
        a, b = (_service(pkg, metrics=reg, name="w", host_label="h",
                         model_label="m") for _ in range(2))
        a.version, b.version = 1, 2
        a.process_batch(["predict,0,x,p", "predict,1,z,q"])
        b.mark_degraded("why")
        first = _untimed(reg.render())
        a.stop()
        texts[pkg] = (first, _untimed(reg.render()), reg.health())
    assert texts["torch"] == texts["jax"]
    assert 'service="w-1"' in texts["torch"][0]
    assert 'service="w",' not in texts["torch"][1]


def test_default_registry_binds_new_services():
    reg = port_metrics.MetricsRegistry()
    port_metrics.set_default_registry(reg)
    try:
        svc = _service("torch")
        svc.process_batch(["predict,0,x,p"])
        assert 'avenir_serving{host="",service="predictor",model="",' \
               'key="served"} 1' in reg.render()
    finally:
        port_metrics.set_default_registry(None)
    assert port_metrics.get_default_registry() is None


def test_sampled_requests_land_in_component_histograms():
    from avenir_tpu_torch.telemetry import reqtrace
    reg = port_metrics.MetricsRegistry()
    svc = _service("torch", metrics=reg)
    reqtrace.set_sample_rate(1)
    try:
        svc.start()
        futs = [svc.submit(["x", "y"]) for _ in range(6)]
        assert [f.result(timeout=30) for f in futs] == ["y"] * 6
    finally:
        reqtrace.set_sample_rate(0)
    text = reg.render_openmetrics()
    svc.stop(drain_s=1.0)
    assert svc.counters.get("Serving", "TracedRequests") == 6
    assert "avenir_request_component_seconds_bucket" in text
    assert '# {trace_id="inproc-' in text
    assert "avenir_request_component_seconds" not in \
        reg.render().split("# TYPE avenir_request_component_seconds")[-1]
