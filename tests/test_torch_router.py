"""The port's multi-model router (``avenir_tpu_torch/serving/router.py``)
and the router keys of ``predictionService`` on the CPU, against the JAX
package.

Held to: the ``fleet9`` fixture's cases b (``ps.client.model=backup``), c
(a canary of rafo9 v1 at 25% while v2 serves) and d (a shadow of v1) byte
for byte with their counters; ``CanaryRequests`` re-derived from the ids
with ``canary_split`` on both packages; the untagged multi-model replay
equal to the single-model one; a per-model depth that sheds only the noisy
tenant; ``canary_bucket`` equal to the JAX package's on 10,000 ids; and
the router's canary outcome tracking and scrape series.
"""

import importlib.util
import json
import os
import shutil
import time
from concurrent.futures import wait

import pytest

from avenir_tpu.serving import router as jax_router
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.serving import router as port_router
from avenir_tpu_torch.serving import BatchPolicy, ModelRegistry, ModelRouter
from avenir_tpu_torch.telemetry import MetricsRegistry

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
FLEET9 = os.path.join(TESTS, "torch_fixtures", "fleet9")
WIRE9 = os.path.join(TESTS, "torch_fixtures", "wire9")
PROPS = os.path.join(ROOT, "resource", "rafo.properties")


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _module(os.path.join(FLEET9, "make.py"), "fleet9_make_router")


def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.fixture()
def cpu_default():
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.mark.parametrize("case", ["b", "c", "d"])
def test_fleet9_router_case(tmp_path, case):
    text, counters = MAKE.run_case(port_run, os.path.join(FLEET9,
                                                          "registry"),
                                   str(tmp_path), case,
                                   extra=("-Dplatform=cpu",))
    assert text == _read(os.path.join(FLEET9, f"{case}.csv"))
    want = json.loads(_read(os.path.join(FLEET9, "counters.json")))[case]
    assert counters == want


def test_canary_requests_rederive_from_the_ids():
    want = json.loads(_read(os.path.join(FLEET9, "counters.json")))["c"]
    for mod in (port_router, jax_router):
        n = sum(mod.canary_split(str(i), 25)
                for i in range(MAKE.N_RECORDS))
        assert n == want["Model"]["rafo9/CanaryRequests"]


def test_canary_bucket_equals_the_reference():
    ids = [str(i) for i in range(10_000)] + ["req-9", "inproc-3", 17]
    assert [port_router.canary_bucket(r) for r in ids] == \
        [jax_router.canary_bucket(r) for r in ids]
    for spec in ("m", "m:3", ("m", None), ["m", "4"], "a:b:5"):
        assert port_router.parse_model_spec(spec) == \
            jax_router.parse_model_spec(spec)


def test_untagged_multi_model_equals_single_model(tmp_path):
    """ps.models without a client tag: the default model answers every
    request, byte for byte the single-model replay."""
    reg = tmp_path / "reg"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg)
    out = tmp_path / "multi"
    assert port_run.main([
        "predictionService", f"-Dconf.path={PROPS}", "-Dplatform=cpu",
        f"-Dps.model.registry.dir={reg}", "-Dps.model.name=rafo9",
        "-Dps.transport=resp", "-Dps.models=rafo9,backup",
        MAKE.RECORDS, str(out)]) == 0
    assert _read(out / "part-m-00000") == \
        _read(os.path.join(WIRE9, "job_replies.csv")) == \
        _read(os.path.join(FLEET9, "a.csv"))
    c = json.loads(_read(f"{out}.counters.json"))
    assert c["Model"] == {"rafo9/Requests": MAKE.N_RECORDS}


class _Throttled:
    """A predictor slowed by ``delay_s`` a batch, so a queue fills."""

    def __init__(self, inner, delay_s):
        self.inner = inner
        self.delay_s = delay_s
        self.device = getattr(inner, "device", None)

    def warm(self):
        return self

    def predict_rows(self, rows):
        time.sleep(self.delay_s)
        return self.inner.predict_rows(rows)


def test_noisy_tenant_shed_at_its_depth(tmp_path, cpu_default):
    reg_dir = tmp_path / "reg"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg_dir)
    want = [line.split(",", 1)[1] for line in
            _read(os.path.join(FLEET9, "a.csv")).splitlines()]
    rows = [r.split(",") for r in _read(MAKE.RECORDS).splitlines()[:40]]
    router = ModelRouter(ModelRegistry(str(reg_dir)), ["rafo9", "backup"],
                         policy=BatchPolicy(max_batch=4, max_wait_ms=5.0),
                         model_depths={"backup": 2}, buckets=(8,))
    noisy = router._residents["backup"][0]
    noisy.predictor = _Throttled(noisy.predictor, 0.05)
    router.start()
    try:
        nfuts = [router.submit_routed(rows[i], rid=f"n{i}",
                                      model_tag=("backup", None))
                 for i in range(40)]
        cfuts = [router.submit_routed(rows[i], rid=f"c{i}")
                 for i in range(10)]
        done, _ = wait(nfuts + cfuts, timeout=60)
        assert len(done) == 50
        assert [f.result() for f in cfuts] == want[:10]
        got_n = [f.result() for f in nfuts]
        n_busy = sum(r == router.busy_label for r in got_n)
        assert 0 < n_busy < 40
        assert all(r == want[i] for i, r in enumerate(got_n)
                   if r != router.busy_label)
        assert router.counters.get("Model", "backup/Rejected") == n_busy
        assert router.counters.get("Model", "rafo9/Rejected") == 0
        st = router.stats()["per_model"]
        assert st["backup"]["rejected"] == n_busy
        assert st["rafo9"]["rejected"] == 0
        assert set(router.model_queue_depths()) == {"rafo9", "backup"}
        unknown = router.submit_routed(rows[0], rid="u",
                                       model_tag=("nope", None))
        assert unknown.result(timeout=5) == "error"
        assert router.counters.get("Serving", "UnknownModel") == 1
    finally:
        router.stop(drain_s=1.0)


def test_canary_outcomes_and_scrape_series(tmp_path, cpu_default):
    """Canary outcomes attribute to the arm the id's split names, and the
    per-arm series render on the registry."""
    reg_dir = tmp_path / "reg"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg_dir)
    mreg = MetricsRegistry()
    router = ModelRouter(ModelRegistry(str(reg_dir)), ["rafo9", "backup"],
                         policy=BatchPolicy(max_batch=8, max_wait_ms=1.0),
                         buckets=(8,), metrics=mreg, host_label="h")
    router.start()
    try:
        router.install_canary("rafo9", version=1, percent=25,
                              pos_class="T", neg_class="F", window=4)
        arms = [router.record_canary_outcome("rafo9", str(i), "T",
                                             "T" if i % 3 else "F")
                for i in range(40)]
        assert arms == ["candidate" if port_router.canary_split(str(i), 25)
                        else "champion" for i in range(40)]
        st = router.canary_state("rafo9")
        assert st["percent"] == 25 and st["version"] == 1
        assert sum(a["outcomes"] for a in st["arms"].values()) == 40
        text = mreg.render()
        assert 'avenir_canary{host="h",model="rafo9",arm="candidate",' \
               'key="percent"} 25' in text
        retired = router.clear_canary("rafo9")
        assert retired is not None and router.canary_state("rafo9") is None
        with pytest.raises(ValueError):
            router.install_canary("nope", version=1)
        with pytest.raises(ValueError):
            router.install_canary("rafo9", version=1, percent=101)
    finally:
        router.stop(drain_s=1.0)


def test_cli_per_model_depth_sheds_the_tagged_tenant(tmp_path):
    """ps.model.backup.queue.max.depth=1 with the replay tagged for
    backup: every id answered, backup's class or busy, and the sheds
    counted on backup's Model series."""
    reg = tmp_path / "reg"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg)
    out = tmp_path / "out"
    assert port_run.main([
        "predictionService", f"-Dconf.path={PROPS}", "-Dplatform=cpu",
        f"-Dps.model.registry.dir={reg}", "-Dps.model.name=rafo9",
        "-Dps.transport=resp", "-Dps.models=rafo9,backup",
        "-Dps.client.model=backup", "-Dps.model.backup.queue.max.depth=1",
        MAKE.RECORDS, str(out)]) == 0
    text = _read(out / "part-m-00000")
    assert MAKE.answered_or_busy(text, _read(os.path.join(FLEET9, "b.csv")))
    busy = text.count(",busy")
    c = json.loads(_read(f"{out}.counters.json"))
    assert busy > 0
    assert c["Model"]["backup/Rejected"] == busy
    assert c["Model"].get("rafo9/Rejected", 0) == 0
