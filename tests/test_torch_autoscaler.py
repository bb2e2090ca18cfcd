"""The port's autoscaler (``avenir_tpu_torch/serving/autoscaler.py``)
against the JAX package's, on the CPU.

``AutoscalePolicy`` validation and ``FleetAutoscaler.decide`` give the JAX
package's decisions over a table of (depth, derivative, p99, active)
inputs, under several policies (hysteresis state carried along).  Driven
by synthetic sensors through ``tick``, a spike scales a fake fleet up and
an idle spell parks it back to the minimum; a real port fleet under the
autoscaler answers every request of a burst and ends at its minimum.
"""

import os
import shutil
import time

import numpy as np
import pytest

from avenir_tpu.serving import autoscaler as jax_as
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.io.respq import RespClient, RespServer
from avenir_tpu_torch.serving import autoscaler as port_as
from avenir_tpu_torch.serving import BatchPolicy, ModelRegistry, ServingFleet

TESTS = os.path.dirname(os.path.abspath(__file__))
FLEET9 = os.path.join(TESTS, "torch_fixtures", "fleet9")
WIRE9 = os.path.join(TESTS, "torch_fixtures", "wire9")

POLICIES = [dict(), dict(min_workers=2, max_workers=3),
            dict(slo_p99_ms=10.0, up_consecutive=1, down_consecutive=2,
                 cooldown_ticks=0),
            dict(depth_high=8, depth_low=1, derivative_high=5.0)]


class _FakeFleet:
    def __init__(self, active=1):
        self.active = active
        self.workers = []
        self.request_q = "requestQueue"
        self.host_label = "h"

    def active_workers(self):
        return self.active

    def scale_to(self, n):
        self.active = max(1, int(n))
        return self.active


def _table(seed=7, n=400):
    rng = np.random.default_rng(seed)
    depth = rng.choice([0, 1, 3, 5, 10, 63, 64, 100, 500], n)
    deriv = rng.choice([-20.0, 0.0, 0.5, 49.9, 50.0, 200.0], n)
    p99 = rng.choice([0.0, 2.0, 4.9, 5.0, 7.9, 8.0, 30.0], n)
    active = rng.integers(1, 6, n)
    return list(zip(depth.tolist(), deriv.tolist(), p99.tolist(),
                    active.tolist()))


@pytest.mark.parametrize("kw", POLICIES, ids=range(len(POLICIES)))
def test_decide_equals_the_reference(kw):
    got = {}
    for name, mod in (("jax", jax_as), ("torch", port_as)):
        scaler = mod.FleetAutoscaler(_FakeFleet(),
                                     policy=mod.AutoscalePolicy(**kw))
        got[name] = [scaler.decide(*row) for row in _table()]
    assert got["torch"] == got["jax"]
    assert {"up", "down", "hold"} & set(got["torch"])


@pytest.mark.parametrize("kw", [dict(min_workers=0),
                                dict(min_workers=3, max_workers=2),
                                dict(depth_low=64, depth_high=64),
                                dict(slo_p99_ms=5.0, p99_low_fraction=0.9,
                                     p99_high_fraction=0.8)])
def test_policy_refusals_equal_the_reference(kw):
    for mod in (jax_as, port_as):
        with pytest.raises(ValueError):
            mod.AutoscalePolicy(**kw)


def test_spike_scales_up_and_idle_parks_back():
    for mod in (jax_as, port_as):
        fleet = _FakeFleet()
        state = {"depth": 0}
        counters = Counters()
        scaler = mod.FleetAutoscaler(
            fleet, policy=mod.AutoscalePolicy(min_workers=1, max_workers=3,
                                              cooldown_ticks=1),
            counters=counters, depth_fn=lambda: state["depth"],
            p99_fn=lambda: 0.0)
        state["depth"] = 500
        recs = [scaler.tick() for _ in range(12)]
        assert fleet.active == 3
        assert [r["action"] for r in recs].count("up") == 2
        state["depth"] = 0
        for _ in range(40):
            scaler.tick()
        assert fleet.active == 1
        assert counters.get("Autoscaler", "ScaleUps") == 2
        assert counters.get("Autoscaler", "ScaleDowns") == 2
        assert counters.get("Autoscaler", "Ticks") == 52


def test_fleet_under_the_autoscaler(tmp_path):
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    reg = tmp_path / "reg"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg)
    with open(os.path.join(WIRE9, "records.csv")) as fh:
        recs = fh.read().splitlines()[:300]
    server = RespServer().start()
    fleet = ServingFleet(ModelRegistry(str(reg)), "rafo9", buckets=(8, 64),
                         policy=BatchPolicy(max_batch=8, max_wait_ms=1.0),
                         n_workers=1,
                         config={"redis.server.port": server.port})
    feeder = RespClient(port=server.port)
    sensor = RespClient(port=server.port)
    counters = Counters()
    scaler = None
    try:
        fleet.start()
        scaler = port_as.FleetAutoscaler(
            fleet, sensor,
            policy=port_as.AutoscalePolicy(min_workers=1, max_workers=3,
                                           depth_high=16, depth_low=2,
                                           up_consecutive=1,
                                           down_consecutive=2,
                                           cooldown_ticks=0),
            interval_s=0.01, counters=counters).start()
        feeder.lpush_many("requestQueue", [f"predict,{i},{r}"
                                           for i, r in enumerate(recs)] * 4)
        got = 0
        deadline = time.monotonic() + 60
        while got < 1200 and time.monotonic() < deadline:
            got += len(feeder.rpop_many("predictionQueue", 512))
            time.sleep(0.005)
        assert got == 1200
        deadline = time.monotonic() + 30
        while fleet.active_workers() > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fleet.active_workers() == 1
        assert counters.get("Autoscaler", "Ticks") > 0
        assert counters.get("Autoscaler", "ScaleDowns") == \
            counters.get("Autoscaler", "ScaleUps")
    finally:
        if scaler is not None:
            scaler.stop()
        fleet.stop(drain_s=1.0)
        feeder.close()
        sensor.close()
        server.stop()
        set_default_device(None)


def test_cli_autoscale_job(tmp_path):
    """predictionService ps.autoscale=true: the single-worker bytes, and
    the Autoscaler counters in the dump."""
    from avenir_tpu_torch.cli import run as port_run
    reg = tmp_path / "reg"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg)
    out = tmp_path / "out"
    assert port_run.main([
        "predictionService",
        f"-Dconf.path={os.path.join(os.path.dirname(TESTS), 'resource', 'rafo.properties')}",
        "-Dplatform=cpu", f"-Dps.model.registry.dir={reg}",
        "-Dps.model.name=rafo9", "-Dps.transport=resp",
        "-Dps.autoscale=true", "-Dps.autoscale.max.workers=3",
        "-Dps.autoscale.interval.ms=10",
        os.path.join(WIRE9, "records.csv"), str(out)]) == 0
    with open(out / "part-m-00000") as a, \
            open(os.path.join(WIRE9, "job_replies.csv")) as b:
        assert a.read() == b.read()
    import json
    with open(f"{out}.counters.json") as fh:
        c = json.load(fh)
    assert c["Autoscaler"]["FinalActiveWorkers"] >= 1
    assert "Ticks" in c["Autoscaler"]
