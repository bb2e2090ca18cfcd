"""The port's serving fleet (``avenir_tpu_torch/serving/fleet.py`` and the
fleet path of ``cli/serving_jobs.py``) on the CPU, against the JAX
package's outputs.

Held to: the ``fleet9`` fixture (``tests/torch_fixtures/fleet9/make.py``,
made by the JAX package) — cases a (2 workers over 2 broker shards) and e
(2 workers, the int8 sidecar) byte for byte with their counters, and case
f's rule (2 workers, queue depth 4: every id answered, its class or
``busy``); the four-way oracle (fleet == ``ps.batching=drain`` ==
in-process == ``modelPredictor``'s labels); a hot-swap from v1 to the v2
delta under load (every id answered exactly once, every worker on v2);
degraded parking (the degraded worker's ``/healthz/<name>`` answers 503
while its peer serves; the last worker never parks); two fleets' host
labels on one registry; and the kernel wrappers' launch counters under
concurrent threads.
"""

import importlib.util
import json
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import pytest

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.io.respq import RespClient, RespServer
from avenir_tpu_torch.kernels import dispatch, histogram, topk, vote
from avenir_tpu_torch.serving import BatchPolicy, ModelRegistry, ServingFleet
from avenir_tpu_torch.telemetry import MetricsRegistry, MetricsServer

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
FLEET9 = os.path.join(TESTS, "torch_fixtures", "fleet9")
WIRE9 = os.path.join(TESTS, "torch_fixtures", "wire9")
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
PROPS = os.path.join(ROOT, "resource", "rafo.properties")


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _module(os.path.join(FLEET9, "make.py"), "fleet9_make")
CPU = ("-Dplatform=cpu",)


def _read(path):
    with open(path) as fh:
        return fh.read()


def _records():
    return _read(MAKE.RECORDS).splitlines()


@pytest.fixture()
def cpu_default():
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture()
def registry(tmp_path):
    d = tmp_path / "registry"
    shutil.copytree(os.path.join(FLEET9, "registry"), d)
    return ModelRegistry(str(d))


@pytest.fixture()
def server():
    srv = RespServer().start()
    yield srv
    srv.stop()


def drain_replies(cli, queue, expect_n, timeout_s=30.0):
    """{rid: [labels...]} until ``expect_n`` replies (duplicates kept)."""
    got = {}
    n = 0
    deadline = time.monotonic() + timeout_s
    while n < expect_n and time.monotonic() < deadline:
        vs = cli.rpop_many(queue, 256)
        if not vs:
            time.sleep(0.002)
            continue
        for v in vs:
            rid, label = v.split(",", 1)
            got.setdefault(rid, []).append(label)
            n += 1
    return got


@pytest.mark.parametrize("case", ["a", "e"])
def test_fleet9_case(tmp_path, case):
    text, counters = MAKE.run_case(port_run, os.path.join(FLEET9,
                                                          "registry"),
                                   str(tmp_path), case, extra=CPU)
    assert text == _read(os.path.join(FLEET9, f"{case}.csv"))
    want = json.loads(_read(os.path.join(FLEET9, "counters.json")))[case]
    assert counters == want


def test_fleet9_admission_answers_every_id(tmp_path):
    text, _ = MAKE.run_case(port_run, os.path.join(FLEET9, "registry"),
                            str(tmp_path), "f", extra=CPU)
    assert MAKE.answered_or_busy(text, _read(os.path.join(FLEET9,
                                                          "a.csv")))
    assert ",busy" in text


def test_four_way_oracle(tmp_path):
    """The same 300 records: a 2-worker continuous fleet, a 2-worker drain
    fleet, the in-process transport and modelPredictor agree label for
    label."""
    recs = tmp_path / "records.csv"
    recs.write_text("\n".join(_records()[:300]) + "\n")
    labels = {}
    for name, extra in (("fleet", ("-Dps.transport=resp",
                                   "-Dps.workers=2")),
                        ("drain", ("-Dps.transport=resp", "-Dps.workers=2",
                                   "-Dps.batching=drain")),
                        ("inprocess", ("-Dps.transport=inprocess",))):
        reg = tmp_path / f"reg_{name}"
        shutil.copytree(os.path.join(FLEET9, "registry"), reg)
        out = tmp_path / name
        assert port_run.main([
            "predictionService", f"-Dconf.path={PROPS}", *CPU,
            f"-Dps.model.registry.dir={reg}", "-Dps.model.name=rafo9",
            *extra, str(recs), str(out)]) == 0
        labels[name] = [line.split(",", 1)[1] for line in
                        _read(out / "part-m-00000").splitlines()]
    assert port_run.main([
        "modelPredictor", f"-Dconf.path={PROPS}", *CPU,
        f"-Dmop.model.dir.path={RAFO9}",
        f"-Dmop.feature.schema.file.path="
        f"{os.path.join(ROOT, 'resource', 'call_hangup.json')}",
        str(recs), str(tmp_path / "mop")]) == 0
    mop = [line.rsplit(",", 1)[1] for line in
           _read(tmp_path / "mop" / "part-m-00000").splitlines()]
    assert labels["fleet"] == labels["drain"] == labels["inprocess"] == mop
    assert len(mop) == 300


def test_hot_swap_to_the_delta_under_load(registry, server, cpu_default):
    """v1 pinned, requests flowing; the pin cleared and a wire 'reload'
    pushed mid-load: every id answered exactly once with v1's or v2's
    class, every worker converges on v2 by the delta patch."""
    recs = _records()[:300]
    v1 = dict(line.split(",", 1) for line in
              _read(os.path.join(FLEET9, "a.csv")).splitlines())
    v2 = dict(line.split(",", 1) for line in
              _read(os.path.join(FLEET9, "d.csv")).splitlines())
    fleet = ServingFleet(registry, "rafo9", buckets=(8, 64),
                         policy=BatchPolicy(max_batch=16, max_wait_ms=1.0),
                         n_workers=2,
                         config={"redis.server.port": server.port})
    feeder = RespClient(port=server.port)
    try:
        fleet.start()
        assert fleet.converged_version() == 1
        for i, rec in enumerate(recs):
            feeder.lpush("requestQueue", f"predict,{i},{rec}")
            if i == 120:
                registry.clear_pin("rafo9")
                feeder.lpush("requestQueue", "reload")
        got = drain_replies(feeder, "predictionQueue", 300)
        assert sorted(got, key=int) == [str(i) for i in range(300)]
        assert all(len(v) == 1 for v in got.values())
        assert all(got[k][0] in (v1[k], v2[k]) for k in got)
        deadline = time.monotonic() + 30.0
        while fleet.converged_version() != 2 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert fleet.converged_version() == 2
        merged = fleet.merged_counters()
        assert merged.get("Serving", "DeltaSwaps") == 2
        assert merged.get("Serving", "HotSwaps") == 2
        assert fleet.stats()["reload_generation"] >= 1
        # after the swap every worker answers v2's classes
        feeder.lpush_many("requestQueue", [f"predict,{i},{recs[i]}"
                                           for i in range(300)])
        after = drain_replies(feeder, "predictionQueue", 300)
        assert all(after[str(i)] == [v2[str(i)]] for i in range(300))
    finally:
        fleet.stop(drain_s=1.0)
        feeder.close()


def _healthz(url, name):
    try:
        with urllib.request.urlopen(f"{url}/healthz/{name}",
                                    timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as exc:
        return exc.code


def test_degraded_worker_parks_its_peer_serves(registry, server,
                                               cpu_default):
    recs = _records()[:300]
    want = dict(line.split(",", 1) for line in
                _read(os.path.join(FLEET9, "a.csv")).splitlines())
    mreg = MetricsRegistry()
    fleet = ServingFleet(registry, "rafo9", buckets=(8, 64),
                         policy=BatchPolicy(max_batch=16, max_wait_ms=1.0),
                         n_workers=2, metrics=mreg,
                         config={"redis.server.port": server.port})
    msrv = MetricsServer(mreg, port=0).start()
    feeder = RespClient(port=server.port)
    try:
        fleet.start()
        assert _healthz(msrv.url, "rafo9-w0") == 200
        assert _healthz(msrv.url, "no-such-worker") == 404
        w0 = fleet.workers[0].service
        w0.mark_degraded("drift: psi over threshold")
        assert _healthz(msrv.url, "rafo9-w0") == 503
        assert _healthz(msrv.url, "rafo9-w1") == 200
        deadline = time.monotonic() + 10.0
        while w0.counters.get("Serving", "ParkedPolls") == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert w0.counters.get("Serving", "ParkedPolls") > 0
        polls = w0.counters.get("Serving", "Polls")
        feeder.lpush_many("requestQueue", [f"predict,{i},{recs[i]}"
                                           for i in range(120)])
        got = drain_replies(feeder, "predictionQueue", 120)
        assert got == {str(i): [want[str(i)]] for i in range(120)}
        assert w0.counters.get("Serving", "Polls") == polls
        assert w0.counters.get("Serving", "Requests") == 0
        # the last active worker never parks: degrade the peer too
        fleet.workers[1].service.mark_degraded("drift")
        feeder.lpush_many("requestQueue", [f"predict,{i},{recs[i]}"
                                           for i in range(120, 150)])
        got = drain_replies(feeder, "predictionQueue", 30)
        assert sorted(got, key=int) == [str(i) for i in range(120, 150)]
        # a hot-swap clears the flags: the pin cleared, a reload
        registry.clear_pin("rafo9")
        fleet.request_reload()
        deadline = time.monotonic() + 30.0
        while w0.degraded is not None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert w0.degraded is None
        assert _healthz(msrv.url, "rafo9-w0") == 200
    finally:
        msrv.stop()
        fleet.stop(drain_s=1.0)
        feeder.close()


def test_two_fleets_host_labels_keep_series_apart(registry, server,
                                                  cpu_default):
    mreg = MetricsRegistry()

    def make(host):
        return ServingFleet(
            registry, "rafo9", buckets=(8,),
            policy=BatchPolicy(max_batch=8, max_wait_ms=1.0), n_workers=1,
            metrics=mreg, host_label=host,
            config={"redis.server.port": server.port,
                    "redis.request.queue": f"rq-{host}",
                    "redis.prediction.queue": f"pq-{host}"})
    fa, fb = make("hostA").start(), make("hostB").start()
    try:
        assert fa.stats()["host"] == "hostA"
        text = mreg.render()
        a = 'avenir_serving{host="hostA",service="rafo9-w0",model="rafo9",'
        b = 'avenir_serving{host="hostB",service="rafo9-w0",model="rafo9",'
        assert a + 'key="queue_depth"}' in text
        assert b + 'key="queue_depth"}' in text
        assert "rafo9-w0-1" not in text
        assert mreg.health_one("hostA:rafo9-w0")[0] is True
        fb.workers[0].service.mark_degraded("drift")
        assert mreg.health_one("hostA:rafo9-w0")[0] is True
        assert mreg.health_one("hostB:rafo9-w0")[0] is False
        fb.stop(drain_s=0.5)
        text = mreg.render()
        assert a + 'key="queue_depth"}' in text
        assert b + 'key="queue_depth"}' not in text
        assert mreg.health_one("hostB:rafo9-w0") is None
    finally:
        fa.stop(drain_s=0.5)
        fb.stop(drain_s=0.5)


def test_fleet_refuses_what_is_not_ported(registry):
    with pytest.raises(ValueError, match="does not combine with models"):
        ServingFleet(registry, "rafo9", models=["rafo9"],
                     reward_sink=lambda msgs: None)
    with pytest.raises(ValueError, match="device_map"):
        ServingFleet(registry, "rafo9", device_map="everywhere")


def _reward_batch():
    """Predicts of fleet9's records with reward rows between them: valid
    ones, a malformed one (the sink judges it) and a ghost."""
    recs = _records()[:6]
    msgs = []
    for i, rec in enumerate(recs):
        msgs.append(f"predict,p{i},{rec}")
        msgs.append(f"reward,p{i},0.{i}25")
    return msgs + ["reward,p0", "reward,ghost,1.5"]


def _jax_service(path, sink):
    from avenir_tpu.serving.registry import ModelRegistry as JRegistry
    from avenir_tpu.serving.service import PredictionService as JService
    return JService(registry=JRegistry(path), model_name="rafo9",
                    reward_sink=sink, wire_native="off")


@pytest.mark.parametrize("wire_native", ["off", "auto"])
def test_reward_intake_matches_the_jax_service(registry, cpu_default,
                                               wire_native):
    """PredictionService(reward_sink=): the sink gets the raw reward rows
    in arrival order, Serving/RewardsRouted counts them, and only the
    predicts are answered — as the JAX package's service does on the same
    messages (on either wire plane: the native codec declines the
    batch)."""
    from avenir_tpu_torch.serving.service import PredictionService
    msgs = _reward_batch()
    got_rows, want_rows = [], []
    svc = PredictionService(registry=registry, model_name="rafo9",
                            reward_sink=got_rows.extend,
                            wire_native=wire_native)
    want_svc = _jax_service(registry.base_dir, want_rows.extend)
    got = svc.process_batch(msgs)
    want = want_svc.process_batch(msgs)
    assert got == want and len(got) == 6
    assert all(r.split(",")[0].startswith("p") for r in got)
    assert got_rows == want_rows == [m for m in msgs
                                     if m.startswith("reward,")]
    for c in (svc.counters, want_svc.counters):
        assert c.get("Serving", "RewardsRouted") == 8
        assert c.get("Serving", "BadRequests") == 0


def test_rewards_without_a_sink_stay_bad_requests(registry, cpu_default):
    from avenir_tpu_torch.serving.service import PredictionService
    svc = PredictionService(registry=registry, model_name="rafo9",
                            wire_native="off")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = svc.process_batch(_reward_batch())
    assert len(got) == 6
    assert svc.counters.get("Serving", "BadRequests") == 8
    assert svc.counters.get("Serving", "RewardsRouted") == 0


def test_fleet_hands_the_sink_to_every_worker(registry, cpu_default):
    """ServingFleet(reward_sink=): each worker's service routes the reward
    rows of its own batches to the one sink."""
    rows = []
    fleet = ServingFleet(registry, "rafo9", n_workers=2,
                         reward_sink=rows.extend)
    services = [fleet._make_service(f"rafo9-w{i}", i) for i in range(2)]
    msgs = _reward_batch()
    for svc in services:
        assert svc.reward_sink == rows.extend
        assert len(svc.process_batch(msgs)) == 6
    assert rows == 2 * [m for m in msgs if m.startswith("reward,")]


def test_fleet_rewards_feed_an_online_learner(registry, cpu_default):
    """The intake's end to end: a fleet worker's reward rows, handed to an
    online learner service, join the decisions it answered and land in its
    arm statistics."""
    from avenir_tpu_torch.online import (OnlineLearnerConfig,
                                         OnlineLearnerService,
                                         OnlineWindowPlane)
    learner = OnlineLearnerService(OnlineWindowPlane(
        OnlineLearnerConfig(actions=("x", "y")), buckets=(8,)))
    learner.process_window([f"predict,p{i}" for i in range(6)])
    fleet = ServingFleet(registry, "rafo9", n_workers=1,
                         reward_sink=learner.process_window)
    svc = fleet._make_service("rafo9-w0", 0)
    svc.process_batch(_reward_batch())
    stats = learner.stats()
    assert stats["joined"] == 6 and stats["orphans"] == 1
    assert float(learner.plane.carries[0]["counts"].sum()) == 6.0
    assert learner.counters.get("Online", "BadRequests") == 1


def test_launch_counters_are_exact_across_threads():
    """Eight threads bump every kernel module's launch counters through
    ``dispatch.count_launches`` with a tiny switch interval: no count is
    lost."""
    mods = {vote: ("launches", "quantized_launches", "partial_launches",
                   "finalize_launches", "table_launches"),
            histogram: ("launches", "mma_launches", "bin_counts_launches"),
            topk: ("launches", "merge_launches", "split_merge_launches")}
    saved = {(m, n): getattr(m, n) for m, names in mods.items()
             for n in names}
    for m, n in saved:
        setattr(m, n, 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    per, threads = 2000, 8

    def bump():
        for _ in range(per):
            for m, names in mods.items():
                dispatch.count_launches(vars(m), names)
    try:
        ts = [threading.Thread(target=bump) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        for m, n in saved:
            assert getattr(m, n) == per * threads, (m.__name__, n)
    finally:
        sys.setswitchinterval(old)
        for (m, n), v in saved.items():
            setattr(m, n, v)
