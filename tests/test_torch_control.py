"""The port's retrain loop (``avenir_tpu_torch/control``,
``monitor.policy.retrain_action`` and the ``retrainController`` job)
against the JAX package's, on the CPU: the port's counterparts of the
tier-1 cases of ``tests/test_controller.py``.

The data are that file's (``gen_rows``: a clean regime the champion
learns, a drifted regime with another label rule the candidate learns).
Every case that ends in a model, a registry version or a journal also
runs the same inputs through the JAX package's controller and compares
the two: the journal (``controller.json``) and every published file byte
for byte, outside the journal's wall-clock ``opened_unix`` fields and
the pin's ``pinned_unix``, and the ``.npz`` files array for array.  The
chaos drills kill the port's controller at each fault point with a live
two-worker ``ServingFleet`` answering, and end where the JAX package's
uninterrupted cycle ends.
"""

import json
import os
import shutil
import threading
import time
import warnings

import numpy as np
import pytest

from avenir_tpu.control import RetrainController as JaxController
from avenir_tpu.control import RetrainPolicy as JaxPolicy
from avenir_tpu.core.table import load_csv as jax_load_csv
from avenir_tpu.models.forest import ForestParams as JaxForestParams
from avenir_tpu.models.forest import build_forest as jax_build_forest
from avenir_tpu.monitor.baseline import compute_baseline as jax_baseline
from avenir_tpu.monitor.baseline import publish_baseline as jax_publish_bl
from avenir_tpu.serving import ModelRegistry as JaxRegistry
from avenir_tpu_torch.control import (CycleJournal, PROBATION, PUBLISHED,
                                      REFUSED, ROLLED_BACK,
                                      RetrainController, RetrainPolicy,
                                      alerts_from_jsonl)
from avenir_tpu_torch.core import faults
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv
from avenir_tpu_torch.models.forest import ForestParams, build_forest
from avenir_tpu_torch.monitor.baseline import (compute_baseline,
                                               load_baseline,
                                               publish_baseline)
from avenir_tpu_torch.monitor.policy import (AlertRecord, DriftPolicy,
                                             retrain_action)
from avenir_tpu_torch.serving import (BatchPolicy, ModelRegistry,
                                      ServingFleet)
from tests.test_controller import DRILLS, gen_rows, write_csv
from tests.test_torch_retrain9 import assert_same_file as _same_file
from tests.test_tree import SCHEMA as JAX_SCHEMA

pytestmark = pytest.mark.controller

MODEL = "churn"
SCHEMA = FeatureSchema.from_dict(JAX_SCHEMA.to_dict())


@pytest.fixture(autouse=True)
def cpu_default():
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    yield
    set_default_device(None)
    faults.uninstall()


@pytest.fixture()
def port_faults():
    """Install a deterministic fault injector into the port's
    ``core.faults`` from a spec string (uninstalled at teardown)."""
    def make(spec: str):
        inj = faults.FaultInjector.parse(spec)
        faults.install(inj)
        return inj
    yield make
    faults.uninstall()


@pytest.fixture()
def resp_server():
    from avenir_tpu_torch.io.respq import RespServer
    server = RespServer().start()
    yield server
    server.stop()


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------

def forest_params(trees=3, depth=2, seed=3):
    p = ForestParams(num_trees=trees, seed=seed)
    p.tree.max_depth = depth
    return p


def build_champion(tmp_path, params=None):
    """Registry holding v1 (clean-regime forest + baseline sidecar) plus
    the clean/fresh CSV pair on disk."""
    params = params or forest_params()
    clean = str(tmp_path / "clean.csv")
    fresh = str(tmp_path / "fresh.csv")
    write_csv(clean, gen_rows(600, seed=1))
    write_csv(fresh, gen_rows(600, seed=2, drifted=True))
    table = load_csv(clean, SCHEMA, ",")
    models = build_forest(table, params)
    reg = ModelRegistry(str(tmp_path / "registry"))
    v = reg.publish(MODEL, models, schema=SCHEMA)
    publish_baseline(reg, MODEL, v, compute_baseline(table))
    return reg, params, clean, fresh


def policy_kw(**kw):
    out = dict(chunk_rows=128, checkpoint_blocks=1, swap_ack_timeout_s=20.0)
    out.update(kw)
    return out


def make_controller(reg, params, tmp_path, train_source, fleet=None,
                    **kw):
    return RetrainController(
        reg, MODEL, SCHEMA, state_dir=str(tmp_path / "state"),
        train_source=train_source, forest_params=params, fleet=fleet,
        policy=RetrainPolicy(**policy_kw(**kw)))


def drift_alert(n_rows=600):
    return AlertRecord(window_index=3, window_kind="window",
                       scope="holdTime", stat="psi", value=0.7,
                       threshold=0.25, level="alert", streak=2,
                       n_rows=n_rows)


# --------------------------------------------------------------------------
# the JAX package's side, and the comparison
# --------------------------------------------------------------------------

def _jax_params():
    p = JaxForestParams(num_trees=3, seed=3)
    p.tree.max_depth = 2
    return p


def jax_twin(tmp_path, mesh_ctx, train, *, holdout=None, full=None,
             cycles=1, outcomes=(), policy=None):
    """The JAX package's controller over the same CSVs: a champion built
    from ``clean.csv`` in ``jax_registry``, ``cycles`` alert-driven
    cycles, then ``outcomes`` fed to ``record_outcome``.  Returns
    (registry, controller)."""
    from avenir_tpu.monitor.policy import AlertRecord as JaxAlert
    params = _jax_params()
    table = jax_load_csv(str(tmp_path / "clean.csv"), JAX_SCHEMA, ",")
    reg = JaxRegistry(str(tmp_path / "jax_registry"))
    v = reg.publish(MODEL, jax_build_forest(table, params, mesh_ctx),
                    schema=JAX_SCHEMA)
    jax_publish_bl(reg, MODEL, v, jax_baseline(table))
    ctl = JaxController(
        reg, MODEL, JAX_SCHEMA, state_dir=str(tmp_path / "jax_state"),
        train_source=train, holdout_source=holdout, full_source=full,
        forest_params=params,
        policy=JaxPolicy(**(policy or policy_kw())))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(cycles):
            ctl.submit_alert(JaxAlert(**drift_alert().__dict__))
            ctl.run_pending()
        for pred, act in outcomes:
            if ctl.record_outcome(pred, act) is not None:
                break
    return reg, ctl


def assert_same_state(port_reg, port_ctl, jax_reg, jax_ctl):
    """The port's journal and registry equal the JAX package's."""
    _same_file(port_ctl.journal.path, jax_ctl.journal.path)
    assert port_reg.versions(MODEL) == jax_reg.versions(MODEL)
    assert port_reg.pinned_version(MODEL) == jax_reg.pinned_version(MODEL)
    pin = os.path.join(port_reg.store.path(MODEL), "serving.json")
    if os.path.exists(pin):
        _same_file(pin, os.path.join(jax_reg.store.path(MODEL),
                                     "serving.json"))
    for v in port_reg.versions(MODEL):
        got, want = port_reg.version_dir(MODEL, v), \
            jax_reg.version_dir(MODEL, v)
        assert sorted(os.listdir(got)) == sorted(os.listdir(want)), v
        for f in os.listdir(want):
            _same_file(os.path.join(got, f), os.path.join(want, f))


# --------------------------------------------------------------------------
# journal
# --------------------------------------------------------------------------

def test_journal_atomic_roundtrip_and_torn_tolerance(tmp_path):
    from avenir_tpu.control import CycleJournal as JaxJournal
    state = str(tmp_path / "state")
    jr = CycleJournal(state)
    assert jr.stage == "idle" and not jr.pending
    jr.open_cycle({"scope": "x"}, "incremental", champion_version=1)
    jr.advance("candidate_validate", candidate_sha="abc")
    # the JAX package writes the same bytes for the same transitions
    twin = JaxJournal(str(tmp_path / "jax_state"))
    twin.open_cycle({"scope": "x"}, "incremental", champion_version=1)
    twin.advance("candidate_validate", candidate_sha="abc")
    _same_file(jr.path, twin.path)
    # a fresh instance reads the exact persisted state
    jr2 = CycleJournal(state)
    assert jr2.stage == "candidate_validate" and jr2.pending
    assert jr2["candidate_sha"] == "abc" and jr2.cycle == 1
    # an abandoned pre-rename tmp never shadows the real file
    with open(jr2.path + ".tmp.999", "w") as fh:
        fh.write("{ torn")
    assert CycleJournal(state).stage == "candidate_validate"
    # a damaged final journal degrades to idle with a warning
    with open(jr2.path, "w") as fh:
        fh.write("{ not json")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        jr3 = CycleJournal(state)
    assert jr3.stage == "idle"


def test_journal_refuses_overlapping_cycles(tmp_path):
    jr = CycleJournal(str(tmp_path / "state"))
    jr.open_cycle(None, "incremental", 1)
    with pytest.raises(RuntimeError, match="still at stage"):
        jr.open_cycle(None, "incremental", 1)
    jr.close_cycle(PUBLISHED)
    assert jr.open_cycle(None, "full", 2) == 2
    assert [h["cycle"] for h in jr.history] == [1]


# --------------------------------------------------------------------------
# the happy cycle
# --------------------------------------------------------------------------

def test_cycle_retrains_validates_publishes_swaps(tmp_path, mesh_ctx):
    """Alert -> incremental retrain on the fresh window -> candidate beats
    the champion on the drifted holdout -> published -> pinned -> a
    linked PredictionService hot-swaps to it; journal and registry equal
    the JAX package's."""
    from avenir_tpu_torch.serving import PredictionService
    reg, params, clean, fresh = build_champion(tmp_path)
    svc = PredictionService(registry=reg, model_name=MODEL, warm=False)
    ctl = make_controller(reg, params, tmp_path, fresh, fleet=svc)
    assert ctl.submit_alert(drift_alert())
    summary = ctl.run_pending()
    assert summary["outcome"] == PUBLISHED
    assert summary["candidate_version"] == 2
    assert summary["candidate_accuracy"] > summary["champion_accuracy"]
    assert reg.versions(MODEL) == [1, 2]
    assert reg.serving_version(MODEL) == 2
    loaded = reg.load(MODEL, 2)
    assert loaded.params["retrain_mode"] == "incremental"
    assert load_baseline(reg, MODEL, 2).n_rows == 600
    assert svc.version == 2
    # bit-identity vs a direct build over the same window
    ref = build_forest(load_csv(fresh, SCHEMA, ","), params)
    assert [m.to_json() for m in loaded.model] == \
        [m.to_json() for m in ref]
    c = ctl.counters.as_dict()["Controller"]
    assert c["Cycles"] == 1 and c["Published"] == 1 and c["Swaps"] == 1
    assert os.listdir(ctl.journal.state_dir) == ["controller.json"]
    assert_same_state(reg, ctl, *jax_twin(tmp_path, mesh_ctx, fresh))


def test_worse_candidate_refused_champion_untouched(tmp_path, mesh_ctx):
    reg, params, clean, fresh = build_champion(tmp_path)
    garbage = str(tmp_path / "garbage.csv")
    write_csv(garbage, gen_rows(600, seed=9, shuffle_labels=True))
    ctl = RetrainController(
        reg, MODEL, SCHEMA, state_dir=str(tmp_path / "state"),
        train_source=garbage, holdout_source=clean, forest_params=params,
        policy=RetrainPolicy(chunk_rows=128))
    ctl.submit_alert(drift_alert())
    with pytest.warns(RuntimeWarning, match="candidate refused"):
        summary = ctl.run_pending()
    assert summary["outcome"] == REFUSED
    assert summary["candidate_accuracy"] < summary["champion_accuracy"]
    assert reg.versions(MODEL) == [1]
    assert reg.pinned_version(MODEL) is None
    assert reg.serving_version(MODEL) == 1
    assert ctl.counters.get("Controller", "Refused") == 1
    assert_same_state(reg, ctl, *jax_twin(
        tmp_path, mesh_ctx, garbage, holdout=clean,
        policy=dict(chunk_rows=128)))


def test_scheduled_full_rebuild_mode(tmp_path, mesh_ctx):
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = RetrainController(
        reg, MODEL, SCHEMA, state_dir=str(tmp_path / "state"),
        train_source=fresh, full_source=clean, holdout_source=clean,
        forest_params=params,
        policy=RetrainPolicy(chunk_rows=128, full_rebuild_every=1))
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["outcome"] == PUBLISHED
    loaded = reg.load(MODEL, 2)
    assert loaded.params["retrain_mode"] == "full"
    ref = build_forest(load_csv(clean, SCHEMA, ","), params)
    assert [m.to_json() for m in loaded.model] == \
        [m.to_json() for m in ref]
    assert_same_state(reg, ctl, *jax_twin(
        tmp_path, mesh_ctx, fresh, full=clean, holdout=clean,
        policy=dict(chunk_rows=128, full_rebuild_every=1)))


def test_alert_intake_coalesce_and_warn_ignored(tmp_path):
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh)
    warn = drift_alert()
    warn.level = "warn"
    assert not ctl.submit_alert(warn)
    assert ctl.counters.get("Controller", "AlertsIgnored") == 1
    assert ctl.run_pending() is None
    assert ctl.submit_alert(drift_alert())
    assert not ctl.submit_alert(drift_alert())
    assert ctl.counters.get("Controller", "AlertsCoalesced") == 1


def test_policy_retrain_action_wires_alerts_to_controller(tmp_path,
                                                          mesh_ctx):
    """A DriftPolicy scoring drifted windows against the champion
    baseline fires through retrain_action into the controller's intake;
    the handoff is a queue append (no retrain ran inline)."""
    from avenir_tpu.control import RetrainController as JC
    from avenir_tpu.monitor.accumulator import \
        StreamDriftMonitor as JaxMonitor
    from avenir_tpu.monitor.baseline import load_baseline as jax_load_bl
    from avenir_tpu.monitor.policy import DriftPolicy as JaxDriftPolicy
    from avenir_tpu.monitor.policy import retrain_action as jax_action
    from avenir_tpu_torch.core.metrics import Counters
    from avenir_tpu_torch.monitor.accumulator import StreamDriftMonitor
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh)
    counters = Counters()
    policy = DriftPolicy(consecutive=1, counters=counters,
                         on_alert=retrain_action(ctl, counters))
    monitor = StreamDriftMonitor(load_baseline(reg, MODEL, 1),
                                 policy=policy, window_rows=300)
    monitor.observe_table(load_csv(fresh, SCHEMA, ","))
    monitor.close_window()
    assert counters.get("DriftMonitor", "RetrainRequests") >= 1
    assert ctl.counters.get("Controller", "Alerts") == 1
    assert ctl.journal.stage == "idle"
    assert ctl.run_pending()["outcome"] == PUBLISHED
    assert reg.serving_version(MODEL) == 2
    assert ctl.journal["trigger"]["level"] == "alert"
    # the JAX package's wiring over the same window journals the same
    # trigger and publishes the same version
    jreg, _ = jax_twin(tmp_path, mesh_ctx, fresh, cycles=0)
    jctl = JC(jreg, MODEL, JAX_SCHEMA,
              state_dir=str(tmp_path / "jax_state"), train_source=fresh,
              forest_params=_jax_params(), policy=JaxPolicy(**policy_kw()))
    from avenir_tpu.core.metrics import Counters as JaxCounters
    jc = JaxCounters()
    jmon = JaxMonitor(jax_load_bl(jreg, MODEL, 1),
                      policy=JaxDriftPolicy(consecutive=1, counters=jc,
                                            on_alert=jax_action(jctl, jc)),
                      window_rows=300)
    jmon.observe_table(jax_load_csv(fresh, JAX_SCHEMA, ","))
    jmon.close_window()
    jctl.run_pending()
    assert counters.get("DriftMonitor", "RetrainRequests") == \
        jc.get("DriftMonitor", "RetrainRequests")
    assert_same_state(reg, ctl, jreg, jctl)


def test_alerts_jsonl_stream_intake(tmp_path):
    reg, params, clean, fresh = build_champion(tmp_path)
    apath = str(tmp_path / "alerts.jsonl")
    with open(apath, "w") as fh:
        warn = drift_alert()
        warn.level = "warn"
        fh.write(warn.to_json() + "\n")
        fh.write("NOT JSON\n")
        fh.write(drift_alert().to_json() + "\n")
    with pytest.warns(RuntimeWarning, match="unparseable"):
        recs = alerts_from_jsonl(apath)
    assert len(recs) == 2
    ctl = make_controller(reg, params, tmp_path, fresh)
    assert ctl.consume(recs) == 1
    assert ctl.run_pending()["outcome"] == PUBLISHED
    assert alerts_from_jsonl(str(tmp_path / "nope.jsonl")) == []


# --------------------------------------------------------------------------
# probation
# --------------------------------------------------------------------------

def test_probation_rollback_on_live_underperformance(tmp_path, mesh_ctx):
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh,
                          probation_outcomes=40, probation_margin=5)
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["stage"] == PROBATION
    assert reg.serving_version(MODEL) == 2
    floor = ctl.journal["probation"]["floor"]
    verdict = None
    with pytest.warns(RuntimeWarning, match="rolled back"):
        for _ in range(40):
            verdict = ctl.record_outcome("T", "F")
            if verdict is not None:
                break
    assert verdict["outcome"] == ROLLED_BACK
    assert reg.pinned_version(MODEL) == 1
    assert reg.serving_version(MODEL) == 1
    assert reg.versions(MODEL) == [1, 2]
    assert ctl.counters.get("Controller", "Rollbacks") == 1
    assert ctl.journal["probation"]["last_accuracy"] < floor
    from avenir_tpu_torch.serving import PredictionService
    assert PredictionService(registry=reg, model_name=MODEL,
                             warm=False).version == 1
    assert_same_state(reg, ctl, *jax_twin(
        tmp_path, mesh_ctx, fresh, outcomes=[("T", "F")] * 40,
        policy=policy_kw(probation_outcomes=40, probation_margin=5)))


def test_probation_survival_completes_published(tmp_path, mesh_ctx):
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh,
                          probation_outcomes=20, probation_windows=2)
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["stage"] == PROBATION
    verdict = None
    for _ in range(40):
        verdict = ctl.record_outcome("T", "T")
        if verdict is not None:
            break
    assert verdict["outcome"] == PUBLISHED
    assert reg.serving_version(MODEL) == 2
    assert ctl.counters.get("Controller", "ProbationWindows") == 2
    assert ctl.record_outcome("T", "F") is None
    assert_same_state(reg, ctl, *jax_twin(
        tmp_path, mesh_ctx, fresh, outcomes=[("T", "T")] * 40,
        policy=policy_kw(probation_outcomes=20, probation_windows=2)))


# --------------------------------------------------------------------------
# chaos drills: kill the controller at every fault point under live load
# --------------------------------------------------------------------------

def start_fleet(reg, port, n_workers=2, models=None):
    fleet = ServingFleet(reg, MODEL, buckets=(8, 64),
                         policy=BatchPolicy(max_batch=16, max_wait_ms=1.0),
                         n_workers=n_workers, models=models,
                         config={"redis.server.port": port})
    return fleet.start()


def serve_round(client, rows, base_id, n=20, timeout_s=30.0):
    """Push n requests, pop n replies; returns {rid: label} — the 'fleet
    is still answering' probe."""
    client.lpush_many("requestQueue",
                      [",".join(["predict", f"{base_id}-{i}"]
                                + rows[i % len(rows)])
                       for i in range(n)])
    got = {}
    deadline = time.monotonic() + timeout_s
    while len(got) < n and time.monotonic() < deadline:
        for v in client.rpop_many("predictionQueue", 64):
            rid, label = v.split(",", 1)
            assert rid not in got, f"duplicate reply for {rid}"
            got[rid] = label
        time.sleep(0.002)
    assert len(got) == n, f"fleet stopped answering ({len(got)}/{n})"
    return got


def wait_converged(fleet, version, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while fleet.converged_version() != version \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return fleet.converged_version()


@pytest.mark.faultinject
@pytest.mark.parametrize("spec,_what", DRILLS,
                         ids=[s.split("=")[0] for s, _ in DRILLS])
def test_chaos_drill_controller_killed_fleet_survives(
        spec, _what, tmp_path, mesh_ctx, resp_server, port_faults):
    """Kill the controller at each named fault point while a live
    2-worker fleet drains traffic: the fleet answers through the crash
    on one version, and a NEW controller resumed on the same state dir
    finishes the cycle with exactly ONE new version — the JAX package's
    uninterrupted cycle's — and converges the fleet onto it."""
    from avenir_tpu_torch.io.respq import RespClient
    reg, params, clean, fresh = build_champion(tmp_path)
    rows = gen_rows(30, seed=77, drifted=True)
    fleet = start_fleet(reg, resp_server.port)
    feeder = RespClient(port=resp_server.port)
    try:
        serve_round(feeder, rows, "pre", 20)
        assert fleet.converged_version() == 1
        ctl = make_controller(reg, params, tmp_path, fresh, fleet=fleet)
        ctl.submit_alert(drift_alert())
        port_faults(spec)
        with pytest.raises(RuntimeError, match="injected fault"):
            ctl.run_pending()
        assert ctl.journal.pending
        serve_round(feeder, rows, "mid", 20)
        assert fleet.converged_version() == 1
        faults.uninstall()
        ctl2 = make_controller(reg, params, tmp_path, fresh, fleet=fleet)
        summary = ctl2.run_pending()
        assert summary["outcome"] == PUBLISHED
        assert ctl2.counters.get("Controller", "Resumes") == 1
        assert reg.versions(MODEL) == [1, 2]
        assert reg.serving_version(MODEL) == 2
        assert wait_converged(fleet, 2) == 2
        serve_round(feeder, rows, "post", 20)
        st = fleet.stats()
        assert st["errors"] == 0
        assert set(st["model_versions"].values()) == {2}
    finally:
        fleet.stop()
        feeder.close()
    assert_same_state(reg, ctl2, *jax_twin(tmp_path, mesh_ctx, fresh))


@pytest.mark.faultinject
def test_chaos_drill_killed_mid_rollback_resumes_rollback(
        tmp_path, mesh_ctx, resp_server, port_faults):
    from avenir_tpu_torch.io.respq import RespClient
    reg, params, clean, fresh = build_champion(tmp_path)
    rows = gen_rows(30, seed=78, drifted=True)
    fleet = start_fleet(reg, resp_server.port)
    feeder = RespClient(port=resp_server.port)
    try:
        ctl = make_controller(reg, params, tmp_path, fresh, fleet=fleet,
                              probation_outcomes=10)
        ctl.submit_alert(drift_alert())
        assert ctl.run_pending()["stage"] == PROBATION
        assert wait_converged(fleet, 2) == 2
        port_faults("rollback@0=raise:RuntimeError")
        with pytest.raises(RuntimeError, match="injected fault"):
            for _ in range(10):
                ctl.record_outcome("T", "F")
        faults.uninstall()
        assert ctl.journal.stage == "rollback"
        assert reg.serving_version(MODEL) == 2
        serve_round(feeder, rows, "mid", 20)
        ctl2 = make_controller(reg, params, tmp_path, fresh, fleet=fleet)
        with pytest.warns(RuntimeWarning, match="rolled back"):
            summary = ctl2.run_pending()
        assert summary["outcome"] == ROLLED_BACK
        assert reg.serving_version(MODEL) == 1
        assert wait_converged(fleet, 1) == 1
        serve_round(feeder, rows, "post", 20)
        assert fleet.stats()["errors"] == 0
    finally:
        fleet.stop()
        feeder.close()
    assert_same_state(reg, ctl2, *jax_twin(
        tmp_path, mesh_ctx, fresh, outcomes=[("T", "F")] * 10,
        policy=policy_kw(probation_outcomes=10)))


@pytest.mark.faultinject
def test_resumed_build_is_bit_identical(tmp_path, mesh_ctx, port_faults):
    """A build killed between checkpoints resumes from the checkpoint and
    publishes the model (and whole-window baseline) of an uninterrupted
    run — the JAX package's."""
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh)
    ctl.submit_alert(drift_alert())
    port_faults("retrain_build@3=raise:RuntimeError")
    with pytest.raises(RuntimeError):
        ctl.run_pending()
    faults.uninstall()
    ctl2 = make_controller(reg, params, tmp_path, fresh)
    assert ctl2.run_pending()["outcome"] == PUBLISHED
    assert ctl2.counters.get("Controller", "BuildResumes") == 1
    ref = build_forest(load_csv(fresh, SCHEMA, ","), params)
    assert [m.to_json() for m in reg.load(MODEL, 2).model] == \
        [m.to_json() for m in ref]
    bl = load_baseline(reg, MODEL, 2)
    assert bl.n_rows == 600
    ref_bl = compute_baseline(load_csv(fresh, SCHEMA, ","))
    assert np.array_equal(bl.counts, ref_bl.counts)
    assert_same_state(reg, ctl2, *jax_twin(tmp_path, mesh_ctx, fresh))


def test_resume_without_candidate_abandons_safely(tmp_path, mesh_ctx):
    from avenir_tpu.control import CycleJournal as JaxJournal
    reg, params, clean, fresh = build_champion(tmp_path)
    state = str(tmp_path / "state")
    jr = CycleJournal(state)
    jr.open_cycle(None, "incremental", champion_version=1)
    jr.advance("candidate_validate", candidate_sha="deadbeef")
    ctl = RetrainController(reg, MODEL, SCHEMA, state_dir=state,
                            train_source=fresh, forest_params=params)
    with pytest.warns(RuntimeWarning, match="abandoned"):
        summary = ctl.run_pending()
    assert summary["outcome"] == "abandoned"
    assert reg.versions(MODEL) == [1]
    assert reg.serving_version(MODEL) == 1
    assert ctl.counters.get("Controller", "Abandoned") == 1
    jreg, _ = jax_twin(tmp_path, mesh_ctx, fresh, cycles=0)
    jjr = JaxJournal(str(tmp_path / "jax_state"))
    jjr.open_cycle(None, "incremental", champion_version=1)
    jjr.advance("candidate_validate", candidate_sha="deadbeef")
    jctl = JaxController(jreg, MODEL, JAX_SCHEMA,
                         state_dir=str(tmp_path / "jax_state"),
                         train_source=fresh, forest_params=_jax_params())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jctl.run_pending()
    assert_same_state(reg, ctl, jreg, jctl)


def test_controller_retires_old_versions_in_loop(tmp_path, mesh_ctx):
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh, retire_keep_last=2)
    for _ in range(2):
        ctl.submit_alert(drift_alert())
        assert ctl.run_pending()["outcome"] == PUBLISHED
    assert reg.versions(MODEL) == [2, 3]
    assert reg.serving_version(MODEL) == 3
    assert ctl.counters.get("Controller", "VersionsRetired") >= 1
    assert_same_state(reg, ctl, *jax_twin(
        tmp_path, mesh_ctx, fresh, cycles=2,
        policy=policy_kw(retire_keep_last=2)))


# --------------------------------------------------------------------------
# CLI job
# --------------------------------------------------------------------------

def _cli_props(tmp_path, reg_dir, state, extra):
    schema_path = str(tmp_path / "schema.json")
    with open(schema_path, "w") as fh:
        json.dump(SCHEMA.to_dict(), fh)
    props = str(tmp_path / f"{os.path.basename(state)}.properties")
    with open(props, "w") as fh:
        fh.write("\n".join([
            f"dtb.model.registry.dir={reg_dir}",
            f"dtb.model.name={MODEL}",
            f"dtb.feature.schema.file.path={schema_path}",
            f"dtb.retrain.state.dir={state}",
            "dtb.retrain.block.rows=128",
            "dtb.num.trees=3",
            "dtb.max.depth.limit=2",
            "dtb.random.seed=3",
            *extra]) + "\n")
    return props


def _cli_both(tmp_path, mesh_ctx, fresh, extra):
    """The retrainController job of both packages over the same inputs;
    returns the two output directories."""
    from avenir_tpu.cli import run as jax_run
    from avenir_tpu_torch.cli import run as port_run
    jreg, _ = jax_twin(tmp_path, mesh_ctx, fresh, cycles=0)
    outs = []
    for name, run, reg_dir, plat in (
            ("port", port_run, str(tmp_path / "registry"),
             ["-Dplatform=cpu"]),
            ("jax", jax_run, jreg.base_dir, [])):
        props = _cli_props(tmp_path, reg_dir, str(tmp_path / f"{name}_cli"),
                           extra)
        out = str(tmp_path / f"{name}_out")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert run.main(["retrainController", f"-Dconf.path={props}",
                             *plat, fresh, out]) == 0
        outs.append(out)
    for f in ("decisions.jsonl", "part-r-00000"):
        _same_file(os.path.join(outs[0], f), os.path.join(outs[1], f))
    _same_file(str(tmp_path / "port_cli" / "controller.json"),
               str(tmp_path / "jax_cli" / "controller.json"))
    port_reg = ModelRegistry(str(tmp_path / "registry"))
    for v in port_reg.versions(MODEL):
        for f in ("meta.json", "baseline.json", "delta.json"):
            got = os.path.join(port_reg.version_dir(MODEL, v), f)
            if os.path.exists(got):
                _same_file(got, os.path.join(jreg.version_dir(MODEL, v), f))
    return outs


def test_retrain_controller_cli_job(tmp_path, mesh_ctx):
    reg, params, clean, fresh = build_champion(tmp_path)
    apath = str(tmp_path / "alerts.jsonl")
    with open(apath, "w") as fh:
        fh.write(drift_alert().to_json() + "\n")
    out, _ = _cli_both(tmp_path, mesh_ctx, fresh,
                       [f"dtb.retrain.alerts.path={apath}"])
    assert reg.versions(MODEL) == [1, 2]
    assert reg.serving_version(MODEL) == 2
    recs = [json.loads(ln) for ln in
            open(os.path.join(out, "decisions.jsonl")).read().splitlines()]
    assert recs[0]["outcome"] == PUBLISHED and recs[0].get("this_run")
    part = open(os.path.join(out, "part-r-00000")).read().split(",")
    assert part[2].strip() == PUBLISHED
    ctrs = json.loads(open(out + ".counters.json").read())
    assert ctrs["Controller"]["Published"] == 1


def test_retrain_controller_cli_probation_rollback(tmp_path, mesh_ctx):
    reg, params, clean, fresh = build_champion(tmp_path)
    prob = str(tmp_path / "probation.csv")
    rows = gen_rows(200, seed=11, drifted=True)
    for r in rows:
        r[4] = "F" if r[4] == "T" else "T"
    write_csv(prob, rows)
    out, _ = _cli_both(tmp_path, mesh_ctx, fresh, [
        "dtb.retrain.trigger=force",
        "dtb.retrain.probation.outcomes=50",
        f"dtb.retrain.probation.input={prob}"])
    assert reg.versions(MODEL) == [1, 2]
    assert reg.serving_version(MODEL) == 1
    recs = [json.loads(ln) for ln in
            open(os.path.join(out, "decisions.jsonl"))]
    assert any(r.get("outcome") == ROLLED_BACK for r in recs)


@pytest.mark.slow
def test_closed_loop_soak_drift_to_swap(tmp_path, resp_server):
    """The whole loop live: a fleet serves drifted traffic, the stream
    monitor fires a debounced alert through retrain_action, the
    controller's background thread retrains, validates, publishes and
    swaps, and the fleet converges onto the candidate."""
    from avenir_tpu_torch.core.metrics import Counters
    from avenir_tpu_torch.io.respq import RespClient
    from avenir_tpu_torch.monitor.accumulator import StreamDriftMonitor
    reg, params, clean, fresh = build_champion(tmp_path)
    fleet = start_fleet(reg, resp_server.port)
    feeder = RespClient(port=resp_server.port)
    ctl = make_controller(reg, params, tmp_path, fresh, fleet=fleet)
    counters = Counters()
    policy = DriftPolicy(consecutive=2, counters=counters,
                         on_alert=retrain_action(ctl, counters))
    monitor = StreamDriftMonitor(load_baseline(reg, MODEL, 1),
                                 policy=policy, window_rows=200)
    ctl.start(poll_s=0.05)
    try:
        drift_rows = gen_rows(500, seed=21, drifted=True)
        serve_round(feeder, drift_rows, "soak", 40)
        monitor.observe_table(load_csv(fresh, SCHEMA, ","))
        monitor.close_window()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if ctl.journal.stage == "complete" \
                    and ctl.journal["outcome"] == PUBLISHED:
                break
            time.sleep(0.05)
        assert ctl.journal["outcome"] == PUBLISHED
        assert wait_converged(fleet, 2) == 2
        serve_round(feeder, drift_rows, "post", 40)
        assert fleet.stats()["errors"] == 0
    finally:
        ctl.stop()
        fleet.stop()
        feeder.close()


def test_rollback_target_retired_abandons_not_wedges(tmp_path):
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh,
                          probation_outcomes=10)
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["stage"] == PROBATION
    shutil.rmtree(reg.version_dir(MODEL, 1))
    with pytest.warns(RuntimeWarning, match="rollback target"):
        verdict = None
        for _ in range(10):
            verdict = ctl.record_outcome("T", "F")
            if verdict is not None:
                break
    assert verdict["outcome"] == "abandoned"
    assert ctl.counters.get("Controller", "RollbackTargetMissing") == 1
    assert reg.pinned_version(MODEL) is None
    assert reg.serving_version(MODEL) == 2
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["stage"] == PROBATION
    assert ctl.resolve_probation(keep=True)["outcome"] == PUBLISHED


def test_cached_head_read_honors_stop_row(tmp_path):
    """The bounded head read the resumed build uses is served from a
    warm .avtc sidecar: the cached iterator honors stop_row, and a
    bounded read never BUILDS a cache."""
    from avenir_tpu_torch.core.table import iter_csv_chunks
    from avenir_tpu_torch.io.colcache import CachePolicy
    fresh = str(tmp_path / "rows.csv")
    write_csv(fresh, gen_rows(600, seed=5))

    def head_rows(cache):
        return sum(c.n_rows for c in iter_csv_chunks(
            fresh, SCHEMA, ",", chunk_rows=128, cache=cache, stop_row=256))

    assert head_rows(CachePolicy(policy="build")) == 256
    assert not os.path.exists(fresh + ".avtc")
    for _ in iter_csv_chunks(fresh, SCHEMA, ",", chunk_rows=128,
                             cache=CachePolicy(policy="build")):
        pass
    assert os.path.exists(fresh + ".avtc")
    assert head_rows(CachePolicy(policy="require")) == 256


def test_probation_timeout_and_operator_resolve(tmp_path):
    reg, params, clean, fresh = build_champion(tmp_path)
    ctl = make_controller(reg, params, tmp_path, fresh,
                          probation_outcomes=10, probation_timeout_s=0.05)
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["stage"] == PROBATION
    assert ctl.run_pending() is None
    time.sleep(0.1)
    with pytest.warns(RuntimeWarning, match="no verdict"):
        summary = ctl.run_pending()
    assert summary["outcome"] == PUBLISHED
    assert ctl.counters.get("Controller", "ProbationTimeouts") == 1
    assert reg.serving_version(MODEL) == 2
    ctl2 = make_controller(reg, params, tmp_path / "s2", fresh,
                           probation_outcomes=10)
    ctl2.submit_alert(drift_alert())
    assert ctl2.run_pending()["stage"] == PROBATION
    assert ctl2.force_cycle() is None
    with pytest.warns(RuntimeWarning, match="rolled back"):
        verdict = ctl2.resolve_probation(keep=False)
    assert verdict["outcome"] == ROLLED_BACK
    assert reg.serving_version(MODEL) == 2
    assert ctl2.resolve_probation() is None


def test_submit_alert_never_blocks_on_a_running_cycle(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    ctl = RetrainController(reg, MODEL, SCHEMA,
                            state_dir=str(tmp_path / "state"),
                            train_source=str(tmp_path / "x.csv"))
    with ctl._lock:
        done = threading.Event()
        threading.Thread(
            target=lambda: (ctl.submit_alert(drift_alert()), done.set()),
            daemon=True).start()
        assert done.wait(2.0), "submit_alert blocked behind the cycle lock"
    assert ctl.counters.get("Controller", "Alerts") == 1


def test_alerts_from_resp_repushes_stop_keeps_batch(resp_server):
    from avenir_tpu_torch.control import alerts_from_resp
    from avenir_tpu_torch.io.respq import RespClient
    cli = RespClient(port=resp_server.port)
    try:
        cli.lpush_many("alertQueue", [drift_alert().to_json(), "stop",
                                      drift_alert(n_rows=7).to_json()])
        recs = alerts_from_resp(cli, "alertQueue")
        assert [r.n_rows for r in recs] == [600, 7]
        assert cli.rpop_many("alertQueue", 10) == ["stop"]
    finally:
        cli.close()


def test_wire_fleet_link_pushes_addressed_reloads(resp_server):
    from avenir_tpu_torch.control import WireFleetLink
    from avenir_tpu_torch.io.respq import RespClient
    cli = RespClient(port=resp_server.port)
    try:
        assert WireFleetLink(cli, hosts=["hostA", "hostB"]).refresh()
        assert set(cli.rpop_many("requestQueue", 10)) == \
            {"reload,hostA", "reload,hostB"}
        assert WireFleetLink(cli).refresh()
        assert cli.rpop_many("requestQueue", 10) == ["reload"]
    finally:
        cli.close()


# --------------------------------------------------------------------------
# canary_validate: the journaled live-traffic gate
# --------------------------------------------------------------------------

@pytest.mark.multimodel
@pytest.mark.faultinject
def test_chaos_drill_canary_validate_resumes_and_publishes_once(
        tmp_path, resp_server, port_faults):
    from avenir_tpu_torch.control.journal import CANARY_VALIDATE
    from avenir_tpu_torch.io.respq import RespClient
    reg, params, clean, fresh = build_champion(tmp_path)
    rows = gen_rows(30, seed=77, drifted=True)
    fleet = start_fleet(reg, resp_server.port, models=[MODEL])
    feeder = RespClient(port=resp_server.port)
    try:
        serve_round(feeder, rows, "pre", 20)
        ctl = make_controller(reg, params, tmp_path, fresh, fleet=fleet,
                              canary_outcomes=6, canary_percent=50)
        ctl.submit_alert(drift_alert())
        port_faults("canary_validate@0=raise:RuntimeError")
        with pytest.raises(RuntimeError, match="injected fault"):
            ctl.run_pending()
        assert ctl.journal.pending
        assert ctl.journal.stage == CANARY_VALIDATE
        serve_round(feeder, rows, "mid", 20)
        assert fleet.converged_version() == 1
        assert fleet.canary_state(MODEL) is None
        faults.uninstall()
        ctl2 = make_controller(reg, params, tmp_path, fresh, fleet=fleet,
                               canary_outcomes=6, canary_percent=50)
        waiting = ctl2.run_pending()
        assert waiting["stage"] == CANARY_VALIDATE
        assert waiting["canary"]["needed"] == 6
        assert ctl2.counters.get("Controller", "Resumes") == 1
        assert reg.versions(MODEL) == [1]
        st = fleet.canary_state(MODEL)
        assert st is not None and st["percent"] == 50
        serve_round(feeder, rows, "can", 30)
        assert ctl2.run_pending() is None
        card = list(SCHEMA.class_attr_field.cardinality)
        summary = None
        for i in range(40):
            summary = ctl2.record_canary_outcome(f"oc-{i}", card[1],
                                                 card[1])
            if summary is not None:
                break
        assert summary is not None and summary["outcome"] == PUBLISHED
        assert reg.versions(MODEL) == [1, 2]
        assert reg.serving_version(MODEL) == 2
        can = ctl2.journal["canary"]
        assert can["candidate_accuracy"] == 100
        assert can["candidate_outcomes"] >= 6
        assert can["floor"] >= 0 and not can["timed_out"]
        assert fleet.canary_state(MODEL) is None
        assert wait_converged(fleet, 2) == 2
        serve_round(feeder, rows, "post", 20)
    finally:
        fleet.stop()
        feeder.close()


class _FakeCanaryFleet:
    """The canary verbs alone, with a record_canary_outcome that returns
    None so the controller exercises its own deterministic split."""

    def __init__(self):
        self.installed = None
        self.cleared = False

    def install_canary(self, mname, version=None, percent=10,
                       predictor=None, pos_class=None, neg_class=None,
                       window=32):
        self.installed = dict(mname=mname, percent=percent,
                              predictor=predictor, pos_class=pos_class,
                              neg_class=neg_class, window=window)

    def record_canary_outcome(self, mname, rid, predicted, actual):
        return None

    def clear_canary(self, mname):
        self.cleared = True


@pytest.mark.multimodel
def test_canary_refuses_candidate_below_live_floor(tmp_path):
    from avenir_tpu_torch.control.journal import CANARY_VALIDATE
    from avenir_tpu_torch.serving.router import canary_split
    reg, params, clean, fresh = build_champion(tmp_path)
    fake = _FakeCanaryFleet()
    ctl = make_controller(reg, params, tmp_path, fresh, fleet=fake,
                          canary_outcomes=5, canary_percent=50)
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["stage"] == CANARY_VALIDATE
    assert fake.installed["percent"] == 50
    assert fake.installed["predictor"] is not None
    assert {fake.installed["pos_class"], fake.installed["neg_class"]} \
        == set(SCHEMA.class_attr_field.cardinality)
    card = list(SCHEMA.class_attr_field.cardinality)
    summary = None
    i = 0
    with pytest.warns(RuntimeWarning, match="refused at canary"):
        while summary is None:
            rid = f"lbl-{i}"
            i += 1
            assert i < 100
            if canary_split(rid, 50):
                summary = ctl.record_canary_outcome(rid, card[0], card[1])
            else:
                summary = ctl.record_canary_outcome(rid, card[1], card[1])
    assert summary["outcome"] == REFUSED
    assert fake.cleared
    assert reg.versions(MODEL) == [1]
    assert reg.serving_version(MODEL) == 1
    can = ctl.journal["canary"]
    assert can["candidate_accuracy"] == 0
    assert can["champion_accuracy"] == 100
    assert can["floor"] > 0
    assert ctl.counters.get("Controller", "Refused") == 1
    assert not ctl.journal.pending


@pytest.mark.multimodel
def test_canary_skips_without_capable_fleet(tmp_path):
    from avenir_tpu_torch.serving import PredictionService
    reg, params, clean, fresh = build_champion(tmp_path)
    svc = PredictionService(registry=reg, model_name=MODEL, warm=False)
    ctl = make_controller(reg, params, tmp_path, fresh, fleet=svc,
                          canary_outcomes=4)
    ctl.submit_alert(drift_alert())
    assert ctl.run_pending()["outcome"] == PUBLISHED
    assert reg.versions(MODEL) == [1, 2]
    assert ctl.journal["canary"] == {"skipped": True,
                                     "reason": "no canary-capable fleet"}
