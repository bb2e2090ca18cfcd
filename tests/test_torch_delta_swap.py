"""Delta distribution in the port (``serving/registry.py`` publish_delta,
``ForestPredictor.apply_delta``, ``PredictionService._try_delta``) on the
CPU, mirroring ``tests/test_delta_swap.py``: the JAX package's forests and
registry are the oracle, the port's vote runs its plain B2 version.

Held to: the port's ``publish_delta`` writes the reference's ``meta.json``
and ``delta.json`` bytes and its ``.npz`` arrays (array for array, dtype
for dtype: ``np.savez`` stamps the time); a delta refresh patches the
resident forest (DeltaSwaps 1) and answers exactly what the JAX batch
predict of the child answers and a full load of the child answers; the
H2D bytes are the changed slices, the index, the weights and the rebuilt
tables, nothing else; every tear (sha chain, a kill at each fault point)
takes the full load; ``retire`` keeps a live delta parent; a child of
shallower trees pads into the parent's layout; quantized serving reloads
in full; a patched forest that outgrows the table form runs the scan form.
Every comparison is exact.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from avenir_tpu.core.table import encode_rows as jax_encode_rows
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry
from tests.test_serving import forest_batch_predict, raw_rows_of, small_forest
from tests.test_tree import SCHEMA as JAX_SCHEMA

from avenir_tpu_torch import weights
from avenir_tpu_torch.core import faults
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.kernels import vote
from avenir_tpu_torch.parallel.mesh import DeviceMesh
from avenir_tpu_torch.runtime import set_default_device
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.serving.service import PredictionService
from avenir_tpu_torch.utils.tracing import transfer_ledger

SCHEMA = FeatureSchema.from_dict(JAX_SCHEMA.to_dict())


@pytest.fixture(autouse=True)
def cpu_default():
    set_default_device("cpu")
    yield
    set_default_device(None)
    faults.uninstall()


def port_trees(jax_models):
    return weights.from_model_json(
        {"trees": [json.loads(m.to_json()) for m in jax_models]})


def delta_pair(tmp_path, mesh_ctx, trees=5, changed=(2,), n=400, depth=3,
               child_depth=None):
    """v1 (parent) and v2 = publish_delta(child), the child replacing
    ``changed`` members, in a port registry and a JAX registry."""
    table, parent = small_forest(mesh_ctx, n=n, trees=trees, seed=3,
                                 depth=depth)
    _, other = small_forest(mesh_ctx, n=n, trees=trees, seed=9,
                            depth=child_depth or depth)
    child = list(parent)
    for i in changed:
        child[i] = other[i]
    reg = ModelRegistry(str(tmp_path / "port"))
    jreg = JaxRegistry(str(tmp_path / "jax"))
    for r, conv in ((reg, port_trees), (jreg, list)):
        sch = SCHEMA if r is reg else JAX_SCHEMA
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert r.publish("churn", conv(parent), schema=sch) == 1
            assert r.publish_delta("churn", conv(child), parent_version=1,
                                   schema=sch) == 2
    rows = raw_rows_of(table, 60)
    enc = jax_encode_rows(rows, JAX_SCHEMA)
    return {"reg": reg, "jreg": jreg, "rows": rows, "table": table,
            "parent": parent, "child": child,
            "expect1": forest_batch_predict(parent, enc),
            "expect2": forest_batch_predict(child, enc)}


def service_on_v1(reg, **kw):
    """A service resident on v1 while v2 is published: pinned to v1 for
    the start, the pin cleared after."""
    reg.pin_version("churn", 1)
    svc = PredictionService(registry=reg, model_name="churn",
                            buckets=(8, 64), **kw)
    reg.clear_pin("churn")
    assert svc.version == 1 and reg.serving_version("churn") == 2
    return svc


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_publish_delta_writes_the_reference_bytes(tmp_path, mesh_ctx):
    ex = delta_pair(tmp_path, mesh_ctx, trees=5, changed=(1, 3))
    reg, jreg = ex["reg"], ex["jreg"]
    for v in (1, 2):
        d, jd = reg.version_dir("churn", v), jreg.version_dir("churn", v)
        assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
        for f in os.listdir(d):
            if f.endswith(".npz"):
                with np.load(os.path.join(d, f)) as a, \
                        np.load(os.path.join(jd, f)) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in a.files:
                        assert a[k].dtype == b[k].dtype, (f, k)
                        np.testing.assert_array_equal(a[k], b[k])
            else:
                assert _read(os.path.join(d, f)) == \
                    _read(os.path.join(jd, f)), (v, f)
    dmeta = reg.delta_info("churn", 2)
    assert dmeta == jreg.delta_info("churn", 2)
    assert dmeta["changed"] == [1, 3] and dmeta["parent_version"] == 1
    _, arrays = reg.load_delta("churn", 2)
    assert list(arrays["idx"]) == [1, 3]
    assert reg.delta_info("churn", 1) is None
    # each side loads the other's delta
    jm, ja = jreg.load_delta("churn", 2)
    assert jm == dmeta and sorted(ja) == sorted(arrays)


def test_full_publish_has_no_delta_and_parentless_delta_warns(tmp_path,
                                                              mesh_ctx):
    table, m5 = small_forest(mesh_ctx, n=300, trees=5, seed=3)
    _, m3 = small_forest(mesh_ctx, n=300, trees=3, seed=9)
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish("churn", port_trees(m5), schema=SCHEMA)
    with pytest.warns(RuntimeWarning, match="member count changed"):
        v2 = reg.publish_delta("churn", port_trees(m3), parent_version=1,
                               schema=SCHEMA)
    assert reg.is_intact("churn", v2) and reg.delta_info("churn", v2) is None
    rows = raw_rows_of(table, 30)
    svc = PredictionService(registry=reg, model_name="churn",
                            buckets=(8, 64))
    assert svc.version == v2
    assert svc.predictor.predict_rows(rows) == \
        forest_batch_predict(m3, jax_encode_rows(rows, JAX_SCHEMA))


def test_delta_refresh_patches_and_matches_full_load(tmp_path, mesh_ctx):
    ex = delta_pair(tmp_path, mesh_ctx)
    svc = service_on_v1(ex["reg"])
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect1"]
    before = svc.predictor
    assert svc.refresh() is True
    assert svc.predictor is before          # patched, not replaced
    assert svc.version == 2
    assert svc.counters.get("Serving", "DeltaSwaps") == 1
    assert svc.counters.get("Serving", "HotSwaps") == 1
    got = svc.predictor.predict_rows(ex["rows"])
    assert got == ex["expect2"]
    full = PredictionService(registry=ex["reg"], model_name="churn",
                             buckets=(8, 64))
    assert full.version == 2
    assert full.counters.get("Serving", "DeltaSwaps") == 0
    assert full.predictor.predict_rows(ex["rows"]) == got
    # the patched resident form IS the child's stacked form
    for a, b in zip(svc.predictor.ensemble._host,
                    full.predictor.ensemble._host):
        np.testing.assert_array_equal(a, b)


def test_delta_refresh_h2d_is_the_slices_weights_and_tables(tmp_path,
                                                            mesh_ctx):
    """2 of 21 trees: the H2D bytes are the two trees' slices, the index,
    the (T,) weights and the rebuilt path-mask tables — the slices at
    most 15% of the resident stacked form."""
    ex = delta_pair(tmp_path, mesh_ctx, trees=21, changed=(4, 17))
    svc = service_on_v1(ex["reg"])
    host = svc.predictor.ensemble._host
    full_bytes = sum(a.nbytes for a in host[:6])
    with transfer_ledger() as led:
        assert svc.refresh() is True
    assert svc.counters.get("Serving", "DeltaSwaps") == 1
    _, arrays = ex["reg"].load_delta("churn", 2)
    slices = sum(arrays[k].nbytes for k in
                 ("lo", "hi", "num_r", "cat_m", "cat_r", "cls_oh"))
    assert slices <= 0.15 * full_bytes
    tables = vote.table_form(*svc.predictor.ensemble._host[:5])
    assert tables is not None
    want = slices + 2 * 8 + 21 * 4 + sum(a.nbytes for a in tables)
    assert led.h2d_bytes == want
    assert svc.counters.get("Serving", "DeltaH2DBytes") == want
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect2"]


@pytest.mark.parametrize("S", [2, 4])
def test_delta_refresh_on_sharded_core(tmp_path, mesh_ctx, S):
    """13 trees over S shards (padded): every shard's slice is patched."""
    ex = delta_pair(tmp_path, mesh_ctx, trees=13, changed=(0, 7, 12))
    svc = service_on_v1(ex["reg"], serve_mesh=DeviceMesh(["cpu"] * S))
    assert svc.predictor.serve_mesh is not None
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect1"]
    assert svc.refresh() is True
    assert svc.counters.get("Serving", "DeltaSwaps") == 1
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect2"]


def test_delta_pads_into_larger_parent_layout(tmp_path, mesh_ctx):
    ex = delta_pair(tmp_path, mesh_ctx, changed=(0, 1, 2, 3, 4),
                    child_depth=1)
    reg = ex["reg"]
    dmeta = reg.delta_info("churn", 2)
    assert dmeta is not None and dmeta["changed"] == [0, 1, 2, 3, 4]
    svc = service_on_v1(reg)
    assert dmeta["stacked_shape"]["P"] == \
        svc.predictor.ensemble._host[0].shape[1]
    assert svc.refresh() is True
    assert svc.counters.get("Serving", "DeltaSwaps") == 1
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect2"]


def test_sha_chain_mismatch_falls_back_to_full_load(tmp_path, mesh_ctx):
    ex = delta_pair(tmp_path, mesh_ctx)
    svc = service_on_v1(ex["reg"])
    svc.predictor.tree_shas = ["0" * 64] * 5
    with pytest.warns(RuntimeWarning, match="falling back"):
        assert svc.refresh() is True
    assert svc.version == 2
    assert svc.counters.get("Serving", "DeltaSwapTorn") == 1
    assert svc.counters.get("Serving", "DeltaSwaps") == 0
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect2"]


@pytest.mark.parametrize("serve_mesh,hit", [
    (None, 0), (None, 1), (None, 2), (2, 2), (2, 3)])
def test_mid_patch_kill_full_load_fallback(tmp_path, mesh_ctx, serve_mesh,
                                           hit):
    """A kill at each swap_patch point — the service's entry (0), before
    the (first shard's) patch (1), between shards or at the commit point
    — leaves the resident model untouched and the same refresh lands v2
    by the full load."""
    ex = delta_pair(tmp_path, mesh_ctx)
    mesh = DeviceMesh(["cpu"] * serve_mesh) if serve_mesh else None
    svc = service_on_v1(ex["reg"], serve_mesh=mesh)
    old = svc.predictor
    faults.install(faults.FaultInjector.parse(
        f"swap_patch@{hit}=raise:RuntimeError"))
    with pytest.warns(RuntimeWarning, match="falling back"):
        assert svc.refresh() is True
    assert svc.predictor is not old
    assert svc.version == 2
    assert svc.counters.get("Serving", "DeltaSwapTorn") == 1
    assert svc.counters.get("Serving", "DeltaSwaps") == 0
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect2"]
    # the torn patch left the old resident whole
    assert old.tree_shas == ex["reg"].load("churn", 1).meta["tree_shas"]
    assert old.predict_rows(ex["rows"]) == ex["expect1"]


def test_retire_protects_live_delta_parent(tmp_path, mesh_ctx):
    ex = delta_pair(tmp_path, mesh_ctx)
    reg = ex["reg"]
    v3 = reg.publish("churn", port_trees(ex["parent"]), schema=SCHEMA)
    v4 = reg.publish_delta("churn", port_trees(ex["child"]),
                           parent_version=v3, schema=SCHEMA)
    assert reg.retire("churn", keep_last=1, dry_run=True) == [1, 2]
    assert sorted(reg.retire("churn", keep_last=1)) == [1, 2]
    assert reg.versions("churn") == [v3, v4]
    assert reg.is_intact("churn", v3)
    assert reg.names() == ["churn"]


def test_retire_keeps_the_pin_and_sweeps_dead_tmps(tmp_path, mesh_ctx):
    table, m5 = small_forest(mesh_ctx, n=300, trees=3, seed=3)
    reg = ModelRegistry(str(tmp_path / "reg"))
    for _ in range(4):
        reg.publish("churn", port_trees(m5), schema=SCHEMA)
    reg.pin_version("churn", 1)
    assert reg.serving_version("churn") == 1
    with pytest.raises(ValueError, match="refusing to pin"):
        reg.pin_version("churn", 9)
    # an abandoned publish of a dead pid, older than the grace period
    dead = reg.version_dir("churn", 5) + ".tmp.999999999"
    os.makedirs(dead)
    os.utime(dead, (0, 0))
    assert ModelRegistry._pid_alive(os.getpid())
    assert not ModelRegistry._pid_alive(999999999)
    assert reg.retire("churn", keep_last=2) == [2]
    assert reg.versions("churn") == [1, 3, 4]
    assert not os.path.exists(dead)
    reg.clear_pin("churn")
    reg.clear_pin("churn")                        # idempotent
    assert reg.serving_version("churn") == 4


def test_quantized_serving_reloads_in_full(tmp_path, mesh_ctx):
    """ps.quantized serves each version's int8 sidecar: a reload onto a
    delta child loads it in full (v2 carries no sidecar: float, warned)."""
    from avenir_tpu_torch.core.table import encode_rows
    from avenir_tpu_torch.serving.quantized import publish_quantized
    ex = delta_pair(tmp_path, mesh_ctx)
    reg = ex["reg"]
    publish_quantized(reg, "churn", 1, reg.load("churn", 1).model, SCHEMA,
                      encode_rows(ex["rows"], SCHEMA), budget=1.0,
                      device="cpu")
    svc = service_on_v1(reg, quantized=True)
    assert svc.predictor.supports_prebinned
    with pytest.warns(RuntimeWarning, match="no quantized sidecar"):
        assert svc.refresh() is True
    assert svc.version == 2 and not svc.predictor.supports_prebinned
    assert svc.counters.get("Serving", "DeltaSwaps") == 0
    assert svc.counters.get("Serving", "DeltaSwapTorn") == 0
    assert svc.predictor.predict_rows(ex["rows"]) == ex["expect2"]


def test_patch_that_outgrows_the_tables_runs_the_scan_form():
    """A patched forest whose thresholds no longer fit the path-mask
    tables gets a model without them (the scan form); its votes equal the
    plain vote over the patched arrays, and the old model is untouched."""
    rng = np.random.default_rng(5)
    T, P, F, C, K = 9, 17, 16, 4, 3
    lo = rng.integers(0, 8, (T, P, F)).astype(np.float32)
    hi = lo + rng.integers(1, 8, (T, P, F)).astype(np.float32)
    num_r = rng.random((T, P, F)) < 0.5
    cat_m = rng.random((T, P, F, C)) < 0.5
    cat_r = rng.random((T, P, F)) < 0.3
    cls_oh = np.eye(K, dtype=np.float32)[rng.integers(0, K, (T, P))]
    wvec = np.ones(T, np.float32)
    host = (lo, hi, num_r, cat_m, cat_r, cls_oh, wvec)
    model = vote.prepare_vote_model(*host, "cpu")
    assert vote.vote_form(model) == "table"
    idx = np.array([2, 6], np.int32)
    # thousands of distinct thresholds: the tables pass SMEM_LIMIT
    wide = rng.random((2, P, F)).astype(np.float32) * 1e6
    slices = [wide, wide + 1, np.ones((2, P, F), bool), cat_m[idx],
              cat_r[idx], cls_oh[idx]]
    new, new_host, moved = vote.patch_vote_model(model, host, idx, slices,
                                                 wvec * 2)
    assert vote.vote_form(new) == "scan" and vote.vote_form(model) == "table"
    assert vote.table_form(*new_host[:5]) is None
    assert moved == idx.astype(np.int64).nbytes + T * 4 + sum(
        np.asarray(s).nbytes for s in slices)
    vals = torch.from_numpy(rng.random((300, F)).astype(np.float32) * 1e6)
    codes = torch.from_numpy(rng.integers(-1, C + 1, (300, F)).astype(
        np.int32))
    want = vote.ensemble_vote_torch(vals, codes, *(
        torch.from_numpy(np.ascontiguousarray(a)) for a in new_host), 1.0)
    assert torch.equal(vote.ensemble_vote(vals, codes, new, 1.0), want)
    np.testing.assert_array_equal(model.lo.numpy(), lo)
    with pytest.raises(ValueError, match="one-hot"):
        vote.patch_vote_model(model, host, idx, slices[:5] + [
            np.full((2, P, K), 0.5, np.float32)], wvec)
