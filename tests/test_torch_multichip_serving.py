"""Tree-sharded forest serving (kernel B6 and the merge-finalize), port
against the JAX package on the CPU.

The port's mesh is an explicit device list, here the CPU repeated S times;
the JAX package's is the conftest's 8 virtual CPU devices.  Answers, tallies
and votes must be equal bit for bit: the port's sharded serve against its
own single-device serve and against the JAX ``ForestPredictor(serve_mesh=
True)`` (XLA body and the Pallas partial-vote kernel in interpret mode);
the plain partial tallies against the Pallas ``ensemble_partial_votes``
over the same tree slices; the plain merge-finalize against
``_vote_finalize`` of the summed JAX partials.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.core.table import encode_rows as jax_encode_rows
from avenir_tpu.models.forest import (_ensemble_vote_body, _member_votes_body,
                                      _vote_finalize)
from avenir_tpu.ops.pallas.dispatch import force_backend
from avenir_tpu.ops.pallas.vote import ensemble_partial_votes as jax_partial
from avenir_tpu.serving.predictor import ForestPredictor as JaxForestPredictor
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry
from tests.test_serving import forest_batch_predict, raw_rows_of, small_forest
from tests.test_tree import SCHEMA as JAX_SCHEMA

from avenir_tpu_torch import weights
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.kernels import vote
from avenir_tpu_torch.parallel.mesh import DeviceMesh
from avenir_tpu_torch.runtime import set_default_device
from avenir_tpu_torch.serving.predictor import ForestPredictor, make_predictor
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.serving.service import PredictionService
from avenir_tpu_torch.utils.tracing import transfer_ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAFO9 = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9")
SCHEMA = FeatureSchema.from_dict(JAX_SCHEMA.to_dict())


def cpu_mesh(S):
    return DeviceMesh(["cpu"] * S)


def port_trees(jax_models):
    """The JAX forest carried across as its tree JSON (weights.py)."""
    return weights.from_model_json(
        {"trees": [json.loads(m.to_json()) for m in jax_models]})


@pytest.fixture(scope="module")
def forest(mesh_ctx):
    """13 trees (padded at 2, 3, 4 and 8 shards), 120 requests, and the
    JAX package's answers: the batch path, the single-device serve and
    the 8-way sharded serve (XLA and Pallas)."""
    table, models = small_forest(mesh_ctx, n=500, trees=13, seed=3)
    rows = raw_rows_of(table, 120)
    expect = forest_batch_predict(models, jax_encode_rows(rows, JAX_SCHEMA))
    single = JaxForestPredictor(models, JAX_SCHEMA).warm().predict_rows(rows)
    sharded = JaxForestPredictor(models, JAX_SCHEMA, serve_mesh=True) \
        .warm().predict_rows(rows)
    with force_backend("pallas"):
        pallas = JaxForestPredictor(models, JAX_SCHEMA, serve_mesh=True) \
            .warm().predict_rows(rows)
    assert expect == single == sharded == pallas
    return models, rows, expect


@pytest.fixture()
def cpu_default():
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_sharded_serve_matches_single_device_and_jax(forest, S):
    models, rows, expect = forest
    trees = port_trees(models)
    single = ForestPredictor(trees, SCHEMA, device="cpu").warm()
    p = ForestPredictor(trees, SCHEMA, serve_mesh=cpu_mesh(S)).warm()
    assert p.serve_mesh is not None and p.serve_mesh.size == S
    assert p.ensemble._stacked is None and len(p.ensemble._sharded) == S
    assert single.predict_rows(rows) == expect
    assert p.predict_rows(rows) == expect


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_shards_pad_with_zero_weight_never_match_members(forest, S):
    models, _, _ = forest
    p = ForestPredictor(port_trees(models), SCHEMA, serve_mesh=cpu_mesh(S))
    shards = p.ensemble._sharded
    T, pad = 13, (-13) % S
    assert {m.shape[0] for m in shards} == {(T + pad) // S}
    host = p.ensemble.stacked_host()
    lo = torch.cat([m.lo for m in shards])
    np.testing.assert_array_equal(lo[:T].numpy(), host[0])
    tail = [torch.cat([getattr(m, f) for m in shards])[T:]
            for f in ("lo", "hi", "num_r", "cat_m", "cat_r", "cls_oh",
                      "wvec")]
    assert bool((tail[0] == float("inf")).all())
    assert bool((tail[1] == float("-inf")).all())
    assert bool(tail[2].all()) and not bool(tail[3].any())
    assert not bool(tail[4].any())
    assert not bool(tail[5].any()) and not bool(tail[6].any())


def _partial_inputs(seed=42):
    """test_pallas_kernels.py's partial-vote shape: T=16, P=4, F=3, C=5,
    K=3, n=41."""
    rng = np.random.default_rng(seed)
    T, P, F, C, K, n = 16, 4, 3, 5, 3, 41
    vals = rng.normal(size=(n, F)).astype(np.float32)
    codes = rng.integers(0, C, size=(n, F)).astype(np.int32)
    lo = np.sort(rng.normal(size=(T, P, F)).astype(np.float32) - 1, axis=2)
    hi = lo + 2.0
    num_r = rng.random((T, P, F)) < 0.5
    cat_m = rng.random((T, P, F, C)) < 0.7
    cat_r = rng.random((T, P, F)) < 0.3
    cls_oh = np.eye(K, dtype=np.float32)[rng.integers(0, K, size=(T, P))]
    wvec = rng.integers(1, 5, size=(T,)).astype(np.float32)
    return vals, codes, (lo, hi, num_r, cat_m, cat_r, cls_oh, wvec)


def _slices(T, S):
    step = -(-T // S)
    return [slice(s * step, min((s + 1) * step, T)) for s in range(S)]


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_partial_votes_match_pallas_partials(S):
    vals, codes, consts = _partial_inputs()
    jv, jc = jnp.asarray(vals), jnp.asarray(codes)
    tv, tc = torch.from_numpy(vals), torch.from_numpy(codes)
    whole = np.asarray(_member_votes_body(jv, jc,
                                          *[jnp.asarray(a) for a in consts]))
    merged = np.zeros_like(whole)
    for sl in _slices(16, S):
        part = [a[sl] for a in consts]
        want = np.asarray(jax_partial(jv, jc, *[jnp.asarray(a) for a in part],
                                      interpret=True))
        model = vote.prepare_vote_model(*part, "cpu")
        got = vote.ensemble_partial_votes(tv, tc, model)
        assert got.dtype == torch.float32 and got.shape == (41, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        merged = merged + want
    np.testing.assert_array_equal(merged, whole)


@pytest.mark.parametrize("min_odds", [1.0, 1.5])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_merge_finalize_matches_vote_finalize(S, min_odds):
    """Summed JAX partials through ``_vote_finalize`` against the port's
    merge over its own partials; tied tallies (every weight 1) and the
    veto both occur.  The merged vote equals the unsharded one."""
    vals, codes, consts = _partial_inputs(seed=7)
    consts = consts[:-1] + (np.ones(16, np.float32),)     # ties
    jv, jc = jnp.asarray(vals), jnp.asarray(codes)
    tv, tc = torch.from_numpy(vals), torch.from_numpy(codes)
    j_parts, t_parts = [], []
    for sl in _slices(16, S):
        part = [a[sl] for a in consts]
        j_parts.append(np.asarray(jax_partial(
            jv, jc, *[jnp.asarray(a) for a in part], interpret=True)))
        t_parts.append(vote.ensemble_partial_votes(
            tv, tc, vote.prepare_vote_model(*part, "cpu")))
    total = j_parts[0]
    for p in j_parts[1:]:
        total = total + p
    want = np.asarray(_vote_finalize(jnp.asarray(total),
                                     jnp.float32(min_odds)))
    got = vote.vote_merge_finalize(t_parts, min_odds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        vote.vote_merge_finalize_torch(t_parts, min_odds).numpy(), want)
    whole = np.asarray(_ensemble_vote_body(
        jv, jc, *[jnp.asarray(a) for a in consts], jnp.float32(min_odds)))
    np.testing.assert_array_equal(got.numpy(), whole)
    top2 = np.sort(total, axis=1)[:, -2:]
    assert (top2[:, 0] == top2[:, 1]).any()               # real ties
    if min_odds > 1.0:
        assert (want == 3).any()                          # vetoes


def test_merge_finalize_refuses_mismatched_shards():
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="at least one"):
        vote.vote_merge_finalize([], 1.0)
    with pytest.raises(ValueError, match="shard 1"):
        vote.vote_merge_finalize([a, torch.zeros((4, 2))], 1.0)
    with pytest.raises(ValueError, match="shard 1"):
        vote.vote_merge_finalize([a, a.to(torch.float64)], 1.0)


def test_shard_merge_ledger_one_per_batch(forest):
    models, rows, expect = forest
    p = ForestPredictor(port_trees(models), SCHEMA, serve_mesh=cpu_mesh(4),
                        buckets=(64, 256)).warm()
    with transfer_ledger() as led:
        assert p.predict_rows(rows) == expect
    sites = led.site_snapshot()
    assert sites.get("serve.shard_merge") == sites.get("serve.predict") >= 1
    assert "ensemble.vote" not in sites          # B2 never runs sharded
    batches = sites["serve.predict"]
    assert led.backend_snapshot() == {"serve.predict.torch": batches,
                                      "serve.shard_merge.torch": batches}
    # one gather a batch; a repeated device copies nothing
    assert (led.gathers, led.gather_bytes) == (batches, 0)


def test_serve_mesh_and_device_are_exclusive(forest):
    models, _, _ = forest
    with pytest.raises(ValueError, match="mutually exclusive"):
        ForestPredictor(port_trees(models), SCHEMA, serve_mesh=cpu_mesh(2),
                        device="cpu")


def test_one_device_serve_mesh_is_the_single_device_core(forest, cpu_default):
    models, rows, expect = forest
    for spec in (1, True, DeviceMesh(["cpu"])):
        p = ForestPredictor(port_trees(models), SCHEMA, serve_mesh=spec)
        assert p.serve_mesh is None and p.ensemble._sharded is None
        assert p.ensemble._stacked is not None
        assert p.predict_rows(rows) == expect


def test_no_stacked_form_warns_and_serves_host_vote(forest):
    """Fractional member weights have no stacked form: the sharded request
    warns and serves the float64 host vote on the mesh's first device,
    as the JAX package does."""
    models, rows, _ = forest
    w = [0.5 + 0.25 * (t % 3) for t in range(13)]
    want = JaxForestPredictor(models, JAX_SCHEMA, weights=w).predict_rows(rows)
    with pytest.warns(RuntimeWarning, match="no stacked device form"):
        p = ForestPredictor(port_trees(models), SCHEMA, weights=w,
                            serve_mesh=cpu_mesh(3))
    assert p.serve_mesh is None and p.ensemble._sharded is None
    with transfer_ledger() as led:
        assert p.predict_rows(rows) == want
    assert led.backend_snapshot() == {"ensemble.vote.host": 1}


def _publish(reg_dir, models):
    return JaxRegistry(reg_dir).publish("churn", models, schema=JAX_SCHEMA)


def test_make_predictor_threads_serve_mesh(tmp_path, forest):
    models, rows, expect = forest
    _publish(str(tmp_path), models)
    loaded = ModelRegistry(str(tmp_path)).load("churn")
    p = make_predictor(loaded, serve_mesh=cpu_mesh(3)).warm()
    assert p.serve_mesh is not None and p.serve_mesh.size == 3
    assert p.predict_rows(rows) == expect


def test_service_serve_mesh_through_load_and_refresh(tmp_path, mesh_ctx,
                                                     forest):
    models, rows, expect = forest
    _publish(str(tmp_path), models)
    svc = PredictionService(registry=ModelRegistry(str(tmp_path)),
                            model_name="churn", buckets=(8, 64),
                            serve_mesh=cpu_mesh(4))
    assert svc.predictor.serve_mesh.size == 4
    assert svc.predict_rows(rows) == expect
    table2, models2 = small_forest(mesh_ctx, n=300, trees=5, seed=11)
    v2 = _publish(str(tmp_path), models2)
    assert svc.refresh() and svc.version == v2
    assert svc.predictor.serve_mesh.size == 4
    rows2 = raw_rows_of(table2, 40)
    assert svc.predict_rows(rows2) == forest_batch_predict(
        models2, jax_encode_rows(rows2, JAX_SCHEMA))


def _rafo9_rows():
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        return [line.split(",") for line in fh.read().splitlines()]


def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize("S", [2, 3, 4])
def test_rafo9_served_and_pred_bytes_under_serve_mesh(tmp_path, S):
    """The rafo9 fixture (9 trees: padded at 2 and 4 shards) served over a
    copy of its registry and through make_predictor, sharded S ways on the
    CPU: served.csv and pred.csv byte for byte."""
    reg = str(tmp_path / "registry")
    shutil.copytree(os.path.join(RAFO9, "registry"), reg)
    rows = _rafo9_rows()
    svc = PredictionService(registry=ModelRegistry(reg), model_name="rafo9",
                            serve_mesh=cpu_mesh(S))
    assert svc.predictor.serve_mesh.size == S
    svc.start()
    futures = [svc.submit(r) for r in rows]
    served = [f.result(timeout=120) for f in futures]
    svc.stop()
    assert "".join(f"{i},{r}\n" for i, r in enumerate(served)) == \
        _read(os.path.join(RAFO9, "served.csv"))
    p = make_predictor(ModelRegistry(reg).load("rafo9"),
                       serve_mesh=cpu_mesh(S))
    labels = p.predict_rows(rows)
    assert "".join(",".join(r) + f",{lab}\n" for r, lab in zip(rows, labels)) \
        == _read(os.path.join(RAFO9, "pred.csv"))
