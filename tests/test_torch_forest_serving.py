"""Random-forest serving, port against the JAX package on the CPU: the same
forests and requests through ``avenir_tpu`` and ``avenir_tpu_torch``
(``-Dplatform=cpu`` / ``device="cpu"``) must give byte-identical job outputs
and identical votes.  Forests: the golden rf fixture (3 trees) and the
committed 9-tree rafo forest (tests/torch_fixtures/rafo9, trained by the
JAX package with resource/rafo.properties)."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.cli import run as jax_run
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.core.table import load_csv as jax_load_csv
from avenir_tpu.models.forest import EnsembleModel as JaxEnsemble
from avenir_tpu.models.forest import _ensemble_vote_body
from avenir_tpu.models.tree import DecisionPathList as JaxPathList
from avenir_tpu.models.tree import DecisionTreeModel as JaxTree
from avenir_tpu.serving.predictor import ForestPredictor as JaxForestPredictor
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry

from avenir_tpu_torch import weights
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv
from avenir_tpu_torch.kernels import vote
from avenir_tpu_torch.models.forest import EnsembleModel
from avenir_tpu_torch.models.tree import DecisionTreeModel
from avenir_tpu_torch.serving.predictor import ForestPredictor
from avenir_tpu_torch.utils.tracing import transfer_ledger

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
RES = os.path.join(ROOT, "resource")
PROPS = os.path.join(RES, "rafo.properties")
SCHEMA = os.path.join(RES, "call_hangup.json")
RF_GOLDEN = os.path.join(TESTS, "golden", "fixtures", "rf")
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
REQUESTS = os.path.join(RAFO9, "requests.csv")
TREES = [os.path.join(RAFO9, f"tree_{i}.json") for i in range(9)]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _counters(out_dir):
    with open(f"{out_dir}.counters.json") as fh:
        return json.load(fh)


def _head(path, n, dest):
    with open(path) as fh:
        lines = fh.read().splitlines()[:n]
    with open(dest, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(dest)


def _jax_trees():
    out = []
    for p in TREES:
        with open(p) as fh:
            out.append(JaxPathList.from_json(fh.read()))
    return out


def _rows(path, n=None):
    with open(path) as fh:
        return [line.split(",") for line in fh.read().splitlines()[:n]]


def test_golden_rf_model_predictor_bytes(tmp_path):
    sys.path.insert(0, RES)
    from gen.call_hangup_gen import generate
    train = tmp_path / "train.csv"
    train.write_text("\n".join(generate(400, 13)))
    out = str(tmp_path / "pred")
    assert port_run.main([
        "org.avenir.model.ModelPredictor", f"-Dconf.path={PROPS}",
        f"-Dmop.model.dir.path={RF_GOLDEN}",
        f"-Dmop.feature.schema.file.path={SCHEMA}", "-Dplatform=cpu",
        str(train), out]) == 0
    assert _read(os.path.join(out, "part-m-00000")) == \
        _read(os.path.join(RF_GOLDEN, "pred.csv"))
    assert _counters(out)["KernelBackends"] == {"ensemble.vote.torch": 1}


MOP_CASES = {
    "default": [],
    "min_odds_veto": ["-Dmop.min.odds.ratio=1.5"],
    "single_tree": ["-Dmop.model.file.names=tree_0.json"],
    "with_kid": ["-Dmop.output.mode=withKId"],
    "fractional_weights": [
        "-Dmop.ensemble.memeber.weights=0.5,1,1.5,1,1,1,1,1,2.25"],
}


@pytest.mark.parametrize("case", sorted(MOP_CASES))
def test_rafo9_model_predictor_matches_jax(tmp_path, case):
    requests = _head(REQUESTS, 600, tmp_path / "requests.csv")
    args = ["org.avenir.model.ModelPredictor", f"-Dconf.path={PROPS}",
            f"-Dmop.model.dir.path={RAFO9}",
            f"-Dmop.feature.schema.file.path={SCHEMA}", *MOP_CASES[case],
            requests]
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_run.main(args + [out_j]) == 0
    assert port_run.main(args + ["-Dplatform=cpu", out_p]) == 0
    got = _read(os.path.join(out_p, "part-m-00000"))
    assert got == _read(os.path.join(out_j, "part-m-00000"))
    backends = _counters(out_p).get("KernelBackends", {})
    if case == "min_odds_veto":
        assert b",ambiguous\n" in got
    if case == "fractional_weights":
        assert backends == {"ensemble.vote.host": 1}
    elif case == "single_tree":
        assert backends == {}
    else:
        assert backends == {"ensemble.vote.torch": 1}


def test_rafo9_model_predictor_matches_committed_output(tmp_path):
    out = str(tmp_path / "pred")
    assert port_run.main([
        "modelPredictor", f"-Dconf.path={PROPS}",
        f"-Dmop.model.dir.path={RAFO9}",
        f"-Dmop.feature.schema.file.path={SCHEMA}", "-Dplatform=cpu",
        REQUESTS, out]) == 0
    assert _read(os.path.join(out, "part-m-00000")) == \
        _read(os.path.join(RAFO9, "pred.csv"))


def test_prediction_service_serves_jax_published_forest(tmp_path):
    """A forest published by avenir_tpu's ModelRegistry, served by both
    packages' predictionService (in-process): identical replies."""
    reg = str(tmp_path / "registry")
    JaxRegistry(reg).publish("rafo9", _jax_trees(),
                             schema=JaxSchema.load(SCHEMA))
    requests = _head(REQUESTS, 600, tmp_path / "requests.csv")
    args = ["org.avenir.serving.PredictionService", f"-Dconf.path={PROPS}",
            f"-Dps.model.registry.dir={reg}", "-Dps.model.name=rafo9",
            "-Dps.transport=inprocess", requests]
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_run.main(args + [out_j]) == 0
    assert port_run.main(args + ["-Dplatform=cpu", out_p]) == 0
    got = _read(os.path.join(out_p, "part-m-00000"))
    assert got == _read(os.path.join(out_j, "part-m-00000"))
    assert got.count(b"\n") == 600
    served = _counters(out_p)
    assert served["Serving"]["Requests"] == 600
    assert served["KernelBackends"]["serve.predict.torch"] > 0


@pytest.mark.parametrize("batching", ["continuous", "drain"])
def test_prediction_service_reads_committed_registry(tmp_path, batching):
    reg = str(tmp_path / "registry")
    shutil.copytree(os.path.join(RAFO9, "registry"), reg)
    out = str(tmp_path / "served")
    assert port_run.main([
        "predictionService", f"-Dconf.path={PROPS}",
        f"-Dps.model.registry.dir={reg}", "-Dps.model.name=rafo9",
        f"-Dps.batching={batching}", "-Dplatform=cpu", REQUESTS, out]) == 0
    assert _read(os.path.join(out, "part-m-00000")) == \
        _read(os.path.join(RAFO9, "served.csv"))


def test_weights_from_stacked_host_give_identical_votes():
    schema_j = JaxSchema.load(SCHEMA)
    ens_j = JaxEnsemble([JaxTree(pl, schema_j) for pl in _jax_trees()],
                        stack=False)
    host = ens_j.stacked_host()
    # the port stacks the same forest into the same layout, bit for bit
    schema = FeatureSchema.load(SCHEMA)
    ens_p = EnsembleModel([DecisionTreeModel(pl, schema, device="cpu")
                           for pl in weights.load_model_dir(RAFO9)],
                          stack=False, device="cpu")
    for a, b in zip(ens_p.stacked_host(), host):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    table = load_csv(REQUESTS, schema)
    vals, codes = ens_p.models[0].matrix.feature_arrays(table)
    vals = vals.astype(np.float32)
    wvec = np.asarray([1, 2, 1, 1, 3, 1, 1, 1, 1], np.float32)
    want = np.asarray(_ensemble_vote_body(
        jnp.asarray(vals), jnp.asarray(codes),
        *[jnp.asarray(a) for a in host], jnp.asarray(wvec),
        jnp.float32(1.2)))
    for model in (weights.vote_model_from_stacked(host, wvec, device="cpu"),
                  weights.vote_model_from_stacked((*host, wvec),
                                                  device="cpu")):
        got = vote.ensemble_vote(torch.from_numpy(vals),
                                 torch.from_numpy(codes), model, 1.2)
        np.testing.assert_array_equal(got.numpy(), want)
    # registry model_json carries the same trees as the tree files
    meta = os.path.join(RAFO9, "registry", "rafo9", "v_000001", "meta.json")
    assert [t.to_json() for t in weights.from_model_json(meta)] == \
        [t.to_json() for t in weights.load_model_dir(RAFO9)]


@pytest.mark.parametrize("n", [1, 513])
def test_bucket_padding_matches_jax(n):
    rows = _rows(REQUESTS, n)
    schema = FeatureSchema.load(SCHEMA)
    port = ForestPredictor(weights.load_model_dir(RAFO9), schema,
                           device="cpu")
    prepared = port.prepare_rows(rows)
    assert [(t.n_rows, k) for t, k in prepared] == \
        ([(1, 1)] if n == 1 else [(512, 512), (1, 1)])
    want = JaxForestPredictor(_jax_trees(), JaxSchema.load(SCHEMA)) \
        .predict_rows(rows)
    assert port.predict_rows(rows) == want
    assert len(want) == n


def test_host_vote_matches_jax_host_vote(tmp_path):
    """Ensembles stacked_host rejects vote on the host in float64 — with
    fractional weights, and with request values that are not float32-exact
    — and every such vote is recorded as ensemble.vote.host."""
    rows = _rows(REQUESTS, 300)
    rows[5][2] = "300.1"                      # not float32-exact
    path = tmp_path / "req.csv"
    path.write_text("\n".join(",".join(r) for r in rows) + "\n")
    schema_j, schema = JaxSchema.load(SCHEMA), FeatureSchema.load(SCHEMA)
    table_j, table = jax_load_csv(str(path), schema_j), load_csv(str(path),
                                                                 schema)
    for w in ([0.5, 1.25, 1, 2, 0.75, 1, 1, 1.5, 1], None):
        ens_j = JaxEnsemble([JaxTree(pl, schema_j) for pl in _jax_trees()],
                            weights=w, min_odds_ratio=1.2)
        ens_p = EnsembleModel([DecisionTreeModel(pl, schema, device="cpu")
                               for pl in weights.load_model_dir(RAFO9)],
                              weights=w, min_odds_ratio=1.2, device="cpu")
        assert (ens_p._stacked is None) == (w is not None)
        with transfer_ledger() as led:
            got = ens_p.predict(table)
        assert got == ens_j.predict(table_j)
        assert led.backend_snapshot() == {"ensemble.vote.host": 1}
