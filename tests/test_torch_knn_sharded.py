"""The train-sharded KNN path on the CPU: ``DistanceComputer`` over a mesh
(the CPU repeated S times, or the runtime context's) and ``knnPipeline``
under a CPU x 4 runtime context, against the JAX package and the committed
``tests/torch_fixtures/elearn_knn`` outputs."""

import importlib.util
import json
import os

import numpy as np
import pytest

from avenir_tpu.ops.distance import DistanceComputer as JaxDistance

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.ops.distance import DistanceComputer
from avenir_tpu_torch.parallel.mesh import (DeviceMesh, MeshContext,
                                            set_runtime_context)
from avenir_tpu_torch.utils.tracing import transfer_ledger

from test_torch_knn import pair, port_schema, schema_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
PROPS = os.path.join(RES, "knn.properties")
SCHEMA = os.path.join(RES, "elearn.json")
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "elearn_knn")


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "elearn_knn_make", os.path.join(FIXTURE, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()
RUNS = [name for name, _, _ in MAKE.runs("data")]


def cpu_mesh(S):
    return DeviceMesh(["cpu"] * S)


@pytest.fixture()
def cpu_context():
    """A CPU x 4 runtime context, cleared afterwards."""
    set_runtime_context(MeshContext(cpu_mesh(4)))
    yield
    set_runtime_context(None)


@pytest.fixture(scope="module")
def sharded_pipeline(tmp_path_factory):
    """Every fixture run through the port's knnPipeline with a CPU x 4
    runtime context installed by the caller (cli.run keeps it)."""
    d = tmp_path_factory.mktemp("sharded_knn")
    data = os.path.join(FIXTURE, "data")
    out = {}
    set_runtime_context(MeshContext(cpu_mesh(4)))
    try:
        for name, in_path, overrides in MAKE.runs(data):
            dest = str(d / name)
            assert port_run.main(MAKE.job_args(
                PROPS, SCHEMA, in_path, dest,
                overrides + ["-Dplatform=cpu"])) == 0
            with open(dest + ".counters.json") as fh:
                with open(os.path.join(dest, "part-r-00000")) as part:
                    out[name] = (part.read(), json.load(fh))
    finally:
        set_runtime_context(None)
    return out


@pytest.mark.parametrize("name", RUNS)
def test_knn_pipeline_sharded_reproduces_fixture(sharded_pipeline, name):
    text, counters = sharded_pipeline[name]
    with open(os.path.join(FIXTURE, f"{name}.csv")) as fh:
        assert text == fh.read()
    with open(os.path.join(FIXTURE, "counters.json")) as fh:
        want = json.load(fh)[name]
    assert {g: counters[g] for g in MAKE.COUNTER_GROUPS} == want
    # one test chunk (500 or 2000 rows): one B5 site call and one merge
    assert counters["KernelBackends"] == {"knn.topk.torch": 1}
    assert counters["Dispatches"] == {"knn.shard_merge": 1, "knn.topk": 1}
    assert counters["Collectives"] == {"GatherBytes": 0, "Gathers": 1}


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("case", [("elearn", 300, 1000, 7, 128),
                                  ("bench", 17, 5, 9, 64)],
                         ids=["elearn-t300r1000", "bench-t17r5"])
def test_pairwise_topk_over_a_mesh_equals_jax(case, metric, S):
    name, n_test, n_train, k, chunk = case
    test, train, ptest, ptrain = pair(name, n_test, n_train)
    want_d, want_i = JaxDistance(schema_of(name), metric=metric) \
        .pairwise_topk(test, train, k, test_chunk=chunk)
    comp = DistanceComputer(port_schema(name), metric=metric,
                            mesh=cpu_mesh(S))
    assert comp.mesh.size == S
    got_d, got_i = comp.pairwise_topk(ptest, ptrain, k, test_chunk=chunk)
    assert got_d.dtype == np.int32 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)


def test_sharded_dispatch_and_transfer_counts():
    """Per test chunk: 2 H2D, one knn.topk and one knn.shard_merge
    dispatch, one gather; one concat dispatch for several chunks; 2 D2H a
    call; the train shards upload once (2 H2D a shard)."""
    _, _, ptest, ptrain = pair("bench", 64, 2500)
    comp = DistanceComputer(port_schema("bench"), mesh=cpu_mesh(3))
    with transfer_ledger() as cold:
        d1, i1 = comp.pairwise_topk(ptest, ptrain, 7, test_chunk=32)
    assert cold.dispatch_sites == {"knn.topk": 2, "knn.shard_merge": 2}
    assert cold.dispatches == 5 and cold.d2h_transfers == 2
    assert cold.h2d_transfers == 3 * 2 + 2 * 2
    assert (cold.gathers, cold.gather_bytes) == (2, 0)
    with transfer_ledger() as warm:
        d2, i2 = comp.pairwise_topk(ptest, ptrain, 7, test_chunk=32)
    assert warm.h2d_transfers == 2 * 2
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    flat = DistanceComputer(port_schema("bench"), device="cpu")
    np.testing.assert_array_equal((d1, i1), flat.pairwise_topk(ptest,
                                                               ptrain, 7))


def test_train_shards_are_contiguous_ranges_without_pad_rows():
    _, _, ptest, ptrain = pair("elearn", 4, 10)
    comp = DistanceComputer(port_schema("elearn"), mesh=cpu_mesh(4))
    comp.pairwise_topk(ptest, ptrain, 3)
    rn, _ = comp._encode_train(ptrain)
    shards = comp.train_shards()
    assert [s[0].shape[0] for s in shards] == [3, 3, 3, 1]
    np.testing.assert_array_equal(
        np.concatenate([s[0].numpy() for s in shards]), rn)


def test_placement_rules(cpu_context):
    """The runtime context's mesh when it has several devices; a 1-device
    mesh is the single-device computer; device= pins one device; mesh and
    device together raise."""
    schema = port_schema("elearn")
    assert DistanceComputer(schema).mesh.size == 4
    assert DistanceComputer(schema, device="cpu").mesh is None
    single = DistanceComputer(schema, mesh=DeviceMesh(["cpu"]))
    assert single.mesh is None and single.device.type == "cpu"
    with pytest.raises(ValueError, match="mutually exclusive"):
        DistanceComputer(schema, mesh=cpu_mesh(2), device="cpu")
    set_runtime_context(MeshContext(DeviceMesh(["cpu"])))
    assert DistanceComputer(schema).mesh is None
