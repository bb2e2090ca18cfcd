"""The sidecar slice end to end on the CPU, port against the JAX package.

The JAX package's ``randomForestBuilder`` with ``dtb.model.quantize=true``
and ``dtb.baseline.publish=true`` (``tests/torch_fixtures/rafo9q/make.py``,
rerun here into a temporary directory) must still produce the committed
rafo9q fixture — JSON and CSV files byte for byte, ``.npz`` files by arrays
and dtypes (``np.savez`` stamps the write time into the zip).  The port's
job on the same data (``-Dplatform=cpu``) must give the same trees,
``meta.json``, ``baseline.json`` and ``quantized.json`` bytes, equal npz
arrays and equal counters; its ``predictionService -Dps.quantized=true``
must reproduce ``served_quantized.csv`` byte for byte.  The keys that need a
registry refuse without one, by name."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from avenir_tpu_torch.cli import run as port_run

TESTS = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(os.path.dirname(TESTS), "resource")
SCHEMA = os.path.join(RES, "call_hangup.json")
RAFO_PROPS = os.path.join(RES, "rafo.properties")
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
FIXTURE = os.path.join(TESTS, "torch_fixtures", "rafo9q")
VERSION = os.path.join("registry", "rafo9", "v_000001")
BYTE_FILES = [os.path.join(VERSION, f) for f in
              ("meta.json", "baseline.json", "quantized.json")] \
    + ["train_counters.json", "served_quantized.csv"]
NPZ_FILES = [os.path.join(VERSION, f) for f in
             ("arrays.npz", "baseline.npz", "quantized.npz")]


def _read(*parts):
    with open(os.path.join(*parts), "rb") as fh:
        return fh.read()


def _assert_npz_equal(got, want):
    with np.load(got) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _gen(n, seed, path):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.call_hangup_gen import generate
    with open(path, "w") as fh:
        fh.write("\n".join(generate(n, seed)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "rafo9q_make", os.path.join(FIXTURE, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = str(tmp_path_factory.mktemp("rafo9q"))
    mod.make(out)
    return out


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    """The port's randomForestBuilder with both sidecar keys, on the CPU."""
    d = tmp_path_factory.mktemp("port")
    train = _gen(5000, 17, d / "train.csv")
    out, reg = str(d / "model"), str(d / "registry")
    assert port_run.main([
        "randomForestBuilder", f"-Dconf.path={RAFO_PROPS}",
        f"-Ddtb.feature.schema.file.path={SCHEMA}",
        f"-Ddtb.model.registry.dir={reg}", "-Ddtb.model.name=rafo9",
        "-Ddtb.model.quantize=true", "-Ddtb.baseline.publish=true",
        "-Dplatform=cpu", train, out]) == 0
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)
    return out, str(d), counters


@pytest.mark.parametrize("name", BYTE_FILES)
def test_fixture_file_is_current(regenerated, name):
    assert _read(regenerated, name) == _read(FIXTURE, name)


@pytest.mark.parametrize("name", NPZ_FILES)
def test_fixture_npz_is_current(regenerated, name):
    _assert_npz_equal(os.path.join(regenerated, name),
                      os.path.join(FIXTURE, name))


def test_fixture_version_lists_its_sidecars():
    meta = json.loads(_read(FIXTURE, VERSION, "meta.json"))
    assert meta["files"] == ["arrays.npz", "baseline.json", "baseline.npz",
                             "quantized.json", "quantized.npz"]
    # the same forest as the rafo9 fixture's version
    rafo9 = json.loads(_read(RAFO9, VERSION, "meta.json"))
    assert meta["model_json"] == rafo9["model_json"]
    assert meta["tree_shas"] == rafo9["tree_shas"]


@pytest.mark.parametrize("name", [f for f in BYTE_FILES
                                  if f.startswith("registry")])
def test_port_job_writes_jax_bytes(regenerated, port_trained, name):
    assert _read(port_trained[1], name) == _read(regenerated, name)


@pytest.mark.parametrize("name", NPZ_FILES)
def test_port_job_writes_jax_arrays(regenerated, port_trained, name):
    _assert_npz_equal(os.path.join(port_trained[1], name),
                      os.path.join(regenerated, name))


def test_port_job_trees_and_counters(regenerated, port_trained):
    out, _, counters = port_trained
    for i in range(9):
        assert _read(out, f"tree_{i}.json") == _read(RAFO9, f"tree_{i}.json")
    assert counters["Random forest"] == json.loads(
        _read(regenerated, "train_counters.json"))
    assert counters["Random forest"]["QuantizedMismatchPerMillion"] == 3800
    assert counters["KernelBackends"] == {
        "baseline.absorb.torch": 1, "ensemble.vote.torch": 1,
        "forest.level.torch": 4, "quantized.vote.torch": 1}


def test_port_quantized_service_reproduces_fixture(port_trained, tmp_path):
    served = str(tmp_path / "served")
    assert port_run.main([
        "predictionService", f"-Dconf.path={RAFO_PROPS}",
        f"-Dps.model.registry.dir={os.path.join(port_trained[1], 'registry')}",
        "-Dps.model.name=rafo9", "-Dps.quantized=true", "-Dplatform=cpu",
        os.path.join(RAFO9, "requests.csv"), served]) == 0
    assert _read(served, "part-m-00000") == \
        _read(FIXTURE, "served_quantized.csv")
    with open(served + ".counters.json") as fh:
        c = json.load(fh)
    # every served batch (and warm-up bucket) took the int8 vote, and only
    # int8 request bytes went to the device: 8 a padded row (F = 4)
    kb = c["KernelBackends"]
    assert set(kb) == {"quantized.vote.torch", "serve.predict.quantized"}
    assert kb["quantized.vote.torch"] == kb["serve.predict.quantized"] >= 36
    h2d = c["Transfers"]["H2DBytes"]
    assert h2d % 8 == 0 and h2d >= 8 * 2000
