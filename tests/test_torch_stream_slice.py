"""The streamed training slice end to end on the CPU, port against the JAX
package.

The JAX package's streamed ``randomForestBuilder`` over a CSV with
malformed records (``tests/torch_fixtures/rafo9s/make.py``, rerun here
into a temporary directory) must still produce the committed rafo9s
fixture — the input CSV, trees, JSON files, quarantine part file and
counters byte for byte, ``.npz`` files by arrays and dtypes.  The port's
streamed job over the fixture's CSV (``-Dplatform=cpu``) must give the same
bytes and arrays and the same job counter groups (``Random forest``,
``BadRecords``), reading every block with the native reader, and its
monolithic job must give the same trees, quarantine and published
forest."""

import importlib.util
import json
import os

import numpy as np
import pytest

from avenir_tpu_torch.cli import run as port_run

TESTS = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(os.path.dirname(TESTS), "resource")
FIXTURE = os.path.join(TESTS, "torch_fixtures", "rafo9s")
VERSION = os.path.join("registry", "rafo9s", "v_000001")
TREES = [f"tree_{i}.json" for i in range(9)]
BYTE_FILES = ["train.csv", "part-q-00000", "train_counters.json"] + TREES \
    + [os.path.join(VERSION, f) for f in ("meta.json", "baseline.json",
                                           "quantized.json")]
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


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "rafo9s_make", os.path.join(FIXTURE, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rafo9s"))
    _make_module().make(out)
    return out


def _port_job(d, *extra):
    out, reg = str(d / "model"), str(d / "registry")
    mk = _make_module()
    keys = mk.STREAM_KEYS if "stream" in extra else [
        k for k in mk.STREAM_KEYS if "streaming" not in k]
    assert port_run.main([
        "randomForestBuilder",
        f"-Dconf.path={os.path.join(RES, 'rafo.properties')}",
        f"-Ddtb.feature.schema.file.path="
        f"{os.path.join(RES, 'call_hangup.json')}",
        f"-Ddtb.model.registry.dir={reg}",
        f"-Ddtb.model.name={mk.MODEL_NAME}",
        f"-Ddtb.streaming.checkpoint.dir={d / 'ck'}", *keys,
        "-Dplatform=cpu", os.path.join(FIXTURE, "train.csv"), out]) == 0
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)
    return out, str(d), counters


@pytest.fixture(scope="module")
def port_streamed(tmp_path_factory):
    return _port_job(tmp_path_factory.mktemp("port_stream"), "stream")


@pytest.fixture(scope="module")
def port_monolithic(tmp_path_factory):
    return _port_job(tmp_path_factory.mktemp("port_mono"))


@pytest.mark.parametrize("name", BYTE_FILES)
def test_fixture_file_is_current(regenerated, name):
    assert _read(regenerated, name) == _read(FIXTURE, name)


@pytest.mark.parametrize("name", NPZ_FILES)
def test_fixture_npz_is_current(regenerated, name):
    _assert_npz_equal(os.path.join(regenerated, name),
                      os.path.join(FIXTURE, name))


def test_fixture_quarantines_the_corrupted_records():
    mk = _make_module()
    lines = _read(FIXTURE, "part-q-00000").decode().splitlines()
    assert [int(line.split(",")[0][1:]) for line in lines] == \
        sorted(mk.GARBLED + mk.TRUNCATED)
    counters = json.loads(_read(FIXTURE, "train_counters.json"))
    assert counters["BadRecords"] == {"Malformed": 5, "Quarantined": 5,
                                      "Skipped": 5}
    assert counters["Random forest"]["BaselineRows"] == 4995


@pytest.mark.parametrize("name", TREES + [
    os.path.join(VERSION, f) for f in ("meta.json", "baseline.json",
                                       "quantized.json")])
def test_port_streamed_job_writes_jax_bytes(port_streamed, name):
    out, d, _ = port_streamed
    where = d if name.startswith("registry") else out
    assert _read(where, name) == _read(FIXTURE, name)


@pytest.mark.parametrize("name", NPZ_FILES)
def test_port_streamed_job_writes_jax_arrays(port_streamed, name):
    _assert_npz_equal(os.path.join(port_streamed[1], name),
                      os.path.join(FIXTURE, name))


def test_port_streamed_job_quarantine_counters_and_checkpoints(
        port_streamed):
    out, d, counters = port_streamed
    assert _read(out, "_quarantine", "part-q-00000") == \
        _read(FIXTURE, "part-q-00000")
    want = json.loads(_read(FIXTURE, "train_counters.json"))
    assert {g: counters[g] for g in want} == want
    # one branch encode and one baseline absorb a block of 777 rows
    blocks = -(-4995 // 777)
    assert counters["Dispatches"]["ingest.encode"] == blocks
    assert counters["KernelBackends"] == {
        "baseline.absorb.torch": blocks, "ensemble.vote.torch": 1,
        "forest.level.torch": 4, "quantized.vote.torch": 1}
    # steps every 2 blocks and the ingest-complete one; the newest 3 kept
    assert sorted(os.listdir(os.path.join(d, "ck"))) == [
        "step_00000004", "step_00000006", "step_00000007"]


def test_port_streamed_job_reads_every_block_natively(port_streamed):
    """rafo9s is reproduced with the native reader: the 7 ingest blocks
    (777 source rows each, the bad records dropped inside) and the
    quantize publish's head sample, all native, none Python."""
    counters = port_streamed[2]
    assert counters["IngestReaders"] == {"native.blocks": 8,
                                         "native.rows": 2 * 4995}


def test_port_monolithic_job_records_why_it_read_python(port_monolithic):
    """The monolithic load under the quarantine policy reads with the
    Python reader, as the reference does (the policy needs the raw lines);
    the ledger says so.  The quantize publish's sample reads the whole
    table already loaded."""
    assert port_monolithic[2]["IngestReaders"] == {
        "python.blocks": 1, "python.rows": 4995, "python.policy": 1}


@pytest.mark.parametrize("name", TREES + [
    os.path.join(VERSION, f) for f in ("meta.json", "baseline.json",
                                       "quantized.json")])
def test_port_monolithic_job_writes_the_same_bytes(port_monolithic, name):
    out, d, counters = port_monolithic
    where = d if name.startswith("registry") else out
    assert _read(where, name) == _read(FIXTURE, name)
    assert _read(out, "_quarantine", "part-q-00000") == \
        _read(FIXTURE, "part-q-00000")
    want = json.loads(_read(FIXTURE, "train_counters.json"))
    assert {g: counters[g] for g in want} == want
