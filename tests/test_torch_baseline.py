"""The monitor baseline, port against the JAX package on the CPU.

* ``bin_counts_torch`` (the plain version of the bin-counts kernel,
  ``kernels/histogram.py``) gives (R, B) float32 counts EQUAL to
  ``avenir_tpu.ops.histogram.feature_bin_counts`` and to the Pallas
  ``bin_counts`` in interpret mode: codes in [-2, B+2), mask None or
  partial, n = 0.  The CUDA kernel runs only on the card (chip_smoke.py).
* ``compute_baseline`` / ``BaselineBuilder`` give counts and quantiles
  equal to the JAX package's, a byte-identical ``baseline.json`` and equal
  ``baseline.npz`` arrays; each package loads the other's sidecar.
* The host pieces the baseline stands on (``Histogram``,
  ``ColumnarTable.binned_codes``) agree with the JAX package's.

Tolerance: exact (0/1 counts in float32, float64 quantiles from the same
arithmetic, byte-compared JSON).
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.core.table import encode_rows as jax_encode_rows
from avenir_tpu.core.table import load_csv as jax_load_csv
from avenir_tpu.models.tree import DecisionPathList as JaxPathList
from avenir_tpu.monitor import baseline as jb
from avenir_tpu.ops.histogram import feature_bin_counts
from avenir_tpu.ops.pallas.histogram import bin_counts as pallas_bin_counts
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry
from avenir_tpu.stats.histogram import Histogram as JaxHistogram

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import encode_rows, load_csv
from avenir_tpu_torch.kernels import histogram
from avenir_tpu_torch.monitor import baseline as pb
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.stats.histogram import Histogram
from avenir_tpu_torch.weights import baseline_from_arrays

TESTS = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(os.path.dirname(TESTS), "resource")
SCHEMA = os.path.join(RES, "call_hangup.json")
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
REQUESTS = os.path.join(RAFO9, "requests.csv")

# every kind of monitored row: categorical (with unknown values), numeric
# with fixed bins over [min, max], unbounded numeric (bins resolved from
# the first table), bucketWidth-binned numeric, and the class
LOCAL_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "color", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["r", "g", "b"]},
    {"name": "age", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 100},
    {"name": "score", "ordinal": 3, "dataType": "double", "feature": True},
    {"name": "visits", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 0, "max": 50, "bucketWidth": 10},
    {"name": "label", "ordinal": 5, "dataType": "categorical",
     "cardinality": ["yes", "no"]},
]}


# --------------------------------------------------------------------------
# the kernel function
# --------------------------------------------------------------------------

def _codes(rng, n, R, B, masked):
    codes = rng.integers(-2, B + 2, (n, R)).astype(np.int32)
    mask = (rng.random(n) < 0.6) if masked else None
    return codes, mask


def _plain(codes, B, mask):
    return histogram.bin_counts_torch(
        torch.from_numpy(codes), B,
        None if mask is None else torch.from_numpy(mask)).numpy()


BIN_CASES = [(0, 3, 4), (1, 5, 7), (7, 5, 7), (257, 5, 7), (1000, 33, 33),
             (300, 4, 1)]


@pytest.mark.parametrize("case", BIN_CASES,
                         ids=lambda c: "n{}R{}B{}".format(*c))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_plain_bin_counts_matches_jax(case, masked):
    n, R, B = case
    rng = np.random.default_rng(n + R * 3 + B + masked)
    codes, mask = _codes(rng, n, R, B, masked)
    got = _plain(codes, B, mask)
    want = np.asarray(feature_bin_counts(
        jnp.asarray(codes), B, None if mask is None else jnp.asarray(mask)))
    assert got.dtype == np.float32 and got.shape == (R, B)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [(0, 3, 4), (7, 5, 7), (257, 5, 7)],
                         ids=lambda c: "n{}R{}B{}".format(*c))
def test_plain_bin_counts_matches_pallas_interpret(case):
    n, R, B = case
    rng = np.random.default_rng(40 + n)
    for masked in (False, True):
        codes, mask = _codes(rng, n, R, B, masked)
        want = np.asarray(pallas_bin_counts(
            jnp.asarray(codes), B,
            None if mask is None else jnp.asarray(mask), interpret=True))
        np.testing.assert_array_equal(_plain(codes, B, mask), want)


def test_wrapper_on_cpu_chunks_rows_and_launches_nothing(monkeypatch):
    """The wrapper takes BIN_ROWS_MAX rows a call and adds the parts in
    float32; on CPU tensors every part is the plain version."""
    rng = np.random.default_rng(9)
    codes, mask = _codes(rng, 1000, 5, 7, True)
    c, m = torch.from_numpy(codes), torch.from_numpy(mask)
    whole = histogram.bin_counts(c, 7, m)
    before = histogram.bin_counts_launches
    monkeypatch.setattr(histogram, "BIN_ROWS_MAX", 64)
    chunked = histogram.bin_counts(c, 7, m)
    assert histogram.bin_counts_launches == before
    assert torch.equal(whole, chunked)
    np.testing.assert_array_equal(whole.numpy(), _plain(codes, 7, mask))
    empty = histogram.bin_counts(c[:0], 7)
    assert empty.shape == (5, 7) and not empty.any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    c = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        histogram.bin_counts(c.to(torch.int64), 5)
    with pytest.raises(ValueError, match="mask"):
        histogram.bin_counts(c, 5, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="num_bins"):
        histogram.bin_counts(c, 0)


# --------------------------------------------------------------------------
# host pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bins", [[0, 0, 0], [3, 0, 1, 6], [0, 0, 5],
                                  [1, 2, 3, 4, 5, 6, 7]])
def test_histogram_matches_jax(bins):
    ours, ref = Histogram(-2.5, 0.5, bins), JaxHistogram(-2.5, 0.5, bins)
    np.testing.assert_array_equal(ours.cum_distr(), ref.cum_distr())
    for q in (-5, 0, 1, 5, 25, 50, 75, 95, 99, 100, 120):
        assert ours.percentile(q) == ref.percentile(q)


def test_binned_codes_match_jax():
    ours = load_csv(REQUESTS, FeatureSchema.load(SCHEMA))
    ref = jax_load_csv(REQUESTS, JaxSchema.load(SCHEMA))
    for o in (1, 2, 3, 4, 5):
        got, want = ours.binned_codes(o), ref.binned_codes(o)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    local = encode_rows(_local_rows(np.random.default_rng(1), 20),
                        FeatureSchema.from_dict(LOCAL_SCHEMA))
    with pytest.raises(ValueError, match="no finite bin alphabet"):
        local.binned_codes(3)


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------

def _local_rows(rng, n):
    color = rng.choice(["r", "g", "b", "zz"], n, p=[0.4, 0.3, 0.2, 0.1])
    age = rng.integers(-10, 121, n)
    score = rng.normal(3.0, 2.0, n).round(3)
    visits = rng.integers(0, 71, n)
    label = rng.choice(["yes", "no", "maybe"], n, p=[0.5, 0.4, 0.1])
    return [[f"id{i}", color[i], str(age[i]), repr(float(score[i])),
             str(visits[i]), label[i]] for i in range(n)]


def _tables(schema_dict, rows):
    return (encode_rows(rows, FeatureSchema.from_dict(schema_dict)),
            jax_encode_rows(rows, JaxSchema.from_dict(schema_dict)))


def _assert_baselines_equal(got, want):
    assert got.n_rows == want.n_rows
    assert [s.to_dict() for s in got.specs] == \
        [s.to_dict() for s in want.specs]
    assert got.counts.dtype == want.counts.dtype == np.float64
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.quantiles, want.quantiles)
    assert tuple(got.quantile_qs) == tuple(want.quantile_qs)
    g, w = got.to_sidecar(), want.to_sidecar()
    assert g[pb.BASELINE_JSON] == w[jb.BASELINE_JSON]
    with np.load(io.BytesIO(g[pb.BASELINE_NPZ])) as a, \
            np.load(io.BytesIO(w[jb.BASELINE_NPZ])) as b:
        assert sorted(a.files) == sorted(b.files) == ["counts", "quantiles"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_compute_baseline_on_call_hangup_matches_jax():
    ours = pb.compute_baseline(load_csv(REQUESTS, FeatureSchema.load(SCHEMA)),
                               device="cpu")
    ref = jb.compute_baseline(jax_load_csv(REQUESTS, JaxSchema.load(SCHEMA)))
    _assert_baselines_equal(ours, ref)
    assert ours.counts.shape == (5, 7) and ours.n_rows == 2000
    assert ours.counts.sum() == 5 * 2000


@pytest.mark.parametrize("n_bins", [8, 32])
def test_builder_updates_with_mask_match_jax(n_bins):
    rng = np.random.default_rng(n_bins)
    (p1, j1), (p2, j2) = (_tables(LOCAL_SCHEMA, _local_rows(rng, n))
                          for n in (300, 211))
    mask = rng.random(211) < 0.5
    ours = pb.BaselineBuilder(p1.schema, n_bins, device="cpu")
    ref = jb.BaselineBuilder(j1.schema, n_bins)
    ours.update(p1).update(p2, mask=mask)
    ref.update(j1).update(j2, mask=mask)
    got, want = ours.finalize(), ref.finalize()
    _assert_baselines_equal(got, want)
    assert got.n_rows == 300 + int(mask.sum())
    kinds = [s.kind for s in got.specs]
    assert kinds == ["categorical", "numeric", "numeric", "numeric", "class"]


def test_sidecar_loads_in_both_packages(tmp_path):
    with open(os.path.join(RAFO9, "tree_0.json")) as fh:
        text = fh.read()
    js, ps = JaxSchema.load(SCHEMA), FeatureSchema.load(SCHEMA)
    jreg = JaxRegistry(str(tmp_path / "j"))
    preg = ModelRegistry(str(tmp_path / "p"))
    jreg.publish("m", [JaxPathList.from_json(text)], schema=js)
    from avenir_tpu_torch.models.tree import DecisionPathList
    preg.publish("m", [DecisionPathList.from_json(text)], schema=ps)
    ours = pb.compute_baseline(load_csv(REQUESTS, ps), device="cpu")
    ref = jb.compute_baseline(jax_load_csv(REQUESTS, js))
    pb.publish_baseline(preg, "m", 1, ours)
    jb.publish_baseline(jreg, "m", 1, ref)
    for f in ("meta.json", pb.BASELINE_JSON):
        with open(os.path.join(preg.version_dir("m", 1), f), "rb") as a, \
                open(os.path.join(jreg.version_dir("m", 1), f), "rb") as b:
            assert a.read() == b.read(), f
    _assert_baselines_equal(
        pb.load_baseline(ModelRegistry(jreg.base_dir), "m"), ref)
    _assert_baselines_equal(
        ours, jb.load_baseline(JaxRegistry(preg.base_dir), "m", 1))
    with open(os.path.join(preg.version_dir("m", 1), "meta.json")) as fh:
        assert json.load(fh)["files"] == ["arrays.npz", pb.BASELINE_JSON,
                                          pb.BASELINE_NPZ]
    # the carry-over helper builds the same object from the JAX fields
    _assert_baselines_equal(
        baseline_from_arrays([s.to_dict() for s in ref.specs], ref.counts,
                             ref.n_rows, ref.quantile_qs, ref.quantiles),
        ref)
    with pytest.raises(FileNotFoundError):
        pb.load_baseline(preg, "nope")
