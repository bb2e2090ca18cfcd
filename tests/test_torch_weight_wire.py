"""The forest's bootstrap-weight wire (``models/tree.py``
``weights_to_device``), port against the JAX package on the CPU: the
narrowest wire that holds the largest weight — two trees a byte while
``w_max < 16`` (T > 1), uint8, uint16, float32 — unpacks to the same
(n, T) weights, records the bytes it uploaded in the ledger, and gives the
trees of the JAX package's build at odd and even T."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.core.table import ColumnarTable as JaxTable
from avenir_tpu.models.forest import ForestParams as JaxForestParams
from avenir_tpu.models.forest import _unpack_weights4
from avenir_tpu.models.forest import build_forest as jax_build_forest
from avenir_tpu.parallel.mesh import MeshContext

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import ColumnarTable
from avenir_tpu_torch.models import forest as pforest
from avenir_tpu_torch.models.tree import unpack_weights4, weights_to_device
from avenir_tpu_torch.utils.tracing import transfer_ledger

SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "color", "ordinal": 1, "dataType": "categorical",
     "feature": True, "maxSplit": 3, "cardinality": ["r", "g", "b", "y"]},
    {"name": "age", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "splitScanInterval": 20, "maxSplit": 3},
    {"name": "score", "ordinal": 3, "dataType": "double", "feature": True,
     "min": 0.0, "max": 1.0, "splitScanInterval": 0.25},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["yes", "no"]},
]}
N = 600

# wire -> (the w_max that selects it, bytes a row at T trees)
WIRES = {"4bit": (15.0, lambda T: -(-T // 2)), "uint8": (255.0, lambda T: T),
         "uint16": (65535.0, lambda T: 2 * T),
         "float32": (65536.0, lambda T: 4 * T)}


def _tables(seed=3):
    rng = np.random.default_rng(seed)
    color = rng.integers(0, 4, N).astype(np.int32)
    age = rng.integers(0, 100, N).astype(np.float64)
    score = rng.random(N)
    label = np.where(((age > 45) ^ (color == 2)) | (rng.random(N) < 0.15),
                     0, 1).astype(np.int32)
    cols = {1: color, 2: age, 3: score, 4: label}
    return (ColumnarTable(schema=FeatureSchema.from_dict(SCHEMA), n_rows=N,
                          columns={k: v.copy() for k, v in cols.items()}),
            JaxTable(schema=JaxSchema.from_dict(SCHEMA), n_rows=N,
                     columns={k: v.copy() for k, v in cols.items()}))


def _params(T, rate=100.0):
    ours = pforest.ForestParams(num_trees=T, seed=5)
    ref = JaxForestParams(num_trees=T, seed=5)
    kw = dict(max_depth=3, sub_sampling="withReplace",
              sub_sampling_rate=rate)
    return (replace(ours, tree=replace(ours.tree, **kw)),
            replace(ref, tree=replace(ref.tree, **kw)))


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("T", [1, 2, 7, 8])
def test_wire_round_trip_and_bytes(wire, T):
    """Integral weights below each wire's cap come back exact as the
    level histogram's tensor (uint8 for the byte wires, float32 above),
    and the ledger records the uploaded bytes: ceil(T/2) a row for the
    4-bit wire (T > 1), T for uint8, 2T for uint16, 4T for float32."""
    w_max, row_bytes = WIRES[wire]
    rng = np.random.default_rng(T)
    w = rng.integers(0, int(w_max) + 1, size=(37, T)).astype(np.float32)
    w[0, 0] = w_max
    with transfer_ledger() as led:
        got = weights_to_device(w, float(w.max()), "cpu")
    np.testing.assert_array_equal(got.numpy().astype(np.float64), w)
    assert got.is_contiguous() and tuple(got.shape) == (37, T)
    assert got.dtype == (torch.uint8 if w_max < 256 else torch.float32)
    assert led.h2d_bytes == 37 * row_bytes(T)   # T = 1 ships one byte


@pytest.mark.parametrize("T", [2, 3, 9, 10])
def test_unpack_equals_the_reference_unpack(T):
    rng = np.random.default_rng(T)
    w = rng.integers(0, 16, size=(50, T + T % 2)).astype(np.uint8)
    packed = w[:, 0::2] | (w[:, 1::2] << 4)
    got = unpack_weights4(torch.from_numpy(np.ascontiguousarray(packed)), T)
    want = np.asarray(_unpack_weights4(packed))[:, :T]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), w[:, :T])


@pytest.mark.parametrize("T", [3, 4, 9])
def test_every_wire_gives_the_reference_trees(monkeypatch, T):
    """The same bootstrap weights shipped on each wire (the cap that
    selects it forced) give the trees of the JAX package's build, whose
    own wire is 4-bit here (bootstrap counts at rate 100 stay below 16)."""
    ours_t, ref_t = _tables()
    ours_p, ref_p = _params(T)
    want = [m.to_json() for m in jax_build_forest(ref_t, ref_p,
                                                  MeshContext())]
    natural = []

    def spy(w, w_max, device):
        natural.append(w_max)
        return weights_to_device(w, w_max, device)
    monkeypatch.setattr(pforest, "weights_to_device", spy)
    with transfer_ledger() as led:
        got = [m.to_json() for m in pforest.build_forest(ours_t, ours_p,
                                                         device="cpu")]
    assert got == want and natural[0] < 16
    assert led.h2d_bytes >= N * -(-T // 2)
    for wire, (w_max, _) in WIRES.items():
        monkeypatch.setattr(pforest, "weights_to_device",
                            lambda w, _m, device, cap=w_max:
                            weights_to_device(w, cap, device))
        assert [m.to_json() for m in pforest.build_forest(
            ours_t, ours_p, device="cpu")] == want, wire


@pytest.mark.parametrize("T", [4, 5])
def test_heavy_bootstrap_takes_the_byte_wire(monkeypatch, T):
    """At a 1,500% sampling rate the counts pass 15: the uint8 wire, T
    bytes a row, and still the reference's trees."""
    ours_t, ref_t = _tables(seed=8)
    ours_p, ref_p = _params(T, rate=1500.0)
    want = [m.to_json() for m in jax_build_forest(ref_t, ref_p,
                                                  MeshContext())]
    seen = []

    def spy(w, w_max, device):
        seen.append(w_max)
        return weights_to_device(w, w_max, device)
    monkeypatch.setattr(pforest, "weights_to_device", spy)
    with transfer_ledger() as led:
        got = [m.to_json() for m in pforest.build_forest(ours_t, ours_p,
                                                         device="cpu")]
    assert 16 <= seen[0] < 256
    assert got == want
    assert led.h2d_bytes >= N * T
