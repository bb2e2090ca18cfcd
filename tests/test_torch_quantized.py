"""Int8 quantized serving, port against the JAX package on the CPU.

* The kernel function: ``quantized_vote_torch`` (the plain version of the
  int8 vote kernel, ``kernels/vote.py``) gives int32 votes IDENTICAL to
  ``avenir_tpu.serving.quantized._quantized_vote_body`` and to the Pallas
  ``quantized_vote`` in interpret mode, on random int8 forests with the
  -128/127 sentinels in values and thresholds, codes of -1 and >= C.  The
  CUDA kernel runs only on the card (chip_smoke.py); its packed int8 form
  is held against the same oracle through a numpy transcription of the
  kernel's loops.
* Quantizing: ``quantize_ensemble`` and ``quantize_rows`` give arrays equal
  to the JAX package's on the same trees and rows, nonfinite values
  included.
* Publishing: each package loads the other's sidecar; the measured
  mismatch is equal; a budget below it refuses to publish.
* Serving: the quantized ``ForestPredictor`` answers what the JAX one
  does, over at least 4x fewer H2D bytes; the four warn-and-serve-float
  cases; a hot swap serves the new version's sidecar.

Tolerance: exact everywhere (int32 votes, int8 bins, byte-compared JSON).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.core.table import load_csv as jax_load_csv
from avenir_tpu.models.forest import EnsembleModel as JaxEnsemble
from avenir_tpu.models.tree import DecisionPathList as JaxPathList
from avenir_tpu.models.tree import DecisionTreeModel as JaxTreeModel
from avenir_tpu.ops.pallas.vote import quantized_vote as pallas_quantized_vote
from avenir_tpu.serving import quantized as jq
from avenir_tpu.serving.predictor import make_predictor as jax_make_predictor
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv
from avenir_tpu_torch.kernels import vote
from avenir_tpu_torch.models.forest import EnsembleModel
from avenir_tpu_torch.models.tree import DecisionPathList, DecisionTreeModel
from avenir_tpu_torch.serving import quantized as pq
from avenir_tpu_torch.serving.predictor import make_predictor
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.serving.service import PredictionService
from avenir_tpu_torch.utils.tracing import transfer_ledger
from avenir_tpu_torch.weights import quantized_from_arrays

TESTS = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(os.path.dirname(TESTS), "resource")
SCHEMA = os.path.join(RES, "call_hangup.json")
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
REQUESTS = os.path.join(RAFO9, "requests.csv")

QFIELDS = ("q_lo", "q_hi", "num_r", "cat_m", "cat_r", "cls_oh", "wvec",
           "scale", "fmin")


# --------------------------------------------------------------------------
# the kernel function
# --------------------------------------------------------------------------

def _qstacked(rng, T, P, F, C, K, n):
    """A random int8 forest in the QuantizedForest layout (real paths, the
    always-match sentinel, never-match pad paths with q_lo = 127) and n
    int8 request rows.  Thresholds and values take the -128 / 127
    sentinels; codes take -1 and values >= C."""
    q_lo = rng.integers(-20, 20, (T, P, F)).astype(np.int8)
    q_hi = (q_lo.astype(np.int16)
            + rng.integers(0, 16, (T, P, F))).clip(-128, 127).astype(np.int8)
    q_lo[rng.random((T, P, F)) < 0.1] = -128
    q_hi[rng.random((T, P, F)) < 0.1] = 127
    num_r = rng.random((T, P, F)) < 0.4
    cat_m = rng.random((T, P, F, C)) < 0.6
    cat_r = rng.random((T, P, F)) < 0.4
    cls_oh = np.zeros((T, P, K), np.uint8)
    cls_oh[np.arange(T)[:, None], np.arange(P)[None, :],
           rng.integers(0, K, (T, P))] = 1
    for t in range(T):
        real = int(rng.integers(1, P))
        q_lo[t, real], q_hi[t, real] = -128, 127
        num_r[t, real] = cat_r[t, real] = False
        q_lo[t, real + 1:], q_hi[t, real + 1:] = 127, -128
        num_r[t, real + 1:], cat_r[t, real + 1:] = True, False
        cls_oh[t, real + 1:] = 0
    wvec = rng.integers(-3, 6, T).astype(np.float32)
    qv = rng.integers(-24, 24, (n, F)).astype(np.int8)
    qv[rng.random((n, F)) < 0.06] = -128      # NaN / -inf sentinel
    qv[rng.random((n, F)) < 0.06] = 127       # +inf, top cell
    qc = rng.integers(-1, C + 3, (n, F)).astype(np.int8)
    return (q_lo, q_hi, num_r, cat_m, cat_r, cls_oh, wvec), qv, qc


def _jax_qvote(stacked, qv, qc, min_odds):
    return np.asarray(jq._quantized_vote_body(
        jnp.asarray(qv), jnp.asarray(qc),
        *[jnp.asarray(a) for a in stacked], jnp.float32(min_odds)))


def _torch_qvote(stacked, qv, qc, min_odds):
    return vote.quantized_vote_torch(
        torch.from_numpy(qv), torch.from_numpy(qc),
        *[torch.from_numpy(a) for a in stacked], min_odds).numpy()


QSHAPES = {"rafo": (9, 17, 4, 4, 3), "K5": (5, 9, 6, 7, 5)}


@pytest.mark.parametrize("shape", list(QSHAPES), ids=list(QSHAPES))
@pytest.mark.parametrize("n", [0, 1, 7, 300])
@pytest.mark.parametrize("min_odds", [1.0, 1.5])
def test_plain_quantized_vote_matches_jax_body(shape, n, min_odds):
    rng = np.random.default_rng(n * 7 + int(min_odds * 2)
                                + list(QSHAPES).index(shape))
    stacked, qv, qc = _qstacked(rng, *QSHAPES[shape], n)
    got = _torch_qvote(stacked, qv, qc, min_odds)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, _jax_qvote(stacked, qv, qc, min_odds))


@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_plain_quantized_vote_matches_pallas_interpret(n):
    rng = np.random.default_rng(100 + n)
    stacked, qv, qc = _qstacked(rng, *QSHAPES["rafo"], n)
    for min_odds in (1.0, 1.5):
        want = np.asarray(pallas_quantized_vote(
            jnp.asarray(qv), jnp.asarray(qc),
            *[jnp.asarray(a) for a in stacked], jnp.float32(min_odds),
            interpret=True))
        np.testing.assert_array_equal(
            _torch_qvote(stacked, qv, qc, min_odds), want)


def test_sentinels_and_vetoes_are_exercised():
    """The random inputs really hit the veto, the pad paths and both
    value sentinels on restricted features."""
    rng = np.random.default_rng(3)
    stacked, qv, qc = _qstacked(rng, 9, 17, 4, 4, 3, 300)
    out = _torch_qvote(stacked, qv, qc, 1.5)
    assert (out == 3).any() and (out < 3).any()
    assert (qv == -128).any() and (qv == 127).any()
    assert (stacked[0] == 127).any() and (qc >= 4).any() and (qc < 0).any()


def _kernel_loops(qv, qc, stacked, min_odds):
    """csrc/vote.cu's per-row loops (the int8 form) transcribed to numpy
    over the packed form prepare_quantized_vote_model uploads for CUDA
    devices; compares promote int8 to int, as the kernel's do."""
    q_lo, q_hi, num_r, cat_m, cat_r, cls_oh, w = stacked
    T, P, F, C = cat_m.shape
    K = cls_oh.shape[2]
    flags, catw, cls = vote.kernel_form(num_r, cat_m, cat_r,
                                        cls_oh.astype(np.float32))
    catw = catw.view(np.uint32)
    out = np.zeros(len(qv), np.int32)
    for r in range(len(qv)):
        tally = np.zeros(K, np.float32)
        for t in range(T):
            hit = 0
            for q in range(P):
                ok = True
                for f in range(F):
                    if not ok:
                        break
                    if flags[t, q, f] & 1:
                        x = int(qv[r, f])
                        ok = int(q_lo[t, q, f]) < x <= int(q_hi[t, q, f])
                    if ok and flags[t, q, f] & 2:
                        c = int(qc[r, f])
                        s = min(c, C - 1)
                        ok = c >= 0 and bool(
                            (int(catw[t, q, f, s >> 5]) >> (s & 31)) & 1)
                if ok:
                    hit = q
                    break
            if cls[t, hit] >= 0:
                tally[cls[t, hit]] += w[t]
        best = int(np.argmax(tally))
        second = max([tally[k] for k in range(K) if k != best],
                     default=np.float32(-np.inf))
        veto = np.float32(min_odds) > 1 and (
            tally[best] / np.maximum(np.float32(second), np.float32(1e-12))
            <= np.float32(min_odds))
        out[r] = K if veto else best
    return out


def test_kernel_packed_int8_form_matches_jax_body():
    rng = np.random.default_rng(11)
    stacked, qv, qc = _qstacked(rng, 9, 17, 4, 4, 3, 60)
    for min_odds in (1.0, 1.5):
        np.testing.assert_array_equal(
            _kernel_loops(qv, qc, stacked, min_odds),
            _jax_qvote(stacked, qv, qc, min_odds))


def test_smem_count_of_the_int8_form():
    """Thresholds take 1 byte a slot in int8 (4 in float32): the rafo
    forest stages 4,932 bytes; a wide forest exceeds the 48 KB budget and
    takes the global-memory path."""
    rng = np.random.default_rng(12)
    stacked, _, _ = _qstacked(rng, 9, 17, 4, 4, 3, 1)
    qm = vote.prepare_quantized_vote_model(*stacked, "cpu")
    assert qm.quantized and qm.lo.dtype == torch.int8
    tpf = 9 * 17 * 4
    assert qm.smem_bytes() == tpf * (2 + 1 + 4) + 9 * 17 * 4 + 9 * 4 == 4932
    fm = vote.prepare_vote_model(stacked[0].astype(np.float32),
                                 stacked[1].astype(np.float32),
                                 *stacked[2:5],
                                 stacked[5].astype(np.float32), stacked[6],
                                 "cpu")
    assert not fm.quantized
    assert fm.smem_bytes() - qm.smem_bytes() == tpf * 6
    wide, _, _ = _qstacked(rng, 64, 257, 16, 16, 8, 1)
    assert vote.prepare_quantized_vote_model(*wide, "cpu").smem_bytes() \
        > vote.SMEM_LIMIT


def test_wrapper_on_cpu_tensors_runs_plain_version():
    rng = np.random.default_rng(5)
    stacked, qv, qc = _qstacked(rng, 9, 17, 4, 4, 3, 50)
    model = vote.prepare_quantized_vote_model(*stacked, "cpu")
    assert model.cls is None            # kernel form is built for CUDA only
    before = vote.quantized_launches
    got = vote.quantized_vote(torch.from_numpy(qv), torch.from_numpy(qc),
                              model, 1.5).numpy()
    assert vote.quantized_launches == before
    np.testing.assert_array_equal(got, _jax_qvote(stacked, qv, qc, 1.5))
    with pytest.raises(ValueError, match="int8 form"):
        vote.ensemble_vote(torch.from_numpy(qv), torch.from_numpy(qc),
                           model, 1.5)
    with pytest.raises(ValueError, match="int8 q_lo"):
        vote.prepare_quantized_vote_model(
            stacked[0].astype(np.int16), *stacked[1:], "cpu")


# --------------------------------------------------------------------------
# quantizing
# --------------------------------------------------------------------------

def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _tree_json(idx):
    return [_read(os.path.join(RAFO9, f"tree_{i}.json")).decode()
            for i in idx]


def _ensembles(idx=range(9), weights=None):
    """The rafo9 trees as a JAX and a port EnsembleModel (port on the
    CPU), with their schemas."""
    js, ps = JaxSchema.load(SCHEMA), FeatureSchema.load(SCHEMA)
    texts = _tree_json(idx)
    jens = JaxEnsemble([JaxTreeModel(JaxPathList.from_json(t), js)
                        for t in texts], weights=weights, require_odd=False)
    pens = EnsembleModel([DecisionTreeModel(DecisionPathList.from_json(t),
                                            ps, device="cpu")
                          for t in texts], weights=weights,
                         require_odd=False, device="cpu")
    return jens, pens, js, ps


def _assert_qf_equal(got, want):
    for k in QFIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.classes == want.classes
    for k in ("min_odds", "budget", "mismatch"):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("with_schema", [True, False])
def test_quantize_ensemble_matches_jax(with_schema):
    jens, pens, js, ps = _ensembles()
    want = jq.quantize_ensemble(jens, js if with_schema else None,
                                budget=0.02)
    got = pq.quantize_ensemble(pens, ps if with_schema else None,
                               budget=0.02)
    _assert_qf_equal(got, want)
    assert got.q_lo.shape == (9, 17, 4) and got.cls_oh.dtype == np.uint8


def test_quantize_refuses_what_jax_refuses():
    jens, pens, js, ps = _ensembles(range(3), weights=[1.0, 0.5, 2.0])
    with pytest.raises(ValueError, match="no stacked device form"):
        jq.quantize_ensemble(jens, js)
    with pytest.raises(ValueError, match="no stacked device form"):
        pq.quantize_ensemble(pens, ps)


def test_quantize_rows_matches_jax_with_nonfinite_values():
    jens, pens, js, ps = _ensembles()
    want_qf = jq.quantize_ensemble(jens, js)
    got_qf = pq.quantize_ensemble(pens, ps)
    vals, codes = pens.models[0].matrix.feature_arrays(load_csv(REQUESTS, ps))
    F = vals.shape[1]
    special = np.array([[np.inf] * F, [-np.inf] * F, [np.nan] * F,
                        [0.0] * F, [1e9] * F, [-1e9] * F])
    vals = np.concatenate([vals, special])
    codes = np.concatenate([codes, np.array([[-5] * F, [-1] * F, [0] * F,
                                             [3] * F, [200] * F,
                                             [127] * F], np.int32)])
    got = got_qf.quantize_rows(vals, codes)
    want = want_qf.quantize_rows(vals, codes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    qv = got[0]
    assert (qv[-6] == 127).all()     # +inf: top cell, not the sentinel
    assert (qv[-5] == -128).all()    # -inf: never matches a strict > lo
    assert (qv[-4] == -128).all()    # NaN: never matches


# --------------------------------------------------------------------------
# publishing
# --------------------------------------------------------------------------

def _published(tmp_path, idx=range(9)):
    """The same trees published as v1 by each package, with a sample
    table of the fixture requests in each package's encoding."""
    texts = _tree_json(idx)
    jreg = JaxRegistry(str(tmp_path / "j"))
    preg = ModelRegistry(str(tmp_path / "p"))
    js, ps = JaxSchema.load(SCHEMA), FeatureSchema.load(SCHEMA)
    jtrees = [JaxPathList.from_json(t) for t in texts]
    ptrees = [DecisionPathList.from_json(t) for t in texts]
    assert jreg.publish("m", jtrees, schema=js) == 1
    assert preg.publish("m", ptrees, schema=ps) == 1
    return (jreg, jtrees, js, jax_load_csv(REQUESTS, js)), \
        (preg, ptrees, ps, load_csv(REQUESTS, ps))


def test_publish_round_trip_between_packages(tmp_path):
    (jreg, jtrees, js, jtab), (preg, ptrees, ps, ptab) = _published(tmp_path)
    jinfo = jq.publish_quantized(jreg, "m", 1, jtrees, js, jtab, budget=0.02)
    pinfo = pq.publish_quantized(preg, "m", 1, ptrees, ps, ptab, budget=0.02,
                                 device="cpu")
    assert pinfo == jinfo and 0.0 < pinfo["mismatch"] <= 0.02
    for f in ("meta.json", pq.QUANTIZED_JSON):
        assert _read(os.path.join(preg.version_dir("m", 1), f)) == \
            _read(os.path.join(jreg.version_dir("m", 1), f))
    assert preg.is_intact("m", 1) and JaxRegistry(preg.base_dir).is_intact(
        "m", 1)
    # each package reads the other's sidecar
    from_port = jq.load_quantized(JaxRegistry(preg.base_dir), "m", 1)
    from_jax = pq.load_quantized(ModelRegistry(jreg.base_dir), "m", 1)
    _assert_qf_equal(from_jax, pq.load_quantized(preg, "m", 1))
    for k in QFIELDS:
        np.testing.assert_array_equal(getattr(from_port, k),
                                      getattr(from_jax, k))
    assert from_port.mismatch == from_jax.mismatch == jinfo["mismatch"]
    # the carry-over helper builds the same object from the JAX fields
    _assert_qf_equal(quantized_from_arrays(**dataclasses.asdict(from_port)),
                     from_jax)


def test_publish_refuses_over_budget(tmp_path):
    (jreg, jtrees, js, jtab), (preg, ptrees, ps, ptab) = _published(
        tmp_path, range(3))
    meta_before = _read(os.path.join(preg.version_dir("m", 1), "meta.json"))
    with pytest.raises(ValueError, match="exceeds the pinned"):
        pq.publish_quantized(preg, "m", 1, ptrees, ps, ptab, budget=-1.0,
                             device="cpu")
    with pytest.raises(ValueError, match="exceeds the pinned"):
        jq.publish_quantized(jreg, "m", 1, jtrees, js, jtab, budget=-1.0)
    with pytest.raises(FileNotFoundError):
        preg.read_sidecar("m", 1, pq.QUANTIZED_JSON)
    assert _read(os.path.join(preg.version_dir("m", 1), "meta.json")) \
        == meta_before
    assert preg.is_intact("m", 1)
    assert not [f for f in os.listdir(preg.version_dir("m", 1))
                if f.startswith("quantized")]


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _rows(n):
    with open(REQUESTS) as fh:
        return [line.split(",") for line in fh.read().splitlines()[:n]]


def test_quantized_predictor_matches_jax_and_ships_4x_fewer_bytes(tmp_path):
    (jreg, jtrees, js, jtab), (preg, ptrees, ps, ptab) = _published(tmp_path)
    jq.publish_quantized(jreg, "m", 1, jtrees, js, jtab)
    rows = _rows(700)
    want = jax_make_predictor(jreg.load("m"), quantized=True).warm() \
        .predict_rows(rows)
    loaded = ModelRegistry(jreg.base_dir).load("m")
    pf = make_predictor(loaded, device="cpu")
    pqp = make_predictor(loaded, device="cpu", quantized=True)
    assert pqp.quantized is not None
    with transfer_ledger() as led_f:
        ref = pf.predict_rows(rows)
    with transfer_ledger() as led_q:
        got = pqp.predict_rows(rows)
    assert got == want
    assert got != ref                # the int8 grid does move some rows
    assert sum(a != b for a, b in zip(got, ref)) / len(rows) <= 0.01
    assert led_f.h2d_bytes >= 4 * led_q.h2d_bytes > 0
    kb = led_q.backend_snapshot()
    assert kb["serve.predict.quantized"] == 2       # two 512-row buckets
    assert kb["quantized.vote.torch"] == 2
    assert not [k for k in kb if k.startswith(("serve.predict.torch",
                                               "ensemble.vote"))]


def _float_reference(loaded, rows):
    return make_predictor(loaded, device="cpu").predict_rows(rows)


def test_single_tree_warns_and_serves_float(tmp_path):
    (_, _, _, _), (preg, ptrees, ps, ptab) = _published(tmp_path, range(1))
    pq.publish_quantized(preg, "m", 1, ptrees, ps, ptab, device="cpu")
    loaded = preg.load("m")
    rows = _rows(40)
    with pytest.warns(RuntimeWarning, match="single-tree"):
        p = make_predictor(loaded, device="cpu", quantized=True)
    assert p.quantized is None
    assert p.predict_rows(rows) == _float_reference(loaded, rows)


def test_missing_sidecar_warns_and_serves_float(tmp_path):
    (_, _, _, _), (preg, _, _, _) = _published(tmp_path)
    loaded = preg.load("m")
    rows = _rows(40)
    with pytest.warns(RuntimeWarning, match="no quantized sidecar"):
        p = make_predictor(loaded, device="cpu", quantized=True)
    assert p.quantized is None
    assert p.predict_rows(rows) == _float_reference(loaded, rows)


def test_torn_sidecar_warns_and_serves_float(tmp_path):
    (_, _, _, _), (preg, ptrees, ps, ptab) = _published(tmp_path)
    pq.publish_quantized(preg, "m", 1, ptrees, ps, ptab, device="cpu")
    loaded = preg.load("m")
    npz = os.path.join(preg.version_dir("m", 1), pq.QUANTIZED_NPZ)
    data = _read(npz)
    with open(npz, "wb") as fh:          # a dying node's partial copy-in
        fh.write(data[:len(data) // 2])
    assert not preg.is_intact("m", 1)
    rows = _rows(40)
    with pytest.warns(RuntimeWarning, match="torn or unreadable"):
        p = make_predictor(loaded, device="cpu", quantized=True)
    assert p.quantized is None
    assert p.predict_rows(rows) == _float_reference(loaded, rows)


def test_class_order_mismatch_warns_and_serves_float(tmp_path):
    (_, _, _, _), (preg, ptrees, ps, ptab) = _published(tmp_path)
    _, pens, _, _ = _ensembles()
    qf = pq.quantize_ensemble(pens, ps)
    qf.classes = list(reversed(qf.classes))
    preg.add_sidecar("m", 1, qf.to_sidecar())
    loaded = preg.load("m")
    rows = _rows(40)
    with pytest.warns(RuntimeWarning, match="class order"):
        p = make_predictor(loaded, device="cpu", quantized=True)
    assert p.quantized is None
    assert p.predict_rows(rows) == _float_reference(loaded, rows)


def test_prediction_service_hot_swap_serves_new_sidecar(tmp_path):
    (_, _, _, _), (preg, ptrees, ps, ptab) = _published(tmp_path)
    pq.publish_quantized(preg, "m", 1, ptrees, ps, ptab, device="cpu")
    svc = PredictionService(registry=preg, model_name="m", quantized=True,
                            device="cpu", warm=False)
    assert svc.version == 1 and svc.predictor.quantized is not None
    assert svc.predictor.quantized.q_lo.shape[0] == 9
    v2 = preg.publish("m", ptrees[:3], schema=ps)
    pq.publish_quantized(preg, "m", v2, ptrees[:3], ps, ptab, device="cpu")
    assert svc.refresh()
    assert svc.version == v2
    q2 = svc.predictor.quantized
    assert q2 is not None and q2.q_lo.shape[0] == 3
    _assert_qf_equal(q2, pq.load_quantized(preg, "m", v2))
    rows = _rows(30)
    assert svc.predict_rows(rows) == [
        p if p is not None else "ambiguous"
        for p in svc.predictor.predict_rows(rows)]
    with open(os.path.join(preg.version_dir("m", v2), "meta.json")) as fh:
        assert json.load(fh)["files"] == ["arrays.npz", pq.QUANTIZED_JSON,
                                          pq.QUANTIZED_NPZ]
