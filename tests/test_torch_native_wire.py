"""The port's native serving codec (``avenir_tpu_torch/io/native_wire.py``
over its own ``serve_native.cpp``) on the CPU: the port's native plane,
the port's Python plane and the JAX package's Python plane give the same
replies, BadRequests and warnings; the wire grammar of
``telemetry/reqtrace.py`` and ``serving/quantized.py`` agrees with the
reference's.

Held to, exactly: replies in order, counters and warning texts of
``process_batch`` on the rafo9q forest (float and int8) over batches of
clean, traced, deadline and malformed messages; a hypothesis fuzz over
random schemas, delimiters and messages (``tests/test_native_wire_fuzz.py``'s
generators, the reference's Python plane as a third party); the codec's
prepared tables equal to ``Predictor.prepare_rows``' (the port's prepared
form); ``encode_lpush`` equal to ``_encode_command``; a failed ``g++``
build raises ``NativeBuildError``.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.serving import quantized as jq
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry
from avenir_tpu.serving.service import PredictionService as JaxService
from avenir_tpu.telemetry import reqtrace as jrt
from tests import test_native_wire_fuzz as ref_fuzz

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.io import native_csv, native_wire
from avenir_tpu_torch.io.respq import _encode_command
from avenir_tpu_torch.runtime import set_default_device
from avenir_tpu_torch.serving import quantized as pq
from avenir_tpu_torch.serving.predictor import Predictor
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.serving.service import PredictionService
from avenir_tpu_torch.telemetry import reqtrace as prt

TESTS = os.path.dirname(os.path.abspath(__file__))
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
RAFO9Q_REG = os.path.join(TESTS, "torch_fixtures", "rafo9q", "registry")


@pytest.fixture(autouse=True)
def cpu_default():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _records(n, start=0):
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        return [line.rstrip("\n") for line in fh][start:start + n]


def _run(svc, msgs):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = svc.process_batch(list(msgs))
    return (out, svc.counters.get("Serving", "BadRequests"),
            svc.counters.get("Serving", "Requests"),
            sorted(str(x.message) for x in w))


def _batches(qf_lines):
    recs = _records(120)
    clean = [f"predict,{i},{r}" for i, r in enumerate(recs)]
    mixed = list(clean[:40])
    mixed[5] = f"predict,5,t=123:1,{recs[5]}"
    mixed[6] = f"predict,6,t=124:0,{recs[6]}"
    mixed += qf_lines[:20] + ["reload", "bogus,1", "predict"]
    malformed = clean[:10] + ["predict,77,K1,billing",
                              "predictq,78,4,1,2,3,4,5,6,7,x"]
    deadline = clean[:10] + [f"predict,90,d=1,{recs[9]}"]
    lexotic = clean[:10] + ["predict,91,K9,billing,1_0,1,0,T"]
    return {"clean": clean, "mixed": mixed, "malformed": malformed,
            "deadline": deadline, "lexotic": lexotic,
            "q_only": qf_lines[:70]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("reg")
    shutil.copytree(RAFO9Q_REG, d / "registry")
    reg = str(d / "registry")
    set_default_device("cpu")
    try:
        qf = pq.load_quantized(ModelRegistry(reg), "rafo9", 1)
        from avenir_tpu_torch.core.table import encode_rows
        from avenir_tpu_torch.models.tree import (DecisionTreeModel,
                                                  FeatureCache)
        fs = FeatureSchema.load(os.path.join(TESTS, "..", "resource",
                                             "call_hangup.json"))
        loaded = ModelRegistry(reg).load("rafo9", 1)
        rows = [r.split(",") for r in _records(70, 200)]
        vals, codes = FeatureCache().host(
            DecisionTreeModel(loaded.model[0], fs).matrix,
            encode_rows(rows, fs))
        qv, qc = qf.quantize_rows(vals, codes)
        lines = pq.wire_encode_rows(range(500, 570), qv, qc)
    finally:
        set_default_device(None)
    return reg, _batches(lines)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("batch", ["clean", "mixed", "malformed",
                                   "deadline", "lexotic", "q_only"])
def test_three_planes_agree_on_the_rafo9_forest(served, quantized, batch):
    reg, batches = served
    msgs = batches[batch]
    runs = []
    for cls, r, plane in ((PredictionService, ModelRegistry, "on"),
                          (PredictionService, ModelRegistry, "off"),
                          (JaxService, JaxRegistry, "off")):
        svc = cls(registry=r(reg), model_name="rafo9", quantized=quantized,
                  wire_native=plane)
        runs.append(_run(svc, msgs))
        if cls is PredictionService and plane == "on":
            pb = svc._wire_codec.parse(msgs)
            # clean and mixed batches really take the native plane; a
            # short row, a malformed predictq, a deadline or a numeric
            # float() accepts and C does not send the batch to Python
            assert (pb is None) == (batch in ("malformed", "deadline",
                                              "lexotic"))
    assert runs[0] == runs[1] == runs[2]
    if batch == "q_only" and quantized:
        assert all(not x.endswith(",error") for x in runs[0][0])


class DigestPredictor(Predictor):
    """The reference fuzz's digest predictor over the port's Predictor:
    the label digests the encoded columns, so any assembler divergence
    changes a reply."""

    def __init__(self, schema, buckets=(1, 8, 64), delim=",", q_width=0):
        super().__init__(schema, buckets=buckets, delim=delim)
        self._q_width = int(q_width)

    _predict_table = ref_fuzz.DigestPredictor._predict_table

    @property
    def supports_prebinned(self):
        return self._q_width > 0

    @property
    def prebinned_width(self):
        return self._q_width

    predict_prebinned = ref_fuzz.DigestPredictor.predict_prebinned


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_native_plane_matches_python_planes_fuzz(seed):
    rng = np.random.default_rng(seed)
    jschema = ref_fuzz._random_schema(rng)
    delim = str(rng.choice(ref_fuzz.DELIMS))
    q_width = int(rng.choice([0, 2, 5]))
    msgs = ref_fuzz._make_batch(rng, jschema, delim, q_width)
    schema = FeatureSchema.from_dict(jschema.to_dict())
    runs = [_run(PredictionService(
        DigestPredictor(schema, delim=delim, q_width=q_width), warm=False,
        delim=delim, wire_native=mode), msgs) for mode in ("on", "off")]
    runs.append(_run(JaxService(
        ref_fuzz.DigestPredictor(jschema, delim=delim, q_width=q_width),
        warm=False, delim=delim, wire_native="off"), msgs))
    assert runs[0] == runs[1] == runs[2], (seed, delim, q_width)


def test_codec_prepared_form_is_prepare_rows(served):
    """WireCodec.parse's prepared chunks are what Predictor.prepare_rows
    makes (the port's prepared form): same bucket sizes, row counts and
    column arrays, and dispatch_prepared answers the same labels."""
    reg, _ = served
    from avenir_tpu_torch.serving.predictor import make_predictor
    pred = make_predictor(ModelRegistry(reg).load("rafo9", 1),
                          buckets=(1, 8, 64), device="cpu")
    rows = [r.split(",") for r in _records(150)]
    msgs = [f"predict,{i},{','.join(r)}" for i, r in enumerate(rows)]
    codec = native_wire.WireCodec(pred.schema, buckets=pred.buckets)
    pb = codec.parse(msgs)
    assert pb.n_float == 150 and pb.rids == [str(i) for i in range(150)]
    want = pred.prepare_rows(rows)
    assert [(t.n_rows, n) for t, n in pb.prepared] == \
        [(t.n_rows, n) for t, n in want] == [(64, 64), (64, 64), (64, 22)]
    for (a, _), (b, _) in zip(pb.prepared, want):
        assert sorted(a.columns) == sorted(b.columns)
        for k in a.columns:
            assert a.columns[k].dtype == b.columns[k].dtype
            np.testing.assert_array_equal(a.columns[k], b.columns[k])
    assert pred.readback_dispatched(pred.dispatch_prepared(pb.prepared)) \
        == pred.predict_rows(rows)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(values=st.lists(st.text(min_size=0, max_size=12), min_size=1,
                       max_size=20), queue=st.text(min_size=1, max_size=8))
def test_encode_lpush_equals_the_python_encoder(values, queue):
    try:
        want = _encode_command(["LPUSH", queue] + values)
    except UnicodeEncodeError:
        assert native_wire.encode_lpush(queue, values) is None
        return
    got = native_wire.encode_lpush(queue, values)
    if any("\n" in v for v in values):
        assert got is None
    else:
        assert got == want


def test_codec_off_and_unusable_delimiters_take_the_python_plane():
    fs = FeatureSchema.from_dict({"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "x", "ordinal": 1, "dataType": "double", "feature": True}]})
    assert native_wire.WireCodec(fs, delim="::").usable is False
    assert native_wire.WireCodec(fs, delim="\n").usable is False
    svc = PredictionService(DigestPredictor(fs), warm=False,
                            wire_native="off")
    assert svc._wire_codec_for(svc.predictor) is None
    native_wire.set_mode("off")
    try:
        assert native_wire.encode_lpush("q", ["a"]) is None
        assert native_wire.WireCodec(fs).parse(["predict,1,a,1"]) is None
        auto = PredictionService(DigestPredictor(fs), warm=False)
        assert auto._wire_codec_for(auto.predictor) is None
    finally:
        native_wire.set_mode("auto")
    with pytest.raises(ValueError, match="wire_native"):
        PredictionService(DigestPredictor(fs), warm=False,
                          wire_native="maybe")


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native_wire, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native_csv, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_wire, "_lib", None)
    with pytest.raises(native_csv.NativeBuildError,
                       match="native serving codec build failed") as exc:
        native_wire.get_lib()
    assert "missing.cpp" in str(exc.value) and "g++" in str(exc.value)
    fs = FeatureSchema.from_dict({"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "x", "ordinal": 1, "dataType": "double", "feature": True}]})
    svc = PredictionService(DigestPredictor(fs), warm=False,
                            wire_native="on")
    with pytest.raises(native_csv.NativeBuildError):
        svc.process_batch(["predict,1,a,1.5"])
    with pytest.raises(native_csv.NativeBuildError):
        native_wire.encode_lpush("q", ["1,T"])
    off = PredictionService(DigestPredictor(fs), warm=False,
                            wire_native="off")
    assert off.process_batch(["predict,1,a,1.5"]) == \
        [f"1,{DigestPredictor(fs).predict_rows([['a', '1.5']])[0]}"]
    assert not list((tmp_path / "build").glob("*.so"))


WIRE_MESSAGES = [
    "predict,1,a,b", "predict,1,t=5:1,a", "predict,1,t=5:0,a,b",
    "predict,1,t=5:2,a,b", "predict,1,t=x:1,a,b", "predict,1,d=9,a,b",
    "predict,1,t=5:1,d=9,m=forest:3,a", "predict,1,m=a.b-c,x,y",
    "predict,1,m=,x", "predict,1,d=9", "predictq,2,t=1:1,2,1,2,3,4",
    "predict,1,d=1x,a", "predict,1,t=1:1,m=x"]


@pytest.mark.parametrize("msg", WIRE_MESSAGES)
def test_wire_fields_parse_as_the_reference(msg):
    parts = msg.split(",")
    a = prt.split_predict_route(parts)
    b = jrt.split_predict_route(parts)
    assert a[:2] == b[:2] and a[3:] == b[3:]
    assert (a[2] is None) == (b[2] is None)
    if a[2] is not None:
        assert (a[2].rid, a[2].enqueue_us, a[2].wire) == \
            (b[2].rid, b[2].enqueue_us, b[2].wire)
    for tok in parts:
        assert prt.parse_field(tok) == jrt.parse_field(tok)
        assert prt.parse_deadline(tok) == jrt.parse_deadline(tok)
        assert prt.parse_model(tok) == jrt.parse_model(tok)


def test_stamps_match_the_reference(monkeypatch):
    msgs = ["predict,1,a,b", "predict,2,t=5:1,a,b", "predictq,3,2,1,1,0,0",
            "predict,4,d=7,a,b", "stop", "predict,5"]
    monkeypatch.setattr(prt, "now_us", lambda: 1000.0)
    monkeypatch.setattr(jrt, "now_us", lambda: 1000.0)
    assert prt.stamp_deadline(msgs, 2.5) == jrt.stamp_deadline(msgs, 2.5)
    assert prt.stamp_model(msgs, "rafo9:2") == jrt.stamp_model(msgs,
                                                               "rafo9:2")
    assert prt.stamp_deadline(msgs, 0) is msgs
    with pytest.raises(ValueError, match="bad model spec"):
        prt.stamp_model(msgs, "a b")
    prt.set_sample_rate(2)
    jrt.set_sample_rate(2)
    try:
        # head sampling: the Nth un-stamped predict of the batch
        got, want = prt.stamp_values(msgs), jrt.stamp_values(msgs)
        assert sum("t=1000:1" in m for m in got) == \
            sum("t=1000:1" in m for m in want) >= 1
    finally:
        prt.set_sample_rate(0)
        jrt.set_sample_rate(0)
    assert prt.stamp_values(msgs) is msgs


@settings(max_examples=200, deadline=None, derandomize=True)
@given(tokens=st.lists(st.sampled_from(
    ["0", "1", "-1", "127", "-128", "128", "-129", "+1", "-0", "01", "x",
     "", "2", "3", "4", "99"]), min_size=0, max_size=10),
    width=st.integers(0, 4))
def test_predictq_decode_matches_the_reference(tokens, width):
    a = pq.wire_decode_tokens(tokens, width)
    b = jq.wire_decode_tokens(tokens, width)
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.int8
            np.testing.assert_array_equal(x, y)


def test_schema_conversion_is_faithful():
    """The fuzz converts the reference's random schemas with to_dict."""
    rng = np.random.default_rng(3)
    js = ref_fuzz._random_schema(rng)
    assert isinstance(js, JaxSchema)
    assert FeatureSchema.from_dict(js.to_dict()).to_dict() == js.to_dict()
