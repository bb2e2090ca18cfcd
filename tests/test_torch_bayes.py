"""The port's Naive Bayes library (``avenir_tpu_torch/models/bayes.py``,
``bayes_text.py``), its registry kind and its serving, against the JAX
package on the CPU.  Inputs are seeded numpy draws fed to both packages;
every comparison is exact (model lines byte for byte, count tables array
for array, percents, P(x) and P(x|c) bit for bit):

* train in each wire form (4-bit, uint8, int32) with the valid-prefix
  mask, chunked against one chunk, a chunk above ``1 << 23`` refused;
* predict in each wire form, including values past a bucketed alphabet,
  which skip the feature instead of wrapping into a valid bin;
* the model file round trip; the text mode; the ``bayes`` registry kind
  both ways and ``predictionService`` over it; the entry points' device
  rule (``cuda`` unless asked, which raises here);
* the reference inconsistency the port does not copy: the JAX package's
  float32 moment sums, which drift from the exact integers at scale.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.core.table import encode_rows as jax_encode
from avenir_tpu.models import bayes as jb
from avenir_tpu.models import bayes_text as jbt
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry

from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import encode_rows
from avenir_tpu_torch.models import bayes, bayes_text
from avenir_tpu_torch.serving.predictor import BayesPredictor, make_predictor
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.serving.service import BatchPolicy, PredictionService
from avenir_tpu_torch.weights import bayes_from_arrays, text_bayes_from_arrays

# schemas: (bucketed int fields' bins, unbucketed int fields, classes)
SCHEMAS = {"churnlike": ((4, 10, 5, 3), 0, 2), "gauss": ((5, 4), 2, 3),
           "wide": ((300, 6), 1, 2), "contonly": ((), 2, 2)}


def _schema_dict(name):
    bins, n_cont, C = SCHEMAS[name]
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    for nb in bins:
        o = len(fields)
        fields.append({"name": f"b{o}", "ordinal": o, "dataType": "int",
                       "feature": True, "min": 0, "max": nb * 10 - 1,
                       "bucketWidth": 10})
    for _ in range(n_cont):
        o = len(fields)
        fields.append({"name": f"c{o}", "ordinal": o, "dataType": "int",
                       "feature": True})
    fields.append({"name": "cls", "ordinal": len(fields),
                   "dataType": "categorical",
                   "cardinality": [f"k{c}" for c in range(C)]})
    return {"fields": fields}


def _rows(name, n, seed, far=0.0, unknown=0.0):
    """Seeded records: class-dependent bins and Gaussian values; a share
    ``far`` of bucketed values past the alphabet (some past 255 bins) and
    ``unknown`` of class labels outside the cardinality."""
    bins, n_cont, C = SCHEMAS[name]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        c = int(rng.integers(C))
        r = [f"r{i}"]
        for j, nb in enumerate(bins):
            v = int(np.clip(rng.normal((c + 1) * nb * 10 / (C + 1), nb * 3),
                            0, nb * 10 - 1))
            if rng.random() < far:
                v = int(rng.choice([nb * 10 + 5, nb * 10 + 2700, 999_999]))
            r.append(str(v))
        for j in range(n_cont):
            r.append(str(int(rng.normal(40 + 25 * c, 8 + 3 * j))))
        r.append("zz" if rng.random() < unknown else f"k{c}")
        rows.append(r)
    return rows


def _both(name, rows):
    d = _schema_dict(name)
    js, ts = JaxSchema.from_dict(d), FeatureSchema.from_dict(d)
    return jax_encode(rows, js), encode_rows(rows, ts)


def _port_model(jm, schema):
    return bayes_from_arrays(
        schema, jm.class_values, jm.binned_ordinals, jm.cont_ordinals,
        jm.num_bins, jm.post_counts, jm.class_counts, jm.prior_counts,
        jm.total, jm.cont_post_mean, jm.cont_post_std, jm.cont_prior_mean,
        jm.cont_prior_std)


def _same_model(got, want):
    assert got.to_lines() == want.to_lines()
    for f in ("post_counts", "class_counts", "prior_counts",
              "cont_post_mean", "cont_post_std", "cont_prior_mean",
              "cont_prior_std"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.total == want.total
    assert (got.binned_ordinals, got.cont_ordinals, got.num_bins) == \
        (want.binned_ordinals, want.cont_ordinals, want.num_bins)


def _same_predictions(got, want):
    np.testing.assert_array_equal(got.class_probs, np.asarray(want.class_probs))
    np.testing.assert_array_equal(got.pred_prob, want.pred_prob)
    np.testing.assert_array_equal(got.class_prob_diff, want.class_prob_diff)
    assert got.pred_class == want.pred_class
    for a, b in ((got.feature_prior_prob, want.feature_prior_prob),
                 (got.feature_post_prob, want.feature_post_prob)):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.fixture(scope="module")
def jax_ctx():
    from avenir_tpu.parallel.mesh import runtime_context
    return runtime_context()


@pytest.mark.parametrize("pack4", ["0", "1"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_train_matches_jax_in_each_wire_form(name, pack4, jax_ctx,
                                             monkeypatch):
    """The 4-bit form where every alphabet fits a nibble (forced: the
    auto rule packs only off the CPU), else uint8 (and int32 on the wide
    schema's 300 bins); unknown classes and out-of-alphabet bins drop."""
    monkeypatch.setenv("AVENIR_TPU_WIRE_PACK4", pack4)
    rows = _rows(name, 700, 1, far=0.03, unknown=0.02)
    jt, tt = _both(name, rows)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = jb.train(jt, jax_ctx)
        counters = Counters()
        got = bayes.train(tt, device="cpu", counters=counters)
    _same_model(got, want)
    assert counters.get("Distribution Data", "Feature posterior binned ") \
        == int((want.post_counts > 0).sum())
    assert counters.get("Distribution Data", "Class prior") == \
        SCHEMAS[name][2]


@pytest.mark.parametrize("chunk", [1, 97, 700, 1 << 23])
def test_train_chunked_equals_one_chunk(chunk):
    rows = _rows("gauss", 700, 2, far=0.02)
    _, tt = _both("gauss", rows)
    one = bayes.train(tt, device="cpu")
    _same_model(bayes.train(tt, device="cpu", chunk_rows=chunk), one)


def test_chunk_above_limit_refused():
    _, tt = _both("gauss", _rows("gauss", 10, 3))
    with pytest.raises(ValueError, match="1<<23"):
        bayes.train(tt, device="cpu", chunk_rows=(1 << 23) + 1)


@pytest.mark.parametrize("k", [0, 1, 50, 64])
def test_prefix_mask_from_the_valid_count(k):
    """A chunk's first ``k`` rows count: the rest of a reused buffer (stale
    rows) are masked on the device from the scalar."""
    rng = np.random.default_rng(k)
    cc = torch.from_numpy(rng.integers(0, 3, 64))
    bc = torch.from_numpy(rng.integers(0, 7, (64, 4)))
    cv = torch.from_numpy(rng.integers(0, 50, (64, 2)).astype(np.float32))
    got = bayes._train_chunk(cc, bc, cv, k, 3, 7)
    want = bayes._train_chunk(cc[:k], bc[:k], cv[:k], k, 3, 7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pack4_force_warns_when_alphabets_are_too_big(monkeypatch):
    monkeypatch.setenv("AVENIR_TPU_WIRE_PACK4", "1")
    _, tt = _both("wide", _rows("wide", 50, 4))
    with pytest.warns(UserWarning, match="AVENIR_TPU_WIRE_PACK4=1 ignored"):
        bayes.train(tt, device="cpu")


def test_unpack4_inverts_the_nibble_pack():
    rng = np.random.default_rng(6)
    for F in (1, 2, 5, 6):
        codes = rng.integers(0, 16, (33, F)).astype(np.uint8)
        pk = np.zeros((33, (F + 1) // 2), np.uint8)
        for j in range(F):
            pk[:, j // 2] |= (codes[:, j] << 4) if j % 2 == 0 \
                else codes[:, j]
        np.testing.assert_array_equal(
            bayes._unpack4(torch.from_numpy(pk), F).numpy(), codes)


@pytest.mark.parametrize("pack4", ["0", "1"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_predict_matches_jax_in_each_wire_form(name, pack4, jax_ctx,
                                               monkeypatch):
    """Percents, argmax, top-2 diff, P(x) and P(x|c) bit for bit, over
    records with values past the alphabets (some past 255 bins)."""
    monkeypatch.setenv("AVENIR_TPU_WIRE_PACK4", pack4)
    jt, tt = _both(name, _rows(name, 500, 7))
    want_model = jb.train(jt, jax_ctx)
    model = _port_model(want_model, tt.schema)
    jq, tq = _both(name, _rows(name, 2000, 8, far=0.05, unknown=0.05))
    _same_predictions(bayes.predict(model, tq, device="cpu"),
                      jb.predict(want_model, jq, jax_ctx))


def test_far_out_of_range_value_skips_the_feature():
    """A bucketed value hundreds of bins past the alphabet must be skipped
    like one just past it, not wrapped into a valid uint8 bin."""
    rows = _rows("churnlike", 400, 9)
    _, tt = _both("churnlike", rows)
    model = bayes.train(tt, device="cpu")
    base = _rows("churnlike", 40, 10)

    def with_first(value):
        out = [list(r) for r in base]
        for r in out:
            r[1] = value
        return bayes.predict(model, _both("churnlike", out)[1],
                             device="cpu").class_probs
    far, mid = with_first("999999"), with_first("1200")
    np.testing.assert_array_equal(far, mid)
    assert not np.array_equal(far, with_first("15"))


def test_model_file_round_trip(jax_ctx):
    rows = _rows("gauss", 600, 11)
    jt, tt = _both("gauss", rows)
    want = jb.train(jt, jax_ctx)
    lines = bayes.train(tt, device="cpu").to_lines()
    assert lines == want.to_lines()
    got = bayes.NaiveBayesModel.from_lines(lines, tt.schema)
    _same_model(got, jb.NaiveBayesModel.from_lines(lines, jt.schema))
    assert got.to_lines() == lines
    # the round-tripped model predicts what the trained one does
    _, tq = _both("gauss", _rows("gauss", 300, 12))
    _same_predictions(bayes.predict(got, tq, device="cpu"),
                      bayes.predict(bayes.train(tt, device="cpu"), tq,
                                    device="cpu"))


def test_evaluate_exports_the_confusion_matrix(jax_ctx):
    jt, tt = _both("churnlike", _rows("churnlike", 500, 13))
    model = bayes.train(tt, device="cpu")
    res = bayes.predict(model, tt, device="cpu")
    counters = Counters()
    cm = bayes.evaluate(model, tt, res, counters=counters)
    jcm = jb.evaluate(jb.train(jt, jax_ctx), jt,
                      jb.predict(jb.train(jt, jax_ctx), jt, jax_ctx))
    assert (cm.true_pos, cm.false_pos, cm.true_neg, cm.false_neg) == \
        (jcm.true_pos, jcm.false_pos, jcm.true_neg, jcm.false_neg)
    assert counters.get("Validation", "TruePositive") == cm.true_pos


def test_entry_points_run_on_cuda_unless_asked():
    """No device means the card; without one the call raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    _, tt = _both("gauss", _rows("gauss", 20, 14))
    with pytest.raises(RuntimeError, match="cuda"):
        bayes.train(tt)
    model = bayes.train(tt, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        bayes.predict(model, tt)
    with pytest.raises(RuntimeError, match="cuda"):
        bayes_text.train_text(["a b,x"])


# ---- text mode ---------------------------------------------------------

TOPICS = {"sports": "goal match team coach league o'neill's 3.5 final",
          "tech": "server kernel gpu compiler cache example.com c++ v2.1",
          "food": "recipe bake flour oven café don't sauce bread"}


def _docs(n, seed, noise=3):
    rng = np.random.default_rng(seed)
    names = sorted(TOPICS)
    out = []
    for _ in range(n):
        label = names[rng.integers(3)]
        words = list(rng.choice(TOPICS[label].split(), 5)) + list(
            rng.choice(" ".join(TOPICS.values()).split() + ["the", "and"],
                       noise))
        out.append(f"{' '.join(words)},{label}")
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_text_train_and_classify_match_jax(seed):
    lines = _docs(120, seed)
    want = jbt.train_text(lines)
    got = bayes_text.train_text(lines, device="cpu")
    assert got.to_lines() == want.to_lines()
    assert got.vocab == want.vocab and got.class_values == want.class_values
    np.testing.assert_array_equal(got.token_counts,
                                  np.asarray(want.token_counts))
    texts = [l.rpartition(",")[0] for l in _docs(200, seed + 10, noise=6)]
    texts += ["", "nothing known here", "goal goal kernel"]
    wp, ws = jbt.classify_text(want, texts)
    tp, ts = bayes_text.classify_text(
        text_bayes_from_arrays(want.class_values, want.vocab,
                               want.token_counts, want.class_counts),
        texts, device="cpu")
    assert tp == wp
    assert ts.dtype == np.asarray(ws).dtype
    np.testing.assert_array_equal(ts, np.asarray(ws))


def test_text_model_round_trip():
    model = bayes_text.train_text(_docs(60, 4), device="cpu")
    lines = model.to_lines()
    again = bayes_text.TextBayesModel.from_lines(lines)
    assert again.to_lines() == lines
    jagain = jbt.TextBayesModel.from_lines(lines)
    assert again.vocab == jagain.vocab
    np.testing.assert_array_equal(again.token_counts, jagain.token_counts)


# ---- registry and serving ----------------------------------------------

def _jax_model(name="gauss", seed=15):
    jt, tt = _both(name, _rows(name, 500, seed))
    from avenir_tpu.parallel.mesh import runtime_context
    return jb.train(jt, runtime_context()), jt.schema, tt.schema


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_registry_bayes_kind_both_ways(tmp_path):
    """The port publishes the JAX package's version (meta.json bytes,
    arrays.npz arrays and dtypes) and each package loads the other's."""
    jm, js, ts = _jax_model()
    pm = _port_model(jm, ts)
    JaxRegistry(str(tmp_path / "jax")).publish("nb", jm, schema=js)
    v = ModelRegistry(str(tmp_path / "port")).publish("nb", pm, schema=ts)
    assert v == 1
    dirs = [os.path.join(tmp_path, r, "nb", "v_000001")
            for r in ("jax", "port")]
    with open(os.path.join(dirs[0], "meta.json"), "rb") as a, \
            open(os.path.join(dirs[1], "meta.json"), "rb") as b:
        assert a.read() == b.read()
    ja, pa = (_npz(os.path.join(d, "arrays.npz")) for d in dirs)
    assert sorted(ja) == sorted(pa)
    for k in ja:
        assert ja[k].dtype == pa[k].dtype, k
        np.testing.assert_array_equal(ja[k], pa[k])
    # each package loads the other's version
    loaded = ModelRegistry(str(tmp_path / "jax")).load("nb")
    assert loaded.kind == "bayes"
    _same_model(loaded.model, jm)
    jloaded = JaxRegistry(str(tmp_path / "port")).load("nb")
    assert jloaded.kind == "bayes"
    assert jloaded.model.to_lines() == jm.to_lines()


def test_registry_refuses_unported_kinds_by_name(tmp_path):
    """An mlp version (ported) loads; a kind neither package knows is
    refused by name."""
    reg = ModelRegistry(str(tmp_path))
    mlp = {"W1": np.zeros((3, 2), np.float32), "b1": np.zeros(2, np.float32),
           "W2": np.zeros((2, 2), np.float32), "b2": np.zeros(2, np.float32)}
    JaxRegistry(str(tmp_path)).publish("nn", mlp, kind="mlp")
    loaded = reg.load("nn")
    assert loaded.kind == "mlp"
    for k, v in mlp.items():
        np.testing.assert_array_equal(loaded.model[k], v)
    assert reg.publish("w", mlp) == 1
    with pytest.raises(TypeError, match="cannot infer model kind"):
        reg.publish("x", {"weights": np.zeros(3)})
    with pytest.raises(ValueError, match="'svm'"):
        reg.publish("x", mlp, kind="svm")


def test_prediction_service_over_a_bayes_version(tmp_path):
    """The in-process service answers each request with the offline
    predictor's class, over bucket-padded batches."""
    jm, js, ts = _jax_model("churnlike", 16)
    JaxRegistry(str(tmp_path)).publish("nb", jm, schema=js)
    rows = _rows("churnlike", 300, 17, far=0.03)
    want = jb.predict(jm, jax_encode(rows, js)).pred_class
    svc = PredictionService(registry=ModelRegistry(str(tmp_path)),
                            model_name="nb", device="cpu",
                            policy=BatchPolicy(max_batch=37))
    assert isinstance(svc.predictor, BayesPredictor)
    svc.start()
    futs = [svc.submit(r) for r in rows]
    got = [f.result(timeout=60) for f in futs]
    svc.stop()
    assert got == want
    assert svc.counters.get("Serving", "Requests") == len(rows)


def test_quantized_and_serve_mesh_on_bayes_warn_and_serve_float(tmp_path):
    jm, js, ts = _jax_model("churnlike", 18)
    JaxRegistry(str(tmp_path)).publish("nb", jm, schema=js)
    loaded = ModelRegistry(str(tmp_path)).load("nb")
    with pytest.warns(RuntimeWarning, match="only forest artifacts"):
        p = make_predictor(loaded, device="cpu", quantized=True)
    assert isinstance(p, BayesPredictor)
    with pytest.warns(RuntimeWarning, match="forest serving only"):
        make_predictor(loaded, device="cpu", serve_mesh=2)
    rows = _rows("churnlike", 20, 19)
    assert p.predict_rows(rows) == \
        jb.predict(jm, jax_encode(rows, js)).pred_class


def test_reference_float32_moments_drift_from_the_exact_integers():
    """The JAX package sums the continuous moments in a float32 one-hot
    contraction; on one device, at 200,000 rows of one value, its sums
    have drifted far enough that the floored mean and sigma change (a
    mesh of several devices sums shorter partials and drifts later).  The
    port sums in float64 (exact to 2^53 here), as the reference's long
    arithmetic does (ROADMAP §C): 101 and 0 against the JAX package's 100
    and 14."""
    from avenir_tpu.parallel.mesh import MeshContext, make_mesh
    d = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "b", "ordinal": 1, "dataType": "int", "feature": True,
         "min": 0, "max": 9, "bucketWidth": 5},
        {"name": "c", "ordinal": 2, "dataType": "int", "feature": True},
        {"name": "cls", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["k0", "k1"]}]}
    n = 200_000
    from avenir_tpu.core.table import ColumnarTable as JaxTable
    from avenir_tpu_torch.core.table import ColumnarTable
    cols = {1: np.arange(n, dtype=np.float64) % 10,
            2: np.full(n, 101.0), 3: np.zeros(n, np.int32)}
    want_line = "k0,2,,101,0"
    got = bayes.train(ColumnarTable(FeatureSchema.from_dict(d), n,
                                    dict(cols)), device="cpu").to_lines()
    ref = jb.train(JaxTable(JaxSchema.from_dict(d), n, dict(cols)),
                   MeshContext(make_mesh(1))).to_lines()
    assert want_line in got and ",2,,101,0" in got
    assert want_line not in ref and "k0,2,,100,14" in ref
    assert [l for l in got if ",2,," not in l] == \
        [l for l in ref if ",2,," not in l]
