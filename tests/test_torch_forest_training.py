"""Random-forest training, port against the JAX package on the CPU: the
same tables (made from a seed with numpy) through ``avenir_tpu`` and
``avenir_tpu_torch`` (``device="cpu"`` / ``-Dplatform=cpu``).  Candidate
splits, split-set arrays, feature matrices, branch codes, the reassign and
the record router are equal; forests are byte-identical tree JSON for every
sub-sampling, impurity, attribute- and split-selection and stopping
strategy, chunked or not; the training CLI reproduces the golden ``rf`` and
``dt`` fixtures and the rafo9 forest; a version the port publishes is
byte-identical to the JAX package's and loads in both; keys of unported
training tiers refuse by name, and the sidecar keys without a registry."""

import json
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.core.table import ColumnarTable as JaxTable
from avenir_tpu.models import tree as jtree
from avenir_tpu.models.forest import ForestParams as JaxForestParams
from avenir_tpu.models.forest import _reassign_body
from avenir_tpu.models.forest import build_forest as jax_build_forest
from avenir_tpu.parallel.mesh import MeshContext
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.cli.jobs import JobNotPorted
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import ColumnarTable
from avenir_tpu_torch.models import forest as pforest
from avenir_tpu_torch.models import tree as ptree
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.utils.tracing import LayerProfile, transfer_ledger

TESTS = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(os.path.dirname(TESTS), "resource")
SCHEMA = os.path.join(RES, "call_hangup.json")
RAFO_PROPS = os.path.join(RES, "rafo.properties")
DETR_PROPS = os.path.join(RES, "detr.properties")
RF_GOLDEN = os.path.join(TESTS, "golden", "fixtures", "rf")
DT_GOLDEN = os.path.join(TESTS, "golden", "fixtures", "dt")
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")

# maxSplit 3 on a categorical and an integer field (3-way splits, B = 3),
# and a double field (float thresholds, 'le 0.25' predicates)
LOCAL_SCHEMA = {"fields": [
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


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _counters(out_dir):
    with open(f"{out_dir}.counters.json") as fh:
        return json.load(fh)


def _columns(n, seed, integral=False, dirty=True):
    """Seeded columns in LOCAL_SCHEMA's layout.  ``dirty`` adds unknown
    categories (-1), NaN scores and unknown class codes (-1); ``integral``
    rounds the scores so the feature matrix narrows to int16."""
    rng = np.random.default_rng(seed)
    color = rng.integers(0, 4, n)
    age = rng.integers(0, 100, n).astype(np.float64)
    score = rng.random(n)
    if integral:
        score = np.round(score * 3)
    label = ((age > 45) ^ (color == 2)) | (rng.random(n) < 0.15)
    label = np.where(label, 0, 1)
    if dirty:
        color[rng.random(n) < 0.05] = -1
        score[rng.random(n) < 0.05] = np.nan
        label[rng.random(n) < 0.03] = -1
    return {1: color.astype(np.int32), 2: age, 3: score,
            4: label.astype(np.int32)}


def _tables(n=500, seed=3, schema=LOCAL_SCHEMA, **kw):
    cols = _columns(n, seed, **kw)
    return (ColumnarTable(schema=FeatureSchema.from_dict(schema), n_rows=n,
                          columns={k: v.copy() for k, v in cols.items()}),
            JaxTable(schema=JaxSchema.from_dict(schema), n_rows=n,
                     columns={k: v.copy() for k, v in cols.items()}))


# --------------------------------------------------------------------------
# candidate splits, split sets, feature matrices, branch codes
# --------------------------------------------------------------------------

def _schemas():
    with open(SCHEMA) as fh:
        hangup = json.load(fh)
    return {"call_hangup": hangup, "local": LOCAL_SCHEMA}


@pytest.mark.parametrize("name", ["call_hangup", "local"])
def test_candidate_splits_and_split_set_match_jax(name):
    d = _schemas()[name]
    ours = ptree.generate_candidate_splits(FeatureSchema.from_dict(d))
    ref = jtree.generate_candidate_splits(JaxSchema.from_dict(d))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert (a.attr, a.thresholds, a.groups) == \
            (b.attr, b.thresholds, b.groups)
        assert [p.to_dict() for p in a.predicates] == \
            [p.to_dict() for p in b.predicates]
        assert [p.is_int for p in a.predicates] == \
            [p.is_int for p in b.predicates]
    s_ours = ptree.SplitSet(ours, FeatureSchema.from_dict(d))
    s_ref = jtree.SplitSet(ref, JaxSchema.from_dict(d))
    assert s_ours.max_branches == s_ref.max_branches
    for attr in ("thresholds", "cat_table", "is_cat", "attr_col"):
        a, b = getattr(s_ours, attr), getattr(s_ref, attr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if name == "local":
        assert s_ours.max_branches == 3
        assert "3 le 0.25" in [p.pred_str for s in ours for p in s.predicates]


@pytest.mark.parametrize("kind", ["int16", "float32_nan"])
def test_feature_matrix_and_branch_codes_match_jax(kind):
    ours_t, ref_t = _tables(700, 5, integral=kind == "int16",
                            dirty=kind != "int16")
    if kind == "int16":
        # unknown categories still narrow: -1 is in the int16 range
        ours_t.columns[1][:7] = ref_t.columns[1][:7] = -1
    ss = ptree.SplitSet(ptree.generate_candidate_splits(ours_t.schema),
                        ours_t.schema)
    ss_ref = jtree.SplitSet(jtree.generate_candidate_splits(ref_t.schema),
                            ref_t.schema)
    X = ss.feature_matrix(ours_t)
    X_ref = ss_ref.feature_matrix(ref_t)
    assert X.dtype == X_ref.dtype == np.dtype(kind[:-4] if kind != "int16"
                                              else "int16")
    np.testing.assert_array_equal(X, X_ref)
    got = ss.branch_codes(torch.from_numpy(X)).numpy()
    want = np.asarray(jtree._branch_codes_body(
        jnp.asarray(X_ref), jnp.asarray(ss_ref.attr_col),
        jnp.asarray(ss_ref.thresholds), jnp.asarray(ss_ref.cat_table),
        jnp.asarray(ss_ref.is_cat)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.max() == 2                      # 3-way splits do branch 2


def test_branch_codes_row_chunks(monkeypatch):
    ours_t, _ = _tables(300, 8)
    ss = ptree.SplitSet(ptree.generate_candidate_splits(ours_t.schema),
                        ours_t.schema)
    X = torch.from_numpy(ss.feature_matrix(ours_t))
    whole = ss.branch_codes(X)
    monkeypatch.setattr(ptree, "_BRANCH_CHUNK_ELEMS", 50)
    assert torch.equal(ss.branch_codes(X), whole)


@pytest.mark.parametrize("T", [1, 5])
def test_reassign_matches_reassign_body(monkeypatch, T):
    rng = np.random.default_rng(T)
    n, Np, S, B, Nn = 1500, 6, 11, 3, 9
    nid = rng.integers(-2, Np, (n, T)).astype(np.int32)
    br = rng.integers(0, B, (n, S)).astype(np.int32)
    sel = rng.integers(-1, S, (T, Np)).astype(np.int32)
    ctab = rng.integers(-1, Nn, (T, Np, B)).astype(np.int32)
    want = np.asarray(_reassign_body(jnp.asarray(nid), jnp.asarray(br),
                                     jnp.asarray(sel), jnp.asarray(ctab)))
    monkeypatch.setattr(ptree, "_REASSIGN_CHUNK", 256)
    node_ids = torch.from_numpy(nid.copy())
    out = ptree.TreeBuilder._reassign(node_ids, torch.from_numpy(br),
                                      torch.from_numpy(sel),
                                      torch.from_numpy(ctab))
    assert out is node_ids                    # updated in place
    np.testing.assert_array_equal(node_ids.numpy(), want)


def test_match_index_device_and_numpy_twin_match_jax():
    ours_t, ref_t = _tables(400, 9, dirty=False)
    paths = jtree.DecisionPathList.from_json(
        _read(os.path.join(RF_GOLDEN, "tree_0.json")).decode())
    with open(SCHEMA) as fh:
        d = json.load(fh)
    rng = np.random.default_rng(9)
    cols = {1: rng.integers(-1, 4, 400).astype(np.int32),
            2: rng.integers(0, 1800, 400).astype(np.float64),
            3: rng.integers(0, 5, 400).astype(np.float64),
            4: rng.integers(0, 10, 400).astype(np.float64),
            5: rng.integers(0, 2, 400).astype(np.int32)}
    ref = jtree.PathMatrix(paths, JaxSchema.from_dict(d)).match_index(
        JaxTable(JaxSchema.from_dict(d), 400, dict(cols)), use_device=False)
    pm = ptree.PathMatrix(ptree.DecisionPathList.from_json(paths.to_json()),
                          FeatureSchema.from_dict(d))
    table = ColumnarTable(FeatureSchema.from_dict(d), 400, dict(cols))
    for use_device in (False, True):
        got = pm.match_index(table, use_device=use_device, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    assert (ref == -1).any() and (ref >= 0).any()


# --------------------------------------------------------------------------
# whole forests
# --------------------------------------------------------------------------

def _params(seed=5, **tree_kw):
    base = dict(max_depth=3)
    base.update(tree_kw)
    ours = pforest.ForestParams(num_trees=3, seed=seed)
    ref = JaxForestParams(num_trees=3, seed=seed)
    ours.tree = replace(ours.tree, **base)
    ref.tree = replace(ref.tree, **base)
    return ours, ref


FOREST_CASES = {
    "sub_none": dict(sub_sampling="none"),
    "sub_with_replace": dict(sub_sampling="withReplace"),
    "sub_without_replace": dict(sub_sampling="withoutReplace",
                                sub_sampling_rate=70.0),
    "entropy": dict(split_algorithm="entropy"),
    "gini": dict(split_algorithm="giniIndex"),
    "attr_all": dict(attr_select_strategy="all"),
    "attr_not_used_yet": dict(attr_select_strategy="notUsedYet"),
    "attr_random_all": dict(attr_select_strategy="randomAll",
                            random_split_set_size=2),
    "attr_random_not_used_yet": dict(attr_select_strategy="randomNotUsedYet"),
    "split_best": dict(split_select_strategy="best"),
    "split_random_among_top": dict(split_select_strategy="randomAmongTop",
                                   top_split_count=4),
    "stop_max_depth": dict(stopping_strategy="maxDepth", max_depth=4),
    "stop_min_population": dict(stopping_strategy="minPopulation",
                                min_population=60),
    "stop_min_info_gain": dict(stopping_strategy="minInfoGain",
                               min_info_gain=0.02),
}


@pytest.mark.parametrize("case", sorted(FOREST_CASES))
def test_build_forest_matches_jax(case):
    ours_t, ref_t = _tables()
    ours_p, ref_p = _params(**FOREST_CASES[case])
    want = [m.to_json() for m in jax_build_forest(ref_t, ref_p, MeshContext())]
    with transfer_ledger() as led:
        got = [m.to_json() for m in pforest.build_forest(ours_t, ours_p,
                                                         device="cpu")]
    assert got == want
    assert set(led.backend_snapshot()) == {"forest.level.torch"}


def test_sequential_build_matches_jax_sequential():
    """batched=False grows each tree with the single-tree count, whose
    unknown-class fold differs from the forest's (the data has unknown
    class codes): the port follows the reference on both sides."""
    ours_t, ref_t = _tables(seed=4)
    ours_p, ref_p = _params(seed=2)
    want = [m.to_json() for m in jax_build_forest(ref_t, ref_p, MeshContext(),
                                                  batched=False)]
    with transfer_ledger() as led:
        got = [m.to_json() for m in pforest.build_forest(
            ours_t, ours_p, device="cpu", batched=False)]
    assert got == want
    assert set(led.backend_snapshot()) == {"tree.level.torch"}
    assert got != [m.to_json() for m in pforest.build_forest(
        ours_t, ours_p, device="cpu")]


def test_chunked_build_matches_unchunked(monkeypatch):
    """A build forced to several launches per level (accumulated in int32)
    gives the unchunked build's trees and the reference's."""
    ours_t, ref_t = _tables(900, 6, dirty=False)
    ours_p, ref_p = _params(seed=9)
    whole = [m.to_json() for m in pforest.build_forest(ours_t, ours_p,
                                                       device="cpu")]
    monkeypatch.setattr(pforest, "level_chunk", lambda *a, **k: 128)
    prof = LayerProfile("cpu")
    with transfer_ledger() as led:
        chunked = [m.to_json() for m in pforest.build_forest(
            ours_t, ours_p, device="cpu", profile=prof)]
    assert chunked == whole
    assert chunked == [m.to_json() for m in
                       jax_build_forest(ref_t, ref_p, MeshContext())]
    levels = len(prof.levels)
    assert levels >= 2
    # 8 launches a level (900 rows / 128), two dispatches each
    assert led.backend_snapshot()["forest.level.torch"] == 8 * levels
    assert led.site_snapshot()["forest.level"] == 16 * levels
    assert {"b1", "accumulate", "counts_d2h", "split_choice"} <= \
        set(prof.median_ms())
    assert {"branch_codes", "weights_h2d", "bootstrap.draw",
            "bootstrap.upload"} == set(prof.setup)


# --------------------------------------------------------------------------
# the training CLI
# --------------------------------------------------------------------------

def _gen(n, seed, dest):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.call_hangup_gen import generate
    dest.write_text("\n".join(generate(n, seed)))
    return str(dest)


def test_golden_rf_random_forest_builder_bytes(tmp_path):
    train = _gen(400, 13, tmp_path / "train.csv")
    out = str(tmp_path / "model")
    assert port_run.main([
        "org.avenir.tree.RandomForestBuilder", f"-Dconf.path={RAFO_PROPS}",
        f"-Ddtb.feature.schema.file.path={SCHEMA}", "-Ddtb.num.trees=3",
        "-Dplatform=cpu", train, out]) == 0
    for i in range(3):
        assert _read(os.path.join(out, f"tree_{i}.json")) == \
            _read(os.path.join(RF_GOLDEN, f"tree_{i}.json"))
    c = _counters(out)
    assert c["KernelBackends"] == {"forest.level.torch": 4}
    assert c["Random forest"] == {"Trees": 3}
    assert c["Dispatches"]["forest.level"] == 4
    assert c["Dispatches"]["tree.reassign"] == 3


def test_golden_dt_decision_tree_builder_bytes(tmp_path):
    train = _gen(400, 12, tmp_path / "train.csv")
    d = str(tmp_path)
    dec_in = None
    for level in range(1, 4):
        args = ["org.avenir.tree.DecisionTreeBuilder",
                f"-Dconf.path={DETR_PROPS}",
                f"-Ddtb.feature.schema.file.path={SCHEMA}",
                f"-Ddtb.decision.file.path.out={d}/dec_out.json",
                "-Dplatform=cpu"]
        if dec_in:
            args.append(f"-Ddtb.decision.file.path.in={dec_in}")
        out = os.path.join(d, f"level_{level}")
        assert port_run.main(args + [train, out]) == 0
        dec_in = os.path.join(d, "dec_in.json")
        os.replace(os.path.join(d, "dec_out.json"), dec_in)
        # the records are carried forward for detr.sh's next level
        assert _read(os.path.join(out, "part-r-00000")).decode() \
            .splitlines() == (tmp_path / "train.csv").read_text() \
            .splitlines()
        c = _counters(out)
        assert c["KernelBackends"] == {"tree.level.torch": 1}
    assert _read(dec_in) == _read(os.path.join(DT_GOLDEN,
                                               "decision_paths.json"))
    assert c["Decision tree"]["Paths"] == \
        len(json.loads(_read(dec_in))["decisionPaths"])


def test_rafo9_trains_and_publishes_committed_forest(tmp_path):
    train = _gen(5000, 17, tmp_path / "train.csv")
    out, reg = str(tmp_path / "model"), str(tmp_path / "reg")
    assert port_run.main([
        "randomForestBuilder", f"-Dconf.path={RAFO_PROPS}",
        f"-Ddtb.feature.schema.file.path={SCHEMA}",
        f"-Ddtb.model.registry.dir={reg}", "-Ddtb.model.name=rafo9",
        "-Dplatform=cpu", train, out]) == 0
    for i in range(9):
        assert _read(os.path.join(out, f"tree_{i}.json")) == \
            _read(os.path.join(RAFO9, f"tree_{i}.json"))
    for f in ("meta.json", "arrays.npz"):
        assert _read(os.path.join(reg, "rafo9", "v_000001", f)) == \
            _read(os.path.join(RAFO9, "registry", "rafo9", "v_000001", f))
    assert _counters(out)["Random forest"] == {"RegistryVersion": 1,
                                               "Trees": 9}


def test_port_publish_is_byte_identical_and_loads_in_both(tmp_path):
    with open(SCHEMA) as fh:
        d = json.load(fh)
    trees = [ptree.DecisionPathList.from_json(
        _read(os.path.join(RAFO9, f"tree_{i}.json")).decode())
        for i in range(9)]
    jtrees = [jtree.DecisionPathList.from_json(t.to_json()) for t in trees]
    ours, ref = ModelRegistry(str(tmp_path / "p")), \
        JaxRegistry(str(tmp_path / "j"))
    for sub in (slice(0, 9), slice(0, 3)):
        assert ours.publish("m", trees[sub],
                            schema=FeatureSchema.from_dict(d)) == \
            ref.publish("m", jtrees[sub], schema=JaxSchema.from_dict(d))
    for v in (1, 2):
        for f in ("meta.json", "arrays.npz"):
            assert _read(os.path.join(ours.version_dir("m", v), f)) == \
                _read(os.path.join(ref.version_dir("m", v), f))
    assert not [e for e in os.listdir(os.path.join(ours.base_dir, "m"))
                if ".tmp" in e]
    loaded = JaxRegistry(ours.base_dir).load("m", 1)
    assert [t.to_json() for t in loaded.model] == \
        [t.to_json() for t in trees]
    back = ModelRegistry(ref.base_dir).load("m")
    assert back.version == 2 and [t.to_json() for t in back.model] == \
        [t.to_json() for t in trees[:3]]
    # an MLP's parameter dict publishes as the JAX package's mlp kind
    # does; an object of no known kind is refused
    mlp = {"W1": np.zeros((3, 2), np.float32), "b1": np.zeros(2, np.float32),
           "W2": np.zeros((2, 2), np.float32), "b2": np.zeros(2, np.float32)}
    assert ours.publish("b", mlp) == ref.publish("b", mlp) == 1
    assert _read(os.path.join(ours.version_dir("b", 1), "meta.json")) == \
        _read(os.path.join(ref.version_dir("b", 1), "meta.json"))
    # the npz members carry their write time: compare array for array
    with np.load(os.path.join(ours.version_dir("b", 1), "arrays.npz")) as a, \
            np.load(os.path.join(ref.version_dir("b", 1), "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(TypeError, match="cannot infer model kind"):
        ours.publish("c", {"weights": np.zeros(3)})


@pytest.mark.parametrize("key", [
    "dtb.streaming.cache.policy=build", "dtb.streaming.resume=true",
    "dtb.baseline.publish=true", "dtb.model.quantize=true",
    "AVENIR_TPU_SHARD=0/2"])
def test_unported_training_keys_refuse_by_name(tmp_path, monkeypatch, key):
    """Keys of unported tiers raise JobNotPorted naming them (a multi-shard
    AVENIR_TPU_SHARD lane in both builders); the sidecar keys are ported,
    and without a registry to ride they raise a ValueError naming the key
    and the registry key it needs; a resume without streamed ingest raises
    the reference's ValueError.  The columnar cache key is ported: it no
    longer refuses, and a streamed job with it builds the sidecar."""
    train = _gen(50, 1, tmp_path / "train.csv")
    name, _, value = key.partition("=")
    args = []
    if name == "dtb.streaming.cache.policy":
        assert port_run.main(["randomForestBuilder",
                              f"-Dconf.path={RAFO_PROPS}",
                              f"-Ddtb.feature.schema.file.path={SCHEMA}",
                              f"-D{key}", "-Ddtb.streaming.ingest=true",
                              "-Dplatform=cpu", train,
                              str(tmp_path / "o")]) == 0
        chunk_bytes = sum(os.path.getsize(os.path.join(train + ".avtc", f))
                          for f in os.listdir(train + ".avtc")
                          if f.startswith("chunk_"))
        with open(str(tmp_path / "o") + ".counters.json") as fh:
            assert json.load(fh)["ColumnarCache"] == {
                "Built": 1, "BytesWritten": chunk_bytes, "Miss": 1}
        return
    if name == "AVENIR_TPU_SHARD":
        monkeypatch.setenv(name, value)
        want = (JobNotPorted, r"AVENIR_TPU_SHARD=0/2")
    elif name.startswith(("dtb.baseline", "dtb.model.quantize")):
        args = [f"-D{key}"]
        want = (ValueError, name.replace(".", r"\.")
                + r" needs dtb\.model\.registry\.dir")
    elif name == "dtb.streaming.resume":
        args = [f"-D{key}"]
        want = (ValueError, r"dtb\.streaming\.resume needs "
                            r"dtb\.streaming\.ingest=true")
    else:
        args = [f"-D{key}"]
        want = (JobNotPorted, key.replace(".", r"\."))
    with pytest.raises(want[0], match=want[1]):
        port_run.main(["randomForestBuilder", f"-Dconf.path={RAFO_PROPS}",
                       f"-Ddtb.feature.schema.file.path={SCHEMA}",
                       *args, "-Dplatform=cpu", train,
                       str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")
    if name == "AVENIR_TPU_SHARD":
        with pytest.raises(JobNotPorted, match=want[1]):
            port_run.main(["decisionTreeBuilder", f"-Dconf.path={DETR_PROPS}",
                           f"-Ddtb.feature.schema.file.path={SCHEMA}",
                           "-Dplatform=cpu", train, str(tmp_path / "o")])
