"""The plain reference against the program at small sizes on the CPU: the
plain forest's trees against ``build_forest``'s, the plain scorer
against ``model_predictor``, and the plain KNN against
``DistanceComputer.pairwise_topk`` and ``classify_topk``."""

import json
import random

import numpy as np
import pytest
import torch

from portbench.core import cell_files
from portbench.gen import call_hangup, elearn
from portbench.reference import forest as plain
from portbench.reference import knn as plain_knn
from portbench.traffic import common
from portbench.traffic.knn_batches import _features, _table, ranges

CONFIG = cell_files("rafo_train_1m")[1]
SCHEMA, PROPS = CONFIG["schema"], CONFIG["properties"]


def _plain_forest(cols, seed, dtype=np.float64):
    splits = plain.candidate_splits(SCHEMA)
    codes = plain.branch_codes(splits, SCHEMA,
                               common.hangup_features(cols), "cpu")
    return plain.build_forest(codes, torch.as_tensor(cols["hungUp"]), splits,
                              call_hangup.CLASSES, PROPS, seed, dtype)


def test_candidate_splits_are_the_programs():
    from avenir_tpu_torch.models.tree import generate_candidate_splits
    fs = common.feature_schema(CONFIG)
    got = [[p.pred_str for p in s.predicates]
           for s in generate_candidate_splits(fs)]
    assert got == [s["preds"] for s in plain.candidate_splits(SCHEMA)]
    assert len(got) == 19


def test_partitions_in_restricted_growth_order():
    assert plain._partitions(list("abc"), 2) == [
        [["a", "b"], ["c"]], [["a", "c"], ["b"]], [["a"], ["b", "c"]]]


@pytest.mark.parametrize("n,seed", [(3000, 7), (20000, 2 ** 33 + 17),
                                    (1, 5)])
def test_plain_forest_is_the_programs(n, seed):
    from avenir_tpu_torch.models.forest import build_forest
    cols = call_hangup.columns(np.random.default_rng(seed), n)
    prog = build_forest(common.hangup_table(CONFIG, cols),
                        common.forest_params(PROPS, seed), device="cpu")
    got = plain.compare_trees([m.to_json() for m in prog],
                              _plain_forest(cols, seed))
    assert got == {"tree_mismatch": 0.0, "prob_gap": 0.0}


def test_model_json_round_trips_through_the_program():
    from avenir_tpu_torch.models.tree import DecisionPathList
    cols = call_hangup.columns(np.random.default_rng(3), 4000)
    for tree in _plain_forest(cols, 11):
        text = plain.model_json(tree)
        assert DecisionPathList.from_json(text).to_json() == text


def test_plain_scorer_is_the_programs():
    from avenir_tpu_torch.core.metrics import Counters
    from avenir_tpu_torch.core.table import load_csv_text
    from avenir_tpu_torch.models.forest import model_predictor
    from avenir_tpu_torch.models.tree import DecisionPathList
    trees = _plain_forest(call_hangup.columns(np.random.default_rng(1),
                                              2000), 5)
    cols = call_hangup.columns(np.random.default_rng(2), 5000)
    records = call_hangup.csv_lines(cols)
    fs = common.feature_schema(CONFIG)
    table = load_csv_text("\n".join(records), fs, ",", keep_raw=True)
    counters = Counters()
    lines = model_predictor(
        table, fs, [DecisionPathList.from_json(plain.model_json(t))
                    for t in trees], class_attr_ordinal=5,
        error_counting=True, counters=counters, device="cpu")
    want = plain.predict(trees, SCHEMA, common.hangup_features(cols))
    assert lines == [f"{r},{p}" for r, p in zip(records, want)]
    actual = np.asarray(call_hangup.CLASSES)[cols["hungUp"]]
    assert counters.get("Prediction", "Error count") == \
        int((want != actual).sum())


def test_plain_knn_lists_match_the_programs_within_float32():
    from avenir_tpu_torch.models.knn import KnnParams, classify_topk
    from avenir_tpu_torch.ops.distance import DistanceComputer
    config = cell_files("knn_elearn_20k")[1]
    fs = common.feature_schema(config)
    train = elearn.columns(np.random.default_rng(1), 3000)
    test = elearn.columns(np.random.default_rng(2), 200)
    comp = DistanceComputer(fs, scale=1000, device="cpu")
    nd, idx = comp.pairwise_topk(_table(fs, test), _table(fs, train), 7)
    codes = train["outcome"].astype(np.int32)
    pred = classify_topk(nd, codes[idx], list(elearn.CLASSES),
                         KnnParams(top_match_count=7)).pred_class
    got = plain_knn.judge(torch.as_tensor(_features(test)),
                          torch.as_tensor(_features(train)), codes,
                          ranges(config["schema"]), 1000, 7, nd, idx,
                          np.array([elearn.CLASSES.index(c) for c in pred]),
                          2)
    # the program's float32 distances lie within a few units of the exact
    # ones; its classes are the vote of its lists
    assert got["dist_gap"] <= 20 and got["rank_gap"] <= 20
    assert got["beyond_kth_pct"] <= 5
    assert got["class_mismatch"] == 0
    d, i = plain_knn.nearest(torch.as_tensor(_features(test)),
                             torch.as_tensor(_features(train)),
                             ranges(config["schema"]), 1000, 7)
    assert (np.abs(d - nd) <= got["dist_gap"]).all()


def test_plain_knn_ties_go_to_the_lower_index():
    train = torch.tensor([[1.0, 0, 0, 0], [0.0, 0, 0, 0], [1.0, 0, 0, 0]])
    d, i = plain_knn.nearest(torch.zeros((1, 4)), train, [1.0] * 4, 1000, 3)
    assert i.tolist() == [[1, 0, 2]] and d.tolist() == [[0, 500, 500]]


def test_judge_reads_a_broken_list_as_infinitely_far():
    train = torch.rand((50, 4), generator=torch.Generator().manual_seed(0))
    test = train[:5]
    d, i = plain_knn.nearest(test, train, [1.0] * 4, 1000, 3)
    cls = np.zeros(50, np.int64)
    ok = plain_knn.judge(test, train, cls, [1.0] * 4, 1000, 3, d, i,
                         np.zeros(5, np.int64), 2)
    assert ok == {"dist_gap": 0.0, "rank_gap": 0.0, "beyond_kth_pct": 0.0,
                  "class_mismatch": 0.0}
    i2 = i.copy()
    i2[0, 1] = i2[0, 0]
    assert plain_knn.judge(test, train, cls, [1.0] * 4, 1000, 3, d, i2,
                           np.zeros(5, np.int64), 2)["rank_gap"] == \
        plain_knn.FAR
    assert plain_knn.judge(test, train, cls, [1.0] * 4, 1000, 3, d[:2], i[:2],
                           np.zeros(2, np.int64), 2)["dist_gap"] == \
        plain_knn.FAR
    # lists shorter than the configuration's k: the nearest one alone
    # would read no gap against the exact first neighbour
    assert plain_knn.judge(test, train, cls, [1.0] * 4, 1000, 3, d[:, :1],
                           i[:, :1], np.zeros(5, np.int64), 2) == {
        n: plain_knn.FAR for n in ok}
