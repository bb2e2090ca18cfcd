"""Program spans on the training, scoring and KNN paths, on the CPU at
small sizes: under ``utils.tracing.trace`` the capture holds each named
span (an ``av:<name>`` range) once a call or build, nested inside it; with
tracing off no profiler range is entered; no span calls
``torch.cuda.synchronize``; a span's JSONL ``ts`` lies within a
millisecond of its range in the capture; ``layer()`` is a program span
with or without a profile.  On the card (``-m card``): the spans add no
synchronising operation to a path."""

import gc
import glob
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv_text
from avenir_tpu_torch.models import forest
from avenir_tpu_torch.models.knn import KnnParams, classify_topk
from avenir_tpu_torch.models.tree import TreeParams
from avenir_tpu_torch.ops.distance import DistanceComputer
from avenir_tpu_torch.telemetry import trace as ttrace
from avenir_tpu_torch.utils.tracing import LayerProfile, layer, trace

RES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "resource")

# the spans each path opens, and how many times a call or build opens each
SPANS = {
    "score": {"predictor.models": 1, "ensemble.encode": 1,
              "ensemble.vote": 1, "predictor.lines": 1,
              "predictor.errors": 1},
    "knn": {"knn.encode": 1, "knn.upload": 1, "knn.scan": 1,
            "knn.readback": 1, "knn.class_scores": 1, "knn.class_pick": 1},
    "train": {"weights_h2d": 1, "bootstrap.draw": 1, "bootstrap.upload": 1,
              "branch_codes": 1},
}
PATHS = sorted(SPANS)


def _generate(name, n, seed):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from importlib import import_module
    return import_module(f"gen.{name}_gen").generate(n, seed)


def _table(name, n, seed):
    schema = FeatureSchema.load(os.path.join(RES, f"{name}.json"))
    return schema, load_csv_text("\n".join(_generate(name, n, seed)),
                                 schema, keep_raw=True)


def _forest_params(seed=5):
    return forest.ForestParams(tree=TreeParams(
        split_algorithm="giniIndex", attr_select_strategy="randomNotUsedYet",
        split_select_strategy="randomAmongTop", max_depth=3,
        sub_sampling="withReplace", sub_sampling_rate=100.0, seed=seed),
        num_trees=3, seed=seed)


def _paths(device):
    """Each path as a call on small inputs made once, on ``device``."""
    schema, table = _table("call_hangup", 600, 3)
    trees = forest.build_forest(table, _forest_params(), device=device)
    eschema, train = _table("elearn", 300, 4)
    _, test = _table("elearn", 40, 5)
    comp = DistanceComputer(eschema, device=device)
    codes = train.columns[5].astype(np.int32)
    params = KnnParams(top_match_count=5)

    def score():
        return forest.model_predictor(
            table, schema, trees, class_attr_ordinal=5, error_counting=True,
            counters=Counters(), device=device)

    def knn():
        nd, idx = comp.pairwise_topk(test, train, 5)
        return classify_topk(nd, codes[idx], ["fail", "pass"], params)

    def train_():
        return forest.build_forest(table, _forest_params(7), device=device)
    return {"score": score, "knn": knn, "train": train_}


@pytest.fixture(scope="module")
def paths():
    return _paths("cpu")


def _ranges(log_dir):
    """The capture's ``av:`` ranges: (name, start us, end us) on the
    epoch's clock."""
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    return [(e["name"][len(ttrace.RANGE_PREFIX):], base_us + e["ts"],
             base_us + e["ts"] + e["dur"])
            for e in doc["traceEvents"] if e.get("ph") == "X"
            and e.get("name", "").startswith(ttrace.RANGE_PREFIX)]


@pytest.mark.parametrize("path", PATHS)
def test_capture_holds_each_span_once_a_call(path, paths, tmp_path):
    with trace(str(tmp_path)) as live:
        assert live
        with ttrace.span("call"):
            paths[path]()
    ranges = _ranges(str(tmp_path))
    (call,) = [r for r in ranges if r[0] == "call"]
    for name, times in SPANS[path].items():
        got = [r for r in ranges if r[0] == name]
        assert len(got) == times, (name, ranges)
        assert all(call[1] <= a and b <= call[2] for _, a, b in got), name
    if path == "train":
        (outer,) = [r for r in ranges if r[0] == "weights_h2d"]
        for name in ("bootstrap.draw", "bootstrap.upload"):
            (inner,) = [r for r in ranges if r[0] == name]
            assert outer[1] <= inner[1] and inner[2] <= outer[2]
    # the switch closes with the capture
    assert ttrace.span("after") is ttrace.NULL_SPAN


@pytest.mark.parametrize("tracer", [False, True], ids=["off", "jsonl"])
@pytest.mark.parametrize("path", PATHS)
def test_no_range_without_a_capture(path, tracer, paths, tmp_path,
                                    monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    class Counted:
        """The C++ range type, counting the ranges it makes."""

        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counted)
    if tracer:
        ttrace.install_tracer(ttrace.Tracer(str(tmp_path)))
    try:
        assert (ttrace.span("x") is ttrace.NULL_SPAN) is not tracer
        paths[path]()
    finally:
        ttrace.uninstall_tracer()
    assert entered == []
    # the same path with the switch on: the counters see its ranges
    with ttrace.annotate_capture():
        paths[path]()
    assert set(SPANS[path]) <= {n[len(ttrace.RANGE_PREFIX):]
                                for n in entered}


@pytest.mark.parametrize("path", PATHS)
def test_spans_never_synchronise(path, paths, tmp_path, monkeypatch):
    """No span calls ``torch.cuda.synchronize`` (on the CPU; the card case
    below counts every synchronising operation)."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    ttrace.install_tracer(ttrace.Tracer(str(tmp_path / "jsonl")))
    try:
        with trace(str(tmp_path / "capture")):
            paths[path]()
    finally:
        ttrace.uninstall_tracer()
    assert syncs == []


@pytest.mark.parametrize("path", PATHS)
def test_jsonl_ts_within_1ms_of_the_capture(path, paths, tmp_path):
    tracer = ttrace.install_tracer(ttrace.Tracer(str(tmp_path / "jsonl")))
    try:
        with trace(str(tmp_path / "capture")):
            paths[path]()
    finally:
        ttrace.uninstall_tracer()
        tracer.close()
    spans = [e for e in ttrace.read_trace_file(tracer.path)
             if e["ph"] == "X"]
    ranges = _ranges(str(tmp_path / "capture"))
    checked = 0
    for name in SPANS[path]:
        mine = sorted(e["ts"] for e in spans if e["name"] == name)
        theirs = sorted(a for n, a, _ in ranges if n == name)
        assert len(mine) == len(theirs) == SPANS[path][name], name
        for ts, start in zip(mine, theirs):
            assert abs(ts - start) < 1000.0, (name, ts - start)
            checked += 1
    assert checked == sum(SPANS[path].values())


@pytest.mark.parametrize("profiled", [False, True],
                         ids=["no_profile", "profile"])
def test_layer_is_a_program_span(profiled, tmp_path):
    prof = LayerProfile("cpu") if profiled else None
    if not profiled:
        # off: the shared null span, nothing allocated
        assert layer(None, "x") is ttrace.NULL_SPAN
    tracer = ttrace.install_tracer(ttrace.Tracer(str(tmp_path)))
    try:
        with layer(prof, "x"):
            pass
    finally:
        ttrace.uninstall_tracer()
        tracer.close()
    (ev,) = [e for e in ttrace.read_trace_file(tracer.path)
             if e["ph"] == "X"]
    assert ev["name"] == "x" and ev["cat"] == "layer"
    if profiled:
        assert set(prof.setup) == {"x"}


@pytest.mark.card
@pytest.mark.parametrize("path", PATHS)
def test_spans_add_no_synchronise_on_the_card(path, tmp_path, monkeypatch):
    """On the card, a path's synchronising operations (torch's sync debug
    mode warns at each: the uploads from pageable memory, the readbacks),
    by the line that made each, are the same with a JSONL tracer and an
    annotated capture as with tracing off, and none is
    ``torch.cuda.synchronize``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    run = _paths("cuda")[path]
    synchronize = []

    def syncs():
        # no collection inside: a finaliser's synchronise is no span's
        gc.collect()
        gc.disable()
        with warnings.catch_warnings(record=True) as got, \
                monkeypatch.context() as m:
            warnings.simplefilter("always")
            m.setattr(torch.cuda, "synchronize",
                      lambda *a, **k: synchronize.append(a))
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                gc.enable()
        return sorted("/".join(w.filename.split(os.sep)[-2:]) +
                      f":{w.lineno}" for w in got
                      if "synchroniz" in str(w.message))
    # the first run under the debug mode also counts one warning raised
    # where the mode is first switched on, no operation of the path's
    syncs()
    off = syncs()
    tracer = ttrace.install_tracer(ttrace.Tracer(str(tmp_path / "jsonl")))
    try:
        with trace(str(tmp_path / "capture")) as live:
            assert live
            on = syncs()
    finally:
        ttrace.uninstall_tracer()
        tracer.close()
    assert off and on == off, (off, on)
    assert synchronize == []
    assert {n for n, _, _ in _ranges(str(tmp_path / "capture"))} >= \
        set(SPANS[path])


def test_annotate_capture_nests():
    assert ttrace.span("x") is ttrace.NULL_SPAN
    with ttrace.annotate_capture():
        with ttrace.annotate_capture():
            assert ttrace.span("x") is not ttrace.NULL_SPAN
        assert ttrace.span("x") is not ttrace.NULL_SPAN
    assert ttrace.span("x") is ttrace.NULL_SPAN
