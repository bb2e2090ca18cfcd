"""Faults planted in the program where a window calls it, to show that a
run whose timed path is broken comes out not correct.  The CPU tests plant
each at a small size (``tests/test_portbench_faults.py``); ``control.py
--fault`` plants one at the cell's own size on the card.

Each fault is planted through ``patch.setattr(owner, name, value)``
(pytest's ``monkeypatch``, or :class:`Patch`): a step that returns its
state unchanged (the previous call's answer again), half of the batch left
out, an answer altered where it is produced, and for KNN a scan over half
the train rows and lists shorter than the configuration's k.  No cell runs
across chips, so none can leave out an exchange between them."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple


class Patch:
    """``setattr`` that remembers what it replaced, for ``undo``."""

    def __init__(self):
        self.saved: List[Tuple[object, str, object]] = []

    def setattr(self, owner, name: str, value) -> None:
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)


def _stale(fn):
    """Every call after the first (the warm-up) answers what the call
    before it did, so a window's first call already answers stale."""
    last = []

    def call(*a, **kw):
        out = fn(*a, **kw)
        if not last:
            last.append(out)
        prev, last[0] = last[0], out
        return prev
    return call


def forest(patch, fault: str) -> None:
    from avenir_tpu_torch.models import forest as program
    build = program.build_forest
    if fault == "stale":
        patch.setattr(program, "build_forest", _stale(build))
    elif fault == "half":
        patch.setattr(program, "build_forest", lambda t, *a, **kw: build(
            t.take_rows(0, t.n_rows // 2), *a, **kw))
    else:
        def altered(*a, **kw):
            models = build(*a, **kw)
            models[0].decision_paths[0].population += 1
            return models
        patch.setattr(program, "build_forest", altered)


def knn(patch, fault: str) -> None:
    from avenir_tpu_torch.ops.distance import DistanceComputer
    scan = DistanceComputer.pairwise_topk
    if fault == "stale":
        patch.setattr(DistanceComputer, "pairwise_topk", _stale(scan))
    elif fault == "half":
        patch.setattr(DistanceComputer, "pairwise_topk",
                      lambda self, test, *a, **kw: scan(
                          self, test.take_rows(0, test.n_rows // 2), *a,
                          **kw))
    elif fault == "half_train":
        # a scan over the first half of the train rows only
        patch.setattr(DistanceComputer, "pairwise_topk",
                      lambda self, test, train, k, **kw: scan(
                          self, test, train.take_rows(0, train.n_rows // 2),
                          k, **kw))
    elif fault == "short_lists":
        patch.setattr(DistanceComputer, "pairwise_topk",
                      lambda self, test, train, k, **kw: scan(
                          self, test, train, 1, **kw))
    elif fault == "altered":
        def altered(self, test, train, k, **kw):
            d, i = scan(self, test, train, k, **kw)
            i[0, 0] = (i[0, 0] + 1) % train.n_rows
            return d, i
        patch.setattr(DistanceComputer, "pairwise_topk", altered)
    else:
        from avenir_tpu_torch.models import knn as program
        classify = program.classify_topk

        def altered_class(*a, **kw):
            res = classify(*a, **kw)
            res.pred_class[0] = "pass" if res.pred_class[0] == "fail" \
                else "fail"
            return res
        patch.setattr(program, "classify_topk", altered_class)


def score(patch, fault: str) -> None:
    from avenir_tpu_torch.models import forest as program
    predict = program.model_predictor
    if fault == "half":
        patch.setattr(program, "model_predictor", lambda t, *a, **kw:
                      predict(t.take_rows(0, t.n_rows // 2), *a, **kw))
    else:
        def altered(*a, **kw):
            lines = predict(*a, **kw)
            lines[0] = lines[0][:-1] + ("T" if lines[0][-1] == "F" else "F")
            return lines
        patch.setattr(program, "model_predictor", altered)


# each traffic kind's planter and the faults its cells can have (a scoring
# call has no state: its answer is the same every call)
BY_KIND: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {
    "forest_train": (forest, ("stale", "half", "altered")),
    "forest_job": (forest, ("stale", "half", "altered")),
    "knn_batches": (knn, ("stale", "half", "half_train", "short_lists",
                          "altered", "altered_class")),
    "forest_score": (score, ("half", "altered")),
}


def plant(patch, kind: str, fault: str) -> None:
    planter, faults = BY_KIND[kind]
    if fault not in faults:
        raise KeyError(f"traffic kind {kind} has no fault {fault!r}")
    planter(patch, fault)
