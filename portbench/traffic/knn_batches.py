"""KNN classification of successive test batches against a served train
set: the train rows are encoded and uploaded in set-up, and each window
call classifies one batch as ``knnPipeline`` does.  The batches cycle
through a pool drawn from the seed in set-up, so no draw runs in the
window.

Check: batches drawn from the seed among the window's; each list's length
against the configuration's k, each listed neighbour's distance and rank
and each class against the exact plain KNN (``reference/knn.py``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import Reservoir
from ..gen import elearn
from ..reference import knn as plain
from ..work import b5
from .common import feature_schema

ENTRY = ("avenir_tpu_torch.ops.distance.DistanceComputer.pairwise_topk, "
         "then avenir_tpu_torch.models.knn.classify_topk")
LAUNCH_COUNTERS = (("avenir_tpu_torch.kernels.topk", "launches",
                    ("topk_kernel",)),)


def _table(fs, cols: dict):
    from avenir_tpu_torch.core.table import ColumnarTable
    n = len(cols["outcome"])
    return ColumnarTable(schema=fs, n_rows=n, columns={
        1: cols["videoHours"], 2: cols["quizScore"], 3: cols["forumPosts"],
        4: cols["assignmentsDone"], 5: cols["outcome"].astype(np.int32)})


def _features(cols: dict) -> np.ndarray:
    return np.stack([cols[f] for f in elearn.FEATURES], axis=1)


def ranges(schema: dict) -> list:
    """Each feature's range ``max - min``, 1 where the schema states none."""
    out = []
    for name in elearn.FEATURES:
        f = next(f for f in schema["fields"] if f["name"] == name)
        out.append(float(f["max"]) - float(f["min"])
                   if f.get("max") is not None and f.get("min") is not None
                   else 1.0)
    return out


class Loop:
    def __init__(self, ctx):
        from avenir_tpu_torch.models import knn
        from avenir_tpu_torch.models.knn import KnnParams
        from avenir_tpu_torch.ops.distance import DistanceComputer
        self.ctx = ctx
        self.knn = knn
        p = ctx.config["properties"]
        fs = feature_schema(ctx.config)
        self.nr = ctx.size("train_rows")
        self.nt = int(ctx.param("test_rows"))
        self.train_cols = elearn.columns(ctx.rng(1), self.nr)
        self.train = _table(fs, self.train_cols)
        self.pool = [elearn.columns(ctx.rng(2, b), self.nt)
                     for b in range(int(ctx.param("pool_batches")))]
        self.tables = [_table(fs, c) for c in self.pool]
        self.comp = DistanceComputer(fs, metric=p["sts.distance.metric"],
                                     scale=int(p["sts.distance.scale"]),
                                     device=ctx.device)
        self.k = min(int(p["nen.top.match.count"]), self.nr)
        pos, neg = p["nen.class.attribute.values"].split(",")
        self.params = KnnParams(
            top_match_count=int(p["nen.top.match.count"]),
            kernel_function=p["nen.kernel.function"],
            inverse_distance_weighted=bool(p["nen.inverse.distance.weighted"]),
            pos_class=pos, neg_class=neg)
        # votes over the sorted class values, as knnPipeline casts them
        self.class_values = sorted(elearn.CLASSES)
        remap = np.array([self.class_values.index(c) for c in elearn.CLASSES])
        self.train_codes = remap[self.train_cols["outcome"]].astype(np.int32)
        self.kept = Reservoir(int(ctx.param("compare_batches")), ctx.seed)
        self.batch_s: list = []
        self.classify = knn.classify_topk

    def _classify(self, test):
        nd, idx = self.comp.pairwise_topk(test, self.train, self.k)
        res = self.classify(nd, self.train_codes[idx], self.class_values,
                            self.params)
        return nd, idx, res.pred_class

    def warm(self) -> None:
        # the pool's last batch: the window starts at its first
        self._classify(self.tables[-1])

    def call(self, i: int) -> int:
        t0 = time.perf_counter()
        out = self._classify(self.tables[i % len(self.tables)])
        self.batch_s.append(time.perf_counter() - t0)
        slot = self.kept.wants(i)
        if slot is not None:
            self.kept.put(slot, i, out)
        return self.nt

    def instrument(self, spans) -> None:
        from avenir_tpu_torch.kernels import topk
        spans.wrap(topk, "topk_scan", "topk")
        self.classify = lambda *a: _spanned(spans, "classify",
                                            self.knn.classify_topk, *a)

    def release(self) -> None:
        self.comp = None

    def b5_seconds(self, batches: int) -> float:
        return b5.batch(self.nt, self.nr, len(elearn.FEATURES), 0, self.k,
                        self.ctx.config["properties"]["sts.distance.metric"]
                        )["seconds"] * batches

    def _judge(self, lists):
        """The compared numbers, worst over ``lists``: {batch: (d, i,
        classes)}."""
        dev = self.ctx.device
        schema = self.ctx.config["schema"]
        scale = int(self.ctx.config["properties"]["sts.distance.scale"])
        train = torch.as_tensor(_features(self.train_cols), device=dev)
        worst = {"dist_gap": 0.0, "rank_gap": 0.0, "beyond_kth_pct": 0.0,
                 "class_mismatch": 0.0}
        for b, (d, i, cls) in sorted(lists.items()):
            test = torch.as_tensor(_features(self.pool[b % len(self.pool)]),
                                   device=dev)
            codes = np.array([self.class_values.index(c) for c in cls])
            got = plain.judge(test, train, self.train_codes, ranges(schema),
                              scale, self.k, np.asarray(d), np.asarray(i),
                              codes, len(self.class_values))
            worst = {k: max(v, got[k]) for k, v in worst.items()}
        return list(worst.items())

    def check(self):
        return self._judge(self.kept.items)

    def control(self):
        """The plain KNN with its distances in bfloat16, in the program's
        place, over the batches the window would check."""
        dev = self.ctx.device
        schema = self.ctx.config["schema"]
        scale = int(self.ctx.config["properties"]["sts.distance.scale"])
        train = torch.as_tensor(_features(self.train_cols), device=dev)
        lists = {}
        for b in range(int(self.ctx.param("compare_batches"))):
            test = torch.as_tensor(_features(self.pool[b]), device=dev)
            d, i = plain.nearest(test, train, ranges(schema), scale, self.k,
                                 dtype=torch.bfloat16)
            cls = plain.vote(self.train_codes[i], len(self.class_values))
            lists[b] = (d, i, [self.class_values[c] for c in cls])
        return self._judge(lists)


def _spanned(spans, name, fn, *args):
    with spans.layer(name):
        return fn(*args)
