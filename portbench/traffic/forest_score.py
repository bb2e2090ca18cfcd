"""Nightly scoring: repeated ``modelPredictor`` calls over one call-centre
table parsed in set-up with its raw records kept, writing each record with
its prediction (``mop.output.mode=withRecord``) and counting the errors
(``mop.error.counting.enabled``), as ``rafo.properties`` sets them.  The
forest is grown in set-up by the plain forest (``reference/forest.py``)
on a sample drawn from the seed, and handed to the program as model files:
nothing of the program's own making.  The seconds that takes are the
reference's, and the run leaves them out of ``setup_s`` (``reference_s``).

Check: the output lines of calls drawn from the seed, and every call's
error count, against the plain scorer's."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import Reservoir
from ..gen import call_hangup
from ..reference import forest as plain
from ..work import b2
from .common import build_seed, feature_schema, hangup_features

ENTRY = "avenir_tpu_torch.models.forest.model_predictor"
LAUNCH_COUNTERS = (("avenir_tpu_torch.kernels.vote", "launches",
                    ("vote_kernel",)),)
CLASS_ORDINAL = 5


class Loop:
    def __init__(self, ctx):
        from avenir_tpu_torch.core.table import load_csv_text
        from avenir_tpu_torch.models import forest
        from avenir_tpu_torch.models.tree import DecisionPathList
        self.ctx = ctx
        self.forest = forest
        self.props = ctx.config["properties"]
        self.fs = feature_schema(ctx.config)
        schema = ctx.config["schema"]
        t0 = time.perf_counter()
        sample = call_hangup.columns(ctx.rng(1),
                                     int(ctx.param("train_sample_rows")))
        splits = plain.candidate_splits(schema)
        codes = plain.branch_codes(splits, schema, hangup_features(sample),
                                   ctx.device)
        self.trees = plain.build_forest(
            codes, torch.as_tensor(sample["hungUp"], device=ctx.device),
            splits, call_hangup.CLASSES, self.props, build_seed(ctx.seed, 0))
        if ctx.device != "cpu":
            torch.cuda.synchronize()
        self.reference_s = time.perf_counter() - t0
        self.path_lists = [DecisionPathList.from_json(plain.model_json(t))
                           for t in self.trees]
        self.n = ctx.size("rows")
        self.cols = call_hangup.columns(ctx.rng(2), self.n)
        self.records = call_hangup.csv_lines(self.cols)
        self.table = load_csv_text("\n".join(self.records), self.fs,
                                   self.props["field.delim.regex"],
                                   keep_raw=True)
        self.kept = Reservoir(int(ctx.param("compare_calls")), ctx.seed)
        self.errors: list = []

    def _score(self):
        from avenir_tpu_torch.core.metrics import Counters
        counters = Counters()
        lines = self.forest.model_predictor(
            self.table, self.fs, self.path_lists,
            output_mode=self.props["mop.output.mode"],
            id_ordinal=int(self.props["mop.rec.id.ordinal"]),
            class_attr_ordinal=int(self.props["mop.class.attr.ord"]),
            error_counting=bool(self.props["mop.error.counting.enabled"]),
            counters=counters, device=self.ctx.device)
        return lines, counters.get("Prediction", "Error count")

    def warm(self) -> None:
        self._score()

    def call(self, i: int) -> int:
        lines, errors = self._score()
        self.errors.append(errors)
        slot = self.kept.wants(i)
        if slot is not None:
            self.kept.put(slot, i, lines)
        return self.n

    def instrument(self, spans) -> None:
        spans.wrap(self.forest, "ensemble_vote", "vote")
        spans.wrap(self.forest, "model_predictor", "score_call")

    def release(self) -> None:
        self.table = None

    def b2_seconds(self, calls: int) -> float:
        fields = [f for f in self.ctx.config["schema"]["fields"]
                  if f.get("feature")]
        fbytes = sum(1 if f["dataType"] == "categorical" else
                     (1 if f["max"] - f["min"] < 256 else 2) for f in fields)
        paths = max(len(t) for t in self.trees)
        return b2.call(self.n, len(self.trees), paths,
                       int(self.props["dtb.max.depth.limit"]), fbytes,
                       len(fields))["seconds"] * calls

    def _judge(self, outputs, errors):
        want = plain.predict(self.trees, self.ctx.config["schema"],
                             hangup_features(self.cols))
        want_lines = [f"{r},{p}" for r, p in zip(self.records, want)]
        want_errors = int((want != np.asarray(call_hangup.CLASSES)[
            self.cols["hungUp"]]).sum())
        mismatch = 0
        for lines in outputs:
            mismatch = max(mismatch, self.n if len(lines) != self.n else
                           sum(a != b for a, b in zip(lines, want_lines)))
        gap = max((abs(e - want_errors) for e in errors), default=0)
        return [("line_mismatch", float(mismatch)),
                ("error_count_gap", float(gap))]

    def check(self):
        return self._judge(list(self.kept.items.values()), self.errors)

    def control(self):
        """The plain scorer with its threshold compares in bfloat16, in the
        program's place."""
        low = plain.predict(self.trees, self.ctx.config["schema"],
                            hangup_features(self.cols), bfloat16=True)
        lines = [f"{r},{p}" for r, p in zip(self.records, low)]
        errors = int((low != np.asarray(call_hangup.CLASSES)[
            self.cols["hungUp"]]).sum())
        return self._judge([lines], [errors])
