"""The ``randomForestBuilder`` job as operators run it, called in process
through ``avenir_tpu_torch.cli.run``: a CSV in, one ``tree_<i>.json`` model
file a tree out.  Set-up writes the CSV of rows drawn from the seed, the
schema and the properties file into the run's own directory; every job
reads that CSV and overwrites one model directory.  Job ``i`` of the window
is seeded ``common.build_seed(--seed, i)`` through ``-Ddtb.random.seed``.

Check: the model files of jobs drawn from the seed among the window's,
against the plain forest's trees over the rows the CSV holds."""

from __future__ import annotations

import contextlib
import json
import os

import torch

from ..core import Reservoir
from ..gen import call_hangup
from .common import build_seed, compare_builds
from .forest_train import LAUNCH_COUNTERS, WARM_BUILD  # noqa: F401

ENTRY = "avenir_tpu_torch.cli.run.main randomForestBuilder"
JOB = "randomForestBuilder"


class Loop:
    def __init__(self, ctx):
        from avenir_tpu_torch.cli import run
        self.ctx = ctx
        self.run = run
        self.props = ctx.config["properties"]
        self.n = ctx.size("rows")
        self.cols = call_hangup.columns(ctx.rng(1), self.n)
        d = ctx.workdir
        self.csv = os.path.join(d, "calls.csv")
        with open(self.csv, "w") as fh:
            fh.write("\n".join(call_hangup.csv_lines(self.cols)))
            fh.write("\n")
        schema = os.path.join(d, "call_hangup.json")
        with open(schema, "w") as fh:
            json.dump(ctx.config["schema"], fh)
        self.conf = os.path.join(d, "rafo.properties")
        with open(self.conf, "w") as fh:
            for k, v in self.props.items():
                if k.startswith(("dtb.", "field.")):
                    fh.write(f"{k}={str(v).lower() if isinstance(v, bool) else v}\n")
            fh.write(f"dtb.feature.schema.file.path={schema}\n")
        self.out = os.path.join(d, "model")
        self.kept = Reservoir(int(ctx.param("compare_jobs")), ctx.seed)
        self.trees = int(self.props["dtb.num.trees"])

    def _job(self, i: int) -> None:
        argv = [JOB, f"-Dconf.path={self.conf}",
                f"-Ddtb.random.seed={build_seed(self.ctx.seed, i)}",
                f"-Dplatform={torch.device(self.ctx.device).type}",
                self.csv, self.out]
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            rc = self.run.main(argv)
        if rc != 0:
            raise RuntimeError(f"{JOB} exited {rc}")

    def warm(self) -> None:
        self._job(WARM_BUILD)

    def call(self, i: int) -> int:
        self._job(i)
        slot = self.kept.wants(i)
        if slot is not None:
            files = []
            for t in range(self.trees):
                with open(os.path.join(self.out, f"tree_{t}.json")) as fh:
                    files.append(fh.read())
            self.kept.put(slot, i, files)
        return self.n

    def instrument(self, spans) -> None:
        from avenir_tpu_torch.cli import jobs
        from avenir_tpu_torch.models import forest
        spans.wrap(jobs, "load_csv", "parse")
        # the job imports build_forest when it runs: hand it the spans as
        # its layer profile
        build = getattr(forest, "build_forest", None)
        if callable(build):
            forest.build_forest = lambda *a, **kw: build(
                *a, **{**kw, "profile": spans})

    def release(self) -> None:
        pass

    def check(self):
        return compare_builds(self.ctx, self.cols, self.kept.items)

    def control(self):
        """The plain forest with its split choice in float32, in the
        program's place, over as many jobs as the check compares."""
        return compare_builds(self.ctx, self.cols, dict.fromkeys(
            range(int(self.ctx.param("compare_jobs")))), low=True)
