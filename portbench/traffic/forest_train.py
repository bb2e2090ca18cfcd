"""Back-to-back in-memory forest builds over one call-centre table made in
set-up: the nightly retrain's work without its parse.  Build ``i`` of the
window is seeded ``common.build_seed(--seed, i)``.

Check: the trees of builds drawn from the seed among the window's, model
file against the plain forest's (``reference/forest.py``)."""

from __future__ import annotations

from ..core import Reservoir
from ..gen import call_hangup
from ..reference import forest as plain
from ..work import b1
from .common import (build_seed, compare_builds, forest_params,
                     hangup_table)

ENTRY = "avenir_tpu_torch.models.forest.build_forest"
# (module, counter, kernel names): launches the program counted, held
# against the capture's kernel events
LAUNCH_COUNTERS = (("avenir_tpu_torch.kernels.histogram", "launches",
                    ("level_counts_mma_kernel", "level_counts_kernel")),)
WARM_BUILD = 4095


class Loop:
    def __init__(self, ctx):
        from avenir_tpu_torch.models import forest
        self.ctx = ctx
        self.forest = forest
        self.props = ctx.config["properties"]
        self.n = ctx.size("rows")
        self.cols = call_hangup.columns(ctx.rng(1), self.n)
        self.table = hangup_table(ctx.config, self.cols)
        self.kept = Reservoir(int(ctx.param("compare_builds")), ctx.seed)
        self.profile = None

    def _build(self, i: int):
        return self.forest.build_forest(
            self.table, forest_params(self.props,
                                      build_seed(self.ctx.seed, i)),
            device=self.ctx.device, profile=self.profile)

    def warm(self) -> None:
        self._build(WARM_BUILD)

    def call(self, i: int) -> int:
        models = self._build(i)
        slot = self.kept.wants(i)
        if slot is not None:
            self.kept.put(slot, i, models)
        return self.n

    def instrument(self, spans) -> None:
        self.profile = spans

    def release(self) -> None:
        self.table = None

    def b1_seconds(self, builds: int) -> float:
        p = self.props
        splits = plain.candidate_splits(self.ctx.config["schema"])
        bound = b1.build(self.n, int(p["dtb.num.trees"]), len(splits),
                         max(len(s["preds"]) for s in splits),
                         len(call_hangup.CLASSES),
                         int(p["dtb.max.depth.limit"]), 255,
                         float(p["dtb.sub.sampling.rate"]))
        return bound["seconds"] * builds

    def check(self):
        return compare_builds(self.ctx, self.cols, {
            i: [m.to_json() for m in models]
            for i, models in self.kept.items.items()})

    def control(self):
        """The plain forest with its split choice in float32, in the
        program's place, over as many builds as the check compares."""
        return compare_builds(self.ctx, self.cols, dict.fromkeys(
            range(int(self.ctx.param("compare_builds")))), low=True)
