"""What the traffic loops share: the run's context, the job settings as
the program's parameter objects, and the tables the loops hand the
program."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np


@dataclass
class Context:
    """One run of one cell.  ``sizes`` overrides the configuration's scale
    keys (the CPU tests run the same code at small sizes); ``device`` is
    the program's device; ``workdir`` is a directory of the run's own."""
    cell: dict
    config: dict
    seed: int
    device: str
    workdir: str
    sizes: Dict[str, int] = field(default_factory=dict)

    def size(self, key: str) -> int:
        return int(self.sizes.get(key, self.config[key]))

    def param(self, key: str):
        return self.sizes.get(key, self.cell["params"][key])

    def rng(self, *stream: int) -> np.random.Generator:
        """The generator of one input stream of this run's seed."""
        return np.random.default_rng([self.seed, *stream])


@dataclass
class Window:
    """What one window did: its calls, the rows they completed, each call's
    end in seconds from the window's start, and the window's length."""
    calls: int
    rows: int
    ends: List[float]
    seconds: float

    def end_to_end(self, cell: dict) -> Dict[str, float]:
        """The cell's end-to-end values other than ``setup_s``: its rate,
        all the window's rows over all its time."""
        return {cell["rate_metric"]: self.rows / self.seconds}


def closed_loop(loop, seconds: float, sync: Callable[[], None]) -> Window:
    """The window of every traffic kind that defines no ``window`` of its
    own: calls back to back, each as the last returns, until one ends past
    ``seconds``; the window closes once the device has finished."""
    calls = rows = 0
    ends: List[float] = []
    t0 = time.perf_counter()
    while True:
        rows += loop.call(calls)
        calls += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync()
    return Window(calls, rows, ends, time.perf_counter() - t0)


def feature_schema(config: dict):
    from avenir_tpu_torch.core.schema import FeatureSchema
    return FeatureSchema.from_dict(config["schema"])


def forest_params(props: dict, seed: int):
    """``randomForestBuilder``'s parameters from the job settings, as the
    job maps them (``cli/jobs.py`` ``_tree_params``)."""
    from avenir_tpu_torch.models.forest import ForestParams
    from avenir_tpu_torch.models.tree import TreeParams
    tree = TreeParams(
        split_algorithm=props["dtb.split.algorithm"],
        attr_select_strategy=props["dtb.split.attribute.selection.strategy"],
        random_split_set_size=int(props["dtb.random.split.set.size"]),
        split_select_strategy=props["dtb.split.select.strategy"],
        top_split_count=int(props["dtb.top.split.count"]),
        stopping_strategy=props["dtb.path.stopping.strategy"],
        max_depth=int(props["dtb.max.depth.limit"]),
        min_population=int(props["dtb.min.population.limit"]),
        sub_sampling=props["dtb.sub.sampling.strategy"],
        sub_sampling_rate=float(props["dtb.sub.sampling.rate"]),
        seed=seed)
    return ForestParams(tree=tree, num_trees=int(props["dtb.num.trees"]),
                        seed=seed)


def build_seed(seed: int, i: int) -> int:
    """``dtb.random.seed`` of build ``i`` of a run seeded ``seed``."""
    return (seed % (1 << 31)) * 4096 + i


def hangup_table(config: dict, cols: dict, fs=None):
    """A ``ColumnarTable`` of call-centre columns (``gen.call_hangup``)."""
    from avenir_tpu_torch.core.table import ColumnarTable
    fs = fs or feature_schema(config)
    n = len(cols["hungUp"])
    return ColumnarTable(schema=fs, n_rows=n, columns={
        1: cols["issueType"].astype(np.int32),
        2: cols["queueTimeSec"].astype(np.float64),
        3: cols["transferCount"].astype(np.float64),
        4: cols["priorCalls"].astype(np.float64),
        5: cols["hungUp"].astype(np.int32)})


def hangup_features(cols: dict) -> Dict[int, np.ndarray]:
    """The feature columns by ordinal, as the plain reference takes them."""
    return {1: cols["issueType"], 2: cols["queueTimeSec"],
            3: cols["transferCount"], 4: cols["priorCalls"]}



def compare_builds(ctx, cols: dict, outputs: dict, low: bool = False):
    """[(name, value)]: the forests of ``outputs`` ({build i: its model
    files}) against the plain forest's for the same seeds over ``cols``
    (tree mismatches summed, the probability gap the widest).  With
    ``low`` the outputs are replaced by the plain forest's own with its
    split choice in float32: the control."""
    import torch
    from ..gen import call_hangup
    from ..reference import forest as plain
    schema, props = ctx.config["schema"], ctx.config["properties"]
    splits = plain.candidate_splits(schema)
    codes = plain.branch_codes(splits, schema, hangup_features(cols),
                               ctx.device)
    cls = torch.as_tensor(cols["hungUp"], device=ctx.device)

    def grow(i, dtype=np.float64):
        return plain.build_forest(codes, cls, splits, call_hangup.CLASSES,
                                  props, build_seed(ctx.seed, i), dtype)
    if low:
        outputs = {i: [plain.model_json(t) for t in grow(i, np.float32)]
                   for i in outputs}
    mismatch, gap = 0.0, 0.0
    for i, files in sorted(outputs.items()):
        got = plain.compare_trees(files, grow(i))
        mismatch += got["tree_mismatch"]
        gap = max(gap, got["prob_gap"])
    return [("tree_mismatch", mismatch), ("prob_gap", gap)]
