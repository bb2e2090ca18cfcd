"""Candidate-split generation + data-partitioning jobs: the port of
``avenir_tpu/cli/partition_jobs.py``.  Both jobs run on the process's
device (``cuda`` unless ``-Dplatform=cpu``) and raise without a GPU when
asked for one.

Namespaces: cpg.* (explore/ClassPartitionGenerator.java:485-510), dap.*
(tree/DataPartitioner.java:135-201,296-321).  SplitGenerator
(tree/SplitGenerator.java) is the same job as ClassPartitionGenerator with
tree-pipeline path conventions; both names resolve here.
"""

from __future__ import annotations

import os

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..core.table import load_csv
from ..runtime import resolve_device
from .jobs import _schema_path, register


@register("org.avenir.explore.ClassPartitionGenerator",
          "classPartitionGenerator",
          "org.avenir.tree.SplitGenerator", "splitGenerator",
          dist="gather")
def class_partition_generator(cfg: Config, in_path: str, out_path: str
                              ) -> Counters:
    """Scores every candidate split of the configured attributes (or emits
    the dataset info content at root).  Keys: cpg.feature.schema.file.path,
    cpg.split.algorithm, cpg.split.attributes (absent -> root mode),
    cpg.parent.info."""
    from ..models import partition as PT
    dev = resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "cpg.feature.schema.file.path")
    algo = cfg.get("cpg.split.algorithm", "giniIndex")
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    attrs = cfg.get_int_list("cpg.split.attributes")
    if not attrs:
        stat = PT.root_info(table, algo)
        artifacts.write_text_output(out_path, [f"{stat}"])
        counters.increment("Splits", "rootInfo", 1)
        return counters
    parent_info = cfg.must_get_float("cpg.parent.info",
                                     "missing parent info")
    scored = PT.score_candidate_splits(table, attrs, algo, parent_info,
                                       device=dev)
    # the splits file uses its own delimiter (default ';') so categorical
    # keys containing ',' stay parseable — matching DataPartitioner's
    # hardcoded ';' line format (DataPartitioner.java:216)
    delim = cfg.get("cpg.split.file.delim", ";")
    artifacts.write_text_output(out_path,
                                [s.to_line(delim) for s in scored])
    counters.increment("Splits", "candidates", len(scored))
    return counters


@register("org.avenir.tree.DataPartitioner", "dataPartitioner",
          dist="gather")
def data_partitioner(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Physically partitions data by the chosen candidate split into
    ``split=<i>/segment=<j>/data/partition.txt`` under out_path
    (DataPartitioner.java:102-128).  Keys: dap.feature.schema.file.path,
    dap.candidate.splits.path (default: sibling ``splits/part-r-00000`` of
    the input, :162), dap.split.selection.strategy (best|randomFromTop),
    dap.num.top.splits, dap.split.file.delim (default ';' — the pipeline
    writes the splits file with that field.delim.out so categorical keys
    containing ',' stay parseable), dap.seed."""
    from ..models import partition as PT
    resolve_device()
    counters = Counters()
    schema = _schema_path(cfg, "dap.feature.schema.file.path")
    cand_path = cfg.get("dap.candidate.splits.path")
    if not cand_path:
        cand_path = os.path.join(os.path.dirname(in_path.rstrip("/")),
                                 "splits", "part-r-00000")
    lines = artifacts.read_text_input(cand_path)
    chosen = PT.choose_split(
        lines, schema,
        strategy=cfg.get("dap.split.selection.strategy", "best"),
        num_top=cfg.get_int("dap.num.top.splits", 5),
        seed=cfg.get_int("dap.seed"),
        delim=cfg.get("dap.split.file.delim", ";"))
    raw = artifacts.read_text_input(in_path)
    segments = PT.partition_rows(raw, schema, chosen, cfg.field_delim_regex)
    split_dir = os.path.join(out_path, f"split={chosen.index}")
    for j, seg_lines in enumerate(segments):
        seg_dir = os.path.join(split_dir, f"segment={j}", "data")
        os.makedirs(seg_dir, exist_ok=True)
        with open(os.path.join(seg_dir, "partition.txt"), "w") as fh:
            fh.write("\n".join(seg_lines) + ("\n" if seg_lines else ""))
        counters.increment("Partition", f"segment_{j}_rows", len(seg_lines))
    counters.increment("Partition", "segments", len(segments))
    return counters
