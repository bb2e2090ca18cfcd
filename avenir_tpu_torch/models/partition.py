"""Candidate-split scoring + physical data partitioning: the port of
``avenir_tpu/models/partition.py``.  The branch codes of every (record,
split) come from the port's ``tree.SplitSet`` on the device, and the
(split, segment, class) counts from one ``bincount`` of the composite key
there (exact integers, as the JAX package's one-hot counts are); the
criteria and the partitioning are its host code, copied, with the
``randomFromTop`` pick drawn from numpy as it draws it.

Parity targets (SURVEY.md §2.1, §2.4):
  * ClassPartitionGenerator (explore/ClassPartitionGenerator.java) — per
    (attribute, candidate split): weighted info stat under 4 criteria
    (util/AttributeSplitStat.java:40-43) and, for entropy/gini, the gain
    ratio vs a supplied parent info (reducer :515-548); at root (no
    cpg.split.attributes) emits the dataset's single info content value.
  * SplitGenerator (tree/SplitGenerator.java:31) — same job with
    tree-pipeline path conventions.
  * DataPartitioner (tree/DataPartitioner.java) — picks the best (or
    random-from-top) candidate split from the splits file (sorted descending
    by score, :157-201) and routes every record to its split segment,
    materializing ``split=<i>/segment=<j>/data/partition.txt`` (:102-128).

Split-key string formats (util/AttributeSplitHandler.java:130-245):
  numeric      ``30:60``            (split points; segment = #points past)
  categorical  ``[a, b]:[c]``       (value groups; segment = group index)

TPU design: all candidate splits are evaluated in ONE device pass — branch
codes for every (record, split) via SplitSet (vectorized predicates), then a
(split, segment, class) histogram by one-hot contraction; the 4 criteria are
closed-form reductions over that histogram.  The reference walks predicates
per record per split in the mapper and shuffles per (split, segment).

NaN guard: the reference's classConfidenceRatio produces NaN when a segment
has zero count for some class (0 * log 0); we evaluate the intended limit 0.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.schema import FeatureField, FeatureSchema
from ..core.table import ColumnarTable
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_h2d
from .tree import CandidateSplit, SplitSet, generate_candidate_splits, _info

ALG_ENTROPY = "entropy"
ALG_GINI = "giniIndex"
ALG_HELLINGER = "hellingerDistance"
ALG_CLASS_CONF = "classConfidenceRatio"


# --------------------------------------------------------------------------
# split-key formatting
# --------------------------------------------------------------------------

def split_key(split: CandidateSplit) -> str:
    """Reference split-key string for a candidate split."""
    if split.groups is not None:
        return ":".join("[" + ", ".join(g) + "]" for g in split.groups)
    return ":".join(_fmt_num(t) for t in split.thresholds)


def _fmt_num(t: float) -> str:
    return str(int(t)) if float(t).is_integer() else str(t)


def parse_split_key(field: FeatureField, key: str):
    """Returns (segment_fn, n_segments): segment_fn maps a raw string column
    -> int segment indices (AttributeSplitHandler Integer/CategoricalSplit
    .getSegmentIndex)."""
    if field.is_categorical:
        groups = []
        for part in key.split(":"):
            part = part.strip()
            if not (part.startswith("[") and part.endswith("]")):
                raise ValueError(f"bad categorical split key {key!r}")
            groups.append([v.strip() for v in part[1:-1].split(",")])
        value_to_seg = {v: i for i, g in enumerate(groups) for v in g}

        def seg_cat(col: np.ndarray) -> np.ndarray:
            out = np.empty(len(col), dtype=np.int32)
            for i, v in enumerate(col):
                try:
                    out[i] = value_to_seg[str(v)]
                except KeyError:
                    raise ValueError(f"split segment not found for {v!r}")
            return out

        return seg_cat, len(groups)

    points = np.asarray([float(p) for p in key.split(":")])

    def seg_num(col: np.ndarray) -> np.ndarray:
        vals = col.astype(np.float64)
        return (vals[:, None] > points[None, :]).sum(axis=1).astype(np.int32)

    return seg_num, len(points) + 1


# --------------------------------------------------------------------------
# split statistics over the (split, segment, class) histogram
# --------------------------------------------------------------------------

def split_histograms(table: ColumnarTable, splits: List[CandidateSplit],
                     chunk: int = 1 << 20, device=None) -> np.ndarray:
    """(S, B, C) class counts per split segment on the device — one
    composite-key count per row chunk (replaces the reference's
    per-record mapper emit + shuffle count).  A branch code outside [0, B)
    or an unknown class (-1) counts nowhere, as in the JAX package."""
    dev = resolve_device(device)
    schema = table.schema
    sset = SplitSet(splits, schema)
    X = sset.feature_matrix(table)
    cls = table.class_codes()
    C = len(schema.class_attr_field.cardinality or [])
    B = sset.max_branches
    S = sset.n_splits
    size = S * B * C
    out = torch.zeros(size, dtype=torch.int64, device=dev)
    s_off = (torch.arange(S, device=dev) * B)[None, :]
    for lo in range(0, table.n_rows, chunk):
        xb, cb = X[lo:lo + chunk], cls[lo:lo + chunk]
        note_h2d(xb.nbytes + cb.nbytes, transfers=2)
        codes = sset.branch_codes(torch.from_numpy(
            np.ascontiguousarray(xb)).to(dev)).long()            # (n, S)
        c = torch.from_numpy(np.ascontiguousarray(cb)).to(dev).long()
        valid = (codes >= 0) & (codes < B) & (c >= 0)[:, None]
        key = ((s_off + codes) * C + c[:, None].clamp(min=0))
        key = torch.where(valid, key, torch.full_like(key, size))
        out += torch.bincount(key.reshape(-1), minlength=size + 1)[:size]
    return fetch(out).reshape(S, B, C).astype(np.float64)


def _weighted_info(counts: np.ndarray, algo: str) -> float:
    """Population-weighted entropy/gini over segments
    (AttributeSplitStat.SplitInfoContent.processStat)."""
    seg_tot = counts.sum(axis=-1)                          # (B,)
    stats = _info(counts, algo, axis=-1)                   # (B,)
    total = seg_tot.sum()
    return float((stats * seg_tot).sum() / max(total, 1e-12))


def _hellinger(counts: np.ndarray) -> float:
    """sqrt(sum_seg (sqrt(n_s0/N0) - sqrt(n_s1/N1))^2)
    (AttributeSplitStat.SplitHellingerDistance.processStat)."""
    if counts.shape[-1] != 2:
        raise ValueError("Hellinger distance algorithm is only valid for "
                         "binary valued class attributes")
    class_tot = counts.sum(axis=0)                         # (2,)
    frac = counts / np.maximum(class_tot[None, :], 1e-12)  # (B, 2)
    d = np.sqrt(frac[:, 0]) - np.sqrt(frac[:, 1])
    return float(np.sqrt((d * d).sum()))


def _class_conf_ratio(counts: np.ndarray) -> float:
    """Weighted entropy of per-segment class-confidence ratios
    (AttributeSplitStat.SplitClassCofidenceRatio + SplitStatSegment
    .processClassConfidenceRatio)."""
    class_tot = counts.sum(axis=0)                         # (C,)
    conf = counts / np.maximum(class_tot[None, :], 1e-12)  # (B, C)
    conf_sum = conf.sum(axis=1, keepdims=True)
    ratio = conf / np.maximum(conf_sum, 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        logr = np.where(ratio > 0, np.log2(np.maximum(ratio, 1e-300)), 0.0)
    ent = -(ratio * logr).sum(axis=1)                      # (B,)
    seg_tot = counts.sum(axis=-1)
    total = seg_tot.sum()
    return float((ent * seg_tot).sum() / max(total, 1e-12))


def _intrinsic_value(counts: np.ndarray) -> float:
    """Entropy of the segment-population distribution
    (AttributeSplitStat.SplitStat.getInfoContent)."""
    seg_tot = counts.sum(axis=-1)
    return float(_info(seg_tot[None, :], "entropy", axis=-1)[0])


def split_stat(counts: np.ndarray, n_branches: int, algo: str) -> float:
    """One split's stat under the chosen criterion; ``counts`` is (B, C)
    with only the first ``n_branches`` rows meaningful."""
    counts = counts[:n_branches]
    if algo in (ALG_ENTROPY, ALG_GINI):
        return _weighted_info(counts, algo)
    if algo == ALG_HELLINGER:
        return _hellinger(counts)
    if algo == ALG_CLASS_CONF:
        return _class_conf_ratio(counts)
    raise ValueError(f"unknown split algorithm {algo!r}")


def root_info(table: ColumnarTable, algo: str) -> float:
    """Dataset-level info content — the root-mode output
    (ClassPartitionGenerator reducer :515-519)."""
    cls = table.class_codes()
    C = len(table.schema.class_attr_field.cardinality or [])
    counts = np.bincount(cls[cls >= 0], minlength=C).astype(np.float64)
    return float(_info(counts[None, :], algo, axis=-1)[0])


@dataclass
class ScoredSplit:
    attr: int
    key: str
    score: float        # gainRatio for entropy/gini; raw stat otherwise
    n_segments: int

    def to_line(self, delim: str = ",") -> str:
        return f"{self.attr}{delim}{self.key}{delim}{self.score:.9g}"


def score_candidate_splits(table: ColumnarTable, attrs: Sequence[int],
                           algo: str, parent_info: float, device=None
                           ) -> List[ScoredSplit]:
    """All candidate splits of the given attributes, scored.  For
    entropy/gini the emitted score is gainRatio = (parentInfo - stat) /
    intrinsicValue (reducer :536-538); other criteria emit the stat."""
    splits = generate_candidate_splits(table.schema, attrs)
    if not splits:
        return []
    hists = split_histograms(table, splits, device=device)
    out: List[ScoredSplit] = []
    for si, s in enumerate(splits):
        counts = hists[si]
        stat = split_stat(counts, s.n_branches, algo)
        if algo in (ALG_ENTROPY, ALG_GINI):
            iv = _intrinsic_value(counts[:s.n_branches])
            score = (parent_info - stat) / iv if iv > 0 else 0.0
        else:
            score = stat
        out.append(ScoredSplit(s.attr, split_key(s), score, s.n_branches))
    return out


# --------------------------------------------------------------------------
# data partitioning by a chosen split
# --------------------------------------------------------------------------

@dataclass
class ChosenSplit:
    index: int          # line index in the candidate file
    attr: int
    key: str
    score: float
    n_segments: int


def choose_split(lines: Sequence[str], schema: FeatureSchema,
                 strategy: str = "best", num_top: int = 5,
                 seed: Optional[int] = None,
                 delim: str = ";") -> ChosenSplit:
    """Pick from the candidate-splits file: descending score, 'best' takes
    the top, 'randomFromTop' a uniform pick among the first num_top
    (DataPartitioner.java:157-201)."""
    parsed = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        items = line.split(delim)
        parsed.append((i, int(items[0]), items[1], float(items[2])))
    if not parsed:
        raise ValueError("empty candidate splits file")
    parsed.sort(key=lambda t: -t[3])
    idx = 0
    if strategy == "randomFromTop":
        rng = np.random.default_rng(seed)
        idx = int(rng.integers(0, min(num_top, len(parsed))))
    i, attr, key, score = parsed[idx]
    field = schema.find_field_by_ordinal(attr)
    _, n_seg = parse_split_key(field, key)
    return ChosenSplit(i, attr, key, score, n_seg)


def partition_rows(raw_lines: Sequence[str], schema: FeatureSchema,
                   chosen: ChosenSplit, delim_regex: str = ","
                   ) -> List[List[str]]:
    """Route every input line to its split segment (PartitionerMapper
    :324-337); returns per-segment line lists (the reducer's part files)."""
    field = schema.find_field_by_ordinal(chosen.attr)
    seg_fn, n_seg = parse_split_key(field, chosen.key)
    pat = re.compile(delim_regex)
    lit = re.escape(delim_regex) == delim_regex
    vals = []
    kept = []
    for line in raw_lines:
        line = line.rstrip("\n")
        if not line:
            continue
        items = line.split(delim_regex) if lit else pat.split(line)
        vals.append(items[chosen.attr])
        kept.append(line)
    segs = seg_fn(np.asarray(vals, dtype=object)) if kept else np.array([])
    out: List[List[str]] = [[] for _ in range(n_seg)]
    for line, s in zip(kept, segs):
        out[int(s)].append(line)
    return out
