"""Class-imbalance samplers + Relief feature relevance: the port of
``avenir_tpu/explore/samplers.py``.

The distances are the port's ``DistanceComputer`` pairwise body on the
device, a tile of query rows at a time; the nearest same-class (or
other-class) rows are picked there too, with ties to the lowest row
index as the JAX package's stable ``argsort`` / ``argmin`` over the full
host matrix pick them: the key ``distance * n + index`` is unique, so
``topk`` and ``min`` over it are deterministic on every device.  Only the
picked indices come back.  The random draws are the JAX package's numpy
draws, in its order.

Parity targets (SURVEY.md §2.4):
  * TopMatchesByClass (explore/TopMatchesByClass.java) — per-class top-k
    nearest records; here one masked top-k over the device distance matrix.
  * ClassBasedOverSampler (explore/ClassBasedOverSampler.java) — SMOTE:
    synthetic minority records interpolated toward a random one of the k
    nearest same-class neighbors.
  * UnderSamplingBalancer (explore/UnderSamplingBalancer.java) — subsample
    the majority class at a rate (or to balance).
  * BaggingSampler (explore/BaggingSampler.java) — bootstrap batches.
  * ReliefFeatureRelevance (explore/ReliefFeatureRelevance.java:199-247):
    score[attr] += diff(nearest miss) - diff(nearest hit), normalized
    range-scaled numeric / 0-1 categorical diffs, divided by sample count.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.table import ColumnarTable
from ..ops.distance import DistanceComputer, euclid_pairwise, manhattan
from ..utils.tracing import fetch, layer, note_dispatch, note_h2d

# the JAX package's sentinel distance for an excluded pair
BIG = 1 << 40
# query rows a device tile takes
TILE = 2048


def _nearest(table: ColumnarTable, rows: np.ndarray, cands: np.ndarray,
             k: int, same_class: Optional[bool], metric: str, device=None,
             profile=None) -> np.ndarray:
    """For each query row in ``rows``, the table indices of its ``k``
    nearest rows among ``cands`` (itself excluded; with ``same_class``
    True only rows of its class, False only rows of another class, None
    any), nearest first with ties to the lowest index; -1 where fewer
    than k qualify.  Returns (len(rows), k) int64."""
    comp = DistanceComputer(table.schema, metric=metric, device=device)
    comp._check_metric()
    dev = comp.device
    with layer(profile, "encode"):
        num, oh = comp.encode(table)
        cls = table.class_codes().astype(np.int64)
    body = manhattan if metric == "manhattan" else euclid_pairwise
    with layer(profile, "h2d"):
        note_h2d(num[cands].nbytes + oh[cands].nbytes + cls.nbytes,
                 transfers=3)
        rn = comp._upload(num[cands])
        roh = comp._upload(oh[cands])
        cand_idx = torch.from_numpy(cands.astype(np.int64)).to(dev)
        cand_cls = torch.from_numpy(cls[cands]).to(dev)
    n = table.n_rows
    out = torch.empty((len(rows), k), dtype=torch.int64, device=dev)
    kk = min(k, len(cands))
    with layer(profile, "device"):
        for s in range(0, len(rows), TILE):
            q = rows[s:s + TILE]
            note_h2d(num[q].nbytes + oh[q].nbytes, transfers=2)
            note_dispatch()
            d = body(comp._upload(num[q]), comp._upload(oh[q]), rn, roh,
                     comp._n_cat, comp._denom, comp._fscale)
            d = d.to(torch.int32).to(torch.int64)
            qi = torch.from_numpy(q.astype(np.int64)).to(dev)
            keep = cand_idx[None, :] != qi[:, None]
            if same_class is not None:
                qc = torch.from_numpy(cls[q]).to(dev)
                same = cand_cls[None, :] == qc[:, None]
                keep &= same if same_class else ~same
            d = torch.where(keep, d, torch.full_like(d, BIG))
            key = d * n + cand_idx[None, :]
            top = torch.topk(key, kk, dim=1, largest=False,
                             sorted=True).values
            idx = torch.where(top // n < BIG, top % n,
                              torch.full_like(top, -1))
            if kk < k:
                idx = torch.cat([idx, torch.full((len(q), k - kk), -1,
                                                 dtype=torch.int64,
                                                 device=dev)], dim=1)
            out[s:s + len(q)] = idx
    with layer(profile, "readback"):
        return fetch(out)


def top_matches_by_class(table: ColumnarTable, k: int,
                         metric: str = "euclidean", device=None,
                         rows: Optional[np.ndarray] = None,
                         profile=None) -> np.ndarray:
    """(n, k) indices of each record's k nearest SAME-class neighbors
    (self excluded).  Missing neighbors (tiny classes) are -1.  With
    ``rows``, only those records' lists ((len(rows), k)), their candidates
    cut to the classes they hold (the same lists)."""
    cls = table.class_codes()
    if rows is None:
        rows = np.arange(table.n_rows)
    rows = np.asarray(rows, np.int64)
    cands = np.flatnonzero(np.isin(cls, np.unique(cls[rows])))
    return _nearest(table, rows, cands, k, True, metric, device, profile)


def smote_oversample(table: ColumnarTable, minority_class: str,
                     k: int = 5, multiplier: int = 1,
                     seed: int = 0, device=None,
                     profile=None) -> List[List[str]]:
    """Synthetic minority rows (as string records): numeric attrs
    interpolated x + u*(neighbor - x), categorical attrs picked from either
    parent — the ClassBasedOverSampler construction."""
    rng = np.random.default_rng(seed)
    schema = table.schema
    cls_field = schema.class_attr_field
    code = cls_field.cat_code(minority_class)
    minority = np.nonzero(table.class_codes() == code)[0]
    # only the minority rows' lists are read
    neighbors = np.full((table.n_rows, k), -1, np.int64)
    if len(minority):
        neighbors[minority] = top_matches_by_class(
            table, k, device=device, rows=minority, profile=profile)
    id_ord = schema.id_fields[0].ordinal if schema.id_fields else None
    out: List[List[str]] = []
    for rep in range(multiplier):
        for i in minority:
            cand = neighbors[i][neighbors[i] >= 0]
            if len(cand) == 0:
                continue
            j = int(rng.choice(cand))
            u = rng.random()
            row: List[str] = []
            for f in schema.fields:
                o = f.ordinal
                if f.id_field:
                    row.append(f"syn_{rep}_{i}")
                elif f.is_numeric:
                    a, b = table.columns[o][i], table.columns[o][j]
                    v = a + u * (b - a)
                    row.append(str(int(round(v))) if f.is_integer else f"{v:.6f}")
                elif f.is_categorical:
                    if o == cls_field.ordinal:
                        row.append(minority_class)
                    else:
                        src = i if rng.random() < 0.5 else j
                        codev = table.columns[o][src]
                        row.append(f.cardinality[codev] if codev >= 0 else "?")
                else:
                    row.append(table.str_columns.get(o, [""] * table.n_rows)[i])
            out.append(row)
    return out


def under_sample(table: ColumnarTable, majority_class: str,
                 rate: float, seed: int = 0) -> np.ndarray:
    """Boolean keep-mask: majority-class rows kept with probability rate,
    everything else kept (UnderSamplingBalancer)."""
    rng = np.random.default_rng(seed)
    code = table.schema.class_attr_field.cat_code(majority_class)
    cls = table.class_codes()
    keep = np.ones((table.n_rows,), dtype=bool)
    maj = cls == code
    keep[maj] = rng.random(int(maj.sum())) < rate
    return keep


def bagging_sample(n: int, rate: float, with_replacement: bool = True,
                   seed: int = 0) -> np.ndarray:
    """Indices of one bagging batch (BaggingSampler)."""
    rng = np.random.default_rng(seed)
    m = int(n * rate)
    if with_replacement:
        return rng.integers(0, n, m)
    return rng.permutation(n)[:m]


def relief_relevance(table: ColumnarTable, attr_ordinals: Sequence[int],
                     sample_count: Optional[int] = None,
                     metric: str = "euclidean", seed: int = 0,
                     device=None) -> Dict[int, float]:
    """Relief scores per attr: mean over samples of
    diff(x, nearest miss) - diff(x, nearest hit)
    (ReliefFeatureRelevance.java:199-247 with 1 hit + 1 miss per sample)."""
    rng = np.random.default_rng(seed)
    schema = table.schema
    n = table.n_rows
    allr = np.arange(n)
    # argmin over an all-excluded row is index 0, as numpy's
    hit_idx = np.maximum(_nearest(table, allr, allr, 1, True, metric,
                                  device)[:, 0], 0)
    miss_idx = np.maximum(_nearest(table, allr, allr, 1, False, metric,
                                   device)[:, 0], 0)

    samples = np.arange(n) if sample_count is None or sample_count >= n else \
        rng.permutation(n)[:sample_count]
    scores = {o: 0.0 for o in attr_ordinals}
    for o in attr_ordinals:
        f = schema.find_field_by_ordinal(o)
        col = table.columns[o]
        if f.is_numeric:
            rng_width = max(float(f.max) - float(f.min), 1e-12) \
                if f.max is not None and f.min is not None else \
                max(float(col.max() - col.min()), 1e-12)
            dh = np.abs(col[samples] - col[hit_idx[samples]]) / rng_width
            dm = np.abs(col[samples] - col[miss_idx[samples]]) / rng_width
        else:
            dh = (col[samples] != col[hit_idx[samples]]).astype(np.float64)
            dm = (col[samples] != col[miss_idx[samples]]).astype(np.float64)
        scores[o] = float((dm - dh).sum() / len(samples))
    return scores
