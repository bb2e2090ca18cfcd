"""Decision tree: port of ``avenir_tpu/models/tree.py``, both halves.

Predict half:
  * ``Predicate`` / ``DecisionPath`` / ``DecisionPathList`` — the model
    artifact, round-tripped through the reference's exact Jackson JSON
    (tree/DecisionPathList.java; bytes identical to the JAX package's);
  * ``PathMatrix`` — a path list compiled to dense predicate tensors: per
    path and feature, one (lo, hi] interval for numeric predicates and an
    allowed-code mask for categorical ones;
  * ``DecisionTreeModel.predict`` — first matching path per record, with
    the population-weighted fallback class.

Single-tree forests serve through this per-tree path.  It has no TPU
kernel in the reference, so its device form is plain torch
(:func:`_match_paths_torch`); the float64 numpy twin
(:func:`_match_paths_np`) runs when the data does not round-trip float32
exactly.

Builder half (level-synchronous growth, tree/DecisionTreeBuilder.java):
  * candidate splits from the schema knobs (``generate_candidate_splits``)
    and their branch evaluator ``SplitSet`` — every record's branch under
    every split, computed once on the device;
  * ``TreeBuilder`` — per level, the (node, split, branch, class) weighted
    histogram of the frontier through the level-histogram kernel
    (``kernels/histogram.py``, one tree = T of 1), the host epilogue that
    picks each node's split in float64 numpy, and the on-device reassign of
    records to child nodes (torch gathers; the reference's is XLA, not
    Pallas).  The host epilogue and every random draw follow the JAX
    package's code and call order, so the trees are byte-identical.

Streamed ingest (``TreeBuilder.from_stream``) assembles the same device
state from CSV row blocks: a staging thread encodes block i+1 and uploads
it from pinned memory on a side CUDA stream while the consumer computes
block i's branch codes, with checkpoints of the accumulated state every N
blocks and resume from one.  A monolithic build pads nothing
(``n_padded == n_rows``); a restored checkpoint written by the JAX package
on a device mesh carries its pad rows, and weights are placed by mask
position over the true row count.  Cross-process count reduction is not
ported yet.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import random as pyrandom
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.schema import FeatureField, FeatureSchema
from ..core.table import ColumnarTable, stage_chunks
from ..kernels.dispatch import BACKEND_CUDA, note_backend, resolve_backend
from ..kernels.histogram import forest_level_counts, level_form
from ..runtime import resolve_device
from ..utils.tracing import fetch, layer, note_dispatch, note_h2d

ROOT_PATH = "$root"
PRED_DELIM = ";"           # dtb.dec.path.delim default


# --------------------------------------------------------------------------
# predicates and the model artifact
# --------------------------------------------------------------------------

@dataclass
class Predicate:
    """One arm of a split; serializes to the reference predicate string
    '<attr> le <v> [<lower>]' / '<attr> gt <v>' / '<attr> in a:b'."""
    attribute: int
    operator: str                      # 'le' | 'gt' | 'in' | None for root
    value_int: int = 0
    value_dbl: float = 0.0
    categorical_values: Optional[List[str]] = None
    other_bound_int: Optional[int] = None
    other_bound_dbl: Optional[float] = None
    is_int: bool = True
    pred_str: str = ""

    @classmethod
    def root(cls) -> "Predicate":
        return cls(attribute=0, operator=None, pred_str=ROOT_PATH)

    @classmethod
    def num(cls, attr: int, op: str, value, other=None,
            is_int=True) -> "Predicate":
        p = cls(attribute=attr, operator=op, is_int=is_int)
        if is_int:
            p.value_int = int(value)
            p.other_bound_int = None if other is None else int(other)
            s = f"{attr} {op} {int(value)}"
            if other is not None:
                s += f" {int(other)}"
        else:
            p.value_dbl = float(value)
            p.other_bound_dbl = None if other is None else float(other)
            s = f"{attr} {op} {p.value_dbl}"
            if other is not None:
                s += f" {p.other_bound_dbl}"
        p.pred_str = s
        return p

    @classmethod
    def cat(cls, attr: int, values: Sequence[str]) -> "Predicate":
        vals = list(values)
        return cls(attribute=attr, operator="in", categorical_values=vals,
                   pred_str=f"{attr} in {':'.join(vals)}")

    def to_dict(self) -> Dict[str, Any]:
        """Jackson field layout of DecisionPathList.DecisionPathPredicate."""
        return {
            "attribute": self.attribute,
            "predicateStr": self.pred_str,
            "operator": self.operator,
            "valueInt": self.value_int,
            "valueDbl": self.value_dbl,
            "categoricalValues": self.categorical_values,
            "otherBoundInt": self.other_bound_int,
            "otherBoundDbl": self.other_bound_dbl,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Predicate":
        return cls(attribute=d.get("attribute", 0),
                   operator=d.get("operator"),
                   value_int=d.get("valueInt", 0) or 0,
                   value_dbl=d.get("valueDbl", 0.0) or 0.0,
                   categorical_values=d.get("categoricalValues"),
                   other_bound_int=d.get("otherBoundInt"),
                   other_bound_dbl=d.get("otherBoundDbl"),
                   pred_str=d.get("predicateStr", ""))

    @property
    def threshold(self) -> float:
        """Numeric comparison value: valueDbl wins when set (Jackson leaves the
        unused slot at 0, mirroring DecisionPathPredicate's int/dbl pair)."""
        return self.value_dbl if self.value_dbl != 0.0 else float(self.value_int)

    @property
    def lower_bound(self) -> Optional[float]:
        if self.other_bound_int is not None:
            return float(self.other_bound_int)
        return self.other_bound_dbl


@dataclass
class DecisionPath:
    predicates: List[Predicate]
    population: int
    info_content: float
    stopped: bool
    class_val_pr: Dict[str, float]

    @property
    def path_str(self) -> str:
        return PRED_DELIM.join(p.pred_str for p in self.predicates)

    def predicted_class(self) -> Tuple[str, float]:
        return max(self.class_val_pr.items(), key=lambda kv: kv[1])

    def to_dict(self) -> Dict[str, Any]:
        return {
            "stopped": self.stopped,
            "classValPr": self.class_val_pr,
            "infoContent": self.info_content,
            "predicates": [p.to_dict() for p in self.predicates],
            "population": self.population,
        }


@dataclass
class DecisionPathList:
    decision_paths: List[DecisionPath] = dc_field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({"decisionPaths": [p.to_dict()
                                             for p in self.decision_paths]},
                          indent=3)

    @classmethod
    def from_json(cls, text: str) -> "DecisionPathList":
        d = json.loads(text)
        paths = []
        for pd in d.get("decisionPaths", []):
            paths.append(DecisionPath(
                predicates=[Predicate.from_dict(x)
                            for x in pd.get("predicates", [])],
                population=pd.get("population", 0),
                info_content=pd.get("infoContent", 0.0),
                stopped=pd.get("stopped", False),
                class_val_pr=pd.get("classValPr", {})))
        return cls(decision_paths=paths)


# --------------------------------------------------------------------------
# batched path matching (tree/DecisionTreeModel.java)
# --------------------------------------------------------------------------

def _match_ok_np(vals, codes, lo, hi, num_restricted, cat_mask,
                 cat_restricted):
    """(n, P) bool match matrix, numpy float64: a record matches a path iff
    every restricted feature passes its interval / allowed-code mask."""
    P, F = lo.shape
    interval = (vals[:, None, :] > lo[None]) & (vals[:, None, :] <= hi[None])
    num_ok = np.where(num_restricted[None], interval, True)
    C = cat_mask.shape[2]
    safe = np.clip(codes, 0, C - 1)
    gathered = cat_mask[np.arange(P)[None, :, None],
                        np.arange(F)[None, None, :],
                        safe[:, None, :]]                      # (n, P, F)
    cat_ok = np.where(cat_restricted[None],
                      gathered & (codes >= 0)[:, None, :], True)
    return (num_ok & cat_ok).all(axis=2)


def _match_ok_torch(vals, codes, lo, hi, num_restricted, cat_mask,
                    cat_restricted):
    """The torch form of :func:`_match_ok_np` (float32 on the device)."""
    P, F = lo.shape
    v = vals.to(torch.float32)[:, None, :]
    num_ok = ((v > lo[None]) & (v <= hi[None])) | ~num_restricted[None]
    C = cat_mask.shape[2]
    safe = codes.clamp(0, C - 1).long()
    gathered = cat_mask.permute(1, 2, 0)[
        torch.arange(F, device=codes.device)[None, :], safe]   # (n, F, P)
    cat_ok = (gathered.permute(0, 2, 1) & (codes >= 0)[:, None, :]) \
        | ~cat_restricted[None]
    return (num_ok & cat_ok).all(dim=2)


def _match_paths_torch(vals, codes, lo, hi, num_restricted, cat_mask,
                       cat_restricted, path_cls, path_prob, fallback_cls,
                       fallback_prob):
    """All paths x all records in one pass; first matching path wins,
    unmatched records take the fallback class.  -> (cls int32, prob f32)."""
    ok = _match_ok_torch(vals, codes, lo, hi, num_restricted, cat_mask,
                         cat_restricted)
    matched = ok.any(dim=1)
    first = ok.to(torch.uint8).argmax(dim=1)
    cls = torch.where(matched, path_cls[first],
                      torch.tensor(int(fallback_cls), dtype=torch.int32,
                                   device=vals.device))
    prob = torch.where(matched, path_prob[first],
                       torch.tensor(float(fallback_prob), dtype=torch.float32,
                                    device=vals.device))
    return cls.to(torch.int32), prob.to(torch.float32)


def _match_paths_np(vals, codes, lo, hi, num_restricted, cat_mask,
                    cat_restricted, path_cls, path_prob,
                    fallback_cls, fallback_prob):
    """Host float64 twin of :func:`_match_paths_torch` — used when the data
    does not round-trip float32 exactly (a value near a split threshold
    could flip branches under f32 rounding)."""
    ok = _match_ok_np(vals, codes, lo, hi, num_restricted, cat_mask,
                      cat_restricted)
    matched = ok.any(axis=1)
    first = np.argmax(ok, axis=1)
    cls = np.where(matched, path_cls[first], fallback_cls)
    prob = np.where(matched, path_prob[first], fallback_prob)
    return cls.astype(np.int32), prob.astype(np.float32)


class FeatureCache:
    """Per-table feature arrays shared across ensemble members: host build
    once, host->device upload once.  Valid for PathMatrix instances over the
    same schema (their feature layout is identical by construction).  A
    cache is bound to the FIRST table it sees and fails loudly on reuse
    with a different one."""

    def __init__(self):
        self._host = None
        self._dev = None
        self._table_id = None

    def host(self, matrix: "PathMatrix", table: ColumnarTable):
        if self._host is None:
            self._host = matrix.feature_arrays(table)
            self._table_id = id(table)
        elif self._table_id != id(table):
            raise ValueError("FeatureCache reused across tables; create one "
                             "cache per table")
        return self._host

    def device(self, vals: np.ndarray, codes: np.ndarray, device):
        """(vals float32, codes int32) tensors on ``device`` — the f32 wire
        form; callers have checked that the values round-trip float32."""
        if self._dev is None:
            v = np.ascontiguousarray(vals, dtype=np.float32)
            c = np.ascontiguousarray(codes, dtype=np.int32)
            note_h2d(v.nbytes + c.nbytes, transfers=2)
            self._dev = (torch.from_numpy(v).to(device),
                         torch.from_numpy(c).to(device))
        return self._dev


class PathMatrix:
    """A DecisionPathList compiled to dense predicate tensors.

    Per path and feature column the predicate chain collapses to
      * numeric: one (lo, hi] interval — 'le t' chains intersect to
        (lower_bound, t], 'gt t' to (t, +inf);
      * categorical: an allowed-code bitmask (intersection of 'in' sets)."""

    def __init__(self, path_list: DecisionPathList, schema: FeatureSchema):
        paths = path_list.decision_paths
        feat_fields = schema.feature_fields
        self.feat_ordinals = [f.ordinal for f in feat_fields]
        col_of = {o: i for i, o in enumerate(self.feat_ordinals)}
        P, F = len(paths), len(feat_fields)
        cmax = max([len(f.cardinality or []) for f in feat_fields
                    if f.is_categorical] + [1])
        lo = np.full((P, F), -np.inf, dtype=np.float64)
        hi = np.full((P, F), np.inf, dtype=np.float64)
        cat_mask = np.ones((P, F, cmax), dtype=bool)
        num_restricted = np.zeros((P, F), dtype=bool)
        cat_restricted = np.zeros((P, F), dtype=bool)
        for pi, path in enumerate(paths):
            for pred in path.predicates:
                if pred.pred_str == ROOT_PATH or pred.operator is None:
                    continue
                ci = col_of[pred.attribute]
                f = schema.find_field_by_ordinal(pred.attribute)
                if pred.operator == "in":
                    m = np.zeros((cmax,), dtype=bool)
                    for v in pred.categorical_values or []:
                        code = f.cat_code(v)
                        if code >= 0:
                            m[code] = True
                    cat_mask[pi, ci] &= m
                    # explicit flag: even an all-values 'in' must still reject
                    # unknown codes
                    cat_restricted[pi, ci] = True
                elif pred.operator == "le":
                    hi[pi, ci] = min(hi[pi, ci], pred.threshold)
                    if pred.lower_bound is not None:
                        lo[pi, ci] = max(lo[pi, ci], pred.lower_bound)
                    num_restricted[pi, ci] = True
                elif pred.operator == "gt":
                    lo[pi, ci] = max(lo[pi, ci], pred.threshold)
                    num_restricted[pi, ci] = True
                else:
                    raise ValueError(f"bad operator {pred.operator}")
        self.lo, self.hi = lo, hi
        self.cat_mask = cat_mask
        self.num_restricted = num_restricted
        self.cat_restricted = cat_restricted
        self.is_cat_col = np.array([f.is_categorical for f in feat_fields],
                                   dtype=bool)
        # bounds survive float32 exactly? (decides device-f32 eligibility)
        fin = np.isfinite(lo)
        self._bounds_f32_exact = bool(
            (lo[fin].astype(np.float32).astype(np.float64) == lo[fin]).all())
        fin = np.isfinite(hi)
        self._bounds_f32_exact &= bool(
            (hi[fin].astype(np.float32).astype(np.float64) == hi[fin]).all())
        self._dev_consts = {}   # device -> resident constants
        # per-path predicted class / prob, over the union class vocabulary
        self.classes: List[str] = sorted(
            {cv for p in paths for cv in p.class_val_pr})
        cls_idx = {c: i for i, c in enumerate(self.classes)}
        self.path_cls = np.array(
            [cls_idx[p.predicted_class()[0]] if p.class_val_pr else 0
             for p in paths], dtype=np.int32)
        self.path_prob = np.array(
            [p.predicted_class()[1] if p.class_val_pr else 0.0 for p in paths],
            dtype=np.float32)
        # fallback for unmatched records: population-weighted class vote
        agg: Dict[str, float] = {}
        for p in paths:
            for cv, pr in p.class_val_pr.items():
                agg[cv] = agg.get(cv, 0.0) + pr * p.population
        self.fallback_cls = np.int32(
            cls_idx[max(agg.items(), key=lambda kv: kv[1])[0]]) if agg \
            else np.int32(0)
        self.n_paths = P

    def feature_arrays(self, table: ColumnarTable
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(vals float64, codes int32), both (n, F).  Only the columns a
        comparison kind actually reads are cast: categorical slots in ``vals``
        (and numeric slots in ``codes``) stay zero."""
        n = table.n_rows
        F = len(self.feat_ordinals)
        vals = np.zeros((n, F), dtype=np.float64)
        codes = np.zeros((n, F), dtype=np.int32)
        for i, o in enumerate(self.feat_ordinals):
            if self.is_cat_col[i]:
                codes[:, i] = table.columns[o].astype(np.int32)
            else:
                vals[:, i] = table.columns[o].astype(np.float64)
        return vals, codes

    def _device_consts(self, device: torch.device):
        consts = self._dev_consts.get(device)
        if consts is None:
            consts = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                           for a in (self.lo.astype(np.float32),
                                     self.hi.astype(np.float32),
                                     self.num_restricted, self.cat_mask,
                                     self.cat_restricted, self.path_cls,
                                     self.path_prob))
            self._dev_consts[device] = consts
        return consts

    def _f32_safe(self, vals: np.ndarray) -> bool:
        """Shared backend gate: the f32 device path runs only when every
        value AND bound round-trips float32 exactly (always true for the
        integer scan grids the split manager produces); otherwise the
        float64 host twin runs so a value half-an-ulp from a threshold
        cannot flip branches relative to the reference's double math."""
        fin = np.isfinite(vals)
        return self._bounds_f32_exact and bool(
            (vals[fin].astype(np.float32).astype(np.float64) == vals[fin])
            .all())

    def _row_chunk(self, chunk: int) -> int:
        """Keep the per-chunk device intermediates around 2^26 elements."""
        F = max(len(self.feat_ordinals), 1)
        per_row = max(self.n_paths * F, F * self.cat_mask.shape[2], 1)
        return max(1024, min(chunk, (1 << 26) // per_row))

    def predict_codes(self, table: ColumnarTable, device,
                      chunk: int = 1 << 20,
                      features: Optional[FeatureCache] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(class idx per record, prob) as arrays; row-chunked, f32 device
        path or f64 host twin per the shared ``_f32_safe`` gate."""
        cache = features if features is not None else FeatureCache()
        vals, codes = cache.host(self, table)
        n = table.n_rows
        if n == 0 or self.n_paths == 0 or not self.classes:
            return (np.zeros((n,), np.int32) - 1, np.zeros((n,), np.float32))
        chunk = self._row_chunk(chunk)
        if not self._f32_safe(vals):
            out = [_match_paths_np(vals[s:s + chunk], codes[s:s + chunk],
                                   self.lo, self.hi, self.num_restricted,
                                   self.cat_mask, self.cat_restricted,
                                   self.path_cls, self.path_prob,
                                   self.fallback_cls, np.float32(0.5))
                   for s in range(0, n, chunk)]
            return (np.concatenate([c for c, _ in out]),
                    np.concatenate([p for _, p in out]))
        device = torch.device(device)
        d_vals, d_codes = cache.device(vals, codes, device)
        consts = self._device_consts(device)
        out_cls, out_prob = [], []
        for s in range(0, n, chunk):
            c, p = _match_paths_torch(d_vals[s:s + chunk],
                                      d_codes[s:s + chunk], *consts,
                                      self.fallback_cls, 0.5)
            out_cls.append(c)
            out_prob.append(p)
        return (torch.cat(out_cls).cpu().numpy(),
                torch.cat(out_prob).cpu().numpy())

    def match_index(self, table: ColumnarTable, chunk: int = 1 << 20,
                    use_device: bool = True, device=None) -> np.ndarray:
        """(n,) int32 index of the FIRST matching path per record, -1 when
        none matches — the record router of the per-level job.  Same
        f32-exactness gate as predict_codes; ``use_device=False`` forces
        the numpy twin (the per-level job's path set changes every call,
        and the host routes at once)."""
        vals, codes = self.feature_arrays(table)
        n = table.n_rows
        if n == 0 or self.n_paths == 0:
            return np.full((n,), -1, dtype=np.int32)
        chunk = self._row_chunk(chunk)
        out = []
        if use_device and self._f32_safe(vals):
            dev = resolve_device(device)
            lo, hi, num_r, cat_m, cat_r, _, _ = self._device_consts(dev)
            for s in range(0, n, chunk):
                ok = _match_ok_torch(
                    torch.from_numpy(vals[s:s + chunk].astype(np.float32)
                                     ).to(dev),
                    torch.from_numpy(codes[s:s + chunk]).to(dev),
                    lo, hi, num_r, cat_m, cat_r)
                idx = torch.where(ok.any(dim=1),
                                  ok.to(torch.uint8).argmax(dim=1), -1)
                out.append(idx.to(torch.int32).cpu().numpy())
        else:
            for s in range(0, n, chunk):
                ok = _match_ok_np(vals[s:s + chunk], codes[s:s + chunk],
                                  self.lo, self.hi, self.num_restricted,
                                  self.cat_mask, self.cat_restricted)
                out.append(np.where(ok.any(axis=1), np.argmax(ok, axis=1),
                                    -1).astype(np.int32))
        return np.concatenate(out)


class DecisionTreeModel:
    """Vectorized evaluator: the path list is compiled once into a
    PathMatrix and every batch is classified in one pass on ``device``."""

    def __init__(self, path_list: DecisionPathList, schema: FeatureSchema,
                 device=None):
        self.paths = path_list.decision_paths
        self.schema = schema
        self.device = resolve_device(device)
        self.matrix = PathMatrix(path_list, schema)

    def predict(self, table: ColumnarTable,
                features: Optional[FeatureCache] = None
                ) -> Tuple[List[str], np.ndarray]:
        """(pred_class per record, prob).  Records matching no path get the
        globally most probable class (population-weighted)."""
        cls_idx, prob = self.matrix.predict_codes(table, self.device,
                                                  features=features)
        if table.n_rows == 0 or self.matrix.n_paths == 0 \
                or not self.matrix.classes:
            return [""] * table.n_rows, np.zeros((table.n_rows,))
        lut = np.array(self.matrix.classes, dtype=object)
        return list(lut[cls_idx]), prob.astype(np.float64)


# --------------------------------------------------------------------------
# candidate split generation (host, from schema — static shapes)
# --------------------------------------------------------------------------

@dataclass
class CandidateSplit:
    attr: int
    predicates: List[Predicate]        # branch order
    thresholds: Optional[List[float]] = None     # numeric
    groups: Optional[List[List[str]]] = None     # categorical

    @property
    def n_branches(self) -> int:
        return len(self.predicates)


def _set_partitions(items: List[str], n_groups: int):
    """All partitions of items into exactly n_groups non-empty groups
    (restricted-growth enumeration; same partition set as
    SplitManager.createCategoricalPartitions, canonical order)."""
    n = len(items)
    if n_groups > n or n_groups < 1:
        return

    def rec(i, groups):
        if i == n:
            if len(groups) == n_groups:
                yield [list(g) for g in groups]
            return
        remaining = n - i - 1  # items left after placing items[i]
        # join an existing group (still need n_groups-len(groups) new groups)
        if remaining >= n_groups - len(groups):
            for g in groups:
                g.append(items[i])
                yield from rec(i + 1, groups)
                g.pop()
        # open a new group
        if len(groups) < n_groups and remaining >= n_groups - len(groups) - 1:
            groups.append([items[i]])
            yield from rec(i + 1, groups)
            groups.pop()

    yield from rec(0, [])


def _numeric_threshold_sets(field: FeatureField) -> List[List[float]]:
    """All increasing threshold tuples on the scan grid with 1..maxSplit-1
    points (SplitManager.createIntPartitions :292-330)."""
    lo, hi = float(field.min), float(field.max)
    interval = float(field.split_scan_interval or 0)
    if interval <= 0 or int((hi - lo) / interval) == 0:
        interval = (hi - lo) / 2
    points = []
    p = lo + interval
    while p < hi:
        points.append(int(p) if field.is_integer else p)
        p += interval
    max_split = field.max_split or 2
    out: List[List[float]] = []
    max_len = max(1, max_split - 1)
    for k in range(1, max_len + 1):
        for combo in itertools.combinations(points, k):
            out.append(list(combo))
    return out


def _numeric_split_predicates(field: FeatureField, thresholds: List[float]
                              ) -> List[Predicate]:
    attr = field.ordinal
    is_int = field.is_integer
    preds = []
    for i, t in enumerate(thresholds):
        if i == 0:
            preds.append(Predicate.num(attr, "le", t, is_int=is_int))
        else:
            preds.append(Predicate.num(attr, "le", t, thresholds[i - 1],
                                       is_int=is_int))
    preds.append(Predicate.num(attr, "gt", thresholds[-1], is_int=is_int))
    return preds


def generate_candidate_splits(schema: FeatureSchema,
                              attrs: Optional[Sequence[int]] = None
                              ) -> List[CandidateSplit]:
    """All candidate splits for the given attrs (default: all feature attrs)."""
    out: List[CandidateSplit] = []
    fields = [schema.find_field_by_ordinal(a) for a in attrs] \
        if attrs is not None else schema.feature_fields
    for f in fields:
        if f.is_categorical:
            card = [str(c) for c in (f.cardinality or [])]
            max_split = f.max_split or 2
            for g in range(2, max_split + 1):
                for groups in _set_partitions(card, g):
                    preds = [Predicate.cat(f.ordinal, grp) for grp in groups]
                    out.append(CandidateSplit(attr=f.ordinal, predicates=preds,
                                              groups=groups))
        elif f.is_numeric:
            for thresholds in _numeric_threshold_sets(f):
                preds = _numeric_split_predicates(f, thresholds)
                out.append(CandidateSplit(
                    attr=f.ordinal, predicates=preds,
                    thresholds=[float(t) for t in thresholds]))
    return out


# rows per chunk of the branch evaluator's (rows, S, Tmax) compare
_BRANCH_CHUNK_ELEMS = 1 << 26


class SplitSet:
    """Branch evaluator for a fixed list of candidate splits.

    Precomputes (host, once):
      * thresholds  (S, Tmax) float32, +inf padded  — numeric branch =
        sum(x > t), giving branch i == t_{i-1} < x <= t_i
      * cat_table   (S, CardMax) int32              — categorical branch =
        table[split, value_code]
      * attr column index per split into the stacked feature matrix

    ``branch_codes`` then evaluates all splits for all records on the
    device — the replacement for the reference's per-record predicate loop
    (DecisionTreeBuilder.java:323-357).
    """

    def __init__(self, splits: List[CandidateSplit], schema: FeatureSchema):
        self.splits = splits
        self.schema = schema
        feat_fields = schema.feature_fields
        self.feat_ordinals = [f.ordinal for f in feat_fields]
        col_of = {o: i for i, o in enumerate(self.feat_ordinals)}
        S = len(splits)
        tmax = max([len(s.thresholds) for s in splits if s.thresholds] + [1])
        cmax = max([len(f.cardinality or []) for f in feat_fields
                    if f.is_categorical] + [1])
        self.max_branches = max((s.n_branches for s in splits), default=2)
        thr = np.full((S, tmax), np.inf, dtype=np.float32)
        cat_tab = np.zeros((S, cmax), dtype=np.int32)
        is_cat = np.zeros((S,), dtype=bool)
        attr_col = np.zeros((S,), dtype=np.int32)
        for si, s in enumerate(splits):
            attr_col[si] = col_of[s.attr]
            f = schema.find_field_by_ordinal(s.attr)
            if s.groups is not None:
                is_cat[si] = True
                for gi, grp in enumerate(s.groups):
                    for v in grp:
                        cat_tab[si, f.cat_code(v)] = gi
            else:
                thr[si, :len(s.thresholds)] = s.thresholds
        self.thresholds = thr
        self.cat_table = cat_tab
        self.is_cat = is_cat
        self.attr_col = attr_col
        self.n_splits = S

    def feature_matrix(self, table: ColumnarTable) -> np.ndarray:
        """(n, F) feature values (categorical as codes): int16 when every
        value is integral and in range (the device cast to float32 is
        lossless, and the upload is half the bytes), else float32."""
        cols = [table.columns[o] for o in self.feat_ordinals]
        if not cols:
            return np.zeros((table.n_rows, 0), np.float32)

        def narrow_ok(c):
            if c.size == 0:
                return True
            if np.issubdtype(c.dtype, np.integer):
                return bool(c.min() > -(1 << 15) and c.max() < (1 << 15))
            # float column: integral AND in range, checked per column so
            # the first fractional column bails out instead of scanning
            # a full stacked (n, F) f64 matrix
            return bool(np.all((c == np.trunc(c)) &
                               (np.abs(c) < float(1 << 15))))

        if all(narrow_ok(c) for c in cols):
            return np.stack([c.astype(np.int16) for c in cols], axis=1)
        return np.stack([c.astype(np.float32) for c in cols], axis=1)

    def branch_codes(self, X: torch.Tensor) -> torch.Tensor:
        """(n, S) int32 branch index of every record under every split, on
        X's device, over row chunks of :func:`_branch_codes_body`."""
        note_dispatch(site="ingest.encode")
        dev = X.device
        consts = [torch.from_numpy(a).to(dev) for a in (
            self.attr_col.astype(np.int64), self.thresholds, self.cat_table,
            self.is_cat)]
        n = X.shape[0]
        out = torch.empty((n, self.n_splits), dtype=torch.int32, device=dev)
        step = max(1, _BRANCH_CHUNK_ELEMS
                   // max(self.n_splits * self.thresholds.shape[1], 1))
        for s in range(0, n, step):
            out[s:s + step] = _branch_codes_body(X[s:s + step], *consts)
        return out


def _branch_codes_body(X, attr_col, thresholds, cat_table, is_cat):
    """The branch evaluator (``tree._branch_codes_body`` in torch).  X may
    be int16 (``feature_matrix``'s narrow form); the compares run in
    float32, as the reference's do — float64 would move rows across a
    threshold.  A categorical code takes ``clip(code, 0, cmax-1)``, so an
    unknown category (-1) takes category 0's branch."""
    vals = X.to(torch.float32)[:, attr_col]                   # (n, S)
    num_branch = (vals[:, :, None] > thresholds[None]
                  ).sum(dim=2).to(torch.int32)                # (n, S)
    codes = vals.to(torch.int32)
    safe = codes.clamp(0, cat_table.shape[1] - 1).long()
    cat_branch = cat_table[
        torch.arange(thresholds.shape[0], device=X.device)[None, :],
        safe]                                                 # (n, S)
    return torch.where(is_cat[None, :], cat_branch, num_branch)


# --------------------------------------------------------------------------
# builder
# --------------------------------------------------------------------------

@dataclass
class TreeParams:
    """The dtb.* knobs (resource/detr.properties / rafo.properties)."""
    split_algorithm: str = "entropy"            # entropy | giniIndex
    attr_select_strategy: str = "notUsedYet"    # all|notUsedYet|randomAll|randomNotUsedYet
    random_split_set_size: int = 3              # dtb.random.split.set.size
    split_select_strategy: str = "best"         # best | randomAmongTop
    top_split_count: int = 3                    # dtb.top.split.count
    stopping_strategy: str = "maxDepth"         # maxDepth|minPopulation|minInfoGain
    max_depth: int = 3
    min_info_gain: float = -1.0
    min_population: int = -1
    sub_sampling: str = "none"                  # none|withReplace|withoutReplace
    sub_sampling_rate: float = 100.0            # percent
    seed: Optional[int] = None

    def should_stop(self, population: float, info_content: float,
                    parent_info: float, depth: int) -> bool:
        """DecisionPathStoppingStrategy.shouldStop :57-69."""
        if self.stopping_strategy == "minPopulation":
            return population < self.min_population
        if self.stopping_strategy == "minInfoGain":
            return (parent_info - info_content) < self.min_info_gain
        if self.stopping_strategy == "maxDepth":
            return depth >= self.max_depth
        raise ValueError(f"invalid stopping strategy {self.stopping_strategy}")


def _info(counts: np.ndarray, algo: str, axis=-1) -> np.ndarray:
    """entropy (log2) or gini of count vectors along axis
    (util/InfoContentStat.java:71-95)."""
    total = counts.sum(axis=axis, keepdims=True)
    p = counts / np.maximum(total, 1e-12)
    if algo == "entropy":
        with np.errstate(divide="ignore", invalid="ignore"):
            logp = np.where(p > 0, np.log2(np.maximum(p, 1e-300)), 0.0)
        return -(p * logp).sum(axis=axis)
    # giniIndex
    return 1.0 - (p * p).sum(axis=axis)


class _LeafState:
    __slots__ = ("predicates", "depth", "info_content", "population",
                 "class_val_pr", "used_attrs", "stopped")

    def __init__(self, predicates, depth, info_content, population,
                 class_val_pr, used_attrs, stopped):
        self.predicates = predicates
        self.depth = depth
        self.info_content = info_content
        self.population = population
        self.class_val_pr = class_val_pr
        self.used_attrs = used_attrs
        self.stopped = stopped


def sampling_weights(n: int, params: TreeParams,
                     rng: np.random.Generator) -> Optional[np.ndarray]:
    """First-iteration sub-sampling as per-record weights
    (DecisionTreeBuilder rootMapHelper :208-244): withReplace -> bootstrap
    multinomial counts at rate% of n; withoutReplace -> Bernoulli(rate%);
    none -> None."""
    if params.sub_sampling == "withReplace":
        m = int(n * params.sub_sampling_rate / 100.0)
        # uniform multinomial == histogram of m uniform draws
        counts = np.bincount(rng.integers(0, n, size=m), minlength=n)
        return counts.astype(np.float32)
    if params.sub_sampling == "withoutReplace":
        keep = rng.random(n) < (params.sub_sampling_rate / 100.0)
        return keep.astype(np.float32)
    return None


def level_chunk(n_nodes: int, n_trees: int, S: int, B: int, C: int,
                w_max: float, mem_elems: int = 128 << 20) -> int:
    """Rows per level-histogram launch, bounded by (a) the plain version's
    one-hot operands — (chunk, T, N) node one-hot + (chunk, C, S, B) class
    x branch one-hot — staying under ``mem_elems`` f32 elements, and (b)
    exactness: per-cell f32 partial sums stay exact integers while the
    chunk's weight mass is < 2^24 (weights are integral: bootstrap counts
    / Bernoulli keeps / ones)."""
    per_row = max(n_trees * max(n_nodes, 1) + C * S * B, 1)
    mem_chunk = max(mem_elems // per_row, 1)
    exact_chunk = max(int(((1 << 24) - 1) / max(w_max, 1.0)), 1)
    return max(1024, min(mem_chunk, exact_chunk))


def unpack_weights4(packed: torch.Tensor, T: int) -> torch.Tensor:
    """(n, ceil(T/2)) uint8 of 4-bit weight pairs (tree 2j in the low
    nibble, 2j+1 in the high) -> the (n, T) uint8 weights, contiguous, on
    the tensor's device: composed elementwise torch ops, the counterpart of
    the JAX package's jitted ``_unpack_weights4``."""
    pairs = torch.stack([packed & 15, packed >> 4], dim=2)
    return pairs.reshape(packed.shape[0], -1)[:, :T].contiguous()


def weights_to_device(w: np.ndarray, w_max: float, device) -> torch.Tensor:
    """(n, T) integral per-record weights -> the level histogram's weight
    tensor on ``device``, shipped in the narrowest wire that holds
    ``w_max`` (the JAX package's ``ForestBuilder.build_all`` rule):

      * ``w_max < 16`` and T > 1: two trees a byte — T padded to even, the
        pairs packed ``lo | hi << 4``, the packed half uploaded and
        unpacked on the device (:func:`unpack_weights4`) into the uint8
        (n, T) tensor;
      * ``w_max < 256``: uint8 (bootstrap counts are small);
      * ``w_max < 65536``: uint16 on the wire, widened to float32 on the
        device;
      * else float32.

    Every form holds the integers exactly; the H2D bytes are recorded as
    uploaded (``note_h2d``)."""
    n, T = w.shape
    if w_max < 256:
        host = w.astype(np.uint8)
        if w_max < 16 and T > 1 and n > 0:
            if T % 2:
                host = np.concatenate([host, np.zeros((n, 1), np.uint8)],
                                      axis=1)
            packed = np.ascontiguousarray(host[:, 0::2] | (host[:, 1::2] << 4))
            note_h2d(packed.nbytes)
            return unpack_weights4(torch.from_numpy(packed).to(device), T)
        host = np.ascontiguousarray(host)
        note_h2d(host.nbytes)
        return torch.from_numpy(host).to(device)
    if w_max < 65536:
        host = np.ascontiguousarray(w.astype(np.uint16))
        note_h2d(host.nbytes)
        # widened through int32: uint16 arithmetic is not on every device
        wire = torch.from_numpy(host.view(np.int16)).to(device)
        return (wire.to(torch.int32) & 0xFFFF).to(torch.float32)
    host = np.ascontiguousarray(w.astype(np.float32))
    note_h2d(host.nbytes)
    return torch.from_numpy(host).to(device)


def count_level(node_ids: torch.Tensor, branches: torch.Tensor,
                cls: torch.Tensor, weights: torch.Tensor, n_nodes: int,
                B: int, C: int, chunk: int, site: str,
                profile=None) -> np.ndarray:
    """One level's (T, N, S, B, C) counts as float64 on the host.  The level
    histogram runs over row chunks of at most ``chunk`` rows (its exact
    float32 range, see :func:`level_chunk`); each chunk's counts convert to
    int32 and accumulate on the device (exact to 2^31 a cell), so chunk
    boundaries cannot change a count, and the host fetches the stacked
    counts once.  Every launch records ``site`` in the Dispatches and
    KernelBackends ledgers, and on the card also the kernel's form
    (``<site>.form.mma`` or ``.atomic``, :func:`level_form`)."""
    n, T = node_ids.shape
    S = branches.shape[1]
    backend = resolve_backend(node_ids.device)
    form = level_form(T, n_nodes, S, B, C, weights.dtype) \
        if backend == BACKEND_CUDA else None
    acc = None
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        # count + accumulate when chunked, as the reference records it
        note_dispatch(1 if n <= chunk else 2, site=site)
        note_backend(site, backend)
        if form is not None:
            note_backend(f"{site}.form", form)
        with layer(profile, "b1"):
            c = forest_level_counts(node_ids[start:end], branches[start:end],
                                    cls[start:end], weights[start:end],
                                    n_nodes, B, C)
        with layer(profile, "accumulate"):
            c = c.to(torch.int32)
            acc = c if acc is None else acc.add_(c)
    if acc is None:
        return np.zeros((T, n_nodes, S, B, C), np.float64)
    with layer(profile, "counts_d2h"):
        host = fetch(acc)
    return host.astype(np.float64)


# rows per chunk of the reassign's (rows, T) index intermediates
_REASSIGN_CHUNK = 1 << 20


def _save_stream_checkpoint(mgr, blocks_done: int, br_parts, cls_parts,
                            mask_parts, n_rows: int,
                            source_rows_done: Optional[int],
                            complete: bool, shard=None) -> None:
    """Persist the accumulated streamed-ingest state as one checkpoint
    step: branch codes (int32), class codes (int32) and the pad mask
    (float32), with meta ``n_rows``, ``blocks_done``, ``source_rows_done``
    and ``ingest_complete``, and a sharded build's ``shard`` spec
    (``{"index", "count"}``) — the JAX package's layout.  Full-state
    snapshots, not increments: any single intact step resumes, which is
    what lets the manager keep only the newest few.  The host copies
    synchronise the device."""
    arrays = {
        "branches": np.concatenate([fetch(p) for p in br_parts])
        if br_parts else np.zeros((0, 0), np.int32),
        "cls_codes": np.concatenate([fetch(p) for p in cls_parts])
        if cls_parts else np.zeros((0,), np.int32),
        "mask": np.concatenate(mask_parts)
        if mask_parts else np.zeros((0,), np.float32),
    }
    meta = {"n_rows": int(n_rows), "blocks_done": int(blocks_done),
            "source_rows_done": None if source_rows_done is None
            else int(source_rows_done),
            "ingest_complete": bool(complete)}
    if shard is not None:
        # a sharded build's state is one shard's rows: resuming it under
        # another shard count would move the row-range split around it
        meta["shard"] = {"index": int(shard.index),
                         "count": int(shard.count)}
    mgr.save(blocks_done, arrays, meta)


class _BlockStager:
    """The staging-thread half of the streamed ingest, and its hand-off to
    the consumer.

    ``stage`` (staging thread) encodes one block's feature matrix and
    class codes on the host and uploads them.  On a CUDA device it copies
    them into one of two pinned host buffers and issues the copies on a
    side stream with ``non_blocking=True``, recording an event after
    them; a buffer is refilled only after its previous copy's event has
    completed.  ``receive`` (consumer) makes the consumer's stream wait on
    that event and marks the tensors as used on it, so the caching
    allocator does not hand their memory to a later upload too early.
    ``pull`` runs the block source's own steps (the baseline tee's B4
    launch among them) under the same device and side stream.  On the CPU
    both halves are plain ``torch.from_numpy``."""

    def __init__(self, split_set: "SplitSet", cls_ord: int,
                 device: torch.device):
        self.split_set = split_set
        self.cls_ord = cls_ord
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self._bufs: List[Optional[Tuple[torch.Tensor, Any]]] = [None,
                                                                    None]
            self._slot = 0

    def _on_device(self):
        """Device and side-stream scope for the staging thread (a new
        thread's current device is cuda:0, and its stream the default)."""
        ctx = contextlib.ExitStack()
        if self.cuda:
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(self.stream))
        return ctx

    def pull(self, blocks):
        """Iterate ``blocks`` with every step of the source under the
        staging scope; closing this generator closes the source."""
        it = iter(blocks)
        try:
            while True:
                with self._on_device():
                    try:
                        block = next(it)
                    except StopIteration:
                        return
                yield block
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _pinned(self, nbytes: int) -> torch.Tensor:
        """The next pinned byte buffer of at least ``nbytes``, once the
        copy that last read it has completed."""
        slot = self._bufs[self._slot]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or slot[0].numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
        else:
            buf = slot[0]
        return buf

    def stage(self, block: ColumnarTable):
        bn = block.n_rows
        X = self.split_set.feature_matrix(block)
        cc = np.ascontiguousarray(
            block.columns[self.cls_ord].astype(np.int32))
        note_h2d(X.nbytes + cc.nbytes, transfers=2)
        src_end = getattr(block, "source_row_end", None)
        if not self.cuda:
            return (torch.from_numpy(X).to(self.device),
                    torch.from_numpy(cc).to(self.device), None, bn, src_end)
        x_bytes = -(-X.nbytes // 16) * 16       # cc starts 16-byte aligned
        with self._on_device():
            buf = self._pinned(x_bytes + cc.nbytes)
            hx = buf[:X.nbytes].view(torch.from_numpy(X[:0]).dtype
                                     ).view(X.shape)
            hc = buf[x_bytes:x_bytes + cc.nbytes].view(torch.int32)
            hx.numpy()[...] = X
            hc.numpy()[...] = cc
            Xd = hx.to(self.device, non_blocking=True)
            ccd = hc.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._bufs[self._slot] = (buf, done)
        self._slot ^= 1
        return Xd, ccd, done, bn, src_end

    def receive(self, staged):
        Xd, ccd, done, bn, src_end = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            Xd.record_stream(cur)
            ccd.record_stream(cur)
        return Xd, ccd, bn, src_end


class TreeBuilder:
    """Level-synchronous tree growth on one device.

    One instance holds the device-resident branch codes and class codes;
    ``build()`` runs the whole iterative loop (the reference's shell-script
    rotation detr.sh:35-41 collapsed into Python), ``build_one_level()``
    runs a single level for the per-level job.  ``profile`` (a
    ``utils.tracing.LayerProfile``) times the layers of each level.

    ``reducer`` (a ``parallel.collectives.AllReducer``) makes the build
    data-parallel over processes that each hold their own ``table``, the
    processes' tables in process order being the whole input: one
    allgather of the row counts gives the global count (the bootstrap
    draw's denominator) and this process's offset into the globally drawn
    weights, and each level's counts are summed across the processes, as
    in :meth:`from_stream`.  Every process then trains the model of one
    process over the concatenated tables, bootstrap included, whatever
    the tables' sizes."""

    def __init__(self, table: ColumnarTable, params: TreeParams,
                 device=None, profile=None, reducer=None):
        self.device = resolve_device(device)
        self.params = params
        self.profile = profile
        self.schema = table.schema
        self.class_field = self.schema.class_attr_field
        self.class_values = list(self.class_field.cardinality or [])
        self.C = len(self.class_values)
        self.splits = generate_candidate_splits(self.schema)
        self.split_set = SplitSet(self.splits, self.schema)
        self.rng = np.random.default_rng(params.seed)
        self.pyrng = pyrandom.Random(params.seed)
        # one device: no pad rows, every row is valid
        self.n_rows = self.n_padded = self._local_rows = table.n_rows
        self.mask_np = np.ones((table.n_rows,), np.float32)
        self._reducer = reducer
        self._row_offset = 0
        if reducer is not None:
            per_shard = reducer.allgather(int(table.n_rows))
            self._row_offset = int(sum(per_shard[:reducer.spec.index]))
            self.n_rows = int(sum(per_shard))
            if self.n_rows == 0:
                raise ValueError("TreeBuilder: no process holds any rows")
        cls_np = np.ascontiguousarray(
            table.columns[self.class_field.ordinal].astype(np.int32))
        with layer(profile, "branch_codes"):
            X = self.split_set.feature_matrix(table)
            note_h2d(X.nbytes + cls_np.nbytes, transfers=2)
            self.cls_codes = torch.from_numpy(cls_np).to(self.device)
            # branch codes computed once; (n, S) int32 on the device.  The
            # feature matrix is not kept: every level reads branch codes
            self.branches = self.split_set.branch_codes(
                torch.from_numpy(X).to(self.device))
        self._w_max = 1.0
        # splits grouped by attr for selection strategies
        self.splits_by_attr: Dict[int, List[int]] = {}
        for i, s in enumerate(self.splits):
            self.splits_by_attr.setdefault(s.attr, []).append(i)

    @classmethod
    def from_stream(cls, blocks, schema: FeatureSchema, params: TreeParams,
                    device=None, stats: Optional[dict] = None,
                    checkpoint=None, checkpoint_every: int = 0,
                    resume_state=None, baseline=None,
                    profile=None, reducer=None) -> "TreeBuilder":
        """Build the device state from an iterator of ColumnarTable row
        blocks instead of one assembled table — the consume stage of the
        streamed CSV -> device ingest (``avenir_tpu``'s unfused form).

        Per block: the host feature matrix and class codes are built and
        uploaded on a staging thread (:func:`core.table.stage_chunks`,
        two blocks deep; :class:`_BlockStager`), and the consumer computes
        the block's branch codes on the device.  Only the (n, S) branch
        codes and (n,) class codes stay resident, joined by one
        ``torch.cat`` at the end, so host memory holds a few blocks.
        ``baseline`` (a ``monitor.baseline.BaselineBuilder``) tees the
        block stream: its bin-counts launch runs on the staging thread,
        on the side stream, once a block.

        ``stats['transfer_s']`` accumulates the staging thread's encode
        and upload time, ``stats['ingest_compute_s']`` the consumer's
        branch-code time plus the final device sync.

        Checkpoint/resume: with a ``checkpoint``
        (``core.checkpoint.CheckpointManager``) and ``checkpoint_every``
        > 0, every Nth block persists the accumulated state
        (:func:`_save_stream_checkpoint`), and a final step with
        ``ingest_complete=True`` lands after the last block.
        ``resume_state`` is ``(arrays, meta)`` from
        ``CheckpointManager.restore``: the restored state is uploaded
        again and ``blocks`` must be the REMAINING stream
        (``iter_csv_chunks(..., start_row=meta['source_rows_done'])``).
        Branch and class codes are exact integers and weights are placed
        by mask position over the true row count, so an interrupted then
        resumed ingest trains the model of an uninterrupted one,
        whichever package wrote the checkpoint.

        Data-parallel over processes (``reducer``, a
        ``parallel.collectives.AllReducer``): ``blocks`` is this process's
        row-range shard of the source (``iter_csv_chunks(shard=...)``),
        staged onto this process's device only.  One allgather after the
        ingest exchanges the shards' row counts: every process learns the
        global row total (the bootstrap draw's denominator) and its own
        offset into the globally drawn weights (:meth:`_expand_weights`).
        Training then sums one stacked count array a level across the
        processes (:meth:`_reduce_counts`), so the host epilogue, and the
        model, is the single-process build's on every process.  A shard
        with no rows still joins every collective.  Its checkpoints carry
        the shard spec; a resume under another shard count is refused."""
        self = cls.__new__(cls)
        spec = reducer.spec if reducer is not None else None
        self._reducer = reducer
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # pinned to an index here: the staging thread's own current
            # device is cuda:0, whatever this thread's is
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.params = params
        self.profile = profile
        self.schema = schema
        self.class_field = schema.class_attr_field
        self.class_values = list(self.class_field.cardinality or [])
        self.C = len(self.class_values)
        self.splits = generate_candidate_splits(schema)
        self.split_set = SplitSet(self.splits, schema)
        self.rng = np.random.default_rng(params.seed)
        self.pyrng = pyrandom.Random(params.seed)

        br_parts: List[torch.Tensor] = []
        cls_parts: List[torch.Tensor] = []
        mask_parts: List[np.ndarray] = []
        n_rows = 0
        blocks_done = 0
        source_rows_done: Optional[int] = None
        t_compute = 0.0
        if resume_state is not None:
            arrays, meta = resume_state
            saved_shard = meta.get("shard")
            want_shard = None if spec is None else \
                {"index": spec.index, "count": spec.count}
            if saved_shard != want_shard:
                raise ValueError(
                    f"checkpoint belongs to shard {saved_shard}, this "
                    f"process is {want_shard}: a sharded build must resume "
                    f"under the SAME process count and shard assignment "
                    f"(the row-range split would move around the saved "
                    f"state); clear the checkpoint dir to restart cold")
            rb = np.ascontiguousarray(arrays["branches"], dtype=np.int32)
            if rb.shape[0]:
                if rb.shape[1] != self.split_set.n_splits:
                    raise ValueError(
                        f"checkpoint branch width {rb.shape[1]} does not "
                        f"match the schema's {self.split_set.n_splits} "
                        f"candidate splits; the checkpoint belongs to a "
                        f"different config")
                rc = np.ascontiguousarray(arrays["cls_codes"],
                                          dtype=np.int32)
                note_h2d(rb.nbytes + rc.nbytes, transfers=2)
                br_parts.append(torch.from_numpy(rb).to(dev))
                cls_parts.append(torch.from_numpy(rc).to(dev))
                mask_parts.append(np.asarray(arrays["mask"],
                                             dtype=np.float32))
            n_rows = int(meta["n_rows"])
            blocks_done = int(meta.get("blocks_done", 0))
            source_rows_done = meta.get("source_rows_done")

        stager = _BlockStager(self.split_set, self.class_field.ordinal, dev)
        if baseline is not None:
            from ..monitor.baseline import tee_blocks
            blocks = tee_blocks(blocks, baseline)
        consumer = torch.cuda.device(dev) if stager.cuda \
            else contextlib.nullcontext()
        with consumer:
            for staged in stage_chunks(stager.pull(blocks), stager.stage,
                                       depth=2, stats=stats):
                t0 = time.perf_counter()
                Xd, ccd, bn, src_end = stager.receive(staged)
                br_parts.append(self.split_set.branch_codes(Xd))
                cls_parts.append(ccd)
                del Xd
                mask_parts.append(np.ones((bn,), np.float32))
                n_rows += bn
                blocks_done += 1
                if src_end is not None:
                    source_rows_done = int(src_end)
                t_compute += time.perf_counter() - t0
                if (checkpoint is not None and checkpoint_every > 0
                        and blocks_done % checkpoint_every == 0):
                    _save_stream_checkpoint(
                        checkpoint, blocks_done, br_parts, cls_parts,
                        mask_parts, n_rows, source_rows_done, False,
                        shard=spec)
            if checkpoint is not None and checkpoint_every > 0:
                # the ingest-complete step: a crash in the build phase
                # resumes straight to training, re-reading no source row
                _save_stream_checkpoint(
                    checkpoint, blocks_done, br_parts, cls_parts,
                    mask_parts, n_rows, source_rows_done, True, shard=spec)
            t0 = time.perf_counter()
            if not br_parts and spec is None:
                # the monolithic path cannot train on 0 rows either
                raise ValueError("from_stream got an empty block stream "
                                 "(no rows to train on)")
            if not br_parts:
                # a shard that owns no blocks (more processes than
                # blocks) joins every collective with zero partials
                self.branches = torch.zeros(
                    (0, self.split_set.n_splits), dtype=torch.int32,
                    device=dev)
                self.cls_codes = torch.zeros((0,), dtype=torch.int32,
                                             device=dev)
                mask_parts = [np.zeros((0,), np.float32)]
            elif len(br_parts) == 1:
                self.branches, self.cls_codes = br_parts[0], cls_parts[0]
            else:
                self.branches = torch.cat(br_parts)
                self.cls_codes = torch.cat(cls_parts)
            del br_parts, cls_parts
            if stager.cuda:
                torch.cuda.synchronize(dev)
        t_compute += time.perf_counter() - t0
        self.mask_np = np.concatenate(mask_parts)
        self._local_rows = n_rows
        self._row_offset = 0
        if reducer is not None:
            # the one allgather of the ingest: the global row total and
            # this shard's offset into the globally drawn weights
            per_shard = reducer.allgather(int(n_rows))
            self._row_offset = int(sum(per_shard[:spec.index]))
            n_rows = int(sum(per_shard))
            if n_rows == 0:
                raise ValueError("sharded from_stream: no shard produced "
                                 "any rows (empty source)")
        self.n_rows = n_rows
        self.n_padded = int(self.mask_np.shape[0])
        if stats is not None:
            stats["ingest_compute_s"] = (stats.get("ingest_compute_s", 0.0)
                                         + t_compute)
        self._w_max = 1.0
        self.splits_by_attr = {}
        for i, s in enumerate(self.splits):
            self.splits_by_attr.setdefault(s.attr, []).append(i)
        return self

    def _expand_weights(self, w: Optional[np.ndarray]) -> np.ndarray:
        """Per-record float32 weights drawn over the TRUE row count (ones
        when not sub-sampling), placed at the valid positions of the
        device layout, zero on pad rows.  A monolithic build's mask is all
        ones; a restored checkpoint's pad rows may interleave with valid
        ones (the JAX package pads every block to its mesh).

        A sharded build draws ``w`` over the GLOBAL row count (every
        process replays the same draws) and keeps this shard's slice:
        global row i gets the same weight whichever process holds it."""
        if w is None:
            w = np.ones((self.n_rows,), dtype=np.float32)
        if self._reducer is not None:
            w = w[self._row_offset:self._row_offset + self._local_rows]
        full = np.zeros((self.n_padded,), dtype=np.float32)
        full[self.mask_np > 0] = w.astype(np.float32)
        return full

    def with_params(self, params: TreeParams) -> "TreeBuilder":
        """Shallow copy sharing the device-resident encoded data, with fresh
        params/RNG — one bootstrap tree of a forest."""
        b = TreeBuilder.__new__(TreeBuilder)
        b.__dict__.update(self.__dict__)
        b.params = params
        b.rng = np.random.default_rng(params.seed)
        b.pyrng = pyrandom.Random(params.seed)
        return b

    def _reduce_counts(self, counts: np.ndarray) -> np.ndarray:
        """The one cross-process collective of a tree level: this shard's
        stacked counts summed with every peer's, so that every process
        holds the global histogram and replays the same host epilogue.
        Exact (integer counts), hence the single-process model.  The
        identity without a reducer; a reducer of one shard still records
        the collective.

        The wire dtype comes from a bound every process agrees on, never
        from local values (all must issue the same collective): a cell is
        at most the global weight mass, the global row count times the
        sub-sampling rate.  int32 below 2^31, else int64."""
        if self._reducer is None:
            return counts
        p = self.params
        rate = p.sub_sampling_rate / 100.0 \
            if p.sub_sampling != "none" else 1.0
        mass_bound = float(self.n_rows) * max(1.0, rate)
        wire = np.int32 if mass_bound < float(2 ** 31 - 1) else np.int64
        return self._reducer.sum(counts.astype(wire)).astype(np.float64)

    @staticmethod
    def _reassign(node_ids: torch.Tensor, branches: torch.Tensor,
                  sel_split: torch.Tensor, child_table: torch.Tensor
                  ) -> torch.Tensor:
        """Re-tag records for every tree (the reducer's re-tagging
        :764-765, as device gathers): node_ids (n, T), sel_split (T, Np),
        child_table (T, Np, B).  A record at an active node whose split was
        chosen moves to ``child_table[t, node, its branch under that
        split]``; one at a node that stopped (split -1) becomes -2; an
        inactive one (< 0) keeps its id.  Updates node_ids IN PLACE, over
        row chunks, and returns it."""
        n, T = node_ids.shape
        S, Bc = branches.shape[1], child_table.shape[2]
        tree = torch.arange(T, device=node_ids.device)[None, :]
        for s in range(0, n, _REASSIGN_CHUNK):
            nid = node_ids[s:s + _REASSIGN_CHUNK]
            active = nid >= 0
            node = torch.where(active, nid, 0).long()
            sel = sel_split[tree, node]                              # (c, T)
            br = branches[s:s + _REASSIGN_CHUNK].gather(
                1, sel.clamp(0, S - 1).long())
            new = child_table[tree, node, br.clamp(0, Bc - 1).long()]
            nid.copy_(torch.where(active & (sel >= 0), new,
                                  torch.where(active, -2, nid)))
        return node_ids

    # ---- level counts ----
    def level_counts(self, node_ids: torch.Tensor, weights: torch.Tensor,
                     n_nodes: int, chunk: Optional[int] = None) -> np.ndarray:
        """(N, S, B, C) float64 counts of one level: the level histogram
        with T = 1 over node_ids (n, 1) and weights (n, 1).

        The reference's single-tree kernel (``make_level_count_kernel``,
        avenir_tpu/models/tree.py:576) indexes a row at ``node*C + cls``,
        so a row of unknown class (-1) at node k >= 1 is counted in node
        k-1's last class and dropped at node 0, where the forest's count
        drops it at every node.  The fold below rewrites (node, cls) to
        ``(nc // C, nc % C)`` with ``nc = node*C + cls`` and drops rows with
        ``nc < 0``: exactly that index arithmetic, and the identity for
        valid classes."""
        S, B, C = self.split_set.n_splits, self.split_set.max_branches, self.C
        if chunk is None:
            chunk = level_chunk(n_nodes, 1, S, B, C, self._w_max)
        nc = node_ids[:, 0].long() * C + self.cls_codes.long()
        keep = (node_ids[:, 0] >= 0) & (nc >= 0)
        node_ids = torch.where(keep, torch.div(nc, C, rounding_mode="floor"),
                               -1).to(torch.int32)[:, None].contiguous()
        cls = torch.remainder(nc, C).to(torch.int32)
        return self._reduce_counts(count_level(
            node_ids, self.branches, cls, weights, n_nodes, B, C, chunk,
            "tree.level", self.profile)[0])

    # ---- attribute selection (DecisionTreeBuilder.getSplitAttributes :365-381)
    def _allowed_attrs(self, leaf: _LeafState) -> List[int]:
        strategy = self.params.attr_select_strategy
        all_attrs = list(self.splits_by_attr.keys())
        if strategy == "all":
            return all_attrs
        if strategy == "notUsedYet":
            return [a for a in all_attrs if a not in leaf.used_attrs] or all_attrs
        if strategy == "randomAll":
            k = min(self.params.random_split_set_size, len(all_attrs))
            return self.pyrng.sample(all_attrs, k)
        if strategy == "randomNotUsedYet":
            cand = [a for a in all_attrs if a not in leaf.used_attrs] or all_attrs
            k = min(self.params.random_split_set_size, len(cand))
            return self.pyrng.sample(cand, k)
        raise ValueError(f"invalid attr selection strategy {strategy}")

    def _next_level(self) -> None:
        if self.profile is not None:
            self.profile.next_level()

    # ---- the full build loop ----
    def build(self) -> DecisionPathList:
        p = self.params
        with layer(self.profile, "weights_h2d"):
            w = self._expand_weights(sampling_weights(self.n_rows, p,
                                                      self.rng))
            self._w_max = float(w.max()) if w.size else 1.0
            weights = weights_to_device(w[:, None], self._w_max, self.device)

        # root pass (generateRoot :478-494)
        node_ids = torch.zeros((self.n_padded, 1), dtype=torch.int32,
                               device=self.device)
        self._next_level()
        counts = self.level_counts(node_ids, weights, 1)
        with layer(self.profile, "split_choice"):
            root = self._root_state(counts[0])
        root_pop, root_info, root_pr = \
            root.population, root.info_content, root.class_val_pr
        leaves = [root]
        final_paths: List[DecisionPath] = []

        levels = p.max_depth if p.stopping_strategy == "maxDepth" else 64
        for _level in range(levels):
            active = [l for l in leaves if not l.stopped]
            if not active:
                break
            self._next_level()
            leaves, stopped_paths, node_ids = self._grow(active, node_ids,
                                                         weights)
            final_paths.extend(stopped_paths)
            if not leaves:
                break

        # any leaves still active at the end become stopped paths
        for leaf in leaves:
            final_paths.append(DecisionPath(
                predicates=leaf.predicates,
                population=int(round(leaf.population)),
                info_content=leaf.info_content, stopped=True,
                class_val_pr=leaf.class_val_pr))
        if not final_paths:
            final_paths.append(DecisionPath(
                predicates=[Predicate.root()], population=int(round(root_pop)),
                info_content=root_info, stopped=True, class_val_pr=root_pr))
        return DecisionPathList(decision_paths=final_paths)

    def _root_state(self, counts0: np.ndarray) -> _LeafState:
        """Root leaf from a (S, B, C) root-level count block
        (generateRoot :478-494; every split partitions the full population,
        so averaging over splits recovers the root class histogram)."""
        root_class = counts0.sum(axis=(0, 1)) / max(self.split_set.n_splits, 1)
        pop = float(root_class.sum())
        info = float(_info(root_class[None], self.params.split_algorithm)[0])
        pr = {cv: float(root_class[i] / max(pop, 1e-12))
              for i, cv in enumerate(self.class_values)}
        return _LeafState([Predicate.root()], 0, info, pop, pr, set(), False)

    def _grow(self, active: List[_LeafState], node_ids, weights):
        """One level of frontier expansion (the expandTree epilogue
        :499-616): compute counts, choose per-node winning split, derive
        children + stopping, reassign records on the device.
        Returns (new_active_leaves, newly_stopped_DecisionPaths, node_ids)."""
        counts = self.level_counts(node_ids, weights, len(active))
        with layer(self.profile, "split_choice"):
            new_leaves, stopped_paths, sel_split, child_table = \
                self._choose_splits(active, counts)
        note_dispatch(site="tree.reassign")
        with layer(self.profile, "reassign"):
            self._reassign(node_ids, self.branches,
                           torch.from_numpy(sel_split[None]).to(self.device),
                           torch.from_numpy(child_table[None]).to(self.device))
        return new_leaves, stopped_paths, node_ids

    def _choose_splits(self, active: List[_LeafState], counts: np.ndarray):
        """Host epilogue of one level: per active node pick the winning split
        from its (S, B, C) counts, derive children + stopping.  Shared by the
        single-tree path and ForestBuilder (which batches the count kernel
        across trees and calls this once per tree).
        Returns (new_leaves, stopped_paths, sel_split (N,), child_table (N,B))."""
        p = self.params
        n_nodes = len(active)
        sel_split = np.full((n_nodes,), -1, dtype=np.int32)
        child_table = np.full((n_nodes, self.split_set.max_branches), -1,
                              dtype=np.int32)
        new_leaves: List[_LeafState] = []
        stopped_paths: List[DecisionPath] = []
        for ni, leaf in enumerate(active):
            attrs = self._allowed_attrs(leaf)
            cand_splits = [si for a in attrs for si in self.splits_by_attr[a]]
            if not cand_splits:
                leaf.stopped = True
                stopped_paths.append(DecisionPath(
                    predicates=leaf.predicates,
                    population=int(round(leaf.population)),
                    info_content=leaf.info_content, stopped=True,
                    class_val_pr=leaf.class_val_pr))
                continue
            node_counts = counts[ni]                       # (S, B, C)
            br_tot = node_counts.sum(axis=2)               # (S, B)
            info = _info(node_counts, p.split_algorithm)   # (S, B)
            tot = br_tot.sum(axis=1)                       # (S,)
            weighted = (info * br_tot).sum(axis=1) / np.maximum(tot, 1e-12)
            order = sorted(cand_splits, key=lambda si: weighted[si])
            if p.split_select_strategy == "randomAmongTop":
                top = order[:max(1, p.top_split_count)]
                chosen = self.pyrng.choice(top)
            else:
                chosen = order[0]
            sel_split[ni] = chosen
            split = self.splits[chosen]
            # children: only branches that received records (the reducer only
            # sees keys that were emitted)
            for b in range(split.n_branches):
                pop = float(br_tot[chosen, b])
                if pop <= 0:
                    continue
                cdist = node_counts[chosen, b]
                cinfo = float(_info(cdist[None], p.split_algorithm)[0])
                cpr = {cv: float(cdist[i] / pop)
                       for i, cv in enumerate(self.class_values)}
                preds = leaf.predicates + [split.predicates[b]]
                stopped = p.should_stop(pop, cinfo, leaf.info_content,
                                        len(preds) - 1)
                child = _LeafState(preds, leaf.depth + 1, cinfo, pop, cpr,
                                   leaf.used_attrs | {split.attr}, stopped)
                if stopped:
                    stopped_paths.append(DecisionPath(
                        predicates=preds, population=int(round(pop)),
                        info_content=cinfo, stopped=True, class_val_pr=cpr))
                else:
                    child_table[ni, b] = len(new_leaves)
                    new_leaves.append(child)
        return new_leaves, stopped_paths, sel_split, child_table

    # ---- per-level job mode (detr.sh rotation contract) ----
    @staticmethod
    def _leaf_from_path(path: DecisionPath) -> _LeafState:
        used = {pr.attribute for pr in path.predicates
                if pr.operator is not None}
        return _LeafState(path.predicates, len(path.predicates) - 1,
                          path.info_content, path.population,
                          path.class_val_pr, used, path.stopped)

    def assign_node_ids(self, table: ColumnarTable,
                        active: List[_LeafState]) -> np.ndarray:
        """Route records to active leaves by evaluating predicate chains
        (what the reference gets for free from its re-tagged record files):
        the leaf paths compile to a PathMatrix and every record routes in
        one first-match pass; leaves partition the frontier, so first match
        is the leaf's."""
        dpl = DecisionPathList([
            DecisionPath(predicates=l.predicates, population=0,
                         info_content=0.0, stopped=False, class_val_pr={})
            for l in active])
        # numpy twin: the frontier changes every level, and the host does
        # this routing at once
        return PathMatrix(dpl, self.schema).match_index(table,
                                                        use_device=False)

    def build_one_level(self, table: ColumnarTable,
                        dpl: Optional[DecisionPathList]) -> DecisionPathList:
        """One invocation of the reference DecisionTreeBuilder job: iteration 0
        (dpl None) writes the root path; otherwise expands every non-stopped
        path one level.  Stopped paths are carried forward so the output file
        is always a complete tree."""
        self._w_max = 1.0
        weights = weights_to_device(np.ones((self.n_padded, 1), np.float32),
                                    1.0, self.device)
        if dpl is None or not dpl.decision_paths:
            node_ids = torch.zeros((self.n_padded, 1), dtype=torch.int32,
                                   device=self.device)
            counts = self.level_counts(node_ids, weights, 1)
            root = self._root_state(counts[0])
            return DecisionPathList([DecisionPath(
                predicates=[Predicate.root()],
                population=int(round(root.population)),
                info_content=root.info_content, stopped=False,
                class_val_pr=root.class_val_pr)])
        carried = [p for p in dpl.decision_paths if p.stopped]
        active = [self._leaf_from_path(p) for p in dpl.decision_paths
                  if not p.stopped]
        if not active:
            return dpl
        ids = np.ascontiguousarray(self.assign_node_ids(table, active)[:, None])
        note_h2d(ids.nbytes)
        node_ids = torch.from_numpy(ids).to(self.device)
        new_leaves, stopped_paths, _ = self._grow(active, node_ids, weights)
        paths = carried + stopped_paths + [
            DecisionPath(predicates=l.predicates,
                         population=int(round(l.population)),
                         info_content=l.info_content, stopped=False,
                         class_val_pr=l.class_val_pr)
            for l in new_leaves]
        return DecisionPathList(paths)
