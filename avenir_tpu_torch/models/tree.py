"""Decision tree, the predict half: port of ``avenir_tpu/models/tree.py``.

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
exactly.  Building trees (the ``TreeBuilder``) is not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable
from ..runtime import resolve_device
from ..utils.tracing import note_h2d

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
    pred_str: str = ""

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
