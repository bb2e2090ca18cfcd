"""Int8-quantized forest serving: port of ``avenir_tpu/serving/quantized.py``.

The float serving path ships every request's feature values (float32) and
categorical codes (int32) to the device; the forest only ever COMPARES
those values against thresholds.  Quantize both sides onto one per-feature
int8 grid and the comparisons survive as int8 compares: the request bytes
shrink about 4x.

Scheme: per feature ``f`` an affine grid ``q(v) = clip(floor((v - fmin_f) /
scale_f), 0, 254) - 127`` over the union of the member thresholds' finite
range and the schema min/max; thresholds bin through the same map (-inf ->
-128, +inf -> +127 sentinels), so ``v > lo`` becomes ``q(v) > q(lo)``
except where a value and its threshold share a bin.  That collision is the
whole accuracy cost, and it is pinned: :func:`publish_quantized` scores the
quantized vote against the float ensemble on a sample at publish time and
refuses to attach the sidecar when the mismatch fraction exceeds the budget
(default ``DEFAULT_BUDGET``).  NaN values map to the -128 sentinel, which no
restricted interval admits.  The grid arithmetic stays float64 numpy on the
host, as the reference has it, so the bins are bit-identical.

Artifact: a ``quantized.json`` + ``quantized.npz`` sidecar pair on the
published registry version (``ModelRegistry.add_sidecar``).  Serving
selects it with ``ps.quantized``; a version without an intact sidecar warns
and serves the float model.  The vote is the int8 form of the ensemble-vote
kernel (``kernels/vote.py`` ``quantized_vote``, replacing the Pallas
``ops/pallas/vote.py`` ``quantized_vote``).  A client holding the grid can
pre-bin its rows itself and send the int8 ``predictq`` wire form
(:func:`wire_encode_rows`, :func:`wire_decode_tokens`): the RESP tier then
hands the decoded rows straight to the int8 vote.
"""

from __future__ import annotations

import io as _io
import json
import re
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.dispatch import note_backend, resolve_backend
from ..kernels.vote import (VoteModel, prepare_quantized_vote_model,
                            quantized_vote)
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch, note_h2d

QUANTIZED_JSON = "quantized.json"
QUANTIZED_NPZ = "quantized.npz"
FORMAT_VERSION = 1
DEFAULT_BUDGET = 0.01      # default pinned accuracy-delta budget (1%)

_LEVELS = 254              # int8 grid cells: q in [-127, 127]
_NAN_Q = np.int8(-128)     # sentinel no finite interval admits
_LO_NEG_INF = np.int8(-128)
_HI_POS_INF = np.int8(127)


class QuantizedVote:
    """A quantized forest resident on a device: int8 request rows in, (n,)
    int32 vote indices (K = veto) out, one kernel launch a call."""

    def __init__(self, model: VoteModel, min_odds: float):
        self.model = model
        self.min_odds = float(min_odds)

    def __call__(self, qv: np.ndarray, qc: np.ndarray) -> torch.Tensor:
        dev = self.model.device
        note_h2d(qv.nbytes + qc.nbytes, transfers=2)
        d_qv = torch.from_numpy(np.ascontiguousarray(qv, np.int8)).to(dev)
        d_qc = torch.from_numpy(np.ascontiguousarray(qc, np.int8)).to(dev)
        note_dispatch(site="quantized.vote")
        note_backend("quantized.vote", resolve_backend(dev))
        return quantized_vote(d_qv, d_qc, self.model, self.min_odds)


@dataclass
class QuantizedForest:
    """The int8 sidecar payload: quantized member tensors + the grid."""

    q_lo: np.ndarray           # (T, P, F) int8
    q_hi: np.ndarray           # (T, P, F) int8
    num_r: np.ndarray          # (T, P, F) bool
    cat_m: np.ndarray          # (T, P, F, Cmax) bool
    cat_r: np.ndarray          # (T, P, F) bool
    cls_oh: np.ndarray         # (T, P, K) uint8 leaf votes
    wvec: np.ndarray           # (T,) float32 member weights
    scale: np.ndarray          # (F,) float64 grid cell width
    fmin: np.ndarray           # (F,) float64 grid origin
    classes: List[str]         # vote-index -> label order
    min_odds: float = 1.0
    budget: float = DEFAULT_BUDGET
    mismatch: float = 0.0      # measured at publish time

    # ---- request-side encode (host) ----
    def quantize_rows(self, vals: np.ndarray, codes: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(n, F) float vals + int codes -> the int8 pair, the per-request
        wire form.  Non-finite values follow the float path's comparison
        semantics: +inf clips to the top cell; NaN and -inf take the -128
        sentinel no restricted interval admits."""
        v = np.asarray(vals, np.float64)
        with np.errstate(invalid="ignore"):
            q = np.floor((v - self.fmin[None, :]) / self.scale[None, :])
            q = np.clip(q, 0, _LEVELS) - 127
        qv = np.where(np.isposinf(v), float(_HI_POS_INF),
                      np.where(np.isfinite(v), q, float(_NAN_Q))
                      ).astype(np.int8)
        qc = np.clip(codes, -1, 127).astype(np.int8)
        return qv, qc

    # ---- sidecar round trip ----
    def to_sidecar(self) -> Dict[str, bytes]:
        meta = {
            "format_version": FORMAT_VERSION,
            "classes": list(self.classes),
            "min_odds": float(self.min_odds),
            "budget": float(self.budget),
            "mismatch": float(self.mismatch),
        }
        buf = _io.BytesIO()
        np.savez(buf, q_lo=self.q_lo, q_hi=self.q_hi, num_r=self.num_r,
                 cat_m=self.cat_m, cat_r=self.cat_r, cls_oh=self.cls_oh,
                 wvec=self.wvec, scale=self.scale, fmin=self.fmin)
        return {QUANTIZED_JSON: json.dumps(meta, indent=2).encode(),
                QUANTIZED_NPZ: buf.getvalue()}

    @classmethod
    def from_sidecar(cls, meta_bytes: bytes,
                     npz_bytes: bytes) -> "QuantizedForest":
        meta = json.loads(meta_bytes.decode())
        with np.load(_io.BytesIO(npz_bytes)) as z:
            a = {k: z[k] for k in z.files}
        return cls(q_lo=a["q_lo"], q_hi=a["q_hi"], num_r=a["num_r"],
                   cat_m=a["cat_m"], cat_r=a["cat_r"], cls_oh=a["cls_oh"],
                   wvec=a["wvec"], scale=a["scale"], fmin=a["fmin"],
                   classes=list(meta["classes"]),
                   min_odds=float(meta["min_odds"]),
                   budget=float(meta["budget"]),
                   mismatch=float(meta["mismatch"]))

    # ---- device vote ----
    def prepare(self, device=None) -> QuantizedVote:
        """The int8 tensors placed on ``device`` once (default: the process
        device), in the vote kernel's layout."""
        return QuantizedVote(prepare_quantized_vote_model(
            self.q_lo, self.q_hi, self.num_r, self.cat_m, self.cat_r,
            self.cls_oh, self.wvec, resolve_device(device)), self.min_odds)


def quantize_ensemble(ensemble, schema=None,
                      budget: float = DEFAULT_BUDGET) -> QuantizedForest:
    """Quantize a stacked ``models.forest.EnsembleModel`` onto the int8
    grid.  Raises when the ensemble cannot take the stacked device path
    (degenerate member / fractional weights) or a categorical alphabet
    exceeds the int8 code range."""
    host = ensemble.stacked_host()
    if host is None:
        raise ValueError(
            "cannot quantize: ensemble has no stacked device form "
            "(degenerate member, non-f32-exact bounds, or fractional "
            "vote weights) — the float host path serves it")
    lo, hi, num_r, cat_m, cat_r, cls_oh = host
    T, P, F = lo.shape
    if cat_m.shape[3] > 127:
        raise ValueError(
            f"cannot quantize: categorical alphabet {cat_m.shape[3]} "
            f"exceeds the int8 code range (127)")
    # per-feature grid over the finite threshold range, widened by the
    # schema's min/max when it pins one (request values live there)
    fmin = np.zeros((F,), np.float64)
    scale = np.ones((F,), np.float64)
    feat_fields = None
    if schema is not None:
        mats = ensemble.models[0].matrix
        feat_fields = [schema.find_field_by_ordinal(o)
                       for o in mats.feat_ordinals]
    for f in range(F):
        finite = []
        m = num_r[:, :, f] & np.isfinite(lo[:, :, f])
        finite.extend(lo[:, :, f][m].tolist())
        m = num_r[:, :, f] & np.isfinite(hi[:, :, f])
        finite.extend(hi[:, :, f][m].tolist())
        if feat_fields is not None and feat_fields[f].is_numeric:
            if feat_fields[f].min is not None:
                finite.append(float(feat_fields[f].min))
            if feat_fields[f].max is not None:
                finite.append(float(feat_fields[f].max))
        if finite:
            gmin, gmax = min(finite), max(finite)
            fmin[f] = gmin
            scale[f] = (gmax - gmin) / _LEVELS if gmax > gmin else 1.0

    def q_thresh(t):
        with np.errstate(invalid="ignore"):
            q = np.floor((t - fmin[None, None, :]) / scale[None, None, :])
        return np.clip(q, -1, _LEVELS) - 127
    q_lo = np.where(np.isneginf(lo), float(_LO_NEG_INF),
                    q_thresh(lo.astype(np.float64)))
    # pad paths carry lo=+inf (never match): +inf quantizes past the top
    # cell, so clip keeps them unreachable (q_lo=127 admits no q_v)
    q_lo = np.where(np.isposinf(lo), float(_HI_POS_INF), q_lo)
    q_hi = np.where(np.isposinf(hi), float(_HI_POS_INF),
                    q_thresh(hi.astype(np.float64)))
    q_hi = np.where(np.isneginf(hi), float(_LO_NEG_INF), q_hi)
    return QuantizedForest(
        q_lo=q_lo.astype(np.int8), q_hi=q_hi.astype(np.int8),
        num_r=num_r, cat_m=cat_m, cat_r=cat_r,
        cls_oh=cls_oh.astype(np.uint8),
        wvec=np.asarray(ensemble.weights, np.float32),
        scale=scale, fmin=fmin, classes=list(ensemble.classes),
        min_odds=float(ensemble.min_odds_ratio), budget=float(budget))


def publish_quantized(registry, name: str, version: int, models,
                      schema, sample_table, *,
                      budget: float = DEFAULT_BUDGET,
                      weights: Optional[Sequence[float]] = None,
                      min_odds_ratio: float = 1.0,
                      device=None) -> Dict[str, float]:
    """Quantize + budget-check + attach the sidecar to a COMMITTED registry
    version.  The quantized vote runs against the float ensemble on
    ``sample_table`` (both on ``device``, default the process device) and a
    mismatch fraction above ``budget`` raises: an over-budget quantized
    model never reaches the registry.  Returns ``{"mismatch": ...,
    "budget": ..., "n_sample": ...}``."""
    from ..models.forest import EnsembleModel
    from ..models.tree import DecisionTreeModel, FeatureCache
    device = resolve_device(device)
    tree_models = [DecisionTreeModel(pl, schema, device=device)
                   for pl in models]
    ens = EnsembleModel(tree_models, weights=weights,
                        min_odds_ratio=min_odds_ratio, require_odd=False,
                        device=device)
    qf = quantize_ensemble(ens, schema, budget=budget)
    n = sample_table.n_rows
    if n == 0:
        raise ValueError("publish_quantized needs a non-empty sample "
                         "table to enforce the accuracy budget")
    float_pred = ens.predict(sample_table)
    vals, codes = FeatureCache().host(tree_models[0].matrix, sample_table)
    qv, qc = qf.quantize_rows(vals, codes)
    idx = fetch(qf.prepare(device)(qv, qc))
    lut = np.concatenate([np.asarray(qf.classes, object), [None]])
    q_pred = list(lut[idx])
    mismatch = sum(a != b for a, b in zip(float_pred, q_pred)) / n
    if mismatch > budget:
        raise ValueError(
            f"quantized forest {name!r} v{version} exceeds the pinned "
            f"accuracy budget: mismatch {mismatch:.4f} > {budget:.4f} "
            f"on {n} sample rows — sidecar NOT published")
    qf.mismatch = float(mismatch)
    registry.add_sidecar(name, version, qf.to_sidecar())
    return {"mismatch": float(mismatch), "budget": float(budget),
            "n_sample": float(n)}


def load_quantized(registry, name: str,
                   version: int) -> Optional[QuantizedForest]:
    """Read a version's quantized sidecar; ``None`` (with a warning) when
    the version carries none or the payload is torn/unreadable — the caller
    serves the float model.  A missing or torn sidecar never refuses
    traffic."""
    try:
        meta_b = registry.read_sidecar(name, version, QUANTIZED_JSON)
        npz_b = registry.read_sidecar(name, version, QUANTIZED_NPZ)
        return QuantizedForest.from_sidecar(meta_b, npz_b)
    except FileNotFoundError:
        warnings.warn(
            f"ps.quantized: model {name!r} v{version} carries no "
            f"quantized sidecar; serving the float model",
            RuntimeWarning)
        return None
    except Exception as exc:
        warnings.warn(
            f"ps.quantized: quantized sidecar of {name!r} v{version} is "
            f"torn or unreadable ({type(exc).__name__}: {exc}); serving "
            f"the float model", RuntimeWarning)
        return None


# --------------------------------------------------------------------------
# the int8 wire form: client-side pre-binning
# --------------------------------------------------------------------------
#
# A client that holds the published grid (sidecar ``scale``/``fmin``) can
# quantize request rows ITSELF and ship the int8 form:
#
#   predictq,<rid>[,t=<us>:<0|1>],<F>,<qv_0..qv_{F-1}>,<qc_0..qc_{F-1}>
#
# where F = len(feat_ordinals) of the serving forest and every qv/qc token
# is a CANONICAL signed decimal int8: ``0`` or ``-?[1-9][0-9]{0,2}`` in
# [-128, 127] — no '+', no '-0', no leading zeros, so one byte pattern per
# value and the native parser (io/serve_native.cpp) and this codec can
# never disagree on a valid payload.  The width echo <F> lets the server
# reject a grid-shape mismatch before touching the payload.  The layout is
# the JAX package's (its golden ``wire`` fixture pins the bytes).

QUANTIZED_VERB = "predictq"

_Q_INT_RE = re.compile(r"^(?:0|-?[1-9][0-9]{0,2})$")
_WIDTH_RE = re.compile(r"^(?:0|[1-9][0-9]*)$")


def wire_encode_rows(rids: Sequence[str], qv: np.ndarray, qc: np.ndarray,
                     *, delim: str = ",") -> List[str]:
    """Encode pre-binned rows (``quantize_rows`` output) as predictq wire
    messages, one per request id — the canonical on-wire layout."""
    qv = np.asarray(qv, np.int8)
    qc = np.asarray(qc, np.int8)
    width = qv.shape[1]
    out = []
    for rid, vrow, crow in zip(rids, qv, qc):
        parts = [QUANTIZED_VERB, str(rid), str(width)]
        parts.extend(str(int(x)) for x in vrow)
        parts.extend(str(int(x)) for x in crow)
        out.append(delim.join(parts))
    return out


def wire_decode_tokens(tokens: Sequence[str], width: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Strict decode of a predictq payload (the row fields after
    rid/trace): ``(qv, qc)`` int8 arrays, or None when the payload is
    malformed — wrong arity, width-echo mismatch, or any non-canonical
    token.  This decoder is the semantics oracle the native parser defers
    to (it FALLS BACK rather than guess)."""
    if len(tokens) != 1 + 2 * width:
        return None
    if _WIDTH_RE.match(tokens[0]) is None or int(tokens[0]) != width:
        return None
    vals = []
    for tok in tokens[1:]:
        if _Q_INT_RE.match(tok) is None:
            return None
        v = int(tok)
        if not -128 <= v <= 127:
            return None
        vals.append(v)
    return (np.asarray(vals[:width], np.int8),
            np.asarray(vals[width:], np.int8))
