"""The forest ensemble vote, float and int8: CUDA kernel wrappers and their
plain PyTorch versions.

Replaces the TPU kernels ``avenir_tpu/ops/pallas/vote.py`` ``ensemble_vote``
(body ``models/forest.py`` ``_ensemble_vote_body``) and ``quantized_vote``
(body ``serving/quantized.py`` ``_quantized_vote_body``).  Inputs keep the
JAX package's stacked layout (``EnsembleModel.stacked_host``):

    vals (n,F) f32, codes (n,F) i32, lo/hi (T,P,F) f32, num_r (T,P,F) bool,
    cat_m (T,P,F,C) bool, cat_r (T,P,F) bool, cls_oh (T,P,K) f32,
    wvec (T,) f32, min_odds f32  ->  (n,) int32 vote index (K = veto)

and, for the int8 form, qvals/qcodes (n,F) int8, q_lo/q_hi (T,P,F) int8 and
cls_oh (T,P,K) uint8, compared as int32.

:func:`prepare_vote_model` (float) and :func:`prepare_quantized_vote_model`
(int8) put a stacked forest on a device once per model load, with its
per-feature path-mask tables (:func:`table_form`) where they fit the
kernel's shared memory and, for a CUDA device, the scan form's view
(:func:`kernel_form`): per-path class indices (T,P) int32, one flag byte
per predicate slot and the categorical masks packed into 32-bit words.
The kernel runs the table form when the model has tables and the path scan
otherwise (:func:`vote_form`); both are exact.  :func:`ensemble_vote` and
:func:`quantized_vote` launch ``csrc/vote.cu`` for CUDA tensors and run
:func:`ensemble_vote_torch` / :func:`quantized_vote_torch` for CPU tensors
(``kernels/dispatch.py``); ``launches`` and ``quantized_launches`` count
their kernel launches.

The tree-sharded serve (``serving/predictor.py`` with ``serve_mesh``) splits
the float vote in two, as the JAX package's sharded core does:
:func:`ensemble_partial_votes` replaces the TPU kernel
``avenir_tpu/ops/pallas/vote.py`` ``ensemble_partial_votes`` — one tree
shard's (n, K) float32 tallies, plain version :func:`member_votes_torch` —
and :func:`vote_merge_finalize` replaces its ``psum`` + ``_vote_finalize``
(``serving/predictor.py:437-438``) — the shards' tallies summed in shard
order, then the finalize, plain version :func:`vote_merge_finalize_torch`.
``partial_launches`` and ``finalize_launches`` count their launches;
``table_launches`` counts the vote launches (float, int8, partial) that ran
the table form.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .dispatch import BACKEND_CUDA, count_launches, resolve_backend

# kernel launches since the last reset (plain integers, bumped under
# dispatch.count_launches' lock; chip_smoke.py zeroes them around the main
# path and reads them back): the float vote's
# and the int8 vote's
launches = 0
quantized_launches = 0
# the sharded form's: per-shard partial tallies and the merge-finalize
partial_launches = 0
finalize_launches = 0
# the launches of the three vote entries above that ran the table form
table_launches = 0

# predicate tensors (or the tables) are staged in shared memory up to this
# size per block
SMEM_LIMIT = 48 * 1024
# features a row the table form holds in registers (csrc/vote.cu kFMax)
TABLE_MAX_F = 16
# K above this keeps the per-row tally in a global scratch buffer
LOCAL_TALLY_MAX_K = 32
# element budget of one row chunk of the plain version's (n,T,P,F) masks
_TORCH_CHUNK_ELEMS = 1 << 27

_NUM_FLAG = 1
_CAT_FLAG = 2


@dataclass
class VoteModel:
    """A stacked forest resident on ``device``.  The first seven tensors are
    the reference layout (what the plain version reads; ``lo``/``hi`` are
    float32, or int8 for the quantized form, and ``cls_oh`` is float32 in
    both); ``flags``, ``catw`` and ``cls`` are the kernel's form, present on
    CUDA devices only; ``u``, ``ntab`` and ``ctab`` the path-mask tables
    (:func:`table_form`), present where they fit."""
    lo: torch.Tensor
    hi: torch.Tensor
    num_r: torch.Tensor
    cat_m: torch.Tensor
    cat_r: torch.Tensor
    cls_oh: torch.Tensor
    wvec: torch.Tensor
    flags: Optional[torch.Tensor] = None
    catw: Optional[torch.Tensor] = None
    cls: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    ntab: Optional[torch.Tensor] = None
    ctab: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.lo.device

    @property
    def shape(self):
        """(T, P, F, C, K)."""
        T, P, F, C = self.cat_m.shape
        return T, P, F, C, self.cls_oh.shape[2]

    def stacked(self):
        return (self.lo, self.hi, self.num_r, self.cat_m, self.cat_r,
                self.cls_oh, self.wvec)

    @property
    def quantized(self) -> bool:
        return self.lo.dtype == torch.int8

    def smem_bytes(self) -> int:
        """Bytes the scan form stages per block: lo and hi (4 bytes a slot
        in float32, 1 in int8), flags, mask words, class indices and
        weights."""
        T, P, F, C, _ = self.shape
        W = (C + 31) // 32
        th = self.lo.element_size()
        return T * P * F * (2 * th + 1 + 4 * W) + T * P * 4 + T * 4

    def table_bytes(self) -> int:
        """Bytes the table form stages per block: the tables, class
        indices and weights (0 without tables)."""
        if self.ntab is None:
            return 0
        T, P = self.shape[:2]
        return 4 * (self.u.numel() + self.ntab.numel() + self.ctab.numel()
                    + T * P + T)


def prepare_vote_model(lo, hi, num_r, cat_m, cat_r, cls_oh, wvec,
                       device) -> VoteModel:
    """Host stacked arrays (numpy, ``stacked_host`` layout) + member weights
    -> a :class:`VoteModel` on ``device``.  Raises on a layout the vote does
    not take, including a ``cls_oh`` row that is neither one-hot nor zero."""
    return _prepare(np.ascontiguousarray(lo, np.float32),
                    np.ascontiguousarray(hi, np.float32), num_r, cat_m, cat_r,
                    cls_oh, wvec, device)


def prepare_quantized_vote_model(q_lo, q_hi, num_r, cat_m, cat_r, cls_oh,
                                 wvec, device) -> VoteModel:
    """The int8 form (``QuantizedForest`` arrays: int8 thresholds, uint8
    leaf votes) -> a :class:`VoteModel` on ``device`` whose ``lo``/``hi``
    stay int8; the leaf votes are cast to float32 before the checks and
    the kernel form, as the reference casts them for its tally."""
    q_lo, q_hi = np.asarray(q_lo), np.asarray(q_hi)
    if q_lo.dtype != np.int8 or q_hi.dtype != np.int8:
        raise ValueError(f"quantized forest needs int8 q_lo/q_hi, got "
                         f"{q_lo.dtype}/{q_hi.dtype}")
    return _prepare(np.ascontiguousarray(q_lo), np.ascontiguousarray(q_hi),
                    num_r, cat_m, cat_r, cls_oh, wvec, device)


def _prepare(lo, hi, num_r, cat_m, cat_r, cls_oh, wvec, device) -> VoteModel:
    num_r = np.ascontiguousarray(num_r, bool)
    cat_m = np.ascontiguousarray(cat_m, bool)
    cat_r = np.ascontiguousarray(cat_r, bool)
    cls_oh = np.ascontiguousarray(cls_oh, np.float32)
    wvec = np.ascontiguousarray(wvec, np.float32)
    if lo.ndim != 3 or cat_m.ndim != 4 or cls_oh.ndim != 3:
        raise ValueError("stacked forest needs lo (T,P,F), cat_m (T,P,F,C) "
                         "and cls_oh (T,P,K)")
    T, P, F = lo.shape
    C, K = cat_m.shape[3], cls_oh.shape[2]
    for name, a, shp in (("hi", hi, (T, P, F)), ("num_r", num_r, (T, P, F)),
                         ("cat_m", cat_m, (T, P, F, C)),
                         ("cat_r", cat_r, (T, P, F)),
                         ("cls_oh", cls_oh, (T, P, K)), ("wvec", wvec, (T,))):
        if a.shape != shp:
            raise ValueError(f"stacked {name} has shape {a.shape}, "
                             f"expected {shp}")
    if C < 1 or K < 1 or P < 1:
        raise ValueError(f"stacked forest needs P, C, K >= 1 "
                         f"(got P={P}, C={C}, K={K})")
    row_sum = cls_oh.sum(axis=2)
    if not (np.isin(cls_oh, (0.0, 1.0)).all() and np.isin(row_sum, (0, 1)).all()):
        raise ValueError("cls_oh rows must be one-hot or all zero")
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(a).to(dev)
    model = VoteModel(put(lo), put(hi), put(num_r), put(cat_m), put(cat_r),
                      put(cls_oh), put(wvec))
    tables = table_form(lo, hi, num_r, cat_m, cat_r)
    if tables is not None:
        model.u, model.ntab, model.ctab = (put(a) for a in tables)
    if dev.type == "cuda":
        flags, catw, cls = kernel_form(num_r, cat_m, cat_r, cls_oh)
        model.flags, model.catw, model.cls = put(flags), put(catw), put(cls)
    return model


def patch_vote_model(model: VoteModel, host, idx, slices, wvec):
    """A float :class:`VoteModel` with trees ``idx`` replaced: ``host`` is
    the model's seven host arrays (``stacked_host`` + wvec), ``slices``
    the six stacked arrays' rows for those trees, ``wvec`` the new (T,)
    member weights.  Returns ``(model, host, h2d_bytes)``.

    Only the slices (and the weights) cross to the device: each stacked
    tensor, and on a CUDA device the kernel form's flags, mask words and
    class indices, is copied with the changed trees' rows replaced
    (``index_copy``, out of place, so ``model`` stays valid for any batch
    still using it).  The path-mask tables are a function of every tree's
    thresholds, so :func:`table_form` runs again over the patched host
    arrays and the new tables (at most ``SMEM_LIMIT`` bytes) are uploaded
    whole; where the patched forest no longer fits them the new model has
    none and runs the scan form.  Raises before touching the device on a
    quantized model, a layout mismatch or a ``cls_oh`` row that is
    neither one-hot nor zero."""
    if model.quantized:
        raise ValueError("patch_vote_model: the int8 form reloads in full")
    idx = np.asarray(idx, np.int64)
    slices = [np.ascontiguousarray(s, h.dtype)
              for s, h in zip(slices, host[:6])]
    for s, h in zip(slices, host[:6]):
        if s.shape != (idx.size,) + h.shape[1:]:
            raise ValueError(f"patch slice shape {s.shape} does not match "
                             f"({idx.size},) + {h.shape[1:]}")
    cls = slices[5]
    if not (np.isin(cls, (0.0, 1.0)).all()
            and np.isin(cls.sum(axis=2), (0, 1)).all()):
        raise ValueError("cls_oh rows must be one-hot or all zero")
    wvec = np.ascontiguousarray(wvec, np.float32)
    if wvec.shape != host[6].shape:
        raise ValueError(f"patch wvec shape {wvec.shape} != "
                         f"{host[6].shape}")
    new_host = [h.copy() for h in host[:6]]
    for h, s in zip(new_host, slices):
        h[idx] = s
    new_host.append(wvec)
    dev = model.device
    moved = idx.nbytes + wvec.nbytes
    d_idx = torch.from_numpy(idx).to(dev)

    def patch(cur, rows):
        nonlocal moved
        moved += rows.nbytes
        return cur.index_copy(0, d_idx, torch.from_numpy(rows).to(dev))
    new = VoteModel(*(patch(cur, s) for cur, s in zip(
        (model.lo, model.hi, model.num_r, model.cat_m, model.cat_r,
         model.cls_oh), slices)), torch.from_numpy(wvec).to(dev))
    if model.flags is not None:
        flags, catw, cls_i = kernel_form(*slices[2:])
        new.flags = patch(model.flags, flags)
        new.catw = patch(model.catw, catw)
        new.cls = patch(model.cls, cls_i)
    tables = table_form(*new_host[:5])
    if tables is not None:
        new.u, new.ntab, new.ctab = (torch.from_numpy(a).to(dev)
                                     for a in tables)
        moved += sum(a.nbytes for a in tables)
    return new, tuple(new_host), moved


# the pad member's value of each stacked array (lo, hi, num_r, cat_m, cat_r,
# cls_oh, wvec): never matches, votes no class, weighs nothing
_PAD_MEMBER = (np.inf, -np.inf, True, False, False, 0.0, 0.0)


def shard_stacked_arrays(arrays, S: int):
    """The seven host stacked arrays (``stacked_host`` + wvec) padded along
    T to a multiple of ``S`` with zero-weight members that never match (lo
    = +inf, hi = -inf, every numeric slot restricted, no categorical
    restriction, no class, weight 0 — as the JAX package's sharded core
    pads them), then cut into ``S`` contiguous tree slices."""
    arrays = [np.asarray(a) for a in arrays]
    T = arrays[0].shape[0]
    pad = (-T) % S
    if pad:
        arrays = [np.concatenate([a, np.full((pad,) + a.shape[1:], f,
                                             a.dtype)])
                  for a, f in zip(arrays, _PAD_MEMBER)]
    step = (T + pad) // S
    return [tuple(a[s * step:(s + 1) * step] for a in arrays)
            for s in range(S)]


def _pack_bits(bits):
    """Bits over the last axis (..., B) packed into ceil(B/32) 32-bit words
    (bit b of word b // 32), stored as int32."""
    B = bits.shape[-1]
    W = (B + 31) // 32
    full = np.zeros(bits.shape[:-1] + (W * 32,), bool)
    full[..., :B] = bits
    words = (full.reshape(bits.shape[:-1] + (W, 32)).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(axis=-1)
    return words.astype(np.uint32).view(np.int32)


def table_form(lo, hi, num_r, cat_m, cat_r):
    """The kernel's per-feature path-mask tables of a stacked forest (host
    numpy; float32 or int8 thresholds), or None where they do not fit in
    ``SMEM_LIMIT`` bytes of shared memory, the rows have more than
    ``TABLE_MAX_F`` features or a restricted threshold is NaN:

    * ``u`` (F, L) float32: for each feature the sorted distinct lo/hi
      values of the slots whose numeric flag is set, +inf padded to L, the
      smallest power of two above the longest; a value v's bin is
      b = #{u < v}, a NaN's bin NB - 1;
    * ``ntab`` (T, F, NB, PW) int32: path masks of ceil(P/32) words, bit p
      of bin b set iff slot (t, p, f) is numerically unrestricted or
      idx(lo) < b <= idx(hi) (that is lo < v <= hi for every non-NaN v);
      the NaN bin admits only unrestricted slots;
    * ``ctab`` (T, F, C+1, PW) int32: bit p of code c < C set iff the slot
      is categorically unrestricted or its mask admits c; bin C (codes
      < 0) admits only unrestricted slots.  Codes >= C use C - 1.

    A tree's first match is the lowest set bit of AND_f ntab[t, f, b_f] &
    ctab[t, f, c_f], path 0 when none is set."""
    lo = np.asarray(lo).astype(np.float32)
    hi = np.asarray(hi).astype(np.float32)
    T, P, F, C = cat_m.shape
    if F > TABLE_MAX_F:
        return None
    us = []
    for f in range(F):
        r = num_r[:, :, f]
        th = np.concatenate([lo[:, :, f][r], hi[:, :, f][r]])
        if np.isnan(th).any():
            return None
        us.append(np.unique(th))
    u_max = max((len(u) for u in us), default=0)
    L, NB, PW = 1 << u_max.bit_length(), u_max + 2, (P + 31) // 32
    words = F * L + T * F * PW * (NB + C + 1) + T * P + T
    if 4 * words > SMEM_LIMIT:
        return None
    u = np.full((F, L), np.inf, np.float32)
    bins = np.arange(NB)
    num_bits = np.zeros((T, F, NB, P), bool)
    for f, uf in enumerate(us):
        u[f, :len(uf)] = uf
        ilo = np.searchsorted(uf, lo[:, :, f])[..., None]      # (T, P, 1)
        ihi = np.searchsorted(uf, hi[:, :, f])[..., None]
        ok = (ilo < bins) & (bins <= ihi)                      # (T, P, NB)
        ok[..., NB - 1] = False                                # the NaN bin
        num_bits[:, f] = (ok | ~num_r[:, :, f, None]).transpose(0, 2, 1)
    free = ~cat_r[..., None]                                   # (T, P, F, 1)
    cat_bits = np.concatenate([cat_m | free, free], axis=3)   # (T,P,F,C+1)
    return (u, _pack_bits(num_bits),
            _pack_bits(cat_bits.transpose(0, 2, 3, 1)))


def vote_form(model: VoteModel) -> str:
    """The form the kernel runs for ``model``: ``"table"`` where
    :func:`table_form` built its tables, else ``"scan"``."""
    return "table" if model.ntab is not None else "scan"


def kernel_form(num_r, cat_m, cat_r, cls_oh):
    """The kernel's view of a stacked forest (host numpy): one flag byte per
    predicate slot (bit 0 numeric restricted, bit 1 categorical
    restricted), the (T,P,F,C) masks packed into ceil(C/32) 32-bit words
    (bit c of word c // 32, stored as int32), and each path's class index,
    -1 for a path that votes nothing."""
    flags = (num_r.astype(np.uint8) * _NUM_FLAG
             | cat_r.astype(np.uint8) * _CAT_FLAG)
    catw = _pack_bits(cat_m)
    cls = np.where(cls_oh.sum(axis=2) > 0, cls_oh.argmax(axis=2),
                   -1).astype(np.int32)
    return flags, catw, cls


# --------------------------------------------------------------------------
# plain PyTorch version (mirrors _member_votes_body + _vote_finalize)
# --------------------------------------------------------------------------

def first_match_torch(vals, codes, lo, hi, num_r, cat_m, cat_r):
    """(n, T) int64 index of each tree's first matching path (0 when none
    matches, as the reference's argmax over an all-false row).  Values are
    compared in the thresholds' type."""
    n = vals.shape[0]
    T, P, F, C = cat_m.shape
    if n == 0:
        return torch.zeros((0, T), dtype=torch.int64, device=vals.device)
    per_row = max(T * P * F, 1)
    step = max(1, _TORCH_CHUNK_ELEMS // per_row)
    feat = torch.arange(F, device=vals.device)[None, :]
    by_code = cat_m.permute(2, 3, 0, 1)                  # (F, C, T, P)
    out = []
    for s in range(0, n, step):
        v = vals[s:s + step].to(lo.dtype)
        c = codes[s:s + step]
        x = v[:, None, None, :]
        num_ok = ((x > lo) & (x <= hi)) | ~num_r         # (n, T, P, F)
        safe = c.clamp(0, C - 1).long()
        gathered = by_code[feat, safe].permute(0, 2, 3, 1)   # (n, T, P, F)
        cat_ok = (gathered & (c >= 0)[:, None, None, :]) | ~cat_r
        ok = (num_ok & cat_ok).all(dim=3)                # (n, T, P)
        out.append(ok.to(torch.uint8).argmax(dim=2))
    return torch.cat(out)


def member_votes_torch(vals, codes, lo, hi, num_r, cat_m, cat_r, cls_oh,
                       wvec):
    """(n, K) float32 weighted vote tallies."""
    T = lo.shape[0]
    first = first_match_torch(vals, codes, lo, hi, num_r, cat_m, cat_r)
    sel = cls_oh[torch.arange(T, device=cls_oh.device)[None, :], first]
    return (sel * wvec[None, :, None]).sum(dim=1)


def vote_finalize_torch(votes, min_odds):
    """(n, K) tallies -> (n,) int32: first-max argmax, index K on a veto."""
    K = votes.shape[1]
    mo = torch.tensor(min_odds, dtype=torch.float32, device=votes.device)
    best = votes.argmax(dim=1)
    top = votes.amax(dim=1)
    is_best = torch.nn.functional.one_hot(best, K).bool()
    second = votes.masked_fill(is_best, float("-inf")).amax(dim=1)
    veto = (mo > 1.0) & (top / second.clamp_min(1e-12) <= mo)
    return torch.where(veto, K, best).to(torch.int32)


def vote_merge_finalize_torch(partials, min_odds):
    """The plain version of the merge: the shards' (n, K) tallies summed in
    shard order, then :func:`vote_finalize_torch`."""
    votes = partials[0]
    for p in partials[1:]:
        votes = votes + p
    return vote_finalize_torch(votes, min_odds)


def ensemble_vote_torch(vals, codes, lo, hi, num_r, cat_m, cat_r, cls_oh,
                        wvec, min_odds):
    """The plain version: composed torch ops, the CPU path and the oracle
    the kernel is held against on the card."""
    if vals.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=vals.device)
    return vote_finalize_torch(
        member_votes_torch(vals, codes, lo, hi, num_r, cat_m, cat_r, cls_oh,
                           wvec), min_odds)


def quantized_vote_torch(qvals, qcodes, q_lo, q_hi, num_r, cat_m, cat_r,
                         cls_oh, wvec, min_odds):
    """The plain version of the int8 vote (``_quantized_vote_body``): the
    float vote's structure over int32-upcast operands, leaf votes as
    float32."""
    if qvals.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=qvals.device)
    i32 = torch.int32
    return vote_finalize_torch(
        member_votes_torch(qvals, qcodes, q_lo.to(i32), q_hi.to(i32), num_r,
                           cat_m, cat_r, cls_oh.to(torch.float32), wvec),
        min_odds)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

# value dtype -> (C entry point, code dtype, wrapper name)
_FORMS = {torch.float32: ("avenir_ensemble_vote", torch.int32,
                          "ensemble_vote"),
          torch.int8: ("avenir_quantized_vote", torch.int8,
                       "quantized_vote")}
_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# rows, n, F, then _model_args: 9 pointers and T, P, C, W, K, L, NB, PW
_MODEL_ARGS = [_p] * 9 + [_i] * 8
_VOTE_ARGS = [_p, _p, _ll, _i, *_MODEL_ARGS, _f, _p, _p, _i, _ll, _p]
# C entry point -> its argument types
_ARGTYPES = {
    "avenir_ensemble_vote": _VOTE_ARGS,
    "avenir_quantized_vote": _VOTE_ARGS,
    "avenir_ensemble_partial_votes": [_p, _p, _ll, _i, *_MODEL_ARGS, _p, _i,
                                      _ll, _p],
    "avenir_vote_merge_finalize": [_p, _i, _ll, _i, _f, _p, _p, _p]}
_entries = {}


def _lib(entry: str):
    """A kernel's C entry point, typed (built and loaded on first use)."""
    fn = _entries.get(entry)
    if fn is None:
        from .build import load
        fn = getattr(load("vote"), entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _entries[entry] = fn
    return fn


def _check_rows(vals, codes, model: VoteModel, what: str, code_dtype):
    """Request rows the kernel takes: contiguous (n, F) tensors of the
    model's value type and ``code_dtype``, on the model's device, and a
    model prepared for a CUDA device."""
    F = model.shape[2]
    n = vals.shape[0]
    for name, t, dtype in (("vals", vals, model.lo.dtype),
                           ("codes", codes, code_dtype)):
        if t.dtype != dtype or t.dim() != 2 or t.shape != (n, F) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"({n}, {F}) {dtype} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != model.device:
            raise ValueError(f"{what}: {name} on {t.device}, model "
                             f"on {model.device}")
    if model.cls is None:
        raise ValueError(f"{what}: model was not prepared for a CUDA "
                         f"device")


def _model_args(model: VoteModel):
    """The predicate arguments every vote entry takes, after the rows:
    lo, hi, flags, mask words, classes, weights, the tables u, ntab and
    ctab (null in the scan form), T, P, C, W, K, L, NB, PW."""
    T, P, F, C, K = model.shape
    if model.ntab is not None:
        tables = (model.u.data_ptr(), model.ntab.data_ptr(),
                  model.ctab.data_ptr())
        dims = (model.u.shape[1], model.ntab.shape[2], model.ntab.shape[3])
    else:
        tables, dims = (None, None, None), (0, 0, 0)
    return (model.lo.data_ptr(), model.hi.data_ptr(), model.flags.data_ptr(),
            model.catw.data_ptr(), model.cls.data_ptr(),
            model.wvec.data_ptr(), *tables, T, P, C, (C + 31) // 32, K,
            *dims)


def _smem_args(model: VoteModel):
    """(use_smem, smem_bytes) for a launch over ``model``: the table form
    always stages its tables."""
    if model.ntab is not None:
        return 1, model.table_bytes()
    smem = model.smem_bytes()
    return (1, smem) if smem <= SMEM_LIMIT else (0, 0)


def _count(model: Optional[VoteModel], name: str) -> None:
    """One launch of ``name``; a table-form ``model`` also counts in
    ``table_launches``."""
    names = (name, "table_launches") \
        if model is not None and model.ntab is not None else (name,)
    count_launches(globals(), names)


def _launch(vals, codes, model: VoteModel, min_odds: float) -> torch.Tensor:
    K = model.shape[4]
    n = vals.shape[0]
    entry, code_dtype, what = _FORMS[model.lo.dtype]
    _check_rows(vals, codes, model, what, code_dtype)
    out = torch.empty((n,), dtype=torch.int32, device=vals.device)
    if n == 0:
        return out
    scratch = None
    if K > LOCAL_TALLY_MAX_K:
        scratch = torch.empty((n, K), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = _lib(entry)(vals.data_ptr(), codes.data_ptr(), n,
                          model.shape[2], *_model_args(model),
                          float(min_odds),
                          scratch.data_ptr() if scratch is not None else None,
                          out.data_ptr(), *_smem_args(model), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    _count(model, "quantized_launches" if model.quantized else "launches")
    return out


def ensemble_vote(vals: torch.Tensor, codes: torch.Tensor, model: VoteModel,
                  min_odds: float) -> torch.Tensor:
    """(n,) int32 vote indices.  CUDA tensors launch ``csrc/vote.cu``; CPU
    tensors run :func:`ensemble_vote_torch`."""
    if model.quantized:
        raise ValueError("ensemble_vote: model is the int8 form; use "
                         "quantized_vote")
    if resolve_backend(vals.device) == BACKEND_CUDA:
        return _launch(vals, codes, model, min_odds)
    return ensemble_vote_torch(vals, codes, *model.stacked(), min_odds)


def quantized_vote(qvals: torch.Tensor, qcodes: torch.Tensor,
                   model: VoteModel, min_odds: float) -> torch.Tensor:
    """(n,) int32 vote indices of int8 request rows against an int8
    :class:`VoteModel`.  CUDA tensors launch ``csrc/vote.cu``'s int8 form;
    CPU tensors run :func:`quantized_vote_torch`."""
    if not model.quantized:
        raise ValueError("quantized_vote: model is the float form; use "
                         "ensemble_vote")
    if resolve_backend(qvals.device) == BACKEND_CUDA:
        return _launch(qvals, qcodes, model, min_odds)
    return quantized_vote_torch(qvals, qcodes, *model.stacked(), min_odds)


# --------------------------------------------------------------------------
# the tree-sharded form: per-shard partial tallies, then one merge-finalize
# --------------------------------------------------------------------------

def _launch_partial(vals, codes, model: VoteModel) -> torch.Tensor:
    K = model.shape[4]
    n = vals.shape[0]
    _check_rows(vals, codes, model, "ensemble_partial_votes", torch.int32)
    out = torch.empty((n, K), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = _lib("avenir_ensemble_partial_votes")(
            vals.data_ptr(), codes.data_ptr(), n, model.shape[2],
            *_model_args(model), out.data_ptr(), *_smem_args(model), stream)
    if err != 0:
        raise RuntimeError(f"ensemble_partial_votes kernel launch failed: "
                           f"CUDA error {err}")
    _count(model, "partial_launches")
    return out


def ensemble_partial_votes(vals: torch.Tensor, codes: torch.Tensor,
                           model: VoteModel) -> torch.Tensor:
    """(n, K) float32 vote tallies of the request rows over the members in
    ``model`` (one tree shard; float form only).  CUDA tensors launch
    ``csrc/vote.cu``'s partial form; CPU tensors run
    :func:`member_votes_torch`."""
    if model.quantized:
        raise ValueError("ensemble_partial_votes takes the float form; the "
                         "int8 serve is not sharded")
    if resolve_backend(vals.device) == BACKEND_CUDA:
        return _launch_partial(vals, codes, model)
    return member_votes_torch(vals, codes, *model.stacked())


def _launch_merge(partials, min_odds: float) -> torch.Tensor:
    n, K = partials[0].shape
    dev = partials[0].device
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    scratch = None
    if K > LOCAL_TALLY_MAX_K:
        scratch = torch.empty((n, K), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(partials))(*[p.data_ptr()
                                               for p in partials])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib("avenir_vote_merge_finalize")(
            ptrs, len(partials), n, K, float(min_odds),
            scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vote_merge_finalize kernel launch failed: CUDA "
                           f"error {err}")
    _count(None, "finalize_launches")
    return out


def vote_merge_finalize(partials, min_odds: float) -> torch.Tensor:
    """(n,) int32 vote indices from S shards' (n, K) float32 tallies, all on
    one device (the merge device): summed in shard order, then finalized.
    CUDA tensors launch ``csrc/vote.cu``'s merge (at most
    ``parallel.mesh.MAX_SHARDS`` shards); CPU tensors run
    :func:`vote_merge_finalize_torch`."""
    partials = list(partials)
    if not partials:
        raise ValueError("vote_merge_finalize needs at least one shard")
    first = partials[0]
    if first.dim() != 2 or first.shape[1] < 1:
        raise ValueError(f"vote_merge_finalize: tallies must be (n, K) with "
                         f"K >= 1, got {tuple(first.shape)}")
    for q, t in enumerate(partials):
        if t.shape != first.shape or t.dtype != torch.float32 \
                or t.device != first.device or not t.is_contiguous():
            raise ValueError(
                f"vote_merge_finalize: shard {q}'s tally is "
                f"{tuple(t.shape)} {t.dtype} on {t.device}; every shard's "
                f"must be a contiguous {tuple(first.shape)} float32 tensor "
                f"on {first.device}")
    if resolve_backend(first.device) == BACKEND_CUDA:
        return _launch_merge(partials, min_odds)
    return vote_merge_finalize_torch(partials, min_odds)
