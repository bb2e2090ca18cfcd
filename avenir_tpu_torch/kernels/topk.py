"""KNN distance + running top-k (kernel B5): the CUDA kernel wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``avenir_tpu/ops/pallas/topk.py`` ``topk_scan``
(XLA twin ``ops/distance.py`` ``_topk_scan_kernel``) with its interface:

    tn (nt,Fn) f32, toh (nt,Fc) i8 0/1, rn (nr,Fn) f32, roh (nr,Fc) i8 0/1,
    k, metric, n_cat, denom, fscale  ->  d (nt,k) f32, i (nt,k) i32

Per test row, the k smallest (floored mixed distance, train index) pairs,
ascending, ties to the lowest train index; the distance body is
``ops/distance.py`` (:func:`euclid_topk`, :func:`manhattan`), in the JAX
package's float32 order.  Callers clamp ``k`` to the train count; a slot
past it would stay (+inf, -1).

:func:`topk_scan` launches ``csrc/topk.cu`` for CUDA tensors and runs
:func:`topk_scan_torch` for CPU tensors (``kernels/dispatch.py``);
``launches`` counts kernel launches.  On the card the train rows are
scanned in the contiguous splits :func:`split_ranges` plans from the SM
count, one split per grid row, and one launch of the top-k merge
(``split_merge_launches`` counts those) merges the splits' lists; the
scan skips the divide and square root for pairs that cannot enter a list
where :func:`tail_skip` allows it.  Both leave the answer bit for bit as
one scan over the whole range gives it.

:func:`topk_scan_sharded` replaces the TPU kernel
``avenir_tpu/ops/pallas/topk.py`` ``topk_scan_sharded`` (B7): the train
rows cut into contiguous shards over a :class:`..parallel.mesh.DeviceMesh`,
one B5 scan per non-empty shard on its device, the shards' lists gathered
onto the mesh's first device, and one merge (:func:`topk_merge`, kernel
``avenir_topk_merge`` in ``csrc/topk.cu``, plain version
:func:`topk_merge_torch`; ``merge_launches`` counts its launches).  No
shard ever holds a pad row, so the result equals the single-device scan
bit for bit — which the JAX package's form, padding the train axis with
zero rows before its per-shard top-k, does not always give (ROADMAP
queue C).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.distance import euclid_topk, manhattan, row_norms
from ..parallel.mesh import MAX_SHARDS
from .dispatch import BACKEND_CUDA, count_launches, resolve_backend

# kernel launches since the last reset (plain integers, bumped under
# dispatch.count_launches' lock; chip_smoke.py zeroes them around the main
# path and reads them back): the scan's and
# the sharded form's merge (:func:`topk_merge`)
launches = 0
merge_launches = 0
# the merges of one scan's train splits (:func:`topk_merge_stacked`, at
# most one a scan)
split_merge_launches = 0

_INT32_MAX = 2 ** 31 - 1

METRICS = {"euclidean": 0, "manhattan": 1}
# (test row, train row) pairs one tile of the plain version holds
_TORCH_TILE_PAIRS = 1 << 24
# the scan's split plan: test rows a block (csrc/topk.cu kThreads, 2
# warps), the resident warps an SM to aim for, the fewest train rows a
# split, and the most splits (the merge's limit)
_BLOCK_ROWS = 64
WARPS_PER_SM = 16
MIN_SPLIT_ROWS = 4096
MAX_SPLITS = MAX_SHARDS


def topk_scan_torch(tn: torch.Tensor, toh: torch.Tensor, rn: torch.Tensor,
                    roh: torch.Tensor, k: int, metric: str, n_cat: float,
                    denom: float, fscale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a scan over train tiles in ascending order, the
    shared distance body for each tile, then a stable sort of
    ``[best, tile]`` that keeps the k smallest — the earlier, lower-index
    entries win ties.  The CPU path and the oracle the kernel is held
    against on the card."""
    nt, nr = tn.shape[0], rn.shape[0]
    best_d = torch.full((nt, k), float("inf"), dtype=torch.float32,
                        device=tn.device)
    best_i = torch.full((nt, k), -1, dtype=torch.int32, device=tn.device)
    r_norms = row_norms(rn) if metric == "euclidean" else None
    step = max(1, _TORCH_TILE_PAIRS // max(nt, 1))
    for s in range(0, nr, step):
        e = min(s + step, nr)
        if metric == "euclidean":
            d = euclid_topk(tn, toh, rn[s:e], roh[s:e], n_cat, denom, fscale,
                            r_norms=r_norms[s:e])
        else:
            d = manhattan(tn, toh, rn[s:e], roh[s:e], n_cat, denom, fscale)
        idx = torch.arange(s, e, dtype=torch.int32,
                           device=tn.device).expand(nt, e - s)
        cand_d = torch.cat([best_d, d], dim=1)
        cand_i = torch.cat([best_i, idx], dim=1)
        sd, order = torch.sort(cand_d, dim=1, stable=True)
        best_d = sd[:, :k].contiguous()
        best_i = torch.gather(cand_i, 1, order[:, :k])
    return best_d, best_i


_entry = None


def _lib():
    """The kernel's C entry point, typed (built and loaded on first use)."""
    global _entry
    if _entry is None:
        from .build import load
        fn = load("topk").avenir_topk_scan
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, f, i, i, i, p, p,
                       p, p, p, p, p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def split_ranges(nt: int, nr: int, k: int, sms: int,
                 splits: Optional[int] = None) -> List[Tuple[int, int]]:
    """The scan's train splits: ascending contiguous [start, stop) ranges
    covering [0, nr), none empty, all but the last ``ceil(nr / S)`` rows.
    ``splits`` forces S (clamped to [1, min(nr, MAX_SPLITS)]); else S is
    the fewest splits that give ``sms`` SMs about ``WARPS_PER_SM`` warps
    of 64-row blocks over ``nt`` test rows, with at least
    ``max(MIN_SPLIT_ROWS, k)`` train rows a split."""
    if nr <= 0:
        return []
    if splits is None:
        blocks = max(1, -(-nt // _BLOCK_ROWS))
        splits = -(-WARPS_PER_SM * max(sms, 1) // (2 * blocks))
        splits = min(splits, nr // max(MIN_SPLIT_ROWS, k))
    splits = max(1, min(int(splits), nr, MAX_SPLITS))
    step = -(-nr // splits)
    return [(s, min(s + step, nr)) for s in range(0, nr, step)]


def tail_skip(denom: float, fscale: float) -> bool:
    """Whether the scan may skip the tail of a pair whose pre-division
    total is not below its list's last: exact when the tail (divide by
    ``denom``, square root, multiply by ``fscale``, floor) is monotone
    non-decreasing, that is for ``denom > 0`` and ``fscale >= 0``."""
    return denom > 0 and fscale >= 0


def list_size(k: int) -> int:
    """The kernel's register list size for ``k`` (0 = the global-memory
    list), as ``csrc/topk.cu`` ``list_size`` picks it."""
    return 8 if k <= 8 else 16 if k <= 16 else 32 if k <= 32 \
        else 64 if k <= 64 else 0


def register_rows(Fn: int, Fc: int) -> bool:
    """Whether the kernel holds a test row in registers (else it reads the
    row from global memory), as ``csrc/topk.cu`` ``register_rows``
    decides."""
    return Fn <= 8 and -(-Fc // 32) <= 2


def _check(tn, toh, rn, roh, k, metric):
    if tn.dim() != 2 or toh.dim() != 2 or rn.dim() != 2 or roh.dim() != 2:
        raise ValueError("topk_scan needs tn (nt,Fn), toh (nt,Fc), "
                         "rn (nr,Fn) and roh (nr,Fc)")
    nt, Fn = tn.shape
    nr, Fc = roh.shape
    for name, t, shape, dtype in (("tn", tn, (nt, Fn), torch.float32),
                                  ("toh", toh, (nt, Fc), torch.int8),
                                  ("rn", rn, (nr, Fn), torch.float32),
                                  ("roh", roh, (nr, Fc), torch.int8)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"topk_scan: {name} must be a {shape} {dtype} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
        if t.device != tn.device:
            raise ValueError(f"topk_scan: {name} on {t.device}, tn on "
                             f"{tn.device}")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if k < 0 or max(nt, nr) >= 1 << 31:
        raise ValueError(f"topk_scan needs k >= 0 and fewer than 2^31 rows "
                         f"(got k={k}, nt={nt}, nr={nr})")


def _launch(tn, toh, rn, roh, k, metric, n_cat, denom, fscale, splits,
            skip):
    nt, Fn = tn.shape
    nr, Fc = roh.shape
    dev = tn.device
    if nt == 0 or nr == 0 or k == 0:
        return (torch.full((nt, k), float("inf"), dtype=torch.float32,
                           device=dev),
                torch.full((nt, k), -1, dtype=torch.int32, device=dev))
    for name, t in (("tn", tn), ("toh", toh), ("rn", rn), ("roh", roh)):
        if not t.is_contiguous():
            raise ValueError(f"topk_scan: {name} must be contiguous")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ranges = split_ranges(nt, nr, k, sms, splits)
    S, step = len(ranges), ranges[0][1]
    W = -(-Fc // 32)
    twords = torch.empty((nt, W), dtype=torch.int32, device=dev) if W else None
    rwords = torch.empty((nr, W), dtype=torch.int32, device=dev) if W else None
    rnorm = torch.empty((nr,), dtype=torch.float32, device=dev) \
        if metric == "euclidean" else None
    totals = torch.empty((S, nt, k), dtype=torch.float32, device=dev) \
        if list_size(k) == 0 else None
    od = torch.empty((S, nt, k), dtype=torch.float32, device=dev)
    oi = torch.empty((S, nt, k), dtype=torch.int32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(tn.data_ptr(), ptr(toh), rn.data_ptr(), ptr(roh), nt,
                     nr, Fn, Fc, k, METRICS[metric], n_cat, denom, fscale,
                     S, step, int(skip and tail_skip(denom, fscale)),
                     ptr(twords), ptr(rwords), ptr(rnorm), ptr(totals),
                     od.data_ptr(), oi.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_scan kernel launch failed: CUDA error "
                           f"{err}")
    count_launches(globals(), ("launches",))
    if S == 1:
        return od[0], oi[0]
    return topk_merge_stacked(od, oi, step, k)


def topk_scan(tn: torch.Tensor, toh: torch.Tensor, rn: torch.Tensor,
              roh: torch.Tensor, k: int, metric: str, n_cat: float,
              denom: float, fscale: float, *, splits: Optional[int] = None,
              skip: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_d (nt,k) float32, best_i (nt,k) int32), rows nearest-first,
    ties to the lowest train index.  CUDA tensors launch
    ``csrc/topk.cu`` (no launch when a side is empty or k = 0) over the
    :func:`split_ranges` plan, then merge the splits; CPU tensors run
    :func:`topk_scan_torch`.  ``splits`` forces the split count and
    ``skip=False`` turns the tail skip off, to hold the kernel's forms
    against each other; neither changes the answer."""
    _check(tn, toh, rn, roh, k, metric)
    if resolve_backend(tn.device) == BACKEND_CUDA:
        return _launch(tn, toh, rn, roh, int(k), metric, float(n_cat),
                       float(denom), float(fscale), splits, skip)
    return topk_scan_torch(tn, toh, rn, roh, int(k), metric, float(n_cat),
                           float(denom), float(fscale))


# --------------------------------------------------------------------------
# the train-sharded form (B7): per-shard scans, one gather, one merge
# --------------------------------------------------------------------------

def topk_merge_torch(ds: Sequence[torch.Tensor], is_: Sequence[torch.Tensor],
                     bases: Sequence[int], k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the merge: each shard's local indices lifted
    by its base, dead slots (index < 0) made (+inf, INT32_MAX), the shards
    concatenated in order, a stable sort by distance, the first k kept and
    +inf distances given index -1.  Shards are ascending contiguous train
    ranges and each list is ascending by (d, local index), so the stable
    sort orders by (d, global index)."""
    cand_d, cand_i = [], []
    for d, i, base in zip(ds, is_, bases):
        dead = i < 0
        cand_d.append(torch.where(dead, float("inf"), d))
        cand_i.append(torch.where(dead, _INT32_MAX, i + int(base)))
    cd, ci = torch.cat(cand_d, dim=1), torch.cat(cand_i, dim=1)
    sd, order = torch.sort(cd, dim=1, stable=True)
    bd = sd[:, :k].contiguous()
    bi = torch.gather(ci, 1, order[:, :k])
    return bd, torch.where(torch.isinf(bd), -1, bi).to(torch.int32)


_merge_entry = None
_stacked_entry = None


def _merge_lib():
    """The merge's C entry point over separate lists, typed (built and
    loaded on first use)."""
    global _merge_entry
    if _merge_entry is None:
        from .build import load
        fn = load("topk").avenir_topk_merge
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p, p, i, p]
        fn.restype = ctypes.c_int
        _merge_entry = fn
    return _merge_entry


def _stacked_lib():
    """The merge's C entry point over one (S, nt, k) pair, typed."""
    global _stacked_entry
    if _stacked_entry is None:
        from .build import load
        fn = load("topk").avenir_topk_merge_stacked
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p, p, i, p]
        fn.restype = ctypes.c_int
        _stacked_entry = fn
    return _stacked_entry


def _merge_out(nt, k, dev):
    return (torch.empty((nt, k), dtype=torch.float32, device=dev),
            torch.empty((nt, k), dtype=torch.int32, device=dev))


def _merge_call(ds, is_, bases, k, old):
    """One launch of ``avenir_topk_merge`` over lists on one device."""
    nt = ds[0].shape[0]
    dev = ds[0].device
    od, oi = _merge_out(nt, k, dev)
    if nt == 0:
        return od, oi
    S = len(ds)
    d_ptrs = (ctypes.c_void_p * S)(*[t.data_ptr() for t in ds])
    i_ptrs = (ctypes.c_void_p * S)(*[t.data_ptr() for t in is_])
    base_arr = (ctypes.c_int * S)(*[int(b) for b in bases])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _merge_lib()(d_ptrs, i_ptrs, base_arr, S, nt, k,
                           od.data_ptr(), oi.data_ptr(), int(old), stream)
    if err != 0:
        raise RuntimeError(f"topk_merge kernel launch failed: CUDA error "
                           f"{err}")
    count_launches(globals(), ("merge_launches",))
    return od, oi


def _stacked_call(d, i, step, k, old):
    """One launch of ``avenir_topk_merge_stacked`` over (S, nt, k)."""
    S, nt = d.shape[0], d.shape[1]
    od, oi = _merge_out(nt, k, d.device)
    if nt == 0:
        return od, oi
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = _stacked_lib()(d.data_ptr(), i.data_ptr(), int(step), S, nt, k,
                             od.data_ptr(), oi.data_ptr(), int(old), stream)
    if err != 0:
        raise RuntimeError(f"topk_merge_stacked kernel launch failed: CUDA "
                           f"error {err}")
    count_launches(globals(), ("split_merge_launches",))
    return od, oi


def topk_merge(ds: Sequence[torch.Tensor], is_: Sequence[torch.Tensor],
               bases: Sequence[int], k: int, *, old: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (distance, global train index) pairs of each test
    row over S shards' (nt, k) lists, all on one device: ``ds`` float32,
    ``is_`` int32 local indices (< 0: dead slot), ``bases`` each shard's
    first global row, ascending.  CUDA tensors launch ``csrc/topk.cu``'s
    merge (at most ``parallel.mesh.MAX_SHARDS`` shards, k >= 1); CPU
    tensors run :func:`topk_merge_torch`.  ``old=True`` launches the first
    port's merge kernel instead, to time the two designs; same answer."""
    ds, is_, bases = list(ds), list(is_), [int(b) for b in bases]
    if not ds or not (len(ds) == len(is_) == len(bases)):
        raise ValueError("topk_merge needs one (d, i, base) per shard")
    nt = ds[0].shape[0]
    dev = ds[0].device
    for s, (d, i) in enumerate(zip(ds, is_)):
        if tuple(d.shape) != (nt, k) or tuple(i.shape) != (nt, k) \
                or d.dtype != torch.float32 or i.dtype != torch.int32 \
                or d.device != dev or i.device != dev \
                or not (d.is_contiguous() and i.is_contiguous()):
            raise ValueError(
                f"topk_merge: shard {s}'s lists are {tuple(d.shape)} "
                f"{d.dtype} / {tuple(i.shape)} {i.dtype} on {d.device}; "
                f"each must be a contiguous ({nt}, {k}) float32 / int32 "
                f"pair on {dev}")
    if any(b2 < b1 for b1, b2 in zip(bases, bases[1:])):
        raise ValueError(f"topk_merge: shard bases {bases} must ascend")
    if k == 0:
        return _merge_out(nt, 0, dev)
    if resolve_backend(dev) == BACKEND_CUDA:
        return _merge_call(ds, is_, bases, k, old)
    return topk_merge_torch(ds, is_, bases, k)


def topk_merge_rounds(ds: Sequence[torch.Tensor], is_: Sequence[torch.Tensor],
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_merge` over any number of (nt, k) lists that already
    carry GLOBAL indices (every base 0), lists in ascending train-range
    order: rounds of at most ``parallel.mesh.MAX_SHARDS`` lists each, every
    round's outputs the next round's lists, until one list is left.  A
    round's output is the lexicographic (distance, global index) best of
    its lists with dead slots (+inf, -1), so the rounds give the one-merge
    answer: ties to the lowest global index.  CUDA tensors launch the
    merge kernel once a group; CPU tensors run the plain version the same
    way."""
    ds, is_ = list(ds), list(is_)
    if not ds or len(ds) != len(is_):
        raise ValueError("topk_merge_rounds needs one (d, i) per list")
    while True:
        merged = []
        for g in range(0, len(ds), MAX_SHARDS):
            group_d, group_i = ds[g:g + MAX_SHARDS], is_[g:g + MAX_SHARDS]
            merged.append(topk_merge(group_d, group_i, [0] * len(group_d), k))
        if len(merged) == 1:
            return merged[0]
        ds, is_ = [m[0] for m in merged], [m[1] for m in merged]


def topk_merge_stacked(d: torch.Tensor, i: torch.Tensor, step: int, k: int,
                       *, old: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_merge` over one contiguous (S, nt, k) pair of lists, list
    s starting at global train row ``s * step`` (B5's train splits, each
    ``step`` rows but the last).  CUDA tensors launch
    ``avenir_topk_merge_stacked`` (two pointers, no per-list arrays;
    ``split_merge_launches`` counts it); CPU tensors run
    :func:`topk_merge_torch` over the S planes.  ``old`` as in
    :func:`topk_merge`."""
    if d.dim() != 3 or tuple(i.shape) != tuple(d.shape) \
            or d.dtype != torch.float32 or i.dtype != torch.int32 \
            or d.device != i.device \
            or not (d.is_contiguous() and i.is_contiguous()) \
            or d.shape[2] != k or not 1 <= d.shape[0] <= MAX_SPLITS \
            or step < 0:
        raise ValueError(
            f"topk_merge_stacked needs contiguous (S, nt, {k}) float32 / "
            f"int32 lists on one device with 1 <= S <= {MAX_SPLITS} and "
            f"step >= 0, got {tuple(d.shape)} {d.dtype} / {tuple(i.shape)} "
            f"{i.dtype}, step {step}")
    S, nt = d.shape[0], d.shape[1]
    if k == 0:
        return _merge_out(nt, 0, d.device)
    if resolve_backend(d.device) == BACKEND_CUDA:
        return _stacked_call(d, i, int(step), k, old)
    return topk_merge_torch(list(d), list(i), [s * int(step)
                                                for s in range(S)], k)


def shard_ranges(n: int, S: int) -> List[Tuple[int, int]]:
    """``S`` contiguous [start, stop) ranges of ``n`` rows, ceil(n/S) rows
    each, the last shorter and any past the end empty: no pad rows."""
    step = -(-n // S) if n else 0
    return [(min(s * step, n), min((s + 1) * step, n)) for s in range(S)]


def topk_scan_sharded(tn: torch.Tensor, toh: torch.Tensor,
                      shards: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      k: int, metric: str, n_cat: float, denom: float,
                      fscale: float, mesh) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """:func:`topk_scan` with the train rows sharded over ``mesh``:
    ``shards[s]`` is (rn, roh) of shard s's contiguous train range, on
    ``mesh.devices[s]``, in ascending row order.  The test rows (on the
    merge device, ``mesh.devices[0]``) go to each shard's device; every
    non-empty shard runs one B5 scan with the caller's k (already clamped
    to the train count: a shard shorter than k fills its tail with dead
    (+inf, -1) slots; an empty shard launches nothing and contributes only
    dead slots); one gather brings the lists to the merge device; one
    merge picks the k smallest (d, global i).  Equal, bit for bit, to the
    single-device scan of the whole train set."""
    if len(shards) != mesh.size:
        raise ValueError(f"topk_scan_sharded: {len(shards)} shards for a "
                         f"mesh of {mesh.size} devices")
    from ..parallel.collectives import gather_to
    merge_dev = mesh.devices[0]
    if tn.device != merge_dev:
        raise ValueError(f"topk_scan_sharded: test rows on {tn.device}, "
                         f"the merge device is {merge_dev}")
    ds, is_, bases = [], [], []
    base = 0
    for (rn, roh), dev in zip(shards, mesh.devices):
        if rn.device != dev:
            raise ValueError(f"topk_scan_sharded: a shard on {rn.device}, "
                             f"its mesh device is {dev}")
        d, i = topk_scan(tn.to(dev), toh.to(dev), rn, roh, k, metric, n_cat,
                         denom, fscale)
        ds.append(d)
        is_.append(i)
        bases.append(base)
        base += rn.shape[0]
    gathered = gather_to(ds + is_, merge_dev)
    S = len(ds)
    return topk_merge(gathered[:S], gathered[S:], bases, k)
