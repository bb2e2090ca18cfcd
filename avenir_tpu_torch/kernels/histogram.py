"""The forest level histogram and the monitor bin counts: CUDA kernel
wrappers and their plain PyTorch versions.

Replaces the TPU kernel ``avenir_tpu/ops/pallas/histogram.py``
``forest_level_counts`` (per-tile body ``models/forest.py`` ``_count_body``).
Inputs keep the JAX package's row-leading layout:

    node_ids (n,T) int32, branches (n,S) int32, cls (n,) int32,
    weights (n,T) uint8 or float32  ->  counts (T,N,S,B,C) float32

For each row and each tree whose node id lies in [0, N), the row's weight
for that tree is added at ``(t, node, s, branches[n,s], cls[n])`` for every
split s.  A class outside [0, C), a branch outside [0, B) or a weight of 0
adds nothing.  Weights are integers and callers keep a call's weight mass
below 2^24 (``models.tree.level_chunk``), so the float32 counts are exact
in any summation order: the kernel and the plain version agree bit for bit.

:func:`forest_level_counts` launches ``csrc/histogram.cu`` for CUDA tensors
and runs :func:`forest_level_counts_torch` for CPU tensors
(``kernels/dispatch.py``); ``launches`` counts kernel launches.  The kernel
has two forms, which :func:`level_form` picks from the shape and the weight
dtype: ``"mma"``, the one-hot contraction on the integer tensor cores (u8
operands, int32 sums; uint8 weights, histograms that :func:`mma_plan` fits
in registers and shared memory), and ``"atomic"``, shared-memory atomic adds
(float32 weights and wider histograms).  ``mma_launches`` counts the mma
form's launches.

:func:`bin_counts` replaces the TPU kernel ``avenir_tpu/ops/pallas/histogram.py``
``bin_counts`` (XLA twin ``ops/histogram.py`` ``feature_bin_counts``), the
drift monitor's counting primitive:

    codes (n,R) int32, mask (n,) bool or None  ->  counts (R,B) float32

A code outside [0, B) drops and a masked-out row adds nothing; ``out=``
adds the counts into an (R,B) float32 carry in place (the monitor's window
matrix).  CUDA tensors launch ``csrc/bin_counts.cu``, one launch a call,
with a per-(device, stream) int32 accumulator and ticket that the kernel
leaves zero (:func:`_workspace`); CPU tensors run :func:`bin_counts_torch`;
``bin_counts_launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .dispatch import BACKEND_CUDA, count_launches, resolve_backend

# kernel launches since the last reset (plain integers, bumped under
# dispatch.count_launches' lock; chip_smoke.py zeroes them around the main
# path and reads them back): the level
# histogram's and the bin counts'
launches = 0
mma_launches = 0
bin_counts_launches = 0

# a block's dynamic shared memory limit (the H100 gives a block up to 227
# KB; the launch raises the 48 KB default): the atomic form keeps its
# per-block accumulator there up to this size (wider histograms add
# straight into global memory); the mma form's buffers must fit in it
SMEM_LIMIT = 200 * 1024
# element budget of one row chunk of the plain version's one-hot operands
_TORCH_CHUNK_ELEMS = 1 << 26

# the mma form's plan (csrc/histogram.cu kMmaRows, kMmaWarps, kWarpTiles):
# rows a staged tile, warps a block, the warp tile shapes the kernel is
# built for (MT m16 tiles x NT n8 tiles a warp, 4 int32 accumulators a
# tile), the most slabs the T*N axis is cut into over the grid (each reads
# every row again)
MMA_ROWS = 128
# bytes of an operand row (csrc/histogram.cu kOpStride): one column's
# MMA_ROWS bytes, padded to 4 x an odd number of words
MMA_OP_STRIDE = MMA_ROWS + 16
MMA_WARPS = 8
MMA_WARP_TILES = ((1, 4), (1, 8), (1, 12), (1, 16), (2, 4), (2, 8), (4, 4))
MMA_SLABS_MAX = 4
# the most blocks an SM the mma form's grid takes (fewer where fewer are
# resident); each block writes one row of partial sums, which a second
# kernel adds up
MMA_BLOCKS_PER_SM = 2

FORMS = ("mma", "atomic")

_WEIGHT_DTYPES = {torch.uint8: 0, torch.float32: 1}

# rows one bin-counts launch takes: no count of its result exceeds 2^24, so
# the float32 result is exact; longer inputs add launch results in float32,
# as the reference's float32 sum does
BIN_ROWS_MAX = 1 << 24


# --------------------------------------------------------------------------
# plain PyTorch version (mirrors _count_body)
# --------------------------------------------------------------------------

def _one_hot(x: torch.Tensor, k: int) -> torch.Tensor:
    """float32 one-hot whose out-of-range entries (negative or >= k) are all
    zero, as ``jax.nn.one_hot`` gives them (torch's ``one_hot`` raises)."""
    return (x.unsqueeze(-1) == torch.arange(k, device=x.device)).to(
        torch.float32)


def forest_level_counts_torch(node_ids: torch.Tensor, branches: torch.Tensor,
                              cls: torch.Tensor, weights: torch.Tensor,
                              n_nodes: int, B: int, C: int) -> torch.Tensor:
    """The plain version: ``_count_body``'s factored one-hot contraction in
    float32 — the weighted (n,T,N) node one-hot against the (n,C,S,B) class
    x branch one-hot — over row chunks, so the one-hot operands stay near
    2^26 elements at any row count.  The CPU path and the oracle the kernel
    is held against on the card."""
    n, T = node_ids.shape
    S = branches.shape[1]
    N = int(n_nodes)
    out = torch.zeros((T, N, C, S, B), dtype=torch.float32,
                      device=node_ids.device)
    step = max(1, _TORCH_CHUNK_ELEMS // max(T * N + C * S * B, 1))
    for s in range(0, n, step):
        nid = node_ids[s:s + step]
        active = nid >= 0
        w = weights[s:s + step].to(torch.float32) * active
        oh_node = _one_hot(torch.where(active, nid, 0), N) * w[..., None]
        oh_cb = torch.einsum("nc,nsb->ncsb", _one_hot(cls[s:s + step], C),
                             _one_hot(branches[s:s + step], B))
        out += torch.einsum("ntm,ncsb->tmcsb", oh_node, oh_cb)
    return out.permute(0, 1, 3, 4, 2).contiguous()           # (T,N,S,B,C)


# --------------------------------------------------------------------------
# which form runs
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MmaPlan:
    """How the mma form cuts a (T*N) x (C*S*B) product: ``m_tiles`` m16
    and ``n_tiles`` n8 tiles, ``slab_tiles`` m16 tiles a slab (grid y),
    ``slabs`` slabs; the block's warps as a (MMA_WARPS / wn) x ``wn`` grid
    over a slab's tiles, each holding at most ``MMA_WARP_TILES[shape]``
    (m-tiles, n-tiles); and the dynamic shared memory: two staging buffers
    and two operand buffers."""
    m_tiles: int
    n_tiles: int
    slab_tiles: int
    slabs: int
    wn: int
    shape: int
    smem_bytes: int


def _round16(x: int) -> int:
    return (x + 15) & ~15


def stage_bytes(T: int, S: int) -> int:
    """One staging buffer of the mma form (``csrc/histogram.cu``
    ``stage_sizes``): a tile's node ids, weights, branch codes and classes,
    each with room for the partial 16-byte granules at its ends."""
    return (_round16(MMA_ROWS * T * 4 + 32) + _round16(MMA_ROWS * T + 32)
            + _round16(MMA_ROWS * S * 4 + 32) + _round16(MMA_ROWS * 4 + 32))


def operand_bytes(slab_tiles: int, n_tiles: int) -> int:
    """One operand buffer (``csrc/histogram.cu`` ``operand_bytes``): a
    slab's A rows and Bm's rows, ``MMA_OP_STRIDE`` bytes each (a row holds
    one column's bytes for the tile's rows)."""
    return (slab_tiles * 16 + n_tiles * 8) * MMA_OP_STRIDE


@functools.lru_cache(maxsize=None)
def mma_plan(T: int, N: int, S: int, B: int, C: int) -> Optional[MmaPlan]:
    """The mma form's plan for a (T, N, S, B, C) level, or None where it
    does not fit: more than ``MMA_SLABS_MAX`` slabs, or shared memory past
    ``SMEM_LIMIT``.  Of the warp grids and tile shapes, the one with the
    fewest slabs, then the fewest instructions a warp a k-step (its mma,
    one A fragment load an m-tile, one B load two n-tiles), then the
    fewest accumulators."""
    m_tiles = -(-T * N // 16)
    n_tiles = -(-C * S * B // 8)
    best = None
    for wn in (1, 2, 4, 8):
        wm = MMA_WARPS // wn
        nt = -(-n_tiles // wn)
        for shape, (tm, tn) in enumerate(MMA_WARP_TILES):
            if nt > tn:
                continue
            slabs = -(-m_tiles // (wm * tm))
            slab_tiles = -(-m_tiles // slabs)   # slabs of even size
            mt = -(-slab_tiles // wm)
            if mt > tm:
                continue
            key = (slabs, mt * nt + mt + -(-nt // 2), tm * tn)
            if best is None or key < best[0]:
                best = (key, slabs, slab_tiles, wn, shape)
    if best is None or best[1] > MMA_SLABS_MAX:
        return None
    _, slabs, slab_tiles, wn, shape = best
    smem = 2 * stage_bytes(T, S) + 2 * operand_bytes(slab_tiles, n_tiles)
    if smem > SMEM_LIMIT:
        return None
    return MmaPlan(m_tiles, n_tiles, slab_tiles, slabs, wn, shape, smem)


def level_form(T: int, N: int, S: int, B: int, C: int,
               weight_dtype: torch.dtype) -> str:
    """The form the kernel runs for a (T, N, S, B, C) level: ``"mma"`` for
    uint8 weights where :func:`mma_plan` fits, else ``"atomic"`` (float32
    weights, which the u8 operands cannot hold, and wider levels)."""
    if weight_dtype == torch.uint8 and mma_plan(T, N, S, B, C) is not None:
        return "mma"
    return "atomic"


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

_entry = None
_mma_entry = None


def _lib():
    """The atomic form's C entry point, typed (built and loaded on first
    use)."""
    global _entry
    if _entry is None:
        from .build import load
        fn = load("histogram").avenir_forest_level_counts
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, ctypes.c_longlong, i, i, i, i, i, p, i,
                       ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _mma_lib():
    """The mma form's C entry point, typed (built and loaded on first
    use)."""
    global _mma_entry
    if _mma_entry is None:
        from .build import load
        fn = load("histogram").avenir_forest_level_counts_mma
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, i, i, i, ll, p, i,
                       p, p]
        fn.restype = ctypes.c_int
        _mma_entry = fn
    return _mma_entry


def _check(node_ids, branches, cls, weights, n_nodes, B, C):
    if node_ids.dim() != 2 or branches.dim() != 2 or cls.dim() != 1 \
            or weights.dim() != 2:
        raise ValueError("forest_level_counts needs node_ids (n,T), "
                         "branches (n,S), cls (n,) and weights (n,T)")
    n, T = node_ids.shape
    S = branches.shape[1]
    for name, t, shape, dtypes in (
            ("node_ids", node_ids, (n, T), (torch.int32,)),
            ("branches", branches, (n, S), (torch.int32,)),
            ("cls", cls, (n,), (torch.int32,)),
            ("weights", weights, (n, T), tuple(_WEIGHT_DTYPES))):
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"forest_level_counts: {name} must be a "
                             f"{shape} tensor of {dtypes}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != node_ids.device:
            raise ValueError(f"forest_level_counts: {name} on {t.device}, "
                             f"node_ids on {node_ids.device}")
    if min(int(n_nodes), B, C, T, S) < 1:
        raise ValueError(f"forest_level_counts needs T, N, S, B, C >= 1 "
                         f"(got T={T}, N={n_nodes}, S={S}, B={B}, C={C})")
    if T * int(n_nodes) * S * B * C >= 1 << 31:
        raise ValueError("forest_level_counts: histogram has 2^31 cells or "
                         "more")


def _launch(node_ids, branches, cls, weights, n_nodes, B, C,
            form=None) -> torch.Tensor:
    n, T = node_ids.shape
    S = branches.shape[1]
    N = int(n_nodes)
    for name, t in (("node_ids", node_ids), ("branches", branches),
                    ("cls", cls), ("weights", weights)):
        if not t.is_contiguous():
            raise ValueError(f"forest_level_counts: {name} must be "
                             f"contiguous")
    want = level_form(T, N, S, B, C, weights.dtype)
    form = want if form is None else form
    if form == "mma" and want != "mma":
        raise ValueError(f"forest_level_counts: the mma form takes uint8 "
                         f"weights at a level mma_plan fits, not "
                         f"{weights.dtype} at (T,N,S,B,C)="
                         f"{(T, N, S, B, C)}")
    dev = node_ids.device
    if n == 0:
        return torch.zeros((T, N, S, B, C), dtype=torch.float32, device=dev)
    # the mma form's second kernel writes every cell; the atomic form adds
    out = (torch.empty if form == "mma" else torch.zeros)(
        (T, N, S, B, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if form == "mma":
            plan = mma_plan(T, N, S, B, C)
            blocks = torch.cuda.get_device_properties(dev) \
                .multi_processor_count * MMA_BLOCKS_PER_SM
            partial = torch.empty((blocks, T * N * S * B * C),
                                  dtype=torch.int32, device=dev)
            err = _mma_lib()(node_ids.data_ptr(), branches.data_ptr(),
                             cls.data_ptr(), weights.data_ptr(), n, T, N, S,
                             B, C, plan.slab_tiles, plan.slabs, plan.wn,
                             plan.shape, plan.smem_bytes, partial.data_ptr(),
                             blocks, out.data_ptr(), stream)
        else:
            smem = T * N * S * B * C * 4
            use_smem = smem <= SMEM_LIMIT
            err = _lib()(node_ids.data_ptr(), branches.data_ptr(),
                         cls.data_ptr(), weights.data_ptr(),
                         _WEIGHT_DTYPES[weights.dtype], n, T, N, S, B, C,
                         out.data_ptr(), int(use_smem),
                         smem if use_smem else 0, stream)
    if err != 0:
        raise RuntimeError(f"forest_level_counts kernel launch failed "
                           f"({form} form): CUDA error {err}")
    count_launches(globals(), ("launches", "mma_launches")
                   if form == "mma" else ("launches",))
    return out


def forest_level_counts(node_ids: torch.Tensor, branches: torch.Tensor,
                        cls: torch.Tensor, weights: torch.Tensor,
                        n_nodes: int, B: int, C: int, *,
                        form: Optional[str] = None) -> torch.Tensor:
    """(T,N,S,B,C) float32 level counts.  CUDA tensors launch
    ``csrc/histogram.cu`` in the :func:`level_form` form; CPU tensors run
    :func:`forest_level_counts_torch`.  n = 0 returns zeros without a
    launch.  ``form`` forces ``"mma"`` or ``"atomic"``, to hold the two
    forms against each other (``"mma"`` raises where the level does not
    take it); it never changes the answer."""
    _check(node_ids, branches, cls, weights, n_nodes, B, C)
    if form is not None and form not in FORMS:
        raise ValueError(f"forest_level_counts: form must be one of "
                         f"{FORMS}, got {form!r}")
    if resolve_backend(node_ids.device) == BACKEND_CUDA:
        return _launch(node_ids, branches, cls, weights, n_nodes, B, C,
                       form)
    return forest_level_counts_torch(node_ids, branches, cls, weights,
                                     n_nodes, B, C)


# --------------------------------------------------------------------------
# monitor bin counts (B4)
# --------------------------------------------------------------------------

def bin_counts_torch(codes: torch.Tensor, num_bins: int,
                     mask: torch.Tensor = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``feature_bin_counts`` as one ``bincount`` over
    the flat ``r*B + code`` index of the valid, unmasked codes, in int64,
    then float32.  With ``out``, adds the counts into it in place (one
    float32 add a cell, the reference's ``counts + feature_bin_counts``) and
    returns it.  The CPU path and the oracle the kernel is held against on
    the card."""
    n, R = codes.shape
    B = int(num_bins)
    valid = (codes >= 0) & (codes < B)
    if mask is not None:
        valid &= mask[:, None]
    flat = codes.long() + B * torch.arange(R, device=codes.device)[None, :]
    counts = torch.bincount(flat[valid], minlength=R * B)
    counts = counts.to(torch.float32).reshape(R, B)
    return counts if out is None else out.add_(counts)


_bins_entries = None


def _bins_lib():
    """The bin-counts library's C entry points, typed (built on first
    use): the kernel, the first port's two launches and the empty launch."""
    global _bins_entries
    if _bins_entries is None:
        from .build import load
        lib = load("bin_counts")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        new = lib.avenir_bin_counts
        new.argtypes = [p, p, ll, i, i, p, p, p, i, i, p]
        old = lib.avenir_bin_counts_old
        old.argtypes = [p, p, ll, i, i, p, p, i, p]
        empty = lib.avenir_empty_launch
        empty.argtypes = [p]
        for fn in (new, old, empty):
            fn.restype = ctypes.c_int
        _bins_entries = (new, old, empty)
    return _bins_entries


# (device index, raw stream) -> (int32 accumulator, uint32 ticket), zero
# between calls: the kernel's last block returns both to zero.  One per
# stream, so calls on two streams at once never share one; grown on demand.
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}
_workspace_lock = threading.Lock()


def _workspace(dev: torch.device, stream: int, cells: int) -> torch.Tensor:
    """int32 (cap + 1,): ``[:cap]`` the accumulator, ``[cap]`` the ticket."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() <= cells:
        with _workspace_lock:
            ws = _workspaces.get(key)
            if ws is None or ws.numel() <= cells:
                cap = max(cells, 1024 if ws is None else 2 * (ws.numel() - 1))
                # allocated zeroed once; the stream's order makes the old
                # one's memory safe to reuse after the calls queued on it
                ws = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
                _workspaces[key] = ws
    return ws


def _rows_per_launch(R: int) -> int:
    """Rows one launch takes: at most BIN_ROWS_MAX (counts exact in
    float32) and fewer than 2^30 codes (the kernel's 32-bit indices)."""
    return max(1, min(BIN_ROWS_MAX, ((1 << 30) - 1) // max(R, 1)))


def _launch_bins(codes, B, mask, out, accumulate) -> None:
    """One kernel launch: counts of ``codes`` written into (or, with
    ``accumulate``, added into) ``out``."""
    n, R = codes.shape
    dev = codes.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = _workspace(dev, stream, R * B)
    cap = ws.numel() - 1
    err = _bins_lib()[0](codes.data_ptr(),
                         mask.data_ptr() if mask is not None else None, n,
                         R, B, ws.data_ptr(), ws.data_ptr() + 4 * cap,
                         out.data_ptr(), int(accumulate), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"bin_counts kernel launch failed: CUDA error "
                           f"{err}")
    count_launches(globals(), ("bin_counts_launches",))


def _launch_bins_old(codes, B, mask) -> torch.Tensor:
    """The first port's design (zeroed int32 accumulator, counting launch,
    conversion launch), for timing beside the kernel only."""
    n, R = codes.shape
    out = torch.zeros((R, B), dtype=torch.float32, device=codes.device)
    acc = torch.zeros((R, B), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = _bins_lib()[1](codes.data_ptr(),
                             mask.data_ptr() if mask is not None else None,
                             n, R, B, acc.data_ptr(), out.data_ptr(),
                             int(R * B * 4 <= 48 * 1024), stream)
    if err != 0:
        raise RuntimeError(f"bin_counts (old) launch failed: CUDA error "
                           f"{err}")
    return out


def empty_launch(device=None) -> None:
    """Launch one empty kernel on the current stream of ``device`` (the
    yardstick of a call whose bytes cost nothing; counted nowhere)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    err = _bins_lib()[2](torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"empty launch failed: CUDA error {err}")


def bin_counts(codes: torch.Tensor, num_bins: int,
               mask: torch.Tensor = None, out: Optional[torch.Tensor] = None,
               *, old: bool = False) -> torch.Tensor:
    """(R, B) float32 counts of the (n, R) int32 ``codes``; ``mask`` (n,)
    bool keeps the rows it marks.  With ``out`` ((R, B) float32 on the
    codes' device) the counts are added into it in place and it is
    returned: bit-identical to ``out + bin_counts(codes, ...)``.

    CUDA tensors launch ``csrc/bin_counts.cu``: one launch a call (one per
    :func:`_rows_per_launch` rows beyond that), n = 0 included; CPU
    tensors run :func:`bin_counts_torch` over the same row chunks.
    ``old=True`` launches the first port's design instead (CUDA only, no
    ``out``), for timing; it does not count in ``bin_counts_launches``."""
    B = int(num_bins)
    if codes.dim() != 2 or codes.dtype != torch.int32 \
            or not codes.is_contiguous():
        raise ValueError(f"bin_counts: codes must be a contiguous (n, R) "
                         f"int32 tensor, got {tuple(codes.shape)} "
                         f"{codes.dtype}")
    n, R = codes.shape
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (n,)
                             or mask.device != codes.device
                             or not mask.is_contiguous()):
        raise ValueError(f"bin_counts: mask must be a contiguous ({n},) "
                         f"bool tensor on {codes.device}, got "
                         f"{tuple(mask.shape)} {mask.dtype} on {mask.device}")
    if B < 1 or R * B >= 1 << 31:
        raise ValueError(f"bin_counts needs 1 <= num_bins and R*B < 2^31 "
                         f"(got R={R}, B={B})")
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (R, B)
                            or out.device != codes.device
                            or not out.is_contiguous()):
        raise ValueError(f"bin_counts: out must be a contiguous ({R}, {B}) "
                         f"float32 tensor on {codes.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    cuda = resolve_backend(codes.device) == BACKEND_CUDA
    if old:
        if not cuda or out is not None or n > BIN_ROWS_MAX:
            raise ValueError("bin_counts(old=True) times the first port's "
                             "kernel: CUDA codes, no out, at most "
                             "BIN_ROWS_MAX rows")
        return _launch_bins_old(codes, B, mask)
    if not cuda:
        step = BIN_ROWS_MAX
        for s in range(0, max(n, 1), step):
            part = bin_counts_torch(
                codes[s:s + step], B,
                None if mask is None else mask[s:s + step])
            out = part if out is None else out.add_(part)
        return out
    accumulate = out is not None
    if out is None:
        out = torch.empty((R, B), dtype=torch.float32, device=codes.device)
    if R == 0:
        return out
    step = _rows_per_launch(R)
    if n <= step:                 # the common case: one launch, no slices
        _launch_bins(codes, B, mask, out, accumulate)
        return out
    for s in range(0, n, step):
        _launch_bins(codes[s:s + step], B,
                     None if mask is None else mask[s:s + step], out,
                     accumulate or s > 0)
    return out
