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
(``kernels/dispatch.py``); ``launches`` counts kernel launches.

:func:`bin_counts` replaces the TPU kernel ``avenir_tpu/ops/pallas/histogram.py``
``bin_counts`` (XLA twin ``ops/histogram.py`` ``feature_bin_counts``), the
drift monitor's counting primitive:

    codes (n,R) int32, mask (n,) bool or None  ->  counts (R,B) float32

A code outside [0, B) drops and a masked-out row adds nothing.  CUDA tensors
launch ``csrc/bin_counts.cu``, CPU tensors run :func:`bin_counts_torch`;
``bin_counts_launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .dispatch import BACKEND_CUDA, resolve_backend

# kernel launches since the last reset (plain integers; chip_smoke.py
# zeroes them around the main path and reads them back): the level
# histogram's and the bin counts'
launches = 0
bin_counts_launches = 0

# the per-block accumulator lives in shared memory up to this size (the
# H100 gives a block up to 227 KB; the launch raises the 48 KB default);
# wider histograms are added straight into global memory
SMEM_LIMIT = 200 * 1024
# element budget of one row chunk of the plain version's one-hot operands
_TORCH_CHUNK_ELEMS = 1 << 26

_WEIGHT_DTYPES = {torch.uint8: 0, torch.float32: 1}

# rows one bin-counts launch takes: no count of its result exceeds 2^24, so
# the float32 result is exact; longer inputs add launch results in float32,
# as the reference's float32 sum does
BIN_ROWS_MAX = 1 << 24
# the bin-counts accumulator lives in shared memory up to this size (no
# attribute raise needed); wider ones add straight into global memory
BIN_SMEM_LIMIT = 48 * 1024


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
# the wrapper
# --------------------------------------------------------------------------

_entry = None


def _lib():
    """The kernel's C entry point, typed (built and loaded on first use)."""
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


def _launch(node_ids, branches, cls, weights, n_nodes, B, C) -> torch.Tensor:
    global launches
    n, T = node_ids.shape
    S = branches.shape[1]
    N = int(n_nodes)
    for name, t in (("node_ids", node_ids), ("branches", branches),
                    ("cls", cls), ("weights", weights)):
        if not t.is_contiguous():
            raise ValueError(f"forest_level_counts: {name} must be "
                             f"contiguous")
    out = torch.zeros((T, N, S, B, C), dtype=torch.float32,
                      device=node_ids.device)
    if n == 0:
        return out
    smem = T * N * S * B * C * 4
    use_smem = smem <= SMEM_LIMIT
    with torch.cuda.device(node_ids.device):
        stream = torch.cuda.current_stream(node_ids.device).cuda_stream
        err = _lib()(node_ids.data_ptr(), branches.data_ptr(),
                     cls.data_ptr(), weights.data_ptr(),
                     _WEIGHT_DTYPES[weights.dtype], n, T, N, S, B, C,
                     out.data_ptr(), int(use_smem), smem if use_smem else 0,
                     stream)
    if err != 0:
        raise RuntimeError(f"forest_level_counts kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def forest_level_counts(node_ids: torch.Tensor, branches: torch.Tensor,
                        cls: torch.Tensor, weights: torch.Tensor,
                        n_nodes: int, B: int, C: int) -> torch.Tensor:
    """(T,N,S,B,C) float32 level counts.  CUDA tensors launch
    ``csrc/histogram.cu``; CPU tensors run
    :func:`forest_level_counts_torch`.  n = 0 returns zeros without a
    launch."""
    _check(node_ids, branches, cls, weights, n_nodes, B, C)
    if resolve_backend(node_ids.device) == BACKEND_CUDA:
        return _launch(node_ids, branches, cls, weights, n_nodes, B, C)
    return forest_level_counts_torch(node_ids, branches, cls, weights,
                                     n_nodes, B, C)


# --------------------------------------------------------------------------
# monitor bin counts (B4)
# --------------------------------------------------------------------------

def bin_counts_torch(codes: torch.Tensor, num_bins: int,
                     mask: torch.Tensor = None) -> torch.Tensor:
    """The plain version: ``feature_bin_counts`` as one ``bincount`` over
    the flat ``r*B + code`` index of the valid, unmasked codes, in int64,
    then float32.  The CPU path and the oracle the kernel is held against
    on the card."""
    n, R = codes.shape
    B = int(num_bins)
    valid = (codes >= 0) & (codes < B)
    if mask is not None:
        valid &= mask[:, None]
    flat = codes.long() + B * torch.arange(R, device=codes.device)[None, :]
    counts = torch.bincount(flat[valid], minlength=R * B)
    return counts.to(torch.float32).reshape(R, B)


_bins_entry = None


def _bins_lib():
    """The bin-counts kernel's C entry point, typed (built on first use)."""
    global _bins_entry
    if _bins_entry is None:
        from .build import load
        fn = load("bin_counts").avenir_bin_counts
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_longlong, i, i, p, p, i, p]
        fn.restype = ctypes.c_int
        _bins_entry = fn
    return _bins_entry


def _launch_bins(codes, B, mask) -> torch.Tensor:
    global bin_counts_launches
    n, R = codes.shape
    out = torch.zeros((R, B), dtype=torch.float32, device=codes.device)
    if n == 0 or R == 0:
        return out
    acc = torch.zeros((R, B), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = _bins_lib()(codes.data_ptr(),
                          mask.data_ptr() if mask is not None else None, n,
                          R, B, acc.data_ptr(), out.data_ptr(),
                          int(R * B * 4 <= BIN_SMEM_LIMIT), stream)
    if err != 0:
        raise RuntimeError(f"bin_counts kernel launch failed: CUDA error "
                           f"{err}")
    bin_counts_launches += 1
    return out


def bin_counts(codes: torch.Tensor, num_bins: int,
               mask: torch.Tensor = None) -> torch.Tensor:
    """(R, B) float32 counts of the (n, R) int32 ``codes``; ``mask`` (n,)
    bool keeps the rows it marks.  CUDA tensors launch
    ``csrc/bin_counts.cu`` (one launch per ``BIN_ROWS_MAX`` rows; n = 0
    returns zeros without a launch); CPU tensors run
    :func:`bin_counts_torch` over the same row chunks."""
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
    form = _launch_bins if resolve_backend(codes.device) == BACKEND_CUDA \
        else bin_counts_torch
    out = None
    for s in range(0, max(n, 1), BIN_ROWS_MAX):
        part = form(codes[s:s + BIN_ROWS_MAX], B,
                    None if mask is None else mask[s:s + BIN_ROWS_MAX])
        out = part if out is None else out + part
    return out
