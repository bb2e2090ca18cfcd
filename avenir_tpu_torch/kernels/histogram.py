"""The forest level histogram: CUDA kernel wrapper and its plain PyTorch
version.

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
"""

from __future__ import annotations

import ctypes

import torch

from .dispatch import BACKEND_CUDA, resolve_backend

# kernel launches since the last reset (a plain integer; chip_smoke.py
# zeroes it around the main path and reads it back)
launches = 0

# the per-block accumulator lives in shared memory up to this size (the
# H100 gives a block up to 227 KB; the launch raises the 48 KB default);
# wider histograms are added straight into global memory
SMEM_LIMIT = 200 * 1024
# element budget of one row chunk of the plain version's one-hot operands
_TORCH_CHUNK_ELEMS = 1 << 26

_WEIGHT_DTYPES = {torch.uint8: 0, torch.float32: 1}


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
    stream = torch.cuda.current_stream(node_ids.device).cuda_stream
    err = _lib()(node_ids.data_ptr(), branches.data_ptr(), cls.data_ptr(),
                 weights.data_ptr(), _WEIGHT_DTYPES[weights.dtype], n, T, N,
                 S, B, C, out.data_ptr(), int(use_smem),
                 smem if use_smem else 0, stream)
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
