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
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops.distance import euclid_topk, manhattan, row_norms
from .dispatch import BACKEND_CUDA, resolve_backend

# kernel launches since the last reset (a plain integer; chip_smoke.py
# zeroes it around the main path and reads it back)
launches = 0

METRICS = {"euclidean": 0, "manhattan": 1}
# (test row, train row) pairs one tile of the plain version holds
_TORCH_TILE_PAIRS = 1 << 24


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
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, f, p, p, p, p, p,
                       p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


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


def _launch(tn, toh, rn, roh, k, metric, n_cat, denom, fscale):
    global launches
    nt, Fn = tn.shape
    nr, Fc = roh.shape
    dev = tn.device
    od = torch.full((nt, k), float("inf"), dtype=torch.float32, device=dev)
    oi = torch.full((nt, k), -1, dtype=torch.int32, device=dev)
    if nt == 0 or nr == 0 or k == 0:
        return od, oi
    for name, t in (("tn", tn), ("toh", toh), ("rn", rn), ("roh", roh)):
        if not t.is_contiguous():
            raise ValueError(f"topk_scan: {name} must be contiguous")
    W = -(-Fc // 32)
    twords = torch.empty((nt, W), dtype=torch.int32, device=dev) if W else None
    rwords = torch.empty((nr, W), dtype=torch.int32, device=dev) if W else None
    rnorm = torch.empty((nr,), dtype=torch.float32, device=dev) \
        if metric == "euclidean" else None

    def ptr(t):
        return t.data_ptr() if t is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(tn.data_ptr(), ptr(toh), rn.data_ptr(), ptr(roh), nt, nr,
                 Fn, Fc, k, METRICS[metric], n_cat, denom, fscale,
                 ptr(twords), ptr(rwords), ptr(rnorm), od.data_ptr(),
                 oi.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return od, oi


def topk_scan(tn: torch.Tensor, toh: torch.Tensor, rn: torch.Tensor,
              roh: torch.Tensor, k: int, metric: str, n_cat: float,
              denom: float, fscale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_d (nt,k) float32, best_i (nt,k) int32), rows nearest-first,
    ties to the lowest train index.  CUDA tensors launch
    ``csrc/topk.cu`` (no launch when a side is empty or k = 0); CPU
    tensors run :func:`topk_scan_torch`."""
    _check(tn, toh, rn, roh, k, metric)
    if resolve_backend(tn.device) == BACKEND_CUDA:
        return _launch(tn, toh, rn, roh, int(k), metric, float(n_cat),
                       float(denom), float(fscale))
    return topk_scan_torch(tn, toh, rn, roh, int(k), metric, float(n_cat),
                           float(denom), float(fscale))
