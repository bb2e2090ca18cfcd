"""Kernel-backend dispatch: the ONE place that decides between a hand-written
CUDA kernel and its plain PyTorch version (port of
``avenir_tpu/ops/pallas/dispatch.py``).

The backend follows the tensors: CUDA tensors launch the kernel, CPU
tensors run the plain version.  There is no selection knob: on the card a
wrapper launches its kernel or raises, it never falls back, and no kernel
takes CPU tensors.  Which form actually ran at each hot site is recorded
through :func:`note_backend` into the active TransferLedger
(``KernelBackends`` counter group).
"""

from __future__ import annotations

import torch

BACKEND_TORCH = "torch"
BACKEND_CUDA = "cuda"


def resolve_backend(device) -> str:
    """``"cuda"`` for tensors on a CUDA device, else ``"torch"``."""
    return BACKEND_CUDA if torch.device(device).type == "cuda" \
        else BACKEND_TORCH


def note_backend(site: str, backend: str, n: int = 1) -> None:
    """Record which form actually ran at a hot site (``cuda`` | ``torch`` |
    ``host``) into every active TransferLedger."""
    from ..utils.tracing import note_kernel_backend
    note_kernel_backend(site, backend, n)
