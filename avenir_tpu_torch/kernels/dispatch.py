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

import threading
from typing import Dict, Sequence

import torch

BACKEND_TORCH = "torch"
BACKEND_CUDA = "cuda"


def resolve_backend(device) -> str:
    """``"cuda"`` for tensors on a CUDA device, else ``"torch"``."""
    return BACKEND_CUDA if torch.device(device).type == "cuda" \
        else BACKEND_TORCH


# one lock for every kernel module's launch counters: fleet workers launch
# from several host threads at once, and ``x += 1`` on a module global is a
# read, an add and a store that two threads can interleave
_COUNT_LOCK = threading.Lock()


def count_launches(counters: Dict[str, int], names: Sequence[str]) -> None:
    """Add one to each named launch counter in ``counters`` (a kernel
    module's ``globals()``), all under one lock, so concurrent launches
    never lose a count."""
    with _COUNT_LOCK:
        for n in names:
            counters[n] += 1


def note_backend(site: str, backend: str, n: int = 1) -> None:
    """Record which form actually ran at a hot site (``cuda`` | ``torch`` |
    ``host``) into every active TransferLedger."""
    from ..utils.tracing import note_kernel_backend
    note_kernel_backend(site, backend, n)
