"""Device selection: the port's counterpart of ``core/platform.py`` and the
single-device use of ``parallel/mesh.runtime_context``.

Every entry point takes an explicit ``device``; ``None`` means the process
default, which is ``cuda`` unless the caller asked for the CPU
(``-Dplatform=cpu`` on the CLI installs it through
:func:`set_default_device`).  Asking for ``cuda`` — explicitly or by
default — on a machine without a GPU raises: the port never carries on
quietly on the CPU.

Importing this module also pins float32 matmul and cuDNN convolutions to
full precision.  TF32 keeps 10 mantissa bits, so integer-valued sums above
2048 would round (the JAX package uses ``Precision.HIGHEST`` for the same
reason, ``models/forest.py`` vote tally).
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"
# -Dplatform values accepted by the CLI, mapped to torch device types
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}

_default: Optional[str] = None
_lock = threading.Lock()

DeviceLike = Union[str, torch.device, None]


def platform_device(name: str) -> str:
    """``-Dplatform`` value -> torch device string (raises on unknowns)."""
    key = (name or "").strip().lower()
    if key not in PLATFORMS:
        raise ValueError(f"unknown platform {name!r}; must be one of "
                         f"{sorted(PLATFORMS)}")
    return PLATFORMS[key]


def set_default_device(device: DeviceLike) -> None:
    """Install the process default device (``None`` restores ``cuda``).
    cli.run sets it from ``-Dplatform`` and clears it when the job ends."""
    global _default
    with _lock:
        _default = None if device is None else str(torch.device(device))


def default_device() -> str:
    return _default if _default is not None else DEFAULT_DEVICE


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` or the process
    default.  Raises when that is a CUDA device and no GPU is present."""
    d = torch.device(device if device is not None else default_device())
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {d} requested but torch.cuda.is_available() is False; "
            f"pass device='cpu' (or -Dplatform=cpu) to run on the CPU")
    return d
