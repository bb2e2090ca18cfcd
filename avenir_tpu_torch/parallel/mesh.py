"""Device meshes of one process: the port of ``avenir_tpu/parallel/mesh.py``
(``make_mesh``, ``tree_mesh``, ``worker_device``, ``MeshContext`` and the
process-wide runtime context).

The JAX package shards over a ``jax.sharding.Mesh`` inside ``shard_map``;
the port's counterpart is one process that drives an ordered tuple of torch
devices.  A sharded path places shard ``s``'s slice on ``devices[s]``,
launches each shard's kernel there, and merges on ``devices[0]`` (the merge
device) after :func:`..parallel.collectives.gather_to`.

The defaults take every visible CUDA device when the process default device
(``runtime.default_device``) is cuda, and the one CPU device when it is
cpu; asking for cuda without a GPU raises, as ``runtime.resolve_device``
does.  An explicit ``devices`` list may name one device several times
(``[cuda:0] * 4``, or ``[cpu] * 8`` in the tests): every shard's kernel
and every merge then run on that one device.  The defaults never repeat a
device.  In a run of several processes each process drives one card,
:func:`worker_device` of its local index (``cli.run`` installs it).  Left
out of the port: the JAX package's mesh axis names (a port mesh has one
axis), the hybrid multi-host mesh, the process-local ingest and
``shard_rows_streamed``.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import torch

from ..runtime import resolve_device

# shards one merge launch takes: csrc/vote.cu and csrc/topk.cu size their
# per-shard pointer arrays to it (kMaxShards) and refuse more
MAX_SHARDS = 64


def _normalize(device) -> torch.device:
    """``device`` as a torch.device with its index: a bare ``cuda`` is the
    current CUDA device, so that it compares equal to a tensor's device."""
    d = torch.device(device)
    if d.type == "cuda":
        resolve_device(d)                   # raises without a GPU
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """An ordered tuple of torch devices.  Shard ``s`` lives on
    ``devices[s]``; ``devices[0]`` is the merge device."""

    def __init__(self, devices: Sequence):
        devs = tuple(_normalize(d) for d in devices)
        if not devs:
            raise ValueError("a DeviceMesh needs at least one device")
        if len(devs) > MAX_SHARDS:
            raise ValueError(f"a DeviceMesh holds at most {MAX_SHARDS} "
                             f"devices, got {len(devs)}")
        types = {d.type for d in devs}
        if len(types) != 1:
            raise ValueError(f"a DeviceMesh holds devices of one type, got "
                             f"{sorted(types)}")
        self.devices: Tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def platform(self) -> str:
        """``"cuda"`` or ``"cpu"``."""
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def visible_devices() -> Tuple[torch.device, ...]:
    """Every visible CUDA device when the process default device is cuda
    (raising without a GPU), else the one CPU device."""
    dev = resolve_device(None)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(dev.type),)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over ``devices`` (default :func:`visible_devices`), or over
    their first ``n_devices``."""
    devs = list(devices if devices is not None else visible_devices())
    if n_devices is not None:
        devs = devs[:int(n_devices)]
    return DeviceMesh(devs)


def tree_mesh(n_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """The mesh of model-parallel serving: the stacked member tensors
    shard over it (one tree slice per device), the request rows and the
    merged (n, K) tally stay whole."""
    return make_mesh(n_devices=n_shards, devices=devices)


def worker_device(index: int, devices: Optional[Sequence] = None
                  ) -> torch.device:
    """Round-robin device for worker ``index`` over ``devices`` (default
    :func:`visible_devices`): the card a process of a multi-process run
    drives, from its local index (several processes share a card when
    there are more of them than cards)."""
    devs = list(devices if devices is not None else visible_devices())
    return _normalize(devs[index % len(devs)])


class MeshContext:
    """A mesh bundled as the runtime handle a job reads."""

    def __init__(self, mesh: Optional[DeviceMesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()


# --------------------------------------------------------------------------
# the process-wide runtime context: installed by a caller, else built from
# the process default device (cli.run's -Dplatform); the jobs read it
# through runtime_context()
# --------------------------------------------------------------------------

_runtime_ctx: Optional[MeshContext] = None
_ctx_lock = threading.Lock()


def set_runtime_context(ctx: Optional[MeshContext]) -> None:
    """Install ``ctx`` as the process-wide context (``None`` clears it)."""
    global _runtime_ctx
    with _ctx_lock:
        _runtime_ctx = ctx


def installed_context() -> Optional[MeshContext]:
    """The context a caller installed, or None."""
    return _runtime_ctx


def runtime_context() -> MeshContext:
    """The installed context, else one over :func:`visible_devices` (built
    anew on each call, so it follows the process default device)."""
    ctx = _runtime_ctx
    return ctx if ctx is not None else MeshContext()
