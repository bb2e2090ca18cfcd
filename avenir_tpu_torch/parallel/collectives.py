"""The merge between a mesh's shards inside one process: the port's
counterpart of the ``psum`` / ``all_gather`` that the JAX package's sharded
paths run inside ``shard_map`` (``serving/predictor.py`` sharded core,
``ops/pallas/topk.py`` ``topk_scan_sharded``).

Only what the single-process mesh needs is here.  The multi-process
``AllReducer`` of ``avenir_tpu/parallel/collectives.py`` (local, file and
``torch.distributed`` transports) comes with the next slice.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils.tracing import note_gather


def gather_to(tensors: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """Each shard's tensor on the merge ``device``, in shard order: one
    merge in the ledger's ``Collectives`` group, with the bytes copied.

    A tensor already on ``device`` is not copied.  The copies are plain
    blocking ``Tensor.to(device)`` calls, which PyTorch orders after the
    work queued on the source device's current stream and before the work
    queued next on the destination's; ``non_blocking`` would need events
    around it."""
    device = torch.device(device)
    out, moved = [], 0
    for t in tensors:
        if t.device == device:
            out.append(t)
        else:
            out.append(t.to(device))
            moved += t.element_size() * t.nelement()
    note_gather(moved)
    return out
