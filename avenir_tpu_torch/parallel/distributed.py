"""Multi-process runs of the port: the process identity, the row-range split
and the host collectives, from ``avenir_tpu/parallel/distributed.py``.

Two lanes run a job over several processes:

* **the joined run** — ``torch.distributed`` (in place of the JAX package's
  ``jax.distributed``), initialised by :func:`initialize` from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``) with the **gloo** backend: every collective here moves
  host data, and NCCL refuses two ranks on one card, which is how a
  one-GPU machine runs both;
* **the shard lane** — plain processes under ``AVENIR_TPU_SHARD=i/P`` that
  exchange partials through ``parallel.collectives.AllReducer``'s file
  transport (``AVENIR_TPU_ALLREDUCE_DIR``).  The override wins over a
  joined run's identity in :func:`shard_spec`.

The split rule of the sharded streamed ingest is :func:`shard_rows`: a
contiguous source-row range a shard, aligned to the ingest block grid.
:func:`work_slice` splits independent work items (the KNN test axis) by
process.  Every multi-process job keeps the reference's contract: each
process trains the model a single process trains, bit for bit.

A ``gather`` job's input spool rests on :func:`allgather_files` (every
process's input files as bytes, one exchange) and :func:`spool_name` (the
rank-ordered file names the spool directory holds).

Each process drives its own card (``parallel.mesh.worker_device`` of
:func:`local_index`); on a machine with one GPU the ranks share it.

Left out, with no counterpart in the port: ``make_hybrid_mesh``,
``row_sharding`` and ``from_process_local``, the JAX package's global-array
plumbing (a process here holds only its own rows; the sharded paths
exchange partials through explicit collectives).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np

# gloo: host tensors only (see the module docstring)
BACKEND = "gloo"
# the default bound on a collective's wait for a dead peer, seconds
DEFAULT_TIMEOUT_S = 300.0


def _dist():
    """``torch.distributed`` when this process joined a group, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def timeout_s() -> float:
    """``AVENIR_TPU_ALLREDUCE_TIMEOUT_S``: how long a collective waits for a
    dead peer before it fails (both lanes)."""
    return float(os.environ.get("AVENIR_TPU_ALLREDUCE_TIMEOUT_S",
                                DEFAULT_TIMEOUT_S))


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def local_index() -> int:
    """This process's index among the processes of its host, which picks
    the card it drives: torchrun's ``LOCAL_RANK``, else the joined run's
    rank, else the shard lane's index."""
    env = os.environ.get("LOCAL_RANK")
    if env:
        return int(env)
    return process_index() if is_multiprocess() else shard_spec().index


def is_multiprocess() -> bool:
    return process_count() > 1


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Join a multi-process run, or skip joining.

    Explicit: pass ``init_method`` (``tcp://host:port`` or ``file://...``)
    with ``world_size`` and ``rank``.  Otherwise torchrun's environment:
    ``WORLD_SIZE`` > 1 with ``RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``.
    Neither: a single-process no-op returning False.  A partial
    environment raises instead of running single-process: each process
    computing 'global' results over only its own shard is the worst
    failure of this module.  Idempotent: a second call keeps the first
    join."""
    import torch.distributed as dist
    if _dist() is not None:
        return dist.get_world_size() > 1
    if world_size is None:
        ws = os.environ.get("WORLD_SIZE")
        world_size = int(ws) if ws else None
    if rank is None:
        rk = os.environ.get("RANK")
        rank = int(rk) if rk else None
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if init_method is None and (addr or port):
        if not (addr and port):
            raise ValueError("MASTER_ADDR and MASTER_PORT must be set "
                             "together; refusing to run single-process")
        if world_size is None:
            raise ValueError("MASTER_ADDR set without WORLD_SIZE; refusing "
                             "to run single-process")
        init_method = f"tcp://{addr}:{port}"
    if world_size is None or world_size <= 1:
        if init_method is not None and world_size is None:
            raise ValueError("an init method without a world size; refusing "
                             "to run single-process")
        return False
    if init_method is None:
        raise ValueError("WORLD_SIZE > 1 without MASTER_ADDR / MASTER_PORT; "
                         "refusing to run single-process (each process "
                         "would compute 'global' results over its own "
                         "shard)")
    if rank is None:
        raise ValueError("WORLD_SIZE > 1 but no process rank (RANK)")
    dist.init_process_group(BACKEND, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s()))
    return True


def leave() -> None:
    """Leave the joined run at the end of a job: a barrier, so no process
    tears down while a peer still talks to it, then the group destroyed
    (gloo's threads outliving the interpreter abort the process).  A
    no-op when no group was joined."""
    d = _dist()
    if d is not None:
        d.barrier()
        d.destroy_process_group()


def shard_rows(n_rows: int, index: int, count: int,
               chunk_rows: int = 1) -> Tuple[int, int]:
    """Contiguous source-row range ``[lo, hi)`` owned by shard ``index`` of
    ``count`` over an ``n_rows``-row source — the one split rule of the
    sharded streamed ingest.

    Split points sit on the ``chunk_rows`` grid (the ``source_row_end``
    axis every streamed block reports), so a shard consumes whole ingest
    blocks and a bad record, counted on the source-row axis, belongs to
    exactly one shard.  The ranges are disjoint and cover ``[0, n_rows)``;
    shards past the last block are empty (``lo == hi``), a valid
    participant; the last non-empty shard takes the tail block."""
    if count < 1:
        raise ValueError(f"shard count must be >= 1, got {count}")
    if not 0 <= index < count:
        raise ValueError(f"shard index {index} outside [0, {count})")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    blocks = -(-n_rows // chunk_rows)
    lo_b = blocks * index // count
    hi_b = blocks * (index + 1) // count
    return (min(lo_b * chunk_rows, n_rows),
            min(hi_b * chunk_rows, n_rows))


@dataclass(frozen=True)
class ShardSpec:
    """This process's identity in a row-range-sharded run: ``(index,
    count)``.  ``count == 1`` is the single-process case (every shard
    helper is the identity)."""

    index: int = 0
    count: int = 1

    def __post_init__(self):
        if self.count < 1 or not 0 <= self.index < self.count:
            raise ValueError(f"bad shard spec {self.index}/{self.count}")

    @property
    def active(self) -> bool:
        return self.count > 1

    def range_for(self, n_rows: int, chunk_rows: int = 1) -> Tuple[int, int]:
        return shard_rows(n_rows, self.index, self.count, chunk_rows)


def shard_spec() -> ShardSpec:
    """This process's shard: ``AVENIR_TPU_SHARD=i/P`` when set (it wins, so
    the shard lane can never be demoted to one shard by a joined run's
    identity), else the joined run's rank and size, else ``0/1``."""
    env = os.environ.get("AVENIR_TPU_SHARD")
    if env:
        try:
            i, _, p = env.partition("/")
            return ShardSpec(int(i), int(p))
        except ValueError as exc:
            raise ValueError(f"AVENIR_TPU_SHARD must look like "
                             f"'index/count', got {env!r}") from exc
    if is_multiprocess():
        return ShardSpec(process_index(), process_count())
    return ShardSpec()


def work_slice(n: int) -> Tuple[int, int]:
    """This process's contiguous ``[lo, hi)`` share of ``n`` independent
    work items (the KNN test rows) — the reference's Spark mapPartitions
    split as an index range.  Single process: ``(0, n)``.  ``lo == 0 and
    hi > 0`` marks the process owning item 0, which emits 'set'-style
    counters so that their cross-process sum is the value."""
    p, total = (process_index(), process_count()) if is_multiprocess() \
        else (0, 1)
    return n * p // total, n * (p + 1) // total


def allgather_object(obj):
    """Every process's picklable ``obj``, in process order (single
    process: ``[obj]``): ``dist.all_gather_object`` over gloo.  For small
    host state: row counts, per-shard tallies, top-k lists."""
    d = _dist()
    if d is None or d.get_world_size() == 1:
        return [obj]
    out = [None] * d.get_world_size()
    d.all_gather_object(out, obj)
    return out


def allgather_files(paths: Sequence[str], what: str = "input gather"
                    ) -> List[List[Tuple[str, bytes]]]:
    """Every process's files as ``(basename, bytes)`` pairs, in process
    order: one :func:`allgather_object` of this process's files read as
    bytes (a byte that does not decode must not raise on one process while
    its peers wait in the collective), together with this process's read
    error.  A read error on any process raises ``RuntimeError`` on every
    process, naming each failed one, so none is left in a collective."""
    err, local = None, []
    try:
        for p in paths:
            with open(p, "rb") as fh:
                local.append((os.path.basename(p), fh.read()))
    except Exception as exc:   # MemoryError too: any escape before the
        # collective would leave the peers blocked in it
        err = f"process {process_index()}: {type(exc).__name__}: {exc}"
        local = []
    gathered = allgather_object((err, local))
    errors = [e for e, _ in gathered if e]
    if errors:
        raise RuntimeError(f"{what} failed on {len(errors)} process(es): "
                           + "; ".join(errors))
    return [files for _, files in gathered]


def spool_name(basename: str, proc: int) -> str:
    """The name of process ``proc``'s file ``basename`` in a gather spool:
    ``<basename>.p<proc>``.  The basename is kept (the similarity jobs key
    the train set on its prefix) and the suffix keeps two processes' files
    of one name apart."""
    return f"{basename}.p{proc}"


def all_reduce_host_array(x) -> np.ndarray:
    """Element-wise sum of a same-shaped host array across processes, exact
    in its dtype and the same on every process: the parts are gathered and
    summed in process order (a float sum's order then cannot differ
    between processes).  Single process: ``np.asarray(x)``."""
    x = np.asarray(x)
    if not is_multiprocess():
        return x
    parts = allgather_object(x)
    out = parts[0].copy()
    for p in parts[1:]:
        out += p
    return out


def all_reduce_counters(counters):
    """Sum a ``Counters`` across the processes (Hadoop counters are global;
    host-side tallies are per process under a joined run).  One gather of
    each process's counter dict, summed by key, so a key only some
    processes set still sums instead of misaligning.  Single process:
    identity."""
    if not is_multiprocess():
        return counters
    with counters._lock:
        mine = dict(counters._c)
    total = {}
    for part in allgather_object(mine):
        for key, v in part.items():
            total[key] = total.get(key, 0) + int(v)
    with counters._lock:
        counters._c.clear()
        counters._c.update(total)
    return counters
