"""The merges between shards: the in-process gather onto a mesh's merge
device (:func:`gather_to`, the port's counterpart of the ``psum`` /
``all_gather`` the JAX package's sharded paths run inside ``shard_map``),
the keyed sum of a reducer (:func:`keyed_reduce`, :func:`keyed_count`),
and the cross-process :class:`AllReducer` of the sharded streamed builds
and the train-sharded KNN (``avenir_tpu/parallel/collectives.py``).
"""

from __future__ import annotations

import glob
import os
import pickle
import time
import uuid
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.tracing import note_allreduce, note_gather


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


def keyed_reduce(values: torch.Tensor, keys: torch.Tensor, num_keys: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shuffle: ``values`` (n, ...) summed into ``num_keys`` groups by
    ``keys`` (n,), on their device; rows with ``mask`` False and keys
    outside [0, num_keys) add nothing (the JAX package's one-hot drops
    them too).  A scatter-add in ``values``' dtype: exact for the integer
    counts every caller sums (its order is the device's, so a float sum
    of non-integers may differ from the JAX package's one-hot matmul in
    the last bits)."""
    k = keys.long()
    valid = (k >= 0) & (k < num_keys)
    if mask is not None:
        valid = valid & mask.bool()
    out = torch.zeros((num_keys,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, k[valid], values[valid])


def keyed_count(keys: torch.Tensor, num_keys: int,
                mask: Optional[torch.Tensor] = None,
                dtype=torch.float32) -> torch.Tensor:
    """Histogram of ``keys`` over [0, num_keys) in ``dtype``: the
    degenerate :func:`keyed_reduce` with values 1, summed as exact int64
    counts and cast at the end."""
    ones = torch.ones(keys.shape[0], dtype=torch.int64, device=keys.device)
    return keyed_reduce(ones, keys, num_keys, mask).to(dtype)


# dtypes the torch transport sums with dist.all_reduce (exact in any order)
_INT_WIRE = (np.dtype(np.int32), np.dtype(np.int64))


class AllReducer:
    """One collective a step over same-shaped per-process partials — the
    synchronisation of the sharded streamed builds (each process trains on
    its row-range shard; the only traffic is one reduce of the stacked
    counts a level, plus one row-count allgather after ingest) and of the
    train-sharded KNN (one top-k merge a test chunk).

    Transports, chosen at construction:

    * ``local`` — shard count 1: every op is the identity, but each call
      still records into the ledger's ``Collectives`` group, so a
      single-process test can pin the one-collective-a-level discipline;
    * ``file`` — ``AVENIR_TPU_ALLREDUCE_DIR`` (or ``transport_dir``): plain
      processes or threads meet at step-indexed files, written
      tmp-then-rename.  The first exchange runs a run-identity handshake
      (:meth:`_ensure_handshake`) so a directory reused across sequential
      runs cannot serve one run's leftovers to the next; each process
      reaps its own step files two steps behind;
    * ``torch`` — a joined ``torch.distributed`` run (gloo): ``sum`` is
      ``dist.all_reduce`` of an int32 / int64 CPU tensor, or the exact
      ordered host sum for other dtypes; ``allgather`` is
      ``all_gather_object``.

    A shard count above 1 with neither a directory nor a joined run
    raises: partials would never combine.  ``timeout_s``
    (``AVENIR_TPU_ALLREDUCE_TIMEOUT_S``, default 300) bounds the file
    transport's wait for a dead peer, and ``heartbeat_s``
    (``AVENIR_TPU_STALL_HEARTBEAT_S``, default the smaller of a quarter
    of it and 15 s; 0 turns it off) the wait before
    a ``RuntimeWarning`` names the shards still missing.  Steps are ordered
    per reducer ``name``: every participant constructs the same reducers in
    the same order and calls the same ops in the same order (lock step, as
    with any collective)."""

    def __init__(self, spec=None, name: str = "reduce",
                 transport_dir: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None):
        from . import distributed
        self.spec = spec if spec is not None else distributed.shard_spec()
        self.name = name
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else distributed.timeout_s())
        self.heartbeat_s = float(
            heartbeat_s if heartbeat_s is not None
            else os.environ.get("AVENIR_TPU_STALL_HEARTBEAT_S",
                                min(self.timeout_s / 4.0, 15.0)))
        self.dir = transport_dir or os.environ.get("AVENIR_TPU_ALLREDUCE_DIR")
        if self.spec.count == 1:
            self.transport = "local"
        elif self.dir:
            self.transport = "file"
            os.makedirs(self.dir, exist_ok=True)
        elif distributed.process_count() == self.spec.count:
            self.transport = "torch"
        else:
            raise ValueError(
                f"shard count {self.spec.count} > 1 but neither a joined "
                f"torch.distributed run of that size nor "
                f"AVENIR_TPU_ALLREDUCE_DIR: partials would never combine")
        self._step = 0
        self._nonce = uuid.uuid4().hex   # this run's identity on the wire
        self._peers = None               # index -> nonce, after handshake

    # ---- public ops (each is one collective) ----
    def sum(self, arr) -> np.ndarray:
        """Element-wise sum of a same-shaped per-process partial, exact in
        the input dtype.  The torch transport's path depends on the dtype
        alone, never on local values: every process must issue the same
        collective."""
        arr = np.asarray(arr)
        note_allreduce(arr.nbytes)
        if self.transport == "local":
            return arr
        if self.transport == "file":
            parts = self._file_exchange(arr)
            out = parts[0].copy()
            for p in parts[1:]:
                out += p
            return out
        if arr.dtype in _INT_WIRE:
            import torch.distributed as dist
            t = torch.from_numpy(np.ascontiguousarray(arr).copy())
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            return t.numpy()
        from .distributed import all_reduce_host_array
        return all_reduce_host_array(arr)

    def allgather(self, obj) -> list:
        """Every process's ``obj`` in shard order.  One collective; the
        payload is pickled once, for the byte count and the wire."""
        if self.transport == "local":
            note_allreduce(0)
            return [obj]
        buf = pickle.dumps(obj)
        note_allreduce(len(buf))
        if self.transport == "file":
            return self._file_exchange(obj, pickled=buf)
        from .distributed import allgather_object
        return [pickle.loads(b) for b in allgather_object(buf)]

    def merge_topk(self, nd: np.ndarray, ni: np.ndarray, k: int,
                   device=None):
        """The lock-step KNN merge: each process contributes its (n_test,
        w) nearest list — distances ascending, GLOBAL train indices, dead
        slots (+inf, -1) — and every process returns the identical global
        (n_test, min(k, total w)) best list, ties to the lowest global
        index: the single-process scan's answer.  One allgather; then
        every process uploads the P lists to ``device`` and merges them
        with the top-k merge kernel, in rounds of at most 64 lists when
        P is larger (``kernels.topk.topk_merge_rounds``; its plain version
        for CPU tensors).  Returns host arrays."""
        from ..kernels.dispatch import note_backend, resolve_backend
        from ..kernels.topk import topk_merge_rounds
        from ..runtime import resolve_device
        from ..utils.tracing import fetch, note_dispatch, note_h2d
        nd = np.asarray(nd, np.float32)
        ni = np.asarray(ni, np.int32)
        parts = self.allgather((nd, ni))
        nt = nd.shape[0]
        kk = min(int(k), sum(p[0].shape[1] for p in parts))
        dev = resolve_device(device)
        ds, is_ = [], []
        for d, i in parts:
            w = min(d.shape[1], kk)
            dp = np.full((nt, kk), np.inf, np.float32)
            ip = np.full((nt, kk), -1, np.int32)
            dp[:, :w] = d[:, :w]
            ip[:, :w] = i[:, :w]
            note_h2d(dp.nbytes + ip.nbytes, transfers=2)
            ds.append(torch.from_numpy(dp).to(dev))
            is_.append(torch.from_numpy(ip).to(dev))
        note_dispatch(site="knn.process_merge")
        note_backend("knn.process_merge", resolve_backend(dev))
        bd, bi = topk_merge_rounds(ds, is_, kk)
        return fetch(bd), fetch(bi)

    # ---- file transport ----
    def _fpath(self, stem: str, idx: int) -> str:
        return os.path.join(self.dir, f"{self.name}-{stem}.{idx}.part")

    def _fwrite(self, path: str, head, body: bytes = b"") -> None:
        tmp = f"{path}.tmp-{os.getpid()}-{id(self)}"
        with open(tmp, "wb") as fh:
            fh.write(pickle.dumps(head))
            fh.write(body)
        os.replace(tmp, path)

    def _stall(self, phase: str, step: int, missing, waited_s: float):
        warnings.warn(
            f"AllReducer[{self.name}] stall at {phase} step {step}: shard "
            f"{self.spec.index}/{self.spec.count} has waited "
            f"{waited_s:.1f}s for shard(s) {sorted(missing)} (heartbeat "
            f"{self.heartbeat_s}s, timeout {self.timeout_s}s)",
            RuntimeWarning)

    def _probe_missing(self, stem: str) -> List[int]:
        """The peers without a readable current-run file for ``stem``."""
        missing = []
        for j in range(self.spec.count):
            if j == self.spec.index:
                continue
            try:
                with open(self._fpath(stem, j), "rb") as fh:
                    if self._peers is not None and \
                            pickle.load(fh) != self._peers[j]:
                        missing.append(j)
            except (OSError, EOFError, pickle.UnpicklingError):
                missing.append(j)
        return missing

    def _fread_wait(self, path: str, deadline: float, what: str, shard: int):
        """The pickled head of ``path`` once it is readable; raises past
        ``deadline``, warns each heartbeat."""
        t0 = time.monotonic()
        beat = t0 + self.heartbeat_s if self.heartbeat_s > 0 else None
        while True:
            try:
                with open(path, "rb") as fh:
                    return pickle.load(fh)
            except (OSError, EOFError, pickle.UnpicklingError):
                now = time.monotonic()
                if beat is not None and now >= beat:
                    self._stall("handshake", self._step, [shard], now - t0)
                    beat = now + self.heartbeat_s
                if now > deadline:
                    raise RuntimeError(
                        f"AllReducer[{self.name}]: {what} never appeared at "
                        f"{path!r} within {self.timeout_s}s")
                time.sleep(0.005)

    def _ensure_handshake(self) -> None:
        """Run-identity handshake, before the first exchange.

        A reused directory can hold an earlier run's files (the reap keeps
        each shard's last two steps; a crash keeps everything).  Each
        participant removes its own leftovers (only it writes files with
        its index, so this cannot race a live peer), announces a fresh
        nonce, and waits until every peer has echoed that nonce back; a
        peer whose echo carries a newer nonce than the one first read is
        adopted and our echo republished.  Payloads carry the writer's
        nonce and a stale one reads as missing: leftovers can delay a
        step, never poison it."""
        if self._peers is not None:
            return
        i = self.spec.index
        for f in glob.glob(os.path.join(self.dir, f"{self.name}-*.{i}.part")):
            try:
                os.remove(f)
            except OSError:
                pass
        self._fwrite(self._fpath("hello-a", i), self._nonce)
        deadline = time.monotonic() + self.timeout_s
        self._peers = {
            j: self._fread_wait(self._fpath("hello-a", j), deadline,
                                f"shard {j}'s announce", j)
            for j in range(self.spec.count)}
        self._fwrite(self._fpath("hello-b", i),
                     (self._nonce, dict(self._peers)))
        for j in range(self.spec.count):
            t0 = time.monotonic()
            beat = t0 + self.heartbeat_s if self.heartbeat_s > 0 else None
            while True:
                nonce_j, echo = self._fread_wait(
                    self._fpath("hello-b", j), deadline,
                    f"shard {j}'s acknowledgment", j)
                if nonce_j != self._peers[j]:
                    self._peers[j] = nonce_j
                    self._fwrite(self._fpath("hello-b", i),
                                 (self._nonce, dict(self._peers)))
                if echo.get(i) == self._nonce:
                    break
                now = time.monotonic()
                if beat is not None and now >= beat:
                    self._stall("handshake", self._step, [j], now - t0)
                    beat = now + self.heartbeat_s
                if now > deadline:
                    raise RuntimeError(
                        f"AllReducer[{self.name}] handshake: shard {j} "
                        f"never acknowledged this run within "
                        f"{self.timeout_s}s (peer died, or {self.dir!r} is "
                        f"shared with another live run)")
                time.sleep(0.005)

    def _file_exchange(self, obj, pickled: Optional[bytes] = None) -> list:
        """Step barrier: write this shard's nonce-tagged payload, wait for
        every peer's payload of the same step, read them in shard order.
        A shard entering step s has read every peer's step s-1 file, so it
        removes its own step s-2 file."""
        self._ensure_handshake()
        step = self._step
        self._step += 1
        stem = f"{step:06d}"
        self._fwrite(self._fpath(stem, self.spec.index), self._nonce,
                     pickled if pickled is not None else pickle.dumps(obj))
        if step >= 2:
            try:
                os.remove(self._fpath(f"{step - 2:06d}", self.spec.index))
            except OSError:
                pass
        parts = []
        t0 = time.monotonic()
        deadline = t0 + self.timeout_s
        beat = t0 + self.heartbeat_s if self.heartbeat_s > 0 else None
        for idx in range(self.spec.count):
            path = self._fpath(stem, idx)
            while True:
                try:
                    with open(path, "rb") as fh:
                        if pickle.load(fh) != self._peers[idx]:
                            raise EOFError("stale payload")
                        parts.append(pickle.load(fh))
                    break
                except (OSError, EOFError, pickle.UnpicklingError):
                    now = time.monotonic()
                    if beat is not None and now >= beat:
                        self._stall("exchange", step,
                                    self._probe_missing(stem), now - t0)
                        beat = now + self.heartbeat_s
                    if now > deadline:
                        raise RuntimeError(
                            f"AllReducer[{self.name}] step {step}: shard "
                            f"{idx} never produced {path!r} within "
                            f"{self.timeout_s}s (peer died or fell out of "
                            f"lock step)")
                    time.sleep(0.005)
        return parts
