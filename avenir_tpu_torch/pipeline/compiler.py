"""Chunk pipelines: port of ``avenir_tpu/pipeline/compiler.py``, trimmed to
what the online learning plane's window needs.

A window declares an ordered list of :class:`Stage`\\ s; :class:`ChunkPipeline`
runs their kernels once a chunk, in order, each reading the earlier
stages' outputs from an ``upstream`` dict keyed ``"<stage>.<out>"`` (device
to device, no host hop) and threading its own carry from chunk to chunk.
Only the keys a stage declares in ``returns`` leave the chunk, as device
tensors; the caller decides what to read back.

In the JAX package the stages trace into one jitted XLA program a chunk,
its carries donated.  In the port a chunk is the stage kernels' torch
launches on the carries' device, and what the process-global
:class:`~.cache.ProgramCache` holds under the JAX package's key (without
its kernel-backend axis) is the chunk's static input buffers: ``staged``
copies each host input into the staging tensor of its key, allocated
once.  ``run_chunk`` is one dispatch at the ``online.window`` ledger site
(``note_dispatch``) inside its literal span.  Capturing the chunk in a
CUDA graph is left for later (ROADMAP A.4).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry import span
from ..utils.tracing import note_dispatch
from .cache import (ProgramCache, _arg_signature, mesh_fingerprint,
                    program_cache)

# the online learning plane's serve-and-learn window: one Dispatches row
# a window at this site, and the span of the same name
ONLINE_SITE = "online.window"


@dataclass
class Stage:
    """One stage of a chunk program.

    ``kernel(carry, inputs, upstream) -> (carry, outputs)`` over torch
    tensors on the pipeline's device: ``carry`` this stage's state (a
    nest of tensors), ``inputs`` the chunk's staged inputs, ``upstream``
    the earlier stages' outputs.  ``carry_init()`` makes the first carry;
    ``returns`` the outputs handed back a chunk; ``version`` bumps the
    stage's key."""

    name: str
    kernel: Callable
    carry_init: Callable[[], Any]
    version: str = "1"
    returns: Tuple[str, ...] = ()

    @property
    def fingerprint(self) -> str:
        return f"{self.name}:{self.version}"


class _Program:
    """A chunk key's static device buffers: one staging tensor an input,
    and the lock its holder keeps from the copies to the launches."""

    __slots__ = ("buffers", "lock")

    def __init__(self, signature, device):
        paths, specs = signature
        self.buffers = {}
        for path, (shape, dtype) in zip(paths, specs):
            self.buffers[path[0]] = torch.empty(
                shape, dtype=getattr(torch, dtype), device=device)
        self.lock = threading.Lock()


def to_device(tree, device):
    """A nest of numpy arrays or tensors as tensors on ``device`` (uint32
    arrays as int64, the threefry twin's key form)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, device) for v in tree)
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if torch.is_tensor(tree):
        return tree.to(device)
    a = np.asarray(tree)
    if a.dtype == np.uint32:        # a threefry key: the twin's int64 words
        a = a.astype(np.int64)
    return torch.as_tensor(a).to(device)


class ChunkPipeline:
    """Run a stage list once a chunk, with the carries on one device and
    the per-run ProgramCache tallies the job counters read."""

    def __init__(self, stages: List[Stage], ctx=None, schema_fp: str = "",
                 cache: Optional[ProgramCache] = None):
        if not stages:
            raise ValueError("ChunkPipeline needs at least one stage")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        from ..parallel.mesh import runtime_context
        self.stages = list(stages)
        self.ctx = ctx or runtime_context()
        self.device = self.ctx.mesh.devices[0]
        self.schema_fp = schema_fp
        self.mesh_fp = mesh_fingerprint(self.ctx)
        self.cache = cache if cache is not None else program_cache()
        self.graph_fp = "|".join(s.fingerprint for s in self.stages)
        self._carries = tuple(to_device(s.carry_init(), self.device)
                              for s in self.stages)
        self._chunks = 0
        # per-RUN tallies (the process-global cache accumulates forever)
        self.hits = 0
        self.misses = 0
        self.retraces = 0

    def _key(self, inputs) -> Tuple:
        return ("chunk-pipeline", self.graph_fp, self.schema_fp,
                self.mesh_fp, _arg_signature(self._carries),
                _arg_signature(inputs))

    def _tally(self, outcome: str) -> None:
        if outcome == "hit":
            self.hits += 1
        else:
            self.misses += 1
            self.retraces += 1

    @contextmanager
    def staged(self, host_inputs: Dict[str, np.ndarray]
               ) -> Iterator[Dict[str, torch.Tensor]]:
        """Resolve the chunk's program (once a chunk), hold it, copy every
        host input into its staging tensor and yield those tensors: run
        the chunk inside the block.  The cache hands one key's buffers to
        every pipeline of that key, so another holder waits here until
        this block ends; by then this chunk's launches are queued on the
        device's stream, ahead of the next holder's copies."""
        sig = _arg_signature(host_inputs)
        prog = self.cache.get_or_compile(
            self._key(host_inputs), lambda: _Program(sig, self.device),
            on_outcome=self._tally)
        with prog.lock:
            for k, v in host_inputs.items():
                prog.buffers[k].copy_(
                    torch.from_numpy(np.ascontiguousarray(v)))
            yield prog.buffers

    def run_chunk(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """ONE dispatch: every stage advances on this chunk; returns the
        declared outputs as device tensors."""
        note_dispatch(1, site=ONLINE_SITE)
        with span("online.window", cat="online", chunk=self._chunks,
                  stages=len(self.stages)):
            upstream: Dict[str, Any] = {}
            new_carries = []
            for st, c in zip(self.stages, self._carries):
                nc, outs = st.kernel(c, inputs, upstream)
                new_carries.append(nc)
                for k, v in (outs or {}).items():
                    upstream[f"{st.name}.{k}"] = v
            rets = {f"{st.name}.{r}": upstream[f"{st.name}.{r}"]
                    for st in self.stages for r in st.returns}
            self._carries = tuple(new_carries)
        self._chunks += 1
        return rets

    # ---- carry access (the online plane's snapshot/restore hooks) ----
    @property
    def carries(self) -> Tuple[Any, ...]:
        return self._carries

    def install_carries(self, carries: Tuple[Any, ...]) -> None:
        """Replace every stage's carry (restore / rollback).  The
        replacement must match the running signature leaf for leaf."""
        carries = tuple(to_device(c, self.device) for c in carries)
        if len(carries) != len(self.stages):
            raise ValueError(f"expected {len(self.stages)} carries, "
                             f"got {len(carries)}")
        if _arg_signature(carries) != _arg_signature(self._carries):
            raise ValueError("carry signature mismatch: restored state "
                             "does not match the running pipeline's "
                             "shapes/dtypes")
        self._carries = carries

    # ---- accounting ----
    def run_stats(self) -> Dict[str, int]:
        return {"chunks": self._chunks, "hits": self.hits,
                "misses": self.misses, "retraces": self.retraces}

    def export(self, counters, group: str = "ProgramCache") -> None:
        """Per-run cache tallies into the job counters: a warm re-run
        shows ``Retraces`` 0."""
        counters.update_group(group, {
            "Chunks": self._chunks, "Hits": self.hits,
            "Misses": self.misses, "Retraces": self.retraces})
