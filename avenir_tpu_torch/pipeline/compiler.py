"""Chunk pipelines: port of ``avenir_tpu/pipeline/compiler.py``.

A job declares an ordered list of :class:`Stage`\\ s over a chunk stream
(``encode -> monitor-absorb``, ``predict -> monitor``, the online plane's
``absorb -> learn -> predict``); :class:`ChunkPipeline` runs their kernels
once a chunk, in order, each reading its own constants (uploaded once),
the chunk's merged inputs and the earlier stages' outputs from an
``upstream`` dict keyed ``"<stage>.<out>"`` (device to device, no host
hop), and threading its own carry from chunk to chunk.  Only the keys a
stage declares in ``returns`` leave the chunk, as device tensors; the
caller decides what to read back.  A stage's ``prepare`` is its host
half (the merged :meth:`ChunkPipeline.prepare`), and its ``finish``
receives the final carry (:meth:`ChunkPipeline.finalize`).

In the JAX package the stages trace into one jitted XLA program a chunk,
its carries donated.  In the port a chunk is the stage kernels' torch
launches on the carries' device, and what the process-global
:class:`~.cache.ProgramCache` holds under the JAX package's key (without
its kernel-backend axis) is the chunk's static input buffers: ``staged``
copies each input (a host array, or a tensor a caller uploaded itself,
as the streamed ingest does from pinned memory) into the staging tensor
of its key, allocated once.  ``run_chunk`` is one dispatch at the pipeline's ledger site
(``note_dispatch``: ``pipeline.chunk``, or ``online.window`` for the
online plane) inside that site's literal span.  Capturing a chunk in a
CUDA graph is speed work for later.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry import span
from ..utils.tracing import note_dispatch
from .cache import (ProgramCache, _arg_signature, mesh_fingerprint,
                    program_cache)

# a job's fused chunk (the forest's streamed ingest, predictDriftScore's
# window): one Dispatches row a chunk at this site, and its span
PIPELINE_SITE = "pipeline.chunk"
# the online learning plane's serve-and-learn window: its own site and
# span of that name
ONLINE_SITE = "online.window"


@dataclass
class Stage:
    """One stage of a chunk program.

    ``kernel(carry, consts, inputs, upstream) -> (carry, outputs)`` over
    torch tensors on the pipeline's device: ``carry`` this stage's state
    (a nest of tensors, ``()`` for a stateless stage), ``consts`` its
    constants (uploaded once), ``inputs`` the chunk's merged staged
    inputs, ``upstream`` the earlier stages' outputs.  ``prepare(block)
    -> dict`` is the stage's host half (run where the caller stages the
    block); ``carry_init()`` makes the first carry; ``returns`` names the
    outputs handed back a chunk; ``finish(carry)`` receives the final
    carry; ``version`` bumps the stage's key."""

    name: str
    kernel: Callable
    version: str = "1"
    prepare: Optional[Callable] = None
    carry_init: Optional[Callable[[], Any]] = None
    consts: Dict[str, Any] = dc_field(default_factory=dict)
    returns: Tuple[str, ...] = ()
    finish: Optional[Callable[[Any], None]] = None

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

    def fill(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        for k, v in inputs.items():
            self.buffers[k].copy_(v if torch.is_tensor(v) else
                                  torch.from_numpy(np.ascontiguousarray(v)))
        return self.buffers


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
    """Run a stage list once a chunk, with the carries and constants on
    one device and the per-run ProgramCache tallies the job counters
    read."""

    def __init__(self, stages: List[Stage], ctx=None, schema_fp: str = "",
                 cache: Optional[ProgramCache] = None,
                 name: str = "pipeline", site: str = PIPELINE_SITE):
        if not stages:
            raise ValueError("ChunkPipeline needs at least one stage")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        if site not in (PIPELINE_SITE, ONLINE_SITE):
            raise ValueError(f"unknown dispatch site {site!r}")
        from ..parallel.mesh import runtime_context
        self.stages = list(stages)
        self.ctx = ctx or runtime_context()
        self.device = self.ctx.mesh.devices[0]
        self.name = name
        self.site = site
        self.schema_fp = schema_fp
        self.mesh_fp = mesh_fingerprint(self.ctx)
        self.cache = cache if cache is not None else program_cache()
        self.graph_fp = "|".join(s.fingerprint for s in self.stages)
        self._carries = tuple(
            to_device(s.carry_init(), self.device)
            if s.carry_init is not None else () for s in self.stages)
        self._consts = {s.name: to_device(dict(s.consts or {}), self.device)
                        for s in self.stages}
        self._chunks = 0
        # per-RUN tallies (the process-global cache accumulates forever)
        self.hits = 0
        self.misses = 0
        self.retraces = 0
        self._finished = False

    # ---- host side ----
    def prepare(self, block) -> Dict[str, np.ndarray]:
        """Every stage's host half of one block, merged.  A key that two
        stages produce is refused: stages share an input by having one
        stage produce it."""
        out: Dict[str, np.ndarray] = {}
        for s in self.stages:
            if s.prepare is None:
                continue
            d = s.prepare(block) or {}
            dup = set(d) & set(out)
            if dup:
                raise ValueError(f"stage {s.name!r} re-produces input "
                                 f"keys {sorted(dup)}")
            out.update(d)
        return out

    def _key(self, inputs) -> Tuple:
        return ("chunk-pipeline", self.graph_fp, self.schema_fp,
                self.mesh_fp, _arg_signature(self._carries),
                _arg_signature(self._consts), _arg_signature(inputs))

    def _tally(self, outcome: str) -> None:
        if outcome == "hit":
            self.hits += 1
        else:
            self.misses += 1
            self.retraces += 1

    @contextmanager
    def staged(self, inputs: Dict[str, Any]
               ) -> Iterator[Dict[str, torch.Tensor]]:
        """Resolve the chunk's program (once a chunk: the tally), hold it,
        copy every input (host arrays or tensors) into its staging tensor
        and yield those tensors: run the chunk inside the block.  The
        cache hands one key's buffers to every pipeline of that key, so
        another holder waits here until this block ends; by then this
        chunk's launches are queued on the device's stream, ahead of the
        next holder's copies."""
        sig = _arg_signature(inputs)
        prog = self.cache.get_or_compile(
            self._key(inputs), lambda: _Program(sig, self.device),
            on_outcome=self._tally)
        with prog.lock:
            yield prog.fill(inputs)

    # ---- the chunk ----
    def run_chunk(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """ONE dispatch: every stage advances on this chunk; returns the
        declared outputs as device tensors."""
        if self._finished:
            raise RuntimeError("pipeline already finalized")
        note_dispatch(1, site=self.site)
        # literal span names per site: the span taxonomy guard scans
        # call-site literals
        if self.site == ONLINE_SITE:
            cm = span("online.window", cat="online", chunk=self._chunks,
                      stages=len(self.stages))
        else:
            cm = span("pipeline.chunk", cat="pipeline", chunk=self._chunks,
                      stages=len(self.stages))
        with cm:
            upstream: Dict[str, Any] = {}
            new_carries = []
            for st, c in zip(self.stages, self._carries):
                nc, outs = st.kernel(c, self._consts[st.name], inputs,
                                     upstream)
                new_carries.append(nc)
                for k, v in (outs or {}).items():
                    upstream[f"{st.name}.{k}"] = v
            rets = {f"{st.name}.{r}": upstream[f"{st.name}.{r}"]
                    for st in self.stages for r in st.returns}
            self._carries = tuple(new_carries)
        self._chunks += 1
        return rets

    def finalize(self) -> None:
        """End of stream: hand each stage its final carry (idempotent)."""
        if self._finished:
            return
        self._finished = True
        for st, c in zip(self.stages, self._carries):
            if st.finish is not None:
                st.finish(c)

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
