"""ProgramCache: port of ``avenir_tpu/pipeline/cache.py``, trimmed.

The JAX package caches a chunk's AOT-compiled XLA program under a key of
everything that fixes its lowered form: the stage graph, the schema, the
argument signature (flattened shapes and dtypes of every carry, constant
and input) and the mesh.  The port keeps the key and the LRU, and caches
what a chunk needs that depends on nothing but that key: its static
device buffers (``ChunkPipeline``'s input staging tensors).  A miss
allocates them (``build()``); a hit hands the same tensors back, so a warm
stream of windows allocates nothing and ``Hits`` / ``Misses`` /
``Retraces`` count what they count in the JAX package.  Unlike a compiled
program an entry is mutable, so it is held by one pipeline at a time
(its lock, taken by ``ChunkPipeline.staged``).  The key leaves
out the JAX package's kernel-backend axis: the port has no such knob (a
tensor's device picks the form).  Left out: the disk persistence.

Telemetry: a miss records a ``pipeline.compile`` span, a hit a
``pipeline.cache_hit`` instant.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..telemetry import instant, span

DEFAULT_MAXSIZE = 64


def mesh_fingerprint(ctx) -> str:
    """The placement half of a key: the context's device count and
    platform."""
    mesh = ctx.mesh
    return f"d{mesh.size}:{mesh.platform}"


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, np.ndarray) or isinstance(leaf, np.generic):
        return str(leaf.dtype)
    return type(leaf).__name__


def _leaves(tree, path=()):
    """(structure, leaves) of nested dicts (sorted keys), tuples and
    lists."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k], path + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaves(v, path + (i,)))
        return out
    return [(path, tree)]


def _arg_signature(tree) -> Tuple:
    """Flattened (structure, (shape, dtype) per leaf) of nested dicts and
    tuples of tensors or arrays: the shape/dtype part of a key.  A numpy
    array and a tensor of one shape and dtype sign alike."""
    leaves = _leaves(tree)
    return (tuple(p for p, _ in leaves),
            tuple((tuple(getattr(v, "shape", ())), _dtype_name(v))
                  for _, v in leaves))


class ProgramCache:
    """LRU of chunk programs.  ``get_or_compile(key, build)`` returns the
    cached program or ``build()``'s.  The LRU is thread-safe; what an
    entry holds is guarded by its holder (``ChunkPipeline.staged``)."""

    def __init__(self, maxsize: int = DEFAULT_MAXSIZE):
        self.maxsize = int(maxsize)
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.retraces = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "retraces": self.retraces,
                    "entries": len(self._entries)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def get_or_compile(self, key: Tuple, build: Callable[[], Any],
                       on_outcome: Optional[Callable[[str], None]] = None
                       ) -> Any:
        """The one entry: ``key`` hashable, ``build()`` makes the program
        on a miss.  ``on_outcome`` is called once with ``"hit"`` or
        ``"compile"`` — how this call resolved, for a per-run tally that
        other pipelines sharing the cache cannot disturb."""
        with self._lock:
            prog = self._entries.get(key)
            if prog is not None:
                self._entries.move_to_end(key)
                self.hits += 1
        if prog is not None:
            if on_outcome is not None:
                on_outcome("hit")
            instant("pipeline.cache_hit", cat="pipeline",
                    key=_short_key(key))
            return prog
        with span("pipeline.compile", cat="pipeline", key=_short_key(key)):
            prog = build()
        with self._lock:
            self.misses += 1
            self.retraces += 1
            self._entries[key] = prog
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        if on_outcome is not None:
            on_outcome("compile")
        return prog


def _short_key(key: Tuple) -> str:
    return hashlib.sha256(repr(key).encode()).hexdigest()[:10]


_GLOBAL: Optional[ProgramCache] = None
_GLOBAL_LOCK = threading.Lock()


def program_cache() -> ProgramCache:
    """The process-global cache: a second job in one process allocates
    nothing anew."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ProgramCache()
        return _GLOBAL
