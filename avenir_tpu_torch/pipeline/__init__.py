"""The chunk-program layer: port of ``avenir_tpu/pipeline`` (trimmed).

* :mod:`.compiler` — :class:`Stage` (one stage of a per-chunk program:
  a kernel over torch tensors, a carry, declared returns) and
  :class:`ChunkPipeline` (runs a stage list once a chunk, one dispatch at
  the ``online.window`` ledger site, with per-run cache tallies for the
  job counters).
* :mod:`.cache` — :class:`ProgramCache`, a process-global LRU keyed as the
  JAX package keys its compiled programs.  The port's "program" is the
  chunk's static device buffers: its input staging tensors, allocated
  once a key and reused by every chunk that hits it, one holder at a
  time.

Left for later (ROADMAP A.4): CUDA-graph capture of a chunk, the cache's
disk persistence (``AVENIR_TPU_PROGRAM_CACHE_DIR``), ``flows.py``, the
forest's fused ``ChunkPipeline`` and what it needs of the JAX package's
(host ``prepare`` encodes, stage constants, ``finalize``, other sites).
"""

from .cache import ProgramCache, mesh_fingerprint, program_cache
from .compiler import ONLINE_SITE, ChunkPipeline, Stage

__all__ = ["Stage", "ChunkPipeline", "ProgramCache", "program_cache",
           "mesh_fingerprint", "ONLINE_SITE"]
