"""The chunk-program layer: port of ``avenir_tpu/pipeline``.

* :mod:`.compiler` — :class:`Stage` (one stage of a per-chunk program: a
  kernel over torch tensors with its constants, carry, host ``prepare``,
  declared returns and ``finish``) and :class:`ChunkPipeline` (runs a
  stage list once a chunk, one dispatch at the ``pipeline.chunk`` or
  ``online.window`` ledger site, with per-run cache tallies for the job
  counters).
* :mod:`.cache` — :class:`ProgramCache`, a process-global LRU keyed as the
  JAX package keys its compiled programs (:func:`schema_fingerprint`,
  :func:`mesh_fingerprint`).  The port's "program" is the chunk's static
  device buffers: its input staging tensors, allocated once a key and
  reused by every chunk that hits it, one holder at a time.
* :mod:`.flows` — :class:`~.flows.PredictDriftFlow`, ``predictDriftScore``'s
  fused window: the forest vote (kernel B2) and the drift window's bin
  counts (kernel B4) with the predicted classes spliced into the class
  row on the device.

The port compiles no program at run time: its kernels are built ahead
of the run (``kernels/build.py``) and a chunk is their launches.  So the
JAX package's ``AVENIR_TPU_PROGRAM_CACHE_DIR`` (compiled XLA programs
kept across processes) has no counterpart.  Capturing a chunk in a CUDA
graph is speed work for later.
"""

from .cache import (ProgramCache, mesh_fingerprint, program_cache,
                    schema_fingerprint)
from .compiler import ONLINE_SITE, PIPELINE_SITE, ChunkPipeline, Stage

__all__ = ["Stage", "ChunkPipeline", "ProgramCache", "program_cache",
           "mesh_fingerprint", "schema_fingerprint", "ONLINE_SITE",
           "PIPELINE_SITE"]
