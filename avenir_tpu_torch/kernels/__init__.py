"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* :mod:`.dispatch` — kernel for CUDA tensors, plain version for CPU ones;
* :mod:`.build`    — nvcc build of ``csrc/*.cu`` into ctypes libraries, at
  first use, under ``build/avenir_tpu_torch/``;
* :mod:`.vote`     — the forest ensemble vote, float and int8 (replace the
  Pallas ``ops/pallas/vote.py`` ``ensemble_vote`` and ``quantized_vote``);
* :mod:`.histogram` — the forest level histogram and the monitor bin counts
  (replace the Pallas ``ops/pallas/histogram.py`` ``forest_level_counts``
  and ``bin_counts``).

``csrc/threefry.cu``, the counter hash under ``jax.random``'s streams,
replaces no Pallas kernel; its wrapper is ``utils/threefry.py``.

Nothing here imports ``ctypes`` libraries or runs ``nvcc`` at import time:
the CPU tests import every module on a machine with neither.
"""
