"""avenir-tpu on PyTorch and CUDA: the port of ``avenir_tpu`` to an NVIDIA
H100 (Hopper, ``sm_90a``).

The package keeps the JAX package's module layout and names
(``avenir_tpu_torch/models/forest.py`` is the counterpart of
``avenir_tpu/models/forest.py``), its CSV / JSON-schema / properties
contract and its job class names.  It imports ``torch`` and numpy and
never ``jax`` or anything of ``avenir_tpu``: the host code it needs is
copied in.  Every TPU (Pallas) kernel on a ported path is a hand-written
CUDA kernel under ``csrc/``, built at first use; its plain PyTorch
version serves tensors that lie on the CPU.

Ported so far: random-forest serving — ``modelPredictor`` and the
in-process ``predictionService`` over a published forest, with the
ensemble vote as a CUDA kernel (``kernels/vote.py``, ``csrc/vote.cu``) —
and random-forest training — ``randomForestBuilder`` with the registry
publish and ``decisionTreeBuilder``, with the level histogram as a CUDA
kernel (``kernels/histogram.py``, ``csrc/histogram.cu``).
"""
