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
random-forest training — ``randomForestBuilder`` with the registry
publish and ``decisionTreeBuilder``, with the level histogram as a CUDA
kernel (``kernels/histogram.py``, ``csrc/histogram.cu``) — and the
version's two sidecars with the int8 serve: the monitor baseline
(``monitor/baseline.py``, with the bin counts as a CUDA kernel,
``csrc/bin_counts.cu``) and the int8 forest (``serving/quantized.py``,
served by the int8 form of the vote kernel in ``csrc/vote.cu``) — KNN
(``ops/distance.py``, ``models/knn.py``, the ``knnPipeline`` flow, with the
distance + top-k scan as a CUDA kernel, ``csrc/topk.cu``) — and one process
over several devices (``parallel/``): the tree-sharded serving vote
(``serve_mesh``) and the train-sharded KNN top-k, with the partial-vote,
merge-finalize and top-k merge kernels — and Naive Bayes
(``models/bayes.py``, ``models/bayes_text.py``, ``ops/histogram.py``: the
train and predict jobs, tabular and text, ``featureCondProbJoiner``, the
registry's ``bayes`` kind and its serving), composed torch ops, since the
JAX package's Bayes path reaches no Pallas kernel.
"""
