"""The port's kernel-backend resolver (avenir_tpu_torch/kernels/dispatch.py)
and device selection (avenir_tpu_torch/runtime.py), the counterpart of
tests/test_pallas_kernels.py::test_backend_knob_resolution."""

import numpy as np
import pytest
import torch

from avenir_tpu_torch import runtime
from avenir_tpu_torch.kernels import vote
from avenir_tpu_torch.kernels.dispatch import resolve_backend


@pytest.mark.parametrize("device,want", [
    ("cpu", "torch"), (torch.device("cpu"), "torch"),
    ("cuda", "cuda"), ("cuda:1", "cuda"), (torch.device("cuda", 0), "cuda"),
])
def test_backend_knob_resolution(device, want):
    # the backend follows the tensors' device: no knob can put the plain
    # version on the card or a kernel on the CPU
    assert resolve_backend(device) == want


def test_explicit_cuda_on_cpu_tensors_raises_without_launch():
    rng = np.random.default_rng(0)
    T, P, F, C, K = 3, 4, 2, 3, 3
    lo = np.full((T, P, F), -np.inf, np.float32)
    hi = np.full((T, P, F), np.inf, np.float32)
    cls_oh = np.zeros((T, P, K), np.float32)
    cls_oh[:, :, 0] = 1.0
    model = vote.prepare_vote_model(
        lo, hi, np.zeros((T, P, F), bool), np.ones((T, P, F, C), bool),
        np.zeros((T, P, F), bool), cls_oh, np.ones(T, np.float32), "cpu")
    vals = torch.from_numpy(rng.random((5, F)).astype(np.float32))
    codes = torch.zeros((5, F), dtype=torch.int32)
    before = vote.launches
    with pytest.raises(ValueError, match="not prepared for a CUDA device"):
        vote._launch(vals, codes, model, 1.0)             # the kernel path
    assert vote.launches == before
    assert vote.ensemble_vote(vals, codes, model, 1.0).tolist() == [0] * 5


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        runtime.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        runtime.resolve_device(None)                  # the default is cuda
    runtime.set_default_device("cpu")
    try:
        assert runtime.resolve_device(None) == torch.device("cpu")
    finally:
        runtime.set_default_device(None)
    assert runtime.default_device() == "cuda"
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_platform_names():
    assert runtime.platform_device("cpu") == "cpu"
    assert runtime.platform_device("GPU") == "cuda"
    with pytest.raises(ValueError, match="unknown platform"):
        runtime.platform_device("tpu")


def test_runtime_disables_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
