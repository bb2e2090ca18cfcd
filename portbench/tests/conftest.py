"""Fixtures of the benchmark's own tests: small sizes for the CPU runs,
and the card, for the tests that need one."""

import pytest

# every cell at a size a CPU test run holds
SMALL = {"rafo_train_1m": {"rows": 20000},
         "knn_elearn_20k": {"train_rows": 4000, "test_rows": 300},
         "knn_elearn_400": {"train_rows": 4000, "test_rows": 100,
                            "pool_batches": 8, "compare_batches": 4},
         "rafo_score_1m": {"rows": 20000, "train_sample_rows": 5000},
         "rafo_job_1m": {"rows": 20000}}


@pytest.fixture
def card():
    """The CUDA device, or a skip when this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    return "cuda"
