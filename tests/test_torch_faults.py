"""The port's retry helper (avenir_tpu_torch/core/faults.py): three tries
with backoff of at most 0.05 s and 0.1 s."""

import pytest

from avenir_tpu_torch.core.faults import with_retry


def _flaky(failures, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise exc("transient")
        return len(calls)
    return fn, calls


@pytest.mark.parametrize("exc", [OSError, MemoryError])
def test_transient_fault_is_retried(exc):
    fn, calls = _flaky(2, exc)
    with pytest.warns(RuntimeWarning, match="retry 2/2"):
        assert with_retry(fn) == 3
    assert len(calls) == 3


def test_last_fault_reraised_after_attempts():
    fn, calls = _flaky(5, OSError)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(OSError, match="transient"):
            with_retry(fn)
    assert len(calls) == 3


def test_other_exceptions_propagate_at_once():
    fn, calls = _flaky(1, ValueError)
    with pytest.raises(ValueError):
        with_retry(fn)
    assert len(calls) == 1
