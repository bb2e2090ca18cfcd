"""Retry with backoff for transient host faults (trimmed copy of
``avenir_tpu/core/faults.py``: the port has no fault-injection points yet).

:func:`with_retry` retries a callable on transient ``OSError`` /
``MemoryError`` — artifact writes (core/artifacts) and served batches
(serving/service) — as the reference's Hadoop substrate retries a task.
"""

from __future__ import annotations

import os
import random
import threading
import time
import warnings
from typing import Callable

RETRY_ATTEMPTS = 3
RETRY_BASE_S = 0.05

# transient by default: an IO hiccup or an allocation spike should be
# re-attempted before the job gives up
TRANSIENT = (OSError, MemoryError)

# full-jitter backoff RNG, one stream per process, seeded from the pid so
# processes that fail together do not retry in lockstep
_JITTER_RNG = random.Random(os.getpid())
_JITTER_LOCK = threading.Lock()


def with_retry(fn: Callable, *, what: str = "operation"):
    """Call ``fn()``; on a transient exception retry up to
    ``RETRY_ATTEMPTS`` total tries with full-jitter exponential backoff:
    attempt i sleeps a uniform draw from (0, RETRY_BASE_S * 2**i], floored
    at a hundredth of that ceiling.  Anything else propagates immediately.
    The final failure re-raises the last exception unchanged."""
    for i in range(RETRY_ATTEMPTS):
        try:
            return fn()
        except TRANSIENT as exc:
            if i + 1 == RETRY_ATTEMPTS:
                raise
            with _JITTER_LOCK:
                u = _JITTER_RNG.random()
            delay = RETRY_BASE_S * (1 << i) * max(u, 0.01)
            warnings.warn(
                f"{what} failed ({type(exc).__name__}: {exc}); "
                f"retry {i + 1}/{RETRY_ATTEMPTS - 1} after "
                f"{delay:.3g}s", RuntimeWarning,
                stacklevel=2)
            time.sleep(delay)
