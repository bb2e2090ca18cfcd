"""Fault tolerance: retry with backoff, and deterministic fault injection
(the port's copy of ``avenir_tpu/core/faults.py``).

  * :func:`with_retry` retries a callable on transient ``OSError`` /
    ``MemoryError`` — native CSV block reads, artifact and quarantine
    writes (core/artifacts, core/table) and served batches
    (serving/service) — as the reference's Hadoop substrate retries a
    task.
  * :class:`FaultInjector` is a spec-driven injector used by the tests
    and by operators, through the ``AVENIR_TPU_FAULTS`` env hook, to prove
    the retry / skip / resume story end to end.  Instrumented sites call
    :func:`fault_point`; with no injector installed that is one
    module-global ``is None`` check.

Fault spec grammar (comma or semicolon separated entries)::

    <op>@<index|*>=<action>[x<times>]

    chunk_read@3=raise:RuntimeError   a crash before native CSV block #3
    chunk_read@2=raise:OSError        one OSError on native block read #2
    chunk_encode@3=raise:RuntimeError a crash before Python CSV block #3
    artifact_write@0=raise:OSError    one transient write failure
    chunk_encode@*=delay:0.01x5       10 ms stall on the first 5 blocks

``index`` counts calls to the op's fault point (0-based, one count per
call, retries included); ``times`` bounds how often the spec fires
(default 1: fail once, then heal).  The port's instrumented ops are
``chunk_read`` (the native reader's block parse, retried through
:func:`with_retry`), ``chunk_encode`` (the Python reader's block parse),
``cache_read`` and ``cache_write`` (a columnar cache chunk),
``artifact_write`` (quarantine appends), ``checkpoint_save``
(``CheckpointManager.save``), the broker journal's ``journal_write``
(before every segment append and checkpoint write), ``journal_fsync``
(before every fsync) and ``journal_replay`` (replay start,
``io/qjournal``), the registry's ``registry_publish`` (the payload write
of a publish) and ``registry_sidecar`` (each sidecar file write), and
``swap_patch`` (the delta reload: the service's patch entry and every
slice of ``ForestPredictor.apply_delta``).
"""

from __future__ import annotations

import os
import random
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# exception classes an injected spec may raise (a whitelist: the spec
# string is operator input, never eval'd)
_RAISABLE = {
    "OSError": OSError,
    "IOError": OSError,
    "MemoryError": MemoryError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "TimeoutError": TimeoutError,
}


class InjectedFault(RuntimeError):
    """Default exception for ``raise:`` specs without a recognized class."""


@dataclass
class FaultSpec:
    op: str
    index: Optional[int]          # None == '*' (every call)
    action: str                   # 'raise' | 'delay'
    exc: type = InjectedFault
    delay_s: float = 0.0
    times: int = 1                # how many firings remain
    fired: int = 0

    @classmethod
    def parse(cls, entry: str) -> "FaultSpec":
        head, _, action = entry.strip().partition("=")
        op, _, idx = head.partition("@")
        if not op or not action:
            raise ValueError(f"bad fault spec {entry!r} "
                             "(want op@index=action[xN])")
        times = 1
        if "x" in action:
            base, _, n = action.rpartition("x")
            if n.isdigit():
                action, times = base, int(n)
        index = None if idx in ("", "*") else int(idx)
        kind, _, arg = action.partition(":")
        if kind == "raise":
            return cls(op=op, index=index, action="raise",
                       exc=_RAISABLE.get(arg, InjectedFault), times=times)
        if kind == "delay":
            return cls(op=op, index=index, action="delay",
                       delay_s=float(arg or 0.01), times=times)
        raise ValueError(f"bad fault action {action!r} in {entry!r} "
                         "(want raise:<Exc> or delay:<seconds>)")


class FaultInjector:
    """Deterministic spec-driven fault source.  Each op keeps a call
    counter; a spec fires when its index matches the op's current call
    number (or is '*'), at most ``times`` times.  Thread-safe: fault
    points run inside the ingest's producer threads."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = list(specs)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.log: List[Tuple[str, int, str]] = []  # (op, call, action)

    @classmethod
    def parse(cls, spec: str) -> "FaultInjector":
        entries = [e for part in spec.replace(";", ",").split(",")
                   if (e := part.strip())]
        return cls([FaultSpec.parse(e) for e in entries])

    def fire(self, op: str, index: Optional[int] = None) -> None:
        with self._lock:
            call = self._counts.get(op, 0)
            self._counts[op] = call + 1
            at = call if index is None else index
            due = []
            for s in self.specs:
                if (s.op == op and s.fired < s.times
                        and (s.index is None or s.index == at)):
                    s.fired += 1
                    due.append(s)
                    self.log.append((op, at, s.action))
        for s in due:  # act outside the lock (sleep/raise)
            if s.action == "delay":
                time.sleep(s.delay_s)
            elif s.action == "raise":
                raise s.exc(f"injected fault: {op}@{at}")


_injector: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> None:
    global _injector
    _injector = injector


def uninstall() -> None:
    install(None)


def current() -> Optional[FaultInjector]:
    return _injector


def fault_point(op: str, index: Optional[int] = None) -> None:
    """Instrumentation hook: no-op unless an injector is installed."""
    if _injector is not None:
        _injector.fire(op, index)


# env hook: AVENIR_TPU_FAULTS installs an injector at import time, so CLI
# runs can be fault-tested without code changes
if os.environ.get("AVENIR_TPU_FAULTS"):
    install(FaultInjector.parse(os.environ["AVENIR_TPU_FAULTS"]))


# --------------------------------------------------------------------------
# retry/backoff
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# deterministic corruption helper (the tests' "corrupt a record" fault)
# --------------------------------------------------------------------------

def corrupt_csv_rows(path: str, rows: Sequence[int], seed: int = 0,
                     mode: str = "garble",
                     field: Optional[int] = None) -> List[str]:
    """Corrupt the given 0-based non-blank-row indices of a CSV file in
    place, deterministically, returning the corrupted line texts (what a
    quarantine pass should capture).  ``mode``: 'garble' replaces one
    field (``field``, default last — pick a NUMERIC ordinal: unknown
    categorical values encode as -1 rather than counting as malformed)
    with a non-numeric token; 'truncate' drops fields so the row is
    short."""
    rng = random.Random(seed)
    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    targets = set(rows)
    out: List[str] = []
    corrupted: List[str] = []
    nonblank = 0
    for line in lines:
        if line.strip():
            if nonblank in targets:
                parts = line.split(",")
                if mode == "truncate" and len(parts) > 1:
                    parts = parts[:max(1, len(parts) // 2)]
                else:
                    at = len(parts) - 1 if field is None else field
                    parts[at] = f"@bad{rng.randrange(10 ** 6)}"
                line = ",".join(parts)
                corrupted.append(line)
            nonblank += 1
        out.append(line)
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return corrupted
