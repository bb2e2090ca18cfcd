"""Metrics channel: Hadoop-style counters.

The reference uses Hadoop Counters / Spark accumulators as its metrics channel
(SURVEY.md §5; bayesian/BayesianPredictor.java:170-180).  Here metrics are
plain dicts of integers accumulated host-side and rendered the same way Hadoop
prints counter groups.  A copy of ``avenir_tpu/core/metrics.py``'s
``Counters``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import threading
from collections import defaultdict
from typing import Dict, Tuple


class Counters:
    """Hadoop-counter-style metrics: (group, name) -> int.

    Updates are atomic under one internal lock: serving loops mutate
    counters from several threads while the metrics snapshot thread reads
    them mid-flight, so read-modify-write races (lost increments, a
    high-water mark going DOWN) must be impossible by construction."""

    def __init__(self):
        self._c: Dict[Tuple[str, str], int] = defaultdict(int)
        self._lock = threading.Lock()

    def increment(self, group: str, name: str, amount: int = 1) -> None:
        with self._lock:
            self._c[(group, name)] += int(amount)

    def set(self, group: str, name: str, value: int) -> None:
        with self._lock:
            self._c[(group, name)] = int(value)

    def max(self, group: str, name: str, value: int) -> int:
        """Atomically raise the counter to ``value`` if it is larger;
        returns the resulting value.  The high-water-mark update (e.g.
        Serving/MaxBatchObserved) as ONE operation — a get-then-set from
        two threads could publish the smaller of two observations."""
        with self._lock:
            key = (group, name)
            cur = self._c.get(key, 0)
            if int(value) > cur:
                cur = int(value)
                self._c[key] = cur
            return cur

    def get(self, group: str, name: str) -> int:
        return self._c.get((group, name), 0)

    def update_group(self, group: str, values: Dict[str, int]) -> None:
        """Set a whole group at once (e.g. a TransferLedger export)."""
        for name, v in values.items():
            self.set(group, name, v)

    def as_dict(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            items = sorted(self._c.items())
        out: Dict[str, Dict[str, int]] = defaultdict(dict)
        for (g, n), v in items:
            out[g][n] = v
        return dict(out)

    def render(self) -> str:
        """Render like Hadoop's end-of-job counter dump."""
        lines = []
        for g, names in self.as_dict().items():
            lines.append(f"{g}")
            for n, v in names.items():
                lines.append(f"\t{n}={v}")
        return "\n".join(lines)

    # ---- machine-readable export (stable key order) ----
    def to_json(self) -> str:
        """One compact JSON object {group: {name: value}} with groups and
        names sorted — jobs and the bench harness consume this instead of
        parsing render() text, and identical counters always serialize to
        identical bytes (diffable artifacts)."""
        return json.dumps(self.as_dict(), sort_keys=True,
                          separators=(",", ":"))
