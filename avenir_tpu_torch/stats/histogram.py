"""Host-side histogram utility: the port's copy of
``avenir_tpu/stats/histogram.py`` (reference python/lib/stats.py Histogram
and the chombo HistogramStat surface): fixed-width bins over
[min, min + binWidth*k], with normalize / cumulative distribution /
percentile / density lookup.  float64 numpy, as the reference has it; the
monitor baseline reads its percentiles and the samplers
(``stats/samplers.py``) its bins."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class Histogram:
    def __init__(self, xmin: float, bin_width: float, bins: np.ndarray):
        self.xmin = float(xmin)
        self.bin_width = float(bin_width)
        self.bins = np.asarray(bins, dtype=np.float64)
        self.normalized = False

    # ---- constructors (stats.py:18,33) ----
    @classmethod
    def create_initialized(cls, xmin: float, bin_width: float,
                           values: Sequence[float]) -> "Histogram":
        return cls(xmin, bin_width, np.asarray(values, dtype=np.float64))

    @classmethod
    def create_uninitialized(cls, xmin: float, xmax: float,
                             bin_width: float) -> "Histogram":
        n = int((xmax - xmin) / bin_width) + 1
        return cls(xmin, bin_width, np.zeros((n,), dtype=np.float64))

    @property
    def xmax(self) -> float:
        return self.xmin + self.bin_width * (len(self.bins) - 1)

    # ---- accumulation (stats.py:44) ----
    def add(self, value: float) -> None:
        self.add_many([value])

    def add_many(self, values: Sequence[float]) -> None:
        idx = ((np.asarray(values, dtype=np.float64) - self.xmin)
               / self.bin_width).astype(np.int64)
        idx = np.clip(idx, 0, len(self.bins) - 1)
        np.add.at(self.bins, idx, 1.0)

    # ---- distribution views (stats.py:52-87) ----
    def normalize(self) -> None:
        total = self.bins.sum()
        if total > 0:
            self.bins = self.bins / total
        self.normalized = True

    def cum_distr(self) -> np.ndarray:
        c = np.cumsum(self.bins)
        return c / c[-1] if c[-1] > 0 else c

    def percentile(self, percent: float) -> float:
        """Smallest bin upper edge whose cumulative share >= percent/100.

        ``percent`` clamps into [0, 100]; an EMPTY histogram (no mass at
        all) returns ``xmin`` — there is no distribution to locate a
        quantile in, and raising would turn a quiet stream into a
        crashed monitor.  The result is always a bin UPPER edge, so with
        all mass in the last bin it is ``xmin + bin_width*len(bins)`` —
        up to one bin width past ``xmax``, because ``xmax`` is the last
        bin's LEFT edge (create_uninitialized's bins-cover-[min, max]
        convention).  Callers whose bins tile the range exactly (e.g.
        monitor baselines) get exact range-top quantiles; do NOT clamp
        to xmax here — that would under-report every top-bin quantile
        by a full bin width for them.  Works on unnormalized bins
        (cum_distr normalizes internally)."""
        cum = self.cum_distr()
        if cum[-1] <= 0.0:
            return self.xmin
        percent = min(max(percent, 0.0), 100.0)
        k = int(np.searchsorted(cum, percent / 100.0))
        k = min(k, len(self.bins) - 1)
        return self.xmin + self.bin_width * (k + 1)

    def value(self, x: float) -> float:
        """Content of the bin containing x: the raw COUNT before
        :meth:`normalize`, the probability share after (callers needing
        density divide by bin_width).  Out-of-range x on either side
        returns 0.0 — never a clamped edge bin (``int()`` truncates
        toward zero, so the sub-xmin guard is explicit)."""
        if x < self.xmin:
            return 0.0
        k = int((x - self.xmin) / self.bin_width)
        if k >= len(self.bins):
            return 0.0
        return float(self.bins[k])

    def cum_value(self, x: float) -> float:
        """Cumulative share at x (always normalized, whether or not
        :meth:`normalize` ran — cum_distr divides by the total).  Below
        xmin: 0.0; at/above the top edge: the full share (1.0, or 0.0
        for an empty histogram — an empty cumulative is 0 everywhere,
        not NaN)."""
        if x < self.xmin:
            return 0.0
        k = min(int((x - self.xmin) / self.bin_width), len(self.bins) - 1)
        return float(self.cum_distr()[k])

    def get_min_max(self) -> Tuple[float, float]:
        return self.xmin, self.xmax

    def bounded_value(self, x: float) -> float:
        return min(max(x, self.xmin), self.xmax)
