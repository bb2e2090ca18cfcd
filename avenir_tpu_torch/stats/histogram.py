"""Host-side histogram utility: the port's copy of
``avenir_tpu/stats/histogram.py`` (reference python/lib/stats.py Histogram),
trimmed to what the monitor baseline reads: fixed-width bins over
[min, min + binWidth*k], their cumulative distribution and percentiles.
float64 numpy, as the reference has it.  The accumulation, normalisation
and density lookups come with the samplers that use them
(``stats/samplers.py``)."""

from __future__ import annotations

import numpy as np


class Histogram:
    def __init__(self, xmin: float, bin_width: float, bins: np.ndarray):
        self.xmin = float(xmin)
        self.bin_width = float(bin_width)
        self.bins = np.asarray(bins, dtype=np.float64)

    def cum_distr(self) -> np.ndarray:
        c = np.cumsum(self.bins)
        return c / c[-1] if c[-1] > 0 else c

    def percentile(self, percent: float) -> float:
        """Smallest bin upper edge whose cumulative share >= percent/100.

        ``percent`` clamps into [0, 100]; an empty histogram (no mass)
        returns ``xmin``.  The result is always a bin UPPER edge, so with
        all mass in the last bin it is ``xmin + bin_width*len(bins)``.
        Works on unnormalized bins (cum_distr normalizes internally)."""
        cum = self.cum_distr()
        if cum[-1] <= 0.0:
            return self.xmin
        percent = min(max(percent, 0.0), 100.0)
        k = int(np.searchsorted(cum, percent / 100.0))
        k = min(k, len(self.bins) - 1)
        return self.xmin + self.bin_width * (k + 1)
