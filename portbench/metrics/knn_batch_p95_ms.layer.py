"""The 95th percentile of every test batch's time in the traced window, by
the host's clock around each call: a tail of single readings of a few to
some tens of milliseconds, which the host's clock cannot time to the
end-to-end metrics' standard, so it stands here beside ``knn_rows_per_s``."""

import statistics


def read(run):
    times = getattr(run.loop, "batch_s", None)
    if not times or len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[-1] * 1e3
