"""B5's share of its roofline: the least time the window's distance scans
need (``work/b5.py``, from the shapes alone) over the device time of the
kernels launched inside the benchmark's span around
``kernels.topk.topk_scan``."""

from portbench.work import peaks


def read(run):
    return run.roofline_pct("topk", run.loop.b5_seconds(run.calls))


def yardstick(run):
    return (f"bound from {peaks.HBM_BYTES_PER_S:g} B/s and "
            f"{peaks.SCALAR_OPS_PER_S:g} ops/s (published, "
            f"{peaks.POWER_W:g} W)")
