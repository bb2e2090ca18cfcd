"""B2's share of its roofline: the least time the window's votes need
(``work/b2.py``, from the shapes alone) over the device time of the
kernels launched inside the benchmark's span around the scoring path's
``ensemble_vote`` calls."""

from portbench.work import peaks


def read(run):
    return run.roofline_pct("vote", run.loop.b2_seconds(run.calls))


def yardstick(run):
    return (f"bound from {peaks.HBM_BYTES_PER_S:g} B/s and "
            f"{peaks.SCALAR_OPS_PER_S:g} compares/s (published, "
            f"{peaks.POWER_W:g} W)")
