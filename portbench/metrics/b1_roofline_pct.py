"""B1's share of its roofline: the least time the window's level
histograms need (``work/b1.py``, from the shapes alone) over the device
time of the kernels launched inside the builders' ``b1`` layer."""

from portbench.work import peaks


def read(run):
    return run.roofline_pct("b1", run.loop.b1_seconds(run.calls))


def yardstick(run):
    return (f"bound from {peaks.HBM_BYTES_PER_S:g} B/s and "
            f"{peaks.SCALAR_OPS_PER_S:g} adds/s (published, "
            f"{peaks.POWER_W:g} W)")
