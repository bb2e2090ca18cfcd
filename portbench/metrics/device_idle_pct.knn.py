"""The share of the traced window in which no kernel, memcpy or memset ran
on the device: 100 less the union of their intervals.  One capture a
process, started within seconds of the process's first CUDA work."""


def read(run):
    return run.idle_pct()
