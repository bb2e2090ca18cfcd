"""Host milliseconds a test batch spends in ``models.knn.classify_topk``:
the benchmark's span around the call."""


def read(run):
    return run.span_ms_per_call("classify")
