"""Host milliseconds a ``randomForestBuilder`` job spends in its CSV parse
and encode: the benchmark's span around the job's ``core.table.load_csv``
call."""


def read(run):
    return run.span_ms_per_call("parse")
