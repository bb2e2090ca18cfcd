"""Host milliseconds a forest build spends shipping its bootstrap weights
to the device (``weights_to_device``: the narrow wire, the upload and its
unpacking): the builders' ``bootstrap.upload`` layer inside
``weights_h2d``, through the benchmark's spans passed to ``build_forest``
as its ``profile=``.  None where the program has no such layer."""


def read(run):
    return run.span_ms_per_call("bootstrap.upload")
