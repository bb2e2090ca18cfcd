"""Host milliseconds a forest build spends drawing its bootstrap weights
(numpy: the per-tree draws, their placement on the device layout's rows,
the stack): the builders' ``bootstrap.draw`` layer inside
``weights_h2d``, through the benchmark's spans passed to ``build_forest``
as its ``profile=``.  None where the program has no such layer."""


def read(run):
    return run.span_ms_per_call("bootstrap.draw")
