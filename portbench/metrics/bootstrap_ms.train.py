"""Host milliseconds a forest build spends drawing and uploading its
bootstrap weights: the builders' ``weights_h2d`` layer, through the
benchmark's spans passed to ``build_forest`` as its ``profile=``."""


def read(run):
    return run.span_ms_per_call("weights_h2d")
