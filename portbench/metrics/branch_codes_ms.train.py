"""Host milliseconds a forest build spends computing its branch codes
(the feature matrix, its upload and the (rows, splits) codes on the
device), which every build makes anew: the builders' ``branch_codes``
layer, through the benchmark's spans passed to ``build_forest`` as its
``profile=``."""


def read(run):
    return run.span_ms_per_call("branch_codes")
