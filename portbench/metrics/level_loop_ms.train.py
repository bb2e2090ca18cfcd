"""Host milliseconds a forest build spends in its level loop: the
builders' ``reassign``, ``b1``, ``accumulate``, ``counts_d2h`` and
``split_choice`` layers summed, each span synchronised at both ends."""

LAYERS = ("reassign", "b1", "accumulate", "counts_d2h", "split_choice")


def read(run):
    return run.span_ms_per_call(*LAYERS)
