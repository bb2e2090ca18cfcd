"""Host milliseconds of a ``model_predictor`` call outside its vote: the
call's span less the vote's (encode, labels and output lines)."""


def read(run):
    whole = run.span_ms_per_call("score_call")
    vote = run.span_ms_per_call("vote")
    if whole is None or vote is None:
        return None
    return whole - vote
