"""Call-centre records in ``call_hangup.json``'s schema, drawn vectorised
from the model of ``resource/gen/call_hangup_gen.py``: the issue mix, an
exponential queue time (mean 420 s, clipped to [0, 1800] and truncated to
whole seconds), Poisson transfers (0.7, at most 4) and prior calls (1.0, at
most 9), and a hang-up drawn from a steep logistic of the caller's
annoyance.  The upstream generator draws row by row in Python; this copy
draws each column in one call, so a million rows take a fraction of a
second.  The streams differ from the upstream's, the model is the same
(``tests/test_portbench_gen.py``)."""

from __future__ import annotations

import numpy as np

ISSUES = ("billing", "outage", "upgrade", "other")
ISSUE_P = (0.35, 0.2, 0.25, 0.2)
PATIENCE = (500.0, 900.0, 420.0, 380.0)
CLASSES = ("F", "T")


def columns(rng: np.random.Generator, n: int) -> dict:
    """``n`` rows as int64 columns keyed by field name: ``issueType`` and
    ``hungUp`` as codes into :data:`ISSUES` and :data:`CLASSES`."""
    issue = rng.choice(len(ISSUES), n, p=ISSUE_P)
    queue = np.clip(rng.exponential(420.0, n), 0, 1800).astype(np.int64)
    transfers = np.clip(rng.poisson(0.7, n), 0, 4).astype(np.int64)
    prior = np.clip(rng.poisson(1.0, n), 0, 9).astype(np.int64)
    annoyance = queue / np.asarray(PATIENCE)[issue] + 0.5 * transfers \
        + 0.3 * prior
    p_hang = 1.0 / (1.0 + np.exp(-3.5 * (annoyance - 1.1)))
    hung = (rng.random(n) < p_hang).astype(np.int64)
    return {"issueType": issue.astype(np.int64), "queueTimeSec": queue,
            "transferCount": transfers, "priorCalls": prior,
            "hungUp": hung}


def csv_lines(cols: dict, start: int = 0) -> list:
    """The rows as the upstream generator prints them
    (``K<7-digit id>,issue,queue,transfers,prior,F|T``), ids from
    ``start``."""
    n = len(cols["queueTimeSec"])
    issue = np.asarray(ISSUES)[cols["issueType"]]
    hung = np.asarray(CLASSES)[cols["hungUp"]]
    return [f"K{i:07d},{a},{b},{c},{d},{e}" for i, a, b, c, d, e in zip(
        range(start, start + n), issue.tolist(),
        cols["queueTimeSec"].tolist(), cols["transferCount"].tolist(),
        cols["priorCalls"].tolist(), hung.tolist())]
