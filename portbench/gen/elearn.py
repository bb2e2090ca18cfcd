"""E-learning records in ``elearn.json``'s schema, drawn vectorised from the
model of ``resource/gen/elearn_gen.py``: a latent diligence ~ Beta(2.2,
2.2) behind video hours (normal, floored at 0, two decimals), quiz score
(normal, clipped to [0, 100], one decimal), forum posts (Poisson, at most
49), assignments done (binomial of 20) and a pass drawn from a logistic of
quiz and assignments.  Values carry the upstream's printed precision, so
a table built from these columns equals one parsed from its CSV."""

from __future__ import annotations

import numpy as np

CLASSES = ("fail", "pass")
FEATURES = ("videoHours", "quizScore", "forumPosts", "assignmentsDone")


def columns(rng: np.random.Generator, n: int) -> dict:
    """``n`` rows as float64 feature columns keyed by field name, and
    ``outcome`` as int64 codes into :data:`CLASSES`."""
    dil = rng.beta(2.2, 2.2, n)
    video = np.round(np.maximum(0.0, rng.normal(18 * dil, 3.0)), 2)
    quiz = np.round(np.clip(rng.normal(35 + 60 * dil, 8.0), 0, 100), 1)
    posts = np.clip(rng.poisson(8 * dil), 0, 49).astype(np.float64)
    assign = np.clip(rng.binomial(20, 0.3 + 0.65 * dil), 0, 20
                     ).astype(np.float64)
    p_pass = 1.0 / (1.0 + np.exp(-(quiz / 10.0 + assign / 4.0 - 8.5)))
    passed = (rng.random(n) < p_pass).astype(np.int64)
    return {"videoHours": video, "quizScore": quiz, "forumPosts": posts,
            "assignmentsDone": assign, "outcome": passed}
