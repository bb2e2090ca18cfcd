"""B2, the forest's vote: the least work one scoring call needs, from the
problem's shapes alone.

Inputs, each read once: every row's F feature values at the narrowest
width the schema's range needs, and each tree's table (per path and
feature a lower and an upper float32 bound, and the path's class byte).
Output: one class byte per row.  Operations: a walk of each tree per row,
one compare a level."""

from __future__ import annotations

from .peaks import bound


def call(n: int, T: int, paths: int, depth: int,
         feature_bytes: int, F: int) -> dict:
    nbytes = n * feature_bytes + T * paths * (F * 8 + 1) + n
    return bound(nbytes, float(n) * T * depth)
