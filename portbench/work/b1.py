"""B1, the forest's level histogram: the least work one tree level of one
forest build needs, from the problem's shapes alone.

Inputs, each read once at the narrowest width its range needs: a node id
per (row, tree) over the level's N nodes and one "not at a node" value; a
branch code per (row, split) over B branches; a class per row over C
classes; a bootstrap count per (row, tree).  Output: the (T, N, S, B, C)
counts written once as 4-byte integers.  Operations: one add per
(row, tree, split) whose bootstrap count is not 0; a bootstrap of ``m``
draws over ``n`` rows leaves a row out of a tree with probability
``(1 - 1/n)^m``."""

from __future__ import annotations

from .peaks import bound, width_bytes


def level(n: int, T: int, N: int, S: int, B: int, C: int,
          max_count: int, rate: float) -> dict:
    weighted = n * T * (1.0 - (1.0 - 1.0 / n) ** (n * rate / 100.0))
    nbytes = n * (T * width_bytes(N + 1) + S * width_bytes(B)
                  + width_bytes(C) + T * width_bytes(max_count + 1)) \
        + T * N * S * B * C * 4
    return bound(nbytes, weighted * S)


def build(n: int, T: int, S: int, B: int, C: int, depth: int,
          max_count: int, rate: float) -> dict:
    """The ``depth`` levels of one build, level ``L`` with ``B**L``
    nodes: seconds, bytes and operations summed."""
    levels = [level(n, T, B ** L, S, B, C, max_count, rate)
              for L in range(depth)]
    return {k: sum(lv[k] for lv in levels)
            for k in ("seconds", "bytes", "ops")}
