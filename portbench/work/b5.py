"""B5, KNN's distance scan and top-k: the least work one test batch needs,
from its shapes alone (``chip_smoke.py``'s ``b5_bound``).

The test and train rows read once (Fn float32 values and Fc one-hot bytes
a row) and the (nt, k) distances and indices written once.  Operations a
pair: for euclidean, Fn fused multiply-adds of the dot product and the
numerator's add, subtract, max and add; for manhattan a subtract, an
absolute value and an add a feature and one add; an AND and a popcount per
32-bit word of one-hot bits.  The divide and the square root are not
counted: a pair that cannot enter the list needs neither."""

from __future__ import annotations

from .peaks import bound


def batch(nt: int, nr: int, Fn: int, Fc: int, k: int,
          metric: str = "euclidean") -> dict:
    words = -(-Fc // 32)
    per_pair = (Fn + 4 if metric == "euclidean" else 3 * Fn + 1) + 2 * words
    nbytes = (nt + nr) * (4 * Fn + Fc) + nt * k * 8
    return bound(nbytes, float(nt) * nr * per_pair)
