"""Driver-script helper surface (reference ``python/lib/support.py`` +
``python/lib/util.py``): the port's copy of ``avenir_tpu/utils/pyutil.py``
(numpy only), with the same results on the same seeds.

The reference's resource generators and python drivers share two small
helper modules: ``support.py:11-79`` (config loading, table extraction,
min-distance checks, random splits, min-max scaling) and ``util.py:9-57``
(random IDs, sublist sampling, IP/time helpers, a three-point quadratic
fit, range clamping).  This module is their equivalent for the rebuild's
``resource/`` generators and tutorials.

Differences from the reference (deliberate, documented):

- the O(n^2) Python double loops in ``find_min_distances`` /
  ``find_min_distances_between_rows`` (``support.py:32-57``) are replaced
  by the row-chunked |a|^2 + |b|^2 - 2ab GEMM expansion (peak temp one
  (chunk, n) tile, independent of feature count) — same values,
  vectorized; the between-rows variant keeps the reference's exact (and
  slightly odd) semantics: entry ``i`` is the min distance from row
  ``i`` to rows ``j > i`` only, so the result has ``n - 1`` entries and
  the last row never gets one.
- ``gen_ip_address`` draws octets from 0..255; the reference's
  ``randint(0, 256)`` (``util.py:34-37``) can emit the out-of-range
  octet 256.
- every random helper takes an optional ``numpy.random.Generator`` so
  generated fixtures are reproducible; the reference uses the global
  ``random`` module.
- ``gen_id`` keeps the reference's token table verbatim — digits appear
  TWICE (``util.py:9-10``), so digits are twice as likely as letters;
  generated IDs must stay distribution-compatible with reference
  fixtures.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np

# reference util.py:9-10 — digits listed twice on purpose (see module
# docstring); 46 tokens, uniform draw => digits twice as likely
ID_TOKENS: Tuple[str, ...] = tuple("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")


def _rng(rng: np.random.Generator | None) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


# ---------------------------------------------------------------- config

def get_configs(config_file: str) -> dict:
    """Load a .properties file into a flat dict (``support.py:11-19``).

    Delegates to the config layer's parser so quoting/continuation rules
    stay in one place; values are raw strings, like jprops returns."""
    from ..core.config import load_properties
    return load_properties(config_file).raw()


def extract_table_from_file(configs: dict, file_param: str,
                            col_indices_param: str) -> np.ndarray:
    """Select columns of a delimited numeric file (``support.py:22-28``).

    ``configs[file_param]`` names the CSV, ``configs[col_indices_param]``
    is a comma-separated column-index list."""
    data_file = configs[file_param]
    col_indices = [int(a) for a in str(configs[col_indices_param]).split(",")]
    data = np.loadtxt(data_file, delimiter=",")
    if data.ndim == 1:
        data = data[None, :]
    return data[:, col_indices]


# ------------------------------------------------------------- distances

def _min_sq_dist_chunked(x1: np.ndarray, x2: np.ndarray, chunk: int,
                         mask_upper_from: int | None = None) -> np.ndarray:
    """Row-chunked min squared distance from rows of ``x1`` to rows of
    ``x2`` via the |a|^2 + |b|^2 - 2ab expansion, so the peak temp is the
    (chunk, len(x2)) GEMM tile — independent of feature count.  With
    ``mask_upper_from`` set, chunk row ``s + i`` only considers columns
    ``j > s + i`` (the reference's upper-diagonal semantics)."""
    sq1 = (x1 * x1).sum(axis=1)
    sq2 = (x2 * x2).sum(axis=1)
    out = np.empty(len(x1), dtype=np.float64)
    for s in range(0, len(x1), chunk):
        e = min(s + chunk, len(x1))
        d2 = sq1[s:e, None] + sq2[None, :] - 2.0 * (x1[s:e] @ x2.T)
        np.maximum(d2, 0.0, out=d2)  # GEMM rounding can dip below zero
        if mask_upper_from is not None:
            rows = np.arange(s, e)[:, None]
            d2[np.arange(len(x2))[None, :] <= rows] = np.inf
        out[s:e] = d2.min(axis=1)
    return out


def find_min_distances(x1: np.ndarray, x2: np.ndarray,
                       chunk: int = 4096) -> np.ndarray:
    """Min euclidean distance from each row of ``x1`` to any row of
    ``x2`` (``support.py:32-39``), computed with the chunked GEMM
    expansion: peak temp is ``chunk * len(x2)`` floats regardless of
    feature count."""
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    return np.sqrt(_min_sq_dist_chunked(x1, x2, chunk))


def find_min_distances_between_rows(x: np.ndarray,
                                    chunk: int = 4096) -> np.ndarray:
    """Per-row min distance to LATER rows only (``support.py:43-57``):
    entry ``i`` is ``min_{j>i} dist(x[i], x[j])``, so the result has
    ``n - 1`` entries (the reference's upper-diagonal semantics,
    preserved exactly — see module docstring).  Same chunked GEMM
    expansion as :func:`find_min_distances`."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n < 2:
        return np.zeros(0, dtype=np.float64)
    d2 = _min_sq_dist_chunked(x[: n - 1], x, chunk, mask_upper_from=0)
    return np.sqrt(d2)


# ------------------------------------------------------ splits / scaling

def split_data_random(x: np.ndarray, split_size: int,
                      rng: np.random.Generator | None = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Split out a CONTIGUOUS random window of ``split_size`` rows
    (``support.py:60-72`` — the reference slices a random [lo, up) run,
    not a shuffled sample); returns (window, remainder) as copies.

    Window range mirrors the reference exactly: ``lo = randint(1,
    n - split_size) - 1`` puts lo in [0, n - split_size - 1], so the
    window can NEVER include the last row, and ``split_size == n``
    is invalid (the reference's randint(1, 0) raises there too)."""
    x = np.asarray(x)
    if not 0 < split_size < len(x):
        raise ValueError(f"split_size {split_size} out of range for "
                         f"{len(x)} rows (must leave the last row out, "
                         f"as the reference's window range does)")
    lo = int(_rng(rng).integers(0, len(x) - split_size))
    up = lo + split_size
    return x[lo:up].copy(), np.concatenate([x[:lo], x[up:]], axis=0)


def scale_min_max(arr: np.ndarray) -> np.ndarray:
    """Min-max scale to [0, 1] (``support.py:75-79``); a constant array
    (zero range) maps to zeros instead of dividing by zero."""
    arr = np.asarray(arr, dtype=np.float64)
    lo, hi = arr.min(), arr.max()
    if hi == lo:
        return np.zeros_like(arr)
    return (arr - lo) / (hi - lo)


# ------------------------------------------------------- random helpers

def select_random_from_list(items: Sequence, rng=None):
    """Uniform draw from a sequence (``util.py:19-20``)."""
    return items[int(_rng(rng).integers(0, len(items)))]


def select_random_sublist_from_list(items: Sequence, num: int,
                                    rng=None) -> List:
    """``num`` DISTINCT items, in first-drawn order, rejection-sampled
    from the RAW list exactly like ``util.py:22-31`` — duplicates weight
    the draw (['a','a','b'] selects 'a' first with probability 2/3), so
    fixtures stay distribution-compatible with reference fixtures.  The
    reference loops forever when ``num`` exceeds the unique count; here
    that is checked up front."""
    uniq = len(dict.fromkeys(items))
    if num > uniq:
        raise ValueError(f"asked for {num} distinct items from "
                         f"{uniq} unique values")
    g = _rng(rng)
    seen, out = set(), []
    while len(out) < num:
        sel = items[int(g.integers(0, len(items)))]
        if sel not in seen:
            seen.add(sel)
            out.append(sel)
    return out


def gen_id(length: int, rng=None) -> str:
    """Random ID over the reference token table (``util.py:12-16``);
    digits twice as likely as letters — see module docstring."""
    g = _rng(rng)
    return "".join(ID_TOKENS[int(i)]
                   for i in g.integers(0, len(ID_TOKENS), size=length))


def gen_ip_address(rng=None) -> str:
    """Dotted-quad with VALID octets 0..255 (reference ``util.py:33-39``
    draws 0..256 inclusive — fixed here, see module docstring)."""
    g = _rng(rng)
    return ".".join(str(int(o)) for o in g.integers(0, 256, size=4))


def cur_time_ms() -> int:
    """Epoch milliseconds (``util.py:41-42``)."""
    return int(time.time() * 1000)


# ------------------------------------------------------------- numerics

def sec_deg_poly_fit(x1: float, y1: float, x2: float, y2: float,
                     x3: float, y3: float) -> Tuple[float, float, float]:
    """Exact quadratic through three points via divided differences
    (``util.py:44-50``); returns (a, b, c) of ``a x^2 + b x + c``."""
    t = (y1 - y2) / (x1 - x2)
    a = (t - (y2 - y3) / (x2 - x3)) / (x1 - x3)
    b = t - a * (x1 + x2)
    c = y1 - a * x1 * x1 - b * x1
    return a, b, c


def range_limit(val: float, lo: float, hi: float) -> float:
    """Clamp to [lo, hi] (``util.py:52-57``)."""
    return lo if val < lo else hi if val > hi else val
