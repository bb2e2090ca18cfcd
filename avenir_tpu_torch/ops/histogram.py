"""Counting primitives: the port of ``avenir_tpu/ops/histogram.py``.

Almost every reducer of the reference sums ones (or moments) per composite
key.  Here that sum is a ``torch.bincount`` over the flattened key, with
every invalid cell (an out-of-range code or a masked row) sent to one
extra trash bin that is dropped: the only intermediate is the (n, F)
int64 key matrix, and the counts are exact integers on any device, then
cast to ``dtype`` (float32 by default, as in the JAX package, exact below
2^24 a cell).  ``class_moments`` keeps the one-hot contraction (its values
are real moments), and ``_class_bin_histogram_onehot`` keeps the one-hot
form of the counts as the oracle of the scatter.

All functions take a ``mask`` so padded rows contribute nothing, and run
on the tensors' device.  ``entropy`` and ``gini`` reproduce the JAX
package's float32 arithmetic on the CPU (XLA's log, the reciprocal of the
folded ``log(2)``, sums left to right over the last axis).  No Pallas
kernel is behind any of them: composed torch ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.xla_math import folded_log_f32, seq_row_sum, xla_log_f32


def _one_hot(codes: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a code outside [0, n) gives a zero row."""
    ar = torch.arange(n, device=codes.device)
    return (codes.long().unsqueeze(-1) == ar).to(dtype)


def _flat_count(key: torch.Tensor, valid: torch.Tensor, size: int,
                dtype) -> torch.Tensor:
    """Counts of ``key`` over [0, size) where ``valid``, in ``dtype``:
    invalid entries go to a trash bin past the end."""
    k = torch.where(valid, key, torch.full_like(key, size))
    return torch.bincount(k.reshape(-1), minlength=size + 1)[:size].to(dtype)


def class_bin_histogram(class_codes: torch.Tensor,    # (n,) int
                        bin_codes: torch.Tensor,      # (n, F) int
                        num_classes: int, num_bins: int,
                        mask: Optional[torch.Tensor] = None,
                        dtype=torch.float32) -> torch.Tensor:
    """counts[c, f, b] = #records with class c and feature f in bin b.

    Out-of-range or negative bin and class codes (unknown values) drop, as
    does every row with ``mask`` False."""
    n, F = bin_codes.shape
    cc = class_codes.long()
    bc = bin_codes.long()
    valid = (bc >= 0) & (bc < num_bins) \
        & ((cc >= 0) & (cc < num_classes))[:, None]
    if mask is not None:
        valid = valid & mask.bool()[:, None]
    c = cc.clamp(0, num_classes - 1)
    b = bc.clamp(0, num_bins - 1)
    f = torch.arange(F, device=bc.device)[None, :]
    key = (c[:, None] * F + f) * num_bins + b                  # (n, F)
    return _flat_count(key, valid, num_classes * F * num_bins,
                       dtype).reshape(num_classes, F, num_bins)


def _class_bin_histogram_onehot(class_codes, bin_codes, num_classes,
                                num_bins, mask=None, dtype=torch.float32):
    """The one-hot contraction form, the scatter's oracle.  Same drop
    semantics."""
    bc = bin_codes.long()
    valid = (bc >= 0) & (bc < num_bins)
    if mask is not None:
        valid = valid & mask.bool()[:, None]
    oh_c = _one_hot(class_codes, num_classes, dtype)              # (n, C)
    oh_b = _one_hot(bc, num_bins, dtype) * valid.to(dtype)[:, :, None]
    return torch.einsum("nc,nfb->cfb", oh_c, oh_b)


def class_bin_histogram_chunked(class_codes, bin_codes, num_classes,
                                num_bins, mask=None, chunk: int = 1 << 18,
                                dtype=torch.float32) -> torch.Tensor:
    """:func:`class_bin_histogram` over row chunks of ``chunk`` rows,
    accumulated in ``dtype`` as the JAX package's scan does."""
    n, F = bin_codes.shape
    acc = torch.zeros((num_classes, F, num_bins), dtype=dtype,
                      device=bin_codes.device)
    for s in range(0, n, chunk):
        m = None if mask is None else mask[s:s + chunk]
        acc = acc + class_bin_histogram(class_codes[s:s + chunk],
                                        bin_codes[s:s + chunk], num_classes,
                                        num_bins, m, dtype)
    return acc


def feature_bin_counts(bin_codes: torch.Tensor, num_bins: int,
                       mask: Optional[torch.Tensor] = None,
                       dtype=torch.float32) -> torch.Tensor:
    """counts[f, b] = #records with feature f in bin b: the classless
    marginal of :func:`class_bin_histogram`."""
    zeros = torch.zeros((bin_codes.shape[0],), dtype=torch.int64,
                        device=bin_codes.device)
    return class_bin_histogram(zeros, bin_codes, 1, num_bins, mask,
                               dtype)[0]


def class_moments(class_codes: torch.Tensor,   # (n,)
                  values: torch.Tensor,        # (n, F)
                  num_classes: int,
                  mask: Optional[torch.Tensor] = None,
                  dtype=torch.float32) -> torch.Tensor:
    """moments[c, f, :] = (count, sum x, sum x^2) per class, as the one-hot
    contraction in ``dtype``.  In float32 the sum's order is the BLAS
    library's, so large sums differ from the JAX package's in the last
    bits; in float64 integer moments are exact (to 2^53) in any order."""
    oh_c = _one_hot(class_codes, num_classes, dtype)             # (n, C)
    if mask is not None:
        oh_c = oh_c * mask.to(dtype)[:, None]
    v = values.to(dtype)
    stacked = torch.stack([torch.ones_like(v), v, v * v], dim=-1)  # (n,F,3)
    return torch.einsum("nc,nfm->cfm", oh_c, stacked)


def joint_histogram(a_codes: torch.Tensor, b_codes: torch.Tensor,
                    num_a: int, num_b: int,
                    mask: Optional[torch.Tensor] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """counts[a, b]: the joint histogram of two code columns (contingency
    matrix, mutual-information pair distributions)."""
    a, b = a_codes.long(), b_codes.long()
    valid = (a >= 0) & (b >= 0) & (a < num_a) & (b < num_b)
    if mask is not None:
        valid = valid & mask.bool()
    key = a.clamp(0, num_a - 1) * num_b + b.clamp(0, num_b - 1)
    return _flat_count(key, valid, num_a * num_b, dtype).reshape(num_a,
                                                                  num_b)


# float32 1 / log(2) as XLA folds ``x / log(2)``: the log of the constant
# correctly rounded, then its reciprocal
_INV_LN2 = float(np.float32(1.0) / folded_log_f32(np.float32(2.0)))


def entropy(p: torch.Tensor, axis: int = -1, eps: float = 1e-12
            ) -> torch.Tensor:
    """Shannon entropy in bits (log2, util/InfoContentStat.java) of float32
    probability vectors along ``axis``."""
    p = torch.clamp(torch.movedim(p.float(), axis, -1),
                    float(np.float32(eps)), 1.0)
    return -seq_row_sum(p * (xla_log_f32(p) * _INV_LN2))


def gini(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Gini index ``1 - sum p^2`` along ``axis``
    (util/InfoContentStat.java)."""
    p = torch.movedim(p.float(), axis, -1)
    return 1.0 - seq_row_sum(p * p)
