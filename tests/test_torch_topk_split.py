"""Kernel B5's train-axis split and tail skip, held on the CPU.

On the card ``csrc/topk.cu`` scans the train rows in the contiguous splits
``kernels/topk.py`` ``split_ranges`` plans, one list a split, and merges
the lists with the top-k merge; it skips the divide and square root for a
pair whose pre-division total is not below its list's last
(``tail_skip``).  Here:

* the plan covers [0, nr) in ascending contiguous, non-empty ranges, at
  most 64 (the merge's limit);
* the plain scan of each split (``topk_scan_torch``) merged by
  ``topk_merge_torch`` equals ``topk_scan_torch`` of the whole set and the
  JAX ``topk_scan`` in interpret mode, exactly: duplicated train rows
  (ties across splits), splits shorter than k, both metrics;
* the port's tail (``div_f32``, ``sqrt_f32``, the multiply by fscale, the
  floor) is monotone non-decreasing in the float32 total for denom > 0 and
  fscale >= 0 (a hypothesis property): the ground of the skip's
  exactness.

``chip_smoke.py`` holds the kernel itself against the plain version at
forced split counts with the skip on and off.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from avenir_tpu.ops.pallas.topk import topk_scan as jax_topk_scan
from avenir_tpu_torch.kernels import topk
from avenir_tpu_torch.ops.distance import div_f32, sqrt_f32

from test_torch_topk import encoded

PLANS = [
    # nt, nr, k, sms, splits (None: planned)
    (8192, 200_000, 10, 132, None),     # a pairwise_topk chunk
    (3616, 200_000, 10, 132, None),     # its last chunk
    (20_000, 10 ** 7, 10, 132, None),   # capped at 64
    (1, 5, 1, 132, None),
    (500, 2000, 7, 132, None),          # too few rows to split
    (513, 1000, 100, 132, 7),
    (7, 20, 10, 132, 7),                # splits shorter than k
    (7, 3, 1, 132, 7),                  # more splits asked than rows
    (7, 10, 2, 132, 4),                 # ceil(10/4) = 3: 4 ranges
    (7, 9, 2, 132, 4),                  # ceil(9/4) = 3: only 3 ranges
    (7, 1000, 2, 132, 100),             # capped at 64
]


@pytest.mark.parametrize("nt,nr,k,sms,splits", PLANS)
def test_split_ranges_cover_the_train_rows(nt, nr, k, sms, splits):
    ranges = topk.split_ranges(nt, nr, k, sms, splits)
    assert 1 <= len(ranges) <= topk.MAX_SPLITS == 64
    assert ranges[0][0] == 0 and ranges[-1][1] == nr
    step = ranges[0][1]
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c and b - a == step          # contiguous, equal steps
    assert all(b > a for a, b in ranges)         # none empty
    if splits is None and nr >= 2 * topk.MIN_SPLIT_ROWS:
        assert step >= max(topk.MIN_SPLIT_ROWS, k)
        # about WARPS_PER_SM warps of 64-row blocks an SM, when rows allow
        blocks = -(-nt // 64)
        if len(ranges) < 64 and len(ranges) < nr // topk.MIN_SPLIT_ROWS:
            assert 2 * blocks * len(ranges) >= topk.WARPS_PER_SM * sms


def split_scan(arrays, k, metric, consts, ranges):
    """The plain scan of each split, merged by the plain merge."""
    tn, toh, rn, roh = (torch.from_numpy(a) for a in arrays)
    ds, is_ = [], []
    for a, b in ranges:
        d, i = topk.topk_scan_torch(tn, toh, rn[a:b], roh[a:b], k, metric,
                                    *consts)
        ds.append(d)
        is_.append(i)
    d, i = topk.topk_merge_torch(ds, is_, [a for a, _ in ranges], k)
    return d.numpy(), i.numpy()


CASES = [(37, 101, 7, 7), (20, 45, 10, 7), (29, 300, 20, 2),
         (9, 12, 12, 5), (33, 257, 10, "plan")]


@pytest.mark.parametrize("n_test,n_train,k,splits", CASES,
                         ids=[f"t{a}r{b}k{c}s{d}" for a, b, c, d in CASES])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("name", ["elearn", "bench", "allcat"])
def test_merged_splits_equal_one_scan(monkeypatch, name, metric, n_test,
                                      n_train, k, splits):
    """Train rows duplicated (second half = first half), so equal pairs sit
    in different splits; "plan" lowers MIN_SPLIT_ROWS so the planner
    itself splits these few rows."""
    arrays, consts = encoded(name, metric, n_test, n_train)
    if splits == "plan":
        monkeypatch.setattr(topk, "MIN_SPLIT_ROWS", 16)
        splits = None
    ranges = topk.split_ranges(n_test, n_train, k, 132, splits)
    assert len(ranges) > 1
    got_d, got_i = split_scan(arrays, k, metric, consts, ranges)
    whole = topk.topk_scan_torch(*(torch.from_numpy(a) for a in arrays), k,
                                 metric, *consts)
    np.testing.assert_array_equal(got_d, whole[0].numpy())
    np.testing.assert_array_equal(got_i, whole[1].numpy())
    pal_d, pal_i = (np.asarray(a) for a in jax_topk_scan(
        *(jnp.asarray(a) for a in arrays), k, metric, *consts,
        interpret=True))
    np.testing.assert_array_equal(got_d, pal_d)
    np.testing.assert_array_equal(got_i, pal_i)
    # on CPU tensors the forcing keywords leave the plain version's answer
    wrap = topk.topk_scan(*(torch.from_numpy(a) for a in arrays), k, metric,
                          *consts, splits=len(ranges), skip=False)
    np.testing.assert_array_equal(wrap[0].numpy(), got_d)


@pytest.mark.parametrize("denom,fscale,ok", [
    (5.0, 1000.0, True), (1.0, 0.0, True), (1e-30, 1e30, True),
    (0.0, 1000.0, False), (-1.0, 1.0, False), (2.0, -1.0, False),
    (math.nan, 1.0, False), (1.0, math.nan, False)])
def test_tail_skip_only_where_the_tail_is_monotone(denom, fscale, ok):
    assert topk.tail_skip(denom, fscale) is ok


def tail(total, metric, denom, fscale):
    """The port's float32 tail of a pre-division total (ops/distance.py)."""
    mean = div_f32(total, denom)
    if metric == "euclidean":
        mean = sqrt_f32(torch.clamp_min(mean, 0.0))
    return torch.floor(mean * torch.tensor(fscale, dtype=torch.float32))


f32 = st.floats(width=32, allow_nan=False)


@settings(max_examples=400, deadline=None)
@given(a=f32, b=f32,
       denom=st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100, width=32),
       fscale=st.floats(min_value=0.0, max_value=2.0 ** 100, width=32),
       metric=st.sampled_from(["euclidean", "manhattan"]))
def test_tail_is_monotone_in_the_total(a, b, denom, fscale, metric):
    """total_a <= total_b  =>  tail(total_b) is not below tail(total_a):
    a pair whose total is >= the last slot's cannot enter the list (its
    distance is not strictly below the last slot's).  A NaN distance (inf
    times 0) enters no list either way."""
    lo, hi = sorted((a, b))
    t = torch.tensor([lo, hi], dtype=torch.float32)
    d_lo, d_hi = tail(t, metric, denom, fscale).tolist()
    assert not d_hi < d_lo
