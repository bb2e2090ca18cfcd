"""The top-k merge's warp tournament (``csrc/topk.cu``
``topk_merge_warp_kernel``), held on the CPU.

On the card a lane group of G = the next power of two >= S lanes merges a
test row's S lists (two lists a lane for S > 32): lane s holds list s's
cursor, head and prefetched next entry, and each of k rounds is a
butterfly argmin over the key (order-preserving distance bits, s), with
exhausted and dead lists out of the running.  Here an emulation of exactly
that, lane by lane and round by round, equals:

* ``topk_merge_torch`` (the plain version) on synthetic lists: ties across
  lists, lists shorter than k, empty lists, live +inf heads, -0.0 beside
  +0.0, S = 1, 2, 3, 19 and 64, k = 1, 10 and 100;
* the single-device JAX ``topk_scan`` (interpret mode) over the same train
  rows, when the lists are the scans of the train rows split into
  ascending contiguous ranges (duplicated rows: ties across splits).

And the stacked (S, nt, k) entry ``topk_merge_stacked`` gives the list
entry's answer.  ``chip_smoke.py`` holds the kernel through both entries
against the plain version on the card.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.ops.pallas.topk import topk_scan as jax_topk_scan
from avenir_tpu_torch.kernels import topk

from test_torch_topk import encoded

DEAD = np.uint64(2 ** 64 - 1)


def ordered(d):
    """The kernel's order-preserving bits of float32 distances (-0 as
    +0)."""
    u = np.where(d == 0, np.float32(0), d).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)


def tournament(ds, is_, bases, k):
    """``topk_merge_warp_kernel`` for every row at once: per lane slot a
    head (d, i), the next entry and a cursor; k rounds of a butterfly min
    over the group's keys; the winner writes and advances."""
    S = len(ds)
    nt = ds[0].shape[0]
    G = 1 << max(0, (S - 1).bit_length())
    G = min(G, 32)
    slots = 2 if G == 32 else 1
    d = np.stack([x.numpy() for x in ds])            # (S, nt, k)
    i = np.stack([x.numpy() for x in is_])
    lists = np.arange(G * slots).reshape(slots, G).T  # lane -> its lists
    rows = np.arange(nt)

    def entry(s, cur):
        ok = (s < S) & (cur < k)
        sc, cc = np.minimum(s, S - 1), np.minimum(cur, k - 1)
        return (np.where(ok, d[sc, rows[:, None], cc], np.inf),
                np.where(ok, i[sc, rows[:, None], cc], -1))

    cur = np.zeros((nt, G, slots), np.int64)
    hd, hi, nd, ni = (np.zeros((nt, G, slots)) for _ in range(4))
    hi, ni = hi.astype(np.int64), ni.astype(np.int64)
    for q in range(slots):
        s = np.broadcast_to(lists[:, q], (nt, G))
        hd[..., q], hi[..., q] = entry(s, cur[..., q])
        nd[..., q], ni[..., q] = entry(s, cur[..., q] + 1)
    od = np.full((nt, k), np.inf, np.float32)
    oi = np.full((nt, k), -1, np.int32)
    for j in range(k):
        keys = np.where(hi >= 0, (ordered(hd) << np.uint64(32))
                        | lists[None].astype(np.uint64), DEAD)
        key = keys.min(axis=2)                                # (nt, G)
        o = G // 2
        while o >= 1:                                         # butterfly
            key = np.minimum(key, key[:, np.arange(G) ^ o])
            o //= 2
        best = key[:, 0]
        live = best != DEAD
        ws = (best & np.uint64(0xFFFFFFFF)).astype(np.int64)
        lane, q = ws % 32, ws // 32
        r = rows[live]
        wl, wq = lane[live], q[live]
        wd, wi = hd[r, wl, wq], hi[r, wl, wq]
        od[r, j] = wd
        oi[r, j] = np.where(np.isinf(wd), -1,
                            wi + np.asarray(bases)[ws[live]])
        # advance the winners: head = next, next = the entry after it
        cur[r, wl, wq] += 1
        hd[r, wl, wq], hi[r, wl, wq] = nd[r, wl, wq], ni[r, wl, wq]
        c = cur[r, wl, wq] + 1
        more = c < k
        nd[r, wl, wq] = np.where(more, d[ws[live], r, np.minimum(c, k - 1)],
                                 np.inf)
        ni[r, wl, wq] = np.where(more, i[ws[live], r, np.minimum(c, k - 1)],
                                 -1)
    return od, oi


def synthetic_lists(rng, S, nt, k):
    """S (nt, k) lists, each row ascending by (d, local index): lengths 0
    to k (one list always empty when S > 1), distances from a small pool
    (ties within and across lists, -0.0 beside +0.0, live +inf), dead
    (+inf, -1) tails; bases ascending."""
    pool = np.array([-0.0, 0.0, 1.0, 2.0, 2.0, 3.0, np.inf], np.float32)
    ds, is_ = [], []
    for s in range(S):
        d = np.full((nt, k), np.inf, np.float32)
        i = np.full((nt, k), -1, np.int32)
        for r in range(nt):
            n = 0 if (S > 1 and s == 1) else int(rng.integers(0, k + 1))
            vals = rng.choice(pool, n)
            idx = rng.choice(4 * k + 4, n, replace=False).astype(np.int32)
            order = np.lexsort((idx, vals))
            d[r, :n], i[r, :n] = vals[order], idx[order]
        ds.append(torch.from_numpy(d))
        is_.append(torch.from_numpy(i))
    bases = (np.arange(S) * (4 * k + 4)).tolist()
    return ds, is_, bases


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("S", [1, 2, 3, 19, 64])
def test_tournament_equals_plain_merge(S, k):
    rng = np.random.default_rng(S * 1000 + k)
    nt = 40 if k < 100 else 12
    ds, is_, bases = synthetic_lists(rng, S, nt, k)
    got_d, got_i = tournament(ds, is_, bases, k)
    want_d, want_i = topk.topk_merge_torch(ds, is_, bases, k)
    np.testing.assert_array_equal(got_d, want_d.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    # the -0.0 / +0.0 tie goes to the lower list, whose sign is kept
    np.testing.assert_array_equal(np.signbit(got_d),
                                  np.signbit(want_d.numpy()))


CASES = [  # name, metric, n_test, n_train, k, splits
    ("elearn", "euclidean", 17, 90, 10, 1),
    ("elearn", "manhattan", 17, 90, 10, 2),
    ("bench", "euclidean", 23, 101, 1, 3),
    ("allcat", "euclidean", 13, 133, 10, 19),   # all ties, splits < k rows
    ("allcat", "manhattan", 9, 130, 100, 3),
    ("bench", "manhattan", 11, 64, 10, 64),      # one row a split
]


@pytest.mark.parametrize("name,metric,n_test,n_train,k,splits", CASES,
                         ids=[f"{c[0]}-{c[1][:3]}-S{c[5]}-k{c[4]}"
                              for c in CASES])
def test_tournament_of_split_scans_equals_jax_topk_scan(name, metric, n_test,
                                                        n_train, k, splits):
    """Train rows duplicated (second half = first half), so equal pairs
    sit in different splits."""
    arrays, consts = encoded(name, metric, n_test, n_train)
    tn, toh, rn, roh = (torch.from_numpy(a) for a in arrays)
    ranges = topk.split_ranges(n_test, n_train, k, 132, splits)
    assert len(ranges) == splits
    lists = [topk.topk_scan_torch(tn, toh, rn[a:b], roh[a:b], k, metric,
                                  *consts) for a, b in ranges]
    ds, is_ = [d for d, _ in lists], [i for _, i in lists]
    got_d, got_i = tournament(ds, is_, [a for a, _ in ranges], k)
    want_d, want_i = (np.asarray(a) for a in jax_topk_scan(
        *(jnp.asarray(a) for a in arrays), k, metric, *consts,
        interpret=True))
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("S,k,step", [(1, 10, 0), (3, 10, 50), (19, 1, 7),
                                      (64, 10, 3)])
def test_stacked_entry_equals_list_entry(S, k, step):
    rng = np.random.default_rng(S + k)
    ds, is_, _ = synthetic_lists(rng, S, 25, k)
    bases = [s * step for s in range(S)]
    got = topk.topk_merge_stacked(torch.stack(ds), torch.stack(is_), step, k)
    want = topk.topk_merge(ds, is_, bases, k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    old = topk.topk_merge(ds, is_, bases, k, old=True)
    np.testing.assert_array_equal(old[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("bad", ["dims", "dtype", "k", "splits", "step"])
def test_stacked_entry_rejects_what_the_kernel_does_not_take(bad):
    d = torch.zeros((3, 4, 5), dtype=torch.float32)
    i = torch.zeros((3, 4, 5), dtype=torch.int32)
    step, k = 2, 5
    if bad == "dims":
        d, i = d[0], i[0]
    elif bad == "dtype":
        i = i.long()
    elif bad == "k":
        k = 4
    elif bad == "splits":
        d = torch.zeros((65, 4, 5), dtype=torch.float32)
        i = torch.zeros((65, 4, 5), dtype=torch.int32)
    else:
        step = -1
    with pytest.raises(ValueError, match="topk_merge_stacked"):
        topk.topk_merge_stacked(d, i, step, k)
