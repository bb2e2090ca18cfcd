"""The train-sharded top-k (kernel B7), port against the JAX package on the
CPU.

The port shards the train rows over a mesh of the CPU repeated S times:
contiguous ranges of ceil(n/S) rows, no pad rows, one plain B5 scan a
non-empty shard and one plain merge.  Its (d, i) must equal, bit for bit,
the JAX package's single-device ``topk_scan`` and (where the JAX form keeps
its own contract) its ``topk_scan_sharded`` on the conftest's 8 virtual CPU
devices, both in interpret mode.  The pad-row probe pins where the JAX form
breaks that contract (ROADMAP queue C).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avenir_tpu.ops.pallas.topk import topk_scan as jax_topk_scan
from avenir_tpu.ops.pallas.topk import (
    topk_scan_sharded as jax_topk_scan_sharded)
from avenir_tpu.parallel.mesh import make_mesh as jax_make_mesh

from avenir_tpu_torch.kernels import topk
from avenir_tpu_torch.parallel.mesh import DeviceMesh


def port_sharded(tn, toh, rn, roh, S, k, metric, n_cat, denom, fscale):
    mesh = DeviceMesh(["cpu"] * S)
    rn_t = torch.from_numpy(rn)
    roh_t = torch.from_numpy(roh.astype(np.int8))
    shards = [(rn_t[a:b], roh_t[a:b])
              for a, b in topk.shard_ranges(rn.shape[0], S)]
    d, i = topk.topk_scan_sharded(torch.from_numpy(tn),
                                  torch.from_numpy(toh.astype(np.int8)),
                                  shards, k, metric, n_cat, denom, fscale,
                                  mesh)
    return d.numpy(), i.numpy()


def jax_forms(tn, toh, rn, roh, k, metric, n_cat, denom, fscale, S=8):
    args = tuple(jnp.asarray(a.astype(np.float32)) for a in (tn, toh, rn,
                                                             roh))
    d1, i1 = jax_topk_scan(*args, k, metric, n_cat, denom, fscale,
                           interpret=True)
    d2, i2 = jax_topk_scan_sharded(*args, k, metric, n_cat, denom, fscale,
                                   jax_make_mesh(S), "data", interpret=True)
    return (np.asarray(d1), np.asarray(i1)), (np.asarray(d2), np.asarray(i2))


def dup_inputs(seed, nt, ntr, Fn, Fc):
    """test_pallas_kernels.py's sharded-parity inputs: the second half of
    the train rows repeats the first, so equal distances land in different
    shards."""
    rng = np.random.default_rng(seed)
    tn = rng.normal(size=(nt, Fn)).astype(np.float32)
    toh = (rng.random((nt, Fc)) < 0.3).astype(np.float32)
    rn = rng.normal(size=(ntr, Fn)).astype(np.float32)
    roh = (rng.random((ntr, Fc)) < 0.3).astype(np.float32)
    rn[ntr // 2:] = rn[:ntr - ntr // 2]
    roh[ntr // 2:] = roh[:ntr - ntr // 2]
    return tn, toh, rn, roh


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_sharded_matches_jax_at_its_parity_shape(metric):
    tn, toh, rn, roh = dup_inputs(42, 37, 205, 5, 7)
    consts = (9, metric, 7.0, 1.0, 1.0)
    (d1, i1), (d2, i2) = jax_forms(tn, toh, rn, roh, *consts)
    d, i = port_sharded(tn, toh, rn, roh, 8, *consts)
    np.testing.assert_array_equal(d, d1)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_array_equal(d, d2)
    np.testing.assert_array_equal(i, i2)


def test_sharded_k_exceeds_local_shards_matches_jax():
    """11 test x 13 train rows over 8 shards (2 rows a shard, the last
    one), k = 9: every shard is shorter than k."""
    rng = np.random.default_rng(42)
    tn = rng.normal(size=(11, 3)).astype(np.float32)
    rn = rng.normal(size=(13, 3)).astype(np.float32)
    toh, roh = np.zeros((11, 0), np.float32), np.zeros((13, 0), np.float32)
    consts = (9, "euclidean", 0.0, 1.0, 1.0)
    (d1, i1), (d2, i2) = jax_forms(tn, toh, rn, roh, *consts)
    d, i = port_sharded(tn, toh, rn, roh, 8, *consts)
    for want in ((d1, i1), (d2, i2)):
        np.testing.assert_array_equal(d, want[0])
        np.testing.assert_array_equal(i, want[1])


@pytest.mark.parametrize("ntr", [3, 40])
@pytest.mark.parametrize("S", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
def test_sharded_equals_single_device_scan(S, ntr, metric):
    """Any shard count, including more shards than train rows (empty
    shards), and k up to the train count: the sharded plain form equals
    the port's single-device plain scan (which tests/test_torch_topk.py
    holds to the JAX scan)."""
    tn, toh, rn, roh = dup_inputs(S * 100 + ntr, 13, ntr, 4, 5)
    for k in sorted({1, 7, ntr}):
        consts = (k, metric, 5.0, 9.0, 1000.0)
        want = topk.topk_scan_torch(
            torch.from_numpy(tn), torch.from_numpy(toh.astype(np.int8)),
            torch.from_numpy(rn), torch.from_numpy(roh.astype(np.int8)),
            *consts)
        d, i = port_sharded(tn, toh, rn, roh, S, *consts)
        np.testing.assert_array_equal(d, want[0].numpy())
        np.testing.assert_array_equal(i, want[1].numpy())


def pad_probe():
    """One test row at the origin; ten train rows at (5, 5) except row 0
    at (1, 0) and row 9 at (2, 0); no categorical columns."""
    tn = np.zeros((1, 2), np.float32)
    rn = np.full((10, 2), 5.0, np.float32)
    rn[0] = (1.0, 0.0)
    rn[9] = (2.0, 0.0)
    return tn, np.zeros((1, 0), np.float32), rn, np.zeros((10, 0), np.float32)


def test_pad_probe_port_keeps_the_single_device_answer():
    tn, toh, rn, roh = pad_probe()
    consts = (2, "euclidean", 0.0, 1.0, 1.0)
    (d1, i1), _ = jax_forms(tn, toh, rn, roh, *consts, S=4)
    np.testing.assert_array_equal(d1, [[1.0, 2.0]])
    np.testing.assert_array_equal(i1, [[0, 9]])
    d, i = port_sharded(tn, toh, rn, roh, 4, *consts)
    np.testing.assert_array_equal(d, d1)
    np.testing.assert_array_equal(i, i1)


def test_pad_probe_pins_the_reference_sharded_deviation():
    """The JAX form pads 10 train rows with 2 zero rows for 4 shards and
    masks them only after each shard's local top-k: the pad row at the
    origin (distance 0) takes a slot of the last shard's list and pushes
    row 9 out, so the merge answers row 1 (distance 7).  If the reference
    changes, this fails and ROADMAP queue C needs updating."""
    tn, toh, rn, roh = pad_probe()
    _, (d2, i2) = jax_forms(tn, toh, rn, roh, 2, "euclidean", 0.0, 1.0, 1.0,
                            S=4)
    np.testing.assert_array_equal(d2, [[1.0, 7.0]])
    np.testing.assert_array_equal(i2, [[0, 1]])


def brute_force(lists, k):
    """k smallest (d, global i) over every live entry of every shard, by a
    Python sort; (+inf, -1) past the live entries."""
    nt = lists[0][0].shape[0]
    d_out = np.full((nt, k), np.inf, np.float32)
    i_out = np.full((nt, k), -1, np.int32)
    for r in range(nt):
        pairs = sorted((float(d[r, j]), int(i[r, j]) + base)
                       for d, i, base in lists for j in range(d.shape[1])
                       if i[r, j] >= 0)[:k]
        for j, (dv, iv) in enumerate(pairs):
            d_out[r, j], i_out[r, j] = dv, iv
    return d_out, i_out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("S,k", [(1, 1), (2, 3), (3, 7), (5, 4), (8, 10)])
def test_merge_plain_matches_brute_force(seed, S, k):
    """Seeded per-shard lists (each its shard's k smallest by (d, local i),
    dead slots where a shard is shorter than k or empty), with distances
    from a small range so that ties cross shards."""
    rng = np.random.default_rng(seed * 1000 + S * 10 + k)
    nt = 9
    sizes = rng.integers(0, 2 * k + 1, S)
    lists, base = [], 0
    for n_s in sizes:
        dist = rng.integers(0, 4, (nt, n_s)).astype(np.float32)
        d = np.full((nt, k), np.inf, np.float32)
        i = np.full((nt, k), -1, np.int32)
        for r in range(nt):
            order = sorted(range(n_s), key=lambda j: (dist[r, j], j))[:k]
            d[r, :len(order)] = dist[r, order]
            i[r, :len(order)] = order
        lists.append((d, i, base))
        base += int(n_s)
    want_d, want_i = brute_force(lists, k)
    got_d, got_i = topk.topk_merge([torch.from_numpy(d) for d, _, _ in lists],
                                   [torch.from_numpy(i) for _, i, _ in lists],
                                   [b for _, _, b in lists], k)
    assert got_d.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_merge_and_shard_checks():
    d, i = torch.zeros((2, 3)), torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="one \\(d, i, base\\)"):
        topk.topk_merge([d], [i, i], [0, 3], 3)
    with pytest.raises(ValueError, match="shard 1"):
        topk.topk_merge([d, d[:, :2]], [i, i], [0, 3], 3)
    with pytest.raises(ValueError, match="ascend"):
        topk.topk_merge([d, d], [i, i], [3, 0], 3)
    mesh = DeviceMesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="2 devices"):
        topk.topk_scan_sharded(torch.zeros((1, 2)),
                               torch.zeros((1, 0), dtype=torch.int8),
                               [(torch.zeros((3, 2)),
                                 torch.zeros((3, 0), dtype=torch.int8))],
                               1, "euclidean", 0.0, 1.0, 1.0, mesh)


@pytest.mark.parametrize("n,S,want", [
    (10, 4, [(0, 3), (3, 6), (6, 9), (9, 10)]),
    (3, 5, [(0, 1), (1, 2), (2, 3), (3, 3), (3, 3)]),
    (0, 2, [(0, 0), (0, 0)]),
    (8, 1, [(0, 8)])])
def test_shard_ranges_have_no_pad_rows(n, S, want):
    assert topk.shard_ranges(n, S) == want
