"""The port's process identity and split rules (``parallel/distributed.py``)
against the JAX package's: ``shard_rows`` over a grid of sizes, shard
counts and block sizes (empty shards, the tail block, validation),
``ShardSpec``, the ``AVENIR_TPU_SHARD`` override, ``work_slice``, the
single-process host collectives, and ``initialize``'s refusals of a
partial torchrun environment."""

import numpy as np
import pytest

from avenir_tpu.parallel import distributed as jdist
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.parallel import distributed as D

GRID = [(n, count, chunk)
        for n in (0, 1, 7, 10, 90, 401, 997, 5000)
        for count in (1, 2, 3, 5, 7, 9)
        for chunk in (1, 8, 64, 100, 777)]


@pytest.mark.parametrize("n,count,chunk", GRID)
def test_shard_rows_equals_the_reference(n, count, chunk):
    got = [D.shard_rows(n, i, count, chunk) for i in range(count)]
    assert got == [jdist.shard_rows(n, i, count, chunk)
                   for i in range(count)]
    # disjoint, ordered, complete; split points on the block grid
    assert got[0][0] == 0 and got[-1][1] == n
    for (lo_a, hi_a), (lo_b, hi_b) in zip(got, got[1:]):
        assert hi_a == lo_b and lo_a <= hi_a <= hi_b
    for lo, hi in got:
        assert lo % chunk == 0 and (hi == n or hi % chunk == 0)


def test_more_shards_than_blocks_leaves_empty_shards_and_the_tail():
    parts = [D.shard_rows(10, i, 5, 8) for i in range(5)]
    assert sum(h - l for l, h in parts) == 10
    assert parts[-1] == (8, 10)                 # the tail block
    assert sum(l == h for l, h in parts) == 3   # three empty shards
    # rafo9s over 2 shards at 777-row blocks: blocks 0-2 and 3-6
    assert [D.shard_rows(5000, i, 2, 777) for i in range(2)] == \
        [(0, 2331), (2331, 5000)]


@pytest.mark.parametrize("args", [(10, 2, 2), (10, -1, 2), (10, 0, 0),
                                  (-1, 0, 1), (10, 0, 2, 0)])
def test_shard_rows_validation(args):
    with pytest.raises(ValueError):
        D.shard_rows(*args)
    with pytest.raises(ValueError):
        jdist.shard_rows(*args)


def test_shard_spec():
    s = D.ShardSpec(1, 3)
    assert s.active and s.range_for(10) == D.shard_rows(10, 1, 3)
    assert s.range_for(5000, 777) == jdist.ShardSpec(1, 3).range_for(5000,
                                                                      777)
    assert not D.ShardSpec().active and D.ShardSpec().range_for(7) == (0, 7)
    for bad in ((0, 0), (3, 3), (-1, 2)):
        with pytest.raises(ValueError, match="bad shard spec"):
            D.ShardSpec(*bad)


def test_shard_spec_env_override(monkeypatch):
    monkeypatch.setenv("AVENIR_TPU_SHARD", "1/3")
    assert D.shard_spec() == D.ShardSpec(1, 3)
    assert D.local_index() == 1        # the shard lane picks its card
    monkeypatch.setenv("LOCAL_RANK", "4")
    assert D.local_index() == 4
    monkeypatch.delenv("LOCAL_RANK")
    for junk in ("junk", "1/x", "3/2"):
        monkeypatch.setenv("AVENIR_TPU_SHARD", junk)
        with pytest.raises(ValueError):
            D.shard_spec()
    monkeypatch.delenv("AVENIR_TPU_SHARD")
    assert D.shard_spec() == D.ShardSpec(0, 1)
    assert not D.shard_spec().active and D.local_index() == 0


@pytest.mark.parametrize("n", [0, 1, 7, 500])
def test_single_process_identity(n):
    assert not D.is_multiprocess()
    assert (D.process_count(), D.process_index()) == (1, 0)
    assert D.work_slice(n) == jdist.work_slice(n) == (0, n)
    assert D.allgather_object({"n": n}) == [{"n": n}]
    x = np.arange(n, dtype=np.int64)
    np.testing.assert_array_equal(D.all_reduce_host_array(x), x)
    c = Counters()
    c.increment("G", "N", n)
    assert D.all_reduce_counters(c) is c and c.get("G", "N") == n


def test_work_slice_partitions_the_items(monkeypatch):
    """The process-index arithmetic of the joined run's split, checked
    with the process identity set by hand."""
    for total in (1, 2, 3, 7):
        monkeypatch.setattr(D, "is_multiprocess", lambda: total > 1)
        monkeypatch.setattr(D, "process_count", lambda: total)
        for n in (0, 5, 500):
            parts = []
            for p in range(total):
                monkeypatch.setattr(D, "process_index", lambda p=p: p)
                parts.append(D.work_slice(n))
            assert parts[0][0] == 0 and parts[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
            assert [h - l for l, h in parts] == \
                [n * (p + 1) // total - n * p // total for p in range(total)]


ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("env,match", [
    ({"WORLD_SIZE": "2", "RANK": "0"}, "without MASTER_ADDR"),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"},
     "no process rank"),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "RANK": "0"},
     "without WORLD_SIZE"),
    ({"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "127.0.0.1"},
     "set together"),
    ({"WORLD_SIZE": "2", "RANK": "1", "MASTER_PORT": "29500"},
     "set together")])
def test_initialize_refuses_a_partial_environment(monkeypatch, env, match):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        D.initialize()
    assert not D.is_multiprocess()


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "1", "RANK": "0"},
                                 {"WORLD_SIZE": "1", "RANK": "0",
                                  "MASTER_ADDR": "127.0.0.1",
                                  "MASTER_PORT": "1"}])
def test_initialize_single_process_is_a_no_op(monkeypatch, env):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert D.initialize() is False
    assert not D.is_multiprocess()
