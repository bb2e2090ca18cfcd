"""The port's sharded broker tier (``avenir_tpu_torch/io/respq.py``
``HashRing``, ``ShardedRespClient``, ``make_queue_client``) against the
JAX package's, on the CPU.

The ring places 10,000 keys as the JAX ring does for 2, 3 and 5 shards,
and dropping a shard moves only its keys.  The two packages' clients and
servers interoperate: a port ring pushing into two JAX servers, and a JAX
ring pushing into two port servers, land every key on the shard both
rings name.  The killed-shard drill: a 2-worker port fleet over 2 shards,
one shard killed mid-load, the unanswered ids re-offered — every id is
answered with the fixture's class and ``BrokerShardDown`` is counted.
"""

import os
import shutil
import time
import warnings

import pytest

from avenir_tpu.io import respq as jax_respq
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.io import respq as port_respq
from avenir_tpu_torch.serving import BatchPolicy, ModelRegistry, ServingFleet

TESTS = os.path.dirname(os.path.abspath(__file__))
FLEET9 = os.path.join(TESTS, "torch_fixtures", "fleet9")
WIRE9 = os.path.join(TESTS, "torch_fixtures", "wire9")
KEYS = [str(k) for k in range(10_000)]


def _eps(m):
    return [f"127.0.0.1:{7100 + i}" for i in range(m)]


@pytest.mark.parametrize("m", [2, 3, 5])
def test_ring_lookup_equals_the_reference(m):
    port, ref = port_respq.HashRing(_eps(m)), jax_respq.HashRing(_eps(m))
    assert [port.lookup(k) for k in KEYS] == [ref.lookup(k) for k in KEYS]
    assert port_respq._hash64("abc") == jax_respq._hash64("abc")


@pytest.mark.parametrize("m", [2, 3, 5])
def test_without_moves_only_the_dropped_shards_keys(m):
    ring = port_respq.HashRing(_eps(m))
    gone = _eps(m)[1]
    smaller = ring.without(gone)
    moved = 0
    for k in KEYS:
        before, after = ring.lookup(k), smaller.lookup(k)
        if before != gone:
            assert after == before
        else:
            assert after != gone
            moved += 1
    assert 0 < moved < len(KEYS)
    ref = jax_respq.HashRing(_eps(m)).without(gone)
    assert [smaller.lookup(k) for k in KEYS] == [ref.lookup(k) for k in KEYS]
    with pytest.raises(ValueError):
        port_respq.HashRing(_eps(2) * 2)
    with pytest.raises(RuntimeError):
        port_respq.HashRing([]).lookup("1")


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("torch", "jax"), ("jax", "torch"),
                          ("torch", "torch")])
def test_ring_routes_across_packages(client_pkg, server_pkg):
    mods = {"jax": jax_respq, "torch": port_respq}
    servers = [mods[server_pkg].RespServer().start() for _ in range(2)]
    eps = [f"127.0.0.1:{s.port}" for s in servers]
    client = mods[client_pkg].make_queue_client(
        {"redis.server.endpoints": ",".join(eps)})
    try:
        assert isinstance(client, mods[client_pkg].ShardedRespClient)
        msgs = [f"predict,{i},x,{i}" for i in range(300)]
        client.lpush_many("q", msgs)
        client.lpush_many("r", [f"{i},T" for i in range(300)])
        assert client.llen("q") == 300
        ring = jax_respq.HashRing(eps)
        for ep, srv in zip(eps, servers):
            single = port_respq.RespClient(port=srv.port)
            got = single.rpop_many("q", 1000)
            replies = single.rpop_many("r", 1000)
            single.close()
            assert got and all(ring.lookup(v.split(",")[1]) == ep
                               for v in got)
            assert {v.split(",")[1] for v in got} == \
                {v.split(",")[0] for v in replies}
        assert client.broadcast("q", "reload") == 2
        assert sorted(client.rpop_many("q", 10)) == ["reload", "reload"]
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_make_queue_client_forms():
    srv = port_respq.RespServer().start()
    try:
        one = port_respq.make_queue_client(
            {"redis.server.endpoints": [("127.0.0.1", srv.port)]})
        assert type(one) is port_respq.RespClient
        one.close()
        plain = port_respq.make_queue_client(
            {"redis.server.port": srv.port})
        assert type(plain) is port_respq.RespClient
        plain.close()
    finally:
        srv.stop()


def test_dead_shard_degrades_the_client_with_a_counter():
    servers = [port_respq.RespServer().start() for _ in range(2)]
    eps = [f"127.0.0.1:{s.port}" for s in servers]
    cnt = Counters()
    sc = port_respq.ShardedRespClient(eps, counters=cnt)
    try:
        msgs = [f"predict,{i},x" for i in range(50)]
        sc.lpush_many("q", msgs)
        servers[1].kill()
        with pytest.warns(RuntimeWarning, match="degrading to the "
                                               "surviving ring"):
            sc.lpush_many("q", msgs)
        assert cnt.get("Broker", "BrokerShardDown") == 1
        assert sc.down_endpoints == [eps[1]]
        assert sc.live_endpoints == [eps[0]]
        assert len(sc.rpop_many("q", 500)) >= len(msgs)
        assert eps[0] in sc.depths("q")
        servers[0].kill()
        with pytest.raises((ConnectionError, OSError)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sc.lpush_many("q", msgs)
        sc.close()
    finally:
        for s in servers:
            s.stop()


def _collect(cli, queue, expect_n, timeout_s=30.0, stall_s=None):
    """First reply an id, until ``expect_n``, the timeout, or no new
    reply for ``stall_s``."""
    got = {}
    deadline = time.monotonic() + timeout_s
    last = time.monotonic()
    while len(got) < expect_n and time.monotonic() < deadline:
        vs = cli.rpop_many(queue, 256)
        if not vs:
            if stall_s is not None and time.monotonic() - last > stall_s:
                break
            time.sleep(0.002)
            continue
        last = time.monotonic()
        for v in vs:
            rid, label = v.split(",", 1)
            got.setdefault(rid, label)
    return got


def test_killed_shard_mid_run_loses_no_request(tmp_path):
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    reg = tmp_path / "registry"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg)
    with open(os.path.join(WIRE9, "records.csv")) as fh:
        records = fh.read().splitlines()[:300]
    with open(os.path.join(FLEET9, "a.csv")) as fh:
        want = dict(line.split(",", 1) for line in fh.read().splitlines())
    servers = [port_respq.RespServer().start() for _ in range(2)]
    eps = [f"127.0.0.1:{s.port}" for s in servers]
    fleet = ServingFleet(ModelRegistry(str(reg)), "rafo9",
                         policy=BatchPolicy(max_batch=16, max_wait_ms=1.0),
                         n_workers=2, buckets=(8, 64),
                         config={"redis.server.endpoints": eps})
    n = 240
    msgs = {str(i): f"predict,{i},{records[i]}" for i in range(n)}
    ids = list(msgs)
    got = {}
    feeder = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet.start()
            feeder = port_respq.ShardedRespClient(eps)
            feeder.lpush_many("requestQueue", [msgs[i] for i in ids[:120]])
            deadline = time.monotonic() + 30
            while len(got) < 60 and time.monotonic() < deadline:
                got.update(_collect(feeder, "predictionQueue", 60,
                                    timeout_s=0.2))
            servers[1].kill()
            feeder.lpush_many("requestQueue", [msgs[i] for i in ids[120:]])
            got.update(_collect(feeder, "predictionQueue", n - len(got),
                                timeout_s=30.0, stall_s=1.0))
            missing = [i for i in ids if i not in got]
            if missing:
                feeder.lpush_many("requestQueue", [msgs[i] for i in missing])
                got.update(_collect(feeder, "predictionQueue", len(missing),
                                    timeout_s=30.0))
        assert sorted(got, key=int) == ids
        assert all(got[i] == want[i] for i in ids)
        merged = fleet.merged_counters()
        assert merged.get("Broker", "BrokerShardDown") >= 1 \
            or feeder.down_endpoints
    finally:
        fleet.stop(drain_s=1.0)
        if feeder is not None:
            feeder.close()
        for s in servers:
            s.stop()
        set_default_device(None)
