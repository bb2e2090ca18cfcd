"""The port's ``AllReducer`` (``parallel/collectives.py``): the local
transport's identity with its ledger count, the file transport in threads
(sum, allgather order, a reused directory holding an earlier run's
payloads, a dead peer failing within a 2 s deadline with a stall warning
that names it), the JAX package's file transport summing the same
partials, and the ``torch`` transport in two gloo subprocesses joined
through a ``file://`` rendezvous (int64 sums past 2^31, the allgather's
order, the counters' sum)."""

import json
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from avenir_tpu.parallel.collectives import AllReducer as JaxAllReducer
from avenir_tpu.parallel.distributed import ShardSpec as JaxShardSpec
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.parallel.collectives import AllReducer
from avenir_tpu_torch.parallel.distributed import ShardSpec
from avenir_tpu_torch.utils.tracing import transfer_ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _threads(fn, n, timeout=60):
    """Run ``fn(i)`` for i < n in threads; return {i: result}, raising the
    first thread's exception."""
    out, errs = {}, {}

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as exc:   # re-raised below, on the test's thread
            errs[i] = exc
    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a shard hung"
    if errs:
        raise next(iter(errs.values()))
    return out


def test_local_transport_is_the_identity_and_counted():
    red = AllReducer(spec=ShardSpec(0, 1), name="one")
    assert red.transport == "local"
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    with transfer_ledger() as led:
        assert red.sum(x) is not None
        np.testing.assert_array_equal(red.sum(x), x)
        assert red.allgather({"a": 1}) == [{"a": 1}]
    assert (led.allreduces, led.allreduce_bytes) == (3, 2 * x.nbytes)
    c = Counters()
    led.export(c)
    assert c.as_dict()["Collectives"] == {"AllReduceBytes": 2 * x.nbytes,
                                          "AllReduces": 3}


def test_more_than_one_shard_needs_a_transport(monkeypatch):
    monkeypatch.delenv("AVENIR_TPU_ALLREDUCE_DIR", raising=False)
    with pytest.raises(ValueError, match="never combine"):
        AllReducer(spec=ShardSpec(0, 2))


@pytest.mark.parametrize("P", [2, 3])
def test_file_transport_sums_and_gathers_in_shard_order(tmp_path, P):
    rdir = str(tmp_path / "r")
    big = np.int64(2 ** 31 - 3)

    def shard(i):
        red = AllReducer(spec=ShardSpec(i, P), name="t", transport_dir=rdir,
                         timeout_s=30)
        assert red.transport == "file"
        s = red.sum(np.array([i + 1, big], dtype=np.int64))
        g = red.allgather(("shard", i))
        f = red.sum(np.full((2, 2), 0.5 * (i + 1), dtype=np.float32))
        return s, g, f

    got = _threads(shard, P)
    for i in range(P):
        s, g, f = got[i]
        np.testing.assert_array_equal(
            s, [P * (P + 1) // 2, P * int(big)])    # int64, past 2^31
        assert s.dtype == np.int64
        assert g == [("shard", j) for j in range(P)]
        np.testing.assert_array_equal(f, np.full((2, 2),
                                                 0.5 * P * (P + 1) / 2))


def test_file_transport_equals_the_reference(tmp_path):
    """The same partials through both packages' file transports."""
    rng = np.random.default_rng(5)
    parts = [rng.integers(0, 1000, (4, 3, 2)).astype(np.int32)
             for _ in range(3)]

    def port(i):
        return AllReducer(spec=ShardSpec(i, 3), name="p",
                          transport_dir=str(tmp_path / "p"),
                          timeout_s=30).sum(parts[i])

    def ref(i):
        return JaxAllReducer(spec=JaxShardSpec(i, 3), name="j",
                             transport_dir=str(tmp_path / "j"),
                             timeout_s=30).sum(parts[i])

    got, want = _threads(port, 3), _threads(ref, 3)
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], sum(parts))


def test_reused_dir_ignores_stale_payloads(tmp_path):
    """A directory reused across sequential runs must not serve run 1's
    leftover step files as run 2's partials: run 2 starts with one shard
    late, past the point where an unguarded reader would have taken the
    stale payload."""
    rdir = str(tmp_path / "r")

    def run(values, delay_shard1=0.0):
        def shard(i):
            if i == 1 and delay_shard1:
                time.sleep(delay_shard1)
            red = AllReducer(spec=ShardSpec(i, 2), name="reuse",
                             transport_dir=rdir, timeout_s=30)
            return red.sum(np.array(values[i], dtype=np.int64))
        return _threads(shard, 2)

    first = run({0: [1, 2], 1: [10, 20]})
    np.testing.assert_array_equal(first[0], [11, 22])
    assert any("-000000.1." in f for f in os.listdir(rdir))   # leftovers
    second = run({0: [3, 4], 1: [30, 40]}, delay_shard1=1.0)
    for i in range(2):
        np.testing.assert_array_equal(second[i], [33, 44])


def test_rolling_reap_keeps_the_directory_small(tmp_path):
    rdir = str(tmp_path / "r")

    def shard(i):
        red = AllReducer(spec=ShardSpec(i, 2), name="reap",
                         transport_dir=rdir, timeout_s=30)
        for step in range(10):
            red.sum(np.array([step], dtype=np.int32))
        return red._step

    assert _threads(shard, 2) == {0: 10, 1: 10}
    steps = [f for f in os.listdir(rdir) if "hello" not in f]
    assert len(steps) <= 2 * 2, steps     # each shard's last two steps


def test_dead_peer_fails_the_step_within_the_deadline(tmp_path):
    """Shard 1 never arrives: shard 0 warns, naming it, at each heartbeat
    and fails its step once the 2 s deadline has passed."""
    red = AllReducer(spec=ShardSpec(0, 2), name="dead",
                     transport_dir=str(tmp_path / "r"), timeout_s=2.0,
                     heartbeat_s=0.5)
    t0 = time.monotonic()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="within 2.0s"):
            red.sum(np.zeros(3, np.int64))
    waited = time.monotonic() - t0
    assert 2.0 <= waited < 10.0, waited
    stalls = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)]
    assert stalls and all("shard(s) [1]" in m for m in stalls), stalls


def test_peer_dying_after_the_handshake_fails_the_exchange(tmp_path):
    """Both shards finish one step; shard 1 then stops: shard 0's next
    step fails within its deadline, naming the missing shard's file."""
    rdir = str(tmp_path / "r")
    reds = [AllReducer(spec=ShardSpec(i, 2), name="mid", transport_dir=rdir,
                       timeout_s=2.0, heartbeat_s=0) for i in range(2)]
    _threads(lambda i: reds[i].sum(np.ones(2, np.int32)), 2)
    with pytest.raises(RuntimeError, match=r"step 1: shard 1 never produced"):
        reds[0].sum(np.ones(2, np.int32))


_WORKER = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[3])
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.parallel import distributed as D
from avenir_tpu_torch.parallel.collectives import AllReducer
from avenir_tpu_torch.utils.tracing import transfer_ledger
rank = int(sys.argv[1])
assert D.initialize(init_method=sys.argv[2], world_size=2, rank=rank)
assert D.is_multiprocess() and D.process_index() == rank
assert D.shard_spec() == D.ShardSpec(rank, 2)
red = AllReducer(name="gloo")
with transfer_ledger() as led:
    s64 = red.sum(np.array([2 ** 31 - 1, rank], dtype=np.int64))
    s32 = red.sum(np.full((2, 3), rank + 1, dtype=np.int32))
    f = red.sum(np.array([0.25 * (rank + 1)], dtype=np.float64))
    g = red.allgather({"rank": rank, "payload": list(range(rank + 1))})
c = Counters()
c.increment("G", "Both", 5)
c.increment("G", f"Only{rank}", rank + 1)
D.all_reduce_counters(c)
print(json.dumps({"transport": red.transport, "s64": s64.tolist(),
                  "s64_dtype": str(s64.dtype), "s32": s32.tolist(),
                  "s32_dtype": str(s32.dtype), "f": f.tolist(),
                  "g": g, "allreduces": led.allreduces,
                  "work": D.work_slice(7), "counters": c.as_dict()["G"]}))
D.leave()
"""


def test_torch_transport_in_two_gloo_processes(tmp_path):
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("AVENIR_TPU_SHARD", "AVENIR_TPU_ALLREDUCE_DIR",
                        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["AVENIR_TPU_ALLREDUCE_TIMEOUT_S"] = "60"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), init,
                               ROOT], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            assert p.returncode == 0, se[-3000:]
            outs.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, o in enumerate(outs):
        assert o["transport"] == "torch"
        assert o["s64"] == [2 * (2 ** 31 - 1), 1] and o["s64_dtype"] == "int64"
        assert o["s32"] == [[3] * 3] * 2 and o["s32_dtype"] == "int32"
        assert o["f"] == [0.75]
        assert o["g"] == [{"rank": 0, "payload": [0]},
                          {"rank": 1, "payload": [0, 1]}]
        assert o["allreduces"] == 4
        assert o["work"] == [[0, 3], [3, 7]][rank]
        assert o["counters"] == {"Both": 10, "Only0": 1, "Only1": 2}
