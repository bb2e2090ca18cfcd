"""The port's RESP broker and client (``avenir_tpu_torch/io/respq.py``)
against the JAX package's (``avenir_tpu/io/respq.py``) on the CPU.

Held to, byte for byte: one raw command script — every verb, lease expiry
and redelivery, ACKPUSH dedup, errors — sent to each side's server gives
the same reply bytes; each side's client works against the other side's
server; the helpers (``resolve_durable``, ``_lease_rid``,
``dedup_replies``, the command codec) agree; a journaled server killed
and restarted on the same directory comes back with the same queues on
either side; a killed-mid-batch leased loop's requests are redelivered
and answered once.
"""

import io
import socket
import time
import warnings

import pytest

from avenir_tpu.io import respq as ref
from avenir_tpu_torch.io import respq as port


def _raw_session(server, script):
    """Send each command of ``script`` (lists of str, or ("sleep", s)) on
    one socket; returns the raw reply bytes of each."""
    s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    rf = s.makefile("rb")
    out = []
    try:
        for cmd in script:
            if cmd[0] == "sleep":
                time.sleep(cmd[1])
                continue
            s.sendall(port._encode_command(cmd))
            out.append(_raw_reply(rf))
    finally:
        rf.close()
        s.close()
    return out


def _raw_reply(rf):
    line = rf.readline()
    kind = line[:1]
    if kind == b"$":
        n = int(line[1:])
        return line + (rf.read(n + 2) if n >= 0 else b"")
    if kind == b"*":
        n = int(line[1:])
        return line + b"".join(_raw_reply(rf) for _ in range(max(n, 0)))
    return line


SCRIPT = [
    ["PING"],
    ["LPUSH", "q", "predict,1,a", "predict,2,b", "predict,3,c", "stop"],
    ["LLEN", "q"],
    ["INFO"],
    ["LEASE", "q", "2", "0.15", "0", ","],
    ["INFO", "q"],
    ["ACKPUSH", "out", "q", ",", "1,T"],
    ["ACKPUSH", "out", "q", ",", "1,T", "9,F"],
    ("sleep", 0.3),
    # lease of id 2 expired: redelivered before fresh traffic
    ["RPOP", "q"],
    ["RPOP", "q", "5"],
    ["RPOP", "q"],
    ["RPOP", "q", "5"],
    ["BRPOP", "q", "0.05"],
    ["LPUSH", "q2", "x"],
    ["BRPOP", "q2", "0.05"],
    ["RPOP", "out", "10"],
    ["LPUSH", "d", "1"],
    ["DEL", "d", "missing"],
    ["LLEN", "d"],
    ["NOPE"],
    ["LPUSH"],
    ["LEASE", "empty", "3", "1.0", "0.05", ","],
]


def test_the_same_script_gives_the_same_reply_bytes():
    replies = []
    for mod in (ref, port):
        server = mod.RespServer().start()
        try:
            replies.append(_raw_session(server, SCRIPT))
        finally:
            server.stop()
    assert replies[0] == replies[1]
    cmds = [c for c in SCRIPT if c[0] != "sleep"]
    got = replies[1]
    # the expired lease of id 2 is redelivered before fresh traffic
    assert got[cmds.index(["RPOP", "q"])] == b"$11\r\npredict,2,b\r\n"
    assert got[cmds.index(["NOPE"])].startswith(b"-ERR unknown command")
    assert got[cmds.index(["ACKPUSH", "out", "q", ",", "1,T", "9,F"])] \
        == b":2\r\n"


@pytest.mark.parametrize("client_mod,server_mod", [(port, ref), (ref, port)])
def test_each_client_against_the_other_server(client_mod, server_mod):
    server = server_mod.RespServer().start()
    try:
        cli = client_mod.RespClient(port=server.port)
        assert cli.ping()
        assert cli.lpush_many("q", [f"predict,{i},v" for i in range(6)]) == 6
        assert cli.lpush("q", "stop") == 7
        assert cli.llen("q") == 7 and cli.info("q") == {"q": 7}
        assert cli.rpop_many("q", 2) == ["predict,0,v", "predict,1,v"]
        assert cli.lease_many("q", 2, 30.0) == ["predict,2,v",
                                                 "predict,3,v"]
        assert cli.ackpush("out", "q", ["2,T", "3,F", "2,T"]) == 2
        assert cli.rpop("q") == "predict,4,v"
        assert cli.brpop("q", 0.05) == "predict,5,v"
        assert cli.brpop("q", 0.05) == "stop"
        assert cli.brpop("q", 0.05) is None
        assert cli.rpop_many("out", 5) == ["2,T", "3,F"]
        assert cli.delete("q", "out") == 0
        cli.close()
    finally:
        server.stop()


def test_helpers_agree():
    for v in (None, "off", "commit", "FSYNC", " commit "):
        assert port.resolve_durable(v) == ref.resolve_durable(v)
    with pytest.raises(ValueError):
        port.resolve_durable("sometimes")
    for v, d in (("predict,7,a", ","), ("predictq,8,4", ","),
                 ("reward,9,1.0", ","), ("stop", ","), ("predict", ","),
                 ("predict,,x", ","), ("predict|3|x", "|")):
        assert port._lease_rid(v, d) == ref._lease_rid(v, d)
    vals = ["1,T", "2,F", "1,F", "3,T", "2,T"]
    assert port.dedup_replies(vals) == ref.dedup_replies(vals) == \
        ({"1": "T", "2": "F", "3": "T"}, 2)
    for args in (["LPUSH", "q", "a,b", "é"], ["PING"], ["RPOP", "q", "3"]):
        wire = port._encode_command(args)
        assert wire == ref._encode_command(args)
        assert port._read_command(io.BytesIO(wire)) == args
    for raw, want in ((b"+OK\r\n", "OK"), (b":12\r\n", 12),
                      (b"$-1\r\n", None), (b"*2\r\n$1\r\na\r\n:3\r\n",
                                           ["a", 3])):
        assert port._read_reply(io.BytesIO(raw)) == want
    with pytest.raises(RuntimeError, match="server error"):
        port._read_reply(io.BytesIO(b"-ERR x\r\n"))
    assert port._read_command(io.BytesIO(b"PING extra\r\n")) == \
        ["PING", "extra"]


@pytest.mark.parametrize("mod", [ref, port])
def test_killed_durable_broker_replays_its_journal(tmp_path, mod):
    jdir = str(tmp_path / "j")
    server = mod.RespServer(durable="commit", journal_dir=jdir).start()
    cli = port.RespClient(port=server.port)
    cli.lpush_many("q", [f"predict,{i},v" for i in range(5)])
    assert cli.rpop_many("q", 2) == ["predict,0,v", "predict,1,v"]
    assert cli.lease_many("q", 1, 30.0) == ["predict,2,v"]
    cli.close()
    server.kill()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        # the other side's server replays this side's journal
        other = port if mod is ref else ref
        again = other.RespServer(durable="commit", journal_dir=jdir).start()
    try:
        cli = port.RespClient(port=again.port)
        # the leased (unacked) value is outstanding work: replayed first
        assert cli.rpop_many("q", 10) == ["predict,2,v", "predict,3,v",
                                          "predict,4,v"]
        assert again.journal_replayed == 3
        assert again.journal_stats()["mode"] == "commit"
        cli.close()
    finally:
        again.stop()


def test_client_reconnects_after_a_dropped_connection():
    server = port.RespServer().start()
    try:
        from avenir_tpu_torch.core.metrics import Counters
        c = Counters()
        cli = port.RespClient(port=server.port, counters=c)
        cli.lpush("q", "a")
        cli._sock.shutdown(socket.SHUT_RDWR)
        with pytest.warns(RuntimeWarning, match="reconnected"):
            assert cli.rpop("q") == "a"
        assert cli.reconnects == 1 and c.get("Broker", "Reconnects") == 1
        cli.close()
    finally:
        server.stop()


def test_leased_loop_killed_mid_batch_is_redelivered(tmp_path):
    """A leased wire loop that dies after taking a batch (no ACKPUSH): the
    lease expires, a second loop serves every request once, and the
    replies are those of a destructive run."""
    from avenir_tpu_torch.serving.predictor import Predictor
    from avenir_tpu_torch.serving.service import (BatchPolicy,
                                                  PredictionService,
                                                  RespPredictionLoop)
    from avenir_tpu_torch.core.schema import FeatureSchema

    class Echo(Predictor):
        def _predict_table(self, table):
            return [f"v{int(x)}" for x in table.columns[1]]

    fs = FeatureSchema.from_dict({"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "x", "ordinal": 1, "dataType": "int", "feature": True}]})
    server = port.RespServer(durable="commit",
                             journal_dir=str(tmp_path / "j")).start()
    try:
        feeder = port.RespClient(port=server.port)
        msgs = [f"predict,{i},k{i},{i}" for i in range(20)]
        feeder.lpush_many("requestQueue", msgs + ["stop"])
        cfg = {"redis.server.port": server.port,
               "redis.lease.timeout.s": 0.2}

        def svc():
            return PredictionService(Echo(fs, buckets=(8,)), warm=False,
                                     policy=BatchPolicy(max_batch=8),
                                     wire_native="off")
        dead = RespPredictionLoop(svc(), cfg)
        taken = dead.client.lease_many("requestQueue", 8, 0.2)
        assert len(taken) == 8            # ...and the loop dies here
        dead.close()
        time.sleep(0.3)
        live = svc()
        loop = RespPredictionLoop(live, cfg)
        loop.run(max_idle_s=5.0)
        loop.close()
        got = feeder.rpop_many("predictionQueue", 100)
        by_id, dups = port.dedup_replies(got)
        assert dups == 0
        assert by_id == {str(i): f"v{i}" for i in range(20)}
        assert server.redelivered == 8
        assert server.counters.get("Broker", "Redelivered") == 8
        feeder.close()
    finally:
        server.stop()
