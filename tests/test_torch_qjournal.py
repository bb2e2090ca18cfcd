"""The port's broker journal (``avenir_tpu_torch/io/qjournal.py``) against
the JAX package's (``avenir_tpu/io/qjournal.py``) on the CPU.

Held to, byte for byte: the record encoders and frames; the journal a
durable broker writes for ``tests/torch_fixtures/wire9``'s command script
(the fixture's ``journal/``, made by the JAX package: a rotation
checkpoint and the segment after it); each side's replay of the other's
journal, whole and with a torn tail (a truncated record, a bad crc,
garbage), reaches the same state; the fault points ``journal_write``,
``journal_fsync`` and ``journal_replay`` fire in the port.
"""

import importlib.util
import os
import shutil
import warnings

import pytest

from avenir_tpu.io import qjournal as ref
from avenir_tpu_torch.core import faults
from avenir_tpu_torch.io import qjournal as port
from avenir_tpu_torch.io import respq

WIRE9 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_fixtures", "wire9")


def _make():
    spec = importlib.util.spec_from_file_location(
        "wire9_make", os.path.join(WIRE9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make()


def _state(st):
    return (st.queues, st.acked, st.next_seq, st.records, st.restored,
            st.torn)


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def test_record_encoders_and_frames_agree():
    for args in ((1, "q", "predict,1,a"), (2 ** 40, "requestQueue", "é" * 9),
                 (7, "", "")):
        assert port.encode_push(*args) == ref.encode_push(*args)
        assert port.encode_ack(*args) == ref.encode_ack(*args)
        assert port.frame(port.encode_push(*args)) == \
            ref.frame(ref.encode_push(*args))
    assert port.encode_del("q") == ref.encode_del("q")


def test_journal_bytes_equal_the_fixture(tmp_path):
    jdir = str(tmp_path / "journal")
    got = MAKE.run_journal_script(respq, jdir)
    assert _files(jdir) == _files(os.path.join(WIRE9, "journal"))
    from avenir_tpu.io import respq as jrespq
    assert got == MAKE.run_journal_script(jrespq, str(tmp_path / "ref"))


@pytest.mark.parametrize("writer,reader", [(ref, port), (port, ref),
                                           (port, port)])
def test_each_side_replays_the_other_journal(tmp_path, writer, reader):
    d = tmp_path / "j"
    if writer is ref:
        shutil.copytree(os.path.join(WIRE9, "journal"), d)
    else:
        MAKE.run_journal_script(respq, str(d))
    want = ref.QueueJournal(str(d)).replay()
    got = reader.QueueJournal(str(d)).replay()
    assert _state(got) == _state(want)
    assert not got.torn and got.restored == 10
    assert got.queues["requestQueue"][0][1] == "predict,6,x,6"


@pytest.mark.parametrize("tail", ["truncated", "crc", "garbage", "length"])
def test_torn_tail_replays_the_intact_prefix(tmp_path, tail):
    states = []
    for mod in (ref, port):
        d = tmp_path / mod.__name__.split(".")[0]
        shutil.copytree(os.path.join(WIRE9, "journal"), d)
        seg = sorted(f for f in os.listdir(d) if f.endswith(".avtj"))[-1]
        path = os.path.join(d, seg)
        with open(path, "rb") as fh:
            data = fh.read()
        extra = port.frame(port.encode_push(99, "requestQueue", "late"))
        if tail == "truncated":
            data += extra[:-3]
        elif tail == "crc":
            data += extra[:-1] + bytes([extra[-1] ^ 1])
        elif tail == "garbage":
            data += b"\x00\x01\x02"
        else:
            data += b"\xff\xff\xff\x7f" + extra[4:]
        with open(path, "wb") as fh:
            fh.write(data)
        with pytest.warns(RuntimeWarning, match="torn|damaged"):
            states.append(_state(mod.QueueJournal(str(d)).replay()))
    assert states[0] == states[1]
    assert states[1][5] is True and states[1][4] == 10


@pytest.mark.parametrize("op", ["journal_write", "journal_fsync",
                                "journal_replay"])
def test_fault_points_fire(tmp_path, op):
    j = port.QueueJournal(str(tmp_path / "j"), mode="fsync")
    faults.install(faults.FaultInjector.parse(f"{op}@0=raise:OSError"))
    try:
        with pytest.raises(OSError):
            if op == "journal_replay":
                j.replay()
            else:
                j.open_for_append()
                j.append([port.encode_push(1, "q", "v")])
    finally:
        faults.uninstall()
        j.close()


def test_a_journal_that_cannot_write_degrades_the_broker(tmp_path):
    server = respq.RespServer(durable="commit",
                              journal_dir=str(tmp_path / "j")).start()
    faults.install(faults.FaultInjector.parse(
        "journal_write@*=raise:OSErrorx3"))
    try:
        cli = respq.RespClient(port=server.port)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert cli.lpush("q", "a") == 1
            assert cli.rpop("q") == "a"
        assert any("durability degraded" in str(x.message) for x in w)
        assert server.counters.get("Broker", "JournalWriteErrors") == 2
        cli.close()
    finally:
        faults.uninstall()
        server.stop()
