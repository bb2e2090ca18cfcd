"""Write-ahead journal for the durable RESP broker: port of
``avenir_tpu/io/qjournal.py``, writing the same bytes.

One :class:`QueueJournal` backs one broker shard.  Every queue mutation
the broker accepts — a pushed value, an acknowledged delivery, a deleted
queue — is appended as one crc32-framed record *before* the in-memory
deque mutates, so a ``kill -9``'d (or power-cut, in ``fsync`` mode)
shard replays back to exactly the accepted-but-unanswered set.

Record framing (little-endian), reusing colcache's per-record crc
discipline::

    [u32 payload_len][u32 crc32(payload)][payload]

    payload 'P' + u64 seq + u16 len(q) + q + u32 len(v) + v    push
    payload 'A' + u64 seq + u16 len(q) + q + u16 len(id) + id  ack
    payload 'D' + u16 len(q) + q                               del queue

Segments are ``seg_<n>.avtj`` under the journal dir.  Rotation: when the
live segment exceeds ``segment_bytes`` the journal (1) opens segment
``n+1``, (2) writes a checkpoint JSON of the full live state via tmp-then-rename
(colcache's atomicity discipline), (3) deletes segments ``<= n``.  A
crash between any two steps leaves either the old checkpoint plus all
old segments, or the new checkpoint plus the new segment — both replay
to the same state; nothing is deleted before the checkpoint that covers
it is durably in place.

Replay tolerates a torn tail: a record whose length field, bytes, or
crc do not check out ends the replay at the last intact prefix with a
warning — a corrupt record is *never* served.  Appending always starts
a fresh segment above the highest existing index, so a torn tail is
never appended into.

Durability levels (the ``ps.broker.durable`` knob):

    ``commit``  write+flush per accepted batch — survives process kill
                (bytes are in the OS page cache), not an OS crash.
    ``fsync``   ``commit`` plus ``os.fsync`` per batch — survives power
                loss, at the cost of one fsync per batch.

Fault hooks (``core.faults``): ``journal_write`` before every segment
append and before the checkpoint write, ``journal_fsync`` before every
fsync, ``journal_replay`` at replay start.
"""

from __future__ import annotations

import binascii
import json
import os
import re
import struct
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

from ..core.faults import fault_point

MODES = ("commit", "fsync")
SEGMENT_RE = re.compile(r"^seg_(\d{8})\.avtj$")
CHECKPOINT = "checkpoint.json"
# a record larger than this cannot be legitimate (queue values are
# request lines); treat the length field itself as corruption instead
# of attempting a multi-GB allocation from a torn header.
MAX_RECORD = 64 << 20

_OP_PUSH = 0x50   # 'P'
_OP_ACK = 0x41    # 'A'
_OP_DEL = 0x44    # 'D'


def _crc(payload: bytes) -> int:
    return binascii.crc32(payload) & 0xFFFFFFFF


def encode_push(seq: int, queue: str, value: str) -> bytes:
    q = queue.encode("utf-8")
    v = value.encode("utf-8")
    return struct.pack("<BQH", _OP_PUSH, seq, len(q)) + q + \
        struct.pack("<I", len(v)) + v


def encode_ack(seq: int, queue: str, rid: str) -> bytes:
    q = queue.encode("utf-8")
    r = rid.encode("utf-8")
    return struct.pack("<BQH", _OP_ACK, seq, len(q)) + q + \
        struct.pack("<H", len(r)) + r


def encode_del(queue: str) -> bytes:
    q = queue.encode("utf-8")
    return struct.pack("<BH", _OP_DEL, len(q)) + q


def frame(payload: bytes) -> bytes:
    return struct.pack("<II", len(payload), _crc(payload)) + payload


class ReplayState:
    """What a journal replays to: per-queue outstanding ``(seq, value)``
    lists oldest-first, per-queue acked request ids in ack order, and
    the next sequence number to assign."""

    def __init__(self):
        self.queues: Dict[str, List[Tuple[int, str]]] = {}
        self.acked: Dict[str, List[str]] = {}
        self.next_seq: int = 1
        self.records: int = 0        # records applied past the checkpoint
        self.restored: int = 0       # outstanding values after replay
        self.torn: bool = False      # replay stopped at a damaged record

    def finalize(self) -> "ReplayState":
        self.restored = sum(len(v) for v in self.queues.values())
        return self


class QueueJournal:
    """Append-side + replay-side of one shard's write-ahead journal.

    Not thread-safe by itself: the broker calls every method under its
    own queue lock, which is also what makes "journal before memory"
    atomic with respect to concurrent consumers."""

    def __init__(self, path: str, mode: str = "commit",
                 segment_bytes: int = 4 << 20):
        if mode not in MODES:
            raise ValueError(
                f"journal mode must be one of {MODES}, got {mode!r}")
        self.path = path
        self.mode = mode
        self.segment_bytes = int(segment_bytes)
        # set by the broker: () -> (queues, acked, next_seq) live state
        # for the rotation checkpoint; queues as {name: [(seq, v), ...]}.
        self.snapshot_provider: \
            Optional[Callable[[], Tuple[dict, dict, int]]] = None
        self._fh = None
        self._seg_index = -1
        self._seg_bytes = 0
        self.fsyncs = 0
        self.fsync_ms_ema = 0.0
        self.appended_records = 0
        self.rotations = 0
        os.makedirs(self.path, exist_ok=True)

    # ---- replay -----------------------------------------------------

    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        for fn in os.listdir(self.path):
            m = SEGMENT_RE.match(fn)
            if m:
                out.append((int(m.group(1)), os.path.join(self.path, fn)))
        return sorted(out)

    def _load_checkpoint(self) -> Tuple[ReplayState, int]:
        """(state, covered_segment_index); covered=-1 when no usable
        checkpoint exists (replay then scans every segment)."""
        st = ReplayState()
        cp = os.path.join(self.path, CHECKPOINT)
        if not os.path.exists(cp):
            return st, -1
        try:
            with open(cp, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            body = json.dumps(doc["state"], sort_keys=True,
                              separators=(",", ":"))
            if _crc(body.encode("utf-8")) != int(doc["crc32"]):
                raise ValueError("checkpoint crc mismatch")
            state = doc["state"]
            st.next_seq = int(state["next_seq"])
            st.queues = {k: [(int(s), v) for s, v in items]
                         for k, items in state["queues"].items()}
            st.acked = {k: list(ids) for k, ids in state["acked"].items()}
            return st, int(state["covered"])
        except Exception as exc:  # noqa: BLE001 - availability-first
            warnings.warn(
                f"qjournal: unreadable checkpoint {cp} "
                f"({type(exc).__name__}: {exc}); replaying every segment",
                RuntimeWarning)
            return ReplayState(), -1

    @staticmethod
    def _apply(st: ReplayState, payload: bytes,
               pending: Dict[int, Tuple[str, str]]) -> None:
        op = payload[0]
        if op == _OP_PUSH:
            seq, qlen = struct.unpack_from("<QH", payload, 1)
            off = 11
            q = payload[off:off + qlen].decode("utf-8")
            off += qlen
            (vlen,) = struct.unpack_from("<I", payload, off)
            off += 4
            v = payload[off:off + vlen].decode("utf-8")
            pending[seq] = (q, v)
            st.next_seq = max(st.next_seq, seq + 1)
        elif op == _OP_ACK:
            seq, qlen = struct.unpack_from("<QH", payload, 1)
            off = 11
            q = payload[off:off + qlen].decode("utf-8")
            off += qlen
            (rlen,) = struct.unpack_from("<H", payload, off)
            off += 2
            rid = payload[off:off + rlen].decode("utf-8")
            if seq in pending:
                del pending[seq]
            else:
                # ack for a value the checkpoint already holds
                items = st.queues.get(q)
                if items:
                    st.queues[q] = [it for it in items if it[0] != seq]
            if rid:
                st.acked.setdefault(q, []).append(rid)
            st.next_seq = max(st.next_seq, seq + 1)
        elif op == _OP_DEL:
            (qlen,) = struct.unpack_from("<H", payload, 1)
            q = payload[3:3 + qlen].decode("utf-8")
            st.queues.pop(q, None)
            st.acked.pop(q, None)
            for seq in [s for s, (qq, _) in pending.items() if qq == q]:
                del pending[seq]
        else:
            raise ValueError(f"unknown journal op 0x{op:02x}")

    def replay(self) -> ReplayState:
        """Rebuild state from checkpoint + segments.  Stops at the first
        damaged record (torn tail, truncated segment, bad crc) with a
        warning — the intact prefix is the recovered state."""
        fault_point("journal_replay")
        st, covered = self._load_checkpoint()
        pending: Dict[int, Tuple[str, str]] = {}
        for idx, seg in self._segments():
            if idx <= covered:
                continue   # compaction raced the delete; stale segment
            if st.torn:
                break      # records after damage are not trustworthy
            try:
                with open(seg, "rb") as fh:
                    data = fh.read()
            except OSError as exc:
                warnings.warn(
                    f"qjournal: unreadable segment {seg} ({exc}); "
                    "recovering the intact prefix", RuntimeWarning)
                st.torn = True
                break
            off, n = 0, len(data)
            while off < n:
                if off + 8 > n:
                    st.torn = True
                    break
                ln, crc = struct.unpack_from("<II", data, off)
                if ln == 0 or ln > MAX_RECORD or off + 8 + ln > n:
                    st.torn = True
                    break
                payload = data[off + 8:off + 8 + ln]
                if _crc(payload) != crc:
                    st.torn = True
                    break
                try:
                    self._apply(st, payload, pending)
                except Exception as exc:  # noqa: BLE001
                    warnings.warn(
                        f"qjournal: undecodable record in {seg} at byte "
                        f"{off} ({type(exc).__name__}: {exc}); recovering "
                        "the intact prefix", RuntimeWarning)
                    st.torn = True
                    break
                st.records += 1
                off += 8 + ln
            if st.torn and off < n:
                warnings.warn(
                    f"qjournal: torn/damaged record in {seg} at byte "
                    f"{off} of {n}; recovering the intact prefix "
                    f"({st.records} records applied)", RuntimeWarning)
        # outstanding pushes replayed past the checkpoint, in seq order
        for seq in sorted(pending):
            q, v = pending[seq]
            st.queues.setdefault(q, []).append((seq, v))
        for q in st.queues:
            st.queues[q].sort(key=lambda it: it[0])
        return st.finalize()

    # ---- append -----------------------------------------------------

    def open_for_append(self) -> None:
        """Open a fresh segment ABOVE every existing index — a possibly
        torn tail is never appended into."""
        segs = self._segments()
        nxt = (segs[-1][0] + 1) if segs else 0
        self._open_segment(nxt)

    def _open_segment(self, index: int) -> None:
        fn = os.path.join(self.path, f"seg_{index:08d}.avtj")
        self._fh = open(fn, "ab", buffering=0)
        self._seg_index = index
        self._seg_bytes = os.path.getsize(fn)

    def _write(self, blob: bytes) -> None:
        fault_point("journal_write")
        self._fh.write(blob)
        if self.mode == "fsync":
            fault_point("journal_fsync")
            t0 = time.perf_counter()
            os.fsync(self._fh.fileno())
            dt = (time.perf_counter() - t0) * 1e3
            self.fsyncs += 1
            self.fsync_ms_ema = dt if self.fsyncs == 1 else \
                0.9 * self.fsync_ms_ema + 0.1 * dt
        self._seg_bytes += len(blob)

    def append(self, payloads: List[bytes]) -> None:
        """Append a batch of encoded payloads as ONE write (and, in
        fsync mode, one fsync) — the unit of durability is the broker
        dispatch call, not the record.

        Rotation runs BEFORE the write, never after: the broker journals
        inside its dispatch, possibly before its in-memory mutation, so
        a checkpoint taken after this write could cover this record
        without its effect in the snapshot — and compaction would then
        delete the only copy.  Rotating first means every covered
        segment holds only records whose dispatches completed, and the
        in-flight batch always lands in the fresh, uncovered segment."""
        if not payloads or self._fh is None:
            return
        if self._seg_bytes >= self.segment_bytes:
            self.rotate()
        self._write(b"".join(frame(p) for p in payloads))
        self.appended_records += len(payloads)

    # ---- rotation / checkpoint --------------------------------------

    def _write_checkpoint(self, covered: int) -> None:
        if self.snapshot_provider is None:
            return
        queues, acked, next_seq = self.snapshot_provider()
        state = {
            "covered": covered,
            "next_seq": int(next_seq),
            "queues": {k: [[int(s), v] for s, v in items]
                       for k, items in queues.items()},
            "acked": {k: list(ids) for k, ids in acked.items()},
        }
        body = json.dumps(state, sort_keys=True, separators=(",", ":"))
        doc = {"format": 1, "crc32": _crc(body.encode("utf-8")),
               "state": state}
        fault_point("journal_write")
        tmp = os.path.join(self.path, CHECKPOINT + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.flush()
            if self.mode == "fsync":
                os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(self.path, CHECKPOINT))

    def rotate(self) -> None:
        """Open next segment -> checkpoint covering this one -> delete
        covered segments.  Any crash inside leaves a replayable pair."""
        if self._fh is None or self.snapshot_provider is None:
            return
        covered = self._seg_index
        self._fh.close()
        self._open_segment(covered + 1)
        self._write_checkpoint(covered)
        for idx, seg in self._segments():
            if idx <= covered:
                try:
                    os.remove(seg)
                except OSError:
                    pass   # replay skips stale segments via `covered`
        self.rotations += 1

    def checkpoint(self) -> None:
        """Graceful-shutdown compaction: rotate unconditionally so the
        next start replays from the checkpoint alone (cheap restart)."""
        self.rotate()

    def sync(self) -> None:
        """Force bytes to disk regardless of mode (graceful shutdown)."""
        if self._fh is None:
            return
        fault_point("journal_fsync")
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    # ---- introspection ----------------------------------------------

    def stats(self) -> dict:
        segs = self._segments()
        return {
            "mode": self.mode,
            "segments": len(segs),
            "bytes": sum(os.path.getsize(p) for _, p in segs
                         if os.path.exists(p)),
            "records": self.appended_records,
            "rotations": self.rotations,
            "fsyncs": self.fsyncs,
            "fsync_ms_ema": round(self.fsync_ms_ema, 4),
        }
