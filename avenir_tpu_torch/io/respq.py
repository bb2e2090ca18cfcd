"""Minimal Redis-protocol (RESP2) queue transport for the serving loop:
port of ``avenir_tpu/io/respq.py`` (its single-endpoint half).

The reference's online tier rides Redis lists as queues: requests are
``rpop``ed from a request queue and replies ``lpush``ed to a prediction
queue (storm/RedisSpout.java:30-95, RedisActionWriter.java:47-61).  This
module provides both halves of that contract with no external
dependency:

  * :class:`RespServer` — a threaded TCP server speaking the RESP2 subset
    the queue contract needs (LPUSH, RPOP, BRPOP, LLEN, DEL, PING, INFO,
    and this broker's LEASE / ACKPUSH), backed by in-memory deques.  A
    real ``redis-cli``/client library can talk to it.
  * :class:`RespClient` — a blocking client usable against this server OR
    a real Redis instance (the wire format is the same).  A dropped TCP
    connection mid-call reconnects once with backoff instead of poisoning
    the client (see :meth:`RespClient._call`).

Durability and delivery: the server optionally journals every accepted
mutation (``durable=commit|fsync``, ``io/qjournal.py``) and replays it on
restart, and the ``LEASE`` / ``ACKPUSH`` verbs replace destructive pops
with visibility-timeout leases whose ack piggybacks on the batched reply
push — at-least-once delivery, upgraded to exactly-once EFFECT by
request-id reply dedup (server-side answered set + the shared
consumer-side :func:`dedup_replies`).  ``durable=off`` + the classic
verbs are byte-identical to the JAX package's wire, and either package's
client talks to the other's server.

Several brokers form a consistent-hash ring (``ps.broker.shards``):
:class:`HashRing` places request ids on shards, :class:`ShardedRespClient`
fans one client's verbs out over the ring (a dead shard is counted as
``Broker/BrokerShardDown`` and its keys re-route to the survivors), and
:func:`make_queue_client` builds the plain or the sharded client from a
serving config.  The ring hashes as the JAX package's does, so either
package's ring places every key on the same shard.

Security note: like stock Redis, there is no auth — bind to loopback
(the default) or a trusted network only.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import socket
import socketserver
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.metrics import Counters
from ..telemetry import instant
from ..telemetry import reqtrace
from . import native_wire
from . import qjournal

DURABLE_ENV = "AVENIR_TPU_BROKER_DURABLE"
DURABLE_MODES = ("off", "commit", "fsync")
# client reconnects: tries, and the first backoff (doubling)
_RECONNECT_ATTEMPTS = 4
_RECONNECT_BASE_S = 0.05


def resolve_durable(value: Optional[str] = None) -> str:
    """The ``ps.broker.durable`` knob / ``AVENIR_TPU_BROKER_DURABLE``
    env twin: ``off`` (today's bytes and behavior, the default),
    ``commit`` (journal write+flush per accepted batch — survives
    process kill), ``fsync`` (plus fsync — survives power loss)."""
    mode = (value if value is not None
            else os.environ.get(DURABLE_ENV) or "off").strip().lower()
    if mode not in DURABLE_MODES:
        raise ValueError(
            f"broker durable mode must be one of {DURABLE_MODES}, "
            f"got {value!r}")
    return mode


def _lease_rid(value: str, delim: str) -> Optional[str]:
    """The lease identity of a queued value: request messages
    (``predict``/``predictq``) lease by their id field; reward messages
    (``reward,<id>,<value>``) lease by ``reward:<id>`` — a verb-scoped
    key, because a reward for request ``<id>`` must coexist in the
    pending set with the prediction lease of the same ``<id>`` (the
    online learner acks predictions by reply id and rewards by the
    snapshot-gated ``reward:<id>`` token); anything else (control words
    like ``stop``/``reload``, malformed lines) has no identity and is
    delivered destructively, exactly as before."""
    parts = value.split(delim, 2)
    if parts[0] in ("predict", "predictq") and len(parts) > 1 and parts[1]:
        return parts[1]
    if parts[0] == "reward" and len(parts) > 1 and parts[1]:
        return f"reward:{parts[1]}"
    return None


def dedup_replies(values: Sequence[str], delim: str = ","
                  ) -> Tuple[Dict[str, str], int]:
    """First-wins reply dedup by request id — the consumer half of the
    exactly-once contract (at-least-once delivery + idempotent effect).
    Returns ``({rid: reply_tail}, duplicates_dropped)`` where the tail
    is the reply with its id stripped (the label for ``<id>,<label>``).
    Shared by the CLI reply collector, the drills, and any client
    reassembling replies from the ring."""
    by_id: Dict[str, str] = {}
    dups = 0
    for v in values:
        rid, _, rest = v.partition(delim)
        if rid in by_id:
            dups += 1
            continue
        by_id[rid] = rest
    return by_id, dups


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def _encode_command(args: List[str]) -> bytes:
    """Client -> server: RESP array of bulk strings."""
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        b = a.encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


def _read_line(rf) -> bytes:
    line = rf.readline()
    if not line:
        raise ConnectionError("peer closed")
    return line.rstrip(b"\r\n")


def _read_reply(rf):
    """Parse one RESP reply: +simple, -error, :int, $bulk (None for -1),
    *array."""
    line = _read_line(rf)
    kind, rest = line[:1], line[1:]
    if kind == b"+":
        return rest.decode()
    if kind == b"-":
        raise RuntimeError(f"server error: {rest.decode()}")
    if kind == b":":
        return int(rest)
    if kind == b"$":
        n = int(rest)
        if n == -1:
            return None
        body = rf.read(n + 2)[:n]
        return body.decode()
    if kind == b"*":
        n = int(rest)
        if n == -1:
            return None
        return [_read_reply(rf) for _ in range(n)]
    raise RuntimeError(f"unparseable reply {line!r}")


def _read_command(rf) -> Optional[List[str]]:
    """Server side: one client command (RESP array of bulk strings, plus
    the inline fallback real Redis also accepts)."""
    line = rf.readline()
    if not line:
        return None
    line = line.rstrip(b"\r\n")
    if not line:
        return []
    if line[:1] == b"*":
        n = int(line[1:])
        args = []
        for _ in range(n):
            hdr = _read_line(rf)
            if hdr[:1] != b"$":
                raise RuntimeError(f"expected bulk string, got {hdr!r}")
            ln = int(hdr[1:])
            args.append(rf.read(ln + 2)[:ln].decode())
        return args
    return line.decode().split()  # inline command


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv: "RespServer" = self.server.owner  # type: ignore[attr-defined]
        srv._track(self.connection, add=True)
        try:
            while True:
                try:
                    args = _read_command(self.rfile)
                except (ConnectionError, ValueError, RuntimeError, OSError):
                    return
                if args is None:
                    return
                if not args:
                    continue
                try:
                    self.wfile.write(srv.dispatch(args))
                    self.wfile.flush()
                except OSError:
                    return   # peer (or kill()) closed the socket mid-reply
        finally:
            srv._track(self.connection, add=False)


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class RespServer:
    """In-memory Redis-list queue server.  ``start()`` binds and serves on
    a daemon thread; ``port`` is resolved after start (pass 0 for an
    ephemeral port).

    Durability: with ``durable`` in ``commit``/``fsync`` every
    queue mutation is journaled (``io/qjournal.py``) under ``journal_dir``
    BEFORE the in-memory deque mutates, and ``start()`` replays the
    journal — a killed-and-restarted shard (same dir) comes back with
    exactly the accepted-but-unanswered set.  ``off`` (default) is
    byte-for-byte today's broker.

    Leases: the ``LEASE`` verb delivers request messages under a
    visibility-timeout lease instead of a destructive pop (Redis
    ``RPOPLPUSH``-style reliable delivery).  ``ACKPUSH`` pushes a batch
    of replies AND acks the leases their request ids held — the ack
    piggybacks on the reply trip, so the worker's crash window closes
    without extra round trips.  An expired lease re-enqueues at the POP
    end (redelivered before fresh traffic — age order), and replies for
    already-acked ids are dropped server-side (first wins).  Leases work
    with or without the journal; together they give exactly-once
    EFFECT without the pushing client re-offering."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 durable: Optional[str] = None,
                 journal_dir: Optional[str] = None,
                 counters: Optional[Counters] = None,
                 acked_cap: int = 65536,
                 journal_segment_bytes: int = 4 << 20):
        self.host, self.port = host, port
        self.durable = resolve_durable(durable)
        if self.durable != "off" and not journal_dir:
            raise ValueError(
                f"durable={self.durable!r} needs a journal_dir")
        self.journal_dir = journal_dir
        self.counters = counters if counters is not None else Counters()
        # queues hold (seq, value): seq is the journal identity of one
        # accepted value — assigned even with the journal off, so leases
        # and durability compose without a format switch
        self._queues: Dict[str, deque] = {}
        self._next_seq = 1
        # queue -> rid -> (seq, value, expiry_monotonic): outstanding
        # leases; queue -> OrderedDict(rid -> True): answered ids (the
        # server half of reply dedup), bounded at acked_cap first-in
        # first-evicted — an id evicted here can in principle dup past
        # the broker, which is why consumers ALSO dedup (dedup_replies)
        self._leases: Dict[str, Dict[str, Tuple[int, str, float]]] = {}
        self._acked: Dict[str, "OrderedDict[str, bool]"] = {}
        self._acked_cap = int(acked_cap)
        self._journal: Optional[qjournal.QueueJournal] = None
        self._journal_segment_bytes = int(journal_segment_bytes)
        self._journal_errors = 0
        self.redelivered = 0
        self.journal_replayed = 0
        self.dup_replies_dropped = 0
        # a Condition so BRPOP can park its handler thread until an LPUSH
        # arrives (ThreadingTCPServer: blocking one handler blocks only
        # that client's connection); its lock is the queues lock
        self._lock = threading.Condition()
        self._server: Optional[_TCPServer] = None
        self._thread: Optional[threading.Thread] = None
        # live client sockets, so kill() can sever them the way a dead
        # broker process would (stop() alone only closes the listener;
        # established connections would keep serving from the ghost)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # flipped by kill(): parked BRPOP handlers re-check it on every
        # wakeup, so severing the sockets can't leave a ghost waiter
        # parked on the condition for the life of the process
        self._killed = False

    def _track(self, conn, add: bool) -> None:
        with self._conns_lock:
            if add:
                self._conns.add(conn)
            else:
                self._conns.discard(conn)

    # ---- durability plumbing ----
    def _journal_batch(self, payloads: List[bytes]) -> None:
        """Append encoded records; a journal that cannot write degrades
        the shard to in-memory with a warning instead of refusing
        traffic (availability-first — the drills pin replay, not
        refusal)."""
        if self._journal is None or not payloads:
            return
        try:
            self._journal.append(payloads)
        except (OSError, MemoryError) as exc:
            self._journal_errors += 1
            self.counters.increment("Broker", "JournalWriteErrors")
            if self._journal_errors == 1:
                warnings.warn(
                    f"respq: journal write failed "
                    f"({type(exc).__name__}: {exc}); shard continues "
                    "IN-MEMORY (durability degraded)", RuntimeWarning)

    def _journal_snapshot(self) -> Tuple[dict, dict, int]:
        """Rotation checkpoint source: every outstanding value — queued
        OR under lease (leased-not-acked is still unanswered work) —
        plus the acked-id sets, oldest-first by seq."""
        with self._lock:
            queues: Dict[str, List[Tuple[int, str]]] = {
                k: sorted(q, key=lambda it: it[0])
                for k, q in self._queues.items()}
            for k, tab in self._leases.items():
                if not tab:
                    continue
                items = queues.setdefault(k, [])
                items.extend((seq, v) for seq, v, _exp in tab.values())
                items.sort(key=lambda it: it[0])
            acked = {k: list(od) for k, od in self._acked.items() if od}
            return queues, acked, self._next_seq

    def _trim_acked(self, od: "OrderedDict[str, bool]") -> None:
        while len(od) > self._acked_cap:
            od.popitem(last=False)

    # ---- leases ----
    def _expire_locked(self, key: str) -> List[Tuple[str, str]]:
        """Re-enqueue expired leases of ``key`` at the POP end (served
        before fresh traffic — redelivery honors request age).  Returns
        ``(queue, rid)`` pairs for instant emission OUTSIDE the lock."""
        tab = self._leases.get(key)
        if not tab:
            return []
        now = time.monotonic()
        expired = [rid for rid, ent in tab.items() if ent[2] <= now]
        if not expired:
            return []
        q = self._queues.setdefault(key, deque())
        out = []
        for rid in expired:
            seq, v, _exp = tab.pop(rid)
            q.append((seq, v))
            out.append((key, rid))
        self.redelivered += len(out)
        self.counters.increment("Broker", "Redelivered", len(out))
        self._lock.notify_all()
        return out

    def _next_expiry_locked(self, key: str) -> Optional[float]:
        tab = self._leases.get(key)
        if not tab:
            return None
        return min(ent[2] for ent in tab.values())

    @staticmethod
    def _note_redelivered(red: List[Tuple[str, str]]) -> None:
        for key, rid in red:
            instant("broker.redeliver", cat="broker", queue=key, rid=rid)

    # ---- command dispatch (the RESP subset the queue contract uses) ----
    def dispatch(self, args: List[str]) -> bytes:
        cmd = args[0].upper()
        try:
            if cmd == "PING":
                return b"+PONG\r\n"
            if cmd == "LPUSH":
                with self._lock:
                    q = self._queues.setdefault(args[1], deque())
                    items = []
                    for v in args[2:]:
                        items.append((self._next_seq, v))
                        self._next_seq += 1
                    if self._journal is not None:
                        self._journal_batch([
                            qjournal.encode_push(seq, args[1], v)
                            for seq, v in items])
                    for it in items:
                        q.appendleft(it)
                    self._lock.notify_all()   # wake parked BRPOP waiters
                    return b":%d\r\n" % len(q)
            if cmd == "BRPOP":
                # blocking pop: park THIS connection's handler thread
                # until a value arrives or the timeout lapses (seconds,
                # fractional ok; 0 = block indefinitely, as in Redis).
                # Reply is [key, value] or nil — the real BRPOP wire form.
                # The condition is held ONLY across the queue check/pop;
                # the reply is encoded after release so a slow handler
                # never extends the critical section other waiters (and
                # every LPUSH) contend on.
                key = args[1]
                timeout = float(args[2])
                deadline = None if timeout <= 0 \
                    else time.monotonic() + timeout
                popped: Optional[str] = None
                red: List[Tuple[str, str]] = []
                with self._lock:
                    while not self._killed:
                        red.extend(self._expire_locked(key))
                        q = self._queues.get(key)
                        if q:
                            seq, popped = q.pop()
                            if self._journal is not None:
                                self._journal_batch(
                                    [qjournal.encode_ack(seq, key, "")])
                            if not q:
                                del self._queues[key]
                            break
                        nxt = self._next_expiry_locked(key)
                        if deadline is None:
                            if nxt is None:
                                self._lock.wait()
                            else:
                                self._lock.wait(
                                    max(nxt - time.monotonic(), 0.001))
                        else:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            if nxt is not None:
                                remaining = max(
                                    min(remaining, nxt - time.monotonic()),
                                    0.001)
                            self._lock.wait(remaining)
                self._note_redelivered(red)
                if popped is None:
                    return b"*-1\r\n"
                k, v = key.encode(), popped.encode()
                return (b"*2\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n"
                        % (len(k), k, len(v), v))
            if cmd == "RPOP":
                if len(args) > 2:
                    # Redis >= 6.2 count form: ONE command drains up to
                    # n values (array reply; nil when the list is gone) —
                    # the server half of rpop_many's single round trip
                    n = int(args[2])
                    red = []
                    with self._lock:
                        red.extend(self._expire_locked(args[1]))
                        q = self._queues.get(args[1])
                        if not q:
                            self._note_redelivered(red)
                            return b"*-1\r\n"
                        vals = []
                        acks = []
                        while q and len(vals) < n:
                            seq, v = q.pop()
                            if self._journal is not None:
                                acks.append(qjournal.encode_ack(
                                    seq, args[1], ""))
                            vals.append(v.encode())
                        self._journal_batch(acks)
                        if not q:
                            del self._queues[args[1]]
                    self._note_redelivered(red)
                    return b"*%d\r\n%s" % (
                        len(vals),
                        b"".join(b"$%d\r\n%s\r\n" % (len(v), v)
                                 for v in vals))
                red = []
                with self._lock:
                    red.extend(self._expire_locked(args[1]))
                    q = self._queues.get(args[1])
                    if not q:
                        self._note_redelivered(red)
                        return b"$-1\r\n"
                    seq, popped = q.pop()
                    if self._journal is not None:
                        self._journal_batch(
                            [qjournal.encode_ack(seq, args[1], "")])
                    v = popped.encode()
                    if not q:
                        del self._queues[args[1]]  # Redis drops empty lists
                self._note_redelivered(red)
                return b"$%d\r\n%s\r\n" % (len(v), v)
            if cmd == "LEASE":
                # LEASE <key> <n> <lease_s> <block_s> [<delim>] — deliver
                # up to n values under a visibility-timeout lease instead
                # of a destructive pop (the RPOPLPUSH-equivalent).  A
                # leased value stays journal-outstanding until ACKPUSH
                # acks its id; expiry re-enqueues it.  Values without a
                # lease identity (control words) deliver destructively.
                # block_s > 0 parks like BRPOP, waking early for lease
                # expiries so a redelivery never waits out a full park.
                return self._lease(args)
            if cmd == "ACKPUSH":
                # ACKPUSH <pushq> <ackq> <delim> <v...> — push replies
                # AND ack the leases their request ids hold on <ackq>;
                # replies whose id was already answered are dropped
                # (first wins).  ONE trip closes the worker crash window.
                return self._ackpush(args)
            if cmd == "LLEN":
                # snapshot under the BRPOP condition, format outside —
                # depth probes (the autoscaler sensor polls this) must
                # not stretch the critical section parked poppers and
                # every LPUSH serialize on
                with self._lock:
                    n = len(self._queues.get(args[1], ()))
                return b":%d\r\n" % n
            if cmd == "INFO":
                # queue-depth observability WITHOUT popping: one bulk
                # string of "queue_depth:<name>=<n>" lines (every queue,
                # or just the named ones when keys are given).  The lock
                # is held only long enough to copy the lengths.  Lease /
                # journal lines appear ONLY when present, so the default
                # broker's INFO stays byte-identical.
                with self._lock:
                    if len(args) > 1:
                        depths = {k: len(self._queues.get(k, ()))
                                  for k in args[1:]}
                        leased = {k: len(self._leases.get(k, ()))
                                  for k in args[1:]}
                    else:
                        depths = {k: len(q)
                                  for k, q in self._queues.items()}
                        leased = {k: len(t)
                                  for k, t in self._leases.items()}
                lines = (["# Queues", f"queues:{len(depths)}"] +
                         [f"queue_depth:{k}={n}"
                          for k, n in sorted(depths.items())])
                lines += [f"queue_leased:{k}={n}"
                          for k, n in sorted(leased.items()) if n]
                if self.durable != "off":
                    lines.append(f"durable:{self.durable}")
                    if self._journal is not None:
                        st = self._journal.stats()
                        lines += [
                            f"journal_segments:{st['segments']}",
                            f"journal_bytes:{st['bytes']}",
                            f"journal_records:{st['records']}"]
                body = "\n".join(lines).encode()
                return b"$%d\r\n%s\r\n" % (len(body), body)
            if cmd == "DEL":
                with self._lock:
                    n = 0
                    dels = []
                    for k in args[1:]:
                        had = self._queues.pop(k, None) is not None
                        held = self._leases.pop(k, None)
                        answered = self._acked.pop(k, None)
                        if had:
                            n += 1
                        if (had or held or answered) \
                                and self._journal is not None:
                            dels.append(qjournal.encode_del(k))
                    self._journal_batch(dels)
                return b":%d\r\n" % n
            return b"-ERR unknown command '%s'\r\n" % cmd.encode()
        except IndexError:
            return b"-ERR wrong number of arguments\r\n"

    def _lease(self, args: List[str]) -> bytes:
        key = args[1]
        n = int(args[2])
        lease_s = float(args[3])
        block_s = float(args[4])
        delim = args[5] if len(args) > 5 else ","
        deadline = None if block_s <= 0 else time.monotonic() + block_s
        out: List[bytes] = []
        red: List[Tuple[str, str]] = []
        with self._lock:
            while not self._killed:
                red.extend(self._expire_locked(key))
                q = self._queues.get(key)
                if q:
                    tab = self._leases.setdefault(key, {})
                    answered = self._acked.get(key)
                    jr = self._journal is not None
                    recs: List[bytes] = []
                    while q and len(out) < n:
                        seq, v = q.pop()
                        rid = _lease_rid(v, delim)
                        if rid is not None and answered \
                                and rid in answered:
                            # a redelivered copy raced its own ack:
                            # retire it instead of double-serving
                            if jr:
                                recs.append(
                                    qjournal.encode_ack(seq, key, ""))
                            continue
                        if rid is not None and lease_s > 0:
                            tab[rid] = (seq, v,
                                        time.monotonic() + lease_s)
                        elif jr:
                            recs.append(qjournal.encode_ack(seq, key, ""))
                        out.append(v.encode())
                    if not q:
                        del self._queues[key]
                    self._journal_batch(recs)
                    if out:
                        break
                if deadline is None:
                    break   # non-blocking
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self._next_expiry_locked(key)
                if nxt is not None:
                    remaining = max(min(remaining,
                                        nxt - time.monotonic()), 0.001)
                self._lock.wait(remaining)
        self._note_redelivered(red)
        if not out:
            return b"*-1\r\n"
        return b"*%d\r\n%s" % (
            len(out),
            b"".join(b"$%d\r\n%s\r\n" % (len(v), v) for v in out))

    def _ackpush(self, args: List[str]) -> bytes:
        pushq, ackq, delim = args[1], args[2], args[3]
        values = args[4:]
        dups = 0
        with self._lock:
            tab = self._leases.get(ackq)
            answered = self._acked.setdefault(ackq, OrderedDict())
            jr = self._journal is not None
            recs: List[bytes] = []
            accepted: List[str] = []
            for v in values:
                rid = v.split(delim, 1)[0]
                if rid in answered:
                    dups += 1   # first reply won; drop the duplicate
                    continue
                ent = tab.pop(rid, None) if tab else None
                # journal the ack even with no lease held HERE (a
                # destructively-popped or cross-shard request): the
                # answered-set must survive restart for dedup to hold
                if jr:
                    recs.append(qjournal.encode_ack(
                        ent[0] if ent is not None else 0, ackq, rid))
                answered[rid] = True
                accepted.append(v)
            self._trim_acked(answered)
            q = self._queues.setdefault(pushq, deque())
            items = []
            for v in accepted:
                items.append((self._next_seq, v))
                self._next_seq += 1
                if jr:
                    recs.append(
                        qjournal.encode_push(items[-1][0], pushq, v))
            self._journal_batch(recs)
            for it in items:
                q.appendleft(it)
            if not q:
                self._queues.pop(pushq, None)
            self._lock.notify_all()
            depth = len(q)
        if dups:
            self.dup_replies_dropped += dups
            self.counters.increment("Broker", "DupRepliesDropped", dups)
        return b":%d\r\n" % depth

    def start(self) -> "RespServer":
        replayed = None
        if self.durable != "off" and self._journal is None:
            self._journal = qjournal.QueueJournal(
                self.journal_dir, mode=self.durable,
                segment_bytes=self._journal_segment_bytes)
            replayed = self._journal.replay()
            with self._lock:
                for k, items in replayed.queues.items():
                    # items are oldest-first; the deque pops from the
                    # RIGHT, so newest go leftmost
                    self._queues[k] = deque(reversed(items))
                for k, ids in replayed.acked.items():
                    od = self._acked.setdefault(k, OrderedDict())
                    for rid in ids:
                        od[rid] = True
                    self._trim_acked(od)
                self._next_seq = max(self._next_seq, replayed.next_seq)
            self._journal.snapshot_provider = self._journal_snapshot
            self._journal.open_for_append()
            self.journal_replayed += replayed.restored
            self.counters.increment("Broker", "JournalReplayed",
                                    replayed.restored)
        self._server = _TCPServer((self.host, self.port), _Handler)
        self._server.owner = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        if replayed is not None and (replayed.records or replayed.restored
                                     or replayed.torn):
            instant("broker.journal_replay", cat="broker",
                    endpoint=f"{self.host}:{self.port}",
                    records=replayed.records, restored=replayed.restored,
                    torn=int(replayed.torn))
        return self

    def _stop_listener(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def stop(self) -> None:
        """Graceful teardown: close the listener, then compact + sync +
        close the journal so the NEXT start replays from the checkpoint
        alone (cheap restart)."""
        self._stop_listener()
        if self._journal is not None:
            with self._lock:
                try:
                    self._journal.checkpoint()
                    self._journal.sync()
                except Exception as exc:  # noqa: BLE001 - teardown
                    warnings.warn(
                        f"respq: journal shutdown checkpoint failed "
                        f"({type(exc).__name__}: {exc}); next start "
                        "replays the segments instead", RuntimeWarning)
                self._journal.close()

    def kill(self) -> None:
        """Die like a crashed broker process: stop listening AND sever
        every established client connection (their next call raises),
        dropping the in-memory queues.  ``stop()`` is the graceful
        teardown; this is what the killed-shard drills simulate.  The
        journal is ABANDONED exactly where the crash left it (no
        checkpoint, no sync — a possibly-torn tail): a new server on the
        same ``journal_dir`` replays it."""
        self._stop_listener()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        # parked BRPOP handlers are waiting on the condition, not the
        # socket: flip the killed flag and wake them — each wait loop
        # exits, answers nil into the severed socket, and the handler
        # thread ends (without the flag an indefinite waiter would
        # re-check the empty queue and park forever)
        with self._lock:
            self._killed = True
            self._queues.clear()
            self._leases.clear()
            self._acked.clear()
            self._lock.notify_all()
        if self._journal is not None:
            self._journal.close()   # file handle only; no checkpoint

    # ---- observability ----
    def journal_stats(self) -> dict:
        return {} if self._journal is None else self._journal.stats()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RespClient:
    """Blocking client for the three verbs the reference uses.  Works
    against :class:`RespServer` or a real Redis.

    A dropped TCP connection mid-call (server restart, transient network
    fault) no longer poisons the client: ``_call`` reconnects ONCE with
    short exponential backoff and re-issues the command before
    surfacing the error (``reconnect=False`` restores the old
    fail-fast).  Two caveats: (1) if the DROP happened after the server
    executed the command but before the reply arrived, the re-issue can
    apply a write twice — the same at-least-once window every
    reconnecting Redis client has; exactly-once consumers dedupe by
    request id.  (2) a reply TIMEOUT (server alive but stalled past the
    socket timeout) reconnects so the next call starts on a clean
    connection but does NOT re-issue — the command may have executed,
    and re-issuing a destructive read (RPOP) would pop, and lose, a
    second batch; the timeout surfaces to the caller instead."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 10.0, reconnect: bool = True,
                 delim: str = ",", counters=None, stamp: bool = True):
        self.host, self.port = host, int(port)
        self.timeout = float(timeout)
        self._reconnect = bool(reconnect)
        self._rpop_count_ok = True
        # LEASE/ACKPUSH are this broker's verbs; against a real Redis
        # (or a pre-lease server) the first -ERR permanently falls back
        # to the destructive rpop/lpush path — same pattern as
        # _rpop_count_ok
        self._lease_ok = True
        self._ackpush_ok = True
        # request-trace stamping: with ps.trace.sample set,
        # every Nth predict push gets the wire trace field at THIS
        # client.  ``stamp=False`` is for inner clients whose owner
        # already stamped; ``delim`` is the wire field separator.
        self._delim = delim
        self._stamp = bool(stamp)
        # reconnect observability: tally + trace instant per reconnect,
        # so a silent reconnect storm shows up in scrapes and timelines
        # instead of only as stderr warnings
        self.counters = counters
        self.reconnects = 0
        self._sock = None
        self._rf = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        # request/reply round trips are small packets; Nagle would add
        # 40ms stalls to every serving poll
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rf = self._sock.makefile("rb")

    def _reconnect_once(self, why: BaseException) -> None:
        """Drop the poisoned half-connection and re-establish — the
        connect itself tried 4 times with exponential backoff from 0.05 s;
        raises the last connect failure when the server stays
        unreachable."""
        try:
            if self._rf is not None:
                self._rf.close()
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        for attempt in range(_RECONNECT_ATTEMPTS):
            try:
                self._connect()
                break
            except OSError:
                if attempt == _RECONNECT_ATTEMPTS - 1:
                    raise
                time.sleep(_RECONNECT_BASE_S * 2 ** attempt)
        self.reconnects += 1
        if self.counters is not None:
            self.counters.increment("Broker", "Reconnects")
        instant("broker.reconnect", cat="broker",
                endpoint=f"{self.host}:{self.port}",
                attempt=self.reconnects,
                cause=f"{type(why).__name__}: {why}")
        warnings.warn(
            f"respq: connection to {self.host}:{self.port} dropped "
            f"({type(why).__name__}: {why}); reconnected",
            RuntimeWarning)

    def _recover(self, exc: BaseException) -> None:
        """Shared reconnect policy for a failed command exchange:
        re-establish the connection, then decide whether the caller may
        re-issue.  A TIMEOUT means the server may be alive and may have
        EXECUTED the command — re-issuing a destructive read would pop
        (and lose) a second batch — so the fresh connection is kept for
        the NEXT call and the timeout re-raises.  A hard drop
        re-establishes and returns (the caller re-issues once)."""
        if not self._reconnect:
            raise exc
        if isinstance(exc, socket.timeout):
            try:
                self._reconnect_once(exc)
            except OSError:
                pass   # surface the original timeout, not the connect
            raise exc
        self._reconnect_once(exc)

    def _call(self, *args: str):
        return self._call_raw(_encode_command(list(args)))

    def _call_raw(self, payload: bytes):
        """One command exchange from an already-encoded RESP buffer —
        the native reply encoder (io/native_wire.encode_lpush) lands
        here so a whole batch of replies is ONE sendall; same
        reconnect/re-issue policy as :meth:`_call`."""
        try:
            self._sock.sendall(payload)
            return _read_reply(self._rf)
        except (ConnectionError, OSError) as exc:
            self._recover(exc)   # raises unless a re-issue is safe
            self._sock.sendall(payload)
            return _read_reply(self._rf)

    def ping(self) -> bool:
        return self._call("PING") == "PONG"

    def lpush(self, queue: str, value: str) -> int:
        # enabled() gate first: sampling off must stay allocation-free
        # on the per-request push path (no temp list, no call into
        # stamp_values)
        if self._stamp and reqtrace.enabled():
            value = reqtrace.stamp_values(
                [value], delim=self._delim,
                broker=f"{self.host}:{self.port}")[0]
        return int(self._call("LPUSH", queue, value))

    def lpush_many(self, queue: str, values: List[str]) -> int:
        """Push ``values`` as ONE variadic LPUSH (n round trips collapse
        to one — the producer half of the wire micro-batching).  Returns
        the queue length after the push; no-op 0 on an empty list.
        Predict messages pass the head-sampling stamp (one global read
        when ``ps.trace.sample`` is off).

        The command buffer is built by the native codec when available
        (one C pass over the batch instead of a python loop of
        per-value bulk-string encodes) — byte-identical to
        ``_encode_command`` by the golden/fuzz contract, and None from
        the encoder (no toolchain, embedded join byte) falls back to
        the python encode of the SAME values."""
        if not values:
            return 0
        if self._stamp:
            values = reqtrace.stamp_values(
                values, delim=self._delim,
                broker=f"{self.host}:{self.port}")
        payload = native_wire.encode_lpush(queue, values)
        if payload is not None:
            return int(self._call_raw(payload))
        return int(self._call("LPUSH", queue, *values))

    def rpop(self, queue: str) -> Optional[str]:
        return self._call("RPOP", queue)

    def brpop(self, queue: str, timeout_s: float = 0.05) -> Optional[str]:
        """Blocking pop: park on the server until a value arrives or
        ``timeout_s`` lapses (fractional seconds; None on timeout) — the
        idle half of the fleet drain, so N parked workers cost the host
        nothing instead of N spin-polling cores.  ``timeout_s`` must be
        positive and stay under the client socket timeout — ENFORCED,
        not just documented: a park outliving the socket timeout would
        hit the reconnect path mid-BRPOP, and the abandoned server-side
        waiter could pop (and lose) the next pushed value.  Poll in a
        loop for long parks."""
        if not 0.0 < float(timeout_s) < self.timeout:
            raise ValueError(
                f"brpop timeout_s must be in (0, {self.timeout}) — the "
                f"client socket timeout; got {timeout_s!r}.  Park in a "
                f"loop for longer waits")
        reply = self._call("BRPOP", queue, repr(float(timeout_s)))
        if reply is None:
            return None
        return reply[1]   # [key, value]

    def rpop_many(self, queue: str, n: int) -> List[str]:
        """Drain up to ``n`` values in ONE round trip.  Prefers the
        Redis >= 6.2 ``RPOP key count`` form (one command, one array
        reply — the server parses n commands' worth of work once); falls
        back permanently to PIPELINED single RPOPs (one socket write
        carrying n commands) the first time the server rejects the count
        argument (real pre-6.2 Redis).  Returns the non-nil values in
        queue order; may be shorter than n."""
        if n <= 0:
            return []
        if self._rpop_count_ok:
            try:
                reply = self._call("RPOP", queue, str(n))
            except RuntimeError:
                # old server: remember and fall back to pipelining
                self._rpop_count_ok = False
            else:
                return [] if reply is None else list(reply)
        try:
            return self._pipelined_rpops(queue, n)
        except (ConnectionError, OSError) as exc:
            # same reconnect contract as _call (timeouts re-raise: the
            # burst may have executed); on a hard drop the whole
            # pipelined burst re-issues against the fresh connection
            self._recover(exc)
            return self._pipelined_rpops(queue, n)

    def _pipelined_rpops(self, queue: str, n: int) -> List[str]:
        self._sock.sendall(
            b"".join(_encode_command(["RPOP", queue]) for _ in range(n)))
        out: List[str] = []
        first_err: Optional[RuntimeError] = None
        for _ in range(n):
            try:
                v = _read_reply(self._rf)
            except RuntimeError as exc:
                # a -ERR reply is one consumed line; keep reading the
                # remaining pipelined replies or the connection would
                # desynchronize (the next command's _call would read a
                # stale RPOP reply as its own answer)
                first_err = first_err or exc
                continue
            if v is not None:
                out.append(v)
        if first_err is not None:
            raise first_err
        return out

    def lease_many(self, queue: str, n: int, lease_s: float,
                   block_s: float = 0.0) -> List[str]:
        """Acquire up to ``n`` values under a visibility-timeout lease
        (``LEASE``) — the at-least-once replacement for
        :meth:`rpop_many`: a worker that dies before acking gets its
        values redelivered after ``lease_s``.  ``block_s > 0`` parks on
        the server like BRPOP (must stay under the socket timeout).

        Unlike a destructive read, a LEASE is SAFE to re-issue after a
        connection drop: values the lost exchange leased simply expire
        and redeliver.  Against a server without the verb (real Redis)
        this falls back permanently to ``rpop_many`` (+ ``brpop`` for
        the park) — delivery is then destructive, as before."""
        if n <= 0:
            return []
        if block_s > 0 and not block_s < self.timeout:
            raise ValueError(
                f"lease_many block_s must stay under the client socket "
                f"timeout ({self.timeout}); got {block_s!r}")
        if self._lease_ok:
            try:
                reply = self._call("LEASE", queue, str(int(n)),
                                   repr(float(lease_s)),
                                   repr(float(block_s)), self._delim)
            except RuntimeError:
                self._lease_ok = False
            else:
                return [] if reply is None else list(reply)
        vals = self.rpop_many(queue, n)
        if vals or block_s <= 0:
            return vals
        v = self.brpop(queue, block_s)
        return [] if v is None else [v]

    def ackpush(self, push_queue: str, ack_queue: str,
                values: List[str]) -> int:
        """Push a reply batch AND ack the leases its request ids hold on
        ``ack_queue`` — ONE round trip (``ACKPUSH``), so the ack
        piggybacks on the reply push the worker already makes.  Replies
        for already-answered ids are dropped server-side (first wins).
        Safe to re-issue after a drop: a double-delivered ack batch
        dedups on the answered set.  Falls back permanently to plain
        :meth:`lpush_many` (no ack, no dedup) against a server without
        the verb."""
        if not values:
            return 0
        if self._ackpush_ok:
            try:
                return int(self._call("ACKPUSH", push_queue, ack_queue,
                                      self._delim, *values))
            except RuntimeError:
                self._ackpush_ok = False
        return self.lpush_many(push_queue, values)

    def llen(self, queue: str) -> int:
        return int(self._call("LLEN", queue))

    def info(self, *queues: str) -> Dict[str, int]:
        """Per-queue depths via the ``INFO`` command — observable WITHOUT
        popping (the autoscaler's queue-depth sensor and operator depth
        probes).  Returns ``{queue: depth}``; all queues by default, the
        named ones when given.  Against a real Redis (whose INFO reports
        server stats, not queue depths) the dict is empty — callers fall
        back to :meth:`llen` per queue."""
        reply = self._call("INFO", *queues)
        out: Dict[str, int] = {}
        for line in (reply or "").splitlines():
            if line.startswith("queue_depth:"):
                key, _, depth = line[len("queue_depth:"):].rpartition("=")
                try:
                    out[key] = int(depth)
                except ValueError:
                    continue
        return out

    def delete(self, *queues: str) -> int:
        return int(self._call("DEL", *queues))

    def close(self) -> None:
        try:
            self._rf.close()
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# sharded broker client
# ---------------------------------------------------------------------------

def _hash64(key: str) -> int:
    """Stable 64-bit ring hash (md5 head): identical placement in every
    process and across runs — python's builtin hash() is seed-randomized
    per process, which would put each fleet host on a DIFFERENT ring."""
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


Endpoint = Union[str, Tuple[str, int]]


def _norm_endpoint(ep: Endpoint) -> str:
    if isinstance(ep, str):
        return ep
    host, port = ep
    return f"{host}:{int(port)}"


class HashRing:
    """Consistent-hash ring over broker endpoints, ``replicas`` virtual
    nodes each.  The property the shard tier leans on: removing (or
    adding) one of M endpoints remaps only the ids that hashed TO it
    (~1/M of the key space) — every surviving assignment stays put, so a
    shard death never reshuffles the whole fleet's queues."""

    __slots__ = ("endpoints", "replicas", "_hashes", "_owners")

    def __init__(self, endpoints: Sequence[str], replicas: int = 64):
        self.endpoints = [_norm_endpoint(e) for e in endpoints]
        if len(set(self.endpoints)) != len(self.endpoints):
            raise ValueError(f"duplicate broker endpoints: {self.endpoints}")
        self.replicas = int(replicas)
        points = sorted((_hash64(f"{ep}#{r}"), ep)
                        for ep in self.endpoints
                        for r in range(self.replicas))
        self._hashes = [h for h, _ in points]
        self._owners = [ep for _, ep in points]

    def lookup(self, key: str) -> str:
        """The endpoint owning ``key`` (first ring point clockwise)."""
        if not self._owners:
            raise RuntimeError("broker ring is empty (every shard down)")
        i = bisect.bisect_right(self._hashes, _hash64(str(key)))
        return self._owners[i % len(self._owners)]

    def without(self, endpoint: str) -> "HashRing":
        return HashRing([e for e in self.endpoints if e != endpoint],
                        self.replicas)


class ShardedRespClient:
    """One client over M RESP broker shards: consistent-hash fan-out.

    Request ids route by :class:`HashRing` lookup, so a request
    (``predict,<id>,...``) and its reply (``<id>,<label>``) land on the
    SAME shard and a collector simply fans ``rpop_many`` across the ring
    and reassembles by id.  Per-shard pipelining everywhere: one
    variadic LPUSH per shard per push batch, one RPOP-count (or
    pipelined) drain per shard per poll.

    Degraded-ring semantics: a shard whose connection fails (after the
    underlying :class:`RespClient`'s own reconnect attempt) is marked
    down with a structured warning and a ``Broker/BrokerShardDown``
    counter, and the ring shrinks to the survivors — values from the
    failed push are RE-ROUTED onto the surviving shards, never dropped.
    Messages already queued inside the dead shard's memory are the
    producer's re-offer window (unanswered ids get re-sent — the bench's
    killed-shard protocol).  When the LAST shard dies the client raises:
    there is nowhere left to degrade to.

    Like :class:`RespClient`, not thread-safe — one instance per thread
    (each fleet worker owns its own)."""

    def __init__(self, endpoints: Sequence[Endpoint],
                 timeout: float = 10.0, replicas: int = 64,
                 delim: str = ",", counters=None):
        eps = [_norm_endpoint(e) for e in endpoints]
        if not eps:
            raise ValueError("need at least one broker endpoint")
        self._delim = delim
        self._timeout = float(timeout)
        self.counters = counters
        self._clients: Dict[str, RespClient] = {}
        self._down: List[str] = []
        # rid -> endpoint it was LEASED from, so the piggybacked ack
        # reaches the shard actually holding the lease even after ring
        # membership changed in between; bounded first-in first-evicted
        # (an evicted entry just means the ack routes by ring lookup
        # and the lease expires into a redelivery — dedup absorbs it)
        self._lease_src: "OrderedDict[str, str]" = OrderedDict()
        self._lease_src_cap = 65536
        # a down shard is probed for REJOIN at most once per interval:
        # the kill-and-restart drill needs the restarted shard (journal
        # replayed) to re-enter the ring without rebuilding every client
        self.rejoin_interval_s = 1.0
        self._last_rejoin = 0.0
        live: List[str] = []
        first_err: Optional[BaseException] = None
        for ep in eps:
            host, _, port = ep.rpartition(":")
            try:
                # inner clients do NOT stamp: the ring stamps per push
                # group below, where the owning shard is known
                self._clients[ep] = RespClient(host or "127.0.0.1",
                                               int(port), timeout=timeout,
                                               delim=delim,
                                               counters=counters,
                                               stamp=False)
            except OSError as exc:
                first_err = first_err or exc
                self._note_down(ep, exc)
            else:
                live.append(ep)
        if not live:
            raise ConnectionError(
                f"no broker shard reachable out of {eps}") from first_err
        self._ring = HashRing(live, replicas=replicas)
        self._rr = 0   # rotating start index: fair drain across shards

    # ---- ring state ----
    @property
    def live_endpoints(self) -> List[str]:
        return list(self._ring.endpoints)

    @property
    def down_endpoints(self) -> List[str]:
        return list(self._down)

    def shard_of(self, request_id: str) -> str:
        """Which live shard owns ``request_id`` (tests + operators)."""
        return self._ring.lookup(request_id)

    def id_of(self, value: str) -> str:
        """The routing id of a wire message: ``predict,<id>,...`` and
        ``reward,<id>,<value>`` route by the id field — a reward MUST
        land on the shard holding the request it rewards, or the
        online learner draining that shard never joins them — anything
        else (a reply ``<id>,<label>``, a control word) by its first
        field."""
        parts = value.split(self._delim, 2)
        if parts[0] in ("predict", "reward") and len(parts) > 1:
            return parts[1]
        if parts[0].startswith("reward:"):
            # a reward-ack token (``reward:<id>,acked``) must chase the
            # shard that leased ``reward,<id>,...`` — i.e. <id>'s shard
            return parts[0][len("reward:"):]
        return parts[0]

    def _note_down(self, ep: str, exc: BaseException) -> None:
        self._down.append(ep)
        if self.counters is not None:
            self.counters.increment("Broker", "BrokerShardDown")
        survivors = sum(1 for e in self._clients if e != ep)
        instant("broker.shard_down", cat="broker", endpoint=ep,
                cause=f"{type(exc).__name__}: {exc}",
                survivors=survivors)
        warnings.warn(
            f"broker: shard {ep} down ({type(exc).__name__}: {exc}); "
            f"degrading to the surviving ring ({survivors} shard(s) "
            f"left)", RuntimeWarning)

    def _mark_down(self, ep: str, exc: BaseException) -> None:
        """Shrink the ring past a dead shard; raises when it was the
        last one (nowhere to degrade to)."""
        if ep not in self._clients:
            return
        self._note_down(ep, exc)
        cli = self._clients.pop(ep)
        try:
            cli.close()
        except OSError:
            pass
        self._ring = self._ring.without(ep)
        if not self._ring.endpoints:
            raise ConnectionError(
                f"broker: last shard {ep} is down "
                f"({type(exc).__name__}: {exc})") from exc

    def _maybe_rejoin(self) -> None:
        """Probe down shards (rate-limited) and fold a revived one back
        into the ring — the client half of the killed-and-restarted
        shard drill: a shard that came back with its journal replayed
        re-owns its id range (consistent hashing: only ids that hashed
        to it move back; every surviving assignment stays put)."""
        if not self._down:
            return
        now = time.monotonic()
        # rate-limited while the ring still has survivors; when EVERY
        # shard is down there is nothing left to throttle for — probe
        # on every verb so a restarted shard is folded back the moment
        # it binds (the fleet's broker-outage grace retry depends on
        # this to recover from a total ring loss)
        if self._ring.endpoints and \
                now - self._last_rejoin < self.rejoin_interval_s:
            return
        self._last_rejoin = now
        for ep in list(self._down):
            host, _, port = ep.rpartition(":")
            try:
                cli = RespClient(host or "127.0.0.1", int(port),
                                 timeout=self._timeout, delim=self._delim,
                                 counters=self.counters, stamp=False)
            except OSError:
                continue
            self._down.remove(ep)
            self._clients[ep] = cli
            self._ring = HashRing(self._ring.endpoints + [ep],
                                  replicas=self._ring.replicas)
            if self.counters is not None:
                self.counters.increment("Broker", "BrokerShardUp")
            instant("broker.shard_up", cat="broker", endpoint=ep,
                    survivors=len(self._ring.endpoints))
            warnings.warn(
                f"broker: shard {ep} is back; rejoined the ring "
                f"({len(self._ring.endpoints)} shard(s) live)",
                RuntimeWarning)

    def _note_leased(self, values: List[str], ep: str) -> None:
        for v in values:
            rid = _lease_rid(v, self._delim)
            if rid is not None:
                self._lease_src[rid] = ep
        while len(self._lease_src) > self._lease_src_cap:
            self._lease_src.popitem(last=False)

    # ---- fan-out verbs ----
    def ping(self) -> bool:
        """True when every LIVE shard answers PONG.  Like every other
        fan-out verb, a shard failing the probe degrades the ring
        (warning + counter) instead of crashing the caller — a liveness
        probe that raises on exactly the condition it probes for would
        be useless; the last shard dying still raises."""
        self._maybe_rejoin()
        ok = True
        for ep in self.live_endpoints:
            if ep not in self._clients:
                continue
            try:
                ok = self._clients[ep].ping() and ok
            except (ConnectionError, OSError) as exc:
                self._mark_down(ep, exc)
                ok = False
        return ok

    def lpush(self, queue: str, value: str) -> int:
        return self.lpush_many(queue, [value])

    def lpush_many(self, queue: str, values: List[str]) -> int:
        """Push a batch: group by owning shard, ONE variadic LPUSH per
        shard.  A shard failing mid-push degrades the ring and its
        group re-routes onto the survivors (accepted values are never
        dropped by the client).  Returns the summed post-push depth of
        the touched shards."""
        self._maybe_rejoin()
        total = 0
        pending = list(values)
        while pending:
            groups: Dict[str, List[str]] = {}
            for v in pending:
                groups.setdefault(self._ring.lookup(self.id_of(v)),
                                  []).append(v)
            pending = []
            for ep, vals in groups.items():
                # head-sampling stamp AFTER routing, so the flow start
                # names the owning shard; a re-route keeps the original
                # stamp (the field-present check makes re-stamping a
                # no-op) — the enqueue time is the FIRST offer
                vals = reqtrace.stamp_values(vals, delim=self._delim,
                                             broker=ep)
                try:
                    total += self._clients[ep].lpush_many(queue, vals)
                except (ConnectionError, OSError) as exc:
                    self._mark_down(ep, exc)   # raises when ring empties
                    pending.extend(vals)       # re-route on the new ring
        return total

    def broadcast(self, queue: str, value: str) -> int:
        """Push ``value`` onto EVERY live shard (control fan-out: a
        'reload' must be seen whichever shard a fleet drains first).
        Returns how many shards accepted it."""
        n = 0
        for ep in self.live_endpoints:
            try:
                self._clients[ep].lpush(queue, value)
                n += 1
            except (ConnectionError, OSError) as exc:
                self._mark_down(ep, exc)
        return n

    def rpop(self, queue: str) -> Optional[str]:
        vs = self.rpop_many(queue, 1)
        return vs[0] if vs else None

    def rpop_many(self, queue: str, n: int) -> List[str]:
        """Drain up to ``n`` values across the ring: pipelined
        ``rpop_many`` per shard, visiting shards from a rotating start
        index so one busy shard cannot starve the others.  A failing
        shard degrades the ring; the poll continues on the survivors."""
        if n <= 0:
            return []
        self._maybe_rejoin()
        out: List[str] = []
        eps = self.live_endpoints
        self._rr += 1
        start = self._rr
        for i in range(len(eps)):
            ep = eps[(start + i) % len(eps)]
            if ep not in self._clients:
                continue
            try:
                out.extend(self._clients[ep].rpop_many(queue, n - len(out)))
            except (ConnectionError, OSError) as exc:
                self._mark_down(ep, exc)
            if len(out) >= n:
                break
        return out

    def lease_many(self, queue: str, n: int, lease_s: float,
                   block_s: float = 0.0) -> List[str]:
        """Lease up to ``n`` values across the ring: one non-blocking
        LEASE sweep from a rotating start, then (idle + ``block_s``) a
        blocking LEASE on ONE rotating shard — the at-least-once drain.
        Records which shard leased each id so the piggybacked ack
        (:meth:`ackpush`) routes back to the lease holder."""
        if n <= 0:
            return []
        self._maybe_rejoin()
        out: List[str] = []
        eps = self.live_endpoints
        self._rr += 1
        start = self._rr
        for i in range(len(eps)):
            ep = eps[(start + i) % len(eps)]
            cli = self._clients.get(ep)
            if cli is None:
                continue
            try:
                got = cli.lease_many(queue, n - len(out), lease_s)
            except (ConnectionError, OSError) as exc:
                self._mark_down(ep, exc)
                continue
            self._note_leased(got, ep)
            out.extend(got)
            if len(out) >= n:
                break
        if out or block_s <= 0:
            return out
        eps = self.live_endpoints
        if not eps:
            raise RuntimeError("broker ring is empty (every shard down)")
        self._rr += 1
        ep = eps[self._rr % len(eps)]
        cli = self._clients.get(ep)
        if cli is None:
            return []
        try:
            got = cli.lease_many(queue, n, lease_s, block_s)
        except (ConnectionError, OSError) as exc:
            self._mark_down(ep, exc)
            return []
        self._note_leased(got, ep)
        return got

    def ackpush(self, push_queue: str, ack_queue: str,
                values: List[str]) -> int:
        """Reply push + lease ack, grouped by the shard each id was
        LEASED from (falling back to ring lookup when unknown).  A
        shard failing mid-ack degrades the ring and its replies
        re-route to the survivors — the reply is never dropped; the
        orphaned lease expires into a redelivery that the answered-set
        (or the consumer-side :func:`dedup_replies`) absorbs."""
        if not values:
            return 0
        self._maybe_rejoin()
        total = 0
        pending = list(values)
        while pending:
            groups: Dict[str, List[str]] = {}
            for v in pending:
                rid = v.split(self._delim, 1)[0]
                ep = self._lease_src.get(rid)
                if ep is None or ep not in self._clients:
                    ep = self._ring.lookup(self.id_of(v))
                groups.setdefault(ep, []).append(v)
            pending = []
            for ep, vals in groups.items():
                try:
                    total += self._clients[ep].ackpush(
                        push_queue, ack_queue, vals)
                except (ConnectionError, OSError) as exc:
                    self._mark_down(ep, exc)   # raises when ring empties
                    pending.extend(vals)
                else:
                    for v in vals:
                        self._lease_src.pop(
                            v.split(self._delim, 1)[0], None)
        return total

    def brpop(self, queue: str, timeout_s: float = 0.05) -> Optional[str]:
        """Park-when-idle over the ring: one non-blocking sweep first,
        then a real BRPOP on ONE rotating shard for the timeout.  A
        value landing on a different shard during the park is picked up
        at the next poll — bounded by ``timeout_s``, which the fleet
        keeps in the low milliseconds."""
        self._maybe_rejoin()
        vs = self.rpop_many(queue, 1)
        if vs:
            return vs[0]
        eps = self.live_endpoints
        if not eps:
            raise RuntimeError("broker ring is empty (every shard down)")
        self._rr += 1
        ep = eps[self._rr % len(eps)]
        try:
            return self._clients[ep].brpop(queue, timeout_s)
        except (ConnectionError, OSError) as exc:
            self._mark_down(ep, exc)
            return None

    def llen(self, queue: str) -> int:
        """Summed depth across the live ring (down shards excluded)."""
        total = 0
        for ep in self.live_endpoints:
            if ep not in self._clients:
                continue
            try:
                total += self._clients[ep].llen(queue)
            except (ConnectionError, OSError) as exc:
                self._mark_down(ep, exc)
        return total

    def depths(self, *queues: str) -> Dict[str, Dict[str, int]]:
        """Per-shard per-queue depths via INFO (no popping):
        ``{endpoint: {queue: depth}}`` — the observable the autoscaler
        sensor and the killed-shard bench read."""
        self._maybe_rejoin()
        out: Dict[str, Dict[str, int]] = {}
        for ep in self.live_endpoints:
            if ep not in self._clients:
                continue
            try:
                out[ep] = self._clients[ep].info(*queues)
            except (ConnectionError, OSError) as exc:
                self._mark_down(ep, exc)
        return out

    def delete(self, *queues: str) -> int:
        n = 0
        for ep in self.live_endpoints:
            if ep not in self._clients:
                continue
            try:
                n += self._clients[ep].delete(*queues)
            except (ConnectionError, OSError) as exc:
                self._mark_down(ep, exc)
        return n

    def close(self) -> None:
        for cli in self._clients.values():
            cli.close()
        self._clients.clear()


def make_queue_client(config: Optional[Dict] = None, delim: str = ",",
                      counters=None
                      ) -> Union[RespClient, ShardedRespClient]:
    """Build the right client for a serving config: the plain
    :class:`RespClient` for one ``redis.server.host``/``port``, the
    :class:`ShardedRespClient` when ``redis.server.endpoints`` lists a
    ring (list of ``host:port`` / ``(host, port)``, or one
    comma-separated string).  The single-endpoint path stays the plain
    client on purpose — no ring hashing on the hot path when there is
    nothing to shard."""
    cfg = dict(config or {})
    endpoints = cfg.get("redis.server.endpoints")
    if endpoints:
        if isinstance(endpoints, str):
            endpoints = [e.strip() for e in endpoints.split(",")
                         if e.strip()]
        endpoints = [_norm_endpoint(e) for e in endpoints]
        if len(endpoints) > 1:
            return ShardedRespClient(endpoints, delim=delim,
                                     counters=counters)
        host, _, port = endpoints[0].rpartition(":")
        return RespClient(host or "127.0.0.1", int(port), delim=delim,
                          counters=counters)
    return RespClient(cfg.get("redis.server.host", "127.0.0.1"),
                      int(cfg.get("redis.server.port", 6379)),
                      delim=delim, counters=counters)
