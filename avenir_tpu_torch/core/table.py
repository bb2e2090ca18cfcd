"""Columnar dataset: CSV text -> encoded numpy arrays.

The port's copy of ``avenir_tpu/core/table.py``, trimmed to what the forest,
the monitor baseline and KNN read: a dataset is a struct of columns, each
encoded once on load:

  * categorical columns  -> int32 vocabulary codes (schema cardinality order;
    unknown values -> -1)
  * numeric columns      -> float64 values
  * id/string columns    -> kept host-side as python lists (never on device)

Only the pure-Python parse is here; the native CSV reader and the
columnar cache are not ported yet.  :class:`BadRecordPolicy` is the
reference's malformed-record handling (fail, skip, quarantine), applied by
the monolithic load (``load_csv(..., bad_records=)``) and per block by the
chunked reader.

The streamed ingest's host stages live here too: :func:`iter_csv_chunks`
yields the CSV as encoded row blocks (each reporting its
``source_row_end``, the checkpoint/resume axis), :func:`prefetch_chunks`
runs a block source on a producer thread behind a bounded queue, and
:func:`stage_chunks` is the same pipeline with a staging function (host
encode + upload to the device) on its own thread.
"""

from __future__ import annotations

import io
import os
import re
import threading
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .faults import fault_point, with_retry
from .metrics import Counters
from .schema import FeatureSchema


# --------------------------------------------------------------------------
# bad-record policy (Hadoop skip-bad-records)
# --------------------------------------------------------------------------

@dataclass
class BadRecordPolicy:
    """What to do with a malformed CSV record (a short row, or a numeric
    field that fails to parse; unknown categorical values encode as -1 and
    are NOT malformed):

      * ``fail``        — raise, killing the job
      * ``skip``        — drop the record, count it
      * ``quarantine``  — drop the record, count it, and append its raw
        line to ``<quarantine_path>/part-q-00000``

    Counters land in the Hadoop-style ``BadRecords`` group: ``Malformed``
    (total seen), ``Skipped``, ``Quarantined``."""

    policy: str = "fail"
    quarantine_path: Optional[str] = None
    counters: Optional[Counters] = None
    n_bad: int = 0
    # the quarantine dir is made once, not per appended record
    _qdir_ready: bool = dc_field(default=False, repr=False, compare=False)

    POLICIES = ("fail", "skip", "quarantine")

    def __post_init__(self):
        if self.policy not in self.POLICIES:
            raise ValueError(f"badrecords.policy must be one of "
                             f"{self.POLICIES}, got {self.policy!r}")
        if self.policy == "quarantine" and not self.quarantine_path:
            raise ValueError("badrecords.policy=quarantine needs a "
                             "quarantine path")

    @property
    def skips(self) -> bool:
        return self.policy in ("skip", "quarantine")

    def quarantine_file(self) -> str:
        if not self._qdir_ready:
            os.makedirs(self.quarantine_path, exist_ok=True)
            self._qdir_ready = True
        return os.path.join(self.quarantine_path, "part-q-00000")

    def record(self, lines: Sequence[str],
               src_rows: Optional[Sequence[int]] = None) -> None:
        """Report (and for quarantine, persist) a batch of malformed raw
        lines.  Appends, so resumed runs accumulate into one part file.
        The quarantine write happens first (one write, through
        ``with_retry`` and the ``artifact_write`` fault point) and the
        counters move only after it succeeded: a failed write that gets
        retried must not have inflated the tallies already.  Reporting
        is at-least-once across crash and resume: records between the
        last checkpoint and a crash are reported again when the resumed
        stream re-reads them.

        ``src_rows`` (parallel to ``lines``) carries each record's source
        row index; this policy ignores it (the reference's columnar cache,
        not ported, persists it)."""
        n = len(lines)
        if n == 0:
            return
        if self.policy == "quarantine":
            path = self.quarantine_file()
            payload = "".join(line + "\n" for line in lines)

            def write():
                fault_point("artifact_write")
                with open(path, "a") as fh:
                    fh.write(payload)
            with_retry(write, what=f"quarantine append to {path}")
            if self.counters is not None:
                self.counters.increment("BadRecords", "Quarantined", n)
        self.n_bad += n
        if self.counters is not None:
            self.counters.increment("BadRecords", "Malformed", n)
            self.counters.increment("BadRecords", "Skipped", n)


def _bad_row_checker(schema: FeatureSchema):
    """Per-row malformedness test: a short row (any schema field's ordinal
    missing) or a numeric field that fails ``float()``."""
    need = max((f.ordinal for f in schema.fields), default=-1)
    numeric_ords = [f.ordinal for f in schema.fields if f.is_numeric]

    def bad(r: List[str]) -> bool:
        if len(r) <= need:
            return True
        for o in numeric_ords:
            try:
                float(r[o])
            except (TypeError, ValueError):
                return True
        return False
    return bad


@dataclass
class ColumnarTable:
    schema: FeatureSchema
    n_rows: int
    # ordinal -> encoded column; int32 codes for categorical, float64 for numeric
    columns: Dict[int, np.ndarray]
    # ordinal -> raw string column for id/string/text fields (host side)
    str_columns: Dict[int, List[str]] = dc_field(default_factory=dict)
    # raw tokenized rows, kept only when the caller needs record echo in outputs
    raw_rows: Optional[List[List[str]]] = None

    def class_codes(self) -> np.ndarray:
        return self.columns[self.schema.class_attr_field.ordinal]

    def take_rows(self, lo: int, hi: int) -> "ColumnarTable":
        """Contiguous row slice [lo, hi) as a new table: encoded columns
        are numpy views, string columns materialize the slice."""
        return ColumnarTable(
            schema=self.schema, n_rows=hi - lo,
            columns={k: v[lo:hi] for k, v in self.columns.items()},
            str_columns={k: v[lo:hi] for k, v in self.str_columns.items()},
            raw_rows=self.raw_rows[lo:hi] if self.raw_rows is not None
            else None)

    @classmethod
    def from_chunks(cls, chunks: Sequence["ColumnarTable"]
                    ) -> "ColumnarTable":
        """Assemble contiguous row blocks (same schema, in row order) into
        one table — the inverse of chunked ingest.  Encoded and string
        columns concatenate, so the result equals loading the whole file
        at once."""
        chunks = list(chunks)
        if not chunks:
            raise ValueError("from_chunks needs at least one chunk")
        columns = {o: np.concatenate([c.columns[o] for c in chunks])
                   for o in chunks[0].columns}
        str_columns = {o: [v for c in chunks for v in c.str_columns[o]]
                       for o in chunks[0].str_columns}
        raw = None
        if all(c.raw_rows is not None for c in chunks):
            raw = [r for c in chunks for r in c.raw_rows]
        return cls(schema=chunks[0].schema,
                   n_rows=sum(c.n_rows for c in chunks), columns=columns,
                   str_columns=str_columns, raw_rows=raw)

    def binned_codes(self, ordinal: int) -> np.ndarray:
        """int32 bin codes in [0, num_bins) for a binned field (categorical code
        or value // bucketWidth - bin_offset)."""
        f = self.schema.find_field_by_ordinal(ordinal)
        col = self.columns[ordinal]
        if f.is_categorical:
            return col.astype(np.int32)
        if f.bucket_width is None:
            raise ValueError(f"field {ordinal} has no finite bin alphabet")
        return (col // f.bucket_width).astype(np.int32) - f.bin_offset


def _make_splitter(delim_regex: str):
    """ONE line-splitter for every parse path: literal fast path when the
    regex is a plain string, compiled re.split otherwise."""
    if re.escape(delim_regex) == delim_regex:
        return lambda line: line.split(delim_regex)
    return re.compile(delim_regex).split


def _tokenize(text: str, delim_regex: str) -> List[List[str]]:
    """Split lines on the reference's field.delim.regex (usually a plain ',')."""
    split = _make_splitter(delim_regex)
    return [split(line) for line in text.splitlines() if line.strip()]


# Contract: categorical values are trimmed of exactly these six ASCII
# whitespace bytes (not unicode whitespace) before vocab lookup — the same
# contract as the JAX package's encoders.
CATEGORICAL_TRIM = " \t\r\n\v\f"


def encode_rows(rows: List[List[str]], schema: FeatureSchema,
                keep_raw: bool = False) -> ColumnarTable:
    """Encode tokenized rows into a ColumnarTable per the schema:
    categorical -> ``vocab.get(value.strip(CATEGORICAL_TRIM), -1)`` int32,
    numeric -> ``float(value)`` float64, everything else a host string
    column; a short row (any schema ordinal missing) raises."""
    n = len(rows)
    columns: Dict[int, np.ndarray] = {}
    str_columns: Dict[int, List[str]] = {}
    for f in schema.fields:
        o = f.ordinal
        if f.is_categorical:
            vocab = {v: i for i, v in enumerate(f.cardinality or [])}
            columns[o] = np.fromiter(
                (vocab.get(r[o].strip(CATEGORICAL_TRIM), -1) for r in rows),
                dtype=np.int32, count=n)
        elif f.is_numeric:
            columns[o] = np.fromiter((float(r[o]) for r in rows),
                                     dtype=np.float64, count=n)
        else:  # id / string / text: host side only
            str_columns[o] = [r[o] for r in rows]
    return ColumnarTable(schema=schema, n_rows=n, columns=columns,
                         str_columns=str_columns,
                         raw_rows=rows if keep_raw else None)


def load_csv(source: Union[str, io.TextIOBase], schema: FeatureSchema,
             delim_regex: str = ",", keep_raw: bool = False,
             bad_records: Optional[BadRecordPolicy] = None) -> ColumnarTable:
    """Load a CSV file (path or file object) into a ColumnarTable.
    ``bad_records`` with a skipping policy (skip/quarantine) drops
    malformed records instead of raising."""
    if isinstance(source, str):
        with open(source, "r") as fh:
            text = fh.read()
    else:
        text = source.read()
    return load_csv_text(text, schema, delim_regex, keep_raw=keep_raw,
                         bad_records=bad_records)


def load_csv_text(text: str, schema: FeatureSchema, delim_regex: str = ",",
                  keep_raw: bool = False,
                  bad_records: Optional[BadRecordPolicy] = None
                  ) -> ColumnarTable:
    """CSV text (one record a line; blank lines skipped) -> ColumnarTable.
    Under a skipping ``bad_records`` policy, malformed records
    (:func:`_bad_row_checker`) are dropped and reported after the encode
    succeeded; otherwise a malformed record raises."""
    if bad_records is None or not bad_records.skips:
        return encode_rows(_tokenize(text, delim_regex), schema,
                           keep_raw=keep_raw)
    split = _make_splitter(delim_regex)
    is_bad = _bad_row_checker(schema)
    rows: List[List[str]] = []
    bad_lines: List[str] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        r = split(line)
        if is_bad(r):
            bad_lines.append(line)
        else:
            rows.append(r)
    table = encode_rows(rows, schema, keep_raw=keep_raw)
    bad_records.record(bad_lines)  # side effects after the fallible encode
    return table


# --------------------------------------------------------------------------
# chunked / streaming ingest (the CSV -> device pipeline's host stages)
# --------------------------------------------------------------------------

def count_source_rows(path: str) -> int:
    """The SOURCE rows (non-blank lines) of a CSV: the denominator of the
    sharded ingest's split.  One streaming text pass, no tokenising."""
    n = 0
    with open(path, "r") as fh:
        for line in fh:
            if line.strip():
                n += 1
    return n


def iter_csv_chunks(path: str, schema: FeatureSchema,
                    delim_regex: str = ",", chunk_rows: int = 1 << 22,
                    bad_records: Optional[BadRecordPolicy] = None,
                    start_row: int = 0, shard=None,
                    stop_row: Optional[int] = None):
    """Yield a CSV as ColumnarTable row blocks of up to ``chunk_rows``
    well-formed rows — the parse stage of the streamed CSV -> device
    ingest.  The file is read line by line and host memory holds one
    encoded block at a time instead of the whole dataset; the blocks
    concatenate (:meth:`ColumnarTable.from_chunks`) to the table
    ``load_csv`` gives.

    ``bad_records`` applies the skip/quarantine policy per block: a
    block's malformed records are reported after it encoded, before it is
    yielded.  ``start_row`` restarts the stream at a SOURCE row index
    (non-blank line count) — the checkpoint/resume contract; every
    yielded chunk reports its own ``source_row_end`` on that axis.  Each
    block's encode passes the ``chunk_encode`` fault point.

    ``shard=(index, count)`` yields only that row-range shard of the
    source: split points from ``parallel.distributed.shard_rows`` over the
    source-row count (:func:`count_source_rows`, one cheap pass), on the
    ``chunk_rows`` grid, so the shards' streams together are the whole
    stream and each bad record is reported by exactly one shard.  It
    composes with ``start_row`` (a resumed shard restarts at the larger of
    its range's start and ``start_row``).  ``stop_row`` (exclusive, on the
    same axis) ends the stream early; it is what ``shard`` is built on,
    and passing both is refused.  This is the reference's python reader;
    its native reader and columnar cache are not ported."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    if start_row < 0:
        raise ValueError(f"start_row must be >= 0, got {start_row}")
    if shard is not None and stop_row is not None:
        raise ValueError("pass shard= or stop_row=, not both (shard "
                         "computes its own bounds)")
    skip_rows = int(start_row)
    stop = int(stop_row) if stop_row is not None else None
    if shard is not None:
        from ..parallel.distributed import shard_rows
        lo, stop = shard_rows(count_source_rows(path), int(shard[0]),
                              int(shard[1]), chunk_rows)
        skip_rows = max(skip_rows, lo)
    split = _make_splitter(delim_regex)
    skipping = bad_records is not None and bad_records.skips
    is_bad = _bad_row_checker(schema) if skipping else None
    rows: List[List[str]] = []
    bad_lines: List[str] = []
    bad_srcs: List[int] = []   # absolute 0-based source row per bad line
    consumed = 0   # non-blank source lines consumed, absolute
    block_idx = 0
    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\r\n")  # same record set as str.splitlines
            if not line.strip():        # for \n / \r\n terminated CSVs
                continue
            if stop is not None and consumed >= stop:
                break           # this line's 0-based source index
            consumed += 1
            if consumed <= skip_rows:
                continue
            r = split(line)
            if skipping and is_bad(r):
                bad_lines.append(line)
                bad_srcs.append(consumed - 1)
                continue
            rows.append(r)
            if len(rows) >= chunk_rows:
                fault_point("chunk_encode", block_idx)
                chunk = encode_rows(rows, schema)
                if bad_lines:
                    bad_records.record(bad_lines, src_rows=bad_srcs)
                    bad_lines, bad_srcs = [], []
                chunk.source_row_end = consumed
                yield chunk
                rows = []
                block_idx += 1
    if rows or bad_lines:
        fault_point("chunk_encode", block_idx)
        chunk = encode_rows(rows, schema) if rows else None
        if bad_lines:
            bad_records.record(bad_lines, src_rows=bad_srcs)
        if chunk is not None:
            chunk.source_row_end = consumed
            yield chunk


def prefetch_chunks(chunks, depth: int = 1, stats: Optional[dict] = None,
                    stage_fn=None, wait_key: str = "parse_s",
                    stage_key: str = "transfer_s",
                    consumer_wait_key: Optional[str] = "queue_wait_s",
                    thread_name: str = "avenir-ingest-prefetch"):
    """Run a chunk iterator on a background thread behind a bounded queue:
    the producer parses block i+1 while the consumer transfers or computes
    block i.  ``depth`` bounds the blocks in flight (memory = depth + 1
    blocks).

    ``stage_fn`` (optional) runs on every block IN THE PRODUCER THREAD
    after it is pulled from the source — the device-staging hook (see
    :func:`stage_chunks`).

    Phase accounting (``stats``; every key starts at 0.0):
      * ``stats[wait_key]`` (``parse_s``) — time pulling from the source
        (the parse, or the wait on an upstream prefetch layer);
      * ``stats[stage_key]`` (``transfer_s``) — time inside ``stage_fn``;
      * ``stats[consumer_wait_key]`` (``queue_wait_s``) — the consumer's
        blocking time on the queue: > 0 means the consumer outran the
        producer (parse/transfer-bound), ~0 that blocks were always ready.
        A layer that feeds another prefetch/stage layer passes
        ``consumer_wait_key=None``: the downstream producer already times
        its wait on this layer.

    A producer failure is re-raised on the consumer side in stream order,
    exactly once; the moment it happens the producer also sets
    ``stats['producer_error']`` (``"ExcType: message"``) and
    ``stats['producer_error_thread']``, so a crashed producer can be told
    from a slow one before the consumer drains the queue.  When the
    consumer abandons the generator, the producer stops and the source's
    ``close()`` runs."""
    import queue
    import time as _time

    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if stats is not None:
        for key in (wait_key, stage_key, consumer_wait_key or "queue_wait_s"):
            stats.setdefault(key, 0.0)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    failure: List[BaseException] = []
    # set when the consumer abandons the generator mid-stream: a producer
    # blocked on a full queue must not hang holding parsed blocks
    stop = threading.Event()

    def put_until_stopped(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        it = None
        try:
            # inside the try: a raising __iter__ must surface on the
            # consumer side like any mid-stream failure
            it = iter(chunks)
            while not stop.is_set():
                t0 = _time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                finally:
                    if stats is not None:
                        stats[wait_key] = (stats.get(wait_key, 0.0)
                                           + _time.perf_counter() - t0)
                if stage_fn is not None:
                    t0 = _time.perf_counter()
                    try:
                        item = stage_fn(item)
                    finally:
                        if stats is not None:
                            stats[stage_key] = (stats.get(stage_key, 0.0)
                                                + _time.perf_counter() - t0)
                if not put_until_stopped(item):
                    break
        except BaseException as exc:  # surfaced on the consumer side
            failure.append(exc)
            if stats is not None:
                stats["producer_error"] = f"{type(exc).__name__}: {exc}"
                stats["producer_error_thread"] = thread_name
        finally:
            close = getattr(it, "close", None)
            if close is not None:  # release the source now, not at GC
                try:
                    close()
                except Exception:
                    pass
            put_until_stopped(end)

    threading.Thread(target=produce, daemon=True, name=thread_name).start()
    try:
        while True:
            t0 = _time.perf_counter()
            item = q.get()
            if stats is not None and consumer_wait_key is not None:
                stats[consumer_wait_key] = (stats.get(consumer_wait_key, 0.0)
                                            + _time.perf_counter() - t0)
            if item is end:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
        try:  # unblock a producer mid-put; it exits via its stop check
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def stage_chunks(blocks, stage_fn, depth: int = 2,
                 stats: Optional[dict] = None):
    """Two-deep device staging: a staging thread runs ``stage_fn(block)``
    (host encode + upload) for block i+1 while the consumer computes on
    block i.  Chain it behind :func:`prefetch_chunks` (constructed with
    ``consumer_wait_key=None``) for the three-stage pipeline parse ||
    transfer || compute.  Stage time lands in ``stats['transfer_s']``,
    the wait on the upstream in ``stats['stage_wait_s']``, the final
    consumer's queue blocking in ``stats['queue_wait_s']``; failures,
    shutdown and ``close()`` follow :func:`prefetch_chunks`."""
    return prefetch_chunks(blocks, depth=depth, stats=stats,
                           stage_fn=stage_fn, wait_key="stage_wait_s",
                           stage_key="transfer_s",
                           thread_name="avenir-ingest-stage")
