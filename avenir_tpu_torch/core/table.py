"""Columnar dataset: CSV text -> encoded numpy arrays.

The port's copy of ``avenir_tpu/core/table.py``, trimmed to what the forest,
the monitor baseline and KNN read: a dataset is a struct of columns, each
encoded once on load:

  * categorical columns  -> int32 vocabulary codes (schema cardinality order;
    unknown values -> -1)
  * numeric columns      -> float64 values
  * binned-numeric view  -> int32 bin codes, ``value // bucketWidth - offset``
    (the native reader emits them during the parse: ``binned_cache``)
  * id/string columns    -> kept host-side (python lists, or joined bytes +
    offsets from the native reader: :class:`LazyStringColumn`)

Two readers produce the same columns byte for byte: the native C++ reader
(``io/native_csv.py``, ``use_native=True``, the default) and the Python
reader below.  The Python reader reads what the native one cannot: a
``keep_raw`` load (raw-row echo), a multi-character delimiter, a text
stream, a monolithic load under a skipping bad-record policy, and the rest
of a stream after the C float grammar (stricter than ``float()``) refused a
field.  Which reader read each block is recorded in the active
``TransferLedger`` (``IngestReaders`` group, :func:`note_ingest`), with the
reason for every Python block.  :class:`BadRecordPolicy` is the reference's
malformed-record handling (fail, skip, quarantine), applied by the
monolithic load (``load_csv(..., bad_records=)``) and per block by the
chunked readers.  ``cache=`` (an ``io.colcache.CachePolicy``) slots the
columnar cache sidecar under both loads.

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
import warnings
from collections.abc import Sequence as SequenceABC
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .faults import fault_point, with_retry
from .metrics import Counters
from .schema import FeatureSchema
from ..utils.tracing import note_ingest


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
        row index; this policy ignores it (the columnar cache's recording
        wrapper, ``io.colcache``, persists it so a cached replay can honor
        a mid-cache ``start_row`` cut exactly)."""
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


class LazyStringColumn(SequenceABC):
    """An id/string column decoded on access: joined UTF-8 bytes plus int64
    row offsets, as the native reader hands it over.  Consumers index,
    iterate or compare it exactly like the list the Python reader
    produces; no per-row Python string is made until one is read."""

    __slots__ = ("_blob", "_offsets")

    def __init__(self, blob: bytes, offsets: np.ndarray):
        if len(offsets) == 0:
            raise ValueError("offsets must have n+1 entries")
        self._blob = blob
        self._offsets = offsets

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._blob[self._offsets[i]:self._offsets[i + 1]].decode()

    def __iter__(self):
        blob, offs = self._blob, self._offsets
        for i in range(len(self)):
            yield blob[offs[i]:offs[i + 1]].decode()

    def __eq__(self, other):
        if isinstance(other, (LazyStringColumn, list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __repr__(self):
        return f"LazyStringColumn(n={len(self)})"

    def tolist(self) -> List[str]:
        return list(self)


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
    # ordinal -> int32 bin codes of bucketWidth-binned numeric fields, as
    # the native reader emits them during the parse (read-only arrays)
    binned_cache: Dict[int, np.ndarray] = dc_field(default_factory=dict)

    def class_codes(self) -> np.ndarray:
        return self.columns[self.schema.class_attr_field.ordinal]

    def feature_matrix(self, fields=None, dtype=np.float64) -> np.ndarray:
        """(n_rows, F) dense matrix of the feature fields' values
        (categorical fields as their codes)."""
        fields = list(fields if fields is not None
                      else self.schema.feature_fields)
        if not fields:
            return np.zeros((self.n_rows, 0), dtype=dtype)
        return np.stack([self.columns[f.ordinal].astype(dtype)
                         for f in fields], axis=1)

    def take_rows(self, lo: int, hi: int) -> "ColumnarTable":
        """Contiguous row slice [lo, hi) as a new table: encoded columns
        are numpy views, string columns materialize the slice."""
        return ColumnarTable(
            schema=self.schema, n_rows=hi - lo,
            columns={k: v[lo:hi] for k, v in self.columns.items()},
            str_columns={k: v[lo:hi] for k, v in self.str_columns.items()},
            raw_rows=self.raw_rows[lo:hi] if self.raw_rows is not None
            else None,
            binned_cache={k: v[lo:hi]
                          for k, v in self.binned_cache.items()})

    @classmethod
    def from_chunks(cls, chunks: Sequence["ColumnarTable"]
                    ) -> "ColumnarTable":
        """Assemble contiguous row blocks (same schema, in row order) into
        one table — the inverse of chunked ingest.  Encoded columns and
        bin caches concatenate; string columns concatenate as one joined
        blob + offsets when every block carries the
        :class:`LazyStringColumn` form (the native reader's), else as
        plain lists.  The result equals loading the whole file at once."""
        chunks = list(chunks)
        if not chunks:
            raise ValueError("from_chunks needs at least one chunk")
        columns = {o: np.concatenate([c.columns[o] for c in chunks])
                   for o in chunks[0].columns}
        binned: Dict[int, np.ndarray] = {}
        for o in chunks[0].binned_cache:
            if all(o in c.binned_cache for c in chunks):
                arr = np.concatenate([c.binned_cache[o] for c in chunks])
                arr.flags.writeable = False   # the native reader's rule
                binned[o] = arr
        str_columns: Dict[int, List[str]] = {}
        for o in chunks[0].str_columns:
            cols = [c.str_columns[o] for c in chunks]
            if all(isinstance(c, LazyStringColumn) for c in cols):
                str_columns[o] = _concat_lazy_strings(cols)
            else:
                str_columns[o] = [v for c in cols for v in c]
        raw = None
        if all(c.raw_rows is not None for c in chunks):
            raw = [r for c in chunks for r in c.raw_rows]
        return cls(schema=chunks[0].schema,
                   n_rows=sum(c.n_rows for c in chunks), columns=columns,
                   str_columns=str_columns, raw_rows=raw,
                   binned_cache=binned)

    def binned_codes(self, ordinal: int) -> np.ndarray:
        """int32 bin codes in [0, num_bins) for a binned field (categorical code
        or value // bucketWidth - bin_offset)."""
        cached = self.binned_cache.get(ordinal)
        if cached is not None:
            return cached
        f = self.schema.find_field_by_ordinal(ordinal)
        col = self.columns[ordinal]
        if f.is_categorical:
            return col.astype(np.int32)
        if f.bucket_width is None:
            raise ValueError(f"field {ordinal} has no finite bin alphabet")
        return (col // f.bucket_width).astype(np.int32) - f.bin_offset


def _concat_lazy_strings(cols: Sequence[LazyStringColumn]
                         ) -> LazyStringColumn:
    """Join per-chunk blob + offset string columns into one without
    decoding a row: blobs concatenate, each chunk's offsets shift by the
    bytes before it."""
    blobs = [c._blob for c in cols]
    parts = [np.asarray(cols[0]._offsets, dtype=np.int64)]
    base = len(blobs[0])
    for c in cols[1:]:
        offs = np.asarray(c._offsets, dtype=np.int64)
        parts.append(offs[1:] + base)
        base += len(c._blob)
    return LazyStringColumn(b"".join(blobs), np.concatenate(parts))


def _filter_lazy_strings(col, keep: np.ndarray):
    """Drop the rows where ``keep`` is False from a blob + offsets string
    column without decoding kept rows; plain lists filter by mask.  Bad
    rows are sparse, so the blob is rebuilt from the runs between dropped
    rows: O(bad rows) slices, not one a kept row."""
    if not isinstance(col, LazyStringColumn):
        return [v for v, k in zip(col, keep) if k]
    offs = np.asarray(col._offsets, dtype=np.int64)
    n = len(keep)
    parts = []
    lo = 0
    for b in np.nonzero(~keep)[0]:
        if b > lo:
            parts.append(col._blob[offs[lo]:offs[b]])
        lo = int(b) + 1
    if lo < n:
        parts.append(col._blob[offs[lo]:offs[n]])
    idx = np.nonzero(keep)[0]
    lens = offs[1:] - offs[:-1]
    new_offs = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(lens[idx], out=new_offs[1:])
    return LazyStringColumn(b"".join(parts), new_offs)


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


def _native_reason(source, delim_regex: str, keep_raw: bool,
                   use_native: bool, skipping: bool) -> Optional[str]:
    """Why a load cannot take the native reader (None when it can):
    ``asked`` (``use_native=False``), ``text`` (a text stream, not a
    path), ``keep_raw``, ``delimiter`` (not one character) or ``policy``
    (a monolithic load under a skipping bad-record policy, which needs the
    raw lines)."""
    from ..io.native_csv import applies
    if not use_native:
        return "asked"
    if not isinstance(source, str):
        return "text"
    if keep_raw:
        return "keep_raw"
    if not applies(delim_regex):
        return "delimiter"
    if skipping:
        return "policy"
    return None


def load_csv(source: Union[str, io.TextIOBase], schema: FeatureSchema,
             delim_regex: str = ",", keep_raw: bool = False,
             use_native: bool = True,
             bad_records: Optional[BadRecordPolicy] = None,
             cache=None) -> ColumnarTable:
    """Load a CSV file (path or file object) into a ColumnarTable.

    Uses the native C++ reader when ``use_native`` and the delimiter is one
    literal character; a native build failure raises
    (``io.native_csv.NativeBuildError``).  A field the C float grammar
    refuses re-parses the file with the Python reader, so the result never
    depends on the reader.  ``keep_raw``, a text stream and a multi-character
    delimiter take the Python reader.  ``bad_records`` with a skipping
    policy (skip/quarantine) drops malformed records instead of raising;
    the monolithic load runs the Python reader for it (per-record
    filtering needs the raw lines; the chunked :func:`iter_csv_chunks`
    keeps the native reader under the same policy).

    ``cache`` (an ``io.colcache.CachePolicy``) routes the load through the
    chunked stream so the columnar sidecar is used or built; the assembled
    table equals the direct load.  Only path sources without ``keep_raw``
    can be cached: ``require`` refuses anything else, the other policies
    fall through to the plain load."""
    skipping = bad_records is not None and bad_records.skips
    if cache is not None and cache.enabled:
        cacheable = isinstance(source, str) and not keep_raw
        if not cacheable and cache.policy == "require":
            raise ValueError(
                "cache.policy=require needs a path source without "
                "keep_raw (raw-row echo and text streams are not cached)")
        if cacheable:
            chunks = list(iter_csv_chunks(
                source, schema, delim_regex, use_native=use_native,
                bad_records=bad_records, cache=cache))
            if not chunks:
                return encode_rows([], schema)
            return ColumnarTable.from_chunks(chunks)
    reason = _native_reason(source, delim_regex, keep_raw, use_native,
                            skipping)
    if reason is None:
        from ..io.native_csv import native_load_csv
        try:
            table = native_load_csv(source, schema, delim_regex)
        except (ValueError, MemoryError, OSError):
            # the C float grammar is stricter than float() (no '1_0', no
            # unicode digits): re-parse with the Python reader, whose
            # float() decides; a genuinely malformed field raises there
            reason = "handover"
        else:
            note_ingest("native", table.n_rows)
            return table
    if isinstance(source, str):
        with open(source, "r") as fh:
            text = fh.read()
    else:
        text = source.read()
    table = load_csv_text(text, schema, delim_regex, keep_raw=keep_raw,
                          bad_records=bad_records)
    note_ingest("python", table.n_rows, reason)
    return table


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


def _iter_csv_chunks_python(path: str, schema: FeatureSchema,
                            delim_regex: str, chunk_rows: int,
                            skip_rows: int = 0,
                            bad_records: Optional[BadRecordPolicy] = None,
                            stop_row: Optional[int] = None,
                            reason: Optional[str] = None):
    """The Python reader's stream: read the file line by line (never the
    whole text in memory), encode every ``chunk_rows`` well-formed rows.
    ``skip_rows`` counts SOURCE rows (non-blank lines) already consumed,
    the axis every yielded chunk reports as ``source_row_end``;
    ``stop_row`` (exclusive, same axis) ends the stream early.  Each
    block's encode passes the ``chunk_encode`` fault point and is recorded
    as a Python block with ``reason``."""
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
            if stop_row is not None and consumed >= stop_row:
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
                note_ingest("python", chunk.n_rows, reason)
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
            note_ingest("python", chunk.n_rows, reason)
            yield chunk


def iter_csv_chunks(path: str, schema: FeatureSchema,
                    delim_regex: str = ",", chunk_rows: int = 1 << 22,
                    use_native: bool = True,
                    bad_records: Optional[BadRecordPolicy] = None,
                    start_row: int = 0, cache=None,
                    shard=None, stop_row: Optional[int] = None):
    """Yield a CSV as ColumnarTable row blocks of up to ``chunk_rows``
    well-formed rows — the parse stage of the streamed CSV -> device
    ingest.  Host memory holds one encoded block at a time instead of the
    whole dataset; the blocks concatenate (:meth:`ColumnarTable.from_chunks`)
    to the table ``load_csv`` gives.

    Uses the native reader (``io.native_csv.NativeCsvReader``) when
    ``use_native`` and the delimiter is one character; a native build
    failure raises.  Each native block read passes the ``chunk_read`` fault
    point inside ``core.faults.with_retry`` (a transient OSError or
    MemoryError is retried).  A ValueError, MemoryError or OSError that
    survives — above all the C float grammar refusing a field ``float()``
    takes — hands the rest of the stream to the Python reader at the exact
    row reached, with a ``RuntimeWarning``; the Python reader passes the
    ``chunk_encode`` fault point per block.

    ``bad_records`` applies the skip/quarantine policy per block: a
    block's malformed records are reported after it encoded, before it is
    yielded.  ``start_row`` restarts the stream at a SOURCE row index
    (non-blank line count) — the checkpoint/resume contract; every
    yielded chunk reports its own ``source_row_end`` on that axis.

    ``cache`` (an ``io.colcache.CachePolicy``) slots the columnar sidecar
    under this stream: ``use``/``build``/``require`` serve an intact
    fresh sidecar (parse skipped), ``build`` also writes the sidecar
    during a cold full pass; bad records, quarantine bytes, counters and
    ``start_row`` behave the same either way, and a torn sidecar hands
    over to this CSV parse with a warning.

    ``shard=(index, count)`` yields only that row-range shard of the
    source: split points from ``parallel.distributed.shard_rows`` over the
    source-row count (the native reader's ``n_rows``, else
    :func:`count_source_rows`), on the ``chunk_rows`` grid, so the shards'
    streams together are the whole stream and each bad record is reported
    by exactly one shard.  It composes with ``start_row`` (a resumed shard
    restarts at the larger of its range's start and ``start_row``).
    ``stop_row`` (exclusive, on the same axis) ends the stream early; it
    is what ``shard`` is built on, and passing both is refused."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    if start_row < 0:
        raise ValueError(f"start_row must be >= 0, got {start_row}")
    if shard is not None and stop_row is not None:
        raise ValueError("pass shard= or stop_row=, not both (shard "
                         "computes its own bounds)")
    if cache is not None and cache.enabled:
        from ..io.colcache import iter_csv_chunks_cached
        yield from iter_csv_chunks_cached(
            path, schema, delim_regex, chunk_rows, use_native,
            bad_records, int(start_row), cache, shard=shard,
            stop_row=stop_row)
        return
    from ..io.native_csv import applies, native_open_csv
    done_rows = int(start_row)
    stop = int(stop_row) if stop_row is not None else None
    reader = None
    reason = "asked" if not use_native else \
        None if applies(delim_regex) else "delimiter"
    if reason is None:
        try:
            reader = native_open_csv(path, schema, delim_regex)
        except OSError:
            # unopenable or unmappable: the Python reader's open() raises
            # its own error (or reads what mmap could not)
            reason = "handover"
    if shard is not None:
        from ..parallel.distributed import shard_rows
        total = reader.n_rows if reader is not None \
            else count_source_rows(path)
        lo, stop = shard_rows(total, int(shard[0]), int(shard[1]),
                              chunk_rows)
        done_rows = max(done_rows, lo)
    if reader is not None:
        with reader:  # closed on every exit path, GeneratorExit included
            n = reader.n_rows if stop is None else min(reader.n_rows, stop)
            block_idx = 0
            try:
                while done_rows < n:
                    take = min(chunk_rows, n - done_rows)

                    def read_block(lo=done_rows, m=take, i=block_idx):
                        fault_point("chunk_read", i)
                        return reader.parse_chunk(
                            lo, m, bad_records=bad_records)

                    chunk = with_retry(
                        read_block, what=f"chunk read [{done_rows}, "
                                         f"{done_rows + take}) of {path!r}")
                    chunk.source_row_end = done_rows + take
                    note_ingest("native", chunk.n_rows)
                    yield chunk
                    done_rows += take
                    block_idx += 1
                return
            except (ValueError, MemoryError, OSError) as exc:
                # the Python reader resumes at done_rows below
                warnings.warn(
                    f"native CSV reader failed mid-stream at row "
                    f"{done_rows} of {path!r} ({type(exc).__name__}: "
                    f"{exc}); degrading to the python parser",
                    RuntimeWarning)
                reason = "handover"
    yield from _iter_csv_chunks_python(path, schema, delim_regex,
                                       chunk_rows, skip_rows=done_rows,
                                       bad_records=bad_records,
                                       stop_row=stop, reason=reason)


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
