"""Columnar cache store: a write-once binary sidecar of a CSV's encoded
chunks (the port's copy of ``avenir_tpu/io/colcache.py``; same ``.avtc``
format, so a sidecar the JAX package built is served here and one built here
passes the JAX package's ``verify_cache``).

The first streamed pass over a CSV under ``policy=build`` writes its encoded
chunks into a sidecar directory (``<csv>.avtc/``); every later pass —
repeated trainings, resumed trains — loads the same chunks back at memcpy
speed and skips the tokenize, float parse and vocabulary lookup.

On-disk layout::

    <csv>.avtc/
      header.json          written LAST: format version, build id, schema
                           fingerprint, source size+mtime, chunk_rows,
                           per-chunk row counts / source ranges / bad
                           counts, trailing bad-line manifest
      chunk_00000.avtc     one file per ingest chunk (tmp-then-rename):
      chunk_00001.avtc       MAGIC | u32 manifest len | manifest JSON |
      ...                    64-byte-aligned raw little-endian column blocks

Per chunk, each encoded column is one contiguous block:

  * categorical codes packed to the narrowest of int8/int16/int32 that the
    schema cardinality allows (-1 for unknown .. cardinality-1), upcast to
    int32 on load;
  * binned-numeric codes packed by the chunk's actual min/max, upcast to
    int32 and frozen on load;
  * numeric columns stay float64 unless the schema declares the field
    integer AND the chunk's values are exactly int32-representable, in
    which case int32 halves the bytes and the float64 round trip is exact;
  * id/string columns as joined bytes + int64 offsets
    (``core.table.LazyStringColumn``).

Bad records: each chunk stores the source row indices and verbatim lines
of the records the parse dropped, so a cached replay reproduces
``badrecords.policy`` exactly — ``fail`` raises, ``skip`` counts,
``quarantine`` appends the same part-file bytes — and a ``start_row``
resume lands mid-cache where the parser would.

Crashes: the build runs in a private ``<dir>.build-<pid>-<id>`` directory
(chunk files tmp-then-rename inside it, header last) and commits by
swapping the directory into place, so an interrupted build is invisible
and concurrent builds cannot interleave chunks.  A torn chunk found
while serving hands the rest of the stream to the CSV parse from the last
intact row with a warning (``require`` raises instead).  A build failure
warns and abandons the build; the pass it rode is unaffected.

Staleness: the header carries a fingerprint of (format version, schema
dict, delimiter) and the source file's size and mtime_ns; any mismatch
makes the sidecar stale — rebuilt under ``build``, refused under
``require``, ignored under ``use``.  The chunk row budget is not part of
the identity: a hit serves the sidecar's own block boundaries.

Entry point: ``core.table.iter_csv_chunks(..., cache=CachePolicy(...))``
(and ``load_csv(..., cache=)``); the job knob is
``dtb.streaming.cache.policy`` (+ ``.dir``).  Every served block is
recorded as a ``cache`` block in the ``IngestReaders`` ledger group.
"""

from __future__ import annotations

import binascii
import json
import os
import shutil
import time
import uuid
import warnings
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.faults import fault_point
from ..utils.tracing import note_ingest

FORMAT_VERSION = 1
MAGIC = b"AVTC\x01"
SIDECAR_SUFFIX = ".avtc"
HEADER_NAME = "header.json"
_ALIGN = 64
CACHE_POLICIES = ("off", "use", "build", "require")

# canonical in-memory dtypes the rest of the framework expects
_KIND_TARGET = {"cat": np.int32, "bin": np.int32, "num": np.float64}


class CacheChunkError(Exception):
    """A chunk file is torn, truncated, or from a different build — the
    serve loop degrades to CSV parse when it sees this."""


@dataclass
class CachePolicy:
    """How a chunked ingest interacts with the columnar sidecar:

      * ``off``      — never touch the cache (the default everywhere);
      * ``use``      — serve from an intact, fresh cache; otherwise parse
        the CSV (and do NOT build);
      * ``build``    — serve from an intact, fresh cache; otherwise parse
        AND emit the sidecar during the same pass (write-once; a stale
        sidecar is rebuilt);
      * ``require``  — serve from the cache or refuse loudly (the
        repeated-epoch contract: a silently re-parsing epoch loop is the
        regression this policy exists to catch).

    ``counters`` mirrors the tallies into a Hadoop-style ``ColumnarCache``
    group (Hit/Miss/Stale/Built/StaleRebuilt/BuildSkipped/BytesRead/
    BytesWritten) so ``cli/run`` dumps them next to ``Transfers``;
    ``stats`` (a streaming stats dict) accumulates ``cache_read_s`` and
    ``cache_write_s``.
    """

    policy: str = "off"
    cache_dir: Optional[str] = None   # default: <csv> + ".avtc"
    counters: Optional[Any] = None    # core.metrics.Counters (duck-typed)
    stats: Optional[dict] = None
    tallies: Dict[str, int] = dc_field(default_factory=dict)

    def __post_init__(self):
        if self.policy not in CACHE_POLICIES:
            raise ValueError(f"cache.policy must be one of {CACHE_POLICIES},"
                             f" got {self.policy!r}")

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    @property
    def builds(self) -> bool:
        return self.policy == "build"

    def dir_for(self, csv_path: str) -> str:
        return self.cache_dir or csv_path + SIDECAR_SUFFIX

    def bump(self, name: str, amount: int = 1) -> None:
        self.tallies[name] = self.tallies.get(name, 0) + int(amount)
        if self.counters is not None:
            self.counters.increment("ColumnarCache", name, amount)

    def add_time(self, key: str, seconds: float) -> None:
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0.0) + seconds


# --------------------------------------------------------------------------
# fingerprint / probe
# --------------------------------------------------------------------------

def schema_fingerprint(schema, delim: str) -> str:
    """Identity of everything that shapes the cached VALUES besides the
    source file itself: the schema (field set, ordinals, cardinality
    order, bucket widths — all of which change the encoded columns), the
    delimiter, and the format version.  sha256 over the canonical JSON.

    The chunk row budget is deliberately NOT part of the identity: a hit
    serves the cache's own block boundaries (the build pass's
    ``iter_csv_chunks`` boundaries, recorded in the header) whatever the
    replay requested — boundaries affect peak memory, never values, and
    resume cuts are on the source-row axis."""
    import hashlib
    payload = json.dumps({"format": FORMAT_VERSION,
                          "schema": schema.to_dict(),
                          "delim": delim},
                         sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def _source_stamp(csv_path: str) -> Dict[str, int]:
    st = os.stat(csv_path)
    return {"size": int(st.st_size), "mtime_ns": int(st.st_mtime_ns)}


def read_header(cache_dir: str) -> Optional[Dict[str, Any]]:
    """The sidecar header, or None when missing/unparseable (an
    interrupted build left chunks but no header — not a cache)."""
    try:
        with open(os.path.join(cache_dir, HEADER_NAME)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def probe(csv_path: str, schema, delim: str,
          cache_dir: Optional[str] = None) -> Tuple[str, Optional[dict]]:
    """('hit', header) when an intact, fresh sidecar exists; ('miss',
    None) when there is none; ('stale', header_or_None) when a sidecar
    exists but its fingerprint or source stamp no longer matches."""
    cdir = cache_dir or csv_path + SIDECAR_SUFFIX
    if not os.path.isdir(cdir):
        return "miss", None
    header = read_header(cdir)
    if header is None:
        return "miss", None
    if header.get("format") != FORMAT_VERSION:
        return "stale", header
    if header.get("fingerprint") != schema_fingerprint(schema, delim):
        return "stale", header
    try:
        if header.get("source") != _source_stamp(csv_path):
            return "stale", header
    except OSError:
        # source gone: the cache cannot be validated against it
        return "stale", header
    return "hit", header


def _gc_dead_builds(cache_dir: str, all_builds: bool = False) -> None:
    """Best-effort removal of ``<cache_dir>.build-<pid>-<id>`` dirs left
    by a build whose process died without abandon() (kill -9, OOM).  Only dirs
    whose recorded pid is no longer alive are touched unless
    ``all_builds`` (:func:`drop_cache`)."""
    import glob as _glob
    prefix = cache_dir + ".build-"
    for d in _glob.glob(prefix + "*"):
        if not all_builds:
            try:
                pid = int(os.path.basename(d)[len(os.path.basename(
                    prefix)):].split("-")[0])
            except ValueError:
                continue
            try:
                os.kill(pid, 0)
                continue          # owner still alive: not ours to reap
            except ProcessLookupError:
                pass              # dead owner: orphaned build
            except OSError:
                continue          # can't tell: leave it
        shutil.rmtree(d, ignore_errors=True)


def drop_cache(cache_dir: str) -> bool:
    """Remove a sidecar directory and any leftover build dirs.  True when
    something was removed."""
    _gc_dead_builds(cache_dir, all_builds=True)
    if os.path.isdir(cache_dir):
        shutil.rmtree(cache_dir, ignore_errors=True)
        return True
    return False


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------

def _pack_codes(arr: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Narrowest of int8/int16/int32 that holds [lo, hi] — lossless by
    range.  Already-narrow arrays pass through uncopied (tobytes() is
    the one copy the write path pays)."""
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return arr if arr.dtype == dt else arr.astype(dt)
    return arr if arr.dtype == np.int32 else arr.astype(np.int32)


def _pack_column(field, kind: str, arr: np.ndarray) -> np.ndarray:
    if kind == "cat":
        card = len(field.cardinality or [])
        # codes are bounded by construction: -1 (unknown) .. card-1
        return _pack_codes(arr, -1, max(card - 1, 0))
    if kind == "bin":
        if arr.size == 0:
            return arr.astype(np.int8)
        return _pack_codes(arr, int(arr.min()), int(arr.max()))
    # numeric: int32 only when the SCHEMA declares the field integral AND
    # the chunk's values are exactly representable (float64 -> int32 ->
    # float64 is the identity there); everything else ships wide
    if (field is not None and field.is_integer and arr.size
            and np.all(np.isfinite(arr))):
        lo, hi = arr.min(), arr.max()
        ii = np.iinfo(np.int32)
        if ii.min <= lo and hi <= ii.max:
            as_int = arr.astype(np.int32)
            if np.array_equal(as_int.astype(np.float64), arr):
                return as_int
    return arr if arr.dtype == np.float64 else arr.astype(np.float64)


def _strings_to_blob(col) -> Tuple[bytes, np.ndarray]:
    """Any string column (list or LazyStringColumn) as joined UTF-8 bytes
    + int64 offsets — the cache's one string form."""
    from ..core.table import LazyStringColumn
    if isinstance(col, LazyStringColumn):
        offs = np.asarray(col._offsets, dtype=np.int64)
        blob = col._blob
        # normalize to a zero-based offset window (a sliced column's
        # offsets need not start at 0)
        if len(offs) and offs[0] != 0:
            blob = blob[offs[0]:offs[-1]]
            offs = offs - offs[0]
        return bytes(blob), offs
    encoded = [s.encode() for s in col]
    offs = np.zeros(len(encoded) + 1, dtype=np.int64)
    if encoded:
        np.cumsum([len(b) for b in encoded], out=offs[1:])
    return b"".join(encoded), offs


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

class CacheWriter:
    """Emits one sidecar during a parse pass: ``append(chunk, bad_src,
    bad_lines)`` per yielded block, ``finalize(tail_bad)`` after the
    stream ends.

    The whole build happens in a PRIVATE build directory
    (``<dir>.build-<pid>-<id>``) and commits by swapping the directory
    into place at finalize — so a crash at ANY point leaves either the
    old cache or no cache (never a torn or half-mixed one), concurrent
    builds (multi-process jobs pointed at the same file) cannot
    interleave chunks from two builds (last commit wins whole), and
    ``abandon`` removes every byte including an in-flight tmp file."""

    def __init__(self, cache_dir: str, schema, csv_path: str, delim: str,
                 chunk_rows: int, policy: Optional[CachePolicy] = None):
        self.final_dir = cache_dir
        self.schema = schema
        self.csv_path = csv_path
        self.delim = delim
        self.chunk_rows = int(chunk_rows)
        self.policy = policy
        self.build_id = uuid.uuid4().hex
        self.dir = f"{cache_dir}.build-{os.getpid()}-{self.build_id[:8]}"
        # stamp taken BEFORE the parse reads the file: a source modified
        # mid-build changes its stat and the finished cache validates
        # stale, which is exactly right
        self._source = _source_stamp(csv_path)
        self.chunks: List[Dict[str, Any]] = []
        self.bytes_written = 0
        self._src_done = 0
        _gc_dead_builds(cache_dir)   # reap a crashed build's leftovers
        os.makedirs(self.dir, exist_ok=True)

    # ---- per-chunk ----
    def append(self, chunk, bad_src: Sequence[int],
               bad_lines: Sequence[str]) -> None:
        idx = len(self.chunks)
        fault_point("cache_write", idx)
        src_end = int(getattr(chunk, "source_row_end", self._src_done))
        manifest: Dict[str, Any] = {
            "build_id": self.build_id, "index": idx,
            "rows": int(chunk.n_rows),
            "source_row_start": self._src_done,
            "source_row_end": src_end,
            "cols": [], "bad": {"src": [int(s) for s in bad_src],
                                "lines": list(bad_lines)}}
        blocks: List[bytes] = []
        offset = 0

        def add_block(entry: Dict[str, Any], payload: bytes) -> None:
            nonlocal offset
            pad = (-offset) % _ALIGN
            if pad:
                blocks.append(b"\x00" * pad)
                offset += pad
            entry["offset"] = offset
            entry["nbytes"] = len(payload)
            entry["crc32"] = binascii.crc32(payload) & 0xFFFFFFFF
            blocks.append(payload)
            offset += len(payload)

        for f in self.schema.fields:
            o = f.ordinal
            if o in chunk.columns:
                kind = "cat" if f.is_categorical else "num"
                packed = _pack_column(f, kind, chunk.columns[o])
                entry = {"ordinal": o, "kind": kind,
                         "dtype": packed.dtype.str}
                add_block(entry, packed.tobytes())
                manifest["cols"].append(entry)
                if o in chunk.binned_cache:
                    packed = _pack_column(f, "bin", chunk.binned_cache[o])
                    entry = {"ordinal": o, "kind": "bin",
                             "dtype": packed.dtype.str}
                    add_block(entry, packed.tobytes())
                    manifest["cols"].append(entry)
            elif o in chunk.str_columns:
                blob, offs = _strings_to_blob(chunk.str_columns[o])
                entry = {"ordinal": o, "kind": "str", "dtype": "<i8"}
                add_block(entry, blob)
                entry["blob_offset"] = entry.pop("offset")
                entry["blob_nbytes"] = entry.pop("nbytes")
                entry["blob_crc32"] = entry.pop("crc32")
                add_block(entry, offs.tobytes())
                manifest["cols"].append(entry)
        mjson = json.dumps(manifest, sort_keys=True,
                           separators=(",", ":")).encode()
        head = MAGIC + np.uint32(len(mjson)).tobytes() + mjson
        pad = (-len(head)) % _ALIGN
        payload_base = len(head) + pad
        final = self.chunk_path(self.dir, idx)
        tmp = f"{final}.tmp-{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(head)
            if pad:
                fh.write(b"\x00" * pad)
            for b in blocks:
                fh.write(b)
        os.replace(tmp, final)
        nbytes = payload_base + offset
        self.bytes_written += nbytes
        if self.policy is not None:
            self.policy.bump("BytesWritten", nbytes)
        self.chunks.append({"rows": int(chunk.n_rows),
                            "source_row_start": self._src_done,
                            "source_row_end": src_end,
                            "bad": len(bad_src), "bytes": nbytes})
        self._src_done = src_end

    # ---- finalize ----
    def finalize(self, tail_bad_src: Sequence[int] = (),
                 tail_bad_lines: Sequence[str] = ()) -> None:
        """Write the header, then swap the build directory into place —
        the commit point.  ``tail_bad_*`` carries malformed records found
        AFTER the last yielded chunk (a bad-only stream tail yields no
        block to attach them to)."""
        header = {
            "format": FORMAT_VERSION,
            "build_id": self.build_id,
            "fingerprint": schema_fingerprint(self.schema, self.delim),
            "source": self._source,
            "source_name": os.path.basename(self.csv_path),
            "delim": self.delim,
            "chunk_rows": self.chunk_rows,
            "n_chunks": len(self.chunks),
            "n_rows": sum(c["rows"] for c in self.chunks),
            "n_bad": (sum(c["bad"] for c in self.chunks)
                      + len(tail_bad_src)),
            "chunks": self.chunks,
            "tail_bad": {"src": [int(s) for s in tail_bad_src],
                         "lines": list(tail_bad_lines)},
            "built_unix": int(time.time()),
        }
        with open(os.path.join(self.dir, HEADER_NAME), "w") as fh:
            json.dump(header, fh, sort_keys=True)
        # commit: the finished build replaces the old sidecar whole.  The
        # rmtree+replace pair is not one atomic op, but every
        # intermediate state is safe — no dir (= miss) or a complete
        # single-build dir; a reader mid-stream on the removed dir hits
        # ENOENT on its next chunk and degrades to parse, same as stale
        if os.path.isdir(self.final_dir):
            shutil.rmtree(self.final_dir)
        os.replace(self.dir, self.final_dir)
        if self.policy is not None:
            self.policy.bump("Built")

    def abandon(self) -> None:
        """Give up on this build: drop the private build directory —
        every chunk file AND any in-flight tmp — best-effort.  The parse
        pass this build rode is unaffected."""
        shutil.rmtree(self.dir, ignore_errors=True)

    @staticmethod
    def chunk_path(cache_dir: str, idx: int) -> str:
        return os.path.join(cache_dir, f"chunk_{idx:05d}{SIDECAR_SUFFIX}")


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

def read_chunk_file(path: str, build_id: Optional[str] = None
                    ) -> Tuple[Dict[str, Any], bytes]:
    """(manifest, raw file bytes) with structural validation: magic,
    manifest parse, build-id match, payload length.  Raises
    CacheChunkError on anything torn/truncated/mismatched — the caller
    degrades to CSV parse."""
    try:
        with open(path, "rb") as fh:
            buf = fh.read()
    except OSError as exc:
        raise CacheChunkError(f"{path!r}: {exc}") from exc
    if len(buf) < len(MAGIC) + 4 or buf[:len(MAGIC)] != MAGIC:
        raise CacheChunkError(f"{path!r}: bad magic (torn write?)")
    mlen = int(np.frombuffer(buf, dtype=np.uint32,
                             count=1, offset=len(MAGIC))[0])
    head_end = len(MAGIC) + 4 + mlen
    if head_end > len(buf):
        raise CacheChunkError(f"{path!r}: truncated manifest")
    try:
        manifest = json.loads(buf[len(MAGIC) + 4:head_end])
    except ValueError as exc:
        raise CacheChunkError(f"{path!r}: manifest unparseable") from exc
    if build_id is not None and manifest.get("build_id") != build_id:
        raise CacheChunkError(
            f"{path!r}: chunk from build {manifest.get('build_id')!r}, "
            f"header expects {build_id!r} (concurrent rebuild?)")
    base = head_end + ((-head_end) % _ALIGN)
    manifest["_payload_base"] = base
    end = base
    for c in manifest.get("cols", []):
        if c["kind"] == "str":
            end = max(end, base + c["blob_offset"] + c["blob_nbytes"],
                      base + c["offset"] + c["nbytes"])
        else:
            end = max(end, base + c["offset"] + c["nbytes"])
    if end > len(buf):
        raise CacheChunkError(
            f"{path!r}: payload truncated ({len(buf)} bytes, "
            f"need {end})")
    return manifest, buf


class CacheReader:
    """Serves the chunks of one intact sidecar as ColumnarTable blocks —
    the memcpy-speed twin of ``NativeCsvReader``."""

    def __init__(self, cache_dir: str, header: Dict[str, Any], schema):
        self.dir = cache_dir
        self.header = header
        self.schema = schema
        self._fields = {f.ordinal: f for f in schema.fields}

    @property
    def n_chunks(self) -> int:
        return int(self.header["n_chunks"])

    def chunk_meta(self, idx: int) -> Dict[str, Any]:
        return self.header["chunks"][idx]

    def load_chunk(self, idx: int, start_row: int = 0,
                   stop_row: Optional[int] = None):
        """One cached block as ``(table, bad_src, bad_lines, nbytes)``,
        sliced so only rows at source index in ``[start_row, stop_row)``
        remain — ``start_row`` is the checkpoint/resume axis, ``stop_row``
        the sharded-ingest upper bound.  Raises CacheChunkError when the
        file is torn — never returns partial data."""
        from ..core.table import ColumnarTable, LazyStringColumn
        fault_point("cache_read", idx)
        path = CacheWriter.chunk_path(self.dir, idx)
        manifest, buf = read_chunk_file(path, self.header.get("build_id"))
        rows = int(manifest["rows"])
        src_start = int(manifest["source_row_start"])
        src_end = int(manifest["source_row_end"])
        meta = self.chunk_meta(idx)
        if (rows != int(meta["rows"]) or src_end !=
                int(meta["source_row_end"])):
            raise CacheChunkError(
                f"{path!r}: chunk meta disagrees with header "
                f"(rows {rows} vs {meta['rows']})")
        base = manifest["_payload_base"]
        bad_src = np.asarray(manifest["bad"]["src"], dtype=np.int64)
        bad_lines = list(manifest["bad"]["lines"])
        bad_sorted = np.sort(bad_src)
        # source-row arithmetic for a mid-chunk cut: good rows appear in
        # source order, so the number before a cut is the number of source
        # rows before it minus the bad ones among them
        skip = 0
        cut_head = start_row > src_start
        if cut_head:
            cut = min(int(start_row), src_end)
            skip = (cut - src_start) - int(np.searchsorted(bad_sorted, cut))
            skip = max(0, min(skip, rows))
        end = rows
        cut_tail = stop_row is not None and int(stop_row) < src_end
        if cut_tail:
            cut = max(int(stop_row), src_start)
            end = (cut - src_start) - int(np.searchsorted(bad_sorted, cut))
            end = max(skip, min(end, rows))
        if cut_head or cut_tail:
            window = bad_src >= start_row
            if stop_row is not None:
                window &= bad_src < int(stop_row)
            bad_lines = [ln for ln, k in zip(bad_lines, window) if k]
            bad_src = bad_src[window]
        columns: Dict[int, np.ndarray] = {}
        binned: Dict[int, np.ndarray] = {}
        str_columns: Dict[int, Any] = {}
        for c in manifest["cols"]:
            o = int(c["ordinal"])
            kind = c["kind"]
            if kind == "str":
                offs = np.frombuffer(buf, dtype=np.int64, count=rows + 1,
                                     offset=base + c["offset"]).copy()
                blob = buf[base + c["blob_offset"]:
                           base + c["blob_offset"] + c["blob_nbytes"]]
                if skip or end < rows:
                    blob = blob[offs[skip]:offs[end]]
                    offs = offs[skip:end + 1] - offs[skip]
                str_columns[o] = LazyStringColumn(blob, offs)
                continue
            arr = np.frombuffer(buf, dtype=np.dtype(c["dtype"]),
                                count=rows, offset=base + c["offset"])
            if skip or end < rows:
                arr = arr[skip:end]
            target = _KIND_TARGET[kind]
            if arr.dtype == target:
                # already canonical: serve the read-only view over the
                # file bytes — zero copy, mutation fails loudly (the
                # frozen-binned-cache discipline extended to wide blocks)
                out = arr
            else:
                # one memcpy-sized astype back to the canonical dtype
                out = arr.astype(target)
                if kind == "bin":
                    # freeze-by-reference rule of the native parse path
                    out.flags.writeable = False
            if kind == "bin":
                binned[o] = out
            else:
                columns[o] = out
        table = ColumnarTable(schema=self.schema, n_rows=end - skip,
                              columns=columns, str_columns=str_columns,
                              raw_rows=None, binned_cache=binned)
        # a tail-cut chunk reports the cut as its end: the consumer's
        # source-row accounting (checkpoints, shard resume) must never
        # claim rows past its own shard bound
        table.source_row_end = min(src_end, int(stop_row)) if cut_tail \
            else src_end
        return table, bad_src, bad_lines, len(buf)


# --------------------------------------------------------------------------
# verification (tests and operators; the serve path checks structure only)
# --------------------------------------------------------------------------

def verify_cache(cache_dir: str, schema=None, csv_path: Optional[str] = None,
                 delim: Optional[str] = None) -> List[str]:
    """Deep-check one sidecar: header present, every chunk structurally
    intact, every block's crc32 matching, row counts consistent; with
    ``schema``/``csv_path``/``delim`` also the fingerprint/freshness.
    Returns a list of problem strings (empty == verified)."""
    problems: List[str] = []
    header = read_header(cache_dir)
    if header is None:
        return [f"no readable {HEADER_NAME} in {cache_dir!r}"]
    if schema is not None and delim is not None:
        fp = schema_fingerprint(schema, delim)
        if header.get("fingerprint") != fp:
            problems.append("schema/delim fingerprint mismatch")
    if csv_path is not None:
        try:
            if header.get("source") != _source_stamp(csv_path):
                problems.append("source file size/mtime changed since build")
        except OSError as exc:
            problems.append(f"source unreadable: {exc}")
    total_rows = 0
    for idx in range(int(header.get("n_chunks", 0))):
        path = CacheWriter.chunk_path(cache_dir, idx)
        try:
            manifest, buf = read_chunk_file(path, header.get("build_id"))
        except CacheChunkError as exc:
            problems.append(str(exc))
            continue
        base = manifest["_payload_base"]
        for c in manifest["cols"]:
            if c["kind"] == "str":
                pairs = [(c["blob_offset"], c["blob_nbytes"],
                          c["blob_crc32"]),
                         (c["offset"], c["nbytes"], c["crc32"])]
            else:
                pairs = [(c["offset"], c["nbytes"], c["crc32"])]
            for off, nb, crc in pairs:
                got = binascii.crc32(buf[base + off:base + off + nb]) \
                    & 0xFFFFFFFF
                if got != crc:
                    problems.append(
                        f"{path!r}: crc mismatch on ordinal "
                        f"{c['ordinal']} ({c['kind']})")
        total_rows += int(manifest["rows"])
    if total_rows != int(header.get("n_rows", -1)):
        problems.append(f"row total {total_rows} != header "
                        f"{header.get('n_rows')}")
    return problems


# --------------------------------------------------------------------------
# the chunk-stream orchestrator behind core.table.iter_csv_chunks(cache=)
# --------------------------------------------------------------------------

class _RecordingBadRecords:
    """Duck-typed BadRecordPolicy wrapper that captures each chunk's bad
    lines + source rows on their way to the real policy — the tee the
    cache build uses to persist the bad-record manifest."""

    def __init__(self, inner):
        self.inner = inner
        self.lines: List[str] = []
        self.src: List[int] = []

    @property
    def skips(self) -> bool:
        return self.inner is not None and self.inner.skips

    @property
    def policy(self) -> str:
        return self.inner.policy if self.inner is not None else "fail"

    def record(self, lines, src_rows=None) -> None:
        self.lines.extend(lines)
        if src_rows is None:
            # no source mapping (a non-instrumented caller): mark unknown
            # so the build is abandoned rather than persisting a manifest
            # that cannot honor start_row resume
            self.src.extend([-1] * len(lines))
        else:
            self.src.extend(int(s) for s in src_rows)
        if self.inner is not None:
            self.inner.record(lines, src_rows=src_rows)

    def take(self) -> Tuple[List[int], List[str]]:
        src, lines = self.src, self.lines
        self.src, self.lines = [], []
        return src, lines


def _raise_cached_bad(n_bad: int, src: np.ndarray, csv_path: str) -> None:
    lo = int(src.min()) if len(src) else -1
    raise ValueError(
        f"{n_bad} malformed record(s) (first at source row {lo}) in "
        f"{csv_path!r} under badrecords.policy=fail (recorded in the "
        f"columnar cache at build time)")


def _header_total_rows(header: Dict[str, Any]) -> int:
    """Total SOURCE rows the sidecar covers: the last chunk's end, pushed
    past any trailing bad-only records — the denominator of the sharded
    serve's split arithmetic (must equal what the parse path would count,
    so a cache hit and a parse miss of the same file agree on shard
    bounds)."""
    chunks = header.get("chunks") or []
    n = int(chunks[-1]["source_row_end"]) if chunks else 0
    tail = (header.get("tail_bad") or {}).get("src") or []
    if tail:
        n = max(n, max(int(s) for s in tail) + 1)
    return n


def _serve_cached(reader: CacheReader, csv_path: str, schema, delim: str,
                  chunk_rows: int, use_native: bool, bad_records,
                  start_row: int, cache: CachePolicy,
                  stop_row: Optional[int] = None):
    """Yield the cached chunks whose source rows fall in ``[start_row,
    stop_row)``, applying the bad-record policy per block exactly where
    the parse path would; a torn chunk degrades the REST of the window to
    CSV parse from the last intact source row (still bounded by
    ``stop_row``, so a degraded shard can never eat its neighbor's
    rows)."""
    from ..core import table as _table
    skipping = bad_records is not None and bad_records.skips
    done_rows = int(start_row)
    header = reader.header
    for idx in range(reader.n_chunks):
        meta = reader.chunk_meta(idx)
        if int(meta["source_row_end"]) <= start_row:
            done_rows = max(done_rows, int(meta["source_row_end"]))
            continue
        if stop_row is not None and \
                int(meta["source_row_start"]) >= stop_row:
            break
        t0 = time.perf_counter()
        try:
            chunk, bad_src, bad_lines, nbytes = reader.load_chunk(
                idx, start_row=start_row, stop_row=stop_row)
        except (CacheChunkError, OSError, ValueError, KeyError,
                IndexError) as exc:
            if cache.policy == "require":
                # require's contract is 'serve from the cache or refuse
                # loudly' — silently re-parsing every epoch is the exact
                # regression the policy exists to catch
                raise CacheChunkError(
                    f"cache.policy=require but chunk {idx} of "
                    f"{reader.dir!r} is torn or unreadable "
                    f"({type(exc).__name__}: {exc}); rebuild the sidecar "
                    f"(cache.policy=build) or drop it") from exc
            warnings.warn(
                f"columnar cache chunk {idx} of {reader.dir!r} is torn or "
                f"unreadable ({type(exc).__name__}: {exc}); degrading to "
                f"CSV parse from source row {done_rows}", RuntimeWarning)
            yield from _table.iter_csv_chunks(
                csv_path, schema, delim, chunk_rows=chunk_rows,
                use_native=use_native, bad_records=bad_records,
                start_row=done_rows, stop_row=stop_row)
            return
        cache.add_time("cache_read_s", time.perf_counter() - t0)
        cache.bump("BytesRead", nbytes)
        if len(bad_src):
            if not skipping:
                _raise_cached_bad(len(bad_src), bad_src, csv_path)
            bad_records.record(bad_lines,
                               src_rows=[int(s) for s in bad_src])
        note_ingest("cache", chunk.n_rows)
        yield chunk
        done_rows = int(getattr(chunk, "source_row_end",
                                meta["source_row_end"]))
    tail = header.get("tail_bad") or {"src": [], "lines": []}
    keep = [(s, ln) for s, ln in zip(tail["src"], tail["lines"])
            if s >= start_row and (stop_row is None or s < stop_row)]
    if keep:
        t_src = [s for s, _ in keep]
        if not skipping:
            _raise_cached_bad(len(t_src), np.asarray(t_src), csv_path)
        bad_records.record([ln for _, ln in keep], src_rows=t_src)


def _parse_and_build(csv_path: str, schema, delim: str, chunk_rows: int,
                     use_native: bool, bad_records, cache: CachePolicy,
                     cache_dir: str):
    """Parse the CSV normally while teeing every chunk into a CacheWriter;
    a writer failure warns and abandons the build (the parse stream the
    consumer sees is never affected)."""
    from ..core import table as _table
    recorder = _RecordingBadRecords(bad_records)
    writer: Optional[CacheWriter] = None
    try:
        writer = CacheWriter(cache_dir, schema, csv_path, delim,
                             chunk_rows, policy=cache)
    except OSError as exc:
        warnings.warn(f"columnar cache build at {cache_dir!r} could not "
                      f"start ({exc}); continuing without a cache",
                      RuntimeWarning)
    source = _table.iter_csv_chunks(
        csv_path, schema, delim, chunk_rows=chunk_rows,
        use_native=use_native,
        bad_records=recorder if (bad_records is not None
                                 or writer is not None) else None)
    complete = False
    try:
        for chunk in source:
            bad_src, bad_lines = recorder.take()
            if writer is not None:
                t0 = time.perf_counter()
                try:
                    if any(s < 0 for s in bad_src):
                        raise CacheChunkError(
                            "bad records without source-row mapping")
                    writer.append(chunk, bad_src, bad_lines)
                except Exception as exc:
                    warnings.warn(
                        f"columnar cache build at {writer.dir!r} failed "
                        f"on chunk {len(writer.chunks)} "
                        f"({type(exc).__name__}: {exc}); abandoning the "
                        f"build (the training pass is unaffected)",
                        RuntimeWarning)
                    writer.abandon()
                    writer = None
                finally:
                    cache.add_time("cache_write_s",
                                   time.perf_counter() - t0)
            yield chunk
        complete = True
    finally:
        if writer is not None:
            if complete:
                tail_src, tail_lines = recorder.take()
                t0 = time.perf_counter()
                try:
                    if any(s < 0 for s in tail_src):
                        raise CacheChunkError(
                            "bad records without source-row mapping")
                    writer.finalize(tail_src, tail_lines)
                except Exception as exc:
                    warnings.warn(
                        f"columnar cache finalize at {writer.dir!r} "
                        f"failed ({type(exc).__name__}: {exc}); "
                        f"abandoning the build", RuntimeWarning)
                    writer.abandon()
                finally:
                    cache.add_time("cache_write_s",
                                   time.perf_counter() - t0)
            else:
                # consumer abandoned the stream (downstream failure):
                # an incomplete build must never become a header
                writer.abandon()


def _build_owner(shard) -> bool:
    """Whether THIS participant may emit the sidecar during its pass.
    Two refusals (the multi-writer guard):

      * a row-range-sharded pass (``shard`` count > 1) never builds — a
        shard is not the full file, and committing it as one would serve
        wrong data to every later pass;
      * over several processes (a joined ``torch.distributed`` run or the
        AVENIR_TPU_SHARD lane) only process/shard 0 builds — N identical
        builds racing the same commit point is wasted parse work and a
        rename collision at finalize; the others just parse this pass.
    """
    if shard is not None and int(shard[1]) > 1:
        return False
    from ..parallel.distributed import shard_spec
    return shard_spec().index == 0


def iter_csv_chunks_cached(csv_path: str, schema, delim: str,
                           chunk_rows: int, use_native: bool, bad_records,
                           start_row: int, cache: CachePolicy, shard=None,
                           stop_row=None):
    """The cache-aware chunk stream behind
    ``core.table.iter_csv_chunks(..., cache=)``: serve from an intact
    fresh sidecar, else parse (building one when the policy asks, the
    pass starts at row 0, and this participant owns the build — a
    resumed tail or a row-range shard must not masquerade as a full
    cache, and concurrent writers must not race one).

    ``shard=(index, count)``: a cache HIT serves only the shard's
    source-row window — the SAME ``shard_rows`` split over the same total
    the parse path would use (``_header_total_rows``), so a warm shard
    and a cold shard of the same run can never overlap; mid-window chunk
    cuts ride ``CacheReader.load_chunk``'s source-row arithmetic."""
    cdir = cache.dir_for(csv_path)
    status, header = probe(csv_path, schema, delim, cache_dir=cdir)
    if status == "hit":
        cache.bump("Hit")
        reader = CacheReader(cdir, header, schema)
        lo, hi = 0, stop_row
        if shard is not None and int(shard[1]) > 1:
            from ..parallel.distributed import shard_rows as _split_rows
            lo, hi = _split_rows(_header_total_rows(header),
                                 int(shard[0]), int(shard[1]), chunk_rows)
        yield from _serve_cached(reader, csv_path, schema, delim,
                                 chunk_rows, use_native, bad_records,
                                 max(int(start_row), lo), cache,
                                 stop_row=hi)
        return
    if cache.policy == "require":
        raise FileNotFoundError(
            f"cache.policy=require but the columnar sidecar at {cdir!r} "
            f"is {status}"
            + ("" if status == "miss" else
               " (source or schema changed since it was built)")
            + "; run a build pass first (cache.policy=build)")
    cache.bump("Miss")
    if status == "stale":
        # visible separately from 'no cache exists': an operator watching
        # the counter group can tell a touched source from a cold start
        cache.bump("Stale")
    from ..core import table as _table
    if cache.builds and start_row == 0 and stop_row is None \
            and _build_owner(shard):
        # a stop_row-bounded read is a HEAD, and a head must never
        # masquerade as a full cache (the same rule start_row>0 follows)
        if status == "stale":
            # the old sidecar stays serveable-to-nobody (it probes stale)
            # until the private build dir swaps over it at finalize
            cache.bump("StaleRebuilt")
        yield from _parse_and_build(csv_path, schema, delim, chunk_rows,
                                    use_native, bad_records, cache, cdir)
        return
    if cache.builds:
        # sharded pass / non-owner process: parse-only this time, counted
        # so the skipped build is observable rather than a mystery miss
        cache.bump("BuildSkipped")
    yield from _table.iter_csv_chunks(
        csv_path, schema, delim, chunk_rows=chunk_rows,
        use_native=use_native, bad_records=bad_records,
        start_row=start_row, shard=shard, stop_row=stop_row)
