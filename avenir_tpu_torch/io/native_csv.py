"""ctypes binding for the native C++ CSV -> columnar reader.

``csv_native.cpp`` (the port's own copy of the JAX package's reader) is
compiled with ``g++`` on first use into ``build/avenir_tpu_torch/`` at the
root of the checkout, beside the CUDA kernels' libraries
(``kernels/build.py``).  The library is named by a hash of the source, the
flags and the host (``platform.machine()`` and the CPU model), because the
``-march=native`` code of one CPU must not be loaded on another.  A file
lock (``fcntl``) is held around the compile, so concurrent processes build
it once; the compiler writes a temporary file that is renamed into place.

A failed build raises :class:`NativeBuildError` with the compiler's output
when the caller asked for the native reader: it never quietly gives way to
the Python reader.  That is the port's rule for its kernels, applied to its
other native code.  (The Python reader still takes over mid-stream when the
C float grammar, stricter than ``float()``, refuses a field: that hand-over
is ``core.table``'s contract with its callers, not a build fallback.)

The C side is a two-phase mmap + memchr parser (see csv_native.cpp): one
``avt_open`` builds the line index, one ``avt_fill`` fills every requested
column in a single fused pass, and string columns come back as a joined
byte blob + int64 offsets wrapped in :class:`core.table.LazyStringColumn`.
:class:`NativeCsvReader` is the streamed form over the same handle:
``parse_chunk(offset, n_rows)`` fills one row block via ``avt_fill_range``.
``AVENIR_TPU_INGEST_THREADS`` caps the parse thread count (default: the
hardware concurrency).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
import weakref
from collections.abc import Sequence
from pathlib import Path
from typing import Optional

import numpy as np

IO_DIR = Path(__file__).resolve().parent
SOURCE = IO_DIR / "csv_native.cpp"
BUILD_DIR = IO_DIR.parents[1] / "build" / "avenir_tpu_torch"

CXX = "g++"
# never -ffast-math: np_floor_divide and the float grammar must round as
# IEEE doubles do (bin codes equal numpy's ``col // bucket_width``)
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# tried first; a toolchain that rejects it builds without
ARCH_FLAG = "-march=native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# (seconds, compiler output) of the build this process ran, if any
build_log: Optional[tuple] = None

_KIND_NUMERIC = 1
_KIND_CATEGORICAL = 2
_KIND_STRING = 3
_KIND_STRING_CHECK = 4
_KIND_NUMERIC_BINNED = 5


class NativeBuildError(RuntimeError):
    """The native CSV reader did not build or load; carries the compiler's
    output."""


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path(source: Optional[Path] = None,
                 stem: str = "libcsv_native") -> Path:
    """Where the library for this source (default: the CSV reader's), these
    flags and this host lives; ``stem`` names it.  A missing source hashes
    by its path, so the compiler reports it."""
    source = SOURCE if source is None else source
    try:
        src = Path(source).read_bytes()
    except OSError:
        src = str(source).encode()
    key = b"\0".join([src, " ".join((CXX, *CXX_FLAGS, ARCH_FLAG)).encode(),
                      platform.machine().encode(), _cpu_model().encode()])
    return BUILD_DIR / f"{stem}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(source: Optional[Path] = None, stem: str = "libcsv_native",
          what: str = "native CSV reader") -> Path:
    """Compile the library of ``source`` (default: the CSV reader) unless
    it is built already; returns its path.  Holds ``<library>.lock``
    around the compile so concurrent processes build it once.  Raises
    :class:`NativeBuildError` with the compiler's output when no flag set
    compiles.  ``build_log`` keeps the CSV reader's build only."""
    global build_log
    import time
    csv_reader = source is None
    source = SOURCE if csv_reader else source
    final = library_path(source, stem)
    if final.exists():
        return final
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(final.with_suffix(".lock"), "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            if final.exists():      # another process built it meanwhile
                return final
            tmp = final.with_suffix(f".tmp{os.getpid()}.so")
            outputs = []
            t0 = time.perf_counter()
            for flags in ((*CXX_FLAGS, ARCH_FLAG), CXX_FLAGS):
                cmd = [CXX, *flags, "-o", str(tmp), str(source)]
                try:
                    res = subprocess.run(cmd, capture_output=True, text=True,
                                         timeout=300)
                except (OSError, subprocess.TimeoutExpired) as exc:
                    outputs.append(f"$ {' '.join(cmd)}\n{exc}")
                    continue
                outputs.append(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
                if res.returncode == 0:
                    os.replace(tmp, final)
                    if csv_reader:
                        build_log = (time.perf_counter() - t0,
                                     outputs[-1])
                    return final
            if tmp.exists():
                tmp.unlink()
            raise NativeBuildError(f"{what} build failed:\n"
                                   + "\n".join(outputs))
        finally:
            fcntl.flock(lock_fh, fcntl.LOCK_UN)


def get_lib() -> ctypes.CDLL:
    """The loaded shared library, built on first use; raises
    :class:`NativeBuildError` when it does not build or load."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise NativeBuildError(
                f"native CSV reader {path} did not load: {exc}") from exc
        lib.avt_open.restype = ctypes.c_void_p
        lib.avt_open.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                 ctypes.c_int]
        lib.avt_n_rows.restype = ctypes.c_int64
        lib.avt_n_rows.argtypes = [ctypes.c_void_p]
        lib.avt_fill.restype = ctypes.c_int64
        lib.avt_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),            # ords
            ctypes.POINTER(ctypes.c_int32),            # kinds
            ctypes.POINTER(ctypes.c_void_p),           # outs
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),  # vocabs
            ctypes.POINTER(ctypes.c_int32),            # vocab_ns
            ctypes.POINTER(ctypes.c_int64),            # bad_out
            ctypes.POINTER(ctypes.c_void_p),           # bin_outs
            ctypes.POINTER(ctypes.c_double),           # bin_widths
            ctypes.POINTER(ctypes.c_int32),            # bin_offsets
            ctypes.POINTER(ctypes.c_uint8)]            # row_bad (nullable)
        lib.avt_fill_range.restype = ctypes.c_int64
        lib.avt_fill_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            *lib.avt_fill.argtypes[1:]]
        lib.avt_row_text.restype = ctypes.c_void_p
        lib.avt_row_text.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int64)]
        lib.avt_string_blob.restype = ctypes.c_void_p
        lib.avt_string_blob.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int64)]
        lib.avt_string_offsets.restype = ctypes.POINTER(ctypes.c_int64)
        lib.avt_string_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.avt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def applies(delim: str) -> bool:
    """Whether the native reader can split on ``delim``: one character,
    not a line end."""
    return len(delim) == 1 and delim not in "\r\n"


def _open_handle(lib, path: str, delim: str) -> "_ParseHandle":
    n_threads = int(os.environ.get("AVENIR_TPU_INGEST_THREADS", "0"))
    h = lib.avt_open(path.encode(), delim.encode(), n_threads)
    if not h:
        raise OSError(f"native csv parse failed to open {path!r}")
    return _ParseHandle(lib, h, int(lib.avt_n_rows(h)), path, delim)


class _ParseHandle:
    """Shared ownership of one avt_open handle (mmap + line index), freed
    when the last referent drops.  Deferred string columns keep it alive
    until they materialize; ``path``/``delim`` let a late extraction that
    fails re-read the column with the Python tokenizer."""

    def __init__(self, lib, h, n, path, delim):
        self.lib = lib
        self.h = h
        self.n = n
        self.path = path
        self.delim = delim
        # extraction writes handle-owned blob/offset state: serialize it
        self.lock = threading.Lock()
        self._finalizer = weakref.finalize(
            self, lib.avt_free, ctypes.c_void_p(h))

    def extract_string(self, ordinal: int):
        """One-column string extraction pass -> (blob bytes, offsets)."""
        lib, h, n = self.lib, self.h, self.n
        ords = (ctypes.c_int32 * 1)(ordinal)
        kinds = (ctypes.c_int32 * 1)(_KIND_STRING)
        outs = (ctypes.c_void_p * 1)()
        vocabs = (ctypes.POINTER(ctypes.c_char_p) * 1)()
        vns = (ctypes.c_int32 * 1)()
        bads = (ctypes.c_int64 * 1)()
        bin_outs = (ctypes.c_void_p * 1)()
        bin_ws = (ctypes.c_double * 1)()
        bin_offs = (ctypes.c_int32 * 1)()
        with self.lock:
            if lib.avt_fill(h, 1, ords, kinds, outs, vocabs, vns,
                            bads, bin_outs, bin_ws, bin_offs, None) != 0:
                raise MemoryError("native string column extraction failed")
            ln = ctypes.c_int64()
            ptr = lib.avt_string_blob(h, 0, ctypes.byref(ln))
            offs_ptr = lib.avt_string_offsets(h, 0)
            if ((ptr is None and ln.value != 0) or ln.value < 0
                    or not offs_ptr):
                raise MemoryError("native string column extraction failed")
            blob = ctypes.string_at(ptr, ln.value) if ln.value else b""
            offsets = np.ctypeslib.as_array(offs_ptr, shape=(n + 1,)).copy()
        return blob, offsets


class DeferredStringColumn(Sequence):
    """A string column that parses its bytes out of the (still-mapped) CSV
    on FIRST access.  Load time pays only a presence check; tables whose id
    columns are never read (forest training) never pay the blob build.
    Same sequence semantics as the Python reader's list."""

    __slots__ = ("_handle", "_ordinal", "_n", "_col")

    def __init__(self, handle: _ParseHandle, ordinal: int):
        self._handle = handle
        self._ordinal = ordinal
        self._n = handle.n
        self._col = None

    def _materialize(self):
        if self._col is None:
            from ..core.table import LazyStringColumn, _tokenize
            handle = self._handle
            try:
                blob, offsets = handle.extract_string(self._ordinal)
                self._col = LazyStringColumn(blob, offsets)
            except (MemoryError, OSError):
                # a deferred extraction must not strand a long job
                # mid-run: re-read just this column the Python way
                with open(handle.path, "r") as fh:
                    rows = _tokenize(fh.read(), handle.delim)
                self._col = [r[self._ordinal] for r in rows]
            self._handle = None  # release the mmap/index share
        return self._col

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, (list, tuple, Sequence)) \
                and not isinstance(other, str):
            mine = self._materialize()
            return (len(mine) == len(other)
                    and all(a == b for a, b in zip(mine, other)))
        return NotImplemented

    def __repr__(self):
        state = "deferred" if self._col is None else "materialized"
        return f"DeferredStringColumn(n={self._n}, {state})"

    def tolist(self):
        return list(self._materialize())


class _FieldSpec:
    """The per-field ctypes arrays every fill of one schema passes: column
    ordinals, kinds, vocabularies and bin parameters.  ``strings`` picks
    the string kind: extract (chunks) or presence check (whole-file load,
    bytes extracted on first access)."""

    def __init__(self, schema, strings: int):
        fields = list(schema.fields)
        n_cols = len(fields)
        self.fields = fields
        self.ords = (ctypes.c_int32 * n_cols)()
        self.kinds = (ctypes.c_int32 * n_cols)()
        self.vocabs = (ctypes.POINTER(ctypes.c_char_p) * n_cols)()
        self.vocab_ns = (ctypes.c_int32 * n_cols)()
        self.bin_ws = (ctypes.c_double * n_cols)()
        self.bin_offs = (ctypes.c_int32 * n_cols)()
        self._keep_alive = []  # encoded vocab arrays must outlive fills
        self.str_ords = []
        for i, f in enumerate(fields):
            self.ords[i] = f.ordinal
            if f.is_categorical:
                self.kinds[i] = _KIND_CATEGORICAL
                enc = [v.encode() for v in (f.cardinality or [])]
                arr = (ctypes.c_char_p * len(enc))(*enc)
                self._keep_alive.append((enc, arr))
                self.vocabs[i] = arr
                self.vocab_ns[i] = len(enc)
            elif f.is_numeric:
                if f.bucket_width is not None:
                    # bin codes emitted during the same parse pass
                    self.kinds[i] = _KIND_NUMERIC_BINNED
                    self.bin_ws[i] = float(f.bucket_width)
                    self.bin_offs[i] = int(f.bin_offset)
                else:
                    self.kinds[i] = _KIND_NUMERIC
            else:
                self.kinds[i] = strings
                self.str_ords.append(f.ordinal)

    def outputs(self, m: int):
        """Fresh output buffers for ``m`` rows: (outs, bin_outs, columns,
        binned_cache)."""
        n_cols = len(self.fields)
        outs = (ctypes.c_void_p * n_cols)()
        bin_outs = (ctypes.c_void_p * n_cols)()
        columns, binned_cache = {}, {}
        for i, f in enumerate(self.fields):
            kind = self.kinds[i]
            if kind == _KIND_CATEGORICAL:
                out = np.empty(m, dtype=np.int32)
            elif kind in (_KIND_NUMERIC, _KIND_NUMERIC_BINNED):
                out = np.empty(m, dtype=np.float64)
                if kind == _KIND_NUMERIC_BINNED:
                    bout = np.empty(m, dtype=np.int32)
                    binned_cache[f.ordinal] = bout
                    bin_outs[i] = bout.ctypes.data_as(ctypes.c_void_p)
            else:
                continue
            columns[f.ordinal] = out
            outs[i] = out.ctypes.data_as(ctypes.c_void_p)
        return outs, bin_outs, columns, binned_cache

    def raise_bad(self, bads, where: str) -> None:
        """The Python reader's ValueError for malformed or short rows."""
        for i, f in enumerate(self.fields):
            if bads[i]:
                what = ("missing/non-numeric"
                        if self.kinds[i] in (_KIND_NUMERIC,
                                             _KIND_NUMERIC_BINNED)
                        else "missing")
                raise ValueError(
                    f"{bads[i]} rows with {what} field {f.ordinal} "
                    f"({f.name!r}) in {where}")


class NativeCsvReader:
    """Streamed row-block access to one CSV.

    ``avt_open`` runs once (mmap + line index); ``parse_chunk(offset,
    n_rows)`` then fills only that row block through ``avt_fill_range``.
    Peak host memory is one block, not the whole encoded dataset.  String
    columns are extracted eagerly per chunk (a chunk's blob is small and
    the handle's blob state is overwritten by the next fill).  Chunks
    assembled with ``ColumnarTable.from_chunks`` equal a whole-file
    :func:`native_load_csv` byte for byte."""

    def __init__(self, lib, path: str, schema, delim: str):
        self._handle = _open_handle(lib, path, delim)
        self.schema = schema
        self.path = path
        self.delim = delim
        self._spec = _FieldSpec(schema, _KIND_STRING)

    @property
    def n_rows(self) -> int:
        handle = self._handle
        if handle is None:
            raise ValueError("NativeCsvReader is closed")
        return handle.n

    def close(self) -> None:
        handle, self._handle = self._handle, None
        if handle is not None:
            handle._finalizer()  # idempotent avt_free

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def row_text(self, row: int) -> str:
        """Raw text of non-blank line ``row`` (absolute index into the
        file's line index) — what the quarantine policy writes verbatim."""
        handle = self._handle
        if handle is None:
            raise ValueError("NativeCsvReader is closed")
        ln = ctypes.c_int64()
        ptr = handle.lib.avt_row_text(handle.h, int(row), ctypes.byref(ln))
        if ptr is None or ln.value < 0:
            raise IndexError(f"row {row} out of range")
        return (ctypes.string_at(ptr, ln.value) if ln.value else b"") \
            .decode(errors="replace")

    def parse_chunk(self, offset: int, n_rows: int, bad_records=None):
        """Rows [offset, offset + n_rows) as a ColumnarTable block, encoded
        exactly like the whole-file path (the same ValueError on malformed
        or short rows, reported with the block's absolute row range).

        ``bad_records`` (a ``core.table.BadRecordPolicy`` with a skipping
        policy) switches malformed rows from ValueError to filter-and-
        report: the C parser flags which rows were bad (``row_bad``), the
        block drops them, and the policy's counters and quarantine record
        the raw lines.  Those side effects happen last, after every
        fallible native call, so a failed-then-retried chunk never records
        twice."""
        from ..core.table import (ColumnarTable, LazyStringColumn,
                                  _filter_lazy_strings)
        handle = self._handle
        if handle is None:
            raise ValueError("NativeCsvReader is closed")
        skipping = bad_records is not None and bad_records.skips
        lo, hi = int(offset), int(offset) + int(n_rows)
        if not 0 <= lo <= hi <= handle.n:
            raise IndexError(f"rows [{lo}, {hi}) out of range "
                             f"(file has {handle.n})")
        m = hi - lo
        spec = self._spec
        lib = handle.lib
        outs, bin_outs, columns, binned_cache = spec.outputs(m)
        bads = (ctypes.c_int64 * len(spec.fields))()
        str_columns = {}
        row_bad = np.zeros(m, dtype=np.uint8) if skipping else None
        with handle.lock:
            rc = lib.avt_fill_range(handle.h, lo, hi, len(spec.fields),
                                    spec.ords, spec.kinds, outs, spec.vocabs,
                                    spec.vocab_ns, bads, bin_outs,
                                    spec.bin_ws, spec.bin_offs,
                                    None if row_bad is None else
                                    row_bad.ctypes.data_as(
                                        ctypes.POINTER(ctypes.c_uint8)))
            if rc != 0:
                raise MemoryError(
                    f"native csv chunk fill failed (rc={rc})")
            # blob state is per-fill on the handle: copy out under the
            # same lock, before any other fill can overwrite it
            for sidx, o in enumerate(spec.str_ords):
                ln = ctypes.c_int64()
                ptr = lib.avt_string_blob(handle.h, sidx, ctypes.byref(ln))
                offs_ptr = lib.avt_string_offsets(handle.h, sidx)
                if ((ptr is None and ln.value != 0) or ln.value < 0
                        or not offs_ptr):
                    raise MemoryError("native string chunk extraction "
                                      "failed")
                blob = ctypes.string_at(ptr, ln.value) if ln.value else b""
                offsets = np.ctypeslib.as_array(
                    offs_ptr, shape=(m + 1,)).copy()
                str_columns[o] = LazyStringColumn(blob, offsets)
        if skipping:
            if row_bad.any():
                keep = row_bad == 0
                bad_idx = np.nonzero(row_bad)[0]
                columns = {o: c[keep] for o, c in columns.items()}
                binned_cache = {o: c[keep] for o, c in binned_cache.items()}
                str_columns = {o: _filter_lazy_strings(c, keep)
                               for o, c in str_columns.items()}
                m = int(np.count_nonzero(keep))
                # policy side effects last: every fallible native call
                # already succeeded
                bad_records.record(
                    [self.row_text(lo + int(i)) for i in bad_idx],
                    src_rows=[lo + int(i) for i in bad_idx])
        else:
            spec.raise_bad(bads, f"rows [{lo}, {hi}) of {self.path!r}")
        for arr in binned_cache.values():
            # same freeze-by-reference contract as native_load_csv
            arr.flags.writeable = False
        return ColumnarTable(schema=self.schema, n_rows=m, columns=columns,
                             str_columns=str_columns, raw_rows=None,
                             binned_cache=binned_cache)


def native_open_csv(path: str, schema, delim: str) -> NativeCsvReader:
    """A :class:`NativeCsvReader` over ``path`` (the streamed twin of
    :func:`native_load_csv`); the caller checks :func:`applies` first.
    Raises :class:`NativeBuildError` when the library does not build, and
    OSError when the file cannot be opened or mapped."""
    return NativeCsvReader(get_lib(), path, schema, delim)


def native_load_csv(path: str, schema, delim: str):
    """Parse ``path`` into a ColumnarTable with the C++ library; the caller
    checks :func:`applies` first.  Raises ValueError on malformed numeric
    fields or short rows, as the Python encoder does, and
    :class:`NativeBuildError` when the library does not build."""
    from ..core.table import ColumnarTable
    handle = _open_handle(get_lib(), path, delim)
    n = handle.n
    # strings: presence validated now (the Python reader's load-time
    # errors); bytes extracted on first access
    spec = _FieldSpec(schema, _KIND_STRING_CHECK)
    outs, bin_outs, columns, binned_cache = spec.outputs(n)
    bads = (ctypes.c_int64 * len(spec.fields))()
    rc = handle.lib.avt_fill(handle.h, len(spec.fields), spec.ords,
                             spec.kinds, outs, spec.vocabs, spec.vocab_ns,
                             bads, bin_outs, spec.bin_ws, spec.bin_offs,
                             None)
    if rc != 0:
        raise MemoryError("native csv fill failed")
    for arr in binned_cache.values():
        # cached codes are returned BY REFERENCE from binned_codes (the
        # Python path returns fresh arrays): freeze them so a caller
        # mutation fails loudly instead of corrupting the cache
        arr.flags.writeable = False
    spec.raise_bad(bads, repr(path))
    str_columns = {o: DeferredStringColumn(handle, o) for o in spec.str_ords}
    return ColumnarTable(schema=schema, n_rows=n, columns=columns,
                         str_columns=str_columns, raw_rows=None,
                         binned_cache=binned_cache)
