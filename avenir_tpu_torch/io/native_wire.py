"""ctypes binding for the native serving wire codec: port of
``avenir_tpu/io/native_wire.py`` over the port's own copy of its C++
source (``serve_native.cpp``).

The serving data plane's inner loop — RESP message tokenize, per-field
``float()``, categorical vocab lookup, reply RESP encode — is one C pass
a drained batch here:

* :class:`WireCodec` — one native pass over a drained batch of raw
  message strings: request ids, trace-field values, float-form feature
  columns written straight into reusable host buffers and sliced into
  the port's prepared form (the bucket-padded ``(ColumnarTable, n)``
  chunks ``Predictor.prepare_rows`` makes and
  ``ForestPredictor.dispatch_prepared`` takes), and the int8 pre-binned
  ``predictq`` rows decoded row-major.
* :func:`encode_lpush` — the whole variadic ``LPUSH q v1 .. vn`` reply
  command as ONE RESP buffer for a single ``sendall`` (byte-identical to
  ``respq._encode_command``).

The library is compiled with ``g++`` on first use into
``build/avenir_tpu_torch/`` (``io/native_csv.build``: named by a hash of
the source, the flags and the host, built once under a file lock).  A
failed build raises :class:`~avenir_tpu_torch.io.native_csv.NativeBuildError`
with the compiler's output: it never quietly gives way to the Python
plane.  The Python plane runs where it is asked for — ``set_mode("off")``,
the ``ps.wire.native=off`` job knob, the differential baseline — and
where the C side returns its FALLBACK verdict on an input it is not
bit-certain about (lexotic numerics ``float()`` accepts, short rows,
malformed trace or predictq payloads, deadline or model fields): the
caller then re-runs that whole batch through Python, the reference's
semantics, so replies and BadRequests counts cannot diverge.

``set_mode`` takes ``auto`` / ``on`` / ``off``; ``auto`` and ``on`` both
run the codec.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.table import ColumnarTable
from . import native_csv

SOURCE = Path(__file__).resolve().parent / "serve_native.cpp"
STEM = "libserve_native"

_ABI_VERSION = 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# message classification (mirrors serve_native.cpp)
MSG_PREDICT = 0
MSG_PREDICTQ = 1
MSG_RELOAD = 2
MSG_BAD = 3

_KIND_NUMERIC = 1
_KIND_CATEGORICAL = 2

MODES = ("auto", "on", "off")
_mode = "auto"


def set_mode(mode: str) -> None:
    """Process-wide codec mode (the ``ps.wire.native`` knob)."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"wire codec mode must be one of {MODES}, "
                         f"got {mode!r}")
    _mode = mode


def get_mode() -> str:
    return _mode


def library_path() -> Path:
    return native_csv.library_path(SOURCE, STEM)


def build() -> Path:
    """Compile the codec unless it is built; raises ``NativeBuildError``
    with the compiler's output when it does not compile."""
    return native_csv.build(SOURCE, STEM, "native serving codec")


def _declare(lib: ctypes.CDLL) -> None:
    lib.awp_abi_version.restype = ctypes.c_int32
    lib.awp_abi_version.argtypes = []
    lib.awp_parse.restype = ctypes.c_int32
    lib.awp_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,   # buf, len, n_msgs
        ctypes.c_char, ctypes.c_char,                      # sep, delim
        ctypes.c_int32,                                    # n_cols
        ctypes.POINTER(ctypes.c_int32),                    # ords
        ctypes.POINTER(ctypes.c_int32),                    # kinds
        ctypes.POINTER(ctypes.c_void_p),                   # outs
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),   # vocabs
        ctypes.POINTER(ctypes.c_int32),                    # vocab_ns
        ctypes.c_int32,                                    # min_fields
        ctypes.c_int32,                                    # q_width
        ctypes.POINTER(ctypes.c_int8),                     # qv_out
        ctypes.POINTER(ctypes.c_int8),                     # qc_out
        ctypes.POINTER(ctypes.c_uint8),                    # kind_out
        ctypes.POINTER(ctypes.c_int64),                    # id_start
        ctypes.POINTER(ctypes.c_int32),                    # id_len
        ctypes.POINTER(ctypes.c_int64),                    # trace_us
        ctypes.POINTER(ctypes.c_uint8),                    # trace_sampled
        ctypes.POINTER(ctypes.c_int64),                    # slot_out
        ctypes.POINTER(ctypes.c_int64),                    # counts
        ctypes.POINTER(ctypes.c_uint8),                    # rid_out
        ctypes.POINTER(ctypes.c_int64),                    # rid_out_len
    ]
    # void_p (not char_p): the auto-bytes conversion would orphan the
    # malloc'd buffer before awp_free_buf could run
    lib.awp_encode_lpush.restype = ctypes.c_void_p
    lib.awp_encode_lpush.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.awp_free_buf.restype = None
    lib.awp_free_buf.argtypes = [ctypes.c_void_p]


def get_lib() -> ctypes.CDLL:
    """The loaded codec library, built on first use; raises
    ``NativeBuildError`` when it does not build, load or match this
    binding's ABI."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
            _declare(lib)
        except (OSError, AttributeError) as exc:
            raise native_csv.NativeBuildError(
                f"native serving codec {path} did not load: {exc}") from exc
        if lib.awp_abi_version() != _ABI_VERSION:
            raise native_csv.NativeBuildError(
                f"native serving codec {path} has ABI "
                f"{lib.awp_abi_version()}, expected {_ABI_VERSION}")
        _lib = lib
        return _lib


# --------------------------------------------------------------------------
# reply-side: one RESP buffer per batch
# --------------------------------------------------------------------------

def encode_lpush(queue: str, values: Sequence[str]) -> Optional[bytes]:
    """``_encode_command(["LPUSH", queue, *values])`` built natively as one
    buffer; None with the codec off, for no values, or when a value embeds
    the join byte or does not encode (the caller then uses the python
    encoder — a mis-split can never reach the wire)."""
    if _mode == "off" or not values:
        return None
    lib = get_lib()
    try:
        blob = "\n".join(values).encode()
        q = queue.encode()
    except UnicodeEncodeError:
        return None
    out_len = ctypes.c_int64()
    ptr = lib.awp_encode_lpush(q, len(q), blob, len(blob), len(values),
                               ctypes.byref(out_len))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.awp_free_buf(ptr)


# --------------------------------------------------------------------------
# request-side: batch assembler
# --------------------------------------------------------------------------

class ParsedBatch:
    """One native pass over a drained batch.  Per-message arrays are VIEWS
    of the codec's reusable buffers — valid until the codec's next
    ``parse`` (process_batch is synchronous through readback, so one codec
    per service is safe).  ``prepared`` is the float-form bucket-padded
    ``(ColumnarTable, n)`` list; ``qv``/``qc`` are the int8 pre-binned rows
    in slot order."""

    __slots__ = ("n_msgs", "kind", "slot", "rids", "trace_us",
                 "trace_sampled", "n_float", "n_q", "n_reload",
                 "prepared", "qv", "qc")

    def __init__(self, n_msgs, kind, slot, rids, trace_us, trace_sampled,
                 n_float, n_q, n_reload, prepared, qv, qc):
        self.n_msgs = n_msgs
        self.kind = kind
        self.slot = slot
        self.rids = rids
        self.trace_us = trace_us
        self.trace_sampled = trace_sampled
        self.n_float = n_float
        self.n_q = n_q
        self.n_reload = n_reload
        self.prepared = prepared
        self.qv = qv
        self.qc = qc


class WireCodec:
    """Reusable native batch assembler bound to one (schema, delim,
    buckets, q_width).  ``parse(messages)`` returns a :class:`ParsedBatch`
    or None — None means "run this batch through the python path" (codec
    off, a delimiter the C side cannot split on, or its fallback verdict);
    it is never an error."""

    def __init__(self, schema, *, delim: str = ",",
                 buckets: Sequence[int] = (1, 8, 64, 512),
                 q_width: int = 0):
        self.schema = schema
        self.delim = delim
        self.buckets = tuple(buckets)
        self.q_width = int(q_width)
        # native needs a literal single-byte delimiter that cannot collide
        # with the message join byte
        self.usable = (len(delim) == 1 and delim != "\n"
                       and len(delim.encode()) == 1)
        self._delim_b = delim.encode() if self.usable else b","

        # ---- per-schema spec arrays (built once) ----
        fields = [f for f in schema.fields
                  if f.is_categorical or f.is_numeric]
        self._n_cols = len(fields)
        self._ords = (ctypes.c_int32 * self._n_cols)(
            *[f.ordinal for f in fields])
        self._kinds = (ctypes.c_int32 * self._n_cols)()
        self._vocabs = (ctypes.POINTER(ctypes.c_char_p) * self._n_cols)()
        self._vocab_ns = (ctypes.c_int32 * self._n_cols)()
        self._keep_alive = []  # encoded vocab arrays must outlive parses
        self._field_kinds = []
        for i, f in enumerate(fields):
            if f.is_categorical:
                self._kinds[i] = _KIND_CATEGORICAL
                enc = [v.encode() for v in (f.cardinality or [])]
                arr = (ctypes.c_char_p * len(enc))(*enc)
                self._keep_alive.append((enc, arr))
                self._vocabs[i] = arr
                self._vocab_ns[i] = len(enc)
                self._field_kinds.append("cat")
            else:
                self._kinds[i] = _KIND_NUMERIC
                self._field_kinds.append("num")
        # encode_rows indexes r[o] for EVERY schema field (strings
        # included) and raises on a short row — the native path must fall
        # back on exactly the same rows
        self._min_fields = (max(f.ordinal for f in schema.fields) + 1
                            if schema.fields else 0)
        self._field_ordinals = [f.ordinal for f in fields]

        # ---- reusable output buffers (grown on demand) ----
        self._cap = 0
        self._cols: List[np.ndarray] = []
        self._outs = (ctypes.c_void_p * max(self._n_cols, 1))()
        self._qv = self._qc = None
        self._kind = self._id_start = self._id_len = None
        self._trace_us = self._trace_sampled = self._slot = None
        self._counts = (ctypes.c_int64 * 3)()

    def _ensure_capacity(self, n: int) -> None:
        if n <= self._cap:
            return
        cap = max(n, 2 * self._cap, 64)
        self._cols = [
            np.empty(cap, dtype=np.int32 if k == "cat" else np.float64)
            for k in self._field_kinds]
        for i, col in enumerate(self._cols):
            self._outs[i] = col.ctypes.data
        if self.q_width > 0:
            self._qv = np.empty((cap, self.q_width), dtype=np.int8)
            self._qc = np.empty((cap, self.q_width), dtype=np.int8)
        self._kind = np.empty(cap, dtype=np.uint8)
        self._id_start = np.empty(cap, dtype=np.int64)
        self._id_len = np.empty(cap, dtype=np.int32)
        self._trace_us = np.empty(cap, dtype=np.int64)
        self._trace_sampled = np.empty(cap, dtype=np.uint8)
        self._slot = np.empty(cap, dtype=np.int64)
        self._cap = cap

    def _bucket_size(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _float_prepared(self, n_float: int):
        """Slice the filled columns into bucket-padded (table, n) chunks —
        ``Predictor._bucketed_tables``' shape discipline.  Full chunks are
        zero-copy views frozen by reference (``writeable=False``): the
        backing buffers are the codec's and are overwritten by the next
        parse, so nothing downstream may retain OR mutate them."""
        prepared = []
        top = self.buckets[-1]
        for s in range(0, n_float, top):
            n = min(top, n_float - s)
            b = self._bucket_size(n)
            columns: Dict[int, np.ndarray] = {}
            for o, col in zip(self._field_ordinals, self._cols):
                if b == n:
                    v = col[s:s + n]
                else:  # tail chunk: pad with copies of its last row
                    v = np.empty(b, dtype=col.dtype)
                    v[:n] = col[s:s + n]
                    v[n:] = col[s + n - 1]
                v.flags.writeable = False
                columns[o] = v
            prepared.append((ColumnarTable(schema=self.schema, n_rows=b,
                                           columns=columns,
                                           str_columns={}), n))
        return prepared

    def parse(self, messages: Sequence[str]) -> Optional[ParsedBatch]:
        if not self.usable or _mode == "off" or not messages:
            return None
        lib = get_lib()
        try:
            blob = "\n".join(messages).encode()
        except UnicodeEncodeError:
            return None
        n = len(messages)
        self._ensure_capacity(n)

        def as_ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))
        qw = self.q_width
        # rids come back packed '\n'-terminated (one entry per message, ""
        # for reload/bad) so one decode+split replaces n slice decodes; no
        # rid can contain '\n' — the sep count validation forbids it
        rid_buf = np.empty(len(blob) + n + 1, dtype=np.uint8)
        rid_len = ctypes.c_int64(0)
        rc = lib.awp_parse(
            blob, len(blob), n, b"\n", self._delim_b,
            self._n_cols, self._ords, self._kinds, self._outs,
            self._vocabs, self._vocab_ns, self._min_fields,
            qw,
            as_ptr(self._qv, ctypes.c_int8) if qw > 0 else None,
            as_ptr(self._qc, ctypes.c_int8) if qw > 0 else None,
            as_ptr(self._kind, ctypes.c_uint8),
            as_ptr(self._id_start, ctypes.c_int64),
            as_ptr(self._id_len, ctypes.c_int32),
            as_ptr(self._trace_us, ctypes.c_int64),
            as_ptr(self._trace_sampled, ctypes.c_uint8),
            as_ptr(self._slot, ctypes.c_int64),
            self._counts,
            as_ptr(rid_buf, ctypes.c_uint8), ctypes.byref(rid_len))
        if rc != 0:  # FALLBACK or internal error: python path, whole batch
            return None
        n_float, n_q, n_reload = (int(self._counts[0]),
                                  int(self._counts[1]),
                                  int(self._counts[2]))
        kind = self._kind[:n]
        rids = rid_buf[:rid_len.value].tobytes().decode()[:-1].split("\n")
        prepared = self._float_prepared(n_float) if n_float else []
        qv = qc = None
        if n_q and qw > 0:
            qv = self._qv[:n_q]
            qc = self._qc[:n_q]
            qv.flags.writeable = False
            qc.flags.writeable = False
        return ParsedBatch(n, kind, self._slot[:n], rids,
                           self._trace_us[:n], self._trace_sampled[:n],
                           n_float, n_q, n_reload, prepared, qv, qc)
