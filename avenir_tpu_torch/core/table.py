"""Columnar dataset: CSV text -> encoded numpy arrays.

The port's copy of ``avenir_tpu/core/table.py``, trimmed to what the forest,
the monitor baseline and KNN read: a dataset is a struct of columns, each
encoded once on load:

  * categorical columns  -> int32 vocabulary codes (schema cardinality order;
    unknown values -> -1)
  * numeric columns      -> float64 values
  * id/string columns    -> kept host-side as python lists (never on device)

Only the pure-Python parse is here; the native CSV reader is not ported yet.
:class:`BadRecordPolicy` and :func:`_bad_row_checker` are the reference's
malformed-record handling, which the drift jobs use (skip by default);
training still refuses every policy but ``fail``.
"""

from __future__ import annotations

import io
import os
import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

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

    def record(self, lines: Sequence[str]) -> None:
        """Report (and for quarantine, persist) a batch of malformed raw
        lines.  The quarantine file is appended first, in one write, and
        the counters move only after it succeeded."""
        n = len(lines)
        if n == 0:
            return
        if self.policy == "quarantine":
            with open(self.quarantine_file(), "a") as fh:
                fh.write("".join(line + "\n" for line in lines))
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
             delim_regex: str = ",", keep_raw: bool = False) -> ColumnarTable:
    """Load a CSV file (path or file object) into a ColumnarTable."""
    if isinstance(source, str):
        with open(source, "r") as fh:
            text = fh.read()
    else:
        text = source.read()
    return load_csv_text(text, schema, delim_regex, keep_raw=keep_raw)


def load_csv_text(text: str, schema: FeatureSchema, delim_regex: str = ",",
                  keep_raw: bool = False) -> ColumnarTable:
    """CSV text (one record a line; blank lines skipped) -> ColumnarTable."""
    return encode_rows(_tokenize(text, delim_regex), schema,
                       keep_raw=keep_raw)
