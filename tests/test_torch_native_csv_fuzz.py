"""Randomized fuzz of the port's native CSV reader against its Python
reader and the JAX package's native reader (the twin of
``tests/test_native_csv_fuzz.py``): random schemas (categorical
vocabularies with the empty string and more than 8 entries, fractional
bucket widths, several string columns), random field text (whitespace
padding, signs, decimals, exponents), blank and whitespace-only lines, LF
or CRLF line ends, and a forced thread pool.  Hypothesis draws the seeds,
derandomized, so a failure reproduces exactly."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from avenir_tpu.core import table as jtable
from avenir_tpu.core.schema import FeatureSchema as JaxSchema

from avenir_tpu_torch.core import table as ptable
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.io.native_csv import native_load_csv, native_open_csv

WORDS = ["", "a", "bb", "basic", "plus", "premium", "goldmember",
         "x" * 12, "Ü", "sp ace", "tab\tword"]
FUZZ = settings(max_examples=12, derandomize=True, deadline=None,
                database=None)


def _random_schema(rng):
    fields = [{"name": "id", "ordinal": 0, "id": True,
               "dataType": "string"}]
    n_fields = int(rng.integers(2, 7))
    for o in range(1, n_fields + 1):
        kind = rng.choice(["cat", "catbig", "num", "numbin", "str"])
        if kind == "cat":
            vocab = list(rng.choice(WORDS, size=int(rng.integers(1, 6)),
                                    replace=False))
            fields.append({"name": f"c{o}", "ordinal": o,
                           "dataType": "categorical", "feature": True,
                           "cardinality": vocab})
        elif kind == "catbig":  # > 8 entries: the hash-map lookup path
            fields.append({"name": f"cb{o}", "ordinal": o,
                           "dataType": "categorical", "feature": True,
                           "cardinality": [f"v{i}" for i in range(12)]})
        elif kind == "num":
            fields.append({"name": f"n{o}", "ordinal": o,
                           "dataType": "double", "feature": True,
                           "min": -100, "max": 100})
        elif kind == "numbin":
            bw = float(rng.choice([0.1, 0.25, 1, 3, 25]))
            fields.append({"name": f"nb{o}", "ordinal": o,
                           "dataType": "double", "feature": True,
                           "min": -50, "max": 150, "bucketWidth": bw})
        else:
            fields.append({"name": f"s{o}", "ordinal": o,
                           "dataType": "string"})
    return {"fields": fields}


def _random_field_text(rng, f):
    pad_l = " " * int(rng.integers(0, 3))
    pad_r = " " * int(rng.integers(0, 3))
    if f.is_categorical:
        if rng.random() < 0.8 and f.cardinality:
            v = str(rng.choice(f.cardinality))
        else:
            v = "UNKNOWNVAL"
        # whitespace inside a vocab word would change the trimmed value
        if any(ch in v for ch in " \t"):
            return v
        return pad_l + v + pad_r
    if f.is_numeric:
        style = rng.random()
        if style < 0.4:
            v = str(int(rng.integers(-10000, 10000)))
        elif style < 0.7:
            v = f"{rng.uniform(-100, 100):.4f}"
        elif style < 0.85:
            v = f"{rng.uniform(-1, 1):.3e}"
        else:
            v = "+" + str(int(rng.integers(0, 999)))
        return pad_l + v + pad_r
    return "t" + str(int(rng.integers(0, 10 ** int(rng.integers(1, 8)))))


def _fuzz_file(path, rng, max_rows):
    """A random schema dict and a CSV of it at ``path``."""
    d = _random_schema(rng)
    schema = FeatureSchema.from_dict(d)
    lines = []
    for i in range(int(rng.integers(1, max_rows))):
        row = [""] * schema.num_columns
        row[0] = f"id{i:05d}"
        for f in schema.fields:
            if f.ordinal:
                row[f.ordinal] = _random_field_text(rng, f)
        lines.append(",".join(row))
        if rng.random() < 0.05:
            lines.append(" " * int(rng.integers(0, 4)))  # blank-ish line
    term = "\r\n" if rng.random() < 0.3 else "\n"
    path.write_bytes((term.join(lines) + term).encode())
    return d


def _bit_equal(got, want, label, bins=True):
    """Every encoded column, bin-code cache and string column identical."""
    assert got.n_rows == want.n_rows, label
    for o in want.columns:
        assert got.columns[o].dtype == want.columns[o].dtype, label
        assert got.columns[o].tobytes() == want.columns[o].tobytes(), \
            f"col {o} {label}"
    if bins:
        assert sorted(got.binned_cache) == sorted(want.binned_cache), label
        for o in want.binned_cache:
            assert got.binned_cache[o].tobytes() == \
                want.binned_cache[o].tobytes(), f"bins {o} {label}"
    for o in want.str_columns:
        assert list(got.str_columns[o]) == list(want.str_columns[o]), \
            f"str field {o} {label}"


def _env():
    """A monkeypatch context usable inside a hypothesis example (the
    function-scoped fixture is not reset between examples)."""
    return pytest.MonkeyPatch.context()


def _threads(monkeypatch, threads):
    """The parse's thread count (0: the hardware's); an explicit count
    shards even a tiny file, so block stitching is fuzzed too."""
    if threads:
        monkeypatch.setenv("AVENIR_TPU_INGEST_THREADS", str(threads))
    else:
        monkeypatch.delenv("AVENIR_TPU_INGEST_THREADS", raising=False)


@pytest.mark.parametrize("threads", [0, 1, 3, 7])
@FUZZ
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_native_matches_both_readers_on_random_input(tmp_path_factory,
                                                     threads, seed):
    rng = np.random.default_rng(seed)
    p = tmp_path_factory.mktemp("fuzz") / "fuzz.csv"
    with _env() as monkeypatch:
        _threads(monkeypatch, threads)
        d = _fuzz_file(p, rng, 400)
        schema = FeatureSchema.from_dict(d)
        native = native_load_csv(str(p), schema, ",")
        ref = jtable.load_csv(str(p), JaxSchema.from_dict(d),
                              use_native=True)
    python = ptable.load_csv(str(p), schema, use_native=False)
    _bit_equal(native, ref, f"seed {seed} vs the JAX reader")
    _bit_equal(native, python, f"seed {seed} vs python", bins=False)
    for o in native.binned_cache:
        np.testing.assert_array_equal(native.binned_codes(o),
                                      python.binned_codes(o))


@pytest.mark.parametrize("threads", [0, 1, 3])
@FUZZ
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_chunked_parse_assembles_bit_identical(tmp_path_factory, threads,
                                               seed):
    """``NativeCsvReader.parse_chunk`` blocks (a random block size, so
    boundaries fall mid-file) and the ``iter_csv_chunks`` blocks of both
    readers join to the whole-file native load; the native blocks equal
    the JAX package's native blocks one for one."""
    rng = np.random.default_rng(seed)
    p = tmp_path_factory.mktemp("fuzz_chunked") / "fuzz.csv"
    with _env() as monkeypatch:
        _threads(monkeypatch, threads)
        d = _fuzz_file(p, rng, 500)
        schema = FeatureSchema.from_dict(d)
        whole = native_load_csv(str(p), schema, ",")
        chunk_rows = int(rng.integers(1, whole.n_rows + 2))
        with native_open_csv(str(p), schema, ",") as reader:
            assert reader.n_rows == whole.n_rows
            chunks = [reader.parse_chunk(lo, min(chunk_rows,
                                                 reader.n_rows - lo))
                      for lo in range(0, reader.n_rows, chunk_rows)]
        _bit_equal(ptable.ColumnarTable.from_chunks(chunks), whole,
                   f"seed {seed} chunk {chunk_rows}")
        ref = list(jtable.iter_csv_chunks(str(p), JaxSchema.from_dict(d),
                                          ",", chunk_rows=chunk_rows))
        for use_native in (True, False):
            blocks = list(ptable.iter_csv_chunks(str(p), schema, ",",
                                                 chunk_rows=chunk_rows,
                                                 use_native=use_native))
            _bit_equal(ptable.ColumnarTable.from_chunks(blocks), whole,
                       f"seed {seed} native={use_native}", bins=use_native)
        assert len(chunks) == len(ref)
        for g, w in zip(chunks, ref):
            _bit_equal(g, w, f"seed {seed} block vs the JAX reader")
