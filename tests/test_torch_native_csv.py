"""The port's native CSV reader (``avenir_tpu_torch/io/native_csv.py``,
``csv_native.cpp``) against its Python reader and the JAX package's
``use_native=True`` reader, on the CPU: the twins of
``tests/test_native_csv.py``'s cases, then the streamed reader (1-row
files, 257-row and whole-file blocks, ``start_row``, ``shard=``,
``stop_row``, CRLF and bare-CR line ends, blank lines, skip and
quarantine), the mid-stream hand-over to the Python reader, a build that
fails, and the ledger's reader counts.  Every table must be byte-identical:
same columns, dtypes, bytes, bin codes and strings."""

import os

import numpy as np
import pytest

from avenir_tpu.core import table as jtable
from avenir_tpu.core.metrics import Counters as JaxCounters
from avenir_tpu.core.schema import FeatureSchema as JaxSchema

from avenir_tpu_torch.core import table as ptable
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.io import native_csv
from avenir_tpu_torch.utils.tracing import transfer_ledger

SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "plan", "ordinal": 1, "dataType": "categorical", "feature": True,
     "cardinality": ["basic", "plus", "premium"]},
    {"name": "minutes", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 1000, "bucketWidth": 100},
    {"name": "spend", "ordinal": 3, "dataType": "double", "feature": True},
    {"name": "status", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["active", "churned"]},
]}


def _make_csv(n=500, seed=3):
    rng = np.random.default_rng(seed)
    plans = ["basic", "plus", "premium", "unknownplan"]
    stats = ["active", "churned"]
    lines = []
    for i in range(n):
        plan = plans[rng.integers(0, len(plans))]
        mins = int(rng.integers(0, 1000))
        spend = round(float(rng.normal(50, 20)), 4)
        st = stats[rng.integers(0, 2)]
        lines.append(f"C{i:05d},{plan},{mins},{spend},{st}")
    lines.insert(7, "   ")  # blank-ish line must be skipped
    return "\n".join(lines) + "\n"


def _same(p, j, bins=True):
    """Port table ``p`` byte-identical to ``j`` (either package's)."""
    assert p.n_rows == j.n_rows
    assert sorted(p.columns) == sorted(j.columns)
    for o in p.columns:
        assert p.columns[o].dtype == j.columns[o].dtype
        assert p.columns[o].tobytes() == j.columns[o].tobytes()
    if bins:
        assert sorted(p.binned_cache) == sorted(j.binned_cache)
        for o in p.binned_cache:
            assert p.binned_cache[o].dtype == j.binned_cache[o].dtype
            assert p.binned_cache[o].tobytes() == j.binned_cache[o].tobytes()
    assert sorted(p.str_columns) == sorted(j.str_columns)
    for o in p.str_columns:
        assert list(p.str_columns[o]) == list(j.str_columns[o])


def _loads(path, d=SCHEMA, **kw):
    """(port native, port python, JAX native) loads of ``path``."""
    fs, jfs = FeatureSchema.from_dict(d), JaxSchema.from_dict(d)
    return (ptable.load_csv(str(path), fs, **kw),
            ptable.load_csv(str(path), fs, use_native=False, **kw),
            jtable.load_csv(str(path), jfs, use_native=True, **kw))


def _all_equal(path, d=SCHEMA, **kw):
    nat, py, ref = _loads(path, d, **kw)
    _same(nat, ref)
    _same(py, ref, bins=False)
    for o in nat.columns:
        np.testing.assert_array_equal(nat.binned_codes(o)
                                      if o in nat.binned_cache
                                      else nat.columns[o],
                                      py.binned_codes(o)
                                      if o in nat.binned_cache
                                      else py.columns[o])
    return nat, py, ref


# --------------------------------------------------------------------------
# twins of tests/test_native_csv.py
# --------------------------------------------------------------------------

def test_native_matches_python_oracle(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text(_make_csv())
    nat, py, _ = _all_equal(p)
    assert nat.n_rows == py.n_rows == 500
    assert isinstance(nat.str_columns[0], native_csv.DeferredStringColumn)
    assert (nat.columns[1] == -1).any()  # unknown categorical -> -1


def test_load_csv_dispatches_to_native(tmp_path, monkeypatch):
    p = tmp_path / "d.csv"
    p.write_text(_make_csv(50))
    called = {}
    orig = native_csv.native_load_csv

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(native_csv, "native_load_csv", spy)
    with transfer_ledger() as led:
        t = ptable.load_csv(str(p), FeatureSchema.from_dict(SCHEMA))
    assert called.get("yes") and t.n_rows == 50
    assert led.ingest_snapshot() == {"native.blocks": 1, "native.rows": 50}


def test_native_crlf_and_whitespace(tmp_path):
    p = tmp_path / "crlf.csv"
    p.write_text("a1, plus ,30,1.5,active\r\na2,basic,40,2.5,churned\r\n")
    nat, _, _ = _all_equal(p)
    assert nat.columns[1].tolist() == [1, 0]
    assert nat.str_columns[0] == ["a1", "a2"]


def test_native_cr_only_and_plus_sign(tmp_path):
    p = tmp_path / "cr.csv"
    p.write_bytes(b"a1,plus,30,+1.5,active\ra2,basic,40,2.5,churned\r")
    nat, _, _ = _all_equal(p)
    assert nat.n_rows == 2 and nat.columns[3].tolist() == [1.5, 2.5]


def test_native_bad_numeric_raises(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("a1,plus,notanint,1.5,active\n")
    fs = FeatureSchema.from_dict(SCHEMA)
    with pytest.raises(ValueError, match="missing/non-numeric field 2"):
        native_csv.native_load_csv(str(p), fs, ",")
    # load_csv hands the file to the Python reader, whose float() raises
    with pytest.raises(ValueError, match="notanint"):
        ptable.load_csv(str(p), fs)


def test_native_short_row_raises(tmp_path):
    p = tmp_path / "short.csv"
    p.write_text("a1,plus,30,1.5,active\na2,basic\n")
    fs, jfs = FeatureSchema.from_dict(SCHEMA), JaxSchema.from_dict(SCHEMA)
    with pytest.raises(ValueError, match="non-numeric field 2"):
        native_csv.native_load_csv(str(p), fs, ",")
    got = want = None
    try:
        ptable.load_csv(str(p), fs)
    except Exception as exc:
        got = type(exc)
    try:
        jtable.load_csv(str(p), jfs)
    except Exception as exc:
        want = type(exc)
    assert got is want is IndexError


def test_native_bin_codes_match_oracle(tmp_path):
    """Bin codes emitted during the native parse == the host floor-divide
    the Python path computes (negatives and bucket edges included), and
    they survive take_rows."""
    d = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "v", "ordinal": 1, "dataType": "double", "feature": True,
         "min": -50, "max": 150, "bucketWidth": 25},
        {"name": "w", "ordinal": 2, "dataType": "int", "feature": True,
         "min": 0, "max": 1000, "bucketWidth": 100},
    ]}
    rng = np.random.default_rng(8)
    lines = [f"r{i},{v:.4f},{int(w)}" for i, (v, w) in enumerate(
        zip(rng.uniform(-50, 150, 300), rng.integers(0, 1000, 300)))]
    lines += ["b0,-50,0", "b1,150,1000", "b2,-0.0001,100", "b3,24.9999,99"]
    p = tmp_path / "bins.csv"
    p.write_text("\n".join(lines) + "\n")
    nat, py, ref = _all_equal(p, d)
    assert set(nat.binned_cache) == {1, 2} and not py.binned_cache
    for o in (1, 2):
        np.testing.assert_array_equal(nat.binned_codes(o),
                                      py.binned_codes(o))
        np.testing.assert_array_equal(nat.take_rows(5, 105).binned_codes(o),
                                      ref.take_rows(5, 105).binned_codes(o))


def test_native_bin_codes_fractional_width(tmp_path):
    """Non-integer bucketWidth: numpy's // is fmod-corrected floor
    division, not floor(a/b) — 511.8 // 0.1 == 5117 while
    floor(511.8 / 0.1) == 5118.  The native codes must match numpy's."""
    d = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "v", "ordinal": 1, "dataType": "double", "feature": True,
         "min": 0, "max": 1000, "bucketWidth": 0.1},
    ]}
    rng = np.random.default_rng(13)
    vals = np.round(rng.uniform(0, 1000, 2000), 1)
    p = tmp_path / "frac.csv"
    p.write_text("\n".join(f"r{i},{v:.1f}" for i, v in enumerate(vals))
                 + "\n511.8,511.8\n")
    nat, py, _ = _all_equal(p, d)
    assert nat.binned_codes(1)[-1] == 5117
    np.testing.assert_array_equal(nat.binned_codes(1), py.binned_codes(1))


def test_native_bin_cache_is_frozen(tmp_path):
    """Cached codes are returned by reference: mutation fails loudly."""
    d = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "v", "ordinal": 1, "dataType": "int", "feature": True,
         "min": 0, "max": 100, "bucketWidth": 10},
    ]}
    p = tmp_path / "f.csv"
    p.write_text("a,5\nb,15\n")
    nat, _, _ = _all_equal(p, d)
    codes = nat.binned_codes(1)
    with pytest.raises(ValueError):
        codes[0] = -1


def test_native_empty_categorical_field(tmp_path):
    """Empty categorical cells (',,') match the Python reader, with a
    vocabulary that contains the empty string."""
    d = {"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "c", "ordinal": 1, "dataType": "categorical",
         "feature": True, "cardinality": ["", "basic", "plus"]},
        {"name": "v", "ordinal": 2, "dataType": "int", "feature": True,
         "min": 0, "max": 100},
    ]}
    p = tmp_path / "empty.csv"
    p.write_text("a1,,5\na2,basic,6\na3,plus,7\na4,,8\n")
    nat, _, _ = _all_equal(p, d)
    assert nat.columns[1].tolist() == [0, 1, 2, 0]


def test_native_float_forms_match_python(tmp_path):
    """Decimal, exponent and signed forms off the integer fast path match
    float()."""
    rows = ["a0,plus,30,1.5,active", "a1,basic,-7,2.5e3,churned",
            "a2,plus,+4,-0.125,active", "a3,basic,0,1e-3,churned",
            "a4,plus,999999999999999999999,inf,active"]
    p = tmp_path / "floats.csv"
    p.write_text("\n".join(rows) + "\n")
    _all_equal(p)


def test_native_threaded_matches_single(tmp_path, monkeypatch):
    """The thread pool forced on a small file gives the same bytes, rows
    across shard boundaries included."""
    p = tmp_path / "sharded.csv"
    p.write_text(_make_csv(5_000, seed=11))
    single, _, _ = _all_equal(p)
    monkeypatch.setenv("AVENIR_TPU_INGEST_THREADS", "5")
    sharded, _, _ = _all_equal(p)
    _same(sharded, single)
    assert set(sharded.binned_cache) == {2}


def test_native_threaded_crlf(tmp_path, monkeypatch):
    monkeypatch.setenv("AVENIR_TPU_INGEST_THREADS", "3")
    lines = [f"b{i},plus,{i},{i}.5,active" for i in range(500)]
    p = tmp_path / "crlf_sharded.csv"
    p.write_bytes(("\r\n".join(lines) + "\r\n").encode())
    nat, _, _ = _all_equal(p)
    assert nat.n_rows == 500


def test_deferred_string_column_semantics(tmp_path):
    """String columns materialize on first access and behave like the
    Python reader's list: len, indexing (negative and slices), iteration,
    equality."""
    p = tmp_path / "d.csv"
    p.write_text(_make_csv(40))
    fs = FeatureSchema.from_dict(SCHEMA)
    col = ptable.load_csv(str(p), fs).str_columns[0]
    assert repr(col).endswith("deferred)")
    assert len(col) == 40          # no materialization needed for len
    assert repr(col).endswith("deferred)")
    oracle = ptable.load_csv(str(p), fs, use_native=False).str_columns[0]
    assert col[0] == oracle[0] and col[-1] == oracle[-1]
    assert col[3:6] == oracle[3:6]
    assert list(col) == oracle
    assert col == oracle
    assert repr(col).endswith("materialized)")
    with pytest.raises(IndexError):
        col[40]


# --------------------------------------------------------------------------
# the streamed reader
# --------------------------------------------------------------------------

def _streams(path, d=SCHEMA, policy=None, tmp=None, **kw):
    """Chunks and policies of the port's native and Python readers and the
    JAX package's native reader over one file."""
    fs, jfs = FeatureSchema.from_dict(d), JaxSchema.from_dict(d)
    out = {}
    for name in ("native", "python", "jax"):
        pol = None
        if policy is not None:
            q = str(tmp / f"q_{name}") if policy == "quarantine" else None
            pol = (jtable.BadRecordPolicy(policy, q, JaxCounters())
                   if name == "jax" else
                   ptable.BadRecordPolicy(policy, q, Counters()))
        if name == "jax":
            gen = jtable.iter_csv_chunks(str(path), jfs, bad_records=pol,
                                         use_native=True, **kw)
        else:
            gen = ptable.iter_csv_chunks(str(path), fs, bad_records=pol,
                                         use_native=name == "native", **kw)
        out[name] = (list(gen), pol)
    return out


def _quarantine_bytes(pol):
    if pol is None or pol.quarantine_path is None:
        return None
    f = os.path.join(pol.quarantine_path, "part-q-00000")
    return open(f, "rb").read() if os.path.exists(f) else b""


def _streams_equal(runs):
    """Native chunks equal the JAX native ones block for block; all three
    join to the same table, with the same tallies and quarantine bytes."""
    nat, ref = runs["native"][0], runs["jax"][0]
    assert [(c.n_rows, c.source_row_end) for c in nat] == \
        [(c.n_rows, c.source_row_end) for c in ref]
    for g, w in zip(nat, ref):
        _same(g, w)
    if nat:
        whole = ptable.ColumnarTable.from_chunks(nat)
        _same(whole, jtable.ColumnarTable.from_chunks(ref))
        _same(ptable.ColumnarTable.from_chunks(runs["python"][0]), whole,
              bins=False)
    else:
        assert not runs["python"][0] or \
            sum(c.n_rows for c in runs["python"][0]) == 0
    pols = [runs[k][1] for k in runs]
    if pols[0] is not None:
        assert pols[0].counters.as_dict() == pols[1].counters.as_dict() == \
            pols[2].counters.as_dict()
        assert len({_quarantine_bytes(p) for p in pols}) == 1


@pytest.mark.parametrize("chunk", [1, 257, 10 ** 6])
def test_stream_blocks_equal_the_reference(tmp_path, chunk):
    p = tmp_path / "d.csv"
    p.write_text(_make_csv(600, seed=4))
    runs = _streams(p, chunk_rows=chunk)
    _streams_equal(runs)
    assert len(runs["native"][0]) == -(-600 // chunk)
    # whole-file blocks equal the monolithic load
    if chunk == 10 ** 6:
        _same(runs["native"][0][0], ptable.load_csv(
            str(p), FeatureSchema.from_dict(SCHEMA)))


def test_one_row_file(tmp_path):
    p = tmp_path / "one.csv"
    p.write_text("only,premium,999,0.5,churned")     # no final newline
    for chunk in (1, 257):
        runs = _streams(p, chunk_rows=chunk)
        _streams_equal(runs)
        assert [c.n_rows for c in runs["native"][0]] == [1]
    _all_equal(p)


@pytest.mark.parametrize("start_row,stop_row", [(0, None), (41, None),
                                                (299, None), (0, 300),
                                                (41, 257), (600, None)])
def test_start_row_and_stop_row(tmp_path, start_row, stop_row):
    p = tmp_path / "d.csv"
    p.write_text(_make_csv(600, seed=5))
    _streams_equal(_streams(p, chunk_rows=257, start_row=start_row,
                            stop_row=stop_row))


@pytest.mark.parametrize("P", [1, 2, 3, 7])
def test_shards_union_to_the_whole(tmp_path, P):
    p = tmp_path / "d.csv"
    p.write_text(_make_csv(600, seed=6))
    union = []
    for i in range(P):
        runs = _streams(p, chunk_rows=64, shard=(i, P))
        _streams_equal(runs)
        union.extend(runs["native"][0])
    _same(ptable.ColumnarTable.from_chunks(union),
          ptable.load_csv(str(p), FeatureSchema.from_dict(SCHEMA)))


@pytest.mark.parametrize("ending", [b"\n", b"\r\n", b"\r"])
def test_line_ends_and_blank_lines(tmp_path, ending):
    """CRLF and bare-CR line ends, empty and whitespace-only lines (not
    records, not counted as source rows), a last line without an end."""
    lines = _make_csv(300, seed=7).splitlines()
    body = []
    for i, line in enumerate(lines):
        body.append(line.encode())
        if i % 40 == 5:
            body.append(b"")
        if i % 61 == 9:
            body.append(b" \t ")
    p = tmp_path / "ends.csv"
    p.write_bytes(ending.join(body))
    for chunk in (1, 257):
        runs = _streams(p, chunk_rows=chunk, start_row=13)
        _streams_equal(runs)
    _all_equal(p)


@pytest.mark.parametrize("policy", ["skip", "quarantine"])
@pytest.mark.parametrize("chunk", [1, 257, 10 ** 6])
def test_bad_records_skip_and_quarantine(tmp_path, policy, chunk):
    """Garbled numbers and short rows (the last row too) are dropped
    inside native blocks and reported with the same tallies and the same
    quarantine bytes as both Python readers and the JAX native reader."""
    lines = _make_csv(500, seed=8).splitlines()
    for i in (0, 3, 256, 257, 400):
        f = lines[i].split(",")
        f[2] = "x9"
        lines[i] = ",".join(f)
    for i in (100, len(lines) - 1):
        lines[i] = ",".join(lines[i].split(",")[:2])
    p = tmp_path / "bad.csv"
    p.write_text("\r\n".join(lines) + "\r\n")
    runs = _streams(p, policy=policy, tmp=tmp_path, chunk_rows=chunk)
    _streams_equal(runs)
    assert runs["native"][1].counters.as_dict()["BadRecords"][
        "Malformed"] == 7
    if policy == "quarantine":
        q = _quarantine_bytes(runs["native"][1]).decode().splitlines()
        assert q == [lines[i] for i in (0, 3, 100, 256, 257, 400,
                                         len(lines) - 1)]


def test_strict_grammar_hands_over_mid_stream(tmp_path):
    """``1_0`` parses under float() but not under the C grammar: the
    native reader reads the blocks before it, then the Python reader reads
    the rest from the exact row reached, with the reference's warning,
    and the ledger shows the hand-over.  The monolithic load re-parses
    with the Python reader."""
    lines = _make_csv(600, seed=9).splitlines()
    f = lines[300].split(",")
    f[2] = "1_0"
    lines[300] = ",".join(f)
    p = tmp_path / "strict.csv"
    p.write_text("\n".join(lines) + "\n")
    with transfer_ledger() as led:
        with pytest.warns(RuntimeWarning, match="mid-stream at row 257"):
            got = list(ptable.iter_csv_chunks(
                str(p), FeatureSchema.from_dict(SCHEMA), chunk_rows=257))
    with pytest.warns(RuntimeWarning, match="mid-stream at row 257"):
        want = list(jtable.iter_csv_chunks(
            str(p), JaxSchema.from_dict(SCHEMA), chunk_rows=257))
    assert [(c.n_rows, c.source_row_end) for c in got] == \
        [(c.n_rows, c.source_row_end) for c in want] == \
        [(257, 257), (257, 514), (86, 600)]
    for g, w in zip(got, want):
        _same(g, w, bins=False)
    assert got[1].columns[2][299 - 257] == 10.0   # the blank line 7
    assert led.ingest_snapshot() == {
        "native.blocks": 1, "native.rows": 257,
        "python.blocks": 2, "python.rows": 343, "python.handover": 2}
    with transfer_ledger() as led:
        nat, py, ref = _loads(p)
    _same(nat, py)
    _same(nat, ref, bins=False)
    assert led.ingest_snapshot() == {
        "python.blocks": 2, "python.rows": 1200, "python.handover": 1,
        "python.asked": 1}


def test_ledger_counts_each_reader_and_why(tmp_path):
    """Every block lands in ``IngestReaders``: native blocks and rows; a
    Python block for each reason the native reader did not read it."""
    p = tmp_path / "d.csv"
    p.write_text(_make_csv(100, seed=10))
    fs = FeatureSchema.from_dict(SCHEMA)
    with transfer_ledger() as led:
        list(ptable.iter_csv_chunks(str(p), fs, chunk_rows=30))
        list(ptable.iter_csv_chunks(str(p), fs, chunk_rows=60,
                                    use_native=False))
        list(ptable.iter_csv_chunks(str(p), fs, "[,]", chunk_rows=1000))
        ptable.load_csv(str(p), fs, keep_raw=True)
        ptable.load_csv(str(p), fs, bad_records=ptable.BadRecordPolicy(
            "skip"))
        with open(p) as fh:
            ptable.load_csv(fh, fs)
    assert led.ingest_snapshot() == {
        "native.blocks": 4, "native.rows": 100,
        "python.blocks": 6, "python.rows": 500, "python.asked": 2,
        "python.delimiter": 1, "python.keep_raw": 1, "python.policy": 1,
        "python.text": 1}
    c = Counters()
    led.export(c)
    assert c.as_dict()["IngestReaders"]["native.blocks"] == 4


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    """The compiler pointed at a missing source: the build raises
    ``NativeBuildError`` carrying g++'s output whenever the native reader
    was asked for, and never quietly hands over to the Python reader."""
    monkeypatch.setattr(native_csv, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native_csv, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_csv, "_lib", None)
    p = tmp_path / "d.csv"
    p.write_text(_make_csv(20))
    fs = FeatureSchema.from_dict(SCHEMA)
    with pytest.raises(native_csv.NativeBuildError, match="missing.cpp") \
            as exc:
        native_csv.get_lib()
    assert "g++" in str(exc.value)
    with pytest.raises(native_csv.NativeBuildError):
        ptable.load_csv(str(p), fs)
    with pytest.raises(native_csv.NativeBuildError):
        list(ptable.iter_csv_chunks(str(p), fs))
    assert not list((tmp_path / "build").glob("*.so"))
    # asked for the Python reader, the job reads without the library
    assert ptable.load_csv(str(p), fs, use_native=False).n_rows == 20


def test_library_is_named_by_source_flags_and_host(monkeypatch):
    """The library lives beside the CUDA kernels' and its name changes
    with the host's CPU and the flags; the flags keep IEEE rounding."""
    path = native_csv.library_path()
    assert path.parent == native_csv.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "avenir_tpu_torch")
    assert "-ffast-math" not in (*native_csv.CXX_FLAGS, native_csv.ARCH_FLAG)
    assert {"-O3", "-std=c++17"} <= set(native_csv.CXX_FLAGS)
    monkeypatch.setattr(native_csv, "_cpu_model", lambda: "another CPU")
    other_cpu = native_csv.library_path()
    monkeypatch.setattr(native_csv, "CXX_FLAGS",
                        native_csv.CXX_FLAGS + ("-g",))
    assert len({path, other_cpu, native_csv.library_path()}) == 3
