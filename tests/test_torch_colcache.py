"""The port's columnar cache sidecar (``avenir_tpu_torch/io/colcache.py``)
on the CPU, following ``tests/test_colcache.py``: chunks served from the
sidecar equal the CSV parse (the port's readers and the JAX package's)
in dtypes, values, strings, bin codes and ``source_row_end`` under every
bad-record policy and across ``start_row`` cuts; a stale sidecar (size,
mtime, schema) is ignored under ``use``, rebuilt under ``build`` and
refused under ``require``; a torn chunk hands over to the parse (or
raises under ``require``); a resume lands mid-cache; a sharded pass
serves from a hit and never builds, and only process 0 builds; and the
``.avtc`` format is the JAX package's in both directions."""

import json
import os
import warnings

import numpy as np
import pytest

from avenir_tpu.core import table as jtable
from avenir_tpu.core.metrics import Counters as JaxCounters
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.io import colcache as jcolcache

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core import faults
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import (BadRecordPolicy, ColumnarTable,
                                         iter_csv_chunks, load_csv,
                                         prefetch_chunks)
from avenir_tpu_torch.io import colcache
from avenir_tpu_torch.io.colcache import (CachePolicy, CacheWriter,
                                          drop_cache, probe, read_chunk_file,
                                          verify_cache)
from avenir_tpu_torch.parallel.distributed import shard_rows
from avenir_tpu_torch.utils.tracing import transfer_ledger

pytestmark = pytest.mark.colcache

SCHEMA_D = {
    "fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "f1", "ordinal": 1, "dataType": "int", "feature": True,
         "min": 0, "max": 100, "bucketWidth": 25,
         "splitScanInterval": 25, "maxSplit": 2},
        {"name": "f2", "ordinal": 2, "dataType": "categorical",
         "feature": True, "maxSplit": 2, "cardinality": ["x", "y", "z"]},
        {"name": "f3", "ordinal": 3, "dataType": "double", "feature": True,
         "min": 0, "max": 1},
        {"name": "cls", "ordinal": 4, "dataType": "categorical",
         "cardinality": ["0", "1"]},
    ]
}
SCHEMA = FeatureSchema.from_dict(SCHEMA_D)
JSCHEMA = JaxSchema.from_dict(SCHEMA_D)
CHUNK = 64


@pytest.fixture()
def fault_injector():
    """Install a port fault injector from a spec; uninstalled at teardown."""
    def make(spec: str):
        faults.install(faults.FaultInjector.parse(spec))
    yield make
    faults.uninstall()


def gen_csv(path, n=230, seed=7, unknown_cat=True):
    rng = np.random.default_rng(seed)
    toks = "xyzq" if unknown_cat else "xyz"   # 'q' -> unknown code -1
    lines = [f"r{i},{rng.integers(0, 100)},"
             f"{toks[rng.integers(0, len(toks))]},"
             f"{rng.random():.6f},{int(rng.random() < 0.4)}"
             for i in range(n)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return lines


def oracle_chunks(path, start_row=0, bad=None, chunk=CHUNK):
    """The JAX package's python reader: the parse every cached replay is
    held to."""
    return list(jtable.iter_csv_chunks(str(path), JSCHEMA, ",",
                                       chunk_rows=chunk, use_native=False,
                                       bad_records=bad, start_row=start_row))


def cached_chunks(path, policy="use", start_row=0, bad=None, chunk=CHUNK,
                  counters=None, stats=None, **kw):
    cp = CachePolicy(policy, counters=counters, stats=stats)
    return list(iter_csv_chunks(str(path), SCHEMA, ",", chunk_rows=chunk,
                                bad_records=bad, start_row=start_row,
                                cache=cp, **kw)), cp


def build_cache(path, bad=None, chunk=CHUNK, use_native=True,
                counters=None):
    cp = CachePolicy("build", counters=counters)
    chunks = list(iter_csv_chunks(str(path), SCHEMA, ",", chunk_rows=chunk,
                                  use_native=use_native, bad_records=bad,
                                  cache=cp))
    return chunks, cp


def assert_tables_equal(a_chunks, b_chunks):
    """Assembled-table bit equality: dtypes, values, strings, bin codes
    (block boundaries differ between the native and python readers under
    skipping policies; the joined table is the pinned axis)."""
    A = ColumnarTable.from_chunks(list(a_chunks))
    B = ColumnarTable.from_chunks(list(b_chunks))
    assert A.n_rows == B.n_rows
    assert set(A.columns) == set(B.columns)
    for o in A.columns:
        assert A.columns[o].dtype == B.columns[o].dtype, o
        assert A.columns[o].tobytes() == B.columns[o].tobytes(), o
    assert set(A.str_columns) == set(B.str_columns)
    for o in A.str_columns:
        assert list(A.str_columns[o]) == list(B.str_columns[o]), o
    for f in A.schema.fields:
        if f.is_binned and f.ordinal in A.columns:
            np.testing.assert_array_equal(A.binned_codes(f.ordinal),
                                          B.binned_codes(f.ordinal))
    return A, B


def assert_chunks_equal(got, want):
    """Block for block: rows, ``source_row_end``, columns, bin caches."""
    assert [(c.n_rows, c.source_row_end) for c in got] == \
        [(c.n_rows, c.source_row_end) for c in want]
    for g, w in zip(got, want):
        assert_tables_equal([g], [w])
        assert sorted(g.binned_cache) == sorted(w.binned_cache)
        for o in g.binned_cache:
            assert g.binned_cache[o].tobytes() == w.binned_cache[o].tobytes()


# --------------------------------------------------------------------------
# round-trip parity
# --------------------------------------------------------------------------

def test_round_trip_bit_identical_to_oracle(tmp_path):
    csv = tmp_path / "d.csv"
    gen_csv(csv)
    ctr = Counters()
    built, cpb = build_cache(csv, counters=ctr)
    assert cpb.tallies == {"Miss": 1,
                           "BytesWritten": cpb.tallies["BytesWritten"],
                           "Built": 1}
    assert probe(str(csv), SCHEMA, ",")[0] == "hit"
    assert verify_cache(str(csv) + ".avtc", schema=SCHEMA,
                        csv_path=str(csv), delim=",") == []
    stats = {}
    with transfer_ledger() as led:
        cached, cpu = cached_chunks(csv, "require", counters=ctr,
                                    stats=stats)
    assert cpu.tallies["Hit"] == 1
    assert cpu.tallies["BytesRead"] == cpb.tallies["BytesWritten"]
    assert stats["cache_read_s"] >= 0
    g = ctr.as_dict()["ColumnarCache"]
    assert g["Hit"] == 1 and g["Built"] == 1 and g["Miss"] == 1
    # every served block is a cache block in the ledger
    assert led.ingest_snapshot() == {"cache.blocks": 4, "cache.rows": 230}
    oracle = oracle_chunks(csv)
    A, B = assert_tables_equal(oracle, cached)
    assert (B.columns[2] == -1).any()   # unknown categoricals survived
    assert_chunks_equal(cached, built)
    assert [c.source_row_end for c in cached] == \
        [c.source_row_end for c in oracle]


def test_cache_built_by_python_parser_matches(tmp_path):
    """A sidecar written from the python reader's pass serves the same
    bytes (without bin caches, which only the native reader emits)."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=150)
    build_cache(csv, use_native=False)
    cached, _ = cached_chunks(csv, "require")
    assert_tables_equal(oracle_chunks(csv), cached)
    assert not cached[0].binned_cache


def test_packed_dtypes_on_disk(tmp_path):
    """Cardinality-3 categoricals pack to int8, schema-integer numerics
    whose values fit pack to int32, doubles stay float64, native bin codes
    pack to int8; loads upcast to int32 / float64."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=80)
    build_cache(csv)
    manifest, _ = read_chunk_file(
        CacheWriter.chunk_path(str(csv) + ".avtc", 0))
    dt = {(c["ordinal"], c["kind"]): c["dtype"] for c in manifest["cols"]}
    assert dt[(2, "cat")] == "|i1" and dt[(4, "cat")] == "|i1"
    assert dt[(1, "num")] == "<i4"      # int field, values 0..99
    assert dt[(3, "num")] == "<f8"      # fractional double: stays wide
    assert dt[(1, "bin")] == "|i1"      # codes 0..3
    cached, _ = cached_chunks(csv, "require")
    assert cached[0].columns[2].dtype == np.int32
    assert cached[0].columns[1].dtype == np.float64
    assert cached[0].binned_cache[1].dtype == np.int32
    assert not cached[0].binned_cache[1].flags.writeable


def test_wide_cardinality_packs_int16(tmp_path):
    d = {"fields": [
        {"name": "c", "ordinal": 0, "dataType": "categorical",
         "feature": True, "cardinality": [f"v{i}" for i in range(300)]},
        {"name": "cls", "ordinal": 1, "dataType": "categorical",
         "cardinality": ["0", "1"]}]}
    wide = FeatureSchema.from_dict(d)
    csv = tmp_path / "w.csv"
    with open(csv, "w") as fh:
        fh.write("\n".join(f"v{i % 300},{i % 2}" for i in range(64)) + "\n")
    built = list(iter_csv_chunks(str(csv), wide, ",", chunk_rows=32,
                                 cache=CachePolicy("build")))
    manifest, _ = read_chunk_file(
        CacheWriter.chunk_path(str(csv) + ".avtc", 0))
    dt = {(c["ordinal"], c["kind"]): c["dtype"] for c in manifest["cols"]}
    assert dt[(0, "cat")] == "<i2"
    cached = list(iter_csv_chunks(str(csv), wide, ",", chunk_rows=32,
                                  cache=CachePolicy("require")))
    np.testing.assert_array_equal(
        np.concatenate([c.columns[0] for c in built]),
        np.concatenate([c.columns[0] for c in cached]))


def test_load_csv_through_cache(tmp_path):
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=120)
    plain = load_csv(str(csv), SCHEMA, ",")
    built = load_csv(str(csv), SCHEMA, ",", cache=CachePolicy("build"))
    warm = load_csv(str(csv), SCHEMA, ",", cache=CachePolicy("require"))
    for t in (built, warm):
        assert_tables_equal([plain], [t])
    # require refuses the uncacheable raw-row form instead of re-parsing
    with pytest.raises(ValueError, match="require"):
        load_csv(str(csv), SCHEMA, ",", keep_raw=True,
                 cache=CachePolicy("require"))


def test_empty_csv_round_trip(tmp_path):
    csv = tmp_path / "e.csv"
    csv.write_text("")
    _, cp = build_cache(csv)
    assert cp.tallies.get("Built") == 1
    assert probe(str(csv), SCHEMA, ",")[0] == "hit"
    cached, _ = cached_chunks(csv, "require")
    assert cached == []
    assert load_csv(str(csv), SCHEMA, ",",
                    cache=CachePolicy("require")).n_rows == 0


# --------------------------------------------------------------------------
# bad-record policy fidelity on cached replays
# --------------------------------------------------------------------------

def _corrupt(csv, rows=(3, 64, 65, 150, 228, 229)):
    # two TRAILING bad rows: a python-built sidecar carries them in the
    # header's tail manifest (no block is yielded after them)
    return faults.corrupt_csv_rows(str(csv), list(rows), seed=9, field=1)


@pytest.mark.parametrize("use_native", [True, False])
def test_quarantine_bytes_and_counters_identical(tmp_path, use_native):
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=3)
    corrupted = _corrupt(csv)
    c1, c2, c3 = Counters(), Counters(), JaxCounters()
    q1, q2, q3 = tmp_path / "q1", tmp_path / "q2", tmp_path / "q3"
    built, _ = build_cache(csv, bad=BadRecordPolicy("quarantine", str(q1),
                                                    c1),
                           use_native=use_native)
    cached, _ = cached_chunks(csv, "use",
                              bad=BadRecordPolicy("quarantine", str(q2),
                                                  c2))
    oracle = oracle_chunks(csv, bad=jtable.BadRecordPolicy(
        "quarantine", str(q3), c3))
    assert_tables_equal(built, cached)
    assert_tables_equal(oracle, cached)
    b1 = (q1 / "part-q-00000").read_text()
    assert b1 == (q2 / "part-q-00000").read_text() == \
        (q3 / "part-q-00000").read_text()
    assert b1.splitlines() == corrupted
    assert c1.as_dict()["BadRecords"] == c2.as_dict()["BadRecords"] == \
        c3.as_dict()["BadRecords"]
    assert c2.get("BadRecords", "Malformed") == len(corrupted)


def test_skip_policy_counters_match_oracle(tmp_path):
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=5)
    _corrupt(csv)
    build_cache(csv, bad=BadRecordPolicy("skip"))
    co, cc = JaxCounters(), Counters()
    oracle = oracle_chunks(csv, bad=jtable.BadRecordPolicy("skip",
                                                           counters=co))
    cached, _ = cached_chunks(csv, "use",
                              bad=BadRecordPolicy("skip", counters=cc))
    assert_tables_equal(oracle, cached)
    assert co.as_dict() == cc.as_dict()


def test_fail_policy_raises_on_cached_replay(tmp_path):
    """A sidecar built under a skipping policy replayed under fail raises
    as the parse would: the manifest keeps the bad records."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=6)
    _corrupt(csv)
    build_cache(csv, bad=BadRecordPolicy("skip"))
    with pytest.raises(ValueError, match="malformed"):
        cached_chunks(csv, "require", bad=None)
    with pytest.raises(ValueError, match="malformed"):
        cached_chunks(csv, "require", bad=BadRecordPolicy("fail"))


def test_trailing_bad_rows_only_tail(tmp_path):
    """Bad records after the last good row survive the round trip (a
    python-built sidecar carries them in the header's tail manifest)."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=70, seed=8)
    faults.corrupt_csv_rows(str(csv), [68, 69], field=1)
    build_cache(csv, bad=BadRecordPolicy("skip"), use_native=False)
    cc = Counters()
    cached, _ = cached_chunks(csv, "require",
                              bad=BadRecordPolicy("skip", counters=cc))
    assert cc.get("BadRecords", "Malformed") == 2
    assert sum(c.n_rows for c in cached) == 68
    cc2 = Counters()     # resume past the tail: nothing re-reported
    cached_chunks(csv, "require", start_row=70,
                  bad=BadRecordPolicy("skip", counters=cc2))
    assert cc2.get("BadRecords", "Malformed") == 0


# --------------------------------------------------------------------------
# start_row resume lands mid-cache exactly where the parser would
# --------------------------------------------------------------------------

def test_start_row_resume_parity(tmp_path):
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=4)
    _corrupt(csv)
    build_cache(csv, bad=BadRecordPolicy("skip"))
    for s in (0, 1, 3, 4, 64, 65, 70, 128, 200, 229, 230):
        co, cc = JaxCounters(), Counters()
        oracle = oracle_chunks(csv, start_row=s,
                               bad=jtable.BadRecordPolicy("skip",
                                                          counters=co))
        cached, cp = cached_chunks(csv, "use", start_row=s,
                                   bad=BadRecordPolicy("skip",
                                                       counters=cc))
        assert cp.tallies.get("Hit") == 1, s
        if oracle:
            assert_tables_equal(oracle, cached)
        else:
            assert sum(c.n_rows for c in cached) == 0
        assert co.as_dict() == cc.as_dict(), s


def test_build_disabled_on_resumed_pass(tmp_path):
    """A pass starting mid-stream must not pass for a full cache."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=100)
    chunks, cp = cached_chunks(csv, "build", start_row=10)
    assert sum(c.n_rows for c in chunks) == 90
    assert cp.tallies.get("Built") is None
    assert probe(str(csv), SCHEMA, ",")[0] == "miss"


# --------------------------------------------------------------------------
# staleness / invalidation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("change", ["mtime", "size"])
def test_source_change_goes_stale_then_rebuilds(tmp_path, change):
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=100)
    build_cache(csv)
    st = os.stat(csv)
    if change == "mtime":
        os.utime(csv, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    else:
        with open(csv, "a") as fh:
            fh.write("r100,5,x,0.5,1\n")
        os.utime(csv, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert probe(str(csv), SCHEMA, ",")[0] == "stale"
    # use: parses (Miss), does not rebuild
    chunks, cp = cached_chunks(csv, "use")
    assert cp.tallies == {"Miss": 1, "Stale": 1}
    assert probe(str(csv), SCHEMA, ",")[0] == "stale"
    assert_tables_equal(oracle_chunks(csv), chunks)
    # require: refuses
    with pytest.raises(FileNotFoundError, match="require"):
        cached_chunks(csv, "require")
    # build: rebuilds
    chunks, cp = build_cache(csv)
    assert cp.tallies.get("StaleRebuilt") == 1
    assert probe(str(csv), SCHEMA, ",")[0] == "hit"
    assert_tables_equal(oracle_chunks(csv), cached_chunks(csv)[0])


def test_fingerprint_mismatch_is_stale(tmp_path):
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=100)
    build_cache(csv)
    # the block budget is not identity: another budget still hits and
    # serves the sidecar's own boundaries, values identical
    other_budget, cp = cached_chunks(csv, "require", chunk=CHUNK * 2)
    assert cp.tallies.get("Hit") == 1
    assert [c.n_rows for c in other_budget] == [64, 36]
    assert_tables_equal(oracle_chunks(csv), other_budget)
    # the schema is identity: the vocabulary order changes the codes
    other = FeatureSchema.from_dict(json.loads(json.dumps(SCHEMA_D)))
    other.fields[2].cardinality = ["y", "x", "z"]
    assert probe(str(csv), other, ",")[0] == "stale"
    assert probe(str(csv), SCHEMA, ";")[0] == "stale"
    for policy, want in (("use", {"Miss": 1, "Stale": 1}),
                         ("build", {"Miss": 1, "Stale": 1,
                                    "StaleRebuilt": 1, "Built": 1})):
        cp = CachePolicy(policy)
        got = list(iter_csv_chunks(str(csv), other, ",", chunk_rows=CHUNK,
                                   cache=cp))
        assert {k: v for k, v in cp.tallies.items()
                if not k.startswith("Bytes")} == want
        assert sum(c.n_rows for c in got) == 100
    assert probe(str(csv), SCHEMA, ",")[0] == "stale"
    with pytest.raises(FileNotFoundError, match="require"):
        cached_chunks(csv, "require")


def test_require_on_missing_cache_refuses(tmp_path):
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=50)
    with pytest.raises(FileNotFoundError, match="require"):
        cached_chunks(csv, "require")


def test_bad_policy_string_refused():
    with pytest.raises(ValueError, match="cache.policy"):
        CachePolicy("cache-me-if-you-can")


# --------------------------------------------------------------------------
# torn sidecars and interrupted builds
# --------------------------------------------------------------------------

def _chunk_files(csv):
    cdir = str(csv) + ".avtc"
    return cdir, sorted(f for f in os.listdir(cdir)
                        if f.startswith("chunk_"))


@pytest.mark.parametrize("tear", ["truncate", "garble", "remove"])
def test_torn_chunk_degrades_to_parse(tmp_path, tear):
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=11)
    build_cache(csv)
    cdir, files = _chunk_files(csv)
    victim = os.path.join(cdir, files[1])
    data = open(victim, "rb").read()
    if tear == "truncate":
        open(victim, "wb").write(data[:len(data) // 2])
    elif tear == "garble":
        open(victim, "wb").write(b"\x00" * len(data))
    else:
        os.remove(victim)
    with transfer_ledger() as led, \
            warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cached, cp = cached_chunks(csv, "use")
    assert any("degrading to CSV parse" in str(x.message) for x in w)
    assert_tables_equal(oracle_chunks(csv), cached)
    # block 0 from the sidecar, the rest parsed natively from row 64
    assert led.ingest_snapshot() == {"cache.blocks": 1, "cache.rows": 64,
                                     "native.blocks": 3,
                                     "native.rows": 230 - 64}
    assert verify_cache(cdir) != []


def test_require_raises_on_torn_chunk(tmp_path):
    """require serves or refuses: a torn chunk raises."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=14)
    build_cache(csv)
    cdir, files = _chunk_files(csv)
    os.remove(os.path.join(cdir, files[1]))
    with pytest.raises(colcache.CacheChunkError, match="require"):
        cached_chunks(csv, "require")


def test_no_build_dir_leftovers(tmp_path, fault_injector):
    """A finished and an abandoned build leave no private .build-*
    directory; a dead build's orphan is reaped by the next build."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=100)

    def build_dirs():
        return [f for f in os.listdir(tmp_path) if ".avtc.build-" in f]

    build_cache(csv)
    assert build_dirs() == []
    st = os.stat(csv)
    os.utime(csv, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    fault_injector("cache_write@0=raise:OSError")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        build_cache(csv)
    assert build_dirs() == []
    faults.uninstall()
    orphan = str(csv) + ".avtc.build-999999999-deadbeef"
    os.makedirs(orphan)
    build_cache(csv)
    assert build_dirs() == []
    assert_tables_equal(oracle_chunks(csv), cached_chunks(csv)[0])


def test_torn_header_is_a_miss(tmp_path):
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=100)
    build_cache(csv)
    hdr = os.path.join(str(csv) + ".avtc", "header.json")
    open(hdr, "w").write('{"format":')   # torn mid-write
    assert probe(str(csv), SCHEMA, ",")[0] == "miss"
    chunks, cp = cached_chunks(csv, "use")
    assert cp.tallies == {"Miss": 1}     # a torn header is no cache
    assert_tables_equal(oracle_chunks(csv), chunks)


@pytest.mark.faultinject
def test_interrupted_build_leaves_no_cache_and_training_unaffected(
        tmp_path, fault_injector):
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=12)
    fault_injector("cache_write@2=raise:OSError")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        chunks, cp = build_cache(csv)
    assert any("abandoning the build" in str(x.message) for x in w)
    assert cp.tallies.get("Built") is None
    assert_tables_equal(oracle_chunks(csv), chunks)
    assert probe(str(csv), SCHEMA, ",")[0] == "miss"
    faults.uninstall()
    _, cp2 = build_cache(csv)
    assert cp2.tallies.get("Built") == 1
    assert_tables_equal(oracle_chunks(csv), cached_chunks(csv)[0])


@pytest.mark.faultinject
def test_cache_read_fault_degrades_to_parse(tmp_path, fault_injector):
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=13)
    build_cache(csv)
    fault_injector("cache_read@1=raise:OSError")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cached, _ = cached_chunks(csv, "use")
    assert any("degrading to CSV parse" in str(x.message) for x in w)
    assert_tables_equal(oracle_chunks(csv), cached)


def test_drop_cache_removes_the_sidecar_and_every_build_dir(tmp_path):
    """``drop_cache`` removes the sidecar and any build directory, a live
    build's too; the next pass is a miss.  A second drop finds
    nothing."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=80)
    build_cache(csv)
    cdir = str(csv) + ".avtc"
    live = f"{cdir}.build-{os.getpid()}-cafef00d"
    os.makedirs(live)
    assert drop_cache(cdir) is True
    assert not os.path.exists(cdir) and not os.path.exists(live)
    assert probe(str(csv), SCHEMA, ",")[0] == "miss"
    assert drop_cache(cdir) is False


def test_abandoned_consumer_never_finalizes(tmp_path):
    """A consumer that abandons a building stream leaves no header."""
    csv = tmp_path / "d.csv"
    gen_csv(csv)
    cp = CachePolicy("build")
    it = iter_csv_chunks(str(csv), SCHEMA, ",", chunk_rows=CHUNK, cache=cp)
    next(it)
    it.close()
    assert probe(str(csv), SCHEMA, ",")[0] == "miss"
    assert cp.tallies.get("Built") is None


# --------------------------------------------------------------------------
# shards and processes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 3])
def test_sharded_hit_serves_each_shards_rows(tmp_path, P):
    """A sharded pass over a fresh sidecar serves only its shard's
    source-row window, the same split the parse uses: each shard's blocks
    equal its parsed shard's, with the same tallies, and the shards
    together are the whole file."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=15)
    _corrupt(csv)
    build_cache(csv, bad=BadRecordPolicy("skip"))
    union = []
    for i in range(P):
        cc, cp_ = Counters(), Counters()
        cached, cp = cached_chunks(csv, "use", shard=(i, P),
                                   bad=BadRecordPolicy("skip", counters=cc))
        parsed = list(iter_csv_chunks(str(csv), SCHEMA, ",",
                                      chunk_rows=CHUNK, shard=(i, P),
                                      bad_records=BadRecordPolicy(
                                          "skip", counters=cp_)))
        assert cp.tallies.get("Hit") == 1
        assert_chunks_equal(cached, parsed)
        assert cc.as_dict() == cp_.as_dict()
        lo, hi = shard_rows(230, i, P, CHUNK)
        assert all(lo < c.source_row_end <= hi for c in cached)
        union.extend(cached)
    assert_tables_equal(oracle_chunks(csv, bad=jtable.BadRecordPolicy(
        "skip")), union)


def test_only_process_zero_builds(tmp_path, monkeypatch):
    """A sharded pass never builds, and over several processes only
    process 0 builds; the others parse and count BuildSkipped."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=150)
    chunks, cp = cached_chunks(csv, "build", shard=(0, 2))
    assert cp.tallies == {"Miss": 1, "BuildSkipped": 1}
    assert probe(str(csv), SCHEMA, ",")[0] == "miss"
    monkeypatch.setenv("AVENIR_TPU_SHARD", "1/2")
    chunks, cp = build_cache(csv)
    assert cp.tallies == {"Miss": 1, "BuildSkipped": 1}
    assert probe(str(csv), SCHEMA, ",")[0] == "miss"
    monkeypatch.setenv("AVENIR_TPU_SHARD", "0/2")
    chunks, cp = build_cache(csv)
    assert cp.tallies.get("Built") == 1
    assert probe(str(csv), SCHEMA, ",")[0] == "hit"


# --------------------------------------------------------------------------
# the .avtc format is the JAX package's, both ways
# --------------------------------------------------------------------------

def _manifests(cdir):
    """Each chunk's manifest (build id dropped) and payload bytes."""
    out = []
    for f in sorted(os.listdir(cdir)):
        if f.startswith("chunk_"):
            m, buf = read_chunk_file(os.path.join(cdir, f))
            m.pop("build_id")
            base = m.pop("_payload_base")
            out.append((m, buf[base:]))
    return out


@pytest.mark.parametrize("made_by", ["jax", "port"])
def test_sidecars_interchange_with_the_jax_package(tmp_path, made_by):
    """A sidecar built by either package (native reader, quarantine
    policy) is a hit for the other, passes the other's ``verify_cache``,
    and serves the other the blocks its own sidecar serves it: the same
    format, fingerprint and chunk bytes."""
    csv = tmp_path / "d.csv"
    gen_csv(csv, seed=16)
    _corrupt(csv)
    d_port, d_jax = str(tmp_path / "port.avtc"), str(tmp_path / "jax.avtc")
    list(iter_csv_chunks(str(csv), SCHEMA, ",", chunk_rows=CHUNK,
                         bad_records=BadRecordPolicy("skip"),
                         cache=CachePolicy("build", cache_dir=d_port)))
    list(jtable.iter_csv_chunks(
        str(csv), JSCHEMA, ",", chunk_rows=CHUNK,
        bad_records=jtable.BadRecordPolicy("skip"),
        cache=jcolcache.CachePolicy("build", cache_dir=d_jax)))
    assert _manifests(d_port) == _manifests(d_jax)
    built = d_jax if made_by == "jax" else d_port
    assert colcache.schema_fingerprint(SCHEMA, ",") == \
        jcolcache.schema_fingerprint(JSCHEMA, ",")
    assert verify_cache(built, schema=SCHEMA, csv_path=str(csv),
                        delim=",") == []
    assert jcolcache.verify_cache(built, schema=JSCHEMA, csv_path=str(csv),
                                  delim=",") == []

    def serve(pkg, cdir, tag):
        q = str(tmp_path / f"q_{pkg}_{tag}")
        if pkg == "port":
            c = Counters()
            cp = CachePolicy("require", cache_dir=cdir)
            got = list(iter_csv_chunks(
                str(csv), SCHEMA, ",", chunk_rows=CHUNK, cache=cp,
                bad_records=BadRecordPolicy("quarantine", q, c)))
        else:
            c = JaxCounters()
            cp = jcolcache.CachePolicy("require", cache_dir=cdir)
            got = list(jtable.iter_csv_chunks(
                str(csv), JSCHEMA, ",", chunk_rows=CHUNK, cache=cp,
                bad_records=jtable.BadRecordPolicy("quarantine", q, c)))
        assert cp.tallies["Hit"] == 1
        return got, c.as_dict(), open(os.path.join(q, "part-q-00000")).read()
    other = "port" if made_by == "jax" else "jax"
    own = d_port if other == "port" else d_jax
    got, c_got, q_got = serve(other, built, "theirs")
    want, c_want, q_want = serve(other, own, "own")
    assert_chunks_equal(got, want)
    assert c_got == c_want and q_got == q_want


# --------------------------------------------------------------------------
# the streamed forest and the job
# --------------------------------------------------------------------------

def _forest_csv(tmp_path, n=500):
    csv = tmp_path / "train.csv"
    gen_csv(csv, n=n, seed=21, unknown_cat=False)
    return csv


def test_streamed_forest_bit_identical_through_cache(tmp_path):
    from avenir_tpu_torch.models.forest import (ForestParams,
                                                build_forest_from_stream)
    csv = _forest_csv(tmp_path)
    params = ForestParams(num_trees=3, seed=11)
    params.tree.max_depth = 2

    def run(cache=None, stats=None):
        blocks = prefetch_chunks(
            iter_csv_chunks(str(csv), SCHEMA, ",", chunk_rows=96,
                            cache=cache),
            stats=stats, consumer_wait_key=None)
        return [m.to_json() for m in build_forest_from_stream(
            blocks, SCHEMA, params, device="cpu", stats=stats)]

    plain = run()
    built = run(cache=CachePolicy("build"))
    stats = {}
    warm = run(cache=CachePolicy("require", stats=stats))
    assert built == plain and warm == plain
    assert stats["cache_read_s"] > 0


def _job_props(tmp_path, tag, schema_path, extra):
    props = tmp_path / f"rafo_{tag}.properties"
    props.write_text(
        "field.delim.regex=,\n"
        f"dtb.feature.schema.file.path={schema_path}\n"
        "dtb.max.depth.limit=2\n"
        "dtb.num.trees=3\n"
        "dtb.streaming.ingest=true\n" + extra)
    return props


def _job(props, csv, out, *args):
    assert port_run.main(["randomForestBuilder", f"-Dconf.path={props}",
                          "-Dplatform=cpu", *args, str(csv),
                          str(out)]) == 0
    with open(str(out) + ".counters.json") as fh:
        counters = json.load(fh)
    return {f: (out / f).read_text() for f in sorted(os.listdir(out))
            if f.endswith(".json")}, counters


def test_job_level_cache_knob_and_counters(tmp_path):
    """dtb.streaming.cache.policy=build then =require through the port's
    CLI: the JAX package's trees, the ColumnarCache group in the counters
    (the warm pass reads the bytes the cold pass wrote), and every block
    of the warm pass served from the sidecar."""
    from avenir_tpu.cli import run as jax_run
    csv = _forest_csv(tmp_path, n=300)
    schema_path = tmp_path / "s.json"
    schema_path.write_text(json.dumps(SCHEMA_D))
    outputs, counters = {}, {}
    for mode in ("build", "require"):
        props = _job_props(tmp_path, mode, schema_path,
                           "dtb.streaming.block.rows=128\n"
                           f"dtb.streaming.cache.policy={mode}\n")
        outputs[mode], counters[mode] = _job(props, csv,
                                             tmp_path / f"forest_{mode}")
    assert outputs["build"] == outputs["require"]
    cold, warm = (counters[m]["ColumnarCache"] for m in ("build", "require"))
    assert cold["Built"] == 1 and warm["Hit"] == 1
    assert warm["BytesRead"] == cold["BytesWritten"]
    assert counters["build"]["IngestReaders"] == {"native.blocks": 3,
                                                  "native.rows": 300}
    assert counters["require"]["IngestReaders"] == {"cache.blocks": 3,
                                                    "cache.rows": 300}
    jout = tmp_path / "forest_jax"
    props = _job_props(tmp_path, "jax", schema_path,
                       "dtb.streaming.block.rows=128\n")
    assert jax_run.main(["randomForestBuilder", f"-Dconf.path={props}",
                         str(csv), str(jout)]) == 0
    assert outputs["require"] == {f: (jout / f).read_text()
                                  for f in sorted(os.listdir(jout))
                                  if f.endswith(".json")}


@pytest.mark.faultinject
def test_resume_with_cache_bit_identical(tmp_path, fault_injector,
                                         monkeypatch):
    """Crash mid-cache under cache.policy=use, then --resume: model and
    quarantine bytes equal the clean CSV-parsed run's."""
    monkeypatch.setattr(faults, "RETRY_BASE_S", 0.0)
    csv = tmp_path / "train.csv"
    gen_csv(csv, n=240, seed=13, unknown_cat=False)
    corrupted = faults.corrupt_csv_rows(str(csv), [30, 99, 201], seed=9,
                                        field=1)
    schema_path = tmp_path / "s.json"
    schema_path.write_text(json.dumps(SCHEMA_D))

    def conf(tag, cache_mode):
        return _job_props(
            tmp_path, tag, schema_path,
            "dtb.streaming.block.rows=48\n"
            f"dtb.streaming.checkpoint.dir={tmp_path / ('ck_' + tag)}\n"
            "dtb.streaming.checkpoint.blocks=1\n"
            "badrecords.policy=quarantine\n"
            f"badrecords.quarantine.path={tmp_path / ('q_' + tag)}\n"
            + (f"dtb.streaming.cache.policy={cache_mode}\n"
               if cache_mode else ""))

    clean, _ = _job(conf("clean", None), csv, tmp_path / "out_clean")
    built, _ = _job(conf("build", "build"), csv, tmp_path / "out_build")
    assert built == clean
    props = conf("use", "use")
    fault_injector("cache_read@2=raise:RuntimeError")
    out = tmp_path / "out_use"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="injected fault"):
            port_run.main(["randomForestBuilder", f"-Dconf.path={props}",
                           "-Dplatform=cpu", str(csv), str(out)])
    faults.uninstall()
    resumed, counters = _job(props, csv, out, "--resume")
    assert resumed == clean
    assert counters["ColumnarCache"]["Hit"] == 1
    assert counters["Checkpoint"]["ResumedFromStep"] == 2
    # the quarantine across crash and resume matches exactly (stride 1)
    assert (tmp_path / "q_use" / "part-q-00000").read_text().splitlines() \
        == corrupted


def test_quarantine_dir_created_once(tmp_path, monkeypatch):
    import avenir_tpu_torch.core.table as table_mod
    calls = []
    real = os.makedirs
    monkeypatch.setattr(table_mod.os, "makedirs",
                        lambda *a, **k: (calls.append(a), real(*a, **k)))
    pol = BadRecordPolicy("quarantine", str(tmp_path / "q"))
    for i in range(5):
        pol.record([f"bad,{i}"])
    assert len(calls) == 1
    assert (tmp_path / "q" / "part-q-00000").read_text().splitlines() \
        == [f"bad,{i}" for i in range(5)]
