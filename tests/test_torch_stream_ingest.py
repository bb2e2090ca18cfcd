"""The streamed ingest's host stages, port against the JAX package on the
CPU: the chunked CSV reader (``iter_csv_chunks``: blocks, ``source_row_end``,
``start_row`` resume, skip/quarantine tallies and bytes against the
reference's python reader), ``ColumnarTable.from_chunks``, the monolithic
skip/quarantine load, the producer threads (``prefetch_chunks`` /
``stage_chunks``: a failure raised exactly once, in order, and the source
closed when the consumer walks away), ``CheckpointManager`` (save, restore,
torn steps, retention, each package reading the other's steps) and the
fault injector."""

import json
import os
import threading
import time
import warnings

import numpy as np
import pytest

from avenir_tpu.core import checkpoint as jckpt
from avenir_tpu.core import faults as jfaults
from avenir_tpu.core import table as jtable
from avenir_tpu.core.metrics import Counters as JaxCounters
from avenir_tpu.core.schema import FeatureSchema as JaxSchema

from avenir_tpu_torch.core import checkpoint as pckpt
from avenir_tpu_torch.core import faults as pfaults
from avenir_tpu_torch.core import table as ptable
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.utils.tracing import transfer_ledger

# an id, a numeric and a categorical feature, a class; a float feature
# too, so a garbled number and a short row are both malformed
SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "age", "ordinal": 1, "dataType": "int", "feature": True,
     "min": 0, "max": 100, "splitScanInterval": 20, "maxSplit": 3},
    {"name": "color", "ordinal": 2, "dataType": "categorical",
     "feature": True, "maxSplit": 2, "cardinality": ["x", "y", "z"]},
    {"name": "score", "ordinal": 3, "dataType": "double", "feature": True,
     "min": 0.0, "max": 1.0, "splitScanInterval": 0.25},
    {"name": "label", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["0", "1"]},
]}
N_ROWS = 600
GARBLED = (0, 17, 256, 257, 599)
TRUNCATED = (40, 300)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A CSV with blank lines and CRLF endings mixed in, corrupted by the
    JAX package's ``corrupt_csv_rows``; the two schemas."""
    d = tmp_path_factory.mktemp("stream_ingest")
    schema_path = d / "schema.json"
    schema_path.write_text(json.dumps(SCHEMA))
    rng = np.random.default_rng(5)
    lines = [f"r{i},{rng.integers(0, 100)},{'xyzw'[rng.integers(0, 4)]},"
             f"{rng.random():.3f},{int(rng.random() < 0.4)}"
             for i in range(N_ROWS)]
    csv = d / "train.csv"
    body = []
    for i, line in enumerate(lines):
        body.append(line + ("\r" if i % 7 == 3 else ""))
        if i % 50 == 10:
            body.append("")
    csv.write_text("\n".join(body) + "\n")
    bad = jfaults.corrupt_csv_rows(str(csv), GARBLED, seed=3, field=3)
    bad += jfaults.corrupt_csv_rows(str(csv), TRUNCATED, seed=3,
                                    mode="truncate")
    return (str(csv), FeatureSchema.load(str(schema_path)),
            JaxSchema.load(str(schema_path)), bad)


def _table_equal(p, j):
    assert p.n_rows == j.n_rows
    assert sorted(p.columns) == sorted(j.columns)
    for o in p.columns:
        assert p.columns[o].dtype == j.columns[o].dtype
        np.testing.assert_array_equal(p.columns[o], j.columns[o])
    assert sorted(p.str_columns) == sorted(j.str_columns)
    for o in p.str_columns:
        assert list(p.str_columns[o]) == list(j.str_columns[o])


def _policies(tmp_path, policy):
    if policy is None:
        return None, None
    pc, jc = Counters(), JaxCounters()
    pq = str(tmp_path / "pq") if policy == "quarantine" else None
    jq = str(tmp_path / "jq") if policy == "quarantine" else None
    return (ptable.BadRecordPolicy(policy, pq, pc),
            jtable.BadRecordPolicy(policy, jq, jc))


def _quarantine(pol):
    if pol is None or pol.quarantine_path is None:
        return None
    path = os.path.join(pol.quarantine_path, "part-q-00000")
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as fh:
        return fh.read()


def _stream_run(tmp_path, tag, policy, reader, **kw):
    """(chunks, policy) of one reader over the fixture: ``port`` (the
    port's default, native reader), ``port_python``, ``jax_native`` or
    ``jax_python``."""
    csv, fs, jfs, _ = kw.pop("data")
    pp, jp = _policies(tmp_path / tag, policy)
    if reader.startswith("port"):
        pol = pp
        gen = ptable.iter_csv_chunks(csv, fs, bad_records=pp,
                                     use_native=reader == "port", **kw)
    else:
        pol = jp
        gen = jtable.iter_csv_chunks(csv, jfs, bad_records=jp,
                                     use_native=reader == "jax_native", **kw)
    return list(gen), pol


@pytest.mark.parametrize("policy", ["skip", "quarantine"])
@pytest.mark.parametrize("chunk", [1, 257, 10 ** 6])
@pytest.mark.parametrize("start_row", [0, 41, 299])
def test_chunks_equal_the_reference_python_reader(data, tmp_path, chunk,
                                                  start_row, policy):
    """The port's default (native) reader against both of the reference's
    readers: block for block against its native reader (the same blocks:
    ``chunk_rows`` source rows each, bad rows dropped inside), and as one
    table, with the same tallies and quarantine bytes, against its python
    reader (whose blocks hold ``chunk_rows`` good rows).  The port's
    python reader equals the reference's python reader block for block."""
    kw = dict(data=data, chunk_rows=chunk, start_row=start_row)
    runs = {r: _stream_run(tmp_path, r, policy, r, **dict(kw))
            for r in ("port", "port_python", "jax_native", "jax_python")}
    for mine, ref in (("port", "jax_native"), ("port_python", "jax_python")):
        got, want = runs[mine][0], runs[ref][0]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _table_equal(g, w)
            assert g.source_row_end == w.source_row_end
    _table_equal(ptable.ColumnarTable.from_chunks(runs["port"][0]),
                 jtable.ColumnarTable.from_chunks(runs["jax_python"][0]))
    pols = [runs[r][1] for r in runs]
    assert len({p.n_bad for p in pols}) == 1
    assert len({json.dumps(p.counters.as_dict(), sort_keys=True)
                for p in pols}) == 1
    assert len({_quarantine(p) for p in pols}) == 1
    pp = runs["port"][1]
    if start_row == 0:
        assert pp.n_bad == len(GARBLED) + len(TRUNCATED)
        assert runs["port"][0][-1].source_row_end in (N_ROWS - 1, N_ROWS)


def test_chunks_without_a_policy_raise_as_the_reference(data):
    """With no policy a malformed record raises, the same exception type
    after the same blocks (a truncated row first: IndexError) on the
    python readers.  The native readers of both packages hand the block
    with the bad row to their python reader at the same row, with the
    same warning, and then raise the same way."""
    csv, fs, jfs, _ = data

    def run(gen):
        n = 0
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                for _ in gen:
                    n += 1
        except Exception as exc:
            return n, type(exc), [str(x.message) for x in w]
        return n, None, [str(x.message) for x in w]
    got = run(ptable.iter_csv_chunks(csv, fs, chunk_rows=64,
                                     use_native=False))
    assert got == run(jtable.iter_csv_chunks(csv, jfs, chunk_rows=64,
                                             use_native=False))
    assert got[1] is not None
    native = run(ptable.iter_csv_chunks(csv, fs, chunk_rows=64))
    assert native == run(jtable.iter_csv_chunks(csv, jfs, chunk_rows=64))
    assert native[:2] == got[:2]
    assert len(native[2]) == 1 and "mid-stream at row 0" in native[2][0]


@pytest.mark.parametrize("kwargs", [{"chunk_rows": 0}, {"start_row": -1}])
def test_chunk_reader_refuses_bad_arguments(data, kwargs):
    csv, fs, _, _ = data
    with pytest.raises(ValueError):
        list(ptable.iter_csv_chunks(csv, fs, **kwargs))


@pytest.mark.parametrize("chunk", [1, 257, 10 ** 6])
def test_from_chunks_equals_load_csv(data, tmp_path, chunk):
    """Chunks of the port's native and python readers join to the port's
    monolithic load and to the reference's, from either of its readers."""
    csv, fs, jfs, _ = data
    whole = ptable.load_csv(csv, fs, bad_records=ptable.BadRecordPolicy(
        "skip"))
    for use_native in (True, False):
        pp, jp = _policies(tmp_path / str(use_native), "skip")
        joined = ptable.ColumnarTable.from_chunks(ptable.iter_csv_chunks(
            csv, fs, chunk_rows=chunk, bad_records=pp,
            use_native=use_native))
        _table_equal(joined, whole)
        _table_equal(joined, jtable.load_csv(csv, jfs, use_native=use_native,
                                             bad_records=jp))


def test_from_chunks_joins_raw_rows_and_refuses_an_empty_list(data):
    csv, fs, _, _ = data
    with open(csv) as fh:
        good = [line for line in fh.read().splitlines()[:60]
                if line.strip()][:20]
    text = "\n".join(good) + "\n"
    parts = [ptable.load_csv_text("\n".join(good[i:i + 7]), fs,
                                  keep_raw=True,
                                  bad_records=ptable.BadRecordPolicy("skip"))
             for i in range(0, 20, 7)]
    whole = ptable.load_csv_text(text, fs, keep_raw=True,
                                 bad_records=ptable.BadRecordPolicy("skip"))
    joined = ptable.ColumnarTable.from_chunks(parts)
    _table_equal(joined, whole)
    assert joined.raw_rows == whole.raw_rows
    with pytest.raises(ValueError, match="at least one chunk"):
        ptable.ColumnarTable.from_chunks([])


@pytest.mark.parametrize("policy", ["skip", "quarantine"])
def test_monolithic_load_equals_the_reference(data, tmp_path, policy):
    """The skipping monolithic load reads with the python reader in both
    packages (the policy needs the raw lines), whichever reader was asked
    for; the port records why."""
    csv, fs, jfs, bad = data
    pp, jp = _policies(tmp_path, policy)
    with transfer_ledger() as led:
        got = ptable.load_csv(csv, fs, keep_raw=True, bad_records=pp)
    assert led.ingest_snapshot() == {
        "python.blocks": 1, "python.rows": got.n_rows,
        "python.keep_raw": 1}
    for use_native in (False, True):
        jpol = _policies(tmp_path / f"j{use_native}", policy)[1]
        want = jtable.load_csv(csv, jfs, keep_raw=True,
                               use_native=use_native, bad_records=jpol)
        _table_equal(got, want)
        assert got.raw_rows == want.raw_rows
        assert pp.counters.as_dict() == jpol.counters.as_dict()
        assert _quarantine(pp) == _quarantine(jpol)
    if policy == "quarantine":
        lines = _quarantine(pp).decode().splitlines()
        assert sorted(lines) == sorted(b.rstrip("\r") for b in bad)
    with open(csv) as fh:
        text = fh.read()
    pp2, _ = _policies(tmp_path / "text", policy)
    _table_equal(ptable.load_csv_text(text, fs, bad_records=pp2), want)
    pp3, _ = _policies(tmp_path / "native", policy)
    with transfer_ledger() as led:
        _table_equal(ptable.load_csv(csv, fs, bad_records=pp3), want)
    assert led.ingest_snapshot()["python.policy"] == 1
    assert _quarantine(pp3) == _quarantine(pp)


def test_quarantine_write_retries_then_counts(tmp_path, monkeypatch):
    """A transient failure of the quarantine append is retried; the
    counters move once, after the write succeeded."""
    monkeypatch.setattr(pfaults, "RETRY_BASE_S", 0.0)
    c = Counters()
    pol = ptable.BadRecordPolicy("quarantine", str(tmp_path / "q"), c)
    pfaults.install(pfaults.FaultInjector.parse(
        "artifact_write@0=raise:OSError"))
    try:
        with pytest.warns(RuntimeWarning, match="quarantine append"):
            pol.record(["a,b", "c"], src_rows=[3, 9])
    finally:
        pfaults.uninstall()
    assert c.as_dict()["BadRecords"] == {"Malformed": 2, "Quarantined": 2,
                                         "Skipped": 2}
    assert (tmp_path / "q" / "part-q-00000").read_text() == "a,b\nc\n"


def test_chunk_encode_fault_point_fires_per_block(data):
    """The python reader's block parse passes ``chunk_encode`` (the native
    reader's passes ``chunk_read``:
    ``test_chunk_read_fault_point_fires_per_block``)."""
    csv, fs, _, _ = data
    pfaults.install(pfaults.FaultInjector.parse(
        "chunk_encode@2=raise:RuntimeError"))
    try:
        it = ptable.iter_csv_chunks(csv, fs, chunk_rows=100,
                                    use_native=False,
                                    bad_records=ptable.BadRecordPolicy(
                                        "skip"))
        got = [next(it), next(it)]
        with pytest.raises(RuntimeError, match="chunk_encode@2"):
            next(it)
    finally:
        pfaults.uninstall()
    assert [c.n_rows for c in got] == [100, 100]


@pytest.mark.parametrize("reader,spec", [
    ("native", "chunk_read@2=raise:RuntimeError"),
    ("python", "chunk_encode@2=raise:RuntimeError")])
def test_chunk_read_fault_point_fires_per_block(data, reader, spec):
    """Each reader's own fault point stops it before its third block: the
    native reader's ``chunk_read`` (blocks of 100 source rows, bad rows
    dropped inside), the python reader's ``chunk_encode`` (blocks of 100
    good rows).  The other point never fires on a reader."""
    csv, fs, _, _ = data
    other = "chunk_encode" if reader == "native" else "chunk_read"
    pfaults.install(pfaults.FaultInjector.parse(
        f"{spec},{other}@*=raise:RuntimeError"))
    try:
        it = ptable.iter_csv_chunks(csv, fs, chunk_rows=100,
                                    use_native=reader == "native",
                                    bad_records=ptable.BadRecordPolicy(
                                        "skip"))
        got = [next(it), next(it)]
        with pytest.raises(RuntimeError, match=spec.split("=")[0]):
            next(it)
    finally:
        pfaults.uninstall()
    assert [c.source_row_end for c in got] == \
        ([100, 200] if reader == "native" else [103, 203])


def test_transient_chunk_read_fault_is_retried(data, monkeypatch):
    """A transient OSError on a native block read is retried through
    ``with_retry``: same blocks, every one read natively."""
    csv, fs, _, _ = data
    monkeypatch.setattr(pfaults, "RETRY_BASE_S", 0.0)
    want = list(ptable.iter_csv_chunks(csv, fs, chunk_rows=100,
                                       bad_records=ptable.BadRecordPolicy(
                                           "skip")))
    pfaults.install(pfaults.FaultInjector.parse("chunk_read@2=raise:OSError"))
    try:
        with transfer_ledger() as led, \
                pytest.warns(RuntimeWarning, match="chunk read"):
            got = list(ptable.iter_csv_chunks(
                csv, fs, chunk_rows=100,
                bad_records=ptable.BadRecordPolicy("skip")))
    finally:
        pfaults.uninstall()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _table_equal(g, w)
    assert led.ingest_snapshot() == {"native.blocks": 6,
                                     "native.rows": sum(c.n_rows
                                                        for c in got)}


# --------------------------------------------------------------------------
# producer threads
# --------------------------------------------------------------------------

class _Source:
    """A block source that fails after ``fail_after`` items (never when
    None) and records its close()."""

    def __init__(self, n, fail_after=None):
        self.n, self.fail_after = n, fail_after
        self.closed = threading.Event()
        self.made = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.fail_after is not None and self.made == self.fail_after:
            raise ValueError("boom")
        if self.made == self.n:
            raise StopIteration
        self.made += 1
        return self.made - 1

    def close(self):
        self.closed.set()


def _pipes():
    return [
        ("prefetch", lambda src, st: ptable.prefetch_chunks(src, stats=st)),
        ("stage", lambda src, st: ptable.stage_chunks(src, lambda b: b * 10,
                                                      stats=st)),
        ("chain", lambda src, st: ptable.stage_chunks(
            ptable.prefetch_chunks(src, stats=st, consumer_wait_key=None),
            lambda b: b * 10, stats=st)),
    ]


@pytest.mark.parametrize("name,pipe", _pipes())
def test_producer_failure_raised_once_in_order(name, pipe):
    stats = {}
    src = _Source(10, fail_after=3)
    gen = pipe(src, stats)
    got = []
    with pytest.raises(ValueError, match="boom"):
        for item in gen:
            got.append(item)
    scale = 1 if name == "prefetch" else 10
    assert got == [0, scale, 2 * scale]
    assert stats["producer_error"] == "ValueError: boom"
    assert stats["producer_error_thread"].startswith("avenir-ingest")
    with pytest.raises(StopIteration):
        next(gen)               # raised once: the generator is finished
    assert src.closed.wait(5)
    keys = {"parse_s", "queue_wait_s"} if name == "prefetch" else \
        {"stage_wait_s", "transfer_s", "queue_wait_s"}
    assert keys <= set(stats)


@pytest.mark.parametrize("name,pipe", _pipes())
def test_source_closed_when_the_consumer_walks_away(name, pipe):
    src = _Source(10 ** 6)
    gen = pipe(src, {})
    assert next(gen) == 0
    gen.close()
    assert src.closed.wait(5)
    time.sleep(0.3)
    made = src.made
    time.sleep(0.3)
    assert src.made == made          # the producer stopped


def test_prefetch_refuses_depth_zero():
    with pytest.raises(ValueError):
        next(ptable.prefetch_chunks(iter([1]), depth=0))


def test_stage_runs_on_its_own_thread():
    main = threading.get_ident()
    seen = []

    def stage(b):
        seen.append(threading.get_ident())
        return b
    assert list(ptable.stage_chunks(iter(range(5)), stage)) == list(range(5))
    assert seen and main not in seen


# --------------------------------------------------------------------------
# checkpoints and the fault injector
# --------------------------------------------------------------------------

def _ops(mod, base):
    """The same sequence of saves, a torn newest step and retention
    against one package's manager; returns what it observed."""
    mgr = mod.CheckpointManager(str(base), keep=2)
    seen = {}
    for step in (1, 2, 3):
        mgr.save(step, {"a": np.arange(step, dtype=np.int32),
                        "m": np.ones(step, np.float32)},
                 {"step": step, "done": step == 3})
    seen["steps"] = mgr.steps()
    s, arrays, meta = mgr.restore()
    seen["restore"] = (s, {k: v.tolist() for k, v in arrays.items()}, meta)
    os.remove(os.path.join(mgr._step_dir(3), "state.npz"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        seen["latest"] = mgr.latest_step()
        seen["fallback"] = mgr.restore()[0]
    seen["warned"] = sorted({str(x.message).split(" in ")[0] for x in w})
    os.remove(os.path.join(mgr._step_dir(2), "meta.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(FileNotFoundError, match="no intact"):
            mgr.restore()
    empty = mod.CheckpointManager(str(base) + "_empty")
    seen["empty"] = empty.latest_step()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        empty.restore()
    return seen


def test_checkpoint_manager_matches_the_reference(tmp_path):
    assert _ops(pckpt, tmp_path / "p") == _ops(jckpt, tmp_path / "j")


@pytest.mark.parametrize("writer,reader", [(jckpt, pckpt), (pckpt, jckpt)])
def test_checkpoints_cross_read(tmp_path, writer, reader):
    arrays = {"branches": np.arange(12, dtype=np.int32).reshape(4, 3),
              "mask": np.asarray([1, 0, 1, 1], np.float32)}
    meta = {"n_rows": 3, "blocks_done": 2, "source_rows_done": 7,
            "ingest_complete": False}
    writer.CheckpointManager(str(tmp_path)).save(2, arrays, meta)
    step, got, got_meta = reader.CheckpointManager(str(tmp_path)).restore()
    assert step == 2 and got_meta == meta
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


def test_checkpoint_save_fault_point(tmp_path):
    mgr = pckpt.CheckpointManager(str(tmp_path))
    pfaults.install(pfaults.FaultInjector.parse(
        "checkpoint_save@4=raise:OSError"))
    try:
        mgr.save(3, {"a": np.zeros(1)})
        with pytest.raises(OSError, match="checkpoint_save@4"):
            mgr.save(4, {"a": np.zeros(1)})
    finally:
        pfaults.uninstall()
    assert mgr.steps() == [3]


@pytest.mark.parametrize("spec", [
    "chunk_encode@2=raise:OSError, artifact_write@*=delay:0.001x2",
    "checkpoint_save@1=raise:RuntimeErrorx3;chunk_encode@*=raise:Nope",
    "a@=delay:0.0"])
def test_fault_injector_fires_as_the_reference(spec):
    def trace(mod):
        inj = mod.FaultInjector.parse(spec)
        out = []
        for op in ("chunk_encode", "artifact_write", "checkpoint_save",
                   "a") * 4:
            try:
                inj.fire(op)
                out.append((op, None))
            except Exception as exc:
                out.append((op, type(exc).__name__))
        return out, inj.log
    got, want = trace(pfaults), trace(jfaults)
    assert [(op, e if e != "InjectedFault" else "I") for op, e in got[0]] \
        == [(op, e if e != "InjectedFault" else "I") for op, e in want[0]]
    assert got[1] == want[1]


@pytest.mark.parametrize("bad", ["nope", "op@1=explode"])
def test_fault_spec_refuses_bad_entries(bad):
    with pytest.raises(ValueError):
        pfaults.FaultInjector.parse(bad)


@pytest.mark.parametrize("mode,field", [("garble", None), ("garble", 1),
                                        ("truncate", None)])
def test_corrupt_csv_rows_equals_the_reference(tmp_path, mode, field):
    lines = [f"r{i},{i},{i * 2},x" for i in range(20)]
    for name in ("p", "j"):
        (tmp_path / name).write_text("\n".join(lines[:5]) + "\n\n"
                                     + "\n".join(lines[5:]) + "\n")
    got = pfaults.corrupt_csv_rows(str(tmp_path / "p"), [0, 6, 19], seed=4,
                                   mode=mode, field=field)
    want = jfaults.corrupt_csv_rows(str(tmp_path / "j"), [0, 6, 19], seed=4,
                                    mode=mode, field=field)
    assert got == want
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
