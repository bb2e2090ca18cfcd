"""The port's chunk pipelines (``avenir_tpu_torch/pipeline``) and the two
fused flows on them against the JAX package, on the CPU (mirrors
``tests/test_pipeline.py``).

* The compiler: its refusals (duplicate stage names, a prepared input two
  stages produce, an unknown dispatch site, a finalized pipeline), stage
  constants and carries, the ProgramCache's key axes and per-run tallies,
  and ``schema_fingerprint`` digit for digit with the JAX package's.
* ``PredictDriftFlow.run_window`` against the JAX flow on the same windows
  of the drift9 stream: the same labels, the same (R, B) counts, and None
  on the same windows (empty, too long, values that are not
  float32-exact).
* ``predictDriftScore`` fused against unfused, byte for byte, with fewer
  dispatches, and against the JAX package's fused job; the even-forest
  refusal under the fused default.
* The fused streamed forest: trees and baseline byte-identical to the
  unfused ingest at strictly fewer dispatches, a warm rerun with zero
  retraces, checkpoint and resume, the baseline's ``as_stage`` (also
  pre-seeded) against the tee, and the job's ``ProgramCache`` and
  ``Dispatches`` groups against the JAX job's in a fresh one-device
  process.

The ProgramCache is process-global: each test that reads tallies clears
it first.
"""

import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core.checkpoint import CheckpointManager
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import encode_rows, iter_csv_chunks, \
    load_csv
from avenir_tpu_torch.models.forest import (EnsembleModel, ForestParams,
                                            build_forest,
                                            build_forest_from_stream)
from avenir_tpu_torch.models.tree import DecisionTreeModel
from avenir_tpu_torch.monitor.baseline import BaselineBuilder, load_baseline
from avenir_tpu_torch.parallel.mesh import DeviceMesh, MeshContext
from avenir_tpu_torch.pipeline import (ONLINE_SITE, PIPELINE_SITE,
                                       ChunkPipeline, ProgramCache, Stage,
                                       program_cache, schema_fingerprint)
from avenir_tpu_torch.pipeline.flows import PredictDriftFlow
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.utils.tracing import transfer_ledger
from tests.test_pipeline import SCHEMA, _write_csv

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
RES = os.path.join(ROOT, "resource")
FIX = os.path.join(TESTS, "torch_fixtures")
CPU = MeshContext(DeviceMesh(["cpu"]))


def _schema():
    return FeatureSchema.from_dict(SCHEMA)


def _params(trees=3, depth=3, seed=7):
    p = ForestParams(num_trees=trees, seed=seed)
    p.tree.max_depth = depth
    p.tree.stopping_strategy = "maxDepth"
    return p


# --------------------------------------------------------------------------
# the compiler
# --------------------------------------------------------------------------

def _toy_stage(name="toy"):
    def kernel(carry, consts, inputs, upstream):
        return carry, {"y": inputs["x"] * consts["scale"]}
    return Stage(name=name, kernel=kernel,
                 consts={"scale": np.float32(2.0)}, returns=("y",))


def _run_toy(cache, schema_fp="s", ctx=CPU, n=8):
    pl = ChunkPipeline([_toy_stage()], ctx=ctx, schema_fp=schema_fp,
                       cache=cache)
    with pl.staged({"x": np.arange(n, dtype=np.float32)}) as inputs:
        out = pl.run_chunk(inputs)
    np.testing.assert_array_equal(out["toy.y"].numpy(),
                                  np.arange(n, dtype=np.float32) * 2)
    return pl


def test_compiler_refuses_duplicates_and_an_unknown_site():
    with pytest.raises(ValueError, match="duplicate"):
        ChunkPipeline([_toy_stage(), _toy_stage()], ctx=CPU,
                      cache=ProgramCache())
    with pytest.raises(ValueError, match="at least one stage"):
        ChunkPipeline([], ctx=CPU, cache=ProgramCache())
    with pytest.raises(ValueError, match="unknown dispatch site"):
        ChunkPipeline([_toy_stage()], ctx=CPU, cache=ProgramCache(),
                      site="serve.predict")
    a, b = _toy_stage("a"), _toy_stage("b")
    a.prepare = lambda block: {"x": np.zeros(2, np.float32)}
    b.prepare = lambda block: {"x": np.ones(2, np.float32),
                               "z": np.ones(2, np.float32)}
    pl = ChunkPipeline([a, b], ctx=CPU, cache=ProgramCache())
    with pytest.raises(ValueError, match=r"re-produces input keys \['x'\]"):
        pl.prepare(None)
    pl.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        pl.run_chunk({"x": torch.zeros(2)})


def test_program_cache_key_axes_and_run_tallies():
    """Schema fingerprint, chunk shape and mesh fingerprint each MISS; an
    identical rerun HITS with zero retraces."""
    cache = ProgramCache()
    _run_toy(cache)
    assert cache.stats() == dict(hits=0, misses=1, retraces=1, entries=1)
    pl = _run_toy(cache)
    assert pl.run_stats() == {"chunks": 1, "hits": 1, "misses": 0,
                              "retraces": 0}
    _run_toy(cache, schema_fp="s2")
    _run_toy(cache, n=16)
    _run_toy(cache, ctx=MeshContext(DeviceMesh(["cpu"] * 2)))
    assert cache.stats()["retraces"] == 4
    c = Counters()
    pl.export(c)
    assert c.as_dict()["ProgramCache"] == {"Chunks": 1, "Hits": 1,
                                           "Misses": 0, "Retraces": 0}


def test_staged_takes_tensors_a_caller_uploaded():
    """A tensor signs as the host array of its shape and dtype: the
    streamed ingest's uploaded block hits the key its host arrays made,
    and the chunk reads the tensor's values."""
    cache = ProgramCache()
    _run_toy(cache)
    pl = ChunkPipeline([_toy_stage()], ctx=CPU, schema_fp="s", cache=cache)
    x = torch.arange(8, dtype=torch.float32) + 1
    with pl.staged({"x": x}) as inputs:
        out = pl.run_chunk(inputs)
    np.testing.assert_array_equal(out["toy.y"].numpy(), (x * 2).numpy())
    assert pl.run_stats()["hits"] == 1 and cache.stats()["entries"] == 1


def test_carry_threads_and_finish_receives_it():
    got = {}

    def kernel(carry, consts, inputs, upstream):
        return carry + inputs["x"].sum(), {"s": carry}

    st = Stage(name="acc", kernel=kernel,
               carry_init=lambda: np.float32(0.0),
               finish=lambda c: got.setdefault("v", float(c)))
    pl = ChunkPipeline([st], ctx=CPU, cache=ProgramCache())
    for k in range(3):
        with pl.staged({"x": np.full(4, k + 1, np.float32)}) as inputs:
            pl.run_chunk(inputs)
    pl.finalize()
    pl.finalize()                                  # idempotent
    assert got["v"] == 4.0 * (1 + 2 + 3)
    assert pl.run_stats()["chunks"] == 3 and pl.run_stats()["hits"] == 2


def test_sites_and_spans_per_site():
    from avenir_tpu_torch.utils.tracing import transfer_ledger as tl
    for site in (PIPELINE_SITE, ONLINE_SITE):
        pl = ChunkPipeline([_toy_stage()], ctx=CPU, cache=ProgramCache(),
                           site=site)
        with tl() as led, pl.staged({"x": np.ones(3, np.float32)}) as x:
            pl.run_chunk(x)
        assert led.site_snapshot() == {site: 1}


def test_schema_fingerprint_is_the_jax_one():
    from avenir_tpu.core.schema import FeatureSchema as JSchema
    from avenir_tpu.pipeline import schema_fingerprint as jfp
    for d in (SCHEMA, json.load(open(os.path.join(RES,
                                                  "call_hangup.json")))):
        assert schema_fingerprint(FeatureSchema.from_dict(d)) == \
            jfp(JSchema.from_dict(d))
    changed = {"fields": [dict(f) for f in SCHEMA["fields"]]}
    changed["fields"][2]["max"] = 700
    assert schema_fingerprint(FeatureSchema.from_dict(changed)) != \
        schema_fingerprint(_schema())


# --------------------------------------------------------------------------
# PredictDriftFlow against the JAX flow
# --------------------------------------------------------------------------

def _flows(window_rows):
    """The rafo9 forest and baseline (rafo9q registry) as the JAX flow on
    a one-device context and the port's flow on the CPU."""
    from avenir_tpu.models.forest import EnsembleModel as JEns
    from avenir_tpu.models.tree import DecisionTreeModel as JTree
    from avenir_tpu.monitor.baseline import load_baseline as jload
    from avenir_tpu.parallel.mesh import MeshContext as JCtx, make_mesh
    from avenir_tpu.pipeline.flows import PredictDriftFlow as JFlow
    from avenir_tpu.serving.registry import ModelRegistry as JReg
    reg_dir = os.path.join(FIX, "rafo9q", "registry")
    jreg, preg = JReg(reg_dir), ModelRegistry(reg_dir)
    jl, pl = jreg.load("rafo9"), preg.load("rafo9")
    jens = JEns([JTree(p, jl.schema) for p in jl.model])
    pens = EnsembleModel([DecisionTreeModel(p, pl.schema, device="cpu")
                          for p in pl.model], device="cpu")
    jflow = JFlow(jens, jload(jreg, "rafo9"), jl.schema, window_rows,
                  ctx=JCtx(make_mesh(1)))
    pflow = PredictDriftFlow(pens, load_baseline(preg, "rafo9"), pl.schema,
                             window_rows)
    return jflow, pflow, jl.schema, pl.schema


def _drift9_rows():
    with open(os.path.join(FIX, "drift9", "stream.csv")) as fh:
        rows = [line.rstrip("\n").split(",") for line in fh]
    return [r for r in rows if len(r) == 6 and r[2].isdigit()
            and r[3].isdigit() and r[4].isdigit()]


def test_run_window_matches_the_jax_flow():
    from avenir_tpu.core.table import encode_rows as jencode
    jflow, pflow, js, ps = _flows(512)
    rows = _drift9_rows()
    windows = [rows[i:i + 512] for i in range(0, len(rows), 512)]
    odd = [list(r) for r in rows[:40]]
    odd[7][2] = "0.1"                        # not float32-exact
    windows += [rows[:513], [], odd, rows[:1]]
    fused = 0
    for w in windows:
        want = jflow.run_window(jencode(w, js))
        got = pflow.run_window(encode_rows(w, ps))
        assert (got is None) == (want is None), len(w)
        if want is None:
            continue
        fused += 1
        assert got[0] == want[0]
        assert got[1].dtype == np.float64
        np.testing.assert_array_equal(got[1], want[1])
    assert fused == len(windows) - 3
    assert pflow.run_stats()["chunks"] == fused


def test_flow_launches_the_plain_versions_on_the_cpu():
    _, pflow, _, ps = _flows(64)
    with transfer_ledger() as led:
        assert pflow.run_window(encode_rows(_drift9_rows()[:50], ps))
    c = Counters()
    led.export(c)
    assert c.as_dict()["Dispatches"] == {"pipeline.chunk": 1}
    assert c.as_dict()["KernelBackends"] == {"ensemble.vote.torch": 1,
                                             "monitor.absorb.torch": 1}


def test_flow_of_an_ensemble_with_no_stacked_form_is_ineligible():
    jflow, pflow, _, ps = _flows(64)
    pflow.ens._stacked = None
    flow = PredictDriftFlow(pflow.ens, pflow.baseline, ps, 64)
    assert not flow.eligible and flow.pl is None
    assert flow.run_window(encode_rows(_drift9_rows()[:10], ps)) is None
    assert flow.run_stats() == {}


# --------------------------------------------------------------------------
# the jobs: predictDriftScore fused vs unfused, and the JAX fused job
# --------------------------------------------------------------------------

def _port(job, *args):
    assert port_run.main([job, "-Dplatform=cpu", *args]) == 0


def _counters(out):
    with open(str(out) + ".counters.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The port's streamed forest (3 trees) and baseline, published; a
    drifted, noisy scoring stream."""
    d = tmp_path_factory.mktemp("published")
    schema_path = str(d / "schema.json")
    with open(schema_path, "w") as fh:
        json.dump(SCHEMA, fh)
    _write_csv(d / "train.csv", n=500, seed=3)
    _write_csv(d / "score.csv", n=300, seed=11, shift=200, noise=0.1)
    _port("randomForestBuilder",
          f"-Ddtb.feature.schema.file.path={schema_path}",
          "-Ddtb.num.trees=3", "-Ddtb.random.seed=7",
          "-Ddtb.max.depth.limit=3", "-Ddtb.path.stopping.strategy=maxDepth",
          "-Ddtb.streaming.ingest=true", "-Ddtb.streaming.block.rows=128",
          "-Ddtb.baseline.publish=true", f"-Ddtb.model.registry.dir={d}/reg",
          "-Ddtb.baseline.bins=8", str(d / "train.csv"), str(d / "out_rf"))
    return d


DM_KEYS = ("-Ddm.model.name=forest", "-Ddm.window.rows=100",
           "-Ddm.consecutive.windows=1", "-Ddm.accuracy.warn=100",
           "-Ddm.accuracy.alert=100", "-Ddm.score.predictions=true")
OUT_FILES = ("part-r-00000", "alerts.jsonl",
             os.path.join("predictions", "part-m-00000"))


def _read(*p):
    with open(os.path.join(*p), "rb") as fh:
        return fh.read()


def test_predict_drift_score_fused_equals_unfused(published, tmp_path):
    d = published
    program_cache().clear()
    outs = {}
    for name, extra in (("fused", ()), ("unfused",
                                        ("-Ddm.pipeline.fuse=false",))):
        out = tmp_path / name
        _port("predictDriftScore", f"-Ddm.model.registry.dir={d}/reg",
              *DM_KEYS, *extra, str(d / "score.csv"), str(out))
        outs[name] = (out, _counters(out))
    (fo, fc), (uo, uc) = outs["fused"], outs["unfused"]
    for f in OUT_FILES:
        assert _read(fo, f) == _read(uo, f), f
    assert _read(fo, "alerts.jsonl")       # drift and accuracy alerts fired
    assert fc["PredictDrift"] == {"FusedWindows": 3, "UnfusedWindows": 0}
    assert uc["PredictDrift"] == {"FusedWindows": 0, "UnfusedWindows": 3}
    assert fc["ProgramCache"] == {"Chunks": 3, "Hits": 2, "Misses": 1,
                                  "Retraces": 1}
    assert "ProgramCache" not in uc
    fd, ud = fc["Dispatches"], uc["Dispatches"]
    assert fd["pipeline.chunk"] == 3
    assert ud["ensemble.vote"] == ud["monitor.absorb"] == 3
    assert fd["pipeline.chunk"] < ud["monitor.absorb"] + ud["ensemble.vote"]
    assert fd["drift.score"] == ud["drift.score"]
    assert "ensemble.vote" not in fd and "monitor.absorb" not in fd
    assert fc["DriftMonitor"] == uc["DriftMonitor"]


def test_predict_drift_score_fused_equals_the_jax_fused_job(published,
                                                           tmp_path):
    from avenir_tpu.cli import monitor_jobs as jmon
    from avenir_tpu.core.config import Config as JConfig
    from avenir_tpu.pipeline import program_cache as jcache
    d = published
    jreg = tmp_path / "jreg"
    shutil.copytree(d / "reg", jreg)
    keys = {k[2:].split("=")[0]: k.split("=", 1)[1] for k in DM_KEYS}
    keys["dm.model.registry.dir"] = str(jreg)
    jcache().clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc = jmon.predict_drift_score(JConfig(keys), str(d / "score.csv"),
                                      str(tmp_path / "jax"))
    program_cache().clear()
    _port("predictDriftScore", f"-Ddm.model.registry.dir={d}/reg", *DM_KEYS,
          str(d / "score.csv"), str(tmp_path / "port"))
    for f in OUT_FILES:
        assert _read(tmp_path / "port", f) == _read(tmp_path / "jax", f), f
    pc = _counters(tmp_path / "port")
    for g in ("PredictDrift", "ProgramCache", "DriftMonitor"):
        assert pc[g] == jc.as_dict()[g], g


def test_predict_drift_score_refuses_an_even_forest_fused_or_not(tmp_path):
    schema_path = str(tmp_path / "schema.json")
    with open(schema_path, "w") as fh:
        json.dump(SCHEMA, fh)
    _write_csv(tmp_path / "train.csv", n=400, seed=3)
    _write_csv(tmp_path / "score.csv", n=120, seed=11)
    _port("randomForestBuilder",
          f"-Ddtb.feature.schema.file.path={schema_path}",
          "-Ddtb.num.trees=4", "-Ddtb.random.seed=7",
          "-Ddtb.max.depth.limit=3", "-Ddtb.path.stopping.strategy=maxDepth",
          "-Ddtb.baseline.publish=true",
          f"-Ddtb.model.registry.dir={tmp_path}/reg",
          "-Ddtb.baseline.bins=8", str(tmp_path / "train.csv"),
          str(tmp_path / "out_rf"))
    for extra in ((), ("-Ddm.pipeline.fuse=true",),
                  ("-Ddm.pipeline.fuse=false",)):
        with pytest.raises(ValueError, match="odd number"):
            port_run.main(["predictDriftScore", "-Dplatform=cpu",
                           f"-Ddm.model.registry.dir={tmp_path}/reg",
                           *DM_KEYS, *extra, str(tmp_path / "score.csv"),
                           str(tmp_path / "out_even")])


# --------------------------------------------------------------------------
# the fused streamed forest
# --------------------------------------------------------------------------

def _stream_forest(csv, schema, params, fuse, baseline=None,
                   chunk_rows=128, **kw):
    stats = {}
    with transfer_ledger() as led:
        models = build_forest_from_stream(
            iter_csv_chunks(csv, schema, ",", chunk_rows=chunk_rows),
            schema, params, device="cpu", stats=stats, fuse=fuse,
            baseline=baseline, **kw)
    return [m.to_json() for m in models], led, stats


def test_rf_stream_fused_bit_identical_with_fewer_dispatches(tmp_path):
    """Fused = one ``pipeline.chunk`` a block; unfused = an encode and a
    teed absorb a block; the same trees as the monolithic build and the
    same baseline bytes."""
    schema = _schema()
    csv = _write_csv(tmp_path / "d.csv", n=401)      # a remainder block
    params = _params()
    ref = [m.to_json() for m in build_forest(load_csv(csv, schema, ","),
                                             params, device="cpu")]
    bf = BaselineBuilder(schema, n_bins=8, device="cpu")
    bu = BaselineBuilder(schema, n_bins=8, device="cpu")
    fused, led_f, stats_f = _stream_forest(csv, schema, params, True, bf)
    unfused, led_u, stats_u = _stream_forest(csv, schema, params, False, bu)
    assert fused == unfused == ref
    chunks = stats_f["pipeline"]["chunks"]
    assert chunks == 4 and "pipeline" not in stats_u
    sf, su = led_f.site_snapshot(), led_u.site_snapshot()
    assert sf["pipeline.chunk"] == chunks
    assert su["ingest.encode"] == su["baseline.absorb"] == chunks
    assert "ingest.encode" not in sf and "baseline.absorb" not in sf
    assert sf["pipeline.chunk"] < su["ingest.encode"] + su["baseline.absorb"]
    fb, ub = bf.finalize(), bu.finalize()
    np.testing.assert_array_equal(fb.counts, ub.counts)
    assert fb.n_rows == ub.n_rows == 401
    assert fb.to_sidecar()["baseline.json"] == \
        ub.to_sidecar()["baseline.json"]
    np.testing.assert_array_equal(fb.quantiles, ub.quantiles)


def test_rf_stream_warm_rerun_zero_retraces(tmp_path):
    schema = _schema()
    csv = _write_csv(tmp_path / "d.csv", n=400)
    program_cache().clear()
    _, _, s1 = _stream_forest(csv, schema, _params(), True)
    _, _, s2 = _stream_forest(csv, schema, _params(), True)
    # three 128-row blocks and a 16-row tail: two chunk shapes
    assert s1["pipeline"] == {"chunks": 4, "hits": 2, "misses": 2,
                              "retraces": 2}
    assert s2["pipeline"] == {"chunks": 4, "hits": 4, "misses": 0,
                              "retraces": 0}


def test_rf_stream_fused_checkpoint_resume_bit_identical(tmp_path):
    schema = _schema()
    csv = _write_csv(tmp_path / "d.csv", n=400)
    params = _params()
    ref, _, _ = _stream_forest(csv, schema, params, True, chunk_rows=64)
    mgr = CheckpointManager(str(tmp_path / "ck"))

    def crash_after(blocks, k):
        for i, b in enumerate(blocks):
            if i == k:
                raise RuntimeError("injected crash")
            yield b

    with pytest.raises(RuntimeError, match="injected crash"):
        build_forest_from_stream(
            crash_after(iter_csv_chunks(csv, schema, ",", chunk_rows=64),
                        3),
            schema, params, device="cpu", checkpoint=mgr,
            checkpoint_every=1)
    step, arrays, meta = mgr.restore()
    assert not meta["ingest_complete"] and meta["source_rows_done"] > 0
    models = build_forest_from_stream(
        iter_csv_chunks(csv, schema, ",", chunk_rows=64,
                        start_row=meta["source_rows_done"]),
        schema, params, device="cpu", checkpoint=mgr, checkpoint_every=1,
        resume_state=(arrays, meta))
    assert [m.to_json() for m in models] == ref


def test_baseline_as_stage_equals_the_tee_and_keeps_a_preseeded_head(
        tmp_path):
    """The stage's carry starts from a pre-seeded builder's counts (the
    retrain controller re-profiles the consumed head with ``update``) and
    ``finish`` installs the final carry: fused and tee'd finalise to the
    same bytes, head included."""
    schema = _schema()
    csv = _write_csv(tmp_path / "d.csv", n=300)
    head = load_csv(_write_csv(tmp_path / "h.csv", n=50, seed=9), schema,
                    ",")
    out = {}
    for fuse in (True, False):
        b = BaselineBuilder(schema, n_bins=8, device="cpu").update(head)
        trees, _, _ = _stream_forest(csv, schema, _params(), fuse, b)
        out[fuse] = (trees, b.finalize())
    (tf, bf), (tu, bu) = out[True], out[False]
    assert tf == tu
    assert bf.n_rows == bu.n_rows == 350
    np.testing.assert_array_equal(bf.counts, bu.counts)
    assert bf.to_sidecar()["baseline.json"] == \
        bu.to_sidecar()["baseline.json"]
    st = BaselineBuilder(schema, n_bins=8, device="cpu").as_stage()
    assert st.name == "monitor-absorb" and st.version.startswith("1:b")


_JAX_RAFO9S = r"""
import json, os, sys, tempfile
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from avenir_tpu.cli import run
fix, res = sys.argv[2], sys.argv[3]
sys.path.insert(0, fix)
import make as mk
with tempfile.TemporaryDirectory() as w:
    out = os.path.join(w, "model")
    assert run.main(["randomForestBuilder",
                     f"-Dconf.path={res}/rafo.properties",
                     f"-Ddtb.feature.schema.file.path={res}/call_hangup.json",
                     f"-Ddtb.model.registry.dir={w}/reg",
                     "-Ddtb.model.name=rafo9s",
                     f"-Ddtb.streaming.checkpoint.dir={w}/ck",
                     *mk.STREAM_KEYS, os.path.join(fix, "train.csv"),
                     out]) == 0
    c = json.load(open(out + ".counters.json"))
print("GROUPS" + json.dumps({g: c[g] for g in ("ProgramCache",
                                               "Dispatches")}))
"""


def test_rf_job_program_cache_and_dispatches_equal_the_jax_job(tmp_path):
    """rafo9s through the fused default in a fresh one-device JAX process
    and in the port: the same ProgramCache group, and the same Dispatches
    at every site the JAX job records.  The port records two more sites,
    pinned here: ``tree.reassign`` (the forest's reassign, which XLA fuses
    into the ``forest.level`` program) and ``quantized.vote`` (the int8
    publish's mismatch sample)."""
    fix = os.path.join(FIX, "rafo9s")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-c", _JAX_RAFO9S, ROOT, fix, RES],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    want = json.loads([x for x in p.stdout.splitlines()
                       if x.startswith("GROUPS")][-1][len("GROUPS"):])
    sys.path.insert(0, fix)
    try:
        import make as mk
    finally:
        sys.path.remove(fix)
    program_cache().clear()
    out = tmp_path / "model"
    _port("randomForestBuilder", f"-Dconf.path={RES}/rafo.properties",
          f"-Ddtb.feature.schema.file.path={RES}/call_hangup.json",
          f"-Ddtb.model.registry.dir={tmp_path}/reg",
          "-Ddtb.model.name=rafo9s",
          f"-Ddtb.streaming.checkpoint.dir={tmp_path}/ck", *mk.STREAM_KEYS,
          os.path.join(fix, "train.csv"), str(out))
    got = _counters(out)
    assert got["ProgramCache"] == want["ProgramCache"] == {
        "Chunks": 7, "Hits": 4, "Misses": 3, "Retraces": 3}
    gd, wd = got["Dispatches"], want["Dispatches"]
    assert {k: gd[k] for k in wd} == wd
    assert {k: v for k, v in gd.items() if k not in wd} == {
        "tree.reassign": 3, "quantized.vote": 1}
