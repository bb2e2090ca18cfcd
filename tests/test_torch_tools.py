"""The port's operator tools (``python -m avenir_tpu_torch.tools.{registrytool,
cachetool,tracetool}``) against the JAX package's scripts under ``tools/``.

Each scenario runs one step list twice, in a subprocess a package: first
every step through the JAX tool (``tools/<tool>.py`` as ``__main__``), then
through the port's module (``-m`` semantics, ``runpy.run_module``), each
from the same pristine copy of the artifacts.  The artifacts are written
by each package in turn: a registry (full versions, a delta, a pin, a
second model name; and a copy with a torn version, a broken delta chain
and an orphaned delta), an ``.avtc`` columnar cache (and a copy with a
flipped payload byte), and a trace with spans, instants and a request's
flow legs.  Every step's exit code and stdout lines must be equal, and
its stderr lines too apart from warnings.  Mirrors
``tests/test_controller.py``'s, ``test_delta_swap.py``'s,
``test_colcache.py``'s, ``test_reqtrace.py``'s and ``test_telemetry.py``'s
tool tests.  The one designed difference: ``summarize --counters`` over a
port job's counters names the port's backend forms where the JAX tool
prints ``?``.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9", "registry")

# one step list through one package's tools, in this subprocess: steps are
# {"tool", "argv"} (a tool run: its exit code and captured output),
# {"restore": [backup, dst]} (dst replaced by a copy of backup, mtimes
# kept) and {"flip": path} (the file's last byte inverted)
RUNNER = r"""
import contextlib, io, json, os, runpy, shutil, sys
pkg, steps = sys.argv[1], json.loads(sys.argv[2])
root = os.getcwd()
results = []
for st in steps:
    if "restore" in st:
        src, dst = st["restore"]
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst, copy_function=shutil.copy2)
        continue
    if "flip" in st:
        data = bytearray(open(st["flip"], "rb").read())
        data[-1] ^= 0xFF
        open(st["flip"], "wb").write(bytes(data))
        continue
    out, err = io.StringIO(), io.StringIO()
    sys.argv = [st["tool"]] + st["argv"]
    rc = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            if pkg == "jax":
                runpy.run_path(os.path.join(root, "tools",
                                            st["tool"] + ".py"),
                               run_name="__main__")
            else:
                runpy.run_module("avenir_tpu_torch.tools." + st["tool"],
                                 run_name="__main__", alter_sys=True)
        except SystemExit as exc:
            rc = exc.code if isinstance(exc.code, int) else (
                0 if exc.code is None else 1)
    results.append({"rc": rc, "out": out.getvalue(), "err": err.getvalue()})
print("RESULTS" + json.dumps(results))
"""


def _run(pkg, steps):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-c", RUNNER, pkg,
                        json.dumps(steps)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("RESULTS")][-1]
    return json.loads(line[len("RESULTS"):])


def _quiet(text):
    return [x for x in text.splitlines()
            if "Warning" not in x and "warn(" not in x and x.strip()]


def _both(steps):
    """Each tool step's (rc, stdout lines, stderr lines) through the JAX
    tool and the port's; returns the two result lists after asserting the
    step counts."""
    want, got = _run("jax", steps), _run("torch", steps)
    assert len(want) == len(got) == sum("tool" in s for s in steps)
    return want, got


def _assert_same(want, got, steps):
    tools = [s for s in steps if "tool" in s]
    for st, w, g in zip(tools, want, got):
        what = f"{st['tool']} {' '.join(st['argv'])}"
        assert g["rc"] == w["rc"], what
        assert g["out"].splitlines() == w["out"].splitlines(), what
        assert _quiet(g["err"]) == _quiet(w["err"]), what


# --------------------------------------------------------------------------
# registrytool
# --------------------------------------------------------------------------

def _write_registry(pkg, base):
    """rafo9 v1-v3 full, v4 a delta on v3, pin v2; fraud v1 full and v2 a
    delta on v1 — written by ``pkg``'s ModelRegistry."""
    if pkg == "jax":
        from avenir_tpu.serving.registry import ModelRegistry
    else:
        from avenir_tpu_torch.serving.registry import ModelRegistry
    src = ModelRegistry(RAFO9).load("rafo9")
    reg = ModelRegistry(base)
    for _ in range(3):
        reg.publish("rafo9", src.model, schema=src.schema)
    reg.publish_delta("rafo9", src.model, parent_version=3,
                      schema=src.schema)
    reg.pin_version("rafo9", 2)
    reg.publish("fraud", src.model, schema=src.schema)
    reg.publish_delta("fraud", src.model, parent_version=1,
                      schema=src.schema)
    return reg


def _break_registry(base):
    """v3's meta tree shas changed (v4's delta chain broken), v2 (the pin)
    torn, fraud v1 removed (its v2 delta orphaned)."""
    meta = os.path.join(base, "rafo9", "v_000003", "meta.json")
    with open(meta) as fh:
        m = json.load(fh)
    m["tree_shas"][0] = "0" * 64
    with open(meta, "w") as fh:
        json.dump(m, fh)
    with open(os.path.join(base, "rafo9", "v_000002", "meta.json"),
              "w") as fh:
        fh.write("{ torn")
    shutil.rmtree(os.path.join(base, "fraud", "v_000001"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_registrytool_matches_the_jax_tool(tmp_path, writer):
    good, bad = str(tmp_path / "good"), str(tmp_path / "bad")
    _write_registry(writer, good)
    shutil.copytree(good, bad)
    _break_registry(bad)
    reg = str(tmp_path / "reg")

    def tool(*argv):
        return {"tool": "registrytool", "argv": list(argv)}

    steps = [tool("verify", str(tmp_path / "nowhere")),
             tool("list", str(tmp_path / "nowhere")),
             {"restore": [good, reg]},
             tool("list", reg), tool("list", reg, "--name", "rafo9"),
             tool("verify", reg),
             tool("gc", reg, "--name", "rafo9", "--keep", "1",
                  "--dry-run"),
             tool("gc", reg, "--name", "nothing"),
             tool("gc", reg, "--keep", "1"), tool("list", reg),
             {"restore": [good, reg]},
             tool("gc", reg, "--name", "rafo9", "--keep", "2"),
             {"restore": [bad, reg]},
             tool("verify", reg), tool("list", reg),
             tool("verify", reg, "--name", "fraud"),
             tool("bogus")]
    want, got = _both(steps)
    _assert_same(want, got, steps)
    rcs = [w["rc"] for w in want]
    outs = [w["out"] for w in want]
    assert rcs == [1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 2]
    assert "rafo9: pinned=2 serving=2" in outs[2] and "*P" in outs[2]
    assert "verified" in outs[4]
    assert "retired [1]" in outs[7]
    assert "TORN" in outs[10] and "delta-sha-chain-broken" in outs[10]
    assert "orphaned-delta" in outs[12]


# --------------------------------------------------------------------------
# cachetool
# --------------------------------------------------------------------------

def _build_cache(pkg, csv):
    from tests.test_torch_colcache import SCHEMA_D
    if pkg == "jax":
        from avenir_tpu.core.schema import FeatureSchema
        from avenir_tpu.core.table import BadRecordPolicy, iter_csv_chunks
        from avenir_tpu.io.colcache import CachePolicy
    else:
        from avenir_tpu_torch.core.schema import FeatureSchema
        from avenir_tpu_torch.core.table import (BadRecordPolicy,
                                                 iter_csv_chunks)
        from avenir_tpu_torch.io.colcache import CachePolicy
    list(iter_csv_chunks(str(csv), FeatureSchema.from_dict(SCHEMA_D), ",",
                         chunk_rows=64, bad_records=BadRecordPolicy("skip"),
                         cache=CachePolicy("build")))


@pytest.mark.parametrize("builder", ["jax", "torch"])
def test_cachetool_matches_the_jax_tool(tmp_path, builder):
    from avenir_tpu_torch.core import faults
    from tests.test_torch_colcache import SCHEMA_D, gen_csv
    csv = tmp_path / "d.csv"
    gen_csv(csv, n=230, seed=5)
    faults.corrupt_csv_rows(str(csv), [5, 99], seed=9, field=1)
    _build_cache(builder, csv)
    cdir = str(csv) + ".avtc"
    pristine = str(tmp_path / "pristine.avtc")
    shutil.copytree(cdir, pristine, copy_function=shutil.copy2)
    schema = tmp_path / "s.json"
    schema.write_text(json.dumps(SCHEMA_D))
    other = dict(SCHEMA_D, fields=[dict(f) for f in SCHEMA_D["fields"]])
    other["fields"][1]["max"] = 200
    schema2 = tmp_path / "s2.json"
    schema2.write_text(json.dumps(other))
    chunk0 = os.path.join(cdir, sorted(f for f in os.listdir(cdir)
                                       if f.startswith("chunk_"))[0])

    def tool(*argv):
        return {"tool": "cachetool", "argv": list(argv)}

    steps = [{"restore": [pristine, cdir]},
             tool("inspect", str(csv)), tool("inspect", cdir),
             tool("verify", str(csv)),
             tool("verify", str(csv), "--schema", str(schema)),
             tool("verify", str(csv), "--schema", str(schema2)),
             tool("verify", cdir),
             tool("inspect", str(tmp_path / "none.csv")),
             {"flip": chunk0},
             tool("verify", str(csv)), tool("inspect", str(csv)),
             {"restore": [pristine, cdir]},
             tool("drop", str(csv)), tool("drop", str(csv)),
             {"restore": [pristine, cdir]}]
    want, got = _both(steps)
    _assert_same(want, got, steps)
    assert [w["rc"] for w in want] == [0, 0, 0, 0, 1, 0, 1, 1, 0, 0, 1]
    assert "build_id" in want[0]["out"]
    assert "verified (4 chunks, 228 rows" in want[2]["out"]


# --------------------------------------------------------------------------
# tracetool
# --------------------------------------------------------------------------

def _write_trace(pkg, trace_dir, rid=42, index=0):
    """One process's trace through ``pkg``'s tracer: spans, a stall, an
    autoscaler decision, a registry publish, two serve batches and two
    requests' flow legs (``rid`` and ``rid + 1``, the second slow)."""
    if pkg == "jax":
        from avenir_tpu.telemetry import trace as T
    else:
        from avenir_tpu_torch.telemetry import trace as T
    tr = T.Tracer(trace_dir, run_id="s", process_index=index)
    T.install_tracer(tr)
    try:
        t0 = time.time() * 1e6
        T.flow("request", "s", str(rid), cat="request", ts_us=t0,
               step="enqueue", broker="b0")
        with T.span("parse.chunk", cat="parse", block=0):
            time.sleep(0.002)
        T.instant("allreduce.stall", missing_shards=[1], shard=0,
                  waited_s=1.5, reducer="rf", phase="exchange", step=3)
        T.instant("autoscaler.decision", action="up", active=1,
                  new_active=2, depth=99, derivative_per_s=10.0,
                  p99_ms=5.0)
        T.instant("registry.publish", model="m", version=4)
        for rows in (8, 3):
            with T.span("serve.predict", cat="serve", rows=rows,
                        model="m"):
                time.sleep(0.001)
        T.flow("request", "t", str(rid), cat="request", ts_us=t0 + 3000,
               step="pop", worker="w0")
        T.flow("request", "f", str(rid), cat="request", ts_us=t0 + 5000,
               step="reply", queue_wait_ms=3.0, coalesce_ms=1.0,
               device_ms=0.8, reply_ms=0.2, total_ms=5.0)
        T.flow("request", "s", str(rid + 1), cat="request", ts_us=t0 + 4e5,
               step="enqueue")
        T.flow("request", "f", str(rid + 1), cat="request", ts_us=t0 + 9e5,
               step="reply")
    finally:
        T.uninstall_tracer()
    tr.close()
    return tr.path, t0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tracetool_matches_the_jax_tool(tmp_path, writer):
    path, t0 = _write_trace(writer, str(tmp_path / "tr"))
    other, _ = _write_trace("torch" if writer == "jax" else "jax",
                            str(tmp_path / "tr2"), rid=142, index=1)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"Serving": {"Requests": 10, "Batches": 2}}))
    b.write_text(json.dumps({"Serving": {"Requests": 14},
                             "Drift": {"Alerts": 1}}))
    jc = tmp_path / "jax.counters.json"
    jc.write_text(json.dumps({
        "Dispatches": {"forest.level": 4, "pipeline.chunk": 7},
        "KernelBackends": {"forest.level.xla": 4,
                           "serve.predict.quantized": 2}}))
    merged, exported = str(tmp_path / "m.json"), str(tmp_path / "e.json")

    def tool(*argv):
        return {"tool": "tracetool", "argv": list(argv)}

    steps = [tool("summarize", path), tool("summarize", path, other),
             tool("summarize", path, "--counters", str(jc)),
             tool("merge", "-o", merged, path, other),
             tool("chrome-export", path, "-o", exported),
             tool("counter-diff", str(a), str(b)),
             tool("request", "42", path), tool("request", "43", path),
             tool("request", "nope", path),
             tool("incident", str(t0 / 1e6 - 1), str(t0 / 1e6 + 5),
                  path),
             tool("incident", "1000", "1001", path)]
    want, got = _both(steps)
    _assert_same(want, got, steps)
    assert [w["rc"] for w in want] == [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1]
    assert "parse.chunk" in want[0]["out"] and "STALL" in want[0]["out"]
    assert "request 42: 3 flow leg(s), wire 5.000 ms" in want[6]["out"]
    assert "autoscaler decisions" in want[9]["out"]
    with open(merged) as fh:
        events = json.load(fh)["traceEvents"]
    from avenir_tpu_torch.telemetry.trace import validate_trace_events
    assert validate_trace_events(events) == []


def test_tracetool_names_the_port_backends(tmp_path):
    """``summarize --counters`` over a port job's counters: every line is
    the JAX tool's up to the backend table, where the port's tool splits
    ``<site>.cuda`` and ``<site>.torch`` into the site and its form and
    the JAX tool shows the whole key with ``?``."""
    path, _ = _write_trace("torch", str(tmp_path / "tr"))
    pc = tmp_path / "port.counters.json"
    pc.write_text(json.dumps({
        "Dispatches": {"forest.level": 4, "pipeline.chunk": 7},
        "KernelBackends": {"forest.level.torch": 4,
                           "baseline.absorb.cuda": 7}}))
    steps = [{"tool": "tracetool",
              "argv": ["summarize", path, "--counters", str(pc)]}]
    (w,), (g,) = _both(steps)
    assert g["rc"] == w["rc"] == 0
    head = "hot-site kernel backends"
    wl, gl = w["out"].splitlines(), g["out"].splitlines()
    cut = [i for i, x in enumerate(wl) if x.startswith(head)][0]
    assert gl[:cut + 2] == wl[:cut + 2]
    assert [x.split() for x in wl[cut + 2:]] == [
        ["baseline.absorb.cuda", "-", "?(7)"], ["forest.level", "4", "-"],
        ["forest.level.torch", "-", "?(4)"], ["pipeline.chunk", "7", "-"]]
    assert [x.split() for x in gl[cut + 2:]] == [
        ["baseline.absorb", "-", "cuda(7)"],
        ["forest.level", "4", "torch(4)"], ["pipeline.chunk", "7", "-"]]
