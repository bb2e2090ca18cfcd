"""The device profile capture of the port (``utils.tracing.trace`` behind
``profile.trace.dir`` / ``AVENIR_TPU_TRACE_DIR`` in ``cli.run``), on the
CPU against the JAX package's ``trace``:

* no directory (None or empty) is a silent no-op in both;
* a profiler that cannot start warns in the JAX package's words and the
  job goes on without a capture;
* a traced ``-Dplatform=cpu`` job, through the key or the variable, writes
  one Chrome trace that loads, with outputs byte-equal to an untraced run;
* two shard-lane processes sharing one directory write two files, each
  named by its process index.

The card's half (B1's and B2's kernels in the trace, in the numbers their
wrappers counted) is ``chip_smoke.py`` phase 71."""

import json
import os
import subprocess
import sys
import warnings

import pytest

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
RAFO9 = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9")
PREDICT = ["modelPredictor", f"-Dconf.path={os.path.join(RES, 'rafo.properties')}",
           "-Dplatform=cpu", f"-Dmop.model.dir.path={RAFO9}",
           "-Dmop.feature.schema.file.path="
           f"{os.path.join(RES, 'call_hangup.json')}",
           os.path.join(RAFO9, "requests.csv")]
TRACE_KEYS = ("AVENIR_TPU_TRACE_DIR", "AVENIR_TPU_SHARD",
              "AVENIR_TPU_ALLREDUCE_DIR", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "MASTER_ADDR", "MASTER_PORT")


def _traces(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pt.trace.json")) \
        if os.path.isdir(d) else []


def _load_one(d):
    files = _traces(d)
    assert len(files) == 1, files
    with open(os.path.join(d, files[0])) as fh:
        trace = json.load(fh)
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    return files[0], trace


def _pred(out):
    with open(os.path.join(out, "part-m-00000"), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("log_dir", [None, ""])
def test_no_directory_is_silent(log_dir):
    from avenir_tpu.utils.tracing import trace as jax_trace
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for fn in (jax_trace, tracing.trace):
            with fn(log_dir) as active:
                assert active is False


def test_failing_profiler_warns_in_the_jax_words(monkeypatch, tmp_path):
    import jax
    import torch.profiler
    from avenir_tpu.utils.tracing import trace as jax_trace

    def boom(*a, **k):
        raise RuntimeError("profiler unsupported on this backend")
    monkeypatch.setattr(jax.profiler, "start_trace", boom)
    monkeypatch.setattr(torch.profiler.profile, "start", boom)
    msgs = []
    log_dir = str(tmp_path / "prof")
    for fn in (jax_trace, tracing.trace):
        with pytest.warns(RuntimeWarning,
                          match="profiler trace capture.*unavailable.*"
                                "RuntimeError: profiler unsupported") as w:
            with fn(log_dir) as active:
                assert active is False
        msgs.append([str(x.message) for x in w])
    assert msgs[0] == msgs[1]
    assert _traces(log_dir) == []


def test_capture_yields_active_and_writes_one_trace(tmp_path):
    import torch
    d = str(tmp_path / "cap")
    with tracing.trace(d) as active:
        assert active is True
        torch.arange(10).sum()
    name, trace = _load_one(d)
    assert "_p0_" in name
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("plain") / "out")
    assert port_run.main(PREDICT + [out]) == 0
    return _pred(out)


@pytest.mark.parametrize("via", ["key", "variable"])
def test_traced_cli_job_writes_one_loadable_trace(tmp_path, monkeypatch,
                                                  untraced, via):
    for k in TRACE_KEYS:
        monkeypatch.delenv(k, raising=False)
    d = str(tmp_path / "prof")
    args = list(PREDICT)
    if via == "key":
        args.insert(1, f"-Dprofile.trace.dir={d}")
    else:
        monkeypatch.setenv("AVENIR_TPU_TRACE_DIR", d)
    out = str(tmp_path / "out")
    assert port_run.main(args + [out]) == 0
    assert _pred(out) == untraced
    _, trace = _load_one(d)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_key_wins_and_empty_variable_means_unset(tmp_path, monkeypatch,
                                                 untraced):
    for k in TRACE_KEYS:
        monkeypatch.delenv(k, raising=False)
    key_dir, env_dir = str(tmp_path / "key"), str(tmp_path / "env")
    monkeypatch.setenv("AVENIR_TPU_TRACE_DIR", env_dir)
    out = str(tmp_path / "a")
    assert port_run.main([PREDICT[0], f"-Dprofile.trace.dir={key_dir}"]
                         + PREDICT[1:] + [out]) == 0
    assert len(_traces(key_dir)) == 1 and _traces(env_dir) == []
    monkeypatch.setenv("AVENIR_TPU_TRACE_DIR", "")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert port_run.main(PREDICT + [str(tmp_path / "b")]) == 0
    assert _pred(str(tmp_path / "b")) == untraced
    assert not os.path.exists(env_dir)


def test_two_shard_processes_share_one_directory(tmp_path):
    """Two ``modelPredictor`` processes of a shard lane (each its own
    output) traced into one directory: two files, named ``p0`` and
    ``p1``."""
    d = str(tmp_path / "prof")
    env = {k: v for k, v in os.environ.items() if k not in TRACE_KEYS}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "avenir_tpu_torch.cli.run", PREDICT[0],
         f"-Dprofile.trace.dir={d}"] + PREDICT[1:] + [str(tmp_path / f"o{i}")],
        env={**env, "AVENIR_TPU_SHARD": f"{i}/2"}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-2000:]
    files = _traces(d)
    assert len(files) == 2
    assert sorted(f.split("_p")[-1].split("_")[0] for f in files) == ["0", "1"]
    for f in files:
        with open(os.path.join(d, f)) as fh:
            assert json.load(fh)["traceEvents"]
    assert _pred(str(tmp_path / "o0")) == _pred(str(tmp_path / "o1"))
