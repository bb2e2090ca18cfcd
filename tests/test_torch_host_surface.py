"""The host surface the port's copies of the JAX package's modules carry,
held against the JAX package on the same inputs (CPU, small sizes):

* retry and backoff: ``with_retry(attempts=, base_delay=, retry_on=)``
  and the ``AVENIR_TPU_RETRY_*`` variables draw the same sleeps in both
  packages; the RESP client reconnects through it;
* the stall heartbeat's ``AVENIR_TPU_STALL_HEARTBEAT_S``;
* the broker's ``avenir_broker_durable`` gauges (``bind_metrics``);
* ``StepTimer.mean_ms``, ``percentiles_ms`` and ``summary``;
* ``Counters.group``, ``from_json``, ``append_jsonl`` and pickling;
* the ``ArtifactStore`` readers and writers (byte-equal files);
* ``DecisionPathList.find`` and ``Predicate.evaluate`` over rafo9's
  trees;
* the small readers: ``MarkovModel.prob`` / ``state_index``, ``ItemSet``'s
  ``contains_*``, ``TransactionMatrix.n_trans``,
  ``RuleExpression.extract_consequent``, ``Baseline.row_index``,
  ``ColumnarTable.column`` and ``positional_cluster(condition_flags=)``.

Every comparison is exact."""

import json
import os
import pickle
import random
import subprocess
import sys
import warnings

import numpy as np
import pytest

from avenir_tpu.core import faults as jfaults
from avenir_tpu_torch.core import faults as pfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures")
RAFO9 = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9")
RAFO9Q = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9q")
SCHEMA = os.path.join(RES, "call_hangup.json")


# --------------------------------------------------------------------------
# retry, backoff and the stall heartbeat
# --------------------------------------------------------------------------

def _sleeps(mod, monkeypatch, seed, **kw):
    """An always-failing ``with_retry`` of ``mod`` on a jitter stream
    seeded with ``seed``, its backoff sleeps."""
    slept = []
    monkeypatch.setattr(mod.time, "sleep", slept.append)
    monkeypatch.setattr(mod, "_JITTER_RNG", random.Random(seed))

    def always():
        raise OSError("transient")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(OSError):
            mod.with_retry(always, **kw)
    return slept


@pytest.mark.parametrize("seed,kw", [
    (1234, {"attempts": 4, "base_delay": 0.1}),
    (7, {"attempts": 6, "base_delay": 0.02}),
    (1234, {})])
def test_with_retry_draws_the_jax_sleeps_under_a_seed(monkeypatch, seed,
                                                      kw):
    want = _sleeps(jfaults, monkeypatch, seed, **kw)
    got = _sleeps(pfaults, monkeypatch, seed, **kw)
    assert got == want
    assert len(got) == kw.get("attempts", 3) - 1


def test_with_retry_retry_on_and_its_warning(monkeypatch):
    """``retry_on`` narrows what is retried; the warning names the
    operation, the exception and the sleep as the JAX package's does."""
    monkeypatch.setattr(pfaults.time, "sleep", lambda s: None)
    monkeypatch.setattr(jfaults.time, "sleep", lambda s: None)
    for mod in (jfaults, pfaults):
        calls = []

        def hard():
            calls.append(1)
            raise MemoryError("not retried here")
        with pytest.raises(MemoryError):
            mod.with_retry(hard, retry_on=(OSError,))
        assert calls == [1]
    msgs = []
    for mod in (jfaults, pfaults):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 2:
                raise OSError("blip")
            return "ok"
        monkeypatch.setattr(mod, "_JITTER_RNG", random.Random(5))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert mod.with_retry(flaky, what="probe") == "ok"
        msgs.append([str(x.message) for x in w])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 1
    assert msgs[1][0].startswith("probe failed (OSError: blip); retry 1/2")


_SEED_PROBE = """
import json, sys, warnings
mod = __import__(sys.argv[1], fromlist=["with_retry"])
slept = []
mod.time.sleep = slept.append
def always():
    raise OSError("transient")
warnings.simplefilter("ignore")
for _ in range(2):
    try:
        mod.with_retry(always)
    except OSError:
        pass
print(json.dumps([mod.RETRY_ATTEMPTS, mod.RETRY_BASE_S, slept]))
"""


def test_retry_variables_give_the_jax_stream_in_a_subprocess():
    """``AVENIR_TPU_RETRY_SEED`` seeds the per-process stream, and the
    attempts and base come from their variables: two calls in a fresh
    process sleep the same in both packages."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("AVENIR_TPU_RETRY")}
    env.update(AVENIR_TPU_RETRY_SEED="99", AVENIR_TPU_RETRY_ATTEMPTS="4",
               AVENIR_TPU_RETRY_BASE_S="0.25", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    out = []
    for mod in ("avenir_tpu.core.faults", "avenir_tpu_torch.core.faults"):
        res = subprocess.run([sys.executable, "-c", _SEED_PROBE, mod],
                             env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        out.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert out[0] == out[1]
    attempts, base, slept = out[1]
    assert (attempts, base, len(slept)) == (4, 0.25, 6)
    assert slept[:3] != slept[3:]          # one stream, not re-seeded


def test_resp_reconnect_goes_through_with_retry(monkeypatch):
    """The client's reconnect is ``with_retry(self._connect, attempts=4,
    base_delay=0.05, retry_on=(OSError,))`` in both packages, and warns
    after reconnecting."""
    from avenir_tpu.io import respq as jrespq
    from avenir_tpu_torch.io import respq as prespq
    seen = []
    for mod, faults in ((jrespq, jfaults), (prespq, pfaults)):
        server = mod.RespServer().start()
        try:
            client = mod.RespClient(port=server.port)
            real = faults.with_retry

            def spy(fn, **kw):
                seen.append({k: v for k, v in kw.items() if k != "what"})
                return real(fn, **kw)
            monkeypatch.setattr(faults, "with_retry", spy)
            if hasattr(mod, "with_retry"):
                monkeypatch.setattr(mod, "with_retry", spy)
            with pytest.warns(RuntimeWarning, match="dropped .*reconnected"):
                client._reconnect_once(ConnectionResetError("gone"))
            assert client.reconnects == 1
            client.lpush_many("q", ["a"])
            client.close()
        finally:
            server.stop()
    assert seen[0] == seen[1] == {"attempts": 4, "base_delay": 0.05,
                                  "retry_on": (OSError,)}


@pytest.mark.parametrize("env,kw", [
    ({"AVENIR_TPU_STALL_HEARTBEAT_S": "2.5"}, {}),
    ({"AVENIR_TPU_STALL_HEARTBEAT_S": "0"}, {}),
    ({"AVENIR_TPU_STALL_HEARTBEAT_S": "2.5"}, {"heartbeat_s": 7.0}),
    ({}, {"timeout_s": 20.0}),
    ({}, {})])
def test_stall_heartbeat_variable(monkeypatch, env, kw):
    from avenir_tpu.parallel.collectives import AllReducer as JaxReducer
    from avenir_tpu.parallel.distributed import ShardSpec as JaxSpec
    from avenir_tpu_torch.parallel.collectives import AllReducer
    from avenir_tpu_torch.parallel.distributed import ShardSpec
    monkeypatch.delenv("AVENIR_TPU_STALL_HEARTBEAT_S", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = JaxReducer(spec=JaxSpec(0, 1), **kw).heartbeat_s
    assert AllReducer(spec=ShardSpec(0, 1), **kw).heartbeat_s == want
    if env and not kw:
        assert want == float(env["AVENIR_TPU_STALL_HEARTBEAT_S"])


def _durable_lines(text):
    return sorted(l for l in text.splitlines()
                  if l.startswith("avenir_broker_durable{"))


def test_bind_metrics_renders_the_jax_durable_gauges(tmp_path):
    """The same traffic through a durable broker of each package renders
    the same ``avenir_broker_durable`` lines (every key of
    tests/test_durable_broker.py's check, the same values), attaches the
    Broker counters, and the returned probe unregisters."""
    from avenir_tpu.io.respq import RespClient as JaxClient
    from avenir_tpu.io.respq import RespServer as JaxServer
    from avenir_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
    from avenir_tpu_torch.io.respq import RespClient, RespServer
    from avenir_tpu_torch.telemetry.metrics import MetricsRegistry
    rendered = []
    for server_cls, client_cls, registry_cls, tag in (
            (JaxServer, JaxClient, JaxRegistry, "j"),
            (RespServer, RespClient, MetricsRegistry, "p")):
        registry = registry_cls()
        s = server_cls(durable="commit",
                       journal_dir=str(tmp_path / tag)).start()
        cli = client_cls(port=s.port)
        try:
            probe = s.bind_metrics(registry, endpoint="ep")
            cli.lpush_many("rq", ["predict,0,a", "predict,1,b"])
            cli.lease_many("rq", 1, lease_s=30.0)
            text = registry.render()
            rendered.append(text)
            registry.unregister_probe(probe)
        finally:
            cli.close()
            s.stop()
    want, got = (_durable_lines(t) for t in rendered)
    assert got == want
    for key in ("queue_depth", "leased", "journal_bytes", "journal_segments",
                "redelivered", "journal_replayed", "journal_fsync_ms"):
        assert any(f'key="{key}"' in l for l in got), key
    assert 'avenir_broker_durable{endpoint="ep",key="leased"} 1' in got
    assert 'avenir_broker_durable{endpoint="ep",key="queue_depth"} 1' in got
    assert 'avenir_job_counter{group="Broker"' in rendered[1]


# --------------------------------------------------------------------------
# StepTimer, Counters, ArtifactStore
# --------------------------------------------------------------------------

def test_step_timer_means_percentiles_and_summary():
    from avenir_tpu.utils.tracing import StepTimer as JaxTimer
    from avenir_tpu_torch.utils.tracing import StepTimer
    rng = np.random.default_rng(3)
    timers = [JaxTimer(keep_samples=64), StepTimer(keep_samples=64)]
    for name, n in (("serve", 100), ("job", 1), ("idle", 0)):
        for s in rng.exponential(0.004, n):
            for t in timers:
                t.record(name, float(s))
    j, p = timers
    for name in ("serve", "job", "idle"):
        assert p.mean_ms(name) == j.mean_ms(name)
        assert p.percentiles_ms(name) == j.percentiles_ms(name)
        assert p.percentiles_ms(name, (10.0, 90.0)) == \
            j.percentiles_ms(name, (10.0, 90.0))
    assert p.summary() == j.summary()
    assert "serve: " in p.summary() and "ms/100x" in p.summary()


def _counters_pair():
    from avenir_tpu.core.metrics import Counters as JaxCounters
    from avenir_tpu_torch.core.metrics import Counters
    pair = (JaxCounters(), Counters())
    for c in pair:
        c.increment("Serving", "Requests", 12)
        c.set("Profiling", "job.timeMs", 877)
        c.set("Profiling", "job.calls", 1)
        c.max("Serving", "MaxBatchObserved", 64)
        c.update_group("Transfers", {"H2DBytes": 64000, "D2HBytes": 8000})
    return pair


def test_counters_json_round_trip_and_group():
    from avenir_tpu_torch.core.metrics import Counters
    j, p = _counters_pair()
    back = Counters.from_json(j.to_json())
    assert back.to_json() == j.to_json() == p.to_json()
    assert back.as_dict() == j.as_dict()
    for g in ("Serving", "Profiling", "Transfers", "Absent"):
        assert p.group(g) == j.group(g)
    assert Counters.from_json("{}").as_dict() == {}


def test_counters_append_jsonl_bytes(tmp_path):
    paths = [str(tmp_path / f"{t}.jsonl") for t in "jp"]
    for c, path in zip(_counters_pair(), paths):
        c.append_jsonl(path, tag="window-0")
        c.increment("Serving", "Requests")
        c.append_jsonl(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and got.count(b"\n") == 2


def test_counters_pickle_drops_and_rebuilds_the_lock():
    _, p = _counters_pair()
    q = pickle.loads(pickle.dumps(p))
    assert q.as_dict() == p.as_dict()
    q.increment("Serving", "Requests")
    assert q.get("Serving", "Requests") == 13
    assert p.get("Serving", "Requests") == 12


def test_artifact_store_files_are_byte_equal(tmp_path):
    from avenir_tpu.core.artifacts import ArtifactStore as JaxStore
    from avenir_tpu.core.artifacts import write_json as jax_write_json
    from avenir_tpu_torch.core.artifacts import ArtifactStore
    from avenir_tpu_torch.core.artifacts import write_json
    obj = {"decisionPaths": [{"population": 3, "p": [0.5, 0.25]}],
           "name": "rafo9", "ok": True, "none": None}
    lines = [f"{i},{i * i},x" for i in range(50)]
    for store_cls, tag in ((JaxStore, "j"), (ArtifactStore, "p")):
        st = store_cls(str(tmp_path / tag))
        assert not st.exists("decPathOut")
        st.write_lines("decPathOut", iter(lines))
        st.write_json("model.json", obj)
        st.rotate("decPathOut", "decPathIn")
        assert st.exists("decPathIn") and not st.exists("decPathOut")
        assert st.read_lines("decPathIn") == lines
        assert st.read_json("model.json") == obj
    jax_write_json(str(tmp_path / "j" / "meta.json"), obj)
    write_json(str(tmp_path / "p" / "meta.json"), obj)
    for rel in (os.path.join("decPathIn", "part-r-00000"), "model.json",
                "meta.json"):
        with open(tmp_path / "j" / rel, "rb") as a, \
                open(tmp_path / "p" / rel, "rb") as b:
            assert b.read() == a.read(), rel


# --------------------------------------------------------------------------
# the tree: find, evaluate
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def request_rows():
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        return [l.split(",") for l in fh.read().splitlines()[:300]]


@pytest.mark.parametrize("tree", range(9))
def test_find_and_evaluate_agree_with_the_jax_model(request_rows, tree):
    """Each of rafo9's nine trees: ``find`` of every path, and every
    predicate ``evaluate``d on 300 request rows, as the JAX package's."""
    from avenir_tpu.models.tree import DecisionPathList as JaxPaths
    from avenir_tpu_torch.models.tree import DecisionPathList
    with open(os.path.join(RAFO9, f"tree_{tree}.json")) as fh:
        text = fh.read()
    j, p = JaxPaths.from_json(text), DecisionPathList.from_json(text)
    assert len(p.decision_paths) == len(j.decision_paths) > 1
    for jp, pp in zip(j.decision_paths, p.decision_paths):
        found = p.find(pp.path_str)
        assert found is not None and found.path_str == pp.path_str
        assert j.find(jp.path_str).to_dict() == found.to_dict()
        for jpred, ppred in zip(jp.predicates, pp.predicates):
            for row in request_rows:
                v = row[ppred.attribute] if ppred.operator else None
                assert ppred.evaluate(v) == jpred.evaluate(v)
    assert p.find("no such path") is None is j.find("no such path")


# --------------------------------------------------------------------------
# the small readers
# --------------------------------------------------------------------------

def test_markov_prob_and_state_index_on_the_golden_model():
    from avenir_tpu.sequence.markov import MarkovModel as JaxMarkov
    from avenir_tpu_torch.sequence.markov import MarkovModel
    with open(os.path.join(GOLDEN, "markov", "model.csv")) as fh:
        lines = fh.read().splitlines()
    j = JaxMarkov.from_lines(lines, class_based=True)
    p = MarkovModel.from_lines(lines, class_based=True)
    assert p.state_index == j.state_index
    for label in j.matrices:
        for a in j.states:
            for b in j.states:
                assert p.prob(label, a, b) == j.prob(label, a, b)


def test_itemsets_and_transaction_matrix_on_the_golden_pairs():
    from avenir_tpu.association import itemsets as jit
    from avenir_tpu_torch.association import itemsets as pit
    with open(os.path.join(GOLDEN, "apriori", "freq_pairs.csv")) as fh:
        lines = fh.read().splitlines()
    j = jit.parse_itemset_lines(lines, 2, contains_trans_ids=False)
    p = pit.parse_itemset_lines(lines, 2, contains_trans_ids=False)
    vocab = sorted({it for s in j for it in s.items}) + ["absent"]
    for js, ps in zip(j, p):
        for it in vocab:
            assert ps.contains_item(it) == js.contains_item(it)
    trans = [(f"t{i}", vocab[i % 3:i % 3 + 2 + i % 2]) for i in range(11)]
    jm, pm = jit.TransactionMatrix(trans), pit.TransactionMatrix(trans)
    assert pm.n_trans == jm.n_trans == 11
    full_j = jit.ItemSet(("a", "b"), trans_ids=["t1", "t4"])
    full_p = pit.ItemSet(("a", "b"), trans_ids=["t1", "t4"])
    for t in ("t1", "t4", "t5", ""):
        assert full_p.contains_trans(t) == full_j.contains_trans(t)


@pytest.mark.parametrize("rule", [
    "1 gt 30 & 3 in a:b > yes", "0 le 2 >  no ", "2 eq x", " > ",
    "1 gt 3 > a > b"])
def test_extract_consequent(rule):
    from avenir_tpu.explore.rules import RuleExpression as JaxRule
    from avenir_tpu_torch.explore.rules import RuleExpression
    assert RuleExpression.extract_consequent(rule) == \
        JaxRule.extract_consequent(rule)


def test_baseline_row_index_on_rafo9q():
    from avenir_tpu.monitor.baseline import load_baseline as jax_load
    from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry
    from avenir_tpu_torch.monitor.baseline import load_baseline
    from avenir_tpu_torch.serving.registry import ModelRegistry
    reg = os.path.join(RAFO9Q, "registry")
    j = jax_load(JaxRegistry(reg), "rafo9")
    p = load_baseline(ModelRegistry(reg), "rafo9")
    names = [s.name for s in j.specs]
    assert [s.name for s in p.specs] == names and names
    for name in names:
        assert p.row_index(name) == j.row_index(name)
    for mod in (p, j):
        with pytest.raises(KeyError, match="no monitored row"):
            mod.row_index("absent")


def test_columnar_table_column():
    from avenir_tpu.core.schema import FeatureSchema as JaxSchema
    from avenir_tpu.core.table import load_csv as jax_load_csv
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import load_csv
    path = os.path.join(RAFO9, "requests.csv")
    j = jax_load_csv(path, JaxSchema.load(SCHEMA))
    p = load_csv(path, FeatureSchema.load(SCHEMA))
    assert sorted(p.columns) == sorted(j.columns)
    for o in j.columns:
        got, want = p.column(o), j.column(o)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _burst():
    recs = [(t, 1.0) for t in range(0, 5000, 1000)]
    return recs + [(6000 + i * 150, 5.0) for i in range(8)]


@pytest.mark.parametrize("kw", [
    {"condition_flags": [i % 2 == 0 for i in range(13)]},
    {"condition_flags": [i >= 5 for i in range(13)]},
    {"condition_flags": [False] * 13},
    {}])
def test_positional_cluster_condition(kw):
    from avenir_tpu.sequence import positional as jpos
    from avenir_tpu_torch.sequence import positional as ppos
    args = dict(window_time_span=2000, time_step=100,
                min_event_time_interval=50, preferred_strategies=["count"],
                min_occurence=4)
    want = jpos.positional_cluster(_burst(), jpos.LocalityConfig(**args),
                                   0.5, **kw)
    got = ppos.positional_cluster(_burst(), ppos.LocalityConfig(**args),
                                  0.5, **kw)
    assert got == want

