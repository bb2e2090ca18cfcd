"""The drift monitor's serving hook (``PredictionService(monitor=)`` with a
``ServingMonitor``) on the CPU.

* The reports the hook produces while serving rafo9's 2,000 requests (from
  the rafo9q registry, whose version carries the baseline) equal, report
  for report and bit for bit, an offline ``StreamDriftMonitor`` fed the
  same rows and the served labels, in both batching modes; and the
  statistics equal the JAX package's offline monitor over the same rows
  and the reference's served labels (``rafo9/served.csv``) within rtol
  1e-5 / atol 1e-7.
* A monitor whose flush raises is counted (``DriftMonitor/RecordErrors``)
  and warned; a hook that raises is warned; serving answers every request
  either way.
* ``mark_degraded`` flags the service and a hot-swap clears it.
"""

import os
import shutil

import numpy as np
import pytest

from avenir_tpu.core.table import encode_rows as jax_encode_rows
from avenir_tpu.monitor import accumulator as ja
from avenir_tpu.monitor import baseline as jb
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry

from avenir_tpu_torch.core.table import encode_rows
from avenir_tpu_torch.monitor.accumulator import (ServingMonitor,
                                                  StreamDriftMonitor)
from avenir_tpu_torch.monitor.baseline import load_baseline
from avenir_tpu_torch.monitor.policy import DriftPolicy, degrade_action
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.serving.service import BatchPolicy, PredictionService

TESTS = os.path.dirname(os.path.abspath(__file__))
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
RAFO9Q = os.path.join(TESTS, "torch_fixtures", "rafo9q", "registry")
WINDOW, FLUSH = 300, 64


@pytest.fixture(scope="module")
def requests():
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        return [line.split(",") for line in fh.read().splitlines()]


@pytest.fixture
def registry(tmp_path):
    shutil.copytree(RAFO9Q, tmp_path / "reg")
    return ModelRegistry(str(tmp_path / "reg"))


def _serve(registry, requests, monitor, batching="continuous"):
    svc = PredictionService(registry=registry, model_name="rafo9",
                            device="cpu", monitor=monitor,
                            policy=BatchPolicy(max_batch=37, max_wait_ms=0.5,
                                               batching=batching))
    svc.start()
    futures = [svc.submit(r) for r in requests]
    labels = [f.result(timeout=60) for f in futures]
    svc.stop()
    return svc, labels


def _key(r):
    return (r.index, r.kind, r.n_rows,
            [(row.scope, row.kind, row.stats) for row in r.rows])


@pytest.mark.parametrize("batching", ["continuous", "drain"])
def test_hook_reports_equal_an_offline_monitor(registry, requests, batching):
    baseline = load_baseline(registry, "rafo9")
    schema = registry.load("rafo9").schema
    mon = ServingMonitor(baseline, schema, window_rows=WINDOW,
                         flush_rows=FLUSH, async_flush=False, device="cpu")
    svc, labels = _serve(registry, requests, mon, batching)
    mon.close()
    offline = StreamDriftMonitor(baseline, window_rows=WINDOW, device="cpu")
    offline.observe_table(encode_rows(requests, schema),
                          class_codes=baseline.class_codes_for_labels(labels))
    offline.close_window()
    assert len(mon.reports) == 2 * -(-len(requests) // WINDOW)
    assert [_key(r) for r in mon.reports] == \
        [_key(r) for r in offline.reports]
    assert mon.counters.get("DriftMonitor", "RowsSeen") == len(requests)
    assert mon.counters.get("DriftMonitor", "RecordErrors") == 0
    assert svc.counters.get("Serving", "Requests") == len(requests)


def test_hook_reports_match_the_reference_monitor(registry, requests):
    baseline = load_baseline(registry, "rafo9")
    schema = registry.load("rafo9").schema
    mon = ServingMonitor(baseline, schema, window_rows=WINDOW,
                         flush_rows=FLUSH, async_flush=False, device="cpu")
    _, labels = _serve(registry, requests, mon)
    mon.close()
    with open(os.path.join(RAFO9, "served.csv")) as fh:
        served = [line.split(",")[1] for line in fh.read().splitlines()]
    assert labels == served
    jreg = JaxRegistry(str(registry.base_dir))
    jbase = jb.load_baseline(jreg, "rafo9")
    jmon = ja.StreamDriftMonitor(jbase, window_rows=WINDOW)
    jmon.observe_table(jax_encode_rows(requests, jreg.load("rafo9").schema),
                       class_codes=jbase.class_codes_for_labels(served))
    jmon.close_window()
    assert len(jmon.reports) == len(mon.reports)
    for rj, rp in zip(jmon.reports, mon.reports):
        assert (rj.index, rj.kind, rj.n_rows) == (rp.index, rp.kind,
                                                  rp.n_rows)
        for a, b in zip(rj.rows, rp.rows):
            assert (a.scope, a.kind) == (b.scope, b.kind)
            for s, v in a.stats.items():
                np.testing.assert_allclose(b.stats[s], v, rtol=1e-5,
                                           atol=1e-7)


def test_failing_flush_is_counted_and_serving_answers(registry, requests):
    baseline = load_baseline(registry, "rafo9")
    schema = registry.load("rafo9").schema
    mon = ServingMonitor(baseline, schema, window_rows=WINDOW,
                         flush_rows=FLUSH, async_flush=False, device="cpu")

    def broken(*a, **k):
        raise RuntimeError("device lost")
    mon.stream.observe_table = broken
    with pytest.warns(RuntimeWarning, match="dropping"):
        _, labels = _serve(registry, requests[:500], mon)
    assert len(labels) == 500 and all(labels)
    with pytest.warns(RuntimeWarning, match="dropping"):
        mon.flush()
    assert mon.counters.get("DriftMonitor", "RecordErrors") == 500


def test_failing_hook_is_warned_and_serving_answers(registry, requests):
    class Broken:
        def record_batch(self, rows, labels):
            raise ValueError("hook down")
    with pytest.warns(RuntimeWarning, match="monitor hook failed"):
        svc, labels = _serve(registry, requests[:100], Broken())
    assert len(labels) == 100 and all(labels)
    assert svc.counters.get("Serving", "Requests") == 100


def test_async_flush_matches_inline(registry, requests):
    baseline = load_baseline(registry, "rafo9")
    schema = registry.load("rafo9").schema
    reports = []
    for async_flush in (False, True):
        mon = ServingMonitor(baseline, schema, window_rows=WINDOW,
                             flush_rows=FLUSH, async_flush=async_flush,
                             device="cpu")
        _serve(registry, requests[:900], mon)
        mon.close()
        reports.append([_key(r) for r in mon.reports])
    assert reports[0] == reports[1]


def test_degrade_action_flags_and_refresh_clears(registry, requests):
    svc = PredictionService(registry=registry, model_name="rafo9",
                            device="cpu")
    policy = DriftPolicy(consecutive=1, on_alert=degrade_action(svc))
    baseline = load_baseline(registry, "rafo9")
    mon = StreamDriftMonitor(baseline, policy=policy, window_rows=200,
                             device="cpu")
    schema = registry.load("rafo9").schema
    # every row in one issue bin: an alert-level shift
    shifted = [[r[0], "other"] + r[2:] for r in requests[:200]]
    mon.observe_table(encode_rows(shifted, schema))
    assert svc.degraded is not None and "issueType" in svc.degraded
    assert svc.counters.get("Serving", "Degraded") >= 1
    # a new version hot-swaps in and clears the flag
    loaded = registry.load("rafo9")
    registry.publish("rafo9", loaded.model, schema=schema)
    assert svc.refresh() and svc.degraded is None
