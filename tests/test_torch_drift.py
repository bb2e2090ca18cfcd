"""The port's drift monitor (``avenir_tpu_torch/monitor/{drift,accumulator,
policy}.py``) held against the JAX package's on the CPU.

* ``DriftScorer``: seeded windows and baselines through both scorers.  At
  the widths of the baselines the port publishes today (the rafo9q
  baseline: R=5, B=7; here B from 3 to 11), ``ks`` and ``chi2`` are
  bit-exact and ``psi``, ``kl`` and ``js`` within rtol 1e-5 / atol 1e-7,
  with the share of differing bits and of differing six-decimal report
  strings printed and bounded.  At the default 33-bin width XLA's CPU code
  vectorises its row sums and the port's left-to-right order no longer
  holds for any statistic: there the bound is the tolerance alone, and the
  string share is bounded by what was measured.
* The scorer against ``tests/test_monitor.py``'s independent numpy oracle,
  at that file's tolerance.
* ``DriftAccumulator`` / ``StreamDriftMonitor``: windows, the decayed long
  window, ``close_counts`` and the knob refusals, report for report.
* ``DriftPolicy`` debounce and warn bands, ``AccuracyTracker``: the same
  record streams as the reference's.
"""

import json

import numpy as np
import pytest

from avenir_tpu.core.table import encode_rows as jax_encode_rows
from avenir_tpu.monitor import accumulator as ja
from avenir_tpu.monitor import baseline as jb
from avenir_tpu.monitor import drift as jd
from avenir_tpu.monitor import policy as jp

from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import encode_rows
from avenir_tpu_torch.monitor import accumulator as pa
from avenir_tpu_torch.monitor import baseline as pbl
from avenir_tpu_torch.monitor import drift as pd
from avenir_tpu_torch.monitor import policy as pp

from test_monitor import SCHEMA as JAX_SCHEMA, make_rows, oracle_stats

SCHEMA_DICT = {"fields": [
    {"name": "x1", "ordinal": 0, "dataType": "double", "feature": True,
     "min": -6, "max": 6},
    {"name": "hold", "ordinal": 1, "dataType": "int", "feature": True,
     "bucketWidth": 60, "min": 0, "max": 600},
    {"name": "cat", "ordinal": 2, "dataType": "categorical",
     "feature": True, "cardinality": ["a", "b", "c"]},
    {"name": "free", "ordinal": 3, "dataType": "double", "feature": True},
    {"name": "y", "ordinal": 4, "dataType": "categorical",
     "cardinality": ["n", "p"]}]}
SCHEMA = FeatureSchema.from_dict(SCHEMA_DICT)

RTOL, ATOL = 1e-5, 1e-7
STATS = pd.STATS


def _baselines(bin_sizes, p_rows):
    """The same hand-built baseline in both packages (numeric, categorical
    and class rows over heterogeneous bin alphabets)."""
    b_max = max(bin_sizes)
    counts = np.zeros((len(bin_sizes), b_max))
    specs_j, specs_p = [], []
    for i, nb in enumerate(bin_sizes):
        kind = "class" if i == len(bin_sizes) - 1 else \
            ("categorical" if i % 2 else "numeric")
        kw = dict(name=f"r{i}", kind=kind, ordinal=i, n_bins=nb,
                  labels=None if kind == "numeric" else
                  [f"v{j}" for j in range(nb)])
        specs_j.append(jb.RowSpec(**kw))
        specs_p.append(pbl.RowSpec(**kw))
        counts[i, :nb] = p_rows[i]
    n = int(counts.sum())
    return (jb.Baseline(specs=specs_j, counts=counts.copy(), n_rows=n),
            pbl.Baseline(specs=specs_p, counts=counts.copy(), n_rows=n))


def _random_case(rng, R, B):
    bin_sizes = list(rng.integers(2, B + 1, R))
    bin_sizes[0] = B
    p_rows = [np.where(rng.random(nb) < 0.15, 0, rng.integers(0, 500, nb))
              for nb in bin_sizes]
    window = np.zeros((R, B))
    for i, nb in enumerate(bin_sizes):
        if rng.random() < 0.5:       # integer counts (a tumbling window)
            window[i, :nb] = rng.integers(0, 300, nb)
        else:                        # decayed counts (a long window)
            window[i, :nb] = rng.random(nb) * 3000
    return _baselines(bin_sizes, p_rows), window


def _compare(cases):
    """(bit-differing count per stat, differing strings, total) over the
    cases, asserting the tolerance on every value."""
    bits = np.zeros(len(STATS), int)
    strings = total = 0
    for (bj, bp), window in cases:
        want = jd.DriftScorer(bj).score_counts(window, 10)
        got = pd.DriftScorer(bp, device="cpu").score_counts(window, 10)
        for rw, rg in zip(want.rows, got.rows):
            assert (rw.scope, rw.kind) == (rg.scope, rg.kind)
            for j, s in enumerate(STATS):
                a, b = rw.stats[s], rg.stats[s]
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{rw.scope} {s}")
                bits[j] += np.float32(a) != np.float32(b)
                strings += repr(round(a, 6)) != repr(round(b, 6))
                total += 1
    return bits, strings, total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorer_matches_reference_at_published_widths(seed):
    rng = np.random.default_rng(seed)
    cases = [_random_case(rng, int(rng.integers(1, 8)),
                          int(rng.integers(3, 12))) for _ in range(25)]
    cases += [_random_case(rng, 5, 7) for _ in range(15)]   # rafo9q's shape
    bits, strings, total = _compare(cases)
    print(f"bit-differing values psi/kl/js/ks/chi2 {bits.tolist()} of "
          f"{total // len(STATS)} rows; differing six-decimal strings "
          f"{strings} of {total}")
    assert bits[STATS.index("ks")] == 0 and bits[STATS.index("chi2")] == 0
    # psi / kl / js: one ulp in under 1.5% of rows (0.1-0.5% measured)
    assert bits.max() <= 0.015 * total / len(STATS)
    assert strings <= 0.001 * total


def test_scorer_at_default_width_within_tolerance():
    rng = np.random.default_rng(33)
    cases = [_random_case(rng, 6, 33) for _ in range(15)]
    bits, strings, total = _compare(cases)
    print(f"33 bins: bit-differing values {bits.tolist()}; differing "
          f"six-decimal strings {strings} of {total}")
    assert strings <= 0.12 * total     # 6.4% measured


def test_scorer_matches_numpy_oracle_per_statistic():
    rng = np.random.default_rng(3)
    bin_sizes = [8, 4, 16, 3, 5]
    p_rows = [rng.integers(1, 1000, nb) for nb in bin_sizes]
    q_rows = [rng.integers(0, 500, nb) for nb in bin_sizes]
    _, baseline = _baselines(bin_sizes, p_rows)
    window = np.zeros_like(baseline.counts)
    for i, nb in enumerate(bin_sizes):
        window[i, :nb] = q_rows[i]
    report = pd.DriftScorer(baseline, device="cpu").score_counts(window, 100)
    assert len(report.rows) == len(bin_sizes)
    for i, row in enumerate(report.rows):
        expect = oracle_stats(p_rows[i], q_rows[i])
        for stat in STATS:
            np.testing.assert_allclose(
                row.stats[stat], expect[stat], rtol=2e-3, atol=1e-5,
                err_msg=f"row {i} stat {stat}")


def test_scorer_extremes_match_reference():
    """Empty window rows, all mass in one bin, a window equal in
    distribution to the baseline (scores ~0)."""
    bin_sizes = [6, 4, 3]
    p_rows = [np.array([0, 5, 0, 9, 1, 0]), np.array([100, 0, 0, 1]),
              np.array([7, 7, 7])]
    bj, bp = _baselines(bin_sizes, p_rows)
    for window_rows in ([np.zeros(6), np.zeros(4), np.zeros(3)],
                        [np.array([0, 0, 50, 0, 0, 0]),
                         np.array([0, 0, 0, 9]), np.array([0, 0, 1])],
                        [3 * r for r in p_rows]):
        window = np.zeros_like(bp.counts)
        for i, nb in enumerate(bin_sizes):
            window[i, :nb] = window_rows[i]
        _compare([((bj, bp), window)])


def test_score_table_counts_through_b4():
    rng = np.random.default_rng(5)
    rows = make_rows(rng, 3000)
    bj = jb.compute_baseline(jax_encode_rows(rows, JAX_SCHEMA))
    bp = pbl.compute_baseline(encode_rows(rows, SCHEMA), device="cpu")
    np.testing.assert_array_equal(bp.counts, bj.counts)
    window = make_rows(rng, 700, mu=0.7)
    want = jd.DriftScorer(bj).score_table(jax_encode_rows(window,
                                                          JAX_SCHEMA))
    got = pd.DriftScorer(bp, device="cpu").score_table(
        encode_rows(window, SCHEMA))
    assert got.n_rows == want.n_rows == 700
    for rw, rg in zip(want.rows, got.rows):
        for s in STATS:
            np.testing.assert_allclose(rg.stats[s], rw.stats[s], rtol=RTOL,
                                       atol=ATOL)


# --------------------------------------------------------------------------
# accumulator and stream monitor
# --------------------------------------------------------------------------

def _pair_baselines(n=6000, seed=0):
    rows = make_rows(np.random.default_rng(seed), n)
    return (jb.compute_baseline(jax_encode_rows(rows, JAX_SCHEMA)),
            pbl.compute_baseline(encode_rows(rows, SCHEMA), device="cpu"))


def _report_key(r):
    return (r.index, r.kind, r.n_rows,
            [(row.scope, row.kind) for row in r.rows])


def test_accumulator_matches_reference_counts():
    bj, bp = _pair_baselines()
    rows = make_rows(np.random.default_rng(1), 5000, mu=0.3)
    aj, ap = ja.DriftAccumulator(bj), pa.DriftAccumulator(bp, device="cpu")
    for lo in range(0, 5000, 700):             # odd block sizes
        aj.absorb_table(jax_encode_rows(rows[lo:lo + 700], JAX_SCHEMA))
        ap.absorb_table(encode_rows(rows[lo:lo + 700], SCHEMA))
    ap.absorb_codes(np.zeros((0, len(bp.specs)), np.int32))   # no-op
    cj, nj = aj.finalize()
    cp, n_p = ap.finalize()
    assert n_p == nj == 5000
    np.testing.assert_array_equal(cp, cj)
    # tumbling reset; warm() leaves the window untouched
    cp2, n2 = ap.finalize()
    assert n2 == 0 and cp2.sum() == 0
    ap.warm()
    ap.absorb_table(encode_rows(rows[:100], SCHEMA))
    cp3, n3 = ap.finalize()
    assert n3 == 100 and cp3.sum() == 100 * len(bp.specs)


def test_blocks_past_the_top_bucket_split_there():
    """A 9,000-row block absorbs as 4,096 + 4,096 + 808-row launches (the
    reference's float32 adds), each one B4 call."""
    bj, bp = _pair_baselines()
    codes = pbl.encode_monitor_codes(
        encode_rows(make_rows(np.random.default_rng(2), 9000), SCHEMA),
        bp.specs)
    aj, ap = ja.DriftAccumulator(bj), pa.DriftAccumulator(bp, device="cpu")
    aj.absorb_codes(codes)
    calls = []
    real = pa.bin_counts

    def spy(c, B, mask=None, out=None):
        calls.append(c.shape[0])
        return real(c, B, mask, out=out)
    pa.bin_counts, saved = spy, pa.bin_counts
    try:
        ap.absorb_codes(codes)
    finally:
        pa.bin_counts = saved
    assert calls == [4096, 4096, 808]
    np.testing.assert_array_equal(ap.finalize()[0], aj.finalize()[0])


@pytest.mark.parametrize("window_rows,decay", [(2000, 0.5), (777, 0.9)])
def test_stream_monitor_reports_match_reference(window_rows, decay):
    bj, bp = _pair_baselines()
    rng = np.random.default_rng(11)
    batches = [make_rows(rng, n, mu=mu) for n, mu in
               ((1500, 0.0), (2600, 0.4), (900, 1.2))]
    mj = ja.StreamDriftMonitor(bj, window_rows=window_rows, decay=decay)
    mp = pa.StreamDriftMonitor(bp, window_rows=window_rows, decay=decay,
                               device="cpu")
    for b in batches:
        mj.observe_table(jax_encode_rows(b, JAX_SCHEMA))
        mp.observe_table(encode_rows(b, SCHEMA))
    tj, tp = mj.close_window(), mp.close_window()
    assert tp.n_rows == tj.n_rows
    assert [_report_key(r) for r in mp.reports] == \
        [_report_key(r) for r in mj.reports]
    for rj, rp in zip(mj.reports, mp.reports):
        for a, b in zip(rj.rows, rp.rows):
            for s in STATS:
                np.testing.assert_allclose(b.stats[s], a.stats[s],
                                           rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(mp._long_counts, mj._long_counts)
    assert mp._long_n == mj._long_n
    assert mp.counters.as_dict() == {
        g: dict(v) for g, v in mj.counters.as_dict().items()}


def test_close_counts_rides_the_same_path():
    bj, bp = _pair_baselines()
    counts = np.asarray(bp.counts) * 0.25
    mj = ja.StreamDriftMonitor(bj, window_rows=100)
    mp = pa.StreamDriftMonitor(bp, window_rows=100, device="cpu")
    rj, rp = mj.close_counts(counts, 1500), mp.close_counts(counts, 1500)
    assert _report_key(rp) == _report_key(rj)
    assert mp.close_counts(counts, 0) is None
    mp.observe_table(encode_rows(make_rows(np.random.default_rng(3), 10),
                                 SCHEMA))
    with pytest.raises(ValueError, match="one absorb path"):
        mp.close_counts(counts, 5)


def test_stream_monitor_rejects_bad_knobs():
    _, bp = _pair_baselines(200)
    with pytest.raises(ValueError, match="window_rows"):
        pa.StreamDriftMonitor(bp, window_rows=0, device="cpu")
    with pytest.raises(ValueError, match="decay"):
        pa.StreamDriftMonitor(bp, decay=1.0, device="cpu")


def test_class_codes_for_labels_shared_encoding():
    bj, bp = _pair_baselines(200)
    labels = ["n", "p", "ambiguous", None, "p"]
    np.testing.assert_array_equal(bp.class_codes_for_labels(labels),
                                  bj.class_codes_for_labels(labels))
    assert bp.n_bins_max == bj.n_bins_max and bp.class_row == bj.class_row
    np.testing.assert_array_equal(bp.probabilities(), bj.probabilities())


# --------------------------------------------------------------------------
# policy
# --------------------------------------------------------------------------

def _reports(mod, values, kind="window", scope="f", row_kind="numeric"):
    return [mod.DriftReport(index=i, kind=kind, n_rows=100, rows=[
        mod.RowScore(scope=scope, kind=row_kind,
                     stats={"psi": v, "kl": v / 2, "js": v / 10,
                            "ks": v / 3, "chi2": v / 4})])
        for i, v in enumerate(values)]


@pytest.mark.parametrize("consecutive", [1, 2, 3])
def test_policy_records_match_reference(consecutive):
    values = [0.05, 0.12, 0.3, 0.3, 0.11, 0.12, 0.5, 0.0, 0.26, 0.27, 0.28]
    fired_j, fired_p = [], []
    pol_j = jp.DriftPolicy(consecutive=consecutive)
    pol_p = pp.DriftPolicy(consecutive=consecutive)
    for kind, row_kind in (("window", "numeric"), ("longterm",
                                                   "categorical")):
        for rj, rp in zip(_reports(jd, values, kind, row_kind=row_kind),
                          _reports(pd, values, kind, row_kind=row_kind)):
            fired_j += pol_j.observe(rj)
            fired_p += pol_p.observe(rp)
    assert [r.to_json() for r in fired_p] == [r.to_json() for r in fired_j]
    assert fired_p, "the stream must fire"
    assert pol_p.counters.as_dict() == pol_j.counters.as_dict()


def test_policy_threshold_overrides_and_refusal():
    pol_p = pp.DriftPolicy(warn={"psi": 0.2}, alert={"js": 0.5})
    pol_j = jp.DriftPolicy(warn={"psi": 0.2}, alert={"js": 0.5})
    assert pol_p.warn == pol_j.warn and pol_p.alert == pol_j.alert
    with pytest.raises(ValueError, match="consecutive"):
        pp.DriftPolicy(consecutive=0)


def test_accuracy_tracker_matches_reference():
    rng = np.random.default_rng(4)
    preds = list(rng.choice(["n", "p", "ambiguous"], 2300, p=(.5, .4, .1)))
    actual = list(rng.choice(["n", "p", "?"], 2300, p=(.45, .45, .1)))
    recs = []
    for mod in (jp, pp):
        pol = mod.DriftPolicy(consecutive=1, accuracy_warn=60,
                              accuracy_alert=45)
        tr = mod.AccuracyTracker("p", "n", pol, window=500)
        fired = []
        for lo in range(0, 2300, 333):
            fired += tr.record(preds[lo:lo + 333], actual[lo:lo + 333])
        fired += tr.close()
        recs.append(([r.to_json() for r in fired], pol.counters.as_dict()))
    assert recs[1] == recs[0]
    assert recs[0][0], "the tracker must fire"
    with pytest.raises(ValueError, match="window"):
        pp.AccuracyTracker("p", "n", pp.DriftPolicy(), window=0)


def test_alert_record_json_is_the_reference_json():
    kw = dict(window_index=3, window_kind="window", scope="x", stat="psi",
              value=0.31, threshold=0.25, level="alert", streak=2,
              n_rows=512)
    assert pp.AlertRecord(**kw).to_json() == jp.AlertRecord(**kw).to_json()
    assert json.loads(pp.AlertRecord(**kw).to_json())["level"] == "alert"


def test_guardrail_actions():
    class Service:
        swapped = True
        reason = None

        def refresh(self):
            return self.swapped

        def mark_degraded(self, reason):
            self.reason = reason
    svc = Service()
    counters = pp.Counters()
    rec = pp.AlertRecord(0, "window", "x", "psi", 0.5, 0.25, "alert", 2, 9)
    pp.refresh_action(svc, counters)(rec)
    pp.degrade_action(svc, counters)(rec)
    assert svc.reason == "x psi=0.5 >= 0.25"
    assert counters.as_dict()["DriftMonitor"] == {
        "RefreshProbes": 1, "RefreshSwaps": 1, "Degradations": 1}
    assert not hasattr(pp, "retrain_action")
