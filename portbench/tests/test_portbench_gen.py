"""The vectorised generators draw from the upstream generators' models:
the same fields and ranges, and the same class balance and means within
sampling error, at n = 20,000."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from portbench.gen import call_hangup, elearn

N = 20000
UPSTREAM = Path(__file__).resolve().parents[2] / "resource" / "gen"


def _upstream(name):
    spec = importlib.util.spec_from_file_location(name, UPSTREAM / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a: np.ndarray, b: np.ndarray):
    """Means of two samples within four standard errors."""
    se = np.sqrt(a.var() / len(a) + b.var() / len(b))
    assert abs(a.mean() - b.mean()) <= 4 * se + 1e-12, (a.mean(), b.mean())


def test_call_hangup_draws_the_upstream_model():
    rows = [r.split(",") for r in _upstream("call_hangup_gen").generate(N, 3)]
    mine = call_hangup.csv_lines(call_hangup.columns(
        np.random.default_rng(4), N))
    ours = [r.split(",") for r in mine]
    assert len(ours[0]) == len(rows[0]) == 6
    assert [r[0] for r in ours[:2]] == ["K0000000", "K0000001"]
    for up, me in ((rows, ours),):
        for col, lo, hi in ((2, 0, 1800), (3, 0, 4), (4, 0, 9)):
            vals = np.array([int(r[col]) for r in me])
            assert vals.min() >= lo and vals.max() <= hi
            _close(vals.astype(float),
                   np.array([int(r[col]) for r in up], float))
        for issue in call_hangup.ISSUES:
            _close(np.array([r[1] == issue for r in me], float),
                   np.array([r[1] == issue for r in up], float))
        assert {r[5] for r in me} == {r[5] for r in up} == {"F", "T"}
        _close(np.array([r[5] == "T" for r in me], float),
               np.array([r[5] == "T" for r in up], float))


def test_elearn_draws_the_upstream_model():
    up = np.array([[float(x) for x in r.split(",")[1:5]] +
                   [r.endswith("pass")]
                   for r in _upstream("elearn_gen").generate(N, 3)])
    cols = elearn.columns(np.random.default_rng(4), N)
    me = np.stack([cols[f] for f in elearn.FEATURES] +
                  [cols["outcome"].astype(float)], axis=1)
    assert me[:, 0].min() >= 0 and np.allclose(me[:, 0], np.round(me[:, 0], 2))
    assert me[:, 1].min() >= 0 and me[:, 1].max() <= 100
    assert np.allclose(me[:, 1], np.round(me[:, 1], 1))
    assert me[:, 2].max() <= 49 and me[:, 3].max() <= 20
    assert set(np.unique(me[:, 4])) == {0.0, 1.0}
    for j in range(5):
        _close(me[:, j], up[:, j])


@pytest.mark.parametrize("gen", [call_hangup, elearn])
def test_same_seed_same_rows(gen):
    a = gen.columns(np.random.default_rng([2 ** 33 + 1, 1]), 1000)
    b = gen.columns(np.random.default_rng([2 ** 33 + 1, 1]), 1000)
    assert all(np.array_equal(a[k], b[k]) for k in a)
