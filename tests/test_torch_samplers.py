"""The port's samplers (``avenir_tpu_torch/stats/samplers.py``) and
histogram on the CPU: the counterparts of the sampler and histogram tests
of ``tests/test_stats.py``, the draws bit-equal to the online9 fixture's
``samplers.npz`` (made by the JAX package), and live against the JAX
package at other seeds and shapes.  No tolerance on draws: a different
number is a different sample."""

import importlib.util
import os

import numpy as np
import pytest

from avenir_tpu_torch.stats import samplers
from avenir_tpu_torch.stats.histogram import Histogram
from avenir_tpu_torch.utils import threefry as tf

TESTS = os.path.dirname(os.path.abspath(__file__))
ONLINE9 = os.path.join(TESTS, "torch_fixtures", "online9")


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "online9_make", os.path.join(ONLINE9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()


def key(seed):
    return tf.PRNGKey(seed, "cpu")


def test_histogram_roundtrip():
    h = Histogram.create_uninitialized(0.0, 10.0, 1.0)
    vals = np.random.default_rng(0).uniform(0, 10, 10_000)
    h.add_many(vals)
    assert h.bins.sum() == 10_000
    h.normalize()
    assert abs(h.cum_value(4.9) - 0.5) < 0.05
    assert 4.0 <= h.percentile(50) <= 6.0
    assert h.get_min_max() == (0.0, 10.0)
    assert h.bounded_value(42.0) == 10.0
    assert h.value(-5.0) == 0.0
    assert h.value(-0.5) == 0.0
    assert h.cum_value(-0.5) == 0.0


def test_histogram_edge_cases_explicit():
    h = Histogram.create_uninitialized(0.0, 10.0, 1.0)
    assert h.percentile(50) == 0.0
    assert h.cum_value(5.0) == 0.0
    assert h.value(5.0) == 0.0
    h.add(10.0)
    assert h.percentile(50) == h.xmax + h.bin_width == 11.0
    assert h.percentile(100) == 11.0
    assert h.percentile(-5) == h.percentile(0)
    assert h.percentile(250) == h.percentile(100)
    h2 = Histogram.create_uninitialized(0.0, 4.0, 1.0)
    h2.add_many([0.5, 0.5, 2.5, 3.5])
    assert h2.value(0.7) == 2.0
    assert h2.cum_value(2.9) == 0.75
    assert h2.percentile(50) == 1.0
    h2.normalize()
    assert h2.value(0.7) == 0.5
    assert h2.value(-0.2) == 0.0 and h2.value(99.0) == 0.0
    assert h2.cum_value(-0.2) == 0.0 and h2.cum_value(99.0) == 1.0


def test_histogram_equals_the_jax_packages():
    from avenir_tpu.stats.histogram import Histogram as JHistogram
    vals = np.random.default_rng(1).normal(5, 2, 3000)
    a = Histogram.create_uninitialized(-1.0, 11.0, 0.5)
    b = JHistogram.create_uninitialized(-1.0, 11.0, 0.5)
    a.add_many(vals)
    b.add_many(vals)
    assert np.array_equal(a.bins, b.bins)
    a.normalize()
    b.normalize()
    for p in (0, 5, 50, 95, 100):
        assert a.percentile(p) == b.percentile(p)
    for x in (-3.0, 0.1, 4.99, 10.5, 30.0):
        assert a.value(x) == b.value(x) and a.cum_value(x) == b.cum_value(x)


def test_gaussian_reject_sampler_moments():
    s = samplers.gaussian_reject_sample(key(0), mean=5.0, std=2.0, n=20_000)
    assert len(s) == 20_000
    assert abs(s.mean() - 5.0) < 0.1
    assert abs(s.std() - 2.0) < 0.15
    assert s.min() >= 5.0 - 6.0 - 1e-9 and s.max() <= 5.0 + 6.0 + 1e-9


def test_nonparam_reject_sampler_distribution():
    weights = [1.0, 3.0, 6.0, 3.0, 1.0]
    s = samplers.nonparam_reject_sample(key(1), 0.0, 1.0, weights, 30_000)
    bins = np.clip(s.astype(int), 0, 4)
    frac = np.bincount(bins, minlength=5) / len(bins)
    np.testing.assert_allclose(frac, np.asarray(weights) / 14.0, atol=0.03)


def test_weighted_indices_proportional():
    idx = samplers.weighted_indices(key(2), [1.0, 2.0, 7.0], 30_000)
    frac = np.bincount(idx, minlength=3) / 30_000
    np.testing.assert_allclose(frac, [0.1, 0.2, 0.7], atol=0.02)


def test_metropolis_converges_to_target():
    target = [1.0, 2.0, 4.0, 8.0, 4.0, 2.0, 1.0]
    m = samplers.MetropolisSampler(prop_std=1.5, xmin=0.0, bin_width=1.0,
                                   values=target, n_chains=64, seed=3,
                                   device="cpu")
    m.run(300, skip=1)
    trace = m.run(400, skip=2)
    bins = np.clip(trace.reshape(-1).astype(int), 0, 6)
    frac = np.bincount(bins, minlength=7) / bins.size
    np.testing.assert_allclose(frac, np.asarray(target) / np.sum(target),
                               atol=0.06)
    assert m.trans_count > 0


def test_metropolis_mixture_proposal_runs():
    m = samplers.MetropolisSampler(1.0, 0.0, 1.0, [1, 2, 3, 2, 1],
                                   n_chains=8, seed=4, device="cpu")
    m.set_global_proposal(global_std=4.0, threshold=0.8)
    out = m.run(50)
    assert out.shape == (50, 8)
    assert (out >= 0.0).all() and (out <= 4.0).all()


def test_draws_equal_the_fixture():
    """Every sampler at both fixture seeds, bit for bit (the Metropolis
    accepted counts too)."""
    got = MAKE.samplers(samplers, key, device="cpu")
    with np.load(os.path.join(ONLINE9, "samplers.npz")) as z:
        assert sorted(z.files) == sorted(got)
        for k in z.files:
            g = np.asarray(got[k])
            assert g.dtype == z[k].dtype, k
            assert np.array_equal(g, z[k]), k


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3])
def test_draws_equal_the_jax_package_live(seed):
    """Other seeds and shapes, against the JAX package in this process:
    rejection samplers with a shortfall retry, 1,000 weights, chains whose
    target has empty bins (a zero density, an infinite ratio)."""
    import jax
    from avenir_tpu.stats import samplers as jsamplers
    jk = jax.random.PRNGKey(seed)
    assert np.array_equal(
        samplers.gaussian_reject_sample(key(seed), -1.5, 0.3, 700),
        jsamplers.gaussian_reject_sample(jk, -1.5, 0.3, 700))
    assert np.array_equal(
        samplers.nonparam_reject_sample(key(seed), -2.0, 0.7,
                                        [0.0, 5.0, 1.0, 0.5], 900),
        jsamplers.nonparam_reject_sample(jk, -2.0, 0.7,
                                         [0.0, 5.0, 1.0, 0.5], 900))
    w = np.random.default_rng(seed % 1000).uniform(0, 3, 1000)
    w[::17] = 0.0
    assert np.array_equal(samplers.weighted_indices(key(seed), w, 300),
                          np.asarray(jsamplers.weighted_indices(jk, w, 300)))
    target = [0.0, 1.0, 0.0, 6.0, 2.5, 0.0, 3.0]
    for mix in (False, True):
        a = samplers.MetropolisSampler(0.7, -1.0, 0.5, target, n_chains=40,
                                       seed=seed, device="cpu")
        b = jsamplers.MetropolisSampler(0.7, -1.0, 0.5, target,
                                        n_chains=40, seed=seed)
        if mix:
            a.set_global_proposal(2.5, 0.6)
            b.set_global_proposal(2.5, 0.6)
        assert np.array_equal(a.run(6, skip=4), b.run(6, skip=4))
        assert a.trans_count == b.trans_count


def test_weighted_indices_chunks_draw_the_same_rows(monkeypatch):
    """Row i's draws are the flat indices i*len(w)...: drawing in chunks
    changes nothing, and a shorter call's rows are a longer one's first
    rows (what the card check compares on a subset)."""
    w = [0.5, 1.0, 2.0, 0.0, 4.0]
    full = samplers.weighted_indices(key(5), w, 1000)
    monkeypatch.setattr(samplers, "WEIGHTED_CHUNK_ELEMS", 64)
    assert np.array_equal(samplers.weighted_indices(key(5), w, 1000), full)
    assert np.array_equal(samplers.weighted_indices(key(5), w, 300),
                          full[:300])


def test_metropolis_chains_do_not_depend_on_the_chain_count():
    """Chain c draws at counter c: the first chains of a larger run are a
    smaller run's chains (what the card check compares on a subset)."""
    target = [1.0, 2.0, 4.0, 8.0, 4.0, 2.0, 1.0]
    a = samplers.MetropolisSampler(1.5, 0.0, 1.0, target, n_chains=100,
                                   seed=6, device="cpu")
    b = samplers.MetropolisSampler(1.5, 0.0, 1.0, target, n_chains=37,
                                   seed=6, device="cpu")
    assert np.array_equal(a.sub_sample(20)[:37], b.sub_sample(20))
