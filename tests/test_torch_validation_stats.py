"""Model validation and the MCMC convergence diagnostics in the port
(``avenir_tpu_torch/models/validation.py``, ``stats/mcconverge.py``)
against the JAX package, on the CPU.

Both are host numpy, copied: the folds, the random splits and the
bagging draws come from the same numpy streams, so the scores, models
and votes are equal; the vmapped k-fold (``torch.func.vmap`` over the
fold masks, where the JAX package uses ``jax.vmap``) gives the fold loop's
accuracies.  The Geweke z-scores and Raftery-Lewis sizes equal the JAX
package's bit for bit.
"""

import numpy as np
import pytest
import torch

from avenir_tpu.models import validation as JV
from avenir_tpu.stats import mcconverge as JMC
from avenir_tpu_torch.models import validation as V
from avenir_tpu_torch.stats import mcconverge as MC


def _data(seed, n=240, d=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d))
    y = (X @ rng.normal(0, 1, d) + rng.normal(0, 0.5, n) > 0).astype(int)
    return X, y


def _train(X, y):
    """A nearest-class-mean classifier (deterministic, numpy)."""
    return np.stack([X[y == c].mean(0) if (y == c).any() else
                     np.zeros(X.shape[1]) for c in (0, 1)])


def _predict(m, X):
    return np.argmin(((X[:, None, :] - m[None]) ** 2).sum(-1), axis=1)


@pytest.mark.parametrize("folds,shuffle,seed", [(3, True, 0), (5, False, 1),
                                                (10, True, 2)])
def test_kfold_matches(folds, shuffle, seed):
    X, y = _data(seed)
    got = V.kfold_validation(X, y, folds, _train, _predict, shuffle, seed)
    want = JV.kfold_validation(X, y, folds, _train, _predict, shuffle, seed)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (got.mean, got.std) == (want.mean, want.std)


@pytest.mark.parametrize("folds,iters,seed", [(4, 3, 3), (5, 6, 4)])
def test_random_fold_matches(folds, iters, seed):
    X, y = _data(seed)
    got = V.random_fold_validation(X, y, folds, iters, _train, _predict, seed)
    want = JV.random_fold_validation(X, y, folds, iters, _train, _predict,
                                     seed)
    np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("rate,seed", [(1.0, 5), (0.3, 6), (0.0, 7)])
def test_bagging_and_majority_vote_match(rate, seed):
    X, y = _data(seed)
    got = V.bagging_train(X, y, 5, _train, rate, seed)
    want = JV.bagging_train(X, y, 5, _train, rate, seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(V.majority_vote(got, X, _predict),
                                  JV.majority_vote(want, X, _predict))


def _fold_accuracy(X, y, mask):
    """Vmappable trainer: class means over the training mask, accuracy
    over the held-out rows."""
    w = mask.to(X.dtype)
    yf = y.to(X.dtype)
    m1 = (X * (w * yf)[:, None]).sum(0) / (w * yf).sum()
    m0 = (X * (w * (1 - yf))[:, None]).sum(0) / (w * (1 - yf)).sum()
    pred = (((X - m1) ** 2).sum(1) < ((X - m0) ** 2).sum(1)).to(X.dtype)
    hold = 1 - w
    return ((pred == yf).to(X.dtype) * hold).sum() / hold.sum()


@pytest.mark.parametrize("folds", [2, 4, 7])
def test_vmapped_kfold_equals_the_fold_loop(folds):
    X, y = _data(8 + folds)
    got = V.kfold_validation_vmapped(X, y, folds, _fold_accuracy, seed=3,
                                     device="cpu")
    n = len(y)
    idx = np.arange(n)
    np.random.default_rng(3).shuffle(idx)
    want = []
    for fold in np.array_split(idx, folds):
        mask = np.ones(n, bool)
        mask[fold] = False
        want.append(float(_fold_accuracy(torch.as_tensor(X),
                                         torch.as_tensor(y),
                                         torch.as_tensor(mask))))
    np.testing.assert_allclose(got.scores, want, rtol=0, atol=1e-12)
    assert got.scores.shape == (folds,)


def _chain(seed, n=4000, rho=0.9):
    rng = np.random.default_rng(seed)
    x = np.empty(n)
    x[0] = 5.0
    for i in range(1, n):
        x[i] = rho * x[i - 1] + rng.normal()
    return x


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_geweke_matches(seed):
    x = _chain(seed)
    sizes = [0, 50, 200, 1000, 3999, 5000]
    got = MC.GewekeConvergence(sizes, 0.1, 0.5)
    want = JMC.GewekeConvergence(sizes, 0.1, 0.5)
    assert got.calculate_zscore(x) == want.calculate_zscore(x)
    assert got.get_zscores() == want.get_zscores()


@pytest.mark.parametrize("seed,q", [(4, 0.025), (5, 0.5), (6, 0.975)])
def test_raftery_lewis_matches(seed, q):
    x = _chain(seed, rho=0.7)
    args = (2, 0.95, 0.01, 0.001, q)
    assert MC.RafteryLewisConvergence(*args).find_sample_size(x) == \
        JMC.RafteryLewisConvergence(*args).find_sample_size(x)


def test_raftery_lewis_degenerate_chain():
    x = np.arange(100.0)   # binarized chain never leaves its state twice
    assert MC.RafteryLewisConvergence(1, 0.95, 0.01, 0.001
                                      ).find_sample_size(x) == \
        JMC.RafteryLewisConvergence(1, 0.95, 0.01, 0.001).find_sample_size(x)
