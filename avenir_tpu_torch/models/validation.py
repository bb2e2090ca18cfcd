"""Model-selection / validation utilities: the port of
``avenir_tpu/models/validation.py`` (host numpy, copied; the folds are
drawn from numpy as the JAX package draws them).  The reference's python validation
layer (python/supv/svm.py:41-165 — linear k-fold, repeated random-fold, and
bagging training over any trainer) generalized over a (train_fn, predict_fn)
pair, plus a vmapped k-fold fast path for trainers written in torch.

Contract: ``train_fn(X, y) -> model``; ``predict_fn(model, X) -> labels``.
Scores are accuracies per fold (the reference prints sklearn cv scores).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np


class ValidationResult(NamedTuple):
    scores: np.ndarray          # per-fold accuracy
    mean: float
    std: float


def _score(predict_fn, model, X, y) -> float:
    pred = np.asarray(predict_fn(model, X))
    return float((pred == np.asarray(y)).mean())


def kfold_validation(X: np.ndarray, y: np.ndarray, n_folds: int,
                     train_fn: Callable, predict_fn: Callable,
                     shuffle: bool = True, seed: int = 0) -> ValidationResult:
    """Linear k-fold cross validation (svm.py train_kfold_validation_ext
    :53-97: contiguous fold slices, train on the rest, score on the fold)."""
    n = len(y)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    folds = np.array_split(idx, n_folds)
    scores = []
    for i in range(n_folds):
        val = folds[i]
        tr = np.concatenate([folds[j] for j in range(n_folds) if j != i])
        model = train_fn(X[tr], y[tr])
        scores.append(_score(predict_fn, model, X[val], y[val]))
    s = np.asarray(scores)
    return ValidationResult(s, float(s.mean()), float(s.std()))


def random_fold_validation(X: np.ndarray, y: np.ndarray, n_folds: int,
                           n_iter: int, train_fn: Callable,
                           predict_fn: Callable,
                           seed: int = 0) -> ValidationResult:
    """Repeated random train/test splits with test fraction 1/n_folds
    (svm.py train_rfold_validation :100-116)."""
    n = len(y)
    test_size = max(n // n_folds, 1)
    rng = np.random.default_rng(seed)
    scores = []
    for _ in range(n_iter):
        idx = rng.permutation(n)
        val, tr = idx[:test_size], idx[test_size:]
        model = train_fn(X[tr], y[tr])
        scores.append(_score(predict_fn, model, X[val], y[val]))
    s = np.asarray(scores)
    return ValidationResult(s, float(s.mean()), float(s.std()))


def bagging_train(X: np.ndarray, y: np.ndarray, n_models: int,
                  train_fn: Callable, sample_rate: float = 1.0,
                  seed: int = 0) -> List:
    """Train n models on bootstrap samples (svm.py train_bagging :22-38);
    combine with majority_vote."""
    rng = np.random.default_rng(seed)
    n = len(y)
    m = max(int(n * sample_rate), 1)  # never hand train_fn an empty sample
    models = []
    for _ in range(n_models):
        idx = rng.integers(0, n, m)
        models.append(train_fn(X[idx], y[idx]))
    return models


def majority_vote(models: Sequence, X: np.ndarray,
                  predict_fn: Callable) -> np.ndarray:
    """Per-record modal prediction over a model list."""
    preds = np.stack([np.asarray(predict_fn(m, X)) for m in models])
    out = []
    for col in preds.T:
        vals, counts = np.unique(col, return_counts=True)
        out.append(vals[np.argmax(counts)])
    return np.asarray(out)


def kfold_validation_vmapped(X: np.ndarray, y: np.ndarray, n_folds: int,
                             train_fold_fn: Callable,
                             seed: int = 0, device=None) -> ValidationResult:
    """All folds train at once under one ``torch.func.vmap`` over the fold
    masks (the JAX package's ``jax.vmap`` fast path).

    ``train_fold_fn(X, y, mask) -> accuracy`` takes torch tensors, must be
    vmappable (no data-dependent Python control flow) and honor a boolean
    training mask (False rows held out), returning validation accuracy
    over the held-out rows — each fold is then just a different mask, and
    the k trainings run as one batched program on ``device``."""
    import torch
    from ..runtime import resolve_device

    dev = resolve_device(device)
    n = len(y)
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    fold_of = np.empty(n, dtype=np.int32)
    for i, fold in enumerate(np.array_split(idx, n_folds)):
        fold_of[fold] = i
    masks = np.stack([fold_of != i for i in range(n_folds)])  # (k, n) train
    Xt = torch.as_tensor(np.asarray(X), device=dev)
    yt = torch.as_tensor(np.asarray(y), device=dev)
    accs = torch.func.vmap(lambda m: train_fold_fn(Xt, yt, m))(
        torch.as_tensor(masks, device=dev))
    s = accs.detach().cpu().numpy()
    return ValidationResult(s, float(s.mean()), float(s.std()))
