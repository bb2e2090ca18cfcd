"""Single-hidden-layer MLP classifier: port of ``avenir_tpu/nn/mlp.py``
(the reference's python/supv/basic_nn.py): tanh hidden layer, softmax
output, cross-entropy with L2 on the weight matrices (not the biases),
trained by plain gradient descent in full batch ("batch"), per shuffled
example ("incr") or per shuffled minibatch ("minibatch").

Parameters are a dict of float32 tensors on one device, and the whole run
stays there: the step is the closed-form backward pass of basic_nn.py
(``softmax - onehot``, ``(1 - a1^2)``), the raw loss's gradient with
``lambda * W`` for the regulariser, as the JAX package's ``jax.grad`` of
the same loss; the losses are read back once at the end.  The random
draws go through :mod:`..utils.threefry`, the JAX package's ``jax.random``
streams: ``init_params`` is bit for bit the JAX package's, and so is every
epoch's permutation (``split`` of the carried key, then ``permutation``).
XLA's CPU ``tanh``, ``log_softmax`` and sums round differently from
torch's, so trained weights agree with the JAX package's to a tolerance
(``tests/test_torch_mlp.py``).  The products ``X @ W1`` and ``a1 @ W2``
are plain ``torch.matmul`` in float32 with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import resolve_device
from ..utils import threefry as tf
from ..utils.xla_math import sqrt_f32

Params = Dict[str, torch.Tensor]
NAMES = ("W1", "b1", "W2", "b2")


@dataclass
class MLPConfig:
    hidden_dim: int = 3
    n_classes: int = 2
    learning_rate: float = 0.01      # epsilon (basic_nn.py:31)
    reg_lambda: float = 0.01         # reg_lambda (basic_nn.py:85)
    mode: str = "batch"              # batch | incr | minibatch
    iterations: int = 1000           # num_passes
    batch_size: int = 64             # minibatch mode only
    seed: int = 0
    validation_interval: int = 50    # loss recorded every this many passes


def _scalar(v: float, device) -> torch.Tensor:
    """A 0-dim float32 operand: on CUDA, dividing by a Python scalar
    multiplies by its reciprocal instead."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def init_params(n_features: int, cfg: MLPConfig, key=None,
                device=None) -> Params:
    """randn/sqrt(fan_in) init, zero biases (basic_nn.py:126-129), drawn
    as the JAX package draws it: ``split(PRNGKey(seed))`` and one
    ``normal`` a matrix."""
    device = key.device if key is not None else resolve_device(device)
    key = key if key is not None else tf.PRNGKey(cfg.seed, device)
    k1, k2 = tf.split(key, 2)
    H, C = cfg.hidden_dim, cfg.n_classes
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {
        "W1": tf.normal(k1, (n_features, H)) /
        sqrt_f32(zero + float(n_features)),
        "b1": torch.zeros(H, dtype=torch.float32, device=device),
        "W2": tf.normal(k2, (H, C)) / sqrt_f32(zero + float(H)),
        "b2": torch.zeros(C, dtype=torch.float32, device=device),
    }


def forward_logits(params: Params, X: torch.Tensor) -> torch.Tensor:
    a1 = torch.tanh(torch.addmm(params["b1"], X, params["W1"]))
    return torch.addmm(params["b2"], a1, params["W2"])


def predict_proba(params: Params, X: torch.Tensor) -> torch.Tensor:
    return torch.softmax(forward_logits(params, X), dim=-1)


def predict(params: Params, X: torch.Tensor) -> torch.Tensor:
    return torch.argmax(forward_logits(params, X), dim=-1)


def loss_fn(params: Params, X: torch.Tensor, y: torch.Tensor,
            reg_lambda: float) -> torch.Tensor:
    """Mean cross-entropy + (lambda/2)(|W1|^2+|W2|^2)/n, the reference's
    calculate_loss normalisation (basic_nn.py:87-103)."""
    logp = torch.log_softmax(forward_logits(params, X), dim=-1)
    ce = -logp.gather(1, y[:, None]).sum()
    reg = 0.5 * reg_lambda * ((params["W1"] ** 2).sum()
                              + (params["W2"] ** 2).sum())
    return (ce + reg) / _scalar(float(X.shape[0]), X.device)


def _grad_step(params: Params, X: torch.Tensor, y: torch.Tensor,
               lr: float, reg_lambda: float) -> Params:
    """One GD step on the un-normalised loss with regulariser gradient
    lambda*W (basic_nn.py:141-160: summed delta3, dW += reg_lambda*W,
    W -= epsilon*dW)."""
    W1, b1, W2, b2 = (params[k] for k in NAMES)
    a1 = torch.tanh(torch.addmm(b1, X, W1))
    d3 = torch.softmax(torch.addmm(b2, a1, W2), dim=-1)
    d3[torch.arange(X.shape[0], device=X.device), y] -= 1.0
    d2 = (d3 @ W2.T) * (1.0 - a1 * a1)
    # the regulariser's lambda*W folded into each product (addmm's beta)
    grads = (torch.addmm(W1, X.T, d2, beta=reg_lambda), d2.sum(0),
             torch.addmm(W2, a1.T, d3, beta=reg_lambda), d3.sum(0))
    return {k: torch.add(p, g, alpha=-lr) for k, p, g in
            zip(NAMES, (W1, b1, W2, b2), grads)}


def _train_batch(params, X, y, Xv, yv, lr, reg_lambda, iters: int,
                 interval: int):
    """Full-batch steps; the validation loss at each interval's end (one
    final loss when there are fewer iterations than an interval)."""
    interval = max(interval, 1)
    n_outer, rem = divmod(iters, interval)
    losses = []
    for _ in range(n_outer):
        for _ in range(interval):
            params = _grad_step(params, X, y, lr, reg_lambda)
        losses.append(loss_fn(params, Xv, yv, reg_lambda))
    for _ in range(rem):
        params = _grad_step(params, X, y, lr, reg_lambda)
    if n_outer == 0:
        losses.append(loss_fn(params, Xv, yv, reg_lambda))
    return params, losses


def _train_shuffled(params, X, y, Xv, yv, lr, reg_lambda, key, iters: int,
                    interval: int, batch_size: Optional[int]):
    """Epochs over a fresh permutation drawn from ``split`` of the carried
    key: one step an example (``batch_size`` None) or an aligned batch;
    the validation loss after every epoch, sampled every ``interval``."""
    n = X.shape[0]
    losses = []
    for _ in range(iters):
        key, sub = tf.split(key, 2)
        order = tf.permutation(sub, n)
        if batch_size is None:
            for j in order.tolist():
                params = _grad_step(params, X[j:j + 1], y[j:j + 1], lr,
                                    reg_lambda)
        else:
            nb = n // batch_size
            for idx in order[:nb * batch_size].reshape(nb, batch_size):
                params = _grad_step(params, X[idx], y[idx], lr, reg_lambda)
        losses.append(loss_fn(params, Xv, yv, reg_lambda))
    return params, losses[::max(interval, 1)]


def to_device(params, device=None) -> Params:
    """A parameter dict (numpy arrays or tensors) as float32 tensors on
    ``device`` (default: the process device)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32)
                               if not torch.is_tensor(v) else v,
                               dtype=torch.float32).to(device)
            for k, v in params.items()}


def train(X: np.ndarray, y: np.ndarray, cfg: MLPConfig,
          X_val: Optional[np.ndarray] = None,
          y_val: Optional[np.ndarray] = None,
          params0: Optional[Params] = None, device=None
          ) -> Tuple[Params, np.ndarray]:
    """Train per ``cfg.mode`` on ``device``; returns (params, the
    validation-loss history sampled every ``cfg.validation_interval``
    passes), the training loss without a validation split.  ``params0``
    warm-starts from an earlier run (checkpoint resume)."""
    device = resolve_device(device)
    Xt = torch.as_tensor(np.asarray(X, np.float32)).to(device)
    yt = torch.as_tensor(np.asarray(y, np.int64)).to(device)
    Xv = torch.as_tensor(np.asarray(X_val, np.float32)).to(device) \
        if X_val is not None else Xt
    yv = torch.as_tensor(np.asarray(y_val, np.int64)).to(device) \
        if y_val is not None else yt
    params = to_device(params0, device) if params0 is not None \
        else init_params(Xt.shape[1], cfg, device=device)
    args = (Xt, yt, Xv, yv, cfg.learning_rate, cfg.reg_lambda)
    if cfg.mode == "batch":
        params, losses = _train_batch(params, *args, cfg.iterations,
                                      cfg.validation_interval)
    elif cfg.mode in ("incr", "minibatch"):
        key = tf.PRNGKey(cfg.seed + 1, device)
        params, losses = _train_shuffled(
            params, *args, key, cfg.iterations, cfg.validation_interval,
            None if cfg.mode == "incr" else cfg.batch_size)
    else:
        raise ValueError(f"invalid training mode {cfg.mode!r} "
                         "(batch | incr | minibatch)")
    hist = torch.stack(losses).cpu().numpy() if losses else \
        np.zeros((0,), np.float32)
    return params, hist


def train_ensemble(X: np.ndarray, y: np.ndarray, cfg: MLPConfig,
                   seeds: Sequence[int], device=None) -> Params:
    """Full batch-mode runs, one a seed (``PRNGKey`` of the uint32 seed),
    on the training data as validation set; returns the params stacked
    on a leading replica axis."""
    device = resolve_device(device)
    Xt = torch.as_tensor(np.asarray(X, np.float32)).to(device)
    yt = torch.as_tensor(np.asarray(y, np.int64)).to(device)
    runs = []
    for seed in seeds:
        p = init_params(Xt.shape[1], cfg,
                        key=tf.PRNGKey(int(seed) & tf.M32, device))
        p, _ = _train_batch(p, Xt, yt, Xt, yt, cfg.learning_rate,
                            cfg.reg_lambda, cfg.iterations,
                            cfg.validation_interval)
        runs.append(p)
    return {k: torch.stack([r[k] for r in runs]) for k in NAMES}


def ensemble_predict(stacked: Params, X: np.ndarray) -> torch.Tensor:
    """Soft vote over the replica axis of :func:`train_ensemble`'s output:
    argmax of the replica-mean class probabilities."""
    dev = stacked["W1"].device
    Xt = torch.as_tensor(np.asarray(X, np.float32)).to(dev)
    probs = torch.stack([
        predict_proba({k: stacked[k][r] for k in NAMES}, Xt)
        for r in range(stacked["W1"].shape[0])])
    return torch.argmax(probs.mean(dim=0), dim=-1)


# ---- model artifact (CSV lines, core.artifacts contract) ----

def to_lines(params: Params, delim: str = ",") -> List[str]:
    lines = []
    for name in NAMES:
        arr = np.asarray(params[name].detach().cpu().numpy()
                         if torch.is_tensor(params[name]) else params[name])
        arr2 = arr.reshape(1, -1) if arr.ndim == 1 else arr
        lines.append(f"#{name}{delim}{arr2.shape[0]}{delim}{arr2.shape[1]}")
        for row in arr2:
            lines.append(delim.join(repr(float(v)) for v in row))
    return lines


def from_lines(lines: Sequence[str], delim: str = ",",
               device=None) -> Params:
    """Parse :func:`to_lines` output into float32 tensors on ``device``."""
    device = resolve_device(device)
    params: Params = {}
    i = 0
    while i < len(lines):
        head = lines[i].strip()
        if not head.startswith("#"):
            i += 1
            continue
        name, r, c = head[1:].split(delim)
        r, c = int(r), int(c)
        rows = [[float(v) for v in lines[i + 1 + k].split(delim)]
                for k in range(r)]
        arr = torch.as_tensor(np.asarray(rows, np.float32)).to(device)
        params[name] = arr[0] if name.startswith("b") else arr
        i += 1 + r
    return params
