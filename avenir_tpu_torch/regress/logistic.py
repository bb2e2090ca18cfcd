"""Logistic regression: port of ``avenir_tpu/regress/logistic.py`` —
iterative full-batch gradient training with the reference's
coefficient-history convergence contract.

Reference: regress/LogisticRegressionJob.java — one MR pass per gradient
iteration (the mapper aggregates per-record x*(y-p) into a gradient
vector, the reducer sums the partial aggregates and appends the result to
the coefficient history file), with the outer driver re-running the job
until ``checkConvergence`` says stop: criteria ``iterLimit`` /
``allBelowThreshold`` / ``averageBelowThreshold`` over the percent change
between the last two history lines.  Feature vectors are [1, x...]
(intercept first).  As in the JAX package, the update is the standard
ascent ``w += lr * grad / n``.

Plain torch functions on an explicit device (default: the process
device): :func:`partials` is the mapper's sums over this process's rows
(``p = sigmoid(X @ w)``, ``X.T @ (y - p)`` and the log-loss), and
:func:`step` all-reduces them as one packed ``[grad, ll, n]`` float32
vector across processes before :func:`combine` applies the update.  The
two products are plain ``torch.matmul`` in float32 with TF32 off (the
JAX package computes them outside any Pallas kernel).  XLA's CPU float32
sums in another order than torch's, so the printed ``.9g`` coefficients
agree with the JAX package's to a tolerance, not digit for digit (see
``tests/test_torch_logistic.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable
from ..runtime import resolve_device

ITER_LIMIT = "iterLimit"
ALL_BELOW_THRESHOLD = "allBelowThreshold"
AVERAGE_BELOW_THRESHOLD = "averageBelowThreshold"
_EPS = 1e-7


@dataclass
class LogisticParams:
    pos_class_value: str
    learning_rate: float = 0.1
    convergence_criteria: str = ITER_LIMIT
    iteration_limit: int = 10
    convergence_threshold: float = 5.0    # percent, reference default
    l2: float = 0.0


# ---------------------------------------------------------------------------
# coefficient history (the durable iteration state / checkpoint)
# ---------------------------------------------------------------------------

def parse_history(lines: Sequence[str], delim: str = ",") -> List[np.ndarray]:
    out = []
    for line in lines:
        line = line.strip()
        if line:
            out.append(np.array([float(v) for v in line.split(delim)]))
    return out


def format_coefficients(w: np.ndarray, delim: str = ",") -> str:
    return delim.join(f"{v:.9g}" for v in w)


def percent_diff(prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """|cur - prev| * 100 / |prev| per coefficient
    (LogisticRegressor.setCoefficientDiff)."""
    denom = np.where(np.abs(prev) > 1e-12, np.abs(prev), 1e-12)
    return np.abs(cur - prev) * 100.0 / denom


def check_convergence(history: List[np.ndarray],
                      params: LogisticParams) -> bool:
    """The driver's stop test (LogisticRegressionJob.checkConvergence)."""
    crit = params.convergence_criteria
    if crit == ITER_LIMIT:
        return len(history) >= params.iteration_limit
    if len(history) < 2:
        return False
    diff = percent_diff(history[-2], history[-1])
    if crit == ALL_BELOW_THRESHOLD:
        return bool(np.all(diff <= params.convergence_threshold))
    if crit == AVERAGE_BELOW_THRESHOLD:
        return bool(diff.mean() <= params.convergence_threshold)
    raise ValueError(f"invalid convergence criteria {crit!r}")


# ---------------------------------------------------------------------------
# the gradient step
# ---------------------------------------------------------------------------

def design_matrix(table: ColumnarTable, schema: FeatureSchema,
                  pos_class_value: Optional[str] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """X = [1, features...] (intercept first) in float32, and y = 1.0 for
    rows of the positive class value (None without one)."""
    cols = [np.ones(table.n_rows, np.float32)]
    cols += [np.asarray(table.columns[f.ordinal]).astype(np.float32)
             for f in schema.feature_fields]
    X = np.stack(cols, axis=1)
    if pos_class_value is None:
        return X, None
    pos_code = schema.class_attr_field.must_cat_code(pos_class_value)
    y = (table.class_codes() == pos_code).astype(np.float32)
    return X, y


def partials(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This process's gradient-iteration sums: the reference mapper's
    per-record x*(y-p) aggregation, and the log-loss sum.  Sums, not
    means: across processes they are all-reduced (the reducer)."""
    p = torch.sigmoid(X @ w)
    grad_data = X.T @ (y - p)
    ll_sum = -(y * torch.log(p + _EPS)
               + (1 - y) * torch.log(1 - p + _EPS)).sum()
    return grad_data, ll_sum


def combine(w: torch.Tensor, grad_sum: torch.Tensor, n: torch.Tensor,
            params: LogisticParams) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=w.device)
    grad = grad_sum - torch.tensor(params.l2, **f32) * w
    return w + torch.tensor(params.learning_rate, **f32) * grad / n


def step(w: np.ndarray, X: torch.Tensor, y: torch.Tensor,
         params: LogisticParams) -> Tuple[np.ndarray, float]:
    """One gradient iteration on X's device.  Multi-process: X/y are this
    process's rows; the (grad, log-loss, row count) sums are all-reduced
    as one packed float32 vector, so every process applies the same
    update."""
    from ..parallel.distributed import (all_reduce_host_array,
                                        is_multiprocess)
    w32 = torch.as_tensor(np.asarray(w, np.float32), device=X.device)
    grad_sum, ll_sum = partials(w32, X, y)
    n = torch.tensor(float(X.shape[0]), dtype=torch.float32,
                     device=X.device)
    if is_multiprocess():
        packed = torch.cat([grad_sum, ll_sum.reshape(1), n.reshape(1)])
        packed = all_reduce_host_array(packed.cpu().numpy())
        packed = torch.from_numpy(packed).to(X.device)
        grad_sum, ll_sum, n = packed[:-2], packed[-2], packed[-1]
    w_new = combine(w32, grad_sum, n, params)
    return (w_new.cpu().numpy().astype(np.float64),
            float(ll_sum) / float(n))


def train(table: ColumnarTable, schema: FeatureSchema,
          params: LogisticParams,
          history: Optional[List[np.ndarray]] = None, device=None,
          max_extra_iterations: int = 10_000
          ) -> Tuple[np.ndarray, List[np.ndarray], int]:
    """Run gradient iterations until the convergence criteria fires
    (resuming from an existing history).  Returns (w, history, iters)."""
    device = resolve_device(device)
    X, y = design_matrix(table, schema, params.pos_class_value)
    X = torch.from_numpy(X).to(device)
    y = torch.from_numpy(y).to(device)
    history = list(history) if history else []
    w = history[-1] if history else np.zeros(
        1 + len(schema.feature_fields))
    it = 0
    while not check_convergence(history, params) and \
            it < max_extra_iterations:
        w, _ = step(w, X, y, params)
        history.append(w)
        it += 1
    return w, history, it


# ---- prediction ----
def predict_proba(table: ColumnarTable, schema: FeatureSchema,
                  w: np.ndarray, device=None) -> np.ndarray:
    """sigmoid([1, x...] @ w) in float32 on ``device``."""
    return proba_from_design(design_matrix(table, schema)[0], w, device)


def proba_from_design(X: np.ndarray, w: np.ndarray,
                      device=None) -> np.ndarray:
    device = resolve_device(device)
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
    wt = torch.as_tensor(np.asarray(w, np.float32), device=device)
    return torch.sigmoid(Xt @ wt).cpu().numpy()


def predict(table: ColumnarTable, schema: FeatureSchema,
            params: LogisticParams, w: np.ndarray,
            threshold: float = 0.5, device=None) -> np.ndarray:
    """Class codes: the positive class code where p > threshold."""
    p = predict_proba(table, schema, w, device)
    pos_code, neg_code = pos_neg_codes(schema.class_attr_field,
                                       params.pos_class_value)
    return threshold_codes(p, threshold, pos_code, neg_code)


def pos_neg_codes(class_field, pos_class_value: str) -> Tuple[int, int]:
    """(pos_code, neg_code) with the trainer's negative-class selection
    rule (first cardinality code that is not the positive one).  Shared
    with the serving LogisticPredictor so its decisions cannot diverge
    from this module's."""
    pos_code = class_field.must_cat_code(pos_class_value)
    card = class_field.cardinality or []
    neg_code = next((c for c in range(len(card)) if c != pos_code),
                    1 - pos_code)
    return pos_code, neg_code


def threshold_codes(p: np.ndarray, threshold: float, pos_code: int,
                    neg_code: int) -> np.ndarray:
    """The decision step itself: strictly-greater threshold compare."""
    return np.where(p > threshold, pos_code, neg_code)
