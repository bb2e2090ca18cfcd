"""Sequential Minimal Optimization (Platt) SVM trainer + batched predictor:
the port of ``avenir_tpu/discriminant/smo.py``.

Reference: discriminant/SequentialMinimalOptimization.java — full in-memory
SMO with linear kernel: the outer loop alternates examine-all /
examine-non-bound sweeps (:76-110), ``examine`` applies Platt's second-choice
heuristic then falls back to random sweeps over support vectors and the full
set (:115-160), ``step`` is the standard two-Lagrangian analytic update with
L/H clipping and threshold update.  discriminant/SupportVectorMachine.java
wraps it: each mapper trains on its partition and emits the support vectors
(:70-85).

The serial Platt trainer (the job's default ``svm.solver=serial``) is the
JAX package's host float64 numpy, copied with its
``np.random.default_rng(seed)`` draws, so its models are byte for byte
the JAX package's.  Prediction is ``X @ w - b`` in float32 on the device,
an FMA chain over the features as XLA's CPU dot computes it.  The
lock-step batched solver (``svm.solver=batched``) is a torch loop on the
device over the stacked groups in float32; every reduction in it runs in
a fixed order (the feature sums left to right, ``argmin``/``argmax`` to
the first index), so the card and the CPU train the same model.  Against
the JAX package's batched solver (a different trainer already, in XLA's
float32 order) its weights and thresholds are held to a tolerance and
its predictions to equality.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch, note_h2d

KERNEL_LINEAR = "linear"


@dataclass
class SMOParams:
    penalty_factor: float = 0.05      # C (svm.pnalty.factor default :62)
    tolerance: float = 1e-3
    eps: float = 1e-3
    kernel_type: str = KERNEL_LINEAR
    max_sweeps: int = 200             # safety bound on outer sweeps
    seed: int = 0


@dataclass
class SVMModel:
    weights: np.ndarray               # (d,) for linear kernel
    threshold: float                  # b in f(x) = w.x - b
    sup_vec_idx: np.ndarray           # indices of alpha>0 rows
    alphas: np.ndarray                # (n,)
    X: np.ndarray
    y: np.ndarray

    def support_vector_lines(self, delim: str = ",") -> List[str]:
        """Reference output: support vector rows = features..., target, alpha
        (SupportVectorMachine.java:76-85 emits data rows incl. lagrangian)."""
        lines = []
        for i in self.sup_vec_idx:
            vals = [f"{v:.6f}" for v in self.X[i]] + \
                [f"{self.y[i]:.0f}", f"{self.alphas[i]:.6f}"]
            lines.append(delim.join(vals))
        return lines


class SMOTrainer:
    def __init__(self, params: SMOParams):
        if params.kernel_type != KERNEL_LINEAR:
            raise ValueError(f"invalid kernel type {params.kernel_type!r} "
                             "(reference supports linear only, "
                             "SequentialMinimalOptimization.java:33-38)")
        self.p = params

    def train(self, X: np.ndarray, y: np.ndarray) -> SVMModel:
        """X (n,d) float, y (n,) in {-1,+1}."""
        p = self.p
        rng = np.random.default_rng(p.seed)
        n, d = X.shape
        self.X, self.y = X.astype(np.float64), y.astype(np.float64)
        self.alpha = np.zeros(n)
        self.b = 0.0
        self.w = np.zeros(d)
        # error cache: E_i = f(x_i) - y_i, refreshed vectorized
        self.E = -self.y.copy()
        C = p.penalty_factor

        num_changed, examine_all, sweeps = 0, True, 0
        while (num_changed > 0 or examine_all) and sweeps < p.max_sweeps:
            num_changed = 0
            if examine_all:
                for i2 in range(n):
                    num_changed += self._examine(i2, rng)
            else:
                for i2 in np.where((self.alpha > 0) & (self.alpha < C))[0]:
                    num_changed += self._examine(int(i2), rng)
            if examine_all:
                examine_all = False
            elif num_changed == 0:
                examine_all = True
            sweeps += 1

        sup = np.where(self.alpha > 1e-12)[0]
        return SVMModel(weights=self.w.copy(), threshold=self.b,
                        sup_vec_idx=sup, alphas=self.alpha.copy(),
                        X=self.X, y=self.y)

    # ---- Platt examine with second-choice heuristic + random fallbacks ----
    def _examine(self, i2: int, rng) -> int:
        p, C = self.p, self.p.penalty_factor
        y2, alph2, E2 = self.y[i2], self.alpha[i2], self.E[i2]
        r2 = E2 * y2
        if (r2 < -p.tolerance and alph2 < C) or (r2 > p.tolerance and alph2 > 0):
            nonbound = np.where((self.alpha > 0) & (self.alpha < C))[0]
            if len(nonbound) > 1:
                # second choice: maximize |E1 - E2|
                i1 = int(nonbound[np.argmax(np.abs(self.E[nonbound] - E2))])
                if self._step(i1, i2):
                    return 1
            # random sweep over non-bound, then over all
            for pool in (nonbound, np.arange(len(self.y))):
                if len(pool) == 0:
                    continue
                start = rng.integers(len(pool))
                for k in range(len(pool)):
                    i1 = int(pool[(start + k) % len(pool)])
                    if self._step(i1, i2):
                        return 1
        return 0

    def _step(self, i1: int, i2: int) -> bool:
        if i1 == i2:
            return False
        C, eps = self.p.penalty_factor, self.p.eps
        y1, y2 = self.y[i1], self.y[i2]
        alph1, alph2 = self.alpha[i1], self.alpha[i2]
        E1, E2 = self.E[i1], self.E[i2]
        s = y1 * y2
        if s > 0:
            L, H = max(0.0, alph1 + alph2 - C), min(C, alph1 + alph2)
        else:
            L, H = max(0.0, alph2 - alph1), min(C, C + alph2 - alph1)
        if L >= H:
            return False
        x1, x2 = self.X[i1], self.X[i2]
        k11, k12, k22 = x1 @ x1, x1 @ x2, x2 @ x2
        eta = k11 + k22 - 2.0 * k12
        if eta > 0:
            a2 = alph2 + y2 * (E1 - E2) / eta
            a2 = min(max(a2, L), H)
        else:
            # objective at both clip ends (Platt's degenerate-eta branch)
            f1 = y1 * (E1 + self.b) - alph1 * k11 - s * alph2 * k12
            f2 = y2 * (E2 + self.b) - s * alph1 * k12 - alph2 * k22
            L1 = alph1 + s * (alph2 - L)
            H1 = alph1 + s * (alph2 - H)
            Lobj = L1 * f1 + L * f2 + 0.5 * L1 * L1 * k11 + \
                0.5 * L * L * k22 + s * L * L1 * k12
            Hobj = H1 * f1 + H * f2 + 0.5 * H1 * H1 * k11 + \
                0.5 * H * H * k22 + s * H * H1 * k12
            if Lobj < Hobj - eps:
                a2 = L
            elif Lobj > Hobj + eps:
                a2 = H
            else:
                return False
        if abs(a2 - alph2) < eps * (a2 + alph2 + eps):
            return False
        a1 = alph1 + s * (alph2 - a2)
        # threshold update
        b1 = E1 + y1 * (a1 - alph1) * k11 + y2 * (a2 - alph2) * k12 + self.b
        b2 = E2 + y1 * (a1 - alph1) * k12 + y2 * (a2 - alph2) * k22 + self.b
        if 0 < a1 < C:
            b_new = b1
        elif 0 < a2 < C:
            b_new = b2
        else:
            b_new = 0.5 * (b1 + b2)
        # vectorized error-cache + weight refresh (the O(n d) inner product)
        dw = y1 * (a1 - alph1) * x1 + y2 * (a2 - alph2) * x2
        self.w += dw
        self.E += self.X @ dw - (b_new - self.b)
        self.b = b_new
        self.alpha[i1], self.alpha[i2] = a1, a2
        self.E[i1] = self.decision_one(i1) - self.y[i1]
        self.E[i2] = self.decision_one(i2) - self.y[i2]
        return True

    def decision_one(self, i: int) -> float:
        return self.X[i] @ self.w - self.b


# ---------------------------------------------------------------------------
# batched device prediction
# ---------------------------------------------------------------------------

def _fma_rows(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``X @ w`` over the last axis as an FMA chain from 0 in
    feature order, one rounding a step (:func:`ops.distance.fma_f32`)."""
    from ..ops.distance import fma_f32
    acc = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    for j in range(X.shape[-1]):
        acc = fma_f32(X[..., j], w[..., j], acc)
    return acc


def decision_function(model: SVMModel, X: np.ndarray,
                      device=None) -> np.ndarray:
    dev = resolve_device(device)
    Xf = np.ascontiguousarray(X, np.float32)
    note_h2d(Xf.nbytes)
    Xd = torch.from_numpy(Xf).to(dev)
    w = torch.from_numpy(np.asarray(model.weights, np.float32)).to(dev)
    b = torch.tensor(np.float32(model.threshold), device=dev)
    note_dispatch()
    return fetch(_fma_rows(Xd, w) - b)


def predict(model: SVMModel, X: np.ndarray, device=None) -> np.ndarray:
    """±1 labels."""
    return np.where(decision_function(model, X, device) >= 0, 1.0, -1.0)


def _train_one(params: SMOParams, X: np.ndarray, y: np.ndarray) -> SVMModel:
    return SMOTrainer(params).train(X, y)


# ---------------------------------------------------------------------------
# device-batched group training (lock-step maximal-violating-pair SMO)
# ---------------------------------------------------------------------------

# membership margin: an alpha within MARGIN of a bound counts as AT the
# bound for pivot-set membership (the JAX package's, with its reasons)
MARGIN = 1e-6
# lock-step iterations between the host's all-groups-done checks
SYNC_EVERY = 64


def _row_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (a fixed order on every
    device)."""
    acc = a[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def _dot_rows(Xt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, n) ``Σ_d X[g, n, d] w[g, d]`` of the feature-major ``Xt``
    (d, G, n), products rounded one by one and added left to right."""
    acc = Xt[0] * w[:, 0, None]
    for j in range(1, Xt.shape[0]):
        acc = acc + Xt[j] * w[:, j, None]
    return acc


class _BatchedSMO:
    """The lock-step maximal-violating-pair solver (the JAX package's
    ``_batched_smo_kernel``) as a torch loop on the stacked groups' device.

    Pivot selection is Keerthi's deterministic maximal-violating-pair rule
    (i_up = argmin F over I_up, i_low = argmax F over I_low, stop when
    b_low - b_up <= 2 tol); the two-Lagrangian analytic step (incl. the
    degenerate-eta objective comparison) matches SMOTrainer._step.
    Converged / stalled groups freeze via masks; the loop ends when every
    group is done or at the iteration cap.  F_i = w.x_i - y_i (threshold-
    free gradient form); the final b is (b_up + b_low) / 2.  The host
    checks for the end every ``SYNC_EVERY`` steps (on a GPU one CUDA
    graph replay of them); a step after every group is done changes
    nothing, and the iteration count stops with the JAX package's."""

    def __init__(self, C: float, tol: float, eps: float, max_iter: int):
        self.C, self.tol, self.eps, self.max_iter = C, tol, eps, max_iter

    def _sets(self, alpha, k):
        """The pivot sets I_up and I_low of the current alphas."""
        a_lt, a_gt = alpha < k["hi"], alpha > k["lo"]
        up = (a_lt & k["pos"]) | (a_gt & k["neg"])
        low = (a_lt & k["neg"]) | (a_gt & k["pos"])
        return up, low

    def _step(self, st, X, y, k):
        alpha, w, F, done, b_lo_hi, it = st
        C, zero, inf, g = k["C"], k["zero"], k["inf"], k["g"]
        up, low = self._sets(alpha, k)
        # a non-member's F pushed past every real one by adding
        # (not masking: masked_fill is slow on the CPU) a huge penalty; an
        # empty set's bound is then +-inf, as a masked min's
        big = k["big"]
        b_up, i1 = (F + (~up).to(F.dtype) * big).min(dim=1)
        b_low, i2 = (F - (~low).to(F.dtype) * big).max(dim=1)
        b_up = torch.where(b_up >= k["half_big"], inf, b_up)
        b_low = torch.where(b_low <= -k["half_big"], -inf, b_low)
        newly_done = (b_low - b_up) <= k["two_tol"]
        it = it + (~done.all()).to(torch.int64)
        active = ~done & ~newly_done
        x1, x2 = X[g, i1], X[g, i2]
        y1, y2 = y[g, i1], y[g, i2]
        a1o, a2o = alpha[g, i1], alpha[g, i2]
        F1, F2 = F[g, i1], F[g, i2]
        s = y1 * y2
        L = torch.where(s > 0, torch.maximum(zero, a1o + a2o - C),
                        torch.maximum(zero, a2o - a1o))
        H = torch.where(s > 0, torch.minimum(C, a1o + a2o),
                        torch.minimum(C, C + a2o - a1o))
        k11 = _row_sum(x1 * x1)
        k12 = _row_sum(x1 * x2)
        k22 = _row_sum(x2 * x2)
        eta = k11 + k22 - k["two"] * k12
        a2_eta = torch.minimum(torch.maximum(
            a2o + y2 * (F1 - F2) / torch.maximum(eta, k["tiny"]), L), H)
        f1 = y1 * F1 - a1o * k11 - s * a2o * k12
        f2 = y2 * F2 - s * a1o * k12 - a2o * k22
        L1 = a1o + s * (a2o - L)
        H1 = a1o + s * (a2o - H)
        half = k["half"]
        Lobj = (L1 * f1 + L * f2 + half * L1 * L1 * k11
                + half * L * L * k22 + s * L * L1 * k12)
        Hobj = (H1 * f1 + H * f2 + half * H1 * H1 * k11
                + half * H * H * k22 + s * H * H1 * k12)
        eps = k["eps"]
        a2_deg = torch.where(Lobj < Hobj - eps, L,
                             torch.where(Lobj > Hobj + eps, H, a2o))
        a2n = torch.where(eta > 0, a2_eta, a2_deg)
        a1n = a1o + s * (a2o - a2n)
        progress = (H > L) & (a2n != a2o)
        change = active & progress
        c1 = torch.where(change, y1 * (a1n - a1o), zero)
        c2 = torch.where(change, y2 * (a2n - a2o), zero)
        w = w + (c1[:, None] * x1 + c2[:, None] * x2)
        F = _dot_rows(k["Xt"], w) - y
        # the second write reads the first's result (i1 == i2 is possible)
        alpha[g, i1] = torch.where(change, a1n, a1o)
        alpha[g, i2] = torch.where(change, a2n, alpha[g, i2])
        done = done | newly_done | (active & ~progress)
        b_lo_hi = torch.where(done[:, None] & (b_lo_hi[:, 0:1] == inf),
                              torch.stack([b_up, b_low], dim=1), b_lo_hi)
        return alpha, w, F, done, b_lo_hi, it

    def _capture(self, st, X, y, k):
        """On a GPU, ``SYNC_EVERY`` steps captured as one CUDA graph over
        static state buffers (a replay launches the same kernels as the
        eager steps, without their host launch cost).  Returns (graph,
        the static state it replays over)."""
        self._static = [t.clone() for t in st]

        def body():
            cur = tuple(self._static)
            for _ in range(SYNC_EVERY):
                cur = self._step(cur, X, y, k)
            for dst, src in zip(self._static, cur):
                if dst is not src:
                    dst.copy_(src)
        # warm up on a copy of the state, on a side stream, as capture wants
        keep = [t.clone() for t in self._static]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        for dst, src in zip(self._static, keep):
            dst.copy_(src)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        return graph, tuple(self._static)

    def run(self, X: torch.Tensor, y: torch.Tensor, valid: torch.Tensor):
        G, n, d = X.shape
        dev = X.device
        f32 = lambda v: torch.tensor(np.float32(v), device=dev)  # noqa: E731
        k = {"C": f32(self.C), "two_tol": f32(2.0 * self.tol),
             "eps": f32(self.eps), "tiny": f32(1e-30), "zero": f32(0.0),
             "two": f32(2.0), "half": f32(0.5), "inf": f32(np.inf),
             "hi": f32(self.C - MARGIN), "lo": f32(MARGIN),
             "big": f32(3e38), "half_big": f32(1e38),
             "pos": valid & (y > 0), "neg": valid & (y < 0),
             "g": torch.arange(G, device=dev),
             "Xt": X.permute(2, 0, 1).contiguous()}
        st = (torch.zeros((G, n), dtype=torch.float32, device=dev),
              torch.zeros((G, d), dtype=torch.float32, device=dev),
              -y, torch.zeros((G,), dtype=torch.bool, device=dev),
              torch.full((G, 2), float("inf"), dtype=torch.float32,
                         device=dev),
              torch.zeros((), dtype=torch.int64, device=dev))
        steps = 0
        graph = None
        if dev.type == "cuda":
            graph, st = self._capture(st, X, y, k)
        while steps < self.max_iter:
            todo = min(SYNC_EVERY, self.max_iter - steps)
            if graph is not None and todo == SYNC_EVERY:
                graph.replay()
            else:
                for _ in range(todo):
                    st = self._step(st, X, y, k)
                if graph is not None:    # back into the graph's buffers
                    for dst, src in zip(self._static, st):
                        if dst is not src:
                            dst.copy_(src)
                    st = tuple(self._static)
            steps += todo
            note_dispatch()
            if bool(st[3].all()):
                break
        alpha, w, F, done, b_lo_hi, it = st
        up, low = self._sets(alpha, k)
        inf = k["inf"]
        b_up = F.masked_fill(~up, np.inf).min(dim=1).values
        b_low = F.masked_fill(~low, -np.inf).max(dim=1).values
        b_lo_hi = torch.where(b_lo_hi[:, 0:1] == inf,
                              torch.stack([b_up, b_low], dim=1), b_lo_hi)
        b = k["half"] * (b_lo_hi[:, 0] + b_lo_hi[:, 1])
        b = torch.where(torch.isfinite(b), b, k["zero"])
        return alpha, w, b, it


def train_groups_batched(groups: Dict[str, Tuple[np.ndarray, np.ndarray]],
                         params: SMOParams,
                         stats: Optional[dict] = None,
                         device=None) -> Dict[str, SVMModel]:
    """All groups stacked and trained lock-step in one device loop — the
    device answer to the reference's per-mapper SMO partitions
    (SupportVectorMachine.java:70-85).  Groups pad to the widest row count
    (padded rows masked out of pivot selection), so per-iteration work is
    a handful of (G, n[, d]) element-wise/reduction ops instead of G
    sequential python loops.

    The pivot heuristic is deterministic maximal-violating-pair, NOT
    Platt's randomized fallback sweeps: both optimize the same dual, so
    weights/threshold agree with SMOTrainer to optimization tolerance and
    predictions match, but alpha SETS (and support-vector output lines)
    can differ on degenerate margins — a different trainer, which is why
    train_groups only selects it by explicit request."""
    if params.kernel_type != KERNEL_LINEAR:
        raise ValueError("batched SMO supports the linear kernel only")
    items = list(groups.items())
    if not items:
        return {}
    d = items[0][1][0].shape[1]
    if any(X.shape[1] != d for _, (X, y) in items):
        raise ValueError("batched SMO needs a common feature width")
    dev = resolve_device(device)
    G = len(items)
    n_max = max(X.shape[0] for _, (X, _) in items)
    Xb = np.zeros((G, n_max, d), np.float32)
    yb = np.ones((G, n_max), np.float32)   # pad labels +1, masked anyway
    valid = np.zeros((G, n_max), bool)
    for gi, (_, (X, y)) in enumerate(items):
        n = X.shape[0]
        Xb[gi, :n] = X
        yb[gi, :n] = y
        valid[gi, :n] = True
    note_h2d(Xb.nbytes + yb.nbytes + valid.nbytes, transfers=3)
    solver = _BatchedSMO(params.penalty_factor, params.tolerance,
                         params.eps, max_iter=params.max_sweeps * n_max)
    alpha, w, b, it = (fetch(v) for v in solver.run(
        *(torch.from_numpy(a).to(dev) for a in (Xb, yb, valid))))
    if stats is not None:
        stats["iterations"] = int(it)
    out = {}
    for gi, (g, (X, y)) in enumerate(items):
        n = X.shape[0]
        a = alpha[gi, :n].astype(np.float64)
        out[g] = SVMModel(weights=w[gi].astype(np.float64),
                          threshold=float(b[gi]),
                          sup_vec_idx=np.where(a > 1e-12)[0],
                          alphas=a, X=X.astype(np.float64),
                          y=y.astype(np.float64))
    return out


def train_groups_sharded(groups: Dict[str, Tuple[np.ndarray, np.ndarray]],
                         params: SMOParams,
                         reducer,
                         stats: Optional[dict] = None,
                         device=None) -> Dict[str, SVMModel]:
    """Multi-host data-parallel group training: shard the GROUP axis
    across processes by the same ``shard_rows`` split the streaming
    ingest uses, train each shard's groups with the lock-step batched
    kernel locally, then ONE collective (``reducer.allgather`` of the
    stacked per-group (weights, threshold, alphas)) hands every process
    the identical full model dict.

    The group axis — the reference's per-mapper SVM partitions
    (SupportVectorMachine.java:70-85) — is the right parallel axis here,
    NOT the row axis: per-group row counts are small by construction
    (each mapper's partition), so a row-parallel SMO would pay a
    cross-host collective per pivot iteration for microseconds of local
    compute — the exact inversion of the one-collective-per-step rule the
    tree/KNN shards follow.  Sharding whole groups keeps every iteration
    local and the single result merge is the only wire traffic.

    Every process must pass the SAME ``groups`` dict (same keys, same
    order — the gather/partition job modes guarantee a global input
    view); results are bit-identical across processes and to an unsharded
    ``train_groups_batched`` run (each group's training sees exactly the
    same lock-step solver on the same rows)."""
    items = list(groups.items())
    spec = reducer.spec
    from ..parallel.distributed import shard_rows as _split_rows
    lo, hi = _split_rows(len(items), spec.index, spec.count)
    local = dict(items[lo:hi])
    trained = train_groups_batched(local, params, stats=stats,
                                   device=device) if local else {}
    payload = {g: (m.weights, m.threshold, m.alphas)
               for g, m in trained.items()}
    merged: Dict[str, SVMModel] = {}
    for part in reducer.allgather(payload):
        for g, (w, b, a) in part.items():
            X, y = groups[g]
            merged[g] = SVMModel(
                weights=np.asarray(w), threshold=float(b),
                sup_vec_idx=np.where(np.asarray(a) > 1e-12)[0],
                alphas=np.asarray(a), X=X.astype(np.float64),
                y=y.astype(np.float64))
    return {g: merged[g] for g, _ in items}


def train_groups(groups: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 params: SMOParams,
                 workers: int = 0,
                 batched: bool = False,
                 device=None) -> Dict[str, SVMModel]:
    """Per-group SVMs — the reference's per-mapper partitions
    (SupportVectorMachine.java:70-85), whose parallelism is PROCESS-level:
    Platt's heuristics make each group's loop inherently sequential (the
    second-choice pick and random fallbacks depend on the evolving error
    cache), so the scaling axis is many groups at once, not a vectorized
    step.

    ``workers`` > 1 trains groups in a spawn-mode process pool (no fork
    after CUDA has started: the workers are fresh interpreters); groups are
    independent and per-group seeding is unchanged, so results are
    bit-identical to the serial loop in any worker count.  0 = auto stays
    SERIAL (each worker pays an interpreter start); pass ``workers``
    explicitly when per-group work dwarfs that.

    ``batched=True`` routes to :func:`train_groups_batched` — ONE jitted
    lock-step program over all stacked groups (the r4-verdict device
    formulation).  Explicit opt-in because its deterministic pivot rule is
    a different (equivalent-optimum) trainer whose support-vector lines
    are not byte-identical to Platt serial."""
    if batched:
        return train_groups_batched(groups, params, device=device)
    items = list(groups.items())
    if workers == 0:
        workers = 1
    if workers <= 1:
        return {g: _train_one(params, X, y) for g, (X, y) in items}
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn")) as ex:
        futs = {g: ex.submit(_train_one, params, X, y)
                for g, (X, y) in items}
        return {g: f.result() for g, f in futs.items()}
