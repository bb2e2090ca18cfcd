"""The serve-and-learn window and the reward join table: port of
``avenir_tpu/online/plane.py``.

One served window is one dispatch of a three-stage
:class:`~avenir_tpu_torch.pipeline.compiler.ChunkPipeline` (ledger site
``online.window``) whose carries are the learner state, on the device:

* ``absorb``  — add this window's joined rewards into the per-arm
  statistics (:func:`..reinforce.online_forms.absorb_rewards`, in row
  order on every device);
* ``learn``   — one gradient step of the logistic weights on the
  rewarded rows (and of the MLP parameters when configured);
* ``predict`` — score the window's requests with the just-updated state:
  bandit arms (:func:`..reinforce.online_forms.bandit_scores`, a
  ``split`` of the carried key through the threefry twin), logistic
  probabilities, MLP classes.

The float32 arithmetic is the JAX package's compiled program's, so that
the state and the decisions are its bytes: the products ``X @ w`` are
XLA's left-to-right FMA sums (:func:`xla_row_dot`), the
sigmoid is ``1 / (1 + exp(-z))`` with XLA's ``exp``, and the gradient's
sum over the reward rows is XLA's order for the bucket
(:func:`xla_grad_sum`).  The MLP head's gradient is torch's autograd of
the same loss: XLA's ``tanh`` and ``log_softmax`` round otherwise, so
those weights agree to a tolerance.

Rewards join the decisions they reward on the host, by request id, in a
bounded :class:`PendingOutcomeTable` with TTL shedding; the device sees
only the joined, padded (arm, value, features) rows.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.mlp import forward_logits
from ..pipeline.compiler import ONLINE_SITE, ChunkPipeline, Stage
from ..reinforce.online_forms import absorb_plan, absorb_rewards, \
    bandit_scores
from ..utils import threefry as tf
from ..utils.xla_math import fma_f32, xla_exp_f32
from .state import OnlineLearnerConfig, init_state, state_from_bytes, \
    state_to_bytes

DEFAULT_WINDOW_BUCKETS = (8, 64, 256)

_STAGE_VERSION = "1"


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# ---- XLA's float32 order for the logistic step ---------------------------

def _fma_step(acc32, x64, r64):
    """One float32 FMA ``fma(x, r, acc)``: ``addcmul`` promotes ``acc`` to
    float64, where the product of two float32 values is exact, and the
    sum rounds once there and once more to float32 (a double rounding
    that differs from one needs the float64 sum exactly halfway between
    two float32 values)."""
    return torch.addcmul(acc32, x64, r64).float()


def _reduce8(v):
    """XLA's horizontal sum of 8 lanes: halves, then pairs, then the
    last two."""
    a = v[..., :4] + v[..., 4:]
    b = a[..., :2] + a[..., 2:]
    return b[..., 0] + b[..., 1]


def grad_block_order(R: int) -> Tuple[int, List[int]]:
    """(vectorised rows, order of their 8-row blocks) of XLA's CPU sum over
    ``R`` reward rows.  Up to 8 rows, and where the vectoriser keeps one
    vector iteration of ``IC`` 8-row blocks for the scalar tail, the rows
    add left to right.  Otherwise the vector loop's ``IC`` interleaved
    accumulators come out of LLVM's reassociation as one chain of FMAs
    over blocks: accumulator 0's blocks (0, IC, 2 IC, ...), then each
    later accumulator's second block, its first, and the rest.  Read from
    the compiled code for R = 64 (IC = 2) and 256 (IC = 4)."""
    if R <= 8:
        return 0, []
    ic = 2 if R < 128 else 4
    nvec = (R - ic * 8) // (ic * 8) * (ic * 8)
    if nvec <= 0:
        return 0, []
    per = nvec // (ic * 8)
    order = [k * ic for k in range(per)]
    for c in range(1, ic):
        chain = [c + k * ic for k in range(per)]
        order += chain[1:2] + chain[:1] + chain[2:]
    return nvec, order


def xla_grad_sum(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``X.T @ r`` (R, W) x (R,) -> (W,) in float32, summed over the rows
    in the order XLA's CPU backend compiles for R (:func:`grad_block_order`),
    every product fused into its add."""
    R, W = X.shape
    X64, r64 = X.double(), r.double()
    nvec, order = grad_block_order(R)
    if nvec:
        acc = torch.zeros((W, 8), dtype=torch.float32, device=X.device)
        Xb = X64[:nvec].reshape(-1, 8, W).transpose(1, 2).unbind(0)
        rb = r64[:nvec].reshape(-1, 1, 8).unbind(0)
        for b in order:
            acc = _fma_step(acc, Xb[b], rb[b])
        tot = _reduce8(acc)
    else:
        tot = torch.zeros(W, dtype=torch.float32, device=X.device)
    rows, vals = X64[nvec:].unbind(0), r64[nvec:].unbind(0)
    for x, v in zip(rows, vals):
        tot = _fma_step(tot, x, v)
    return tot


def xla_row_dot(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X @ w`` (N, W) x (W,) in float32 as XLA's CPU gemv computes it:
    each row left to right, ``acc = fma(X[:, j], w[j], acc)`` from 0."""
    acc = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for x, v in zip(X.double().unbind(1), w.double().unbind(0)):
        acc = _fma_step(acc, x, v)
    return acc


def xla_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA's CPU backend expands it: ``1 / (1 +
    exp(-z))`` with XLA's ``exp``."""
    one = torch.ones_like(z)
    return torch.div(one, xla_exp_f32(-z) + one)


def logistic_probs(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sigmoid(X @ w)``: the product as XLA's left-to-right FMA sum."""
    return xla_sigmoid(xla_row_dot(X, w))


class PendingOutcomeTable:
    """Bounded id -> (features, chosen arm) map awaiting rewards.

    ``put`` on a full table evicts the oldest entry (Evicted); ``join``
    pops the entry for a reward id (a miss is an orphan); ``shed`` drops
    entries older than the TTL (Shed).  All three outcomes are counted."""

    def __init__(self, capacity: int = 4096, ttl_s: float = 300.0,
                 clock=time.monotonic):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._entries: "OrderedDict[str, Tuple[np.ndarray, Any, float]]" \
            = OrderedDict()
        self.evicted = 0
        self.shed = 0
        self.orphans = 0
        self.joined = 0

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, rid: str, x: np.ndarray, decision: Any) -> None:
        if rid in self._entries:          # re-decision: newest wins
            self._entries.pop(rid)
        elif len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)
            self.evicted += 1
        self._entries[rid] = (x, decision, self._clock())

    def join(self, rid: str) -> Optional[Tuple[np.ndarray, Any]]:
        ent = self._entries.pop(rid, None)
        if ent is None:
            self.orphans += 1
            return None
        self.joined += 1
        return ent[0], ent[1]

    def shed_expired(self) -> int:
        """Drop entries past the TTL (insertion order == age order)."""
        if self.ttl_s <= 0:
            return 0
        cutoff = self._clock() - self.ttl_s
        n = 0
        while self._entries:
            rid, (_, _, t) = next(iter(self._entries.items()))
            if t > cutoff:
                break
            self._entries.popitem(last=False)
            n += 1
        self.shed += n
        return n

    def stats(self) -> Dict[str, int]:
        return {"pending": len(self._entries), "joined": self.joined,
                "orphans": self.orphans, "shed": self.shed,
                "evicted": self.evicted}


class OnlineWindowPlane:
    """Owns the window pipeline and the pending-outcome table.

    ``run_window(requests, rewards)`` is the whole hot path: join the
    rewards, pad both sides to shape buckets, one ``run_chunk`` dispatch,
    one stacked read-back, record the new decisions as pending.  Windows
    with the same (request bucket, reward bucket) pair reuse one set of
    staging buffers through the process-global ProgramCache.

    ``profile`` (off by default) synchronises the device around each part
    of a window and adds its seconds to ``timings`` (join, upload,
    device, read-back, and the service's parse through
    :meth:`note_parse`): the card's per-window breakdown."""

    def __init__(self, config: OnlineLearnerConfig, ctx=None,
                 cache=None, buckets: Sequence[int] = DEFAULT_WINDOW_BUCKETS,
                 pending_capacity: int = 4096, pending_ttl_s: float = 300.0,
                 clock=time.monotonic):
        self.config = config
        wanted = tuple(sorted(set(int(b) for b in buckets)))
        if not wanted or wanted[0] < 1:
            raise ValueError(f"bad window buckets {buckets!r}")
        self.pending = PendingOutcomeTable(pending_capacity,
                                           pending_ttl_s, clock=clock)
        self.windows = 0
        self._absorb_steps = 0
        if ctx is None:
            from ..parallel.mesh import runtime_context
            ctx = runtime_context()
        self.device = ctx.mesh.devices[0]
        self._pipeline = ChunkPipeline(
            self._build_stages(), ctx=ctx,
            schema_fp=config.fingerprint(), cache=cache,
            name="online-window", site=ONLINE_SITE)
        # every bucket rounds up to a multiple of the context's device
        # count, as the JAX package pads rows to its mesh
        nd = max(int(self._pipeline.ctx.mesh.size), 1)
        self.buckets = tuple(sorted(set(
            ((b + nd - 1) // nd) * nd for b in wanted)))
        self.profile = False
        self.timings = {"parse_s": 0.0, "join_s": 0.0, "upload_s": 0.0,
                        "device_s": 0.0, "readback_s": 0.0}

    # ---- stage kernels -------------------------------------------------
    def _build_stages(self) -> List[Stage]:
        cfg = self.config
        bandit0, weights0, rng0 = init_state(cfg, self.device)

        def absorb_kernel(carry, consts, inputs, upstream):
            counts, totals, total_sqs = absorb_rewards(
                carry["counts"], carry["totals"], carry["total_sqs"],
                inputs["r_arm"], inputs["r_val"], inputs["r_mask"],
                inputs["r_rank"], self._absorb_steps)
            nc = {"counts": counts, "totals": totals,
                  "total_sqs": total_sqs}
            return nc, dict(nc)

        def learn_kernel(carry, consts, inputs, upstream):
            X, vals, m = inputs["r_x"], inputs["r_val"], inputs["r_mask"]
            n = m.sum()
            any_rows = n > 0
            # logistic: outcome >= threshold is the positive class; the
            # offline trainer's partial sums (x * (y - p) over the rows)
            # and combine, in XLA's float32 order
            y = torch.where(vals >= cfg.threshold, m, torch.zeros_like(m))
            grad_sum = xla_grad_sum(X, y - logistic_probs(X, carry["w"]))
            w_new = _combine(carry["w"], grad_sum, torch.clamp(n, min=1.0))
            nc = {"w": torch.where(any_rows, w_new, carry["w"])}
            outs = {"w": nc["w"]}
            if "mlp" in carry:
                nc["mlp"] = _mlp_step(carry["mlp"], X[:, 1:], vals, m,
                                      any_rows)
                outs["mlp"] = nc["mlp"]
            return nc, outs

        def _combine(w, grad_sum, n):
            # LogisticTrainer._combine_impl with this config's
            # hyper-parameters; XLA fuses grad_sum - l2 * w into an FMA
            grad = fma_f32(w, -cfg.l2, grad_sum)
            return w + grad * cfg.learning_rate / n

        def _mlp_step(params, Xf, vals, m, any_rows):
            y_cls = torch.clamp(vals.to(torch.int32), 0,
                                cfg.mlp_classes - 1).long()
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            with torch.enable_grad():
                logp = torch.log_softmax(forward_logits(p, Xf), dim=-1)
                ce = -(logp.gather(1, y_cls[:, None])[:, 0] * m).sum()
                reg = 0.5 * cfg.l2 * ((p["W1"] ** 2).sum()
                                      + (p["W2"] ** 2).sum())
                names = sorted(p)
                grads = torch.autograd.grad(ce + reg,
                                            [p[k] for k in names])
            return {k: torch.where(any_rows,
                                   params[k] - cfg.learning_rate * g,
                                   params[k])
                    for k, g in zip(names, grads)}

        def predict_kernel(carry, consts, inputs, upstream):
            X = inputs["x"]
            keys = tf.split(carry["key"], 2)
            key, sub = keys[0], keys[1]
            scores = bandit_scores(
                cfg.algorithm, upstream["absorb.counts"],
                upstream["absorb.totals"], upstream["absorb.total_sqs"],
                sub, X.shape[0], cfg.temp_constant)
            outs: Dict[str, Any] = {
                "arm": torch.argmax(scores, dim=1).to(torch.int32),
                "prob": logistic_probs(X, upstream["learn.w"]),
            }
            if "learn.mlp" in upstream:
                logits = forward_logits(upstream["learn.mlp"], X[:, 1:])
                outs["cls"] = torch.argmax(logits, dim=1).to(torch.int32)
            nc = {"key": key, "step": carry["step"] + 1}
            return nc, outs

        returns = ("arm", "prob") + (("cls",)
                                     if "mlp" in weights0 else ())
        return [
            Stage(name="absorb", kernel=absorb_kernel,
                  carry_init=lambda: bandit0, version=_STAGE_VERSION),
            Stage(name="learn", kernel=learn_kernel,
                  carry_init=lambda: weights0, version=_STAGE_VERSION),
            Stage(name="predict", kernel=predict_kernel,
                  carry_init=lambda: rng0, version=_STAGE_VERSION,
                  returns=returns),
        ]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the window ----------------------------------------------------
    def run_window(self, requests: Sequence[Tuple[str, np.ndarray]],
                   rewards: Sequence[Tuple[str, float]]
                   ) -> Tuple[List[Tuple[str, int, float, int]],
                              List[Tuple[Tuple[int, float, int], float]]]:
        """One dispatch over a served window.

        ``requests``: (request id, feature row) pairs, ``n_features``
        wide.  ``rewards``: (request id, outcome value) pairs, joined
        against the pending table; unknown ids count as orphans.

        Returns ``(decisions, outcomes)``: one ``(rid, arm, prob, cls)``
        decision per request (cls -1 without an MLP head), recorded as
        pending; and one ``(decision, value)`` per joined reward."""
        cfg = self.config
        W = cfg.design_width
        t0 = time.perf_counter()
        joined: List[Tuple[int, float, np.ndarray]] = []
        outcomes: List[Tuple[Tuple[int, float, int], float]] = []
        for rid, val in rewards:
            ent = self.pending.join(rid)
            if ent is not None:
                joined.append((ent[1][0], float(val), ent[0]))
                outcomes.append((ent[1], float(val)))
        self.pending.shed_expired()

        B = _bucket(max(len(requests), 1), self.buckets)
        R = _bucket(max(len(joined), 1), self.buckets)
        x = np.zeros((B, W), np.float32)
        for i, (_, row) in enumerate(requests):
            x[i, 0] = 1.0
            if cfg.n_features:
                x[i, 1:] = row
        r_x = np.zeros((R, W), np.float32)
        r_arm = np.zeros(R, np.int32)
        r_val = np.zeros(R, np.float32)
        r_mask = np.zeros(R, np.float32)
        for i, (arm, val, row) in enumerate(joined):
            r_x[i] = row
            r_arm[i] = arm
            r_val[i] = val
            r_mask[i] = 1.0
        r_rank, self._absorb_steps = absorb_plan(r_arm, r_mask, cfg.n_arms)
        t1 = time.perf_counter()
        with self._pipeline.staged({
                "x": x, "r_x": r_x, "r_arm": r_arm, "r_val": r_val,
                "r_mask": r_mask, "r_rank": r_rank}) as inputs:
            if self.profile:
                self._sync()
            t2 = time.perf_counter()
            rets = self._pipeline.run_chunk(inputs)
            cols = [rets["predict.arm"].double(),
                    rets["predict.prob"].double()]
            if "predict.cls" in rets:
                cols.append(rets["predict.cls"].double())
            stacked = torch.stack(cols, 1)
            if self.profile:
                self._sync()
            t3 = time.perf_counter()
        host = stacked.cpu().numpy()
        t4 = time.perf_counter()
        if self.profile:
            tm = self.timings
            tm["join_s"] += t1 - t0
            tm["upload_s"] += t2 - t1
            tm["device_s"] += t3 - t2
            tm["readback_s"] += t4 - t3
        self.windows += 1
        has_cls = host.shape[1] > 2
        out = []
        for i, (rid, row) in enumerate(requests):
            decision = (int(host[i, 0]), float(np.float32(host[i, 1])),
                        int(host[i, 2]) if has_cls else -1)
            # the decision row joins its future reward: store the DESIGN
            # row (intercept set) so the learn stage gets it
            self.pending.put(rid, x[i].copy(), decision)
            out.append((rid,) + decision)
        return out, outcomes

    def note_parse(self, seconds: float) -> None:
        """A window's parse seconds, measured by the service that parsed
        it, into ``timings`` (with ``profile`` on)."""
        if self.profile:
            self.timings["parse_s"] += seconds

    # ---- state access (supervisor hooks) -------------------------------
    @property
    def carries(self):
        return self._pipeline.carries

    def state_bytes(self) -> bytes:
        return state_to_bytes(self._pipeline.carries)

    def restore(self, payload: bytes) -> None:
        template = tuple(init_state(self.config, self.device))
        self._pipeline.install_carries(
            state_from_bytes(payload, template))

    def logistic_w(self) -> np.ndarray:
        """The logistic coefficient vector as a host array — the registry
        snapshot's model payload."""
        return self._pipeline.carries[1]["w"].cpu().numpy() \
            .astype(np.float32)

    def run_stats(self) -> Dict[str, int]:
        s = self._pipeline.run_stats()
        s["windows"] = self.windows
        s.update(self.pending.stats())
        return s

    def export(self, counters, group: str = "OnlineProgramCache") -> None:
        self._pipeline.export(counters, group=group)
