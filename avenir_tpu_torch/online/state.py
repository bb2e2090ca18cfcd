"""The learner's state and its byte round trip: port of
``avenir_tpu/online/state.py``.

The state is the carry tuple of the window pipeline, one nest a stage:
``bandit`` (per-arm count / reward sum / reward sum-sq), ``weights`` (the
logistic coefficients, intercept first, and the MLP parameters when an
MLP head is configured) and ``rng`` (the threaded key and the window
step).

The byte format is the JAX package's, so that a snapshot either package
wrote restores in the other: ``_MAGIC``, a little-endian u32 header
length, a JSON header naming each leaf (``path``, ``dtype``, ``shape``;
leaves in the order and with the paths ``jax.tree_util.
tree_flatten_with_path`` gives the tuple — dict keys sorted), then the
raw payloads in header order.  The key is written as JAX holds it,
``uint32 (2,)``; the port's twin keeps it as int64 words.  The step is a
0-dim int32.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_MAGIC = b"AVONL1\n"


@dataclass(frozen=True)
class OnlineLearnerConfig:
    """Shape of the online learner: which heads exist and their sizes."""

    actions: Tuple[str, ...]              # bandit arm names (>= 1)
    n_features: int = 0                   # numeric features per request
    algorithm: str = "ucb1"               # ucb1 | softMax | sampsonSampler
    head: str = "bandit"                  # bandit | logistic | mlp
    temp_constant: float = 0.1            # softMax temperature
    learning_rate: float = 0.05
    l2: float = 0.0
    mlp_hidden: int = 0                   # > 0 adds the MLP head
    mlp_classes: int = 2
    pos_label: str = "1"                  # logistic head reply labels
    neg_label: str = "0"
    threshold: float = 0.5
    seed: int = 42
    labels: Tuple[str, ...] = ()          # mlp head reply labels

    def __post_init__(self):
        from ..reinforce.online_forms import ONLINE_ALGORITHMS
        if not self.actions:
            raise ValueError("OnlineLearnerConfig needs >= 1 action")
        if self.algorithm not in ONLINE_ALGORITHMS:
            raise ValueError(
                f"algorithm {self.algorithm!r} has no device form; "
                f"known: {ONLINE_ALGORITHMS}")
        if self.head not in ("bandit", "logistic", "mlp"):
            raise ValueError(f"unknown head {self.head!r}")
        if self.head == "mlp" and self.mlp_hidden <= 0:
            raise ValueError("head='mlp' needs mlp_hidden > 0")
        if self.mlp_hidden > 0 and self.n_features <= 0:
            raise ValueError("an MLP head needs n_features > 0")

    @property
    def n_arms(self) -> int:
        return len(self.actions)

    @property
    def design_width(self) -> int:
        """Logistic design-matrix width: intercept + features."""
        return self.n_features + 1

    def fingerprint(self) -> str:
        return (f"online:{self.algorithm}:{self.head}:{self.n_arms}"
                f":{self.n_features}:{self.mlp_hidden}"
                f":{self.mlp_classes}")

    def mlp_label(self, idx: int) -> str:
        if self.labels and idx < len(self.labels):
            return self.labels[idx]
        return str(idx)


def init_state(config: OnlineLearnerConfig,
               device="cpu") -> Tuple[Any, Any, Any]:
    """Fresh carry tuple (bandit, weights, rng) as host arrays; the MLP's
    initial parameters are the JAX package's draws (the twin's
    ``normal``, drawn on ``device``)."""
    from ..reinforce.online_forms import init_arm_stats
    bandit = init_arm_stats(config.n_arms)
    weights: Dict[str, Any] = {
        "w": np.zeros(config.design_width, np.float32)}
    if config.mlp_hidden > 0:
        from ..nn.mlp import MLPConfig, init_params
        mcfg = MLPConfig(hidden_dim=config.mlp_hidden,
                         n_classes=config.mlp_classes, seed=config.seed)
        params = init_params(config.n_features, mcfg, device=device)
        weights["mlp"] = {k: v.cpu().numpy().astype(np.float32)
                          for k, v in params.items()}
    rng = {"key": np.asarray([0, config.seed & 0xFFFFFFFF], np.uint32),
           "step": np.int32(0)}
    return bandit, weights, rng


# ---- deterministic byte round trip ------------------------------------

def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        a = leaf.detach().cpu().numpy()
    else:
        a = np.asarray(leaf)
    if a.dtype == np.int64:          # a twin key: JAX's uint32 words
        a = a.astype(np.uint32)
    return a


def _flatten(tree, path=()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, path + (str(i),)))
        return out
    return [("/".join(path), tree)]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(template)


def state_to_bytes(carries) -> bytes:
    """Serialize a carry tuple (host arrays or device tensors) to
    deterministic bytes: the same state gives the same bytes, in either
    package."""
    leaves = [(k, _host(a)) for k, a in _flatten(carries)]
    header = [{"path": k, "dtype": str(a.dtype), "shape": list(a.shape)}
              for k, a in leaves]
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode()
    parts = [_MAGIC, struct.pack("<I", len(hdr)), hdr]
    for _, a in leaves:
        parts.append(np.ascontiguousarray(a).tobytes())
    return b"".join(parts)


def state_from_bytes(payload: bytes, template) -> Any:
    """Rebuild a carry tuple of host arrays from :func:`state_to_bytes`
    output.  ``template`` (a fresh carry tuple of the same config) gives
    the structure; a leaf whose dtype or shape differs is refused."""
    if not payload.startswith(_MAGIC):
        raise ValueError("not an online learner state payload")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<I", payload, off)
    off += 4
    header = json.loads(payload[off:off + hlen].decode())
    off += hlen
    t_leaves = [(k, _host(a)) for k, a in _flatten(template)]
    if [h["path"] for h in header] != [k for k, _ in t_leaves]:
        raise ValueError(
            f"state layout mismatch: payload has "
            f"{[h['path'] for h in header]}, template has "
            f"{[k for k, _ in t_leaves]}")
    leaves = []
    for h, (key, t) in zip(header, t_leaves):
        dt = np.dtype(h["dtype"])
        shape = tuple(h["shape"])
        if dt != t.dtype or shape != t.shape:
            raise ValueError(
                f"leaf {key!r}: payload {dt}{shape} vs template "
                f"{t.dtype}{t.shape}")
        n = dt.itemsize * int(np.prod(shape, dtype=np.int64)) \
            if shape else dt.itemsize
        arr = np.frombuffer(payload[off:off + n],
                            dtype=dt).reshape(shape).copy()
        off += n
        leaves.append(arr)
    if off != len(payload):
        raise ValueError(f"trailing bytes in state payload "
                         f"({len(payload) - off})")
    return _unflatten(template, leaves)
