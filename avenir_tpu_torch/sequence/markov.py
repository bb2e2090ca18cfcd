"""Markov-chain models: transition counting, classification, HMM, Viterbi.
The port of ``avenir_tpu/sequence/markov.py``.

Parity targets (the reference's markov/ jobs):
  * MarkovStateTransitionModel — count (fromState, toState) pairs,
    optionally per class label, normalize rows to a scaled transition
    matrix; the model file is the states line plus the matrix rows (with
    ``classLabel:<v>`` separators in class-based mode).
  * MarkovModelClassifier — per-sequence log odds
    sum ln(P_c0(fr,to)/P_c1(fr,to)), threshold -> class.
  * HiddenMarkovModelBuilder — supervised counts from (observation,
    state)-tagged sequences -> transition, emission and initial matrices.
  * ViterbiStatePredictor — the max-likelihood hidden path.

On the device: the transition counts are a joint histogram of (class x
from, to) codes (``ops.histogram.joint_histogram``, a bincount), float32
chunks below 2^24 accumulated in float64 on the host; the classifier's
log odds and the Viterbi scan are float32 torch ops.  The classifier's
printed log odds are XLA's CPU float32: ``xla_log_f32`` of the guarded
ratio table and the row sum in the order XLA gives the batch's padded
length (``utils.xla_math.reduce_row_sum``).  Viterbi is adds and maxes
only (exact in any order); its argmax takes the first of tied
predecessors, as XLA's does.  No Pallas kernel is behind any of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.histogram import joint_histogram
from ..runtime import DeviceLike, resolve_device
from ..utils.tracing import LayerProfile, fetch, layer, note_h2d
from ..utils.xla_math import reduce_row_sum, xla_log_f32

# adjacent pairs a count launch: float32 counts stay exact below 2^24
COUNT_CHUNK_PAIRS = 8 << 20
_EPS = float(np.float32(1e-12))


# --------------------------------------------------------------------------
# transition counting + model
# --------------------------------------------------------------------------

@dataclass
class MarkovModel:
    states: List[str]
    # class label -> (S, S) scaled transition prob matrix; the label is None
    # for a single-matrix model
    matrices: Dict[Optional[str], np.ndarray]
    scale: int = 1000

    def to_lines(self, delim: str = ",") -> List[str]:
        lines = [delim.join(self.states)]
        if list(self.matrices.keys()) == [None]:
            for row in self.matrices[None]:
                lines.append(delim.join(_fmt(v) for v in row))
        else:
            for label, mat in self.matrices.items():
                lines.append(f"classLabel:{label}")
                for row in mat:
                    lines.append(delim.join(_fmt(v) for v in row))
        return lines

    @classmethod
    def from_lines(cls, lines: Sequence[str], class_based: bool,
                   delim: str = ",") -> "MarkovModel":
        states = lines[0].split(delim)
        n = len(states)
        matrices: Dict[Optional[str], np.ndarray] = {}
        i = 1
        if class_based:
            label = None
            while i < len(lines):
                if lines[i].startswith("classLabel"):
                    label = lines[i].split(":")[1]
                    i += 1
                matrices[label] = np.array(
                    [[float(v) for v in lines[i + r].split(delim)]
                     for r in range(n)])
                i += n
        else:
            matrices[None] = np.array(
                [[float(v) for v in lines[i + r].split(delim)]
                 for r in range(n)])
        return cls(states=states, matrices=matrices)


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else f"{v:.3f}"


def encode_sequences(sequences: Sequence[Sequence[str]],
                     states: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Pad string sequences to (n, Lmax) int32 codes + lengths; unknown
    symbols and padding are -1.  One flat pass of dict lookups through
    ``np.fromiter``, landed by one fancy-index scatter (a reshape when
    every sequence has the same length)."""
    n = len(sequences)
    L = max((len(s) for s in sequences), default=1)
    codes = np.full((n, L), -1, dtype=np.int32)
    lens = (np.fromiter((len(s) for s in sequences), dtype=np.int32,
                        count=n) if n else np.zeros((0,), np.int32))
    total = int(lens.sum())
    if total == 0 or not states:
        return codes, lens
    g = {s: i for i, s in enumerate(states)}.get
    flat = np.fromiter((g(s, -1) for seq in sequences for s in seq),
                       dtype=np.int32, count=total)
    if n and (lens == lens[0]).all():
        codes[:, : lens[0]] = flat.reshape(n, -1)
    else:
        offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(total) - np.repeat(offsets, lens)
        codes[rows, cols] = flat
    return codes, lens


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cpu":
        note_h2d(arr.nbytes)
        t = t.to(dev)
    return t


def _pair_valid(c: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(n, L-1): position t holds a real (from, to) pair of known codes."""
    pos = torch.arange(c.shape[1] - 1, device=c.device)[None, :]
    return (pos < (lens.long()[:, None] - 1)) & (c[:, :-1] >= 0) \
        & (c[:, 1:] >= 0)


def count_transitions(codes: np.ndarray, lens: np.ndarray, n_states: int,
                      class_codes: Optional[np.ndarray] = None,
                      n_classes: int = 1, device: DeviceLike = None,
                      profile: Optional[LayerProfile] = None) -> np.ndarray:
    """(n_classes, S, S) transition counts over the padded batch: one
    joint histogram of the (class x from, to) codes of every adjacent pair
    a chunk of rows (at most COUNT_CHUNK_PAIRS pairs, exact in float32),
    accumulated in float64 on the host."""
    dev = resolve_device(device)
    n, L = codes.shape
    total = np.zeros((n_classes * n_states, n_states), np.float64)
    if L < 2 or n == 0:
        return total.reshape(n_classes, n_states, n_states)
    rows = max(1, COUNT_CHUNK_PAIRS // (L - 1))
    for s in range(0, n, rows):
        with layer(profile, "h2d"):
            c = _upload(codes[s:s + rows], dev)
            ln = _upload(lens[s:s + rows], dev)
            cl = None if class_codes is None else \
                _upload(class_codes[s:s + rows], dev)
        with layer(profile, "device"):
            valid = _pair_valid(c, ln)
            fr = c[:, :-1].long()
            if cl is not None:
                fr = cl.long()[:, None] * n_states + fr
            counts = joint_histogram(fr, c[:, 1:], n_classes * n_states,
                                     n_states, mask=valid)
        with layer(profile, "readback"):
            total += fetch(counts).astype(np.float64)
    return total.reshape(n_classes, n_states, n_states)


def build_model(sequences: Sequence[Sequence[str]], states: Sequence[str],
                labels: Optional[Sequence[str]] = None,
                class_labels: Optional[Sequence[str]] = None,
                scale: int = 1000, laplace: float = 1.0,
                device: DeviceLike = None,
                profile: Optional[LayerProfile] = None) -> MarkovModel:
    """Count + row-normalize to scaled probabilities (Laplace smoothing
    keeps the classifier's log ratios finite)."""
    with layer(profile, "encode"):
        codes, lens = encode_sequences(sequences, states)
        ccodes, cl = None, None
        if labels is not None:
            cl = list(class_labels or sorted(set(labels)))
            cidx = {c: i for i, c in enumerate(cl)}
            ccodes = np.array([cidx[l] for l in labels], dtype=np.int32)
    S = len(states)
    if labels is None:
        counts = count_transitions(codes, lens, S, device=device,
                                   profile=profile)
        mats = {None: _normalize(counts[0], scale, laplace)}
    else:
        counts = count_transitions(codes, lens, S, ccodes, len(cl),
                                   device=device, profile=profile)
        mats = {c: _normalize(counts[i], scale, laplace)
                for i, c in enumerate(cl)}
    return MarkovModel(states=list(states), matrices=mats, scale=scale)


def _normalize(counts: np.ndarray, scale: int, laplace: float) -> np.ndarray:
    c = counts + laplace
    rows = c.sum(axis=1, keepdims=True)
    return c / rows * scale


def log_odds(codes: np.ndarray, lens: np.ndarray, m0: np.ndarray,
             m1: np.ndarray, device: DeviceLike = None,
             profile: Optional[LayerProfile] = None) -> np.ndarray:
    """float32 log odds of each padded sequence, as the JAX package's
    ``_log_odds_kernel`` computes them: the (S, S) table ``log(max(m0,
    1e-12) / max(m1, 1e-12))`` in float32 with XLA's log, each real pair's
    entry (the one-hot einsum selects it exactly), the others 0, summed
    over the padded length in XLA's order for that length."""
    dev = resolve_device(device)
    with layer(profile, "h2d"):
        a = _upload(np.asarray(m0, np.float32), dev)
        b = _upload(np.asarray(m1, np.float32), dev)
        c = _upload(codes, dev)
        ln = _upload(lens, dev)
    with layer(profile, "device"):
        lr = xla_log_f32(a.clamp(min=_EPS) / b.clamp(min=_EPS))
        fr = c[:, :-1].long().clamp(min=0)
        to = c[:, 1:].long().clamp(min=0)
        x = torch.where(_pair_valid(c, ln), lr[fr, to],
                        torch.zeros((), dtype=torch.float32, device=dev))
        out = reduce_row_sum(x)
    with layer(profile, "readback"):
        return fetch(out)


def classify(model: MarkovModel, sequences: Sequence[Sequence[str]],
             class_labels: Sequence[str], log_odds_threshold: float = 0.0,
             device: DeviceLike = None,
             profile: Optional[LayerProfile] = None
             ) -> Tuple[List[str], np.ndarray]:
    """Log-odds classification: logOdds = sum ln(P_c0/P_c1) over adjacent
    pairs; > threshold -> c0."""
    with layer(profile, "encode"):
        codes, lens = encode_sequences(sequences, model.states)
    lo = log_odds(codes, lens, model.matrices[class_labels[0]],
                  model.matrices[class_labels[1]], device, profile)
    c0, c1 = class_labels[0], class_labels[1]
    # float32 against the threshold, as the JAX package's numpy compare
    pred = [c0 if hit else c1 for hit in (lo > log_odds_threshold).tolist()]
    return pred, lo


# --------------------------------------------------------------------------
# HMM
# --------------------------------------------------------------------------

@dataclass
class HiddenMarkovModel:
    states: List[str]
    observations: List[str]
    transition: np.ndarray      # (S, S) scaled row-normalized
    emission: np.ndarray        # (S, O)
    initial: np.ndarray         # (S,)
    scale: int = 1000

    def to_lines(self, delim: str = ",") -> List[str]:
        """states line, observations line, S transition rows, S emission
        rows, the initial row."""
        lines = [delim.join(self.states), delim.join(self.observations)]
        for row in self.transition:
            lines.append(delim.join(_fmt(v) for v in row))
        for row in self.emission:
            lines.append(delim.join(_fmt(v) for v in row))
        lines.append(delim.join(_fmt(v) for v in self.initial))
        return lines

    @classmethod
    def from_lines(cls, lines: Sequence[str], delim: str = ","
                   ) -> "HiddenMarkovModel":
        states = lines[0].split(delim)
        obs = lines[1].split(delim)
        S = len(states)
        tr = np.array([[float(v) for v in lines[2 + i].split(delim)]
                       for i in range(S)])
        em = np.array([[float(v) for v in lines[2 + S + i].split(delim)]
                       for i in range(S)])
        init = np.array([float(v) for v in lines[2 + 2 * S].split(delim)])
        return cls(states=states, observations=obs, transition=tr,
                   emission=em, initial=init)


def build_hmm(tagged: Sequence[Sequence[Tuple[str, str]]],
              states: Sequence[str], observations: Sequence[str],
              scale: int = 1000, laplace: float = 1.0) -> HiddenMarkovModel:
    """Supervised HMM from (observation, state)-tagged sequences (host
    counts, as in the JAX package)."""
    sidx = {s: i for i, s in enumerate(states)}
    oidx = {o: i for i, o in enumerate(observations)}
    S, O = len(states), len(observations)
    tr = np.zeros((S, S)); em = np.zeros((S, O)); init = np.zeros((S,))
    for seq in tagged:
        prev = None
        for pos, (obs, st) in enumerate(seq):
            si = sidx[st]
            em[si, oidx[obs]] += 1
            if pos == 0:
                init[si] += 1
            if prev is not None:
                tr[prev, si] += 1
            prev = si

    def norm(m):
        c = m + laplace
        return c / c.sum(axis=-1, keepdims=True) * scale
    return HiddenMarkovModel(states=list(states),
                             observations=list(observations),
                             transition=norm(tr), emission=norm(em),
                             initial=norm(init), scale=scale)


def _log_table(m: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``jnp.log(jnp.asarray(m) + 1e-12)``: a float32 add, XLA's log."""
    eps = torch.tensor(_EPS, dtype=torch.float32, device=dev)
    return xla_log_f32(_upload(np.asarray(m, np.float32), dev) + eps)


def viterbi_scan(codes: np.ndarray, lens: np.ndarray,
                 model: HiddenMarkovModel, device: DeviceLike = None,
                 profile: Optional[LayerProfile] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's ``_viterbi_kernel`` over the padded batch, a step
    a position: the final (n, S) scores and the (L-1, n, S) backpointers.
    Unknown observations (code -1) add a zero emission.  The argmax over
    predecessors keeps the first of equal maxima (a strict ``>`` scan over
    them), as XLA's argmax does."""
    dev = resolve_device(device)
    n, L = codes.shape
    S = len(model.states)
    with layer(profile, "h2d"):
        log_tr = _log_table(model.transition, dev)
        log_em_t = _log_table(model.emission, dev).T.contiguous()  # (O, S)
        log_init = _log_table(model.initial, dev)
        c = _upload(codes, dev)
        ln = _upload(lens, dev).long()
    with layer(profile, "device"):
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        # (L, n, S) emission terms and (L, n) activity, position-major
        em = torch.where((c < 0)[..., None], zero,
                         log_em_t[c.long().clamp(min=0)]).transpose(0, 1)
        active = (torch.arange(L, device=dev)[:, None] < ln[None, :])
        score = log_init[None, :] + em[0]
        back = torch.zeros((max(L - 1, 0), n, S),
                           dtype=torch.uint8 if S <= 256 else torch.int32,
                           device=dev)
        for t in range(1, L):
            best = score[:, 0, None] + log_tr[0][None, :]          # (n, S)
            arg = torch.zeros_like(back[t - 1])
            for p in range(1, S):
                cand = score[:, p, None] + log_tr[p][None, :]
                better = cand > best
                best = torch.where(better, cand, best)
                arg.masked_fill_(better, p)
            back[t - 1] = arg
            score = torch.where(active[t][:, None], best + em[t], score)
    with layer(profile, "readback"):
        return fetch(score), fetch(back)


def backtrack(final: np.ndarray, back: np.ndarray, lens: np.ndarray
              ) -> List[np.ndarray]:
    """Each row's best path from its final scores (``np.argmax``: the first
    of equal scores) back through the backpointers, all rows a step."""
    n = final.shape[0]
    L = back.shape[0] + 1
    cur = np.argmax(final, axis=1) if n else np.zeros((0,), np.int64)
    path = np.zeros((n, L), dtype=np.int64)
    rows = np.arange(n)
    for t in range(L - 1, 0, -1):
        act = rows[lens > t]
        path[act, t] = cur[act]
        cur[act] = back[t - 1, act, cur[act]]
    path[:, 0] = cur
    return [path[i, :int(lens[i])] for i in range(n)]


def viterbi_decode(model: HiddenMarkovModel,
                   obs_sequences: Sequence[Sequence[str]],
                   device: DeviceLike = None,
                   profile: Optional[LayerProfile] = None
                   ) -> List[List[str]]:
    """Batched Viterbi: the scan on the device, the backtrack on the
    host."""
    with layer(profile, "encode"):
        codes, lens = encode_sequences(obs_sequences, model.observations)
    final, back = viterbi_scan(codes, lens, model, device, profile)
    with layer(profile, "backtrack"):
        names = model.states
        return [[names[s] for s in p.tolist()]
                for p in backtrack(final, back, lens)]
