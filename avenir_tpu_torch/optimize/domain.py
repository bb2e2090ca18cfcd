"""Search-domain protocol for stochastic optimization: port of
``avenir_tpu/optimize/domain.py``.

Parity target: optimize/BasicSearchDomain.java — the Strategy interface
between optimizers and business domains.  A solution is an integer vector
``(n_components,)`` of choice indices; a population is a ``(k,
n_components)`` tensor on one device and every callback is batched:
``cost_batch`` maps (k, L) -> (k,) float32.  Mutation replaces random
components (createNeighborhoodSolution), crossover is single point; both
draw through :mod:`..utils.threefry`, key for key as the JAX package
draws, so a run follows the JAX package's trajectory.

``MatrixCostDomain.cost_batch`` adds each solution's per-component costs
in the order XLA's CPU code adds them in the JAX package on one device,
because one ulp of a cost can flip an annealing acceptance.  Outside a
compiled program (the annealer's initial costs, ``form="eager"``) the L
costs add left to right, above 32 in windows of 32 (XLA's tree-reduction
rewrite, :func:`window_sum`).  Inside the compiled optimizer loop
(``form="fused"``) XLA merges the choice and component sums into one
reduction of the L x C masked costs, and LLVM vectorises its loop over
the components according to L and C (:func:`fused_sum_width`): left to
right, or in 4 or 8 lanes added as a tree, and above 32 components in
windows of 32 again.  This was read off XLA's compiled ``cost_batch``
for L from 1 to 300 and C from 2 to 40 on an x86 CPU with AVX-512, and
short annealing and genetic runs follow it
(``tests/test_torch_optimize.py`` holds a sample of every branch).  Two
regions are not reproduced: C above 32 (XLA windows the choices too) and
L above 32 with L % 32 == 31 and C up to 8.  There the port adds left to
right, and a trajectory can part from the JAX package's by an ulp.  The
mean multiplies by the float32 reciprocal of L (XLA folds the division
by a constant).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import threefry as tf
from ..utils.xla_math import WINDOW, lane_sum, seq_row_sum, window_sum


def fused_sum_width(L: int, C: int) -> Optional[int]:
    """The lanes of XLA's fused L x C cost sum (above 32 components, of
    each unpadded window; 1 is left to right), or None where its order
    is not reproduced."""
    if C > 32:
        return None
    if L > WINDOW:
        if L % WINDOW == 0:
            return 8 if C <= 6 else 4 if C <= 8 else 1
        return None if L % WINDOW == WINDOW - 1 and C <= 8 else 1
    if L == 4:
        return 4
    if L == 8 or 16 <= L <= 19 or 24 <= L <= 27 or L == 32:
        return 8
    if 20 <= L <= 23:
        return 4 if C <= 8 else 8
    if 28 <= L <= 31:
        return 4 if 3 <= C <= 8 else 8
    return 1


def fused_sum(base: torch.Tensor, C: int) -> torch.Tensor:
    """Row sums of the (k, L) float32 component costs in XLA's fused
    order (:func:`fused_sum_width`, :func:`window_sum`); left to right
    where that order is not reproduced."""
    L = base.shape[1]
    width = fused_sum_width(L, C)
    if width is None:
        return seq_row_sum(base)
    return lane_sum(base, width) if L <= WINDOW else \
        window_sum(base, width)


@dataclass
class StepSize:
    """Neighborhood step-size strategies (optimize/StepSize.java:28-101):
    how many components one move replaces.  constant -> always max;
    uniform -> U[1, max] (``randint``); gaussian -> round(N(mean, std))
    clipped to [1, max] (``normal``)."""

    max_step_size: int = 1
    strategy: str = "constant"        # constant | uniform | gaussian
    mean: float = 1.0
    std_dev: float = 1.0

    def sample(self, key: torch.Tensor, k: int) -> torch.Tensor:
        """(k,) int64 per-solution step sizes in [1, max_step_size]."""
        if self.strategy == "constant":
            return torch.full((k,), self.max_step_size, dtype=torch.int64,
                              device=key.device)
        if self.strategy == "uniform":
            return tf.randint(key, (k,), 1,
                              self.max_step_size + 1).to(torch.int64)
        if self.strategy == "gaussian":
            from ..utils.xla_math import fma_f32
            # XLA contracts mean + std * z into one FMA
            s = fma_f32(tf.normal(key, (k,)), float(np.float32(self.std_dev)),
                        float(np.float32(self.mean)))
            return torch.clamp(torch.round(s), 1,
                               self.max_step_size).to(torch.int64)
        raise ValueError(f"unknown step-size strategy {self.strategy!r}")


def set_components(solutions: torch.Tensor, pos: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    """``solutions`` with ``solutions[..., i, pos[..., i]] = val[..., i]``,
    as a broadcast select."""
    L = solutions.shape[-1]
    idx = torch.arange(L, device=solutions.device)
    return torch.where(idx == pos[..., None], val[..., None].to(
        solutions.dtype), solutions)


class SearchDomain:
    """Base class: subclasses define n_components, n_choices and cost."""

    n_components: int
    n_choices: int

    def cost_batch(self, solutions: torch.Tensor,
                   form: str = "fused") -> torch.Tensor:
        """(k, L) int -> (k,) float32 cost."""
        raise NotImplementedError

    def initial_solutions(self, rng: np.random.Generator, k: int
                          ) -> np.ndarray:
        return rng.integers(0, self.n_choices, (k, self.n_components),
                            dtype=np.int32)

    def mutate(self, key: torch.Tensor, solutions: torch.Tensor,
               n_mutations: int = 1,
               step_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Replace random components with random choices per solution
        (createNeighborhoodSolution): mutation m draws ``split(key, 3)``,
        a position and a choice, and applies where ``step_sizes > m``."""
        k, L = solutions.shape
        out = solutions
        for m in range(n_mutations):
            key, k1, k2 = tf.split(key, 3)
            pos = tf.randint(k1, (k,), 0, L)
            val = tf.randint(k2, (k,), 0, self.n_choices)
            nxt = set_components(out, pos, val)
            if step_sizes is not None:
                nxt = torch.where((step_sizes > m)[:, None], nxt, out)
            out = nxt
        return out

    def crossover(self, key: torch.Tensor, parents_a: torch.Tensor,
                  parents_b: torch.Tensor) -> torch.Tensor:
        """Single-point crossover per pair (BasicSearchDomain:328-411)."""
        k, L = parents_a.shape
        point = tf.randint(key, (k, 1), 1, L)
        idx = torch.arange(L, device=parents_a.device)[None, :]
        return torch.where(idx < point, parents_a, parents_b)

    # ---- serialization ----
    def component_str(self, position: int, choice: int) -> str:
        return f"{position}:{choice}"

    def parse_component(self, comp: str) -> Tuple[int, int]:
        a, b = comp.split(":")
        return int(a), int(b)

    def to_string(self, solution: np.ndarray, delim: str = ";") -> str:
        return delim.join(self.component_str(i, int(c))
                          for i, c in enumerate(solution))

    def from_string(self, text: str, delim: str = ";") -> np.ndarray:
        out = np.zeros((self.n_components,), dtype=np.int32)
        for comp in text.split(delim):
            pos, choice = self.parse_component(comp)
            out[pos] = choice
        return out


@dataclass
class MatrixCostDomain(SearchDomain):
    """Cost = the mean (or sum) of per-(position, choice) costs, replaced
    by a penalty for a solution that puts two conflicting positions on one
    choice (the TaskSchedule example)."""

    cost_matrix: np.ndarray                    # (L, n_choices)
    conflict: Optional[np.ndarray] = None
    conflict_penalty: float = 0.0
    invalid_replaces_cost: bool = True
    average: bool = True

    def __post_init__(self):
        self.n_components, self.n_choices = self.cost_matrix.shape
        self._cm = torch.from_numpy(np.asarray(self.cost_matrix,
                                               np.float32))
        self._conf = None if self.conflict is None else \
            torch.from_numpy(np.asarray(self.conflict) > 0)
        self._on = {}

    def _tables(self, device):
        dev = torch.device(device)
        t = self._on.get(dev)
        if t is None:
            t = (self._cm.to(dev),
                 None if self._conf is None else self._conf.to(dev))
            self._on[dev] = t
        return t

    def cost_batch(self, solutions: torch.Tensor,
                   form: str = "fused") -> torch.Tensor:
        """Per-solution cost: each component's cost (the JAX package's
        masked select with clipped indices, here a gather: one nonzero a
        row, so the values are the same), summed in XLA's order for
        ``form`` (module docstring), times the float32 1/L for the mean;
        an invalid solution's cost is the penalty (or the penalty per
        conflict added, with ``invalid_replaces_cost`` False)."""
        cm, conf = self._tables(solutions.device)
        L, C = self.n_components, self.n_choices
        sel = torch.clamp(solutions.long(), 0, C - 1)
        base = cm[torch.arange(L, device=sel.device)[None, :], sel]
        total = fused_sum(base, C) if form == "fused" else \
            window_sum(base)
        if self.average:
            total = total * float(np.float32(1.0) / np.float32(L))
        if conf is not None:
            same = solutions[:, :, None] == solutions[:, None, :]
            pen = (same & conf[None]).sum(dim=(1, 2)).to(torch.float32)
            if self.invalid_replaces_cost:
                total = torch.where(pen > 0, torch.full_like(
                    total, float(np.float32(self.conflict_penalty))), total)
            else:
                total = total + float(np.float32(self.conflict_penalty)) * pen
        return total
