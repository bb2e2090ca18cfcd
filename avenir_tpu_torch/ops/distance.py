"""Mixed-type record distance and the all-pairs / nearest-k computations of
the KNN jobs: the port of ``avenir_tpu/ops/distance.py``.

Semantics (chombo's ``InterRecordDistance``, as the JAX package defines
them): a numeric attribute contributes ``|a-b| / (max-min)``, a categorical
one a 0/1 mismatch; euclidean is ``floor(sqrt(mean of squares) * scale)``,
manhattan ``floor(mean * scale)``, with ``scale`` = ``sts.distance.scale``.

Bit-identity needs the JAX package's float32 evaluation ORDER, not only its
formula.  The euclidean form ``|t|² + |r|² − 2 t·r`` cancels when t ≈ r and
the square root amplifies the rounding: on e-learning data another
summation order moves distances by up to 15 units.  So every op here is a
separately rounded IEEE float32 op, in the JAX body's order
(``_dist_kernels``), and each accumulation follows the order XLA takes on
the CPU for that path:

* **top-k order** (``pairwise_topk``: the XLA scan and the Pallas kernel
  B5): row norms and dot product each accumulated by fused multiply-add,
  from 0, in feature order; then ``(|t|² + |r|²) − 2·dot``
  (:func:`euclid_topk`);
* **pairwise order** (``pairwise``, the sameTypeSimilarity job): the same
  FMA row norms, but the dot as separately rounded products summed in
  pairs, ``(p0 + p1) + (p2 + p3)`` — a halving tree for other widths
  (:func:`euclid_pairwise`);
* **manhattan**: ``Σ |t − r|`` summed in feature order (:func:`manhattan`).

The two euclidean orders disagree with each other (the reference's own
inconsistency, ROADMAP queue C); each path here mirrors its own.  The
categorical match count is an exact integer in any order.  The FMA is
emulated exactly from float64 ops (:func:`fma_f32`), so these functions
give the same bits on the CPU and on a GPU, where kernel B5
(``kernels/topk.py``, ``csrc/topk.cu``) uses the hardware FMA.

:class:`DistanceComputer` encodes tables (host numpy, as the JAX package
does), caches the encoded train side and its device upload, and runs
``pairwise`` (torch ops on the device) and ``pairwise_topk`` (kernel B5, one
launch per test chunk).  Over a mesh of several devices ``pairwise_topk``
shards the train rows (kernel B7, ``kernels/topk.py``
``topk_scan_sharded``), as the JAX package does on a one-process mesh.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch, note_h2d


# --------------------------------------------------------------------------
# the distance body (shared by pairwise, the plain top-k and the tests)
# --------------------------------------------------------------------------

def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once, as a hardware FMA rounds it, from
    float64 ops (broadcasting).  ``float32(float64(a)*b + c)`` would round
    twice; instead: the float64 product (exact for float32 operands),
    TwoSum for the error of the float64 add, round-to-odd (truncate toward
    zero, set the last bit when inexact), then the cast to float32."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)          # p + c == s + err exactly
    inexact = err != 0
    toward_zero = inexact & ((err > 0) != (s > 0))
    s = torch.where(toward_zero, torch.nextafter(s, torch.zeros_like(s)), s)
    odd = s.view(torch.int64) | inexact.to(torch.int64)
    return odd.view(torch.float64).to(torch.float32)


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """(n,) float32 ``Σ x_f²`` by FMA from 0 in feature order."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for f in range(x.shape[1]):
        acc = fma_f32(x[:, f], x[:, f], acc)
    return acc


def cat_matches(toh: torch.Tensor, roh: torch.Tensor) -> torch.Tensor:
    """(nt, nr) float32 count of shared one-hot bits (exact integers: the
    float64 product of 0/1 operands sums exactly in any order)."""
    if toh.shape[1] == 0:
        return torch.zeros((toh.shape[0], roh.shape[0]), dtype=torch.float32,
                           device=toh.device)
    return (toh.to(torch.float64) @ roh.to(torch.float64).T).to(torch.float32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: the float64 root cast to
    float32 (53 ≥ 2·24 + 2 bits, so the double rounding is exact).
    PyTorch's vectorised float32 ``sqrt`` on the CPU is not correctly
    rounded (some inputs come out one ulp off), which moves floored
    distances at integer edges."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def div_f32(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """IEEE float32 ``x / divisor``.  The divisor rides a 0-dim tensor on
    ``x``'s device: PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal, which rounds differently for a divisor that is not
    a power of two."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


def _euclid_finish(sq, match, n_cat: float, denom: float, fscale: float):
    """``floor(sqrt(max((max(sq, 0) + (n_cat − match)) / denom, 0)) ·
    fscale)``: the JAX body's tail (a categorical mismatch is 0/1, so its
    square is itself)."""
    total = torch.clamp_min(sq, 0.0) + (n_cat - match)
    mean = div_f32(total, denom)
    return torch.floor(sqrt_f32(torch.clamp_min(mean, 0.0)) * fscale)


def euclid_topk(tn, toh, rn, roh, n_cat: float, denom: float, fscale: float,
                r_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nt, nr) float32 floored euclidean distances in the top-k order:
    FMA norms, FMA dot of ``2t`` and ``r`` from 0 in feature order
    (``r_norms``: the train rows' norms, when the caller hoisted them)."""
    t_norms = row_norms(tn)
    if r_norms is None:
        r_norms = row_norms(rn)
    t2 = tn * 2.0
    dot = torch.zeros((tn.shape[0], rn.shape[0]), dtype=torch.float32,
                      device=tn.device)
    for f in range(tn.shape[1]):
        dot = fma_f32(t2[:, f, None], rn[None, :, f], dot)
    sq = (t_norms[:, None] + r_norms[None, :]) - dot
    return _euclid_finish(sq, cat_matches(toh, roh), n_cat, denom, fscale)


def euclid_pairwise(tn, toh, rn, roh, n_cat: float, denom: float,
                    fscale: float) -> torch.Tensor:
    """(nt, nr) float32 floored euclidean distances in the pairwise order:
    FMA norms, the products ``2t_f · r_f`` rounded one by one and summed
    by a halving tree (``(p0 + p1) + (p2 + p3)`` at four features)."""
    t2 = tn * 2.0
    terms = [t2[:, f, None] * rn[None, :, f] for f in range(tn.shape[1])]
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    dot = terms[0] if terms else torch.zeros(
        (tn.shape[0], rn.shape[0]), dtype=torch.float32, device=tn.device)
    sq = (row_norms(tn)[:, None] + row_norms(rn)[None, :]) - dot
    return _euclid_finish(sq, cat_matches(toh, roh), n_cat, denom, fscale)


def manhattan(tn, toh, rn, roh, n_cat: float, denom: float, fscale: float
              ) -> torch.Tensor:
    """(nt, nr) float32 ``floor((Σ|t − r| + (n_cat − match)) / denom ·
    fscale)``, the numeric sum in feature order."""
    num = torch.zeros((tn.shape[0], rn.shape[0]), dtype=torch.float32,
                      device=tn.device)
    for f in range(tn.shape[1]):
        num = num + (tn[:, f, None] - rn[None, :, f]).abs()
    cat = n_cat - cat_matches(toh, roh)
    return torch.floor(div_f32(num + cat, denom) * fscale)


# --------------------------------------------------------------------------
# the computer
# --------------------------------------------------------------------------

class DistanceComputer:
    """Per-attribute normalisation and the categorical one-hot layout of a
    schema; all-pairs int distances on ``device``.

    Placement: ``device=`` pins one device.  ``mesh=`` (a
    ``parallel.mesh.DeviceMesh``) shards ``pairwise_topk``'s train rows
    over the mesh's devices and merges on its first, which is then
    ``device``.  With neither, the computer takes the runtime context's
    mesh (``parallel.mesh.runtime_context``) when that has several
    devices, else the process device (``cuda`` unless asked otherwise).

    The train-side encode AND its device uploads are cached (one slot,
    keyed by the train table through a weakref): the KNN pipeline hits
    the same train set with every test chunk."""

    def __init__(self, schema: FeatureSchema, metric: str = "euclidean",
                 scale: int = 1000, device=None, mesh=None):
        if mesh is not None and device is not None:
            raise ValueError("mesh and device are mutually exclusive "
                             "placements")
        if mesh is None and device is None:
            from ..parallel.mesh import runtime_context
            mesh = runtime_context().mesh
        self.schema = schema
        self.metric = metric
        self.scale = scale
        # a 1-device mesh is the single-device computer
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self.num_fields = [f for f in schema.feature_fields if f.is_numeric]
        self.cat_fields = [f for f in schema.feature_fields
                           if f.is_categorical]
        self.n_attrs = len(self.num_fields) + len(self.cat_fields)
        self.ranges = np.array(
            [max(float(f.max) - float(f.min), 1e-12) if f.max is not None
             and f.min is not None else 1.0 for f in self.num_fields],
            dtype=np.float32)
        self.cards = [len(f.cardinality or []) for f in self.cat_fields]
        self._n_cat = float(len(self.cat_fields))
        self._denom = float(max(self.n_attrs, 1))
        self._fscale = float(self.scale)
        self._train_ref = lambda: None
        self._train_host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._train_dev: dict = {}

    # ---- encode a table into (numeric matrix, categorical block one-hot) ----
    def encode(self, table: ColumnarTable) -> Tuple[np.ndarray, np.ndarray]:
        """(numeric (n, Fn) float32, one-hot (n, sum_card) int8): each
        numeric column divided in float64 by its float32 range, then cast;
        an unknown categorical code (-1) leaves its block all zeros."""
        n = table.n_rows
        if self.num_fields:
            num = np.stack([table.columns[f.ordinal] / r for f, r in
                            zip(self.num_fields, self.ranges)], axis=1
                           ).astype(np.float32)
        else:
            num = np.zeros((n, 0), dtype=np.float32)
        oh = np.zeros((n, sum(self.cards)), dtype=np.int8)
        off = 0
        for f, card in zip(self.cat_fields, self.cards):
            codes = table.columns[f.ordinal]
            valid = codes >= 0
            oh[np.arange(n)[valid], off + codes[valid]] = 1
            off += card
        return num, oh

    def _encode_train(self, train: ColumnarTable
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Cached train-side encode; rebinding to another table drops the
        old entry and its device arrays."""
        if self._train_ref() is not train or self._train_host is None:
            self.prime_train(train, *self.encode(train))
        return self._train_host

    def prime_train(self, train: ColumnarTable, num: np.ndarray,
                    oh: np.ndarray) -> None:
        """Bind ``train`` to already-encoded arrays (``encode``'s form):
        the next calls with ``train`` use them instead of encoding it."""
        self._train_host = (np.ascontiguousarray(num, np.float32),
                            np.ascontiguousarray(oh, np.int8))
        self._train_dev = {}
        self._train_ref = weakref.ref(train)

    def train_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cached train arrays on the device (uploaded, and recorded in
        the ledger, once per train table)."""
        hit = self._train_dev.get("flat")
        if hit is None:
            rn, roh = self._train_host
            note_h2d(rn.nbytes + roh.nbytes, transfers=2)
            hit = self._train_dev["flat"] = (self._upload(rn),
                                             self._upload(roh))
        return hit

    def train_shards(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The cached train arrays cut into the mesh's contiguous ranges
        (``kernels.topk.shard_ranges``: ceil(n/S) rows each, no pad rows),
        each uploaded once to its shard's device and recorded in the
        ledger."""
        from ..kernels.topk import shard_ranges
        hit = self._train_dev.get("shards")
        if hit is None:
            rn, roh = self._train_host
            hit = []
            for (a, b), dev in zip(shard_ranges(rn.shape[0], self.mesh.size),
                                   self.mesh.devices):
                note_h2d(rn[a:b].nbytes + roh[a:b].nbytes, transfers=2)
                hit.append((self._upload(rn[a:b], dev),
                            self._upload(roh[a:b], dev)))
            self._train_dev["shards"] = hit
        return hit

    def _upload(self, a: np.ndarray, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device if device is None else device)

    def _check_metric(self) -> None:
        if self.metric not in ("euclidean", "manhattan"):
            raise ValueError(f"unknown metric {self.metric!r}")

    def pairwise(self, test: ColumnarTable, train: ColumnarTable,
                 tile: int = 4096, topk_order: bool = False) -> np.ndarray:
        """(n_test, n_train) int32 scaled distances, computed ``tile`` test
        rows at a time: euclidean in the pairwise order, or with
        ``topk_order`` in the top-k order (:func:`euclid_topk`)."""
        self._check_metric()
        tn, toh = self.encode(test)
        self._encode_train(train)
        rn_d, roh_d = self.train_device()
        body = manhattan if self.metric == "manhattan" else \
            euclid_topk if topk_order else euclid_pairwise
        out = np.zeros((tn.shape[0], rn_d.shape[0]), dtype=np.float32)
        for s in range(0, tn.shape[0], tile):
            e = min(s + tile, tn.shape[0])
            note_h2d(tn[s:e].nbytes + toh[s:e].nbytes, transfers=2)
            note_dispatch()
            out[s:e] = fetch(body(self._upload(tn[s:e]),
                                  self._upload(toh[s:e]), rn_d, roh_d,
                                  self._n_cat, self._denom, self._fscale))
        return out.astype(np.int32)

    def pairwise_topk(self, test: ColumnarTable, train: ColumnarTable,
                      k: int, test_chunk: int = 1 << 13,
                      shard_reducer=None, shard_base: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused all-pairs distance + nearest-k: the (n_test, n_train)
        matrix never exists.  One B5 launch per ``test_chunk`` test rows
        (``kernels/topk.py``; the plain version on the CPU) against the
        cached flat train arrays; the chunks' results stay on the device
        and read back in one transfer per output.  Over a mesh, each chunk
        runs one B5 launch per non-empty train shard and one merge
        (``topk_scan_sharded``) instead.

        Returns (distances (n_test, k) int32, train indices (n_test, k)
        int32), rows nearest-first, ties to the lowest train index, with
        ``k`` clamped to ``n_train``.

        Over processes (``shard_reducer``, a
        ``parallel.collectives.AllReducer``): ``train`` is this process's
        row-range shard of the global train set, from global row
        ``shard_base``.  Each test chunk's local list (B5 with k clamped
        to the shard's rows, live indices lifted to global rows) merges
        with every peer's in one lock-step collective a chunk
        (``AllReducer.merge_topk``, the top-k merge kernel on this
        process's device), so every process returns the single-process
        scan's lists; ``k`` is then clamped to the global train count.  An
        empty shard still joins every chunk's merge.  All processes must
        walk the same test rows in the same chunks.

        Ledger shape: each test chunk costs 2 H2D transfers and 1
        ``knn.topk`` dispatch (over a mesh also 1 ``knn.shard_merge``
        dispatch and 1 gather); several chunks add 1 concat dispatch; the
        call reads back 2 D2H transfers; the train side uploads (2 H2D,
        over a mesh 2 a shard) once per train table."""
        from ..kernels.dispatch import note_backend, resolve_backend
        from ..kernels.topk import topk_scan, topk_scan_sharded
        tn, toh = self.encode(test)
        rn, roh = self._encode_train(train)
        n_test, n_train = tn.shape[0], rn.shape[0]
        k_loc = min(k, n_train)
        if shard_reducer is None:
            k = k_loc
            if n_train == 0 or n_test == 0:
                return (np.zeros((n_test, k), np.int32),
                        np.zeros((n_test, k), np.int32))
        self._check_metric()
        if n_train and self.mesh is not None:
            shards = self.train_shards()
        elif n_train:
            rn_d, roh_d = self.train_device()
        backend = resolve_backend(self.device)
        out_d: List = []
        out_i: List = []
        consts = (k_loc, self.metric, self._n_cat, self._denom,
                  self._fscale)
        for ts in range(0, n_test, test_chunk):
            te = min(ts + test_chunk, n_test)
            if n_train:
                note_h2d(tn[ts:te].nbytes + toh[ts:te].nbytes, transfers=2)
                tn_c = self._upload(tn[ts:te])
                toh_c = self._upload(toh[ts:te])
                note_dispatch(site="knn.topk")
                note_backend("knn.topk", backend)
                if self.mesh is not None:
                    note_dispatch(site="knn.shard_merge")
                    best_d, best_i = topk_scan_sharded(
                        tn_c, toh_c, shards, *consts, self.mesh)
                else:
                    best_d, best_i = topk_scan(tn_c, toh_c, rn_d, roh_d,
                                               *consts)
            if shard_reducer is not None:
                if n_train:
                    d_h, i_h = fetch(best_d), fetch(best_i)
                    i_h = np.where(i_h >= 0, i_h + np.int32(shard_base),
                                   np.int32(-1))
                else:
                    # an empty train shard joins every merge, with nothing
                    d_h = np.zeros((te - ts, 0), np.float32)
                    i_h = np.zeros((te - ts, 0), np.int32)
                best_d, best_i = shard_reducer.merge_topk(
                    d_h, i_h, k, device=self.device)
            out_d.append(best_d)
            out_i.append(best_i)
        if shard_reducer is not None:
            if not out_d:
                return (np.zeros((0, k_loc), np.int32),
                        np.zeros((0, k_loc), np.int32))
            return (np.concatenate(out_d).astype(np.int32),
                    np.concatenate(out_i))
        if len(out_d) == 1:
            d_all, i_all = out_d[0], out_i[0]
        else:
            note_dispatch()
            d_all, i_all = torch.cat(out_d), torch.cat(out_i)
        return fetch(d_all).astype(np.int32), fetch(i_all)
