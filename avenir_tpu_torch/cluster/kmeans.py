"""K-means clustering over mixed-type records, several cluster groups at
once: the port of ``avenir_tpu/cluster/kmeans.py``.

Reference: cluster/KmeansCluster.java — one MR pass per Lloyd iteration; the
mapper assigns every record to the nearest centroid of every *active* cluster
group (mixed numeric/categorical distance, :116,162), the reducer recomputes
each centroid (numeric attrs -> mean, categorical attrs -> histogram mode,
:262-282) and emits ``group,centroid...,movement,status,avError,count``
(:284-294).  The cluster file between iterations is the checkpoint
(cluster/ClusterGroup.java:17-29 marks clusters stopped once their movement
falls below the threshold).

One pass per Lloyd iteration over the stacked groups, on the engine's
device, over row chunks (``ROW_CHUNK``): the (G, n, K) distance, its
first minimum, and the sums the JAX package's ``_partials_impl`` takes by
one-hot contractions (``onehot.T @ num``, ``onehot.T @ codes_oh``,
``onehot.T @ dmin²``) as ``bincount``s of the flat (group, cluster)
slot.  The distance is the JAX package's float32 arithmetic element for
element, as XLA's CPU backend compiles it (read from its optimized HLO
and held against its output): each division by a constant a product
with the float32 reciprocal, the centroid's scaled difference
``fma(-c, 1/range, x * (1/range))``, the squares summed by an FMA chain
left to right, the root correctly rounded.  So assignments and their ties
are the JAX package's.  Each FMA is emulated exactly from float64 ops
(:func:`ops.distance.fma_f32`), so the CPU and the card compute the same
float32 values.  The sums are float64: counts and the sums of integer-valued
attributes are then exact at any size and in any order, and equal to the
JAX package's float32 sums wherever those are exact (below 2^24);
``dmin²`` sums (``avError``, rounded to float32 from a float64 sum whose
order the card's atomics may vary) are held to a tolerance.  The
finalize (new centroids, movement, avError) runs on the host in float32
numpy, the same on every device.  In a joined run the partials are
all-reduced before it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.artifacts import write_text_output
from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable
from ..ops.distance import fma_f32, sqrt_f32
from ..runtime import resolve_device
from ..utils.tracing import fetch, layer, note_dispatch, note_h2d

NULL = "null"
STATUS_ACTIVE = "active"
STATUS_STOPPED = "stopped"
# rows a pass takes at once, by device type: on the card few launches,
# its (G, rows, K) float64 temporaries of the distance bounded; on the
# CPU temporaries that stay in cache (a pass several times faster)
ROW_CHUNK = {"cuda": 1 << 20, "cpu": 1 << 17}


# ---------------------------------------------------------------------------
# host-side state: cluster file round-trip (the checkpoint contract)
# ---------------------------------------------------------------------------

@dataclass
class Cluster:
    """One centroid: full record-width string items (non-facet attrs NULL)."""
    items: List[str]
    movement: float
    status: str
    av_error: float = 0.0
    count: int = 0


@dataclass
class ClusterGroup:
    """Reference cluster/ClusterGroup.java: clusters become stopped when their
    movement drops below the threshold; the group is active while any cluster
    still is."""
    name: str
    clusters: List[Cluster]
    movement_threshold: float

    def apply_threshold(self) -> None:
        for c in self.clusters:
            if c.movement < self.movement_threshold:
                c.status = STATUS_STOPPED

    @property
    def active(self) -> bool:
        return any(c.status == STATUS_ACTIVE for c in self.clusters)


def parse_cluster_lines(lines: Sequence[str], num_attributes: int,
                        movement_threshold: float, delim: str = ","
                        ) -> List[ClusterGroup]:
    """Parse ``group,<numAttributes centroid items>,movement,status[,avError,count]``
    (format of cluster/KmeansCluster.java:123-144 in, :284-294 out)."""
    groups: Dict[str, ClusterGroup] = {}
    order: List[str] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        parts = line.split(delim)
        name = parts[0]
        items = parts[1:1 + num_attributes]
        rest = parts[1 + num_attributes:]
        movement = float(rest[0]) if rest else float("inf")
        status = rest[1] if len(rest) > 1 else STATUS_ACTIVE
        av_error = float(rest[2]) if len(rest) > 2 else 0.0
        count = int(rest[3]) if len(rest) > 3 else 0
        if name not in groups:
            groups[name] = ClusterGroup(name, [], movement_threshold)
            order.append(name)
        groups[name].clusters.append(Cluster(items, movement, status,
                                             av_error, count))
    out = [groups[n] for n in order]
    for g in out:
        g.apply_threshold()
    return out


def format_cluster_lines(groups: Sequence[ClusterGroup], delim: str = ",",
                         precision: int = 3) -> List[str]:
    lines = []
    for g in groups:
        for c in g.clusters:
            lines.append(delim.join(
                [g.name] + list(c.items) +
                [f"{c.movement:.{precision}f}", c.status,
                 f"{c.av_error:.{precision}f}", str(c.count)]))
    return lines


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a*b + c`` rounded once (:func:`ops.distance.fma_f32`)."""
    return fma_f32(torch.from_numpy(np.asarray(a, np.float32)),
                   torch.from_numpy(np.asarray(b, np.float32)),
                   torch.from_numpy(np.asarray(c, np.float32))).numpy()


def _sqrt_f32(x: np.ndarray) -> np.ndarray:
    """Correctly rounded float32 square root (through float64)."""
    return np.sqrt(np.asarray(x, np.float64)).astype(np.float32)


# ---------------------------------------------------------------------------
# the Lloyd iteration
# ---------------------------------------------------------------------------

class KMeansEngine:
    """Mixed-type Lloyd's updates for stacked cluster groups.

    Distance semantics follow ops.distance.DistanceComputer (chombo
    InterRecordDistance): numeric attrs contribute ((a-b)/range)^2, categorical
    attrs 0/1 mismatch; record distance = sqrt(mean over facet attrs).
    """

    def __init__(self, schema: FeatureSchema, attr_ordinals: Sequence[int],
                 metric: str = "euclidean", device=None):
        self.schema = schema
        self.attr_ordinals = list(attr_ordinals)
        fields = [schema.find_field_by_ordinal(o) for o in self.attr_ordinals]
        self.num_fields = [f for f in fields if f.is_numeric]
        self.cat_fields = [f for f in fields if f.is_categorical]
        bad = [f.ordinal for f in fields
               if not (f.is_numeric or f.is_categorical)]
        if bad:
            raise ValueError(f"only numeric/categorical attrs allowed, got "
                             f"ordinals {bad}")
        self.n_attrs = len(self.num_fields) + len(self.cat_fields)
        self.metric = metric
        self.device = resolve_device(device)
        self.ranges = np.array(
            [max(float(f.max) - float(f.min), 1e-12)
             if f.max is not None and f.min is not None else 1.0
             for f in self.num_fields], dtype=np.float32)
        self.cards = [len(f.cardinality or []) for f in self.cat_fields]
        # XLA folds each division by a constant into a product with its
        # float32 reciprocal
        self._recip = (np.float32(1.0) / self.ranges).astype(np.float32)
        self._recip_attrs = float(np.float32(1.0)
                                  / np.float32(max(self.n_attrs, 1)))

    # ---- encoding -------------------------------------------------------
    def encode_table(self, table: ColumnarTable) -> Tuple[np.ndarray, np.ndarray]:
        n = table.n_rows
        num = (np.stack([table.columns[f.ordinal] for f in self.num_fields],
                        axis=1).astype(np.float32)
               if self.num_fields else np.zeros((n, 0), np.float32))
        cat = (np.stack([table.columns[f.ordinal] for f in self.cat_fields],
                        axis=1).astype(np.int32)
               if self.cat_fields else np.zeros((n, 0), np.int32))
        return num, cat

    def encode_groups(self, groups: Sequence[ClusterGroup]
                      ) -> Dict[str, np.ndarray]:
        G = len(groups)
        K = max((len(g.clusters) for g in groups), default=1)
        cent_num = np.zeros((G, K, len(self.num_fields)), np.float32)
        cent_cat = np.zeros((G, K, len(self.cat_fields)), np.int32)
        valid = np.zeros((G, K), bool)
        for gi, g in enumerate(groups):
            for ki, c in enumerate(g.clusters):
                valid[gi, ki] = True
                for fi, f in enumerate(self.num_fields):
                    cent_num[gi, ki, fi] = float(c.items[f.ordinal])
                for fi, f in enumerate(self.cat_fields):
                    cent_cat[gi, ki, fi] = f.cat_code(c.items[f.ordinal])
        return {"cent_num": cent_num, "cent_cat": cent_cat, "valid": valid}

    def upload(self, num: np.ndarray, cat: np.ndarray,
               row_valid: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """The loop-invariant row arrays on the engine's device, once."""
        note_h2d(num.nbytes + cat.nbytes + row_valid.nbytes, transfers=3)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (num, cat, row_valid))

    # ---- device pass ----------------------------------------------------
    def _distances(self, num, cat, cent_num, cent_cat, valid):
        """num (n,Fn) raw, cat (n,Fc) codes; centroids (G,K,Fn)/(G,K,Fc).
        Returns (G,n,K) float32 distances with invalid clusters at +inf, in
        the JAX package's float32 order."""
        n = num.shape[0]
        G, K = valid.shape
        total = torch.zeros((G, n, K), dtype=torch.float32,
                            device=num.device)
        if self.num_fields:
            recip = torch.from_numpy(self._recip).to(num.device)
            nn = num * recip
            for fi in range(len(self.num_fields)):
                d = fma_f32(-cent_num[:, None, :, fi], recip[fi],
                            nn[None, :, fi, None])
                total = d * d if fi == 0 else fma_f32(d, d, total)
        if self.cat_fields:
            mismatch = (cat[None, :, None, :] != cent_cat[:, None, :, :]).sum(
                -1).to(torch.float32)
            total = total + mismatch
        mean = torch.clamp(total * self._recip_attrs, min=0.0)
        d = sqrt_f32(mean)
        return torch.where(valid[:, None, :], d,
                           torch.full_like(d, float("inf")))

    def partials(self, num, cat, row_valid, enc: Dict[str, np.ndarray],
                 chunk: Optional[int] = None,
                 profile=None) -> Dict[str, np.ndarray]:
        """The Lloyd sums for every group over this process's rows:
        assignment counts (G,K), numeric sums (G,K,Fn), categorical
        histograms (G,K,Fc,maxcard) and squared-distance sums (G,K), in
        float64.  ``num``/``cat``/``row_valid`` are device tensors
        (:meth:`upload`); ``chunk`` rows at a time (default
        ``ROW_CHUNK`` of their device type)."""
        dev = num.device
        chunk = chunk or ROW_CHUNK.get(dev.type, ROW_CHUNK["cuda"])
        cent_num = torch.from_numpy(enc["cent_num"]).to(dev)
        cent_cat = torch.from_numpy(enc["cent_cat"]).to(dev)
        valid = torch.from_numpy(enc["valid"]).to(dev)
        G, K = enc["valid"].shape
        Fn, Fc = len(self.num_fields), len(self.cat_fields)
        maxcard = max(self.cards, default=0)
        counts = torch.zeros((G, K), dtype=torch.float64, device=dev)
        sum_num = torch.zeros((G, K, Fn), dtype=torch.float64, device=dev)
        cat_hist = torch.zeros((G, K, Fc, maxcard), dtype=torch.float64,
                               device=dev)
        sum_sq = torch.zeros((G, K), dtype=torch.float64, device=dev)
        with layer(profile, "device"):
            self._accumulate(num, cat, row_valid, cent_num, cent_cat, valid,
                             counts, sum_num, cat_hist, sum_sq, chunk)
        with layer(profile, "readback"):
            return {"counts": fetch(counts), "sum_num": fetch(sum_num),
                    "cat_hist": fetch(cat_hist), "sum_sq": fetch(sum_sq)}

    def _accumulate(self, num, cat, row_valid, cent_num, cent_cat, valid,
                    counts, sum_num, cat_hist, sum_sq, chunk):
        dev = num.device
        G, K = counts.shape
        size = G * K
        # one flat slot a (group, cluster)
        base = torch.arange(G, device=dev)[:, None] * K
        for lo in range(0, num.shape[0], chunk):
            nb, cb = num[lo:lo + chunk], cat[lo:lo + chunk]
            rv = row_valid[lo:lo + chunk].double()
            note_dispatch()
            d = self._distances(nb, cb, cent_num, cent_cat, valid)
            dmin, assign = torch.min(d, dim=2)      # first min on ties
            slot = (assign + base).reshape(-1)
            w = rv.repeat(G)             # a padded row weighs 0
            counts += torch.bincount(slot, w, minlength=size).view(G, K)
            for fi in range(nb.shape[1]):
                sum_num[:, :, fi] += torch.bincount(
                    slot, w * nb[:, fi].double().repeat(G),
                    minlength=size).view(G, K)
            for fi, card in enumerate(self.cards):
                code = cb[:, fi].long().repeat(G)
                ok = (code >= 0) & (code < card)
                cat_hist[:, :, fi, :card] += torch.bincount(
                    slot * card + code.clamp(0, card - 1), w * ok,
                    minlength=size * card).view(G, K, card)
            sq = (dmin * dmin).double().reshape(-1)
            sum_sq += torch.bincount(slot, w * sq,
                                     minlength=size).view(G, K)

    # ---- host finalize ---------------------------------------------------
    def finalize(self, parts: Dict[str, np.ndarray],
                 enc: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Global sums -> new centroids + movement + stats, in float32 as
        the JAX package's ``_finalize_impl``: every process derives the
        identical model from the same reduced sums."""
        f32 = np.float32
        counts = parts["counts"].astype(f32)
        sum_num = parts["sum_num"].astype(f32)
        sum_sq = parts["sum_sq"].astype(f32)
        cent_num, cent_cat = enc["cent_num"], enc["cent_cat"]
        safe = np.maximum(counts, f32(1.0))
        new_num = sum_num / safe[..., None]
        if self.cards:
            new_cat = np.stack(
                [np.argmax(parts["cat_hist"][:, :, fi, :card], axis=2)
                 for fi, card in enumerate(self.cards)],
                axis=2).astype(np.int32)
        else:
            new_cat = np.zeros_like(cent_cat)
        empty = counts < 0.5
        new_num = np.where(empty[..., None], cent_num, new_num)
        new_cat = np.where(empty[..., None], cent_cat, new_cat)
        av_error = sum_sq / safe
        mv = np.zeros(counts.shape, f32)
        for fi in range(len(self.num_fields)):
            d = (cent_num[..., fi] - new_num[..., fi]) * self._recip[fi]
            mv = d * d if fi == 0 else _fma(d, d, mv)
        mv = mv + (cent_cat != new_cat).sum(-1).astype(f32)
        movement = _sqrt_f32(mv * f32(self._recip_attrs))
        movement = np.where(empty, f32(0.0), movement)
        return {"cent_num": new_num, "cent_cat": new_cat,
                "movement": movement, "av_error": av_error,
                "counts": counts}

    def iterate(self, num, cat, row_valid, enc: Dict[str, np.ndarray],
                profile=None) -> Dict[str, np.ndarray]:
        """One Lloyd update for all groups: local partial sums ->
        cross-process all-reduce (identity in one process) -> finalize.
        ONE packed collective an iteration, as the JAX package's."""
        from ..parallel.distributed import (all_reduce_host_array,
                                            is_multiprocess)
        parts = self.partials(num, cat, row_valid, enc, profile=profile)
        if is_multiprocess():
            keys = ("counts", "sum_num", "cat_hist", "sum_sq")
            flat = all_reduce_host_array(
                np.concatenate([parts[k].ravel() for k in keys]))
            splits = np.cumsum([parts[k].size for k in keys])[:-1]
            parts = {k: seg.reshape(parts[k].shape)
                     for k, seg in zip(keys, np.split(flat, splits))}
        with layer(profile, "finalize"):
            return self.finalize(parts, enc)

    # ---- host-side round trip ------------------------------------------
    def update_groups(self, groups: Sequence[ClusterGroup],
                      res: Dict[str, np.ndarray],
                      active_idx: Sequence[int],
                      precision: int = 3) -> None:
        """Write the results back into the (full) group list; only groups
        listed in active_idx were part of the batch."""
        for bi, gi in enumerate(active_idx):
            g = groups[gi]
            for ki, c in enumerate(g.clusters):
                items = [NULL] * self.schema.num_columns
                for fi, f in enumerate(self.num_fields):
                    v = float(res["cent_num"][bi, ki, fi])
                    items[f.ordinal] = (f"{v:.{precision}f}" if f.is_double
                                        else str(int(round(v))))
                for fi, f in enumerate(self.cat_fields):
                    code = int(res["cent_cat"][bi, ki, fi])
                    items[f.ordinal] = (f.cardinality or [NULL])[code]
                c.items = items
                c.movement = float(res["movement"][bi, ki])
                c.av_error = float(res["av_error"][bi, ki])
                c.count = int(res["counts"][bi, ki])
            g.apply_threshold()

    def assign(self, table: ColumnarTable, group: ClusterGroup) -> np.ndarray:
        """Nearest-cluster index per row for one group (prediction path)."""
        num, cat = self.encode_table(table)
        enc = self.encode_groups([group])
        t_num, t_cat, _ = self.upload(num, cat, np.ones(len(num), np.float32))
        dev = t_num.device
        d = self._distances(t_num, t_cat,
                            torch.from_numpy(enc["cent_num"]).to(dev),
                            torch.from_numpy(enc["cent_cat"]).to(dev),
                            torch.from_numpy(enc["valid"]).to(dev))
        return fetch(torch.argmin(d[0], dim=1))


# ---------------------------------------------------------------------------
# the iteration loop
# ---------------------------------------------------------------------------

def kmeans_one_pass(table: ColumnarTable, groups: List[ClusterGroup],
                    engine: KMeansEngine, precision: int = 3,
                    encoded: Optional[Tuple] = None, profile=None) -> None:
    """One reference job run (= one MR pass): update every active group in
    place; stopped groups carry forward unchanged.  ``encoded`` (the
    :meth:`KMeansEngine.upload` tensors) lets a caller's loop hoist the
    loop-invariant row upload."""
    active_idx = [i for i, g in enumerate(groups) if g.active]
    if not active_idx:
        return
    if encoded is None:
        num, cat = engine.encode_table(table)
        encoded = engine.upload(num, cat, np.ones(table.n_rows, np.float32))
    enc = engine.encode_groups([groups[i] for i in active_idx])
    res = engine.iterate(*encoded, enc, profile=profile)
    with layer(profile, "finalize"):
        engine.update_groups(groups, res, active_idx, precision)


def run_kmeans(table: ColumnarTable, groups: List[ClusterGroup],
               engine: KMeansEngine, max_iter: int = 100,
               store=None, precision: int = 3, profile=None
               ) -> Tuple[List[ClusterGroup], int]:
    """Iterate to convergence (the reference's external loop re-running
    the job on the rotated cluster file).  If ``store`` (an
    ``ArtifactStore``) is given, each iteration's cluster file is written as
    ``centroids_iter_<i>.csv`` plus the rolling ``centroids.csv``."""
    with layer(profile, "encode"):
        num, cat = engine.encode_table(table)
    with layer(profile, "h2d"):
        encoded = engine.upload(num, cat, np.ones(table.n_rows, np.float32))
    it = 0
    for it in range(1, max_iter + 1):
        if not any(g.active for g in groups):
            it -= 1
            break
        kmeans_one_pass(table, groups, engine, precision, encoded=encoded,
                        profile=profile)
        if store is not None:
            lines = format_cluster_lines(groups, precision=precision)
            write_text_output(store.path(f"centroids_iter_{it}.csv"), lines)
            write_text_output(store.path("centroids.csv"), lines)
    return groups, it


def init_groups(table: ColumnarTable, engine: KMeansEngine,
                group_sizes: Dict[str, int], movement_threshold: float,
                seed: Optional[int] = None) -> List[ClusterGroup]:
    """Random distinct-record initialization (the reference supplies the
    initial cluster file externally; this is the convenience path).  Draws
    from ``np.random.default_rng(seed)`` as the JAX package does."""
    rng = np.random.default_rng(seed)
    groups = []
    for name, k in group_sizes.items():
        picks = rng.choice(table.n_rows, size=k, replace=False)
        clusters = []
        for r in picks:
            items = [NULL] * table.schema.num_columns
            for f in engine.num_fields:
                v = float(table.columns[f.ordinal][r])
                items[f.ordinal] = (f"{v:.6f}" if f.is_double
                                    else str(int(round(v))))
            for f in engine.cat_fields:
                code = int(table.columns[f.ordinal][r])
                items[f.ordinal] = (f.cardinality or [NULL])[max(code, 0)]
            clusters.append(Cluster(items, float("inf"), STATUS_ACTIVE))
        groups.append(ClusterGroup(name, clusters, movement_threshold))
    return groups
