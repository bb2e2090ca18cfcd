"""Random forest: port of ``avenir_tpu/models/forest.py``, both halves.

Training (the rafo.sh per-tree rerun loop, in-process):
  * ``ForestParams`` / ``build_forest`` — num_trees trees, each with its
    own bootstrap weights and RNG streams (tree t is seeded
    ``seed + 1000*(t+1)``), grown from one encoding of the data;
  * ``ForestBuilder`` — all trees advance one level together: the (n, T)
    node ids are re-tagged on the device with the previous level's
    winners, one level-histogram kernel launch a row chunk counts the
    stacked (T, N, S, B, C) histogram (``kernels/histogram.py``, replacing
    the Pallas ``ops/pallas/histogram.py`` ``forest_level_counts``), the
    chunks accumulate in int32 on the device, and the host fetches the
    stacked counts once a level — never once a tree;
  * ``build_forest_from_stream`` — the same trees from CSV row blocks
    (``TreeBuilder.from_stream`` assembles the device state; checkpoints,
    resume and a teed baseline ride the ingest).

Prediction:
  * ``EnsembleModel``   == model/EnsemblePredictiveModel.java:69-113 —
    weighted majority vote, min-odds-ratio veto (ambiguous -> None);
  * ``model_predictor`` == model/ModelPredictor.java:46-82 — output modes
    withRecord / withKId / withActualClassAttr, optional error counting.

Device path of the vote: all members' predicate tensors are stacked
(padded to the widest member, plus one always-match fallback sentinel path
each) and the whole vote is one launch of the ensemble-vote kernel per
batch (``kernels/vote.py``).  Ensembles the stacked form rejects — a
degenerate member, bounds that are not float32-exact, non-integer weights —
vote on the host in float64 (``_predict_host``); that is the reference's
own semantics for them, not a fallback, and every run of it is recorded as
``ensemble.vote.host`` in the KernelBackends ledger.

Tree-sharded vote (``EnsembleModel.shard_stacked``, the JAX package's
sharded serving core, ``serving/predictor.py:398-438``): the stacked
members split into one contiguous tree slice per device of a mesh; each
batch runs one partial-tally launch per shard and one merge-finalize on
the mesh's first device (``kernels/vote.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field, replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.metrics import Counters
from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable
from ..kernels.dispatch import note_backend, resolve_backend
from ..kernels.vote import (ensemble_partial_votes, ensemble_vote,
                            prepare_vote_model, shard_stacked_arrays,
                            vote_merge_finalize)
from ..runtime import resolve_device
from ..utils.tracing import fetch, layer, note_dispatch
from .tree import (DecisionPath, DecisionPathList, DecisionTreeModel,
                   FeatureCache, Predicate, TreeBuilder, TreeParams,
                   count_level, level_chunk, sampling_weights,
                   weights_to_device)


class EnsembleModel:
    """Weighted-vote ensemble with min-odds veto
    (model/EnsemblePredictiveModel.java:69-113).  The reference requires an
    odd number of models for unweighted votes; we keep that check."""

    def __init__(self, models: List[DecisionTreeModel],
                 weights: Optional[Sequence[float]] = None,
                 min_odds_ratio: float = 1.0,
                 require_odd: bool = True,
                 stack: bool = True,
                 device=None):
        if require_odd and weights is None and len(models) % 2 == 0:
            raise ValueError("need odd number of models in ensemble")
        self.models = models
        self.weights = list(weights) if weights is not None \
            else [1.0] * len(models)
        self.min_odds_ratio = min_odds_ratio
        self.device = resolve_device(device)
        # vote vocabulary is fixed by the member models; "" is the no-paths
        # sentinel a degenerate member can emit
        self.classes = sorted({c for m in models for c in m.matrix.classes}
                              | {""})
        self._cls_arr = np.array(self.classes)
        # vote-index -> label decode (trailing None = min-odds veto): one
        # table for the batch path and the serving layer
        self._lut = np.concatenate([self._cls_arr.astype(object), [None]])
        self._vote_backend = resolve_backend(self.device)
        # the host arrays of the resident form (stacked_host + the weight
        # vector; per shard when sharded): a delta reload patches them
        self._host = None
        self._sharded_host = None
        # stack=False skips device placement (callers that only need the
        # stacked layout, or shard_stacked)
        self._stacked = self._stack_members() if stack else None
        self._sharded = None

    def stacked_host(self):
        """The HOST (numpy) form of the stacked member tensors
        ``(lo, hi, num_r, cat_m, cat_r, cls_oh)`` — layout identical to the
        JAX package's.  None when any member is degenerate (no
        paths/classes), bounds are not f32-exact, or the vote weights are
        not small integers — fractional weights must accumulate in the host
        path's float64 (f32 vote sums could flip argmax/veto decisions near
        ties)."""
        mats = [m.matrix for m in self.models]
        if not mats or any(m.n_paths == 0 or not m.classes or
                           not m._bounds_f32_exact for m in mats):
            return None
        if any(w != round(w) or abs(w) >= float(1 << 24)
               for w in self.weights):
            return None
        F = len(mats[0].feat_ordinals)
        cmax = max(m.cat_mask.shape[2] for m in mats)
        P = max(m.n_paths for m in mats) + 1          # + fallback sentinel
        T, K = len(mats), len(self.classes)
        cls_idx = {c: i for i, c in enumerate(self.classes)}
        lo = np.full((T, P, F), np.inf, dtype=np.float32)   # pad: never match
        hi = np.full((T, P, F), -np.inf, dtype=np.float32)
        num_r = np.ones((T, P, F), dtype=bool)
        cat_m = np.zeros((T, P, F, cmax), dtype=bool)
        cat_r = np.zeros((T, P, F), dtype=bool)
        cls_oh = np.zeros((T, P, K), dtype=np.float32)
        for t, m in enumerate(mats):
            p = m.n_paths
            lo[t, :p] = m.lo.astype(np.float32)
            hi[t, :p] = m.hi.astype(np.float32)
            num_r[t, :p] = m.num_restricted
            cat_m[t, :p, :, :m.cat_mask.shape[2]] = m.cat_mask
            cat_r[t, :p] = m.cat_restricted
            for pi in range(p):
                cls_oh[t, pi, cls_idx[m.classes[m.path_cls[pi]]]] = 1.0
            # sentinel: always matches, votes the member's fallback class
            lo[t, p] = -np.inf
            hi[t, p] = np.inf
            num_r[t, p] = False
            cls_oh[t, p, cls_idx[m.classes[int(m.fallback_cls)]]] = 1.0
        return lo, hi, num_r, cat_m, cat_r, cls_oh

    def _stack_members(self):
        """:meth:`stacked_host` placed on the device once, in the vote
        kernel's layout (None passes through: the host vote serves those
        ensembles)."""
        host = self.stacked_host()
        if host is None:
            return None
        self._host = (*host, np.asarray(self.weights, np.float32))
        return prepare_vote_model(*self._host, self.device)

    def shard_stacked(self, mesh):
        """Place the stacked members over ``mesh`` (a
        ``parallel.mesh.DeviceMesh``) for :meth:`vote_device`: T padded up
        to a multiple of S with zero-weight members that never match, split
        into S contiguous tree slices
        (``kernels.vote.shard_stacked_arrays``), each prepared on its
        shard's device.  The batch rows and
        the merge live on ``mesh.devices[0]``, which must be this model's
        device.  Raises when the ensemble has no stacked form."""
        host = self.stacked_host()
        if host is None:
            raise ValueError("shard_stacked: the ensemble has no stacked "
                             "form (degenerate member, bounds that are not "
                             "float32-exact, or non-integer weights)")
        if torch.device(mesh.devices[0]) != torch.device(self.device):
            raise ValueError(f"shard_stacked: the mesh merges on "
                             f"{mesh.devices[0]}, the model is on "
                             f"{self.device}")
        slices = shard_stacked_arrays(
            (*host, np.asarray(self.weights, np.float32)), mesh.size)
        self._sharded = [prepare_vote_model(*arrays, dev)
                         for arrays, dev in zip(slices, mesh.devices)]
        self._sharded_host = slices

    def device_inputs(self, table: ColumnarTable, cache=None):
        """The single gate for the device vote: (d_vals, d_codes) when this
        table can take it — members stacked (on one device or sharded),
        rows present, and features f32-exact — else None (host vote).
        Shared by predict() and the serving layer so the two paths can
        never disagree on WHEN the kernel applies."""
        if (self._stacked is None and self._sharded is None) \
                or table.n_rows == 0:
            return None
        cache = cache if cache is not None else FeatureCache()
        m0 = self.models[0].matrix
        vals, codes = cache.host(m0, table)
        if not m0._f32_safe(vals):
            return None
        return cache.device(vals, codes, self.device)

    def predict(self, table: ColumnarTable) -> List[Optional[str]]:
        """Weighted vote: device kernel when available, else one (n, K)
        host reduction over per-member predictions."""
        cache = FeatureCache()
        dev = self.device_inputs(table, cache)
        if dev is not None:
            return list(self._lut[fetch(self.vote_device(*dev))])
        return self._predict_host(table, cache)

    def vote_device(self, d_vals, d_codes) -> torch.Tensor:
        """(n,) int32 vote indices on the device: ONE kernel launch for the
        whole batch (the kernel keeps no (n,T,P) intermediate, so there is
        nothing to chunk).  Sharded (:meth:`shard_stacked`): the rows go to
        every shard's device, one partial-tally launch a shard, one gather
        of the (n, K) tallies onto this model's device, one
        merge-finalize launch, recorded as one ``serve.shard_merge``."""
        if self._sharded is not None:
            from ..parallel.collectives import gather_to
            note_dispatch(site="serve.shard_merge")
            note_backend("serve.shard_merge", self._vote_backend)
            parts = [ensemble_partial_votes(d_vals.to(m.device),
                                            d_codes.to(m.device), m)
                     for m in self._sharded]
            return vote_merge_finalize(gather_to(parts, self.device),
                                       self.min_odds_ratio)
        note_dispatch(site="ensemble.vote")
        note_backend("ensemble.vote", self._vote_backend)
        return ensemble_vote(d_vals, d_codes, self._stacked,
                             self.min_odds_ratio)

    def _predict_host(self, table: ColumnarTable,
                      cache) -> List[Optional[str]]:
        note_backend("ensemble.vote", "host")
        n = table.n_rows
        cls_arr = self._cls_arr
        mat = np.zeros((n, len(cls_arr)), dtype=np.float64)
        rows = np.arange(n)
        for model, w in zip(self.models, self.weights):
            pred, _ = model.predict(table, features=cache)
            idx = np.searchsorted(cls_arr, np.asarray(pred))
            # (rows, idx) pairs are unique within one model's votes, so plain
            # fancy-index += is exact
            mat[rows, idx] += w
        order = np.argsort(-mat, axis=1)
        best = cls_arr[order[:, 0]]
        out = best.astype(object)
        if self.min_odds_ratio > 1.0 and mat.shape[1] > 1:
            top = mat[rows, order[:, 0]]
            second = np.maximum(mat[rows, order[:, 1]], 1e-12)
            out[top / second <= self.min_odds_ratio] = None
        return list(out)


OUTPUT_WITH_RECORD = "withRecord"
OUTPUT_WITH_ID = "withKId"
OUTPUT_WITH_CLASS_ATTR = "withActualClassAttr"


def model_predictor(table: ColumnarTable, schema: FeatureSchema,
                    path_lists: List[DecisionPathList],
                    output_mode: str = OUTPUT_WITH_RECORD,
                    id_ordinal: int = 0,
                    class_attr_ordinal: Optional[int] = None,
                    error_counting: bool = False,
                    weights: Optional[Sequence[float]] = None,
                    min_odds_ratio: float = 1.0,
                    out_delim: str = ",",
                    counters: Optional[Counters] = None,
                    device=None) -> List[str]:
    """The generic predictor job body: ensemble (or single-model) prediction
    with the reference's output modes (model/ModelPredictor.java:87-150) and
    optional per-member vote weights (:144-151)."""
    device = resolve_device(device)
    models = [DecisionTreeModel(pl, schema, device=device)
              for pl in path_lists]
    if len(models) == 1:
        preds, _ = models[0].predict(table)
        pred_list: List[Optional[str]] = list(preds)
    else:
        pred_list = EnsembleModel(models, weights=weights,
                                  min_odds_ratio=min_odds_ratio,
                                  require_odd=min_odds_ratio <= 1.0 and
                                  weights is None,
                                  device=device).predict(table)
    raw = table.raw_rows
    preds = [p if p is not None else "ambiguous" for p in pred_list]
    if output_mode == OUTPUT_WITH_RECORD and raw is not None:
        lines = [out_delim.join(r) + out_delim + p
                 for r, p in zip(raw, preds)]
    elif output_mode == OUTPUT_WITH_ID:
        rids = table.str_columns[id_ordinal] \
            if id_ordinal in table.str_columns \
            else map(str, range(table.n_rows))
        lines = [rid + out_delim + p for rid, p in zip(rids, preds)]
    elif output_mode == OUTPUT_WITH_CLASS_ATTR and raw is not None:
        if class_attr_ordinal is not None:
            lines = [f"{i}{out_delim}{r[class_attr_ordinal]}{out_delim}{p}"
                     for i, (r, p) in enumerate(zip(raw, preds))]
        else:
            lines = [f"{i}{out_delim}{out_delim}{p}"
                     for i, p in enumerate(preds)]
    else:
        lines = list(preds)
    if error_counting and class_attr_ordinal is not None and raw is not None:
        actual = np.fromiter((r[class_attr_ordinal] for r in raw),
                             dtype=object, count=table.n_rows)
        errors = int((np.asarray(pred_list, dtype=object) != actual).sum())
        if counters is not None:
            counters.increment("Prediction", "Error count", errors)
            counters.increment("Prediction", "Total count", table.n_rows)
    return lines


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@dataclass
class ForestParams:
    tree: TreeParams = dc_field(default_factory=lambda: TreeParams(
        attr_select_strategy="randomNotUsedYet",
        split_select_strategy="randomAmongTop",
        sub_sampling="withReplace", sub_sampling_rate=90.0))
    num_trees: int = 5
    seed: int = 0


class ForestBuilder:
    """All trees advance one level per level-histogram pass.

    Equivalent to the sequential per-tree loop — each tree keeps its own
    bootstrap weights and RNG streams, so the models are those of
    ``build_forest(..., batched=False)`` — but the level histogram runs
    once for the whole forest over (n, T) node and weight arrays, and
    records are re-tagged for all trees by one reassign a level."""

    def __init__(self, table: Optional[ColumnarTable], params: ForestParams,
                 device=None, profile=None,
                 base: Optional[TreeBuilder] = None, reducer=None):
        """``profile`` (a ``utils.tracing.LayerProfile``) times the layers
        of each level.  ``base`` injects a built TreeBuilder (one
        assembled by ``TreeBuilder.from_stream`` over CSV row blocks); it
        must carry ``replace(params.tree, seed=params.seed)``.  Otherwise
        the builder is constructed from ``table``, data-parallel over
        processes with a ``reducer`` (``TreeBuilder``)."""
        self.params = params
        self.profile = profile
        self.base = base if base is not None else TreeBuilder(
            table, replace(params.tree, seed=params.seed), device,
            profile=profile, reducer=reducer)
        self.tree_builders = [
            self.base.with_params(
                replace(params.tree, seed=params.seed + 1000 * (t + 1)))
            for t in range(params.num_trees)]
        self._w_max = 1.0

    def _level_counts(self, node_ids, weights, n_nodes: int) -> np.ndarray:
        """One level for the whole forest: (T, N, S, B, C) float64 counts,
        row-chunked launches accumulated in int32 on the device, one host
        transfer of the stacked counts — and, in a sharded build, one
        all-reduce of them (``TreeBuilder._reduce_counts``)."""
        base = self.base
        T = len(self.tree_builders)
        S, B, C = base.split_set.n_splits, base.split_set.max_branches, base.C
        chunk = level_chunk(n_nodes, T, S, B, C, self._w_max)
        counts = count_level(node_ids, base.branches, base.cls_codes,
                             weights, n_nodes, B, C, chunk, "forest.level",
                             self.profile)
        with layer(self.profile, "allreduce"):
            return base._reduce_counts(counts)

    def _level_fused(self, node_ids, weights, sel_split: np.ndarray,
                     child_table: np.ndarray, n_new: int):
        """Advance the forest one level: reassign with the previous level's
        winners (in place on node_ids), then histogram the new frontier.
        Returns the counts as a float64 host array."""
        base = self.base
        dev = base.device
        note_dispatch(site="tree.reassign")
        with layer(self.profile, "reassign"):
            TreeBuilder._reassign(node_ids, base.branches,
                                  torch.from_numpy(sel_split).to(dev),
                                  torch.from_numpy(child_table).to(dev))
        return self._level_counts(node_ids, weights, n_new)

    def build_all(self) -> List[DecisionPathList]:
        base, builders = self.base, self.tree_builders
        p = self.params.tree
        T, n = len(builders), base.n_padded
        with layer(self.profile, "weights_h2d"):
            w_cols = [base._expand_weights(
                sampling_weights(base.n_rows, b.params, b.rng))
                for b in builders]
            # per-record weight cap feeds the exactness bound in level_chunk
            self._w_max = max((float(c.max()) for c in w_cols if c.size),
                              default=1.0)
            weights = weights_to_device(np.stack(w_cols, axis=1),
                                        self._w_max, base.device)
        node_ids = torch.zeros((n, T), dtype=torch.int32, device=base.device)
        B = base.split_set.max_branches

        # the root histogram (every record at node 0) IS the level-0
        # frontier histogram, so one pass serves both
        base._next_level()
        counts = self._level_counts(node_ids, weights, 1)
        leaves = [[b._root_state(counts[t, 0])] for t, b in enumerate(builders)]
        finals: List[List[DecisionPath]] = [[] for _ in range(T)]
        roots = [l[0] for l in leaves]
        sel_split = child_table = None

        levels = p.max_depth if p.stopping_strategy == "maxDepth" else 64
        for _level in range(levels):
            active = [[l for l in leaves[t] if not l.stopped] for t in range(T)]
            n_nodes = max((len(a) for a in active), default=0)
            if n_nodes == 0:
                break
            if _level > 0:
                base._next_level()
                counts = self._level_fused(node_ids, weights, sel_split,
                                           child_table, n_nodes)
            with layer(self.profile, "split_choice"):
                sel_split = np.full((T, n_nodes), -1, dtype=np.int32)
                child_table = np.full((T, n_nodes, B), -1, dtype=np.int32)
                for t, b in enumerate(builders):
                    if not active[t]:
                        leaves[t] = []
                        continue
                    new_l, stopped, sel, ctab = b._choose_splits(
                        active[t], counts[t, :len(active[t])])
                    finals[t].extend(stopped)
                    leaves[t] = new_l
                    sel_split[t, :len(sel)] = sel
                    child_table[t, :ctab.shape[0]] = ctab
            if not any(leaves):
                break

        out: List[DecisionPathList] = []
        for t in range(T):
            paths = list(finals[t])
            for leaf in leaves[t]:
                paths.append(DecisionPath(
                    predicates=leaf.predicates,
                    population=int(round(leaf.population)),
                    info_content=leaf.info_content, stopped=True,
                    class_val_pr=leaf.class_val_pr))
            if not paths:
                r = roots[t]
                paths.append(DecisionPath(
                    predicates=[Predicate.root()],
                    population=int(round(r.population)),
                    info_content=r.info_content, stopped=True,
                    class_val_pr=r.class_val_pr))
            out.append(DecisionPathList(decision_paths=paths))
        return out


def build_forest(table: ColumnarTable, params: ForestParams, device=None,
                 batched: bool = True, profile=None,
                 reducer=None) -> List[DecisionPathList]:
    """Train num_trees trees, each with an independent bootstrap + RNG
    (the rafo.sh per-tree rerun loop, in-process), on ``device`` (default:
    the process device, ``cuda`` unless asked otherwise).  ``batched=True``
    (the default) advances all trees level by level through one shared
    histogram; ``batched=False`` is the sequential per-tree loop, whose
    counts take the single-tree semantics of the reference for rows of
    unknown class (``TreeBuilder.level_counts``).

    ``reducer`` (a ``parallel.collectives.AllReducer``) trains over
    processes that each hold their own ``table``: one row-count allgather,
    one count all-reduce a level, and every process returns the forest of
    one process over the tables concatenated in process order
    (``TreeBuilder``)."""
    device = resolve_device(device)
    if batched:
        return ForestBuilder(table, params, device, profile=profile,
                             reducer=reducer).build_all()
    models: List[DecisionPathList] = []
    # data is encoded and branch codes computed once; each tree shares them
    base_builder = TreeBuilder(table, replace(params.tree, seed=params.seed),
                               device, profile=profile, reducer=reducer)
    for t in range(params.num_trees):
        tree_params = replace(params.tree, seed=params.seed + 1000 * (t + 1))
        models.append(base_builder.with_params(tree_params).build())
    return models


def build_forest_from_stream(blocks, schema: FeatureSchema,
                             params: ForestParams, device=None,
                             stats: Optional[dict] = None,
                             checkpoint=None, checkpoint_every: int = 0,
                             resume_state=None, baseline=None,
                             profile=None,
                             reducer=None) -> List[DecisionPathList]:
    """Train the forest from an iterator of ColumnarTable row blocks — the
    streamed CSV -> device ingest's training entry.  Each block is encoded
    to branch and class codes on the device and released, so host memory
    holds a few blocks in flight instead of the whole dataset; wrap the
    source in ``core.table.prefetch_chunks`` so block i+1 parses while
    block i uploads.  The trees are those of ``build_forest`` over the
    assembled table: the bootstrap draws, RNG streams and level
    histograms see the same records.

    ``stats`` collects the phase times: ``parse_s`` (from the caller's
    ``prefetch_chunks``), ``stage_wait_s``, ``transfer_s``,
    ``queue_wait_s``, ``ingest_compute_s`` (``TreeBuilder.from_stream``),
    ``ingest_wall_s`` (the whole ingest) and ``build_s`` (the level loop).
    ``checkpoint``, ``checkpoint_every``, ``resume_state`` and
    ``baseline`` go to ``TreeBuilder.from_stream``.

    ``reducer`` (a ``parallel.collectives.AllReducer``) makes the build
    data-parallel over processes: ``blocks`` is this process's row-range
    shard (``iter_csv_chunks(shard=...)``), every tree level pays one
    all-reduce of the stacked (T, N, S, B, C) counts, and every process
    returns the single-process forest."""
    import time as _time
    t0 = _time.perf_counter()
    base = TreeBuilder.from_stream(blocks, schema,
                                   replace(params.tree, seed=params.seed),
                                   device, stats=stats,
                                   checkpoint=checkpoint,
                                   checkpoint_every=checkpoint_every,
                                   resume_state=resume_state,
                                   baseline=baseline, profile=profile,
                                   reducer=reducer)
    t1 = _time.perf_counter()
    models = ForestBuilder(None, params, profile=profile,
                           base=base).build_all()
    if stats is not None:
        stats["ingest_wall_s"] = t1 - t0
        stats["build_s"] = _time.perf_counter() - t1
    return models
