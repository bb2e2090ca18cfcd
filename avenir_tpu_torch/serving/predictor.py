"""Warm, shape-bucketed predictors: port of
``avenir_tpu/serving/predictor.py`` (the ``Predictor`` base, the
``ForestPredictor``, the ``BayesPredictor``, the ``LogisticPredictor``
and the ``MLPPredictor``).

Every ``Predictor`` pads incoming micro-batches up to a fixed bucket size
with copies of the batch's last row (per-row prediction is independent, so
pad rows cannot perturb real rows; results are sliced back).  PyTorch runs
eagerly, so the buckets bound the set of batch shapes the kernels see
rather than a compile cache; ``warm()`` still runs one batch per bucket
at model load, which also builds the CUDA kernels off the request path.

A ``ForestPredictor`` places the stacked member tensors on its device once
per model and answers exactly what the offline ``modelPredictor`` job
would emit for the same records.  ``None`` (min-odds veto) maps to the
service's ``ambiguous_label``.  Given a version's int8 sidecar
(``serving/quantized.py``, the ``ps.quantized`` knob) it serves the
quantized vote instead, over about 4x fewer request bytes.  Given
``serve_mesh`` it shards the members over the trees of a device mesh
(forests too big for one device's memory) and merges each batch's
tallies on the mesh's first device.  A quantized ``ForestPredictor`` also
serves client-binned int8 rows (``predict_prebinned``, the ``predictq``
wire form), and a float one patches the trees a registry delta changed
(``apply_delta``) in place of a full reload.  A ``BayesPredictor`` scores
each bucket-padded table with ``models/bayes.predict``, the offline
``bayesianPredictor``'s argmax.  A ``LogisticPredictor`` computes
``sigmoid([1, x...] @ w)`` in float32 over each bucket-padded table, the
trainer's own predict math (``regress/logistic.py``).  An
``MLPPredictor`` answers the argmax of ``nn/mlp.forward_logits`` over each
bucket-padded table, the offline ``neuralNetworkPredictor``'s label.
"""

from __future__ import annotations

import json
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.schema import FeatureSchema
from ..core.table import ColumnarTable, encode_rows
from ..kernels.dispatch import BACKEND_CUDA, note_backend
from ..kernels.vote import patch_vote_model, vote_form
from ..runtime import resolve_device
from ..utils.tracing import fetch, note_dispatch, note_h2d
from .registry import BAYES, FOREST, LOGISTIC, MLP, LoadedModel

DEFAULT_BUCKETS = (1, 8, 64, 512)
# the stacked arrays a delta sidecar carries slices of, in stacked order
_DELTA_NAMES = ("lo", "hi", "num_r", "cat_m", "cat_r", "cls_oh")
AMBIGUOUS = "ambiguous"   # the ensemble's min-odds veto, as a wire label


class Predictor:
    """Base: tokenized-row requests -> class-label strings, bucketed."""

    def __init__(self, schema: FeatureSchema,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 delim: str = ","):
        self.schema = schema
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.delim = delim

    # ---- bucketing ----
    def bucket_size(self, n: int) -> int:
        """Smallest bucket >= n; requests beyond the largest bucket are
        chunked by the caller."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def dummy_row(self) -> List[str]:
        """One schema-valid record (used to warm the buckets)."""
        row = [""] * self.schema.num_columns
        for f in self.schema.fields:
            if f.is_categorical:
                row[f.ordinal] = (f.cardinality or [""])[0]
            elif f.is_numeric:
                lo = f.min if f.min is not None else 0
                row[f.ordinal] = str(int(lo)) if f.is_integer \
                    else repr(float(lo))
            else:
                row[f.ordinal] = "x"
        return row

    def warm(self) -> "Predictor":
        """One dummy batch per bucket size through the full predict path
        before traffic arrives."""
        d = self.dummy_row()
        for b in self.buckets:
            self.predict_rows([list(d)] * b)
        return self

    # ---- request entries ----
    def _bucketed_tables(self, rows: List[List[str]]):
        """Yield (table, n_valid) per top-bucket chunk: rows are split at
        the largest bucket, each chunk padded up to its bucket size with
        copies of its last row."""
        top = self.buckets[-1]
        for s in range(0, len(rows), top):
            chunk = rows[s:s + top]
            n = len(chunk)
            b = self.bucket_size(n)
            yield encode_rows(chunk + [chunk[-1]] * (b - n),
                              self.schema), n

    def prepare_rows(self, rows: List[List[str]]):
        """The HOST half of predict_rows: tokenized records -> encoded,
        bucket-padded tables.  Hand the result to :meth:`predict_prepared`
        on the SAME predictor instance."""
        return list(self._bucketed_tables(rows)) if rows else []

    def predict_prepared(self, prepared) -> List[Optional[str]]:
        """The DEVICE half: predict the tables from :meth:`prepare_rows`."""
        out: List[Optional[str]] = []
        for table, n in prepared:
            out.extend(self._predict_table(table)[:n])
        return out

    def predict_rows(self, rows: List[List[str]]) -> List[Optional[str]]:
        """Predict a micro-batch of tokenized records."""
        if not rows:
            return []
        return self.predict_prepared(self.prepare_rows(rows))

    # ---- pre-binned int8 wire form (predictq) ----
    @property
    def supports_prebinned(self) -> bool:
        """True when :meth:`predict_prebinned` can serve the int8
        ``predictq`` wire form (quantized forests only)."""
        return False

    @property
    def prebinned_width(self) -> int:
        """F of the (n, F) int8 pre-binned row — 0 when unsupported."""
        return 0

    def predict_prebinned(self, qv, qc) -> List[Optional[str]]:
        raise NotImplementedError(
            f"{type(self).__name__} has no pre-binned serving path")

    def _predict_table(self, table: ColumnarTable) -> List[Optional[str]]:
        raise NotImplementedError


class ForestPredictor(Predictor):
    """Decision forest serving through the batch path's own vote kernel, so
    responses are exactly what the offline modelPredictor job emits for the
    same records.  Single-tree forests serve through the per-tree path.

    ``quantized`` (a ``QuantizedForest``) serves the int8 vote instead; it
    warns and serves the float model when the forest is a single tree, has
    no stacked device form, or the sidecar's class order is not the
    ensemble's.

    ``serve_mesh`` shards the stacked members over the tree axis of a
    device mesh instead of placing them on one device: ``True`` = every
    visible device, an int = the first n, a ``parallel.mesh.DeviceMesh``
    as given; a 1-device result is the plain single-device predictor on
    that device.  Each batch copies its feature arrays to every shard's
    device, runs one partial-tally launch a shard and one merge-finalize
    on the mesh's first device (``EnsembleModel.shard_stacked``), and
    answers bit for bit what the single-device vote answers.  A forest
    with no stacked form warns and serves the host vote on the first
    device; the int8 serve stays unsharded, on that device, as in the JAX
    package.  ``serve_mesh`` and ``device`` are exclusive."""

    def __init__(self, path_lists, schema: FeatureSchema,
                 weights: Optional[Sequence[float]] = None,
                 min_odds_ratio: float = 1.0, quantized=None, device=None,
                 serve_mesh=None, tree_shas: Optional[Sequence[str]] = None,
                 **kw):
        super().__init__(schema, **kw)
        # the published per-tree content shas: the identity a delta's
        # parent chain must match before apply_delta patches anything
        self.tree_shas = list(tree_shas) if tree_shas else None
        from ..models.forest import EnsembleModel
        from ..models.tree import DecisionTreeModel
        if serve_mesh is not None and device is not None:
            raise ValueError("serve_mesh and device are mutually exclusive "
                             "placements")
        mesh = self._resolve_serve_mesh(serve_mesh)
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self.models = [DecisionTreeModel(pl, schema, device=self.device)
                       for pl in path_lists]
        self.single = len(self.models) == 1
        self.serve_mesh = None
        if self.single:
            self.ensemble = None
        else:
            sharded = mesh is not None and mesh.size > 1
            self.ensemble = EnsembleModel(
                self.models, weights=weights, min_odds_ratio=min_odds_ratio,
                require_odd=False, stack=not sharded, device=self.device)
            if sharded and self.ensemble.stacked_host() is None:
                warnings.warn(
                    "serve_mesh: ensemble has no stacked device form "
                    "(degenerate member, bounds that are not float32-exact "
                    "or non-integer weights); serving the host vote on "
                    f"{self.device}", RuntimeWarning)
            elif sharded:
                self.ensemble.shard_stacked(mesh)
                self.serve_mesh = mesh
        self.quantized = None
        self._qvote = None
        if quantized is None:
            return
        if self.single:
            warnings.warn(
                "ps.quantized: single-tree forests serve through the "
                "per-tree predict path; quantized sidecar ignored, serving "
                "the float model", RuntimeWarning)
        elif self.ensemble._stacked is None and \
                self.ensemble._sharded is None:
            warnings.warn(
                "ps.quantized: ensemble has no stacked device form; "
                "serving the float host path", RuntimeWarning)
        elif list(quantized.classes) != list(self.ensemble.classes):
            warnings.warn(
                "ps.quantized: sidecar class order does not match the "
                "loaded model; serving the float model", RuntimeWarning)
        else:
            self.quantized = quantized
            self._qvote = quantized.prepare(self.device)

    @staticmethod
    def _resolve_serve_mesh(serve_mesh):
        """``serve_mesh`` -> a tree-axis ``DeviceMesh`` or None: ``True``
        = every visible device, an int = the first n, a ``DeviceMesh`` as
        given (any axis name)."""
        if serve_mesh is None or serve_mesh is False:
            return None
        from ..parallel.mesh import DeviceMesh, tree_mesh
        if isinstance(serve_mesh, DeviceMesh):
            return serve_mesh
        if serve_mesh is True:
            return tree_mesh()
        return tree_mesh(int(serve_mesh))

    def dispatch_prepared(self, prepared):
        """The ASYNC half of predict_prepared: host prep, H2D and the vote
        kernel's launch per bucket chunk, without waiting for the result
        (CUDA launches return at once), so a continuous serving loop can
        encode the next batch during this one's device time.  Chunks off
        the device path (host vote, single tree) compute synchronously here
        and ride along resolved."""
        from ..models.tree import FeatureCache
        staged = []
        for table, n in prepared:
            if self._qvote is not None:
                # int8 wire: ~4x fewer request bytes than the float path;
                # no f32-exact gate (binning subsumes it)
                vals, codes = FeatureCache().host(self.models[0].matrix,
                                                  table)
                qv, qc = self.quantized.quantize_rows(vals, codes)
                note_backend("serve.predict", "quantized")
                staged.append((True, self._qvote(qv, qc), n))
                continue
            if self.single:
                staged.append(
                    (False, list(self.models[0].predict(table)[0]), n))
                continue
            # same device gate and label decode as the batch path; the
            # cache rides into the host vote so a failed gate does not
            # rebuild the feature arrays
            cache = FeatureCache()
            dev = self.ensemble.device_inputs(table, cache)
            if dev is not None:
                backend = self.ensemble._vote_backend
                note_backend("serve.predict", backend)
                if backend == BACKEND_CUDA and self.serve_mesh is None:
                    # the form the kernel runs: a delta reload rebuilds
                    # the tables, and a patched forest that outgrows them
                    # runs the scan form
                    note_backend("serve.predict.form",
                                 vote_form(self.ensemble._stacked))
                if self.serve_mesh is not None:
                    # one sharded batch, pinned in the ledger as in the JAX
                    # package (vote_device records its merge)
                    note_dispatch(site="serve.predict")
                staged.append((True, self.ensemble.vote_device(*dev), n))
            else:
                staged.append(
                    (False, self.ensemble._predict_host(table, cache), n))
        return staged

    def readback_dispatched(self, staged) -> List[Optional[str]]:
        """The BLOCKING half: read each staged device result back and decode
        labels (host-path chunks are already resolved)."""
        out: List[Optional[str]] = []
        for is_dev, v, n in staged:
            if is_dev:
                out.extend(list(self.ensemble._lut[fetch(v)])[:n])
            else:
                out.extend(list(v)[:n])
        return out

    def _predict_table(self, table: ColumnarTable) -> List[Optional[str]]:
        return self.readback_dispatched(
            self.dispatch_prepared([(table, table.n_rows)]))

    # ---- pre-binned int8 wire form (predictq) ----
    @property
    def supports_prebinned(self) -> bool:
        return self._qvote is not None

    @property
    def prebinned_width(self) -> int:
        if self._qvote is None:
            return 0
        return len(self.models[0].matrix.feat_ordinals)

    def predict_prebinned(self, qv, qc) -> List[Optional[str]]:
        """Serve client-pre-binned int8 rows (the ``predictq`` wire form):
        the host encode — tokenize, ``float()``, ``quantize_rows`` — was
        done by the client, so the decoded rows go straight to the int8
        vote (B3) with no re-quantization.  Same bucket/pad discipline as
        ``_bucketed_tables``: chunks of the top bucket, each padded to its
        bucket with copies of its last row."""
        if self._qvote is None:
            raise NotImplementedError(
                "predict_prebinned needs a quantized sidecar (ps.quantized)")
        qv = np.asarray(qv, np.int8)
        qc = np.asarray(qc, np.int8)
        n_all = qv.shape[0]
        staged = []
        top = self.buckets[-1]
        for s in range(0, n_all, top):
            n = min(top, n_all - s)
            b = self.bucket_size(n)
            cv, cc = qv[s:s + n], qc[s:s + n]
            if b != n:
                cv = np.concatenate([cv, np.repeat(cv[-1:], b - n, 0)])
                cc = np.concatenate([cc, np.repeat(cc[-1:], b - n, 0)])
            note_backend("serve.predict", "quantized")
            staged.append((self._qvote(cv, cc), n))
        out: List[Optional[str]] = []
        for v, n in staged:
            out.extend(list(self.ensemble._lut[fetch(v)])[:n])
        return out

    # ---- delta reload ----
    def apply_delta(self, dmeta: Dict[str, Any], arrays) -> int:
        """Patch ONLY the changed trees of the resident forest: the delta
        slices go to the device into fresh copies of the stacked tensors
        (``kernels.vote.patch_vote_model``), the kernel's path-mask tables
        are rebuilt from the patched forest — they are a function of every
        tree's thresholds — and the new ``VoteModel`` replaces the old one
        in one assignment at the end.  Nothing is patched in place, so a
        batch already launched keeps a valid model.  A tree-sharded core
        patches every shard's slice.  If the patched forest no longer fits
        the table form, the new model runs the scan form (recorded as
        ``serve.predict.form.scan``).  Raises on ANY mismatch — the parent
        sha chain, the class vocabulary, a slice's layout — before
        anything changes, so the caller takes the full load: never wrong
        weights.  Returns the H2D bytes moved (also recorded in the
        active TransferLedger)."""
        from ..core.faults import fault_point
        from ..models.tree import DecisionPathList, DecisionTreeModel
        ens = self.ensemble
        if self.single or ens is None:
            raise ValueError("delta patch: single-tree predictors reload "
                             "in full")
        if ens._stacked is None and ens._sharded is None:
            raise ValueError("delta patch needs the stacked device vote "
                             "(host-path ensembles reload in full)")
        if self._qvote is not None:
            raise ValueError("delta patch: quantized serving rebuilds its "
                             "int8 sidecar a version; reload in full")
        parent = list(dmeta.get("parent_tree_shas") or [])
        if not self.tree_shas or parent != list(self.tree_shas):
            raise ValueError("delta patch: parent sha chain does not match "
                             "the resident model")
        if list(dmeta.get("classes") or []) != list(ens.classes):
            raise ValueError("delta patch: class vocabulary mismatch")
        idx = np.asarray(arrays["idx"], np.int32)
        T = len(self.models)
        if idx.size and (idx.min() < 0 or idx.max() >= T):
            raise ValueError("delta patch: changed-tree index out of range")
        host = ens._host if ens._sharded is None else ens._sharded_host[0]
        slices = []
        for name, cur in zip(_DELTA_NAMES, host):
            upd = np.asarray(arrays[name])
            if upd.shape[1:] != cur.shape[1:] or \
                    upd.shape[0] != idx.size or upd.dtype != cur.dtype:
                raise ValueError(
                    f"delta patch: slice {name} layout {upd.shape}/"
                    f"{upd.dtype} does not match resident "
                    f"{cur.shape}/{cur.dtype}")
            slices.append(upd)
        new_wv = np.asarray(arrays["wvec"], np.float32)
        if new_wv.shape != (T,):
            raise ValueError("delta patch: wvec shape mismatch")
        changed_trees = dmeta.get("changed_trees") or []
        if len(changed_trees) != idx.size:
            raise ValueError("delta patch: changed_trees does not match "
                             "the index list")
        moved = 0
        if ens._sharded is None:
            fault_point("swap_patch")
            stacked, new_host, moved = patch_vote_model(
                ens._stacked, ens._host, idx, slices, new_wv)
            sharded = sharded_host = None
        else:
            # the shards hold contiguous slices of T padded to a multiple
            # of S (zero-weight pad members): each takes its own trees
            S = len(ens._sharded)
            step = ens._sharded_host[0][0].shape[0]
            wv = np.zeros(S * step, np.float32)
            wv[:T] = new_wv
            sharded, sharded_host = [], []
            for s, (model, h) in enumerate(zip(ens._sharded,
                                               ens._sharded_host)):
                fault_point("swap_patch")
                mine = (idx >= s * step) & (idx < (s + 1) * step)
                m, nh, b = patch_vote_model(
                    model, h, idx[mine] - s * step,
                    [a[mine] for a in slices],
                    wv[s * step:(s + 1) * step])
                sharded.append(m)
                sharded_host.append(nh)
                moved += b
            stacked = new_host = None
        fault_point("swap_patch")
        note_h2d(moved)
        # host twins of the changed members (the host vote and the
        # feature gate stay coherent with the device form)
        for i, tj in zip(idx, changed_trees):
            self.models[int(i)] = DecisionTreeModel(
                DecisionPathList.from_json(json.dumps(tj)), self.schema,
                device=self.device)
        ens.weights = [float(w) for w in new_wv]
        # the swap: one assignment per resident form; a batch that already
        # launched keeps the tensors it was given
        if sharded is None:
            ens._stacked, ens._host = stacked, new_host
        else:
            ens._sharded, ens._sharded_host = sharded, sharded_host
        self.tree_shas = list(dmeta["tree_shas"])
        return moved


class BayesPredictor(Predictor):
    """Naive Bayes serving through ``models/bayes.predict`` itself, on
    ``device`` (default: the process device): each bucket-padded table is
    one predict, and a response is the class the offline
    ``bayesianPredictor`` job prints for the record.  The model's tables
    stay on the device across batches (cached on the model)."""

    def __init__(self, model, schema: Optional[FeatureSchema] = None,
                 device=None, **kw):
        super().__init__(schema or model.schema, **kw)
        self.model = model
        self.device = resolve_device(device)

    def _predict_table(self, table: ColumnarTable) -> List[Optional[str]]:
        from ..models import bayes
        return list(bayes.predict(self.model, table,
                                  self.device).pred_class)


class LogisticPredictor(Predictor):
    """Binary logistic serving: the trainer's exact predict math (sigmoid
    of the float32 [1, x...] design row dotted with float32 weights,
    ``regress.logistic.predict``) on ``device`` (default: the process
    device), over bucket-padded tables."""

    def __init__(self, w, schema: FeatureSchema, pos_class_value: str,
                 threshold: float = 0.5, device=None, **kw):
        super().__init__(schema, **kw)
        from ..regress.logistic import pos_neg_codes
        self.w = np.asarray(w, np.float64)
        self.threshold = float(threshold)
        self.device = resolve_device(device)
        cf = schema.class_attr_field
        self.card = list(cf.cardinality or [])
        self.pos_code, self.neg_code = pos_neg_codes(cf, pos_class_value)

    def _proba_table(self, table: ColumnarTable) -> np.ndarray:
        from ..regress.logistic import design_matrix, proba_from_design
        X, _ = design_matrix(table, self.schema)
        return proba_from_design(X, self.w, self.device)

    def _predict_table(self, table: ColumnarTable) -> List[Optional[str]]:
        from ..regress.logistic import threshold_codes
        codes = threshold_codes(self._proba_table(table), self.threshold,
                                self.pos_code, self.neg_code)
        if self.card:
            return [self.card[int(c)] for c in codes]
        return [str(int(c)) for c in codes]

    def predict_proba_rows(self, rows: List[List[str]]) -> np.ndarray:
        """Bucketed positive-class probabilities (the same bucketing as
        predict_rows)."""
        if not rows:
            return np.zeros((0,), np.float32)
        return np.concatenate([self._proba_table(t)[:n]
                               for t, n in self._bucketed_tables(rows)])


class MLPPredictor(Predictor):
    """MLP serving: ``nn/mlp.forward_logits`` argmax (``mlp.predict``)
    on ``device`` (default: the process device) over bucket-padded
    tables; the parameters are placed on the device once."""

    def __init__(self, params: Dict[str, Any], schema: FeatureSchema,
                 class_values: Optional[Sequence[str]] = None, device=None,
                 **kw):
        super().__init__(schema, **kw)
        import torch
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(np.asarray(v, np.float32)).to(
            self.device) for k, v in params.items()}
        cf = schema.class_attr_field
        self.class_values = list(class_values or cf.cardinality or [])

    def _predict_table(self, table: ColumnarTable) -> List[Optional[str]]:
        import torch
        from ..nn import mlp
        X = torch.from_numpy(table.feature_matrix(dtype=np.float32)).to(
            self.device)
        idx = mlp.predict(self.params, X).cpu().numpy()
        cv = self.class_values
        return [cv[i] if i < len(cv) else str(int(i)) for i in idx]


def make_predictor(loaded: LoadedModel,
                   schema: Optional[FeatureSchema] = None,
                   buckets: Sequence[int] = DEFAULT_BUCKETS,
                   delim: str = ",", device=None,
                   quantized: bool = False, serve_mesh=None) -> Predictor:
    """Registry artifact -> a Predictor of its kind (``forest``,
    ``bayes``, ``logistic`` or ``mlp``), using the artifact's embedded schema
    unless one is passed explicitly.  A logistic version names its
    positive class in its ``pos_class_value`` param (and may set
    ``threshold``).

    ``quantized=True`` (the ``ps.quantized`` knob) loads a forest
    version's int8 sidecar and serves the budget-pinned quantized vote; a
    version without an intact sidecar, and every version of another kind,
    warns and serves the float model.  ``serve_mesh`` shards a forest's
    vote over a device mesh (``ForestPredictor``); another kind warns and
    serves on ``device``."""
    schema = schema or loaded.schema
    if schema is None:
        raise ValueError(
            f"model {loaded.name!r} v{loaded.version} has no embedded "
            "schema; pass schema= to make_predictor")
    if loaded.kind not in (FOREST, BAYES, LOGISTIC, MLP):
        raise ValueError(f"unknown model kind {loaded.kind!r}")
    if quantized and loaded.kind != FOREST:
        warnings.warn(
            f"ps.quantized: only forest artifacts have a quantized "
            f"serving path (got kind {loaded.kind!r}); serving the "
            f"float model", RuntimeWarning)
    if serve_mesh is not None and loaded.kind != FOREST:
        warnings.warn(
            f"serve_mesh placement applies to forest serving only (got "
            f"kind {loaded.kind!r}); serving on one device",
            RuntimeWarning)
    if loaded.kind == BAYES:
        return BayesPredictor(loaded.model, schema, device=device,
                              buckets=buckets, delim=delim)
    if loaded.kind == LOGISTIC:
        p = loaded.params
        if "pos_class_value" not in p:
            raise ValueError("logistic artifact is missing the "
                             "pos_class_value param (publish with "
                             "params={'pos_class_value': ...})")
        return LogisticPredictor(
            loaded.model, schema, p["pos_class_value"],
            threshold=float(p.get("threshold", 0.5)), device=device,
            buckets=buckets, delim=delim)
    if loaded.kind == MLP:
        return MLPPredictor(loaded.model, schema,
                            class_values=loaded.class_values or None,
                            device=device, buckets=buckets, delim=delim)
    p = loaded.params
    qf = None
    if quantized:
        if loaded.base_dir is None:
            warnings.warn(
                "ps.quantized: model was not loaded from a registry (no "
                "sidecar source); serving the float model", RuntimeWarning)
        else:
            from .quantized import load_quantized
            from .registry import ModelRegistry
            qf = load_quantized(ModelRegistry(loaded.base_dir), loaded.name,
                                loaded.version)
    return ForestPredictor(
        loaded.model, schema, weights=p.get("weights"),
        min_odds_ratio=float(p.get("min_odds_ratio", 1.0)), quantized=qf,
        device=device, serve_mesh=serve_mesh,
        tree_shas=loaded.meta.get("tree_shas"), buckets=buckets,
        delim=delim)
