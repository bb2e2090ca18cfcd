"""Model registry: port of ``avenir_tpu/serving/registry.py`` for the
``forest``, ``bayes`` and ``logistic`` kinds — reading versions,
publishing them (whole or as a delta over a parent), the serving pin and
retention.

It reads the versions the JAX package's ``ModelRegistry.publish`` writes,
and ``publish`` writes them byte for byte as that one does:

    <base_dir>/<name>/v_000001/meta.json     # kind, class labels, dtypes,
                                             # params, schema, JSON payload
    <base_dir>/<name>/v_000001/arrays.npz    # numeric payload (pinned dtypes)
    <base_dir>/<name>/v_000001/<sidecar>      # files add_sidecar attaches
                                             # (baseline.*, quantized.*)
    <base_dir>/<name>/serving.json           # optional serving pin

Publish writes the version as ``v_NNNNNN.tmp.<pid>`` and renames it into
place, so a reader sees the previous latest or the complete new version.
``add_sidecar`` attaches files to a committed version (each written
tmp-then-rename, the ``meta.json`` manifest rewritten last), and the
intactness probe covers every file the manifest lists.  ``latest_version``
skips torn version directories with a warning, and ``serving_version``
honours a pin whose target is intact.  A forest's payload is its trees'
JSON in ``meta.json`` (an empty ``arrays.npz``); a Naive Bayes model's is
its count tables and Gaussian parameters in ``arrays.npz`` and its record
total in ``meta.json``; a logistic model's is its weight vector ``w``
in ``arrays.npz``.

``pin_version`` / ``clear_pin`` write and remove the serving pin
(tmp-then-rename), ``retire`` keeps the newest versions plus the pinned,
the serving and any live delta parent, and sweeps abandoned tmps of dead
publishers.  ``publish_delta`` publishes a forest in full and attaches a
``delta.json`` + ``delta.npz`` sidecar pair holding only the trees that
changed against a parent version, in the parent's stacked layout: a
serving tier resident on the parent patches those trees
(``ForestPredictor.apply_delta``) instead of reloading the forest.  The
``mlp`` kind is not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.artifacts import ArtifactStore, write_json
from ..core.faults import fault_point, with_retry
from ..core.schema import FeatureSchema
from ..telemetry import instant

FOREST = "forest"
BAYES = "bayes"
LOGISTIC = "logistic"
MLP = "mlp"
KINDS = (FOREST, BAYES, LOGISTIC, MLP)

META_FILE = "meta.json"
ARRAYS_FILE = "arrays.npz"
# the delta sidecar pair: the changed trees' stacked slices and the parent
# version's per-tree sha chain
DELTA_JSON = "delta.json"
DELTA_NPZ = "delta.npz"
DELTA_FORMAT_VERSION = 1
PIN_FILE = "serving.json"
FORMAT_VERSION = 1

_VERSION_RE = re.compile(r"^v_(\d{6})$")
# abandoned publish/pin tmps a dead process left behind (the trailing
# group is the pid retire()'s sweep liveness-checks); younger tmps are
# never swept — a remote host's live publisher looks pid-dead locally
_TMP_RE = re.compile(r"^(?:v_\d{6}|" + re.escape(PIN_FILE)
                     + r")\.tmp\.(\d+)$")
_TMP_GRACE_S = float(os.environ.get("AVENIR_TPU_REGISTRY_TMP_GRACE_S",
                                    "3600"))


@dataclass
class LoadedModel:
    """What :meth:`ModelRegistry.load` returns: the reconstructed model
    object plus everything needed to build a serving Predictor around it."""
    name: str
    version: int
    kind: str
    model: Any                       # kind-specific (see _decode)
    meta: Dict[str, Any]
    schema: Optional[FeatureSchema]  # from the artifact, when saved with one
    base_dir: Optional[str] = None   # registry root this was loaded from

    @property
    def params(self) -> Dict[str, Any]:
        return self.meta.get("params", {})

    @property
    def class_values(self) -> List[str]:
        return list(self.meta.get("class_values") or [])


def _tree_shas(trees_json: List[Any]) -> List[str]:
    """Per-tree content shas over the canonical (sorted-key, no-space)
    JSON form — the identity the JAX package's delta chain is keyed on."""
    return [hashlib.sha256(
        json.dumps(t, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()
        for t in trees_json]


def _pad_stacked_to(c_host, p_host):
    """Re-pad a child forest's stacked host arrays into the parent's
    ``(P, cmax)`` layout so delta slices align with a parent-layout
    resident.  Raises when the child cannot fit — a changed tree with more
    paths (or wider categorical sets) than the parent layout holds has no
    delta form; the serving tier then loads the full artifact."""
    lo, hi, num_r, cat_m, cat_r, cls_oh = c_host
    T, Pc, F = lo.shape
    cmax_c, Kc = cat_m.shape[3], cls_oh.shape[2]
    P, Fp = p_host[0].shape[1], p_host[0].shape[2]
    cmax, K = p_host[3].shape[3], p_host[5].shape[2]
    if F != Fp or Kc != K:
        raise ValueError("feature/class axis changed; patch slices "
                         "would not align")
    if Pc > P or cmax_c > cmax:
        raise ValueError(
            f"child outgrows the parent stacked layout "
            f"(P {Pc}>{P} or cmax {cmax_c}>{cmax}); no delta form")
    # stacked_host's own pad rows: never-match bounds, unrestricted
    # categoricals, vote-nothing one-hot
    nlo = np.full((T, P, F), np.inf, np.float32)
    nhi = np.full((T, P, F), -np.inf, np.float32)
    nnum = np.ones((T, P, F), dtype=bool)
    ncm = np.zeros((T, P, F, cmax), dtype=bool)
    ncr = np.zeros((T, P, F), dtype=bool)
    ncls = np.zeros((T, P, K), np.float32)
    nlo[:, :Pc], nhi[:, :Pc], nnum[:, :Pc] = lo, hi, num_r
    ncm[:, :Pc, :, :cmax_c] = cat_m
    ncr[:, :Pc], ncls[:, :Pc] = cat_r, cls_oh
    return nlo, nhi, nnum, ncm, ncr, ncls


def _detect_kind(model: Any) -> str:
    """The registry kind of a model object: a forest (a
    ``DecisionPathList`` or a list of them), a ``NaiveBayesModel``, or a
    logistic model's 1-D weight vector."""
    from ..models.bayes import NaiveBayesModel
    from ..models.tree import DecisionPathList
    if isinstance(model, NaiveBayesModel):
        return BAYES
    if isinstance(model, DecisionPathList) or (
            isinstance(model, (list, tuple)) and model
            and all(isinstance(m, DecisionPathList) for m in model)):
        return FOREST
    if isinstance(model, np.ndarray) and model.ndim == 1:
        return LOGISTIC
    raise NotImplementedError(
        f"publishing {type(model).__name__} is not ported to "
        f"avenir_tpu_torch yet (ported kinds: {FOREST!r}, a "
        f"DecisionPathList or a list of them, {BAYES!r}, a "
        f"NaiveBayesModel, and {LOGISTIC!r}, a 1-D weight array)")


def _encode(model: Any, kind: str, schema: Optional[FeatureSchema]
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any],
                       Optional[List[str]]]:
    """A model of a detected kind -> (arrays, model_json, class_values),
    as the JAX package encodes it: a forest's arrays are empty, a Naive
    Bayes model's are its tables with their dtypes (the ordinals and bin
    counts int64), a logistic model's its weights in their own dtype."""
    if kind == FOREST:
        from ..models.tree import DecisionPathList
        trees = [model] if isinstance(model, DecisionPathList) \
            else list(model)
        model_json = {"trees": [json.loads(t.to_json()) for t in trees]}
        cls = list(schema.class_attr_field.cardinality or []) if schema \
            else None
        return {}, model_json, cls
    if kind == LOGISTIC:
        cls = list(schema.class_attr_field.cardinality or []) if schema \
            else None
        return {"w": np.asarray(model)}, None, cls
    arrays = {
        "post_counts": np.asarray(model.post_counts),
        "class_counts": np.asarray(model.class_counts),
        "prior_counts": np.asarray(model.prior_counts),
        "cont_post_mean": np.asarray(model.cont_post_mean),
        "cont_post_std": np.asarray(model.cont_post_std),
        "cont_prior_mean": np.asarray(model.cont_prior_mean),
        "cont_prior_std": np.asarray(model.cont_prior_std),
        "binned_ordinals": np.asarray(model.binned_ordinals, np.int64),
        "cont_ordinals": np.asarray(model.cont_ordinals, np.int64),
        "num_bins": np.asarray(model.num_bins, np.int64),
    }
    return arrays, {"total": float(model.total)}, list(model.class_values)


def _decode(kind: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
            schema: Optional[FeatureSchema]) -> Any:
    if kind == FOREST:
        from ..models.tree import DecisionPathList
        return [DecisionPathList.from_json(json.dumps(t))
                for t in meta["model_json"]["trees"]]
    if kind == BAYES:
        from ..models.bayes import NaiveBayesModel
        if schema is None:
            raise ValueError("bayes artifact needs a schema (save one into "
                             "the artifact or pass schema= to load)")
        return NaiveBayesModel(
            schema=schema,
            class_values=list(meta.get("class_values") or []),
            binned_ordinals=[int(o) for o in arrays["binned_ordinals"]],
            cont_ordinals=[int(o) for o in arrays["cont_ordinals"]],
            num_bins=[int(b) for b in arrays["num_bins"]],
            post_counts=arrays["post_counts"],
            class_counts=arrays["class_counts"],
            prior_counts=arrays["prior_counts"],
            total=float(meta["model_json"]["total"]),
            cont_post_mean=arrays["cont_post_mean"],
            cont_post_std=arrays["cont_post_std"],
            cont_prior_mean=arrays["cont_prior_mean"],
            cont_prior_std=arrays["cont_prior_std"])
    if kind == LOGISTIC:
        return arrays["w"]
    raise NotImplementedError(
        f"model kind {kind!r} is not ported to avenir_tpu_torch yet "
        f"(ported: {FOREST!r}, {BAYES!r}, {LOGISTIC!r})")


class ModelRegistry:
    """Versioned model store over an ArtifactStore base directory."""

    def __init__(self, base_dir: str):
        self.store = ArtifactStore(base_dir)
        self.base_dir = self.store.base_dir

    def version_dir(self, name: str, version: int) -> str:
        return self.store.path(name, f"v_{version:06d}")

    def versions(self, name: str) -> List[int]:
        """All committed (renamed-into-place) version numbers, ascending.
        ``.tmp`` publishes in flight (or abandoned) are not versions."""
        d = self.store.path(name)
        if not os.path.isdir(d):
            return []
        out = []
        for entry in os.listdir(d):
            m = _VERSION_RE.match(entry)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def is_intact(self, name: str, version: int) -> bool:
        """True when the version's meta.json parses, declares a known kind,
        and every file in its manifest probes intact (npz zip directory
        opens, json parses, anything else exists non-empty)."""
        d = self.version_dir(name, version)
        try:
            with open(os.path.join(d, META_FILE)) as fh:
                meta = json.load(fh)
            if meta.get("kind") not in KINDS:
                return False
            for fname in meta.get("files") or [ARRAYS_FILE]:
                path = os.path.join(d, fname)
                if fname.endswith(".npz"):
                    with np.load(path) as z:
                        z.files
                elif fname.endswith(".json"):
                    with open(path) as fh:
                        json.load(fh)
                elif not (os.path.isfile(path)
                          and os.path.getsize(path) > 0):
                    return False
            return True
        except Exception:
            return False

    def latest_version(self, name: str) -> Optional[int]:
        """Newest INTACT version — a torn newest directory is skipped with
        a warning so a reload never serves a half-written model."""
        for v in reversed(self.versions(name)):
            if self.is_intact(name, v):
                return v
            warnings.warn(
                f"model {name!r} version {v} in {self.base_dir!r} is torn "
                f"or unreadable; skipping it for serving", RuntimeWarning)
        return None

    # ---- serving pin (the rollback surface) ----
    def _pin_path(self, name: str) -> str:
        return self.store.path(name, PIN_FILE)

    def pin_version(self, name: str, version: int) -> None:
        """Pin the version the serving tier resolves (tmp-then-rename, so
        readers see the old pin or the new one, never a torn file).
        Refuses a version that is not committed and intact — pinning a
        torn version would wedge every later hot-swap refresh."""
        if not self.is_intact(name, version):
            raise ValueError(
                f"refusing to pin model {name!r} version {version}: not a "
                f"committed intact version in {self.base_dir!r}")
        final = self._pin_path(name)
        tmp = final + f".tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"version": int(version),
                       "pinned_unix": time.time()}, fh)
        os.replace(tmp, final)
        instant("registry.pin", cat="registry", model=name,
                version=int(version))

    def clear_pin(self, name: str) -> None:
        """Back to newest-intact resolution (idempotent)."""
        try:
            os.remove(self._pin_path(name))
        except FileNotFoundError:
            return
        instant("registry.unpin", cat="registry", model=name)

    def pinned_version(self, name: str) -> Optional[int]:
        """The pinned version number, or None (no pin / unreadable pin — an
        unreadable pin file warns and reads as absent)."""
        try:
            with open(self._pin_path(name)) as fh:
                return int(json.load(fh)["version"])
        except FileNotFoundError:
            return None
        except Exception as exc:
            warnings.warn(
                f"model {name!r} serving pin in {self.base_dir!r} is "
                f"unreadable ({type(exc).__name__}: {exc}); falling back "
                f"to newest intact version", RuntimeWarning)
            return None

    def serving_version(self, name: str) -> Optional[int]:
        """THE version the serving tier should run: the pinned version when
        a pin exists and its target is intact, otherwise the newest intact
        version."""
        pin = self.pinned_version(name)
        if pin is not None:
            if self.is_intact(name, pin):
                return pin
            warnings.warn(
                f"model {name!r} pinned version {pin} in "
                f"{self.base_dir!r} is torn or missing; serving falls "
                f"back to the newest intact version", RuntimeWarning)
        return self.latest_version(name)

    # ---- retention ----
    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True        # exists, just not ours
        except OSError:
            return True        # unknown: err on the safe side

    def retire(self, name: str, keep_last: int = 3,
               dry_run: bool = False) -> List[int]:
        """Delete old versions: keep the newest ``keep_last`` committed
        versions plus, always, the pinned version, the resolved serving
        version, and the direct delta parent of any version a consumer can
        be told to load next (latest, pinned, serving) — residents on that
        parent are the ones a delta reload patches.  Abandoned ``.tmp``
        publishes and pin tmps are swept too, but only when the pid in
        their suffix is dead here and they are older than the grace
        period (``AVENIR_TPU_REGISTRY_TMP_GRACE_S``, default 3600 s: on a
        shared registry a remote publisher looks pid-dead locally).
        Returns the retired version numbers; ``dry_run`` computes the same
        list without deleting anything."""
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        versions = self.versions(name)
        keep = set(versions[-keep_last:])
        for protected in (self.pinned_version(name),
                          self.serving_version(name)):
            if protected is not None:
                keep.add(protected)
        all_v = set(versions)
        loadable = {v for v in (versions[-1] if versions else None,
                                self.pinned_version(name),
                                self.serving_version(name))
                    if v is not None}
        for v in loadable:
            info = self.delta_info(name, v)
            if not info:
                continue
            parent = int(info.get("parent_version", -1))
            if parent in all_v:
                keep.add(parent)
        retired = [v for v in versions if v not in keep]
        if dry_run:
            return retired
        for v in retired:
            shutil.rmtree(self.version_dir(name, v), ignore_errors=True)
        d = self.store.path(name)
        if os.path.isdir(d):
            now = time.time()
            for entry in os.listdir(d):
                m = _TMP_RE.match(entry)
                if not m or self._pid_alive(int(m.group(1))):
                    continue
                path = os.path.join(d, entry)
                try:
                    age = now - os.path.getmtime(path)
                except OSError:
                    continue
                if age < _TMP_GRACE_S:
                    continue
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    try:
                        os.remove(path)   # an orphaned pin tmp file
                    except OSError:
                        pass
        return retired

    def names(self) -> List[str]:
        """All model names with at least one committed version."""
        if not os.path.isdir(self.base_dir):
            return []
        return [entry for entry in sorted(os.listdir(self.base_dir))
                if os.path.isdir(os.path.join(self.base_dir, entry))
                and self.versions(entry)]

    def load(self, name: str, version: Optional[int] = None,
             schema: Optional[FeatureSchema] = None) -> LoadedModel:
        """Reconstruct a model (+ its schema when the artifact carries one).
        Default version: the newest intact one.  The artifact's dtype pins
        are enforced — a payload whose arrays do not match the dtypes
        recorded at publish time fails loudly."""
        if version is None:
            version = self.latest_version(name)
            if version is None:
                raise FileNotFoundError(
                    f"no intact versions of model {name!r} in "
                    f"{self.base_dir!r}")
        d = self.version_dir(name, version)
        with open(os.path.join(d, META_FILE)) as fh:
            meta = json.load(fh)
        with np.load(os.path.join(d, ARRAYS_FILE)) as z:
            arrays = {k: z[k] for k in z.files}
        actual = {k: str(v.dtype) for k, v in arrays.items()}
        declared = meta.get("dtypes", {})
        if declared != actual:
            raise ValueError(
                f"model {name!r} v{version}: array dtypes {actual} do not "
                f"match the artifact's declared {declared}")
        if schema is None and meta.get("schema") is not None:
            schema = FeatureSchema.from_dict(meta["schema"])
        kind = meta["kind"]
        return LoadedModel(name=name, version=version, kind=kind,
                           model=_decode(kind, arrays, meta, schema),
                           meta=meta,
                           schema=schema, base_dir=self.base_dir)

    def publish(self, name: str, model: Any, *,
                schema: Optional[FeatureSchema] = None,
                kind: Optional[str] = None,
                params: Optional[Dict[str, Any]] = None) -> int:
        """Write the model (a forest: a list of ``DecisionPathList``; a
        ``NaiveBayesModel``; or a logistic 1-D weight array) as the next
        version and atomically commit it;
        returns the version number.  ``meta.json`` and ``arrays.npz`` hold
        what the JAX package's ``publish`` writes for the same model (the
        JSON byte for byte, the arrays array for array), so either package
        loads the version."""
        detected = _detect_kind(model)
        if kind is not None and kind != detected:
            raise ValueError(f"publish kind {kind!r} does not match the "
                             f"model's kind {detected!r}")
        kind = detected
        arrays, model_json, class_values = _encode(model, kind, schema)
        versions = self.versions(name)
        version = (versions[-1] + 1) if versions else 1
        final = self.version_dir(name, version)
        # single publisher per model name is the contract; the pid suffix
        # keeps an abandoned .tmp of a dead publisher out of the way
        tmp = final + f".tmp.{os.getpid()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {
            "format_version": FORMAT_VERSION,
            "name": name,
            "version": version,
            "kind": kind,
            "class_values": class_values,
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "params": dict(params or {}),
            "model_json": model_json,
            "schema": schema.to_dict() if schema is not None else None,
            # manifest of payload files the intactness probe covers
            "files": [ARRAYS_FILE],
        }
        if kind == FOREST:
            meta["tree_shas"] = _tree_shas(model_json["trees"])
        def write_arrays():
            fault_point("registry_publish")
            np.savez(os.path.join(tmp, ARRAYS_FILE), **arrays)
        with_retry(write_arrays, what=f"registry publish {name} v{version}")
        write_json(os.path.join(tmp, META_FILE), meta)
        os.replace(tmp, final)
        instant("registry.publish", cat="registry", model=name,
                version=version, kind=kind)
        return version

    # ---- delta distribution ----
    def publish_delta(self, name: str, model: Any, *,
                      parent_version: int,
                      schema: Optional[FeatureSchema] = None,
                      params: Optional[Dict[str, Any]] = None) -> int:
        """Publish a forest as the next version PLUS a ``delta.npz`` /
        ``delta.json`` sidecar pair holding only the trees that changed
        against ``parent_version``.  The FULL artifact is always written
        first (the delta is an overlay, never the only copy), and the
        sidecar attach is best-effort: any incompatibility — parent torn
        or retired, member count or class vocabulary changed, a changed
        tree outgrowing the parent's stacked layout (smaller layouts
        re-pad) — warns and leaves the plain full publish.  Returns the
        new version number either way."""
        params = dict(params or {})
        params["delta_parent"] = int(parent_version)
        version = self.publish(name, model, schema=schema, params=params)
        try:
            self._attach_delta(name, version, int(parent_version))
        except Exception as exc:
            warnings.warn(
                f"model {name!r} v{version}: delta sidecar against "
                f"parent v{parent_version} not attached "
                f"({type(exc).__name__}: {exc}); consumers will load "
                f"the full artifact", RuntimeWarning)
        return version

    def _attach_delta(self, name: str, version: int,
                      parent_version: int) -> None:
        """Compute and attach the delta sidecars (raises on any layout or
        chain mismatch — publish_delta turns that into a warning).  The
        stacked forms are built on the host (``device="cpu"``)."""
        import io
        from ..models.forest import EnsembleModel
        from ..models.tree import DecisionTreeModel
        if not self.is_intact(name, parent_version):
            raise ValueError(f"parent v{parent_version} is not intact")
        child = self.load(name, version)
        parent = self.load(name, parent_version)
        if child.kind != FOREST or parent.kind != FOREST:
            raise ValueError("delta publish is forest-only")
        child_shas = list(child.meta.get("tree_shas") or [])
        parent_shas = list(parent.meta.get("tree_shas") or [])
        if not child_shas or not parent_shas:
            raise ValueError("parent predates per-tree shas")
        if len(child_shas) != len(parent_shas):
            raise ValueError(
                f"member count changed ({len(parent_shas)} -> "
                f"{len(child_shas)}); no delta form exists")
        if child.schema is None:
            raise ValueError("forest artifact has no embedded schema")

        def host_form(loaded):
            models = [DecisionTreeModel(pl, loaded.schema, device="cpu")
                      for pl in loaded.model]
            ens = EnsembleModel(
                models, weights=loaded.params.get("weights"),
                min_odds_ratio=float(
                    loaded.params.get("min_odds_ratio", 1.0)),
                require_odd=False, stack=False, device="cpu")
            return ens, ens.stacked_host()
        c_ens, c_host = host_form(child)
        p_ens, p_host = host_form(parent)
        if c_host is None or p_host is None:
            raise ValueError("no stacked device form (degenerate member "
                             "or non-f32-exact bounds)")
        if c_ens.classes != p_ens.classes:
            raise ValueError("class vocabulary changed")
        if any(c.shape[1:] != q.shape[1:]
               for c, q in zip(c_host, p_host)):
            # each tree's slot is laid out on its own (sentinel at its own
            # path count, never-match rows after), so re-padding the child
            # to the parent's (P, cmax) is exact
            c_host = _pad_stacked_to(c_host, p_host)
        changed = [i for i, (cs, ps) in
                   enumerate(zip(child_shas, parent_shas)) if cs != ps]
        lo, hi, num_r, cat_m, cat_r, cls_oh = c_host
        idx = np.asarray(changed, np.int32)
        buf = io.BytesIO()
        np.savez(buf, idx=idx, lo=lo[idx], hi=hi[idx], num_r=num_r[idx],
                 cat_m=cat_m[idx], cat_r=cat_r[idx], cls_oh=cls_oh[idx],
                 wvec=np.asarray(c_ens.weights, np.float32))
        trees = child.meta["model_json"]["trees"]
        dmeta = {
            "format": DELTA_FORMAT_VERSION,
            "parent_version": int(parent_version),
            "parent_tree_shas": parent_shas,
            "tree_shas": child_shas,
            "classes": list(c_ens.classes),
            "n_trees": len(child_shas),
            "changed": [int(i) for i in changed],
            "changed_trees": [trees[i] for i in changed],
            "stacked_shape": {"P": int(lo.shape[1]),
                              "F": int(lo.shape[2]),
                              "cmax": int(cat_m.shape[3]),
                              "K": int(cls_oh.shape[2])},
        }
        self.add_sidecar(name, version, {
            DELTA_NPZ: buf.getvalue(),
            DELTA_JSON: json.dumps(dmeta).encode(),
        })
        instant("registry.delta_publish", cat="registry", model=name,
                version=version, parent=int(parent_version),
                changed=len(changed), total=len(child_shas))

    def delta_info(self, name: str, version: int) -> Optional[Dict]:
        """The parsed ``delta.json`` sidecar, or None when the version
        carries no (readable) delta — absence means a full load, never an
        error."""
        try:
            return json.loads(
                self.read_sidecar(name, version, DELTA_JSON))
        except FileNotFoundError:
            return None
        except Exception as exc:
            warnings.warn(
                f"model {name!r} v{version}: delta sidecar unreadable "
                f"({type(exc).__name__}: {exc}); treating as absent",
                RuntimeWarning)
            return None

    def load_delta(self, name: str, version: int
                   ) -> Tuple[Dict, Dict[str, np.ndarray]]:
        """(delta meta, delta arrays) of a version published with a delta
        sidecar; FileNotFoundError when it has none."""
        import io
        dmeta = json.loads(self.read_sidecar(name, version, DELTA_JSON))
        with np.load(io.BytesIO(
                self.read_sidecar(name, version, DELTA_NPZ))) as z:
            arrays = {k: z[k] for k in z.files}
        return dmeta, arrays

    # ---- sidecars ----
    def add_sidecar(self, name: str, version: int,
                    files: Dict[str, bytes]) -> None:
        """Attach extra payload files to a COMMITTED version and extend its
        meta.json manifest, crash-safely: every sidecar file writes
        ``<file>.tmp.<pid>`` and renames into place BEFORE the manifest
        update (itself tmp-then-rename), so a crash at any point leaves the
        version either intact-without-sidecar or intact-with.  The manifest
        is rewritten as the JAX package rewrites it (``json.dump``, indent
        2), so a version with sidecars keeps byte-identical ``meta.json``."""
        if not files:
            return
        d = self.version_dir(name, version)
        meta_path = os.path.join(d, META_FILE)
        with open(meta_path) as fh:
            meta = json.load(fh)
        reserved = {META_FILE, ARRAYS_FILE}
        for fname, payload in files.items():
            if os.path.basename(fname) != fname or fname in reserved:
                raise ValueError(f"bad sidecar file name {fname!r}")
            final = os.path.join(d, fname)
            tmp = final + f".tmp.{os.getpid()}"

            def write(tmp=tmp, final=final, payload=payload):
                fault_point("registry_sidecar")
                with open(tmp, "wb") as fh:
                    fh.write(payload)
                os.replace(tmp, final)
            with_retry(write,
                       what=f"sidecar write {name} v{version} {fname}")
        manifest = list(meta.get("files") or [ARRAYS_FILE])
        manifest.extend(f for f in files if f not in manifest)
        meta["files"] = manifest
        tmp_meta = meta_path + f".tmp.{os.getpid()}"
        with open(tmp_meta, "w") as fh:
            json.dump(meta, fh, indent=2)
        os.replace(tmp_meta, meta_path)

    def read_sidecar(self, name: str, version: int, fname: str) -> bytes:
        """Read one sidecar payload; FileNotFoundError when the version does
        not carry it (not listed in the manifest)."""
        d = self.version_dir(name, version)
        with open(os.path.join(d, META_FILE)) as fh:
            meta = json.load(fh)
        if fname not in (meta.get("files") or []):
            raise FileNotFoundError(
                f"model {name!r} v{version} has no sidecar {fname!r}")
        with open(os.path.join(d, fname), "rb") as fh:
            return fh.read()


def save_model(base_dir: str, name: str, model: Any, *,
               schema: Optional[FeatureSchema] = None,
               kind: Optional[str] = None,
               params: Optional[Dict[str, Any]] = None) -> int:
    return ModelRegistry(base_dir).publish(name, model, schema=schema,
                                           kind=kind, params=params)


def load_model(base_dir: str, name: str, version: Optional[int] = None,
               schema: Optional[FeatureSchema] = None) -> LoadedModel:
    return ModelRegistry(base_dir).load(name, version, schema=schema)
