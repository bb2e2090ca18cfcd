"""Model registry: port of ``avenir_tpu/serving/registry.py`` for the
``forest`` and ``bayes`` kinds — reading versions and publishing them.

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
total in ``meta.json``.  Deltas, writing pins, retention and the
``logistic`` and ``mlp`` kinds are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.artifacts import ArtifactStore, write_json
from ..core.faults import with_retry
from ..core.schema import FeatureSchema

FOREST = "forest"
BAYES = "bayes"
LOGISTIC = "logistic"
MLP = "mlp"
KINDS = (FOREST, BAYES, LOGISTIC, MLP)

META_FILE = "meta.json"
ARRAYS_FILE = "arrays.npz"
PIN_FILE = "serving.json"
FORMAT_VERSION = 1

_VERSION_RE = re.compile(r"^v_(\d{6})$")


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


def _tree_shas(trees_json: List[Any]) -> List[str]:
    """Per-tree content shas over the canonical (sorted-key, no-space)
    JSON form — the identity the JAX package's delta chain is keyed on."""
    return [hashlib.sha256(
        json.dumps(t, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()
        for t in trees_json]


def _detect_kind(model: Any) -> str:
    """The registry kind of a model object: a forest (a
    ``DecisionPathList`` or a list of them) or a ``NaiveBayesModel``."""
    from ..models.bayes import NaiveBayesModel
    from ..models.tree import DecisionPathList
    if isinstance(model, NaiveBayesModel):
        return BAYES
    if isinstance(model, DecisionPathList) or (
            isinstance(model, (list, tuple)) and model
            and all(isinstance(m, DecisionPathList) for m in model)):
        return FOREST
    raise NotImplementedError(
        f"publishing {type(model).__name__} is not ported to "
        f"avenir_tpu_torch yet (ported kinds: {FOREST!r}, a "
        f"DecisionPathList or a list of them, and {BAYES!r}, a "
        f"NaiveBayesModel)")


def _encode(model: Any, kind: str, schema: Optional[FeatureSchema]
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any],
                       Optional[List[str]]]:
    """A model of a detected kind -> (arrays, model_json, class_values),
    as the JAX package encodes it: a forest's arrays are empty, a Naive
    Bayes model's are its tables with their dtypes (the ordinals and bin
    counts int64)."""
    if kind == FOREST:
        from ..models.tree import DecisionPathList
        trees = [model] if isinstance(model, DecisionPathList) \
            else list(model)
        model_json = {"trees": [json.loads(t.to_json()) for t in trees]}
        cls = list(schema.class_attr_field.cardinality or []) if schema \
            else None
        return {}, model_json, cls
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
    raise NotImplementedError(
        f"model kind {kind!r} is not ported to avenir_tpu_torch yet "
        f"(ported: {FOREST!r}, {BAYES!r})")


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

    def pinned_version(self, name: str) -> Optional[int]:
        """The pinned version number, or None (no pin / unreadable pin — an
        unreadable pin file warns and reads as absent)."""
        try:
            with open(self.store.path(name, PIN_FILE)) as fh:
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
                schema: Optional[FeatureSchema] = None) -> int:
        """Write the model (a forest: a list of ``DecisionPathList``; or a
        ``NaiveBayesModel``) as the next version and atomically commit it;
        returns the version number.  ``meta.json`` and ``arrays.npz`` hold
        what the JAX package's ``publish`` writes for the same model (the
        JSON byte for byte, the arrays array for array), so either package
        loads the version."""
        kind = _detect_kind(model)
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
            "params": {},
            "model_json": model_json,
            "schema": schema.to_dict() if schema is not None else None,
            # manifest of payload files the intactness probe covers
            "files": [ARRAYS_FILE],
        }
        if kind == FOREST:
            meta["tree_shas"] = _tree_shas(model_json["trees"])
        with_retry(lambda: np.savez(os.path.join(tmp, ARRAYS_FILE), **arrays),
                   what=f"registry publish {name} v{version}")
        write_json(os.path.join(tmp, META_FILE), meta)
        os.replace(tmp, final)
        return version

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
