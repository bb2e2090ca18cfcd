"""Job registry: the ``hadoop jar avenir.jar <ClassName> -Dconf.path=... in
out`` entry points, ported job by job from ``avenir_tpu/cli/jobs.py``.

Every reference job class name (and a short camelCase alias) maps to a
Python job function ``job(config, in_path, out_path) -> Counters``.  A job
name that is not ported yet raises :class:`JobNotPorted`; nothing here
dispatches to the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..core.schema import FeatureSchema
from ..core.table import _make_splitter, load_csv

JOBS: Dict[str, Callable] = {}


class JobNotPorted(KeyError):
    """The job exists in the reference but not (yet) in the port."""


def register(*names: str):
    def deco(fn):
        for n in names:
            JOBS[n] = fn
        return fn
    return deco


def resolve(name: str) -> Callable:
    if name in JOBS:
        return JOBS[name]
    # allow bare class name for fully-qualified registrations
    for k, v in JOBS.items():
        if k.split(".")[-1] == name:
            return v
    raise JobNotPorted(
        f"job {name!r} is not ported to avenir_tpu_torch yet; ported jobs: "
        f"{sorted(JOBS)}")


def _schema_path(cfg: Config, key: str) -> FeatureSchema:
    return FeatureSchema.load(cfg.must_get(key))


def _splitter(delim_regex: str):
    """Line splitter honoring field.delim.regex semantics."""
    return _make_splitter(delim_regex)


@register("org.avenir.model.ModelPredictor", "modelPredictor")
def model_predictor_job(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Generic map-only predictor (model/ModelPredictor.java:46-82): loads N
    decision-path model files (mop.model.dir.path + mop.model.file.names,
    default the forest builder's tree_<i>.json files) and predicts via single
    model or weighted ensemble vote (mop.ensemble.memeber.weights —
    reference key name, typo included)."""
    from ..models.forest import model_predictor
    from ..weights import load_tree_files, tree_files
    counters = Counters()
    schema = _schema_path(cfg, "mop.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex, keep_raw=True)
    model_dir = cfg.get("mop.model.dir.path", "")
    names = cfg.get_list("mop.model.file.names")
    if not names:
        if not model_dir:
            cfg.must_get_list("mop.model.file.names")  # raise with key name
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"model dir {model_dir!r} not found")
        names = tree_files(model_dir)
        if not names:
            raise FileNotFoundError(
                f"no tree_<i>.json models in {model_dir!r}; set "
                "mop.model.file.names explicitly for other layouts")
    path_lists = load_tree_files(
        [os.path.join(model_dir, nm) if model_dir else nm for nm in names])
    output_mode = cfg.get("mop.output.mode", "withRecord")
    # per-mode mandatory ordinals (ModelPredictor.java:165-172); error
    # counting also requires the class ordinal (:116)
    error_counting = cfg.get_boolean("mop.error.counting.enabled", False)
    class_ord = None
    if output_mode == "withActualClassAttr" or error_counting:
        class_ord = cfg.must_get_int(
            "mop.rec.class.attr.ordinal",
            "missing class attribute ordinal") if \
            "mop.rec.class.attr.ordinal" in cfg else \
            cfg.must_get_int("mop.class.attr.ord",
                             "missing class attribute ordinal")
    id_ord = cfg.get_int("mop.rec.id.ordinal", 0) \
        if output_mode != "withKId" else \
        cfg.must_get_int("mop.rec.id.ordinal", "missing id ordinal")
    lines = model_predictor(
        table, schema, path_lists,
        output_mode=output_mode,
        id_ordinal=id_ord,
        class_attr_ordinal=class_ord,
        error_counting=error_counting,
        weights=cfg.get_float_list("mop.ensemble.memeber.weights"),
        min_odds_ratio=cfg.get_float("mop.min.odds.ratio", 1.0),
        out_delim=cfg.field_delim_out, counters=counters)
    artifacts.write_text_output(out_path, lines, role="m")
    return counters
