"""Weight carry-over: the JAX package's forests as the port's.

A forest's "weights" are its trees.  The JAX package stores them as
``DecisionPathList`` JSON — ``tree_<i>.json`` files from the
``randomForestBuilder`` job, or the ``model_json`` of a registry version's
``meta.json`` — and, on the device, as the stacked predicate arrays
``(lo, hi, num_r, cat_m, cat_r, cls_oh)`` that ``EnsembleModel.stacked_host()``
returns, plus the member weight vector ``wvec``.  Both forms load here:
the JSON into the port's ``DecisionPathList`` objects, the arrays into a
``VoteModel`` on the chosen device in the layout the vote kernel takes.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence

import numpy as np

from .kernels.vote import VoteModel, prepare_vote_model
from .models.tree import DecisionPathList
from .runtime import resolve_device

_TREE_FILE = re.compile(r"tree_(\d+)\.json")


def tree_files(model_dir: str) -> List[str]:
    """The forest builder's ``tree_<i>.json`` names in ``model_dir``, in
    numeric order."""
    matches = [(int(m.group(1)), f) for f in os.listdir(model_dir)
               if (m := _TREE_FILE.fullmatch(f))]
    return [f for _, f in sorted(matches)]


def load_tree_files(paths: Sequence[str]) -> List[DecisionPathList]:
    """Tree JSON files -> path lists (the modelPredictor input)."""
    out = []
    for p in paths:
        with open(p) as fh:
            out.append(DecisionPathList.from_json(fh.read()))
    return out


def load_model_dir(model_dir: str) -> List[DecisionPathList]:
    names = tree_files(model_dir)
    if not names:
        raise FileNotFoundError(f"no tree_<i>.json models in {model_dir!r}")
    return load_tree_files([os.path.join(model_dir, n) for n in names])


def from_model_json(model_json) -> List[DecisionPathList]:
    """A registry ``meta.json`` ``model_json`` object (``{"trees": [...]}``,
    or the whole meta dict, or a path to ``meta.json``) -> path lists."""
    if isinstance(model_json, str):
        with open(model_json) as fh:
            model_json = json.load(fh)
    if "model_json" in model_json:
        model_json = model_json["model_json"]
    return [DecisionPathList.from_json(json.dumps(t))
            for t in model_json["trees"]]


def vote_model_from_stacked(stacked, weights: Optional[Sequence[float]] = None,
                            device=None) -> VoteModel:
    """``stacked_host()`` arrays — six, with ``weights`` (default all 1.0),
    or seven with ``wvec`` last — -> a :class:`VoteModel` on ``device``
    (default: the process device, ``cuda`` unless asked otherwise)."""
    arrays = [np.asarray(a) for a in stacked]
    if len(arrays) == 7:
        if weights is not None:
            raise ValueError("pass wvec inside stacked or as weights, "
                             "not both")
        *arrays, wvec = arrays
    elif len(arrays) == 6:
        T = arrays[0].shape[0]
        wvec = np.asarray(weights if weights is not None else [1.0] * T,
                          np.float32)
    else:
        raise ValueError(f"expected 6 or 7 stacked arrays, got {len(arrays)}")
    return prepare_vote_model(*arrays, wvec, resolve_device(device))
