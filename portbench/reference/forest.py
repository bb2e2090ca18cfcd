"""Plain random forest over a call-centre table: avenir's tree semantics
(tree/DecisionTreeBuilder.java, model/EnsemblePredictiveModel.java) written
out once more, in numpy and plain torch, for the benchmark's check.

It imports nothing of the program.  It takes the raw columns the benchmark
drew and the job's settings, and derives everything else itself: the
candidate splits from the schema, every row's branch under every split,
the bootstrap counts and the random attribute and split choices from the
build's seed, each level's counts, and the gini choice.

Random streams (what "the same seed" means in avenir's port): tree ``t``
of a build seeded ``s`` draws with seed ``s + 1000 (t + 1)``; its
bootstrap is ``numpy.random.default_rng(seed).integers(0, n, m)`` with
``m = int(n * rate / 100)``, counted per row; its attribute samples and
its pick among the top splits come, node by node in frontier order, from
``random.Random(seed)`` (``sample`` then ``choice``).

``dtype`` is the precision of the split choice: float64 as the
configuration states, float32 for the control.
"""

from __future__ import annotations

import itertools
import random
from typing import Dict, List, Sequence

import numpy as np
import torch


def _partitions(items: Sequence[str], groups: int) -> List[List[List[str]]]:
    """The partitions of ``items`` into exactly ``groups`` non-empty
    groups, as restricted growth strings in lexicographic order."""
    out = []
    for rgs in itertools.product(range(groups), repeat=len(items)):
        if rgs[0] != 0 or max(rgs) != groups - 1:
            continue
        if any(rgs[i] > max(rgs[:i]) + 1 for i in range(1, len(rgs))):
            continue
        out.append([[items[i] for i in range(len(items)) if rgs[i] == g]
                    for g in range(groups)])
    return out


def candidate_splits(schema: dict) -> List[dict]:
    """Every candidate split of the schema's feature fields, in field order:
    ``attr``, ``preds`` (the predicate string of each branch) and either
    ``groups`` (categorical: the values of each branch) or ``thresholds``
    (integer fields: branch ``i`` holds ``t[i-1] < x <= t[i]``)."""
    out = []
    for f in sorted(schema["fields"], key=lambda f: f["ordinal"]):
        if not f.get("feature"):
            continue
        o, max_split = f["ordinal"], f.get("maxSplit") or 2
        if f["dataType"] == "categorical":
            card = [str(c) for c in f["cardinality"]]
            for g in range(2, max_split + 1):
                for groups in _partitions(card, g):
                    out.append({"attr": o, "groups": groups, "preds": [
                        f"{o} in {':'.join(grp)}" for grp in groups]})
            continue
        if f["dataType"] != "int":
            raise ValueError(f"field {f['name']}: only int and categorical "
                             "features are written out here")
        lo, hi = float(f["min"]), float(f["max"])
        step = float(f.get("splitScanInterval") or 0)
        if step <= 0 or int((hi - lo) / step) == 0:
            step = (hi - lo) / 2
        points, p = [], lo + step
        while p < hi:
            points.append(int(p))
            p += step
        for k in range(1, max(1, max_split - 1) + 1):
            for ts in itertools.combinations(points, k):
                preds = [f"{o} le {ts[0]}"] + [
                    f"{o} le {ts[i]} {ts[i - 1]}" for i in range(1, k)] + [
                    f"{o} gt {ts[-1]}"]
                out.append({"attr": o, "thresholds": list(ts),
                            "preds": preds})
    return out


def branch_codes(splits: List[dict], schema: dict, cols: Dict[int, np.ndarray],
                 device) -> torch.Tensor:
    """(n, S) int64 branch of every row under every split, on ``device``.
    ``cols`` maps each feature ordinal to its raw values: category codes
    into the field's cardinality, or integers."""
    fields = {f["ordinal"]: f for f in schema["fields"]}
    out = []
    for s in splits:
        x = torch.as_tensor(np.asarray(cols[s["attr"]]), device=device)
        if "groups" in s:
            card = [str(c) for c in fields[s["attr"]]["cardinality"]]
            table = torch.zeros(len(card), dtype=torch.int64, device=device)
            for g, grp in enumerate(s["groups"]):
                for v in grp:
                    table[card.index(v)] = g
            out.append(table[x.long()])
        else:
            t = torch.as_tensor(s["thresholds"], dtype=torch.int64,
                                device=device)
            out.append((x.long()[:, None] > t[None, :]).sum(dim=1))
    return torch.stack(out, dim=1)


def gini(counts: np.ndarray) -> np.ndarray:
    """Gini impurity along the last axis: ``1 - sum p^2``."""
    total = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(total, 1e-12)
    return 1.0 - (p * p).sum(axis=-1)


def _draw_weights(n: int, rate: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = int(n * rate / 100.0)
    return np.bincount(rng.integers(0, n, size=m), minlength=n)


def build_tree(codes: torch.Tensor, cls: torch.Tensor, splits: List[dict],
               classes: Sequence[str], settings: dict, seed: int,
               dtype=np.float64) -> List[dict]:
    """One tree of the forest: its decision paths as dicts of the model
    file's fields (``predicates`` as predicate strings, ``population``,
    ``stopped``, ``infoContent``, ``classValPr``), in the model file's
    order.  ``codes`` (n, S) and ``cls`` (n,) are on one device."""
    dev = codes.device
    n, S = codes.shape
    B = max(len(s["preds"]) for s in splits)
    C = len(classes)
    max_depth = int(settings["dtb.max.depth.limit"])
    set_size = int(settings["dtb.random.split.set.size"])
    top_n = int(settings["dtb.top.split.count"])
    if (settings["dtb.split.algorithm"] != "giniIndex"
            or settings["dtb.split.attribute.selection.strategy"]
            != "randomNotUsedYet"
            or settings["dtb.split.select.strategy"] != "randomAmongTop"
            or settings["dtb.sub.sampling.strategy"] != "withReplace"
            or settings["dtb.path.stopping.strategy"] != "maxDepth"):
        raise ValueError("the plain forest writes out the rafo settings "
                         "only")
    w = torch.as_tensor(_draw_weights(n, float(settings[
        "dtb.sub.sampling.rate"]), seed), dtype=torch.float64, device=dev)
    pyrng = random.Random(seed)
    attrs = list(dict.fromkeys(s["attr"] for s in splits))
    by_attr = {a: [i for i, s in enumerate(splits) if s["attr"] == a]
               for a in attrs}

    root = torch.bincount(cls, weights=w, minlength=C).cpu().numpy()
    root = root.astype(dtype)
    pop = root.sum()
    leaves = [{"preds": ["$root"], "used": set(), "info": gini(root),
               "pop": pop, "pr": root / max(pop, 1e-12), "stopped": False}]
    paths: List[dict] = []
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    split_ix = torch.arange(S, device=dev)[None, :]
    for level in range(max_depth):
        active = [l for l in leaves if not l["stopped"]]
        if not active:
            break
        N = len(active)
        live = node >= 0
        key = ((node[:, None] * S + split_ix) * B + codes) * C + cls[:, None]
        hist = torch.bincount(key[live].reshape(-1),
                              weights=w[live].repeat_interleave(S),
                              minlength=N * S * B * C)
        counts = hist.reshape(N, S, B, C).cpu().numpy().astype(dtype)
        chosen = np.full(N, -1, np.int64)
        child = np.full((N, B), -1, np.int64)
        leaves = []
        for i, leaf in enumerate(active):
            cand = [a for a in attrs if a not in leaf["used"]] or attrs
            picked = pyrng.sample(cand, min(set_size, len(cand)))
            cand_splits = [si for a in picked for si in by_attr[a]]
            c = counts[i]
            br_tot = c.sum(axis=2)
            weighted = (gini(c) * br_tot).sum(axis=1) \
                / np.maximum(br_tot.sum(axis=1), 1e-12)
            order = sorted(cand_splits, key=lambda si: weighted[si])
            s = pyrng.choice(order[:max(1, top_n)])
            chosen[i] = s
            for b, pred in enumerate(splits[s]["preds"]):
                bpop = br_tot[s, b]
                if bpop <= 0:
                    continue
                kid = {"preds": leaf["preds"] + [pred],
                       "used": leaf["used"] | {splits[s]["attr"]},
                       "info": gini(c[s, b]), "pop": bpop,
                       "pr": c[s, b] / bpop,
                       "stopped": level + 1 >= max_depth}
                if kid["stopped"]:
                    paths.append(kid)
                else:
                    child[i, b] = len(leaves)
                    leaves.append(kid)
        if not leaves:
            break
        sel = torch.as_tensor(chosen, device=dev)
        tab = torch.as_tensor(child, device=dev)
        safe = node.clamp(min=0)
        br = codes.gather(1, sel[safe][:, None])[:, 0]
        node = torch.where(node >= 0, tab[safe, br], node)
    paths.extend(leaves)
    if not paths:
        paths = [{"preds": ["$root"], "info": gini(root), "pop": pop,
                  "pr": root / max(pop, 1e-12)}]
    return [{"predicates": p["preds"], "population": int(round(float(p["pop"]))),
             "stopped": True, "infoContent": float(p["info"]),
             "classValPr": {cv: float(p["pr"][j])
                            for j, cv in enumerate(classes)}}
            for p in paths]


def tree_seed(build_seed: int, t: int) -> int:
    return build_seed + 1000 * (t + 1)


def build_forest(codes: torch.Tensor, cls: torch.Tensor, splits: List[dict],
                 classes: Sequence[str], settings: dict, build_seed: int,
                 dtype=np.float64) -> List[List[dict]]:
    """Every tree of one build seeded ``build_seed``."""
    return [build_tree(codes, cls, splits, classes, settings,
                       tree_seed(build_seed, t), dtype)
            for t in range(int(settings["dtb.num.trees"]))]


# --------------------------------------------------------------------------
# scoring (model/ModelPredictor.java, EnsemblePredictiveModel.java)
# --------------------------------------------------------------------------

def _bf16(a) -> np.ndarray:
    """float64 values rounded to bfloat16."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


def _matches(pred: str, cols: Dict[int, np.ndarray], card: Dict[int, list],
             bfloat16: bool) -> np.ndarray:
    parts = pred.split(" ")
    attr, op = int(parts[0]), parts[1]
    x = cols[attr]
    if op == "in":
        allowed = [card[attr].index(v) for v in parts[2].split(":")]
        return np.isin(x, allowed)
    rnd = _bf16 if bfloat16 else (lambda a: np.asarray(a, np.float64))
    xv = rnd(x)
    if op == "gt":
        return xv > rnd(float(parts[2]))
    ok = xv <= rnd(float(parts[2]))
    if len(parts) > 3:
        ok &= xv > rnd(float(parts[3]))
    return ok


def predict(trees: List[List[dict]], schema: dict,
            cols: Dict[int, np.ndarray], bfloat16: bool = False
            ) -> np.ndarray:
    """(n,) predicted class of each row under the forest's unweighted
    majority vote: each tree votes the most probable class of the first
    path the row satisfies, or its population-weighted most probable
    class where none holds the row.  ``bfloat16`` rounds values and thresholds to
    bfloat16 before they are compared (the control)."""
    card = {f["ordinal"]: [str(c) for c in f["cardinality"]]
            for f in schema["fields"] if f["dataType"] == "categorical"}
    n = len(next(iter(cols.values())))
    classes = sorted({c for tree in trees for p in tree
                      for c in p["classValPr"]})
    votes = np.zeros((n, len(classes)), np.int64)
    for tree in trees:
        vote = np.full(n, -1, np.int64)
        for p in tree:
            ok = vote < 0
            for pred in p["predicates"]:
                if pred != "$root":
                    ok &= _matches(pred, cols, card, bfloat16)
            best = max(p["classValPr"].items(), key=lambda kv: kv[1])[0]
            vote[ok] = classes.index(best)
        # a row no path holds (a branch the training rows left empty)
        # takes the tree's population-weighted most probable class
        agg: Dict[str, float] = {}
        for p in tree:
            for cv, pr in p["classValPr"].items():
                agg[cv] = agg.get(cv, 0.0) + pr * p["population"]
        vote[vote < 0] = classes.index(max(agg.items(),
                                           key=lambda kv: kv[1])[0])
        votes[np.arange(n), vote] += 1
    return np.asarray(classes)[np.argmax(votes, axis=1)]


def _predicate_fields(pred: str) -> dict:
    """One predicate string as the model file's predicate object."""
    if pred == "$root":
        return {"attribute": 0, "predicateStr": pred, "operator": None,
                "valueInt": 0, "valueDbl": 0.0, "categoricalValues": None,
                "otherBoundInt": None, "otherBoundDbl": None}
    parts = pred.split(" ")
    out = {"attribute": int(parts[0]), "predicateStr": pred,
           "operator": parts[1], "valueInt": 0, "valueDbl": 0.0,
           "categoricalValues": None, "otherBoundInt": None,
           "otherBoundDbl": None}
    if parts[1] == "in":
        out["categoricalValues"] = parts[2].split(":")
    else:
        out["valueInt"] = int(parts[2])
        if len(parts) > 3:
            out["otherBoundInt"] = int(parts[3])
    return out


def model_json(tree: List[dict]) -> str:
    """A tree as ``randomForestBuilder``'s ``tree_<i>.json`` model file
    (tree/DecisionPathList.java's Jackson layout), which modelPredictor
    reads."""
    import json
    return json.dumps({"decisionPaths": [{
        "stopped": p["stopped"], "classValPr": p["classValPr"],
        "infoContent": p["infoContent"],
        "predicates": [_predicate_fields(q) for q in p["predicates"]],
        "population": p["population"]} for p in tree]}, indent=3)


def compare_trees(got: List[str], want: List[List[dict]]) -> dict:
    """The trees of one build as model files (``got``) against the plain
    forest's: ``tree_mismatch`` counts trees whose paths differ in order,
    predicates, population or stopping; ``prob_gap`` is the widest gap of
    an info content or class probability in the trees that match."""
    import json
    mismatch, gap = 0, 0.0
    if len(got) != len(want):
        return {"tree_mismatch": float(max(len(got), len(want))),
                "prob_gap": 0.0}
    for text, tree in zip(got, want):
        paths = json.loads(text)["decisionPaths"]
        shape = [([q["predicateStr"] for q in p["predicates"]],
                  p["population"], p["stopped"]) for p in paths]
        if shape != [(p["predicates"], p["population"], p["stopped"])
                     for p in tree]:
            mismatch += 1
            continue
        for p, q in zip(paths, tree):
            if set(p["classValPr"]) != set(q["classValPr"]):
                mismatch += 1
                break
            gap = max(gap, abs(p["infoContent"] - q["infoContent"]),
                      *(abs(p["classValPr"][c] - v)
                        for c, v in q["classValPr"].items()))
    return {"tree_mismatch": float(mismatch), "prob_gap": float(gap)}
