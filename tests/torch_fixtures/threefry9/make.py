"""Make the threefry9 fixture with ``jax.random`` on the CPU: the draws
the port's twin (``avenir_tpu_torch/utils/threefry.py``) is held to where
JAX cannot run (``chip_smoke.py`` on the GPU).

JAX 0.9.0 with ``jax_threefry_partitionable=True`` and the
``threefry2x32`` implementation; :func:`make` refuses to run under any
other setting.  ``CASES`` lists every case as plain data (a name, a
function of ``jax.random``, a seed and its arguments): keys from
``PRNGKey`` (signed, unsigned and 32-bit-wrapping seeds), ``split``,
``fold_in``, 32-bit ``bits``, ``uniform`` (also on [-3.7, 5.1)),
``normal``, ``gumbel``, ``randint`` at the bounds its consumers use,
``permutation`` at 1, 2 and 3 sorting rounds, and ``categorical`` over
(64, 4) logits.  ``draws.npz`` holds each case's output (uint32 as
int64, floats as their int32 bits); an output above 64 KiB is stored as
its sha256 and first 64 values in ``digests.json`` instead.
:func:`twin_case` computes a case with the port's twin on a device.
Regenerate from the repo root (the test reruns it into a temporary
directory and compares):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/threefry9/make.py
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
JAX_VERSION = "0.9.0"
SEEDS = (0, 1, 11, 2 ** 31 - 1, -1, 2 ** 31, 2 ** 32 - 1)
SHAPES = ((), (5,), (3, 4), (1000,))
BIG = 2 ** 20
PERM_NS = (1, 2, 1625, 1626, 100_000, 3_000_000)
INLINE_BYTES = 64 * 1024
HEAD = 64


def _cases():
    out = []
    for s in SEEDS:
        out += [("key", s, {}), ("split", s, {"num": 2}),
                ("split", s, {"num": 3}), ("fold_in", s, {"data": 7})]
        for shape in SHAPES:
            for fn in ("bits", "uniform", "normal", "gumbel"):
                out.append((fn, s, {"shape": list(shape)}))
        out += [("uniform", s, {"shape": [1000], "minval": -3.7,
                                "maxval": 5.1}),
                ("randint", s, {"shape": [24, 2], "minval": 0,
                                "maxval": 24}),
                ("randint", s, {"shape": [16, 1], "minval": 1,
                                "maxval": 12}),
                ("randint", s, {"shape": [1000], "minval": 0,
                                "maxval": 2 ** 31 - 1}),
                ("randint", s, {"shape": [5], "minval": 3, "maxval": 3}),
                ("categorical", s, {"logits_seed": 9, "shape": [64, 4]}),
                ("permutation", s, {"n": 1626})]
    for fn in ("bits", "uniform", "normal", "gumbel"):
        out.append((fn, 0, {"shape": [BIG]}))
    for n in PERM_NS:
        out.append(("permutation", 3, {"n": n}))
    return [{"name": f"{i:03d}_{fn}", "fn": fn, "seed": s, "args": a}
            for i, (fn, s, a) in enumerate(out)]


CASES = _cases()


def logits(case):
    a = case["args"]
    return np.random.default_rng(a["logits_seed"]).normal(
        0.0, 2.0, a["shape"]).astype(np.float32)


def as_stored(arr) -> np.ndarray:
    """uint32 -> int64 values, float32 -> int32 bits, ints -> int64."""
    arr = np.asarray(arr)
    if arr.dtype == np.float32:
        return arr.view(np.int32).copy()
    return arr.astype(np.int64)


def digest(arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "head": arr.reshape(-1)[:HEAD].tolist(),
            "shape": list(arr.shape), "dtype": str(arr.dtype)}


def check_jax():
    import jax
    if jax.__version__ != JAX_VERSION or \
            not jax.config.jax_threefry_partitionable or \
            jax.config.jax_default_prng_impl != "threefry2x32":
        raise SystemExit(
            f"threefry9 is made with jax {JAX_VERSION}, "
            "jax_threefry_partitionable=True and the threefry2x32 "
            f"implementation; this is jax {jax.__version__}, "
            f"partitionable={jax.config.jax_threefry_partitionable}, "
            f"impl={jax.config.jax_default_prng_impl}")


def jax_case(case):
    import jax
    fn, a = case["fn"], case["args"]
    key = jax.random.PRNGKey(case["seed"])
    shape = tuple(a.get("shape", ()))
    if fn == "key":
        return key
    if fn == "split":
        return jax.random.split(key, a["num"])
    if fn == "fold_in":
        return jax.random.fold_in(key, a["data"])
    if fn == "bits":
        return jax.random.bits(key, shape)
    if fn == "uniform":
        return jax.random.uniform(key, shape, minval=a.get("minval", 0.0),
                                  maxval=a.get("maxval", 1.0))
    if fn == "normal":
        return jax.random.normal(key, shape)
    if fn == "gumbel":
        return jax.random.gumbel(key, shape)
    if fn == "randint":
        return jax.random.randint(key, shape, a["minval"], a["maxval"])
    if fn == "permutation":
        return jax.random.permutation(key, a["n"])
    if fn == "categorical":
        return jax.random.categorical(key, logits(case), axis=1)
    raise ValueError(fn)


def twin_case(case, device):
    """The case through the port's twin on ``device``, as numpy."""
    import torch
    from avenir_tpu_torch.utils import threefry as tf
    fn, a = case["fn"], case["args"]
    key = tf.PRNGKey(case["seed"], device)
    shape = tuple(a.get("shape", ()))
    if fn == "key":
        out = key
    elif fn == "split":
        out = tf.split(key, a["num"])
    elif fn == "fold_in":
        out = tf.fold_in(key, a["data"])
    elif fn == "bits":
        out = tf.random_bits(key, shape)
    elif fn == "uniform":
        out = tf.uniform(key, shape, a.get("minval", 0.0),
                         a.get("maxval", 1.0))
    elif fn == "normal":
        out = tf.normal(key, shape)
    elif fn == "gumbel":
        out = tf.gumbel(key, shape)
    elif fn == "randint":
        out = tf.randint(key, shape, a["minval"], a["maxval"])
    elif fn == "permutation":
        out = tf.permutation(key, a["n"])
    elif fn == "categorical":
        out = tf.categorical(key, torch.from_numpy(logits(case)).to(device),
                             axis=1)
    else:
        raise ValueError(fn)
    return out.cpu().numpy()


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    check_jax()
    os.makedirs(out_dir, exist_ok=True)
    inline, digests = {}, {}
    for case in CASES:
        arr = as_stored(jax_case(case))
        if arr.nbytes > INLINE_BYTES:
            digests[case["name"]] = digest(arr)
        else:
            inline[case["name"]] = arr
    np.savez(os.path.join(out_dir, "draws.npz"), **inline)
    with open(os.path.join(out_dir, "digests.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")


def held(case, got: np.ndarray, out_dir: str = HERE):
    """None when the twin's output ``got`` equals the fixture's for
    ``case``, else a description of the difference."""
    got = as_stored(got)
    name = case["name"]
    with open(os.path.join(out_dir, "digests.json")) as fh:
        digests = json.load(fh)
    if name in digests:
        want = digests[name]
        d = digest(got)
        if d["shape"] != want["shape"] or d["sha256"] != want["sha256"]:
            return (f"{name}: sha256 differs; first values "
                    f"{d['head'][:4]} vs {want['head'][:4]}")
        return None
    with np.load(os.path.join(out_dir, "draws.npz")) as z:
        want = z[name]
    if got.shape != want.shape or not np.array_equal(got, want):
        return f"{name}: {int(np.sum(got != want))} values differ"
    return None


if __name__ == "__main__":
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
