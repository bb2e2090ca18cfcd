"""The port's twin of ``jax.random`` (``avenir_tpu_torch/utils/threefry.py``)
against JAX 0.9.0 itself, on the CPU, bit for bit.

* the plain ``threefry2x32`` (the int64 torch form, which is the CUDA
  kernel's oracle on the card, and the numpy uint32 form the CPU path
  runs) against ``jax.prng.threefry_2x32`` over random keys and counters;
* every twin function draw for draw against ``jax.random`` over the
  threefry9 case list, live;
* the float transforms on all 2^23 mantissa inputs: ``uniform``,
  ``normal`` and ``gumbel`` are functions of ``bits >> 9`` alone, so a
  jitted mirror of ``jax/_src/random.py``'s transform over
  ``arange(2^23)`` (itself checked against real draws) is the whole
  truth table, and the twin's transform equals it on every entry — this
  pins XLA's ``erf_inv`` polynomial, its ``log1p``, its correctly
  rounded ``sqrt`` and the FMA of ``uniform``'s scale;
* the threefry9 fixture, which ``chip_smoke.py`` holds the card to.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from avenir_tpu_torch.utils import threefry as tf
from avenir_tpu_torch.utils import xla_math

TESTS = os.path.dirname(os.path.abspath(__file__))
TF9 = os.path.join(TESTS, "torch_fixtures", "threefry9")


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "threefry9_make", os.path.join(TF9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()


def test_jax_is_the_pinned_configuration():
    assert jax.__version__ == MAKE.JAX_VERSION
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plain_hash_equals_jax(seed):
    from jax._src.prng import threefry_2x32
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 2 ** 32, 2 * 5000,
                          dtype=np.uint64).astype(np.uint32)
    want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(counts)))
    x0 = torch.from_numpy(counts[:5000].astype(np.int64))
    x1 = torch.from_numpy(counts[5000:].astype(np.int64))
    k = torch.from_numpy(key.astype(np.int64))
    pairs = tf.threefry_hash(k.reshape(1, 2), 5000, 1, x0, x1)[0]  # numpy
    got = np.concatenate([pairs[:, 0].numpy(), pairs[:, 1].numpy()])
    np.testing.assert_array_equal(got, want.astype(np.int64))
    t0, t1 = tf.threefry2x32_torch(k[0], k[1], x0, x1)   # the torch form
    np.testing.assert_array_equal(np.concatenate([t0.numpy(), t1.numpy()]),
                                  want.astype(np.int64))


def test_torch_and_numpy_forms_agree_on_batched_keys():
    keys = torch.tensor([[0, 0], [1, 2], [2 ** 32 - 1, 2 ** 31]])
    for mode in (0, 1):
        a = tf._hash_torch(keys, None, None, 1000, mode)
        idx = torch.arange(1000)
        b0, b1 = tf.threefry2x32_torch(keys[:, 0:1], keys[:, 1:2],
                                       (idx >> 32)[None], idx[None] & tf.M32)
        want = tf._to_int32_bits(b0 ^ b1) if mode == 0 else \
            torch.stack([b0, b1], dim=-1)
        assert torch.equal(a, want)


@pytest.mark.parametrize("case", [c for c in MAKE.CASES
                                  if c["fn"] != "permutation"
                                  or c["args"]["n"] <= 100_000],
                         ids=lambda c: c["name"])
def test_twin_draws_equal_jax_random(case):
    want = MAKE.as_stored(MAKE.jax_case(case))
    got = MAKE.as_stored(MAKE.twin_case(case, "cpu"))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_large_permutation_takes_three_rounds():
    """n = 3,000,000 sorts three times (1 round to 1,625, 2 to ~2.64M)."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.permutation(key, 3_000_000))
    got = tf.permutation(tf.PRNGKey(3, "cpu"), 3_000_000).numpy()
    assert np.array_equal(got, want)


def test_batched_keys_are_vmap():
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (7, 2), 0, 24))(keys))
    np.testing.assert_array_equal(tf.randint(tkeys, (7, 2), 0, 24).numpy(),
                                  want)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 1)))(keys))
    np.testing.assert_array_equal(
        tf.uniform(tkeys, (9, 1)).numpy().view(np.int32),
        want.view(np.int32))
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 7))(keys))
    np.testing.assert_array_equal(tf.split(tkeys, 7).numpy(),
                                  want.astype(np.int64))


# --------------------------------------------------------------------------
# the exhaustive check of the float transforms
# --------------------------------------------------------------------------

def _unit(m):
    return lax.bitcast_convert_type(m | jnp.uint32(0x3F800000),
                                    jnp.float32) - np.float32(1)


def _uniform(m, lo, hi):
    lo, hi = np.float32(lo), np.float32(hi)
    return lax.max(lo, _unit(m) * (hi - lo) + lo)


TRANSFORMS = {
    "uniform": (lambda m: _uniform(m, 0.0, 1.0),
                lambda b: tf.uniform_from_bits(b)),
    "uniform_scaled": (lambda m: _uniform(m, -3.7, 5.1),
                       lambda b: tf.uniform_from_bits(b, -3.7, 5.1)),
    "normal": (lambda m: np.float32(np.sqrt(2)) * lax.erf_inv(
        _uniform(m, np.nextafter(np.float32(-1), np.float32(0)), 1.0)),
        tf.normal_from_bits),
    "gumbel": (lambda m: -jnp.log(-jnp.log(
        _uniform(m, np.finfo(np.float32).tiny, 1.0))), tf.gumbel_from_bits),
}
DRAWS = {"uniform": lambda k: jax.random.uniform(k, (4096,)),
         "uniform_scaled": lambda k: jax.random.uniform(
             k, (4096,), minval=-3.7, maxval=5.1),
         "normal": lambda k: jax.random.normal(k, (4096,)),
         "gumbel": lambda k: jax.random.gumbel(k, (4096,))}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_on_every_mantissa(name):
    mirror, twin = TRANSFORMS[name]
    table = np.asarray(jax.jit(mirror)(jnp.arange(2 ** 23,
                                                  dtype=jnp.uint32)))
    # the mirror is jax.random's transform: index it with real draws' bits
    for seed in (3, 11):
        k = jax.random.PRNGKey(seed)
        m = np.asarray(jax.random.bits(k, (4096,))) >> 9
        assert np.array_equal(table[m].view(np.int32),
                              np.asarray(DRAWS[name](k)).view(np.int32))
    got = twin(torch.arange(2 ** 23, dtype=torch.int32) << 9).numpy()
    bad = np.nonzero(got.view(np.int32) != table.view(np.int32))[0]
    assert bad.size == 0, (bad[:8], got[bad[:8]], table[bad[:8]])


def test_sqrt_f32_is_correctly_rounded():
    x = np.random.default_rng(0).random(100_000).astype(np.float32) * 100
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(
        xla_math.sqrt_f32(torch.from_numpy(x)).numpy(), want)


# --------------------------------------------------------------------------
# the fixture
# --------------------------------------------------------------------------

def test_threefry9_fixture_against_the_twin():
    bad = [MAKE.held(c, MAKE.twin_case(c, "cpu")) for c in MAKE.CASES]
    assert not [b for b in bad if b]


def test_make_reproduces_the_fixture(tmp_path):
    out = str(tmp_path / "threefry9")
    MAKE.make(out)
    with open(os.path.join(out, "digests.json")) as a, \
            open(os.path.join(TF9, "digests.json")) as b:
        assert a.read() == b.read()
    with np.load(os.path.join(out, "draws.npz")) as a, \
            np.load(os.path.join(TF9, "draws.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])


def test_keys_stay_on_the_device_they_name():
    key = tf.PRNGKey(4, "cpu")
    assert key.dtype == torch.int64 and key.device.type == "cpu"
    k1, k2 = tf.split(key, 2)
    assert tf.uniform(k1, (3,)).device.type == "cpu"
    launches = tf.launches
    tf.normal(k2, (8,))
    assert tf.launches == launches          # the CPU runs the plain version
