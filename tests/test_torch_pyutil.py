"""The port's driver-script helpers (``avenir_tpu_torch/utils/pyutil.py``)
against the JAX package's module, on the same seeds and inputs: the eleven
cases of ``tests/test_pyutil.py``, each called through both modules, with
equal results (arrays bit for bit, draws draw for draw, the same
exceptions)."""

import numpy as np
import pytest

from avenir_tpu.utils import pyutil as J
from avenir_tpu_torch.utils import pyutil as P


def _both(fn, *args, seed=None, **kw):
    """``fn``'s result in each module, a fresh generator of ``seed`` each."""
    out = []
    for mod in (J, P):
        extra = {"rng": np.random.default_rng(seed)} if seed is not None \
            else {}
        out.append(getattr(mod, fn)(*args, **kw, **extra))
    return out


def _min_distances():
    rng = np.random.default_rng(7)
    x1, x2 = rng.normal(size=(37, 5)), rng.normal(size=(23, 5))
    return [m.find_min_distances(x1, x2, chunk=8) for m in (J, P)]


def _min_between_rows():
    x = np.random.default_rng(8).normal(size=(12, 3))
    return [m.find_min_distances_between_rows(x) for m in (J, P)]


def _split():
    x = np.arange(40).reshape(20, 2)
    return [[m.split_data_random(x, 6, rng=np.random.default_rng(s))
             for s in range(30)] for m in (J, P)]


def _scale():
    return [(m.scale_min_max(np.array([2.0, 4.0, 6.0])),
             m.scale_min_max(np.full(3, 5.0))) for m in (J, P)]


def _gen_id():
    return [[m.gen_id(16, rng=rng) for _ in range(200)]
            for m, rng in ((J, np.random.default_rng(1)),
                           (P, np.random.default_rng(1)))]


def _sublist():
    return _both("select_random_sublist_from_list",
                 ["a", "b", "c", "d", "a"], 4, seed=2)


def _sublist_weighted():
    return [[m.select_random_sublist_from_list(["a", "a", "b"], 2,
                                               rng=rng)[0]
             for _ in range(3000)]
            for m, rng in ((J, np.random.default_rng(5)),
                           (P, np.random.default_rng(5)))]


def _ip():
    return [[m.gen_ip_address(rng=rng) for _ in range(50)]
            for m, rng in ((J, np.random.default_rng(3)),
                           (P, np.random.default_rng(3)))]


def _poly_fit():
    f = lambda x: 2.5 * x * x - 1.0 * x + 4.0     # noqa: E731
    return _both("sec_deg_poly_fit", 1.0, f(1.0), 3.0, f(3.0), -2.0,
                 f(-2.0))


def _range_limit():
    return [[m.range_limit(v, 0, 10) for v in (5, -1, 11)] for m in (J, P)]


CASES = {"min_distances": _min_distances,
         "min_between_rows": _min_between_rows, "split": _split,
         "scale": _scale, "gen_id": _gen_id, "sublist": _sublist,
         "sublist_weighted": _sublist_weighted, "ip": _ip,
         "poly_fit": _poly_fit, "range_limit": _range_limit}


def _equal(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_equals_the_jax_module(case):
    want, got = CASES[case]()
    _equal(want, got)


def test_configs_table_and_refusals(tmp_path):
    csv = tmp_path / "t.csv"
    csv.write_text("1,2,3\n4,5,6\n")
    props = tmp_path / "c.properties"
    props.write_text(f"data.file={csv}\ncols=0,2\n")
    cfgs = [m.get_configs(str(props)) for m in (J, P)]
    assert cfgs[0] == cfgs[1]
    _equal(*[m.extract_table_from_file(c, "data.file", "cols")
             for m, c in zip((J, P), cfgs)])
    assert P.ID_TOKENS == J.ID_TOKENS
    x = np.arange(40).reshape(20, 2)
    for mod in (J, P):
        for bad in (0, len(x)):
            with pytest.raises(ValueError):
                mod.split_data_random(x, bad)
        with pytest.raises(ValueError):
            mod.select_random_sublist_from_list(["a", "b", "a"], 3)
