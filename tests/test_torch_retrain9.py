"""The port's ``retrainController`` against the JAX package's retrain9
fixture (``tests/torch_fixtures/retrain9/make.py``), on the CPU.

Cases a-d (a forced cycle that publishes with a delta, an alert-driven
cycle, a probation replay that rolls back, and a publish killed after
its commit then resumed to exactly one new version) run through the
port's CLI through the fixture's own ``make.run_case``.  Every
file the fixture keeps must equal the port's byte for byte, outside two
wall-clock fields: ``opened_unix`` in the journal's ``probation`` and
``canary`` blocks, and ``pinned_unix`` in the registry's
``serving.json``.  The ``.npz`` files are zip archives whose members
carry their write time, so they are compared array for array (values and
dtypes).  A rerun of ``make.py`` into a temporary directory must match
the committed files the same way.
"""

import importlib.util
import os
import re

import numpy as np
import pytest

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core import faults as port_faults

TESTS = os.path.dirname(os.path.abspath(__file__))
RETRAIN9 = os.path.join(TESTS, "torch_fixtures", "retrain9")
# the wall-clock fields left out of the byte comparisons
_CLOCK = re.compile(rb'"(opened_unix|pinned_unix)": [0-9.e+-]+')


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "retrain9_make", os.path.join(RETRAIN9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()


def _port_main(args):
    return port_run.main([args[0], "-Dplatform=cpu", *args[1:]])


def _files(root, versions=True):
    """The files under ``root``, relative; without the registry's
    version directories unless ``versions``."""
    rels = (os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs)
    return sorted(r for r in rels
                  if versions or not r.startswith("registry/v_"))


def assert_same_file(got, want):
    if got.endswith(".npz"):
        with np.load(got) as a, np.load(want) as b:
            assert sorted(a.files) == sorted(b.files), got
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (got, k)
                assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind
                                      in "fc"), (got, k)
        return
    with open(got, "rb") as a, open(want, "rb") as b:
        ga, wb = a.read(), b.read()
    assert _CLOCK.sub(rb'"\1": T', ga) == _CLOCK.sub(rb'"\1": T', wb), got


def assert_same_tree(got_root, want_root, versions=True):
    assert _files(got_root, versions) == _files(want_root, versions)
    for rel in _files(want_root, versions):
        assert_same_file(os.path.join(got_root, rel),
                         os.path.join(want_root, rel))


def test_fixture_cases_end_as_designed():
    """The fixture itself: a, b and d publish v2 and serve it, c rolls
    back to v1; d's killed run left the cycle at registry_publish and
    its resume adopted the committed version."""
    import json
    for case, outcome, serving in (("a", "published", "2"),
                                   ("b", "published", "2"),
                                   ("c", "rolled_back", "1"),
                                   ("d", "published", "2")):
        with open(os.path.join(RETRAIN9, case, "part-r-00000")) as fh:
            part = fh.read().strip().split(",")
        assert part[2] == outcome and part[5] == serving, case
    with open(os.path.join(RETRAIN9, "d", "crashed.json")) as fh:
        assert json.load(fh)["stage"] == "registry_publish"
    with open(os.path.join(RETRAIN9, "d", "counters.json")) as fh:
        ctl = json.load(fh)["Controller"]
    assert ctl["PublishDeduped"] == 1 and "Published" not in ctl
    assert os.path.exists(os.path.join(RETRAIN9, "a", "registry",
                                       "v_000002", "delta.json"))


@pytest.mark.parametrize("case", MAKE.CASES)
def test_port_case_matches_fixture(tmp_path, case):
    """The port's CLI over the case's inputs writes the fixture's files;
    its published version equals case a's (every case publishes the same
    candidate)."""
    work = str(tmp_path / "work")
    os.makedirs(work)
    MAKE.run_case(_port_main, port_faults, case, work)
    got = str(tmp_path / "got")
    MAKE.keep(work, got, versions=True)
    want = os.path.join(RETRAIN9, case)
    versions = os.path.join(got, "registry", "v_000002")
    assert_same_tree(versions,
                     os.path.join(RETRAIN9, "a", "registry", "v_000002"))
    assert_same_tree(got, want, versions=False)


def test_make_reproduces_the_fixture(tmp_path):
    """Rerun the JAX package's maker into a temporary directory: every
    file it writes equals the committed one, outside the clock fields."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = str(tmp_path / "retrain9")
    MAKE.make(out)
    for case in MAKE.CASES:
        assert_same_tree(os.path.join(out, case),
                         os.path.join(RETRAIN9, case))
