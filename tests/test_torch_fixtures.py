"""The committed rafo9 fixture (tests/torch_fixtures/rafo9) is what the JAX
package produces today: rerun its make.py into a temporary directory and
require identical bytes, so the oracle chip_smoke.py holds the port against
on the GPU cannot drift from the reference."""

import importlib.util
import json
import os

import pytest

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_fixtures", "rafo9")
META = os.path.join("registry", "rafo9", "v_000001", "meta.json")


def _load_make():
    spec = importlib.util.spec_from_file_location(
        "rafo9_make", os.path.join(FIXTURE, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rafo9"))
    _load_make().make(out)
    return out


def _read(*parts):
    with open(os.path.join(*parts), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name", [f"tree_{i}.json" for i in range(9)]
                         + ["requests.csv", "pred.csv", "served.csv"])
def test_fixture_file_is_current(regenerated, name):
    assert _read(regenerated, name) == _read(FIXTURE, name)


def test_fixture_registry_is_current(regenerated):
    got = json.loads(_read(regenerated, META))
    want = json.loads(_read(FIXTURE, META))
    for meta in (got, want):      # publish-time stamps, if any, may differ
        for k in [k for k in meta if "time" in k or "unix" in k]:
            meta.pop(k)
    assert got["model_json"] == want["model_json"]
    assert got == want
    assert len(want["model_json"]["trees"]) == 9
