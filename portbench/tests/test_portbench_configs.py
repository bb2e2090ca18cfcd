"""Each configuration's copy of its schema, which the benchmark runs from
so that its yardstick lies under its own folder, equals the schema file
of the repo's tutorial that it names (``schema_file``)."""

import json

import pytest

from portbench.core import CHECKOUT, PACKAGE_DIR, load_json

CONFIGS = sorted(p.stem for p in (PACKAGE_DIR / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_schema_copy_equals_the_schema_file(name):
    config = load_json(PACKAGE_DIR / "configs" / f"{name}.json")
    with open(CHECKOUT / config["schema_file"]) as fh:
        assert config["schema"] == json.load(fh)
