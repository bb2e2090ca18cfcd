"""The text and rule jobs in the port (``cli/text_jobs.py``:
``wordCounter``, ``ruleEvaluator``, ``temporalFilter``; ``text.word_count``
and ``explore.rules``) against the JAX package, on the CPU: the seq9
fixture's text cases byte for byte, and the word count and the rule
evaluation equal the JAX package's on random inputs."""

import importlib.util
import json
import os

import numpy as np
import pytest

from avenir_tpu.explore import rules as JRU
from avenir_tpu.text import word_count as jax_word_count
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.explore import rules as RU
from avenir_tpu_torch.text import word_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ9 = os.path.join(ROOT, "tests", "torch_fixtures", "seq9")
CPU = "-Dplatform=cpu"
TEXT_JOBS = {"wordCounter", "ruleEvaluator", "temporalFilter"}

_spec = importlib.util.spec_from_file_location(
    "seq9_make_text", os.path.join(SEQ9, "make.py"))
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)


@pytest.mark.parametrize("case", [c for c, (job, _, _) in MAKE.CASES.items()
                                  if job in TEXT_JOBS])
def test_seq9_case_byte_equal(tmp_path, case):
    text, counters = MAKE.run_case(port_run.main, SEQ9, str(tmp_path), case,
                                   (CPU,))
    with open(os.path.join(SEQ9, case, "out.csv")) as fh:
        assert text == fh.read()
    with open(os.path.join(SEQ9, case, "counters.json")) as fh:
        assert counters == json.load(fh)


@pytest.mark.parametrize("seed", range(3))
def test_word_count_equal(seed):
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(MAKE.WORDS + ("Ünïcode", "a.b.c", "x-y"),
                                 int(rng.integers(0, 15))))
             for _ in range(60)]
    assert word_count(texts) == jax_word_count(texts)


@pytest.mark.parametrize("strategy", ["confAccuracy", "confEntropy"])
def test_evaluate_rules_equal(strategy):
    rng = np.random.default_rng(7)
    n = 200
    cols = [np.asarray([f"r{i}" for i in range(n)], dtype=object),
            np.asarray([str(int(v)) for v in rng.integers(0, 100, n)],
                       dtype=object),
            np.asarray(list(rng.choice(list("ABCD"), n)), dtype=object),
            np.asarray(list(rng.choice(["yes", "no"], n)), dtype=object)]
    specs = {"a": "1 gt 50 > yes", "b": "2 notin A:B and 1 le 70 > no",
             "c": "2 eq Z > yes", "d": "1 ge 0 and 2 ne C > no"}
    port = {k: RU.RuleExpression.create(v) for k, v in specs.items()}
    jax_ = {k: JRU.RuleExpression.create(v) for k, v in specs.items()}
    assert RU.evaluate_rules(port, cols, 3, n, strategy, ["yes", "no"]) == \
        JRU.evaluate_rules(jax_, cols, 3, n, strategy, ["yes", "no"])
