"""The Naive Bayes jobs through the port's CLI on the CPU, byte for byte
against the JAX package:

* the golden ``nb`` fixture (``tests/golden/flows.py`` ``nb_flow``);
* the ``nb9`` fixture (``tests/torch_fixtures/nb9``, made by the JAX
  package with ``make.py``): the model with its Gaussian lines, the
  predictor's argmax, cost, prob-diff-threshold and feature-prob modes,
  the text mode, the knn.sh class-conditional pipeline
  (``featureCondProbJoiner`` -> ``nearestNeighbor``), ``knnPipeline`` and
  ``predictionService`` over the fixture's bayes version, through the same
  flow ``chip_smoke.py`` runs on the card; and ``make.py`` rerun into a
  temporary directory reproduces every file;
* the five-job pipeline of ``tests/test_knn_pipeline_full.py`` run by both
  packages: every job's output equal;
* the jobs' refusals and the text mode's validation counters.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

from avenir_tpu.cli import run as jax_run

from avenir_tpu_torch.cli import jobs as port_jobs
from avenir_tpu_torch.cli import run as port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
NB_GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "nb")
NB9 = os.path.join(ROOT, "tests", "torch_fixtures", "nb9")
CPU = "-Dplatform=cpu"


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_golden_nb_through_the_port_cli(tmp_path):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.telecom_churn_gen import generate
    train = tmp_path / "train.csv"
    train.write_text("\n".join(generate(400, 11)))
    props = f"-Dconf.path={RES}/churn.properties"
    assert port_run.main(["org.avenir.bayesian.BayesianDistribution", props,
                          CPU, f"-Dbad.feature.schema.file.path="
                          f"{RES}/churn.json", str(train),
                          str(tmp_path / "model")]) == 0
    model = tmp_path / "model" / "part-r-00000"
    assert port_run.main(["org.avenir.bayesian.BayesianPredictor", props,
                          CPU, f"-Dbap.feature.schema.file.path="
                          f"{RES}/churn.json",
                          f"-Dbap.bayesian.model.file.path={model}",
                          str(train), str(tmp_path / "pred")]) == 0
    assert _read(model) == _read(os.path.join(NB_GOLDEN, "model.csv"))
    assert _read(tmp_path / "pred" / "part-m-00000") == \
        _read(os.path.join(NB_GOLDEN, "pred.csv"))


@pytest.fixture(scope="module")
def nb9_run(tmp_path_factory):
    cs = _chip_smoke()
    work = str(tmp_path_factory.mktemp("nb9") / "run")
    return cs.nb9_flow(work, [CPU])


@pytest.mark.parametrize("name", sorted(
    ["model", "pred", "pred_cost", "pred_diff", "cond_prob", "nn", "knn",
     "text_model", "text_pred", "served"]))
def test_nb9_output_equals_the_fixture(nb9_run, name):
    outs, _ = nb9_run
    rel = _chip_smoke().NB9_FILES[name]
    assert _read(outs[name]) == _read(os.path.join(NB9, rel)), rel


def test_nb9_joiner_digest_and_counters(nb9_run):
    outs, counters = nb9_run
    data = _read(outs["joined"])
    with open(os.path.join(NB9, "joined.sha256")) as fh:
        digest, lines = fh.read().split()
    assert hashlib.sha256(data).hexdigest() == digest
    assert data.count(b"\n") == int(lines)
    with open(os.path.join(NB9, "counters.json")) as fh:
        assert counters == json.load(fh)
    _chip_smoke().nb9_check(outs, counters, "nb9 cpu")


def test_nb9_fixture_has_every_mode():
    """The fixture exercises what it is for: Gaussian lines, both
    arbitration outcomes, both ambiguity flags, skipped far values."""
    model = _read(os.path.join(NB9, "model.csv")).decode().splitlines()
    assert any(l.count(",") == 4 and l.split(",")[2] == "" for l in model)
    assert any(l.startswith(",3,,") for l in model)
    cost = [l.split(",")[5] for l in
            _read(os.path.join(NB9, "pred_cost.csv")).decode().splitlines()]
    assert {"pass", "fail"} <= set(cost)
    flags = {l.rsplit(",", 1)[1] for l in
             _read(os.path.join(NB9, "pred_diff.csv")).decode().splitlines()}
    assert flags == {"classified", "ambiguous"}
    test_rows = _read(os.path.join(NB9, "data", "test_part")).decode()
    assert any(int(l.split(",")[1]) > 99 for l in test_rows.splitlines())


def test_make_reproduces_the_fixture(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "nb9_make", os.path.join(NB9, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "nb9"
    mod.make(str(out))
    for dirpath, _, files in os.walk(NB9):
        for f in files:
            if f == "make.py" or "__pycache__" in dirpath:
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), NB9)
            if f.endswith(".npz"):
                with np.load(os.path.join(NB9, rel)) as a, \
                        np.load(str(out / rel)) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in a.files:
                        assert a[k].dtype == b[k].dtype
                        np.testing.assert_array_equal(a[k], b[k])
            else:
                assert _read(out / rel) == _read(os.path.join(NB9, rel)), rel


# ---- the knn.sh five-job pipeline (tests/test_knn_pipeline_full.py) ----

def _knn_full_setup(tmp_path):
    from tests.test_knn_pipeline_full import SCHEMA, _gen
    schema = tmp_path / "s.json"
    schema.write_text(json.dumps(SCHEMA))
    data = tmp_path / "data"
    data.mkdir()
    _gen(data / "tr_part", 260, 0, "tr")
    _gen(data / "test_part", 60, 1, "te")
    props = tmp_path / "knn.properties"
    props.write_text(f"""
field.delim.regex=,
sts.same.schema.file.path={schema}
sts.distance.scale=1000
bad.feature.schema.file.path={schema}
bap.feature.schema.file.path={schema}
bap.output.feature.prob.only=true
nen.top.match.count=7
nen.class.condition.weighted=true
nen.class.attribute.values=fail,pass
nen.validation.mode=true
""")
    return data, props


def _knn_full(main, base, data, props, plat=()):
    """The five jobs of knn.sh in ``base``; returns each job's output."""
    model = base / "bayes_model"
    conf = [f"-Dconf.path={props}", *plat]
    assert main(["sameTypeSimilarity", *conf, str(data),
                 str(base / "dist")]) == 0
    assert main(["bayesianDistribution", *conf, str(data / "tr_part"),
                 str(model)]) == 0
    assert main(["bayesianPredictor", *conf,
                 f"-Dbap.bayesian.model.file.path={model}/part-r-00000",
                 str(data / "tr_part"), str(base / "cond_prob")]) == 0
    join_in = base / "join_in"
    join_in.mkdir()
    shutil.copy(base / "cond_prob" / "part-m-00000", join_in / "condProb_part")
    shutil.copy(base / "dist" / "part-r-00000", join_in / "neighbors")
    assert main(["featureCondProbJoiner", *conf, str(join_in),
                 str(base / "joined")]) == 0
    assert main(["nearestNeighbor", *conf, str(base / "joined"),
                 str(base / "pred")]) == 0
    return {name: _read(base / name / part) for name, part in (
        ("dist", "part-r-00000"), ("bayes_model", "part-r-00000"),
        ("cond_prob", "part-m-00000"), ("joined", "part-r-00000"),
        ("pred", "part-r-00000"))}


def test_knn_full_pipeline_equals_the_jax_package(tmp_path):
    data, props = _knn_full_setup(tmp_path)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _knn_full(jax_run.main, tmp_path / "jax", data, props)
    got = _knn_full(port_run.main, tmp_path / "port", data, props, (CPU,))
    for name in want:
        assert got[name] == want[name], name
    lines = got["joined"].decode().splitlines()
    assert len(lines) == 260 * 60 and all(l.count(",") == 5 for l in lines)
    assert len(got["pred"].decode().splitlines()) == 60


def test_joiner_counts_unmatched_neighbours(tmp_path):
    """A train item whose actual class has no (class, prob) pair drops its
    neighbour lines, counted, as in the JAX package."""
    d = tmp_path / "in"
    d.mkdir()
    (d / "condProb_x").write_text("a,0.5,pass,0.25,pass\n"
                                  "b,0.5,pass,0.125,fail\n")
    (d / "neighbors").write_text("a,t1,10,pass,fail\nb,t1,20,fail,fail\n"
                                 "a,t2,30,pass\n")
    (d / "_SUCCESS").write_text("")
    outs = {}
    for name, main, plat in (("jax", jax_run.main, []),
                             ("port", port_run.main, [CPU])):
        assert main(["featureCondProbJoiner", *plat, str(d),
                     str(tmp_path / name)]) == 0
        outs[name] = (_read(tmp_path / name / "part-r-00000"),
                      _read(str(tmp_path / name) + ".counters.json"))
    assert outs["port"][0] == outs["jax"][0] == \
        b"t1,fail,a,10,pass,0.25\nt2,?,a,30,pass,0.25\n"
    port_c, jax_c = (json.loads(outs[k][1]) for k in ("port", "jax"))
    assert port_c["Join"] == jax_c["Join"] == {"joinedLines": 2,
                                               "unmatchedNeighbors": 1}


def test_text_mode_jobs_equal_the_jax_package(tmp_path):
    train = os.path.join(NB9, "text", "train.txt")
    outs = {}
    for name, main, plat in (("jax", jax_run.main, []),
                             ("port", port_run.main, [CPU])):
        base = tmp_path / name
        assert main(["bayesianDistribution", *plat, train,
                     str(base / "model")]) == 0
        assert main(["bayesianPredictor", *plat,
                     f"-Dbap.bayesian.model.file.path={base}/model",
                     train, str(base / "pred")]) == 0
        outs[name] = [_read(base / "model" / "part-r-00000"),
                      _read(base / "pred" / "part-m-00000"),
                      json.loads(_read(str(base / "pred") +
                                       ".counters.json"))["Validation"]]
    assert outs["port"] == outs["jax"]
    assert outs["port"][2]["Accuracy"] == 100


def test_job_names_resolve_and_keep_their_dist_modes():
    for names, mode in (
            (("org.avenir.bayesian.BayesianDistribution",
              "bayesianDistribution", "BayesianDistribution"), "sharded"),
            (("org.avenir.bayesian.BayesianPredictor", "bayesianPredictor",
              "BayesianPredictor"), "map"),
            (("org.avenir.knn.FeatureCondProbJoiner",
              "featureCondProbJoiner", "FeatureCondProbJoiner"), "gather")):
        fns = {port_jobs.resolve(n) for n in names}
        assert len(fns) == 1
        assert port_jobs.dist_mode(fns.pop()) == mode


def test_predictor_needs_its_model_key(tmp_path):
    from avenir_tpu_torch.core.config import ConfigError
    with pytest.raises(ConfigError, match="bap.bayesian.model.file.path"):
        port_run.main(["bayesianPredictor", CPU,
                       f"-Dbap.feature.schema.file.path={NB9}/schema.json",
                       os.path.join(NB9, "data", "test_part"),
                       str(tmp_path / "o")])
