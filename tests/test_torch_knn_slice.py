"""The KNN slice as a whole, on the CPU: the port's CLI against the JAX
package's committed outputs.

* ``sameTypeSimilarity`` then ``nearestNeighbor`` over
  ``tests/golden/flows.py``'s knn data reproduce the golden
  ``tests/golden/fixtures/knn/dist.csv`` and ``pred.csv`` byte for byte;
* ``knnPipeline`` reproduces ``tests/torch_fixtures/elearn_knn/`` (made by
  its ``make.py`` with the JAX package): inter-set and intra-set, euclidean
  and manhattan, outputs byte for byte and job counters equal; the
  fixture itself is rerun into a temporary directory and compared.
"""

import importlib.util
import json
import os
import sys

import pytest

from avenir_tpu_torch.cli import jobs as port_jobs
from avenir_tpu_torch.cli import run as port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
PROPS = os.path.join(RES, "knn.properties")
SCHEMA = os.path.join(RES, "elearn.json")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "knn")
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "elearn_knn")


def _read(*parts):
    with open(os.path.join(*parts)) as fh:
        return fh.read()


def _make_module():
    spec = importlib.util.spec_from_file_location(
        "elearn_knn_make", os.path.join(FIXTURE, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make_module()
RUNS = [name for name, _, _ in MAKE.runs("data")]


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """The port's two-job file flow over the golden knn data."""
    d = tmp_path_factory.mktemp("knn_golden")
    data = d / "data"
    data.mkdir()
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.elearn_gen import generate
    rows = generate(130, 14)
    (data / "tr_part").write_text("\n".join(rows[:100]))
    (data / "test_part").write_text("\n".join(rows[100:]))
    assert port_run.main([
        "org.sifarish.feature.SameTypeSimilarity", f"-Dconf.path={PROPS}",
        f"-Dsts.same.schema.file.path={SCHEMA}", "-Dplatform=cpu",
        str(data), str(d / "dist")]) == 0
    assert port_run.main([
        "org.avenir.knn.NearestNeighbor", f"-Dconf.path={PROPS}",
        "-Dplatform=cpu", str(d / "dist"), str(d / "pred")]) == 0
    return d


def test_golden_dist_csv(golden_run):
    assert _read(golden_run, "dist", "part-r-00000") == \
        _read(GOLDEN, "dist.csv")


def test_golden_pred_csv(golden_run):
    assert _read(golden_run, "pred", "part-r-00000") == \
        _read(GOLDEN, "pred.csv")
    with open(str(golden_run / "pred") + ".counters.json") as fh:
        counters = json.load(fh)
    assert counters["Validation"]["Accuracy"] == 80


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("elearn_knn"))
    MAKE.make(out)
    return out


@pytest.mark.parametrize("name", ["data/tr_part", "data/test_part",
                                  "counters.json"] + [f"{r}.csv"
                                                      for r in RUNS])
def test_fixture_file_is_current(regenerated, name):
    assert _read(regenerated, name) == _read(FIXTURE, name)


@pytest.fixture(scope="module")
def port_pipeline(tmp_path_factory):
    """Every fixture run through the port's knnPipeline on the CPU."""
    d = tmp_path_factory.mktemp("port_knn")
    data = os.path.join(FIXTURE, "data")
    out = {}
    for name, in_path, overrides in MAKE.runs(data):
        dest = str(d / name)
        assert port_run.main(MAKE.job_args(PROPS, SCHEMA, in_path, dest,
                                           overrides + ["-Dplatform=cpu"])
                             ) == 0
        with open(dest + ".counters.json") as fh:
            out[name] = (_read(dest, "part-r-00000"), json.load(fh))
    return out


@pytest.mark.parametrize("name", RUNS)
def test_knn_pipeline_reproduces_fixture(port_pipeline, name):
    text, counters = port_pipeline[name]
    assert text == _read(FIXTURE, f"{name}.csv")
    want = json.loads(_read(FIXTURE, "counters.json"))[name]
    assert {g: counters[g] for g in MAKE.COUNTER_GROUPS} == want
    n_test = 500 if name.startswith("inter") else 2000
    assert counters["KernelBackends"] == {"knn.topk.torch": 1}
    assert counters["Neighborhood"]["Test records"] == n_test
    assert len(text.splitlines()) == n_test


@pytest.mark.parametrize("key,exc", [
    ("nen.class.condition.weighted=true", ValueError),
    ("nen.prediction.mode=regression", ValueError)])
def test_knn_pipeline_refuses_loudly(tmp_path, key, exc):
    with pytest.raises(exc):
        port_run.main(["knnPipeline", f"-Dconf.path={PROPS}",
                       f"-Dsts.same.schema.file.path={SCHEMA}",
                       f"-D{key}", "-Dplatform=cpu",
                       os.path.join(FIXTURE, "data"), str(tmp_path / "o")])


@pytest.mark.parametrize("names", [
    ("org.sifarish.feature.SameTypeSimilarity", "sameTypeSimilarity",
     "recordSimilarity", "SameTypeSimilarity"),
    ("org.avenir.knn.NearestNeighbor", "nearestNeighbor", "knnClassifier",
     "NearestNeighbor"),
    ("org.avenir.knn.KnnPipeline", "knnPipeline", "knnInProcess",
     "KnnPipeline"),
    ("org.avenir.spark.similarity.GroupedRecordSimilarity",
     "groupedRecordSimilarity", "GroupedRecordSimilarity")])
def test_job_names_resolve(names):
    fns = {port_jobs.resolve(n) for n in names}
    assert len(fns) == 1


def test_unported_knn_neighbours_stay_unported():
    with pytest.raises(port_jobs.JobNotPorted):
        port_jobs.resolve("kmeansCluster")


def test_intra_set_votes_sum_to_k(tmp_path):
    """Intra-set knnPipeline asks B5 for k + 1 neighbours and drops the
    self-match: with nen.output.class.distr every row's votes sum to k."""
    src = os.path.join(FIXTURE, "data", "test_part")
    out = str(tmp_path / "intra")
    assert port_run.main(["knnPipeline", f"-Dconf.path={PROPS}",
                          f"-Dsts.same.schema.file.path={SCHEMA}",
                          "-Dnen.output.class.distr=true", "-Dplatform=cpu",
                          src, out]) == 0
    lines = _read(out, "part-r-00000").splitlines()
    assert len(lines) == 500
    for line in lines:
        parts = line.split(",")
        assert int(parts[2]) + int(parts[4]) == 7
