"""The Naive Bayes jobs in a joined run over per-process inputs, on the CPU:
two real gloo ranks (torchrun's environment, each a subprocess waited on
with a timeout), held against one process over the concatenated input —
the nb9 fixture, made by the JAX package's single-process jobs:

* ``bayesianDistribution`` over equal (130 + 130 rows) and unequal
  (160 + 100) files: every rank writes the fixture's ``model.csv``; the
  counters are summed over the ranks (each counts the global model, as in
  the JAX package's joined run) and printed by rank 0 only;
* ``bayesianPredictor`` (a map job): the ranks' part files concatenate to
  the fixture's ``pred.csv``;
* ``featureCondProbJoiner`` (a gather job) over distinct per-rank halves
  of the feature probabilities and distance lines: every rank's output
  is the fixture's ``joined.sha256`` (the spool keeps the ``condProb``
  prefix);
* the text mode refuses a joined run, and ``bayesianDistribution``
  refuses the shard lane, by name.
"""

import hashlib
import os

import pytest

from avenir_tpu_torch.cli import jobs as pjobs
from avenir_tpu_torch.cli import run as port_run
from tests.test_torch_cli_multiprocess import LANE_KEYS, _dump
from tests.test_torch_joined_gather import run_joined

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB9 = os.path.join(ROOT, "tests", "torch_fixtures", "nb9")
SCHEMA = os.path.join(NB9, "schema.json")
CPU = "-Dplatform=cpu"


def _lines(path):
    with open(path) as fh:
        return fh.read().splitlines(True)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _split(src, cuts, dests):
    lines = _lines(src)
    for lo, hi, dest in zip(cuts, cuts[1:], dests):
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "w") as fh:
            fh.write("".join(lines[lo:hi]))


@pytest.fixture(scope="module")
def joined_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nb_joined")
    train = os.path.join(NB9, "data", "tr_part")
    test = os.path.join(NB9, "data", "test_part")
    # the distance lines the joiner reads, from the port's own job
    dist = tmp / "dist"
    assert port_run.main(["sameTypeSimilarity", CPU,
                          f"-Dsts.same.schema.file.path={SCHEMA}",
                          os.path.join(NB9, "data"), str(dist)]) == 0
    n_dist = len(_lines(dist / "part-r-00000"))
    files = {}
    for name, src, cuts in (("eq", train, [0, 130, 260]),
                            ("uneq", train, [0, 160, 260]),
                            ("test", test, [0, 30, 60]),
                            ("text", os.path.join(NB9, "text", "train.txt"),
                             [0, 45, 90])):
        files[name] = [str(tmp / f"{name}{i}.csv") for i in range(2)]
        _split(src, cuts, files[name])
    join_in = [tmp / f"join{i}" for i in range(2)]
    _split(os.path.join(NB9, "cond_prob.csv"), [0, 130, 260],
           [str(d / "condProb_part") for d in join_in])
    _split(str(dist / "part-r-00000"), [0, n_dist // 2, n_dist],
           [str(d / "neighbors") for d in join_in])
    model = os.path.join(NB9, "model.csv")
    runs = []
    for i in range(2):
        runs.append([
            ["bayesianDistribution", CPU,
             f"-Dbad.feature.schema.file.path={SCHEMA}", files["eq"][i],
             str(tmp / f"eq_out{i}")],
            ["bayesianDistribution", CPU,
             f"-Dbad.feature.schema.file.path={SCHEMA}", files["uneq"][i],
             str(tmp / f"uneq_out{i}")],
            ["bayesianPredictor", CPU,
             f"-Dbap.feature.schema.file.path={SCHEMA}",
             f"-Dbap.bayesian.model.file.path={model}", files["test"][i],
             str(tmp / "pred")],
            ["featureCondProbJoiner", CPU, str(join_in[i]),
             str(tmp / f"joined{i}")],
            ["bayesianDistribution", CPU, files["text"][i],
             str(tmp / f"text{i}")]])
    return tmp, run_joined(tmp, runs)


def test_joined_jobs_exit_as_expected(joined_run):
    _, res = joined_run
    for rc, so, se, rcs in res:
        assert rc == 0, se[-3000:]
        # the text mode is refused on both ranks; the rest succeed
        assert rcs == [0, 0, 0, 0, 1], so[-3000:] + se[-3000:]
        assert "JOB_ERROR JobNotPorted" in so
        assert "bayesianDistribution text mode in a joined run" in so


@pytest.mark.parametrize("layout", ["eq", "uneq"])
def test_joined_train_writes_one_process_model(joined_run, layout):
    tmp, _ = joined_run
    want = _read(os.path.join(NB9, "model.csv"))
    for i in range(2):
        assert _read(tmp / f"{layout}_out{i}" / "part-r-00000") == want


def test_joined_train_counters_sum_over_the_ranks(joined_run):
    """Rank 0 prints the counters, summed: every rank counted the global
    model, so each Distribution Data counter is twice one process's."""
    _, res = joined_run
    (_, so0, _, _), (_, so1, _, _) = res
    first = so0.split("JOB_RC")[0]
    got = _dump(first)["Distribution Data"]
    assert got == {"Class prior": 4, "Feature posterior binned ": 32}
    assert "Distribution Data" not in so1


def test_joined_predictor_writes_a_part_file_a_rank(joined_run):
    tmp, _ = joined_run
    pred = tmp / "pred"
    assert sorted(os.listdir(pred)) == ["part-m-00000", "part-m-00001"]
    assert _read(pred / "part-m-00000") + _read(pred / "part-m-00001") == \
        _read(os.path.join(NB9, "pred.csv"))


def test_joined_joiner_reads_the_spool(joined_run):
    tmp, _ = joined_run
    with open(os.path.join(NB9, "joined.sha256")) as fh:
        digest, n = fh.read().split()
    for i in range(2):
        data = _read(tmp / f"joined{i}" / "part-r-00000")
        assert hashlib.sha256(data).hexdigest() == digest
        assert data.count(b"\n") == int(n)
    # every spool was removed
    for i in range(2):
        assert not [f for f in os.listdir(tmp / f"tmp{i}")
                    if f.startswith("avenir_dist_gather_")]


def test_shard_lane_refuses_the_train_by_name(tmp_path, monkeypatch):
    for k in LANE_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("AVENIR_TPU_SHARD", "0/2")
    for extra in ([f"-Dbad.feature.schema.file.path={SCHEMA}"], []):
        with pytest.raises(pjobs.JobNotPorted,
                           match="bayesianDistribution on the shard lane "
                                 ".AVENIR_TPU_SHARD=0/2"):
            port_run.main(["bayesianDistribution", CPU, *extra,
                           os.path.join(NB9, "data", "tr_part"),
                           str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")
