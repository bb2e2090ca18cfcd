"""Candidate-split scoring and the data partitioner in the port
(``avenir_tpu_torch/models/partition.py``, ``cli/partition_jobs.py``)
against the JAX package, on the CPU.

The (split, segment, class) counts are exact integers on both sides
(one composite-key ``bincount`` here, one-hot counts there), so every
criterion, gain ratio, root info and chosen split is equal; the
``randomFromTop`` pick draws the JAX package's numpy stream.  End to end:
the golden disease flow and every tail9 partition case through the port's
CLI byte for byte; without ``-Dplatform=cpu`` the jobs raise on a machine
with no GPU.
"""

import os

import numpy as np
import pytest

from avenir_tpu.core.schema import FeatureSchema as JSchema
from avenir_tpu.models import partition as JPT
from avenir_tpu.models import tree as JT
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.models import partition as PT
from avenir_tpu_torch.models import tree as T
from tests.test_torch_cluster import (case_of, check_job_needs_a_gpu,
                                      check_job_registered, run_tail9_case)
from tests.test_torch_explore import RES, _gen, _tables
from tests.test_torch_sequence import FLOWS, GOLDEN, _PortCLI

PARTITION_JOBS = ("classPartitionGenerator", "dataPartitioner")
SETS = [("campaign", "campaign_gen", [1, 2, 3, 4]),
        ("patient", "patient_gen", [1, 2, 3, 4, 5]),
        ("hosp_readmit", "hosp_readmit_gen", [1, 2, 3, 4, 5])]


@pytest.mark.parametrize("name,gen,attrs", SETS)
@pytest.mark.parametrize("seed", [1, 2])
def test_split_histograms_match(name, gen, attrs, seed):
    jt, pt = _tables(name, _gen(gen, 600, seed))
    jsplits = JT.generate_candidate_splits(jt.schema, attrs)
    psplits = T.generate_candidate_splits(pt.schema, attrs)
    want = JPT.split_histograms(jt, jsplits)
    got = PT.split_histograms(pt, psplits, chunk=97, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,gen,attrs", SETS)
@pytest.mark.parametrize("algo", ["entropy", "giniIndex",
                                  "classConfidenceRatio"])
def test_scored_splits_and_root_info_match(name, gen, attrs, algo):
    jt, pt = _tables(name, _gen(gen, 400, 3))
    assert PT.root_info(pt, algo) == JPT.root_info(jt, algo)
    got = PT.score_candidate_splits(pt, attrs, algo, 0.47, device="cpu")
    want = JPT.score_candidate_splits(jt, attrs, algo, 0.47)
    assert [s.to_line(";") for s in got] == [s.to_line(";") for s in want]


def test_hellinger_needs_two_classes():
    jt, pt = _tables("campaign", _gen("campaign_gen", 300, 4))
    got = PT.score_candidate_splits(pt, [2, 4], "hellingerDistance", 0.5,
                                    device="cpu")
    want = JPT.score_candidate_splits(jt, [2, 4], "hellingerDistance", 0.5)
    assert [s.to_line() for s in got] == [s.to_line() for s in want]
    with pytest.raises(ValueError, match="binary"):
        PT.split_stat(np.ones((2, 3)), 2, "hellingerDistance")


@pytest.mark.parametrize("strategy,seed", [("best", None),
                                           ("randomFromTop", 1),
                                           ("randomFromTop", 23),
                                           ("randomFromTop", 99)])
def test_choose_split_and_partition_rows_match(strategy, seed):
    rows = _gen("campaign_gen", 300, 5)
    jt, pt = _tables("campaign", rows)
    lines = [s.to_line(";") for s in JPT.score_candidate_splits(
        jt, [1, 2, 3, 4], "giniIndex", 0.46)]
    js = JSchema.load(os.path.join(RES, "campaign.json"))
    ps = FeatureSchema.load(os.path.join(RES, "campaign.json"))
    want = JPT.choose_split(lines, js, strategy, 5, seed)
    got = PT.choose_split(lines, ps, strategy, 5, seed)
    assert vars(got) == vars(want)
    assert PT.partition_rows(rows, ps, got) == \
        JPT.partition_rows(rows, js, want)


def test_unknown_categorical_value_refuses():
    ps = FeatureSchema.load(os.path.join(RES, "campaign.json"))
    seg, n = PT.parse_split_key(ps.find_field_by_ordinal(4),
                                "[none]:[opens, clicks]")
    assert n == 2
    np.testing.assert_array_equal(seg(np.array(["clicks", "none"], object)),
                                  [1, 0])
    with pytest.raises(ValueError, match="segment not found"):
        seg(np.array(["bounced"], object))


def test_golden_disease_flow_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(FLOWS, "cli_run", _PortCLI)
    for rel, text in FLOWS.disease_flow(str(tmp_path)).items():
        with open(os.path.join(GOLDEN, rel)) as fh:
            assert text == fh.read(), rel


@pytest.mark.parametrize("case", case_of(PARTITION_JOBS))
def test_tail9_partition_case(tmp_path, case):
    text, counters, want, want_c = run_tail9_case(tmp_path, case)
    assert text == want
    assert counters == want_c


@pytest.mark.parametrize("job", PARTITION_JOBS)
def test_partition_job_registered(job):
    check_job_registered(job)


@pytest.mark.parametrize("job", PARTITION_JOBS)
def test_partition_job_raises_without_a_gpu_unless_asked_for_the_cpu(
        tmp_path, job):
    check_job_needs_a_gpu(tmp_path, job)
