"""Make the tail9 fixture with the JAX package, on the CPU, in one process
with one JAX device: the cluster, explore, partition and discriminant
jobs on what the golden fixtures do not pin.

``data/`` holds every case's input, drawn here from numpy seeds and the
repo's generators (``resource/gen``).  Each case (``CASES``) is one job
over one input with a few keys; it writes ``<case>/out.csv`` and
``<case>/counters.json`` (its counter groups, without the run's
``Collectives``, ``Profiling`` and ``Transfers``, and without the port's
``IngestReaders``, which names the CSV reader that parsed the input).  ``out.csv`` is the
job's part files concatenated; for a job that writes a directory tree
(the distance store, the data partitioner) every file of the tree under a
``## <path>`` line.  Agglomerative cluster ids are fresh ``uuid4`` hex on
every run of either package, so they are written as ``C<i>`` in the order
of the lines.  A case may first run another case (``PRE``) into the work
directory and read its output there (``{work}``), or read a file of this
fixture (``{fix}``):

  kmeans            kmeansCluster, 3 groups over numeric and categorical
                    attributes, 60 iterations: group A starts with two
                    equal centroids (every row ties, the second cluster
                    stays empty), clusters stop by movement
  kmeans_one        one Lloyd pass (the reference's default), numeric only
  store             entityDistanceStore (the index and data files)
  agg_store         agglomerativeGraphical over that store, distances
  agg_lines         agglomerativeGraphical over distance lines in memory
  fisher            fisherDiscriminant over patient_gen
  svm_grouped       supportVectorMachine, serial, one SVM a plan
  svm_batched       supportVectorMachine, svm.solver=batched, C = 0.01
  svm_grouped_batched  the batched solver over the plan groups
  svm_batched_pred  supportVectorPredictor over svm_batched's model
  svm_serial        supportVectorMachine, serial, C = 0.01
  svm_serial_pred   supportVectorPredictor over svm_serial's model
  mi_all            mutualInformation, all five score algorithms
  numcorr, numcorr_pairs  numericalCorrelation, all pairs and nuc.attr.pairs
  cramer            cramerCorrelation
  hetero_gini, hetero_entropy  heterogeneityReductionCorrelation
  affinity          categoricalClassAffinity
  encoding_woe      categoricalContinuousEncoding, weightOfEvidence
  sts               sameTypeSimilarity over machine_failure_gen (ovsa)
  topmatches        topMatchesByClass over sts's distances (ovsa)
  topmatches_dist   the same by distance (tmc.nearest.by.count=false)
  smote             classBasedOverSampler (ovsa's keys)
  undersample       underSamplingBalancer
  relief            reliefFeatureRelevance with a sample count
  adaboost_error    adaBoostError, weight normalized and not
  adaboost_error_mean
  adaboost_update   adaBoostUpdate
  adaboost_reset    adaBoostUpdate with an error above 0.5
  bagging           baggingSampler over batches of 40
  cpg_root_entropy  classPartitionGenerator root mode, entropy
  cpg_campaign      classPartitionGenerator, giniIndex (retarget)
  cpg_entropy       the same with entropy
  cpg_hellinger     hellingerDistance
  cpg_conf          classConfidenceRatio
  partition_best    dataPartitioner, best (retarget)
  partition_random  dataPartitioner, randomFromTop with a seed

The JAX package inside pytest has 8 CPU devices; this maker runs with one
(``XLA_FLAGS`` set before JAX is imported).  The port is held against
these files by ``tests/test_torch_cluster.py``, ``test_torch_explore.py``,
``test_torch_partition.py`` and ``test_torch_discriminant.py`` on the CPU
and by ``chip_smoke.py`` on the GPU: byte for byte, save the outputs
``TOLERANCE`` names.  Regenerate from the repo root:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/tail9/make.py
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
# counter groups a run adds around the job (wall times, the ledger, the
# port's reader tallies)
RUN_GROUPS = ("Collectives", "IngestReaders", "Profiling", "Transfers")
KMC = ("-Dkmc.schema.file.path={fix}/data/kmeans.json",
       "-Dkmc.cluster.file.path={fix}/data/clusters.csv",
       "-Dkmc.movement.threshold=0.01", "-Dnads.output.precision=3")
SVM = ("-Dsvm.feature.schema.file.path={res}/churn_svm.json",
       "-Dsvm.positive.class.value=churned", "-Dsvm.random.seed=5",
       "-Dsvm.pnalty.factor=0.01")
HOSP = "{res}/hosp_readmit.json"
MACHINE = "{res}/machine_failure.json"
CAMPAIGN = ("-Dcpg.feature.schema.file.path={res}/campaign.json",
            "-Dcpg.split.file.delim=;")
DAP = ("-Ddap.feature.schema.file.path={res}/campaign.json",
       "-Ddap.candidate.splits.path={fix}/cpg_campaign/out.csv",
       "-Ddap.split.file.delim=;")
ABE = ("-Dabe.actual.class.attr.ordinal=1", "-Dabe.pred.class.attr.ordinal=2",
       "-Dabe.boost.attr.ordinal=3")
ABU = ("-Dabu.actual.class.attr.ordinal=1", "-Dabu.pred.class.attr.ordinal=2",
       "-Dabu.boost.attr.ordinal=3", "-Dabu.output.precision=6")
# case -> (job, input under data/ or "{fix}"/"{work}" path, -D keys)
CASES = {
    "kmeans": ("kmeansCluster", "kmeans.csv",
               KMC + ("-Dkmc.attr.odinals=1,2,3,4,5,6",
                      "-Dkmc.num.iterations=60")),
    "kmeans_one": ("kmeansCluster", "kmeans.csv",
                   KMC + ("-Dkmc.attr.odinals=1,2,3,4,5",)),
    "store": ("entityDistanceStore", "distances.csv", ()),
    "agg_store": ("agglomerativeGraphical", "entities.csv",
                  ("-Dagg.map.file.dir.path={work}/store",
                   "-Dagg.min.av.edge.weight.threshold=600",
                   "-Dagg.dist.scale=1000")),
    "agg_lines": ("agglomerativeGraphical", "entities.csv",
                  ("-Dagg.map.file.dir.path={fix}/data/similarities.csv",
                   "-Dagg.min.av.edge.weight.threshold=450")),
    "fisher": ("fisherDiscriminant", "patients.csv",
               ("-Dfid.feature.schema.file.path={res}/patient.json",)),
    "svm_grouped": ("supportVectorMachine", "churn.csv",
                    SVM + ("-Dsvm.group.field.ordinals=1",)),
    "svm_batched": ("supportVectorMachine", "churn.csv",
                    SVM + ("-Dsvm.solver=batched",)),
    "svm_grouped_batched": ("supportVectorMachine", "churn.csv",
                            SVM + ("-Dsvm.solver=batched",
                                   "-Dsvm.group.field.ordinals=1")),
    "svm_batched_pred": ("supportVectorPredictor", "churn.csv",
                         SVM + ("-Dsvm.model.file.path="
                                "{fix}/svm_batched/out.csv",
                                "-Dvalidation.mode=true")),
    "svm_serial": ("supportVectorMachine", "churn.csv", SVM),
    "svm_serial_pred": ("supportVectorPredictor", "churn.csv",
                        SVM + ("-Dsvm.model.file.path="
                               "{fix}/svm_serial/out.csv",
                               "-Dvalidation.mode=true")),
    "mi_all": ("mutualInformation", "hosp.csv",
               (f"-Dmut.feature.schema.file.path={HOSP}",
                "-Dmut.mutual.info.score.algorithms=mutual.info.maximization,"
                "mutual.info.feature.selection,joint.mutual.info,"
                "double.input.symmetrical.relevance,"
                "min.redundancy.max.relevance",
                "-Dmut.mutual.info.redundancy.factor=0.5")),
    "numcorr": ("numericalCorrelation", "hosp.csv",
                (f"-Dnuc.schema.file.path={HOSP}",)),
    "numcorr_pairs": ("numericalCorrelation", "hosp.csv",
                      (f"-Dnuc.schema.file.path={HOSP}",
                       "-Dnuc.attr.pairs=1:2,4:1")),
    "cramer": ("cramerCorrelation", "hosp.csv",
               (f"-Dcrc.feature.schema.file.path={HOSP}",
                "-Dcrc.source.attributes=3,5", "-Dcrc.dest.attributes=5,6")),
    "hetero_gini": ("heterogeneityReductionCorrelation", "calls.csv",
                    ("-Dhrc.feature.schema.file.path={res}/cust_call.json",)),
    "hetero_entropy": ("heterogeneityReductionCorrelation", "calls.csv",
                       ("-Dhrc.feature.schema.file.path={res}/cust_call.json",
                        "-Dhrc.heterogeneity.algorithm=entropy",
                        "-Dhrc.attributes=1,2,4")),
    "affinity": ("categoricalClassAffinity", "hosp.csv",
                 (f"-Dcca.feature.schema.file.path={HOSP}",)),
    "encoding_woe": ("categoricalContinuousEncoding", "hosp.csv",
                     (f"-Dcoe.feature.schema.file.path={HOSP}",
                      "-Dcoe.cat.attribute.ordinals=3,5",
                      "-Dcoe.class.attr.ordinal=6",
                      "-Dcoe.pos.class.attr.value=T",
                      "-Dcoe.encoding.strategy=weightOfEvidence",
                      "-Dcoe.output.scale=100")),
    "sts": ("sameTypeSimilarity", "machines.csv",
            (f"-Dsts.same.schema.file.path={MACHINE}",
             "-Dsts.distance.scale=1000")),
    "topmatches": ("topMatchesByClass", "{fix}/sts/out.csv",
                   ("-Dtmc.top.match.count=5", "-Dtmc.filer.class.value=T")),
    "topmatches_dist": ("topMatchesByClass", "{fix}/sts/out.csv",
                        ("-Dtmc.nearest.by.count=false",
                         "-Dtmc.match.distance=150")),
    "smote": ("classBasedOverSampler", "machines.csv",
              (f"-Dcbos.feature.schema.file.path={MACHINE}",
               "-Dcbos.minority.class.value=T", "-Dcbos.neighbor.count=5",
               "-Dcbos.over.sampling.multiplier=4", "-Dcbos.random.seed=7")),
    "undersample": ("underSamplingBalancer", "machines.csv",
                    (f"-Dusb.feature.schema.file.path={MACHINE}",
                     "-Dusb.majority.class.value=F",
                     "-Dusb.sampling.rate=0.3", "-Dusb.random.seed=11")),
    "relief": ("reliefFeatureRelevance", "patients.csv",
               ("-Dffr.attr.schema.file.path={res}/patient.json",
                "-Dffr.attr.ordinals=1,2,3,4,5", "-Dffr.sample.count=120",
                "-Dffr.random.seed=13")),
    "adaboost_error": ("adaBoostError", "boost.csv", ABE),
    "adaboost_error_mean": ("adaBoostError", "boost.csv",
                            ABE + ("-Dabe.weight.normalized=false",
                                   "-Dabe.output.precision=9")),
    "adaboost_update": ("adaBoostUpdate", "boost.csv",
                        ABU + ("-Dabu.iteration.error=0.21",)),
    "adaboost_reset": ("adaBoostUpdate", "boost.csv",
                       ABU + ("-Dabu.iteration.error=0.62",
                              "-Dabu.initial.weight=0.5")),
    "bagging": ("baggingSampler", "bag.csv",
                ("-Dbas.batch.size=40", "-Dbas.random.seed=17")),
    "cpg_root_entropy": ("classPartitionGenerator", "campaign.csv",
                         CAMPAIGN + ("-Dcpg.split.algorithm=entropy",)),
    "cpg_campaign": ("classPartitionGenerator", "campaign.csv",
                     CAMPAIGN + ("-Dcpg.split.attributes=1,2,3,4",
                                 "-Dcpg.parent.info=0.46")),
    "cpg_entropy": ("classPartitionGenerator", "campaign.csv",
                    CAMPAIGN + ("-Dcpg.split.algorithm=entropy",
                                "-Dcpg.split.attributes=1,3,4",
                                "-Dcpg.parent.info=0.92")),
    "cpg_hellinger": ("classPartitionGenerator", "campaign.csv",
                      CAMPAIGN + ("-Dcpg.split.algorithm=hellingerDistance",
                                  "-Dcpg.split.attributes=2,4",
                                  "-Dcpg.parent.info=0.5")),
    "cpg_conf": ("classPartitionGenerator", "campaign.csv",
                 CAMPAIGN + ("-Dcpg.split.algorithm=classConfidenceRatio",
                             "-Dcpg.split.attributes=1,4",
                             "-Dcpg.parent.info=0.5")),
    "partition_best": ("dataPartitioner", "campaign.csv", DAP),
    "partition_random": ("dataPartitioner", "campaign.csv",
                         DAP + ("-Ddap.split.selection.strategy=randomFromTop",
                                "-Ddap.num.top.splits=6", "-Ddap.seed=23")),
}
# a case run first into the work directory (its output read as {work})
PRE = {"agg_store": "store"}
# agglomerative ids are uuid4 hex on every run
RENAMED_IDS = ("agg_store", "agg_lines")
# outputs held to a tolerance, not byte for byte (the float32 sums the
# port does not order as XLA does; :func:`compare` applies them): case ->
# what is compared
TOLERANCE = {
    "fisher": "each number within 1e-4 relative (float32 class moments)",
    "svm_batched": "weights within 1e-2 of the largest, threshold within "
                   "1e-2; support-vector lines counted",
    "svm_grouped_batched": "as svm_batched, a group at a time",
    "kmeans": "avError within 2e-3 (float64 sums of dmin^2 rounded to "
              "float32; printed to 3 decimals); every other field exact",
    "sts": "one distance of 11,175 one apart (sameTypeSimilarity's "
           "pairwise order, ROADMAP §C)",
}
F_RTOL, W_TOL, B_TOL, AV_ERROR_ATOL, STS_LINES_APART = \
    1e-4, 1e-2, 1e-2, 2e-3, 1
KMEANS_SCHEMA = {"fields": [
    {"name": "custId", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "visitsPerMonth", "ordinal": 1, "dataType": "int",
     "feature": True, "min": 0, "max": 60},
    {"name": "avgSpend", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 500},
    {"name": "recencyDays", "ordinal": 3, "dataType": "int",
     "feature": True, "min": 0, "max": 365},
    {"name": "basketSize", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 1, "max": 40},
    {"name": "discountShare", "ordinal": 5, "dataType": "int",
     "feature": True, "min": 0, "max": 100},
    {"name": "tier", "ordinal": 6, "dataType": "categorical",
     "feature": True, "cardinality": ["bronze", "silver", "gold"]}]}


def _gen(name, *args):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    import importlib
    return importlib.import_module(f"gen.{name}").generate(*args)


def make_data(out_dir: str) -> None:
    """Write every case's input under ``<out_dir>/data``."""
    data = os.path.join(out_dir, "data")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)

    def _write(name, lines):
        with open(os.path.join(data, name), "w") as fh:
            fh.write("".join(ln + "\n" for ln in lines))
    rng = np.random.default_rng(9)
    with open(os.path.join(data, "kmeans.json"), "w") as fh:
        json.dump(KMEANS_SCHEMA, fh, indent=1)
    tiers = KMEANS_SCHEMA["fields"][6]["cardinality"]
    cust = [f"{ln},{tiers[int(t)]}" for ln, t in zip(
        _gen("cust_seg_gen", 240, 81), rng.integers(0, 3, 240))]
    _write("kmeans.csv", cust)
    rows = [ln.split(",") for ln in cust]
    clusters = []
    for group, picks in (("A", (3, 3, 50, 120)), ("B", (7, 90, 200)),
                         ("C", (11, 40, 77, 150, 230))):
        for r in picks:
            clusters.append(",".join([group, "null"] + rows[r][1:]
                                     + ["inf", "active"]))
    _write("clusters.csv", clusters)
    pts = rng.random((24, 2))
    ids = [f"E{i:02d}" for i in range(24)]
    dist = lambda i, j: int(1000 * np.hypot(*(pts[i] - pts[j])))  # noqa: E731
    _write("distances.csv", [
        ",".join([ids[i]] + [f"{ids[j]},{dist(i, j)}" for j in range(24)
                             if j != i]) for i in range(24)])
    _write("similarities.csv", [
        ",".join([ids[i]] + [f"{ids[j]},{1000 - dist(i, j)}.0"
                             for j in range(24) if j != i and j % 3 != i % 3])
        for i in range(24)])
    order = rng.permutation(24)
    _write("entities.csv", [f"{ids[i]},x{i}" for i in order])
    _write("patients.csv", _gen("patient_gen", 300, 83))
    _write("churn.csv", _gen("churn_svm_gen", 300, 84))
    _write("hosp.csv", _gen("hosp_readmit_gen", 300, 85))
    _write("calls.csv", _gen("cust_call_gen", 300, 86))
    _write("machines.csv", _gen("machine_failure_gen", 150, 87))
    _write("campaign.csv", _gen("campaign_gen", 300, 88))
    labels = ("yes", "no", "maybe")
    _write("boost.csv", [
        f"r{i},{labels[int(a)]},{labels[int(p)]},{w:.4f}" for i, (a, p, w)
        in enumerate(zip(rng.integers(0, 3, 60),
                         rng.integers(0, 3, 60), rng.random(60) / 60))])
    _write("bag.csv", [f"b{i},{int(rng.integers(0, 1000))}"
                       for i in range(100)])


def case_args(case, fix, work):
    """(job, argv) of one case: its input, output dir ``work/case``."""
    job, inp, keys = CASES[case]

    def sub(s):
        return s.replace("{fix}", fix).replace("{res}", RES) \
            .replace("{work}", work)
    src = sub(inp) if "{" in inp else os.path.join(fix, "data", inp)
    return job, [job, *(sub(k) for k in keys), src,
                 os.path.join(work, case)]


def read_output(out: str, case: str) -> str:
    """The text a case's output is compared by (module docstring)."""
    if os.path.isfile(os.path.join(out, "part-r-00000")) or any(
            p.startswith("part-") for p in os.listdir(out)):
        text = "".join(open(os.path.join(out, p)).read()
                       for p in sorted(os.listdir(out))
                       if p.startswith("part-"))
    else:
        parts = []
        for d, _, files in sorted(os.walk(out)):
            for f in sorted(files):
                path = os.path.join(d, f)
                parts.append(f"## {os.path.relpath(path, out)}\n"
                             + open(path).read())
        text = "".join(parts)
    if case in RENAMED_IDS:
        text = "".join(f"C{i}," + ln.split(",", 1)[1] + "\n"
                       for i, ln in enumerate(text.splitlines()))
    return text


def _weights(text):
    """{group: (weights, threshold)} of a model file's weights lines."""
    out = {}
    for line in text.splitlines():
        parts = line.split(",")
        if "weights" in parts:
            i = parts.index("weights")
            vals = [float(v) for v in parts[i + 1:]]
            out[",".join(parts[:i])] = (np.array(vals[:-1]), vals[-1])
    return out


def compare(case, got, want):
    """Hold a case's output text to the fixture's: byte for byte, or for a
    case of ``TOLERANCE`` within it.  Returns the number of lines that
    differ; raises ``AssertionError`` past the tolerance."""
    a, b = got.splitlines(), want.splitlines()
    apart = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    if case not in TOLERANCE:
        assert got == want, f"{case}: {apart} lines differ"
        return 0
    if case == "fisher":
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.array(x.split(","), float),
                                       np.array(y.split(","), float),
                                       rtol=F_RTOL, err_msg=case)
    elif case == "kmeans":
        for x, y in zip(a, b):
            xs, ys = x.split(","), y.split(",")
            assert xs[:-2] + xs[-1:] == ys[:-2] + ys[-1:], (case, x, y)
            assert abs(float(xs[-2]) - float(ys[-2])) <= AV_ERROR_ATOL, \
                (case, x, y)
    elif case == "sts":
        assert apart <= STS_LINES_APART, f"{case}: {apart} lines differ"
        for x, y in zip(a, b):
            xs, ys = x.split(","), y.split(",")
            assert xs[:2] + xs[3:] == ys[:2] + ys[3:] and \
                abs(int(xs[2]) - int(ys[2])) <= 1, (case, x, y)
    else:
        gw, ww = _weights(got), _weights(want)
        assert gw.keys() == ww.keys(), case
        for g, (w, t) in ww.items():
            assert np.abs(gw[g][0] - w).max() <= W_TOL * np.abs(w).max(), \
                (case, g)
            assert abs(gw[g][1] - t) <= B_TOL, (case, g)
    assert len(a) == len(b) or case.startswith("svm"), case
    return apart


def run_case(main, fix, work, case, extra=()):
    """Run ``case`` (after its PRE case) through a CLI ``main`` (either
    package's); returns (output text, counters dict without the run's
    groups)."""
    pre = PRE.get(case)
    if pre and not os.path.exists(os.path.join(work, pre)):
        run_case(main, fix, work, pre, extra)
    _, argv = case_args(case, fix, work)
    if main(argv + list(extra)) != 0:
        raise RuntimeError(f"case {case} failed")
    out = os.path.join(work, case)
    with open(out + ".counters.json") as fh:
        counters = {g: v for g, v in json.load(fh).items()
                    if g not in RUN_GROUPS}
    return read_output(out, case), counters


def make(out_dir: str = HERE) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() == 1, jax.devices()
    from avenir_tpu.cli import run
    make_data(out_dir)
    with tempfile.TemporaryDirectory() as work:
        for case in CASES:
            text, counters = run_case(run.main, out_dir, work, case)
            d = os.path.join(out_dir, case)
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            with open(os.path.join(d, "out.csv"), "w") as fh:
                fh.write(text)
            with open(os.path.join(d, "counters.json"), "w") as fh:
                json.dump(counters, fh, indent=2, sort_keys=True)
                fh.write("\n")


if __name__ == "__main__":
    make()
