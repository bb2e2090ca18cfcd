"""The cluster family in the port (``avenir_tpu_torch/cluster``,
``io/diststore.py``, ``cli/cluster_jobs.py``) against the JAX package, on
the CPU, and the tail9 fixture's shared checks.

The k-means distance is the JAX package's float32 arithmetic element for
element (read from XLA's optimized HLO: reciprocal products, an FMA for
the centroid's scaled difference, an FMA chain over the squares), so on
integer-valued attributes the assignments, counts, centroids and
movements equal the JAX package's bit for bit; ``avError`` (a float64 sum
of squared distances rounded to float32, where XLA sums in float32) is
held to ``AV_ERROR_RTOL`` (and in the printed files to the maker's
``compare``).  The distance store writes the same index and
data bytes and answers the same lookups; the agglomerative pass the same
clusters (its ids are uuid4 on both sides).  Every tail9 case of these
jobs runs through the port's CLI byte for byte; a joined run of two gloo
ranks gives the one-process clusters; without ``-Dplatform=cpu`` the
jobs raise on a machine with no GPU.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avenir_tpu.cli import jobs as jax_jobs
from avenir_tpu.cli import run as jax_run
from avenir_tpu.cluster import agglomerative as JAG
from avenir_tpu.cluster import kmeans as JKM
from avenir_tpu.core.schema import FeatureSchema as JSchema
from avenir_tpu.core.table import load_csv as jload
from avenir_tpu.io.diststore import EntityDistanceStore as JStore
from avenir_tpu_torch.cli import jobs as port_jobs
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.cluster import agglomerative as AG
from avenir_tpu_torch.cluster import kmeans as KM
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv
from avenir_tpu_torch.io.diststore import EntityDistanceStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAIL9 = os.path.join(ROOT, "tests", "torch_fixtures", "tail9")
CPU = "-Dplatform=cpu"
AV_ERROR_RTOL = 2e-6


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _load("tail9_make", os.path.join(TAIL9, "make.py"))
CLUSTER_JOBS = ("kmeansCluster", "agglomerativeGraphical",
                "entityDistanceStore")


def case_of(job_names):
    return [c for c, (job, _, _) in MAKE.CASES.items() if job in job_names]


def run_tail9_case(tmp_path, case):
    """The port's CLI over one tail9 case: (output text, counters,
    fixture text, fixture counters)."""
    text, counters = MAKE.run_case(port_run.main, TAIL9, str(tmp_path),
                                   case, (CPU,))
    with open(os.path.join(TAIL9, case, "out.csv")) as fh:
        want = fh.read()
    with open(os.path.join(TAIL9, case, "counters.json")) as fh:
        want_c = json.load(fh)
    return text, counters, want, want_c


def _jax_names():
    assert jax_run  # the JAX CLI's import registers every job
    names = {}
    for name, fn in jax_jobs.JOBS.items():
        names.setdefault(fn, []).append(name)
    return names


def check_job_registered(job):
    """``job`` resolves in the port under every name the JAX package
    registers it under, with the JAX package's multi-process mode."""
    jfn = jax_jobs.resolve(job)
    pfn = port_jobs.resolve(job)
    for name in _jax_names()[jfn]:
        assert port_jobs.resolve(name) is pfn, name
    assert port_jobs.dist_mode(pfn) == jax_jobs.dist_mode(jfn)


def check_job_needs_a_gpu(tmp_path, job):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        port_run.main([job, str(tmp_path / "in.csv"),
                       str(tmp_path / "out")])


# --------------------------------------------------------------------------
# k-means
# --------------------------------------------------------------------------

SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "a", "ordinal": 1, "dataType": "int", "feature": True,
     "min": 0, "max": 60},
    {"name": "b", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 7},
    {"name": "c", "ordinal": 3, "dataType": "int", "feature": True,
     "min": 0, "max": 365},
    {"name": "d", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 3, "max": 40},
    {"name": "t", "ordinal": 5, "dataType": "categorical", "feature": True,
     "cardinality": ["x", "y", "z"]},
    {"name": "u", "ordinal": 6, "dataType": "categorical", "feature": True,
     "cardinality": ["p", "q"]}]}


def _engines(attrs):
    return (JKM.KMeansEngine(JSchema.from_dict(SCHEMA), attrs),
            KM.KMeansEngine(FeatureSchema.from_dict(SCHEMA), attrs,
                            device="cpu"))


def _kmeans_inputs(seed, n, G, K, attrs):
    rng = np.random.default_rng(seed)
    hi = {1: 61, 2: 8, 3: 366, 4: 41}
    nums = [o for o in attrs if o <= 4]
    cats = [o for o in attrs if o >= 5]
    num = np.stack([rng.integers(0, hi[o], n) for o in nums], 1).astype(
        np.float32) if nums else np.zeros((n, 0), np.float32)
    cat = np.stack([rng.integers(0, 3 if o == 5 else 2, n) for o in cats],
                   1).astype(np.int32) if cats else np.zeros((n, 0), np.int32)
    cn = np.stack([rng.integers(0, hi[o], (G, K)) for o in nums],
                  2).astype(np.float32) if nums else np.zeros((G, K, 0),
                                                              np.float32)
    cc = np.stack([rng.integers(0, 3 if o == 5 else 2, (G, K))
                   for o in cats], 2).astype(np.int32) if cats else \
        np.zeros((G, K, 0), np.int32)
    # a centroid equal to another (every row ties between them) and a
    # padded cluster slot
    cn[0, 1], cc[0, 1] = cn[0, 0], cc[0, 0]
    valid = np.ones((G, K), bool)
    valid[-1, -1] = False
    return num, cat, {"cent_num": cn, "cent_cat": cc, "valid": valid}


ATTR_SETS = [(1, 2, 3, 4, 5, 6), (1, 2, 3, 4), (1, 3), (5, 6), (2, 4, 6)]


def _torch_form(pe, num, cat, enc):
    d = pe._distances(torch.from_numpy(num), torch.from_numpy(cat),
                      torch.from_numpy(enc["cent_num"]),
                      torch.from_numpy(enc["cent_cat"]),
                      torch.from_numpy(enc["valid"]))
    return d


@pytest.mark.parametrize("attrs", ATTR_SETS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_distance_is_the_jax_float32(attrs, seed):
    """The torch form (the same on the CPU and the card) gives the JAX
    package's jitted ``_distances`` bit for bit on its first call, and
    so its minimum and first index, group by group."""
    import jax
    je, pe = _engines(list(attrs))
    num, cat, enc = _kmeans_inputs(seed, 2000, 3, 5, attrs)
    dist = jax.jit(je._distances)
    want = np.stack([np.asarray(dist(num, cat, enc["cent_num"][g],
                                     enc["cent_cat"][g], enc["valid"][g]))
                     for g in range(3)])
    got = _torch_form(pe, num, cat, enc)
    np.testing.assert_array_equal(got.numpy(), want)
    dmin, assign = torch.min(got, dim=2)
    np.testing.assert_array_equal(dmin.numpy(), want.min(axis=2))
    np.testing.assert_array_equal(assign.numpy(), want.argmin(axis=2))


FIRST_CALL = """
import sys
import jax
import numpy as np
import torch
from tests.test_torch_cluster import _engines, _kmeans_inputs, _torch_form
attrs, seed = [1, 2, 3, 4, 5, 6], int(sys.argv[1])
je, pe = _engines(attrs)
num, cat, enc = _kmeans_inputs(seed, 5000, 3, 5, attrs)
dist = jax.jit(je._distances)
want = np.stack([np.asarray(dist(num, cat, enc["cent_num"][g],
                                 enc["cent_cat"][g], enc["valid"][g]))
                 for g in range(3)])
print(int((_torch_form(pe, num, cat, enc).numpy() != want).sum()))
"""


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_kmeans_distance_first_call_in_a_fresh_process(seed):
    """The torch form's first call in a process that has loaded jaxlib
    (and run the JAX package's distance) is already the JAX package's
    float32, element for element."""
    out = subprocess.run(
        [sys.executable, "-c", FIRST_CALL, str(seed)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "0"


@pytest.mark.parametrize("attrs", ATTR_SETS)
@pytest.mark.parametrize("seed", [3, 4])
def test_kmeans_iteration_matches_the_jax_package(attrs, seed):
    """One Lloyd update over stacked groups: counts, centroids, movements
    bit for bit, avError within AV_ERROR_RTOL; the tied centroid's twin
    stays empty and keeps its place."""
    je, pe = _engines(list(attrs))
    num, cat, enc = _kmeans_inputs(seed, 3000, 3, 4, attrs)
    ones = np.ones(len(num), np.float32)
    want = je.iterate(num, cat, ones, enc)
    got = pe.iterate(*pe.upload(num, cat, ones), enc)
    for k in ("counts", "cent_num", "cent_cat", "movement"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    np.testing.assert_allclose(got["av_error"], np.asarray(want["av_error"]),
                               rtol=AV_ERROR_RTOL)
    assert got["counts"][0, 1] == 0


def test_kmeans_chunked_pass_equals_one_pass():
    """Row chunks change nothing: the contractions sum in float64."""
    _, pe = _engines([1, 2, 3, 4, 5, 6])
    num, cat, enc = _kmeans_inputs(5, 3001, 2, 5, (1, 2, 3, 4, 5, 6))
    t = pe.upload(num, cat, np.ones(len(num), np.float32))
    a = pe.partials(*t, enc)
    b = pe.partials(*t, enc, chunk=700)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def _cust_seg_text(n, seed):
    """cust_seg rows drawn vectorised from its generator's model."""
    sys.path.insert(0, os.path.join(ROOT, "resource"))
    try:
        from gen import cust_seg_gen as cs
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(seed)
    seg = rng.integers(len(cs.SEGMENTS), size=n)
    lo, hi = np.asarray(cs.CLIP, np.float64).T
    vals = np.clip(rng.normal(np.asarray(cs.SEGMENTS, np.float64)[seg],
                              cs.SPREAD), lo, hi).astype(np.int64)
    return "\n".join(f"U{i:07d}," + ",".join(map(str, v))
                     for i, v in enumerate(vals.tolist()))


# k-means past 2^24: (customers, printed strings apart, of all) — a
# cluster's avgSpend sum passes 2^24 (~100,000 rows of ~180), where the
# JAX package's float32 contraction rounds and the port's float64 sum
# does not; the centroids print as rounded integers, movement and
# avError to 3 places
KMEANS_PAST_F32 = (200_000, 0, 99)


def test_kmeans_past_float32_sums():
    """The whole run (3 groups of 2, 3 and 4 clusters, cluster.properties'
    attributes and threshold) against the JAX package's ``run_kmeans``:
    the same iterations, and its printed strings save the stated count.
    In the first iteration the port's centroid sums are the exact ones and
    its counts the JAX package's, whose float32 centroids differ from the
    port's by rounding alone."""
    from avenir_tpu.core.table import load_csv_text as jtext
    from avenir_tpu_torch.core.table import load_csv_text as ptext
    n, apart, total = KMEANS_PAST_F32
    text = _cust_seg_text(n, 31)
    path = os.path.join(ROOT, "resource", "cust_seg.json")
    jt = jtext(text, JSchema.load(path))
    pt = ptext(text, FeatureSchema.load(path))
    attrs, sizes = [1, 2, 3, 4, 5], {"g2": 2, "g3": 3, "g4": 4}
    je = JKM.KMeansEngine(jt.schema, attrs)
    pe = KM.KMeansEngine(pt.schema, attrs, device="cpu")
    jg = JKM.init_groups(jt, je, sizes, 0.01, seed=5)
    pg = KM.init_groups(pt, pe, sizes, 0.01, seed=5)
    enc = pe.encode_groups(pg)
    num, cat = pe.encode_table(pt)
    ones = np.ones(n, np.float32)
    rows = pe.upload(num, cat, ones)
    parts = pe.partials(*rows, enc)
    assert parts["sum_num"].max() > 2 ** 24
    d = _torch_form(pe, num, cat, enc).numpy()
    for g in range(3):
        slot = d[g].argmin(1)
        for fi in range(num.shape[1]):
            np.testing.assert_array_equal(
                parts["sum_num"][g, :, fi],
                np.bincount(slot, num[:, fi].astype(np.float64), 4))
    want = je.iterate(num, cat, ones, enc)
    got = pe.iterate(*rows, enc)
    np.testing.assert_array_equal(got["counts"], np.asarray(want["counts"]))
    assert (got["cent_num"] != np.asarray(want["cent_num"])).any()
    np.testing.assert_allclose(got["cent_num"], np.asarray(want["cent_num"]),
                               rtol=1e-6)
    jg, jit = JKM.run_kmeans(jt, jg, je, max_iter=60)
    pg, pit = KM.run_kmeans(pt, pg, pe, max_iter=60)
    assert pit == jit
    a, b = KM.format_cluster_lines(pg), JKM.format_cluster_lines(jg)
    pairs = [(x, y) for la, lb in zip(a, b)
             for x, y in zip(la.split(","), lb.split(","))]
    assert len(pairs) == total
    assert sum(x != y for x, y in pairs) == apart


def test_kmeans_init_groups_draw_the_jax_rows():
    path = os.path.join(TAIL9, "data", "kmeans.csv")
    js = JSchema.load(os.path.join(TAIL9, "data", "kmeans.json"))
    ps = FeatureSchema.load(os.path.join(TAIL9, "data", "kmeans.json"))
    attrs = [1, 2, 3, 4, 5, 6]
    want = JKM.init_groups(jload(path, js), JKM.KMeansEngine(js, attrs),
                           {"g1": 4, "g2": 3}, 0.01, seed=7)
    got = KM.init_groups(load_csv(path, ps),
                         KM.KMeansEngine(ps, attrs, device="cpu"),
                         {"g1": 4, "g2": 3}, 0.01, seed=7)
    assert KM.format_cluster_lines(got) == JKM.format_cluster_lines(want)


def test_kmeans_assign_and_store(tmp_path):
    """``assign`` is the argmin of the JAX package's distances; a store
    keeps each iteration's cluster file."""
    from avenir_tpu_torch.core.artifacts import ArtifactStore
    path = os.path.join(TAIL9, "data", "kmeans.csv")
    ps = FeatureSchema.load(os.path.join(TAIL9, "data", "kmeans.json"))
    js = JSchema.load(os.path.join(TAIL9, "data", "kmeans.json"))
    lines = open(os.path.join(TAIL9, "data", "clusters.csv")).read(
        ).splitlines()
    pg = KM.parse_cluster_lines(lines, ps.num_columns, 0.01)
    jg = JKM.parse_cluster_lines(lines, js.num_columns, 0.01)
    attrs = [1, 2, 3, 4, 5, 6]
    pe = KM.KMeansEngine(ps, attrs, device="cpu")
    je = JKM.KMeansEngine(js, attrs)
    pt, jt = load_csv(path, ps), jload(path, js)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(pe.assign(pt, a), je.assign(jt, b))
    store = ArtifactStore(str(tmp_path / "store"))
    _, it = KM.run_kmeans(pt, pg, pe, max_iter=3, store=store)
    assert it == 3
    assert sorted(os.listdir(store.base_dir)) == [
        "centroids.csv", "centroids_iter_1.csv", "centroids_iter_2.csv",
        "centroids_iter_3.csv"]


# --------------------------------------------------------------------------
# the distance store and the agglomerative pass
# --------------------------------------------------------------------------

def test_distance_store_bytes_and_lookups(tmp_path):
    src = os.path.join(TAIL9, "data", "distances.csv")
    a = EntityDistanceStore.write_from_file(src, str(tmp_path / "p"))
    b = JStore.write_from_file(src, str(tmp_path / "j"))
    for f in ("data.txt", "index.json"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    with EntityDistanceStore(str(tmp_path / "j")) as pj:
        for key in b.keys() + ["E99"]:
            assert pj.read(key) == b.read(key), key
            assert pj.read_raw(key) == b.read_raw(key)
    assert a.keys() == b.keys()
    b.close()
    a.close()


@pytest.mark.parametrize("threshold,scale", [(450.0, None), (600.0, 1000.0),
                                             (800.0, 1000.0)])
def test_agglomerative_clusters_match(threshold, scale):
    lines = open(os.path.join(TAIL9, "data", "similarities.csv" if scale is
                              None else "distances.csv")).read().splitlines()
    ents = [ln.split(",")[0] for ln in open(os.path.join(
        TAIL9, "data", "entities.csv")).read().splitlines()]
    got = AG.agglomerative_cluster(ents, AG.EntityDistanceStore.from_lines(
        lines), threshold, scale)
    want = JAG.agglomerative_cluster(ents, JAG.EntityDistanceStore.from_lines(
        lines), threshold, scale)
    strip = lambda cs: [c.to_line().split(",", 1)[1] for c in cs]  # noqa: E731
    assert strip(got) == strip(want)
    assert AG.EntityDistanceStore.from_lines(lines).to_lines() == \
        JAG.EntityDistanceStore.from_lines(lines).to_lines()


# --------------------------------------------------------------------------
# the CLI: tail9, the registry, the device
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", case_of(CLUSTER_JOBS))
def test_tail9_cluster_case(tmp_path, case):
    """Byte for byte; kmeans' avError within the maker's tolerance."""
    text, counters, want, want_c = run_tail9_case(tmp_path, case)
    assert counters == want_c
    MAKE.compare(case, text, want)


def test_tail9_kmeans_shows_the_tie_and_the_empty_cluster():
    """kmeans_one: group A's second centroid equals its first, every row
    ties and goes to the first, and the empty twin keeps its centroid."""
    lines = open(os.path.join(TAIL9, "kmeans_one", "out.csv")).read(
        ).splitlines()
    a0, a1 = lines[0].split(","), lines[1].split(",")
    assert a1[-1] == "0" and a1[-3] == "stopped" and a1[-4] == "0.000"
    assert int(a0[-1]) > 0


@pytest.mark.parametrize("job", CLUSTER_JOBS)
def test_cluster_job_registered(job):
    check_job_registered(job)


@pytest.mark.parametrize("job", CLUSTER_JOBS)
def test_cluster_job_raises_without_a_gpu_unless_asked_for_the_cpu(
        tmp_path, job):
    check_job_needs_a_gpu(tmp_path, job)


def test_two_gloo_ranks_give_the_one_process_clusters(tmp_path):
    """kmeansCluster over two gloo ranks, each with half the rows: the
    packed partials' all-reduce gives both ranks the one-process cluster
    file (integer sums are exact in float64; avError within
    AV_ERROR_RTOL) and one process's iteration counters."""
    from tests.test_torch_joined_gather import run_joined
    _, argv = MAKE.case_args("kmeans", TAIL9, str(tmp_path))
    src = argv[-2]
    rows = open(src).read().splitlines(True)
    runs = []
    for i, part in enumerate((rows[:100], rows[100:])):
        p = tmp_path / f"part{i}.csv"
        p.write_text("".join(part))
        runs.append([argv[:-2] + [CPU, str(p), str(tmp_path / f"out{i}")]])
    for rc, so, se, rcs in run_joined(tmp_path, runs):
        assert rc == 0 and rcs == [0], se[-3000:]
    one = open(os.path.join(TAIL9, "kmeans", "out.csv")).read()
    got = [open(tmp_path / f"out{i}" / "part-r-00000").read()
           for i in range(2)]
    assert got[0] == got[1]
    MAKE.compare("kmeans", got[0], one)
    with open(tmp_path / "out0.counters.json") as fh:
        assert json.load(fh)["Clustering"] == {"activeGroups": 0,
                                               "iterations": 5}


def test_tail9_maker_reproduces_the_fixture(tmp_path):
    """The committed fixture is what the maker writes (in a fresh
    one-device process)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = (f"import sys; sys.path.insert(0, {TAIL9!r}); import make; "
            f"make.make({str(tmp_path)!r})")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   capture_output=True, cwd=ROOT, timeout=600)
    for case in MAKE.CASES:
        for f in ("out.csv", "counters.json"):
            with open(os.path.join(tmp_path, case, f)) as a, \
                    open(os.path.join(TAIL9, case, f)) as b:
                assert a.read() == b.read(), (case, f)
    for f in os.listdir(os.path.join(TAIL9, "data")):
        with open(os.path.join(tmp_path, "data", f)) as a, \
                open(os.path.join(TAIL9, "data", f)) as b:
            assert a.read() == b.read(), f
