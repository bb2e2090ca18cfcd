"""Make the elearn_knn fixture with the JAX package, on the CPU: the
``knnPipeline`` job (``resource/knn.properties``: k = 7, euclidean, scale
1000, over ``resource/elearn.json``) on ``elearn_gen`` rows.

  data/tr_part, data/test_part   2,000 train rows (elearn_gen(2000, 41)) and
                                 500 test rows (elearn_gen(500, 42)); the
                                 test ids are renamed T000000.. so the two
                                 sets never share an id
  inter_<metric>.csv             knnPipeline over data/ (inter-set: the
                                 'tr' files are the train set)
  intra_<metric>.csv             knnPipeline over data/tr_part alone
                                 (intra-set, leave-one-out)
  counters.json                  each run's job counters (Validation,
                                 Neighborhood), keyed <mode>_<metric>

for metric in euclidean and manhattan.  The port (``avenir_tpu_torch``) is
held against these files on the CPU by ``tests/test_torch_knn_slice.py``
(which also reruns this script into a temporary directory and compares) and
on the GPU by ``chip_smoke.py``, which imports no JAX.  Regenerate from the
repo root:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/torch_fixtures/elearn_knn/make.py
"""

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")

N_TRAIN, TRAIN_SEED = 2000, 41
N_TEST, TEST_SEED = 500, 42
METRICS = ("euclidean", "manhattan")
# the job counter groups the fixture keeps (the ledger and timer groups
# describe the device, not the answer)
COUNTER_GROUPS = ("Neighborhood", "Validation")


def _write_rows(path, rows):
    with open(path, "w") as fh:
        fh.write("\n".join(rows) + "\n")


def write_data(data_dir: str) -> None:
    """The fixture's input CSVs (deterministic from the seeds above)."""
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.elearn_gen import generate
    os.makedirs(data_dir, exist_ok=True)
    _write_rows(os.path.join(data_dir, "tr_part"),
                generate(N_TRAIN, TRAIN_SEED))
    _write_rows(os.path.join(data_dir, "test_part"),
                ["T" + r[1:] for r in generate(N_TEST, TEST_SEED)])


def runs(data_dir: str):
    """(name, input path, -D overrides) of every run the fixture holds."""
    for metric in METRICS:
        yield f"inter_{metric}", data_dir, [f"-Dsts.distance.metric={metric}"]
        yield (f"intra_{metric}", os.path.join(data_dir, "tr_part"),
               [f"-Dsts.distance.metric={metric}"])


def job_args(props: str, schema: str, in_path: str, out_path: str,
             overrides) -> list:
    return ["org.avenir.knn.KnnPipeline", f"-Dconf.path={props}",
            f"-Dsts.same.schema.file.path={schema}", *overrides, in_path,
            out_path]


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.cli import run as cli_run
    props = os.path.join(RES, "knn.properties")
    schema = os.path.join(RES, "elearn.json")
    data_dir = os.path.join(out_dir, "data")
    write_data(data_dir)
    counters = {}
    with tempfile.TemporaryDirectory() as work:
        for name, in_path, overrides in runs(data_dir):
            out = os.path.join(work, name)
            assert cli_run.main(job_args(props, schema, in_path, out,
                                         overrides)) == 0
            shutil.copyfile(os.path.join(out, "part-r-00000"),
                            os.path.join(out_dir, f"{name}.csv"))
            with open(out + ".counters.json") as fh:
                got = json.load(fh)
            counters[name] = {g: got[g] for g in COUNTER_GROUPS}
    with open(os.path.join(out_dir, "counters.json"), "w") as fh:
        json.dump(counters, fh, indent=2, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
