"""Make the rafo9s fixture with the JAX package, on the CPU: the rafo9
forest trained through the streamed ingest, over a CSV with malformed
records, with both publish sidecars.

The port (``avenir_tpu_torch``) is held against these files on the CPU by
``tests/test_torch_stream_slice.py`` and on the GPU by ``chip_smoke.py``,
which imports no JAX.  Configuration ``resource/rafo.properties`` (9
trees, depth 4), over ``call_hangup_gen(5000, 17)`` with five records
corrupted by ``avenir_tpu.core.faults.corrupt_csv_rows`` (three numeric
fields garbled, two rows truncated), trained with
``dtb.streaming.ingest=true``, ``dtb.streaming.block.rows=777``,
``dtb.streaming.checkpoint.blocks=2``, ``badrecords.policy=quarantine``,
``dtb.baseline.publish=true`` and ``dtb.model.quantize=true``:

  train.csv                  the corrupted input (5000 records)
  tree_<i>.json              the nine trees
  registry/rafo9s/v_000001/  meta.json, arrays.npz, baseline.json,
                             baseline.npz, quantized.json, quantized.npz
  part-q-00000               the quarantined raw lines
  train_counters.json        the job's "Random forest", "BadRecords" and
                             "ProgramCache" counter groups (the fused
                             ingest's tallies, from an empty program
                             cache)

``np.savez`` stamps the write time into each zip entry, so the ``.npz``
files differ in bytes from run to run; they are compared by arrays and
dtypes.  Regenerate from the repo root:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/torch_fixtures/rafo9s/make.py
"""

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")

MODEL_NAME = "rafo9s"
# 0-based record indices: garbled numeric field (queueTimeSec), then
# truncated rows
GARBLED = (101, 1202, 3303)
TRUNCATED = (2604, 4405)
STREAM_KEYS = ("-Ddtb.streaming.ingest=true",
               "-Ddtb.streaming.block.rows=777",
               "-Ddtb.streaming.checkpoint.blocks=2",
               "-Dbadrecords.policy=quarantine",
               "-Ddtb.model.quantize=true", "-Ddtb.baseline.publish=true")
COUNTER_GROUPS = ("Random forest", "BadRecords", "ProgramCache")


def make_csv(path: str) -> None:
    """The fixture's input: the rafo9 training rows, then the corruption."""
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.call_hangup_gen import generate
    from avenir_tpu.core.faults import corrupt_csv_rows
    with open(path, "w") as fh:
        fh.write("\n".join(generate(5000, 17)) + "\n")
    corrupt_csv_rows(path, GARBLED, seed=9, field=2)
    corrupt_csv_rows(path, TRUNCATED, seed=9, mode="truncate")


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from avenir_tpu.cli import run as cli_run
    from avenir_tpu.pipeline import program_cache
    props = os.path.join(RES, "rafo.properties")
    schema_path = os.path.join(RES, "call_hangup.json")
    os.makedirs(out_dir, exist_ok=True)
    registry_dir = os.path.join(out_dir, "registry")
    shutil.rmtree(registry_dir, ignore_errors=True)
    train = os.path.join(out_dir, "train.csv")
    make_csv(train)
    program_cache().clear()
    with tempfile.TemporaryDirectory() as work:
        model = os.path.join(work, "model")
        assert cli_run.main([
            "org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
            f"-Ddtb.feature.schema.file.path={schema_path}",
            f"-Ddtb.model.registry.dir={registry_dir}",
            f"-Ddtb.model.name={MODEL_NAME}",
            f"-Ddtb.streaming.checkpoint.dir={os.path.join(work, 'ck')}",
            *STREAM_KEYS, train, model]) == 0
        with open(model + ".counters.json") as fh:
            counters = json.load(fh)
        with open(os.path.join(out_dir, "train_counters.json"), "w") as fh:
            json.dump({g: counters[g] for g in COUNTER_GROUPS}, fh,
                      indent=2, sort_keys=True)
            fh.write("\n")
        for name in sorted(os.listdir(model)):
            if name.startswith("tree_"):
                shutil.copyfile(os.path.join(model, name),
                                os.path.join(out_dir, name))
        shutil.copyfile(os.path.join(model, "_quarantine", "part-q-00000"),
                        os.path.join(out_dir, "part-q-00000"))


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
