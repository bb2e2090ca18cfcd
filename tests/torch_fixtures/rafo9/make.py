"""Make the rafo9 forest fixture with the JAX package, on the CPU.

The port (``avenir_tpu_torch``) is held against these files on the GPU by
``chip_smoke.py``, which imports no JAX: they are the JAX package's own
outputs at the published forest's full width (``resource/rafo.properties``:
9 trees, depth 4, over ``resource/call_hangup.json``).

  tree_0.json .. tree_8.json   randomForestBuilder on call_hangup_gen(5000, 17)
  requests.csv                 call_hangup_gen(2000, 29)
  pred.csv                     modelPredictor over requests.csv
  registry/rafo9/v_000001/     the forest published by ModelRegistry.publish
  served.csv                   predictionService (ps.transport=inprocess)
                               over requests.csv from that registry

Regenerate from the repo root (``tests/test_torch_fixtures.py`` reruns it
into a temporary directory and requires identical bytes):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/torch_fixtures/rafo9/make.py
"""

import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")

N_TREES = 9
MODEL_NAME = "rafo9"


def _write_rows(path, rows):
    with open(path, "w") as fh:
        fh.write("\n".join(rows) + "\n")


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.call_hangup_gen import generate
    from avenir_tpu.cli import run as cli_run
    from avenir_tpu.core.schema import FeatureSchema
    from avenir_tpu.models.tree import DecisionPathList
    from avenir_tpu.serving.registry import ModelRegistry
    props = os.path.join(RES, "rafo.properties")
    schema_path = os.path.join(RES, "call_hangup.json")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:
        train = os.path.join(work, "train.csv")
        _write_rows(train, generate(5000, 17))
        model = os.path.join(work, "model")
        assert cli_run.main([
            "org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
            f"-Ddtb.feature.schema.file.path={schema_path}",
            train, model]) == 0
        for i in range(N_TREES):
            shutil.copyfile(os.path.join(model, f"tree_{i}.json"),
                            os.path.join(out_dir, f"tree_{i}.json"))
        requests = os.path.join(out_dir, "requests.csv")
        _write_rows(requests, generate(2000, 29))
        pred = os.path.join(work, "pred")
        assert cli_run.main([
            "org.avenir.model.ModelPredictor", f"-Dconf.path={props}",
            f"-Dmop.model.dir.path={model}",
            f"-Dmop.feature.schema.file.path={schema_path}",
            requests, pred]) == 0
        shutil.copyfile(os.path.join(pred, "part-m-00000"),
                        os.path.join(out_dir, "pred.csv"))
        registry_dir = os.path.join(out_dir, "registry")
        shutil.rmtree(registry_dir, ignore_errors=True)
        trees = []
        for i in range(N_TREES):
            with open(os.path.join(model, f"tree_{i}.json")) as fh:
                trees.append(DecisionPathList.from_json(fh.read()))
        ModelRegistry(registry_dir).publish(
            MODEL_NAME, trees, schema=FeatureSchema.load(schema_path))
        served = os.path.join(work, "served")
        assert cli_run.main([
            "org.avenir.serving.PredictionService", f"-Dconf.path={props}",
            f"-Dps.model.registry.dir={registry_dir}",
            f"-Dps.model.name={MODEL_NAME}", "-Dps.transport=inprocess",
            requests, served]) == 0
        shutil.copyfile(os.path.join(served, "part-m-00000"),
                        os.path.join(out_dir, "served.csv"))


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
