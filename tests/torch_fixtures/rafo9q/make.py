"""Make the rafo9q fixture with the JAX package, on the CPU: the rafo9
forest published with its two sidecars, and the int8 serve of it.

The port (``avenir_tpu_torch``) is held against these files on the GPU by
``chip_smoke.py``, which imports no JAX.  Same configuration and data as
``../rafo9/make.py`` (``resource/rafo.properties``: 9 trees, depth 4, over
``call_hangup_gen(5000, 17)``), trained with ``dtb.model.quantize=true``
and ``dtb.baseline.publish=true``:

  registry/rafo9/v_000001/   meta.json (manifest lists the sidecars),
                             arrays.npz, baseline.json, baseline.npz,
                             quantized.json, quantized.npz
  train_counters.json        the job's "Random forest" counters
                             (RegistryVersion, BaselineRows,
                             QuantizedSampleRows,
                             QuantizedMismatchPerMillion, Trees)
  served_quantized.csv       predictionService -Dps.quantized=true over
                             ../rafo9/requests.csv from that registry

``np.savez`` stamps the write time into each zip entry, so the ``.npz``
files differ in bytes from run to run; they are compared by arrays and
dtypes.  Regenerate from the repo root (``tests/test_torch_sidecar_slice.py``
reruns it into a temporary directory and compares):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/torch_fixtures/rafo9q/make.py
"""

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
REQUESTS = os.path.join(HERE, "..", "rafo9", "requests.csv")

MODEL_NAME = "rafo9"
SIDECAR_KEYS = ("-Ddtb.model.quantize=true", "-Ddtb.baseline.publish=true")


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
    props = os.path.join(RES, "rafo.properties")
    schema_path = os.path.join(RES, "call_hangup.json")
    os.makedirs(out_dir, exist_ok=True)
    registry_dir = os.path.join(out_dir, "registry")
    shutil.rmtree(registry_dir, ignore_errors=True)
    with tempfile.TemporaryDirectory() as work:
        train = os.path.join(work, "train.csv")
        _write_rows(train, generate(5000, 17))
        model = os.path.join(work, "model")
        assert cli_run.main([
            "org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
            f"-Ddtb.feature.schema.file.path={schema_path}",
            f"-Ddtb.model.registry.dir={registry_dir}",
            f"-Ddtb.model.name={MODEL_NAME}", *SIDECAR_KEYS,
            train, model]) == 0
        with open(model + ".counters.json") as fh:
            counters = json.load(fh)["Random forest"]
        with open(os.path.join(out_dir, "train_counters.json"), "w") as fh:
            json.dump(counters, fh, indent=2, sort_keys=True)
            fh.write("\n")
        served = os.path.join(work, "served")
        assert cli_run.main([
            "org.avenir.serving.PredictionService", f"-Dconf.path={props}",
            f"-Dps.model.registry.dir={registry_dir}",
            f"-Dps.model.name={MODEL_NAME}", "-Dps.transport=inprocess",
            "-Dps.quantized=true", REQUESTS, served]) == 0
        shutil.copyfile(os.path.join(served, "part-m-00000"),
                        os.path.join(out_dir, "served_quantized.csv"))


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
