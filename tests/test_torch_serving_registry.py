"""The port's registry read side and in-process serving loop
(avenir_tpu_torch/serving) on versions the JAX package publishes: torn
versions are skipped, a serving pin is honoured, refresh() hot-swaps to a
new version, admission control answers busy, and unported jobs / serving
tiers refuse by name."""

import os
import warnings

import pytest

from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.models.tree import DecisionPathList as JaxPathList
from avenir_tpu.serving.registry import ModelRegistry as JaxRegistry

from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.cli.jobs import JobNotPorted
from avenir_tpu_torch.serving.registry import ModelRegistry
from avenir_tpu_torch.serving.service import BatchPolicy, PredictionService

TESTS = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(os.path.dirname(TESTS), "resource")
RAFO9 = os.path.join(TESTS, "torch_fixtures", "rafo9")
SCHEMA = os.path.join(RES, "call_hangup.json")


def _trees(idx):
    out = []
    for i in idx:
        with open(os.path.join(RAFO9, f"tree_{i}.json")) as fh:
            out.append(JaxPathList.from_json(fh.read()))
    return out


def _rows(n):
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        return [line.split(",") for line in fh.read().splitlines()[:n]]


@pytest.fixture()
def registry(tmp_path):
    """v1 = all nine trees, v2 = the first three (published by avenir_tpu)."""
    reg = JaxRegistry(str(tmp_path / "reg"))
    schema = JaxSchema.load(SCHEMA)
    reg.publish("m", _trees(range(9)), schema=schema)
    reg.publish("m", _trees(range(3)), schema=schema)
    return str(tmp_path / "reg")


def test_latest_skips_torn_version_and_honours_pin(registry):
    reg = ModelRegistry(registry)
    assert reg.versions("m") == [1, 2]
    assert reg.latest_version("m") == 2
    loaded = reg.load("m")
    assert loaded.kind == "forest" and len(loaded.model) == 3
    assert loaded.schema is not None
    JaxRegistry(registry).pin_version("m", 1)
    assert reg.pinned_version("m") == 1
    assert reg.serving_version("m") == 1
    with open(os.path.join(reg.version_dir("m", 2), "meta.json"), "w") as fh:
        fh.write("{torn")
    with pytest.warns(RuntimeWarning, match="torn"):
        assert reg.latest_version("m") == 1
    assert not reg.is_intact("m", 2)


def test_refresh_hot_swaps_to_serving_version(registry):
    JaxRegistry(registry).pin_version("m", 1)
    svc = PredictionService(registry=ModelRegistry(registry), model_name="m",
                            device="cpu", warm=False)
    assert svc.version == 1 and len(svc.predictor.models) == 9
    assert not svc.refresh()
    JaxRegistry(registry).clear_pin("m")
    assert svc.refresh()
    assert svc.version == 2 and len(svc.predictor.models) == 3
    assert svc.counters.get("Serving", "HotSwaps") == 1
    rows = _rows(20)
    assert svc.predict_rows(rows) == [
        p if p is not None else "ambiguous"
        for p in svc.predictor.predict_rows(rows)]


def test_admission_control_answers_busy(registry):
    svc = PredictionService(registry=ModelRegistry(registry), model_name="m",
                            device="cpu", warm=False,
                            policy=BatchPolicy(max_queue_depth=2))
    futs = [svc.submit(r) for r in _rows(5)]     # worker not started yet
    assert [f.result(timeout=5) for f in futs[2:]] == ["busy"] * 3
    svc.start()
    svc.stop()
    assert all(f.result(timeout=5) in ("F", "T", "ambiguous")
               for f in futs[:2])
    assert svc.counters.get("Serving", "Rejected") == 3


def test_malformed_row_costs_only_its_reply(registry):
    svc = PredictionService(registry=ModelRegistry(registry), model_name="m",
                            device="cpu", warm=False,
                            policy=BatchPolicy(batching="drain"))
    rows = _rows(4)
    rows[1] = rows[1][:2]                         # short record
    svc.start()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        futs = [svc.submit(r) for r in rows]
        svc.stop()
    assert futs[1].exception(timeout=5) is not None
    assert all(futs[i].result(timeout=5) for i in (0, 2, 3))
    assert svc.counters.get("Serving", "BadRequests") == 1


def test_unported_jobs_and_serving_tiers_refuse_by_name(registry, tmp_path):
    # every job of the JAX package is ported: a name absent from both
    # registries refuses by name; the fused drift tier is ported, so its
    # job gets as far as its first required key
    with pytest.raises(JobNotPorted, match="not ported"):
        port_run.main(["org.avenir.cluster.DbscanCluster",
                       "-Dplatform=cpu", "in.csv", str(tmp_path / "o")])
    with pytest.raises(Exception, match="dm.model.registry.dir") as exc:
        port_run.main(["predictDriftScore", "-Dplatform=cpu", "in.csv",
                       str(tmp_path / "o")])
    assert not isinstance(exc.value, JobNotPorted)
    req = tmp_path / "req.csv"
    req.write_text("\n".join(",".join(r) for r in _rows(3)) + "\n")
    # the fleet keys are ported; without ps.transport=resp they refuse by
    # name, as the JAX package does
    for extra in (["-Dps.autoscale=true"], ["-Dps.workers=2"],
                  ["-Dps.quantized=true", "-Dps.workers=2"]):
        with pytest.raises(ValueError, match=r"ps\.(autoscale|workers).*"
                                             r"require"):
            port_run.main(["predictionService", f"-Dps.model.registry.dir="
                           f"{registry}", "-Dps.model.name=m",
                           "-Dplatform=cpu", *extra, str(req),
                           str(tmp_path / "o")])
