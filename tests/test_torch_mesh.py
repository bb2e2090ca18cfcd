"""The port's single-process device mesh (``parallel/mesh.py``), its
in-process gather (``parallel/collectives.py``) and the runtime context
that a ``cli.run`` job sees."""

import json

import pytest
import torch

from avenir_tpu_torch.cli import jobs as port_jobs
from avenir_tpu_torch.cli import run as port_run
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.parallel import mesh as M
from avenir_tpu_torch.parallel.collectives import gather_to
from avenir_tpu_torch.runtime import set_default_device
from avenir_tpu_torch.utils.tracing import transfer_ledger


@pytest.fixture()
def cpu_default():
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture()
def no_context():
    M.set_runtime_context(None)
    yield
    M.set_runtime_context(None)


def test_cpu_default_gives_one_cpu_device(cpu_default, no_context):
    mesh = M.make_mesh()
    assert mesh.devices == (torch.device("cpu"),)
    assert (mesh.size, mesh.platform) == (1, "cpu")
    ctx = M.runtime_context()
    assert (ctx.mesh.size, ctx.mesh.platform) == (1, "cpu")
    assert M.runtime_context() is not ctx      # built anew, nothing installed
    assert M.installed_context() is None
    assert M.worker_device(5) == torch.device("cpu")


def test_cuda_without_a_gpu_raises(no_context):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda resolves")
    for make in (M.make_mesh, M.tree_mesh, M.runtime_context,
                 lambda: M.DeviceMesh(["cuda"]),
                 lambda: M.DeviceMesh(["cuda:0", "cuda:0"])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_explicit_devices_may_repeat():
    mesh = M.make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert M.make_mesh(2, devices=["cpu"] * 4).size == 2
    assert M.worker_device(6, devices=["cpu"] * 3) == torch.device("cpu")


def test_mesh_checks():
    with pytest.raises(ValueError, match="at least one"):
        M.DeviceMesh([])
    with pytest.raises(ValueError, match="one type"):
        M.DeviceMesh(["cpu", "meta"])
    assert M.DeviceMesh(["cpu"] * M.MAX_SHARDS).size == M.MAX_SHARDS
    with pytest.raises(ValueError, match=f"at most {M.MAX_SHARDS}"):
        M.DeviceMesh(["cpu"] * (M.MAX_SHARDS + 1))


def test_tree_axis_is_distinct():
    m = M.tree_mesh(devices=["cpu"] * 4)
    assert m.devices == M.make_mesh(devices=["cpu"] * 4).devices
    assert M.tree_mesh(3, devices=["cpu"] * 4).size == 3
    ctx = M.MeshContext(m)
    assert ctx.mesh is m and ctx.mesh.size == 4


def test_gather_to_copies_only_other_devices():
    parts = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
             torch.ones((2, 3), dtype=torch.float64).to("meta"),
             torch.zeros((2, 3), dtype=torch.int32)]
    with transfer_ledger() as led:
        got = gather_to([parts[0], parts[2]], "cpu")
    assert got[0] is parts[0] and got[1] is parts[2]
    assert (led.gathers, led.gather_bytes) == (1, 0)
    with transfer_ledger() as led:
        moved = gather_to(parts[:2], "meta")
    assert moved[1] is parts[1] and moved[0].device.type == "meta"
    assert (led.gathers, led.gather_bytes) == (1, 6 * 4)
    counters = Counters()
    led.export(counters)
    assert json.loads(counters.to_json())["Collectives"] == {
        "GatherBytes": 24, "Gathers": 1}


@pytest.fixture()
def probe_job():
    """A registered job that records the runtime context it runs under."""
    seen = []

    def job(cfg, in_path, out_path):
        seen.append(M.runtime_context())
        return None
    port_jobs.JOBS["meshProbe"] = job
    yield seen
    del port_jobs.JOBS["meshProbe"]


def test_cli_run_platform_sets_the_runtime_context(probe_job, no_context):
    assert port_run.main(["meshProbe", "-Dplatform=cpu"]) == 0
    assert port_run.main(["meshProbe", "-Dplatform=cpu"]) == 0
    first, second = probe_job
    assert first.mesh.devices == second.mesh.devices == (torch.device("cpu"),)
    assert first is not second                 # nothing left installed


def test_cli_run_keeps_a_context_the_caller_installed(probe_job, no_context):
    mine = M.MeshContext(M.DeviceMesh(["cpu"] * 3))
    M.set_runtime_context(mine)
    assert port_run.main(["meshProbe", "-Dplatform=cpu"]) == 0
    assert probe_job[0] is mine
    assert M.runtime_context() is mine
