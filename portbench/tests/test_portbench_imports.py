"""Nothing the benchmark runs on the chip loads JAX or the JAX package,
and the plain reference loads nothing of the program: each checked by
importing every module in a fresh interpreter."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import portbench

ROOT = Path(portbench.__file__).resolve().parent
CHECKOUT = ROOT.parent


def _modules(package: str):
    pkg = __import__(package, fromlist=["_"])
    return [package] + [f"{package}.{m.name}" for m in
                        pkgutil.walk_packages(pkg.__path__, "")
                        if m.name != "tests"]


def _loaded_after(imports, code_after: str = "") -> dict:
    src = (f"import sys, json, importlib\n"
           f"for m in {imports!r}:\n    importlib.import_module(m)\n"
           f"{code_after}"
           f"print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", src], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _tops(mods):
    return {m.split(".")[0] for m in mods}


def test_harness_loads_no_jax():
    """Every harness module and reader imported, then every cell run at a
    small size on the CPU, traced: what the port loads counts too."""
    from portbench.tests.conftest import SMALL
    mods = [m for m in _modules("portbench") if ".tests" not in m]
    # the per-layer readers are found by file, not as a package
    readers = [p.stem for p in (ROOT / "metrics").glob("*.py")]
    code = ("from portbench.core import metric_reader\n"
            f"for r in {readers!r}:\n    metric_reader(r)\n"
            "from portbench.run import run_cell\n"
            f"for w, s in {SMALL!r}.items():\n"
            "    run_cell(w, 5, 0.3, True, 'cpu', s)\n")
    loaded = _loaded_after(mods, code)
    assert not _tops(loaded) & {"jax", "jaxlib", "flax", "avenir_tpu"}
    assert "avenir_tpu_torch" in _tops(loaded)


def test_reference_loads_nothing_of_the_program():
    mods = [m for m in _modules("portbench.reference")]
    loaded = _loaded_after(mods)
    assert not _tops(loaded) & {"jax", "jaxlib", "flax", "avenir_tpu",
                                "avenir_tpu_torch"}


def test_forbidden_names_compare_whole():
    from portbench.core import forbidden_loaded
    assert forbidden_loaded(["avenir_tpu_torch.models", "jaxtyping",
                             "numpy"]) == []
    assert forbidden_loaded(["jax.numpy", "avenir_tpu.models"]) == [
        "avenir_tpu.models", "jax.numpy"]
