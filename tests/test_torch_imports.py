"""The port imports no JAX and nothing of the JAX package: every module of
``avenir_tpu_torch`` and ``chip_smoke.py`` import in a fresh interpreter in
which ``jax``, ``jaxlib`` and the top-level ``avenir_tpu`` package (exact
name — ``avenir_tpu_torch`` shares its prefix) cannot be imported."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "avenir_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import avenir_tpu_torch
names = ["avenir_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(avenir_tpu_torch.__path__,
                                          "avenir_tpu_torch.")]
for name in ("avenir_tpu_torch.monitor.baseline",
             "avenir_tpu_torch.stats.histogram",
             "avenir_tpu_torch.serving.quantized",
             "avenir_tpu_torch.ops.distance",
             "avenir_tpu_torch.kernels.topk",
             "avenir_tpu_torch.models.knn",
             "avenir_tpu_torch.cli.knn_jobs",
             "avenir_tpu_torch.parallel.mesh",
             "avenir_tpu_torch.parallel.collectives",
             "avenir_tpu_torch.parallel.distributed",
             "avenir_tpu_torch.monitor.drift",
             "avenir_tpu_torch.monitor.accumulator",
             "avenir_tpu_torch.monitor.policy",
             "avenir_tpu_torch.utils.xla_math",
             "avenir_tpu_torch.cli.monitor_jobs",
             "avenir_tpu_torch.core.checkpoint",
             "avenir_tpu_torch.core.faults",
             "avenir_tpu_torch.core.table",
             "avenir_tpu_torch.io",
             "avenir_tpu_torch.io.native_csv",
             "avenir_tpu_torch.io.colcache",
             "avenir_tpu_torch.ops.histogram",
             "avenir_tpu_torch.models.bayes",
             "avenir_tpu_torch.models.bayes_text",
             "avenir_tpu_torch.text.wordcount",
             "avenir_tpu_torch.cli.bayes_jobs",
             "avenir_tpu_torch.telemetry",
             "avenir_tpu_torch.telemetry.trace",
             "avenir_tpu_torch.telemetry.reqtrace",
             "avenir_tpu_torch.io.qjournal",
             "avenir_tpu_torch.io.respq",
             "avenir_tpu_torch.io.native_wire",
             "avenir_tpu_torch.serving.service",
             "avenir_tpu_torch.serving.registry",
             "avenir_tpu_torch.cli.serving_jobs",
             "avenir_tpu_torch.telemetry.metrics",
             "avenir_tpu_torch.telemetry.server",
             "avenir_tpu_torch.serving.router",
             "avenir_tpu_torch.serving.fleet",
             "avenir_tpu_torch.serving.autoscaler",
             "avenir_tpu_torch.serving.fleet_host",
             "avenir_tpu_torch.control",
             "avenir_tpu_torch.control.journal",
             "avenir_tpu_torch.control.controller",
             "avenir_tpu_torch.cli.control_jobs",
             "avenir_tpu_torch.regress",
             "avenir_tpu_torch.regress.logistic",
             "avenir_tpu_torch.cli.regress_jobs",
             "avenir_tpu_torch.utils.threefry",
             "avenir_tpu_torch.utils.timefmt",
             "avenir_tpu_torch.nn",
             "avenir_tpu_torch.nn.mlp",
             "avenir_tpu_torch.cli.nn_jobs",
             "avenir_tpu_torch.optimize",
             "avenir_tpu_torch.optimize.domain",
             "avenir_tpu_torch.optimize.task_schedule",
             "avenir_tpu_torch.optimize.annealing",
             "avenir_tpu_torch.optimize.genetic",
             "avenir_tpu_torch.cli.optimize_jobs",
             "avenir_tpu_torch.reinforce",
             "avenir_tpu_torch.reinforce.learners",
             "avenir_tpu_torch.reinforce.batch",
             "avenir_tpu_torch.reinforce.serving",
             "avenir_tpu_torch.cli.reinforce_jobs",
             "avenir_tpu_torch.pipeline",
             "avenir_tpu_torch.pipeline.cache",
             "avenir_tpu_torch.pipeline.compiler",
             "avenir_tpu_torch.reinforce.online_forms",
             "avenir_tpu_torch.online",
             "avenir_tpu_torch.online.state",
             "avenir_tpu_torch.online.plane",
             "avenir_tpu_torch.online.service",
             "avenir_tpu_torch.cli.online_jobs",
             "avenir_tpu_torch.stats.samplers",
             "avenir_tpu_torch.sequence",
             "avenir_tpu_torch.sequence.markov",
             "avenir_tpu_torch.sequence.pst",
             "avenir_tpu_torch.sequence.positional",
             "avenir_tpu_torch.explore",
             "avenir_tpu_torch.explore.rules",
             "avenir_tpu_torch.association",
             "avenir_tpu_torch.association.itemsets",
             "avenir_tpu_torch.association.rules",
             "avenir_tpu_torch.cli.sequence_jobs",
             "avenir_tpu_torch.cli.association_jobs",
             "avenir_tpu_torch.cli.text_jobs",
             "avenir_tpu_torch.pipeline.flows",
             "avenir_tpu_torch.utils.pyutil",
             "avenir_tpu_torch.tools",
             "avenir_tpu_torch.tools.registrytool",
             "avenir_tpu_torch.tools.cachetool",
             "avenir_tpu_torch.tools.tracetool"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
# onlineLearner resolves by both names with the CLI's job modules loaded
from avenir_tpu_torch.cli import run as _run
from avenir_tpu_torch.cli.jobs import resolve
assert resolve("onlineLearner") is resolve("org.avenir.online.OnlineLearner")
for short, full in (("markovModelClassifier",
                     "org.avenir.markov.MarkovModelClassifier"),
                    ("frequentItemsApriori",
                     "org.avenir.association.FrequentItemsApriori"),
                    ("wordCounter", "org.avenir.text.WordCounter")):
    assert resolve(short) is resolve(full)
importlib.import_module("chip_smoke")
# the operator tools run as modules with jax and avenir_tpu blocked
import contextlib, io, runpy
for tool in ("registrytool", "cachetool", "tracetool"):
    sys.argv = [tool, "--help"]
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            runpy.run_module("avenir_tpu_torch.tools." + tool,
                             run_name="__main__")
        except SystemExit as exc:
            assert exc.code in (0, None), (tool, exc.code)
# the native reader builds and loads the port's own library, never one
# of the JAX package's
import os, tempfile
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.table import load_csv
fs = FeatureSchema.from_dict({"fields": [
    {"name": "v", "ordinal": 0, "dataType": "double", "feature": True}]})
with tempfile.NamedTemporaryFile("w", suffix=".csv", delete=False) as fh:
    fh.write("1.5\n2.5\n")
assert load_csv(fh.name, fs).columns[0].tolist() == [1.5, 2.5]
os.remove(fh.name)
# and so does the serving codec
from avenir_tpu_torch.io import native_wire
assert native_wire.encode_lpush("q", ["1,T"]) == \
    b"*3\r\n$5\r\nLPUSH\r\n$1\r\nq\r\n$3\r\n1,T\r\n"
maps = open("/proc/self/maps").read()
assert "libcsv_native-" in maps and "libserve_native-" in maps
assert os.sep + os.path.join("avenir_tpu", "") not in maps, \
    [l for l in maps.splitlines() if "avenir_tpu" + os.sep in l]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_avenir_tpu():
    res = subprocess.run([sys.executable, "-I", "-c", _PROBE, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # runtime, weights, core x7, utils x5, kernels x6, models x4,
    # serving x9, monitor x5, stats x3, ops x2, cli x10, parallel x4, io x3,
    # telemetry x5, nn x2, optimize x5, reinforce x5, pipeline x3, online x4,
    # sequence x4, explore x2, association x3, the three new cli job
    # modules, pipeline.flows, utils.pyutil, tools x4 and the package
    assert int(res.stdout.strip()) >= 99
