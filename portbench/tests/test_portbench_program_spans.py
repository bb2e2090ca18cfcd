"""The training layers the builders open inside ``weights_h2d`` and the
branch codes, as the benchmark reads them: the readers of
``bootstrap_draw_ms.train``, ``bootstrap_upload_ms.train`` and
``branch_codes_ms.train`` on hand-made spans and in a traced run of
``rafo_train_1m`` at a small size on the CPU, and the idle gaps labelled
by the innermost of the nested layers."""

import pytest

from portbench.core import Capture, Spans, TracedRun, metric_reader
from portbench.run import run_cell
from portbench.tests.conftest import SMALL
from portbench.tests.test_portbench_capture import Ev

NEW = ("bootstrap_draw_ms.train", "bootstrap_upload_ms.train",
       "branch_codes_ms.train")
# what a traced CPU run of the cell read before these metrics: the device
# shares read a capture with no kernels (B1's roofline none)
OLD = ("bootstrap_ms.train", "level_loop_ms.train", "device_idle_pct.train")


def _run(seconds: dict, calls: int = 2) -> TracedRun:
    spans = Spans(lambda: None)
    for name, s in seconds.items():
        spans.seconds[name] += s
        spans.count[name] += calls
    return TracedRun(None, calls, spans, None, True)


@pytest.mark.parametrize("name,layer", [
    ("bootstrap_draw_ms.train", "bootstrap.draw"),
    ("bootstrap_upload_ms.train", "bootstrap.upload"),
    ("branch_codes_ms.train", "branch_codes")])
def test_reader_is_its_layer_per_build(name, layer):
    reader = metric_reader(name)
    assert reader.read(_run({layer: 0.5, "weights_h2d": 0.9})) == \
        pytest.approx(250.0)
    # a program without the layer: nothing to read, and no error
    assert reader.read(_run({"weights_h2d": 0.9})) is None


def test_idle_gaps_by_the_innermost_bootstrap_layer():
    cap = Capture([
        Ev("pb:window", 0, 1000),
        Ev("pb:weights_h2d", 100, 850),
        Ev("pb:bootstrap.draw", 110, 490),
        Ev("pb:bootstrap.upload", 610, 290),
        Ev("Memcpy HtoD (Pageable -> Device)", 700, 100, "cuda")])
    # gaps [0, 700) (its middle in the draw) and [800, 1000) (its middle
    # in weights_h2d, the upload just ended)
    got = dict(cap.breakdown()["idle_gaps"])
    assert got == pytest.approx({"bootstrap.draw": 700 / 1e9,
                                 "weights_h2d": 200 / 1e9})


def test_traced_train_run_reports_the_new_metrics():
    result, checks = run_cell("rafo_train_1m", 2 ** 32 + 25, 1.0, True,
                              "cpu", SMALL["rafo_train_1m"])
    metrics = result["metrics"]
    for name in NEW + OLD:
        assert metrics[name]["value"] is not None, name
    assert metrics["bootstrap_draw_ms.train"]["unit"] == "ms/build"
    # the two nest inside the whole bootstrap layer
    assert metrics["bootstrap_draw_ms.train"]["value"] + \
        metrics["bootstrap_upload_ms.train"]["value"] <= \
        metrics["bootstrap_ms.train"]["value"]
    assert result["correct"], checks
