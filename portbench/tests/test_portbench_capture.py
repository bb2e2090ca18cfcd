"""The reading of a device capture, on hand-made events: the busy union,
kernels placed in the span their launch fell in, and the idle gaps by
span."""

import pytest

from portbench.core import Capture


class Ev:
    def __init__(self, name, start, dur, device="cpu", corr=0):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._corr = device, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType.CUDA" if self._device == "cuda" else \
            "DeviceType.CPU"

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0


def _capture():
    return Capture([
        Ev("pb:window", 0, 1000),
        Ev("pb:window", 0, 1000, device="cuda"),      # the device's copy
        Ev("pb:b1", 100, 200), Ev("pb:classify", 500, 300),
        Ev("cudaLaunchKernel", 290, 5, corr=7),       # launched in b1
        # the device clock puts it just after the span's end
        Ev("void level_counts_mma_kernel<3>(Args)", 305, 50, "cuda", 7),
        Ev("Memcpy HtoD (Pageable -> Device)", 600, 100, "cuda"),
        Ev("topk_kernel", 650, 100, "cuda"),           # overlaps the copy
        Ev("aten::add", 10, 5)])


def test_busy_is_the_union_of_device_intervals():
    cap = _capture()
    assert cap.window_s == pytest.approx(1e-6)
    assert cap.busy_s() == pytest.approx((50 + 150) / 1e9)
    assert cap.kernel_count(["level_counts_mma_kernel"]) == 1


def test_a_kernel_counts_in_the_span_it_was_launched_in():
    cap = _capture()
    assert cap.launches_found() == 1
    assert cap.kernel_s_in("b1") == pytest.approx(50 / 1e9)
    # the copy is no kernel; topk_kernel, with no launch, by its start
    assert cap.kernel_s_in("classify") == pytest.approx(100 / 1e9)
    assert cap.kernel_s_in("reassign") is None


def test_idle_gaps_by_the_span_the_host_was_in():
    # gaps [0, 305) (its middle in b1), [355, 600) and [750, 1000)
    # (middles outside any span)
    got = dict(_capture().breakdown()["idle_gaps"])
    assert got == pytest.approx({"b1": 305 / 1e9,
                                 "outside the spans": 495 / 1e9})
    ops = dict(_capture().breakdown()["device_ops"])
    assert ops["level_counts_mma_kernel"] == pytest.approx(50 / 1e9)
