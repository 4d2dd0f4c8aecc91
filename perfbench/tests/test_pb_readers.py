"""Readers: rates over the window, spans, shares of the device, and a
metric whose hook point or profile is missing is left out, not failed."""

import pytest

from perfbench import bench
from perfbench.hooks import Hooks
from perfbench.profiling import DeviceProfile


def test_rates():
    assert bench.read_metric("train_samples_per_s",
                             {"window_samples": 2560, "window_s": 2.0}) == 1280.0
    assert bench.read_metric("train_samples_per_s", {"window_samples": 0}) is None


def test_missing_hook_point_drops_its_metric():
    class Owner:
        pass
    h = Hooks()
    assert not h.wrap(Owner, "draw_batch", lambda orig: orig)
    assert h.missing == ["Owner.draw_batch"]
    data = {"spans": dict(h.spans)}
    assert bench.read_metric("draw_ms.train", data) is None
    assert bench.read_metric("step_ms.train", data) is None
    assert bench.read_metric("device_idle.train", data) is None
    assert bench.read_metric("train_mfu", data) is None
    out = bench.Outcome(data=data, attempted=1, failed=0,
                        checks={"x": {"value": 0.0, "limit": 0.0}}, device={})
    from perfbench.tests.pb_tiny import TRAIN, benchmark

    metrics = bench.Cell.find(benchmark(), TRAIN).per_layer
    line = bench.result_line(out, metrics, True)
    assert line["metrics"] == {} and line["correct"] is True


def test_spans_and_idle_gaps():
    h = Hooks()
    h.recording = True
    h.add("draw", 100, 200)
    h.add("draw", 300, 400)
    h.add("step", 400, 1000)
    p = DeviceProfile()
    p.t0, p.t1 = 0, 1000
    p.ops = [(150, 170, "gemm", 120), (210, 260, "ln", 190), (500, 520, "topk", 450)]
    data = {"spans": dict(h.spans), "profile": p}
    assert bench.read_metric("draw_ms.train", data) == pytest.approx(100 / 1e6)
    assert bench.read_metric("device_idle.train", data) == pytest.approx(100 * (1 - 0.09))
    gaps = p.idle_gaps(data["spans"], 3)
    assert gaps == [["step", pytest.approx(480e-9)], ["draw", pytest.approx(240e-9)],
                    ["host", pytest.approx(150e-9)]]
