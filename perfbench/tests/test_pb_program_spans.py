"""Readers of the program's own spans: the mean and self time of a span
over the window, device time attributed by launch time, None where there
is nothing to read; and the narrowed cell on the CPU, whose program spans
sit on the benchmark's own step by step."""

import time

import pytest
import torch

from perfbench import bench
from perfbench.drivers import train
from perfbench.profiling import DeviceProfile
from perfbench.readers import program_span
from perfbench.tests.pb_tiny import tiny_cell
from rag_icd10_tpu_torch.utils.metrics import Span, StageMetrics

MS = 1_000_000
NEW = ("draw_sample_ms.train", "draw_tokenize_ms.train", "step_wait_ms.train",
       "forward_device_ms.train", "backward_device_ms.train", "update_device_ms.train")


def _registry(window=512):
    """Two steps at 100 and 200 ms (ids 0, 1), each a 10-ms draw (4 ms
    sampling, 6 tokenizing) and a 50-ms step (forward 10, backward 20,
    update 5: 15 ms of self time); a third step at 900 ms, past the window."""
    reg = StageMetrics(window)
    for step, t in ((0, 100), (1, 200), (2, 900)):
        t *= MS
        reg._add(Span("train.draw", t, t + 10 * MS, None, step))
        reg._add(Span("train.draw.sample", t, t + 4 * MS, "train.draw", step))
        reg._add(Span("train.draw.tokenize", t + 4 * MS, t + 10 * MS, "train.draw", step))
        s = t + 10 * MS
        reg._add(Span("train.step", s, s + 50 * MS, None, step))
        for name, a, b in (("forward", 0, 10), ("backward", 10, 30), ("update", 30, 35)):
            reg._add(Span(f"train.step.{name}", s + a * MS, s + b * MS, "train.step", step))
    return reg


def _data(profile=None):
    # the benchmark's own spans: the two steps' draws and steps, recorded a
    # few microseconds inside the program's
    spans = {"draw": [(100 * MS + 5, 110 * MS - 5), (200 * MS + 5, 210 * MS - 5)],
             "step": [(110 * MS + 5, 160 * MS - 5), (210 * MS + 5, 260 * MS - 5)]}
    return {"spans": spans, "profile": profile}


def _profile(t0=90 * MS, t1=300 * MS):
    p = DeviceProfile()
    p.t0, p.t1 = t0, t1
    # (start, end, name, launch): device ms 2 + 3 launched under the
    # forwards, 7 under a backward (from autograd's thread, inside the main
    # thread's span), 1 under an update, 4 outside every phase
    p.ops = [(112 * MS, 114 * MS, "gemm", 111 * MS), (212 * MS, 215 * MS, "gemm", 211 * MS),
             (125 * MS, 132 * MS, "gemm_bw", 122 * MS), (145 * MS, 146 * MS, "adam", 142 * MS),
             (150 * MS, 154 * MS, "copy", 149 * MS), (160 * MS, 161 * MS, "loose", None)]
    return p


@pytest.fixture
def reg(monkeypatch):
    r = _registry()
    monkeypatch.setattr(program_span, "registry", lambda: r)
    return r


def test_mean_of_a_span_over_the_window(reg):
    data = _data()
    assert bench.read_metric("draw_sample_ms.train", data) == pytest.approx(4.0)
    assert bench.read_metric("draw_tokenize_ms.train", data) == pytest.approx(6.0)


def test_self_time_of_the_step(reg):
    assert bench.read_metric("step_wait_ms.train", _data()) == pytest.approx(15.0)
    # the step holding the profiler's stop is the harness's time: left out
    reg._add(Span("train.step", 300 * MS, 400 * MS, None, 5))
    data = _data(_profile(t1=350 * MS))
    data["spans"]["step"].append((300 * MS + 5, 340 * MS))
    assert bench.read_metric("step_wait_ms.train", data) == pytest.approx(15.0)


def test_device_time_by_launch(reg):
    data = _data(_profile())
    assert bench.read_metric("forward_device_ms.train", data) == pytest.approx(5 / 2)
    assert bench.read_metric("backward_device_ms.train", data) == pytest.approx(7 / 2)
    assert bench.read_metric("update_device_ms.train", data) == pytest.approx(1 / 2)
    # only the steps that start in the profiled window count
    assert bench.read_metric("forward_device_ms.train",
                             _data(_profile(t1=150 * MS))) == pytest.approx(2.0)


def test_none_where_nothing_can_be_read(reg, monkeypatch):
    for name in NEW[:3]:
        assert bench.read_metric(name, {"spans": {}}) is None  # not traced
    for name in NEW[3:]:
        assert bench.read_metric(name, _data()) is None  # no profile
        assert bench.read_metric(name, _data(_profile(t0=500 * MS, t1=600 * MS))) is None
        empty = _profile()
        empty.ops = []
        assert bench.read_metric(name, _data(empty)) is None  # no device operation
    late = _data()
    late["spans"] = {"step": [(500 * MS, 600 * MS)]}  # a window with no step
    for name in NEW[:3]:
        assert bench.read_metric(name, late) is None
    small = _registry(window=2)  # each ring dropped the first step's spans
    monkeypatch.setattr(program_span, "registry", lambda: small)
    for name in NEW:
        assert bench.read_metric(name, _data(_profile())) is None


def test_a_program_without_the_registry_reads_none(monkeypatch):
    class Parent:  # the registry before it kept spans
        def snapshot(self):
            return {}

    from rag_icd10_tpu_torch.utils import metrics as module

    monkeypatch.setattr(module, "metrics", Parent())
    assert program_span.registry() is None
    for name in NEW:
        assert bench.read_metric(name, _data(_profile())) is None


def test_narrowed_cell_program_spans_sit_on_the_benchmarks():
    """Traced, on the CPU: each of the benchmark's ``draw`` and ``step``
    spans lies inside the program's ``train.draw`` / ``train.step`` of the
    same step, within a few ms at each end, but where the harness does its
    own work inside the program's span: the profiler's start and stop,
    and the copies of the window's compared steps."""
    from rag_icd10_tpu_torch.utils.metrics import metrics

    torch.set_num_threads(2)
    since = time.time_ns()
    tr, inp, _ = train.train_window(tiny_cell(), 2**31 + 99, 1.0, True, device="cpu")
    hooks = inp["hooks"].spans
    harness = {tr.snap_step, tr.snap_step + tr.compare - 1}
    checked = 0
    for ours, theirs in (("draw", "train.draw"), ("step", "train.step")):
        prog = metrics.spans(theirs, since)
        assert len(hooks[ours]) >= 5
        for a, b in hooks[ours]:
            (s,) = [s for s in prog if s.start_ns <= a and b <= s.end_ns]
            if s.id in harness or s.start_ns <= tr.prof.t0 <= s.end_ns \
                    or s.start_ns <= tr.prof.t1 <= s.end_ns:
                continue
            assert a - s.start_ns < 5 * MS and s.end_ns - b < 5 * MS, (ours, s.id)
            checked += 1
    assert checked >= 8
    data = {"spans": dict(hooks), "profile": tr.prof}
    for name in NEW[:3]:
        assert bench.read_metric(name, data) > 0
    assert bench.read_metric("draw_sample_ms.train", data) + bench.read_metric(
        "draw_tokenize_ms.train", data) <= bench.read_metric("draw_ms.train", data)
