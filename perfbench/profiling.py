"""torch.profiler over a sub-window, read from its raw events.

The profiler records CPU operators of the thread that started it only,
but the CUDA runtime's launches and the device's kernels, copies and
memsets of every thread (CUPTI). So a kernel is attributed to a span by
the host time of the runtime call that launched it (correlation id), and
spans are host-clock intervals from ``hooks.py``. The profiler's clock is
aligned to ``time.time_ns()`` by three sleep kernels launched at known
times when tracing starts.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_KINDS = ("CUDA",)


class DeviceProfile:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0  # the traced window, time.time_ns()
        self.ops: List[Tuple[int, int, str, Optional[int]]] = []  # start, end, name, launch
        self.error: Optional[str] = None
        self.clock, self.offset_ns = "", 0
        self._sleeps: List[int] = []

    def start(self) -> None:
        """Start tracing the device (this thread's operators only where
        there is none: they cost the model's own thread time)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts = [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark_ns = time.time_ns()
        with record_function("perfbench::mark"):
            pass
        # clock marks: kernels launched at known host times
        self._sleeps = []
        if torch.cuda.is_available():
            for _ in range(3):
                a = time.time_ns()
                torch.cuda._sleep(1000)
                self._sleeps.append((a + time.time_ns()) // 2)
            torch.cuda.synchronize()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        """Stop tracing; the events are read by ``read``."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()

    def read(self) -> None:
        if self.prof is None:
            return
        try:
            self._read()
        except Exception as e:  # a profiler that gives nothing leaves its metrics out
            self.error = f"{type(e).__name__}: {e}"
        self.prof = None

    def _read(self) -> None:
        events = self.prof.profiler.kineto_results.events()
        mark = None
        launches: Dict[int, int] = {}
        device = []
        for e in events:
            kind = str(e.device_type()).split(".")[-1]
            if kind in DEVICE_KINDS:
                if not e.is_user_annotation() and not e.name().startswith("perfbench::"):
                    device.append(e)
            elif e.name() == "perfbench::mark":
                mark = e.start_ns() - self._mark_ns
            elif e.name().startswith("cu"):
                launches[e.correlation_id()] = e.start_ns()
        raw = []
        for e in device:
            corr = e.linked_correlation_id() or e.correlation_id()
            raw.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), launches.get(corr)))
        raw.sort()
        # the profiler's clock against time.time_ns(): the launches of the
        # clock marks' kernels, else the annotation, else none
        sleeps = [r[3] for r in raw if "sleep" in r[2].lower() or "spin" in r[2].lower()]
        sleeps = [x for x in sleeps if x is not None][: len(self._sleeps)]
        if sleeps and len(sleeps) == len(self._sleeps):
            offset = sorted(x - m for x, m in zip(sleeps, self._sleeps))[len(sleeps) // 2]
            self.clock = "kernel marks"
        else:
            offset = mark or 0
            self.clock = "annotation" if mark is not None else "none"
        self.offset_ns = offset
        self.ops = [(s - offset, e - offset, name, None if l is None else l - offset)
                    for s, e, name, l in raw
                    if not ("sleep" in name.lower() or "spin" in name.lower())]

    # ------------------------------------------------------------ reads

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """Union of device operations, clipped to the window."""
        out: List[List[int]] = []
        for s, e, _, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for s, e, name, _ in self.ops:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, spans: Dict[str, Sequence[Tuple[int, int]]], n: int = 10) -> List[List]:
        """The longest idle gaps of the device, each named by the host span
        covering its middle (``host`` where none does)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            name = "host"
            for span_name, ivs in spans.items():
                if any(s <= mid <= e for s, e in ivs):
                    name = span_name
                    break
            out.append([name, (b - a) / 1e9])
        return out

    def summary(self, spans: Dict[str, Sequence[Tuple[int, int]]]) -> str:
        """One line on what the trace held, for the run's log."""
        launched = sum(1 for op in self.ops if op[3] is not None)
        per = {k: len(v) for k, v in spans.items()}
        return (f"profiler: {len(self.ops)} device ops ({launched} with their launch), clock "
                f"{self.clock} offset {self.offset_ns} ns, spans {per}")
