"""Spans of the program's stages + torch profiler hooks.

The reference's observability is log-lines only (SURVEY.md §5: loguru
sinks, no tracer). Here every pipeline stage (extract/encode/search/
rescore/confidence) and every phase of the encoder-training loop records
a span: its name, start and end in ``time.time_ns()`` (the clock a device
trace can be aligned to), the innermost span open on the same thread when
it started (its parent) and an id it shares with that parent. Spans are
kept in a bounded ring per name (``RING``: enough for a training
window's per-layer spans); /stats surfaces counts + p50/p95/mean per name.
Counters (``count``) add numbers, or tensors where they live (on the
device, with no host read), and are read on demand (``counters``).
Inside ``quiet()`` a thread records no span and adds to no counter: the
backward's recomputation of a checkpointed forward runs there, so that
spans and counters hold forward work only.
torch.profiler traces can be started/stopped at runtime for deep dives
(Chrome trace JSON, viewable in Perfetto): while one runs, each span is
also a ``record_function`` range of its name, so the trace shows the
stages above the kernels. The stop result carries the CUDA
allocator's memory statistics.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]  # the innermost span open on this thread at the start
    id: Optional[int]  # the top-level span's, given by its caller


class _Open:
    """One span while it is open: a context manager."""

    __slots__ = ("reg", "name", "id", "parent", "start", "rf", "stack")

    def __init__(self, reg: "StageMetrics", name: str, id: Optional[int]):
        self.reg, self.name, self.id = reg, name, id
        self.parent = self.rf = None

    def __enter__(self) -> "_Open":
        try:
            stack = self.stack = self.reg._local.stack
        except AttributeError:
            stack = self.stack = self.reg._local.stack = []
        if stack:
            top = stack[-1]
            self.parent, self.id = top.name, top.id
        stack.append(self)
        if _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        self.stack.pop()
        # tuple.__new__ skips NamedTuple's __new__, a Python call: a large share of a span
        self.reg._add(tuple.__new__(Span, (self.name, self.start, end, self.parent, self.id)))
        return False


# spans kept per name: a 25-s training window of a layer-by-layer span (a
# few hundred steps at ten a step) with room to spare; about 1 MB a name
RING = 8192


class StageMetrics:
    """Thread-safe span registry: a ring of the last ``window`` spans per
    name, with the count recorded and the count dropped from the ring; and
    named counters."""

    def __init__(self, window: int = RING):
        self.window = window
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: Dict[str, deque] = {}
        self._counts: Dict[str, int] = {}
        self._dropped: Dict[str, Tuple[int, int]] = {}  # name -> (count, newest's end)
        self._counters: Dict[str, Union[int, float, torch.Tensor]] = {}

    def span(self, name: str, id: Optional[int] = None):
        """A span of ``name`` around a ``with`` block. A span opened inside
        another on the same thread takes that one as its parent and its
        id; a top-level span takes ``id``. Inside ``quiet()``, nothing."""
        if getattr(self._local, "quiet", 0):
            return contextlib.nullcontext()
        return _Open(self, name, id)

    @contextlib.contextmanager
    def quiet(self):
        """While open, this thread's spans and counts are not recorded."""
        self._local.quiet = getattr(self._local, "quiet", 0) + 1
        try:
            yield
        finally:
            self._local.quiet -= 1

    timer = span  # the serving stages' name for it

    def _add(self, span: Span) -> None:
        name = span.name
        with self._lock:
            ring = self._spans.get(name)
            if ring is None:
                ring = self._spans[name] = deque(maxlen=self.window)
            elif len(ring) == self.window:
                n, _ = self._dropped.get(name, (0, 0))
                self._dropped[name] = (n + 1, ring[0].end_ns)
            ring.append(span)
            self._counts[name] = self._counts.get(name, 0) + 1

    def spans(self, name: str, since_ns: int = 0,
              until_ns: Optional[int] = None) -> Optional[List[Span]]:
        """The spans of ``name`` held in the ring that start in [since_ns,
        until_ns], by start; None where the ring has dropped one that
        ended after ``since_ns`` (it may have started in the interval)."""
        with self._lock:
            held = list(self._spans.get(name, ()))
            lost = self._dropped.get(name)
        if lost is not None and lost[1] > since_ns:
            return None
        out = [s for s in held
               if s.start_ns >= since_ns and (until_ns is None or s.start_ns <= until_ns)]
        out.sort(key=lambda s: s.start_ns)
        return out

    def count(self, name: str, value: Union[int, float, torch.Tensor]) -> None:
        """Add ``value`` to counter ``name``: a number on the host, or a
        tensor (elementwise) where it lives, with no host read: a device
        tensor is added by the device. Inside ``quiet()``, nothing."""
        if getattr(self._local, "quiet", 0):
            return
        with self._lock:
            held = self._counters.get(name)
            if isinstance(value, torch.Tensor):
                value = value.detach()
                if held is None:
                    self._counters[name] = value.clone()
                elif held.shape != value.shape:
                    raise ValueError(f"counter {name} holds shape {tuple(held.shape)}; "
                                     f"added {tuple(value.shape)}")
                else:
                    held.add_(value)
            else:
                self._counters[name] = value if held is None else held + value

    def counters(self, prefix: str = "") -> Dict[str, np.ndarray]:
        """Every counter whose name starts with ``prefix``, since the process
        started (or the last ``reset``), as host arrays: this reads the
        device where a counter lives there."""
        with self._lock:
            held = {k: v for k, v in self._counters.items() if k.startswith(prefix)}
        return {k: (v.to("cpu", copy=True).numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in held.items()}

    def dropped(self, name: str) -> int:
        """Spans of ``name`` dropped from the full ring so far."""
        with self._lock:
            return self._dropped.get(name, (0, 0))[0]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for stage, buf in self._spans.items():
                arr = np.fromiter((s.end_ns - s.start_ns for s in buf), np.float64,
                                  len(buf)) / 1e6  # ms
                out[stage] = {
                    "count": self._counts[stage],
                    "p50_ms": round(float(np.percentile(arr, 50)), 3),
                    "p95_ms": round(float(np.percentile(arr, 95)), 3),
                    "mean_ms": round(float(arr.mean()), 3),
                    "last_ms": round(float(arr[-1]), 3),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()
            self._dropped.clear()
            self._counters.clear()


def self_ns(span: Span, children: Iterable[Span]) -> int:
    """``span``'s length less the part of it its children (spans with it
    as their parent and its id) cover; children on one thread do not
    overlap."""
    covered = sum(min(c.end_ns, span.end_ns) - max(c.start_ns, span.start_ns)
                  for c in children
                  if c.parent == span.name and c.id == span.id
                  and c.start_ns < span.end_ns and c.end_ns > span.start_ns)
    return span.end_ns - span.start_ns - covered


# process-wide default registry
metrics = StageMetrics()


class Profiler:
    """Runtime-controllable torch.profiler trace (Chrome trace JSON)."""

    def __init__(self, log_dir: str = "logs/profile"):
        self.log_dir = log_dir
        self._prof = None

    def start(self) -> Dict:
        if self._prof is not None:
            return {"status": "already_running", "log_dir": self.log_dir}
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.reset_peak_memory_stats()
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()
        return {"status": "started", "log_dir": self.log_dir}

    def stop(self) -> Dict:
        if self._prof is None:
            return {"status": "not_running"}
        prof, self._prof = self._prof, None
        prof.stop()
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        trace = str(Path(self.log_dir) / f"trace_{int(time.time())}.json")
        prof.export_chrome_trace(trace)
        out: Dict = {"status": "stopped", "log_dir": self.log_dir, "trace": trace}
        if torch.cuda.is_available():
            out["cuda_memory"] = {
                "allocated_bytes": torch.cuda.memory_allocated(),
                "reserved_bytes": torch.cuda.memory_reserved(),
                "max_allocated_bytes": torch.cuda.max_memory_allocated(),
            }
        return out

    @property
    def active(self) -> bool:
        return self._prof is not None


profiler = Profiler()
