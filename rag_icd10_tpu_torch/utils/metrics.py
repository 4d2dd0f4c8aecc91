"""Per-stage latency metrics + torch profiler hooks.

The reference's observability is log-lines only (SURVEY.md §5: loguru
sinks, no tracer). Here every pipeline stage (extract/encode/search/
rescore/confidence) records wall-clock into a bounded ring buffer, and
/stats surfaces counts + p50/p95/mean per stage. torch.profiler traces
can be started/stopped at runtime for deep dives (Chrome trace JSON,
viewable in Perfetto), and the stop result carries the CUDA allocator's
memory statistics.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path
from typing import Dict

import numpy as np


class StageMetrics:
    """Thread-safe ring-buffer latency recorder."""

    def __init__(self, window: int = 512):
        self.window = window
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {}
        self._counts: Dict[str, int] = {}

    @contextmanager
    def timer(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            buf = self._samples.setdefault(stage, deque(maxlen=self.window))
            buf.append(seconds)
            self._counts[stage] = self._counts.get(stage, 0) + 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for stage, buf in self._samples.items():
                arr = np.asarray(buf, dtype=np.float64) * 1000  # ms
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
            self._samples.clear()
            self._counts.clear()


# process-wide default registry
metrics = StageMetrics()


class Profiler:
    """Runtime-controllable torch.profiler trace (Chrome trace JSON)."""

    def __init__(self, log_dir: str = "logs/profile"):
        self.log_dir = log_dir
        self._prof = None

    def start(self) -> Dict:
        import torch

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
        import torch

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
