"""Spans the benchmark wraps around the program's methods at set-up.

A hook point is looked up by name; one that is missing is recorded in
``missing`` (its metrics then read nothing) and never fails the run.
Spans are host-clock intervals in ``time.time_ns()``, the clock the
profiler's events are aligned to; they are kept only while ``recording``
is on (the measured window of a traced run).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple


class Hooks:
    def __init__(self):
        self.recording = False
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.missing: List[str] = []
        self._restore: List[Tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, make: Callable[[Callable], Callable]) -> bool:
        """Replace ``owner.attr`` by ``make(original)``; False (and the
        name in ``missing``) where ``owner`` has no such attribute."""
        orig = getattr(owner, attr, None) if owner is not None else None
        if orig is None:
            self.missing.append(f"{getattr(owner, '__name__', owner)}.{attr}")
            return False
        setattr(owner, attr, make(orig))
        self._restore.append((owner, attr, orig))
        return True

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._restore):
            setattr(owner, attr, orig)
        self._restore.clear()

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.recording:
            self.spans[name].append((t0, t1))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.time_ns())
