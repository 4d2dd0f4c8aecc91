"""Request-coalescing batcher.

Concurrent /query and /standardize requests landing within a small window
are merged into ONE device batch (one encoder forward + one fused search
scan via MultiDiagnosisService.match_many_texts). The reference has no
equivalent — every request is processed alone and sequentially.

Device work runs in a single worker thread: JAX dispatch is blocking, and
serializing it through one thread also guarantees jit-cache friendliness.

Overload/failure behavior (SURVEY.md §5 failure-detection row):
- bounded queue — submit raises ``BatcherOverloaded`` when ``max_queue``
  requests are already waiting (the API maps it to 503) instead of
  growing memory without bound;
- per-request timeout — a caller stuck behind a slow batch (e.g. a cold
  XLA compile for a new shape bucket) gets ``BatcherTimeout`` (504)
  rather than waiting forever; the worker skips delivering to abandoned
  futures;
- graceful drain — ``stop()`` waits up to ``drain_timeout_s`` for queued
  and in-flight work before cancelling, so a SIGTERM during an in-flight
  compile neither wedges teardown nor silently drops completed results.

Requests carrying per-request search knobs (search_method / ef_search)
still coalesce: the worker groups a collected batch by knob key and runs
one matcher call per group (almost always a single default group).

Pipelining: when the matcher exposes the three-stage split
(extract_stage / device_stage / rescore_stage,
pipeline/orchestrator.py), up to two batches are in flight at once.
The device stage is DISPATCH-ONLY (store.search_dispatch returns a
PendingSearch; every blocking fetch — embeddings download, top-k
arrays, certificate redo, hit building — happens in rescore_stage's
finalize step on the host pool). So the single device thread never
blocks on results: batch n+1's encoder forward + search are dispatched
into the device queue while batch n is still executing/downloading —
true device-side overlap of encode(n+1) with search(n), even on a
1-core host (the finalize wait releases the GIL inside np.asarray, so
the core is free for another batch's extract/rescore). Steady-state
throughput approaches max(device, host) per batch instead of their
sum. Two documented exceptions issue device work from the host pool
concurrently with the in-flight batch's scan: enhanced extraction's
small boundary-embedding encode (pipeline/enhanced.py), and the
rescore stage's semantic-coherence gather (pipeline/confidence.py
_semantic_coherence -> store.semantic_similarities / encoder per
candidate). JAX dispatch is thread-safe and XLA serializes on-device,
so both cost at most device-queue contention (per-candidate for the
coherence gather), not correctness. The reference processes each
request fully sequentially.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class BatcherOverloaded(Exception):
    """Queue is full — shed load (maps to HTTP 503)."""


class BatcherTimeout(Exception):
    """Request waited longer than the per-request timeout (HTTP 504)."""


@dataclass
class _Pending:
    text: str
    top_k: int
    key: Tuple[Optional[str], Optional[int]]  # (search_method, ef_search)
    future: asyncio.Future = field(repr=False)


class RequestBatcher:
    """Collects match requests for up to ``window_ms`` / ``max_batch`` and
    executes them as one batch."""

    def __init__(
        self,
        matcher_fn: Callable[..., List[Dict[str, Any]]],
        window_ms: float = 2.0,
        max_batch: int = 64,
        max_queue: int = 256,
        request_timeout_s: float = 90.0,
        drain_timeout_s: float = 10.0,
        max_inflight: int = 2,
    ):
        self.matcher_fn = matcher_fn
        # probe knob support ONCE (a live-call TypeError fallback would
        # mask real TypeErrors from inside the matcher and silently drop
        # the requested knobs)
        try:
            import inspect

            params = inspect.signature(matcher_fn).parameters
            self._knob_aware = "search_method" in params or any(
                p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()
            )
        except (TypeError, ValueError):
            self._knob_aware = False
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.request_timeout_s = request_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.queue: "asyncio.Queue[_Pending]" = asyncio.Queue(maxsize=max_queue)
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._collecting = False  # a batch is being assembled right now
        self._inflight: set = set()  # asyncio.Tasks processing batches
        # pipeline depth: how many collected batches may be in flight at
        # once (2 = extraction of batch n+1 overlaps batch n's device
        # wait; 1 = strictly serial, the pre-pipelining behavior)
        self.max_inflight = max(1, max_inflight)
        # dedicated single worker thread: serializes device work (jit-cache
        # friendly) and can be abandoned on shutdown without hanging the
        # event loop's default executor (a SIGTERM during an in-flight XLA
        # compile must not wedge process teardown)
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="batcher")
        # host-stage pipelining: available when the matcher is a bound
        # method of an object exposing the three-stage split; depth 1
        # (PIPELINE_DEPTH=1) disables the staged path entirely so the
        # serving A/B compares pipelined vs the monolithic matcher, not
        # pipelined vs staged-but-serial
        obj = getattr(matcher_fn, "__self__", None)
        if self.max_inflight > 1 and obj is not None and all(
            hasattr(obj, s)
            for s in ("extract_stage", "device_stage", "rescore_stage")
        ):
            self._pipeline_obj = obj
            self._host_executor = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="batcher-host"
            )
        else:
            self._pipeline_obj = None
            self._host_executor = None
        self.batches_served = 0
        self.requests_served = 0
        self.requests_rejected = 0
        self.requests_timed_out = 0

    @property
    def _busy(self) -> bool:
        """A batch is being collected or processed (drain gate)."""
        return self._collecting or bool(self._inflight)

    def start(self) -> None:
        if self._task is None:
            self._stopping = False
            self._task = asyncio.get_event_loop().create_task(self._worker())

    async def stop(self) -> None:
        """Drain queued + in-flight work for up to ``drain_timeout_s``,
        then cancel. In-flight device calls that outlive the drain are
        abandoned (their thread is daemonized by executor shutdown)."""
        self._stopping = True
        if self._task is not None:
            deadline = asyncio.get_event_loop().time() + self.drain_timeout_s
            while (
                (not self.queue.empty() or self._busy)
                and asyncio.get_event_loop().time() < deadline
            ):
                await asyncio.sleep(0.05)
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # cancel batch tasks that outlived the drain; their futures get
        # the shutdown exception below / in _run_group's cancel handler
        for t in list(self._inflight):
            t.cancel()
        # don't wait for an in-flight device call; drop it
        self._executor.shutdown(wait=False, cancel_futures=True)
        if self._host_executor is not None:
            self._host_executor.shutdown(wait=False, cancel_futures=True)
        # fail whatever is still queued so callers aren't left hanging
        while not self.queue.empty():
            pending = self.queue.get_nowait()
            if not pending.future.done():
                pending.future.set_exception(
                    BatcherTimeout("server shutting down")
                )

    async def submit(
        self,
        text: str,
        top_k: int,
        search_method: Optional[str] = None,
        ef_search: Optional[int] = None,
    ) -> Dict[str, Any]:
        if self._stopping:
            raise BatcherOverloaded("server shutting down")
        loop = asyncio.get_event_loop()
        pending = _Pending(
            text=text,
            top_k=top_k,
            key=(search_method, ef_search),
            future=loop.create_future(),
        )
        try:
            self.queue.put_nowait(pending)
        except asyncio.QueueFull:
            self.requests_rejected += 1
            raise BatcherOverloaded(
                f"request queue full ({self.max_queue} waiting)"
            ) from None
        try:
            return await asyncio.wait_for(
                pending.future, timeout=self.request_timeout_s
            )
        except asyncio.TimeoutError:
            self.requests_timed_out += 1
            raise BatcherTimeout(
                f"request timed out after {self.request_timeout_s:.0f}s"
            ) from None

    async def _worker(self) -> None:
        while True:
            # free pipeline slot BEFORE dequeuing: total buffering stays
            # bounded at max_queue + max_inflight*max_batch + max_batch
            while len(self._inflight) >= self.max_inflight:
                await asyncio.wait(
                    set(self._inflight),
                    return_when=asyncio.FIRST_COMPLETED,
                )
            first = await self.queue.get()
            # collecting from the moment a request is dequeued: stop()'s
            # drain must not cancel us while collected requests sit in the
            # coalescing window (their futures would never resolve)
            self._collecting = True
            batch = [first]
            try:
                deadline = asyncio.get_event_loop().time() + self.window_s
                while len(batch) < self.max_batch:
                    timeout = deadline - asyncio.get_event_loop().time()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(
                            await asyncio.wait_for(self.queue.get(), timeout=timeout)
                        )
                    except asyncio.TimeoutError:
                        break
                # group by search-knob key; each group is one device batch
                groups: Dict[Tuple, List[_Pending]] = {}
                for p in batch:
                    groups.setdefault(p.key, []).append(p)
                # bounded pipelining: launch processing as tasks and go
                # back to collecting; the next batch's host extraction
                # overlaps this batch's device wait
                for (method, ef), group in groups.items():
                    # multi-group batches may exceed the slot gate by the
                    # extra knob groups — rare and still bounded
                    task = asyncio.get_event_loop().create_task(
                        self._run_group(group, method, ef)
                    )
                    self._inflight.add(task)
                    task.add_done_callback(self._inflight.discard)
                self.batches_served += len(groups)
                self.requests_served += len(batch)
            except asyncio.CancelledError:
                for pending in batch:
                    if not pending.future.done():
                        pending.future.set_exception(
                            BatcherTimeout("server shutting down")
                        )
                raise
            finally:
                self._collecting = False

    async def _run_group(self, group: List[_Pending], method, ef) -> None:
        # requests may ask different top_k: run at the max, slice later
        top_k = max(p.top_k for p in group)
        texts = [p.text for p in group]
        loop = asyncio.get_event_loop()

        try:
            if self._pipeline_obj is not None:
                # three-stage pipeline: host stages on the 2-thread host
                # pool, device stage strictly serialized on the single
                # device thread
                m = self._pipeline_obj
                state = await loop.run_in_executor(
                    self._host_executor, m.extract_stage, texts
                )

                def run_device():
                    if (method is None and ef is None) or not self._knob_aware:
                        return m.device_stage(state, top_k)
                    return m.device_stage(
                        state, top_k, search_method=method, ef_search=ef
                    )

                await loop.run_in_executor(self._executor, run_device)
                results = await loop.run_in_executor(
                    self._host_executor, m.rescore_stage, state, top_k
                )
            else:
                def call():
                    if (method is None and ef is None) or not self._knob_aware:
                        return self.matcher_fn(texts, top_k)
                    return self.matcher_fn(
                        texts, top_k, search_method=method, ef_search=ef
                    )

                results = await loop.run_in_executor(self._executor, call)
            for pending, result in zip(group, results):
                if pending.top_k < top_k:
                    for m in result.get("matches", []):
                        m.candidates = m.candidates[: pending.top_k]
                    result["total_matches"] = sum(
                        len(m.candidates) for m in result.get("matches", [])
                    )
                if not pending.future.done():
                    pending.future.set_result(result)
        except asyncio.CancelledError:
            for pending in group:
                if not pending.future.done():
                    pending.future.set_exception(
                        BatcherTimeout("server shutting down")
                    )
            raise
        except Exception as e:
            for pending in group:
                if not pending.future.done():
                    pending.future.set_exception(e)

    def stats(self) -> Dict[str, Any]:
        return {
            "pipelined": self._pipeline_obj is not None,
            "inflight_batches": len(self._inflight),
            "batches_served": self.batches_served,
            "requests_served": self.requests_served,
            "requests_rejected": self.requests_rejected,
            "requests_timed_out": self.requests_timed_out,
            "queue_depth": self.queue.qsize(),
            "max_queue": self.max_queue,
            "avg_batch_size": (
                round(self.requests_served / self.batches_served, 2)
                if self.batches_served
                else 0.0
            ),
        }
