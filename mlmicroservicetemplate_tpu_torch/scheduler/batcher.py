"""Asyncio dynamic batcher: admit -> queue (deadline-aware) -> dispatch ->
route futures; and the entry of streaming generation.

The non-streaming path of the JAX package's ``scheduler/batcher.py``.  A
batch closes when it reaches ``max_batch`` items or ``batch_timeout_ms``
after its first item arrived, whichever comes first; a burst already
queued forms a full batch with no added wait.  Requests carry a priority
class and a deadline (``scheduler/admission.py``): the queue is earliest
deadline first within a class and class-weighted across classes
(``policy.py``), and a KV-footprint budget gates dequeue.  Past
``max_queue`` waiting items ``submit`` sheds with ``QueueFullError``
(503): the newcomer, or the lowest-class latest-deadline waiter it
outranks; a request whose deadline passes while it waits fails with
``DeadlineExceededError`` (504).  Dispatch runs on worker threads so the
device call never blocks the event loop; ``stop()`` drains the queue and
joins them; ``begin_drain()`` stops admission (503 ``drain``).

A generative model also gets a ``ContinuousDecodeLoop`` (one loop, unless
``CONTINUOUS_BATCHING=0``): ``submit_stream`` hands it every stream whose
prompt fits its slots, and ``stop()`` stops it.  The other streams (a
prompt past the loop's largest seq bucket, or every stream without a loop)
take the per-stream path, as in the JAX package: one worker thread each
runs ``InferenceEngine.generate_stream``, admitted at once or shed (the
drain and KV gates apply), with ``MAX_STREAMS`` capping both paths'
streams together.  One ``AdmissionController`` serves the request queue
and the loop, so its ledger covers both.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from ..models.registry import KIND_IMAGE, KIND_SEQ2SEQ
from ..utils import metrics, tracing
from .admission import AdmissionController
from .policy import BATCH, INTERACTIVE, DeadlineExceededError, DeadlineQueue, QueueFullError

__all__ = ["Batcher", "DeadlineExceededError", "QueueFullError", "batch_results"]

# Batches in flight at once unless the config sets ``pipeline_depth``
# (PIPELINE_DEPTH): the next batch is collated and queued on the host while
# the current one runs (the engine runs one forward at a time).
PIPELINE_DEPTH = 2


class _QueuedCall:
    """One queued request: its future and scheduling fields."""

    __slots__ = ("feats", "future", "t_in", "klass", "deadline", "started", "kv", "kv_held",
                 "_removed")

    def __init__(self, feats: dict, future: asyncio.Future, klass: str,
                 deadline: float | None, kv: int):
        self.feats = feats
        self.future = future
        self.t_in = time.monotonic()
        self.klass = klass
        self.deadline = deadline
        self.started = False
        self.kv = kv
        self.kv_held = False
        self._removed = False

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)


class Batcher:
    def __init__(self, engine, cfg):
        self.engine = engine
        self.model = engine.bundle.name
        self.max_batch = int(cfg.max_batch)
        self.timeout_s = float(cfg.batch_timeout_ms) / 1000.0
        self.pipeline_depth = int(getattr(cfg, "pipeline_depth", PIPELINE_DEPTH))
        self.admission = AdmissionController(cfg, engine)
        self._queue = DeadlineQueue(cfg.max_queue, weight=int(getattr(cfg, "class_weight", 4)))
        self._wake = asyncio.Event()
        self._executor = ThreadPoolExecutor(
            max_workers=self.pipeline_depth, thread_name_prefix="dispatch"
        )
        self._dispatch_sem = asyncio.Semaphore(self.pipeline_depth)
        self._batch_ewma_s = 0.05  # behind the Retry-After guidance on 503s
        self._task: asyncio.Task | None = None
        self._inflight: set[asyncio.Task] = set()
        self._closed = False
        self._cdl = None
        # The per-stream path: its workers and its live streams.
        self.max_streams = int(getattr(cfg, "max_streams", 8))
        self._stream_executor = None
        self._active_streams = 0
        self._stream_ewma_s = 1.0  # per-stream lifetimes, behind their Retry-After
        if getattr(engine.bundle, "kind", None) == KIND_SEQ2SEQ:
            self._stream_executor = ThreadPoolExecutor(max_workers=self.max_streams,
                                                       thread_name_prefix="stream")
            if getattr(cfg, "continuous_batching", True):
                from ..engine.streams import ContinuousDecodeLoop

                self._cdl = ContinuousDecodeLoop(engine, cfg)
                self._cdl.external_active = lambda: self._active_streams
                # One admission controller (KV ledger) for both queues.
                self._cdl.admission = self.admission

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        """Stop admitting, finish everything queued and in flight, and
        join the dispatch threads."""
        self._closed = True
        if self._task is not None:
            self._wake.set()
            await self._task
            self._task = None
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        self._executor.shutdown(wait=True)
        if self._cdl is not None:
            await asyncio.get_running_loop().run_in_executor(None, self._cdl.stop)
        if self._stream_executor is not None:
            # Each per-stream worker stops at its next chunk once its
            # consumer is gone.
            self._stream_executor.shutdown(wait=False)

    @property
    def default_deadline_ms(self) -> float:
        """DEADLINE_MS: the deadline of an item that brings none."""
        return self.admission.default_deadline_ms

    def begin_drain(self) -> None:
        """Stop admitting (new work sheds 503 ``drain``); everything queued
        or in flight runs to its end."""
        self.admission.draining = True

    @property
    def draining(self) -> bool:
        return self.admission.draining

    @draining.setter
    def draining(self, value: bool) -> None:
        self.admission.draining = bool(value)

    def pending_work(self) -> int:
        streams = self._cdl.admitted if self._cdl is not None else 0
        return self._queue.qsize() + len(self._inflight) + streams + self._active_streams

    def warm_engine(self) -> float:
        """``engine.warmup`` where batches will run: in every dispatch thread
        for an image model, whose cuDNN convolutions keep their execution
        plans per thread (a thread's first batch of a bucket would build
        them while its requests wait), once for the others.  Returns the
        seconds taken."""
        n = self.pipeline_depth if self.engine.bundle.kind == KIND_IMAGE else 1
        barrier = threading.Barrier(n)

        def warm_here() -> None:
            barrier.wait(timeout=60)  # each of the n calls holds a thread of its own
            self.engine.warmup()

        t0 = time.monotonic()
        for f in [self._executor.submit(warm_here) for _ in range(n)]:
            f.result()
        return time.monotonic() - t0

    def compile_status(self) -> dict:
        """``/status.compile``: the graph cache's counters, the accumulated
        warm-phase seconds, the captures and their seconds, the bytes the
        graph pools hold, and per graph kind ``"graph"`` or ``"eager:
        <reason>"`` (the JAX package's ``compile_status``, with CUDA graphs
        in place of XLA executables)."""
        from ..runtime import compile_cache

        captures = compile_cache.capture_stats()
        return {
            "executable_cache": compile_cache.cache_stats(),
            "warm_phases_s": compile_cache.warm_stats(),
            "graph_captures": captures["count"],
            "graph_capture_s": round(captures["seconds"], 3),
            "graph_pool_bytes": compile_cache.graph_pool_bytes(),
            "kinds": self.engine.graph_modes(),
        }

    def warm_streams(self) -> float:
        """Warm the decode loop (a no-op without one); returns seconds."""
        return self._cdl.warm() if self._cdl is not None else 0.0

    def submit_stream(self, feats: dict):
        """Streaming generation: the async iterator of the stream's token
        chunks (int32 arrays), from the continuous decode loop when its
        slots take the prompt, else from the per-stream path
        (``_submit_per_stream``).  Sheds with ``QueueFullError`` past
        ``max_streams`` streams on both paths together (the loop: past
        ``MAX_STREAM_QUEUE`` more waiting), while draining, or past the KV
        budget."""
        if self._closed:
            raise RuntimeError("batcher is stopped")
        if self._stream_executor is None:
            raise ValueError(f"{self.model} is not a generative model; nothing to stream")
        if self._cdl is not None and int(feats.get("length", 0)) <= self._cdl.max_prompt:
            return self._cdl.submit_stream(feats)
        return self._submit_per_stream(feats)

    def _submit_per_stream(self, feats: dict):
        """One worker thread runs ``engine.generate_stream`` and pumps its
        chunks onto the event loop.  Admission is checked and counted here,
        in the event loop, before the iterator is returned; the count drops
        when the worker ends, so an abandoned iterator frees its place.  A
        consumer that goes away stops the worker before its next chunk.
        The drain and KV-budget gates apply; there is no wait queue."""
        klass, _ = self.admission.classify(feats)
        try:
            self.admission.admit(feats, klass)
        except QueueFullError as e:
            if e.retry_after_s is None:
                e.retry_after_s = self.retry_after_s(streams=True)
            self._shed(e.reason)
            raise
        loop_admitted = self._cdl.admitted if self._cdl is not None else 0
        if self._active_streams + loop_admitted >= self.max_streams:
            self._shed("queue_full")
            raise QueueFullError(
                f"{self._active_streams + loop_admitted} streams active >= "
                f"max_streams={self.max_streams}",
                retry_after_s=self.retry_after_s(streams=True),
            )
        loop = asyncio.get_running_loop()
        chunks: asyncio.Queue = asyncio.Queue()
        cancelled = threading.Event()
        end = object()

        def pump() -> None:
            t_prev = 0.0
            try:
                gen = self.engine.generate_stream(feats)
                try:
                    for chunk in gen:
                        loop.call_soon_threadsafe(chunks.put_nowait, chunk)
                        metrics.TOKENS.labels(self.model).inc(int(chunk.size))
                        t_now = time.monotonic()
                        if t_prev:
                            metrics.TBT.labels(self.model).observe(t_now - t_prev)
                        t_prev = t_now
                        if cancelled.is_set():
                            return
                finally:
                    gen.close()
                loop.call_soon_threadsafe(chunks.put_nowait, end)
            except BaseException as e:  # to the consumer
                loop.call_soon_threadsafe(chunks.put_nowait, e)

        self._active_streams += 1
        t_started = time.monotonic()
        done = loop.run_in_executor(self._stream_executor, pump)

        def release(_fut) -> None:
            self._active_streams -= 1
            dt = time.monotonic() - t_started
            self._stream_ewma_s = 0.8 * self._stream_ewma_s + 0.2 * dt

        done.add_done_callback(release)

        async def gen():
            try:
                while True:
                    item = await chunks.get()
                    if item is end:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                cancelled.set()

        return gen()

    def retry_after_s(self, streams: bool = False) -> float:
        """Client guidance on 503: queue depth x observed batch time; for a
        stream, the streams on both paths and this one, each for the
        per-stream path's mean lifetime, spread over ``max_streams``."""
        if streams:
            waiting = self._active_streams + (self._cdl.admitted if self._cdl is not None else 0)
            est = (waiting + 1) * self._stream_ewma_s / max(1, self.max_streams)
        else:
            est = (self._queue.qsize() / max(1, self.max_batch) + 1.0) * self._batch_ewma_s
        return min(60.0, max(1.0, est))

    def _shed(self, reason: str) -> None:
        metrics.SHED.labels(self.model, reason).inc()

    def _depth_gauges(self) -> None:
        metrics.QUEUE_DEPTH.labels(self.model).set(self._queue.qsize())
        for klass in (INTERACTIVE, BATCH):
            metrics.CLASS_QUEUE_DEPTH.labels(self.model, "batch", klass).set(
                self._queue.waiting(klass))

    async def submit(self, feats: dict) -> np.ndarray:
        """Enqueue one preprocessed item; resolves to its result row.
        Sheds with ``QueueFullError`` (503: queue_full, kv_budget or drain)
        or, when its deadline passes before dispatch,
        ``DeadlineExceededError`` (504)."""
        if self._closed:
            raise RuntimeError("batcher is stopped")
        klass, deadline = self.admission.classify(feats)
        try:
            klass, kv = self.admission.admit(feats, klass)
        except QueueFullError as e:
            if e.retry_after_s is None:
                e.retry_after_s = self.retry_after_s()
            self._shed(e.reason)
            raise
        fut = asyncio.get_running_loop().create_future()
        item = _QueuedCall(feats, fut, klass, deadline, kv)
        try:
            victim = self._queue.put(item)
        except QueueFullError as e:
            e.retry_after_s = self.retry_after_s()
            self._shed("queue_full")
            raise
        if victim is not None:
            self._shed("queue_full")
            victim.fail(QueueFullError("shed for higher-priority work",
                                       retry_after_s=self.retry_after_s()))
        self._wake.set()
        self._depth_gauges()
        return await fut

    def _expire(self) -> None:
        for item in self._queue.expire():
            self.admission.release(item)
            self._shed("deadline")
            item.fail(DeadlineExceededError(
                "deadline passed while queued; request shed before dispatch"
            ))

    def _pop_ready(self):
        """Expire stale waiters, then pop the next item whose KV reservation
        fits (any item once the batcher is closing) and reserve it."""
        self._expire()
        item = self._queue.pop_nowait(fits=None if self._closed else self.admission.fits)
        if item is not None:
            self.admission.reserve(item)
        return item

    async def _wait_wake(self, timeout: float | None) -> None:
        try:
            if timeout is None:
                await self._wake.wait()
            else:
                await asyncio.wait_for(self._wake.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._wake.clear()

    async def _next_item(self):
        """Block until an item is ready, or return None once the batcher
        is closed and its queue is empty."""
        while True:
            item = self._pop_ready()
            if item is not None:
                return item
            if self._closed and self._queue.qsize() == 0:
                return None
            nd = self._queue.next_deadline()
            timeout = None if nd is None else max(0.01, nd - time.monotonic())
            if self._queue.qsize() > 0 or self._closed:
                # Waiters held by the KV budget (no event marks a release),
                # or shutdown under way: poll.
                timeout = 0.05 if timeout is None else min(timeout, 0.05)
            await self._wait_wake(timeout)

    async def _acquire_dispatch(self) -> None:
        """Take a dispatch slot; while every slot is busy, keep failing
        waiters whose deadline passes, so they 504 on time."""
        while True:
            try:
                await asyncio.wait_for(self._dispatch_sem.acquire(), 0.05)
                return
            except asyncio.TimeoutError:
                self._expire()

    async def _run(self) -> None:
        while True:
            await self._acquire_dispatch()
            first = await self._next_item()
            if first is None:
                self._dispatch_sem.release()
                return
            batch = [first]
            deadline = time.monotonic() + self.timeout_s
            while len(batch) < self.max_batch:
                item = self._pop_ready()
                if item is None:
                    remaining = deadline - time.monotonic()
                    if self._closed or remaining <= 0:
                        break
                    await self._wait_wake(remaining)
                    continue
                batch.append(item)
            self._depth_gauges()
            task = asyncio.get_running_loop().create_task(self._dispatch(batch))
            self._inflight.add(task)
            task.add_done_callback(self._dispatch_done)

    def _dispatch_done(self, task: asyncio.Task) -> None:
        self._inflight.discard(task)
        self._dispatch_sem.release()
        self._wake.set()

    async def _dispatch(self, batch: list[_QueuedCall]) -> None:
        loop = asyncio.get_running_loop()
        now = time.monotonic()
        tr = tracing.tracer()
        for item in batch:
            metrics.QUEUE_WAIT.labels(self.model).observe(now - item.t_in)
            if tr is not None:
                tr.add("queue_wait", cat="sched",
                       rid=str(item.feats.get("request_id") or ""),
                       t0=item.t_in, dur=now - item.t_in, klass=item.klass)
        metrics.BATCH_SIZE.labels(self.model).observe(len(batch))
        feats = [item.feats for item in batch]
        t0 = time.monotonic()
        try:
            rows = await loop.run_in_executor(self._executor, self.engine.run_batch, feats)
        except Exception as e:
            for item in batch:
                item.fail(e)
            return
        finally:
            for item in batch:
                self.admission.release(item)
        dt = time.monotonic() - t0
        self._batch_ewma_s = 0.8 * self._batch_ewma_s + 0.2 * dt
        metrics.DEVICE_TIME.labels(self.model).observe(dt)
        for item, row in zip(batch, rows):
            if not item.future.done():
                item.future.set_result(row)


def batch_results(rows: list[np.ndarray]) -> Any:
    """Helper for tests: stack row results."""
    return np.stack(rows)
