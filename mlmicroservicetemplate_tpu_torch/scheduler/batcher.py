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
and the loop, so its ledger covers both.  Under ``SPEC_DECODE`` a stream
takes the per-stream path's speculation while fewer than
``SPEC_MAX_STREAMS`` generations are active on both paths (``spec_route``),
and under ``SPEC_CONTINUOUS`` with ``SPEC_SAMPLED=0`` a sampled stream
bypasses the speculative loop (``sampled_opt_out``), as in the JAX package.
Under ``ADAPTER_DIR`` the batcher builds the LoRA ``AdapterPool`` and hands
it to the engine and the loop (refused with speculative decoding and for
adapters of another architecture, as in the JAX package); a stream with an
``adapter_id`` serves only through the loop, and the per-stream path sheds
it with reason ``adapter_pool``.  The whole (non-streamed) path generates
with the base model, as the reference's does.  Under ``TENANTS`` or
``TENANTS_FILE`` it builds the ``TenantRegistry`` (the admission
controller's quota gate: 429 ``quota``) and a ``WeightedFairShare`` for its
queue and one for the loop's; every other shed is counted against its
tenant too, and every shed path returns the tenant's lease.

Durable serving (``JOURNAL_DIR``, a generative model): the batcher builds
one ``StreamJournal`` a process and hands it to the engine, where the
loop's hooks find it; a unary request whose client-supplied
``X-Request-Id`` has a journaled result is answered from it with no
dispatch, and each such result is journaled as it lands;
``resume_stream`` hands a journal replay's streams to the loop.  Under
``JOBS_ENABLED`` it builds the bulk-job ``JobManager`` (``jobs/``), whose
governor reads ``interactive_load``.  ``stop()`` stops the jobs first and
closes the journal and the disk tier last.
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
                 "_removed", "tenant")

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
        # The fair share's key ("" = anonymous).
        self.tenant = str(feats.get("tenant") or "")

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
        # One write-ahead journal a process (JOURNAL_DIR), on the engine
        # where the loop's hooks find it.  Unset: no journal object exists.
        self._owns_journal = False
        jdir = getattr(cfg, "journal_dir", None)
        if (jdir and getattr(engine.bundle, "kind", None) == KIND_SEQ2SEQ
                and getattr(engine, "journal", None) is None):
            from ..runtime.durability import StreamJournal

            engine.journal = StreamJournal(jdir, fsync=getattr(cfg, "journal_fsync", "always"),
                                           model=engine.bundle.name)
            self._owns_journal = True
        # Supervised crash recovery (SUPERVISE, engine/supervisor.py): the
        # continuous loop's restart budget; /readyz reads its ``failed``.
        self.supervisor = None
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
                if getattr(cfg, "supervise", True):
                    from ..engine.supervisor import Supervisor

                    # It dumps the engine's flight recorder the moment it
                    # refuses a restart.
                    self.supervisor = Supervisor(cfg, recorder=getattr(engine, "flight", None))
                    self._cdl.supervisor = self.supervisor
        # Multi-tenant serving (tenancy/): the tenant registry and a fair
        # share on the batcher's queue and the loop's (TENANTS,
        # TENANTS_FILE), and the batched multi-adapter LoRA pool
        # (ADAPTER_DIR), with the reference's boot refusals.  Unset, none of
        # it is built: the queues pop plain EDF and every dispatch is the
        # base model's.
        self.tenants = None
        self.adapters = None
        if getattr(cfg, "tenants", None) or getattr(cfg, "tenants_file", None) or getattr(
                cfg, "adapter_dir", None):
            self._build_tenancy(cfg)
        # The bulk-job lane (JOBS_ENABLED): its store under JOURNAL_DIR/jobs
        # and the executor that backfills its lines.  Unset: no job code.
        self.jobs = None
        if getattr(cfg, "jobs_enabled", False):
            from ..jobs.executor import JobManager

            self.jobs = JobManager(engine, self, cfg)

    def _build_tenancy(self, cfg) -> None:
        """The tenant registry and its fair shares, and the adapter pool,
        each where its knob is set; a bad table or pool fails the boot."""
        from ..tenancy.accounts import TenantRegistry
        from ..tenancy.adapters import AdapterPool
        from ..tenancy.fairshare import WeightedFairShare

        engine = self.engine
        default_w = float(getattr(cfg, "tenant_default_weight", 1.0) or 1.0)
        try:
            reg = TenantRegistry.from_cfg(cfg, model=self.model)
            pool = None
            if getattr(cfg, "adapter_dir", None):
                pool = AdapterPool.from_cfg(cfg, model=self.model, device=engine.device,
                                            device_lock=engine._lock)
                if getattr(engine, "spec_enabled", False) or (
                        self._cdl is not None and self._cdl.spec):
                    raise ValueError(
                        "ADAPTER_DIR does not compose with "
                        "SPEC_DECODE/SPEC_CONTINUOUS: the "
                        "draft→verify executables run the base "
                        "model only"
                    )
                # Wrong-architecture adapters fail the boot, not the first
                # adapted request.
                pool.validate_against(engine.bundle.model)
        except Exception:
            # A failed boot leaves no loop thread behind.
            if self._cdl is not None:
                self._cdl.stop()
            raise
        self.tenants = reg
        self.adapters = pool
        if pool is not None:
            engine.adapters = pool
        if reg is not None:
            self.admission.set_tenants(reg)
            self._queue.set_fairshare(WeightedFairShare(reg.weights(), default_w))
        if self._cdl is not None:
            self._cdl.tenants = reg
            self._cdl.adapters = pool
            if reg is not None:
                self._cdl.queue.set_fairshare(WeightedFairShare(reg.weights(), default_w))

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        """Stop admitting, finish everything queued and in flight, and
        join the dispatch threads."""
        self._closed = True
        if self.jobs is not None:
            # The executor submits into this batcher: it stops first.
            await self.jobs.stop()
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
        if self._owns_journal:
            for part in (getattr(self.engine, "journal", None),
                         getattr(self.engine, "kv_disk", None)):
                if part is not None:
                    part.close()

    def interactive_load(self) -> tuple[bool, bool]:
        """(interactive decode live, interactive work waiting): the bulk-job
        governor's claim signal."""
        if self._cdl is not None:
            return self._cdl.interactive_load()
        return self._active_streams > 0, False

    def resume_stream(self, feats: dict, delivered: list[int]):
        """A journal replay's stream, to the continuous loop: its
        continuation's iterator, or None when its budget was delivered
        already.  RuntimeError without the loop (CONTINUOUS_BATCHING=0)."""
        if self._cdl is None:
            raise RuntimeError(
                "journal replay needs the continuous decode loop "
                "(CONTINUOUS_BATCHING=1)"
            )
        return self._cdl.resume_stream(feats, delivered)

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
        """Warm the decode loop (a no-op without one), the adapter pool's
        install path first; returns seconds."""
        if self._cdl is None:
            return 0.0
        if self._cdl.adapters is not None:
            self._cdl.adapters.warm()
        return self._cdl.warm()

    def tenancy_status(self) -> dict | None:
        """``/status.tenancy``: each tenant's usage and quotas, the ledger's
        totals and the fair share's virtual times (``TENANTS``), and the
        adapter pool's slot residency (``ADAPTER_DIR``); None (the key
        absent) with neither."""
        if self.tenants is None and self.adapters is None:
            return None
        out: dict = {}
        if self.tenants is not None:
            out["tenants"] = self.tenants.usage()
            out["totals"] = self.tenants.totals()
            fs = self._queue._fairshare
            if fs is not None:
                out["fairshare"] = fs.snapshot()
        if self.adapters is not None:
            out["adapters"] = self.adapters.status()
        return out

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
        # SPEC_DECODE routes a stream to the per-stream path (where the
        # speculative graphs live) only in the low-concurrency regime it
        # targets: fewer than SPEC_MAX_STREAMS active on both paths.  Under
        # load one batched dispatch beats serialized speculative streams, so
        # the loop takes them.  Sampled streams speculate by rejection
        # sampling unless SPEC_SAMPLED=0.
        eng = self.engine
        loop_admitted = self._cdl.admitted if self._cdl is not None else 0
        sampled = float(feats.get("temperature", 0.0)) > 0.0
        spec_route = (getattr(eng, "spec_enabled", False) and not feats.get("adapter_id")
                      and (not sampled or eng.spec_sampled)
                      and self._active_streams + loop_admitted
                      < int(eng.cfg.spec_max_streams))
        # A speculative loop (SPEC_CONTINUOUS) under SPEC_SAMPLED=0 would
        # accept its sampled rows by rejection sampling, breaking the
        # opt-out's seed contract: those streams take the per-stream path.
        sampled_opt_out = (self._cdl is not None and self._cdl.spec and sampled
                           and not eng.spec_sampled)
        if (self._cdl is not None and not spec_route and not sampled_opt_out
                and int(feats.get("length", 0)) <= self._cdl.max_prompt):
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
        tenant = str(feats.get("tenant") or "")
        try:
            self.admission.admit(feats, klass)
        except QueueFullError as e:
            if e.retry_after_s is None:
                e.retry_after_s = self.retry_after_s(streams=True)
            self._shed(e.reason, tenant)
            raise
        if feats.get("adapter_id"):
            # Adapters serve through the continuous loop's batched dispatch
            # only: this path sheds rather than generate base-model tokens.
            self.admission.release_lease(feats)
            self._shed("adapter_pool", tenant)
            raise QueueFullError(
                "adapter streams require the continuous batching path "
                "(prompt exceeds the largest seq bucket, or "
                "CONTINUOUS_BATCHING=0)",
                reason="adapter_pool",
                retry_after_s=self.retry_after_s(streams=True),
            )
        loop_admitted = self._cdl.admitted if self._cdl is not None else 0
        if self._active_streams + loop_admitted >= self.max_streams:
            self.admission.release_lease(feats)
            self._shed("queue_full", tenant)
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
            self.admission.release_lease(feats)
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

    def _shed(self, reason: str, tenant: str = "") -> None:
        metrics.SHED.labels(self.model, reason).inc()
        if self.tenants is not None and reason != "quota":
            # Attributed to the tenant too; a quota shed was at its gate.
            self.tenants.note_shed(tenant, reason)

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
        # A client-supplied X-Request-Id whose result was journaled (before
        # a crash, say) is answered from the journal: a lookup, not a
        # recompute, and never another completion.  Minted ids never
        # repeat, so the API marks only the client's (``rid_client``).
        j = getattr(self.engine, "journal", None)
        rid = str(feats.get("request_id") or "")
        if j is not None and rid and feats.get("rid_client"):
            cached = j.lookup_result(rid)
            if cached is not None:
                return np.asarray(cached, np.int32)
        klass, deadline = self.admission.classify(feats)
        try:
            klass, kv = self.admission.admit(feats, klass)
        except QueueFullError as e:
            if e.retry_after_s is None:
                e.retry_after_s = self.retry_after_s()
            self._shed(e.reason, str(feats.get("tenant") or ""))
            raise
        fut = asyncio.get_running_loop().create_future()
        item = _QueuedCall(feats, fut, klass, deadline, kv)
        try:
            victim = self._queue.put(item)
        except QueueFullError as e:
            self.admission.release_lease(feats)
            e.retry_after_s = self.retry_after_s()
            self._shed("queue_full", item.tenant)
            raise
        if victim is not None:
            self.admission.release_lease(victim.feats)
            self._shed("queue_full", victim.tenant)
            victim.fail(QueueFullError("shed for higher-priority work",
                                       retry_after_s=self.retry_after_s()))
        self._wake.set()
        self._depth_gauges()
        return await fut

    def _expire(self) -> None:
        for item in self._queue.expire():
            self.admission.release(item)
            self._shed("deadline", item.tenant)
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
            rows = await loop.run_in_executor(self._executor, self._run_batch, feats)
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
        j = getattr(self.engine, "journal", None)
        for item, row in zip(batch, rows):
            if j is not None and item.feats.get("rid_client"):
                rid = str(item.feats.get("request_id") or "")
                arr = np.asarray(row)
                if rid and np.issubdtype(arr.dtype, np.integer):
                    # Journaled for X-Request-Id dedup (token rows: the
                    # generative unary path).
                    j.result(rid, arr)
            if not item.future.done():
                item.future.set_result(row)

    def _run_batch(self, feats: list[dict]):
        """One batch through the engine under its fault injector and
        watchdog, its host seconds on the ``batch`` dispatch site, as the
        JAX batcher's guarded dispatch (duck-typed engines without the
        guard run bare)."""
        guard = getattr(self.engine, "dispatch_guard", None)
        if guard is None:
            return self.engine.run_batch(feats)
        return guard("batch", lambda: self.engine.run_batch(feats))


def batch_results(rows: list[np.ndarray]) -> Any:
    """Helper for tests: stack row results."""
    return np.stack(rows)
