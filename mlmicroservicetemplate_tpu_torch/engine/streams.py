"""Continuous batching for streaming generation.

Counterpart of the JAX package's ``engine/streams.py``
(``ContinuousDecodeLoop``).  One loop thread owns
a batched decode state of ``MAX_STREAMS`` rows ("slots").  At every chunk
boundary it admits the waiting streams as one wave (one prefill plus the
first decode chunk for the whole wave, ``InferenceEngine.start``), copies
each wave row into a free slot, dispatches one batched decode chunk for
every live slot and routes each row's tokens to its stream; a stream that
hits EOS or its budget frees its slot.  One chunk stays in flight: chunk
N+1 is dispatched before chunk N's tokens and ``done`` flags are read to
the host, once per chunk.

Sampling: each slot row carries its stream's ``SampleParams`` (copied in
at insert with the rest of the row, the rng chain as the wave's first
chunk left it), and the loop runs the sampled variant of its chunk while
any live slot samples (``sampled_slots``), the argmax one otherwise; a
seeded stream draws the same tokens whichever slots it shares the state
with.

KV layouts, as in the reference:
- contiguous (``PAGED_KV=0``): every slot holds ``[largest seq bucket +
  decode budget]`` cache rows; decode runs the contiguous decode-attention
  kernel (K2).  An encoder-decoder (T5) brings its own slot state
  (``ModelBundle.slot_state``): self caches ``[decode budget]`` rows, cross
  K/V and an encoder mask as wide as the largest seq bucket; an insert
  copies every field of the wave row, zero-padding the narrower ones, as
  the reference's ``ins_row`` does, whatever the family.
- block-paged (``PAGED_KV=1``): per-layer pools of ``KV_BLOCK_SIZE``-token
  blocks shared by every slot, plus a host-owned block table per slot
  (``engine/kv_blocks.py``) that each chunk carries to the device.  A
  stream holds its prompt's blocks and the first chunk's at admission,
  grows block by block before each chunk and returns every block when it
  ends.  Decode runs the paged decode-attention kernel (K3); the wave's
  first chunk runs on its contiguous prefill state, so K2 runs once per
  admission wave here too.

A freed slot's row keeps stepping until the slot is reused, as in the
reference: its writes past a width land in its own last column
(``models/llama.py``; in paged mode its table row is the sentinel, whose
K/V writes land in the pool's scratch block) and its tokens are
discarded; an insert overwrites the whole row.  The
per-slot step counts live on the host (``_dispatched_steps``), so the
slot state carries none.

On the card each chunk replays one CUDA graph (``loop_chunk``, or
``loop_chunk_paged``; ``runtime/compile_cache.py``) captured over the slot
state, which is allocated once and reset in place, never reallocated,
and over a static ``[n_slots, nb_max]`` copy of the block table written
before each replay.  The graph is captured when the slot state is
allocated, every slot dead (whether or not the service warmed up): the
capture's eager run advances the rows it runs over, which a live stream
must not see; both variants (argmax and sampled) are captured then.  The
host copy of a chunk's tokens and ``done`` flags
is enqueued right after its replay, before the next one.  A wave's
prefill runs the bucket's ``start`` graph, whose static state the next
``start`` overwrites, so the loop holds the engine's ``_lock`` from the
wave's ``start`` until its rows are copied into their slots.

The engine's ``_lock`` serializes the loop's dispatches with the
non-streaming batcher's and the per-stream path's (prompts past the
largest seq bucket; ``MAX_STREAMS`` counts those streams too,
``external_active``); tokens reach each stream's asyncio queue through
``loop.call_soon_threadsafe``.  The loop thread enters
``torch.inference_mode`` itself (it is thread-local).

Admission and shedding, as in the reference: each stream is classified
(``X-Priority``, else ``PRIORITY_DEFAULT``; ``deadline_ms``, else
``DEADLINE_MS``) and admitted by the shared ``AdmissionController``
(``scheduler/admission.py``: drain, and the KV budget, which sheds work
that can never fit and down-classes interactive work under pressure), then
waits in a two-class EDF ``DeadlineQueue`` of ``MAX_STREAMS +
MAX_STREAM_QUEUE``.  Past that many admitted streams a submit sheds the
lowest-class latest-deadline waiter it outranks, or else itself, with
``QueueFullError`` and ``Retry-After`` advice of (admitted + 1) x the EWMA
of stream lifetimes (submit to release) / ``MAX_STREAMS``.  A stream still
queued when its deadline passes is failed with ``DeadlineExceededError``
at the next iteration top (the API answers 504).  A stream leaves the
queue only when its KV reservation fits (``AdmissionController.fits``).

Preemption (``PREEMPT``, on by default): when interactive streams wait and
every slot is busy, the iteration top checkpoints batch-class slot
holders (latest deadline first; a stream yields at most twice; none while
a checkpointed stream still waits) and queues them again, ``started``, so
they neither expire nor are evicted.  The checkpoint is the tokens already
delivered: a greedy stream of a causal decoder (``supports_prefix``) whose
prompt and delivered tokens fit the largest seq bucket resumes by
prefilling them as its new prompt (*recast*); every other stream (sampled,
T5) replays its whole generation with the delivered tokens suppressed
(*replay*; a sampled stream's seed is pinned at admission, so the replay
draws the same tokens).  A paged stream whose insert or growth finds the
pool dry is checkpointed and queued again the same way.  A checkpointed
stream holds no blocks and no reservation while it waits.  The victim's
row in the chunk still in flight writes through the table that chunk
read; its blocks return to the pool at once, and a new tenant's insert,
enqueued on the same CUDA stream, lands after that chunk's writes.

Not ported (``ROADMAP.md``): the prefix cache and shared blocks, chunked
prefill, the host and disk KV tiers, decode windows, pipelining deeper
than one chunk, speculative decoding in the loop, fleets, the journal and
the supervisor.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
import threading
import time
from typing import Any, AsyncIterator

import numpy as np
import torch

from ..models.gpt import GPTState, PagedState, state_tensors
from ..models.sampling import greedy_params
from ..ops.paged_attention import scatter_pages
from ..runtime import compile_cache
from ..scheduler.admission import AdmissionController
from ..scheduler.policy import (
    BATCH,
    INTERACTIVE,
    DeadlineExceededError,
    DeadlineQueue,
    QueueFullError,
)
from ..utils import metrics, tracing
from .kv_blocks import OutOfBlocks, StreamBlocks

log = logging.getLogger(__name__)

_END = object()


class StreamClosedError(Exception):
    """The decode loop is shutting down."""


class _Stream:
    """One client stream: the loop thread's handle on an event-loop queue
    of token chunks, the deadline queue's item (``klass``, ``deadline``,
    ``started``) and, under preemption, its own checkpoint: ``tokens`` holds
    every token delivered, so a preempted stream resumes token-identically."""

    __slots__ = ("feats", "chunks", "loop", "cancelled", "produced", "released", "budget",
                 "klass", "deadline", "started", "kv", "kv_held", "skip", "tokens",
                 "preempted", "_removed", "blocks", "s_base", "rid", "t_emit", "t_in",
                 "t_queued")

    # The admission ledger's marker: paged streams are accounted by the pool.
    is_stream = True

    def __init__(self, feats: dict, loop: asyncio.AbstractEventLoop, budget: int):
        self.feats = feats
        self.t_in = time.monotonic()  # submit; release - t_in is the lifetime
        self.t_queued = self.t_in  # when it last entered the queue
        # Scheduling fields, set at submit: the class, the absolute
        # monotonic deadline by which it must leave the queue (or None),
        # whether it has delivered tokens and was queued again (exempt
        # from expiry and eviction), and its KV reservation.
        self.klass = INTERACTIVE
        self.deadline: float | None = None
        self.started = False
        self.kv = 0
        self.kv_held = False
        self._removed = False
        self.chunks: asyncio.Queue = asyncio.Queue()
        self.loop = loop
        self.cancelled = threading.Event()
        # Decode steps run for this stream since its last (re)start, and
        # its budget (max_tokens clamped to the server's; after a recast,
        # what was left of it).
        self.produced = 0
        self.released = False  # exactly-once release
        self.budget = budget
        # The checkpoint: tokens delivered (since the last recast), tokens a
        # replay still suppresses, and how often it was preempted.
        self.tokens: list[int] = []
        self.skip = 0
        self.preempted = 0
        # Paged KV: the stream's blocks and its prefill's collated width.
        self.blocks: StreamBlocks | None = None
        self.s_base = 0
        self.rid = str(feats.get("request_id") or "")
        self.t_emit = 0.0

    def emit(self, item: Any) -> None:
        try:
            self.loop.call_soon_threadsafe(self.chunks.put_nowait, item)
        except RuntimeError:
            # Event loop closed: the consumer is gone.
            self.cancelled.set()


class _HostCopy:
    """Device-to-host copies started without waiting (pinned buffers and
    an event on the card; copies on the CPU).  ``get`` waits for them."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class ContinuousDecodeLoop:
    """Slot-based batched decode over one ``InferenceEngine``."""

    def __init__(self, engine, cfg):
        self.engine = engine
        self.model = engine.bundle.name
        self.max_streams = int(cfg.max_streams)
        self.n_slots = self.max_streams
        # Slots hold prompts up to the largest seq bucket.
        self.max_prompt = max(engine.seq_buckets)
        self.chunk = engine.chunk_tokens
        self.paged = engine.paged_kv
        if self.paged:
            self.block_size = engine.kv_block_size
            self.pool = engine.kv_pool
            self.nb_max = engine.kv_blocks_per_stream
            # A free slot's row names the sentinel id (== pool size).
            self._table = np.full((self.n_slots, self.nb_max), self.pool.num_blocks, np.int32)
            self._dispatched_steps: dict[int, int] = {}
        # An idle loop waits this long for the rest of a concurrent burst
        # before admitting the wave (ADMIT_GRACE_MS).
        self.admit_grace_s = float(getattr(cfg, "admit_grace_ms", 8.0)) / 1e3
        # Up to MAX_STREAM_QUEUE streams wait beyond the slots.
        self.max_stream_queue = max(0, int(getattr(cfg, "max_stream_queue", 0)))
        self.queue = DeadlineQueue(self.max_streams + self.max_stream_queue,
                                   weight=int(getattr(cfg, "class_weight", 4)))
        # Classes, deadlines and the KV ledger; the batcher puts its own
        # controller here, shared with its request queue.
        self.admission = AdmissionController(cfg, engine)
        # Interactive arrivals may preempt batch-class slot holders.
        self.preempt = bool(getattr(cfg, "preempt", True))
        # EWMA of stream lifetimes (submit to release), behind Retry-After.
        self._stream_ewma_s = 1.0
        # Streams the batcher serves on the per-stream path: MAX_STREAMS
        # caps them and the loop's together.
        self.external_active = lambda: 0
        self.active: dict[int, _Stream] = {}
        # Live slots whose stream samples: the loop runs the sampled chunk
        # while this is non-empty.
        self.sampled_slots: set[int] = set()
        self.free: list[int] = list(range(self.n_slots))
        # The slot state (loop-thread-owned; built once, reset in place) and,
        # paged, the block table's device copy.
        self._state = None
        self._table_dev: torch.Tensor | None = None
        self._state_stale = False
        # Dispatched chunks not yet routed: (host copy of (tokens, done),
        # {slot: stream at dispatch}); the snapshot keeps a late chunk's
        # rows from reaching a slot's next tenant.
        self._inflight: list[tuple[_HostCopy, dict[int, _Stream]]] = []
        # Streams admitted and not yet released (queued or in a slot).
        self._admitted = 0
        self._admitted_lock = threading.Lock()
        # Streams popped off the queue whose prefill is not yet dispatched,
        # and admissions dispatched but not yet in a slot: the failure
        # path must end these consumers too.
        self._pending_wave: list[_Stream] = []
        self._pending_admissions: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._thread_lock = threading.Lock()
        # Counters (since start or a reset by the caller): wave prefills
        # (each also runs one contiguous decode chunk), chunk dispatches
        # of the slot state and their decode steps.
        self.prefill_dispatches = 0
        self.chunk_dispatches = 0
        self.decode_steps = 0
        # Checkpoints: preemptions for interactive work, dry-pool stalls (a
        # paged insert or growth found the pool dry), and how the
        # checkpointed streams resume (recast or replay).
        self.preemptions = 0
        self.kv_growth_stalls = 0
        self.recasts = 0
        self.replays = 0

    # ------------------------------------------------------------------
    # event-loop side

    @property
    def admitted(self) -> int:
        return self._admitted

    def submit_stream(self, feats: dict) -> AsyncIterator[np.ndarray]:
        """Queue one stream; returns the async iterator of its token
        chunks.  Classifies and admits it (``QueueFullError`` while draining
        or past the KV budget); past ``max_streams + max_stream_queue``
        admitted streams it sheds the waiter it outranks, or else itself,
        with ``QueueFullError``.  A stream still queued when its deadline
        passes fails with ``DeadlineExceededError`` (the API answers 504)."""
        if self._stop.is_set():
            raise RuntimeError("decode loop is stopped")
        if float(feats.get("temperature", 0.0) or 0.0) > 0.0 and feats.get("seed") is None:
            # Pin the seed now: a resume replays the generation, and a seed
            # drawn again at collate would part from the tokens delivered.
            feats["seed"] = random.getrandbits(32)
        adm = self.admission
        st = _Stream(feats, asyncio.get_running_loop(), self.engine.budget_for(feats))
        with tracing.span("admission", cat="sched", rid=st.rid):
            klass, st.deadline = adm.classify(feats)
            try:
                st.klass, st.kv = adm.admit(feats, klass)
            except QueueFullError as e:
                if e.retry_after_s is None:
                    e.retry_after_s = self._retry_after_s()
                metrics.SHED.labels(self.model, e.reason).inc()
                raise
            cap = self.max_streams + self.max_stream_queue
            with self._admitted_lock:
                total = self._admitted + int(self.external_active())
                victim = self.queue.evict_for(st) if total >= cap else None
                if total < cap or victim is not None:
                    self._admitted += 1
            if total >= cap and victim is None:
                metrics.SHED.labels(self.model, "queue_full").inc()
                raise QueueFullError(
                    f"{total} streams active >= max_streams={self.max_streams}"
                    f"+{self.max_stream_queue} queued",
                    retry_after_s=self._retry_after_s(),
                )
            if victim is not None:
                metrics.SHED.labels(self.model, "queue_full").inc()
                self._finish(victim, QueueFullError("shed for higher-priority stream",
                                                    retry_after_s=self._retry_after_s()))
            st.t_queued = time.monotonic()
            self.queue.put(st, force=True)  # the bound is enforced above
        self._ensure_thread()
        return self._consumer_gen(st)

    def _consumer_gen(self, st: _Stream):
        async def gen():
            try:
                while True:
                    item = await st.chunks.get()
                    if item is _END:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                # Consumer gone (disconnect or full drain): the loop thread
                # frees the slot at the next chunk boundary.
                st.cancelled.set()

        return gen()

    def _retry_after_s(self) -> float:
        """Client guidance on 503: the streams ahead, and this one, each
        for the mean stream lifetime, spread over the slots."""
        est = (self._admitted + 1) * self._stream_ewma_s / max(1, self.max_streams)
        return min(60.0, max(1.0, est))

    # ------------------------------------------------------------------
    # lifecycle

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="decode-loop",
                                                daemon=True)
                self._thread.start()

    def stop(self) -> None:
        """Stop the loop thread; every stream still queued or live ends
        with ``StreamClosedError``."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=30)

    def warm(self) -> float:
        """Build the slot state and run one chunk over it (every row dead)
        before the first stream, so the pools' allocation, the decode
        kernels' first build and load and, on the card, the chunk's graph
        capture land before the service reports ready; returns the seconds
        taken.  A no-op once the loop thread runs."""
        with self._thread_lock:
            if self._thread is not None:
                return 0.0
            eng = self.engine
            with compile_cache.warm_phase(self.model, "loop") as phase, \
                    torch.inference_mode(), eng._lock:
                if self._state is None:
                    self._build_empty_state()
                self._state, toks = self._chunk_call()
                toks.cpu()
        return phase.seconds

    # ------------------------------------------------------------------
    # loop thread

    def _run(self) -> None:
        """Thread entry.  If the loop body dies on something its
        per-iteration handler does not catch, every consumer still gets a
        terminal error instead of waiting forever."""
        try:
            with torch.inference_mode():
                self._run_loop()
        except BaseException as e:
            log.exception("decode loop thread died")
            self._fail_all(e)
            for st in self.queue.drain_all():
                self._finish(st, e)
            raise

    def _run_loop(self) -> None:
        log.info("continuous decode loop up: %d slots, %s KV", self.n_slots,
                 "paged" if self.paged else "contiguous")
        while not self._stop.is_set():
            try:
                # Streams whose deadline passed in the queue shed as 504s
                # before any admission work.
                self._expire_queued()
                if not self.active and not self._inflight and self.queue.qsize() == 0:
                    st = self.queue.pop(timeout=0.05, fits=self.admission.fits)
                    if st is None:
                        continue
                    self._reserve(st)
                    wave = [st]
                else:
                    wave = []
                # Interactive streams wait and every slot is busy: checkpoint
                # batch-class slot holders so this wave admits them.
                if (self.preempt and not wave and not self.free
                        and self.queue.waiting(INTERACTIVE) > 0):
                    self._preempt_for_interactive()
                # Chunk boundary: admit everything that fits, as one wave.
                while len(wave) + len(self.active) < self.n_slots:
                    st = self.queue.pop_nowait(fits=self.admission.fits)
                    if st is None:
                        break
                    self._reserve(st)
                    wave.append(st)
                if wave and not self.active and not self._inflight:
                    # Idle: give the rest of a concurrent burst a moment to
                    # arrive, so it prefills as one wave.
                    deadline = time.monotonic() + self.admit_grace_s
                    while len(wave) < self.n_slots:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        st = self.queue.pop(timeout=remaining, fits=self.admission.fits)
                        if st is None:
                            break
                        self._reserve(st)
                        wave.append(st)
                self._class_gauges()
                # The live chunk goes first; the wave's prefill queues
                # behind it on the device.
                dispatched = False
                self._pending_wave = wave
                if self.active and self._work_remains():
                    self._dispatch_chunk()
                    dispatched = True
                if wave:
                    # One hold of the lock from the wave's start until its
                    # rows sit in their slots: the next start overwrites
                    # the state they are copied from.
                    with self.engine._lock:
                        self._pending_admissions = self._admit_dispatch(wave)
                        self._pending_wave = []
                        if self._pending_admissions:
                            self._admit_complete(self._pending_admissions)
                            self._pending_admissions = []
                # One chunk in flight: route the older one once the next
                # is dispatched, or everything when nothing was.
                if len(self._inflight) > 1:
                    self._deliver_oldest()
                elif self._inflight and not dispatched:
                    while self._inflight:
                        self._deliver_oldest()
                elif not dispatched and not wave and not self.active:
                    # Waiters whose reservation does not fit yet, nothing in
                    # flight: poll, do not spin.
                    time.sleep(0.01)
            except Exception as e:
                log.exception("decode loop iteration failed")
                self._fail_all(e)
        closed = StreamClosedError("server stopping")
        for st in self.queue.drain_all():
            self._finish(st, closed)
        for slot in list(self.active):
            self.active[slot].emit(closed)
            self._free_slot(slot)
        self._inflight.clear()

    def _fail_all(self, exc: BaseException) -> None:
        """End every pending and live stream with ``exc``; the slot state
        is rebuilt at the next admission."""
        for st, *_ in self._pending_admissions:
            self._finish(st, exc)
        self._pending_admissions = []
        for st in self._pending_wave:
            self._finish(st, exc)
        self._pending_wave = []
        for slot in list(self.active):
            self.active[slot].emit(exc)
            self._free_slot(slot)
        self._inflight.clear()
        self._state_stale = True  # reset at the next admission

    def _reserve(self, st: _Stream) -> None:
        tr = tracing.tracer()
        if tr is not None:
            # The queue wait ends here (a resume's starts at its requeue).
            tr.add("queue_wait", cat="sched", rid=st.rid, t0=st.t_queued, klass=st.klass,
                   resumed=st.started)
        self.admission.reserve(st)

    def _class_gauges(self) -> None:
        for klass in (INTERACTIVE, BATCH):
            metrics.CLASS_QUEUE_DEPTH.labels(self.model, "stream", klass).set(
                self.queue.waiting(klass))

    def _expire_queued(self) -> None:
        """Fail every queued stream whose deadline passed while it waited;
        its consumer raises before any response bytes went out.  A stream
        in a slot never expires."""
        for st in self.queue.expire():
            metrics.SHED.labels(self.model, "deadline").inc()
            self._finish(st, DeadlineExceededError(
                "deadline passed while queued; stream shed before dispatch"))

    def _release(self, st: _Stream) -> None:
        """Exactly once per stream."""
        if not st.released:
            st.released = True
            self.admission.release(st)
            dt = time.monotonic() - st.t_in
            with self._admitted_lock:
                self._admitted -= 1
                self._stream_ewma_s = 0.8 * self._stream_ewma_s + 0.2 * dt

    def _finish(self, st: _Stream, item: Any = _END) -> None:
        st.emit(item)
        self._release(st)

    def _free_slot(self, slot: int) -> None:
        st = self.active.pop(slot, None)
        self.free.append(slot)
        self.sampled_slots.discard(slot)
        self._release_blocks(slot, st)
        if st is not None:
            self._release(st)

    def _release_blocks(self, slot: int, st: _Stream | None) -> None:
        """Return a slot's blocks to the pool and point its table row at
        the sentinel, so the dead row's writes go to the scratch block."""
        if not self.paged:
            return
        if st is not None and st.blocks is not None:
            st.blocks.release()
            st.blocks = None
        self._table[slot, :] = self.pool.num_blocks
        self._dispatched_steps.pop(slot, None)
        self.admission.note_pool()

    # -- preemption ----------------------------------------------------

    def _preempt_for_interactive(self) -> None:
        """Interactive streams wait and every slot is busy: at this chunk
        boundary, checkpoint batch-class slot holders (latest deadline
        first) and queue them again; their consumers never see the gap.
        None while a checkpointed stream still waits (each preemption
        discards compute), and a stream yields at most twice."""
        if self.queue.waiting_started() > 0:
            return
        want = min(self.queue.waiting(INTERACTIVE), self.n_slots)
        victims = [(slot, st) for slot, st in self.active.items()
                   if st.klass == BATCH and not st.cancelled.is_set() and st.preempted < 2]
        victims.sort(key=lambda e: e[1].deadline if e[1].deadline is not None
                     else float("inf"), reverse=True)
        n = 0
        for slot, st in victims:
            if n >= want or len(self.free) >= want:
                break
            self._vacate(slot, st)
            self.preemptions += 1
            metrics.PREEMPTIONS.labels(self.model).inc()
            n += 1
        if n:
            # The vacated slots go to the interactive waiters, not back to
            # the batch class just preempted.
            self.queue.prefer_interactive()

    def _vacate(self, slot: int, st: _Stream) -> None:
        """Take a live stream out of its slot, checkpoint it and queue it
        again.  Its row in a chunk still in flight is never routed (struck
        from the snapshot, since the stream may be admitted again, even to
        the same slot, before that chunk is routed), its blocks return to
        the pool and its table row points at the sentinel."""
        for _, snapshot in self._inflight:
            if snapshot.get(slot) is st:
                del snapshot[slot]
        self.active.pop(slot)
        self.sampled_slots.discard(slot)
        self.free.append(slot)
        self.admission.release(st)
        self._requeue_preempted(st)
        self._release_blocks(slot, st)

    def _note_stall(self) -> None:
        """A paged insert or growth found the pool dry."""
        self.kv_growth_stalls += 1
        metrics.KV_GROWTH_STALLS.labels(self.model).inc()

    def _checkpoint_for_resume(self, st: _Stream) -> bool:
        """Prepare one stream's token-identical resume off the tokens it
        delivered; False when nothing is left to resume (finished or
        cancelled).  Recast: a greedy causal decoder's remaining tokens
        continue prompt + delivered, so those become its prompt (when they
        fit the largest seq bucket).  Replay: everything else runs its whole
        generation again and suppresses the first ``skip`` tokens."""
        remaining = st.budget - st.produced
        if remaining <= 0 or st.cancelled.is_set():
            return False
        st.started = True
        st.preempted += 1
        greedy = float(st.feats.get("temperature", 0.0)) == 0.0
        ids = np.asarray(st.feats["input_ids"], np.int32)[: int(st.feats["length"])]
        new_len = int(ids.size) + len(st.tokens)
        if (greedy and self.engine.bundle.supports_prefix and st.skip == 0
                and new_len <= self.max_prompt):
            st.feats = dict(st.feats, input_ids=np.concatenate(
                [ids, np.asarray(st.tokens, np.int32)]), length=np.int32(new_len))
            st.budget = remaining
            st.tokens = []  # folded into the prompt
            self.recasts += 1
        else:
            st.skip = len(st.tokens)
            self.replays += 1
        st.produced = 0
        if st.blocks is not None:
            st.blocks.release()
        # A checkpointed stream holds no blocks and no reservation.
        st.blocks = None
        st.s_base = 0
        return True

    def _requeue_preempted(self, st: _Stream) -> None:
        """Checkpoint one stream and queue it again, its footprint
        re-estimated off its new prompt (a recast grew it)."""
        if not self._checkpoint_for_resume(st):
            self._finish(st)
            return
        st.kv = self.admission.kv_bytes_for_resume(st.feats)
        st.t_queued = time.monotonic()
        self.queue.put(st, force=True)

    def _emit_tokens(self, st: _Stream, chunk: np.ndarray) -> None:
        """Send one chunk's tokens to a stream: skip what a replay already
        delivered, never pass its budget, and record them for a later
        checkpoint."""
        arr = np.asarray(chunk)
        if st.skip:
            k = min(st.skip, int(arr.size))
            st.skip -= k
            arr = arr[k:]
        arr = arr[: max(0, st.budget - len(st.tokens))]
        if not arr.size:
            return
        st.tokens.extend(int(t) for t in arr.tolist())
        st.emit(arr)
        metrics.TOKENS.labels(self.model).inc(int(arr.size))
        now = time.monotonic()
        if st.t_emit:
            metrics.TBT.labels(self.model).observe(now - st.t_emit)
        st.t_emit = now

    # -- admission -----------------------------------------------------

    def _admit_dispatch(self, wave: list[_Stream]) -> list:
        """Prefill the wave as one batch, with its first decode chunk, and
        start the host copy of that chunk's tokens and done flags (the
        caller holds the engine's lock)."""
        eng = self.engine
        ok: list[_Stream] = []
        for st in wave:
            if st.cancelled.is_set():
                self._release(st)
            elif int(st.feats.get("length", 0)) > self.max_prompt:
                self._finish(st, ValueError(
                    f"prompt longer than the largest seq bucket ({self.max_prompt}) "
                    "cannot join the shared batch"
                ))
            else:
                ok.append(st)
        if not ok:
            return []
        try:
            state1, toks, width = eng.start([st.feats for st in ok])
            copy = _HostCopy(toks, state1.done)
        except Exception as e:
            for st in ok:
                self._finish(st, e)
            return []
        self.prefill_dispatches += 1
        return [(st, state1, copy, row, width) for row, st in enumerate(ok)]

    def _admit_complete(self, started: list) -> None:
        """Route each admitted stream's first chunk, then copy its row into
        a free slot (or end it, when the first chunk finished it); the
        caller holds the engine's lock."""
        for st, state1, copy, row, width in started:
            toks_np, done_np = copy.get()
            st.produced = self.chunk
            self._emit_tokens(st, toks_np[row])
            if bool(done_np[row]) or st.produced >= st.budget:
                self._finish(st)
                continue
            slot = None
            try:
                if self._state is None or self._state_stale:
                    self._build_empty_state()
                slot = self.free.pop()
                if self.paged:
                    self._insert_paged(st, state1, slot, row, width)
                else:
                    self._insert(state1, slot, row)
            except OutOfBlocks:
                # Another reservation took the blocks since the stream left
                # the queue: its first chunk is delivered, so checkpoint it
                # and queue it again.
                if slot is not None:
                    self.free.append(slot)
                self._note_stall()
                self.admission.release(st)
                self._requeue_preempted(st)
                continue
            except Exception as e:
                if slot is not None:
                    self.free.append(slot)
                self._finish(st, e)
                continue
            self.active[slot] = st
            if float(st.feats.get("temperature", 0.0)) > 0.0:
                self.sampled_slots.add(slot)

    def _build_empty_state(self) -> None:
        """Every slot dead: zeroed caches (paged: ``num_blocks`` pool
        blocks plus the scratch block, int8 scale pools of ones) and
        per-row fields at the slot count, every row greedy.  Allocated
        once, and on the card the chunk's graphs (argmax and sampled)
        captured over it then, while no slot is live (the caller holds the
        engine's lock); later calls (a failed dispatch) reset the same
        tensors in place, which the graphs read and write."""
        eng = self.engine
        cfg = eng.bundle.cfg
        dev = eng.device
        dtype = eng.bundle.policy.compute_dtype
        n = self.n_slots
        st = self._state
        if st is not None:
            self._reset_state(st)
            return
        if eng.bundle.slot_state is not None:  # an encoder-decoder's own layout
            self._state = eng.bundle.slot_state(n, self.max_prompt, eng.max_decode_len)
            self._state_stale = False
            self._capture_chunks()
            return
        if self.paged:
            lead, width = (self.pool.num_blocks + 1, self.block_size), self.nb_max * self.block_size
        else:
            width = self.max_prompt + eng.max_decode_len
            lead = (n, width)
        shape = lead + (cfg.num_kv_heads, cfg.head_dim)
        scale_fill = 1 if self.paged else 0

        def entry():
            if cfg.kv_quant:
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.full(shape[:3] + (1,), scale_fill, dtype=dtype, device=dev))
            return torch.zeros(shape, dtype=dtype, device=dev)

        def per_row(dt):
            return torch.zeros(n, dtype=dt, device=dev)

        fields = dict(
            cache_k=[entry() for _ in range(cfg.num_layers)],
            cache_v=[entry() for _ in range(cfg.num_layers)],
            key_valid=torch.zeros(n, width, dtype=torch.int32, device=dev),
            write_idx=per_row(torch.long), pos=per_row(torch.long),
            last_token=per_row(torch.long),
            done=torch.ones(n, dtype=torch.bool, device=dev),
            tokens=torch.full((n, eng.max_decode_len), cfg.pad_id, dtype=torch.int32,
                              device=dev),
            sample=greedy_params(n, dev),
        )
        self._state = PagedState(**fields) if self.paged else GPTState(**fields, steps=None)
        self._state_stale = False
        if self.paged:
            self._table_dev = torch.tensor(self._table, device=dev)
            self.admission.note_pool()
        self._capture_chunks()

    def _capture_chunks(self) -> None:
        """On the card, capture the chunk's graphs (argmax and sampled) over
        the freshly allocated slot state, every slot dead."""
        if self.engine.graphs is not None:
            try:
                self.chunk_graph(False)
                self.chunk_graph(True)
            except BaseException:
                self._state = None  # the next admission allocates and captures anew
                raise

    def _reset_state(self, st) -> None:
        """Every slot dead again, in place (the graphs keep their
        addresses): caches zeroed (int8 scale pools of the paged layout
        ones), the other fields zeroed, rows done, tokens pad, greedy."""
        eng = self.engine
        scale_fill = 1 if self.paged else 0
        for entry in st.cache_k + st.cache_v:
            if isinstance(entry, tuple):
                entry[0].zero_()
                entry[1].fill_(scale_fill)
            else:
                entry.zero_()
        kept = ("cache_k", "cache_v", "done", "tokens", "sample")
        for f in dataclasses.fields(st):
            value = getattr(st, f.name)
            if f.name not in kept:
                for t in value if isinstance(value, list) else [value]:
                    if isinstance(t, torch.Tensor):
                        t.zero_()
        st.done.fill_(True)
        st.tokens.fill_(eng.bundle.cfg.pad_id)
        st.sample.copy_(greedy_params(self.n_slots, eng.device))
        self._state_stale = False

    def _insert_rows(self, single, slot: int, row: int) -> None:
        """The per-row fields of wave row ``row`` into slot ``slot``
        (widths padded with zeros)."""
        dst = self._state
        for name in ("key_valid", "tokens"):
            d, s = getattr(dst, name), getattr(single, name)
            d[slot, : s.shape[1]] = s[row]
            d[slot, s.shape[1]:] = 0
        for name in ("write_idx", "pos", "last_token", "done"):
            getattr(dst, name)[slot] = getattr(single, name)[row]
        for d, s in zip(dst.sample.fields(), single.sample.fields()):
            d[slot] = s[row]

    def _insert(self, single, slot: int, row: int) -> None:
        """Contiguous insert: every field of wave row ``row`` of the prefill
        state into slot ``slot``, any family's state (the reference's
        ``ins_row``): a field narrower than the slot's (a cache, an encoder-
        decoder's cross K/V and encoder mask at the wave's width) zero-padded
        past its width."""
        for d, s in zip(state_tensors(self._state), state_tensors(single)):
            if d.dim() == 1:
                d[slot] = s[row]
                continue
            d[slot, : s.shape[1]] = s[row]
            d[slot, s.shape[1]:] = 0

    def _insert_paged(self, st: _Stream, single: GPTState, slot: int, row: int,
                      width: int) -> None:
        """Paged insert: grant the stream the blocks its prompt and first
        chunk wrote (positions ``[0, width + chunk)``), point the slot's
        table row at them and scatter that span of the wave row's caches
        into them."""
        s_cut = width + self.chunk
        sb = StreamBlocks(self.pool, self.block_size)
        try:
            sb.ensure(s_cut)
            table_row = np.full(self.nb_max, self.pool.num_blocks, np.int32)
            table_row[: len(sb.ids)] = sb.ids
            row_t = torch.from_numpy(table_row)
            for d_entry, s_entry in zip(self._state.cache_k + self._state.cache_v,
                                        single.cache_k + single.cache_v):
                pairs = (zip(d_entry, s_entry) if isinstance(d_entry, tuple)
                         else [(d_entry, s_entry)])
                for pool, s in pairs:
                    scatter_pages(pool, row_t, s[row, :s_cut], self.block_size)
            self._insert_rows(single, slot, row)
        except BaseException:
            sb.release()
            raise
        st.blocks = sb
        st.s_base = width
        self._table[slot] = table_row
        self._dispatched_steps[slot] = self.chunk
        self.admission.note_pool()

    # -- decode chunks -------------------------------------------------

    def _work_remains(self) -> bool:
        """True while a live stream needs tokens beyond what the chunks in
        flight will deliver."""
        ahead = len(self._inflight) * self.chunk
        return any(st.produced + ahead < st.budget for st in self.active.values())

    def _grow_for_dispatch(self) -> None:
        """Grant every live row the blocks the next chunk writes (never
        past its budget: later writes go to the scratch block and are
        never read).  A row whose growth finds the pool dry is checkpointed
        and queued again (it resumes token-identically when blocks free up);
        admission's worst-case bound lets a stream alone always fit."""
        grew = False
        for slot, st in list(self.active.items()):
            if st.cancelled.is_set() or st.blocks is None:
                continue  # frees at the next delivery; its writes go to scratch
            steps = self._dispatched_steps.get(slot, 0) + self.chunk
            try:
                fresh = st.blocks.ensure(st.s_base + min(steps, st.budget))
            except OutOfBlocks:
                self._note_stall()
                self._vacate(slot, st)
                continue
            if fresh:
                self._table[slot, : len(st.blocks.ids)] = st.blocks.ids
                grew = True
            self._dispatched_steps[slot] = steps
        if grew:
            self.admission.note_pool()

    def _chunk_call(self, sample: bool = False):
        """One decode chunk over the whole slot state (caller holds the
        engine's lock; ``sample``: the sampled variant): the block table
        copied to its device buffer, then the chunk's graph replayed (on
        the CPU: the chunk run); returns (state, tokens [n_slots, chunk])."""
        eng = self.engine
        if self.paged:
            self._table_dev.copy_(torch.from_numpy(self._table), non_blocking=True)
        if eng.graphs is None:
            if self.paged:
                return eng.bundle.paged_chunk(self._state, self._table_dev, self.chunk, sample)
            return eng.bundle.generate_chunk(self._state, self.chunk, sample)
        entry = self.chunk_graph(sample)
        entry.replay()
        return self._state, entry.outputs

    def chunk_graph(self, sample: bool = False) -> compile_cache.GraphEntry:
        """The graph of one chunk over this loop's slot state, argmax or
        ``sample`` (captured on the first call): its descriptor holds the
        slot state's token, so no other loop's state aliases it."""
        eng = self.engine
        cfg = eng.bundle.cfg
        kind = "loop_chunk_paged" if self.paged else "loop_chunk"
        shape = ((self.pool.num_blocks, self.block_size, self.nb_max) if self.paged
                 else (self.max_prompt + eng.max_decode_len,))
        descriptor = (self.n_slots, *shape, self.chunk, "sample" if sample else "greedy",
                      str(eng.bundle.policy.compute_dtype).split(".")[-1],
                      "int8" if cfg.kv_quant else "none",
                      compile_cache.fingerprint(self))
        return eng.graphs.get(eng.bundle, kind, descriptor, eng.placement_key,
                              lambda: self._make_chunk(sample))

    def _make_chunk(self, sample: bool):
        if self.active:
            raise RuntimeError(f"{self.model}: the loop chunk's capture would advance "
                               f"{len(self.active)} live streams")
        eng, state, table = self.engine, self._state, self._table_dev
        if self.paged:
            def chunk():
                return eng.bundle.paged_chunk(state, table, self.chunk, sample)[1]
        else:
            def chunk():
                return eng.bundle.generate_chunk(state, self.chunk, sample)[1]
        return chunk, (state, table), eng.device

    def _dispatch_chunk(self) -> None:
        with tracing.span("decode_chunk", cat="engine", n_streams=len(self.active),
                          streams=[st.rid for st in self.active.values()], paged=self.paged):
            if self.paged:
                self._grow_for_dispatch()
            with self.engine._lock:
                self._state, toks = self._chunk_call(bool(self.sampled_slots))
                copy = _HostCopy(toks, self._state.done)
        self.chunk_dispatches += 1
        self.decode_steps += self.chunk
        metrics.STREAM_BATCH.labels(self.model).observe(len(self.active))
        self._inflight.append((copy, dict(self.active)))

    def _deliver_oldest(self) -> None:
        copy, snapshot = self._inflight.pop(0)
        toks_np, done_np = copy.get()
        self._route_chunk(toks_np, done_np, snapshot)

    def _route_chunk(self, toks_np: np.ndarray, done_np: np.ndarray,
                     snapshot: dict[int, _Stream]) -> None:
        for slot, st in snapshot.items():
            # The slot may have been freed, or re-tenanted, since the chunk
            # was dispatched: never emit stale rows.
            if self.active.get(slot) is not st:
                continue
            if st.cancelled.is_set():
                self._free_slot(slot)
                continue
            self._emit_tokens(st, toks_np[slot])
            st.produced += self.chunk
            if bool(done_np[slot]) or st.produced >= st.budget:
                st.emit(_END)
                self._free_slot(slot)
