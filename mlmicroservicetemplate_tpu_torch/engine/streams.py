"""Continuous batching for streaming generation.

Counterpart of the JAX package's ``engine/streams.py``
(``ContinuousDecodeLoop``).  One loop thread owns
a batched decode state of ``MAX_STREAMS`` rows ("slots").  At every chunk
boundary it admits the waiting streams as one wave (one prefill plus the
first decode chunk for the whole wave, ``InferenceEngine.start``), copies
each wave row into a free slot, dispatches one batched decode chunk for
every live slot and routes each row's tokens to its stream; a stream that
hits EOS or its budget frees its slot.  Up to ``chain_depth`` chunks stay
in flight: chunk N+D is dispatched before chunk N's tokens and ``done``
flags are read to the host (see "Dispatch pipeline" below).

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

Prefix cache (``PREFIX_CACHE=1``; ``engine/prefix_cache.py``), as in the
reference: each admitted stream is matched once.  Hits group by (prefix
bucket, suffix bucket), one prefixed start per group (B = 1 for a solo
hit, else the slot count's bucket, pad rows behind the first member's
prefix), and misses share one full wave.  Contiguous, every row donates
its longest bucket prefix (a clone of its rows, taken at dispatch; a hit
only when the prompt now covers a longer bucket).  Paged, an entry is a
pin on the donor's prompt blocks (``_donate_paged``, after the insert); a
hit takes one ref on each at match (``StreamBlocks.adopt``, so a pin
evicted before the stream's insert cannot free them), prefills its suffix
over a dense gather of them from the pools (``_gather_prefix``), and its
insert scatters only positions ``[s_lo, s_cut)``: the shared rows below
its prefix length are never rewritten, and K3 reads them through several
table rows.  A growth or insert that finds the pool dry evicts LRU pins
before it checkpoints a stream (``_reclaim_then_ensure``), and a rebuilt
slot state flushes every pin.  A recast resume re-enters admission with
prompt and delivered tokens, so it hits the prefix its first admission
donated.  Each group's start graph is replayed and its rows copied into
their slots before the next group's replay, since a graph's outputs last
only until another graph of the pool replays.  The loop counts
``prefix_hit_waves`` (grouped hit starts), ``recast_hits``, the most
blocks shared at once (``peak_shared_blocks``) and the most blocks two or
more live rows of one dispatched chunk's tables name
(``peak_shared_in_chunk``).

Chunked prefill (``PREFILL_CHUNK``), as in the reference: a prompt longer
than one window or than the largest seq bucket does not join a wave; it
becomes a job (``_PrefillJob``) whose windows of ``PREFILL_CHUNK`` tokens
dispatch after each iteration's decode chunk (``_advance_prefill``), so a
long prompt delays the live streams by at most ``PREFILL_BUDGET`` tokens
of window compute a chunk boundary (unbounded when nothing decodes).  The
jobs go by class, deadline and arrival, and ``PrefillPacer`` holds
batch-class windows while interactive streams decode (one every
``CLASS_WEIGHT`` boundaries gets through).  The knob lifts the loop's
prompt ceiling to ``PREFILL_MAX_PROMPT``, else the position budget: the
contiguous slots and the paged tables widen to it (the pool stays sized
off the largest bucket).  Contiguous, a job fills a detached state of the
slot width (a prefix hit's rows seeded into it first) and its handoff is
the usual slot insert; paged, its windows write straight into the pools
through its own table row, which grows a window at a time (a hit adopts
the donor's blocks first), and its handoff writes the slot's row fields
only.  The row goes live at ``write_idx = L - 1`` and step 0, so the next
chunk re-embeds the last prompt token as ``init_decode_state`` arranges,
and its tokens are the monolithic path's.  A job whose window finds the
pool dry (after the pins are reclaimed) is checkpointed: it holds no block
while it waits and reserves its first window again.  A job whose deadline
passes before its first token sheds with 504.  On the card each window
replays one graph of its width (``prefill_window``, over a detached state
of its own that a job's state is copied into and out of, or
``prefill_window_paged``, over the loop's pools and a static table row),
captured with the loop's chunk while every slot is dead.

Host KV tier (``KV_HOST_BUDGET_MB``, paged only; ``kv_blocks.KVHostTier``
on the engine), as in the reference: a checkpoint (preemption, a dry
pool) copies the blocks behind its resume prompt to pinned host buffers
before it frees them (``_swap_out``: one ``index_select`` of the pool
leaves on the loop's CUDA stream, behind every chunk that wrote them, then
a device-to-host copy that lands at the next iteration top,
``_drain_swapouts``); its resume allocates those blocks up front and
copies them back ``KV_PREFETCH_BLOCKS`` a chunk boundary while streams
decode, as many for each resuming stream otherwise (``_advance_swapins``:
pinned staging, then ``index_copy_`` into the pools on the loop's stream,
so it lands after any chunk in flight that still names a fresh block),
then goes live by the chunked-prefill handoff, token-identically.  A job checkpointed
mid-prefill swaps out its consumed windows and resumes as a job at that
boundary (``_swapin_to_prefill``).  An evicted paged prefix pin is
demoted: the engine queues it with its refs (``_drain_demotions`` gathers
it, the refs free when it lands) and a later device miss promotes it back
(``_promote_host_prefix``).  The copies are eager and write the pools the
graphs captured in place.  A host copy that is missing, evicted or not
landed falls back to the recompute resume (``swap_fallbacks``); a dry pool
at swap-in requeues the stream with its entry intact.  A flush of pins
before a reset demotes nothing (``_flush_pins``).

Fused decode windows (``DECODE_WINDOW``, ``DECODE_WINDOW_AUTO``; gpt2 and
llama), as in the reference: ``DecodeWindowGovernor`` picks each
dispatch's depth W (1 while interactive streams are live or waiting,
under AUTO; else up to the cap and the chunks a live stream still needs,
a power of two), a paged dispatch grants the blocks of all W chunks up
front, and the W chunks go out with no host sync between them
(``models/window.py``; on the card the chunk's graph replayed W times,
each chunk's tokens and ``done`` flags copied into the window's buffers
before the next replay).  One fetch a window brings its tokens, the
``done`` history and the chunks it ran by the reference's rule; routing
replays the per-chunk routing over them.  The reference stops a window on
the device once every row is done; here the chunks past that point still
run, over an all-done batch whose tokens are pad, so what reaches the
streams is identical and the cost is their device time
(``time_windows``).  Chunked prefill's budget a
boundary scales by the last window.

Dispatch pipeline, as in the reference:
- depth (``STREAM_PIPELINE``): up to ``chain_depth`` dispatches stay in
  flight; once one more is out the oldest is fetched and routed, and an
  iteration that dispatched nothing drains the whole chain with one wait
  (one ``fetch`` boundary: on one CUDA stream the newest copy's event
  follows every older one).  Each dispatch's host copy is queued right
  after its own replay, before the next replay overwrites the graph's
  outputs.  0 (the default) tunes the depth at ``warm()``: k chained
  chunk replays and one fetch take RTT + k x compute, so ``wall(1)`` and
  ``wall(5)`` give both, the depth is RTT / compute clamped to [1, 8], and
  the idle-burst admission grace drops to min(``ADMIT_GRACE_MS``, RTT /
  10): on a directly attached card a lone request no longer waits 8 ms for
  a burst that never comes.
- ready delivery (paged): at the top of each iteration, dispatches whose
  host copy has landed (``_HostCopy.ready``, an event query, no sync; on
  the CPU always) are routed first, so rows that ended return their blocks
  before the growth pass, and no all-done window follows an early exit.
- staged host prep (``HOST_PREP_DOUBLE``, paged, on by default): right
  after a dispatch, the next one's growth pass runs and its block table is
  uploaded (``_stage_host_prep``); the next dispatch uses them only if the
  window, the tenants, the step cursors and the table are all unchanged,
  else the staged grants are rolled back and the prep runs again inline.
  The upload goes straight into the graph's table buffer: it is queued on
  the loop's CUDA stream after the chunk just dispatched, so no chunk in
  flight reads it, and only chunk graphs read that buffer.  Host tables
  go through pinned buffers, one reused only after its last copy's event.
- blocking admission (``ADMIT_OVERLAP=0``): a wave's prefill, fetch and
  insert all finish before the next chunk dispatch.
Each dispatch site's host seconds feed ``dispatch_host_seconds``.

Speculative decoding in the loop (``SPEC_CONTINUOUS``, contiguous slots
only, as in the reference): the slot state is a ``spec.SpecState`` (the
family's slot state as ``base``, and each slot's drafting history
``_hist_w`` wide; the cache ``_kv_w`` wide, T5's history wider by the
encoder ids), and each chunk is ``STREAM_CHUNK_TOKENS`` verify rounds of
every slot (``loop_spec_chunk`` on the card), whose rows emit 1 to
``SPEC_K + 1`` tokens a round, routed through ``spec.flatten_emitted`` and
trimmed to each stream's budget.  A wave still starts through the normal
``start`` (its first chunk through K2); ``_insert_spec`` recasts its row
through the family's ``init_spec`` and writes the slot's history row
``_hist_row`` built on the host from the prompt and that first chunk.

LoRA adapters (``ADAPTER_DIR``, as in the reference): a stream with an
``adapter_id`` takes a reference on its pool slot at submit (a pool whose
every slot serves a live stream sheds it, 503 ``adapter_pool``) and drops
it at its release, a checkpoint keeping it.  Every dispatch of the loop
then runs through the pool's overlay: a wave's start with each stream's
slot (the engine's ``lora`` start graphs), each chunk and window over
``_ad_rows`` (the slot holders' adapter slots, 0 for a free slot), each
prefill window over ``_ad_job_rows``.  Both are device buffers allocated
with the slot state, before its graphs are captured, and written by
device fills before a dispatch when a slot's adapter changed.

Faults and supervised recovery (``FAULT_SPEC``, ``DISPATCH_TIMEOUT_S``,
``SUPERVISE``; ``engine/faults.py``, ``engine/supervisor.py``): every
dispatch of the loop runs through ``engine.dispatch_guard`` at its site.
An iteration that raises goes to ``_recover``: under a supervisor with
budget left, every stream pending, mid-prefill, mid-prefetch or live is
checkpointed at the tokens it delivered and queued again, as a preempted
one is (``_checkpoint_requeue``; after a watchdog cut no KV swaps out,
``_swap_hold``), the slot state and the block table reset in place (the
graphs keep their addresses, so they stay valid) and the prefix cache
flushed (``engine.reset_device_state``); the streams then resume
token-identically.  A failed prefill parks the fault
(``_fault_pending``) for the next iteration top, its streams requeued
(``_fail_streams``).  Without a supervisor, with the budget spent or after
a CUDA error that poisoned the context, every stream ends with the error;
a spent or failed supervisor stops the loop.  The engine's flight
recorder dumps before the rebuild (and at an unrecoverable fault), so the
post-mortem shows the iterations that led to the fault.  The reference's
fleet failover is not ported.

Observability reads host state only: one flight-recorder frame per
non-idle iteration (``_record_iteration``: batch composition, slot
occupancy, queue depths, the pool's blocks), events at sheds,
preemptions, checkpoints, dry-pool stalls, swaps, prefix demotions and
promotions and window early exits (and the pacer's and the window
governor's decisions); the perf observatory's completions at the seams
where the host sees a dispatch's outputs land (``_deliver_ready`` /
``_deliver_oldest``, ``_deliver_all``, ``_admit_complete``); and, under
``SLO_*``, each TTFT and TBT sample into the SLO tracker.

The decode-kernel autotuner (``PALLAS_AUTOTUNE``, ``PALLAS_VARIANT``;
``ops/autotune.py``): ``warm`` resolves K3's split count at the paged
loop's shape before the slot state's graphs are captured
(``_autotune_kernel``), so they replay the winner's grid.

Durable serving (``JOURNAL_DIR``; ``runtime/durability.py``), at the
reference's places: ``submit_stream`` journals the admission record before
the stream can produce anything; ``_emit_tokens`` journals each chunk's
tokens before the consumer sees them; ``_journal_done`` writes the
terminal record exactly once, before the end reaches the consumer (at the
emit sites, and at ``_release`` for a stream that ends with no terminal
emission); a checkpoint leaves its cursor.  ``resume_stream`` readmits a
crashed process's stream off its journaled record and cursor through
``_checkpoint_for_resume`` (a recast for greedy decoder-only streams, a
replay with the seed pinned at admission for the rest).  The disk KV tier
(``KV_DISK_BUDGET_MB``, paged): attached to the pool leaves' layout when
the slot state is built; the host ledger's LRU victims spill to it, a
checkpoint's landed swap-out writes through keyed by request id, a resume
whose swap entry is on disk promotes it disk -> host (straight into the
host pool's buffers) before the host -> device prefetch, a prefix missing
from the host tier is looked up on disk, and a stream's end releases its
disk entry.  The per-stream path does not journal, as in the reference.

Not ported (``ROADMAP.md``): fleets.
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

from ..models.gpt import GPTState, PagedState, copy_state, state_tensors
from ..models.sampling import greedy_params
from ..models.spec import SpecState, flatten_emitted
from ..models.window import decode_window
from ..ops import autotune
from ..ops.paged_attention import gather_pages, scatter_pages
from ..runtime import compile_cache
from ..scheduler.admission import AdmissionController
from ..scheduler.policy import (
    BATCH,
    INTERACTIVE,
    DeadlineExceededError,
    DeadlineQueue,
    DecodeWindowGovernor,
    PrefillPacer,
    QueueFullError,
    SLOTracker,
)
from ..tenancy.adapters import AdapterBusy
from ..utils import metrics, tracing
from .engine import bucket_for
from .faults import DispatchTimeoutError, is_context_poisoned, is_fatal_device
from .kv_blocks import OutOfBlocks, PagedPrefix, StreamBlocks, blocks_for

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
                 "preempted", "_removed", "blocks", "s_base", "s_lo", "rid", "t_emit", "t_in",
                 "t_queued", "swap", "adapter_slot", "parted", "done_journaled", "tenant")

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
        # A replay whose regenerated tokens parted from those delivered
        # (bf16 draws of another batch shape at a near tie): it resumes
        # from the delivered tokens instead (``_recast_parted``).
        self.parted = False
        # Paged KV: the stream's blocks (a prefix hit's adopted ones first),
        # where its prefill's rows end (prefix and collated width) and the
        # prefix length below which it writes nothing.
        self.blocks: StreamBlocks | None = None
        self.s_base = 0
        self.s_lo = 0
        # The host tier's copy of its resume KV (a ``SwapEntry``) while it
        # waits, checkpointed, or is prefetched back.
        self.swap = None
        # The LoRA pool slot it holds a reference on (0: the base model),
        # from submit to its release; a checkpoint keeps it.
        self.adapter_slot = 0
        # Its tenant ("" = anonymous): the fair share's key and the label of
        # its sheds and SLO notes.
        self.tenant = str(feats.get("tenant") or "")
        self.rid = str(feats.get("request_id") or "")
        self.t_emit = 0.0
        # The journal's terminal record: written once, before the consumer
        # can see the end (``_journal_done``).
        self.done_journaled = False

    def emit(self, item: Any) -> None:
        try:
            self.loop.call_soon_threadsafe(self.chunks.put_nowait, item)
        except RuntimeError:
            # Event loop closed: the consumer is gone.
            self.cancelled.set()


class _PrefillJob:
    """One stream mid-chunked-prefill: the prompt positions consumed so far
    and the KV carried between windows, a detached B=1 state (contiguous)
    or the stream's own blocks and table row (paged, where the windows
    write straight into the pools).  ``ready`` once the prompt is
    exhausted: the job then waits only for a free slot."""

    __slots__ = ("st", "ids", "L", "p_len", "consumed", "state", "sb", "table_row", "ready",
                 "t_in")

    def __init__(self, st: _Stream, ids: np.ndarray, length: int):
        self.st = st
        self.ids = ids
        self.L = length
        self.p_len = 0  # a prefix hit's seeded or adopted positions
        self.consumed = 0  # absolute positions prefilled so far
        self.state = None  # contiguous: the detached state
        self.sb: StreamBlocks | None = None  # paged: the blocks being grown
        self.table_row: np.ndarray | None = None  # paged: sentinel-padded
        self.ready = False
        self.t_in = time.monotonic()


class _SwapInJob:
    """A checkpointed stream whose resume KV comes back from the host tier:
    its device blocks, allocated up front and filled ``copied`` at a time
    (``_advance_swapins``).  ``resume_at`` is the positions the host copy
    covers: ``L`` for a whole resume prompt (the stream then goes live by
    the chunked-prefill handoff, whose fields it shares with
    ``_PrefillJob``), fewer for a job checkpointed mid-prefill, which
    becomes a prefill job again at that boundary."""

    __slots__ = ("st", "ids", "L", "p_len", "sb", "table_row", "copied", "ready", "state",
                 "t_in", "resume_at")

    def __init__(self, st: _Stream, ids: np.ndarray, length: int):
        self.st = st
        self.ids = ids
        self.L = length
        self.p_len = 0  # swapped blocks are the stream's own: no adopted prefix
        self.sb: StreamBlocks | None = None
        self.table_row: np.ndarray | None = None
        self.copied = 0
        self.ready = False
        self.state = None
        self.t_in = time.monotonic()
        self.resume_at = length


class _HostCopy:
    """Device-to-host copies started without waiting (pinned buffers and
    an event on the card; copies on the CPU).  ``get`` waits for them;
    ``ready`` asks without waiting."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def tensors(self) -> list[torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
        return self.host

    def get(self) -> list[np.ndarray]:
        return [h.numpy() for h in self.tensors()]


def _outputs(toks) -> tuple:
    """A chunk's outputs as a tuple: its tokens, or a spec chunk's (out,
    n_emit)."""
    return tuple(toks) if isinstance(toks, (tuple, list)) else (toks,)


def _dummy_prompt(state) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty ids and mask for recasting a state through ``init_spec`` when
    its history is not wanted: [B, 1], or an encoder-decoder's [B, S_enc],
    whose history is as much wider than its cache."""
    enc = getattr(state, "enc_mask", None)
    ids = torch.zeros((state.done.shape[0], 1 if enc is None else enc.shape[1]),
                      dtype=torch.int32, device=state.done.device)
    return ids, ids


class _Inflight:
    """A dispatched chunk or fused window not yet routed: the host copy of
    its (tokens, done) or (tokens, done history, chunks run), the slots'
    streams at dispatch, its depth ``w`` (1: one chunk) and, when the loop
    times windows, the CUDA events around its chunks."""

    __slots__ = ("copy", "snapshot", "w", "events")

    def __init__(self, copy: _HostCopy, snapshot: dict, w: int = 1, events=None):
        self.copy = copy
        self.snapshot = snapshot
        self.w = w
        self.events = events


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
        self.prefix_cache = getattr(engine, "prefix_cache", None)
        # SPEC_CONTINUOUS: verify rounds in the shared chunk.  Decoder-only
        # families draft from a history whose [0, P) is a global
        # PROMPT_PREFIX's (ids unknown: -1); an encoder-decoder's history
        # starts with the encoder ids.  The widths are set with the slot
        # state.
        self.spec = bool(getattr(cfg, "spec_continuous", False)
                         and getattr(engine, "spec_enabled", False))
        if getattr(cfg, "spec_continuous", False) and not self.spec:
            raise ValueError(
                "SPEC_CONTINUOUS needs SPEC_DECODE=ngram on a spec-capable family")
        self._p_len = engine.global_prefix_len() if self.spec else 0
        self._hist_w: int | None = None
        self._kv_w: int | None = None
        self.spec_rounds = 0
        # Chunked prefill (PREFILL_CHUNK): long prompts prefill as windows
        # between the decode chunks, and the prompt ceiling rises past the
        # largest bucket, to PREFILL_MAX_PROMPT or the position budget (the
        # slots and tables are sized for it below).
        self.prefill_chunk = int(getattr(engine, "prefill_chunk", 0) or 0)
        self._prefilling: list[_PrefillJob] = []
        self.prefill_chunk_dispatches = 0
        self.prefill_stall_s = 0.0
        self.prefill_checkpoints = 0
        self.prefill_budget = 0
        self._pacer: PrefillPacer | None = None
        # The engine's flight recorder (None on an engine without one): the
        # pacer's and the window governor's decisions land in it too.
        self._flight = getattr(engine, "flight", None)
        if self.prefill_chunk and self.spec:
            raise ValueError(
                "PREFILL_CHUNK does not compose with SPEC_CONTINUOUS "
                "(the spec slot insert rebuilds the drafting history "
                "from a monolithic collated prompt)")
        if self.paged and self.spec:
            raise ValueError("PAGED_KV does not compose with SPEC_CONTINUOUS yet")
        if self.prefill_chunk:
            cap = engine.bundle.cfg.max_position - engine.max_decode_len
            want = int(getattr(cfg, "prefill_max_prompt", 0) or 0) or cap
            self.max_prompt = max(self.max_prompt, min(want, cap))
            self.prefill_budget = int(getattr(cfg, "prefill_budget", 0) or 0) or self.prefill_chunk
            self._pacer = PrefillPacer(weight=int(getattr(cfg, "class_weight", 4)))
            self._pacer.recorder = self._flight
        if self.paged:
            self.block_size = engine.kv_block_size
            self.pool = engine.kv_pool
            # The table covers the prompt ceiling and the decode budget (the
            # pool is sized off the largest bucket by the engine).
            self.nb_max = blocks_for(self.max_prompt + engine.max_decode_len, self.block_size)
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
        # Dispatched chunks and windows not yet routed (``_Inflight``); the
        # snapshot of each keeps its late rows from reaching a slot's next
        # tenant.  Up to ``chain_depth`` stay in flight (STREAM_PIPELINE; 0
        # tunes it at warm(), see the module docstring).
        self._inflight: list[_Inflight] = []
        self.chain_depth = max(1, int(getattr(cfg, "stream_pipeline", 0) or 1))
        self._auto_depth = int(getattr(cfg, "stream_pipeline", 0) or 0) == 0
        # The tuned (RTT, compute) seconds, once warm() measured them.
        self.tuned: tuple[float, float] | None = None
        metrics.CHAIN_DEPTH.labels(self.model).set(self.chain_depth)
        # Staged host prep (HOST_PREP_DOUBLE, paged): the next dispatch's
        # plan, and how many were staged, used as staged, rolled back.
        self.host_prep_double = bool(getattr(cfg, "host_prep_double", True))
        self._staged_prep: dict | None = None
        self.prep_staged = 0
        self.prep_hits = 0
        self.prep_misses = 0
        # Pinned host copies of the block table on their way to the card
        # ([tensor, event of its last copy]), used in turn.
        self._table_host: list[list] = []
        self._table_turn = 0
        # ADMIT_OVERLAP=0: a wave's admission completes before the next
        # chunk dispatch.
        self.overlap_admission = bool(getattr(cfg, "admit_overlap", True))
        # Fused decode windows (DECODE_WINDOW): the governor picks each
        # dispatch's depth; the decoder-only families serve one (an
        # encoder-decoder's loop has a slot state of its own).
        self.decode_window = max(1, int(getattr(cfg, "decode_window", 1) or 1))
        bundle = engine.bundle
        if self.decode_window > 1 and self.spec:
            raise ValueError(
                "DECODE_WINDOW>1 does not compose with SPEC_CONTINUOUS "
                "(spec rounds are their own fused dispatch shape)")
        if self.decode_window > 1 and bundle.slot_state is not None:
            raise ValueError(
                f"DECODE_WINDOW={self.decode_window} needs a window-capable family "
                f"(gpt2/llama); {bundle.name} decodes one chunk per dispatch")
        self._window_gov = DecodeWindowGovernor(
            self.decode_window, bool(getattr(cfg, "decode_window_auto", True)))
        self._window_gov.recorder = self._flight
        # SLO burn rates per class (SLO_*); None when every objective is 0.
        self.slo = SLOTracker.from_cfg(self.model, cfg)
        # Window counts (/status.decode): dispatches of more than one chunk,
        # chunks they ran, those that stopped early, the last depth picked;
        # tokens sent to streams.
        self.window_dispatches = 0
        self.window_chunks = 0
        self.window_early_exits = 0
        self.last_window = 1
        self.tokens_emitted = 0
        # With ``time_windows`` (off; a measurement turns it on, on the
        # card), CUDA events around each window's chunks: the device ms its
        # chunks past ``n_chunks`` took, summed, and how many there were.
        self.time_windows = False
        self.window_tail_ms = 0.0
        self.window_tail_chunks = 0
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
        # Replays whose regenerated tokens parted from those delivered
        # (each then resumed as a recast, ``_recast_parted``).
        self.replays_parted = 0
        # The prefix cache's admissions (see the module docstring).
        self.prefix_hit_waves = 0
        self.recast_hits = 0
        self.peak_shared_blocks = 0
        self.peak_shared_in_chunk = 0
        # The host KV tier (paged, KV_HOST_BUDGET_MB): streams whose resume
        # KV is coming back, swap-outs and demotions whose device-to-host
        # copy is in flight ((entry, gathered device rows, host copy, device
        # refs freed when it lands)), the blocks a boundary prefetches while
        # streams decode, and the counts.
        self._swapping: list[_SwapInJob] = []
        self._swap_pending: list = []
        self.swap_chunk_blocks = max(1, int(getattr(cfg, "kv_prefetch_blocks", 4) or 4))
        self.swap_outs = 0
        self.swap_ins = 0
        self.swap_fallbacks = 0
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.prefetch_blocks_total = 0
        self.prefetch_blocks_live = 0
        self.host_prefix_promotes = 0
        # The LoRA adapter pool (ADAPTER_DIR; the batcher sets it): every
        # dispatch of this loop then runs through its overlay, over the
        # per-slot adapter slots in ``_ad_rows`` (a prefill window's in
        # ``_ad_job_rows``): device buffers allocated with the slot state,
        # before its graphs are captured, and written before each dispatch.
        self.adapters = None
        # The tenant registry (TENANTS; the batcher sets it, with a fair
        # share on ``queue``): per-tenant sheds and SLO notes.
        self.tenants = None
        self._ad_rows: torch.Tensor | None = None
        self._ad_job_rows: torch.Tensor | None = None
        self._ad_rows_now: list[int] = []
        # Crash recovery: the batcher attaches the supervisor (SUPERVISE);
        # None ends every stream on a fault.  A fatal fault the prefill path
        # parked (its streams requeued) runs the recovery at the next
        # iteration top; after a watchdog cut no KV swaps out.
        self.supervisor = None
        self._fault_pending: BaseException | None = None
        self._swap_hold = False
        # K3's split variant resolved at warm-up ("" = the heuristic's).
        self.kernel_variant = ""

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
                self._shed(e.reason, st.tenant)
                raise
            cap = self.max_streams + self.max_stream_queue
            with self._admitted_lock:
                total = self._admitted + int(self.external_active())
                victim = self.queue.evict_for(st) if total >= cap else None
                if total < cap or victim is not None:
                    self._admitted += 1
            if total >= cap and victim is None:
                adm.release_lease(feats)
                self._shed("queue_full", st.tenant)
                raise QueueFullError(
                    f"{total} streams active >= max_streams={self.max_streams}"
                    f"+{self.max_stream_queue} queued",
                    retry_after_s=self._retry_after_s(),
                )
            if victim is not None:
                self._shed("queue_full", victim.tenant)
                self._finish(victim, QueueFullError("shed for higher-priority stream",
                                                    retry_after_s=self._retry_after_s()))
            if self.adapters is not None and feats.get("adapter_id"):
                # The stream's LoRA slot, pinned for its lifetime: after the
                # capacity checks (a shed must not churn the pool); a pool
                # whose every slot serves a live stream sheds it.
                try:
                    st.adapter_slot = self.adapters.acquire(str(feats["adapter_id"]))
                except AdapterBusy as e:
                    with self._admitted_lock:
                        self._admitted -= 1
                    adm.release_lease(feats)
                    self._shed("adapter_pool", st.tenant)
                    raise QueueFullError(str(e), reason="adapter_pool",
                                         retry_after_s=e.retry_after_s) from e
            # The write-ahead admission record, before the stream can
            # produce anything: a kill at any later point finds it.
            j = self._journal()
            if j is not None and st.rid:
                j.admit(st.rid, feats, st.klass, st.budget)
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

    def resume_stream(self, feats: dict, delivered: list[int]):
        """Readmit a crashed process's stream off its journaled admission
        record and delivered tokens, through the checkpoint machinery an
        in-process resume takes: a greedy decoder-only stream recasts
        (prompt + delivered prefilled), any other replays with the first
        ``len(delivered)`` tokens suppressed and the seed pinned at its
        admission.  Event-loop side; returns the iterator of the
        continuation's chunks (the journaled prefix is the reconnect
        route's to serve), or None when nothing is left to resume.  No
        deadline: the original one passed while the process was down."""
        st = _Stream(feats, asyncio.get_running_loop(), self.engine.budget_for(feats))
        st.klass, _deadline = self.admission.classify(feats)
        st.tokens = [int(t) for t in delivered]
        st.produced = len(st.tokens)
        j = self._journal()
        if j is not None and st.rid and st.rid not in j.streams:
            # A journal that never saw the rid: the continuation's cursor
            # records need a base to extend.
            j.admit(st.rid, feats, st.klass, st.budget)
            j.tokens(st.rid, st.tokens)
        if not self._checkpoint_for_resume(st):
            return None
        # The checkpoint's write-through copy on disk (a previous life's)
        # rides the admission as the swap entry: ``_start_swapin``
        # promotes it disk -> host -> device, any failure to the recompute
        # resume.
        d = getattr(self.engine, "kv_disk", None)
        if self.paged and d is not None and d.enabled and st.rid:
            entry = d.get(("stream", st.rid))
            if entry is not None and entry.alive and entry.tokens <= int(st.feats["length"]):
                st.swap = entry
        st.kv = self.admission.kv_bytes_for_resume(st.feats, swap_tokens=self._swap_tokens(st))
        aid = str(st.feats.get("adapter_id") or "")
        if aid and self.adapters is not None:
            st.adapter_slot = self.adapters.acquire(aid)
        with self._admitted_lock:
            self._admitted += 1
        if self._flight is not None:
            self._flight.event("resume_stream", rid=st.rid, klass=st.klass,
                               budget=st.budget, skip=st.skip)
        st.t_queued = time.monotonic()
        self.queue.put(st, force=True)
        self._ensure_thread()
        return self._consumer_gen(st)

    def _journal(self):
        """The process's write-ahead journal (``JOURNAL_DIR``), else None;
        read through the engine, whose rebuilds keep it."""
        return getattr(self.engine, "journal", None)

    def _disk_tier(self):
        """The disk KV tier once its payload files are attached to the
        pool leaves' layout (paged only), else None."""
        if not self.paged:
            return None
        d = getattr(self.engine, "kv_disk", None)
        if d is None or not d.enabled or d.pool.leaves is None:
            return None
        return d

    def _journal_done(self, st: _Stream) -> None:
        """The terminal record, exactly once, before the consumer can see
        the end: the other order loses the race a kill runs against it
        (the client saw the end, the journal still holds the stream
        incomplete, and the restart runs it again)."""
        if st.done_journaled:
            return
        j = self._journal()
        if j is not None and st.rid:
            j.done(st.rid)
        st.done_journaled = True

    def _shed(self, reason: str, tenant: str = "") -> None:
        metrics.SHED.labels(self.model, reason).inc()
        if self.tenants is not None and reason != "quota":
            # Attributed to the tenant too; a quota shed was at its gate.
            self.tenants.note_shed(tenant, reason)
        if self._flight is not None:
            self._flight.event("shed", reason=reason)

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
        capture land before the service reports ready (a window replays
        that graph); with ``STREAM_PIPELINE=0`` tune the depth and the
        admission grace over that chunk (``_tune_chain_depth``, paged
        ``_tune_chain_depth_paged``); then reset every slot to dead, so no
        warm chunk leaks into serving.  Returns the seconds taken.  A no-op
        once the loop thread runs."""
        with self._thread_lock:
            if self._thread is not None:
                return 0.0
            eng = self.engine
            with compile_cache.warm_phase(self.model, "loop") as phase, \
                    torch.inference_mode(), eng._lock:
                if self._state is None:
                    self._autotune_kernel()
                    self._build_empty_state()
                self._state, toks = self._chunk_call()
                _HostCopy(*_outputs(toks)).tensors()
                if self._auto_depth:
                    if self.paged:
                        self._tune_chain_depth_paged()
                    else:
                        self._tune_chain_depth()
                self._build_empty_state()
        return phase.seconds

    def _autotune_kernel(self) -> None:
        """K3's split count for this loop's decode shape, before the slot
        state's graphs are captured: a ``PALLAS_VARIANT`` pin checked
        against the table width and installed, else under
        ``PALLAS_AUTOTUNE`` the table's entry or a measured sweep
        (``ops/autotune.py``).  A no-op for the contiguous loop, off the
        card, or with neither knob set (``kernel_variant`` stays "")."""
        eng = self.engine
        cfg = eng.cfg
        pin = getattr(cfg, "pallas_variant", None) or None
        if not (self.paged and eng.device.type == "cuda"
                and (pin or getattr(cfg, "pallas_autotune", False))):
            return
        bcfg = eng.bundle.cfg
        kvh = int(getattr(bcfg, "num_kv_heads", bcfg.num_heads))
        self.kernel_variant = autotune.ensure_tuned(
            "paged_decode", b=self.n_slots, kvh=kvh, n_rep=int(bcfg.num_heads) // kvh,
            d=int(bcfg.head_dim), block_size=self.block_size, t=self.nb_max,
            dtype=str(eng.bundle.policy.compute_dtype).split(".")[-1],
            quant=bool(getattr(bcfg, "kv_quant", False)), device=eng.device, pin=pin,
            table_path=autotune.default_table_path(getattr(cfg, "pallas_tune_table", None)),
            iters=int(getattr(cfg, "pallas_autotune_iters", autotune.SWEEP_ITERS)))

    @staticmethod
    def depth_from(rtt_s: float, compute_s: float) -> int:
        """Chain depth from measured numbers: cadence ~ max(RTT / D, chunk
        compute), so D ~ RTT / compute closes the gap to the wire; clamped
        to [1, 8] (deeper chains only add fetch latency)."""
        return max(1, min(8, round(rtt_s / max(compute_s, 1e-4))))

    def _apply_tuned_depth(self, rtt: float, compute: float) -> None:
        """Set the depth from the measured numbers and cut the idle-burst
        grace to a tenth of the round trip: a lone request on a directly
        attached card does not wait out ``ADMIT_GRACE_MS`` for a burst that
        never comes."""
        self.tuned = (rtt, compute)
        self.chain_depth = self.depth_from(rtt, compute)
        metrics.CHAIN_DEPTH.labels(self.model).set(self.chain_depth)
        self.admit_grace_s = min(self.admit_grace_s, rtt / 10.0)
        log.info(
            "continuous loop: chunk compute %.1f ms, dispatch RTT %.1f ms "
            "-> chain depth %d, admit grace %.1f ms",
            compute * 1e3, rtt * 1e3, self.chain_depth, self.admit_grace_s * 1e3)

    def _tune_chain_depth(self) -> None:
        """Measure the dispatch round trip and the chunk's compute over the
        warm slot state (the caller holds the engine's lock): ``wall(k)`` is
        k chained chunks (on the card, replays of the loop's chunk graph,
        nothing captured anew) and one fetch (a device-to-host copy of the
        last chunk's tokens and a wait on it), RTT + k x compute; one
        ``wall(1)`` primes, then compute = (wall(5) - wall(1)) / 4 and RTT =
        wall(1) - compute."""
        def wall(k: int) -> float:
            t0 = time.perf_counter()
            for _ in range(k):
                self._state, toks = self._chunk_call(upload=False)
            _HostCopy(*_outputs(toks)).tensors()
            return time.perf_counter() - t0

        wall(1)
        w1 = wall(1)
        w5 = wall(5)
        compute = max((w5 - w1) / 4.0, 1e-4)
        rtt = max(w1 - compute, 0.0)
        self._apply_tuned_depth(rtt, compute)

    def _tune_chain_depth_paged(self) -> None:
        """The paged loop's tuning: the block table uploaded once, then
        every chunk of the measurement over it."""
        self._upload_table()
        self._tune_chain_depth()

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
                # A fatal fault the prefill path parked (its streams
                # requeued): the recovery runs now, with clean pending lists.
                if self._fault_pending is not None:
                    e, self._fault_pending = self._fault_pending, None
                    raise e
                # Streams whose deadline passed in the queue shed as 504s
                # before any admission work.
                self._expire_queued()
                # The host tier's copies of the last iteration land in its
                # buffers, and demoted pins gather out.
                self._drain_swapouts()
                self._drain_demotions()
                # Dispatches whose results have landed route now (paged):
                # rows that ended free their blocks before this iteration's
                # growth pass and open slots for the wave below.
                self._deliver_ready()
                self._recast_parted()
                if (not self.active and not self._inflight and not self._prefilling
                        and not self._swapping and self.queue.qsize() == 0):
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
                # Jobs mid-prefill or mid-prefetch count against the slots:
                # each needs one at its handoff.
                while (len(wave) + len(self.active) + len(self._prefilling)
                       + len(self._swapping) < self.n_slots):
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
                if wave and not self.overlap_admission:
                    # ADMIT_OVERLAP=0: the blocking order, the wave's
                    # prefill, fetch and insert before the next chunk.
                    self._pending_wave = wave
                    with self.engine._lock:
                        self._pending_admissions = self._admit_dispatch(wave)
                        self._pending_wave = []
                        if self._pending_admissions:
                            self._admit_complete(self._pending_admissions)
                            self._pending_admissions = []
                    wave = []
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
                # Prefetches and prefill windows queue behind the live chunk
                # on the device.
                advanced = self._advance_swapins()
                advanced = self._advance_prefill() or advanced
                # With the chunk just dispatched in flight, stage the next
                # dispatch's host prep.
                if dispatched:
                    self._stage_host_prep()
                # Up to chain_depth in flight: route the oldest once one
                # more is out, and drain the chain when nothing was
                # dispatched.
                if len(self._inflight) > self.chain_depth:
                    self._deliver_oldest()
                elif self._inflight and not dispatched:
                    self._deliver_all()
                elif not dispatched and not wave and not self.active and not advanced:
                    # Waiters whose reservation does not fit yet, nothing in
                    # flight: poll, do not spin.
                    time.sleep(0.01)
                self._record_iteration()
            except Exception as e:
                if self._recover(e):
                    continue
                log.exception("decode loop iteration failed")
                n_lost = self._fail_all(e)
                if n_lost:
                    metrics.STREAMS_LOST.labels(self.model, "0", "fault").inc(n_lost)
                # The budget is spent (or the context poisoned): the loop
                # stops, the shutdown below ends every queued consumer, and
                # /readyz stays unready.
                if self.supervisor is not None and self.supervisor.failed:
                    self._stop.set()
        closed = StreamClosedError("server stopping")
        self._staged_prep = None  # the slot frees below return every block
        self._drain_swapouts()
        if self.paged:
            # Demotions never gathered now: their refs return to the pool.
            self._free_demotions()
        self._fail_jobs(closed)
        for st in self.queue.drain_all():
            self._finish(st, closed)
        for slot in list(self.active):
            self._journal_done(self.active[slot])
            self.active[slot].emit(closed)
            self._free_slot(slot)
        self._inflight.clear()

    def _record_iteration(self) -> None:
        """One flight-recorder frame per non-idle iteration: batch
        composition, slot occupancy, queue depths and the pool's blocks,
        all host state."""
        fl = self._flight
        if fl is None or not fl.size:
            return
        if not (self.active or self._prefilling or self._swapping or self._inflight):
            return
        rec = dict(
            active=len(self.active),
            free_slots=len(self.free),
            queued=self.queue.qsize(),
            prefilling=len(self._prefilling),
            swapping=len(self._swapping),
            inflight_chunks=len(self._inflight),
            chunk_dispatches=self.chunk_dispatches,
            prefill_dispatches=self.prefill_dispatches,
            window=self.last_window,
            slots={str(slot): {"rid": st.rid, "klass": st.klass, "produced": st.produced,
                               "budget": st.budget}
                   for slot, st in self.active.items()},
        )
        if self.paged:
            rec["pool_free_blocks"] = self.pool.free_blocks
            rec["pool_used_blocks"] = self.pool.used_blocks
        fl.record_iteration(**rec)

    def _fail_all(self, exc: BaseException) -> int:
        """End every pending and live stream with ``exc``; the slot state
        is rebuilt at the next admission.  Returns how many ended."""
        n = len(self._pending_admissions) + len(self._pending_wave) + len(self.active)
        for st, *_ in self._pending_admissions:
            self._finish(st, exc)
        self._pending_admissions = []
        for st in self._pending_wave:
            self._finish(st, exc)
        self._pending_wave = []
        n += self._fail_jobs(exc)
        self._staged_prep = None  # the slot frees below return every block
        for slot in list(self.active):
            self._journal_done(self.active[slot])
            self.active[slot].emit(exc)
            self._free_slot(slot)
        self._inflight.clear()
        self._state_stale = True  # reset at the next admission
        if self.paged and self.prefix_cache is not None:
            self._flush_pins()  # the pins name blocks of the pools to be reset
        return n

    def _fail_jobs(self, exc: BaseException) -> int:
        """End every stream mid-prefill or mid-prefetch with ``exc``, its KV
        returned; returns how many."""
        jobs = self._prefilling + self._swapping
        for job in jobs:
            self._drop_job(job)
            self._finish(job.st, exc)
        self._prefilling = []
        self._swapping = []
        return len(jobs)

    # -- crash recovery ------------------------------------------------

    def _checkpoint_requeue(self, st: _Stream) -> bool:
        """Checkpoint one stream at its delivered tokens and queue it again
        for a token-identical resume; a finished or cancelled one just ends.
        Returns True when requeued."""
        self.admission.release(st)
        if st.cancelled.is_set() or st.budget - st.produced <= 0:
            self._finish(st)
            return False
        self._requeue_preempted(st)
        return True

    def _fail_streams(self, streams: list[_Stream], exc: Exception) -> None:
        """A failure on the prefill path of ``streams`` (in no slot yet).
        Under a supervisor a fatal device fault requeues them (nothing was
        delivered: the resume is a clean restart) and parks the fault for
        the recovery at the next iteration top; anything else ends just
        these streams, so one bad request never takes the loop down."""
        if self.supervisor is not None and is_fatal_device(exc):
            # A poisoned context resumes nothing: they end with the error,
            # and the recovery fails the supervisor.
            poisoned = is_context_poisoned(exc)
            for st in streams:
                if poisoned:
                    self._finish(st, exc)
                else:
                    self._checkpoint_requeue(st)
            self._fault_pending = exc
            return
        for st in streams:
            self._finish(st, exc)

    def _recover(self, exc: Exception) -> bool:
        """Supervised recovery on the loop thread: checkpoint every pending,
        mid-prefill, mid-prefetch and live stream at the tokens it
        delivered (``produced`` advances only at routing, so a chunk in
        flight belongs to no checkpoint), reset the device state in place
        and queue the checkpoints again.  False (the caller ends every
        stream) without a supervisor, with the budget spent, or after a CUDA
        error that poisoned the context, which fails the supervisor
        outright: no rebuild in this process can serve again.  The flight
        recorder dumps first either way (a spent budget's dump is the
        supervisor's), so the post-mortem shows what led here."""
        sup = self.supervisor
        fl = self._flight
        if sup is None:
            if fl is not None:
                fl.dump(f"unsupervised loop fault: {type(exc).__name__}: {exc}")
            return False
        if is_context_poisoned(exc):
            log.error("decode loop fault poisoned the CUDA context (%s: %s); "
                      "no in-process restart", type(exc).__name__, exc)
            if fl is not None and not sup.failed:
                fl.dump(f"CUDA context poisoned: {type(exc).__name__}: {exc}")
            sup.fail()
            return False
        if not sup.allow_restart():
            return False
        eng = self.engine
        # Dump before the rebuild changes what the rings describe.
        if fl is not None:
            fl.dump(f"fatal fault, supervised restart {sup.restarts}/{sup.max_restarts}: "
                    f"{type(exc).__name__}: {exc}")
        log.warning("decode loop fault (%s: %s); supervised engine restart %d/%d",
                    type(exc).__name__, exc, sup.restarts, sup.max_restarts)
        # After a watchdog cut the device may be wedged: no swap-out gather.
        self._swap_hold = isinstance(exc, DispatchTimeoutError)
        # Each checkpoint below returns its stream's whole block list,
        # staged grants included.
        self._staged_prep = None
        recovered = 0
        for st, *_ in self._pending_admissions:
            recovered += self._checkpoint_requeue(st)
        self._pending_admissions = []
        for st in self._pending_wave:
            recovered += self._checkpoint_requeue(st)
        self._pending_wave = []
        for job in self._prefilling:
            self._swap_out_job(job)  # its consumed windows, unless held
            self._drop_job(job)
            recovered += self._checkpoint_requeue(job.st)
        self._prefilling = []
        for job in self._swapping:
            # The host copy survives the rebuild: the resume prefetches again.
            self._drop_job(job)
            recovered += self._checkpoint_requeue(job.st)
        self._swapping = []
        for slot in list(self.active):
            st = self.active.pop(slot)
            recovered += self._checkpoint_requeue(st)
        self._swap_hold = False
        self.sampled_slots.clear()
        self.free = list(range(self.n_slots))
        self._inflight.clear()
        # The swap-outs gathered above land while this thread owns them.
        self._drain_swapouts()
        # The slot state resets in place at the next admission; the graphs
        # keep replaying the same addresses.
        self._state_stale = True
        if self.paged:
            self._table[:] = self.pool.num_blocks
            self._dispatched_steps.clear()
        eng.reset_device_state()
        self.admission.note_pool()
        metrics.ENGINE_RESTARTS.labels(self.model).inc()
        if recovered:
            metrics.STREAMS_RECOVERED.labels(self.model, "0", "restart").inc(recovered)
        log.info("engine rebuilt; %d stream checkpoint(s) requeued for token-identical "
                 "resume", recovered)
        return True

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
            self._shed("deadline", st.tenant)
            self._finish(st, DeadlineExceededError(
                "deadline passed while queued; stream shed before dispatch"))

    def _release(self, st: _Stream) -> None:
        """Exactly once per stream."""
        if not st.released:
            st.released = True
            # The terminal record (usually written at the emit site already)
            # for a stream that ends with no terminal emission (cancelled).
            self._journal_done(st)
            self._drop_swap(st, disk_too=True)  # nothing resumes it now
            self.admission.release(st)
            if st.adapter_slot and self.adapters is not None:
                # The LoRA pool's reference, dropped once, at the stream's
                # end (a preempted stream kept it across its checkpoint).
                self.adapters.release(st.adapter_slot)
                st.adapter_slot = 0
            dt = time.monotonic() - st.t_in
            tr = tracing.tracer()
            if tr is not None:
                # The stream's lifetime (submit to release), the interval its
                # queue-wait, prefill and decode spans tile.
                tr.add("stream", cat="sched", rid=st.rid, t0=st.t_in, dur=dt,
                       produced=st.produced, klass=st.klass, preempted=st.preempted)
            with self._admitted_lock:
                self._admitted -= 1
                self._stream_ewma_s = 0.8 * self._stream_ewma_s + 0.2 * dt

    def _finish(self, st: _Stream, item: Any = _END) -> None:
        """End a stream that holds no slot (blocks a prefix hit adopted at
        match go back)."""
        if st.blocks is not None:
            st.blocks.release()
            st.blocks = None
        self._journal_done(st)
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
            if self._flight is not None:
                self._flight.event("preempt", rid=st.rid, slot=slot)
            n += 1
        if n:
            # The vacated slots go to the interactive waiters, not back to
            # the batch class just preempted.
            self.queue.prefer_interactive()

    def _recast_parted(self) -> None:
        """Take every live replay that parted from its delivered tokens out
        of its slot; its checkpoint resumes from those tokens."""
        for slot, st in [(slot, st) for slot, st in self.active.items() if st.parted]:
            self._vacate(slot, st)

    def _vacate(self, slot: int, st: _Stream) -> None:
        """Take a live stream out of its slot, checkpoint it and queue it
        again.  Its row in a chunk still in flight is never routed (struck
        from the snapshot, since the stream may be admitted again, even to
        the same slot, before that chunk is routed), its blocks return to
        the pool and its table row points at the sentinel."""
        for entry in self._inflight:
            if entry.snapshot.get(slot) is st:
                del entry.snapshot[slot]
        self.active.pop(slot)
        self.sampled_slots.discard(slot)
        self.free.append(slot)
        self.admission.release(st)
        self._requeue_preempted(st)
        self._release_blocks(slot, st)

    def _note_stall(self, st: _Stream, site: str) -> None:
        """A paged insert, prefill window, prefetch or growth (``site``)
        found the pool dry for ``st``."""
        self.kv_growth_stalls += 1
        metrics.KV_GROWTH_STALLS.labels(self.model).inc()
        if self._flight is not None:
            self._flight.event("kv_growth_stall", rid=st.rid, site=site)

    def _checkpoint_for_resume(self, st: _Stream) -> bool:
        """Prepare one stream's token-identical resume off the tokens it
        delivered; False when nothing is left to resume (finished or
        cancelled).  Recast: a greedy causal decoder's remaining tokens
        continue prompt + delivered, so those become its prompt (when they
        fit the largest seq bucket).  Replay: everything else runs its whole
        generation again and suppresses the first ``skip`` tokens."""
        parted, st.parted = st.parted, False
        remaining = st.budget - (len(st.tokens) if parted else st.produced)
        if remaining <= 0 or st.cancelled.is_set():
            return False
        st.started = True
        st.preempted += 1
        # The checkpoint site's cursor: a crash between this checkpoint and
        # its resume replays to the same continuation point.
        j = self._journal()
        if j is not None and st.rid:
            j.checkpoint(st.rid)
        greedy = float(st.feats.get("temperature", 0.0)) == 0.0
        ids = np.asarray(st.feats["input_ids"], np.int32)[: int(st.feats["length"])]
        new_len = int(ids.size) + len(st.tokens)
        fits = self.engine.bundle.supports_prefix and new_len <= self.max_prompt
        if parted:
            # A parted replay resumes as a recast whatever it samples: the
            # delivered tokens join its prompt and its key chain moves past
            # the steps that drew them, so it draws what it would have.  Its
            # KV past the parting is the regenerated history's, so nothing
            # is swapped out.  One that cannot (T5, a prompt past the
            # largest bucket) ends with the tokens it delivered.
            if not fits:
                return False
            st.feats = dict(st.feats, input_ids=np.concatenate(
                [ids, np.asarray(st.tokens, np.int32)]), length=np.int32(new_len),
                rng_skip=int(st.feats.get("rng_skip", 0)) + len(st.tokens))
            st.budget, st.tokens, st.skip, st.produced = remaining, [], 0, 0
            self.recasts += 1
            self._drop_swap(st)
            if st.blocks is not None:
                st.blocks.release()
            st.blocks = None
            st.s_base = st.s_lo = 0
            return True
        if greedy and fits and st.skip == 0:
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
            # The feats now spell the resume prompt, whose KV is positions
            # [0, length) of these blocks: under the host tier they are
            # copied out before they free, and the resume prefetches them.
            if self.paged:
                self._swap_out(st)
            st.blocks.release()
        # A checkpointed stream holds no blocks and no reservation.
        st.blocks = None
        st.s_base = st.s_lo = 0
        return True

    def _requeue_preempted(self, st: _Stream) -> None:
        """Checkpoint one stream and queue it again, its footprint
        re-estimated off its new prompt (a recast grew it)."""
        if not self._checkpoint_for_resume(st):
            self._finish(st)
            return
        # A host-swapped checkpoint is charged the blocks its prefetch takes.
        st.kv = self.admission.kv_bytes_for_resume(st.feats, swap_tokens=self._swap_tokens(st))
        if self._flight is not None:
            self._flight.event("checkpoint_requeue", rid=st.rid, klass=st.klass,
                               budget=st.budget, skip=st.skip, preempted=st.preempted)
        st.t_queued = time.monotonic()
        self.queue.put(st, force=True)

    def _emit_tokens(self, st: _Stream, chunk: np.ndarray) -> None:
        """Send one chunk's tokens to a stream: skip what a replay already
        delivered, never pass its budget, and record them for a later
        checkpoint."""
        arr = np.asarray(chunk)
        if st.parted:
            return
        if st.skip:
            k = min(st.skip, int(arr.size))
            at = len(st.tokens) - st.skip
            if arr[:k].tolist() != st.tokens[at:at + k]:
                # The replay drew other tokens than it delivered: what it
                # generates now follows a history the consumer never saw.
                st.parted = True
                self.replays_parted += 1
                return
            st.skip -= k
            arr = arr[k:]
        arr = arr[: max(0, st.budget - len(st.tokens))]
        if not arr.size:
            return
        st.tokens.extend(int(t) for t in arr.tolist())
        # The write-ahead cursor: the journal learns of these tokens before
        # the consumer can, so after a kill it covers everything a client
        # received and the reconnect emits none twice.
        j = self._journal()
        if j is not None and st.rid:
            j.tokens(st.rid, arr)
        st.emit(arr)
        self.tokens_emitted += int(arr.size)
        metrics.TOKENS.labels(self.model).inc(int(arr.size))
        now = time.monotonic()
        if st.t_emit:
            gap = now - st.t_emit
            metrics.TBT.labels(self.model).observe(gap)
            if self.slo is not None:
                self.slo.note("tbt", st.klass, gap)
            if self.tenants is not None:
                self.tenants.note_latency(st.tenant, "tbt", st.klass, gap)
        else:
            ttft = now - st.t_in
            if self.slo is not None:
                self.slo.note("ttft", st.klass, ttft)
            if self.tenants is not None:
                self.tenants.note_latency(st.tenant, "ttft", st.klass, ttft)
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
            elif not (self.paged and st.swap is not None and self._start_swapin(st)):
                # (A host-swapped checkpoint resumes by prefetch; one whose
                # host copy is gone falls back to this recompute admission.)
                ok.append(st)
        if self.prefill_chunk:
            # A prompt longer than one window, or than the largest bucket,
            # becomes a job; shorter ones keep the wave (one fused start).
            rest = []
            for st in ok:
                if eng.chunked_prefill_applies(int(st.feats["length"])):
                    self._start_prefill_job(st)
                else:
                    rest.append(st)
            ok = rest
        if not ok:
            return []
        if self.prefix_cache is not None:
            self._admit_prefixed(ok)
            return []
        return self._start_wave(ok)

    def _start_wave(self, streams: list[_Stream]) -> list:
        """One ``start`` of whole prompts for ``streams``, collated as one
        batch; returns their admissions (a failed start ends them)."""
        try:
            state1, toks, width = self.engine.dispatch_guard(
                "prefill", lambda: self.engine.start([st.feats for st in streams],
                                                     self._wave_rows(streams)))
            copy = _HostCopy(toks, state1.done)
        except Exception as e:
            self._fail_streams(streams, e)
            return []
        self.prefill_dispatches += 1
        for st in streams:
            st.s_lo, st.s_base = 0, width
        return [(st, state1, copy, row) for row, st in enumerate(streams)]

    def _admit_prefixed(self, ok: list[_Stream]) -> None:
        """Admission through the prefix cache (the caller holds the
        engine's lock): match each stream once, start the misses as one
        wave and each (prefix, suffix) group of hits as one prefixed start,
        donate, and complete each start's admissions (first chunk, slot
        insert) before the next one replays."""
        eng, cache = self.engine, self.prefix_cache
        groups: dict[tuple[int, int], list] = {}
        misses: list[tuple[_Stream, np.ndarray, int]] = []
        for st in ok:
            length = int(st.feats["length"])
            row_ids = np.asarray(st.feats["input_ids"], np.int32)[:length]
            m = cache.match(row_ids, length, usable=eng._prefix_guard(length))
            if m is None and self.paged:
                # A pin demoted to the host tier comes back on a device miss.
                m = self._promote_host_prefix(row_ids, length, eng._prefix_guard(length))
            if m is not None and self.paged and (self._state is None or self._state_stale
                                                 or not isinstance(m[1], PagedPrefix)):
                m = None  # counted as a hit, as in the reference, but served as a miss
            if m is None:
                misses.append((st, row_ids, length))
                continue
            p_len, prefix = m
            if self.paged:
                # The stream's refs on the pin's blocks, taken now: an eviction
                # before its insert then frees only the pin's.
                st.blocks = StreamBlocks(self.pool, self.block_size)
                st.blocks.adopt(list(prefix.block_ids))
                prefix = self._gather_prefix(p_len, prefix.block_ids)
            if st.started and st.skip == 0:
                self.recast_hits += 1
            s_suf = bucket_for(max(length - p_len, 1), eng.seq_buckets, eng.seq_multiple)
            groups.setdefault((p_len, s_suf), []).append((st, row_ids, length, p_len, prefix))
        self._pending_wave = [g[0] for members in groups.values() for g in members]
        if misses:
            started = self._start_wave([st for st, _, _ in misses])
            self._complete(started, [(row_ids, length, None) for _, row_ids, length in misses])
        for (p_len, s_suf), members in groups.items():
            streams = [m[0] for m in members]
            self._pending_wave = [st for st in self._pending_wave if st not in streams]
            started = self._start_hits(p_len, members)
            self._complete(started, [(row_ids, length, p_len)
                                     for _, row_ids, length, _, _ in members])
        self._pending_wave = []

    def _start_hits(self, p_len: int, members: list) -> list:
        """One prefixed start of a (prefix, suffix) group's suffixes: B = 1
        for one member, else padded to the slot count's bucket (pad rows
        empty, behind the first member's prefix); returns the
        admissions."""
        eng = self.engine
        feats = [dict(st.feats, input_ids=row_ids[p_len:], length=np.int32(length - p_len))
                 for st, row_ids, length, _, _ in members]
        if len(feats) > 1:
            feats += [{"input_ids": np.zeros(0, np.int32), "length": np.int32(0)}] * (
                self.n_slots - len(feats))
        try:
            ids, mask, _ = eng._collate_text(feats)
            sp, sampled = eng._collate_sample(feats, ids.shape[0])
            prefixes = [m[4] for m in members]
            prefixes += [prefixes[0]] * (ids.shape[0] - len(prefixes) if len(prefixes) > 1
                                         else 0)
            rows = self._wave_rows([m[0] for m in members])
            state1, toks = eng.dispatch_guard(
                "prefill", lambda: eng._start_prefixed(prefixes, ids, mask, sp, sampled, rows))
            copy = _HostCopy(toks, state1.done)
        except Exception as e:
            self._fail_streams([st for st, *_ in members], e)
            return []
        self.prefill_dispatches += 1
        if len(members) > 1:
            self.prefix_hit_waves += 1
        for st, *_ in members:
            st.s_lo, st.s_base = p_len, p_len + ids.shape[1]
        return [(st, state1, copy, row) for row, (st, *_) in enumerate(members)]

    def _donate(self, state1, row: int, row_ids: np.ndarray, length: int,
                over: int | None) -> None:
        """Contiguous donation of one wave row's longest bucket prefix (a
        hit's only past its own prefix, ``over``); paged rows donate block
        pins after their insert (``_donate_paged``)."""
        cache = self.prefix_cache
        if self.paged:
            return
        p_ins = cache.bucket_for_insert(length)
        if (p_ins is not None and (over is None or p_ins > over)
                and not cache.contains(row_ids, p_ins)):
            cache.insert(row_ids, p_ins, self.engine._capture_prefix(state1, p_ins, row))

    def _complete(self, started: list, donors: list) -> None:
        """Donate each admitted row's prefix (``donors``: its ids, length
        and the prefix it hit, in ``started``'s order), then complete the
        admissions; the failure path ends them meanwhile."""
        self._pending_admissions = started
        for (_, state1, _, row), (row_ids, length, over) in zip(started, donors):
            self._donate(state1, row, row_ids, length, over)
        self._admit_complete(started)
        self._pending_admissions = []

    def _admit_complete(self, started: list) -> None:
        """Route each admitted stream's first chunk, then copy its row into
        a free slot (or end it, when the first chunk finished it); the
        caller holds the engine's lock."""
        copies = {id(copy): copy for _, _, copy, _ in started}  # a wave's rows share one
        try:
            got = self.engine.dispatch_guard(
                "fetch", lambda: {k: c.get() for k, c in copies.items()})
        except Exception as e:
            self._fail_streams([st for st, *_ in started], e)
            return
        # One prefill dispatch per distinct copy has landed.
        self._perf_complete("prefill", len(copies))
        for st, state1, copy, row in started:
            toks_np, done_np = got[id(copy)]
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
                    self._insert_paged(st, state1, slot, row)
                elif self.spec:
                    self._insert_spec(state1, slot, row, self._hist_row(st.feats, toks_np[row]))
                else:
                    self._insert(state1, slot, row)
            except OutOfBlocks:
                # Another reservation took the blocks since the stream left
                # the queue: its first chunk is delivered, so checkpoint it
                # and queue it again.
                if slot is not None:
                    self.free.append(slot)
                self._note_stall(st, "insert")
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
            if self.paged and self.prefix_cache is not None:
                self._donate_paged(st)

    # -- chunked prefill (PREFILL_CHUNK) ----------------------------------

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted but not yet prefilled (read from other
        threads as a snapshot)."""
        return sum(max(0, j.L - j.consumed) for j in list(self._prefilling))

    def _chunked_prefix_usable(self, length: int):
        """``usable(P)`` of a chunked prompt's prefix-cache match: prefix,
        prompt and decode fit the position table; paged, the prefix is
        whole blocks and leaves a token; contiguous, the prefix and the
        suffix's bucket fit the prompt ceiling."""
        eng = self.engine
        max_pos = int(eng.bundle.cfg.max_position)

        def usable(p_len: int) -> bool:
            if length + eng.max_decode_len > max_pos:
                return False
            if self.paged:
                return p_len % self.block_size == 0 and p_len < length
            s_suf = bucket_for(max(length - p_len, 1), eng.seq_buckets, eng.seq_multiple)
            return p_len + s_suf <= self.max_prompt

        return usable

    def _start_prefill_job(self, st: _Stream) -> None:
        """Make one chunked-prefill job and queue it for ``_advance_prefill``
        (the caller holds the engine's lock): match the prefix cache once (a
        paged hit adopts the donor's blocks, a contiguous one seeds its rows
        into the job's state) and set up the job's table row or its
        detached state."""
        eng = self.engine
        length = int(st.feats["length"])
        ids = np.asarray(st.feats["input_ids"], np.int32)[:length]
        # The TTFT's admission-mode label: the API reads it off the feats it
        # submitted.
        st.feats["prefill_mode"] = "chunked"
        self._pending_wave = [s for s in self._pending_wave if s is not st]
        job = _PrefillJob(st, ids, length)
        try:
            if self.paged and (self._state is None or self._state_stale):
                # The windows write into the pools (and a reset flushes the
                # pins of the pools it clears, before the match below).
                self._build_empty_state()
            p_len, prefix = 0, None
            if self.prefix_cache is not None:
                m = self.prefix_cache.match(ids, length,
                                            usable=self._chunked_prefix_usable(length))
                if m is None and self.paged:
                    m = self._promote_host_prefix(ids, length,
                                                  self._chunked_prefix_usable(length))
                if m is not None and (not self.paged or isinstance(m[1], PagedPrefix)):
                    p_len, prefix = m
                    if st.started and st.skip == 0:
                        self.recast_hits += 1
            job.p_len = job.consumed = p_len
            if self.paged:
                st.s_lo, st.s_base = p_len, length  # growth runs off the exact length
                job.sb = StreamBlocks(self.pool, self.block_size)
                if p_len:
                    job.sb.adopt(list(prefix.block_ids))
                job.table_row = np.full(self.nb_max, self.pool.num_blocks, np.int32)
                job.table_row[: len(job.sb.ids)] = job.sb.ids
            else:
                job.state = eng.bundle.empty_state(1, self.max_prompt, eng.max_decode_len)
                if p_len:
                    self._seed_prefix_state(job.state, prefix, p_len)
        except Exception as e:
            self._drop_job(job)
            self._fail_streams([st], e)
            return
        self._prefilling.append(job)

    @staticmethod
    def _seed_prefix_state(state, prefix: dict, p_len: int) -> None:
        """A contiguous prefix-cache hit's rows into positions ``[0, p_len)``
        of a job's fresh state, marked valid: the suffix then prefills in
        windows from ``p_len``."""
        for caches, entries in ((state.cache_k, prefix["k"]), (state.cache_v, prefix["v"])):
            for c, e in zip(caches, entries):
                for ci, ei in (zip(c, e) if isinstance(c, tuple) else [(c, e)]):
                    ci[:, :p_len] = ei.to(ci.dtype)
        state.key_valid[:, :p_len] = 1

    def _drop_job(self, job: _PrefillJob) -> None:
        """Return a job's KV: its blocks, or its detached state."""
        if job.sb is not None:
            job.sb.release()
            job.sb = None
            self.admission.note_pool()
        job.state = None

    def _checkpoint_job(self, job: _PrefillJob) -> None:
        """Checkpoint a job whose window found the pool dry: nothing was
        delivered, so its resume is a clean restart through admission; it
        holds no block while it waits and reserves its first window again,
        or, under the host tier, the blocks of the windows it consumed,
        which are copied out first and prefetched back at its resume."""
        self._swap_out_job(job)
        self._drop_job(job)
        self.prefill_checkpoints += 1
        self.admission.release(job.st)
        self._requeue_preempted(job.st)

    def _dispatch_prefill_window(self, job: _PrefillJob) -> None:
        """One window of ``job``: the prompt slice padded to the window,
        (paged) the table grown to cover it, the window dispatched.  Raises
        ``OutOfBlocks`` (the caller checkpoints the job) or the dispatch's
        own failure."""
        eng = self.engine
        c = self.prefill_chunk
        start = job.consumed
        end = min(start + c, job.L)
        with tracing.span("prefill_window", cat="engine", rid=job.st.rid, start=start, end=end,
                          total=job.L, paged=self.paged):
            ids = np.zeros((1, c), np.int32)
            mask = np.zeros((1, c), np.int32)
            ids[0, : end - start] = job.ids[start:end]
            mask[0, : end - start] = 1
            if self.paged:
                eng.fault_point("grow")
                self._reclaim_then_ensure(job.sb, end)
                job.table_row[: len(job.sb.ids)] = job.sb.ids
            with eng._lock:
                eng.dispatch_guard("prefill_chunk",
                                   lambda: self._window_call(job, ids, mask, start))
            if self.paged:
                self.admission.note_pool()
            job.consumed = end
            self.prefill_chunk_dispatches += 1
            metrics.PREFILL_CHUNKS.labels(self.model).inc()

    def _window_call(self, job: _PrefillJob, ids: np.ndarray, mask: np.ndarray,
                     start: int) -> None:
        """One window of ``job`` (the caller holds the engine's lock): run
        eagerly, or on the card its graph replayed over the window's static
        inputs, the job's state copied into the graph's detached state and
        back (contiguous) or its table row into the static row (paged)."""
        eng = self.engine
        dev = eng.device
        if self._ad_job_rows is not None:
            self._ad_job_rows.fill_(job.st.adapter_slot)
        if eng.graphs is None:
            args = (torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                    torch.tensor(start, device=dev))
            kw = self.engine._adapter_kw(self._ad_job_rows)
            if self.paged:
                eng.bundle.paged_prefill_chunk(self._state, torch.from_numpy(job.table_row).to(dev),
                                               *args, **kw)
            else:
                eng.bundle.prefill_chunk(job.state, *args, **kw)
            return
        entry = self.window_graph()
        s_ids, s_mask, s_start, target = entry.inputs
        s_ids.copy_(torch.from_numpy(ids), non_blocking=True)
        s_mask.copy_(torch.from_numpy(mask), non_blocking=True)
        s_start.fill_(start)
        if self.paged:
            target.copy_(torch.from_numpy(job.table_row), non_blocking=True)
            entry.replay()
            return
        copy_state(target, job.state)
        entry.replay()
        copy_state(job.state, target)

    def window_graph(self) -> compile_cache.GraphEntry:
        """The graph of one prefill window of this loop (captured on the
        first call): paged over its pools, contiguous over a detached state
        of the slot width, the graph's own."""
        eng = self.engine
        kind = "prefill_window_paged" if self.paged else "prefill_window"
        width = self.nb_max if self.paged else self._slot_width()
        descriptor = (self.prefill_chunk, width,
                      str(eng.bundle.policy.compute_dtype).split(".")[-1],
                      "int8" if eng.bundle.cfg.kv_quant else "none",
                      compile_cache.fingerprint(self))
        return eng.graphs.get(eng.bundle, kind, descriptor, eng.placement_key,
                              self._make_window)

    def _make_window(self):
        """Static window inputs (ids and mask [1, C], the 0-d start, and a
        sentinel table row [T] or a detached state) and the window over
        them.  A paged capture's eager run writes through a table of
        sentinels into the scratch block only."""
        eng = self.engine
        dev = eng.device
        c = self.prefill_chunk
        ids = torch.zeros((1, c), dtype=torch.int32, device=dev)
        mask = torch.zeros((1, c), dtype=torch.int32, device=dev)
        start = torch.zeros((), dtype=torch.long, device=dev)
        kw = self.engine._adapter_kw(self._ad_job_rows)
        if self.paged:
            state = self._state
            target = torch.full((self.nb_max,), self.pool.num_blocks, dtype=torch.int32,
                                device=dev)

            def window():
                eng.bundle.paged_prefill_chunk(state, target, ids, mask, start, **kw)
        else:
            target = eng.bundle.empty_state(1, self.max_prompt, eng.max_decode_len)

            def window():
                eng.bundle.prefill_chunk(target, ids, mask, start, **kw)
        return window, (ids, mask, start, target), dev

    def _handoff_job(self, job: _PrefillJob) -> bool:
        """The prompt is exhausted: put the stream live in a free slot.  The
        row starts at step 0 with ``write_idx = L - 1`` and the last prompt
        token as its last token (the next chunk's first step embeds it
        again, as ``init_decode_state`` arranges), sampling from its pinned
        seed's first draw.  Contiguous, the job's state goes in by the slot
        insert; paged, its KV is in its blocks already and only the row's
        fields are written.  Then the stream donates to the prefix cache as
        a wave row does.  Returns True when the stream went live."""
        st = job.st
        eng = self.engine
        if st.cancelled.is_set():
            self._drop_job(job)
            self._release(st)
            return False
        slot = None
        try:
            with eng._lock:
                if self._state is None or self._state_stale:
                    self._build_empty_state()
                slot = self.free.pop()
                eng.dispatch_guard("handoff", lambda: self._handoff_rows(job, slot))
        except Exception as e:
            if slot is not None:
                self.free.append(slot)
            self._drop_job(job)
            self._fail_streams([st], e)
            return False
        self.active[slot] = st
        if float(st.feats.get("temperature", 0.0)) > 0.0:
            self.sampled_slots.add(slot)
        if self.paged:
            self.admission.note_pool()
            if self.prefix_cache is not None:
                self.peak_shared_blocks = max(self.peak_shared_blocks,
                                              self.pool.stats()["shared"])
                self._donate_paged(st)
        elif self.prefix_cache is not None:
            with eng._lock:
                self._donate(job.state, 0, job.ids, job.L, job.p_len or None)
        self._drop_job(job)
        return True

    def _handoff_rows(self, job: _PrefillJob, slot: int) -> None:
        """The row fields of a job whose prompt is exhausted into ``slot``
        (paged: its blocks become the stream's; contiguous: its state goes in
        by the slot insert); the caller holds the engine's lock."""
        st, eng = job.st, self.engine
        sp, _ = eng._collate_sample([st.feats], 1)
        dev = eng.device
        fields = dict(
            write_idx=torch.full((1,), job.L - 1, dtype=torch.long, device=dev),
            pos=torch.zeros(1, dtype=torch.long, device=dev),
            last_token=torch.full((1,), int(job.ids[-1]), dtype=torch.long, device=dev),
            done=torch.zeros(1, dtype=torch.bool, device=dev), sample=sp.to(dev))
        if self.paged:
            key_valid = torch.zeros(1, self.nb_max * self.block_size, dtype=torch.int32,
                                    device=dev)
            key_valid[:, : job.L] = 1
            tokens = torch.full((1, eng.max_decode_len), eng.bundle.cfg.pad_id,
                                dtype=torch.int32, device=dev)
            self._insert_rows(GPTState(cache_k=[], cache_v=[], key_valid=key_valid,
                                       tokens=tokens, **fields), slot, 0)
            st.blocks, job.sb = job.sb, None
            self._table[slot] = job.table_row
            self._dispatched_steps[slot] = 0
        else:
            for name, value in fields.items():
                setattr(job.state, name, value)
            self._insert(job.state, slot, 0)

    def _advance_prefill(self) -> bool:
        """Dispatch prefill windows behind this iteration's decode chunk: the
        live streams wait for at most ``prefill_budget`` window tokens a
        chunk boundary, an idle loop backfills the whole backlog, and the
        pacer holds batch-class windows while interactive streams decode.
        Cancelled jobs drop first, a job past its deadline sheds (504),
        ready jobs take the free slots, and a job whose window finds the
        pool dry is checkpointed.  Returns True when a window dispatched or
        a job went live."""
        if not self.prefill_chunk:
            return False
        if not self._prefilling:
            metrics.PREFILL_BACKLOG.labels(self.model).set(0)
            return False
        advanced = False
        t0 = time.monotonic()
        live = bool(self.active)
        interactive_live = any(s.klass == INTERACTIVE and not s.cancelled.is_set()
                               for s in self.active.values())
        for job in list(self._prefilling):
            st = job.st
            if st.cancelled.is_set():
                self._prefilling.remove(job)
                self._drop_job(job)
                self._release(st)
            elif not st.started and st.deadline is not None and time.monotonic() > st.deadline:
                self._prefilling.remove(job)
                self._drop_job(job)
                self._shed("deadline", st.tenant)
                self._finish(st, DeadlineExceededError(
                    "deadline passed mid-prefill; stream shed before its first token"))
        for job in [j for j in self._prefilling if j.ready]:
            if not self.free:
                break
            self._prefilling.remove(job)
            advanced = self._handoff_job(job) or advanced
        # Window boundaries are up to last_window times rarer than chunk
        # boundaries: prefill keeps its share of the interleave.
        budget = self.prefill_budget * max(1, self.last_window) if live else 1 << 30
        jobs = sorted((j for j in self._prefilling if not j.ready),
                      key=lambda j: (j.st.klass != INTERACTIVE,
                                     j.st.deadline if j.st.deadline is not None
                                     else float("inf"), j.t_in))
        for job in jobs:
            if budget <= 0:
                break
            if live and not self._pacer.allow(job.st.klass, interactive_live):
                continue
            try:
                self._dispatch_prefill_window(job)
            except OutOfBlocks:
                self._note_stall(job.st, "prefill")
                self._prefilling.remove(job)
                self._checkpoint_job(job)
                continue
            except Exception as e:
                log.exception("prefill window failed")
                self._prefilling.remove(job)
                self._drop_job(job)
                self._fail_streams([job.st], e)
                if self._fault_pending is not None:
                    break  # the recovery takes every other job at the top
                continue
            advanced = True
            budget -= self.prefill_chunk
            if job.consumed >= job.L:
                job.ready = True
                if self.free:
                    self._prefilling.remove(job)
                    self._handoff_job(job)
        if live and advanced:
            # The host time this boundary spent on prefill while streams
            # were live (the windows run behind the chunk on the device, so
            # this bounds the stall, it does not equal it).
            dt = time.monotonic() - t0
            self.prefill_stall_s += dt
            metrics.PREFILL_STALL.labels(self.model).inc(dt)
        metrics.PREFILL_BACKLOG.labels(self.model).set(self.prefill_backlog_tokens())
        return advanced

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
        self._alloc_adapter_rows()
        if self.paged and self.prefix_cache is not None:
            # The pins name blocks of the pools being cleared.
            self._flush_pins()
        if st is not None:
            self._reset_state(st)
            return
        if eng.bundle.slot_state is not None:  # an encoder-decoder's own layout
            self._state = self._spec_slots(
                eng.bundle.slot_state(n, self.max_prompt, eng.max_decode_len))
            self._state_stale = False
            self._capture_chunks()
            return
        if self.paged:
            lead, width = (self.pool.num_blocks + 1, self.block_size), self.nb_max * self.block_size
        else:
            width = self._slot_width()
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
        self._state = (PagedState(**fields) if self.paged
                       else self._spec_slots(GPTState(**fields, steps=None)))
        self._state_stale = False
        if self.paged:
            self._table_dev = torch.tensor(self._table, device=dev)
            self.admission.note_pool()
            tier = self._host_tier()
            if tier is not None:
                # The host buffers, once the pool leaves' shapes are known.
                self._ensure_host_pool(tier)
                self._note_host_gauges()
                self._attach_disk_tier(tier)
        self._capture_chunks()

    def _spec_slots(self, base):
        """Under SPEC_CONTINUOUS the slot state as a ``SpecState``: the
        family's dead slots recast by its ``init_spec`` (T5 gains
        ``key_valid`` and ``write_idx``) and a history of -1 everywhere; sets
        ``_hist_w`` and ``_kv_w``.  Otherwise ``base`` itself."""
        if not self.spec:
            return base
        ss = self.engine.bundle.init_spec(base, *_dummy_prompt(base))
        ss.history.fill_(-1)
        self._hist_w = int(ss.history.shape[1])
        self._kv_w = int(ss.base.key_valid.shape[1])
        return ss

    def _hist_row(self, feats: dict, first_toks: np.ndarray) -> np.ndarray:
        """A slot's drafting-history row [``_hist_w``] built on the host from
        what it knows (the prompt and the first chunk's tokens), at the
        slot's layout: ``hist[hoff + p]`` is the token embedded at cache
        position ``p``, -1 where none lives.  An encoder-decoder's row holds
        the encoder ids, then its start token at ``hoff``, then the first
        chunk (clamped when that chunk fills the budget: the last budget
        token is never embedded); a decoder-only row holds the prompt at
        ``[P, P + L)`` behind a global prefix's ``P`` unknown ids, then the
        first chunk."""
        hw, kw = self._hist_w, self._kv_w
        hoff = hw - kw
        n = int(feats["length"])
        ids = np.asarray(feats["input_ids"], np.int64)[:n]
        row = np.full(hw, -1, np.int64)
        chunk = np.asarray(first_toks, np.int64)
        if hoff > 0:
            row[:n] = ids
            row[hoff] = int(getattr(self.engine.bundle.cfg, "decoder_start_id", 0))
            room = hw - (hoff + 1)
            row[hoff + 1: hoff + 1 + min(chunk.size, room)] = chunk[:room]
        else:
            base = self._p_len + n
            row[self._p_len:base] = ids
            room = hw - base
            row[base: base + min(chunk.size, room)] = chunk[:room]
        return row

    def _insert_spec(self, single, slot: int, row: int, hist_row: np.ndarray) -> None:
        """SPEC_CONTINUOUS insert: wave row ``row`` recast by the family's
        ``init_spec`` (its device history is dropped: per-bucket widths and
        T5's offset do not pad to the slot's layout) into slot ``slot``
        (``_insert``'s zero padding), and the slot's history row."""
        recast = self.engine.bundle.init_spec(single, *_dummy_prompt(single)).base
        self._insert_into(self._state.base, recast, slot, row)
        self._state.history[slot].copy_(torch.from_numpy(hist_row))

    # -- LoRA adapters (ADAPTER_DIR) ----------------------------------------

    def _wave_rows(self, streams) -> list[int] | None:
        """Each stream's adapter slot for a start through the overlay, or
        None without a pool (the base start)."""
        if self.adapters is None:
            return None
        return [st.adapter_slot for st in streams]

    def _alloc_adapter_rows(self) -> None:
        """The per-slot and the window's adapter-slot buffers, once, outside
        any graph pool (a capture reads their addresses)."""
        if self.adapters is not None and self._ad_rows is None:
            dev = self.engine.device
            self._ad_rows = torch.zeros(self.n_slots, dtype=torch.long, device=dev)
            self._ad_job_rows = torch.zeros(1, dtype=torch.long, device=dev)
            self._ad_rows_now = [0] * self.n_slots

    def _write_slot_rows(self) -> None:
        """Each slot's adapter slot into ``_ad_rows`` before a dispatch (the
        caller holds the engine's lock): its live stream's, 0 for a free
        slot, as the reference's ``_slot_rows``.  Only changed slots are
        written, each by a device fill queued behind the dispatches in
        flight, so no host copy waits on them."""
        if self._ad_rows is None:
            return
        for slot in range(self.n_slots):
            st = self.active.get(slot)
            v = st.adapter_slot if st is not None else 0
            if v != self._ad_rows_now[slot]:
                self._ad_rows[slot].fill_(v)
                self._ad_rows_now[slot] = v

    def _slot_width(self) -> int:
        """A contiguous slot's positions: a global PROMPT_PREFIX's, the
        largest seq bucket's and the decode budget's."""
        eng = self.engine
        return eng.global_prefix_len() + self.max_prompt + eng.max_decode_len

    def _capture_chunks(self) -> None:
        """On the card, capture the chunk's graphs (argmax and sampled) and
        the prefill window's over the freshly allocated slot state, every
        slot dead."""
        if self.engine.graphs is not None:
            try:
                self.chunk_graph(False)
                self.chunk_graph(True)
                if self.prefill_chunk:
                    self.window_graph()
            except BaseException:
                self._state = None  # the next admission allocates and captures anew
                raise

    def _reset_state(self, st) -> None:
        """Every slot dead again, in place (the graphs keep their
        addresses): caches zeroed (int8 scale pools of the paged layout
        ones), the other fields zeroed, rows done, tokens pad, greedy; a
        spec slot state's histories -1."""
        eng = self.engine
        if isinstance(st, SpecState):
            st.history.fill_(-1)
            self._reset_state(st.base)
            return
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
        self._insert_into(self._state, single, slot, row)

    @staticmethod
    def _insert_into(dst, single, slot: int, row: int) -> None:
        for d, s in zip(state_tensors(dst), state_tensors(single)):
            if d.dim() == 1:
                d[slot] = s[row]
                continue
            d[slot, : s.shape[1]] = s[row]
            d[slot, s.shape[1]:] = 0

    def _insert_paged(self, st: _Stream, single: GPTState, slot: int, row: int) -> None:
        """Paged insert: grant the stream the blocks its prompt and first
        chunk wrote (positions ``[0, s_base + chunk)``; a prefix hit's first
        ``s_lo`` positions are its adopted blocks), evicting prefix pins if
        the pool is dry, point the slot's table row at them and scatter
        positions ``[s_lo, s_base + chunk)`` of the wave row's caches into
        them (shared prefix rows are never written again)."""
        s_cut = st.s_base + self.chunk
        sb = st.blocks if st.blocks is not None else StreamBlocks(self.pool, self.block_size)
        try:
            self.engine.fault_point("grow")
            self._reclaim_then_ensure(sb, s_cut)
            table_row = np.full(self.nb_max, self.pool.num_blocks, np.int32)
            table_row[: len(sb.ids)] = sb.ids
            row_t = torch.from_numpy(table_row)
            for d_entry, s_entry in zip(self._state.cache_k + self._state.cache_v,
                                        single.cache_k + single.cache_v):
                pairs = (zip(d_entry, s_entry) if isinstance(d_entry, tuple)
                         else [(d_entry, s_entry)])
                for pool, s in pairs:
                    scatter_pages(pool, row_t, s[row, st.s_lo:s_cut], self.block_size,
                                  start=st.s_lo)
            self._insert_rows(single, slot, row)
        except BaseException:
            sb.release()
            st.blocks = None
            raise
        st.blocks = sb
        self._table[slot] = table_row
        self._dispatched_steps[slot] = self.chunk
        if self.prefix_cache is not None:
            self.peak_shared_blocks = max(self.peak_shared_blocks, self.pool.stats()["shared"])
        self.admission.note_pool()

    def _reclaim_then_ensure(self, sb: StreamBlocks, n_tokens: int) -> list[int]:
        """Grow ``sb`` to ``n_tokens`` positions; when the pool is dry,
        evict LRU prefix pins (sharers keep their refs) until it fits, else
        raise ``OutOfBlocks``.  Returns the new ids."""
        while True:
            try:
                return sb.ensure(n_tokens)
            except OutOfBlocks:
                if self.prefix_cache is None or self.prefix_cache.pop_lru() is None:
                    raise

    def _gather_prefix(self, p_len: int, block_ids) -> dict:
        """A dense ``{"k": [...], "v": [...]}`` of a pin's first ``p_len``
        positions (``[1, P, KVH, D]``, int8 and scale pairs under the int8
        cache), gathered from the current pools: what a paged hit's
        prefixed start reads.  The blocks are written once, by their
        donor's insert, so any later pool holds the right rows."""
        blocks = torch.tensor([list(block_ids)], dtype=torch.int32, device=self.engine.device)

        def one(pool):
            return gather_pages(pool, blocks, self.block_size)[:, :p_len]

        def entry(c):
            return tuple(one(x) for x in c) if isinstance(c, tuple) else one(c)

        return {"k": [entry(c) for c in self._state.cache_k],
                "v": [entry(c) for c in self._state.cache_v]}

    def _donate_paged(self, st: _Stream) -> None:
        """Paged donation after the insert: pin the stream's first
        ``bucket_for_insert`` positions' blocks with one ref (no copy); a
        hit donates only a bucket longer than its own prefix.  Prefix
        buckets are block-aligned (``utils/config``), so a pin never covers
        part of a block."""
        cache = self.prefix_cache
        length = int(st.feats["length"])
        row_ids = np.asarray(st.feats["input_ids"], np.int32)[:length]
        p_ins = cache.bucket_for_insert(length)
        if (p_ins is None or (st.s_lo > 0 and p_ins <= st.s_lo)
                or cache.contains(row_ids, p_ins) or st.blocks is None):
            return
        nb_pin = p_ins // self.block_size
        if nb_pin <= 0 or nb_pin > len(st.blocks.ids):
            return
        ids = list(st.blocks.ids[:nb_pin])
        self.pool.ref(ids)
        cache.insert(row_ids, p_ins, PagedPrefix(p_ins, tuple(ids),
                                                 p_ins * self.engine.kv_token_bytes()))

    # -- host KV tier (KV_HOST_BUDGET_MB) --------------------------------

    def _host_tier(self):
        """The engine's ``KVHostTier`` when this loop uses one (paged, a
        budget of at least one block), else None."""
        if not self.paged:
            return None
        tier = getattr(self.engine, "kv_host", None)
        return tier if tier is not None and tier.enabled else None

    def _ensure_host_pool(self, tier) -> bool:
        """Build the tier's buffers, pinned on the card, off the pool
        leaves (the first build, at the slot state's allocation, pins them
        all before the service is ready)."""
        return tier.ensure_pool(self._leaf_specs(), pin=self.engine.device.type == "cuda")

    def _leaf_specs(self) -> list:
        """``[(per-block shape, dtype)]`` of the pool leaves."""
        return [(tuple(x.shape[1:]), x.dtype) for x in self._pool_leaves()]

    def _attach_disk_tier(self, tier) -> None:
        """The disk rung under the host tier (KV_DISK_BUDGET_MB): its
        payload files opened against the pool leaves' layout (a layout
        that changed wipes the stale tier) and the host ledger's eviction
        spilling to it."""
        disk = getattr(self.engine, "kv_disk", None)
        if disk is None or not disk.enabled or tier.ledger is None:
            return
        if disk.attach(self._leaf_specs()):
            tier.ledger.spill = self._spill_host_entry
            disk._note_gauges(self.model)
        else:
            log.warning("disk KV tier: leaf layout mismatch; tier disabled for this process")

    def _spill_host_entry(self, entry) -> None:
        """The host ledger's eviction hook: the victim's blocks go to the
        disk tier before they die (host reads and memmap writes only,
        under the host ledger's lock)."""
        disk = self._disk_tier()
        if disk is None or entry.key is None or entry.pool is None:
            return
        disk.put(entry.key, entry.tokens, entry.kind, entry.pool.read(entry.ids))
        if self._flight is not None:
            self._flight.event("disk_spill", entry=entry.kind, blocks=len(entry.ids))

    def _is_disk_entry(self, entry) -> bool:
        d = getattr(self.engine, "kv_disk", None)
        return entry is not None and d is not None and entry.ledger is d.ledger

    def _promote_disk_entry(self, entry, key):
        """Disk -> host: a host entry of ``entry``'s blocks, read straight
        into the host pool's buffers; None on any miss or pressure (the
        caller takes its fallback)."""
        d = self._disk_tier()
        tier = self._host_tier()
        if d is None or tier is None or entry is None or not entry.alive or not entry.ready:
            return None
        try:
            if not self._ensure_host_pool(tier):
                return None
            # Hot on disk while the host reservation may spill a victim there.
            d.ledger.touch(entry)
            host = tier.reserve(len(entry.ids), entry.tokens, kind=entry.kind, key=key)
            if host is None:
                return None
            d.pool.read_into(entry.ids, tier.pool, host.ids)
            host.ready = True
        except Exception:
            log.exception("disk->host KV promotion failed")
            return None
        d.promotes += 1
        self.swap_in_bytes += len(entry.ids) * self.pool.block_bytes
        if self._flight is not None:
            self._flight.event("disk_promote", entry=entry.kind, tokens=entry.tokens,
                               blocks=len(entry.ids))
        self._note_host_gauges()
        return host

    def _pool_leaves(self) -> list[torch.Tensor]:
        """The paged pools in the host buffers' order: ``cache_k`` then
        ``cache_v``, layer by layer, an int8 payload before its scale."""
        out = []
        for entry in self._state.cache_k + self._state.cache_v:
            out.extend(entry if isinstance(entry, tuple) else (entry,))
        return out

    def _swap_tokens(self, st: _Stream) -> int | None:
        e = st.swap
        return e.tokens if e is not None and e.alive else None

    def _drop_swap(self, st: _Stream, disk_too: bool = False) -> None:
        """Release a stream's host entry (it ended, fell back, went live or
        is swapped out again), through the entry's own ledger; at a
        terminal end (``disk_too``) its disk copy too, which nothing will
        resume now."""
        e = st.swap
        if e is not None:
            st.swap = None
            if e.ledger is not None:
                e.ledger.release(e)
            self._note_host_gauges()
        if disk_too and st.rid:
            d = getattr(self.engine, "kv_disk", None)
            if d is not None and d.enabled:
                try:
                    d.release_key(("stream", st.rid))
                except Exception:
                    log.exception("disk-tier release failed")

    def _note_host_gauges(self) -> None:
        tier = self._host_tier()
        if tier is None or tier.pool is None:
            return
        metrics.KV_HOST_POOL_BLOCKS.labels(self.model, "used").set(tier.pool.used_blocks)
        metrics.KV_HOST_POOL_BLOCKS.labels(self.model, "free").set(tier.pool.free_blocks)

    def _give_back(self, ids: list[int]) -> None:
        self.pool.free(ids)
        self.admission.note_pool()

    def _free_demotions(self) -> None:
        """Demotions queued and not gathered return their device refs."""
        eng = self.engine
        pending, eng._host_demote_pending = eng._host_demote_pending, []
        for _, pp in pending:
            self._give_back(list(pp.block_ids))

    def _flush_pins(self) -> None:
        """Flush the prefix cache's pins before their blocks are cleared:
        no demotion (its copy would read what the reset clears), and the
        demotions still queued free their refs."""
        eng = self.engine
        prev = getattr(eng, "_host_demote_on", True)
        eng._host_demote_on = False
        try:
            self.prefix_cache.flush()
        finally:
            eng._host_demote_on = prev
        if getattr(eng, "_host_demote_pending", None):
            self._free_demotions()

    def _gather(self, block_ids: list[int]):
        """One gather of ``block_ids``' rows from every pool leaf, on the
        loop's CUDA stream (after every chunk in flight that wrote them),
        into fresh device tensors, and their copy to the host started
        without waiting; the blocks may go to another stream at once.
        Returns (gathered rows, which must outlive the copy; the copy)."""
        idx = torch.as_tensor(list(block_ids), dtype=torch.long).to(self.engine.device)
        with self.engine._lock:
            gathered = [leaf.index_select(0, idx) for leaf in self._pool_leaves()]
            return gathered, _HostCopy(*gathered)

    def _swap_out(self, st: _Stream) -> None:
        """Copy the blocks behind a checkpointed stream's resume prompt
        (positions ``[0, length)`` of its feats, rewritten already) to the
        host tier."""
        self._swap_out_blocks(st, list(st.blocks.ids), int(st.feats.get("length", 0) or 0))

    def _swap_out_job(self, job: _PrefillJob) -> None:
        """A job checkpointed mid-prefill: copy the windows it consumed
        (``[0, consumed)``, block-aligned, as PREFILL_CHUNK and the prefix
        buckets are) to the host tier before its blocks free, so its resume
        prefetches them and prefills only the windows it never ran."""
        cov = int(job.consumed)
        if not self.paged or job.sb is None or cov <= 0 or cov % self.block_size:
            return
        self._swap_out_blocks(job.st, list(job.sb.ids), cov)

    def _swap_out_blocks(self, st: _Stream, block_ids: list[int], cov: int) -> None:
        """Swap the first ``blocks_for(cov)`` of ``block_ids`` out as
        ``st``'s resume KV: a host entry, one gather, the copy landing at
        the next iteration top.  Any failure leaves the stream on the
        recompute resume: the swap is never a correctness dependency."""
        tier = self._host_tier()
        if tier is None or self._state is None or st.cancelled.is_set() or self._swap_hold:
            return
        self._drop_swap(st)  # supersedes an earlier entry
        nb = blocks_for(cov, self.block_size)
        if nb <= 0 or nb > len(block_ids):
            return
        entry = None
        try:
            if not self._ensure_host_pool(tier):
                return
            # Keyed by request id, so its disk write-through (and a restart's
            # replay) finds it.
            entry = tier.reserve(nb, cov, kind="stream",
                                 key=("stream", st.rid) if st.rid else None)
            if entry is None:
                return  # the tier cannot hold it even after eviction
            gathered, copy = self.engine.dispatch_guard(
                "swap", lambda: self._gather(block_ids[:nb]))
        except Exception:
            log.exception("KV swap-out failed; the stream resumes by recompute")
            if entry is not None:
                tier.release(entry)
            return
        self._swap_pending.append((entry, gathered, copy, None))
        st.swap = entry
        self.swap_outs += 1
        nbytes = nb * self.pool.block_bytes
        self.swap_out_bytes += nbytes
        metrics.KV_SWAP_BYTES.labels(self.model, "out").inc(nbytes)
        if self._flight is not None:
            self._flight.event("swap_out", rid=st.rid, tokens=cov, blocks=nb)
        self._note_host_gauges()

    def _drain_swapouts(self) -> None:
        """Land the device-to-host copies in flight in the host buffers
        (``index_copy_`` on the CPU; the copies started at the gather have
        usually finished): at the iteration top, before a swap-in reads an
        entry, and at shutdown.  A demotion's device refs free here."""
        if not self._swap_pending:
            return
        pending, self._swap_pending = self._swap_pending, []
        disk = self._disk_tier()
        for entry, _gathered, copy, free_ids in pending:
            try:
                if entry.alive:
                    vals = copy.tensors()
                    entry.pool.write(entry.ids, vals)
                    entry.ready = True
                    if disk is not None and entry.kind == "stream" and entry.key is not None:
                        # Write-through: the resume KV now outlives the
                        # process, and a restart prefetches it back.
                        try:
                            disk.put(entry.key, entry.tokens, "stream", vals)
                        except Exception:
                            log.exception("disk write-through failed (resume still host-served)")
            except Exception:
                log.exception("KV swap-out copy failed")
                if entry.ledger is not None:
                    entry.ledger.release(entry)
            finally:
                if free_ids:
                    self._give_back(free_ids)
        self._note_host_gauges()

    def _drain_demotions(self) -> None:
        """Gather the prefix pins the cache evicted since the last
        iteration (their refs came with them) to the host tier; the refs
        free when the copy lands.  A demotion that cannot land (no tier,
        no state, the key resident already, the tier full) frees its refs
        now: an eviction still evicts."""
        eng = self.engine
        pending = getattr(eng, "_host_demote_pending", None)
        if not pending:
            return
        eng._host_demote_pending = []
        tier = self._host_tier()
        for key, pp in pending:
            ids = list(pp.block_ids)
            entry = None
            if (tier is not None and self._state is not None and not self._state_stale
                    and ids and self._ensure_host_pool(tier)
                    and not tier.prefix_resident(key)):
                entry = tier.reserve(len(ids), pp.p_len, kind="prefix", key=key)
            if entry is None:
                self._give_back(ids)
                continue
            try:
                gathered, copy = self._gather(ids)
            except Exception:
                log.exception("prefix demotion gather failed")
                tier.release(entry)
                self._give_back(ids)
                continue
            nbytes = len(ids) * self.pool.block_bytes
            self.swap_out_bytes += nbytes
            metrics.KV_SWAP_BYTES.labels(self.model, "out").inc(nbytes)
            if self._flight is not None:
                self._flight.event("prefix_demote", p_len=pp.p_len, blocks=len(ids))
            self._swap_pending.append((entry, gathered, copy, ids))

    def _host_to_device(self, entry, pos: int, dev_ids: list[int]) -> None:
        """Copy host blocks ``entry.ids[pos:pos + n]`` into device blocks
        ``dev_ids`` (the caller holds the engine's lock): the host rows
        into pinned staging, to the card without waiting, then
        ``index_copy_`` into the pools on the loop's stream, behind any
        chunk in flight whose table still names those blocks (a vacated
        row's); the pools are the graphs' own tensors, written in place."""
        dev = self.engine.device
        pin = dev.type == "cuda"
        n = len(dev_ids)
        staging = [torch.empty((n,) + tuple(buf.shape[1:]), dtype=buf.dtype, pin_memory=pin)
                   for buf in entry.pool.leaves]
        entry.pool.read(entry.ids[pos:pos + n], out=staging)
        idx = torch.as_tensor(list(dev_ids), dtype=torch.long).to(dev)
        for leaf, rows in zip(self._pool_leaves(), staging):
            leaf.index_copy_(0, idx, rows.to(dev, non_blocking=True))

    def _start_swapin(self, st: _Stream) -> bool:
        """Begin a host-swapped checkpoint's resume (the caller holds the
        engine's lock): allocate the device blocks its host copy covers
        (admission charged exactly them) and queue the prefetch.  False
        only when the host copy is unusable (evicted, another tier's, not
        landed, or covering neither the whole resume prompt nor a
        block-aligned part of it that chunked prefill can continue): the
        caller admits the stream by recompute.  A dry pool requeues it with
        its entry intact."""
        entry = st.swap
        tier = self._host_tier()
        self._drain_swapouts()  # the entry's copy may not have landed yet
        length = int(st.feats["length"])
        if self._is_disk_entry(entry):
            # The checkpoint's KV outlived a host eviction or the process:
            # disk -> host first, then the host prefetch as for any swap.
            if self._state is None or self._state_stale:
                self._build_empty_state()
            entry = self._promote_disk_entry(entry, ("stream", st.rid) if st.rid else None)
            st.swap = entry
        partial_ok = (entry is not None and 0 < entry.tokens < length and bool(self.prefill_chunk)
                      and entry.tokens % self.block_size == 0)
        if (entry is None or tier is None or tier.pool is None or entry.pool is not tier.pool
                or not entry.alive or not entry.ready
                or not (entry.tokens == length or partial_ok)):
            self._drop_swap(st)
            self.swap_fallbacks += 1
            metrics.KV_SWAP_RESUMES.labels(self.model, "fallback").inc()
            if self._flight is not None:
                self._flight.event("swap_fallback", rid=st.rid)
            return False
        self._pending_wave = [s for s in self._pending_wave if s is not st]
        ids = np.asarray(st.feats["input_ids"], np.int32)[:length]
        st.feats["prefill_mode"] = "swapped"
        job = _SwapInJob(st, ids, length)
        job.resume_at = int(entry.tokens)
        job.sb = StreamBlocks(self.pool, self.block_size)
        try:
            if self._state is None or self._state_stale:
                self._build_empty_state()
            # Exactly the blocks the host copy covers; a partial resume
            # grows the rest a window at a time.
            self._reclaim_then_ensure(job.sb, job.resume_at)
        except OutOfBlocks:
            job.sb.release()
            self._note_stall(st, "swapin")
            self.admission.release(st)
            self._requeue_preempted(st)
            return True
        except Exception as e:
            job.sb.release()
            self._finish(st, e)
            return True
        # Growth runs off the exact length: the KV covers real positions only.
        st.s_lo, st.s_base = 0, length
        job.table_row = np.full(self.nb_max, self.pool.num_blocks, np.int32)
        job.table_row[: len(job.sb.ids)] = job.sb.ids
        self._swapping.append(job)
        self.admission.note_pool()
        return True

    def _note_swapin(self, st: _Stream, tokens: int, partial: bool = False) -> None:
        self.swap_ins += 1
        metrics.KV_SWAP_RESUMES.labels(self.model, "swapped").inc()
        if self._flight is not None:
            if partial:
                self._flight.event("swap_resume", rid=st.rid, tokens=tokens, partial=True)
            else:
                self._flight.event("swap_resume", rid=st.rid, tokens=tokens)
        self._drop_swap(st)

    def _swapin_to_prefill(self, job: _SwapInJob) -> None:
        """A mid-prefill checkpoint's consumed windows are back: the stream
        becomes a prefill job again at that boundary, its restored blocks
        what those windows wrote, so only the windows it never ran
        prefill."""
        st = job.st
        self._swapping.remove(job)
        pj = _PrefillJob(st, job.ids, job.L)
        pj.consumed = job.resume_at
        pj.sb, job.sb = job.sb, None
        pj.table_row = job.table_row
        self._note_swapin(st, job.resume_at, partial=True)
        self._prefilling.append(pj)

    def _swap_handoff(self, job: _SwapInJob) -> bool:
        """A whole resume prompt's blocks are back: the chunked-prefill
        handoff puts the stream live (``write_idx = L - 1``, step 0), its
        tokens those of a fresh prefill of the same prompt."""
        st = job.st
        tokens = st.swap.tokens if st.swap is not None else job.L
        ok = self._handoff_job(job)
        if ok:
            self._note_swapin(st, tokens)
        return ok

    def _advance_swapins(self) -> bool:
        """Copy the resuming streams' blocks back, ``KV_PREFETCH_BLOCKS`` a
        chunk boundary in all while streams decode (as many for each job
        when none does), interactive streams first, behind the live chunk
        as prefill windows are; hand off the ones complete when a slot is
        free.  A host entry evicted mid-prefetch returns its device blocks
        and the stream resumes by recompute.  Returns True when a copy or
        a handoff happened."""
        if not self._swapping:
            return False
        advanced = False
        live = bool(self.active)
        for job in list(self._swapping):
            if job.st.cancelled.is_set():
                self._swapping.remove(job)
                self._drop_job(job)
                self._release(job.st)
        for job in [j for j in self._swapping if j.ready]:
            if not self.free:
                break
            self._swapping.remove(job)
            advanced = self._swap_handoff(job) or advanced
        budget = self.swap_chunk_blocks if live else 1 << 30
        jobs = sorted((j for j in self._swapping if not j.ready),
                      key=lambda j: (j.st.klass != INTERACTIVE, j.t_in))
        for job in jobs:
            if budget <= 0:
                break
            entry = job.st.swap
            if entry is None or not entry.alive:
                self._swapping.remove(job)
                self._drop_job(job)
                self._drop_swap(job.st)
                self.swap_fallbacks += 1
                metrics.KV_SWAP_RESUMES.labels(self.model, "fallback").inc()
                self.admission.release(job.st)
                self._requeue_preempted(job.st)
                continue
            n = len(job.sb.ids)
            k = min(self.swap_chunk_blocks, n - job.copied, budget)
            if k > 0:
                try:
                    with self.engine._lock:
                        self.engine.dispatch_guard("swap", lambda: self._host_to_device(
                            entry, job.copied, job.sb.ids[job.copied: job.copied + k]))
                except Exception as e:
                    log.exception("KV prefetch failed")
                    self._swapping.remove(job)
                    self._drop_job(job)
                    self._fail_streams([job.st], e)
                    if self._fault_pending is not None:
                        break
                    continue
                job.copied += k
                budget -= k
                advanced = True
                nbytes = k * self.pool.block_bytes
                self.swap_in_bytes += nbytes
                self.prefetch_blocks_total += k
                if live:
                    self.prefetch_blocks_live += k
                metrics.KV_SWAP_BYTES.labels(self.model, "in").inc(nbytes)
            if job.copied >= n:
                if job.resume_at < job.L:
                    self._swapin_to_prefill(job)
                    advanced = True
                else:
                    job.ready = True
                    if self.free:
                        self._swapping.remove(job)
                        advanced = self._swap_handoff(job) or advanced
        return advanced

    def _promote_host_prefix(self, row_ids: np.ndarray, length: int, usable):
        """On a device miss, a prefix the host tier holds comes back (the
        caller holds the engine's lock): fresh blocks, the copy to the
        card, a new pin whose ref is the allocation's.  Returns the match
        ``(P, PagedPrefix)``, or None on any miss or pressure: a promotion
        never fails or sheds a request."""
        tier = self._host_tier()
        cache = self.prefix_cache
        if (tier is None or tier.ledger is None or cache is None or self._state is None
                or self._state_stale):
            return None
        m = cache.host_lookup(row_ids, length, tier, usable=usable)
        from_disk = False
        if m is None:
            # A prefix the host LRU spilled to disk comes back through the
            # host tier.
            disk = self._disk_tier()
            if disk is not None:
                m = cache.host_lookup(row_ids, length, disk, usable=usable)
                if m is not None:
                    host = self._promote_disk_entry(m[1], m[1].key)
                    m = (m[0], host) if host is not None else None
                    from_disk = m is not None
        if m is None:
            return None
        p_len, entry = m
        nb = p_len // self.block_size
        if nb <= 0 or len(entry.ids) < nb or not entry.ready:
            return None
        try:
            ids = self.pool.alloc(nb)
        except OutOfBlocks:
            return None
        try:
            k = self.swap_chunk_blocks
            for i in range(0, nb, k):
                self._host_to_device(entry, i, ids[i: i + k])
        except Exception:
            log.exception("prefix promotion copy failed")
            self._give_back(ids)
            return None
        pp = PagedPrefix(p_len, tuple(ids), p_len * self.engine.kv_token_bytes())
        cache.insert(row_ids, p_len, pp)
        if not cache.contains(row_ids, p_len):
            return None  # evicted straight back out (a budget under one entry)
        self.admission.note_pool()
        self.host_prefix_promotes += 1
        nbytes = nb * self.pool.block_bytes
        self.swap_in_bytes += nbytes
        metrics.KV_SWAP_BYTES.labels(self.model, "in").inc(nbytes)
        metrics.KV_HOST_PREFIX_HITS.labels(self.model).inc()
        if self._flight is not None:
            self._flight.event("prefix_promote", p_len=p_len, blocks=nb, disk=from_disk)
        return p_len, pp

    # -- decode chunks and windows ---------------------------------------

    def _inflight_chunks_ahead(self) -> int:
        """Chunks the dispatches in flight will deliver at most (a window
        counts its depth: an early exit only shortens it)."""
        return sum(e.w for e in self._inflight)

    def _work_remains(self) -> bool:
        """True while a live stream needs tokens beyond what the chunks and
        windows in flight will deliver."""
        ahead = self._inflight_chunks_ahead() * self.chunk
        return any(st.produced + ahead < st.budget for st in self.active.values())

    def interactive_load(self) -> tuple[bool, bool]:
        """(an interactive stream holds a slot, an interactive stream waits
        in the queue, mid-prefill or mid-prefetch): the decode window
        governor's class pressure."""
        live = any(st.klass == INTERACTIVE and not st.cancelled.is_set()
                   for st in self.active.values())
        waiting = self.queue.waiting(INTERACTIVE) > 0 or any(
            j.st.klass == INTERACTIVE for jobs in (self._prefilling, self._swapping)
            for j in jobs)
        return live, waiting

    def _pick_window(self, preview: bool = False) -> int:
        """The next dispatch's window depth: the governor's class policy,
        clamped to the chunks a live stream still needs beyond those in
        flight; ``preview`` (the staged host prep) leaves the governor's
        state alone."""
        if self.decode_window <= 1:
            return 1
        ahead = self._inflight_chunks_ahead() * self.chunk
        need = max((st.budget - st.produced - ahead for st in self.active.values()
                    if not st.cancelled.is_set()), default=0)
        live, waiting = self.interactive_load()
        fn = self._window_gov.preview if preview else self._window_gov.pick
        return fn(max_chunks=-(-need // self.chunk), interactive_live=live,
                  interactive_waiting=waiting)

    def _grow_for_dispatch(self, n_chunks: int = 1) -> None:
        """Grant every live row the blocks the next ``n_chunks`` chunks write
        (a window's whole depth up front; never past its budget: later
        writes go to the scratch block and are never read).  A row whose
        growth finds the pool dry is checkpointed and queued again (it
        resumes token-identically when blocks free up); admission's
        worst-case bound lets a stream alone always fit."""
        grew = False
        for slot, st in list(self.active.items()):
            if st.cancelled.is_set() or st.blocks is None:
                continue  # frees at the next delivery; its writes go to scratch
            steps = self._dispatched_steps.get(slot, 0) + self.chunk * max(1, n_chunks)
            try:
                self.engine.fault_point("grow")
                fresh = self._reclaim_then_ensure(st.blocks, st.s_base + min(steps, st.budget))
            except OutOfBlocks:
                self._note_stall(st, "grow")
                self._vacate(slot, st)
                continue
            if fresh:
                self._table[slot, : len(st.blocks.ids)] = st.blocks.ids
                grew = True
            self._dispatched_steps[slot] = steps
        if grew:
            self.admission.note_pool()

    def _chunk_call(self, sample: bool = False, w: int = 1, events=None, upload: bool = True):
        """One decode chunk over the whole slot state, or with ``w`` > 1 a
        fused window of ``w`` chunks (caller holds the engine's lock;
        ``sample``: the sampled variant): the block table copied to its
        device buffer (unless ``upload`` is off: a staged plan uploaded it),
        then each chunk the chunk's graph replayed (on the CPU: the chunk
        run).  Returns (state, tokens [n_slots, chunk]), or for a window
        (state, tokens, done history, chunks run) as
        ``window.decode_window`` does, with no host sync between its
        chunks and ``events`` (``w`` + 1 CUDA events, or None) recorded
        before the first and after each.  Under SPEC_CONTINUOUS the chunk is
        verify rounds and its tokens are (out, n_emit)."""
        eng = self.engine
        bundle = eng.bundle
        if self.paged and upload:
            self._upload_table()
        self._write_slot_rows()
        kw = self.engine._adapter_kw(self._ad_rows)
        if eng.graphs is not None:
            entry = self.chunk_graph(sample)

            def step(state):
                entry.replay()
                return state, entry.outputs
        elif self.spec:
            def step(state):
                return state, bundle.spec_chunk(state, self.chunk, eng.spec_k, sample)[1:]
        elif self.paged:
            def step(state):
                return bundle.paged_chunk(state, self._table_dev, self.chunk, sample, **kw)
        else:
            def step(state):
                return bundle.generate_chunk(state, self.chunk, sample, **kw)
        if w == 1:
            return step(self._state)
        chunk_fn = step
        if events is not None:
            events[0].record()
            marks = iter(events[1:])

            def chunk_fn(state):
                out = step(state)
                next(marks).record()
                return out

        return decode_window(chunk_fn, self._state, self.chunk, w, bundle.cfg.pad_id)

    def _upload_table(self) -> None:
        """The host block table into the chunk graph's device buffer (the
        caller holds the engine's lock), queued on the loop's CUDA stream
        behind every dispatch in flight, which therefore never read it.  On
        the card through pinned buffers used in turn (a copy from pageable
        memory may hold the host), one reused only once its last copy's
        event fired: chain_depth + 2 of them, so that wait is rarely
        felt."""
        src = torch.from_numpy(self._table)
        if self._table_dev.device.type != "cuda":
            self._table_dev.copy_(src)
            return
        while len(self._table_host) < self.chain_depth + 2:
            self._table_host.append([torch.empty(src.shape, dtype=src.dtype, pin_memory=True),
                                     None])
        self._table_turn = (self._table_turn + 1) % len(self._table_host)
        buf = self._table_host[self._table_turn]
        if buf[1] is not None:
            buf[1].synchronize()
        buf[0].copy_(src)
        self._table_dev.copy_(buf[0], non_blocking=True)
        buf[1] = torch.cuda.Event()
        buf[1].record()

    def _window_events(self, w: int):
        """``w`` + 1 timing events for a window when the loop times them on
        the card, else None."""
        if not self.time_windows or self.engine.device.type != "cuda":
            return None
        return [torch.cuda.Event(enable_timing=True) for _ in range(w + 1)]

    def chunk_graph(self, sample: bool = False) -> compile_cache.GraphEntry:
        """The graph of one chunk over this loop's slot state, argmax or
        ``sample`` (captured on the first call): its descriptor holds the
        slot state's token, so no other loop's state aliases it."""
        eng = self.engine
        cfg = eng.bundle.cfg
        kind = ("loop_chunk_paged" if self.paged else "loop_spec_chunk" if self.spec
                else "loop_chunk")
        shape = ((self.pool.num_blocks, self.block_size, self.nb_max) if self.paged
                 else (self._slot_width(),))
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
        kw = self.engine._adapter_kw(self._ad_rows)
        if self.paged:
            def chunk():
                return eng.bundle.paged_chunk(state, table, self.chunk, sample, **kw)[1]
        elif self.spec:
            def chunk():
                return eng.bundle.spec_chunk(state, self.chunk, eng.spec_k, sample)[1:]
        else:
            def chunk():
                return eng.bundle.generate_chunk(state, self.chunk, sample, **kw)[1]
        return chunk, (state, table), eng.device

    # -- staged host prep (HOST_PREP_DOUBLE) -----------------------------

    def _stage_host_prep(self) -> None:
        """With the chunk just dispatched in flight, run the next
        dispatch's host prep now (paged): the growth pass for the window
        the governor would pick (``preview``, no side effect) and the
        table's upload, so that dispatch only checks the plan.  The growth
        is the inline pass itself: a dry pool checkpoints as it would one
        iteration later (the undelivered tokens in flight are part of no
        checkpoint).  Both halves count as ``prep`` boundaries."""
        self._rollback_staged_prep()
        if not (self.host_prep_double and self.paged and self.active):
            return
        if not self._work_remains():
            return
        eng = self.engine
        w = self._pick_window(preview=True)
        t0 = time.perf_counter()
        steps0 = dict(self._dispatched_steps)
        self._grow_for_dispatch(w)
        if not self.active:  # every row checkpointed on a dry pool
            return
        deltas = {slot: self._dispatched_steps.get(slot, 0) - steps0.get(slot, 0)
                  for slot in self.active}
        table_np = self._table.copy()
        eng.note_dispatch("prep", time.perf_counter() - t0)

        def upload():
            with eng._lock:
                self._upload_table()

        eng.dispatch_guard("prep", upload)
        self._staged_prep = {"w": w, "tenants": dict(self.active),
                             "steps": dict(self._dispatched_steps), "deltas": deltas,
                             "table_np": table_np}
        self.prep_staged += 1

    def _rollback_staged_prep(self) -> None:
        """Return a stale plan's grants: each tenant still live gets its
        step cursor back and its blocks past it trimmed, its table row
        rewritten (one that left released its whole list already)."""
        staged, self._staged_prep = self._staged_prep, None
        if staged is None:
            return
        trimmed = False
        for slot, st in staged["tenants"].items():
            delta = staged["deltas"].get(slot, 0)
            if self.active.get(slot) is not st or st.blocks is None or not delta:
                continue
            steps = max(0, self._dispatched_steps.get(slot, 0) - delta)
            self._dispatched_steps[slot] = steps
            trimmed |= bool(st.blocks.trim(st.s_base + min(steps, st.budget)))
            n = len(st.blocks.ids)
            self._table[slot, :n] = st.blocks.ids
            self._table[slot, n:] = self.pool.num_blocks
        if trimmed:
            self.admission.note_pool()

    def _consume_staged_prep(self, w: int) -> bool:
        """Whether the staged plan holds for this dispatch: the same window,
        tenants (by identity), step cursors and table bytes.  Else it is
        rolled back, so the inline prep starts from the state before it."""
        staged = self._staged_prep
        if staged is None:
            return False
        if (staged["w"] == w and staged["tenants"] == dict(self.active)
                and staged["steps"] == self._dispatched_steps
                and np.array_equal(staged["table_np"], self._table)):
            self._staged_prep = None
            self.prep_hits += 1
            return True
        self.prep_misses += 1
        self._rollback_staged_prep()
        return False

    def _dispatch_chunk(self) -> None:
        """Dispatch one chunk or fused window of every live slot (its depth
        from ``_pick_window``; paged, the blocks of all its chunks granted
        first, by the staged plan when it holds) and start the host copy of
        its results."""
        w = self._pick_window()
        self.last_window = w
        with tracing.span("decode_chunk", cat="engine", n_streams=len(self.active),
                          streams=[st.rid for st in self.active.values()], paged=self.paged,
                          window=w):
            staged = False
            if self.paged:
                staged = self._consume_staged_prep(w)
                if not staged:
                    self._grow_for_dispatch(w)
                    if not self.active:  # every row checkpointed on a dry pool
                        return
                if self.prefix_cache is not None:
                    self._note_shared_rows()
            events = self._window_events(w) if w > 1 else None
            sample = bool(self.sampled_slots)
            with self.engine._lock:
                if w > 1:
                    self._state, toks, hist, n = self.engine.dispatch_guard(
                        "chunk", lambda: self._chunk_call(sample, w, events, upload=not staged))
                    copy = _HostCopy(toks, hist, n)
                else:
                    self._state, toks = self.engine.dispatch_guard(
                        "chunk", lambda: self._chunk_call(sample, upload=not staged))
                    base = self._state.base if self.spec else self._state
                    copy = _HostCopy(*_outputs(toks), base.done)
        self.chunk_dispatches += 1
        if self.spec:
            self.spec_rounds += self.chunk
        else:
            self.decode_steps += self.chunk * w
        metrics.STREAM_BATCH.labels(self.model).observe(len(self.active))
        metrics.DECODE_WINDOW_CHUNKS.labels(self.model).observe(w)
        if w > 1:
            self.window_dispatches += 1
        self._inflight.append(_Inflight(copy, dict(self.active), w, events))

    def _note_shared_rows(self) -> None:
        """The most blocks that two or more live rows of the chunk about to
        be dispatched name in their tables (K3 reads them through each)."""
        rows = self._table[list(self.active)]
        ids = rows[rows != self.pool.num_blocks]
        if ids.size:
            _, counts = np.unique(ids, return_counts=True)
            self.peak_shared_in_chunk = max(self.peak_shared_in_chunk, int((counts > 1).sum()))

    def _deliver_oldest(self) -> None:
        e = self._inflight.pop(0)
        fetched = self.engine.dispatch_guard("fetch", e.copy.get)
        # The host saw the oldest chunk land: a completion sample.
        self._perf_complete("chunk")
        self._route_entry(e, fetched)

    def _deliver_all(self) -> None:
        """Drain every dispatch in flight with one wait, one ``fetch``
        boundary: the newest copy's event follows every older one on the
        loop's CUDA stream."""
        entries, self._inflight = self._inflight, []

        def fetch():
            entries[-1].copy.tensors()
            return [e.copy.get() for e in entries]

        fetched = self.engine.dispatch_guard("fetch", fetch)
        self._perf_complete("chunk", len(entries))
        for e, got in zip(entries, fetched):
            self._route_entry(e, got)

    def _deliver_ready(self) -> None:
        """Route, oldest first, the dispatches in flight whose host copy
        has landed (paged; on the card an event query, no sync): rows that
        ended return their blocks before the growth pass instead of after
        it.  Nothing waits, so the pipeline's cadence is untouched."""
        if not self.paged:
            return
        while self._inflight and self._inflight[0].copy.ready():
            self._deliver_oldest()

    def _perf_complete(self, site: str, n: int = 1) -> None:
        """One completion sample for the engine's device-occupancy
        estimator (an engine without one records nowhere)."""
        perf = getattr(self.engine, "perf", None)
        if perf is not None:
            perf.note_complete(site, n)

    def _route_entry(self, e: _Inflight, fetched: list[np.ndarray]) -> None:
        if e.w > 1:
            toks_np, hist_np, n = fetched
            self._route_window(toks_np, hist_np, int(n), e)
        elif self.spec:
            out_np, ns_np, done_np = fetched
            self._route_chunk((out_np, ns_np), done_np, e.snapshot)
        else:
            self._route_chunk(*fetched, e.snapshot)

    def _route_window(self, toks_np: np.ndarray, hist_np: np.ndarray, nc: int,
                      e: _Inflight) -> None:
        """A window's delivery: the per-chunk routing replayed over the
        ``nc`` chunks it ran, each with its ``done`` flags from the
        history, so the streams get what fetching each chunk would have
        given them.  No row outlives an early exit: every row is done after
        the last chunk the window ran (at its entry, when it ran none), so
        this routing, or the one before that saw the row end, frees each
        row of the snapshot whole, with the blocks granted for the chunks
        past its end."""
        w, chunk = e.w, self.chunk
        self.window_chunks += nc
        if nc < w:
            self.window_early_exits += 1
            metrics.WINDOW_EARLY_EXITS.labels(self.model).inc()
            if self._flight is not None:
                self._flight.event("window_early_exit", ran=nc, window=w)
            if e.events is not None:
                # Synchronized by the fetch: the copy followed the last chunk.
                self.window_tail_ms += e.events[nc].elapsed_time(e.events[w])
                self.window_tail_chunks += w - nc
        for c in range(nc):
            self._route_chunk(toks_np[:, c * chunk:(c + 1) * chunk], hist_np[c], e.snapshot)

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
            if self.spec:
                # A verify round may pass the budget mid-chunk: trim.
                out_np, ns_np = toks_np
                chunk = flatten_emitted(out_np, ns_np, slot)
                metrics.SPEC_EMITTED.labels(self.model).observe(int(chunk.size) / max(1, self.chunk))
                chunk = chunk[: st.budget - st.produced]
                st.produced += int(chunk.size)
                self._emit_tokens(st, chunk)
            else:
                self._emit_tokens(st, toks_np[slot])
                st.produced += self.chunk
            if bool(done_np[slot]) or st.produced >= st.budget:
                self._journal_done(st)
                st.emit(_END)
                self._free_slot(slot)
