"""InferenceEngine: bucketed dispatch of one model on one device.

Counterpart of the JAX package's ``engine/engine.py`` for image and text
classification and for non-streaming generation.  Requests are padded up
to a small set of (batch, seq) buckets.  In the JAX package each bucket
is one compiled executable; here, on the card, each bucket is one CUDA
graph (``runtime/compile_cache.py``): the dispatch copies the collated
batch into the bucket's static inputs, replays the graph and copies the
static output to the host, all under ``_lock`` (on the card the lock of
the card's graph pool, shared by every engine there), so no graph output
escapes the lock except as a host copy.  ``warmup`` captures every bucket
before the service reports ready; with ``WARMUP=0`` a bucket's first
dispatch captures it (a cache miss), as jit compiles at first use.  A
capture that fails raises: there is no eager fallback.  On the CPU, and
under a placement whose shards span several cards (multi-card capture is
not ported), the same functions run eagerly; ``graph_modes`` says which.

- Classification: each dispatch is one ``torch.inference_mode`` forward
  and one device-to-host copy of the logits.  An image batch crosses to
  the device as uint8 (a quarter of f32's bytes) from pinned host memory,
  padded to a batch bucket only (every image has the model's size).
  Under a sequence-parallel placement (bert-long) the batch goes to the
  forward as sequence shards, one per device of the placement, and seq
  buckets round up to a multiple of the shard count, as in the JAX
  package.
- Generation (``KIND_SEQ2SEQ``): ``start`` (prefill plus the first
  decode chunk, one graph per bucket as the JAX package's fused ``start``
  executable), then decode in chunks of ``STREAM_CHUNK_TOKENS`` steps
  (``gen_chunk``, one graph per bucket over the state ``start`` wrote,
  updated in place).  Each request's sampling fields become per-row
  ``SampleParams`` (``_collate_sample``; bucket-padding rows greedy); a
  batch with a sampled row runs the sampled variant of both graphs (the
  JAX package's static ``sample=True`` executables, keyed apart here by
  ``sample`` in the descriptor), an all-greedy batch the argmax one.
  Warmup captures both variants unless ``WARMUP_SAMPLING=0``.  After each
  chunk the engine reads once from the device whether every row is done
  (EOS, or its ``max_tokens`` budget), the host-side counterpart of the JAX
  package's done-aware ``while_loop``; rows come back pad-filled to
  ``max_decode_len``.
- Streaming generation runs in the continuous decode loop
  (``engine/streams.py``), or for one request on its own through
  ``generate_stream`` (prompts past the loop's largest seq bucket, and
  ``CONTINUOUS_BATCHING=0``).  The loop admits a wave of streams through
  ``start`` (prefill plus the first chunk, fused as in the JAX package)
  and, with ``PAGED_KV=1``, keeps its KV in ``kv_pool``: the blocks of
  ``KV_BUDGET_MB``, else of ``MAX_STREAMS`` worst-case streams (largest
  seq bucket plus the decode budget each).  ``kv_bytes_estimate`` and
  ``kv_blocks_estimate`` are the admission controller's footprints
  (``scheduler/admission.py``).
- Prefixes, as in the JAX package: a global ``PROMPT_PREFIX`` sits at
  positions ``[0, P)`` of every generation (the bundle's ``init_state``
  puts it there; ``global_prefix_len`` widens the footprints and the
  loop's slots).  ``PREFIX_CACHE=1`` builds ``prefix_cache``
  (``engine/prefix_cache.py``): ``start_fused`` starts one stream through
  it (a hit prefills the suffix behind the entry, a miss donates
  ``_capture_prefix``'s clone of its rows), and ``_start_prefixed`` starts
  a batch of suffixes behind per-row prefixes, on the card through a
  ``start_prefixed`` graph per (B, P, S) whose static inputs include the
  per-layer prefix K/V; warmup captures that grid (``prefixed_grid`` x
  ``prefixed_batches``).
- Chunked prefill (``PREFILL_CHUNK``): refused at build for a family
  without windows, with ``PROMPT_PREFIX``, and off the block grid under
  ``PAGED_KV``, with the reference's messages; ``chunked_prefill_applies``
  is the routing rule the loop and the ledger share, and a chunked
  prompt's ``kv_blocks_estimate`` charges its first window up front and
  grows its worst case off its exact length.
- Speculative decoding (``SPEC_DECODE=ngram``, gpt2/llama/t5): a stream on
  the per-stream path runs ``_spec_stream``, ``spec_start`` (prefill, the
  drafting history and ``STREAM_CHUNK_TOKENS`` verify rounds; behind a
  prefix-cache hit ``spec_start_prefixed``) then ``spec_chunk`` graphs, and
  a non-streaming batch of at most ``SPEC_MAX_STREAMS`` rows runs
  ``full_spec`` and ``full_spec_chunk`` replays until every row is done, each
  round capped by the rows' budgets on the device, as the reference's one
  ``while_loop`` is.  ``generate_stream`` speculates only while the per-stream
  streams (itself included) are at most ``SPEC_MAX_STREAMS``
  (``_live_streams``); sampled rows only under ``SPEC_SAMPLED``.
- The host KV tier (``KV_HOST_BUDGET_MB``): ``kv_host`` (a
  ``kv_blocks.KVHostTier``, refused without ``PAGED_KV`` with the
  reference's message), whose buffers the loop builds and fills; under it
  the paged prefix cache's ``on_evict`` hands an evicted pin and its refs
  to ``_host_demote_pending`` for the loop to demote.
- Durability (``JOURNAL_DIR``): ``journal`` (the batcher's
  ``StreamJournal``) and ``kv_disk`` (the ``KVDiskTier`` under
  ``KV_DISK_BUDGET_MB``, refused without ``JOURNAL_DIR`` or without the
  host tier, with the reference's messages); None without them.
- LoRA adapters (``ADAPTER_DIR``): the batcher hands the engine its
  ``AdapterPool`` (``adapters``); the continuous loop's starts pass each
  row's adapter slot (``start``'s ``rows``) and run through the pool's
  overlay, in ``start``/``start_prefixed`` graphs of their own (a static
  rows input written before each replay), warmed with the base ones.  The
  whole path and the per-stream path stay on the base model, as in the
  reference.
- Faults (``engine/faults.py``): ``faults`` (the ``FAULT_SPEC`` schedule,
  its grammar checked here, before readiness) and ``watchdog``
  (``DISPATCH_TIMEOUT_S``, ``DISPATCH_RETRIES``, ``DISPATCH_BACKOFF_S``)
  around every dispatch site: ``dispatch_guard(site, fn)`` runs one
  dispatch under both and counts its host seconds, ``fault_point`` is a
  bare injection point (the paged allocator's ``grow``).  With no spec, no
  deadline and no retries a guard is a plain call.  ``reset_device_state``
  is the supervised rebuild's device half, in place: the pools, the params
  and the graphs keep their addresses.
- Observability (``utils/tracing.py``, ``utils/perfobs.py``,
  ``utils/locktrace.py``): ``flight`` (the flight recorder, ``FLIGHT_RING``;
  the watchdog's retries and timeouts land in it, the loop's iterations
  and events too), ``perf`` (the device busy / bubble estimator,
  ``PERF_OBS``, on by default) and ``dispatch_stats`` (per site: count, host
  seconds and, under ``TRACE=1`` only, device seconds;
  ``dispatch_attribution()``).  ``dispatch_guard`` checks the lock-order
  detector, stamps the submit for ``perf`` with the two clock reads it
  already takes and, under ``TRACE=1``, records a ``dispatch:{site}`` span
  whose device half synchronizes the engine's stream.  Outside ``TRACE=1``
  nothing here synchronizes or reads the device.
"""

from __future__ import annotations

import logging
import math
import os
import random
import threading
import time
from typing import Iterator

import numpy as np
import torch

from ..models.gpt import clone_state, copy_state, prefix_len
from ..models.spec import flatten_emitted
from ..models.registry import KIND_IMAGE, KIND_SEQ2SEQ, KIND_TEXT, ModelBundle, decode_budget
from ..models.sampling import SampleParams, advance, greedy_params, make_params
from ..runtime import compile_cache
from ..utils import locktrace, metrics, perfobs, tracing
from .faults import FaultInjector, Watchdog
from .kv_blocks import BlockPool, KVHostTier, PagedPrefix, blocks_for, kv_token_bytes
from .prefix_cache import PrefixCache

# A per-stream prompt past the largest seq bucket is collated at its length
# rounded up to this step (at most the model's prompt cap), so such prompts
# share a bounded set of widths, and of graphs.
LONG_PROMPT_STEP = 128

log = logging.getLogger(__name__)


def bucket_for(n: int, buckets: tuple[int, ...], multiple: int = 1) -> int:
    """Smallest bucket >= max(n, multiple) that is a multiple of
    ``multiple``; past every such bucket, the larger of the largest bucket
    and n, rounded up to the multiple."""
    lo = max(n, multiple)
    for b in sorted(buckets):
        if b >= lo and b % multiple == 0:
            return b
    return int(math.ceil(max(buckets + (lo,)) / multiple)) * multiple


def _stack(entries: list):
    """Per-row prefix entries ``[1, P, ...]`` (or int8 and scale pairs of
    them) stacked along the batch."""
    if isinstance(entries[0], tuple):
        return tuple(torch.cat([e[i] for e in entries]) for i in range(len(entries[0])))
    return torch.cat(entries)


def _copy_prefixes(static: dict, prefixes: list[dict], b: int) -> None:
    """Per-row prefix K/V (one entry for every row, or one per row) into a
    prefixed graph's static ``{"k", "v"}`` inputs ``[b, P, ...]``."""
    rows = [(slice(0, b), prefixes[0])] if len(prefixes) == 1 else [
        (slice(r, r + 1), p) for r, p in enumerate(prefixes)]
    for name in ("k", "v"):
        for li, dst in enumerate(static[name]):
            for sl, p in rows:
                src = p[name][li]
                for d, x in (zip(dst, src) if isinstance(dst, tuple) else [(dst, src)]):
                    d[sl].copy_(x)


class InferenceEngine:
    """Owns the model's device and runs formed batches on it."""

    def __init__(self, bundle: ModelBundle, cfg):
        self.bundle = bundle
        self.cfg = cfg
        self.device = bundle.device
        self.batch_buckets = tuple(cfg.batch_buckets)
        self.seq_buckets = tuple(cfg.seq_buckets)
        # Sequence-parallel placement (bert-long): batches go to the forward
        # as sequence shards, and seq buckets round to its shard count.
        self.placement = getattr(bundle, "placement", None)
        self.seq_multiple = self.placement.seq_multiple() if self.placement else 1
        # Images have no sequence: only a text model's prompts bound the
        # seq buckets.
        limit = None
        if getattr(bundle, "kind", None) != KIND_IMAGE:
            limit = getattr(bundle, "max_prompt_len", None) or bundle.cfg.max_position
        if limit is not None and max(self.seq_buckets) > limit:
            raise ValueError(
                f"SEQ_BUCKETS {cfg.seq_buckets} exceed the model's {limit} positions "
                "for a prompt"
            )
        # Generation: decode steps per chunk, and the decode budget rounded
        # up to whole chunks (the width of every generation's cache).
        self.chunk_tokens = cfg.stream_chunk_tokens
        self.max_decode_len = decode_budget(cfg)
        # One dispatch at a time: it serializes this engine's batches and
        # its loop's chunks (on the card, every engine's: see below).
        self._lock = threading.Lock()
        # CUDA graphs on the card when every shard of the placement sits on
        # one device; else eager, and why.
        devices = self.placement.devices if self.placement else [self.device]
        self.placement_key = compile_cache.placement_key(devices)
        self.graphs: compile_cache.GraphCache | None = None
        self.eager_reason = None
        if self.device.type != "cuda":
            self.eager_reason = f"{self.device.type} has no CUDA graphs"
        elif len(set(devices)) > 1:
            self.eager_reason = (f"placement spans {len(set(devices))} cards (multi-card "
                                 "capture is not ported)")
        else:
            self.graphs = compile_cache.CACHE
            # Every engine on the card replays into its one graph pool,
            # whose outputs are valid until the pool's next replay: they
            # all dispatch under the pool's lock.
            self._lock = compile_cache.device_lock(self.device)
        # Dispatches (forwards, or generations) and decode steps run since
        # start or the last reset: the counters kernel launch counts are
        # held against.
        self.dispatches = 0
        self.decode_steps = 0
        self.last_decode_steps = 0
        # Block-paged KV of the continuous loop (PAGED_KV=1).
        self.paged_kv = bool(cfg.paged_kv)
        self.kv_block_size = int(cfg.kv_block_size)
        self.kv_pool = None
        if self.paged_kv:
            # A worst-case stream's blocks (the largest seq bucket and the
            # decode budget), and a pool of KV_BUDGET_MB's blocks, else of
            # MAX_STREAMS of those.  The loop's table width is its own: under
            # PREFILL_CHUNK it covers the position budget, while the pool
            # stays sized off the largest bucket, as in the reference.
            self.kv_blocks_per_stream = blocks_for(
                max(self.seq_buckets) + self.max_decode_len, self.kv_block_size)
            bb = self.kv_block_bytes()
            budget = int(float(getattr(cfg, "kv_budget_mb", 0.0) or 0.0) * 1e6)
            num = (max(1, budget // bb) if budget
                   else cfg.max_streams * self.kv_blocks_per_stream)
            self.kv_pool = BlockPool(num, bb)
        # The host KV tier (KV_HOST_BUDGET_MB > 0, generators): a
        # checkpointed stream's blocks swap out to pinned host buffers and
        # its resume prefetches them back (``engine/streams.py``), and an
        # evicted prefix pin is demoted there instead of freed.  It swaps
        # paged blocks, so it needs PAGED_KV, refused here as the reference
        # refuses it.  Demotions queue here (``on_evict`` may run under the
        # cache's lock, where nothing copies) for the loop to gather at its
        # next chunk boundary; a flush of pins whose blocks are about to be
        # cleared turns ``_host_demote_on`` off around it.
        self.kv_host = None
        self._host_demote_pending: list = []
        self._host_demote_on = True
        host_mb = float(getattr(cfg, "kv_host_budget_mb", 0.0) or 0.0)
        if host_mb > 0 and getattr(bundle, "kind", None) == KIND_SEQ2SEQ:
            if not self.paged_kv:
                raise ValueError(
                    "KV_HOST_BUDGET_MB requires PAGED_KV=1 (the host "
                    "tier swaps paged blocks; the contiguous layout "
                    "has no block identity to swap)"
                )
            self.kv_host = KVHostTier(host_mb, self.kv_block_bytes())
        # The disk KV tier under the host tier (KV_DISK_BUDGET_MB > 0,
        # generators): the host LRU's victims spill to memmap files under
        # JOURNAL_DIR/kv_disk, and checkpoints write through, so a resume
        # outlives the process (``runtime/durability.py``).  One tier per
        # directory per process (``get_disk_tier``).  The journal is the
        # batcher's (one per process), attached here; the supervisor's
        # in-place rebuild keeps both, since a rebuild is not a restart.
        self.kv_disk = None
        self.journal = None
        disk_mb = float(getattr(cfg, "kv_disk_budget_mb", 0.0) or 0.0)
        if disk_mb > 0 and getattr(bundle, "kind", None) == KIND_SEQ2SEQ:
            jdir = getattr(cfg, "journal_dir", None)
            if not jdir:
                raise ValueError(
                    "KV_DISK_BUDGET_MB requires JOURNAL_DIR (the "
                    "disk tier persists under the journal directory)"
                )
            if self.kv_host is None:
                raise ValueError(
                    "KV_DISK_BUDGET_MB requires PAGED_KV=1 and "
                    "KV_HOST_BUDGET_MB>0 (the disk tier sits BELOW "
                    "the host-RAM tier in the offload hierarchy)"
                )
            from ..runtime.durability import get_disk_tier

            self.kv_disk = get_disk_tier(disk_mb, self.kv_block_bytes(),
                                         os.path.join(jdir, "kv_disk"))
            self.kv_disk.model = bundle.name
        # Chunked prefill (PREFILL_CHUNK > 0, the decoder families): the
        # continuous loop prefills long prompts in windows between its
        # decode chunks (``engine/streams.py``).  Refused here, before
        # readiness, where it would silently serve monolithic.
        self.prefill_chunk = int(getattr(cfg, "prefill_chunk", 0) or 0)
        if self.prefill_chunk:
            if bundle.prefill_chunk is None:
                raise ValueError(
                    f"PREFILL_CHUNK is not supported for {bundle.name!r} "
                    "(chunked prefill covers the decoder families: gpt2, llama)"
                )
            if self.global_prefix_len() > 0:
                raise ValueError(
                    "PREFILL_CHUNK and PROMPT_PREFIX are mutually "
                    "exclusive (the global prefix overlay is seeded "
                    "by init_decode_state, which chunked prefill "
                    "bypasses); use PREFIX_CACHE=1"
                )
            if self.paged_kv and self.prefill_chunk % self.kv_block_size:
                raise ValueError(
                    f"PREFILL_CHUNK={self.prefill_chunk} must be a "
                    f"multiple of KV_BLOCK_SIZE={self.kv_block_size} "
                    "(block-aligned window boundaries keep per-chunk "
                    "block growth exact)"
                )
        # The per-request prefix cache (PREFIX_CACHE=1, decoder families
        # without a global PROMPT_PREFIX).  Paged, its entries are pins on
        # the pool's blocks, and an eviction frees the pin's refs.
        self.prefix_cache = None
        if (getattr(cfg, "prefix_cache", False) and bundle.supports_prefix
                and getattr(bundle, "prompt_prefix", None) is None):
            on_evict = None
            if self.paged_kv:
                def on_evict(entry, key=None):
                    if not isinstance(entry, PagedPrefix):
                        return
                    if self.kv_host is not None and key is not None and self._host_demote_on:
                        # The pin's refs go with it to the loop's demotion
                        # queue and free once its blocks are on the host.
                        self._host_demote_pending.append((key, entry))
                        return
                    self.kv_pool.free(list(entry.block_ids))

            self.prefix_cache = PrefixCache(
                self.seq_buckets, float(getattr(cfg, "prefix_cache_mb", 256.0)),
                on_evict=on_evict)
        # Speculative decoding (SPEC_DECODE=ngram, a family with verify
        # windows), and the per-stream streams live now, whose count gates it
        # on the per-stream path.
        self.spec_enabled = bool(cfg.spec_decode == "ngram"
                                 and getattr(bundle, "spec_chunk", None) is not None)
        self.spec_k = int(cfg.spec_k)
        self.spec_sampled = self.spec_enabled and bool(cfg.spec_sampled)
        self.spec_rounds = 0
        self._live_streams = 0
        self._live_streams_lock = threading.Lock()
        # The LoRA adapter pool (``tenancy/adapters.py``) under ADAPTER_DIR,
        # set by the batcher: the continuous loop's starts then run through
        # its overlay (``start``'s ``rows``), in graphs of their own.
        self.adapters = None
        # Static per-layer prefix K/V of the prefixed starts' graphs, one
        # set per (batch, prefix length), shared by the graphs of that pair;
        # and the prefix grid's warm accounting (``_warm_prefixed``).
        self._prefix_inputs: dict[tuple[int, int], dict] = {}
        self.prefix_warm: dict | None = None
        # On the CPU the engine's own lock serializes its dispatches, held
        # across each as the card's pool lock is (``device_lock`` registers
        # that one with the lock-order detector).
        if self.graphs is None:
            locktrace.allow_across_dispatch(self._lock)
        # Observability: TRACE=1 installs the process tracer if none is (a
        # second engine without the knob leaves the first's on); the flight
        # recorder rides on the engine whatever TRACE says.
        if getattr(cfg, "trace", False) and tracing.tracer() is None:
            tracing.configure(True, int(getattr(cfg, "trace_ring", 4096)))
        self.flight = tracing.FlightRecorder(int(getattr(cfg, "flight_ring", 256)))
        # Host dispatch and fetch boundaries by site (``batch``, ``prefill``,
        # ``chunk``, ``fetch``, ``prefill_chunk``, ``prep``, ...), the JAX
        # engine's per-site accounting: {site: [count, host seconds, device
        # seconds]}, the device half only under TRACE=1.  Its counts are what
        # a fused decode window divides (``dispatch_counts``).
        self.dispatch_stats: dict[str, list] = {}
        self._dispatch_stats_lock = threading.Lock()
        # The perf observatory: device busy / bubble from submit stamps and
        # the loop's fetch seams; the process switch also gates the graph
        # cache's cost count.
        perf_on = bool(getattr(cfg, "perf_obs", True))
        perfobs.configure(perf_on)
        self.perf = perfobs.DeviceOccupancy(bundle.name, enabled=perf_on,
                                            peak_flops=perfobs.peak_flops(cfg))
        # Fault injection and the dispatch watchdog (FAULT_SPEC; the port is
        # one engine, replica 0).
        self.faults = FaultInjector.from_spec(getattr(cfg, "fault_spec", None),
                                              int(getattr(cfg, "fault_seed", 0) or 0))
        self.watchdog = Watchdog(
            bundle.name,
            timeout_s=float(getattr(cfg, "dispatch_timeout_s", 0.0) or 0.0),
            retries=int(getattr(cfg, "dispatch_retries", 2)),
            backoff_s=float(getattr(cfg, "dispatch_backoff_s", 0.05)),
            injector=self.faults, recorder=self.flight)

    def note_dispatch(self, site: str, host_s: float | None = None,
                      device_s: float | None = None) -> None:
        """Count one host dispatch or fetch boundary at ``site`` and, given
        the host seconds the call took (``time.perf_counter`` around it, no
        synchronisation added), observe them in ``dispatch_host_seconds``;
        ``dispatch_stats`` keeps the count with the host and (``TRACE=1``)
        device seconds."""
        if host_s is not None:
            metrics.DISPATCH_HOST.labels(self.bundle.name, site).observe(host_s)
        with self._dispatch_stats_lock:
            st = self.dispatch_stats.setdefault(site, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += host_s or 0.0
            st[2] += device_s or 0.0

    @property
    def dispatch_counts(self) -> dict[str, int]:
        """Dispatches and fetches so far by site (``/status.decode``)."""
        with self._dispatch_stats_lock:
            return {site: st[0] for site, st in self.dispatch_stats.items()}

    def dispatch_attribution(self) -> dict:
        """Per-site dispatch accounting: ``{site: {count, host_s,
        host_ms_avg, device_s}}``; ``device_s`` stays 0.0 unless ``TRACE=1``
        measured it."""
        out = {}
        with self._dispatch_stats_lock:
            for site, (n, host, dev) in sorted(self.dispatch_stats.items()):
                out[site] = {"count": n, "host_s": round(host, 4),
                             "host_ms_avg": round(host / n * 1e3, 3) if n else 0.0,
                             "device_s": round(dev, 4)}
        return out

    def dispatch_guard(self, site: str, fn):
        """Run one dispatch (or fetch) ``fn`` under the fault injector and
        the watchdog, and count it at ``site`` with its host seconds.  A
        fault fires before ``fn`` touches the device, so a retried
        transient dispatches once.

        The perf observatory's submit stamp reuses the two clock reads.
        Under ``TRACE=1`` a ``dispatch:{site}`` span also measures the
        device half by synchronizing the engine's stream after ``fn``
        returns (the reference's ``block_until_ready``): an attribution mode
        that serializes the loop's pipeline."""
        if locktrace.is_active():
            locktrace.note_dispatch(site)
        tr = tracing.tracer()
        if tr is None:
            t0 = time.perf_counter()
            out = self.watchdog.run(site, fn)
            t1 = time.perf_counter()
            self.note_dispatch(site, t1 - t0)
            self.perf.on_guard(site, t0, t1)
            return out
        with tr.span(f"dispatch:{site}", cat="dispatch") as sp:
            t0 = time.perf_counter()
            out = self.watchdog.run(site, fn)
            host_s = time.perf_counter() - t0
            self.perf.on_guard(site, t0, t0 + host_s)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            device_s = time.perf_counter() - t0 - host_s
            sp.set(host_ms=round(host_s * 1e3, 3), device_ms=round(device_s * 1e3, 3))
            self.note_dispatch(site, host_s, device_s)
        return out

    def fault_point(self, site: str) -> None:
        """Bare injection point for a boundary that is not a dispatch (the
        paged allocator's ``grow``: an injected ``OutOfBlocks`` takes the
        checkpoint-and-requeue path)."""
        if self.faults is not None:
            self.faults.fire(site)

    def reset_device_state(self) -> None:
        """The device half of a supervised rebuild, in place.  The reference
        re-creates the paged pool and re-places the params, because its
        executables take buffers as arguments; the port's graphs replay
        fixed addresses, so the pools, the params and the pinned buffers
        stay where they are, and what named the torn-down state goes: the
        prefix cache is flushed (its pins' refs return to the pool, with no
        demotion) and the demotions still queued return theirs.  The loop
        resets its slot state in place and has already returned every
        stream's blocks."""
        self._host_demote_on = False
        try:
            if self.prefix_cache is not None:
                self.prefix_cache.flush()
        finally:
            self._host_demote_on = True
        pending, self._host_demote_pending = self._host_demote_pending, []
        for _key, entry in pending:
            self.kv_pool.free(list(entry.block_ids))

    def budget_for(self, feats: dict) -> int:
        """One stream's token budget: its max_tokens clamped to the
        server's decode budget."""
        return min(int(feats.get("max_tokens", self.max_decode_len)), self.max_decode_len)

    def kv_token_bytes(self) -> int:
        """KV bytes one token position costs (scales in the compute type
        under the int8 cache)."""
        c = self.bundle.cfg
        elt = torch.empty(0, dtype=self.bundle.policy.compute_dtype).element_size()
        return kv_token_bytes(c.num_layers, c.num_kv_heads, c.head_dim, elt, c.kv_quant,
                              scale_bytes=elt)

    def kv_block_bytes(self) -> int:
        """Bytes one ``KV_BLOCK_SIZE``-token block costs."""
        return self.kv_token_bytes() * self.kv_block_size

    def global_prefix_len(self) -> int:
        """Positions a global ``PROMPT_PREFIX`` takes in every generation's
        cache (0 without one)."""
        pre = self.bundle.prompt_prefix
        return 0 if pre is None else prefix_len(pre["k"][0])

    def kv_bytes_estimate(self, feats: dict) -> int:
        """Admission-time ceiling of one request's KV footprint in bytes:
        a global prefix's positions, its prompt bucket and the server's
        decode budget (an encoder-decoder adds its cross-attention K/V over
        the encoder bucket).  A ceiling, so the budget fails safe; under
        ``PAGED_KV=1`` the block ledger (``kv_blocks_estimate``) takes its
        place for streams."""
        if self.bundle.kind != KIND_SEQ2SEQ:
            return 0
        s = bucket_for(max(int(feats.get("length", 0) or 0), 1), self.seq_buckets,
                       self.seq_multiple)
        per_tok = self.kv_token_bytes()
        total = (self.global_prefix_len() + s + self.max_decode_len) * per_tok
        if getattr(self.bundle.cfg, "d_kv", None) is not None:
            total += s * per_tok
        return int(total)

    def chunked_prefill_applies(self, length: int) -> bool:
        """Whether the continuous loop prefills a prompt of ``length``
        tokens in PREFILL_CHUNK windows: chunked prefill is on and the
        prompt is longer than one window or than the largest seq bucket.
        One predicate for the loop's routing and the admission ledger, so
        the two cannot drift."""
        return bool(self.prefill_chunk) and (
            int(length) > self.prefill_chunk or int(length) > max(self.seq_buckets))

    def kv_blocks_estimate(self, feats: dict) -> tuple[int, int]:
        """Paged mode's exact ledger for one stream: (initial, worst)
        blocks.  ``initial`` covers the prompt bucket and the first chunk,
        what admission charges up front; ``worst`` the request's own decode
        budget in whole chunks, the bound past which it can never fit.
        A chunked prompt's ``initial`` is its first window (the loop grows
        the rest window by window, and a stream checkpointed mid-prefill
        reserves the same again) and its ``worst`` grows off its exact
        length, not the padded bucket."""
        length = max(int(feats.get("length", 0) or 0), 1)
        s = bucket_for(length, self.seq_buckets, self.seq_multiple)
        budget = -(-self.budget_for(feats) // self.chunk_tokens) * self.chunk_tokens
        if self.chunked_prefill_applies(length):
            initial = blocks_for(min(length, self.prefill_chunk), self.kv_block_size)
            worst = blocks_for(length + budget, self.kv_block_size)
        else:
            initial = blocks_for(s + self.chunk_tokens, self.kv_block_size)
            worst = blocks_for(s + budget, self.kv_block_size)
        return initial, max(initial, worst)

    def _collate_images(self, feats: list[dict]) -> tuple[torch.Tensor, int]:
        """A uint8 [bsz, S, S, 3] batch at the batch bucket, written straight
        into pinned host memory when the model is on the card (the copy to
        it then runs without a staging copy)."""
        n = len(feats)
        bsz = bucket_for(n, self.batch_buckets)
        size = self.bundle.image_size
        out = torch.empty((bsz, size, size, 3), dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        arr = out.numpy()
        for i, f in enumerate(feats):
            arr[i] = f["image"]
        arr[n:] = 0
        return out, n

    def graph_modes(self) -> dict[str, str]:
        """Per graph kind this engine dispatches: ``"graph"``, or
        ``"eager: <reason>"``."""
        loop = ("loop_chunk_paged" if self.paged_kv
                else "loop_spec_chunk" if self.spec_enabled and self.cfg.spec_continuous
                else "loop_chunk")
        kinds = {KIND_IMAGE: ("forward_images",), KIND_TEXT: ("forward",),
                 KIND_SEQ2SEQ: ("start", "gen_chunk", loop)
                 + (("start_prefixed",) if self.prefix_cache is not None else ())
                 + (("prefill_window_paged" if self.paged_kv else "prefill_window",)
                    if self.prefill_chunk else ())
                 + (("spec_start", "spec_chunk", "full_spec", "full_spec_chunk")
                    if self.spec_enabled else ())
                 + (("spec_start_prefixed",)
                    if self.spec_enabled and self.prefix_cache is not None else ())}
        mode = "graph" if self.graphs is not None else f"eager: {self.eager_reason}"
        return {kind: mode for kind in kinds.get(self.bundle.kind, ())}

    def _graph(self, kind: str, shape: tuple, sample: bool | None,
               make, lora: bool = False) -> compile_cache.GraphEntry:
        """This bundle's graph of ``kind`` for a bucket ``shape`` (a
        generation's: its greedy or ``sample`` variant; ``lora``: the one
        over the adapter pool's overlay), captured from ``make()`` on a
        miss; the caller holds ``_lock``."""
        dtype = str(self.bundle.policy.compute_dtype).split(".")[-1]
        quant = "int8" if getattr(self.bundle.cfg, "kv_quant", False) else "none"
        variant = () if sample is None else ("sample" if sample else "greedy",)
        adapted = ("lora",) if lora else ()
        return self.graphs.get(self.bundle, kind, (*shape, *variant, dtype, quant, *adapted),
                               self.placement_key, make)

    # -- LoRA adapters (ADAPTER_DIR) ---------------------------------------

    def _slot_rows(self, rows: list[int], b: int) -> torch.Tensor:
        """A dispatch's per-row adapter slots on the host, int64 [b]: the
        given rows, then bucket-padding rows on the zero slot."""
        out = torch.zeros(b, dtype=torch.long)
        out[: len(rows)] = torch.tensor(rows, dtype=torch.long)
        return out

    def _adapter_kw(self, rows_dev: torch.Tensor | None) -> dict:
        """The ``adapters=`` keyword of the bundle's generation callables:
        the pool's overlay over the device rows ``rows_dev``, or nothing
        (the base model) without them."""
        return {} if rows_dev is None else {"adapters": self.adapters.overlay(rows_dev)}

    def _forward_images(self, images: torch.Tensor) -> np.ndarray:
        with self._lock, torch.inference_mode():
            if self.graphs is None:
                logits = self.bundle.forward(images.to(self.device, non_blocking=True))
            else:
                entry = self._graph("forward_images", tuple(images.shape), None,
                                    lambda: self._make_images(tuple(images.shape)))
                entry.inputs.copy_(images, non_blocking=True)
                entry.replay()
                logits = entry.outputs
            self.dispatches += 1
            return logits.to(self.bundle.policy.output_dtype).cpu().numpy()

    def _make_images(self, shape: tuple):
        x = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        return (lambda: self.bundle.forward(x)), x, self.device

    def _collate_text(self, feats: list[dict]) -> tuple[np.ndarray, np.ndarray, int]:
        n = len(feats)
        bsz = bucket_for(n, self.batch_buckets)
        max_len = max(int(f["length"]) for f in feats)
        seq = bucket_for(max_len, self.seq_buckets, self.seq_multiple)
        ids = np.zeros((bsz, seq), np.int32)
        mask = np.zeros((bsz, seq), np.int32)
        for i, f in enumerate(feats):
            L = int(f["length"])
            ids[i, :L] = f["input_ids"][:L]
            mask[i, :L] = 1
        return ids, mask, n

    def _collate_budget(self, feats: list[dict], bsz: int) -> np.ndarray:
        """Per-row decode budgets: a request's max_tokens clamped to the
        server's budget; padding rows 0."""
        budgets = np.zeros(bsz, np.int32)
        for i, f in enumerate(feats):
            budgets[i] = min(int(f.get("max_tokens", self.max_decode_len)),
                             self.max_decode_len)
        return budgets

    def _collate_sample(self, feats: list[dict], bsz: int) -> tuple[SampleParams, bool]:
        """Per-row ``SampleParams`` (on the CPU) from the request fields;
        bucket-padding rows are greedy.  Returns them and whether any row
        samples, which picks the sampled graphs (an all-greedy batch never
        pays the per-step sort and threefry)."""
        temp = np.zeros(bsz, np.float32)
        top_k = np.zeros(bsz, np.int32)
        top_p = np.ones(bsz, np.float32)
        seed = np.zeros(bsz, np.uint32)
        sampled = False
        for i, f in enumerate(feats):
            t = float(f.get("temperature", 0.0))
            temp[i] = t
            if t > 0.0:
                sampled = True
                top_k[i] = int(f.get("top_k", 0))
                top_p[i] = float(f.get("top_p", 1.0))
                s = f.get("seed")
                # Unseeded sampled requests must differ from each other; the
                # mask keeps one bad row from failing a shared batch.
                s = int(s) if s is not None else random.getrandbits(32)
                seed[i] = np.uint32(s & 0xFFFFFFFF)
        params = make_params(seed, temp, top_k, top_p)
        skips = [int(f.get("rng_skip", 0)) for f in feats]
        if any(skips):
            # A recast resume's key chain continues past the steps that drew
            # the tokens folded into its prompt (``engine/streams.py``).
            params.rng = advance(params.rng, skips)
        return params, sampled

    def _shards(self, a: np.ndarray) -> list[np.ndarray]:
        """A [B, S] host array as the placement's sequence shards (one
        shard without a placement)."""
        n = len(self.placement.devices) if self.placement is not None else 1
        return np.split(a, n, axis=1)

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with self._lock, torch.inference_mode():
            if self.graphs is not None:
                entry = self._graph("forward", ids.shape, None,
                                    lambda: self._make_forward(ids.shape))
                for static, host in zip(entry.inputs, (ids, mask)):
                    for dst, part in zip(static, self._shards(host)):
                        dst.copy_(torch.from_numpy(np.ascontiguousarray(part)),
                                  non_blocking=True)
                entry.replay()
                logits = entry.outputs
            elif self.placement is not None:  # lists of sequence shards
                logits = self.bundle.forward(self.placement.place_batch(ids),
                                             self.placement.place_batch(mask))
            else:
                logits = self.bundle.forward(
                    torch.from_numpy(ids).to(self.device, non_blocking=True),
                    torch.from_numpy(mask).to(self.device, non_blocking=True))
            self.dispatches += 1
            return logits.to(self.bundle.policy.output_dtype).cpu().numpy()

    def _make_forward(self, shape: tuple):
        """Static [B, S] ids and mask (lists of sequence shards under a
        placement) and the forward over them."""
        b, s = shape
        devices = self.placement.devices if self.placement is not None else [self.device]
        ids, mask = ([torch.ones((b, s // len(devices)), dtype=torch.int32, device=d)
                      for d in devices] for _ in range(2))
        if self.placement is not None:
            return (lambda: self.bundle.forward(ids, mask)), (ids, mask), self.device
        return (lambda: self.bundle.forward(ids[0], mask[0])), (ids, mask), self.device

    def _make_start(self, shape: tuple, sample: bool, lora: bool = False):
        """Static [B, S] ids and mask and per-row ``SampleParams`` (with
        ``lora`` a static [B] of adapter slots too, the pool's overlay over
        it), and prefill plus the first chunk over them (``sample``: the
        sampled variant); the outputs are (state, tokens [B, chunk])."""
        ids, mask = (torch.ones(shape, dtype=torch.int32, device=self.device) for _ in range(2))
        sp = greedy_params(shape[0], self.device)
        rows = torch.zeros(shape[0], dtype=torch.long, device=self.device) if lora else None
        kw = self._adapter_kw(rows)

        def start():
            state = self.bundle.init_state(ids, mask, self.max_decode_len, sample=sp, **kw)
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample, **kw)

        return start, (ids, mask, sp) + ((rows,) if lora else ()), self.device

    def _start_graph(self, shape: tuple, sample: bool,
                     lora: bool = False) -> compile_cache.GraphEntry:
        """The ``start`` graph of a bucket ``(B, S)``, or the
        ``start_prefixed`` graph of ``(B, P, S)`` (``lora``: over the adapter
        overlay)."""
        if len(shape) == 3:
            return self._graph("start_prefixed", shape, sample,
                               lambda: self._make_start_prefixed(shape, sample, lora), lora)
        return self._graph("start", shape, sample, lambda: self._make_start(shape, sample, lora),
                           lora)

    def _make_gen_chunk(self, shape: tuple, sample: bool):
        """One decode chunk over the state of the bucket's start graph
        (``_start_graph``: a prefixed one for a ``(B, P, S)`` shape) of the
        same variant, which is replayed first, so the eager warm run reads a
        real state; the output is the chunk's tokens."""
        entry = self._start_graph(shape, sample)
        entry.replay()
        state = entry.outputs[0]

        def chunk():
            state.steps = self.chunk_tokens  # as after start
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample)[1]

        return chunk, state, self.device

    def _start(self, ids: np.ndarray, mask: np.ndarray, sp: SampleParams, sample: bool,
               rows: list[int] | None = None):
        """Prefill plus the first decode chunk of a collated batch (with
        ``rows``, each row's adapter slot, through the pool's LoRA overlay:
        the continuous loop's admissions under ADAPTER_DIR); returns
        (state, tokens [B, chunk]).  On the card the state is the bucket's
        static one, valid until the next replay.  The caller holds
        ``_lock`` inside ``torch.inference_mode``."""
        lora = rows is not None
        slots = self._slot_rows(rows, ids.shape[0]) if lora else None
        if self.graphs is None:
            kw = self._adapter_kw(None if slots is None else slots.to(self.device))
            state = self.bundle.init_state(torch.from_numpy(ids).to(self.device),
                                           torch.from_numpy(mask).to(self.device),
                                           self.max_decode_len, sample=sp.to(self.device),
                                           **kw)
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample, **kw)
        entry = self._graph("start", ids.shape, sample,
                            lambda: self._make_start(ids.shape, sample, lora), lora)
        for dst, host in zip(entry.inputs, (ids, mask)):
            dst.copy_(torch.from_numpy(host), non_blocking=True)
        entry.inputs[2].copy_(sp)
        if lora:
            entry.inputs[3].copy_(slots, non_blocking=True)
        entry.replay()
        state, toks = entry.outputs
        state.steps = self.chunk_tokens
        return state, toks

    # -- the prefix cache's starts ---------------------------------------

    def _prefix_guard(self, length: int):
        """``usable(P)`` for a prompt of ``length`` tokens: the suffix's
        bucket and the prefix fit the largest seq bucket (the loop's slots),
        and prefix, suffix and decode fit the position table."""
        s_max = max(self.seq_buckets)
        max_pos = int(getattr(self.bundle.cfg, "max_position", 1 << 30))

        def usable(p_len: int) -> bool:
            s_suf = bucket_for(max(length - p_len, 1), self.seq_buckets, self.seq_multiple)
            return p_len + s_suf <= s_max and p_len + s_suf + self.max_decode_len <= max_pos

        return usable

    def _capture_prefix(self, state, p_len: int, row: int = 0) -> dict:
        """A prefix-cache entry from a fresh prefill: rows ``[0, p_len)`` of
        batch row ``row`` of each layer's cache, cloned (int8 payload and
        scale under the int8 cache), so it outlives the state, which the
        bucket's next replay overwrites.  The caller holds ``_lock``."""
        def cut(c):
            if isinstance(c, tuple):
                return tuple(x[row:row + 1, :p_len].clone() for x in c)
            return c[row:row + 1, :p_len].clone()

        return {"k": [cut(c) for c in state.cache_k], "v": [cut(c) for c in state.cache_v]}

    def _prefix_input(self, b: int, p_len: int) -> dict:
        """The static per-layer prefix K/V ``[b, p_len, KVH, D]`` (int8 and
        scale pairs under the int8 cache) of the prefixed starts' graphs,
        allocated once per pair, outside the graph pool."""
        key = (b, p_len)
        if key not in self._prefix_inputs:
            c = self.bundle.cfg
            shape = (b, p_len, c.num_kv_heads, c.head_dim)
            dtype = self.bundle.policy.compute_dtype

            def entry():
                if c.kv_quant:
                    return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                            torch.ones(shape[:3] + (1,), dtype=dtype, device=self.device))
                return torch.zeros(shape, dtype=dtype, device=self.device)

            self._prefix_inputs[key] = {"k": [entry() for _ in range(c.num_layers)],
                                        "v": [entry() for _ in range(c.num_layers)]}
        return self._prefix_inputs[key]

    def _make_start_prefixed(self, shape: tuple, sample: bool, lora: bool = False):
        """Static suffix ids and mask ``[B, S]``, per-row ``SampleParams``
        and prefix K/V ``[B, P, ...]`` (with ``lora`` static adapter slots
        [B] too), and the suffix prefill behind that prefix plus the first
        chunk over them; the outputs are (state, tokens [B, chunk])."""
        b, p_len, s = shape
        ids, mask = (torch.ones((b, s), dtype=torch.int32, device=self.device) for _ in range(2))
        sp = greedy_params(b, self.device)
        prefix = self._prefix_input(b, p_len)
        rows = torch.zeros(b, dtype=torch.long, device=self.device) if lora else None
        kw = self._adapter_kw(rows)

        def start():
            state = self.bundle.init_state(ids, mask, self.max_decode_len, sample=sp,
                                           prefix_kv=prefix, **kw)
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample, **kw)

        return start, (ids, mask, sp, prefix) + ((rows,) if lora else ()), self.device

    def _start_prefixed(self, prefixes: list[dict], ids: np.ndarray, mask: np.ndarray,
                        sp: SampleParams, sample: bool, rows: list[int] | None = None):
        """Prefill of a batch of suffixes, row ``r`` behind ``prefixes[r]``
        (one per row, or one for them all: ``[1, P, ...]`` entries), plus
        the first decode chunk; returns (state, tokens [B, chunk]).  On the
        card the state is the ``start_prefixed`` graph's static one, valid
        until its next replay.  The caller holds ``_lock`` inside
        ``torch.inference_mode``."""
        b = ids.shape[0]
        p_len = prefix_len(prefixes[0]["k"][0])
        lora = rows is not None
        slots = self._slot_rows(rows, b) if lora else None
        if self.graphs is None:
            prefix = prefixes[0] if len(prefixes) == 1 else {
                name: [_stack([p[name][li] for p in prefixes])
                       for li in range(len(prefixes[0][name]))]
                for name in ("k", "v")}
            kw = self._adapter_kw(None if slots is None else slots.to(self.device))
            state = self.bundle.init_state(torch.from_numpy(ids).to(self.device),
                                           torch.from_numpy(mask).to(self.device),
                                           self.max_decode_len, sample=sp.to(self.device),
                                           prefix_kv=prefix, **kw)
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample, **kw)
        shape = (b, p_len, ids.shape[1])
        entry = self._start_graph(shape, sample, lora)
        for dst, host in zip(entry.inputs, (ids, mask)):
            dst.copy_(torch.from_numpy(host), non_blocking=True)
        entry.inputs[2].copy_(sp)
        _copy_prefixes(entry.inputs[3], prefixes, b)
        if lora:
            entry.inputs[4].copy_(slots, non_blocking=True)
        entry.replay()
        state, toks = entry.outputs
        state.steps = self.chunk_tokens
        return state, toks

    def start_fused(self, feats: dict, width: int | None = None):
        """Prefill plus the first decode chunk of ONE stream, through the
        prefix cache when it is on: a hit prefills only the suffix behind
        the cached prefix, a miss prefills the whole prompt (collated at
        ``width`` when given: the per-stream path's long prompts) and
        donates its longest bucket prefix; a hit donates too when the
        prompt now covers a longer bucket (a growing conversation).  Paged,
        the cache's entries are the loop's pins: this contiguous path
        neither reads nor feeds them.  Returns (state, tokens [1, chunk],
        sampled, shape): ``shape`` keys the state's per-stream chunk graph
        (``(1, S)``, or ``(1, P, S)`` after a hit).  The caller holds
        ``_lock`` inside ``torch.inference_mode``."""
        length = int(feats["length"])
        row_ids = np.asarray(feats["input_ids"], np.int32)[:length]
        cache = None if self.paged_kv else self.prefix_cache
        if cache is not None:
            m = cache.match(row_ids, length, usable=self._prefix_guard(length))
            if m is not None:
                p_len, prefix = m
                sfeats = dict(feats, input_ids=row_ids[p_len:], length=np.int32(length - p_len))
                ids, mask, _ = self._collate_text([sfeats])
                sp, sampled = self._collate_sample([feats], ids.shape[0])
                state, toks = self._start_prefixed([prefix], ids, mask, sp, sampled)
                p_ins = cache.bucket_for_insert(length)
                if p_ins is not None and p_ins > p_len and not cache.contains(row_ids, p_ins):
                    cache.insert(row_ids, p_ins, self._capture_prefix(state, p_ins))
                return state, toks, sampled, (1, p_len, ids.shape[1])
        ids, mask, _ = self._collate_text([feats])
        if width is not None and width > ids.shape[1]:
            pad = ((0, 0), (0, width - ids.shape[1]))
            ids, mask = np.pad(ids, pad), np.pad(mask, pad)
        sp, sampled = self._collate_sample([feats], ids.shape[0])
        state, toks = self._start(ids, mask, sp, sampled)
        if cache is not None:
            p_ins = cache.bucket_for_insert(length)
            if p_ins is not None and not cache.contains(row_ids, p_ins):
                cache.insert(row_ids, p_ins, self._capture_prefix(state, p_ins))
        return state, toks, sampled, ids.shape

    def prefixed_grid(self) -> list[tuple[int, int]]:
        """The (prefix bucket, suffix bucket) pairs a hit can use
        (``_prefix_guard``)."""
        s_max = max(self.seq_buckets)
        max_pos = int(getattr(self.bundle.cfg, "max_position", 1 << 30))
        return [(p, s) for p in self.seq_buckets for s in self.seq_buckets
                if p + s <= s_max and p + s + self.max_decode_len <= max_pos]

    def prefixed_batches(self) -> tuple[int, ...]:
        """Batch sizes of the prefixed starts: 1, and the slot count's
        bucket for the continuous loop's grouped hit waves."""
        if not self.cfg.continuous_batching:
            return (1,)
        return tuple(sorted({1, bucket_for(self.cfg.max_streams, self.batch_buckets)}))

    def _warm_spec(self, ids: np.ndarray, variants) -> None:
        """The speculative graphs of a (B, S) bucket, each variant: at B = 1
        the per-stream ``spec_start`` and ``spec_chunk``, and at every batch
        bucket a batch of at most ``SPEC_MAX_STREAMS`` rows collates to the
        non-streaming ``full_spec`` and ``full_spec_chunk``; on the CPU the
        same calls run (the caller holds ``_lock``)."""
        b = ids.shape[0]
        full = b <= bucket_for(int(self.cfg.spec_max_streams), self.batch_buckets)
        for sample in variants:
            if self.graphs is None:
                sp, _ = self._collate_sample(
                    [{"temperature": 1.0, "seed": 0}] * b if sample else [], b)
                if b == 1:
                    self._spec_start(ids, ids, sp, sample)
                continue
            if b == 1:
                self._spec_start_graph(ids.shape, sample)
                self._graph("spec_chunk", ids.shape, sample,
                            lambda: self._make_spec_chunk(ids.shape, sample))
            if full:
                self._graph("full_spec_chunk", ids.shape, sample,
                            lambda: self._make_full_spec_chunk(ids.shape, sample))

    def _warm_prefixed(self, variants, spec_variants=()) -> float:
        """The prefixed starts' grid (``prefixed_grid`` x
        ``prefixed_batches``, each variant), a warm phase of its own
        (``prefix``): captured on the card, run on the CPU; with the loop
        off, the per-stream path's chunk graphs over those states too.
        Records the graphs captured, their seconds and the graph pool's
        bytes after them in ``prefix_warm``; returns the seconds."""
        per_stream = not self.cfg.continuous_batching and self.max_decode_len > self.chunk_tokens
        before = self.graphs.stats()["insert"] if self.graphs is not None else 0
        with compile_cache.warm_phase(self.bundle.name, "prefix") as phase, self._lock, \
                torch.inference_mode():
            for b in self.prefixed_batches():
                for p_len, s in self.prefixed_grid():
                    shape = (b, p_len, s)
                    for sample in variants:
                        if self.graphs is None:
                            ids = np.ones((b, s), np.int32)
                            sp, _ = self._collate_sample(
                                [{"temperature": 1.0, "seed": 0}] * b if sample else [], b)
                            self._start_prefixed([self._prefix_input(b, p_len)], ids, ids, sp,
                                                 sample)
                            continue
                        self._start_graph(shape, sample)
                        if self.adapters is not None:
                            self._start_graph(shape, sample, True)
                        if per_stream:
                            self._graph("gen_chunk", shape, sample,
                                        lambda: self._make_gen_chunk(shape, sample))
                    # The per-stream spec path's hits: B = 1.
                    for sample in spec_variants if b == 1 else ():
                        if self.graphs is None:
                            ids = np.ones((1, s), np.int32)
                            sp, _ = self._collate_sample(
                                [{"temperature": 1.0, "seed": 0}] if sample else [], 1)
                            self._spec_start(ids, ids, sp, sample, self._prefix_input(1, p_len),
                                             np.ones(p_len, np.int32))
                            continue
                        self._spec_start_graph(shape, sample)
                        self._graph("spec_chunk", shape, sample,
                                    lambda: self._make_spec_chunk(shape, sample))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        graphs = self.graphs.stats()["insert"] - before if self.graphs is not None else 0
        self.prefix_warm = {"graphs": graphs, "seconds": phase.seconds,
                            "pairs": len(self.prefixed_grid()),
                            "batches": list(self.prefixed_batches()),
                            "graph_pool_bytes": (compile_cache.graph_pool_bytes()
                                                 if self.graphs is not None else 0)}
        log.info("%s: prefix grid of %d (prefix, suffix) pairs at batches %s warmed in %.2fs, "
                 "%d CUDA graphs captured", self.bundle.name, self.prefix_warm["pairs"],
                 self.prefix_warm["batches"], phase.seconds, graphs)
        return phase.seconds

    def _generate(self, ids: np.ndarray, mask: np.ndarray, budgets: np.ndarray,
                  sp: SampleParams, sample: bool) -> tuple[np.ndarray, int]:
        """Prefill plus chunked decode of one batch (``sample``: the sampled
        variant); returns the token rows [B, max_decode_len] int32 and the
        decode steps run.  Bucket-padding rows (all-zero mask) count as
        done from the start (``init_state``), or no padded batch could stop
        early."""
        with self._lock, torch.inference_mode():
            chunk = None
            if self.graphs is not None and self.max_decode_len > self.chunk_tokens:
                # Before start replays: a first capture replays start itself.
                chunk = self._graph("gen_chunk", ids.shape, sample,
                                    lambda: self._make_gen_chunk(ids.shape, sample))
            budgets_t = torch.from_numpy(budgets).to(self.device)
            state, _ = self._start(ids, mask, sp, sample)
            steps = self.chunk_tokens
            while True:
                self.decode_steps += self.chunk_tokens
                # A row at its max_tokens budget counts as done.
                torch.logical_or(state.done, state.pos >= budgets_t, out=state.done)
                if steps >= self.max_decode_len or bool(state.done.all()):
                    break
                if chunk is None:
                    self.bundle.generate_chunk(state, self.chunk_tokens, sample)
                else:
                    chunk.replay()
                steps += self.chunk_tokens
                state.steps = steps
            self.dispatches += 1
            return state.tokens.cpu().numpy(), steps

    def generate_stream(self, feats: dict) -> Iterator[np.ndarray]:
        """Streaming generation of one request on its own, the per-stream
        path (prompts longer than the loop's largest seq bucket, and every
        stream under ``CONTINUOUS_BATCHING=0``): ``start`` at the request's
        own bucket (a prompt past every seq bucket at ``stream_width``; on
        the card its graph is captured at first use, a miss), then ``gen_chunk``
        until EOS or the request's budget; yields each chunk's int32 tokens,
        the last trimmed to the budget.  The lock is held per dispatch only.
        On the card the bucket's graphs read and write one static state,
        which another dispatch of the bucket may overwrite between two
        chunks, so the stream keeps its own copy of the state and moves it
        in and out around each replay.  Under ``SPEC_DECODE`` the stream
        speculates (``_spec_stream``) while the per-stream streams live,
        itself included, are at most ``SPEC_MAX_STREAMS``, a sampled one only
        under ``SPEC_SAMPLED``."""
        if self.bundle.kind != KIND_SEQ2SEQ:
            raise ValueError(f"{self.bundle.name} does not support streaming")
        with self._live_streams_lock:
            self._live_streams += 1
            spec_ok = self._live_streams <= int(self.cfg.spec_max_streams)
        try:
            if self.spec_enabled and spec_ok and (
                    float(feats.get("temperature", 0.0)) == 0.0 or self.spec_sampled):
                yield from self._spec_stream(feats)
                return
            yield from self._plain_stream(feats)
        finally:
            with self._live_streams_lock:
                self._live_streams -= 1

    def _plain_stream(self, feats: dict) -> Iterator[np.ndarray]:
        """``generate_stream``'s non-speculative chunks."""
        budget = self.budget_for(feats)
        width = self.stream_width(self._collate_text([feats])[0].shape[1])
        with self._lock, torch.inference_mode():
            state, toks, sampled, shape = self.dispatch_guard(
                "prefill", lambda: self.start_fused(feats, width))
            chunk, done = toks[0].cpu().numpy(), bool(state.done[0])
            self.note_dispatch("fetch")
            # The fetch returned: the prefill it read has finished.
            self.perf.note_complete("prefill")
            if self.graphs is not None:
                state = clone_state(state)
            self.decode_steps += self.chunk_tokens
            self.dispatches += 1
        produced = self.chunk_tokens
        yield chunk[:budget]
        while not done and produced < budget:
            with self._lock, torch.inference_mode():
                toks = self.dispatch_guard(
                    "chunk", lambda: self._stream_chunk(shape, state, sampled))
                chunk, done = toks[0].cpu().numpy(), bool(state.done[0])
                self.note_dispatch("fetch")
                self.perf.note_complete("chunk")
                self.decode_steps += self.chunk_tokens
            yield chunk[: budget - produced]
            produced += self.chunk_tokens

    def stream_width(self, width: int) -> int:
        """The per-stream path's width for a collated prompt width: a seq
        bucket as it is; past the largest, rounded up to a multiple of
        ``LONG_PROMPT_STEP``, at most the model's prompt cap.  Padded keys
        are masked, so the tokens do not change."""
        if width <= max(self.seq_buckets):
            return width
        cap = max(width, self.bundle.max_prompt_len or width)
        return min(-(-width // LONG_PROMPT_STEP) * LONG_PROMPT_STEP, cap)

    def _stream_chunk(self, shape: tuple, state, sample: bool) -> torch.Tensor:
        """One decode chunk of a per-stream state (the caller holds
        ``_lock``): eagerly, or on the card through the ``gen_chunk`` graph
        of the state's start shape (``start_fused``) with the state copied
        into that start graph's static state and back; returns the chunk's
        tokens [1, chunk]."""
        if self.graphs is None:
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample)[1]
        entry = self._graph("gen_chunk", shape, sample,
                            lambda: self._make_gen_chunk(shape, sample))
        static = self._start_graph(shape, sample).outputs[0]
        copy_state(static, state)
        entry.replay()
        copy_state(state, static)
        state.steps += self.chunk_tokens
        return entry.outputs

    # -- speculative decoding (SPEC_DECODE) -------------------------------

    def _make_spec_start(self, shape: tuple, sample: bool):
        """Static [B, S] ids and mask and per-row ``SampleParams``, and over
        them the prefill, the drafting history and the first chunk of
        verify rounds; the outputs are (spec state, out, n_emit)."""
        ids, mask = (torch.ones(shape, dtype=torch.int32, device=self.device) for _ in range(2))
        sp = greedy_params(shape[0], self.device)

        def start():
            state = self.bundle.init_state(ids, mask, self.max_decode_len, sample=sp)
            ss = self.bundle.init_spec(state, ids, mask)
            return self.bundle.spec_chunk(ss, self.chunk_tokens, self.spec_k, sample)

        return start, (ids, mask, sp), self.device

    def _make_spec_start_prefixed(self, shape: tuple, sample: bool):
        """As ``_make_spec_start`` behind a prefix ``[B, P, ...]`` of the
        request's own tokens, whose ids [1, P] are a static input too (the
        history drafts from them)."""
        b, p_len, s = shape
        ids, mask = (torch.ones((b, s), dtype=torch.int32, device=self.device) for _ in range(2))
        sp = greedy_params(b, self.device)
        prefix = self._prefix_input(b, p_len)
        pids = torch.zeros((1, p_len), dtype=torch.long, device=self.device)

        def start():
            state = self.bundle.init_state(ids, mask, self.max_decode_len, sample=sp,
                                           prefix_kv=prefix)
            ss = self.bundle.init_spec(state, ids, mask, prefix_ids=pids)
            return self.bundle.spec_chunk(ss, self.chunk_tokens, self.spec_k, sample)

        return start, (ids, mask, sp, prefix, pids), self.device

    def _spec_start_graph(self, shape: tuple, sample: bool) -> compile_cache.GraphEntry:
        """The ``spec_start`` graph of ``(B, S)``, or the
        ``spec_start_prefixed`` graph of ``(B, P, S)``."""
        if len(shape) == 3:
            return self._graph("spec_start_prefixed", shape, sample,
                               lambda: self._make_spec_start_prefixed(shape, sample))
        return self._graph("spec_start", shape, sample,
                           lambda: self._make_spec_start(shape, sample))

    def _make_spec_chunk(self, shape: tuple, sample: bool):
        """``STREAM_CHUNK_TOKENS`` verify rounds over the state of the
        shape's spec start graph, which is replayed first; the outputs are
        (out, n_emit)."""
        entry = self._spec_start_graph(shape, sample)
        entry.replay()
        ss = entry.outputs[0]

        def chunk():
            return self.bundle.spec_chunk(ss, self.chunk_tokens, self.spec_k, sample)[1:]

        return chunk, ss, self.device

    def _spec_start(self, ids: np.ndarray, mask: np.ndarray, sp: SampleParams, sample: bool,
                    prefix: dict | None = None, prefix_ids: np.ndarray | None = None):
        """Prefill, history and the first chunk of verify rounds of one
        collated batch (behind ``prefix``, whose ids are ``prefix_ids``, for
        a prefix-cache hit); returns (spec state, out [B, chunk, K + 1],
        n_emit [B, chunk]).  On the card the state is the graph's static
        one, valid until its next replay.  The caller holds ``_lock`` inside
        ``torch.inference_mode``."""
        if self.graphs is None:
            dev = self.device
            ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
            pids = None
            if prefix is not None:
                pids = torch.from_numpy(np.asarray(prefix_ids, np.int64)).to(dev)[None]
                state = self.bundle.init_state(ids_t, mask_t, self.max_decode_len,
                                               sample=sp.to(dev), prefix_kv=prefix)
            else:
                state = self.bundle.init_state(ids_t, mask_t, self.max_decode_len,
                                               sample=sp.to(dev))
            ss = self.bundle.init_spec(state, ids_t, mask_t, prefix_ids=pids)
            return self.bundle.spec_chunk(ss, self.chunk_tokens, self.spec_k, sample)
        shape = ids.shape if prefix is None else (ids.shape[0], prefix_len(prefix["k"][0]),
                                                  ids.shape[1])
        entry = self._spec_start_graph(shape, sample)
        for dst, host in zip(entry.inputs, (ids, mask)):
            dst.copy_(torch.from_numpy(host), non_blocking=True)
        entry.inputs[2].copy_(sp)
        if prefix is not None:
            _copy_prefixes(entry.inputs[3], [prefix], ids.shape[0])
            entry.inputs[4].copy_(torch.from_numpy(np.asarray(prefix_ids, np.int64))[None])
        entry.replay()
        return entry.outputs

    def _spec_stream_chunk(self, shape: tuple, ss, sample: bool):
        """One chunk of verify rounds of a per-stream spec state (the caller
        holds ``_lock``): eagerly, or on the card through the shape's
        ``spec_chunk`` graph with the state (its history included) copied
        into the spec start graph's static state and back; returns (out,
        n_emit)."""
        if self.graphs is None:
            return self.bundle.spec_chunk(ss, self.chunk_tokens, self.spec_k, sample)[1:]
        entry = self._graph("spec_chunk", shape, sample,
                            lambda: self._make_spec_chunk(shape, sample))
        static = self._spec_start_graph(shape, sample).outputs[0]
        copy_state(static, ss)
        entry.replay()
        copy_state(ss, static)
        return entry.outputs

    def _spec_stream(self, feats: dict) -> Iterator[np.ndarray]:
        """Speculative streaming of one request: each dispatch runs
        ``STREAM_CHUNK_TOKENS`` verify rounds and yields between that many
        and that many times ``SPEC_K + 1`` tokens, trimmed to the budget.
        Through the prefix cache as ``start_fused`` goes (bypassed under
        ``PAGED_KV``): a hit prefills the suffix only and drafts from the
        whole prompt, a miss (or a hit that now covers a longer bucket)
        donates.  The stream keeps its own copy of the state, as
        ``_plain_stream`` does."""
        n_verify = self.chunk_tokens
        budget = self.budget_for(feats)
        length = int(feats["length"])
        row_ids = np.asarray(feats["input_ids"], np.int32)[:length]
        sampled = float(feats.get("temperature", 0.0)) > 0.0
        cache = None if self.paged_kv else self.prefix_cache
        with self._lock, torch.inference_mode():
            hit = None
            if cache is not None:
                hit = cache.match(row_ids, length, usable=self._prefix_guard(length))
            if hit is not None:
                p_len, prefix = hit
                sfeats = dict(feats, input_ids=row_ids[p_len:], length=np.int32(length - p_len))
                ids, mask, _ = self._collate_text([sfeats])
                sp, _ = self._collate_sample([feats], ids.shape[0])
                ss, out, ns = self.dispatch_guard("prefill", lambda: self._spec_start(
                    ids, mask, sp, sampled, prefix, row_ids[:p_len]))
                shape = (1, p_len, ids.shape[1])
                p_ins = cache.bucket_for_insert(length)
                if p_ins is not None and p_ins > p_len and not cache.contains(row_ids, p_ins):
                    cache.insert(row_ids, p_ins, self._capture_prefix(ss.base, p_ins))
            else:
                ids, mask, _ = self._collate_text([feats])
                width = self.stream_width(ids.shape[1])
                if width > ids.shape[1]:
                    pad = ((0, 0), (0, width - ids.shape[1]))
                    ids, mask = np.pad(ids, pad), np.pad(mask, pad)
                sp, _ = self._collate_sample([feats], ids.shape[0])
                ss, out, ns = self.dispatch_guard(
                    "prefill", lambda: self._spec_start(ids, mask, sp, sampled))
                shape = ids.shape
                if cache is not None:
                    p_ins = cache.bucket_for_insert(length)
                    if p_ins is not None and not cache.contains(row_ids, p_ins):
                        cache.insert(row_ids, p_ins, self._capture_prefix(ss.base, p_ins))
            out_np, ns_np, done = out.cpu().numpy(), ns.cpu().numpy(), bool(ss.base.done[0])
            self.note_dispatch("fetch")
            self.perf.note_complete("prefill")
            if self.graphs is not None:
                ss = clone_state(ss)
            self.spec_rounds += n_verify
            self.dispatches += 1
        chunk = self._spec_emitted(out_np, ns_np, n_verify)[:budget]
        produced = int(chunk.size)
        yield chunk
        # One chunk ahead, as the reference pipelines it: chunk k + 1 is
        # dispatched before chunk k's results are read (at most one is
        # wasted at the end), skipped once the budget could be covered.
        ahead = None
        while not done and produced < budget:
            with self._lock, torch.inference_mode():
                if ahead is None:
                    ahead = self._spec_dispatch(shape, ss, sampled)
                current, ahead = ahead, None
                if produced + n_verify < budget:  # every round emits >= 1
                    ahead = self._spec_dispatch(shape, ss, sampled)
                out_np, ns_np, done_np = (t.cpu().numpy() for t in current)
                self.note_dispatch("fetch")
                self.perf.note_complete("chunk")
            done = bool(done_np[0])
            chunk = self._spec_emitted(out_np, ns_np, n_verify)[: budget - produced]
            produced += int(chunk.size)
            if chunk.size:
                yield chunk

    def _spec_dispatch(self, shape: tuple, ss, sample: bool) -> tuple:
        """One chunk of verify rounds of a per-stream spec state; returns
        copies of its (out, n_emit, done), which the next replay leaves
        alone.  The caller holds ``_lock``."""
        out, ns = self.dispatch_guard("chunk", lambda: self._spec_stream_chunk(shape, ss, sample))
        self.spec_rounds += self.chunk_tokens
        return out.clone(), ns.clone(), ss.base.done.clone()

    def _spec_emitted(self, out_np: np.ndarray, ns_np: np.ndarray, n_verify: int,
                      row: int = 0) -> np.ndarray:
        """One row's emitted tokens of a fetched chunk of verify rounds,
        observed in ``spec_tokens_per_verify_step``."""
        chunk = flatten_emitted(out_np, ns_np, row)
        metrics.SPEC_EMITTED.labels(self.bundle.name).observe(int(chunk.size) / max(1, n_verify))
        return chunk

    def _spec_rounds(self, ss, caps: torch.Tensor, sample: bool) -> None:
        """``STREAM_CHUNK_TOKENS`` verify rounds of a non-streaming batch,
        each followed by its budget cap: a row counts as done once its
        position reaches ``caps`` (its budget plus one, at most the decode
        budget), the reference's per-round cap."""
        for _ in range(self.chunk_tokens):
            self.bundle.spec_chunk(ss, 1, self.spec_k, sample)
            torch.logical_or(ss.base.done, ss.base.pos >= caps, out=ss.base.done)

    def _make_full_spec(self, shape: tuple, sample: bool):
        """Static [B, S] ids and mask, ``SampleParams`` and caps [B], and
        over them the prefill, the history and the first capped rounds; the
        output is the spec state."""
        ids, mask = (torch.ones(shape, dtype=torch.int32, device=self.device) for _ in range(2))
        sp = greedy_params(shape[0], self.device)
        caps = torch.ones(shape[0], dtype=torch.long, device=self.device)

        def start():
            state = self.bundle.init_state(ids, mask, self.max_decode_len, sample=sp)
            ss = self.bundle.init_spec(state, ids, mask)
            self._spec_rounds(ss, caps, sample)
            return ss

        return start, (ids, mask, sp, caps), self.device

    def _make_full_spec_chunk(self, shape: tuple, sample: bool):
        """More capped rounds over the ``full_spec`` graph's state, which is
        replayed first; the output is the rows' ``done`` flags."""
        entry = self._graph("full_spec", shape, sample,
                            lambda: self._make_full_spec(shape, sample))
        entry.replay()
        ss, caps = entry.outputs, entry.inputs[3]

        def chunk():
            self._spec_rounds(ss, caps, sample)
            return ss.base.done

        return chunk, ss, self.device

    def _generate_spec(self, ids: np.ndarray, mask: np.ndarray, budgets: np.ndarray,
                       sp: SampleParams, sample: bool) -> tuple[np.ndarray, int]:
        """A non-streaming batch by verify rounds: prefill, history and
        capped rounds until every row is done (bucket-padding rows are born
        done); returns the token rows [B, max_decode_len] int32 and the
        largest position, the reference's ``pos.max()``."""
        caps = np.minimum(budgets.astype(np.int64) + 1, self.max_decode_len)
        with self._lock, torch.inference_mode():
            if self.graphs is None:
                fn, inputs, _ = self._make_full_spec(ids.shape, sample)
                chunk_fn = None
            else:
                # Before the start replays: a first capture replays it itself.
                chunk = self._graph("full_spec_chunk", ids.shape, sample,
                                    lambda: self._make_full_spec_chunk(ids.shape, sample))
                entry = self._graph("full_spec", ids.shape, sample,
                                    lambda: self._make_full_spec(ids.shape, sample))
                fn, inputs, chunk_fn = entry.replay, entry.inputs, chunk.replay
            for dst, host in zip(inputs, (ids, mask)):
                dst.copy_(torch.from_numpy(host), non_blocking=True)
            inputs[2].copy_(sp)
            inputs[3].copy_(torch.from_numpy(caps), non_blocking=True)
            ss = fn()
            if self.graphs is not None:
                ss = entry.outputs
            self.spec_rounds += self.chunk_tokens
            # Every live row moves one position a round, so the loop ends
            # within the decode budget's rounds.
            for _ in range(-(-self.max_decode_len // self.chunk_tokens)):
                if bool(ss.base.done.all()):
                    break
                if chunk_fn is None:
                    self._spec_rounds(ss, inputs[3], sample)
                else:
                    chunk_fn()
                self.spec_rounds += self.chunk_tokens
            self.dispatches += 1
            return ss.base.tokens.cpu().numpy(), int(ss.base.pos.max())

    def start(self, feats: list[dict], rows: list[int] | None = None):
        """Prefill plus the first decode chunk of a wave of streams,
        collated as one batch at the wave's widest bucket (sampled if any
        row samples; with ``rows``, each stream's adapter slot, through the
        LoRA overlay); returns (state, tokens [B, chunk], collated width).
        The caller holds ``_lock`` inside ``torch.inference_mode`` until it
        has read the state, which on the card the bucket's next ``start``
        overwrites."""
        ids, mask, _ = self._collate_text(feats)
        sp, sampled = self._collate_sample(feats, ids.shape[0])
        state, toks = self._start(ids, mask, sp, sampled, rows)
        return state, toks, ids.shape[1]

    def run_batch(self, feats: list[dict]) -> list[np.ndarray]:
        """Run one formed batch; returns one row per item: f32 logits, or
        int32 tokens for a generative model.  Batches larger than the max
        bucket split into sub-dispatches."""
        cap = max(self.batch_buckets)
        if len(feats) > cap:
            out: list[np.ndarray] = []
            for i in range(0, len(feats), cap):
                out.extend(self.run_batch(feats[i : i + cap]))
            return out
        if self.bundle.kind == KIND_IMAGE:
            images, n = self._collate_images(feats)
            with tracing.span("dispatch", cat="engine", batch=images.shape[0],
                              image=images.shape[1], n=n):
                rows = self._forward_images(images)
            return [rows[i] for i in range(n)]
        ids, mask, n = self._collate_text(feats)
        with tracing.span("dispatch", cat="engine", batch=ids.shape[0], seq=ids.shape[1], n=n):
            if self.bundle.kind == KIND_SEQ2SEQ:
                sp, sampled = self._collate_sample(feats, ids.shape[0])
                # Speculation is the low-concurrency lever (the streams'
                # gate): a batch of at most SPEC_MAX_STREAMS rows, sampled
                # ones only under SPEC_SAMPLED.
                spec = (self.spec_enabled and (not sampled or self.spec_sampled)
                        and n <= int(self.cfg.spec_max_streams))
                run = self._generate_spec if spec else self._generate
                rows, self.last_decode_steps = run(
                    ids, mask, self._collate_budget(feats, ids.shape[0]), sp, sampled)
            else:
                rows = self._forward(ids, mask)
        return [rows[i] for i in range(n)]

    def warmup(self) -> float:
        """Every (batch, seq) bucket once (an image model: every batch
        bucket): on the card its graphs captured (a generative model's
        ``start`` and ``gen_chunk``, greedy and, unless
        ``WARMUP_SAMPLING=0``, sampled; under ``SPEC_DECODE`` the speculative
        graphs, ``_warm_spec``), on the CPU its functions run; returns the
        seconds taken.  A failed capture raises."""
        image = self.bundle.kind == KIND_IMAGE
        captured = self.graphs.stats()["insert"] if self.graphs is not None else 0
        variants = (False, True) if self.cfg.warmup_sampling else (False,)
        # SPEC_MAX_STREAMS=0 leaves the per-stream and whole spec paths unused
        # (only SPEC_CONTINUOUS's loop speculates): nothing of theirs to warm.
        spec_variants = ((False, True) if self.cfg.warmup_sampling and self.spec_sampled
                         else (False,)) if self.spec_enabled and self.cfg.spec_max_streams else ()
        with compile_cache.warm_phase(self.bundle.name, "engine") as phase:
            for b in self.batch_buckets:
                if image:
                    self.run_batch(
                        [{"image": np.zeros((self.bundle.image_size,) * 2 + (3,), np.uint8)}] * b)
                    continue
                for s in self.seq_buckets:
                    ids = np.ones((b, s), np.int32)
                    if self.bundle.kind != KIND_SEQ2SEQ:
                        self._forward(ids, ids)
                        continue
                    with self._lock, torch.inference_mode():
                        for sample in variants:
                            if self.graphs is None:
                                sp, _ = self._collate_sample(
                                    [{"temperature": 1.0, "seed": 0}] * b if sample else [], b)
                                self._start(ids, ids, sp, sample)
                                continue
                            self._graph("start", ids.shape, sample,
                                        lambda: self._make_start(ids.shape, sample))
                            if self.adapters is not None:
                                # The continuous loop's admissions start
                                # through the adapter overlay.
                                self._start_graph(ids.shape, sample, True)
                            if self.max_decode_len > self.chunk_tokens:
                                self._graph("gen_chunk", ids.shape, sample,
                                            lambda: self._make_gen_chunk(ids.shape, sample))
                        if spec_variants:
                            self._warm_spec(ids, spec_variants)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        seconds = phase.seconds
        if self.prefix_cache is not None:
            seconds += self._warm_prefixed(variants, spec_variants)
        n_seq = 1 if image else len(self.seq_buckets)
        if self.graphs is not None:
            captured = self.graphs.stats()["insert"] - captured
            log.info("%s: warmed %d buckets in %.2fs, %d CUDA graphs captured (%s)",
                     self.bundle.name, len(self.batch_buckets) * n_seq, phase.seconds,
                     captured, ", ".join(self.graph_modes()))
        else:
            log.info("%s: warmed %d buckets in %.2fs; %s run eagerly: %s", self.bundle.name,
                     len(self.batch_buckets) * n_seq, phase.seconds,
                     ", ".join(self.graph_modes()), self.eager_reason)
        return seconds
