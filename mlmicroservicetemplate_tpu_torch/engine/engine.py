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
"""

from __future__ import annotations

import logging
import math
import random
import threading
from typing import Iterator

import numpy as np
import torch

from ..models.gpt import clone_state, copy_state
from ..models.registry import KIND_IMAGE, KIND_SEQ2SEQ, KIND_TEXT, ModelBundle, decode_budget
from ..models.sampling import SampleParams, greedy_params, make_params
from ..runtime import compile_cache
from ..utils import tracing
from .kv_blocks import BlockPool, blocks_for, kv_token_bytes

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
            # The most blocks one stream can hold (the loop's table width),
            # and a pool of KV_BUDGET_MB's blocks, else of MAX_STREAMS of
            # those worst cases.
            self.kv_blocks_per_stream = blocks_for(
                max(self.seq_buckets) + self.max_decode_len, self.kv_block_size)
            bb = self.kv_block_bytes()
            budget = int(float(getattr(cfg, "kv_budget_mb", 0.0) or 0.0) * 1e6)
            num = (max(1, budget // bb) if budget
                   else cfg.max_streams * self.kv_blocks_per_stream)
            self.kv_pool = BlockPool(num, bb)

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

    def kv_bytes_estimate(self, feats: dict) -> int:
        """Admission-time ceiling of one request's KV footprint in bytes:
        its prompt bucket plus the server's decode budget of positions (an
        encoder-decoder adds its cross-attention K/V over the encoder
        bucket).  A ceiling, so the budget fails safe; under ``PAGED_KV=1``
        the block ledger (``kv_blocks_estimate``) takes its place for
        streams."""
        if self.bundle.kind != KIND_SEQ2SEQ:
            return 0
        s = bucket_for(max(int(feats.get("length", 0) or 0), 1), self.seq_buckets,
                       self.seq_multiple)
        per_tok = self.kv_token_bytes()
        total = (s + self.max_decode_len) * per_tok
        if getattr(self.bundle.cfg, "d_kv", None) is not None:
            total += s * per_tok
        return int(total)

    def kv_blocks_estimate(self, feats: dict) -> tuple[int, int]:
        """Paged mode's exact ledger for one stream: (initial, worst)
        blocks.  ``initial`` covers the prompt bucket and the first chunk,
        what admission charges up front; ``worst`` the request's own decode
        budget in whole chunks, the bound past which it can never fit."""
        s = bucket_for(max(int(feats.get("length", 0) or 0), 1), self.seq_buckets,
                       self.seq_multiple)
        budget = -(-self.budget_for(feats) // self.chunk_tokens) * self.chunk_tokens
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
        kinds = {KIND_IMAGE: ("forward_images",), KIND_TEXT: ("forward",),
                 KIND_SEQ2SEQ: ("start", "gen_chunk",
                                "loop_chunk_paged" if self.paged_kv else "loop_chunk")}
        mode = "graph" if self.graphs is not None else f"eager: {self.eager_reason}"
        return {kind: mode for kind in kinds.get(self.bundle.kind, ())}

    def _graph(self, kind: str, shape: tuple, sample: bool | None,
               make) -> compile_cache.GraphEntry:
        """This bundle's graph of ``kind`` for a bucket ``shape`` (a
        generation's: its greedy or ``sample`` variant), captured from
        ``make()`` on a miss; the caller holds ``_lock``."""
        dtype = str(self.bundle.policy.compute_dtype).split(".")[-1]
        quant = "int8" if getattr(self.bundle.cfg, "kv_quant", False) else "none"
        variant = () if sample is None else ("sample" if sample else "greedy",)
        return self.graphs.get(self.bundle, kind, (*shape, *variant, dtype, quant),
                               self.placement_key, make)

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
        return make_params(seed, temp, top_k, top_p), sampled

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

    def _make_start(self, shape: tuple, sample: bool):
        """Static [B, S] ids and mask and per-row ``SampleParams``, and
        prefill plus the first chunk over them (``sample``: the sampled
        variant); the outputs are (state, tokens [B, chunk])."""
        ids, mask = (torch.ones(shape, dtype=torch.int32, device=self.device) for _ in range(2))
        sp = greedy_params(shape[0], self.device)

        def start():
            state = self.bundle.init_state(ids, mask, self.max_decode_len, sample=sp)
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample)

        return start, (ids, mask, sp), self.device

    def _make_gen_chunk(self, shape: tuple, sample: bool):
        """One decode chunk over the state of the bucket's ``start`` graph
        of the same variant, which is replayed first, so the eager warm run
        reads a real state; the output is the chunk's tokens."""
        entry = self._graph("start", shape, sample, lambda: self._make_start(shape, sample))
        entry.replay()
        state = entry.outputs[0]

        def chunk():
            state.steps = self.chunk_tokens  # as after start
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample)[1]

        return chunk, state, self.device

    def _start(self, ids: np.ndarray, mask: np.ndarray, sp: SampleParams, sample: bool):
        """Prefill plus the first decode chunk of a collated batch; returns
        (state, tokens [B, chunk]).  On the card the state is the bucket's
        static one, valid until the next replay.  The caller holds
        ``_lock`` inside ``torch.inference_mode``."""
        if self.graphs is None:
            state = self.bundle.init_state(torch.from_numpy(ids).to(self.device),
                                           torch.from_numpy(mask).to(self.device),
                                           self.max_decode_len, sample=sp.to(self.device))
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample)
        entry = self._graph("start", ids.shape, sample,
                            lambda: self._make_start(ids.shape, sample))
        for dst, host in zip(entry.inputs, (ids, mask)):
            dst.copy_(torch.from_numpy(host), non_blocking=True)
        entry.inputs[2].copy_(sp)
        entry.replay()
        state, toks = entry.outputs
        state.steps = self.chunk_tokens
        return state, toks

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
        in and out around each replay."""
        if self.bundle.kind != KIND_SEQ2SEQ:
            raise ValueError(f"{self.bundle.name} does not support streaming")
        budget = self.budget_for(feats)
        ids, mask, _ = self._collate_text([feats])
        pad = ((0, 0), (0, self.stream_width(ids.shape[1]) - ids.shape[1]))
        ids, mask = np.pad(ids, pad), np.pad(mask, pad)
        sp, sampled = self._collate_sample([feats], ids.shape[0])
        with self._lock, torch.inference_mode():
            state, toks = self._start(ids, mask, sp, sampled)
            chunk, done = toks[0].cpu().numpy(), bool(state.done[0])
            if self.graphs is not None:
                state = clone_state(state)
            self.decode_steps += self.chunk_tokens
            self.dispatches += 1
        produced = self.chunk_tokens
        yield chunk[:budget]
        while not done and produced < budget:
            with self._lock, torch.inference_mode():
                toks = self._stream_chunk(ids.shape, state, sampled)
                chunk, done = toks[0].cpu().numpy(), bool(state.done[0])
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
        ``_lock``): eagerly, or on the card through the bucket's
        ``gen_chunk`` graph with the state copied into the bucket's static
        state and back; returns the chunk's tokens [1, chunk]."""
        if self.graphs is None:
            return self.bundle.generate_chunk(state, self.chunk_tokens, sample)[1]
        entry = self._graph("gen_chunk", shape, sample,
                            lambda: self._make_gen_chunk(shape, sample))
        static = self._graph("start", shape, sample,
                             lambda: self._make_start(shape, sample)).outputs[0]
        copy_state(static, state)
        entry.replay()
        copy_state(state, static)
        state.steps += self.chunk_tokens
        return entry.outputs

    def start(self, feats: list[dict]):
        """Prefill plus the first decode chunk of a wave of streams,
        collated as one batch at the wave's widest bucket (sampled if any
        row samples); returns (state, tokens [B, chunk], collated width).
        The caller holds ``_lock`` inside ``torch.inference_mode`` until it
        has read the state, which on the card the bucket's next ``start``
        overwrites."""
        ids, mask, _ = self._collate_text(feats)
        sp, sampled = self._collate_sample(feats, ids.shape[0])
        state, toks = self._start(ids, mask, sp, sampled)
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
                rows, self.last_decode_steps = self._generate(
                    ids, mask, self._collate_budget(feats, ids.shape[0]),
                    *self._collate_sample(feats, ids.shape[0]),
                )
            else:
                rows = self._forward(ids, mask)
        return [rows[i] for i in range(n)]

    def warmup(self) -> float:
        """Every (batch, seq) bucket once (an image model: every batch
        bucket): on the card its graphs captured (a generative model's
        ``start`` and ``gen_chunk``, greedy and, unless
        ``WARMUP_SAMPLING=0``, sampled), on the CPU its functions run;
        returns the seconds taken.  A failed capture raises."""
        image = self.bundle.kind == KIND_IMAGE
        captured = self.graphs.stats()["insert"] if self.graphs is not None else 0
        variants = (False, True) if self.cfg.warmup_sampling else (False,)
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
                            if self.max_decode_len > self.chunk_tokens:
                                self._graph("gen_chunk", ids.shape, sample,
                                            lambda: self._make_gen_chunk(ids.shape, sample))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
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
        return phase.seconds
