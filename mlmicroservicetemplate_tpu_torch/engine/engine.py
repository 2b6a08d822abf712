"""InferenceEngine: bucketed dispatch of one model on one device.

Counterpart of the JAX package's ``engine/engine.py`` for image and text
classification and for non-streaming generation.  Requests are padded up
to a small set of (batch, seq) buckets, as in the JAX package where each
bucket is one compiled executable; here execution is eager, and
``warmup`` runs every bucket once so first-call costs (kernel build and
load, allocator growth) land before the service reports ready.

- Classification: each dispatch is one ``torch.inference_mode`` forward
  and one device-to-host copy of the logits.  An image batch crosses to
  the device as uint8 (a quarter of f32's bytes) from pinned host memory,
  padded to a batch bucket only (every image has the model's size).
  Under a sequence-parallel placement (bert-long) the batch goes to the
  forward as sequence shards, one per device of the placement, and seq
  buckets round up to a multiple of the shard count, as in the JAX
  package.
- Generation (``KIND_SEQ2SEQ``): prefill, then greedy decode in chunks of
  ``STREAM_CHUNK_TOKENS`` steps.  After each chunk the engine reads once
  from the device whether every row is done (EOS, or its ``max_tokens``
  budget), the eager counterpart of the JAX package's done-aware
  ``while_loop``; rows come back pad-filled to ``max_decode_len``.
- Streaming generation runs in the continuous decode loop
  (``engine/streams.py``), which admits a wave of streams through
  ``start`` (prefill plus the first chunk, fused as in the JAX package)
  and, with ``PAGED_KV=1``, keeps its KV in ``kv_pool``: blocks for
  ``MAX_STREAMS`` worst-case streams (largest seq bucket plus the decode
  budget each), so growth never finds the pool dry.
"""

from __future__ import annotations

import logging
import math
import threading
import time

import numpy as np
import torch

from ..models.registry import KIND_IMAGE, KIND_SEQ2SEQ, ModelBundle, decode_budget
from ..utils import tracing
from .kv_blocks import BlockPool, blocks_for, kv_token_bytes

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
        # One forward at a time on the device: eager dispatch from several
        # batcher threads would only interleave on the same stream.
        self._lock = threading.Lock()
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
            # and a pool of MAX_STREAMS of them.
            self.kv_blocks_per_stream = blocks_for(
                max(self.seq_buckets) + self.max_decode_len, self.kv_block_size)
            self.kv_pool = BlockPool(cfg.max_streams * self.kv_blocks_per_stream)

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

    def _forward_images(self, images: torch.Tensor) -> np.ndarray:
        with self._lock, torch.inference_mode():
            logits = self.bundle.forward(images.to(self.device, non_blocking=True))
            self.dispatches += 1
            return logits.to(self.bundle.policy.output_dtype).cpu().numpy()

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

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with self._lock, torch.inference_mode():
            if self.placement is not None:  # lists of sequence shards
                ids_t = self.placement.place_batch(ids)
                mask_t = self.placement.place_batch(mask)
            else:
                ids_t = torch.from_numpy(ids).to(self.device, non_blocking=True)
                mask_t = torch.from_numpy(mask).to(self.device, non_blocking=True)
            logits = self.bundle.forward(ids_t, mask_t)
            self.dispatches += 1
            return logits.to(self.bundle.policy.output_dtype).cpu().numpy()

    def _generate(self, ids: np.ndarray, mask: np.ndarray,
                  budgets: np.ndarray) -> tuple[np.ndarray, int]:
        """Prefill plus chunked greedy decode of one batch; returns the
        token rows [B, max_decode_len] int32 and the decode steps run."""
        with self._lock, torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device)
            mask_t = torch.from_numpy(mask).to(self.device)
            budgets_t = torch.from_numpy(budgets).to(self.device)
            state = self.bundle.init_state(ids_t, mask_t, self.max_decode_len)
            # Bucket-padding rows (all-zero mask) never emit EOS: they count
            # as done from the start, or no padded batch could stop early.
            state.done = state.done | (mask_t.sum(dim=-1) == 0)
            while state.steps < self.max_decode_len and not bool(state.done.all()):
                state, _ = self.bundle.generate_chunk(state, self.chunk_tokens)
                self.decode_steps += self.chunk_tokens
                # A row at its max_tokens budget counts as done.
                state.done = state.done | (state.pos >= budgets_t)
            self.dispatches += 1
            return state.tokens.cpu().numpy(), state.steps

    def start(self, feats: list[dict]):
        """Prefill plus the first decode chunk of a wave of streams,
        collated as one batch at the wave's widest bucket; returns (state,
        tokens [B, chunk], collated width).  The caller holds ``_lock``
        inside ``torch.inference_mode``."""
        ids, mask, _ = self._collate_text(feats)
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        state = self.bundle.init_state(ids_t, mask_t, self.max_decode_len)
        state, toks = self.bundle.generate_chunk(state, self.chunk_tokens)
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
                    ids, mask, self._collate_budget(feats, ids.shape[0])
                )
            else:
                rows = self._forward(ids, mask)
        return [rows[i] for i in range(n)]

    def warmup(self) -> float:
        """Run every (batch, seq) bucket once (a generative model: its
        prefill and one decode chunk; an image model: every batch bucket);
        returns the seconds taken."""
        t0 = time.monotonic()
        image = self.bundle.kind == KIND_IMAGE
        for b in self.batch_buckets:
            if image:
                self.run_batch(
                    [{"image": np.zeros((self.bundle.image_size,) * 2 + (3,), np.uint8)}] * b)
                continue
            for s in self.seq_buckets:
                ids = np.ones((b, s), np.int32)
                if self.bundle.kind == KIND_SEQ2SEQ:
                    with self._lock, torch.inference_mode():
                        ones = torch.from_numpy(ids).to(self.device)
                        state = self.bundle.init_state(ones, ones, self.max_decode_len)
                        self.bundle.generate_chunk(state, self.chunk_tokens)
                else:
                    self._forward(ids, np.ones((b, s), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.monotonic() - t0
        n_seq = 1 if image else len(self.seq_buckets)
        log.info("warmed %d buckets in %.2fs", len(self.batch_buckets) * n_seq, dt)
        return dt
