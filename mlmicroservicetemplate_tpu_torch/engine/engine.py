"""InferenceEngine: bucketed dispatch of one model on one device.

Counterpart of the JAX package's ``engine/engine.py`` for text
classification.  Requests are padded up to a small set of (batch, seq)
buckets, as in the JAX package where each bucket is one compiled
executable; here execution is eager, and ``warmup`` runs every bucket
once so first-call costs (kernel build and load, allocator growth) land
before the service reports ready.  Each dispatch is one
``torch.inference_mode`` forward and one device-to-host copy of the
logits.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from ..models.registry import ModelBundle
from ..utils import tracing

log = logging.getLogger(__name__)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n; n itself past the largest bucket."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return n


class InferenceEngine:
    """Owns the model's device and runs formed batches on it."""

    def __init__(self, bundle: ModelBundle, cfg):
        self.bundle = bundle
        self.cfg = cfg
        self.device = bundle.device
        self.batch_buckets = tuple(cfg.batch_buckets)
        self.seq_buckets = tuple(cfg.seq_buckets)
        if max(self.seq_buckets) > bundle.cfg.max_position:
            raise ValueError(
                f"SEQ_BUCKETS {cfg.seq_buckets} exceed the model's "
                f"{bundle.cfg.max_position} positions"
            )
        # One forward at a time on the device: eager dispatch from several
        # batcher threads would only interleave on the same stream.
        self._lock = threading.Lock()
        # Forward passes run since start or the last reset (the counter
        # the kernel launch counts are held against).
        self.dispatches = 0

    def _collate_text(self, feats: list[dict]) -> tuple[np.ndarray, np.ndarray, int]:
        n = len(feats)
        bsz = bucket_for(n, self.batch_buckets)
        max_len = max(int(f["length"]) for f in feats)
        seq = bucket_for(max_len, self.seq_buckets)
        ids = np.zeros((bsz, seq), np.int32)
        mask = np.zeros((bsz, seq), np.int32)
        for i, f in enumerate(feats):
            L = int(f["length"])
            ids[i, :L] = f["input_ids"][:L]
            mask[i, :L] = 1
        return ids, mask, n

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with self._lock, torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device, non_blocking=True)
            mask_t = torch.from_numpy(mask).to(self.device, non_blocking=True)
            logits = self.bundle.forward(ids_t, mask_t)
            self.dispatches += 1
            return logits.to(self.bundle.policy.output_dtype).cpu().numpy()

    def run_batch(self, feats: list[dict]) -> list[np.ndarray]:
        """Forward one formed batch; returns one f32 logits row per item.
        Batches larger than the max bucket split into sub-dispatches."""
        cap = max(self.batch_buckets)
        if len(feats) > cap:
            out: list[np.ndarray] = []
            for i in range(0, len(feats), cap):
                out.extend(self.run_batch(feats[i : i + cap]))
            return out
        ids, mask, n = self._collate_text(feats)
        with tracing.span("dispatch", cat="engine", batch=ids.shape[0], seq=ids.shape[1], n=n):
            rows = self._forward(ids, mask)
        return [rows[i] for i in range(n)]

    def warmup(self) -> float:
        """Run every (batch, seq) bucket once; returns the seconds taken."""
        t0 = time.monotonic()
        for b in self.batch_buckets:
            for s in self.seq_buckets:
                ids = np.ones((b, s), np.int32)
                self._forward(ids, np.ones((b, s), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.monotonic() - t0
        log.info("warmed %d buckets in %.2fs",
                 len(self.batch_buckets) * len(self.seq_buckets), dt)
        return dt
