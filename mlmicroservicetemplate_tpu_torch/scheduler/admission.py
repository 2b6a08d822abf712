"""Admission control: priority classes, deadlines, the KV-footprint budget
and the drain gate.

Counterpart of the JAX package's ``scheduler/admission.py``.  It sits
between the HTTP layer and the wait queues (``policy.py``) and decides at
submit time:

- **Class and deadline**: ``X-Priority`` (interactive | batch, else
  ``PRIORITY_DEFAULT``) and ``X-Deadline-Ms`` (else ``DEADLINE_MS``; 0 =
  none) become the queue's scheduling fields.
- **KV budget** (``KV_BUDGET_MB``): each request's cache footprint is
  estimated up front (``InferenceEngine.kv_bytes_estimate``).  Work that
  could never fit sheds at once (503 ``kv_budget``); interactive work
  that would overcommit what is committed now is down-classed to
  ``batch`` and waits.  The budget then gates dequeue: an item leaves its
  queue only when its reservation fits (``fits``, ``reserve``,
  ``release``).  Under ``PAGED_KV=1`` the engine's block pool is the
  ledger of streams: a stream is charged its prompt's blocks and its
  first chunk's (``kv_blocks_estimate``), and grows block by block.
- **Drain**: once ``draining`` is set (SIGTERM), every admission sheds
  with 503 ``drain``.

One controller serves the batcher's request queue and the continuous
loop's stream queue, so its ledger covers both.  Tenant quotas and the
fleet's budget split are not ported.
"""

from __future__ import annotations

import threading
import time

from ..utils import metrics, tracing
from .policy import BATCH, CLASSES, INTERACTIVE, QueueFullError


class AdmissionController:
    """Shared admission policy and committed-KV ledger of one model."""

    def __init__(self, cfg, engine=None):
        self.engine = engine
        self.model = getattr(getattr(engine, "bundle", None), "name", "unknown")
        default = str(getattr(cfg, "priority_default", INTERACTIVE) or INTERACTIVE).lower()
        self.default_class = default if default in CLASSES else INTERACTIVE
        self.default_deadline_ms = float(getattr(cfg, "deadline_ms", 0.0) or 0.0)
        self.kv_budget_bytes = int(float(getattr(cfg, "kv_budget_mb", 0.0) or 0.0) * 1e6)
        self._committed = 0
        self._lock = threading.Lock()
        self.draining = False
        # PAGED_KV=1: streams are accounted by the engine's block pool (the
        # exact ledger: allocated blocks x block bytes); the byte ledger
        # stays for the batch path, against what the pool has not claimed.
        self.paged = bool(getattr(engine, "paged_kv", False))
        self.pool = getattr(engine, "kv_pool", None)

    def _pool_bytes(self) -> int:
        return self.pool.used_bytes if (self.paged and self.pool) else 0

    def note_pool(self) -> None:
        """Refresh the committed-bytes and pool gauges off the pool
        (paged)."""
        if self.paged and self.pool:
            used = self.pool.used_blocks
            metrics.KV_COMMITTED.labels(self.model).set(
                self._committed + used * self.pool.block_bytes)
            metrics.KV_POOL_BLOCKS.labels(self.model, "used").set(used)
            metrics.KV_POOL_BLOCKS.labels(self.model, "free").set(self.pool.num_blocks - used)

    # -- classification ------------------------------------------------

    def classify(self, feats: dict) -> tuple[str, float | None]:
        """(class, absolute monotonic deadline or None) from the request's
        scheduling fields (set by the API off ``X-Priority`` and
        ``X-Deadline-Ms``), with the configured defaults."""
        klass = str(feats.get("priority") or self.default_class).lower()
        if klass not in CLASSES:  # the header's syntax is checked upstream (400)
            klass = self.default_class
        dl_ms = feats.get("deadline_ms")
        dl_ms = float(dl_ms) if dl_ms is not None else self.default_deadline_ms
        deadline = time.monotonic() + dl_ms / 1e3 if dl_ms > 0 else None
        return klass, deadline

    # -- KV budget -----------------------------------------------------

    def kv_bytes(self, feats: dict) -> int:
        est = getattr(self.engine, "kv_bytes_estimate", None)
        return int(est(feats)) if est is not None else 0

    def kv_bytes_for_resume(self, feats: dict) -> int:
        """The footprint a checkpointed stream reserves again at dequeue,
        off its current feats: a recast resume folds the delivered tokens
        into the prompt, so the admission-time estimate can fall short of
        the new prompt's bucket."""
        if self.paged and self.pool is not None:
            initial, _ = self.engine.kv_blocks_estimate(feats)
            return initial * self.pool.block_bytes
        return self.kv_bytes(feats)

    def admit(self, feats: dict, klass: str) -> tuple[str, int]:
        """The drain and KV-budget gates.  Returns the (possibly
        down-classed) class and the KV bytes to reserve; raises
        ``QueueFullError`` with reason ``drain`` or ``kv_budget``.  Paged,
        a stream whose prompt bucket and own decode budget exceed the
        whole pool sheds, and the bytes returned are its initial blocks
        (prompt and first chunk): the loop grows it from there."""
        if self.draining:
            raise QueueFullError("server is draining", reason="drain", retry_after_s=5.0)
        if self.paged and self.pool is not None:
            initial, worst = self.engine.kv_blocks_estimate(feats)
            if worst > self.pool.num_blocks:
                raise QueueFullError(
                    f"request needs {worst} KV blocks, ledger holds {self.pool.num_blocks}",
                    reason="kv_budget")
            if self.pool.free_blocks < initial and klass == INTERACTIVE:
                # Transient pressure: wait it out in the lower class.
                klass = BATCH
                self._note_downclass(feats, "pool_pressure")
            return klass, initial * self.pool.block_bytes
        kv = self.kv_bytes(feats)
        if self.kv_budget_bytes:
            if kv > self.kv_budget_bytes:
                raise QueueFullError(
                    f"request KV footprint {kv}B exceeds the {self.kv_budget_bytes}B budget",
                    reason="kv_budget")
            with self._lock:
                over = self._committed + kv > self.kv_budget_bytes
            if over and klass == INTERACTIVE:
                klass = BATCH
                self._note_downclass(feats, "kv_overcommit")
        return klass, kv

    @staticmethod
    def _note_downclass(feats: dict, why: str) -> None:
        tr = tracing.tracer()
        if tr is not None:
            tr.add("downclass", cat="sched", rid=str(feats.get("request_id") or ""), dur=0.0,
                   why=why)

    def fits(self, item) -> bool:
        """The dequeue gate: may this waiter's reservation commit now?
        Paged streams gate on free pool blocks for their initial blocks;
        other work on the byte ledger, against what the pool has not
        claimed."""
        kv = getattr(item, "kv", 0)
        if self.paged and self.pool is not None:
            if getattr(item, "is_stream", False):
                return self.pool.free_blocks >= -(-kv // self.pool.block_bytes)
            if not self.kv_budget_bytes:
                return True
            with self._lock:
                return self._committed + kv + self._pool_bytes() <= self.kv_budget_bytes
        if not self.kv_budget_bytes:
            return True
        with self._lock:
            return self._committed + kv <= self.kv_budget_bytes

    def reserve(self, item) -> None:
        if self.paged and getattr(item, "is_stream", False):
            # The pool is the ledger: blocks commit at slot insert and grow
            # at chunk boundaries; only the gauge moves here.
            self.note_pool()
            return
        kv = getattr(item, "kv", 0)
        if kv and not item.kv_held:
            with self._lock:
                self._committed += kv
                metrics.KV_COMMITTED.labels(self.model).set(self._committed + self._pool_bytes())
            item.kv_held = True

    def release(self, item) -> None:
        if self.paged and getattr(item, "is_stream", False):
            self.note_pool()
            return
        if getattr(item, "kv_held", False):
            with self._lock:
                self._committed -= item.kv
                metrics.KV_COMMITTED.labels(self.model).set(self._committed + self._pool_bytes())
            item.kv_held = False

    @property
    def committed_bytes(self) -> int:
        with self._lock:
            return self._committed + self._pool_bytes()
