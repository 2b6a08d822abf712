"""The wait-queue policy of the dynamic batcher and the continuous loop.

The parts of the JAX package's ``scheduler/policy.py`` that the port
uses: the shed and deadline errors, the two priority classes and one
bounded deadline-aware queue, the ``/predict`` path's request queue and
the continuous decode loop's stream queue.

- Two classes, ``interactive`` above ``batch`` (``X-Priority``, else
  ``PRIORITY_DEFAULT``).
- Earliest deadline first within a class, FIFO among waiters with equal
  deadlines or none (so without deadlines it is plain FIFO).
- Class-weighted dequeue across classes: ``weight`` (``CLASS_WEIGHT``)
  interactive pops per batch pop while both classes wait.
- On overflow the victim is the lowest-class, latest-deadline waiter, and
  only if the newcomer outranks it; else the newcomer is shed (503).
- Expiry: a waiter past its deadline is removed (504 before dispatch).
  A ``started`` waiter (a preempted stream queued to resume) is never
  expired nor evicted.

Fair share across tenants, the prefill pacer, the backfill, SLO, scaling
and decode-window governors are not ported.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time

INTERACTIVE = "interactive"
BATCH = "batch"
#: Rank order: earlier = higher priority.
CLASSES = (INTERACTIVE, BATCH)


class QueueFullError(Exception):
    """Queue at capacity; shed load (HTTP 503 + Retry-After).  ``reason``
    labels the shed counter (queue_full | kv_budget | drain)."""

    def __init__(self, msg: str = "", reason: str = "queue_full",
                 retry_after_s: float | None = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceededError(Exception):
    """The request's deadline passed while it waited (HTTP 504)."""


def _dl(item) -> float:
    """Sort key: the absolute deadline; None (no deadline) ranks last."""
    return item.deadline if item.deadline is not None else float("inf")


class DeadlineQueue:
    """Bounded two-class EDF wait queue (see the module docstring).

    Items expose ``klass`` (interactive | batch), ``deadline`` (absolute
    seconds on the queue's clock, ``time.monotonic`` unless one is
    injected, so tests pin expiry without sleeping; or None) and
    ``started`` (True once a preempted stream is queued to resume).  The
    queue stamps ``_removed`` on them for lazy deletion from its heaps.
    Thread-safe; ``pop`` waits."""

    def __init__(self, maxsize: int, weight: int = 4, clock=None):
        self.maxsize = max(1, int(maxsize))
        self.weight = max(1, int(weight))
        self._heaps: dict[str, list] = {k: [] for k in CLASSES}
        self._count: dict[str, int] = {k: 0 for k in CLASSES}
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._streak = 0  # interactive pops in a row while batch waits
        self._clock = clock if clock is not None else time.monotonic

    # -- introspection -------------------------------------------------

    def qsize(self) -> int:
        with self._cond:
            return sum(self._count.values())

    def waiting(self, klass: str) -> int:
        with self._cond:
            return self._count[klass]

    def _live_locked(self):
        return (it for heap in self._heaps.values() for _, it in heap if not it._removed)

    def waiting_started(self) -> int:
        """Checkpointed (preempted) streams still waiting to resume."""
        with self._cond:
            return sum(1 for it in self._live_locked() if it.started)

    def next_deadline(self) -> float | None:
        """The earliest deadline among waiters that can expire."""
        with self._cond:
            return min((it.deadline for it in self._live_locked()
                        if not it.started and it.deadline is not None), default=None)

    # -- enqueue -------------------------------------------------------

    def put(self, item, force: bool = False):
        """Enqueue; returns an evicted lower-ranked waiter (the caller fails
        it with a 503) or None.  Raises ``QueueFullError`` when full and the
        newcomer outranks nobody.  ``force`` bypasses the bound (a preempted
        stream queued again, or a bound the caller enforces itself)."""
        with self._cond:
            victim = None
            if not force and sum(self._count.values()) >= self.maxsize:
                victim = self._pick_victim_locked(item)
                if victim is None:
                    raise QueueFullError(
                        f"queue depth {sum(self._count.values())} >= {self.maxsize}")
                self._remove_locked(victim)
            item._removed = False
            heapq.heappush(self._heaps[item.klass], ((_dl(item), next(self._seq)), item))
            self._count[item.klass] += 1
            self._cond.notify()
            return victim

    def evict_for(self, incoming):
        """Shed for admission without enqueueing: remove and return the
        waiter ``incoming`` outranks, or None (for callers whose bound is
        wider than the queue, as the stream loop's counts its slots)."""
        with self._cond:
            victim = self._pick_victim_locked(incoming)
            if victim is not None:
                self._remove_locked(victim)
            return victim

    def _remove_locked(self, item) -> None:
        item._removed = True
        self._count[item.klass] -= 1

    def _pick_victim_locked(self, incoming):
        """The lowest-class, latest-deadline waiter ``incoming`` outranks:
        a strictly lower class, or the same class with a strictly later
        deadline.  Started items are never evicted."""
        inc_rank = CLASSES.index(incoming.klass)
        for v_rank in range(len(CLASSES) - 1, -1, -1):  # lowest class first
            live = [it for _, it in self._heaps[CLASSES[v_rank]]
                    if not it._removed and not it.started]
            if not live:
                continue
            victim = max(live, key=_dl)
            if inc_rank < v_rank or (inc_rank == v_rank and _dl(incoming) < _dl(victim)):
                return victim
            return None
        return None

    # -- dequeue -------------------------------------------------------

    def pop_nowait(self, fits=None):
        """EDF within a class, class-weighted across classes; None when
        empty, or when no waiter passes ``fits`` (the KV-budget gate)."""
        with self._cond:
            return self._pop_locked(fits)

    def pop(self, timeout: float | None = None, fits=None):
        """As ``pop_nowait``, waiting up to ``timeout`` seconds of the
        queue's clock for a waiter that fits; None if none did."""
        until = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                item = self._pop_locked(fits)
                if item is not None:
                    return item
                remaining = None if until is None else until - self._clock()
                if remaining is not None and remaining <= 0:
                    return None
                if not self._cond.wait(timeout=remaining):
                    return self._pop_locked(fits)

    def prefer_interactive(self) -> None:
        """Reset the weighted-dequeue streak so the next pop serves the
        interactive class (after a preemption: the vacated slot must not go
        back to the batch class)."""
        with self._cond:
            self._streak = 0

    def _pop_locked(self, fits):
        for klass in self._class_order_locked():
            item = self._pop_class_locked(klass, fits)
            if item is not None:
                if klass == INTERACTIVE and self._count[BATCH] > 0:
                    self._streak += 1
                else:
                    self._streak = 0
                return item
        return None

    def _class_order_locked(self):
        if self._count[INTERACTIVE] and self._count[BATCH]:
            if self._streak >= self.weight:
                return (BATCH, INTERACTIVE)
            return (INTERACTIVE, BATCH)
        return (INTERACTIVE, BATCH) if self._count[INTERACTIVE] else (BATCH, INTERACTIVE)

    def _pop_class_locked(self, klass: str, fits):
        heap = self._heaps[klass]
        stash = []
        found = None
        while heap:
            key, it = heapq.heappop(heap)
            if it._removed:
                continue
            if fits is not None and not fits(it):
                # The head does not fit the budget: look past it (a smaller
                # one may); expiry bounds how long a skipped head waits.
                stash.append((key, it))
                continue
            self._remove_locked(it)
            found = it
            break
        for entry in stash:
            heapq.heappush(heap, entry)
        return found

    # -- expiry / shutdown ---------------------------------------------

    def expire(self, now: float | None = None) -> list:
        """Remove and return every waiter whose deadline has passed (at
        ``now``, default the queue's clock); started items never expire."""
        now = self._clock() if now is None else now
        out = []
        with self._cond:
            for klass in CLASSES:
                heap = self._heaps[klass]
                repush = []
                while heap and heap[0][0][0] <= now:
                    key, it = heapq.heappop(heap)
                    if it._removed:
                        continue
                    if it.started:
                        repush.append((key, it))
                        continue
                    self._remove_locked(it)
                    out.append(it)
                for entry in repush:
                    heapq.heappush(heap, entry)
        return out

    def drain_all(self) -> list:
        """Remove and return every waiter, each class in pop order
        (shutdown)."""
        with self._cond:
            out = [it for klass in CLASSES
                   for _, it in sorted(self._heaps[klass], key=lambda e: e[0])
                   if not it._removed]
            for it in out:
                it._removed = True
            self._heaps = {k: [] for k in CLASSES}
            self._count = {k: 0 for k in CLASSES}
            return out
