"""The wait-queue policy of the dynamic batcher and the continuous loop.

The parts of the JAX package's ``scheduler/policy.py`` that the port
uses: the shed and deadline errors and one bounded earliest-deadline-first
queue (FIFO among waiters with equal deadlines or none, so without
deadlines it is plain FIFO), the ``/predict`` path's request queue and the
continuous decode loop's stream queue (the JAX stream ``DeadlineQueue`` cut
to one class).  Priority classes, eviction, fair share and the KV budget
are not ported.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time


class QueueFullError(Exception):
    """Queue at capacity; shed load (HTTP 503 + Retry-After)."""

    def __init__(self, msg: str = "", reason: str = "queue_full",
                 retry_after_s: float | None = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceededError(Exception):
    """The request's deadline passed while it waited (HTTP 504)."""


class DeadlineQueue:
    """Bounded EDF wait queue.  Items expose ``deadline``: absolute seconds
    on the queue's clock (``time.monotonic`` unless one is injected, so
    tests pin expiry without sleeping), or None for no deadline, which
    ranks after every deadline.  Thread-safe; ``pop`` waits."""

    def __init__(self, maxsize: int, clock=None):
        self.maxsize = max(1, int(maxsize))
        self._heap: list = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._clock = clock if clock is not None else time.monotonic

    @staticmethod
    def _key(item) -> float:
        return item.deadline if item.deadline is not None else float("inf")

    def qsize(self) -> int:
        with self._cv:
            return len(self._heap)

    def next_deadline(self) -> float | None:
        with self._cv:
            return min((it.deadline for _, _, it in self._heap
                        if it.deadline is not None), default=None)

    def put(self, item) -> None:
        with self._cv:
            if len(self._heap) >= self.maxsize:
                raise QueueFullError(f"queue depth {len(self._heap)} >= {self.maxsize}")
            heapq.heappush(self._heap, (self._key(item), next(self._seq), item))
            self._cv.notify()

    def pop_nowait(self):
        with self._cv:
            return heapq.heappop(self._heap)[2] if self._heap else None

    def pop(self, timeout: float):
        """The first waiter, waiting up to ``timeout`` seconds of the
        queue's clock; None if none arrived."""
        until = self._clock() + timeout
        with self._cv:
            while not self._heap:
                remaining = until - self._clock()
                if remaining <= 0 or not self._cv.wait(remaining):
                    break
            return heapq.heappop(self._heap)[2] if self._heap else None

    def expire(self, now: float | None = None) -> list:
        """Remove and return every waiter whose deadline has passed (at
        ``now``, default the queue's clock)."""
        now = self._clock() if now is None else now
        out = []
        with self._cv:
            while self._heap and self._heap[0][0] <= now:
                out.append(heapq.heappop(self._heap)[2])
        return out

    def drain_all(self) -> list:
        """Remove and return every waiter (shutdown)."""
        with self._cv:
            out = [it for _, _, it in sorted(self._heap, key=lambda e: e[:2])]
            self._heap.clear()
            return out
