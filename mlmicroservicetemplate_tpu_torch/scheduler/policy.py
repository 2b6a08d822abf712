"""The wait-queue policy of the dynamic batcher.

The parts of the JAX package's ``scheduler/policy.py`` that the
``/predict`` path uses: the shed and deadline errors and a bounded
earliest-deadline-first queue (FIFO among requests without a deadline,
so the default is plain FIFO); and for the continuous decode loop a
bounded FIFO of waiting streams.  Priority classes, fair share and the KV
budget are not ported.
"""

from __future__ import annotations

import collections
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
    """Bounded EDF wait queue.  Items expose ``deadline`` (absolute
    ``time.monotonic()`` seconds, or None for no deadline)."""

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._heap: list = []
        self._seq = itertools.count()
        self._lock = threading.Lock()

    @staticmethod
    def _key(item) -> float:
        return item.deadline if item.deadline is not None else float("inf")

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)

    def next_deadline(self) -> float | None:
        with self._lock:
            return min((it.deadline for _, _, it in self._heap
                        if it.deadline is not None), default=None)

    def put(self, item) -> None:
        with self._lock:
            if len(self._heap) >= self.maxsize:
                raise QueueFullError(f"queue depth {len(self._heap)} >= {self.maxsize}")
            heapq.heappush(self._heap, (self._key(item), next(self._seq), item))

    def pop_nowait(self):
        with self._lock:
            return heapq.heappop(self._heap)[2] if self._heap else None

    def expire(self) -> list:
        """Remove and return every waiter whose deadline has passed."""
        now = time.monotonic()
        out = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                out.append(heapq.heappop(self._heap)[2])
        return out


class StreamQueue:
    """Bounded FIFO of streams waiting for a slot of the continuous decode
    loop: the plain-FIFO cut of the JAX package's stream ``DeadlineQueue``
    (no priority classes, deadlines or eviction).  Thread-safe; the loop
    thread pops with a timeout."""

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._items: collections.deque = collections.deque()
        self._cv = threading.Condition()

    def qsize(self) -> int:
        with self._cv:
            return len(self._items)

    def put(self, item) -> None:
        with self._cv:
            if len(self._items) >= self.maxsize:
                raise QueueFullError(f"stream queue depth {len(self._items)} >= {self.maxsize}")
            self._items.append(item)
            self._cv.notify()

    def pop_nowait(self):
        with self._cv:
            return self._items.popleft() if self._items else None

    def pop(self, timeout: float):
        """The oldest waiter, waiting up to ``timeout`` seconds; None if
        none arrived."""
        with self._cv:
            if not self._items:
                self._cv.wait(timeout)
            return self._items.popleft() if self._items else None

    def drain_all(self) -> list:
        with self._cv:
            out = list(self._items)
            self._items.clear()
            return out
