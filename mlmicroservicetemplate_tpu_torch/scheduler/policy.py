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
- Fair share (``TENANTS``, ``set_fairshare``): within a class the
  ``tenancy.fairshare.WeightedFairShare`` picks the tenant, and that
  tenant's earliest-deadline waiter is served; without it the pop is plain
  EDF.

``PrefillPacer`` paces chunked prefill's windows against live decode,
``DecodeWindowGovernor`` picks the loop's fused decode window (both write
their decisions to the engine's flight recorder, ``recorder``),
``BackfillGovernor`` caps a bulk job's lines in flight, and ``SLOTracker``
turns the loop's TTFT and TBT samples into SLO burn rates.  The scaling
governor is not ported.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque

from ..utils import metrics

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


class PrefillPacer:
    """Which prefill windows may dispatch at a chunk boundary (chunked
    prefill, ``engine/streams.py``), mirroring the dequeue weights:
    interactive-class prefill always advances (holding it back only moves
    its own TTFT); batch-class prefill is held while interactive decode is
    live, except one window every ``weight`` boundaries so it cannot
    starve; with no interactive decode running it backfills freely.
    ``recorder`` (the engine's flight recorder, wired by the loop) gets
    every hold and grant of a batch window as an event."""

    def __init__(self, weight: int = 4):
        self.weight = max(1, int(weight))
        self._held = 0
        self.recorder = None
        # Decisions so far that held a batch window back.
        self.holds = 0

    def allow(self, job_klass: str, interactive_active: bool) -> bool:
        """May a ``job_klass`` window dispatch now, given whether
        interactive decode is live?"""
        if job_klass == INTERACTIVE or not interactive_active:
            return True
        self._held += 1
        if self._held >= self.weight:
            self._held = 0
            if self.recorder is not None:
                self.recorder.event("pacer_grant", klass=job_klass, weight=self.weight)
            return True
        self.holds += 1
        if self.recorder is not None:
            self.recorder.event("pacer_hold", klass=job_klass, held=self._held,
                                weight=self.weight)
        return False


class DecodeWindowGovernor:
    """The fused decode window's depth W for one dispatch of the
    continuous loop (``DECODE_WINDOW``, ``engine/streams.py``).  A deep
    window divides the host's dispatches and fetches per token by W but
    widens every boundary the host sees (token delivery, admission,
    preemption, prefill interleave) to W chunks.  So, as the reference:

    - interactive streams live or waiting: W = 1 (their cadence binds at
      chunk granularity);
    - batch-only traffic: fuse up to the cap;
    - never past the chunks a live stream still needs, floored to a power
      of two, so the depths stay {1, 2, 4, ...}.

    ``auto=False`` always fuses to the cap.  ``recorder`` (the engine's
    flight recorder, wired by the loop) gets each drop to W = 1 as an
    event."""

    def __init__(self, cap: int, auto: bool = True):
        self.cap = max(1, int(cap))
        self.auto = bool(auto)
        self.recorder = None
        self._last = 1

    def pick(self, max_chunks: int, interactive_live: bool,
             interactive_waiting: bool) -> int:
        if self.cap <= 1 or max_chunks <= 1:
            return 1
        w = self.preview(max_chunks, interactive_live, interactive_waiting)
        if w == 1 and self._last > 1 and self.recorder is not None:
            self.recorder.event("window_drop", live=bool(interactive_live),
                                waiting=bool(interactive_waiting))
        self._last = w
        return w

    def preview(self, max_chunks: int, interactive_live: bool,
                interactive_waiting: bool) -> int:
        """``pick`` without its side effects (the last depth, the
        recorder)."""
        if self.cap <= 1 or max_chunks <= 1:
            return 1
        if self.auto and (interactive_live or interactive_waiting):
            return 1
        w = min(self.cap, int(max_chunks))
        return 1 << (w.bit_length() - 1)


class BackfillGovernor:
    """How many lines of a bulk job may be in flight now
    (``JOB_MAX_CONCURRENT_LINES``; ``jobs/executor.py``).  Lines are
    batch-class streams, so once admitted the class weights and
    preemption protect interactive work; this bounds how hard the executor
    pushes on admission: the whole cap with no interactive work anywhere,
    half of it while interactive streams decode, one line while
    interactive work waits."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))

    def target(self, interactive_live: bool, interactive_waiting: bool) -> int:
        if interactive_waiting:
            return 1
        if interactive_live:
            return max(1, self.cap // 2)
        return self.cap


class SLOTracker:
    """Per-priority-class latency SLO burn rates, as the reference's.

    Objectives come from ``SLO_TTFT_MS`` / ``SLO_TBT_MS`` (interactive
    class) and ``SLO_BATCH_TTFT_MS`` / ``SLO_BATCH_TBT_MS``; 0 turns that
    (kind, class) objective off.  Each delivery the loop already measures
    (TTFT at a stream's first chunk, TBT at each later gap,
    ``engine/streams.py::_emit_tokens``) is scored good or bad against its
    objective, and the burn rate over a window is::

        burn = (bad / total within window) / (1 - SLO_TARGET)

    1.0 spends the error budget at exactly the sustainable rate.  The fast
    window (``SLO_WINDOWS_S``'s first) reacts, the slow one filters blips.
    Exported as ``slo_{ttft,tbt}_burn_rate{klass, window}`` (at most about
    once a second).  The clock is injectable, each objective keeps one
    deque pruned to the slow window, and notes and reads are thread-safe.
    The reference's scaling governor, which reads ``worst_burn``, comes
    with the fleet."""

    KINDS = ("ttft", "tbt")
    WINDOW_NAMES = ("fast", "slow")

    def __init__(self, model: str, objectives: dict, target: float = 0.99,
                 windows_s: tuple = (60.0, 600.0), clock=None, max_samples: int = 4096):
        self.model = model
        #: {(kind, klass): objective seconds}, the enabled ones only.
        self.objectives = {k: float(v) for k, v in objectives.items() if v and v > 0}
        self.target = float(target)
        self.windows_s = (float(windows_s[0]), float(windows_s[1]))
        self._budget = max(1e-9, 1.0 - self.target)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._max_samples = int(max_samples)
        self._samples: dict = {key: deque(maxlen=self._max_samples) for key in self.objectives}
        self._last_export = 0.0

    @classmethod
    def from_cfg(cls, model: str, cfg, clock=None):
        """A tracker from the service knobs, or None when every objective
        is 0 (the default): no work on the delivery path."""
        objectives = {
            ("ttft", INTERACTIVE): float(getattr(cfg, "slo_ttft_ms", 0.0) or 0.0) / 1e3,
            ("tbt", INTERACTIVE): float(getattr(cfg, "slo_tbt_ms", 0.0) or 0.0) / 1e3,
            ("ttft", BATCH): float(getattr(cfg, "slo_batch_ttft_ms", 0.0) or 0.0) / 1e3,
            ("tbt", BATCH): float(getattr(cfg, "slo_batch_tbt_ms", 0.0) or 0.0) / 1e3,
        }
        if not any(v > 0 for v in objectives.values()):
            return None
        windows = getattr(cfg, "slo_windows_s", None) or "60,600"
        try:
            parts = [float(x) for x in str(windows).split(",") if x.strip()]
        except ValueError:
            parts = [60.0, 600.0]
        if len(parts) != 2 or parts[0] <= 0 or parts[0] >= parts[1]:
            parts = [60.0, 600.0]
        return cls(model, objectives, target=float(getattr(cfg, "slo_target", 0.99) or 0.99),
                   windows_s=(parts[0], parts[1]), clock=clock)

    def note(self, kind: str, klass: str, value_s: float) -> None:
        obj = self.objectives.get((kind, klass))
        if obj is None:
            return
        now = self._clock()
        with self._lock:
            q = self._samples[(kind, klass)]
            q.append((now, value_s <= obj))
            horizon = now - self.windows_s[1]
            while q and q[0][0] < horizon:
                q.popleft()
            export = now - self._last_export >= 1.0
            if export:
                self._last_export = now
        if export:
            self.export_gauges(now)

    def burn_rate(self, kind: str, klass: str, window_s: float | None = None,
                  now: float | None = None) -> float:
        """The burn rate over ``window_s`` (default the fast window); 0.0
        with no samples."""
        if (kind, klass) not in self.objectives:
            return 0.0
        window = self.windows_s[0] if window_s is None else float(window_s)
        now = self._clock() if now is None else now
        horizon = now - window
        with self._lock:
            total = bad = 0
            for ts, good in reversed(self._samples[(kind, klass)]):
                if ts < horizon:
                    break
                total += 1
                if not good:
                    bad += 1
        if not total:
            return 0.0
        return (bad / total) / self._budget

    def worst_burn(self) -> float:
        """The largest fast-window burn across the enabled objectives."""
        return max((self.burn_rate(kind, klass) for kind, klass in self.objectives),
                   default=0.0)

    def export_gauges(self, now: float | None = None) -> None:
        """Set the burn-rate gauges of every (objective, window)."""
        now = self._clock() if now is None else now
        for (kind, klass) in self.objectives:
            gauge = metrics.SLO_TTFT_BURN if kind == "ttft" else metrics.SLO_TBT_BURN
            for name, win in zip(self.WINDOW_NAMES, self.windows_s):
                gauge.labels(self.model, klass, name).set(
                    self.burn_rate(kind, klass, win, now=now))

    def snapshot(self) -> dict:
        """``/status.perf.slo`` and ``/debug/perf``: objectives and burn
        rates."""
        now = self._clock()
        out: dict = {
            "target": self.target,
            "windows_s": list(self.windows_s),
            "objectives_ms": {f"{kind}:{klass}": round(obj * 1e3, 3)
                              for (kind, klass), obj in sorted(self.objectives.items())},
            "burn": {},
        }
        for (kind, klass) in sorted(self.objectives):
            for name, win in zip(self.WINDOW_NAMES, self.windows_s):
                out["burn"][f"{kind}:{klass}:{name}"] = round(
                    self.burn_rate(kind, klass, win, now=now), 4)
        with self._lock:
            out["samples"] = {f"{kind}:{klass}": len(self._samples[(kind, klass)])
                              for (kind, klass) in sorted(self.objectives)}
        return out


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
        # Weighted fair share across tenants within a class (TENANTS; set by
        # the batcher); None: plain EDF.
        self._fairshare = None
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

    def set_fairshare(self, fs) -> None:
        """Attach (or, with None, detach) a ``WeightedFairShare``: within
        each class the tenant with the lowest virtual time is served its
        earliest-deadline waiter, so one tenant's backlog cannot starve
        another's."""
        with self._cond:
            self._fairshare = fs

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
        if self._fairshare is not None:
            return self._pop_class_fair_locked(klass, fits, self._fairshare)
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

    def _pop_class_fair_locked(self, klass: str, fits, fs):
        """The fair pop: each tenant's earliest-deadline waiter that
        ``fits``, then the fair share picks the tenant and is charged.  A
        scan of the heap (lazy deletion keeps its EDF order for the plain
        pop and ``expire``); it reorders across tenants only, never within
        one."""
        heads: dict[str, tuple] = {}
        for key, it in self._heaps[klass]:
            if it._removed or (fits is not None and not fits(it)):
                continue
            t = getattr(it, "tenant", "") or ""
            cur = heads.get(t)
            if cur is None or key < cur[0]:
                heads[t] = (key, it)
        if not heads:
            return None
        tenant = fs.pick(heads.keys())
        it = heads[tenant][1]
        self._remove_locked(it)
        fs.charge(tenant)
        return it

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
