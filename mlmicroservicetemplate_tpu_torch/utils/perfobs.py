"""Always-on device-time and MFU attribution: the perf observatory.

Counterpart of the JAX package's ``utils/perfobs.py``, with its accounting
model unchanged.  Per-site host time is always measured
(``dispatch_host_seconds{site}``); the device half, which ``TRACE=1``
measures by synchronizing every dispatch, is estimated here from
timestamps the serving loop already takes, with no added synchronisation:

- every guarded dispatch is **stamped at submit** (``on_guard``, with the
  two clock reads ``dispatch_guard`` already pays);
- **completion is sampled at the fetch seams** the loop already has
  (``note_complete`` from the loop's ``_deliver_ready``, ``_deliver_oldest``,
  ``_deliver_all`` and ``_admit_complete``, and the per-stream fetches of
  ``engine/engine.py``): the host seeing a dispatch's outputs land (a
  copy's event that reports done, or a host copy that returned) means the
  dispatch finished on the card, at the latest then.  So the busy time is
  an upper bound on the card's.

One card runs its stream in submission order, so a completion at sequence
``s`` also closes every older pending submit (the linearity rule):
chunked-prefill windows, swap scatters and hand-offs, which have no fetch
of their own, are closed by the next chunk's completion.

**Accounting model** (an estimator): each completion sample at time ``T``
closing pending submits ``P`` adds one busy interval ``[max(prev_busy_end,
min_submit(P)), T]``; the gap before it is device **bubble**.  The interval
is split equally across the closed sites.  Only the paired sites accrue
busy time (``chunk``, ``prefill``, ``prefill_chunk``; ``batch`` is
synchronous and closes itself); the rare unpaired ones (``swap`` and
``handoff`` tails) land in bubble.  ``prep`` host intervals that overlap
device work in flight accrue ``prep_overlap_s``.

**MFU**: ``runtime/compile_cache.py`` counts each CUDA graph's FLOPs and
bytes once, when it is captured, and every replay accrues them per (model,
kind) into the book here.  ``mfu_estimate`` = rolling modeled FLOP rate /
the card's peak (``PEAK_TFLOPS``, else the card table, else unknown: the
gauge stays 0 and ``/debug/perf`` carries the raw components).

``PERF_OBS=0`` turns the layer off: ``on_guard`` and ``note_*`` return
before touching any state, and captures count nothing.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import metrics

# The process-level switch, set from ServiceConfig when an engine is built
# and read by the graph cache's cost count; on by default, as the
# reference's.
_ENABLED = os.environ.get("PERF_OBS", "1").lower() not in ("0", "false", "no")


def configure(enabled: bool) -> None:
    """Set the process-level switch (the last engine built wins)."""
    global _ENABLED
    _ENABLED = bool(enabled)


def enabled() -> bool:
    return _ENABLED


# ---------------------------------------------------------------------------
# the modeled-FLOP book, per (model, kind), fed by graph replays

_BOOK_LOCK = threading.Lock()
_BOOK: dict[str, dict] = {}  # model -> {"flops", "bytes", "by_kind": {}}
# The modeled-FLOP counter's child per (model, kind): a replay pays a dict
# read, not a ``.labels()`` lookup.
_FLOP_CHILDREN: dict[tuple[str, str], object] = {}


def note_cost(model: str, kind: str, flops: float, bytes_: float) -> None:
    """One replay of a counted graph: accrue its modeled cost (any thread)."""
    with _BOOK_LOCK:
        b = _BOOK.get(model)
        if b is None:
            b = _BOOK[model] = {"flops": 0.0, "bytes": 0.0, "by_kind": {}}
        b["flops"] += flops
        b["bytes"] += bytes_
        b["by_kind"][kind] = b["by_kind"].get(kind, 0.0) + flops
        child = _FLOP_CHILDREN.get((model, kind)) if flops else None
        if flops and child is None:
            child = _FLOP_CHILDREN[(model, kind)] = metrics.MODELED_FLOPS.labels(model, kind)
    if child is not None:
        child.inc(flops)


def book_flops(model: str) -> float:
    """Modeled FLOPs accrued for one model so far (the running total)."""
    with _BOOK_LOCK:
        b = _BOOK.get(model)
        return b["flops"] if b is not None else 0.0


def book_totals(model: str) -> dict:
    """``{"flops", "bytes", "by_kind"}`` accrued for one model so far."""
    with _BOOK_LOCK:
        b = _BOOK.get(model)
        if b is None:
            return {"flops": 0.0, "bytes": 0.0, "by_kind": {}}
        return {"flops": b["flops"], "bytes": b["bytes"], "by_kind": dict(b["by_kind"])}


def reset_book() -> None:
    """Zero the modeled-cost accruals (tests)."""
    with _BOOK_LOCK:
        _BOOK.clear()


# ---------------------------------------------------------------------------
# the card's peak, the MFU denominator

#: Dense bf16 peak FLOP/s by fragment of ``torch.cuda.get_device_name``, from
#: NVIDIA's data sheets (H100 SXM, whose name reads "H100 80GB HBM3"; H100
#: PCIe); ``PEAK_TFLOPS`` overrides.  The CPU has no entry: MFU stays unknown.
_PEAK_BY_NAME = (
    ("h100 80gb hbm3", 989.4e12),
    ("h100 sxm", 989.4e12),
    ("h100 pcie", 756e12),
)


def peak_flops(cfg=None) -> float:
    """Peak FLOP/s of the MFU estimate: ``PEAK_TFLOPS`` when set, else the
    card table's entry for ``torch.cuda.get_device_name``, else 0.0
    (unknown; always on the CPU)."""
    knob = float(getattr(cfg, "peak_tflops", 0.0) or 0.0) if cfg is not None else 0.0
    if not knob:
        try:
            knob = float(os.environ.get("PEAK_TFLOPS", "0") or 0.0)
        except ValueError:
            knob = 0.0
    if knob:
        return knob * 1e12
    if cfg is not None and getattr(cfg, "device", "cuda") != "cuda":
        return 0.0
    try:
        import torch

        if not torch.cuda.is_available():
            return 0.0
        name = torch.cuda.get_device_name(0).lower()
    except (ImportError, RuntimeError):
        return 0.0
    for frag, peak in _PEAK_BY_NAME:
        if frag in name:
            return peak
    return 0.0


# ---------------------------------------------------------------------------
# the per-engine occupancy estimator


class DeviceOccupancy:
    """Device busy / bubble estimator for one engine, with no added
    synchronisation (the module docstring has the accounting model).
    Thread-safe: submits come from the loop's and the per-stream threads,
    completions from whichever thread saw the outputs land."""

    #: Sites whose submits a fetch seam pairs.
    TRACKED_SITES = frozenset({"chunk", "prefill", "prefill_chunk"})
    #: Synchronous sites: the guarded call holds its own fetch, so the
    #: guard's return is the completion (the whole-batch path).
    SYNC_SITES = frozenset({"batch"})
    #: Host-side prep (the staged host prep): overlap accounting only.
    HOST_SITES = frozenset({"prep"})
    #: Pending-submit bound: a path that never completes must not grow.
    MAX_PENDING = 4096

    def __init__(self, model: str, enabled: bool = True, peak_flops: float = 0.0,
                 clock=time.perf_counter, window_s: float = 60.0):
        self.model = model
        self.enabled = bool(enabled)
        self.peak_flops = float(peak_flops)
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._pending: dict[str, deque] = {}  # site -> deque[(seq, ts)]
        self._pending_total = 0
        self._epoch = clock()
        self._busy_end: float | None = None
        self.busy_s: dict[str, float] = {}
        self.bubble_s = 0.0
        self.prep_overlap_s = 0.0
        self.prep_host_s = 0.0
        self.samples = 0
        self.dropped_submits = 0
        # Rolling MFU ring: (ts, cumulative modeled flops) at completions.
        self._flops_ring: deque = deque(maxlen=2048)
        self._last_gauge = 0.0
        # Metric children, each looked up once, at its first use (a
        # completion then pays dict reads, not ``.labels()`` lookups).
        self._children: dict[tuple, object] = {}

    def on_guard(self, site: str, t0: float, t1: float) -> None:
        """One guarded dispatch returned: stamp it, with the two clock reads
        ``dispatch_guard`` already paid."""
        if not self.enabled:
            return
        if site in self.HOST_SITES:
            with self._lock:
                self.prep_host_s += t1 - t0
                if self._pending_total:
                    # Host prep while device work was in flight.
                    self.prep_overlap_s += t1 - t0
            return
        if site in self.SYNC_SITES:
            with self._lock:
                self._account_locked([site], t0, t1)
            return
        if site not in self.TRACKED_SITES:
            return
        with self._lock:
            q = self._pending.setdefault(site, deque())
            if self._pending_total >= self.MAX_PENDING:
                # An unpaired path: drop the oldest rather than grow.
                for qq in self._pending.values():
                    if qq:
                        qq.popleft()
                        self._pending_total -= 1
                        self.dropped_submits += 1
                        break
            self._seq += 1
            q.append((self._seq, t0))
            self._pending_total += 1

    def note_complete(self, site: str, n: int = 1) -> None:
        """A fetch seam saw ``n`` dispatches of ``site`` land: close them
        and, by linearity, every older pending submit of any site, and
        account the busy interval."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            q = self._pending.get(site)
            if not q:
                return
            closed: list[tuple[int, float, str]] = []
            for _ in range(min(n, len(q))):
                seq, ts = q.popleft()
                self._pending_total -= 1
                closed.append((seq, ts, site))
            max_seq = closed[-1][0]
            for other, qq in self._pending.items():
                while qq and qq[0][0] < max_seq:
                    seq, ts = qq.popleft()
                    self._pending_total -= 1
                    closed.append((seq, ts, other))
            t0 = min(ts for _, ts, _ in closed)
            self._account_locked([s for _, _, s in closed], t0, now)

    def _account_locked(self, sites: list[str], t0: float, t1: float) -> None:
        start = t0 if self._busy_end is None else max(self._busy_end, t0)
        if self._busy_end is not None and start > self._busy_end:
            gap = start - self._busy_end
            self.bubble_s += gap
            self._child(metrics.DEVICE_BUBBLE).inc(gap)
        busy = max(0.0, t1 - start)
        self._busy_end = max(t1, self._busy_end or t1)
        self.samples += 1
        share = busy / len(sites)
        for s in sites:
            self.busy_s[s] = self.busy_s.get(s, 0.0) + share
            if share:
                self._child(metrics.DEVICE_BUSY, s).inc(share)
        self._flops_ring.append((t1, book_flops(self.model)))
        if t1 - self._last_gauge >= 1.0:
            self._last_gauge = t1
            self._child(metrics.MFU).set(self._mfu_locked(t1))

    def _child(self, metric, *labels):
        """``metric``'s child for this model and ``labels``, cached."""
        key = (metric, labels)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = metric.labels(self.model, *labels)
        return child

    def _mfu_locked(self, now: float) -> float:
        if not self.peak_flops or not self._flops_ring:
            return 0.0
        newest_ts, newest = self._flops_ring[-1]
        oldest_ts, oldest = self._flops_ring[0]
        for ts, cum in self._flops_ring:
            if ts >= now - self.window_s:
                oldest_ts, oldest = ts, cum
                break
        span = newest_ts - oldest_ts
        if span <= 0:
            # One sample in the window: the rate since the epoch.
            span = max(now - self._epoch, 1e-9)
            oldest = 0.0
        return (newest - oldest) / span / self.peak_flops

    def snapshot(self) -> dict:
        """``/debug/perf`` and ``/status.perf``."""
        now = self._clock()
        with self._lock:
            busy_total = sum(self.busy_s.values())
            elapsed = max(now - self._epoch, 1e-9)
            book = book_totals(self.model)
            peak = self.peak_flops
            return {
                "enabled": self.enabled,
                "model": self.model,
                "elapsed_s": round(elapsed, 4),
                "device_busy_s": {k: round(v, 4) for k, v in sorted(self.busy_s.items())},
                "device_busy_total_s": round(busy_total, 4),
                "device_bubble_s": round(self.bubble_s, 4),
                "busy_ratio": (round(busy_total / (busy_total + self.bubble_s), 4)
                               if busy_total + self.bubble_s > 0 else None),
                "prep_host_s": round(self.prep_host_s, 4),
                "prep_overlap_s": round(self.prep_overlap_s, 4),
                "completion_samples": self.samples,
                "pending_dispatches": self._pending_total,
                "dropped_submits": self.dropped_submits,
                "modeled_flops_total": book["flops"],
                "modeled_bytes_total": book["bytes"],
                "modeled_flops_by_kind": dict(sorted(book["by_kind"].items())),
                "peak_flops": peak,
                "mfu_estimate": round(self._mfu_locked(now), 6) if peak else None,
                # Modeled flops over the busy union (what the card sustained
                # while it ran) and over the whole epoch.
                "mfu_busy": (round(book["flops"] / busy_total / peak, 6)
                             if peak and busy_total > 0 else None),
                "mfu_epoch": round(book["flops"] / elapsed / peak, 6) if peak else None,
            }


def merge_snapshots(snaps: list[dict]) -> dict:
    """Sum the additive fields of several occupancy snapshots (ratios
    recomputed from the sums); the modeled-FLOP book is per model, so it
    comes from the first snapshot."""
    out: dict = {
        "replicas": len(snaps),
        "device_busy_total_s": 0.0,
        "device_bubble_s": 0.0,
        "prep_overlap_s": 0.0,
        "modeled_flops_total": 0.0,
        "completion_samples": 0,
        "device_busy_s": {},
    }
    for s in snaps:
        out["device_busy_total_s"] += s.get("device_busy_total_s", 0.0)
        out["device_bubble_s"] += s.get("device_bubble_s", 0.0)
        out["prep_overlap_s"] += s.get("prep_overlap_s", 0.0)
        out["completion_samples"] += s.get("completion_samples", 0)
        for k, v in (s.get("device_busy_s") or {}).items():
            out["device_busy_s"][k] = out["device_busy_s"].get(k, 0.0) + v
    busy, bubble = out["device_busy_total_s"], out["device_bubble_s"]
    out["busy_ratio"] = round(busy / (busy + bubble), 4) if busy + bubble > 0 else None
    if snaps:
        out["modeled_flops_total"] = snaps[0].get("modeled_flops_total", 0.0)
        out["mfu_estimate"] = snaps[0].get("mfu_estimate")
    return out
