"""Process-level table of captured CUDA graphs: one graph per bucket.

Counterpart of the JAX package's ``runtime/compile_cache.py``.  The JAX
package never dispatches op by op: every bucket is one compiled
executable, shared through ``ExecutableCache`` and compiled ahead of time
at warmup.  The port's counterpart of an executable is a CUDA graph: the
bucket's kernels captured once with their arguments, then replayed with
one host call per dispatch.

Key discipline, as in the JAX module:

    (bundle fingerprint, kind, static descriptor, placement)

- the **fingerprint** is a token minted per object and stored on it
  (``fingerprint``): two bundles never share one, even with equal names;
- the **kind** names the code path: ``forward``, ``forward_images``,
  ``start`` (prefill plus the first decode chunk), ``gen_chunk``,
  ``loop_chunk``, ``loop_chunk_paged`` (``KINDS``);
- the **descriptor** spells out what the captured call closes over
  besides the bundle: the bucket's shapes, the compute type, the KV
  quantization, and, for the continuous loop, the token of the slot state
  whose buffers the graph reads and writes in place;
- the **placement** is the device set the call runs on.

An entry (``GraphEntry``) holds the graph, its static input and output
tensors and, read at capture, how many times each hand-written kernel
launches inside it.  The kernels' launch counters (``fused_attention``,
``decode_attention``, ``paged_decode_attention``, ``ring_hop``; each
wrapper joins ``LAUNCH_COUNTERS`` at import through ``counts_launches``)
are bumped in Python by their wrappers, so a replay, which runs no Python,
would count nothing: each replay adds the counts recorded at capture, and
the capture itself (which launches nothing on the card) takes back what
its Python bumped.  Each counter keeps meaning "launches on the card".

Capture (``capture_graph``) first runs the call eagerly on a side stream:
that builds every lazy thing a capture may not build (cuBLAS and cuDNN
handles and plans, the kernel libraries' load, each kernel's
once-per-device shared-memory attribute and the TMA encoder's entry
point).  The eager run does the call's work: a call that updates state in
place is captured before that state holds anything live.  A capture that
fails raises; there is no eager fallback.

Every graph of a process allocates from one memory pool per device.  A
tensor a graph frees during its capture may hold another graph's output
later, so a graph's outputs are valid only until another graph of the
pool replays.  The pool's lock (``device_lock``) keeps that true: every
engine on the card takes it as its own dispatch lock, so every replay
into the pool, and the read of its outputs (to the host, or into the
loop's slot state), happen under it, whichever engine dispatches.  A
generation's ``gen_chunk`` replays only after its own bucket's ``start``
rewrote the state it reads.  The pool's first graph is held for the life
of the process: once every graph of a pool is gone, the caching allocator
refuses the pool's id to the next capture (an internal assert), and
graphs captured outside the cache come and go.  Static inputs are
allocated outside the pool.

Import-light: nothing here touches CUDA at import.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable

from ..utils import metrics

KINDS = ("forward", "forward_images", "start", "gen_chunk", "loop_chunk", "loop_chunk_paged")

_fp_lock = threading.Lock()
_fp_counter = itertools.count()


def fingerprint(obj: Any) -> str:
    """``obj``'s cache identity: a token minted on first use and stored on
    the object; distinct objects never share one."""
    fp = getattr(obj, "_graph_fingerprint", None)
    if fp is None:
        with _fp_lock:
            fp = getattr(obj, "_graph_fingerprint", None)
            if fp is None:
                fp = f"{getattr(obj, 'name', type(obj).__name__)}#{next(_fp_counter)}"
                obj._graph_fingerprint = fp
    return fp


def placement_key(devices) -> tuple:
    """The device set a call runs on, as a hashable key."""
    return tuple(str(d) for d in devices)


# Kernel wrappers whose ``launches`` graph entries keep current, by name.
LAUNCH_COUNTERS: dict[str, Any] = {}


def counts_launches(wrapper: Callable) -> Callable:
    """Register a kernel wrapper that adds one to ``wrapper.launches`` per
    launch (starting from 0), so that captures and replays account for
    its launches; returns the wrapper."""
    wrapper.launches = 0
    LAUNCH_COUNTERS[wrapper.__name__] = wrapper
    return wrapper


@dataclasses.dataclass
class GraphEntry:
    """One captured call: replay it after writing its static inputs; read
    its static outputs before another graph replays."""

    kind: str
    graph: Any  # torch.cuda.CUDAGraph, or anything with ``replay()``
    inputs: Any
    outputs: Any
    launches: dict[str, int]  # kernel name -> launches in one replay
    capture_s: float
    replays: int = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            LAUNCH_COUNTERS[name].launches += n


_pool_lock = threading.Lock()
# device index -> [pool handle, the first graph captured into the pool]
_POOLS: dict[int, list] = {}
# device index -> the lock of its pool's replays
_DEVICE_LOCKS: dict[int, threading.RLock] = {}


def _index(device) -> int:
    import torch

    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def device_lock(device) -> threading.RLock:
    """The lock of ``device``'s graph pool: a replay into the pool and the
    read of its outputs happen under it.  Every engine on the card
    dispatches under it."""
    index = _index(device)
    with _pool_lock:
        return _DEVICE_LOCKS.setdefault(index, threading.RLock())


def graph_pool_bytes() -> int:
    """Device memory the graph pools hold (segments of the caching
    allocator reserved for them)."""
    import torch

    with _pool_lock:
        pools = {tuple(p[0]) for p in _POOLS.values()}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def capture_graph(kind: str, fn: Callable[[], Any], inputs: Any, device) -> GraphEntry:
    """Run ``fn`` once eagerly on a side stream, then capture one call of
    it into a CUDA graph in ``device``'s pool.  ``fn`` reads ``inputs``
    (static tensors) and returns the outputs.  Raises if the capture
    fails."""
    import torch

    t0 = time.perf_counter()
    device = torch.device(device)
    index = _index(device)
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)
    with _pool_lock:
        pool = _POOLS.setdefault(index, [torch.cuda.graph_pool_handle(), None])
    counters = dict(LAUNCH_COUNTERS)
    before = {name: c.launches for name, c in counters.items()}
    launches = {}
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool[0], capture_error_mode="thread_local"):
            outputs = fn()
    except BaseException:
        with _pool_lock:
            if pool[1] is None and _POOLS.get(index) is pool:
                del _POOLS[index]  # nothing holds this pool: the next capture mints one
        raise
    finally:
        for name, c in counters.items():
            n = c.launches - before[name]
            if n:
                launches[name] = n
                c.launches -= n  # the capture launched nothing on the card
    with _pool_lock:
        if pool[1] is None:
            pool[1] = graph
    return GraphEntry(kind, graph, inputs, outputs, launches, time.perf_counter() - t0)


class GraphCache:
    """One table of graph entries with its hit / miss / insert counts and
    capture totals.  ``capturer(kind, fn, inputs, device)`` makes an entry
    (``capture_graph``; tests inject others)."""

    def __init__(self, capturer: Callable[..., GraphEntry] = capture_graph):
        self.capturer = capturer
        self._lock = threading.RLock()
        self._entries: dict[tuple, GraphEntry] = {}
        self.counts = {"hit": 0, "miss": 0, "insert": 0}
        self.capture_s = 0.0

    @staticmethod
    def key(bundle, kind: str, descriptor: tuple, placement: tuple) -> tuple:
        if kind not in KINDS:
            raise ValueError(f"unknown graph kind {kind!r}; kinds: {KINDS}")
        return (fingerprint(bundle), kind, tuple(descriptor), tuple(placement))

    def get(self, bundle, kind: str, descriptor: tuple, placement: tuple,
            make: Callable[[], tuple]) -> GraphEntry:
        """The entry under the key, or a new one captured from ``make()``,
        which returns ``(fn, inputs, device)`` for the capturer.  The
        caller holds the device's lock (``device_lock``)."""
        key = self.key(bundle, kind, descriptor, placement)
        with self._lock:
            entry = self._entries.get(key)
            self.counts["hit" if entry is not None else "miss"] += 1
        metrics.EXEC_CACHE_EVENTS.labels("hit" if entry is not None else "miss").inc()
        if entry is not None:
            return entry
        fn, inputs, device = make()
        entry = self.capturer(kind, fn, inputs, device)
        with self._lock:
            self._entries[key] = entry
            self.counts["insert"] += 1
            self.capture_s += entry.capture_s
        metrics.EXEC_CACHE_EVENTS.labels("insert").inc()
        return entry

    def entries(self, bundle=None) -> list[GraphEntry]:
        """Every entry, or those of one bundle."""
        fp = None if bundle is None else fingerprint(bundle)
        with self._lock:
            return [e for k, e in self._entries.items() if fp is None or k[0] == fp]

    def stats(self) -> dict:
        """{entries, hit, miss, insert}, as the JAX ``cache_stats``."""
        with self._lock:
            return {"entries": len(self._entries), **self.counts}

    def kinds(self) -> dict[str, int]:
        """Entries per kind."""
        with self._lock:
            out: dict[str, int] = {}
            for key in self._entries:
                out[key[1]] = out.get(key[1], 0) + 1
            return out

    def capture_stats(self) -> dict:
        with self._lock:
            return {"count": self.counts["insert"], "seconds": self.capture_s}

    def drop(self, bundle) -> int:
        """Drop one bundle's entries (a service torn down), so their graphs
        and static outputs can be freed; returns how many went."""
        fp = fingerprint(bundle)
        with self._lock:
            keys = [k for k in self._entries if k[0] == fp]
            for k in keys:
                del self._entries[k]
        return len(keys)

    def clear(self) -> None:
        """Drop every entry and zero the counts."""
        with self._lock:
            self._entries.clear()
            self.counts = dict.fromkeys(self.counts, 0)
            self.capture_s = 0.0


CACHE = GraphCache()


def cache_stats() -> dict:
    return CACHE.stats()


def cache_kinds() -> dict[str, int]:
    return CACHE.kinds()


def capture_stats() -> dict:
    return CACHE.capture_stats()


# -- warm-phase accounting (engine_warm_seconds{model,phase}) -------------
_warm_lock = threading.Lock()
_WARM_PHASES: dict[str, float] = {}


class warm_phase:
    """``with warm_phase(model, "engine"): ...`` times one warm phase into
    ``engine_warm_seconds{model,phase}`` and the process totals."""

    def __init__(self, model: str, phase: str):
        self.model = model
        self.phase = phase
        self.seconds = 0.0

    def __enter__(self) -> "warm_phase":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        metrics.WARM_SECONDS.labels(self.model, self.phase).observe(self.seconds)
        with _warm_lock:
            _WARM_PHASES[self.phase] = _WARM_PHASES.get(self.phase, 0.0) + self.seconds


def warm_stats() -> dict[str, float]:
    """Accumulated seconds per warm phase."""
    with _warm_lock:
        return {k: round(v, 4) for k, v in sorted(_WARM_PHASES.items())}
