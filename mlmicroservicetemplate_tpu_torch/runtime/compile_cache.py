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
  ``start`` (prefill plus the first decode chunk), ``start_prefixed``
  (the same behind a prefix-cache entry, whose per-layer K/V are static
  inputs ``[B, P, KVH, D]`` written before each replay like the ids),
  ``gen_chunk``, ``loop_chunk``, ``loop_chunk_paged``, and chunked
  prefill's windows: ``prefill_window`` (one window into a detached
  contiguous state of the loop's slot width, the graph's own, which each
  job's state is copied into and back out of) and
  ``prefill_window_paged`` (one window into the loop's pools through a
  static table row), and speculative decoding's: ``spec_start`` (prefill,
  the drafting history and the first chunk of verify rounds),
  ``spec_start_prefixed`` (the same behind a prefix-cache entry, whose ids
  are a static input too), ``spec_chunk`` (verify rounds over a spec
  start's state), ``full_spec`` and ``full_spec_chunk`` (a non-streaming
  batch's start and rounds, each capped by the rows' budgets) and
  ``loop_spec_chunk`` (``SPEC_CONTINUOUS``: the loop's rounds over its slot
  state and histories) (``KINDS``);
- the **descriptor** spells out what the captured call closes over
  besides the bundle: the bucket's shapes (``(B, P, S)`` for a prefixed
  start and its per-stream ``gen_chunk``), the compute type, the KV
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

**Modeled cost** (the perf observatory, ``utils/perfobs.py``): with
``PERF_OBS`` on, a graph's FLOPs and bytes are counted once, on the first
call of its function (the capture's eager warm pass, or a CPU stand-in
capturer's call), by a torch-function mode over the calls that multiply
(a function mode costs a few µs a call; a dispatch mode, some 90):
``2 * numel(out) * K`` for matmuls, linears and convolutions (K the
contraction), ``2 * prod(index sizes)`` for a two-operand einsum, and each
such call's operands read once and output written once as its bytes.  The
hand-written kernels' wrappers count nothing (``uncounted``), on the card,
where they are ctypes calls no mode sees, and on the CPU, where their plain
versions would: one graph counts the same on both devices.
Every replay accrues the count into the book (a fused window's graph holds
its W chunks, so it counts W times a chunk's).  The reference's XLA cost
analysis leaves out its Pallas calls the same way.  Eager paths, which
replay no graph, accrue nothing.

Import-light: nothing here touches CUDA at import.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable

from ..utils import locktrace, metrics, perfobs

KINDS = ("forward", "forward_images", "start", "start_prefixed", "gen_chunk", "loop_chunk",
         "loop_chunk_paged", "prefill_window", "prefill_window_paged", "spec_start",
         "spec_start_prefixed", "spec_chunk", "full_spec", "full_spec_chunk", "loop_spec_chunk")

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


# -- modeled cost ------------------------------------------------------------
_uncounted = threading.local()


class uncounted:
    """``with uncounted(): ...`` keeps the ops inside out of the cost count
    (the kernel wrappers' plain versions).  Thread-local, nestable."""

    def __enter__(self):
        _uncounted.depth = getattr(_uncounted, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _uncounted.depth -= 1
        return False


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


_MATMULS = {"mm": 0, "bmm": 0, "matmul": 0, "__matmul__": 0, "linear": 0,
            "addmm": 1, "baddbmm": 1}
_CONVS = ("conv2d", "convolution", "cudnn_convolution_relu", "cudnn_convolution_add_relu")


def _contraction(name: str, args: tuple) -> int | None:
    """K of a multiply-accumulate call (FLOPs = 2 * numel(out) * K), or None
    for a call that is not one."""
    if name in _MATMULS:
        return int(args[_MATMULS[name]].shape[-1])
    if name in _CONVS:
        w = args[1]
        return w.numel() // int(w.shape[0])
    return None


def _einsum_operands(args: tuple) -> list:
    ops = args[1:]
    return list(ops[0]) if len(ops) == 1 and isinstance(ops[0], (list, tuple)) else list(ops)


def _einsum_flops(eq: str, ops: list) -> int:
    """2 * the product of every index's size, for a two-operand einsum."""
    if len(ops) != 2:
        return 0
    lhs = eq.split("->")[0].replace(" ", "").split(",")
    sizes: dict[str, int] = {}
    for term, t in zip(lhs, ops):
        for letter, n in zip(term, t.shape):
            sizes[letter] = int(n)
    total = 2
    for n in sizes.values():
        total *= n
    return total


class _Cost:
    """FLOPs and bytes of one graph's call, and whether it was counted."""

    __slots__ = ("flops", "bytes", "done")

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.done = False


def _cost_mode(cost: _Cost):
    """A torch-function mode adding each multiplying call's FLOPs and bytes
    to ``cost`` (outside ``uncounted``).  It sees the Python API's calls
    (``F.linear``, ``einsum``, ``bmm``, the convolutions), once each: a
    mode is off inside its own handler."""
    import torch
    from torch.overrides import TorchFunctionMode

    class _CostMode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if getattr(_uncounted, "depth", 0):
                return out
            name = getattr(func, "__name__", "")
            if name == "einsum":
                operands = _einsum_operands(args)
                flops = _einsum_flops(args[0], operands)
            else:
                k = _contraction(name, args)
                if k is None or not isinstance(out, torch.Tensor):
                    return out
                flops = 2 * out.numel() * k
                operands = [a for a in args if isinstance(a, torch.Tensor)]
            if flops:
                cost.flops += flops
                cost.bytes += sum(_nbytes(a) for a in operands) + _nbytes(out)
            return out

    return _CostMode()


def _counted(fn: Callable[[], Any], cost: _Cost) -> Callable[[], Any]:
    """``fn``, whose first call is counted into ``cost``."""

    def call():
        if cost.done:
            return fn()
        with _cost_mode(cost):
            out = fn()
        cost.done = True
        return out

    return call


@dataclasses.dataclass
class GraphEntry:
    """One captured call: replay it after writing its static inputs; read
    its static outputs before another graph replays.  ``cost`` (its modeled
    FLOPs and bytes, counted at capture under ``PERF_OBS``) accrues into
    ``model``'s book at each replay."""

    kind: str
    graph: Any  # torch.cuda.CUDAGraph, or anything with ``replay()``
    inputs: Any
    outputs: Any
    launches: dict[str, int]  # kernel name -> launches in one replay
    capture_s: float
    replays: int = 0
    model: str = ""
    cost: _Cost | None = None

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            LAUNCH_COUNTERS[name].launches += n
        cost = self.cost
        if cost is not None and cost.done and perfobs.enabled():
            perfobs.note_cost(self.model, self.kind, cost.flops, cost.bytes)


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
        lock = _DEVICE_LOCKS.get(index)
        if lock is None:
            lock = _DEVICE_LOCKS[index] = threading.RLock()
            # Held across every replay by design: the lock-order detector's
            # one lock allowed across a dispatch.
            locktrace.allow_across_dispatch(lock)
        return lock


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
        cost = None
        if perfobs.enabled():
            cost = _Cost()
            fn = _counted(fn, cost)
        entry = self.capturer(kind, fn, inputs, device)
        entry.model = getattr(bundle, "name", "")
        entry.cost = cost
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

    def cost_stats(self) -> dict[str, int]:
        """Counted graphs per kind (the reference's analyzed signatures per
        executable kind)."""
        with self._lock:
            out: dict[str, int] = {}
            for key, e in self._entries.items():
                if e.cost is not None and e.cost.done:
                    out[key[1]] = out.get(key[1], 0) + 1
            return out

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


def cost_stats() -> dict[str, int]:
    return CACHE.cost_stats()


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
