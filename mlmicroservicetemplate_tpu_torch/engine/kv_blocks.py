"""Block-paged KV-cache bookkeeping: a refcounted free-list allocator,
per-stream block tables and the prefix cache's block pins.

Counterpart of the JAX package's ``engine/kv_blocks.py`` for the
continuous loop's paged mode (``PAGED_KV=1``): the KV cache is a pool of
``KV_BLOCK_SIZE``-token blocks shared by every slot, a stream holds only
the blocks its positions need, grows block by block at chunk boundaries
and returns every block the moment it ends; a stream whose growth finds
the pool dry is checkpointed and queued again (``engine/streams.py``).
Everything here is host-side:
block ids index the device pools (``models/gpt.PagedState``); each decode
dispatch carries the tables as an int32 tensor.

Copy-on-write prefix sharing (``PREFIX_CACHE=1``): KV is append-only, so
"CoW" is pure sharing.  A prefix-cache entry is a ``PagedPrefix``, a pin
of one pool ref on a donor's prompt blocks; a stream that hits it adopts
those blocks (one ref each) and never writes below the prefix, whose
length is a block-aligned seq bucket.  A block returns to the free list
only when its last holder (streams and pins alike) frees it.
``StreamBlocks.trim`` returns the blocks a fused decode window granted for
chunks it did not need.  ``BlockPool.take`` claims exact ids (the disk
tier's restart rebuild, ``runtime/durability.py``).

Host KV tier (``KV_HOST_BUDGET_MB``): ``HostBlockPool`` is a second pool
with the same discipline that also holds the blocks' contents, one host
tensor per leaf of the paged pools (pinned on the card); ``SwapLedger``
maps its blocks to the swapped-out stream checkpoints and demoted prefix
pins that own them, and ``KVHostTier`` builds both on first use.  The
copies between the tiers are the loop's (``engine/streams.py``).  The
disk tier below (``KV_DISK_BUDGET_MB``) hangs off the ledger's ``spill``
and ``on_release`` hooks and rebuilds its own ledger through ``restore``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import torch

log = logging.getLogger(__name__)


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV rows (ceil; 0 for 0)."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(block_size))


def kv_token_bytes(layers: int, kv_heads: int, head_dim: int, elt_bytes: int,
                   quant_int8: bool = False, scale_bytes: int = 4) -> int:
    """KV bytes per token position: K and V across all layers, at the cache
    element width (int8 payload plus one scale per token and head under
    ``QUANT_KV=int8``)."""
    per_head = head_dim + scale_bytes if quant_int8 else head_dim * elt_bytes
    return 2 * layers * kv_heads * per_head


class OutOfBlocks(Exception):
    """The pool cannot satisfy an allocation."""


class BlockPool:
    """Thread-safe free-list allocator of ``num_blocks`` blocks of
    ``block_bytes`` each (the admission ledger reads its bytes), with
    per-block refcounts: ``alloc`` hands a block out at 1, ``ref`` adds a
    holder, ``free`` drops one and returns the block at 0.  All-or-nothing:
    a failed allocation takes nothing; a double free raises."""

    def __init__(self, num_blocks: int, block_bytes: int = 0):
        self.num_blocks = int(num_blocks)
        self.block_bytes = int(block_bytes)
        self._free: deque[int] = deque(range(self.num_blocks))
        self._ref: dict[int, int] = {}
        self._lock = threading.Lock()

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    @property
    def used_bytes(self) -> int:
        return self.used_blocks * self.block_bytes

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks (refcount 1 each) or raise ``OutOfBlocks``
        without taking any."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                raise OutOfBlocks(
                    f"need {n} blocks, {len(self._free)} free of {self.num_blocks}"
                )
            ids = [self._free.popleft() for _ in range(n)]
            for b in ids:
                self._ref[b] = 1
            return ids

    def ref(self, ids: list[int]) -> None:
        """Add one holder to each block (a prefix pin, or a sharer)."""
        with self._lock:
            for b in ids:
                if self._ref.get(b, 0) <= 0:
                    raise ValueError(f"ref of unallocated block {b}")
                self._ref[b] += 1

    def take(self, ids: list[int]) -> None:
        """Claim these free blocks at refcount 1: a persistent tier's
        index names exact ids, so its restart rebuild takes those, not
        what the free list pops.  All-or-nothing; an id out of range or
        already held raises."""
        with self._lock:
            want = set()
            for b in ids:
                b = int(b)
                if not (0 <= b < self.num_blocks):
                    raise ValueError(f"take of out-of-range block {b}")
                if self._ref.get(b, 0) > 0 or b in want:
                    raise ValueError(f"take of already-held block {b}")
                want.add(b)
            self._free = deque(b for b in self._free if b not in want)
            for b in want:
                self._ref[b] = 1

    def free(self, ids: list[int]) -> None:
        """Drop one holder per id; a block rejoins the free list at 0.  A
        free of a block nobody holds raises."""
        with self._lock:
            for b in ids:
                c = self._ref.get(b, 0)
                if c <= 0:
                    raise ValueError(f"double free of block {b}")
                if c == 1:
                    del self._ref[b]
                    self._free.append(b)
                else:
                    self._ref[b] = c - 1

    def stats(self) -> dict:
        """{num_blocks, free, used, shared (blocks with two or more holders)}."""
        with self._lock:
            return {"num_blocks": self.num_blocks, "free": len(self._free),
                    "used": self.num_blocks - len(self._free),
                    "shared": sum(1 for c in self._ref.values() if c > 1)}


@dataclass
class StreamBlocks:
    """One stream's block table: ids in logical-position order.  The first
    ``shared`` are a donor's prefix blocks it adopted (one ref each, like
    any holder); ``release`` frees every id exactly once."""

    pool: BlockPool
    block_size: int
    ids: list[int] = field(default_factory=list)
    shared: int = 0
    released: bool = False

    def adopt(self, shared_ids: list[int]) -> None:
        """Take one ref on each of a donor's block-aligned prefix blocks,
        which become the table's first entries; only before any
        allocation."""
        if self.ids:
            raise ValueError("adopt must precede any allocation")
        self.pool.ref(shared_ids)
        self.ids = list(shared_ids)
        self.shared = len(shared_ids)

    def ensure(self, n_tokens: int) -> list[int]:
        """Grow the table to cover ``n_tokens`` positions; returns the new
        ids ([] when already covered).  ``OutOfBlocks`` leaves the table
        unchanged."""
        need = blocks_for(n_tokens, self.block_size) - len(self.ids)
        if need <= 0:
            return []
        fresh = self.pool.alloc(need)
        self.ids.extend(fresh)
        return fresh

    def trim(self, n_tokens: int) -> list[int]:
        """Return the tail blocks past what ``n_tokens`` positions need to
        the pool, never into the adopted prefix (``shared``); returns the
        freed ids ([] when already exact).  The reference's loop trims a
        row still live after a window's early exit; none is (every row is
        done there and freed whole), so the port's loop never calls it."""
        keep = max(blocks_for(n_tokens, self.block_size), self.shared)
        if keep >= len(self.ids):
            return []
        tail = self.ids[keep:]
        self.ids = self.ids[:keep]
        self.pool.free(tail)
        return tail

    def release(self) -> None:
        if not self.released:
            self.released = True
            if self.ids:
                self.pool.free(self.ids)
            self.ids = []
            self.shared = 0


@dataclass(frozen=True)
class PagedPrefix:
    """A prefix-cache entry in paged mode: the donor's prompt-block ids, on
    which the cache holds one pool ref (the pin); no KV copy.  Eviction
    frees only the pin's ref, so sharers keep the blocks.  ``nbytes`` (the
    pinned positions' KV bytes in the pool) counts against
    ``PREFIX_CACHE_MB``."""

    p_len: int
    block_ids: tuple[int, ...]
    nbytes: int


class HostBlockPool(BlockPool):
    """The host tier's blocks: the device pool's free list and refcounts,
    plus their contents, one preallocated host tensor per leaf of the
    paged pools (``[num_blocks, block_size, heads, dim]`` payloads, and
    the scale leaves under ``QUANT_KV=int8``), so a block's rows cross
    between the tiers by id with no reshaping.  ``leaf_specs`` is
    ``[(per-block shape, dtype)]`` in the loop's leaf order (``cache_k``
    then ``cache_v``, layer by layer, a payload before its scale).  With
    ``pin`` (the card) the buffers are page-locked.  They are allocated
    once and written in place; rows cross to and from the card through
    pinned staging (indexing them returns unpinned memory, from which a
    copy to the card would be synchronous)."""

    def __init__(self, num_blocks: int, block_bytes: int, leaf_specs, pin: bool = False):
        super().__init__(num_blocks, block_bytes)
        self.leaves = [torch.zeros((self.num_blocks,) + tuple(shape), dtype=dtype,
                                   pin_memory=pin)
                       for shape, dtype in leaf_specs]

    @staticmethod
    def _index(ids) -> torch.Tensor:
        return torch.as_tensor(list(ids), dtype=torch.long)

    def write(self, ids, leaf_vals) -> None:
        """Store block rows: ``leaf_vals[i]`` is ``[len(ids), bs, ...]``."""
        idx = self._index(ids)
        for buf, vals in zip(self.leaves, leaf_vals):
            buf.index_copy_(0, idx, vals.to(buf.dtype))

    def read(self, ids, out=None) -> list[torch.Tensor]:
        """Block rows, one ``[len(ids), bs, ...]`` tensor per leaf, into
        ``out`` when given (pinned staging: indexing would return unpinned
        memory, from which a copy to the card is synchronous)."""
        idx = self._index(ids)
        if out is None:
            return [buf.index_select(0, idx) for buf in self.leaves]
        for buf, o in zip(self.leaves, out):
            torch.index_select(buf, 0, idx, out=o)
        return out


class SwapEntry:
    """One unit of the host tier: the host block ids holding a stream's
    resume-prompt KV (kind ``stream``) or a demoted prefix pin's (kind
    ``prefix``), and the token positions they cover.  ``alive`` turns
    False at eviction or release (a waiting stream whose entry died
    resumes by recompute); ``ready`` turns True once the device-to-host
    copy has landed in the buffers.  ``pool`` and ``ledger`` say which
    tier holds the ids and frees them."""

    __slots__ = ("ids", "tokens", "kind", "key", "alive", "ready", "pool", "ledger")

    def __init__(self, ids, tokens: int, kind: str, key=None, pool=None, ledger=None):
        self.ids = list(ids)
        self.tokens = int(tokens)
        self.kind = kind
        self.key = key
        self.alive = True
        self.ready = False
        self.pool = pool
        self.ledger = ledger


class SwapLedger:
    """Which host blocks hold which stream's or prefix's KV.  Every block
    of the host pool is owned by exactly one live entry, so releasing
    every entry drains the pool to 0; a second release of an entry is
    absorbed (the pool still raises on a true double free).  Under
    pressure the LRU evicts demoted prefix entries before stream
    checkpoints: a waiting stream's resume is hotter than a cache
    entry's maybe-reuse."""

    def __init__(self, pool: HostBlockPool):
        self.pool = pool
        self._lru: OrderedDict[SwapEntry, None] = OrderedDict()
        self._prefix: dict = {}
        self._lock = threading.Lock()
        self.evictions = 0
        # The tier below (``runtime/durability.py``): ``spill(entry)`` is
        # offered an LRU victim before it dies, so its blocks demote to
        # disk (a spill that fails still evicts), and ``on_release(entry)``
        # mirrors every release into the disk tier's index.  Both None: no
        # tier below.
        self.spill = None
        self.on_release = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def reserve(self, n_blocks: int, tokens: int, kind: str, key=None) -> SwapEntry | None:
        """``n_blocks`` host blocks as a new entry, evicting older entries
        (prefix ones first) to make room; None when the tier cannot hold
        it even empty."""
        if n_blocks <= 0 or n_blocks > self.pool.num_blocks:
            return None
        with self._lock:
            while True:
                try:
                    ids = self.pool.alloc(n_blocks)
                    break
                except OutOfBlocks:
                    if not self._evict_one_locked():
                        return None
            entry = SwapEntry(ids, tokens, kind, key=key, pool=self.pool, ledger=self)
            self._lru[entry] = None
            if key is not None:
                self._prefix[key] = entry
            return entry

    def restore(self, ids: list[int], tokens: int, kind: str, key=None) -> SwapEntry:
        """An entry at these exact block ids (a persistent tier's index at
        restart): its payload is in the backing store already, so it is
        born ``ready``."""
        with self._lock:
            self.pool.take(ids)
            entry = SwapEntry(ids, tokens, kind, key=key, pool=self.pool, ledger=self)
            entry.ready = True
            self._lru[entry] = None
            if key is not None:
                self._prefix[key] = entry
            return entry

    def _evict_one_locked(self) -> bool:
        victim = None
        for e in self._lru:  # oldest first; a prefix entry goes before any stream's
            if e.kind == "prefix":
                victim = e
                break
            if victim is None:
                victim = e
        if victim is None:
            return False
        if self.spill is not None and victim.ready:
            try:
                self.spill(victim)
            except Exception:
                log.exception("KV tier spill failed; evicting without demotion")
        self._release_locked(victim)
        self.evictions += 1
        return True

    def _release_locked(self, entry: SwapEntry) -> None:
        if not entry.alive:
            return
        entry.alive = False
        self._lru.pop(entry, None)
        if entry.key is not None:
            self._prefix.pop(entry.key, None)
        self.pool.free(entry.ids)
        if self.on_release is not None:
            try:
                self.on_release(entry)
            except Exception:
                log.exception("KV tier release hook failed")

    def release(self, entry: SwapEntry) -> None:
        with self._lock:
            self._release_locked(entry)

    def touch(self, entry: SwapEntry) -> None:
        """Move a live entry to the LRU's hot end."""
        with self._lock:
            if entry.alive:
                self._lru.move_to_end(entry)

    def prefix_get(self, key) -> SwapEntry | None:
        """A live prefix entry by its cache key (bucket, content hash);
        a hit moves it to the LRU's hot end."""
        return self.get(key)

    def get(self, key) -> SwapEntry | None:
        """A live entry of any kind by its key (a stream checkpoint's is
        ``("stream", rid)``); a hit moves it to the LRU's hot end."""
        with self._lock:
            e = self._prefix.get(key)
            if e is not None and e.alive:
                self._lru.move_to_end(e)
                return e
            return None

    def stats(self) -> dict:
        with self._lock:
            streams = sum(1 for e in self._lru if e.kind == "stream")
            return {"entries": len(self._lru), "stream_entries": streams,
                    "prefix_entries": len(self._lru) - streams, "evictions": self.evictions,
                    "used_blocks": self.pool.used_blocks, "free_blocks": self.pool.free_blocks}


class KVHostTier:
    """One host KV tier: its budget, and the pool and ledger built on first
    use (``ensure_pool``: the leaf shapes are known once the paged pools
    are).  ``pin_seconds`` is how long that first build took (pinning a
    large budget is not free)."""

    def __init__(self, budget_mb: float, block_bytes: int):
        self.budget_bytes = int(float(budget_mb) * 1e6)
        self.block_bytes = int(block_bytes)
        self.num_blocks = self.budget_bytes // max(1, self.block_bytes)
        self.pool: HostBlockPool | None = None
        self.ledger: SwapLedger | None = None
        self.pin_seconds: float | None = None
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.num_blocks > 0

    def ensure_pool(self, leaf_specs, pin: bool = False) -> bool:
        """Build the buffers on first use; False when the budget holds no
        whole block (the tier is off)."""
        if not self.enabled:
            return False
        with self._lock:
            if self.pool is None:
                t0 = time.monotonic()
                self.pool = HostBlockPool(self.num_blocks, self.block_bytes, leaf_specs, pin=pin)
                self.ledger = SwapLedger(self.pool)
                self.pin_seconds = time.monotonic() - t0
        return True

    def reserve(self, n_blocks: int, tokens: int, kind: str, key=None) -> SwapEntry | None:
        return (self.ledger.reserve(n_blocks, tokens, kind, key=key)
                if self.ledger is not None else None)

    def release(self, entry: SwapEntry) -> None:
        if self.ledger is not None:
            self.ledger.release(entry)

    def prefix_get(self, key) -> SwapEntry | None:
        return self.ledger.prefix_get(key) if self.ledger is not None else None

    def prefix_resident(self, key) -> bool:
        return self.prefix_get(key) is not None

    def stats(self) -> dict:
        base = {"budget_bytes": self.budget_bytes, "block_bytes": self.block_bytes,
                "num_blocks": self.num_blocks}
        if self.ledger is not None:
            base.update(self.ledger.stats())
        return base
