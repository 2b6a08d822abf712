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
only when its last holder (streams and pins alike) frees it.  The
reference's ``take`` (the journal's restart, ROADMAP A12) and ``trim``
(decode windows, A8.5) wait for their callers.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field


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
