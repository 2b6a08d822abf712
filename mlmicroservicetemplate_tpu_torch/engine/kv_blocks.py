"""Block-paged KV-cache bookkeeping: a free-list allocator and per-stream
block tables.

Counterpart of the JAX package's ``engine/kv_blocks.py`` for the
continuous loop's paged mode (``PAGED_KV=1``): the KV cache is a pool of
``KV_BLOCK_SIZE``-token blocks shared by every slot, a stream holds only
the blocks its positions need, grows block by block at chunk boundaries
and returns every block the moment it ends; a stream whose growth finds
the pool dry is checkpointed and queued again (``engine/streams.py``).
Everything here is host-side:
block ids index the device pools (``models/gpt.PagedState``); each decode
dispatch carries the tables as an int32 tensor.  Each block has one holder:
the reference's refcounts, adoption and trimming serve its prefix cache,
and its host and disk tiers, none of which is ported.
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
    ``block_bytes`` each (the admission ledger reads its bytes).
    All-or-nothing: a failed allocation takes nothing; a double free
    raises."""

    def __init__(self, num_blocks: int, block_bytes: int = 0):
        self.num_blocks = int(num_blocks)
        self.block_bytes = int(block_bytes)
        self._free: deque[int] = deque(range(self.num_blocks))
        self._held: set[int] = set()
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

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks or raise ``OutOfBlocks`` without taking any."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                raise OutOfBlocks(
                    f"need {n} blocks, {len(self._free)} free of {self.num_blocks}"
                )
            ids = [self._free.popleft() for _ in range(n)]
            self._held.update(ids)
            return ids

    def free(self, ids: list[int]) -> None:
        """Return blocks to the free list.  A double free raises."""
        with self._lock:
            for b in ids:
                if b not in self._held:
                    raise ValueError(f"double free of block {b}")
                self._held.remove(b)
                self._free.append(b)


@dataclass
class StreamBlocks:
    """One stream's block table: ids in logical-position order.
    ``release`` frees every id exactly once."""

    pool: BlockPool
    block_size: int
    ids: list[int] = field(default_factory=list)
    released: bool = False

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
