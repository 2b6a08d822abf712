"""Per-request prompt-prefix KV cache (``PREFIX_CACHE=1``).

Counterpart of the JAX package's ``engine/prefix_cache.py``.  Chat traffic
shares prefixes per conversation (a system prompt and a growing history),
so each request reuses the KV of the longest prefix of its own token ids
that an earlier request computed: its prefill then runs over the suffix
only.

- **Buckets**: a prefix's length P is one of the engine's seq buckets, so
  the prefixed starts form a (prefix bucket x suffix bucket) grid of
  graphs that warmup captures.  A request matches the largest bucket
  ``P <= length - 1`` whose key hits (one real token must remain to
  prefill), among those the caller's ``usable(P)`` guard admits.
- **Keys** are content hashes, ``blake2b`` of the int32 ids ``[:P]``, so a
  hit is an exact-prefix match.
- **LRU** within ``PREFIX_CACHE_MB`` (entry bytes: every tensor of the
  entry, or a paged pin's ``nbytes``); ``on_evict(entry, key)`` runs for
  every entry that leaves.

Entries the cache owns.  The reference can share a slice of a prefill's
cache because JAX arrays are immutable.  Here every tensor is written in
place: a ``start`` graph's static state is overwritten by the bucket's next
replay, and a loop slot by its next tenant.  So a contiguous entry is a
``clone`` of rows ``[0, P)`` of one row of a fresh prefill state, taken
under the engine's lock before the state is released
(``InferenceEngine._capture_prefix``): a per-layer ``{"k": [...], "v":
[...]}`` of ``[1, P, KVH, D]`` tensors, or ``(int8, scale)`` pairs under
``QUANT_KV=int8`` (the cache's own rows, so a hit copies them back bit for
bit).  Nothing else holds those tensors, and a hit only reads them.  In
paged mode an entry is a ``kv_blocks.PagedPrefix``: one pool ref on the
donor's prompt blocks, which no stream writes again (streams write only at
or past their own prefix, and a block returns to the free list only when
its last holder frees it); ``on_evict`` frees the pin's ref.

Mutually exclusive with ``PROMPT_PREFIX``, whose rows occupy ``[0, P)`` of
every stream; the engine builds this cache only without one.  Under the
host KV tier (``KV_HOST_BUDGET_MB``) an evicted paged pin is demoted to the
host rather than freed (the engine's ``on_evict``), and ``host_lookup``
finds it there under the same key after a device miss.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any

import numpy as np
import torch


def _key(ids: np.ndarray, p: int) -> bytes:
    return hashlib.blake2b(
        np.ascontiguousarray(ids[:p].astype(np.int32)).tobytes(), digest_size=16
    ).digest()


def _tensors(entry: Any):
    if isinstance(entry, torch.Tensor):
        yield entry
    elif isinstance(entry, dict):
        for v in entry.values():
            yield from _tensors(v)
    elif isinstance(entry, (list, tuple)):
        for v in entry:
            yield from _tensors(v)


class PrefixCache:
    """LRU {(P, hash(ids[:P])) -> per-layer prefix KV, or a paged pin}."""

    def __init__(self, buckets: tuple[int, ...], budget_mb: float = 256.0, on_evict=None):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.budget_bytes = int(budget_mb * 1e6)
        self._entries: OrderedDict[tuple[int, bytes], Any] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # on_evict(entry, key): paged mode frees the pin's pool ref.
        self.on_evict = on_evict

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def match(self, ids: np.ndarray, length: int, usable=None):
        """Longest cached prefix of ``ids[:length]``: (P, entry) or None,
        counted as a hit or a miss.  ``P <= length - 1``, and ``usable(P)``
        (the caller's shape guard) is asked before a candidate counts, so an
        entry the caller cannot serve from is neither a hit nor promoted."""
        with self._lock:
            for p in reversed(self.buckets):
                if p > length - 1 or (usable is not None and not usable(p)):
                    continue
                key = (p, _key(ids, p))
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return p, entry
            self.misses += 1
            return None

    def peek(self, ids: np.ndarray, length: int) -> int:
        """Longest cached prefix bucket of ``ids[:length]`` (0 for none),
        without touching the counts or the LRU order."""
        with self._lock:
            for p in reversed(self.buckets):
                if p <= length - 1 and (p, _key(ids, p)) in self._entries:
                    return p
            return 0

    def host_lookup(self, ids: np.ndarray, length: int, tier, usable=None):
        """Longest prefix of ``ids[:length]`` the host tier holds, asked
        after the device entries missed: (P, ``SwapEntry``) or None.  The
        caller promotes it back (blocks, the copy to the card, a new pin);
        the counts here do not move."""
        for p in reversed(self.buckets):
            if p > length - 1 or (usable is not None and not usable(p)):
                continue
            e = tier.prefix_get((p, _key(ids, p)))
            if e is not None:
                return p, e
        return None

    def bucket_for_insert(self, length: int) -> int | None:
        """Largest bucket ``<= length - 1`` (the longest prefix a prompt of
        this length can donate), or None when it is too short."""
        cands = [p for p in self.buckets if p <= length - 1]
        return max(cands) if cands else None

    def contains(self, ids: np.ndarray, p: int) -> bool:
        with self._lock:
            return (p, _key(ids, p)) in self._entries

    @staticmethod
    def _entry_bytes(entry: Any) -> int:
        if hasattr(entry, "nbytes") and not isinstance(entry, torch.Tensor):
            return int(entry.nbytes)  # a paged pin
        return sum(t.numel() * t.element_size() for t in _tensors(entry))

    def _evict(self, key, entry) -> None:
        self._bytes -= self._entry_bytes(entry)
        if self.on_evict is not None:
            self.on_evict(entry, key)

    def insert(self, ids: np.ndarray, p: int, entry: Any) -> None:
        """Store a prefix entry (a no-op when its key is cached already);
        evict LRU entries past the byte budget, always keeping the newest."""
        key = (p, _key(ids, p))
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = entry
            self._bytes += self._entry_bytes(entry)
            while self._bytes > self.budget_bytes and len(self._entries) > 1:
                self._evict(*self._entries.popitem(last=False))

    def pop_lru(self) -> Any | None:
        """Evict the least recently used entry (the paged loop's reclaim
        when the pool runs dry, and the flush); returns it, or None when
        the cache is empty."""
        with self._lock:
            if not self._entries:
                return None
            key, entry = self._entries.popitem(last=False)
            self._evict(key, entry)
            return entry

    def flush(self) -> int:
        """Evict every entry; returns how many went."""
        n = 0
        while self.pop_lru() is not None:
            n += 1
        return n

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes, "hits": self.hits,
                    "misses": self.misses}
