"""Decode states shared by the decoder-only families.

The ``GPTState`` and ``PagedState`` layouts of the JAX package's
``models/gpt.py`` (llama decodes with both), and the paged token write;
the GPT-2 model itself is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class GPTState:
    """Per-row decode state of a contiguous KV cache.

    ``cache_k`` / ``cache_v`` hold one entry per layer: a dense
    ``[B, T, KVH, D]`` tensor, or an ``(int8 payload, scale [B, T, KVH, 1])``
    pair under the int8 cache.  The caches are preallocated at their full
    width and written in place by each decode step."""

    cache_k: list[Any]
    cache_v: list[Any]
    key_valid: torch.Tensor  # [B, T] int32, 1 = a written key
    write_idx: torch.Tensor  # [B] int64, where the next K/V row goes
    pos: torch.Tensor  # [B] int64, tokens emitted so far
    last_token: torch.Tensor  # [B] int64, the token the next step embeds
    done: torch.Tensor  # [B] bool
    tokens: torch.Tensor  # [B, max_len] int32, pad-filled
    # Decode steps taken when every row steps together: ``pos`` on the host,
    # so the step loop checks its bound without a device read.  None for
    # the continuous loop's slot state, whose rows sit at different steps
    # (the loop keeps its own per-slot counts).
    steps: int | None = 0
    # Sampling parameters; greedy decoding (the only mode ported) has none.
    sample: Any = None


@dataclasses.dataclass
class PagedState:
    """Decode state over a block-paged KV pool (``PAGED_KV=1``).

    As ``GPTState`` except the caches: per layer a pool of
    ``block_size``-token blocks ``[NB + 1, BS, KVH, D]`` shared by every
    row (an ``(int8, scale)`` pair under the int8 cache), where logical
    position ``p`` of row ``b`` lives at ``pool[table[b, p // BS], p % BS]``
    through a host-owned block table passed to each step.  Block ``NB`` is
    scratch: the sentinel id ``NB`` of a freed or never-granted table entry
    points there, so a dead row's writes land where no live row reads,
    in place of the reference's dropped out-of-range scatter.  The other
    fields keep their per-row ``GPTState`` meaning over logical positions
    (``key_valid`` is ``[B, T * BS]``), which is what keeps paged decode
    token-identical to the contiguous layout."""

    cache_k: list[Any]
    cache_v: list[Any]
    key_valid: torch.Tensor  # [B, T * BS] int32 over logical positions
    write_idx: torch.Tensor  # [B] int64
    pos: torch.Tensor  # [B] int64
    last_token: torch.Tensor  # [B] int64
    done: torch.Tensor  # [B] bool
    tokens: torch.Tensor  # [B, max_len] int32

    @property
    def num_blocks(self) -> int:
        """Blocks a table may name (the pool less its scratch block)."""
        entry = self.cache_k[0]
        return (entry[0] if isinstance(entry, tuple) else entry).shape[0] - 1


def paged_dest(table: torch.Tensor, t: torch.Tensor, bs: int, nb: int) -> torch.Tensor:
    """Flat pool index of logical position ``t`` of each row.  Positions
    past the table and sentinel entries both resolve into the scratch block
    ``nb``, whose contents no valid key reads."""
    bidx = t // bs
    width = table.shape[1]
    blk = table.gather(1, bidx.clamp(max=width - 1)[:, None])[:, 0].long()
    blk = torch.where((bidx < width) & (blk >= 0) & (blk < nb), blk, torch.full_like(blk, nb))
    return blk * bs + t % bs


def paged_write_token(pool: torch.Tensor, dest: torch.Tensor, val: torch.Tensor) -> None:
    """Write one new K (or V) row per batch row at flat pool indices
    ``dest`` (``paged_dest``), in place."""
    flat = pool.view((-1,) + tuple(pool.shape[2:]))
    flat[dest] = val.to(pool.dtype)
