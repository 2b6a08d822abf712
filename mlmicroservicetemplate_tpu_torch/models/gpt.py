"""Decode state shared by the decoder-only families.

Only the ``GPTState`` layout of the JAX package's ``models/gpt.py`` is
ported so far (llama decodes with it); the GPT-2 model is not.
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
    # Decode steps taken.  Every row steps together, so this is ``pos`` on
    # the host: the step loop checks its bound without a device read.
    steps: int = 0
    # Sampling parameters; greedy decoding (the only mode ported) has none.
    sample: Any = None
