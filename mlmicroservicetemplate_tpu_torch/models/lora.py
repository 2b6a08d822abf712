"""Batched multi-adapter (LoRA) delta math.

Counterpart of the JAX package's ``models/lora.py``.  The reference hangs
stacked adapter weights on its params under ``"__adapters__"``; the port's
params are the model module, so ``attach(model, overlay)`` wraps the module
in an ``Adapted`` view that carries the overlay, and every entry point of
the decoder families (prefill, decode, paged decode, the chunked-prefill
windows, the verify window) reads it with ``adapter_tables(model)``.  A
bare module has none: its computation is the base model's, unchanged.  An
``Overlay`` holds:

- ``rows``: int64 [B], each row's adapter slot (0 = the zero delta);
- ``tables``: ``{proj: (a [S, L, d_in, r], b [S, L, r, d_out])}``, f32,
  slot-stacked (slot 0 zeros), the scale alpha / r folded into ``b``.

``S`` and ``r`` are fixed when the pool is built (``tenancy/adapters.py``),
and the pool installs an adapter by copying into its slot in place, so a
CUDA graph captured over an overlay replays every install: the loop fills
``rows`` (a device buffer of its own) before each replay.  The delta is two
batched products through each row's gathered factors, plain PyTorch ops
as the reference's are two XLA einsums: no kernel of its own.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Overlay:
    rows: torch.Tensor
    tables: dict[str, tuple[torch.Tensor, torch.Tensor]]


class Adapted:
    """A model module seen through an adapter ``Overlay``: every attribute
    is the module's, and ``adapters`` is the overlay."""

    def __init__(self, model, adapters: Overlay):
        self._model = model
        self.adapters = adapters

    def __getattr__(self, name: str):
        return getattr(self._model, name)


def attach(model, adapters: Overlay | None):
    """``model`` with the overlay ``adapters``, or ``model`` itself when
    there is none (the base computation, unchanged)."""
    return model if adapters is None else Adapted(model, adapters)


def adapter_tables(model) -> Overlay | None:
    """The overlay the caller attached, else None."""
    return model.adapters if isinstance(model, Adapted) else None


def delta(ad: Overlay | None, name: str, li: int, x: torch.Tensor) -> torch.Tensor | None:
    """Per-row LoRA delta of projection ``name`` at layer ``li``, or None
    when there is no overlay or the projection is not adapted.  ``x`` is
    the projection's input ``[B, T, d_in]``; the result is the ``[B, T,
    d_out]`` term added to its output, in x's type: row ``i`` goes through
    slot ``rows[i]``'s factors, in f32."""
    ent = None if ad is None else ad.tables.get(name)
    if ent is None:
        return None
    a = ent[0][ad.rows, li]  # [B, d_in, r]
    b = ent[1][ad.rows, li]  # [B, r, d_out]
    h = torch.bmm(x.to(a.dtype), a)
    return torch.bmm(h, b).to(x.dtype)


def apply(ad: Overlay | None, name: str, li: int, x: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """``y + delta`` when adapted, else ``y`` untouched."""
    d = delta(ad, name, li, x)
    return y if d is None else y + d
