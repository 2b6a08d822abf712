"""Symmetric int8 quantization, the formula the int8 KV cache stores with.

A copy of ``symmetric_int8`` from the JAX package's ``models/quant.py``.
Weight quantization (``QUANTIZE=int8``) is not ported yet.
"""

from __future__ import annotations

import torch


def symmetric_int8(x: torch.Tensor, dim) -> tuple[torch.Tensor, torch.Tensor]:
    """q = round(x / s) clamped to [-127, 127], s = max|x| / 127 over
    ``dim`` (kept), at least 1e-8 / 127.  All in f32; ``torch.round``
    rounds half to even, as ``jnp.round`` does.  Returns (int8 q, f32 s)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q8, scale
