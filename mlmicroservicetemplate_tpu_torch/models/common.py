"""Shared building blocks, as plain functions on tensors.

Counterparts of the JAX package's ``models/common.py``.  Two layout notes:
the JAX ``dense`` kernel is ``[d_in, d_out]`` (``x @ W``) while the port
keeps weights in ``nn.Linear``'s ``[d_out, d_in]`` (``convert.jax_params``
transposes); attention activations stay ``[B, S, H, D]`` as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``x @ weight.T + bias`` in x's type (weight in ``[d_out, d_in]``)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """Normalize in f32, return x's type.  ``F.layer_norm`` computes bf16
    inputs (statistics and affine) in f32 itself, so no f32 copy of the
    activations is made."""
    return F.layer_norm(x, x.shape[-1:], scale.to(x.dtype), bias.to(x.dtype), eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """erf GELU (BERT's "gelu")."""
    return F.gelu(x, approximate="none")


def embed(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(ids, table).to(dtype)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.view(b, s, n_heads, d // n_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def mha_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]
    v: torch.Tensor,  # [B, Sk, H, D]
    mask: torch.Tensor | None = None,  # bool, broadcastable to [B, H, Sq, Sk]
    bias: torch.Tensor | None = None,  # additive, broadcastable to [B, H, Sq, Sk]
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-head attention core; returns [B, Sq, H, D].  Softmax in f32,
    masked logits set to -1e9 (not -inf: a fully masked row averages V
    instead of producing NaN)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
