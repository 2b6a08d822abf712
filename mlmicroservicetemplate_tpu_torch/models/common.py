"""Shared building blocks, as plain functions on tensors.

Counterparts of the JAX package's ``models/common.py``.  Two layout notes:
the JAX ``dense`` kernel is ``[d_in, d_out]`` (``x @ W``) while the port
keeps weights in ``nn.Linear``'s ``[d_out, d_in]`` (``convert.jax_params``
transposes); attention activations stay ``[B, S, H, D]`` as in JAX.
The int8 KV helpers (``kv_quantize``, ``mha_attention_kv8``) and the
llama pieces (``rmsnorm``, ``lm_head_logits``, ``repeat_kv``) follow the
JAX functions of the same names.  The ResNet pieces (``conv2d``,
``batchnorm_affine``) keep torch's layouts: OIHW conv weights and
NCHW-logical activations, both in ``torch.channels_last`` memory format,
which is the JAX package's NHWC in memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``x @ weight.T + bias`` in x's type (weight in ``[d_out, d_in]``)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0, relu: bool = False,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """Convolution of a channels-last NCHW ``x`` by an OIHW ``weight``, plus
    a per-channel ``bias``, then with ``relu`` the ``residual`` added and a
    ReLU, in x's type (cuDNN on the card; the JAX package's is plain XLA).
    On the card a conv with a bias and a ReLU is one cuDNN call that fuses
    them (``torch.cudnn_convolution_relu`` / ``_add_relu``): PyTorch's own
    conv adds a bias in a pass of its own, and the add and the ReLU would
    be two more."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if relu and b is not None and x.is_cuda:
        s, p = (stride, stride), (padding, padding)
        if residual is None:
            return torch.cudnn_convolution_relu(x, w, b, s, p, (1, 1), 1)
        return torch.cudnn_convolution_add_relu(x, w, residual, 1.0, b, s, p, (1, 1), 1)
    y = F.conv2d(x, w, b, stride=stride, padding=padding)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def batchnorm_init(c: int) -> dict[str, torch.Tensor]:
    """Inference-mode BN state (running stats + affine)."""
    return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
            "var": torch.ones(c)}


def batchnorm_affine(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, dtype: torch.dtype,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as one affine ``y = x * g + b``: ``g`` and ``b`` formed
    in f32 (the rsqrt of the running variance), then cast to ``dtype``."""
    inv = torch.rsqrt(var.float() + eps)
    g = scale.float() * inv
    b = bias.float() - mean.float() * g
    return g.to(dtype), b.to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """Normalize in f32, return x's type.  ``F.layer_norm`` computes bf16
    inputs (statistics and affine) in f32 itself, so no f32 copy of the
    activations is made."""
    return F.layer_norm(x, x.shape[-1:], scale.to(x.dtype), bias.to(x.dtype), eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (no mean, no bias): statistics and scale in f32, result in
    x's type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def lm_head_logits(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """f32 logits ``x @ weight.T`` for a dense head stored ``[V, D]``
    (the JAX ``lm_head_logits`` with an unquantized ``[D, V]`` kernel)."""
    return F.linear(x.float(), weight.float())


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token, per-head symmetric int8 of K or V: ``[..., H, D]`` ->
    (int8 of the same shape, f32 scale ``[..., H, 1]``)."""
    from .quant import symmetric_int8

    return symmetric_int8(x, dim=-1)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA broadcast ``[B, S, KVH, D]`` -> ``[B, S, KVH * n_rep, D]``:
    query head h reads KV head h // n_rep."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


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


def mha_attention_kv8(
    q: torch.Tensor,  # [B, Sq, H, D]
    k8: torch.Tensor,  # [B, Sk, H, D] int8
    k_scale: torch.Tensor,  # [B, Sk, H, 1]
    v8: torch.Tensor,  # [B, Sk, H, D] int8
    v_scale: torch.Tensor,  # [B, Sk, H, 1]
    mask: torch.Tensor | None = None,  # bool, broadcastable to [B, H, Sq, Sk]
    scale: float | None = None,
) -> torch.Tensor:
    """``mha_attention`` over an int8 cache, the scales factored out of
    both products: the key scale multiplies its logit column, the value
    scale folds into the softmax weights; returns [B, Sq, H, D] in q's
    type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ks = k_scale[..., 0].permute(0, 2, 1)[:, :, None, :].float()  # [B, H, 1, Sk]
    vs = v_scale[..., 0].permute(0, 2, 1)[:, :, None, :].float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k8.to(q.dtype)).float() * scale * ks
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.softmax(logits, dim=-1)
    weighted = (probs * vs).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weighted, v8.to(q.dtype))
