"""Fused encoder self-attention: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``mlmicroservicetemplate_tpu/ops/attention.py``
(``_attn_body``, launched by its ``fused_attention``).  The kernel lives in
``csrc/fused_attention.cu``; its header says what bounds it on the card and
what its design does about that.  In short: the TPU kernel keeps one head's
whole [S, S] f32 score tile in VMEM, which at S = 512 does not fit an SM's
shared memory, so the CUDA kernel walks the keys in 64-key tiles with an f32
online softmax and never writes scores to device memory.  It reads and
writes [B, S, H, D] through strides, so no transposes surround it.

``fused_attention`` launches the kernel for CUDA tensors and raises on any
input the kernel does not take; for CPU tensors it runs
``fused_attention_ref``, the plain PyTorch version of the same function.
``fused_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the only head width the kernel takes (BERT-base, T5-small)


def fused_attention_ref(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, H, D]
    v: torch.Tensor,  # [B, S, H, D]
    mask: torch.Tensor,  # [B, S], nonzero = keep
    bias: torch.Tensor | None = None,  # [1, H, S, S] additive
    scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: scores and softmax in f32, masked keys at
    -1e9, probabilities cast to v's type, f32 sum over keys; returns
    [B, S, H, D] in q's type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    keep = (mask != 0)[:, None, None, :]
    scores = torch.where(keep, scores, torch.tensor(-1e9, dtype=torch.float32,
                                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return ctx.to(q.dtype)


def _check(q, k, v, mask, bias) -> None:
    if not (k.device == v.device == mask.device == q.device) or (
        bias is not None and bias.device != q.device
    ):
        raise ValueError("fused_attention: all inputs must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"fused_attention: q/k/v must share one of float32/bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"fused_attention: q/k/v must be [B, S, H, D] of one shape, got "
            f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"fused_attention: head dim {d} (the kernel takes {HEAD_DIM})")
    per_access = 16 // q.element_size()  # the kernel moves 16 bytes per access
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % per_access for st in t.stride()[:3]):
            raise ValueError(
                f"fused_attention: {name} needs a unit head_dim stride and "
                f"other strides divisible by {per_access}, got {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} is not 16-byte aligned")
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"fused_attention: mask must be [B, S], got {tuple(mask.shape)}")
    if bias is not None:
        if tuple(bias.shape) != (1, h, s, s) or bias.stride(3) != 1:
            raise ValueError(
                f"fused_attention: bias must be [1, H, S, S] with unit key "
                f"stride, got {tuple(bias.shape)} strides {bias.stride()}"
            )
        if bias.dtype not in (torch.float32, q.dtype):
            raise TypeError(
                f"fused_attention: bias must be float32 or {q.dtype}, got {bias.dtype}"
            )


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fused_attention_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [
            p, p, p, p, p, p,  # q, k, v, mask, bias, out
            i, i, i, i, i, i,  # dtype, bias_dtype, batch, seq, heads, head_dim
            ctypes.POINTER(ctypes.c_longlong),  # strides
            ctypes.c_float, i, p,  # scale, device, stream
        ]
        fn.restype = i
        lib.fused_attention_error_string.argtypes = [i]
        lib.fused_attention_error_string.restype = ctypes.c_char_p


def fused_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, S], nonzero = keep
    bias: torch.Tensor | None = None,  # [1, H, S, S] additive (T5 rel-pos)
    scale: float | None = None,
) -> torch.Tensor:
    """Encoder self-attention; returns [B, S, H, D] in q's type.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    ``fused_attention_ref``."""
    if q.device.type == "cpu":
        return fused_attention_ref(q, k, v, mask, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    _check(q, k, v, mask, bias)
    from ._build import load_library

    lib = load_library("fused_attention")
    _bind(lib)
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if mask.dtype != torch.int32 or mask.stride(1) != 1:
        mask = mask.to(torch.int32).contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask.stride(0),
        bias.stride(1) if bias is not None else 0,
        bias.stride(2) if bias is not None else 0,
    )
    rc = lib.fused_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        _DTYPE_CODE[q.dtype], -1 if bias is None else _DTYPE_CODE[bias.dtype],
        b, s, h, d, strides, float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        msg = lib.fused_attention_error_string(rc).decode()
        raise RuntimeError(f"fused_attention kernel launch failed ({rc}): {msg}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
