"""Attention kernels written by hand in CUDA for Hopper, with their plain
versions.

- ``fused_attention`` (K1): encoder self-attention, ``csrc/fused_attention.cu``.
- ``decode_attention`` (K2): one decode step's attention over a contiguous
  KV cache, dense or int8, grouped-query; ``csrc/decode_attention.cu`` on
  the decode core ``csrc/decode_sm90.cuh``, replacing the Pallas kernel
  ``decode_attention`` of the JAX package's ``ops/attention.py`` (bodies
  ``_decode_body``, ``_decode_body_v``).  Each CTA reads one (batch row, KV
  head, key split)'s share of the K/V slab once and serves all the query
  heads of its group; ``split_plan`` picks the splits from the shapes; the
  headers say what bounds it.  The wrapper builds each call signature's
  plan (checks, strides, splits) once.  ``decode_attention.launches``
  counts its calls that launched.

K1 replaces the Pallas TPU kernel ``mlmicroservicetemplate_tpu/ops/attention.py``
(``_attn_body``, launched by its ``fused_attention``).  The kernel lives in
``csrc/fused_attention.cu`` on the Hopper main loop it shares with K4
(``csrc/attention_sm90.cuh``); their headers say what bounds it on the card
and what the design does about that.  In short: the TPU kernel keeps one
head's whole [S, S] f32 score tile in VMEM, which at S = 512 does not fit an
SM's shared memory, so the CUDA kernel walks the keys in 128-key tiles
(wgmma, TMA, tiles with no valid key skipped; a bf16 bias with 16-byte
aligned rows comes as TMA tiles too) with an f32 online softmax and never
writes scores to device memory.  It reads and writes [B, S, H, D]
through strides, so no transposes surround it.

Each wrapper launches its kernel for CUDA tensors and raises on any
input the kernel does not take; for CPU tensors it runs its plain PyTorch
version (``fused_attention_ref``, ``decode_attention_ref``).
``fused_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import struct
import threading

import torch

from ..runtime.compile_cache import counts_launches

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the only head width the kernels take (BERT-base, TinyLlama)
MAX_SEQ = 1 << 16  # keys K1's key bitmap covers


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
    if s > MAX_SEQ:
        raise ValueError(f"fused_attention: {s} keys (the kernel takes {MAX_SEQ})")
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


counts_launches(fused_attention)


# ---------------------------------------------------------------------------
# decode attention (K2): one query per row over a contiguous KV cache

MAX_GROUP = 16  # query heads per KV head the decode kernel takes
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [B, T, KVH, D] dense, or int8
    v: torch.Tensor,  # [B, T, KVH, D]
    mask: torch.Tensor,  # [B, T], nonzero = attend
    k_scale: torch.Tensor | None = None,  # [B, T, KVH, 1]: int8 cache
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the decode step's cache attention.

    Query head h reads KV head h // (H / KVH).  Scores and softmax in f32,
    masked keys at -1e9.  Dense cache: probabilities cast to V's type,
    f32 sum.  int8 cache: K = k8 * k_scale and V = v8 * v_scale in f32,
    probabilities stay f32.  Returns [B, H, D] in q's type."""
    b, h, d = q.shape
    kvh = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kvh, h // kvh, d)
    kf = k.float() if k_scale is None else k.float() * k_scale.float()
    scores = torch.einsum("bgrd,btgd->bgrt", qg, kf) * scale
    keep = (mask != 0)[:, None, None, :]
    scores = torch.where(keep, scores, torch.tensor(-1e9, dtype=torch.float32,
                                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is None:
        probs, vf = probs.to(v.dtype).float(), v.float()
    else:
        vf = v.float() * v_scale.float()
    ctx = torch.einsum("bgrt,btgd->bgrd", probs, vf)
    return ctx.reshape(b, h, d).to(q.dtype)


def _check_decode(q, k, v, mask, k_scale, v_scale) -> None:
    tensors = [q, k, v, mask] + [t for t in (k_scale, v_scale) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all inputs must be on one device")
    quant = k_scale is not None or v_scale is not None
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, got {q.dtype}")
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("decode_attention: the int8 cache needs k_scale and v_scale")
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(
                f"decode_attention: scales given, so k/v must be int8, got {k.dtype}/{v.dtype}"
            )
        if k_scale.dtype not in _DTYPE_CODE or v_scale.dtype != k_scale.dtype:
            raise TypeError(
                f"decode_attention: scales must share float32 or bfloat16, got "
                f"{k_scale.dtype}/{v_scale.dtype}"
            )
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"decode_attention: a dense cache must have q's type {q.dtype}, got "
            f"{k.dtype}/{v.dtype}"
        )
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"decode_attention: q must be [B, H, D] and k/v one [B, T, KVH, D] "
            f"shape, got {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}"
        )
    b, h, d = q.shape
    _, t, kvh, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(
            f"decode_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
        )
    if d != HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {d} (the kernel takes {HEAD_DIM})")
    if h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(
            f"decode_attention: {h} query heads over {kvh} KV heads (the kernel "
            f"takes a whole group of at most {MAX_GROUP})"
        )
    if tuple(mask.shape) != (b, t):
        raise ValueError(f"decode_attention: mask must be [B, T], got {tuple(mask.shape)}")
    if q.stride(2) != 1:
        raise ValueError(f"decode_attention: q needs a unit head_dim stride, got {q.stride()}")
    per_access = 16 // k.element_size()  # the kernel moves 16 bytes per access
    for name, x in (("k", k), ("v", v)):
        if x.stride(3) != 1 or any(st % per_access for st in x.stride()[:3]):
            raise ValueError(
                f"decode_attention: {name} needs a unit head_dim stride and other "
                f"strides divisible by {per_access}, got {x.stride()}"
            )
        if x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte aligned")
    if quant:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(x.shape) != (b, t, kvh, 1):
                raise ValueError(
                    f"decode_attention: {name} must be [B, T, KVH, 1], got {tuple(x.shape)}"
                )


# The decode kernels' key split (csrc/decode_sm90.cuh): 64-key tiles, at most
# MAX_SPLIT_TILES a split, and enough splits that the grid (KV head, row,
# split) holds about two CTAs for each of an H100's 132 SMs.
SPLIT_TILE = 64
MAX_SPLIT_TILES = 16
TARGET_CTAS = 2 * 132


def split_plan(batch: int, kv_heads: int, n_keys: int, unit_tiles: int = 1) -> tuple[int, int]:
    """(splits, tiles per split) of the decode kernels' grid, from the shapes
    alone: a split holds a whole number of ``unit_tiles`` tiles (the paged
    kernel's unit is a whole number of blocks), at most MAX_SPLIT_TILES
    tiles, every split holds a key, and the splits cover every key."""
    n_tiles = -(-n_keys // SPLIT_TILE)
    units = -(-n_tiles // unit_tiles)
    want = -(-TARGET_CTAS // (batch * kv_heads))
    least = -(-units // (MAX_SPLIT_TILES // unit_tiles))
    per = -(-units // min(units, max(want, least)))
    return -(-units // per), per * unit_tiles


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What one call signature of a decode kernel needs, built once: the
    entry point's plan array (dtype codes, shapes, splits, device, element
    strides; its layout is in the .cu source) and what the wrapper
    allocates."""

    args: ctypes.Array  # the plan array, c_longlong
    splits: int
    split_tiles: int
    ws_numel: int  # f32 partials past one split, else 0
    out_shape: tuple[int, int, int]
    out_dtype: torch.dtype
    device: int
    scale: float  # the default 1 / sqrt(D)
    cast_keep: bool  # the mask / key_valid (and table) go to contiguous int32 first

    @property
    def address(self) -> int:
        return ctypes.addressof(self.args)

    def allocate(self) -> tuple[torch.Tensor, int]:
        """The output and the address of the partials' workspace (0 at one
        split): one ``torch.empty`` whose head is the output and whose tail,
        16-byte aligned (the output is whole 64-wide rows), the workspace."""
        if not self.ws_numel:
            return torch.empty(self.out_shape, dtype=self.out_dtype, device=self.device), 0
        n_out = math.prod(self.out_shape)
        el = self.out_dtype.itemsize
        buf = torch.empty(n_out + -(-self.ws_numel * 4 // el), dtype=self.out_dtype,
                          device=self.device)
        return buf[:n_out].view(self.out_shape), buf.data_ptr() + n_out * el


_PLAN_CACHE_MAX = 256


def _signature(q, k, v, keep, *rest) -> tuple:
    """What a plan depends on: each tensor's shape, strides, dtype and
    device (the int8 scales' only where given)."""
    return (q.shape, q.stride(), q.dtype, q.get_device(), k.shape, k.stride(), k.dtype,
            k.get_device(), v.shape, v.stride(), v.dtype, v.get_device(), keep.shape,
            keep.stride(), keep.dtype, keep.get_device(),
            *((t.shape, t.stride(), t.dtype, t.get_device()) for t in rest if t is not None))


def _check_aligned(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")


_tls = threading.local()
_PACK = {n: struct.Struct(f"{n}Q").pack_into for n in (9, 10)}


def _pointers(*values: int) -> int:
    """The address of this thread's array of up to 10 call addresses, filled
    with ``values`` (0 for an absent tensor)."""
    try:
        arr, address = _tls.ptrs
    except AttributeError:
        arr = (ctypes.c_uint64 * 10)()
        address = ctypes.addressof(arr)
        _tls.ptrs = arr, address
    _PACK[len(values)](arr, 0, *values)
    return address


def _stream(device: int) -> int:
    """The current CUDA stream of ``device``, as an address."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(device) if raw is not None else torch.cuda.current_stream(device).cuda_stream


def _bind_run(lib: ctypes.CDLL, name: str) -> None:
    """Argument types of ``<name>_run(ptrs, plan, scale)`` and its error
    string, bound once when the library loads."""
    fn = getattr(lib, f"{name}_run")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p


_decode_plans: dict[tuple, _Plan] = {}


def _decode_plan(q, k, v, mask, k_scale=None, v_scale=None) -> _Plan:
    """The launch plan of ``decode_attention`` for these inputs: on the first
    call of a signature (shapes, dtypes, strides, devices) the full
    ``_check_decode``; on every call the checks that depend on the data
    (16-byte alignment of the K/V rows)."""
    key = _signature(q, k, v, mask, k_scale, v_scale)
    plan = _decode_plans.get(key)
    if plan is not None:
        if k.data_ptr() % 16 or v.data_ptr() % 16:
            _check_aligned("decode_attention", k=k, v=v)
        return plan
    _check_decode(q, k, v, mask, k_scale, v_scale)
    b, h, d = q.shape
    _, t, kvh, _ = k.shape
    cast = mask.dtype != torch.int32 or mask.stride(1) != 1
    quant = k_scale is not None
    sc_strides = (k_scale.stride()[:3] + v_scale.stride()[:3]) if quant else (0,) * 6
    splits, split_tiles = split_plan(b, kvh, t)
    device = q.get_device()
    plan = _Plan(
        args=(ctypes.c_longlong * 28)(
            _DTYPE_CODE[q.dtype], _KV_CODE[k.dtype],
            _DTYPE_CODE[k_scale.dtype] if quant else -1,
            b, t, h, kvh, d, splits, split_tiles, device,
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *sc_strides,
            h * d, d, t if cast else mask.stride(0),
        ),
        splits=splits, split_tiles=split_tiles,
        ws_numel=b * h * splits * (d + 2) if splits > 1 else 0,
        out_shape=(b, h, d), out_dtype=q.dtype, device=device,
        scale=1.0 / math.sqrt(d), cast_keep=cast,
    )
    if len(_decode_plans) >= _PLAN_CACHE_MAX:
        _decode_plans.clear()
    _decode_plans[key] = plan
    return plan


_decode_lib: ctypes.CDLL | None = None


def _load_decode() -> ctypes.CDLL:
    """The built K2 library, its argument types bound once."""
    global _decode_lib
    if _decode_lib is None:
        from ._build import load_library

        lib = load_library("decode_attention")
        _bind_run(lib, "decode_attention")
        _decode_lib = lib
    return _decode_lib


def decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [B, T, KVH, D] dense, or int8
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, T], nonzero = attend
    k_scale: torch.Tensor | None = None,  # [B, T, KVH, 1]: int8 cache
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """One decode step's attention over the KV cache; returns [B, H, D]
    in q's type.

    CUDA tensors launch the kernel (``csrc/decode_attention.cu``: the split
    kernel, and past one split the combine, on the current stream; the
    host reads nothing back) or raise; CPU tensors take
    ``decode_attention_ref``."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, mask, k_scale, v_scale, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    plan = _decode_plan(q, k, v, mask, k_scale, v_scale)
    lib = _load_decode()
    if plan.cast_keep:
        mask = mask.to(torch.int32).contiguous()
    out, ws = plan.allocate()
    quant = k_scale is not None
    rc = lib.decode_attention_run(
        _pointers(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  k_scale.data_ptr() if quant else 0, v_scale.data_ptr() if quant else 0,
                  mask.data_ptr(), out.data_ptr(), ws, _stream(plan.device)),
        plan.address, plan.scale if scale is None else scale,
    )
    if rc != 0:
        msg = lib.decode_attention_error_string(rc).decode()
        raise RuntimeError(f"decode_attention kernel launch failed ({rc}): {msg}")
    decode_attention.launches += 1
    return out


counts_launches(decode_attention)
