"""Ring attention over sequence shards, and its hop kernel (K4).

Counterpart of the JAX package's ``parallel/ring.py``.  The sequence axis
is cut into n shards; each shard keeps its local Q block and the K/V (and
key-mask) blocks travel around the ring, one shard forward after every hop
but the last, while f32 online-softmax accumulators ``(o, m, l)`` merge
each hop's partial attention.  There the rotation is ``lax.ppermute``
inside a ``shard_map``; here one process drives every shard, so the
rotation is ``tensor.to(next_device, non_blocking=True)``: a peer-to-peer
copy between cards, and no copy at all where shards share a device.

- ``ring_hop`` (K4): one hop's online-softmax update for every (batch,
  head), the hand-written CUDA kernel ``csrc/ring_hop.cu`` on the card,
  replacing the Pallas TPU kernel ``_hop_pallas`` (body ``_hop_kernel``).
  The TPU kernel holds one head's whole [S_loc, S_loc] f32 score tile in
  VMEM, which at S_loc = 2048 is 16 MB, far past an SM's shared memory; the
  CUDA kernel walks the visiting keys in 64-key tiles (K1's design), starts
  each query row from its carried state and writes it back unnormalised.
  The source's header says what bounds it.  ``ring_hop.launches`` counts
  its launches.  CPU tensors take ``ring_hop_ref``, the plain version.
- ``ring_attention``: the ring itself, n hops per call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Sequence

import torch

from ..ops.attention import _DTYPE_CODE, HEAD_DIM

MASKED = -1e9  # score of a masked key: finite, so an all-masked row averages V

Hop = Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def ring_hop_ref(
    q: torch.Tensor,  # [B, S, H, D]: the local queries
    k: torch.Tensor,  # [B, S, H, D]: the visiting block
    v: torch.Tensor,  # [B, S, H, D]
    mask: torch.Tensor,  # [B, S], nonzero = keep: the visiting block's keys
    o: torch.Tensor,  # [B, H, S, D] f32, carried
    m: torch.Tensor,  # [B, H, S] f32: running row max
    l: torch.Tensor,  # [B, H, S] f32: running row sum
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one hop (the JAX ring's einsum body): q, k
    and v widened to f32, masked keys at -1e9, ``m`` raised to the new row
    max and ``l``, ``o`` rescaled by ``exp(m_prev - m_new)`` before this
    block's terms are added.  No normalisation.  Returns new ``(o, m, l)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where((mask != 0)[:, None, None, :], s,
                    torch.tensor(MASKED, dtype=torch.float32, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return o, m_new, l


def _check(q, k, v, mask, o, m, l) -> None:
    if any(t.device != q.device for t in (k, v, mask, o, m, l)):
        raise ValueError("ring_hop: all inputs must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"ring_hop: q/k/v must share one of float32/bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"ring_hop: q/k/v must be [B, S, H, D] of one shape, got "
            f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"ring_hop: head dim {d} (the kernel takes {HEAD_DIM})")
    per_access = 16 // q.element_size()  # the kernel moves 16 bytes per access
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % per_access for st in t.stride()[:3]):
            raise ValueError(
                f"ring_hop: {name} needs a unit head_dim stride and other strides "
                f"divisible by {per_access}, got {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"ring_hop: {name} is not 16-byte aligned")
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"ring_hop: mask must be [B, S], got {tuple(mask.shape)}")
    for name, t, shape in (("o", o, (b, h, s, d)), ("m", m, (b, h, s)), ("l", l, (b, h, s))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"ring_hop: {name} must be a contiguous float32 {list(shape)}, got "
                f"{t.dtype} {tuple(t.shape)} strides {t.stride()}"
            )
    if o.data_ptr() % 16:
        raise ValueError("ring_hop: o is not 16-byte aligned")


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ring_hop_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [
            p, p, p, p, p, p, p,  # q, k, v, mask, o, m, l
            i, i, i, i, i,  # dtype, batch, seq, heads, head_dim
            ctypes.POINTER(ctypes.c_longlong),  # strides
            ctypes.c_float, i, p,  # scale, device, stream
        ]
        fn.restype = i
        lib.ring_hop_error_string.argtypes = [i]
        lib.ring_hop_error_string.restype = ctypes.c_char_p


def ring_hop(
    q: torch.Tensor,  # [B, S, H, D] f32 or bf16
    k: torch.Tensor,  # [B, S, H, D], q's type
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, S], nonzero = keep
    o: torch.Tensor,  # [B, H, S, D] f32, contiguous
    m: torch.Tensor,  # [B, H, S] f32, contiguous
    l: torch.Tensor,  # [B, H, S] f32, contiguous
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring hop; returns the updated ``(o, m, l)``.

    CUDA tensors launch the kernel (``csrc/ring_hop.cu``), which updates
    ``o``, ``m`` and ``l`` in place and returns them, or raise; CPU tensors
    take ``ring_hop_ref``, which returns new tensors.  Callers use the
    returned ones."""
    if q.device.type == "cpu":
        return ring_hop_ref(q, k, v, mask, o, m, l, scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_hop: unsupported device {q.device}")
    _check(q, k, v, mask, o, m, l)
    from ..ops._build import load_library

    lib = load_library("ring_hop")
    _bind(lib)
    b, s, h, d = q.shape
    if mask.dtype != torch.int32 or mask.stride(1) != 1:
        mask = mask.to(torch.int32).contiguous()
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], mask.stride(0),
    )
    rc = lib.ring_hop_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(),
        _DTYPE_CODE[q.dtype], b, s, h, d, strides, float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        msg = lib.ring_hop_error_string(rc).decode()
        raise RuntimeError(f"ring_hop kernel launch failed ({rc}): {msg}")
    ring_hop.launches += 1
    return o, m, l


ring_hop.launches = 0


def ring_attention(
    q: Sequence[torch.Tensor],  # n shards of [B, S_loc, H, D], in ring order
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    mask: Sequence[torch.Tensor],  # n shards of [B, S_loc], nonzero = keep
    hop: Hop = ring_hop,
) -> list[torch.Tensor]:
    """Attention of every query shard over the whole sequence; returns n
    shards of [B, S_loc, H, D] in q's type, each on its shard's device.

    n hops: in hop j, shard i attends over the block that started on shard
    i - j.  The carried state starts at (o, m, l) = (0, -inf, 0); after
    every hop but the last, each K/V/mask block moves one shard forward (to
    the device of shard i + 1); the result is ``o / max(l, 1e-20)``, so a
    row whose keys are all masked is the plain mean of V, never NaN.
    ``hop`` is ``ring_hop`` (the kernel on the card) or ``ring_hop_ref``."""
    n = len(q)
    if not n == len(k) == len(v) == len(mask):
        raise ValueError(f"ring_attention: {n} q shards but {len(k)}/{len(v)}/{len(mask)} k/v/mask")
    scale = 1.0 / math.sqrt(q[0].shape[-1])
    state = []
    for qi in q:
        b, s, h, d = qi.shape
        state.append((
            torch.zeros((b, h, s, d), dtype=torch.float32, device=qi.device),
            torch.full((b, h, s), -math.inf, dtype=torch.float32, device=qi.device),
            torch.zeros((b, h, s), dtype=torch.float32, device=qi.device),
        ))

    def rotate(blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        # shard i receives shard i - 1's block (lax.ppermute j -> j + 1)
        return [blocks[i - 1].to(q[i].device, non_blocking=True) for i in range(n)]

    kc, vc, mc = list(k), list(v), list(mask)
    for j in range(n):
        for i in range(n):
            state[i] = hop(q[i], kc[i], vc[i], mc[i], *state[i], scale)
        if j < n - 1:  # the last hop's rotation would only be discarded
            kc, vc, mc = rotate(kc), rotate(vc), rotate(mc)
    return [
        (o / l.clamp_min(1e-20)[..., None]).transpose(1, 2).to(qi.dtype)
        for qi, (o, _, l) in zip(q, state)
    ]
