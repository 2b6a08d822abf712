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
  CUDA kernel walks the visiting keys in 128-key tiles on the shared Hopper
  main loop (``csrc/attention_sm90.cuh``: wgmma, TMA, key tiles with no
  valid key skipped), starts each query row from its carried state and
  writes it back unnormalised.  ``fresh=True`` starts from (0, -inf, 0)
  without reading a state; ``out=`` makes the hop the last one, writing
  ``o / max(l, 1e-20)`` there in q's type and no state.  The source's
  header says what bounds it.  ``ring_hop.launches`` counts its launches.
  CPU tensors take ``ring_hop_ref``, the plain version, with the same
  arguments.
- ``ring_attention``: the ring itself, n hops per call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Sequence

import torch

from ..ops.attention import _DTYPE_CODE, HEAD_DIM, MAX_SEQ
from ..runtime.compile_cache import counts_launches

MASKED = -1e9  # score of a masked key: finite, so an all-masked row averages V
MIN_SUM = 1e-20  # the ring's output is o / max(l, MIN_SUM)

Hop = Callable[..., object]  # ring_hop or ring_hop_ref


def ring_hop_ref(
    q: torch.Tensor,  # [B, S, H, D]: the local queries
    k: torch.Tensor,  # [B, S, H, D]: the visiting block
    v: torch.Tensor,  # [B, S, H, D]
    mask: torch.Tensor,  # [B, S], nonzero = keep: the visiting block's keys
    o: torch.Tensor | None,  # [B, H, S, D] f32, carried
    m: torch.Tensor | None,  # [B, H, S] f32: running row max
    l: torch.Tensor | None,  # [B, H, S] f32: running row sum
    scale: float,
    *,
    fresh: bool = False,
    out: torch.Tensor | None = None,  # [B, S, H, D] in q's type: the last hop
):
    """Plain PyTorch version of one hop (the JAX ring's einsum body): q, k
    and v widened to f32, masked keys at -1e9, ``m`` raised to the new row
    max and ``l``, ``o`` rescaled by ``exp(m_prev - m_new)`` before this
    block's terms are added.  ``fresh`` starts from (0, -inf, 0) and ignores
    ``o``, ``m`` and ``l``.  Returns the new ``(o, m, l)``, unnormalised;
    with ``out`` it writes ``o / max(l, 1e-20)`` there and returns ``out``."""
    if fresh:
        b, s, h, d = q.shape
        o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, s), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where((mask != 0)[:, None, None, :], s,
                    torch.tensor(MASKED, dtype=torch.float32, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    if out is None:
        return o, m_new, l
    out.copy_((o / l.clamp_min(MIN_SUM)[..., None]).transpose(1, 2))
    return out


def _check(q, k, v, mask, o, m, l, fresh, out) -> None:
    state = (o, m, l)
    if not fresh and any(t is None for t in state):
        raise ValueError("ring_hop: o, m and l are needed unless fresh=True")
    given = [t for t in (k, v, mask, out, *state) if t is not None]
    if any(t.device != q.device for t in given):
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
    if s > MAX_SEQ:
        raise ValueError(f"ring_hop: a block of {s} keys (the kernel takes {MAX_SEQ})")
    per_access = 16 // q.element_size()  # the kernel moves 16 bytes per access
    strided = [("q", q), ("k", k), ("v", v)] + ([("out", out)] if out is not None else [])
    for name, t in strided:
        if t.stride(3) != 1 or any(st % per_access for st in t.stride()[:3]):
            raise ValueError(
                f"ring_hop: {name} needs a unit head_dim stride and other strides "
                f"divisible by {per_access}, got {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"ring_hop: {name} is not 16-byte aligned")
    if out is not None and (out.dtype != q.dtype or out.shape != q.shape):
        raise ValueError(
            f"ring_hop: out must be {q.dtype} {list(q.shape)}, got {out.dtype} "
            f"{tuple(out.shape)}"
        )
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"ring_hop: mask must be [B, S], got {tuple(mask.shape)}")
    if fresh and (out is not None or o is None):
        return  # the state is not read, and is written to new tensors or not at all
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
            p, p, p, p, p, p, p, p,  # q, k, v, mask, o, m, l, out
            i, i, i, i, i, i,  # dtype, fresh, batch, seq, heads, head_dim
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
    o: torch.Tensor | None,  # [B, H, S, D] f32, contiguous
    m: torch.Tensor | None,  # [B, H, S] f32, contiguous
    l: torch.Tensor | None,  # [B, H, S] f32, contiguous
    scale: float,
    *,
    fresh: bool = False,
    out: torch.Tensor | None = None,  # [B, S, H, D] in q's type: the last hop
):
    """One ring hop; returns the updated ``(o, m, l)``, or ``out`` when given.

    CUDA tensors launch the kernel (``csrc/ring_hop.cu``), which updates
    ``o``, ``m`` and ``l`` in place and returns them (a fresh hop without
    them gets new ones), or writes ``o / max(l, 1e-20)`` into ``out`` and
    no state; or raise.  CPU tensors take ``ring_hop_ref``, which returns
    new tensors.  Callers use the returned ones."""
    if q.device.type == "cpu":
        return ring_hop_ref(q, k, v, mask, o, m, l, scale, fresh=fresh, out=out)
    if q.device.type != "cuda":
        raise ValueError(f"ring_hop: unsupported device {q.device}")
    _check(q, k, v, mask, o, m, l, fresh, out)
    from ..ops._build import load_library

    lib = load_library("ring_hop")
    _bind(lib)
    b, s, h, d = q.shape
    if fresh and out is None and o is None:
        o = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
        m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if mask.dtype != torch.int32 or mask.stride(1) != 1:
        mask = mask.to(torch.int32).contiguous()
    strides = (ctypes.c_longlong * 13)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], mask.stride(0),
        *(out.stride()[:3] if out is not None else (0, 0, 0)),
    )
    state = (None, None, None) if fresh and out is not None else (o, m, l)
    rc = lib.ring_hop_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in state),
        out.data_ptr() if out is not None else None,
        _DTYPE_CODE[q.dtype], int(fresh), b, s, h, d, strides, float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        msg = lib.ring_hop_error_string(rc).decode()
        raise RuntimeError(f"ring_hop kernel launch failed ({rc}): {msg}")
    ring_hop.launches += 1
    return (o, m, l) if out is None else out


counts_launches(ring_hop)


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
    i - j.  The first hop starts each shard's carried state fresh at (o, m,
    l) = (0, -inf, 0); after every hop but the last, each K/V/mask block
    moves one shard forward (to the device of shard i + 1); the last hop
    writes ``o / max(l, 1e-20)`` straight into the output, so a row whose
    keys are all masked is the plain mean of V, never NaN.  At one shard
    that is one hop a call, with no carried state at all.  ``hop`` is
    ``ring_hop`` (the kernel on the card) or ``ring_hop_ref``."""
    n = len(q)
    if not n == len(k) == len(v) == len(mask):
        raise ValueError(f"ring_attention: {n} q shards but {len(k)}/{len(v)}/{len(mask)} k/v/mask")
    scale = 1.0 / math.sqrt(q[0].shape[-1])

    def rotate(blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        # shard i receives shard i - 1's block (lax.ppermute j -> j + 1)
        return [blocks[i - 1].to(q[i].device, non_blocking=True) for i in range(n)]

    kc, vc, mc = list(k), list(v), list(mask)
    state: list = [(None, None, None)] * n
    for j in range(n - 1):  # every hop but the last carries the state on
        for i in range(n):
            state[i] = hop(q[i], kc[i], vc[i], mc[i], *state[i], scale, fresh=j == 0)
        kc, vc, mc = rotate(kc), rotate(vc), rotate(mc)
    return [
        hop(qi, ki, vi, mi, *st, scale, fresh=n == 1,
            out=torch.empty(qi.shape, dtype=qi.dtype, device=qi.device))
        for qi, ki, vi, mi, st in zip(q, kc, vc, mc, state)
    ]
