"""Paged decode attention (K3): one decode step over a block-paged KV pool.

Counterpart of the JAX package's ``ops/paged_attention.py``.  The pool is
``[NB, BS, KVH, D]`` per layer (int8 payloads with ``[NB, BS, KVH, 1]``
scale pools under ``QUANT_KV=int8``), shared by every slot; logical
position ``p`` of row ``b`` lives at ``pool[table[b, p // BS], p % BS]``.

- ``gather_pages`` / ``scatter_pages``: plain indexing through a table.  A
  sentinel id (``>= NB``, a freed or never-granted entry) clamps to
  ``NB - 1`` on a gather and drops on a scatter.
- ``paged_attention_ref``: the plain version (gather the dense view,
  dequantize, masked f32 softmax with masked keys at -1e30).
- ``paged_attention_split_ref``: the plain version in the kernel's split
  form (per-split partial (o, m, l), merged as the kernel's combine
  merges them): the form each candidate split of the autotuner is held
  against on the CPU.
- ``paged_decode_attention``: the wrapper.  CUDA tensors launch the
  hand-written kernel ``csrc/paged_decode_attention.cu`` on the decode core
  ``csrc/decode_sm90.cuh`` that K2 shares (replacing the Pallas kernel
  ``paged_decode_attention`` of the JAX package, bodies ``_paged_kernel_v``
  and ``_fold_block``) or raise; CPU tensors take ``paged_attention_ref``.
  The table splits across CTAs in whole blocks (``block_unit_tiles``): as
  many splits as ``split_plan`` picks from the shapes, or as the
  autotuner's table holds for the call's tuning key (``ops/autotune.py``:
  ``PALLAS_AUTOTUNE`` measures them at the paged loop's warm-up,
  ``PALLAS_VARIANT`` pins them), or as ``splits`` asks.  Each call
  signature's plan is built once per state of that table.
  ``paged_decode_attention.launches`` counts its launches.  The sources'
  headers say what bounds the kernel.

The Pallas kernel's tuning variants (block folding, head batching) and
its TP sharding wrapper are TPU tuning points of the same function and are
not carried; the split count is the Hopper kernel's own tuning axis.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .attention import (
    _DTYPE_CODE,
    _KV_CODE,
    HEAD_DIM,
    MAX_GROUP,
    MAX_SPLIT_TILES,
    SPLIT_TILE,
    _bind_run,
    _check_aligned,
    _Plan,
    _PLAN_CACHE_MAX,
    _pointers,
    _signature,
    _stream,
    split_plan,
)
from . import autotune
from ..runtime.compile_cache import counts_launches, uncounted


def gather_pages(pool: torch.Tensor, table: torch.Tensor, block_size: int) -> torch.Tensor:
    """Dense view of each row's blocks: ``[NB, BS, ...] x [B, T]`` ->
    ``[B, T * BS, ...]``.  Out-of-range ids clamp to the last block; the
    caller masks those positions."""
    nb = pool.shape[0]
    b, t = table.shape
    blocks = pool[table.long().clamp(0, nb - 1)]  # [B, T, BS, ...]
    return blocks.reshape((b, t * block_size) + tuple(pool.shape[2:]))


def scatter_pages(pool: torch.Tensor, table_row: torch.Tensor, values: torch.Tensor,
                  block_size: int, start: int = 0) -> torch.Tensor:
    """Write ``values`` ``[W, ...]`` at logical positions ``start ..
    start + W - 1`` of one row's blocks, in place; returns the pool.
    Positions past the table or at a sentinel entry drop.  The kept
    positions are found on ``table_row``'s device: a table row on the CPU
    costs the card no synchronisation."""
    nb = pool.shape[0]
    w = values.shape[0]
    p = start + torch.arange(w, device=table_row.device)
    bidx = p // block_size
    inside = bidx < table_row.shape[0]
    blk = table_row.long()[bidx.clamp(max=table_row.shape[0] - 1)]
    kept = torch.nonzero(inside & (blk >= 0) & (blk < nb)).flatten()
    dest = (blk * block_size + p % block_size)[kept]
    flat = pool.view((nb * block_size,) + tuple(pool.shape[2:]))
    flat.index_copy_(0, dest.to(pool.device),
                     values.index_select(0, kept.to(values.device)).to(pool.dtype))
    return pool


def paged_attention_ref(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [NB, BS, KVH, D] dense, or int8
    v_pool: torch.Tensor,
    table: torch.Tensor,  # [B, T] block ids
    key_valid: torch.Tensor,  # [B, T * BS], nonzero = attend
    block_size: int,
    k_scale: torch.Tensor | None = None,  # [NB, BS, KVH, 1]: int8 pools
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: gather, dequantize, masked softmax attention
    in f32 (masked keys at -1e30, so a row with no valid key averages its
    gathered values); query head h reads KV head h // (H / KVH).  Returns
    [B, H, D] in q's type."""
    b, h, d = q.shape
    kvh = k_pool.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kd = gather_pages(k_pool, table, block_size).float()
    vd = gather_pages(v_pool, table, block_size).float()
    if k_scale is not None:
        kd = kd * gather_pages(k_scale, table, block_size).float()
        vd = vd * gather_pages(v_scale, table, block_size).float()
    qg = q.float().reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bgrd,btgd->bgrt", qg, kd) * scale
    s = torch.where(key_valid[:, None, None, :] != 0, s,
                    torch.tensor(-1e30, dtype=torch.float32, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", p, vd)
    return o.reshape(b, h, d).to(q.dtype)


def paged_attention_split_ref(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [NB, BS, KVH, D] dense, or int8
    v_pool: torch.Tensor,
    table: torch.Tensor,  # [B, T] block ids
    key_valid: torch.Tensor,  # [B, T * BS], nonzero = attend
    block_size: int,
    splits: int,
    split_tiles: int,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """The plain version in the kernel's split form, in f32: the keys cut
    into ``splits`` runs of ``split_tiles`` 64-key tiles; each split's
    partial (o, m, l) of a masked softmax (a split with no valid key m =
    -inf, l = 0; a row with no valid key gives each split (sum v, 0, count),
    its plain mean after the merge), merged as the kernel's combine merges
    them: split s weighed by exp(m_s - max m).  Returns [B, H, D] in q's
    type."""
    b, h, d = q.shape
    kvh = k_pool.shape[2]
    rep = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kd = gather_pages(k_pool, table, block_size).float()
    vd = gather_pages(v_pool, table, block_size).float()
    if k_scale is not None:
        kd = kd * gather_pages(k_scale, table, block_size).float()
        vd = vd * gather_pages(v_scale, table, block_size).float()
    n = kd.shape[1]
    span = split_tiles * SPLIT_TILE
    if not (splits - 1) * span < n <= splits * span:
        raise ValueError(f"{splits} splits of {split_tiles} tiles do not cover {n} keys")
    pad = splits * span - n
    valid = torch.nn.functional.pad(key_valid != 0, (0, pad))  # [B, S * span]
    vpad = torch.nn.functional.pad(vd, (0, 0, 0, 0, 0, pad)).reshape(b, splits, span, kvh, d)
    sc = torch.einsum("bgrd,bngd->bgrn", q.float().reshape(b, kvh, rep, d), kd) * scale
    sc = torch.nn.functional.pad(sc, (0, pad))
    sc = torch.where(valid[:, None, None, :], sc, -math.inf).reshape(b, kvh, rep, splits, span)
    m = sc.amax(dim=-1)  # [B, G, R, S]
    p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bgrsn,bsngd->bgrsd", p, vpad)
    # A row with no valid key: every split's (sum v, 0, count).
    row_any = valid.any(dim=1)[:, None, None, None]
    count = (n - torch.arange(splits, device=l.device) * span).clamp(0, span).to(l)
    o_all = vpad.sum(dim=2).permute(0, 2, 1, 3)[:, :, None]  # [B, G, 1, S, D]
    m = torch.where(row_any, m, 0.0)
    l = torch.where(row_any, l, count)
    o = torch.where(row_any[..., None], o, o_all)
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    out = (w[..., None] * o).sum(dim=-2) / (w * l).sum(dim=-1)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def _check(q, k_pool, v_pool, table, key_valid, block_size, k_scale, v_scale) -> None:
    tensors = [q, k_pool, v_pool, table, key_valid] + [
        t for t in (k_scale, v_scale) if t is not None
    ]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on one device")
    quant = k_scale is not None or v_scale is not None
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention: q must be float32 or bfloat16, got {q.dtype}")
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("paged_decode_attention: int8 pools need k_scale and v_scale")
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(
                f"paged_decode_attention: scales given, so the pools must be int8, got "
                f"{k_pool.dtype}/{v_pool.dtype}"
            )
        if k_scale.dtype not in _DTYPE_CODE or v_scale.dtype != k_scale.dtype:
            raise TypeError(
                f"paged_decode_attention: scales must share float32 or bfloat16, got "
                f"{k_scale.dtype}/{v_scale.dtype}"
            )
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_decode_attention: dense pools must have q's type {q.dtype}, got "
            f"{k_pool.dtype}/{v_pool.dtype}"
        )
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_decode_attention: q must be [B, H, D] and the pools one "
            f"[NB, BS, KVH, D] shape, got {tuple(q.shape)}/{tuple(k_pool.shape)}/"
            f"{tuple(v_pool.shape)}"
        )
    b, h, d = q.shape
    nb, bs, kvh, dk = k_pool.shape
    if bs != block_size or dk != d:
        raise ValueError(
            f"paged_decode_attention: pools {tuple(k_pool.shape)} do not fit q "
            f"{tuple(q.shape)} at block size {block_size}"
        )
    if d != HEAD_DIM:
        raise ValueError(f"paged_decode_attention: head dim {d} (the kernel takes {HEAD_DIM})")
    if h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(
            f"paged_decode_attention: {h} query heads over {kvh} KV heads (the kernel "
            f"takes a whole group of at most {MAX_GROUP})"
        )
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] < 1:
        raise ValueError(f"paged_decode_attention: table must be [B, T], got {tuple(table.shape)}")
    if tuple(key_valid.shape) != (b, table.shape[1] * bs):
        raise ValueError(
            f"paged_decode_attention: key_valid must be [B, T * BS] = "
            f"{(b, table.shape[1] * bs)}, got {tuple(key_valid.shape)}"
        )
    if q.stride(2) != 1:
        raise ValueError(
            f"paged_decode_attention: q needs a unit head_dim stride, got {q.stride()}"
        )
    per_access = 16 // k_pool.element_size()  # the kernel moves 16 bytes per access
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        if x.stride(3) != 1 or any(st % per_access for st in x.stride()[:3]):
            raise ValueError(
                f"paged_decode_attention: {name} needs a unit head_dim stride and other "
                f"strides divisible by {per_access}, got {x.stride()}"
            )
        if x.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} is not 16-byte aligned")
    if quant:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(x.shape) != (nb, bs, kvh, 1):
                raise ValueError(
                    f"paged_decode_attention: {name} must be [NB, BS, KVH, 1], got "
                    f"{tuple(x.shape)}"
                )


def block_unit_tiles(block_size: int) -> int:
    """Tiles of a paged split's unit: the fewest 64-key tiles that hold a
    whole number of blocks (1 where that would pass the split's cap)."""
    unit = SPLIT_TILE * block_size // math.gcd(SPLIT_TILE, block_size) // SPLIT_TILE
    return unit if unit <= MAX_SPLIT_TILES else 1


_paged_plans: dict[tuple, _Plan] = {}


def _units(t: int, block_size: int) -> tuple[int, int]:
    """(units, tiles a unit) of a table of ``t`` blocks of ``block_size``."""
    unit = block_unit_tiles(block_size)
    return -(-(-(-t * block_size // SPLIT_TILE)) // unit), unit


def feasible_splits(t: int, block_size: int) -> list[int]:
    """Every split count a plan over ``t`` blocks of ``block_size`` can have,
    ascending: whole units of ``block_unit_tiles`` tiles, at most
    MAX_SPLIT_TILES a split, every split holding a key."""
    units, unit = _units(t, block_size)
    out = []
    for n in range(1, units + 1):
        per = -(-units // n)
        if per * unit <= MAX_SPLIT_TILES and -(-units // per) == n:
            out.append(n)
    return out


def split_count(b: int, kvh: int, t: int, block_size: int, splits: int = 0) -> tuple[int, int]:
    """(splits, tiles per split) of a plan over ``t`` blocks that asks for
    ``splits``; 0 is ``split_plan``'s own choice.  ValueError where no plan
    has that many splits."""
    units, unit = _units(t, block_size)
    if splits <= 0:
        return split_plan(b, kvh, t * block_size, unit)
    if splits not in feasible_splits(t, block_size):
        raise ValueError(
            f"{splits} splits do not fit a table of {t} blocks of {block_size} "
            f"(feasible: {feasible_splits(t, block_size)})")
    per = -(-units // splits)
    return splits, per * unit


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _paged_plan(q, k_pool, v_pool, table, key_valid, block_size, k_scale=None,
                v_scale=None, splits: int | None = None) -> _Plan:
    """The launch plan of ``paged_decode_attention`` for these inputs: on the
    first call of a signature the full ``_check``; on every call the pools'
    16-byte alignment.  The split count is ``splits`` when given, else the
    autotuner's entry for the call's tuning key, else ``split_plan``'s; the
    cache is keyed by the tuning table's generation, so a plan built before
    a pin or a sweep is not used after it, and one built again after the
    cache was cleared reads the table again."""
    key = (block_size, splits, autotune.generation()) + _signature(
        q, k_pool, v_pool, table, key_valid, k_scale, v_scale)
    plan = _paged_plans.get(key)
    if plan is not None:
        if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
            _check_aligned("paged_decode_attention", k_pool=k_pool, v_pool=v_pool)
        return plan
    _check(q, k_pool, v_pool, table, key_valid, block_size, k_scale, v_scale)
    b, h, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    t = table.shape[1]
    # one flag casts both; a cast of a contiguous int32 tensor is no copy
    cast = (table.dtype != torch.int32 or table.stride(1) != 1
            or key_valid.dtype != torch.int32 or key_valid.stride(1) != 1)
    quant = k_scale is not None
    sc_strides = (k_scale.stride()[:3] + v_scale.stride()[:3]) if quant else (0,) * 6
    if splits is None:
        splits = autotune.parse_variant(autotune.lookup(
            "paged_decode", b=b, kvh=kvh, n_rep=h // kvh, d=d, block_size=bs, t=t,
            dtype=_dtype_name(q.dtype), quant=quant))
    splits, split_tiles = split_count(b, kvh, t, bs, splits)
    device = q.get_device()
    plan = _Plan(
        args=(ctypes.c_longlong * 31)(
            _DTYPE_CODE[q.dtype], _KV_CODE[k_pool.dtype],
            _DTYPE_CODE[k_scale.dtype] if quant else -1,
            b, nb, bs, t, h, kvh, d, splits, split_tiles, device,
            *q.stride()[:2], *k_pool.stride()[:3], *v_pool.stride()[:3], *sc_strides,
            h * d, d, t if cast else table.stride(0), t * bs if cast else key_valid.stride(0),
        ),
        splits=splits, split_tiles=split_tiles,
        ws_numel=b * h * splits * (d + 2) if splits > 1 else 0,
        out_shape=(b, h, d), out_dtype=q.dtype, device=device,
        scale=1.0 / math.sqrt(d), cast_keep=cast,
    )
    if len(_paged_plans) >= _PLAN_CACHE_MAX:
        _paged_plans.clear()
    _paged_plans[key] = plan
    return plan


_paged_lib: ctypes.CDLL | None = None


def _load_paged() -> ctypes.CDLL:
    """The built K3 library, its argument types bound once."""
    global _paged_lib
    if _paged_lib is None:
        from ._build import load_library

        lib = load_library("paged_decode_attention")
        _bind_run(lib, "paged_decode_attention")
        _paged_lib = lib
    return _paged_lib


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [NB, BS, KVH, D] dense, or int8
    v_pool: torch.Tensor,
    table: torch.Tensor,  # [B, T] block ids; sentinels (>= NB) clamp
    key_valid: torch.Tensor,  # [B, T * BS], nonzero = attend
    block_size: int,
    k_scale: torch.Tensor | None = None,  # [NB, BS, KVH, 1]: int8 pools
    v_scale: torch.Tensor | None = None,
    scale: float | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """One decode step's attention over the paged pool; returns [B, H, D]
    in q's type.

    CUDA tensors launch the kernel (``csrc/paged_decode_attention.cu``: the
    split kernel, and past one split the combine, on the current stream; the
    host reads nothing back) or raise; CPU tensors take
    ``paged_attention_ref``.  ``splits`` forces the grid's split count (the
    autotuner's candidates); by default the tuned or the heuristic one."""
    if q.device.type == "cpu":
        with uncounted():
            return paged_attention_ref(q, k_pool, v_pool, table, key_valid, block_size,
                                       k_scale, v_scale, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    plan = _paged_plan(q, k_pool, v_pool, table, key_valid, block_size, k_scale, v_scale,
                       splits)
    lib = _load_paged()
    if plan.cast_keep:
        table = table.to(torch.int32).contiguous()
        key_valid = key_valid.to(torch.int32).contiguous()
    out, ws = plan.allocate()
    quant = k_scale is not None
    rc = lib.paged_decode_attention_run(
        _pointers(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  k_scale.data_ptr() if quant else 0, v_scale.data_ptr() if quant else 0,
                  table.data_ptr(), key_valid.data_ptr(), out.data_ptr(), ws,
                  _stream(plan.device)),
        plan.address, plan.scale if scale is None else scale,
    )
    if rc != 0:
        msg = lib.paged_decode_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_decode_attention kernel launch failed ({rc}): {msg}")
    paged_decode_attention.launches += 1
    return out


counts_launches(paged_decode_attention)
