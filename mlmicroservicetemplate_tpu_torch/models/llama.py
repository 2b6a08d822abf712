"""Llama-family decoder (RoPE, grouped-query attention, SwiGLU), KV-cached.

Counterpart of the JAX package's ``models/llama.py``, greedy or sampled
per row (``models/sampling.py``): pre-norm RMSNorm blocks, rotary embeddings (HF rotate-half)
applied before K is cached, GQA (K/V kept at KV-head width; query head h
reads KV head h // R), SwiGLU MLP, no biases, untied LM head.  Defaults
are TinyLlama-1.1B.

Prefill is plain PyTorch (``common.mha_attention`` under a causal and
padding mask), as the JAX package computes it outside any kernel.  Each
decode step's single query attends to the cache through
``ops.attention.decode_attention``: the hand-written CUDA kernel on the
card, its plain version on the CPU.

Unlike the JAX package's immutable arrays, the KV cache is preallocated
at ``[B, S + max_len, KVH, D]`` per layer (int8 payload plus a
``[B, S + max_len, KVH, 1]`` scale under ``kv_quant``) and every decode
step writes its K/V row, the key-validity bit, its token and the per-row
fields (``write_idx``, ``pos``, ``last_token``, ``done``, the sampling
chains) in place, so a
CUDA graph of a chunk replays over the same state.
The continuous loop's freed rows keep stepping until their slot is
reused; their writes past a width land in the row's own last column
(``gpt.write_at``), where the reference's ``mode="drop"`` drops them.

Paged decode (``PAGED_KV=1``, the continuous loop) keeps the same step
over a ``gpt.PagedState``: K/V rows go to a block pool through a block
table, and the single query attends through
``ops.paged_attention.paged_decode_attention``.

Speculative decoding (``SPEC_DECODE``): ``multi_step`` is the verify
window of ``gpt.multi_step`` with RoPE at each row's own window positions,
K/V written at KV-head width (dense or int8), and the window's queries
through ``_window_attention``'s plain path (``K + 1`` >= 2 queries a row).

Chunked prefill (``PREFILL_CHUNK``): ``prefill_chunk`` and
``paged_prefill_chunk`` take ``gpt.py``'s window contract at GQA width and
with the int8 cache; a one-token window attends through the decode kernel
(K2), as the reference's ``_cache_attention`` takes its decode kernel for
a single query.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    dense,
    embed,
    kv_quantize,
    lm_head_logits,
    merge_heads,
    mha_attention,
    mha_attention_kv8,
    repeat_kv,
    rmsnorm,
    split_heads,
)
from .gpt import (
    GPTState,
    PagedState,
    cache_attention,
    cache_dtype,
    contiguous_io,
    empty_state,
    finish_step,
    paged_io,
    paged_window_base,
    paged_window_kv,
    paged_write_kv,
    prefill_caches,
    prefix_len,
    prefix_mask,
    prefix_pairs,
    prefixed_state,
    run_steps,
    span_mask,
    span_positions,
    span_write_kv,
    window_dest,
    window_mask,
    window_positions,
    window_write,
    window_write_kv,
    with_prefix,
    write_at,
)
from . import lora
from .quant import load_weights
from .sampling import SampleParams


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    # Defaults = TinyLlama-1.1B; tests use small overrides.
    vocab_size: int = 32000
    d_model: int = 2048
    num_heads: int = 32
    num_kv_heads: int = 4
    num_layers: int = 22
    d_ff: int = 5632
    max_position: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 0
    # int8 KV cache (QUANT_KV=int8): per-token, per-head int8 + scales in
    # the compute type, dequantized inside the decode kernel.
    kv_quant: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def n_rep(self) -> int:
        return self.num_heads // self.num_kv_heads


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


class Linear(nn.Linear):
    """Bias-free ``nn.Linear`` that computes in its input's type."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, None)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, kv = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
        self.q, self.k, self.v, self.o = Linear(d, d), Linear(d, kv), Linear(d, kv), Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate = Linear(cfg.d_model, cfg.d_ff)
        self.up = Linear(cfg.d_model, cfg.d_ff)
        self.down = Linear(cfg.d_ff, cfg.d_model)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(h)) * self.up(h))


class Layer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.attn_ln = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.attn = Attention(cfg)
        self.mlp_ln = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.mlp = Mlp(cfg)

    def qkv(self, cfg: LlamaConfig, x, cos, sin, ad=None, li: int = 0):
        """Rotated q [B, S, H, D], rotated k and v [B, S, KVH, D] (each
        projection with its per-row LoRA delta under an adapter overlay
        ``ad``, at layer ``li``; ``models/lora.py``)."""
        h = self.attn_ln(x)
        a = self.attn
        q, k, v = (lora.apply(ad, name, li, h, getattr(a, name)(h)) for name in "qkv")
        q = apply_rope(split_heads(q, cfg.num_heads), cos, sin)
        k = apply_rope(split_heads(k, cfg.num_kv_heads), cos, sin)
        return q, k, split_heads(v, cfg.num_kv_heads)

    def finish(self, x: torch.Tensor, ctx: torch.Tensor, ad=None, li: int = 0) -> torch.Tensor:
        """Attention output projection (with its LoRA delta under ``ad``)
        and the MLP, both residual."""
        c = merge_heads(ctx)
        x = x + lora.apply(ad, "o", li, c, self.attn.o(c))
        return x + self.mlp(self.mlp_ln(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.lm_head = Linear(cfg.d_model, cfg.vocab_size)


# ---------------------------------------------------------------------------
# rotary embeddings (HF rotate-half convention)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor, dtype: torch.dtype):
    """cos / sin ``[..., head_dim]`` for integer positions ``[...]``:
    angles in f32, then cast to ``dtype``."""
    half = cfg.head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) * 2.0
    inv_freq = 1.0 / (cfg.rope_theta ** (exponent / cfg.head_dim))
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin broadcastable to [B, S, 1, D]."""
    return x * cos + _rotate_half(x) * sin


# ---------------------------------------------------------------------------
# prefill


def _kv_int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    q8, scale = kv_quantize(x)
    return (q8.float() * scale).to(x.dtype)


def _dequant_prefix(entry, dtype: torch.dtype) -> torch.Tensor:
    """Dense form of a prefix K/V entry for the suffix prefill's attention
    (an ``(int8, scale)`` pair is dequantized in ``dtype``, once a
    prefill; the cached copy stays int8)."""
    if isinstance(entry, tuple):
        q8, sc = entry
        return q8.to(dtype) * sc.to(dtype)
    return entry.to(dtype)


def _quant_prefix_entry(entry, dtype: torch.dtype):
    """The int8 cache's ``(int8, scale in dtype)`` form of a prefix K/V
    entry: a pair passes through exactly (a capture under the int8 cache
    cuts its rows), a dense entry quantizes with the cache's own
    per-token, per-head scheme."""
    if isinstance(entry, tuple):
        q8, sc = entry
        return q8, sc.to(dtype)
    q8, sc = kv_quantize(entry)
    return q8, sc.to(dtype)


def quantize_prefix_kv(pkv: dict) -> dict:
    """A dense ``compute_prefix_kv`` result in the int8 cache's ``(int8,
    scale)`` form: a global ``PROMPT_PREFIX`` under ``QUANT_KV=int8`` is
    quantized once, at startup."""
    return {"k": [tuple(kv_quantize(k)) for k in pkv["k"]],
            "v": [tuple(kv_quantize(v)) for v in pkv["v"]]}


def forward_hidden(
    model: LlamaModel,
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S]
    dtype: torch.dtype = torch.float32,
    collect_kv: bool = False,
    kv_int8_roundtrip: bool = False,
    prefix_kv=None,
):
    """Final hidden states [B, S, D] (and, with ``collect_kv``, each
    layer's rotated K and V).  ``kv_int8_roundtrip`` passes K and V
    through the int8 cache's quantize-dequantize before attention, which
    measures what storing them in int8 costs.  With ``prefix_kv`` (one
    ``(k, v)`` per layer of ``[1 or B, P, KVH, D]`` rotated entries, dense
    or ``(int8, scale)``: a cached prefix) the batch is the suffix of that
    prefix: its tokens take rotary positions ``P ..``, every query sees the
    whole prefix and its causal suffix, and only the suffix's K/V is
    computed."""
    cfg = model.cfg
    s = input_ids.shape[1]
    dev = input_ids.device
    p_len = 0 if prefix_kv is None else prefix_len(prefix_kv[0][0])
    x = embed(model.embed, input_ids, dtype)
    cos, sin = rope_tables(cfg, torch.arange(p_len, p_len + s, device=dev), dtype)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    mask = prefix_mask(causal[None, None] & (attention_mask[:, None, None, :] != 0), p_len)
    kv = []
    ad = lora.adapter_tables(model)
    for li, layer in enumerate(model.layers):
        q, k, v = layer.qkv(cfg, x, cos, sin, ad, li)
        if collect_kv:
            kv.append((k, v))
        if kv_int8_roundtrip:
            k, v = _kv_int8_roundtrip(k), _kv_int8_roundtrip(v)
        if p_len:
            pk, pv = prefix_kv[li]
            k = with_prefix(k, _dequant_prefix(pk, k.dtype))
            v = with_prefix(v, _dequant_prefix(pv, v.dtype))
        ctx = mha_attention(q, repeat_kv(k, cfg.n_rep), repeat_kv(v, cfg.n_rep), mask=mask)
        x = layer.finish(x, ctx, ad, li)
    x = model.final_ln(x)
    return (x, kv) if collect_kv else x


def compute_prefix_kv(model: LlamaModel, prefix_ids,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Each layer's rotated K/V ``[1, P, KVH, D]`` of a shared prompt prefix
    (``P`` ids): ``{"k": [...], "v": [...]}``, computed once at startup."""
    dev = model.final_ln.weight.device
    ids = torch.as_tensor(np.asarray(prefix_ids, np.int32), device=dev).reshape(1, -1)
    _, kv = forward_hidden(model, ids, torch.ones_like(ids), dtype, collect_kv=True)
    return {"k": [k for k, _ in kv], "v": [v for _, v in kv]}


def lm_logits(model: LlamaModel, input_ids, attention_mask, dtype=torch.float32,
              kv_int8_roundtrip: bool = False) -> torch.Tensor:
    """[B, S, V] next-token logits in f32 (the non-generative forward)."""
    x = forward_hidden(model, input_ids, attention_mask, dtype,
                       kv_int8_roundtrip=kv_int8_roundtrip)
    return lm_head_logits(x, model.lm_head)


# ---------------------------------------------------------------------------
# incremental decode


def init_decode_state(
    model: LlamaModel,
    input_ids: torch.Tensor,  # [B, S] right-padded
    attention_mask: torch.Tensor,  # [B, S]
    max_len: int,
    dtype: torch.dtype = torch.float32,
    sample: SampleParams | None = None,
    prefix_kv: dict | None = None,
) -> GPTState:
    """Prefill, then the preallocated cache and the per-row state
    (``sample``: per-row sampling parameters, copied; None = greedy).

    As in the JAX package, ``write_idx`` starts at the last prompt token:
    the first decode step embeds it again and rewrites its K/V row.  With
    ``prefix_kv`` (``compute_prefix_kv``'s form, ``[1 or B, P, KVH, D]``,
    dense or ``(int8, scale)``; a global ``PROMPT_PREFIX`` or a
    prefix-cache hit) the prompt is its suffix: the prefix rows sit at
    ``[0, P)``, valid (under the int8 cache as int8 and scale, a pair copied
    bit for bit), and ``write_idx`` starts at ``P + len - 1``."""
    cfg = model.cfg
    s = input_ids.shape[1]
    pairs = prefix_pairs(prefix_kv)
    p_len = 0 if pairs is None else prefix_len(pairs[0][0])
    _, kv = forward_hidden(model, input_ids, attention_mask, dtype, collect_kv=True,
                           prefix_kv=pairs)
    if pairs is not None and cfg.kv_quant:
        pairs = [tuple(_quant_prefix_entry(e, dtype) for e in kv_pair) for kv_pair in pairs]
    cache_k, cache_v = prefill_caches(kv, p_len + s + max_len, cfg.kv_quant, dtype,
                                      input_ids.device, prefix=pairs)
    return prefixed_state(cache_k, cache_v, input_ids, attention_mask, max_len, p_len,
                          cfg.pad_id, sample)


def _step(model: LlamaModel, state, write_kv_fn, attend, sample: bool):
    """One step for every row, over the cache layout that
    ``write_kv_fn(cache, at, new)`` and ``attend(q, ck, cv, key_valid)``
    address (``at``: each row's write position, ``gpt.write_at``): each
    row embeds its last token at its own position, writes its K/V row and
    attends to its cache; ``gpt.finish_step`` picks the tokens (argmax, or
    with ``sample`` per-row sampling).  Every field is updated in the
    state's own tensors (and ``steps`` on the host), so a captured step
    reads and writes the same addresses at every replay.  Returns the
    state and the tokens."""
    cfg = model.cfg
    dtype = cache_dtype(state)
    b = state.last_token.shape[0]
    rows = torch.arange(b, device=state.last_token.device)
    t = state.write_idx
    at = write_at(state, t, state.key_valid.shape[1])
    x = embed(model.embed, state.last_token[:, None], dtype)  # [B, 1, D]
    cos, sin = rope_tables(cfg, t.clamp(max=cfg.max_position - 1), dtype)
    cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    # A device tensor, not a Python 1: a scalar would be copied from the host.
    state.key_valid[rows, at] = torch.ones_like(at, dtype=state.key_valid.dtype)
    ad = lora.adapter_tables(model)
    for li, layer in enumerate(model.layers):
        q, k1, v1 = layer.qkv(cfg, x, cos, sin, ad, li)
        write_kv_fn(state.cache_k[li], at, k1[:, 0])
        write_kv_fn(state.cache_v[li], at, v1[:, 0])
        ctx = attend(q, state.cache_k[li], state.cache_v[li], state.key_valid)
        x = layer.finish(x, ctx, ad, li)
    x = model.final_ln(x)
    logits = lm_head_logits(x[:, 0], model.lm_head)
    state.write_idx.add_(1)
    return finish_step(state, cfg, logits, sample)


def decode_step(model: LlamaModel, state: GPTState,
                sample: bool = False) -> tuple[GPTState, torch.Tensor]:
    """One step over the contiguous cache."""
    return _step(model, state, *contiguous_io(state), sample)


def generate_chunk(model: LlamaModel, state: GPTState, n_steps: int,
                   sample: bool = False) -> tuple[GPTState, torch.Tensor]:
    """``n_steps`` decode steps (``sample``: the per-row sampling path,
    else argmax, as the JAX static argument); returns the state and the
    chunk's tokens [B, n_steps].  A state whose rows step together
    (``steps`` not None) refuses to step past its token width."""
    return run_steps(lambda s: decode_step(model, s, sample), state, n_steps)


# ---------------------------------------------------------------------------
# block-paged decode (PAGED_KV=1): gpt.PagedState at GQA width, dense or int8


def paged_decode_step(model: LlamaModel, state: PagedState, table: torch.Tensor,
                      block_size: int, sample: bool = False) -> tuple[PagedState, torch.Tensor]:
    """One step with K/V written and read through the block table
    ``table`` [B, T] (positions, masks and EOS logic as the contiguous
    step: the physical layout is the only difference)."""
    return _step(model, state, *paged_io(state, table, block_size), sample)


def generate_chunk_paged(model: LlamaModel, state: PagedState, table: torch.Tensor,
                         block_size: int, n_steps: int,
                         sample: bool = False) -> tuple[PagedState, torch.Tensor]:
    """``n_steps`` paged steps; returns the state and the chunk's tokens
    [B, n_steps]."""
    return run_steps(lambda s: paged_decode_step(model, s, table, block_size, sample),
                     state, n_steps)


def greedy_generate(model: LlamaModel, input_ids, attention_mask, max_len: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Prefill plus ``max_len`` greedy steps -> tokens [B, max_len] int32."""
    state = init_decode_state(model, input_ids, attention_mask, max_len, dtype)
    state, _ = generate_chunk(model, state, max_len)
    return state.tokens


# ---------------------------------------------------------------------------
# chunked prefill (PREFILL_CHUNK): gpt.py's window contract at GQA width,
# with the int8 KV cache


def empty_decode_state(model: LlamaModel, batch: int, s_total: int, max_len: int,
                       dtype: torch.dtype = torch.float32) -> GPTState:
    """All-zero decode state for a chunked prefill (``gpt.empty_state``);
    under ``kv_quant`` int8 payloads with scales of ones, the layout the
    monolithic prefill writes, so the windows' quantized rows land where
    its rows would."""
    return empty_state(model.cfg, batch, s_total, max_len, dtype, model.final_ln.weight.device)


def _window_rope(cfg: LlamaConfig, pos_w: torch.Tensor, dtype):
    """cos / sin [1, C, 1, D] at the window's positions (clamped to the
    position table)."""
    cos, sin = rope_tables(cfg, pos_w.clamp(max=cfg.max_position - 1), dtype)
    return cos[None, :, None, :], sin[None, :, None, :]


def _window_attention(cfg: LlamaConfig, q, ck, cv, mask) -> torch.Tensor:
    """A window's queries [B, C, H, D] over dense or int8 K/V [B, T, KVH,
    D] under ``mask`` [B, 1, C, T]: the GQA repeat of payloads and scales
    alike, then ``mha_attention`` or ``mha_attention_kv8``.  A one-token
    window runs the decode kernel (K2) instead, as the reference's
    ``_cache_attention`` takes its decode kernel for a single query: no
    repeat, int8 payloads dequantized inside."""
    if q.shape[1] == 1:
        return cache_attention(q, ck, cv, mask[:, 0, 0, :].to(torch.int32))
    if isinstance(ck, tuple):
        return mha_attention_kv8(q, repeat_kv(ck[0], cfg.n_rep), repeat_kv(ck[1], cfg.n_rep),
                                 repeat_kv(cv[0], cfg.n_rep), repeat_kv(cv[1], cfg.n_rep),
                                 mask=mask)
    return mha_attention(q, repeat_kv(ck, cfg.n_rep), repeat_kv(cv, cfg.n_rep), mask=mask)


def prefill_chunk(model: LlamaModel, state: GPTState, chunk_ids: torch.Tensor,
                  chunk_mask: torch.Tensor, start: torch.Tensor) -> GPTState:
    """One prompt window into the contiguous cache, in place
    (``gpt.prefill_chunk``): RoPE at each absolute position, K/V written at
    KV-head width (quantized per token and head under ``kv_quant``, the
    monolithic prefill's scheme, so the grouping into windows never changes
    the stored bytes), the window's queries over the cache."""
    cfg = model.cfg
    dtype = cache_dtype(state)
    c = chunk_ids.shape[1]
    cos, sin = _window_rope(cfg, window_positions(start, c), dtype)
    x = embed(model.embed, chunk_ids, dtype)
    mask = window_mask(state.key_valid != 0, chunk_mask, start)
    ad = lora.adapter_tables(model)
    for li, layer in enumerate(model.layers):
        q, k1, v1 = layer.qkv(cfg, x, cos, sin, ad, li)
        window_write_kv(state.cache_k[li], k1, start, dtype)
        window_write_kv(state.cache_v[li], v1, start, dtype)
        x = layer.finish(x, _window_attention(cfg, q, state.cache_k[li], state.cache_v[li],
                                              mask), ad, li)
    window_write(state.key_valid, chunk_mask.to(state.key_valid.dtype), start)
    return state


def paged_prefill_chunk(model: LlamaModel, state: PagedState, table_row: torch.Tensor,
                        chunk_ids: torch.Tensor, chunk_mask: torch.Tensor,
                        start: torch.Tensor, block_size: int) -> PagedState:
    """One prompt window [1, C] straight into the stream's pool blocks
    (``gpt.paged_prefill_chunk``), at GQA width and with the int8 pool
    pairs; the window's queries read a dense gather of the stream's
    blocks."""
    cfg = model.cfg
    dtype = cache_dtype(state)
    c = chunk_ids.shape[1]
    cos, sin = _window_rope(cfg, window_positions(start, c), dtype)
    x = embed(model.embed, chunk_ids, dtype)
    mask = window_mask(paged_window_base(table_row, block_size, start), chunk_mask, start)
    dest = window_dest(table_row, start, c, block_size, state.num_blocks)
    ad = lora.adapter_tables(model)
    for li, layer in enumerate(model.layers):
        q, k1, v1 = layer.qkv(cfg, x, cos, sin, ad, li)
        paged_write_kv(state.cache_k[li], dest, k1[0], dtype)
        paged_write_kv(state.cache_v[li], dest, v1[0], dtype)
        kd, vd = paged_window_kv(state.cache_k[li], state.cache_v[li], table_row, block_size)
        x = layer.finish(x, _window_attention(cfg, q, kd, vd, mask), ad, li)
    return state


# ---------------------------------------------------------------------------
# speculative verify window (models/spec.py)


def multi_step(model: LlamaModel, state: GPTState, tokens: torch.Tensor) -> torch.Tensor:
    """The verify window (``gpt.multi_step``): RoPE at each row's window
    positions, K/V written at KV-head width (quantized under ``kv_quant``)
    with writes past the cache dropped, the window's queries over the GQA
    repeat of the cache; returns f32 logits [B, D, V]."""
    cfg = model.cfg
    dtype = cache_dtype(state)
    t = state.write_idx
    pos_w = span_positions(t, tokens.shape[1])
    cos, sin = rope_tables(cfg, pos_w.clamp(max=cfg.max_position - 1), dtype)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x = embed(model.embed, tokens, dtype)
    mask = span_mask(state.key_valid != 0, t, tokens.shape[1])
    ad = lora.adapter_tables(model)
    for li, layer in enumerate(model.layers):
        q, k1, v1 = layer.qkv(cfg, x, cos, sin, ad, li)
        span_write_kv(state.cache_k[li], k1, t, dtype)
        span_write_kv(state.cache_v[li], v1, t, dtype)
        x = layer.finish(x, _window_attention(cfg, q, state.cache_k[li], state.cache_v[li],
                                              mask), ad, li)
    x = model.final_ln(x)
    return lm_head_logits(x, model.lm_head)


# ---------------------------------------------------------------------------
# weights


def init_params(cfg: LlamaConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights in ``LlamaModel``'s state-dict layout, drawn on the
    CPU from ``generator``: N(0, 0.02) embedding and projections, unit
    RMSNorm scales."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in LlamaModel(cfg).state_dict().items()}
    return {
        name: torch.ones(shape) if name.endswith("_ln.weight")
        else torch.empty(shape).normal_(0.0, 0.02, generator=generator)
        for name, shape in shapes.items()
    }


def build_model(cfg: LlamaConfig, state: dict[str, torch.Tensor], device: torch.device,
                dtype: torch.dtype, quantize: bool = False) -> LlamaModel:
    """A ``LlamaModel`` holding ``state`` (every key, no extras) in
    ``dtype`` on ``device``, in eval mode;
    with ``quantize`` its eligible weights int8 (``quant.load_weights``)."""
    with torch.device("meta"):
        model = LlamaModel(cfg)
    return load_weights(model, state, device, dtype, quantize)
