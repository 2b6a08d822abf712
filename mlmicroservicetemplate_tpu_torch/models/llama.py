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
"""

from __future__ import annotations

import dataclasses

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
    repeat_kv,
    rmsnorm,
    split_heads,
)
from .gpt import (
    GPTState,
    PagedState,
    cache_dtype,
    contiguous_io,
    finish_step,
    paged_io,
    prefill_caches,
    row_fields,
    run_steps,
    write_at,
)
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

    def qkv(self, cfg: LlamaConfig, x, cos, sin):
        """Rotated q [B, S, H, D], rotated k and v [B, S, KVH, D]."""
        h = self.attn_ln(x)
        a = self.attn
        q = apply_rope(split_heads(a.q(h), cfg.num_heads), cos, sin)
        k = apply_rope(split_heads(a.k(h), cfg.num_kv_heads), cos, sin)
        return q, k, split_heads(a.v(h), cfg.num_kv_heads)

    def finish(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """Attention output projection and the MLP, both residual."""
        x = x + self.attn.o(merge_heads(ctx))
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


def forward_hidden(
    model: LlamaModel,
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S]
    dtype: torch.dtype = torch.float32,
    collect_kv: bool = False,
    kv_int8_roundtrip: bool = False,
):
    """Final hidden states [B, S, D] (and, with ``collect_kv``, each
    layer's rotated K and V).  ``kv_int8_roundtrip`` passes K and V
    through the int8 cache's quantize-dequantize before attention, which
    measures what storing them in int8 costs."""
    cfg = model.cfg
    s = input_ids.shape[1]
    x = embed(model.embed.weight, input_ids, dtype)
    cos, sin = rope_tables(cfg, torch.arange(s, device=input_ids.device), dtype)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    causal = torch.ones(s, s, dtype=torch.bool, device=input_ids.device).tril()
    mask = causal[None, None] & (attention_mask[:, None, None, :] != 0)
    kv = []
    for layer in model.layers:
        q, k, v = layer.qkv(cfg, x, cos, sin)
        if collect_kv:
            kv.append((k, v))
        if kv_int8_roundtrip:
            k, v = _kv_int8_roundtrip(k), _kv_int8_roundtrip(v)
        ctx = mha_attention(q, repeat_kv(k, cfg.n_rep), repeat_kv(v, cfg.n_rep), mask=mask)
        x = layer.finish(x, ctx)
    x = model.final_ln(x)
    return (x, kv) if collect_kv else x


def lm_logits(model: LlamaModel, input_ids, attention_mask, dtype=torch.float32,
              kv_int8_roundtrip: bool = False) -> torch.Tensor:
    """[B, S, V] next-token logits in f32 (the non-generative forward)."""
    x = forward_hidden(model, input_ids, attention_mask, dtype,
                       kv_int8_roundtrip=kv_int8_roundtrip)
    return lm_head_logits(x, model.lm_head.weight)


# ---------------------------------------------------------------------------
# incremental decode


def init_decode_state(
    model: LlamaModel,
    input_ids: torch.Tensor,  # [B, S] right-padded
    attention_mask: torch.Tensor,  # [B, S]
    max_len: int,
    dtype: torch.dtype = torch.float32,
    sample: SampleParams | None = None,
) -> GPTState:
    """Prefill, then the preallocated cache and the per-row state
    (``sample``: per-row sampling parameters, copied; None = greedy).

    As in the JAX package, ``write_idx`` starts at the last prompt token:
    the first decode step embeds it again and rewrites its K/V row."""
    cfg = model.cfg
    b, s = input_ids.shape
    total = s + max_len
    _, kv = forward_hidden(model, input_ids, attention_mask, dtype, collect_kv=True)
    cache_k, cache_v = prefill_caches(kv, total, cfg.kv_quant, dtype, input_ids.device)
    key_valid = torch.zeros(b, total, dtype=torch.int32, device=input_ids.device)
    key_valid[:, :s] = attention_mask.to(torch.int32)
    return GPTState(cache_k=cache_k, cache_v=cache_v, key_valid=key_valid,
                    **row_fields(input_ids, attention_mask, max_len, cfg.pad_id, sample))


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
    x = embed(model.embed.weight, state.last_token[:, None], dtype)  # [B, 1, D]
    cos, sin = rope_tables(cfg, t.clamp(max=cfg.max_position - 1), dtype)
    cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    # A device tensor, not a Python 1: a scalar would be copied from the host.
    state.key_valid[rows, at] = torch.ones_like(at, dtype=state.key_valid.dtype)
    for li, layer in enumerate(model.layers):
        q, k1, v1 = layer.qkv(cfg, x, cos, sin)
        write_kv_fn(state.cache_k[li], at, k1[:, 0])
        write_kv_fn(state.cache_v[li], at, v1[:, 0])
        ctx = attend(q, state.cache_k[li], state.cache_v[li], state.key_valid)
        x = layer.finish(x, ctx)
    x = model.final_ln(x)
    logits = lm_head_logits(x[:, 0], model.lm_head.weight)
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
                dtype: torch.dtype) -> LlamaModel:
    """A ``LlamaModel`` holding ``state`` (every key, no extras) in
    ``dtype`` on ``device``, in eval mode."""
    with torch.device("meta"):
        model = LlamaModel(cfg)
    state = {k: v.to(device=device, dtype=dtype) for k, v in state.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()
