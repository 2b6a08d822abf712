"""T5-small encoder-decoder with a KV-cached incremental decode.

Counterpart of the JAX package's ``models/t5.py``: pre-norm blocks with
RMSNorm, a relative-position-bucket attention bias (layer 0's table,
shared by every layer of its stack), unscaled dot products (T5 folds
1/sqrt(d) into its init: every attention runs at ``scale=1.0``), ReLU
feed-forward, and a head scaled by d_model**-0.5 (the shared embedding,
or an untied ``lm_head`` when the weights carry one), logits in f32.
Defaults are T5-small.

- The encoder's self-attention runs ``ops.attention.fused_attention``
  (K1) with the position bias as a contiguous ``[1, H, S, S]`` tensor in
  the compute type: the hand-written CUDA kernel on the card, its plain
  version on the CPU.  The decoder's self- and cross-attention are plain
  PyTorch (``common.mha_attention``), as they are XLA ops in the reference.
- Bucket tables: the reference takes an f32 log of each relative position
  on the device, then truncates, so at a boundary two devices' ``log``
  may round to different buckets.  Here the tables are built on the host
  in numpy's f32 (integer-equal to the reference's), once per width and
  device: the encoder's ``[S, S]`` and the decoder's over relative
  positions -(T-1)..0, which covers every live row of a ``T``-position
  cache.  The first call at a width builds its table; a CUDA graph's
  capture runs its call eagerly first, so no capture copies from the host.
- ``T5State`` holds everything per row, preallocated at full width; each
  decode step writes its K/V row, token and per-row fields in place, so a
  CUDA graph of a chunk replays over the same state.  The cross K/V are
  projected once, at ``init_decode_state``.  The next token comes from
  ``gpt.finish_step`` (argmax, or ``sampling.select_token`` per row).  A
  freed loop row keeps stepping; its writes past the cache land in its
  own last column (``gpt.write_at``), where the reference drops them.
- Rows of a batch whose encoder mask is empty (bucket padding) are done
  from the start, as the JAX engine marks them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention, fused_attention_ref
from .common import embed, lm_head_logits, merge_heads, mha_attention, split_heads
from .gpt import finish_step, run_steps, write_at
from .llama import Linear, RMSNorm
from .sampling import SampleParams, greedy_params

RMS_EPS = 1e-6  # the reference's rmsnorm default


@dataclasses.dataclass(frozen=True)
class T5Config:
    # Defaults = T5-small; tests use small overrides.
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    num_heads: int = 8
    d_ff: int = 2048
    num_layers: int = 6
    rel_buckets: int = 32
    rel_max_distance: int = 128
    pad_id: int = 0
    eos_id: int = 1
    decoder_start_id: int = 0

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    # The fields the engine reads of every generative family's config: one
    # KV head per query head, ``d_kv`` wide, and no int8 cache.
    @property
    def num_kv_heads(self) -> int:
        return self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_kv

    @property
    def kv_quant(self) -> bool:
        return False


# ---------------------------------------------------------------------------
# modules (state-dict names follow the JAX pytree's paths)


class Attention(nn.Module):
    def __init__(self, cfg: T5Config, with_rel_bias: bool):
        super().__init__()
        d, inner = cfg.d_model, cfg.inner_dim
        self.q, self.k, self.v = Linear(d, inner), Linear(d, inner), Linear(d, inner)
        self.out = Linear(inner, d)
        self.rel_bias = nn.Embedding(cfg.rel_buckets, cfg.num_heads) if with_rel_bias else None


class Mlp(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi = Linear(cfg.d_model, cfg.d_ff)
        self.wo = Linear(cfg.d_ff, cfg.d_model)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.wo(F.relu(self.wi(h)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, first: bool):
        super().__init__()
        self.attn_ln = RMSNorm(cfg.d_model, RMS_EPS)
        self.attn = Attention(cfg, first)
        self.mlp_ln = RMSNorm(cfg.d_model, RMS_EPS)
        self.mlp = Mlp(cfg)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, first: bool):
        super().__init__()
        self.self_attn_ln = RMSNorm(cfg.d_model, RMS_EPS)
        self.self_attn = Attention(cfg, first)
        self.cross_attn_ln = RMSNorm(cfg.d_model, RMS_EPS)
        self.cross_attn = Attention(cfg, False)
        self.mlp_ln = RMSNorm(cfg.d_model, RMS_EPS)
        self.mlp = Mlp(cfg)


class Stack(nn.Module):
    def __init__(self, cfg: T5Config, layer):
        super().__init__()
        self.layers = nn.ModuleList(layer(cfg, i == 0) for i in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, RMS_EPS)


class T5Model(nn.Module):
    def __init__(self, cfg: T5Config, untied_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = Stack(cfg, EncoderLayer)
        self.decoder = Stack(cfg, DecoderLayer)
        # [V, D] like every nn.Linear of the port (the JAX kernel is [D, V]).
        self.lm_head = Linear(cfg.d_model, cfg.vocab_size) if untied_head else None
        # Device bucket tables by (kind, width, device), built at first use.
        self._buckets: dict[tuple, torch.Tensor] = {}


# ---------------------------------------------------------------------------
# relative position buckets (host tables)


def relative_bucket(rel: np.ndarray, bidirectional: bool, num_buckets: int,
                    max_distance: int) -> np.ndarray:
    """The reference's ``_relative_bucket`` in numpy, the log in f32 as
    there: int32 buckets of int32 relative positions (key - query)."""
    rel = np.asarray(rel, np.int32)
    ret = np.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        ret = ret + (rel > 0).astype(np.int32) * n
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)
    max_exact = n // 2
    rel_f = np.maximum(rel.astype(np.float32), np.float32(1.0))
    large = max_exact + (
        np.log(rel_f / np.float32(max_exact))
        / np.log(np.float32(max_distance / max_exact))
        * np.float32(n - max_exact)
    ).astype(np.int32)
    large = np.minimum(large, n - 1)
    return ret + np.where(rel < max_exact, rel, large)


def encoder_buckets(cfg: T5Config, s: int) -> np.ndarray:
    """[S, S] bidirectional buckets of key - query."""
    pos = np.arange(s, dtype=np.int32)
    return relative_bucket(pos[None, :] - pos[:, None], True, cfg.rel_buckets,
                           cfg.rel_max_distance)


def decoder_buckets(cfg: T5Config, t: int) -> np.ndarray:
    """[T] causal buckets of relative position -n, n = 0..T-1 (a query at
    t over the key at t - n)."""
    return relative_bucket(-np.arange(t, dtype=np.int32), False, cfg.rel_buckets,
                           cfg.rel_max_distance)


def bucket_table(model: T5Model, kind: str, width: int, device) -> torch.Tensor:
    """The ``kind`` ("encoder" or "decoder") bucket table at ``width`` on
    ``device`` (int64), built on the host at its first use."""
    key = (kind, width, str(device))
    table = model._buckets.get(key)
    if table is None:
        fn = encoder_buckets if kind == "encoder" else decoder_buckets
        table = torch.from_numpy(fn(model.cfg, width).astype(np.int64)).to(device)
        model._buckets[key] = table
    return table


def encoder_position_bias(model: T5Model, s: int, dtype: torch.dtype,
                          device) -> torch.Tensor:
    """[1, H, S, S] contiguous additive bias (gathered from the transposed
    [H, buckets] table, so keys have unit stride, as K1 takes it)."""
    rel = model.encoder.layers[0].attn.rel_bias.weight  # [buckets, H]
    buckets = bucket_table(model, "encoder", s, device)
    return rel.t()[:, buckets].to(dtype)[None]


def decoder_position_bias(model: T5Model, t: torch.Tensor, width: int) -> torch.Tensor:
    """[B, H, 1, T] causal bias of each row's query at its own position
    ``t`` [B] over keys 0..T-1; keys past ``t`` (masked) and rows past the
    cache (a freed loop row) clamp into the table."""
    rel = model.decoder.layers[0].self_attn.rel_bias.weight
    table = bucket_table(model, "decoder", width, t.device)
    k_pos = torch.arange(width, device=t.device)
    dist = (t[:, None] - k_pos[None, :]).clamp(0, width - 1)
    return rel[table[dist]].permute(0, 2, 1)[:, :, None, :]


# ---------------------------------------------------------------------------
# encoder


def encode(model: T5Model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
           dtype: torch.dtype = torch.float32, plain: bool = False) -> torch.Tensor:
    """Encoder hidden states [B, S, D]; self-attention through K1 with the
    position bias and ``scale=1.0`` (``plain``: K1's plain version on any
    device, the reference a card's kernel is held against)."""
    cfg = model.cfg
    attend = fused_attention_ref if plain else fused_attention
    s = input_ids.shape[1]
    x = embed(model.shared.weight, input_ids, dtype)
    bias = encoder_position_bias(model, s, dtype, input_ids.device)
    for layer in model.encoder.layers:
        a = layer.attn
        h = layer.attn_ln(x)
        q, k, v = (split_heads(p(h), cfg.num_heads) for p in (a.q, a.k, a.v))
        x = x + a.out(merge_heads(attend(q, k, v, attention_mask, bias=bias, scale=1.0)))
        x = x + layer.mlp(layer.mlp_ln(x))
    return model.encoder.final_ln(x)


# ---------------------------------------------------------------------------
# decode


@dataclasses.dataclass
class T5State:
    """Per-row decode state of the encoder-decoder, preallocated at full
    width and updated in place by each step."""

    cache_k: list[torch.Tensor]  # per decoder layer [B, T, H, D] self-attention
    cache_v: list[torch.Tensor]
    cross_k: list[torch.Tensor]  # per decoder layer [B, S_enc, H, D], projected once
    cross_v: list[torch.Tensor]
    enc_mask: torch.Tensor  # [B, S_enc] int32
    pos: torch.Tensor  # [B] int64, the next position to write
    last_token: torch.Tensor  # [B] int64
    done: torch.Tensor  # [B] bool
    tokens: torch.Tensor  # [B, T] int32, pad-filled
    # Steps taken when every row steps together (``gpt.GPTState.steps``);
    # None for the continuous loop's slot state.
    steps: int | None = 0
    sample: SampleParams | None = None


def init_decode_state(model: T5Model, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                      max_len: int, sample: SampleParams | None = None) -> T5State:
    """Zeroed self caches ``max_len`` positions wide, the cross K/V of
    every decoder layer, and the per-row fields (decoder start token;
    rows with an empty encoder mask born done)."""
    cfg = model.cfg
    b = enc_out.shape[0]
    dev, dtype = enc_out.device, enc_out.dtype
    shape = (b, max_len, cfg.num_heads, cfg.d_kv)
    cross_k, cross_v = [], []
    for layer in model.decoder.layers:
        ca = layer.cross_attn
        cross_k.append(split_heads(ca.k(enc_out), cfg.num_heads))
        cross_v.append(split_heads(ca.v(enc_out), cfg.num_heads))
    n = len(model.decoder.layers)
    return T5State(
        cache_k=[torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)],
        cache_v=[torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)],
        cross_k=cross_k, cross_v=cross_v,
        enc_mask=enc_mask.to(torch.int32),
        pos=torch.zeros(b, dtype=torch.long, device=dev),
        last_token=torch.full((b,), cfg.decoder_start_id, dtype=torch.long, device=dev),
        done=enc_mask.sum(dim=-1) == 0,
        tokens=torch.full((b, max_len), cfg.pad_id, dtype=torch.int32, device=dev),
        sample=greedy_params(b, dev) if sample is None else sample.to(dev).clone(),
    )


def empty_state(cfg: T5Config, n: int, enc_width: int, max_len: int, dtype: torch.dtype,
                device) -> T5State:
    """The continuous loop's slot state: ``n`` dead rows (done, greedy),
    self caches ``max_len`` wide and cross K/V ``enc_width`` wide, zeroed."""
    def zeros(width):
        return [torch.zeros(n, width, cfg.num_heads, cfg.d_kv, dtype=dtype, device=device)
                for _ in range(cfg.num_layers)]

    return T5State(
        cache_k=zeros(max_len), cache_v=zeros(max_len),
        cross_k=zeros(enc_width), cross_v=zeros(enc_width),
        enc_mask=torch.zeros(n, enc_width, dtype=torch.int32, device=device),
        pos=torch.zeros(n, dtype=torch.long, device=device),
        last_token=torch.zeros(n, dtype=torch.long, device=device),
        done=torch.ones(n, dtype=torch.bool, device=device),
        tokens=torch.full((n, max_len), cfg.pad_id, dtype=torch.int32, device=device),
        steps=None, sample=greedy_params(n, device),
    )


def lm_logits(model: T5Model, x: torch.Tensor) -> torch.Tensor:
    """f32 logits: x * d_model**-0.5 through the untied head, else the
    shared embedding."""
    x = x * (model.cfg.d_model ** -0.5)
    head = model.lm_head.weight if model.lm_head is not None else model.shared.weight
    return lm_head_logits(x, head)


def decode_step(model: T5Model, state: T5State, sample: bool = False):
    """One decode step of every row at its own position: causal
    self-attention over its cache (its K/V row written first), cross-
    attention over the encoder, then ``gpt.finish_step``."""
    cfg = model.cfg
    dtype = state.cross_k[0].dtype
    b, width = state.tokens.shape
    rows = torch.arange(b, device=state.pos.device)
    t = state.pos
    at = write_at(state, t, width)
    x = embed(model.shared.weight, state.last_token[:, None], dtype)  # [B, 1, D]
    k_pos = torch.arange(width, device=t.device)
    self_mask = (k_pos[None, :] <= t[:, None])[:, None, None, :]
    self_bias = decoder_position_bias(model, t, width)
    cross_mask = (state.enc_mask != 0)[:, None, None, :]
    for li, layer in enumerate(model.decoder.layers):
        sa = layer.self_attn
        h = layer.self_attn_ln(x)
        q, k1, v1 = (split_heads(p(h), cfg.num_heads) for p in (sa.q, sa.k, sa.v))
        state.cache_k[li][rows, at] = k1[:, 0]
        state.cache_v[li][rows, at] = v1[:, 0]
        ctx = mha_attention(q, state.cache_k[li], state.cache_v[li], mask=self_mask,
                            bias=self_bias, scale=1.0)
        x = x + sa.out(merge_heads(ctx))
        ca = layer.cross_attn
        qc = split_heads(ca.q(layer.cross_attn_ln(x)), cfg.num_heads)
        ctx = mha_attention(qc, state.cross_k[li], state.cross_v[li], mask=cross_mask,
                            scale=1.0)
        x = x + ca.out(merge_heads(ctx))
        x = x + layer.mlp(layer.mlp_ln(x))
    x = model.decoder.final_ln(x)
    return finish_step(state, cfg, lm_logits(model, x[:, 0]), sample)


def generate_chunk(model: T5Model, state: T5State, n_steps: int, sample: bool = False):
    """``n_steps`` decode steps; returns the state and the tokens [B, n]."""
    return run_steps(lambda s: decode_step(model, s, sample), state, n_steps)


def greedy_generate(model: T5Model, input_ids, attention_mask, max_len: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Encode plus ``max_len`` greedy steps -> tokens [B, max_len] int32."""
    enc = encode(model, input_ids, attention_mask, dtype)
    state = init_decode_state(model, enc, attention_mask, max_len)
    state, _ = generate_chunk(model, state, max_len)
    return state.tokens


def teacher_forced_logits(model: T5Model, input_ids, attention_mask, targets,
                          dtype: torch.dtype = torch.float32,
                          plain: bool = False) -> torch.Tensor:
    """f32 logits [B, L, V] of the decoder fed ``targets`` [B, L] after its
    start token (position i predicts targets[i]) in one pass: the
    non-incremental forward the served tokens are checked against
    (``plain``: the encoder through K1's plain version)."""
    cfg = model.cfg
    b, n = targets.shape
    dev = targets.device
    enc = encode(model, input_ids, attention_mask, dtype, plain)
    dec_in = torch.cat([torch.full((b, 1), cfg.decoder_start_id, dtype=torch.long, device=dev),
                        targets[:, :-1].long()], dim=1)
    x = embed(model.shared.weight, dec_in, dtype)
    pos = torch.arange(n, device=dev)
    rel = model.decoder.layers[0].self_attn.rel_bias.weight
    table = bucket_table(model, "decoder", n, dev)
    dist = (pos[:, None] - pos[None, :]).clamp(0, n - 1)
    bias = rel[table[dist]].permute(2, 0, 1)[None]  # [1, H, L, L]
    causal = (pos[None, :] <= pos[:, None])[None, None]
    cross_mask = (attention_mask != 0)[:, None, None, :]
    for layer in model.decoder.layers:
        sa, ca = layer.self_attn, layer.cross_attn
        h = layer.self_attn_ln(x)
        q, k, v = (split_heads(p(h), cfg.num_heads) for p in (sa.q, sa.k, sa.v))
        x = x + sa.out(merge_heads(mha_attention(q, k, v, mask=causal, bias=bias, scale=1.0)))
        qc = split_heads(ca.q(layer.cross_attn_ln(x)), cfg.num_heads)
        kc, vc = (split_heads(p(enc), cfg.num_heads) for p in (ca.k, ca.v))
        x = x + ca.out(merge_heads(mha_attention(qc, kc, vc, mask=cross_mask, scale=1.0)))
        x = x + layer.mlp(layer.mlp_ln(x))
    return lm_logits(model, model.decoder.final_ln(x))


# ---------------------------------------------------------------------------
# weights


def init_params(cfg: T5Config, generator: torch.Generator,
                untied_head: bool = False) -> dict[str, torch.Tensor]:
    """Random weights in ``T5Model``'s state-dict layout, drawn on the CPU
    from ``generator`` at the JAX init's scales: N(0, 1) shared embedding;
    q N(0, (d·d_kv)^-1/2), k and v N(0, d^-1/2), out N(0, inner^-1/2); wi
    N(0, d^-1/2), wo N(0, d_ff^-1/2); rel tables N(0, d^-1/2); unit RMSNorm
    scales; with ``untied_head`` an N(0, d^-1/2) head."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in T5Model(cfg, untied_head).state_dict().items()}
    d, inner = cfg.d_model, cfg.inner_dim
    std = {"q": (d * cfg.d_kv) ** -0.5, "k": d ** -0.5, "v": d ** -0.5, "out": inner ** -0.5,
           "wi": d ** -0.5, "wo": cfg.d_ff ** -0.5, "rel_bias": d ** -0.5, "shared": 1.0,
           "lm_head": d ** -0.5}

    def init(name, shape):
        mod = name.rsplit(".", 2)[-2]
        if mod.endswith("_ln"):
            return torch.ones(shape)
        return torch.empty(shape).normal_(0.0, std[mod], generator=generator)

    return {name: init(name, shape) for name, shape in shapes.items()}


def build_model(cfg: T5Config, state: dict[str, torch.Tensor], device: torch.device,
                dtype: torch.dtype) -> T5Model:
    """A ``T5Model`` holding ``state`` in ``dtype`` on ``device``, in eval
    mode; untied when ``state`` carries ``lm_head.weight``."""
    with torch.device("meta"):
        model = T5Model(cfg, untied_head="lm_head.weight" in state)
    state = {k: v.to(device=device, dtype=dtype) for k, v in state.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()
