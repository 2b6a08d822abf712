"""BERT encoder + sequence-classification head.

Counterpart of the JAX package's ``models/bert.py``: post-LN transformer
encoder, learned positions, token-type embeddings, erf-GELU, LN eps
1e-12.  With ``use_kernel`` the attention core is ``ops.attention.
fused_attention`` (the hand-written CUDA kernel on the card); without it,
``common.mha_attention``.  ``classify_seq_parallel`` runs the forward over
sequence shards with ring attention across them (bert-long).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..ops.attention import fused_attention
from ..parallel.ring import Hop, ring_attention, ring_hop
from .common import dense, embed, gelu, layernorm, merge_heads, mha_attention, split_heads
from .quant import load_weights


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    ln_eps: float = 1e-12


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.q, self.k, self.v, self.out = (Linear(d, d) for _ in range(4))
        self.ln = LayerNorm(d, cfg.ln_eps)


class Mlp(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.up = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.down = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.ln_eps)


class Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attn = Attention(cfg)
        self.mlp = Mlp(cfg)

    def qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The attention's q, k, v projections, each [B, S, H, D]."""
        a = self.attn
        return tuple(split_heads(proj(x), self.num_heads) for proj in (a.q, a.k, a.v))

    def finish(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """Out-projection of the attention context [B, S, H, D], residual +
        LN, then the MLP block."""
        a = self.attn
        x = a.ln(x + a.out(merge_heads(ctx)))
        m = self.mlp
        return m.ln(x + m.down(gelu(m.up(x))))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                key_mask: torch.Tensor | None) -> torch.Tensor:
        q, k, v = self.qkv(x)
        if key_mask is not None:
            ctx = fused_attention(q, k, v, key_mask)
        else:
            ctx = mha_attention(q, k, v, mask=mask)
        return self.finish(x, ctx)


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, d)
        self.position = nn.Embedding(cfg.max_position, d)
        self.token_type = nn.Embedding(cfg.type_vocab_size, d)
        self.ln = LayerNorm(d, cfg.ln_eps)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_layers))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size)
        self.classifier = Linear(cfg.hidden_size, cfg.num_labels)

    def embed(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor | None = None,
              dtype: torch.dtype = torch.float32, offset: int = 0) -> torch.Tensor:
        """Embeddings + LN [B, S, D] of tokens at positions offset ..
        offset + S - 1."""
        s = input_ids.shape[1]
        e = self.embeddings
        x = embed(e.word, input_ids, dtype)
        pos = torch.arange(offset, offset + s, device=input_ids.device)
        x = x + embed(e.position, pos, dtype)[None]
        tt = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
        x = x + embed(e.token_type, tt, dtype)
        return e.ln(x)

    def head(self, cls: torch.Tensor) -> torch.Tensor:
        """Pooler + classifier on the first token's hidden state [B, D]:
        logits [B, num_labels] in f32."""
        pooled = torch.tanh(self.pooler(cls).float())
        return self.classifier(pooled)

    def encode(
        self,
        input_ids: torch.Tensor,  # [B, S] int
        attention_mask: torch.Tensor,  # [B, S] 1 = keep
        token_type_ids: torch.Tensor | None = None,
        dtype: torch.dtype = torch.float32,
        use_kernel: bool = False,
    ) -> torch.Tensor:
        """Final hidden states [B, S, D]."""
        x = self.embed(input_ids, token_type_ids, dtype)
        mask = attention_mask[:, None, None, :].bool()  # [B, 1, 1, S]
        key_mask = attention_mask if use_kernel else None
        for layer in self.layers:
            x = layer(x, mask, key_mask)
        return x

    def classify(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: torch.Tensor | None = None,
        dtype: torch.dtype = torch.float32,
        use_kernel: bool = False,
    ) -> torch.Tensor:
        """Sequence-classification logits [B, num_labels] in f32."""
        hidden = self.encode(input_ids, attention_mask, token_type_ids, dtype, use_kernel)
        return self.head(hidden[:, 0])

    forward = classify


def classify_seq_parallel(
    replicas: Sequence[BertModel],
    input_ids: Sequence[torch.Tensor],  # n shards of [B, S_loc], in sequence order
    attention_mask: Sequence[torch.Tensor],  # n shards of [B, S_loc]
    dtype: torch.dtype = torch.float32,
    hop: Hop = ring_hop,
) -> torch.Tensor:
    """Sequence-classification logits [B, num_labels] in f32 with the
    sequence cut into shards, shard i on the device of ``replicas[i]``
    (the model's copy there).

    The forward the JAX package's XLA partitioner derives from a sequence
    sharding, written out: embeddings per shard (shard i's positions start
    at i * S_loc); per layer, the q/k/v projections per shard,
    ``parallel.ring_attention`` across the shards, then the
    out-projection, LN and MLP per shard; pooler and classifier on shard
    0's first token.  ``hop`` is the ring's hop: ``ring_hop`` (the kernel on
    the card) or ``parallel.ring_hop_ref``."""
    n = len(replicas)
    if not n == len(input_ids) == len(attention_mask):
        raise ValueError(
            f"classify_seq_parallel: {n} replicas for {len(input_ids)} id and "
            f"{len(attention_mask)} mask shards"
        )
    s_loc = input_ids[0].shape[1]
    xs = [r.embed(ids, dtype=dtype, offset=i * s_loc)
          for i, (r, ids) in enumerate(zip(replicas, input_ids))]
    for li in range(len(replicas[0].layers)):
        layers = [r.layers[li] for r in replicas]
        q, k, v = zip(*(layer.qkv(x) for layer, x in zip(layers, xs)))
        ctx = ring_attention(q, k, v, attention_mask, hop=hop)
        xs = [layer.finish(x, c) for layer, x, c in zip(layers, xs, ctx)]
    return replicas[0].head(xs[0][:, 0])


def init_params(cfg: BertConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights in ``BertModel``'s state-dict layout, drawn on the
    CPU from ``generator`` (so every device gets the same numbers): N(0,
    0.02) embeddings and dense weights, zero biases, unit LN scales."""
    with torch.device("meta"):
        shapes = {k: (v.shape, k.endswith("bias")) for k, v in BertModel(cfg).state_dict().items()}
    out = {}
    for name, (shape, is_bias) in shapes.items():
        if ".ln." in name:
            out[name] = torch.zeros(shape) if is_bias else torch.ones(shape)
        elif is_bias:
            out[name] = torch.zeros(shape)
        else:
            out[name] = torch.empty(shape).normal_(0.0, 0.02, generator=generator)
    return out


def build_model(cfg: BertConfig, state: dict[str, torch.Tensor], device: torch.device,
                dtype: torch.dtype, quantize: bool = False) -> BertModel:
    """A ``BertModel`` holding ``state`` (strictly: every key, no extras)
    in ``dtype`` on ``device``, in eval mode;
    with ``quantize`` its eligible weights int8 (``quant.load_weights``)."""
    with torch.device("meta"):
        model = BertModel(cfg)
    return load_weights(model, state, device, dtype, quantize)
