"""Decoder-only causal LM (GPT-2), and the decode machinery the decoder
families share.

Counterpart of the JAX package's ``models/gpt.py``:

- ``GPTState`` and ``PagedState`` (llama decodes with both), the paged
  token write, the cache writes and cache attention of one decode step
  (``write_kv``, ``cache_attention``, ``paged_write_kv``,
  ``paged_cache_attention``) and the end of every step, which picks the
  next tokens greedily or by per-row sampling (``finish_step``).
- GPT-2 itself: learned positions, pre-LN blocks, tanh GELU, a fused QKV
  projection, multi-head attention (``num_kv_heads = num_heads``), final
  LN and a head tied to the token embedding, logits in f32.  Defaults are
  GPT-2 small.  Prefill is plain PyTorch (``common.mha_attention`` under a
  causal and padding mask), as the JAX package's is plain XLA.  Each decode
  step's single query attends to the cache through
  ``ops.attention.decode_attention`` (contiguous) or
  ``ops.paged_attention.paged_decode_attention`` (paged): the hand-written
  CUDA kernels on the card, at one query head per KV head, and their plain
  versions on the CPU.

As in the port's llama, the caches are preallocated at their full width
and every decode step writes its K/V row, the key-validity bit, its token,
the per-row fields and the rows' sampling chains in place, so a CUDA graph
of a chunk replays over the same state.  Positions past the position table
clamp to its last row (a freed loop row keeps stepping until its slot is
reused), and such a row's writes past a width land in its own last column,
where the reference drops them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import decode_attention
from ..ops.paged_attention import paged_decode_attention
from .bert import LayerNorm, Linear
from .common import embed, kv_quantize, lm_head_logits, merge_heads, mha_attention, split_heads
from .sampling import SampleParams, greedy_params, select_token


@dataclasses.dataclass
class GPTState:
    """Per-row decode state of a contiguous KV cache.

    ``cache_k`` / ``cache_v`` hold one entry per layer: a dense
    ``[B, T, KVH, D]`` tensor, or an ``(int8 payload, scale [B, T, KVH, 1])``
    pair under the int8 cache.  The caches are preallocated at their full
    width and written in place by each decode step."""

    cache_k: list[Any]
    cache_v: list[Any]
    key_valid: torch.Tensor  # [B, T] int32, 1 = a written key
    write_idx: torch.Tensor  # [B] int64, where the next K/V row goes
    pos: torch.Tensor  # [B] int64, tokens emitted so far
    last_token: torch.Tensor  # [B] int64, the token the next step embeds
    done: torch.Tensor  # [B] bool
    tokens: torch.Tensor  # [B, max_len] int32, pad-filled
    # Decode steps taken when every row steps together: ``pos`` on the host,
    # so the step loop checks its bound without a device read.  None for
    # the continuous loop's slot state, whose rows sit at different steps
    # (the loop keeps its own per-slot counts).
    steps: int | None = 0
    # Per-row sampling parameters (``sampling.SampleParams``); a sampled
    # step advances every row's rng chain in place.
    sample: SampleParams | None = None


@dataclasses.dataclass
class PagedState:
    """Decode state over a block-paged KV pool (``PAGED_KV=1``).

    As ``GPTState`` except the caches: per layer a pool of
    ``block_size``-token blocks ``[NB + 1, BS, KVH, D]`` shared by every
    row (an ``(int8, scale)`` pair under the int8 cache), where logical
    position ``p`` of row ``b`` lives at ``pool[table[b, p // BS], p % BS]``
    through a host-owned block table passed to each step.  Block ``NB`` is
    scratch: the sentinel id ``NB`` of a freed or never-granted table entry
    points there, so a dead row's writes land where no live row reads,
    in place of the reference's dropped out-of-range scatter.  The other
    fields keep their per-row ``GPTState`` meaning over logical positions
    (``key_valid`` is ``[B, T * BS]``), which is what keeps paged decode
    token-identical to the contiguous layout."""

    cache_k: list[Any]
    cache_v: list[Any]
    key_valid: torch.Tensor  # [B, T * BS] int32 over logical positions
    write_idx: torch.Tensor  # [B] int64
    pos: torch.Tensor  # [B] int64
    last_token: torch.Tensor  # [B] int64
    done: torch.Tensor  # [B] bool
    tokens: torch.Tensor  # [B, max_len] int32
    sample: SampleParams | None = None

    @property
    def num_blocks(self) -> int:
        """Blocks a table may name (the pool less its scratch block)."""
        entry = self.cache_k[0]
        return (entry[0] if isinstance(entry, tuple) else entry).shape[0] - 1


def state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a decode state (any family's dataclass), in field
    order: caches (int8 pairs flattened), per-row fields, the rows'
    ``SampleParams``."""
    out: list[torch.Tensor] = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.extend(state_tensors(v))
            continue
        for t in v if isinstance(v, list) else [v]:
            out.extend(t if isinstance(t, tuple) else [t] if isinstance(t, torch.Tensor) else [])
    return out


def clone_state(state):
    """A copy of a decode state with tensors of its own (the host-side
    ``steps`` carried over)."""
    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, (list, tuple)):
            return type(v)(clone(x) for x in v)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: clone(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v

    return clone(state)


def copy_state(dst, src) -> None:
    """Write every tensor of ``src`` into the same-shaped ``dst``, in place."""
    for d, s in zip(state_tensors(dst), state_tensors(src)):
        d.copy_(s)


def paged_dest(table: torch.Tensor, t: torch.Tensor, bs: int, nb: int) -> torch.Tensor:
    """Flat pool index of logical position ``t`` of each row.  Positions
    past the table and sentinel entries both resolve into the scratch block
    ``nb``, whose contents no valid key reads."""
    bidx = t // bs
    width = table.shape[1]
    blk = table.gather(1, bidx.clamp(max=width - 1)[:, None])[:, 0].long()
    blk = torch.where((bidx < width) & (blk >= 0) & (blk < nb), blk, torch.full_like(blk, nb))
    return blk * bs + t % bs


def paged_write_token(pool: torch.Tensor, dest: torch.Tensor, val: torch.Tensor) -> None:
    """Write one new K (or V) row per batch row at flat pool indices
    ``dest`` (``paged_dest``), in place."""
    flat = pool.view((-1,) + tuple(pool.shape[2:]))
    flat[dest] = val.to(pool.dtype)


# ---------------------------------------------------------------------------
# the decode step's pieces, shared by the decoder families


def cache_dtype(state) -> torch.dtype:
    """The compute type a state's caches hold (the scales' under int8)."""
    entry = state.cache_k[0]
    return entry[1].dtype if isinstance(entry, tuple) else entry.dtype


def write_at(state, idx: torch.Tensor, width: int) -> torch.Tensor:
    """Where each row's write at ``idx`` lands in a per-row field ``width``
    wide.  Rows that step together (``steps`` set) never pass a width.
    The continuous loop's slot state (``steps`` None) clamps: a freed row
    steps on until its slot is reused, and its writes past a width land in
    its own last column, which no other row reads and the slot's next
    insert overwrites (the reference drops them)."""
    if getattr(state, "steps", None) is not None:
        return idx
    return idx.clamp(max=width - 1)


def prefill_caches(kv, total: int, kv_quant: bool, dtype, device):
    """Each layer's prompt K and V ``[B, S, KVH, D]`` written into caches
    preallocated ``total`` positions wide (dense, or int8 payload plus
    scale); returns (cache_k, cache_v)."""
    cache_k, cache_v = [], []
    for k, v in kv:
        b, s, kvh, d = k.shape
        shape = (b, total, kvh, d)
        for new, caches in ((k, cache_k), (v, cache_v)):
            if kv_quant:
                q8, sc = kv_quantize(new)
                c8 = torch.zeros(shape, dtype=torch.int8, device=device)
                cs = torch.ones(shape[:3] + (1,), dtype=dtype, device=device)
                c8[:, :s] = q8
                cs[:, :s] = sc.to(dtype)
                caches.append((c8, cs))
            else:
                c = torch.zeros(shape, dtype=new.dtype, device=device)
                c[:, :s] = new
                caches.append(c)
    return cache_k, cache_v


def write_kv(cache, rows, t, new: torch.Tensor, dtype) -> None:
    """Write one K (or V) row per batch row at ``t`` into a dense or an
    (int8, scale) cache entry, in place."""
    if isinstance(cache, tuple):
        q8, sc = kv_quantize(new)
        cache[0][rows, t] = q8
        cache[1][rows, t] = sc.to(dtype)
    else:
        cache[rows, t] = new


def cache_attention(q, ck, cv, key_valid) -> torch.Tensor:
    """The step's single query [B, 1, H, D] over a dense or int8 cache,
    through the decode-attention kernel; returns [B, 1, H, D]."""
    if isinstance(ck, tuple):
        ctx = decode_attention(q[:, 0], ck[0], cv[0], key_valid, k_scale=ck[1], v_scale=cv[1])
    else:
        ctx = decode_attention(q[:, 0], ck, cv, key_valid)
    return ctx[:, None]


def paged_write_kv(cache, dest: torch.Tensor, val: torch.Tensor, dtype) -> None:
    """Write one new K (or V) row per batch row at flat pool indices
    ``dest`` into a dense pool or an (int8 payload, scale) pool pair, with
    the contiguous cache's quantization."""
    if isinstance(cache, tuple):
        q8, sc = kv_quantize(val)
        paged_write_token(cache[0], dest, q8)
        paged_write_token(cache[1], dest, sc.to(dtype))
    else:
        paged_write_token(cache, dest, val)


def paged_cache_attention(q, ck, cv, table, key_valid, bs: int) -> torch.Tensor:
    """The step's single query [B, 1, H, D] over the paged pool through
    the paged decode-attention kernel; returns [B, 1, H, D]."""
    if isinstance(ck, tuple):
        ctx = paged_decode_attention(q[:, 0], ck[0], cv[0], table, key_valid, bs,
                                     k_scale=ck[1], v_scale=cv[1])
    else:
        ctx = paged_decode_attention(q[:, 0], ck, cv, table, key_valid, bs)
    return ctx[:, None]


def contiguous_io(state):
    """(write_kv(cache, at, new), attend(q, ck, cv, key_valid)) of one step
    over the contiguous cache."""
    dtype = cache_dtype(state)
    rows = torch.arange(state.last_token.shape[0], device=state.last_token.device)
    return (lambda cache, at, new: write_kv(cache, rows, at, new, dtype)), cache_attention


def paged_io(state, table: torch.Tensor, block_size: int):
    """As ``contiguous_io``, through the block table ``table`` [B, T]."""
    dtype = cache_dtype(state)
    dest = paged_dest(table, state.write_idx, block_size, state.num_blocks)
    return ((lambda cache, _at, new: paged_write_kv(cache, dest, new, dtype)),
            (lambda q, ck, cv, key_valid: paged_cache_attention(q, ck, cv, table, key_valid,
                                                                block_size)))


def finish_step(state, cfg, logits: torch.Tensor, sample: bool):
    """The end of one decode step of every row: the next token from the
    f32 logits [B, V] (argmax; with ``sample``, ``sampling.select_token``
    over each row's own parameters, whose rng chains advance in place),
    ``pad_id`` for rows already done; then the token, positions, last
    token and done flags written into the state's own tensors (and
    ``steps`` on the host).  Shared by every generative family; a family
    with its own K/V write index advances it itself.  Returns the state
    and the tokens."""
    if sample:
        if state.sample is None:
            raise ValueError("a sampled step needs the state's SampleParams")
        next_tok, sp = select_token(logits, state.sample)
        state.sample.rng.copy_(sp.rng)
    else:
        next_tok = logits.argmax(dim=-1)
    next_tok = torch.where(state.done, torch.full_like(next_tok, cfg.pad_id), next_tok)
    rows = torch.arange(next_tok.shape[0], device=next_tok.device)
    state.tokens[rows, write_at(state, state.pos, state.tokens.shape[1])] = \
        next_tok.to(torch.int32)
    state.pos.add_(1)
    state.last_token.copy_(next_tok)
    torch.logical_or(state.done, next_tok == cfg.eos_id, out=state.done)
    if getattr(state, "steps", None) is not None:
        state.steps += 1
    return state, next_tok


def row_fields(input_ids, attention_mask, max_len: int, pad_id: int, sample):
    """The per-row fields after a prefill of right-padded prompts: the
    first step re-embeds each row's last prompt token at its own position
    (rewriting its K/V row), fully padded rows are born done; ``sample``
    (copied) or all-greedy params."""
    b = input_ids.shape[0]
    dev = input_ids.device
    lengths = attention_mask.sum(dim=-1)
    write_idx = (lengths - 1).clamp(min=0).long()
    rows = torch.arange(b, device=dev)
    return dict(
        write_idx=write_idx,
        pos=torch.zeros(b, dtype=torch.long, device=dev),
        last_token=input_ids[rows, write_idx].long(),
        done=lengths == 0,
        tokens=torch.full((b, max_len), pad_id, dtype=torch.int32, device=dev),
        sample=greedy_params(b, dev) if sample is None else sample.to(dev).clone(),
    )


# ---------------------------------------------------------------------------
# GPT-2


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU (HF "gelu_new"), not BERT's erf form."""
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    # Defaults = GPT-2 small; tests use small overrides.
    vocab_size: int = 50257
    d_model: int = 768
    num_heads: int = 12
    num_layers: int = 12
    d_ff: int = 3072
    max_position: int = 1024
    ln_eps: float = 1e-5
    eos_id: int = 50256
    pad_id: int = 50256  # GPT-2 has no pad token; eos doubles as pad
    # The shape fields the decode loop reads of every decoder family: GPT-2
    # is multi-head (one query head per KV head) and serves a dense cache
    # (the JAX package's int8 KV cache covers the llama family only).
    kv_quant: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        d = cfg.d_model
        self.qkv = Linear(d, 3 * d)
        self.out = Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.up = Linear(cfg.d_model, cfg.d_ff)
        self.down = Linear(cfg.d_ff, cfg.d_model)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.ln_eps)
        self.mlp = Mlp(cfg)
        self.num_heads = cfg.num_heads

    def qkv(self, x: torch.Tensor):
        """q, k, v [B, S, H, D] of the pre-LN input."""
        q, k, v = self.attn.qkv(self.ln1(x)).chunk(3, dim=-1)
        return tuple(split_heads(t, self.num_heads) for t in (q, k, v))

    def finish(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """Attention output projection and the MLP, both residual."""
        x = x + self.attn.out(merge_heads(ctx))
        m = self.mlp
        return x + m.down(gelu_new(m.up(self.ln2(x))))


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.wpe = nn.Embedding(cfg.max_position, cfg.d_model)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.d_model, cfg.ln_eps)


def forward_hidden(model: GPTModel, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   dtype: torch.dtype = torch.float32, collect_kv: bool = False):
    """Final hidden states [B, S, D] (and, with ``collect_kv``, each
    layer's K and V [B, S, H, D])."""
    s = input_ids.shape[1]
    dev = input_ids.device
    x = embed(model.wte.weight, input_ids, dtype)
    x = x + embed(model.wpe.weight, torch.arange(s, device=dev), dtype)[None]
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    mask = causal[None, None] & (attention_mask[:, None, None, :] != 0)
    kv = []
    for layer in model.layers:
        q, k, v = layer.qkv(x)
        if collect_kv:
            kv.append((k, v))
        x = layer.finish(x, mha_attention(q, k, v, mask=mask))
    x = model.final_ln(x)
    return (x, kv) if collect_kv else x


def logits_of(model: GPTModel, x: torch.Tensor) -> torch.Tensor:
    """The tied head: f32 logits of hidden states."""
    return lm_head_logits(x, model.wte.weight)


def lm_logits(model: GPTModel, input_ids, attention_mask,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S, V] next-token logits in f32 (the non-generative forward)."""
    return logits_of(model, forward_hidden(model, input_ids, attention_mask, dtype))


def init_decode_state(model: GPTModel, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      max_len: int, dtype: torch.dtype = torch.float32,
                      sample: SampleParams | None = None) -> GPTState:
    """Prefill, then the preallocated cache and the per-row state; the
    first decode step embeds each row's last prompt token again."""
    cfg = model.cfg
    b, s = input_ids.shape
    total = s + max_len
    _, kv = forward_hidden(model, input_ids, attention_mask, dtype, collect_kv=True)
    cache_k, cache_v = prefill_caches(kv, total, cfg.kv_quant, dtype, input_ids.device)
    key_valid = torch.zeros(b, total, dtype=torch.int32, device=input_ids.device)
    key_valid[:, :s] = attention_mask.to(torch.int32)
    return GPTState(cache_k=cache_k, cache_v=cache_v, key_valid=key_valid,
                    **row_fields(input_ids, attention_mask, max_len, cfg.pad_id, sample))


def _step(model: GPTModel, state, write_kv_fn, attend, sample: bool):
    """One decode step for every row over the cache layout that
    ``write_kv_fn(cache, at, new)`` and ``attend(q, ck, cv, key_valid)``
    address: each row embeds its last token at its own position (clamped
    to the position table), writes its K/V row and attends to its cache."""
    cfg = model.cfg
    dtype = cache_dtype(state)
    b = state.last_token.shape[0]
    rows = torch.arange(b, device=state.last_token.device)
    t = state.write_idx
    at = write_at(state, t, state.key_valid.shape[1])
    x = embed(model.wte.weight, state.last_token[:, None], dtype)  # [B, 1, D]
    x = x + embed(model.wpe.weight, t.clamp(max=cfg.max_position - 1), dtype)[:, None]
    # A device tensor, not a Python 1: a scalar would be copied from the host.
    state.key_valid[rows, at] = torch.ones_like(at, dtype=state.key_valid.dtype)
    for li, layer in enumerate(model.layers):
        q, k1, v1 = layer.qkv(x)
        write_kv_fn(state.cache_k[li], at, k1[:, 0])
        write_kv_fn(state.cache_v[li], at, v1[:, 0])
        x = layer.finish(x, attend(q, state.cache_k[li], state.cache_v[li], state.key_valid))
    x = model.final_ln(x)
    state.write_idx.add_(1)
    return finish_step(state, cfg, logits_of(model, x[:, 0]), sample)


def decode_step(model: GPTModel, state: GPTState, sample: bool = False):
    """One step over the contiguous cache."""
    return _step(model, state, *contiguous_io(state), sample)


def paged_decode_step(model: GPTModel, state: PagedState, table: torch.Tensor,
                      block_size: int, sample: bool = False):
    """One step with K/V written and read through the block table."""
    return _step(model, state, *paged_io(state, table, block_size), sample)


def run_steps(step, state, n_steps: int):
    """``n_steps`` calls of ``step(state) -> (state, tokens)``; returns the
    state and the chunk's tokens [B, n_steps].  A state whose rows step
    together (``steps`` not None) refuses to step past its token width."""
    steps = getattr(state, "steps", None)
    if steps is not None and steps + n_steps > state.tokens.shape[1]:
        raise ValueError(
            f"{n_steps} more steps after {steps} overrun the cache's "
            f"{state.tokens.shape[1]} decode positions"
        )
    toks = []
    for _ in range(n_steps):
        state, tok = step(state)
        toks.append(tok)
    return state, torch.stack(toks, dim=1)


def generate_chunk(model: GPTModel, state: GPTState, n_steps: int, sample: bool = False):
    """``n_steps`` decode steps; ``sample`` picks the per-row sampling
    path, else argmax (the JAX static argument)."""
    return run_steps(lambda s: decode_step(model, s, sample), state, n_steps)


def generate_chunk_paged(model: GPTModel, state: PagedState, table: torch.Tensor,
                         block_size: int, n_steps: int, sample: bool = False):
    """``n_steps`` paged decode steps; returns the state and the tokens."""
    return run_steps(lambda s: paged_decode_step(model, s, table, block_size, sample),
                     state, n_steps)


def greedy_generate(model: GPTModel, input_ids, attention_mask, max_len: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Prefill plus ``max_len`` greedy steps -> tokens [B, max_len] int32."""
    state = init_decode_state(model, input_ids, attention_mask, max_len, dtype)
    state, _ = generate_chunk(model, state, max_len)
    return state.tokens


# ---------------------------------------------------------------------------
# weights


def init_params(cfg: GPTConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights in ``GPTModel``'s state-dict layout, drawn on the CPU
    from ``generator`` with the JAX init's scales: N(0, 0.02) token
    embedding and projections, N(0, 0.01) positions, zero biases, unit
    LayerNorm scales."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in GPTModel(cfg).state_dict().items()}

    def init(name, shape):
        if name.endswith("ln1.weight") or name.endswith("ln2.weight") or name == \
                "final_ln.weight":
            return torch.ones(shape)
        if name.endswith(".bias"):
            return torch.zeros(shape)
        std = 0.01 if name == "wpe.weight" else 0.02
        return torch.empty(shape).normal_(0.0, std, generator=generator)

    return {name: init(name, shape) for name, shape in shapes.items()}


def build_model(cfg: GPTConfig, state: dict[str, torch.Tensor], device: torch.device,
                dtype: torch.dtype) -> GPTModel:
    """A ``GPTModel`` holding ``state`` (every key, no extras) in ``dtype``
    on ``device``, in eval mode."""
    with torch.device("meta"):
        model = GPTModel(cfg)
    state = {k: v.to(device=device, dtype=dtype) for k, v in state.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()
