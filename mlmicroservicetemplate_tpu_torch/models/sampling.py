"""Per-row token sampling for generative decode (temperature, top-k, top-p).

Counterpart of the JAX package's ``models/sampling.py``.  Every request
carries its own sampling knobs, so one batched decode step mixes greedy
and sampled rows; the controls are per-row tensors inside the decode
state (``SampleParams``):

- ``temperature`` [B] f32: 0 = greedy argmax (the default); > 0 scales
  the logits before sampling.
- ``top_k`` [B] int32: keep only the k highest logits (0 = off).
- ``top_p`` [B] f32: nucleus sampling, keep the smallest prefix of the
  sorted distribution whose mass reaches p (>= 1 = off).
- ``rng`` [B, 2] int64: each row's threefry2x32 key, two unsigned 32-bit
  words held in int64.  A key derives from the request's ``seed`` only,
  and each step's key is split from the row's own chain, so a seeded
  request draws the same tokens whatever rows share its batch.

The random numbers are JAX's own: ``row_split`` and ``random_bits`` are
threefry2x32 in the "foldlike" layout that ``jax.random.split`` and
``jax.random.bits`` use with ``jax_threefry_partitionable`` on (hash the
key with the counter pair (0, i)), written in int64 tensor ops masked to
32 bits; ``select_token`` turns them into uniforms and Gumbel noise as
``jax.random.categorical`` does.  So a seeded row samples the tokens the
JAX package samples from the same logits.  Everything runs on the
state's own tensors, with no ``torch.Generator`` and no read to the host,
so a sampled decode chunk captures in a CUDA graph.  The reference
computes all of this in XLA ops (no Pallas kernel), so plain torch ops
are the implementation here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NEG_INF = -1e9
_MASK32 = 0xFFFFFFFF
# threefry2x32's rotation schedule and key-schedule parity constant.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass
class SampleParams:
    """Per-row sampling state carried inside the decode states."""

    rng: torch.Tensor  # [B, 2] int64: threefry key words, each in [0, 2**32)
    temperature: torch.Tensor  # [B] f32, 0 = greedy
    top_k: torch.Tensor  # [B] int32, 0 = off
    top_p: torch.Tensor  # [B] f32, >= 1 = off

    def fields(self) -> tuple[torch.Tensor, ...]:
        return (self.rng, self.temperature, self.top_k, self.top_p)

    def to(self, device) -> "SampleParams":
        return SampleParams(*(t.to(device) for t in self.fields()))

    def clone(self) -> "SampleParams":
        return SampleParams(*(t.clone() for t in self.fields()))

    def copy_(self, other: "SampleParams") -> None:
        """Write ``other``'s rows into these tensors, in place."""
        for d, s in zip(self.fields(), other.fields()):
            d.copy_(s, non_blocking=True)


def greedy_params(batch: int, device=None) -> SampleParams:
    """All-greedy rows (what a decode state holds when the caller asks
    for no sampling)."""
    return SampleParams(
        rng=torch.zeros(batch, 2, dtype=torch.long, device=device),
        temperature=torch.zeros(batch, dtype=torch.float32, device=device),
        top_k=torch.zeros(batch, dtype=torch.int32, device=device),
        top_p=torch.ones(batch, dtype=torch.float32, device=device),
    )


def make_params(seed, temperature, top_k, top_p) -> SampleParams:
    """Per-row params from [B] request arrays, on the CPU.  Numpy on the
    request path, as in the JAX package; the key is threefry2x32's
    ``PRNGKey(seed)``: [seed >> 32, seed & 0xFFFFFFFF]."""
    seed64 = np.asarray(seed, np.uint64)
    rng = np.stack([(seed64 >> np.uint64(32)).astype(np.int64),
                    (seed64 & np.uint64(_MASK32)).astype(np.int64)], axis=-1)
    return SampleParams(
        rng=torch.from_numpy(rng),
        temperature=torch.from_numpy(np.asarray(temperature, np.float32)),
        top_k=torch.from_numpy(np.asarray(top_k, np.int32)),
        top_p=torch.from_numpy(np.asarray(top_p, np.float32)),
    )


# ---------------------------------------------------------------------------
# filtering


def _filter_top_k(logits, top_k, sorted_desc):
    """Mask logits below each row's k-th largest (top_k == 0 keeps all)."""
    v = sorted_desc.shape[-1]
    k_idx = (top_k.long() - 1).clamp(0, v - 1)
    kth = sorted_desc.gather(1, k_idx[:, None])
    keep = (logits >= kth) | (top_k <= 0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, _NEG_INF))


def _filter_top_p(logits, top_p, sorted_desc):
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches top_p (the first token always
    stays); top_p >= 1 keeps all."""
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # A sorted position stays while the mass before it is < p.
    keep_sorted = (cum - probs) < top_p[:, None]
    cutoff = torch.where(keep_sorted, sorted_desc,
                         torch.full_like(sorted_desc, float("inf"))).amin(dim=-1)
    keep = (logits >= cutoff[:, None]) | (top_p >= 1.0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, _NEG_INF))


def filtered_logits(logits, temperature, top_k, top_p) -> torch.Tensor:
    """Temperature, then top-k, then top-p (the HF order), as f32 logits
    with the filtered entries at -1e9: their softmax is the distribution
    a sampled row draws from.  One descending sort; the sorted view of
    the top-k-filtered logits is that sort with its tail masked."""
    z = logits.float() / temperature.clamp(min=1e-6)[:, None]
    v = z.shape[-1]
    sorted_desc = torch.sort(z, dim=-1, descending=True).values
    z = _filter_top_k(z, top_k, sorted_desc)
    eff_k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v)).long()[:, None]
    cols = torch.arange(v, device=z.device)[None, :]
    sorted_desc2 = torch.where(cols < eff_k, sorted_desc, torch.full_like(sorted_desc, _NEG_INF))
    return _filter_top_p(z, top_p, sorted_desc2)


# ---------------------------------------------------------------------------
# threefry2x32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block of key (k0, k1) over counters
    (x0, x1): int64 tensors holding 32-bit words, broadcast together."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def row_split(rng: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's key [B, 2] split in two, as ``jax.random.split``: the
    next chain (counter (0, 0)) and this step's key (counter (0, 1))."""
    k0, k1 = rng[:, 0:1], rng[:, 1:2]
    lo = torch.arange(2, device=rng.device, dtype=torch.long)[None, :]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)  # [B, 2] each
    return torch.stack([b0[:, 0], b1[:, 0]], dim=-1), torch.stack([b0[:, 1], b1[:, 1]], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each row's key [B, 2]:
    [B, n] int64 of 32-bit words."""
    lo = torch.arange(n, device=keys.device, dtype=torch.long)[None, :]
    b0, b1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo), lo)
    return b0 ^ b1


def uniforms(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [tiny, 1) from 32-bit words, as JAX's ``_uniform``
    with ``minval=tiny``: 23 random mantissa bits under the exponent of
    1.0, minus 1, scaled, clamped at tiny."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # Scalars, not tensors made here: a tensor from the host is a copy a
    # CUDA graph cannot capture.
    return (f * (1.0 - _F32_TINY) + _F32_TINY).clamp(min=_F32_TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Gumbel noise [B, n] f32 from each row's key, as ``jax.random.gumbel``."""
    return -torch.log(-torch.log(uniforms(random_bits(keys, n))))


def select_token(logits: torch.Tensor, sp: SampleParams) -> tuple[torch.Tensor, SampleParams]:
    """The next token of each row: argmax where temperature <= 0, a draw
    from the filtered distribution elsewhere (Gumbel-max over the row's
    step key).  Returns (tokens [B] int64, the params with every row's
    chain advanced)."""
    greedy_tok = logits.argmax(dim=-1)
    z = filtered_logits(logits, sp.temperature, sp.top_k, sp.top_p)
    next_rng, step_keys = row_split(sp.rng)
    sampled = (z + gumbel(step_keys, z.shape[-1])).argmax(dim=-1)
    tok = torch.where(sp.temperature > 0.0, sampled, greedy_tok)
    return tok, dataclasses.replace(sp, rng=next_rng)
