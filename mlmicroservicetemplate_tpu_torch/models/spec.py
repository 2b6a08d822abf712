"""Self-drafting speculative decoding (prompt lookup / n-gram).

Counterpart of the JAX package's ``models/spec.py`` (``SPEC_DECODE=ngram``).
At batch 1 a decode step streams every weight once for one token.  Here
each round drafts ``spec_k`` tokens for free (the tokens that followed the
most recent earlier occurrence of the trailing n-gram in the prompt and
the generation so far) and verifies them in one forward of ``spec_k + 1``
tokens a row (the family's ``multi_step``), so a round whose ``m`` drafts
hold emits ``m + 1`` tokens for one pass over the weights.

Greedy rows accept the longest prefix of drafts equal to the verify
forward's own argmax, so the tokens are exactly those of non-speculative
greedy decoding.  Sampled rows (``sample``) accept by rejection sampling
(``_sampled_emission``): the same distribution as sequential sampling,
other draws, from the row's own threefry chain (split once a round), bit
for bit the JAX package's.

Everything runs on the state's own tensors with static shapes and no read
to the host, and updates them in place (``SpecState`` keeps the family's
decode state as ``base``), so a CUDA graph captures a whole ``spec_chunk``.
The window writes K/V at every window position before acceptance is known;
only accepted positions become valid keys.  Writes the reference drops
(past the cache, the token buffer or the history) are dropped here too:
the K/V window writes through ``gpt.span_write``, the token and history
writes below by comparison over the whole row, never into a clamped last
column, which a later draft of the same window would overwrite.

The history may be wider than the cache by a constant prefix (T5: the
encoder ids, ``t5.init_spec_state``): cache position ``p`` lives at
history position ``p + hoff``, ``hoff`` read off the widths.  The verify
window's attention is plain PyTorch (``K + 1`` queries a row), as the
reference's is plain XLA: its decode kernel takes one query only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .sampling import SampleParams, categorical, filtered_logits, fold_in, row_split, uniform


@dataclasses.dataclass
class SpecState:
    """A family's decode state (``base``: ``key_valid``, ``write_idx``,
    ``pos``, ``last_token``, ``done``, ``tokens``, ``sample`` and its
    caches) and the drafting ``history`` [B, total] int64: the token id
    embedded at each cache position (offset by ``hoff``), -1 where no
    real token lives.  Invariant: ``history[b, hoff + write_idx[b]] ==
    last_token[b]``."""

    base: Any
    history: torch.Tensor


def init_history(state, input_ids: torch.Tensor, attention_mask: torch.Tensor, p_len: int,
                 prefix_ids: torch.Tensor | None = None) -> SpecState:
    """The drafting history of a fresh prefill of right-padded prompts
    behind ``p_len`` cached positions: the prompt's ids at ``[p_len, p_len
    + S)``, and ``prefix_ids`` [1, P] at ``[0, P)`` when the prefix is the
    request's own tokens (a prefix-cache hit); a global ``PROMPT_PREFIX``'s
    region stays -1."""
    b, s = input_ids.shape
    total = state.key_valid.shape[1]
    hist = torch.full((b, total), -1, dtype=torch.long, device=input_ids.device)
    ids = torch.where(attention_mask != 0, input_ids.long(), torch.full_like(input_ids.long(), -1))
    hist[:, p_len:p_len + s] = ids
    if prefix_ids is not None:
        hist[:, :p_len] = prefix_ids.long().reshape(1, -1).expand(b, p_len)
    return SpecState(base=state, history=hist)


def make_init_spec_fn(p_len: int = 0):
    """``init_spec(state, input_ids, attention_mask, prefix_ids=None) ->
    SpecState`` of the decoder-only families: ``prefix_ids``' length, when
    given, wins over the global prefix's ``p_len``."""
    def init_spec(state, input_ids, attention_mask, prefix_ids=None):
        pl = prefix_ids.shape[-1] if prefix_ids is not None else p_len
        return init_history(state, input_ids, attention_mask, pl, prefix_ids)

    return init_spec


def draft_ngram(history: torch.Tensor, write_idx: torch.Tensor, spec_k: int,
                ngram_n: int) -> torch.Tensor:
    """[B, spec_k] draft: the tokens after the most recent earlier
    occurrence of the trailing n-gram (ending at ``write_idx``), the
    largest n of ``ngram_n .. 1`` that matches, -1 for a row no n matches
    (never equal to an argmax, so rejected for free).  One pass: depth d's
    candidates refine depth d - 1's."""
    b, total = history.shape
    posv = torch.arange(total, device=history.device)[None]
    t = write_idx.long()[:, None]
    cand = posv < t
    j_by_n = []
    for d in range(ngram_n):
        tgt = history.gather(1, (t - d).clamp(0, total - 1))  # [B, 1]
        if d == 0:
            hd = history
        else:
            hd = torch.cat([torch.full_like(history[:, :d], -1), history[:, :-d]], dim=1)
        cand = cand & (hd == tgt) & (tgt >= 0) & (posv >= d)
        j_by_n.append(torch.where(cand, posv, torch.full_like(posv, -1)).amax(dim=1))
    j = torch.full_like(j_by_n[0], -1)
    for j_n in reversed(j_by_n):
        j = torch.where(j >= 0, j, j_n)
    gather = (j[:, None] + 1 + torch.arange(spec_k, device=history.device)[None]).clamp(
        0, total - 1)
    draft = history.gather(1, gather)
    return torch.where(j[:, None] >= 0, draft, torch.full_like(draft, -1))


def _sampled_emission(logits: torch.Tensor, draft: torch.Tensor, sp: SampleParams,
                      spec_k: int):
    """Rejection-sampling acceptance for point-mass drafts: accept draft_i
    with probability p_{i-1}(draft_i) under the row's filtered distribution
    (``sampling.filtered_logits``); at the first rejection draw from p with
    the rejected token's mass removed, or past K accepted drafts from p_K.
    A -1 draft slot is never accepted and removes nothing.  Each row's key
    splits once (``row_split``); ``fold_in(key, 0)`` feeds the K uniforms and
    ``fold_in(key, 1)`` the final categorical, as in the reference.
    Returns (candidates [B, K + 1], accepted counts [B], next rng [B, 2])."""
    b, width, v = logits.shape
    z = filtered_logits(logits.reshape(b * width, v),
                        sp.temperature.repeat_interleave(width),
                        sp.top_k.repeat_interleave(width),
                        sp.top_p.repeat_interleave(width)).reshape(b, width, v)
    probs = torch.softmax(z, dim=-1)
    clip_d = draft.clamp(0, v - 1)
    p_draft = probs[:, :spec_k, :].gather(2, clip_d[:, :, None])[..., 0]  # [B, K]
    next_rng, step_keys = row_split(sp.rng)
    u = uniform(fold_in(step_keys, 0), spec_k)
    accept = (u < p_draft) & (draft >= 0)
    m = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    probs_m = probs.gather(1, m[:, None, None].expand(b, 1, v))[:, 0]  # [B, V]
    rej_slot = m.clamp(max=spec_k - 1)[:, None]
    rej_tok = clip_d.gather(1, rej_slot)[:, 0]
    rej_valid = (m < spec_k) & (draft.gather(1, rej_slot)[:, 0] >= 0)
    cols = torch.arange(v, device=logits.device)[None]
    final_p = torch.where((cols == rej_tok[:, None]) & rej_valid[:, None],
                          torch.zeros_like(probs_m), probs_m)
    final_logits = torch.log(final_p.clamp(min=1e-38))
    e = categorical(fold_in(step_keys, 1), final_logits)
    offs = torch.arange(width, device=logits.device)[None]
    draft_pad = torch.cat([draft, draft[:, :1]], dim=1)
    cand = torch.where(offs == m[:, None], e[:, None], draft_pad)
    return cand, m, next_rng


def write_emitted(buf: torch.Tensor, vals: torch.Tensor, start: torch.Tensor,
                  n: torch.Tensor) -> None:
    """``buf[b, start[b] + j] = vals[b, j]`` for ``j < n[b]``, in place;
    positions past ``buf``'s width drop (the reference's ``mode="drop"``):
    the whole row is rewritten by comparison, so nothing lands in a
    clamped column."""
    width = vals.shape[1]
    off = torch.arange(buf.shape[1], device=buf.device)[None] - start.long()[:, None]
    sel = (off >= 0) & (off < n[:, None])
    v = vals.gather(1, off.clamp(0, width - 1)).to(buf.dtype)
    buf.copy_(torch.where(sel, v, buf))


def verify_step(spec_state: SpecState, spec_k: int, ngram_n: int, multi_fn: Callable,
                eos_id: int, pad_id: int, sample: bool = False):
    """One draft, verify, accept round, in place.  ``multi_fn(base,
    tokens [B, K + 1]) -> logits [B, K + 1, V]`` writes the window's K/V
    into the base's caches (``key_valid`` untouched).  Returns (out [B, K +
    1], n_emit [B]): ``out[:, :n_emit]`` are the emitted tokens, pad past.

    The window is ``x_0 = last_token`` (re-embedded at its own position, as
    a decode step does) and the K drafts; g_i is the argmax after x_i.  m
    accepted drafts emit m + 1 tokens, through the first EOS inclusive;
    rows already done emit nothing and keep their fields."""
    st = spec_state.base
    hist = spec_state.history
    width = spec_k + 1
    dev = st.last_token.device
    offs = torch.arange(width, device=dev)[None]
    total = st.key_valid.shape[1]
    hoff = hist.shape[1] - total
    draft = draft_ngram(hist, st.write_idx + hoff, spec_k, ngram_n)
    tokens = torch.cat([st.last_token[:, None], draft], dim=1)
    feed = torch.where(tokens >= 0, tokens, torch.full_like(tokens, pad_id))
    logits = multi_fn(st, feed)
    g = logits.argmax(dim=-1)
    m = torch.cumprod((draft == g[:, :spec_k]).long(), dim=1).sum(dim=1)
    cand = g
    if sample:
        cand_s, m_s, next_rng = _sampled_emission(logits, draft, st.sample, spec_k)
        is_samp = st.sample.temperature > 0.0
        cand = torch.where(is_samp[:, None], cand_s, g)
        m = torch.where(is_samp, m_s, m)
        st.sample.rng.copy_(next_rng)
    is_eos = (cand == eos_id) & (offs <= m[:, None])
    has_eos = is_eos.any(dim=1)
    # The first EOS (width when none): a minimum, unambiguous on ties.
    eos_idx = torch.where(is_eos, offs, torch.full_like(offs, width)).amin(dim=1)
    n_emit = torch.minimum(m + 1, eos_idx + 1)
    n_emit = torch.where(st.done, torch.zeros_like(n_emit), n_emit)
    out = torch.where(offs < n_emit[:, None], cand, torch.full_like(cand, pad_id))
    write_emitted(st.tokens, out, st.pos, n_emit)
    posv = torch.arange(total, device=dev)[None]
    w0 = st.write_idx[:, None]
    st.key_valid.masked_fill_((posv >= w0) & (posv < w0 + n_emit[:, None]), 1)
    write_emitted(hist, out, st.write_idx + hoff + 1, n_emit)
    last = cand.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
    st.last_token.copy_(torch.where(n_emit > 0, last, st.last_token))
    st.write_idx.add_(n_emit)
    st.pos.add_(n_emit)
    torch.logical_or(st.done, has_eos, out=st.done)
    return out, n_emit


def spec_chunk(spec_state: SpecState, n_verify: int, spec_k: int, ngram_n: int,
               multi_fn: Callable, eos_id: int, pad_id: int, sample: bool = False):
    """``n_verify`` verify rounds, in place.  Returns (state, out [B,
    n_verify, K + 1], n_emit [B, n_verify]): a live row emits 1 to K + 1
    tokens a round (0 once done)."""
    outs, ns = [], []
    for _ in range(n_verify):
        out, n = verify_step(spec_state, spec_k, ngram_n, multi_fn, eos_id, pad_id, sample)
        outs.append(out)
        ns.append(n)
    return spec_state, torch.stack(outs, dim=1), torch.stack(ns, dim=1)


def flatten_emitted(out_np: np.ndarray, n_np: np.ndarray, row: int = 0) -> np.ndarray:
    """Host side: one row's emitted tokens, in order, from a fetched (out
    [B, n_verify, K + 1], n_emit [B, n_verify]) pair (int32)."""
    parts = [np.asarray(out_np[row, v, : int(n_np[row, v])], np.int32)
             for v in range(out_np.shape[1])]
    return np.concatenate(parts) if parts else np.zeros((0,), np.int32)
