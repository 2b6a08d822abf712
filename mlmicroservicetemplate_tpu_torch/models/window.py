"""Fused decode windows: W chunks issued back to back, one host fetch.

Counterpart of the JAX package's ``models/window.py`` (``DECODE_WINDOW``).
The continuous loop's dispatch unit is one chunk (``generate_chunk``: a
run of ``chunk_tokens`` decode steps), and every chunk boundary costs the
host one dispatch and one fetch.  A window lifts the unit to W chunks: the
host issues them with no sync in between, fetches their tokens, the
``done`` flags after each chunk and the count of chunks that ran once, and
routes them chunk by chunk.

The reference runs a window as one ``lax.while_loop`` that re-checks
``all(done)`` at every chunk boundary on the device and stops there.  A
CUDA stream has no such branch without a host sync, so here the W chunks
always run: chunks past the boundary where every row is done step an
all-done batch, whose tokens are ``pad_id`` and whose ``done`` stays set.
The count of chunks that ran in the reference's sense (``n_chunks``) is
computed on the device from the history, and the tokens and history of
the chunks past it are masked to what the reference returns, so the three
outputs equal the reference's.  The state does not: it is left after all
W chunks (positions, last tokens, sampled rows' rng chains and K/V writes
of done rows advanced further), which no live row reads; the loop inserts
a slot's next tenant over every field.

Token identity with per-chunk dispatch is by construction: each step of
the window is the same chunk function on the same state in the same order.
"""

from __future__ import annotations

import torch


def window_chunks(done0: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """The chunks a window ran by the reference's rule, on the device
    (0-d int32): 0 when every row was done at entry (``done0``), else the
    first ``c >= 1`` whose history row ``hist[c - 1]`` is all done, else
    the window's depth."""
    all_done = hist.all(dim=1)
    first = all_done.int().argmax() + 1  # argmax: the first maximum
    first = torch.where(all_done.any(), first, torch.full_like(first, hist.shape[0]))
    return torch.where(done0, torch.zeros_like(first), first).to(torch.int32)


def decode_window(chunk_fn, state, n_steps: int, max_chunks: int, pad_id: int):
    """``max_chunks`` calls of ``chunk_fn`` (one chunk each: ``state ->
    (state, tokens [B, n_steps])``), each chunk's tokens and ``done`` flags
    copied into the window's own buffers before the next call (a CUDA
    graph's outputs are overwritten by its next replay).

    Returns ``(state, tokens [B, max_chunks * n_steps] int32, done_hist
    [max_chunks, B] bool, n_chunks)`` as the reference does:

    - ``tokens``: chunk c's tokens at columns ``[c * n_steps, (c + 1) *
      n_steps)``; chunks from ``n_chunks`` on read ``pad_id``;
    - ``done_hist[c]``: ``state.done`` after chunk c; rows from
      ``n_chunks`` on read all done;
    - ``n_chunks``: a 0-d int32 device tensor, the chunks before the first
      boundary at which every row was done (0 when every row was done at
      entry), else ``max_chunks``.

    Nothing here reads the device from the host."""
    done = state.done
    b, dev = done.shape[0], done.device
    done0 = done.all()
    buf = torch.empty((b, max_chunks * n_steps), dtype=torch.int32, device=dev)
    hist = torch.empty((max_chunks, b), dtype=torch.bool, device=dev)
    for c in range(max_chunks):
        state, toks = chunk_fn(state)
        buf[:, c * n_steps:(c + 1) * n_steps].copy_(toks)
        hist[c].copy_(state.done)
    n = window_chunks(done0, hist)
    ran = torch.arange(max_chunks, device=dev) < n
    hist = hist | ~ran[:, None]
    buf = torch.where(ran.repeat_interleave(n_steps)[None, :], buf,
                      torch.full_like(buf, pad_id))
    return state, buf, hist, n
