"""The port's chunked-prefill windows against the JAX package's, f32 on
the CPU, at the JAX tests' tiny gpt and llama widths on the same weights:
``prefill_chunk`` and ``paged_prefill_chunk`` window by window (gpt,
llama, llama int8; chunks that divide the prompt and chunks that do not):
caches and the first decode step's logits within 1e-4, and the tokens of
the port's own monolithic ``init_decode_state``.  A window past the
state's width drops its tail.

The loop under ``PREFILL_CHUNK`` is held against the JAX loop in
``test_torch_prefill_loop.py``; admission, pacing, gates and the HTTP
surface in ``test_torch_prefill_pacer.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu.models.sampling import greedy_params as jax_greedy_params
from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
    gpt_params_from_jax,
    llama_params_from_jax,
)
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama

TINY = dict(vocab_size=300, d_model=32, num_layers=2, d_ff=64, max_position=256, eos_id=1,
            pad_id=0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(5, 250, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the model's windows


def _family(name: str):
    """(JAX module, JAX cfg, JAX params, port module, port model) at the
    tiny widths, on the same weights."""
    if name == "gpt":
        jcfg = jax_gpt.GPTConfig(**TINY, num_heads=2)
        params = jax.tree.map(np.asarray, jax_gpt.init_params(jax.random.PRNGKey(0), jcfg))
        cfg = port_gpt.GPTConfig(**TINY, num_heads=2)
        model = port_gpt.build_model(cfg, gpt_params_from_jax(params, cfg),
                                     torch.device("cpu"), torch.float32)
        return jax_gpt, jcfg, params, port_gpt, model
    quant = name == "llama-int8"
    jcfg = jax_llama.LlamaConfig(**TINY, num_heads=4, num_kv_heads=2, kv_quant=quant)
    params = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = port_llama.LlamaConfig(**TINY, num_heads=4, num_kv_heads=2, kv_quant=quant)
    model = port_llama.build_model(cfg, llama_params_from_jax(params, cfg),
                                   torch.device("cpu"), torch.float32)
    return jax_llama, jcfg, params, port_llama, model


def _windows(n: int, c: int, start: int = 0):
    """(start, ids [1, C], mask [1, C]) of each window of an n-token
    prompt from ``start``."""
    ids = _ids(n, 0)
    out = []
    pos = start
    while pos < n:
        end = min(pos + c, n)
        w, m = np.zeros((1, c), np.int32), np.zeros((1, c), np.int32)
        w[0, : end - pos] = ids[pos:end]
        m[0, : end - pos] = 1
        out.append((pos, w, m))
        pos = end
    return ids, out


@contextlib.contextmanager
def _logits_of(module, name: str, arg: int):
    """Record the ``arg``-th argument (or, ``arg`` None, the result) of
    every call of ``module.name``."""
    seen = []
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        seen.append(np.asarray(out if arg is None else a[arg], np.float32))
        return out

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def _entry_np(c) -> np.ndarray:
    """A cache entry as f32 numpy (an int8 pair dequantized)."""
    if isinstance(c, tuple):
        return np.asarray(c[0], np.float32) * np.asarray(c[1], np.float32)
    return np.asarray(c, np.float32)


def _jax_step_logits(jmod, jcfg, params, state, table=None):
    """The JAX first decode step's logits [V] (eager, the logits recorded
    off the step's head)."""
    name, arg = ("_logits", None) if jmod is jax_gpt else ("lm_head_logits", None)
    with _logits_of(jmod, name, arg) as seen:
        if table is None:
            jmod._decode_step(params, jcfg, state)
        else:
            jmod._paged_decode_step(params, jcfg, state, table)
    return seen[-1][0]


def _port_step_logits(pmod, model, state, table=None, bs=None):
    with _logits_of(pmod, "finish_step", 2) as seen:
        if table is None:
            pmod.decode_step(model, state)
        else:
            pmod.paged_decode_step(model, state, table, bs)
    return seen[-1][0]


def _handoff_fields(n: int, last: int, max_len: int):
    return dict(write_idx=[n - 1], pos=[0], last_token=[last], done=[False])


@pytest.mark.parametrize("chunk", [4, 7, 32])
@pytest.mark.parametrize("family", ["gpt", "llama", "llama-int8"])
def test_window_identity_against_jax(family, chunk):
    """Contiguous windows: the port's caches and first-step logits equal the
    JAX windows' within 1e-4 and its tokens the port's monolithic
    prefill's; a chunk that divides the prompt, one that does not, and one
    as wide as the whole state."""
    jmod, jcfg, params, pmod, model = _family(family)
    n, s_total, max_len = 20, 24, 8
    ids, wins = _windows(n, chunk)
    jst = jmod.empty_decode_state(params, jcfg, 1, s_total, max_len)
    st = pmod.empty_decode_state(model, 1, s_total, max_len)
    with torch.inference_mode():
        for start, w, m in wins:
            jst = jmod.prefill_chunk(params, jcfg, jst, jnp.asarray(w), jnp.asarray(m),
                                     np.int32(start))
            pmod.prefill_chunk(model, st, torch.from_numpy(w), torch.from_numpy(m),
                               torch.tensor(start))
        for name in ("cache_k", "cache_v"):
            for je, pe in zip(getattr(jst, name), getattr(st, name)):
                np.testing.assert_allclose(_entry_np(pe)[:, :n], _entry_np(je)[:, :n],
                                           atol=1e-4, err_msg=name)
        np.testing.assert_array_equal(st.key_valid.numpy(), np.asarray(jst.key_valid))
        hand = _handoff_fields(n, int(ids[-1]), max_len)
        jst = jst._replace(**{k: jnp.asarray(v, jnp.bool_ if k == "done" else jnp.int32)
                              for k, v in hand.items()})
        for k, v in hand.items():
            getattr(st, k).copy_(torch.tensor(v))
        want = _jax_step_logits(jmod, jcfg, params, jst)
        got = _port_step_logits(pmod, model, st)
        np.testing.assert_allclose(got, want, atol=1e-4)
        # The rest of the generation against the monolithic prefill.
        st, _ = pmod.generate_chunk(model, st, max_len - 1)
        mono = pmod.greedy_generate(model, torch.from_numpy(ids[None]),
                                    torch.ones(1, n, dtype=torch.int32), max_len)
    np.testing.assert_array_equal(st.tokens.numpy(), mono.numpy())


def _jax_paged_state(jmod, jcfg, nb: int, bs: int, width: int):
    """An all-dead JAX ``PagedState`` over zeroed pools of ``nb`` blocks."""
    shape = (nb, bs, jcfg.num_kv_heads if hasattr(jcfg, "num_kv_heads") else jcfg.num_heads,
             jcfg.head_dim)
    quant = getattr(jcfg, "kv_quant", False)

    def entry():
        if quant:
            return (jnp.zeros(shape, jnp.int8), jnp.ones(shape[:3] + (1,), jnp.float32))
        return jnp.zeros(shape, jnp.float32)

    return jax_gpt.PagedState(
        cache_k=[entry() for _ in range(jcfg.num_layers)],
        cache_v=[entry() for _ in range(jcfg.num_layers)],
        key_valid=jnp.zeros((1, width), jnp.int32), write_idx=jnp.zeros(1, jnp.int32),
        pos=jnp.zeros(1, jnp.int32), last_token=jnp.zeros(1, jnp.int32),
        done=jnp.ones(1, bool), tokens=jnp.zeros((1, 8), jnp.int32),
        sample=jax_greedy_params(1))


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("family", ["gpt", "llama", "llama-int8"])
def test_paged_window_identity_against_jax(family, chunk):
    """Paged windows through a shuffled table row with a sentinel tail:
    the stream's blocks and the first paged step's logits equal the JAX
    windows' within 1e-4; the port's tokens equal its monolithic
    prefill's.  A chunk that divides the prompt and one that does not,
    whose last window runs onto the sentinel: the port's pools carry a
    scratch block past the JAX pools' blocks, where those writes go."""
    jmod, jcfg, params, pmod, model = _family(family)
    n, bs, nb, max_len = 20, 4, 12, 8
    ids, wins = _windows(n, chunk)
    table = np.full(8, nb, np.int32)
    table[:5] = [7, 2, 9, 0, 4]  # the prompt's 20 positions
    jst = _jax_paged_state(jmod, jcfg, nb, bs, table.size * bs)
    cfg = model.cfg
    k, v = port_gpt.empty_caches(cfg, nb + 1, bs, torch.float32, torch.device("cpu"))
    st = port_gpt.PagedState(
        cache_k=k, cache_v=v, key_valid=torch.zeros(1, table.size * bs, dtype=torch.int32),
        write_idx=torch.zeros(1, dtype=torch.long), pos=torch.zeros(1, dtype=torch.long),
        last_token=torch.zeros(1, dtype=torch.long), done=torch.ones(1, dtype=torch.bool),
        tokens=torch.zeros(1, max_len, dtype=torch.int32),
        sample=port_gpt.greedy_params(1))
    row = torch.from_numpy(table)
    with torch.inference_mode():
        for start, w, m in wins:
            jst = jmod.paged_prefill_chunk(params, jcfg, jst, jnp.asarray(table),
                                           jnp.asarray(w), jnp.asarray(m), np.int32(start))
            pmod.paged_prefill_chunk(model, st, row, torch.from_numpy(w), torch.from_numpy(m),
                                     torch.tensor(start), bs)
        blocks = table[:5]
        for name in ("cache_k", "cache_v"):
            for je, pe in zip(getattr(jst, name), getattr(st, name)):
                got = _entry_np(pe)[blocks].reshape(-1, *_entry_np(pe).shape[2:])[:n]
                want = _entry_np(je)[blocks].reshape(-1, *_entry_np(je).shape[2:])[:n]
                np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        # Decode's growth: the blocks past the prompt, as the loop grants them.
        table[5:7] = [11, 5]
        kv = np.zeros((1, table.size * bs), np.int32)
        kv[0, :n] = 1
        jst = jst._replace(key_valid=jnp.asarray(kv), write_idx=jnp.asarray([n - 1]),
                           last_token=jnp.asarray([int(ids[-1])]), done=jnp.zeros(1, bool))
        st.key_valid.copy_(torch.from_numpy(kv))
        st.write_idx.fill_(n - 1)
        st.last_token.fill_(int(ids[-1]))
        st.done.fill_(False)
        want = _jax_step_logits(jmod, jcfg, params, jst, jnp.asarray(table[None]))
        got = _port_step_logits(pmod, model, st, row[None], bs)
        np.testing.assert_allclose(got, want, atol=1e-4)
        st, _ = pmod.generate_chunk_paged(model, st, row[None], bs, max_len - 1)
        mono = pmod.greedy_generate(model, torch.from_numpy(ids[None]),
                                    torch.ones(1, n, dtype=torch.int32), max_len)
    np.testing.assert_array_equal(st.tokens.numpy(), mono.numpy())


def test_window_write_drops_past_the_width():
    """A window reaching past the state's width drops its tail: the
    positions inside take the window's rows, the last one exactly its own,
    and nothing else changes (``start`` stays on the device)."""
    dst = torch.arange(10.0).view(1, 10, 1)
    new = torch.full((1, 4, 1), -1.0) - torch.arange(4.0).view(1, 4, 1)
    port_gpt.window_write(dst, new, torch.tensor(8))
    assert dst.view(-1).tolist() == [0, 1, 2, 3, 4, 5, 6, 7, -1, -2]
    port_gpt.window_write(dst, new, torch.tensor(12))  # wholly past it
    assert dst.view(-1).tolist() == [0, 1, 2, 3, 4, 5, 6, 7, -1, -2]
