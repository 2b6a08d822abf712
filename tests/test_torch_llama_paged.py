"""Paged llama decode of the port against the JAX package's, at a small
config with TinyLlama's head width (64) and GQA, f32 on both sides.

- ``generate_chunk_paged`` from the very pool the JAX paged prefill built
  (carried across by ``paged_state_from_jax``), over a shuffled block
  table, gives tokens identical to JAX ``generate_chunk_paged`` (its
  Pallas kernel in interpret mode, or its gather path) and to contiguous
  greedy decoding, dense and int8 (as ``tests/test_paged.py``).
- A dead row stepping past its state's widths raises nothing and changes
  no live row, paged and contiguous."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
    llama_params_from_jax,
    paged_state_from_jax,
)
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
BS, MAX_LEN = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.LlamaConfig(**SMALL)
    params = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(1), jcfg))
    return params, llama_params_from_jax(params, port_llama.LlamaConfig(**SMALL))


def _model(state_dict, kv_quant: bool):
    cfg = port_llama.LlamaConfig(**SMALL, kv_quant=kv_quant)
    return port_llama.build_model(cfg, state_dict, torch.device("cpu"), torch.float32)


def _prompts():
    """Three right-padded prompts of unequal length and a shuffled table
    covering prompt + decode for each row (a paged bug that only shows
    with out-of-order blocks must not hide behind an identity table)."""
    rng = np.random.default_rng(1)
    lens = [4, 11, 7]
    ids = np.zeros((3, 12), np.int32)
    mask = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(5, 250, n)
        mask[i, :n] = 1
    nb_row = -(-(ids.shape[1] + MAX_LEN) // BS)
    table = np.random.RandomState(2).permutation(3 * nb_row).reshape(3, nb_row)
    return ids, mask, table.astype(np.int32), 3 * nb_row


def _jax_paged(params, kv_quant: bool, jax_kernel: bool):
    """JAX: the paged prefill state and its tokens after MAX_LEN steps."""
    jcfg = jax_llama.LlamaConfig(**SMALL, kv_quant=kv_quant, pallas_decode=jax_kernel,
                                 pallas_interpret=jax_kernel)
    ids, mask, table, nb = _prompts()
    st0 = jax_llama.init_paged_state(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                     MAX_LEN, jnp.asarray(table), nb, BS)
    st, _ = jax_llama.generate_chunk_paged(params, jcfg, st0, jnp.asarray(table), MAX_LEN)
    contiguous = jax_llama.greedy_generate(params, dataclasses.replace(jcfg, pallas_decode=False),
                                           ids, mask, MAX_LEN)
    return jax.tree.map(np.asarray, st0), np.asarray(st.tokens), np.asarray(contiguous), table


@pytest.mark.parametrize("jax_kernel", [True, False], ids=["jax-pallas", "jax-gather"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_paged_tokens_identical_to_jax(weights, kv_quant, jax_kernel):
    params, state_dict = weights
    st0, want_paged, want_contiguous, table = _jax_paged(params, kv_quant, jax_kernel)
    np.testing.assert_array_equal(want_paged, want_contiguous)
    model = _model(state_dict, kv_quant)
    launches = paged_decode_attention.launches
    with torch.inference_mode():
        state = paged_state_from_jax(st0)
        state, toks = port_llama.generate_chunk_paged(model, state, torch.from_numpy(table), BS,
                                                      MAX_LEN)
    assert paged_decode_attention.launches == launches  # CPU: the plain version
    assert toks.shape == (3, MAX_LEN)
    np.testing.assert_array_equal(state.tokens.numpy(), want_paged)
    np.testing.assert_array_equal(toks.numpy(), want_paged)


def _kill_row_near_the_end(state, width: int, max_len: int) -> None:
    """Row 0 becomes a long-dead loop row still stepping: its next write
    lands two positions before its cache width, its next token one before
    its token width, and it is not done."""
    state.write_idx[0] = width - 2
    state.pos[0] = max_len - 1
    state.done[0] = False


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_dead_row_past_its_width_changes_no_live_row_paged(weights, kv_quant):
    params, state_dict = weights
    st0, _, _, table = _jax_paged(params, kv_quant, jax_kernel=False)
    model = _model(state_dict, kv_quant)
    nb = st0.cache_k[0][0].shape[0] if kv_quant else st0.cache_k[0].shape[0]
    steps = 5
    with torch.inference_mode():
        ref, ref_toks = port_llama.generate_chunk_paged(
            model, paged_state_from_jax(st0), torch.from_numpy(table), BS, steps)
        state = paged_state_from_jax(st0)
        dead_table = table.copy()
        dead_table[0] = nb  # a freed slot: every entry is the sentinel
        _kill_row_near_the_end(state, state.key_valid.shape[1], MAX_LEN)
        state, toks = port_llama.generate_chunk_paged(
            model, state, torch.from_numpy(dead_table), BS, steps)
    np.testing.assert_array_equal(toks[1:].numpy(), ref_toks[1:].numpy())
    np.testing.assert_array_equal(state.tokens[1:].numpy(), ref.tokens[1:].numpy())
    assert int(state.write_idx[0]) == state.key_valid.shape[1] - 2 + steps
    live = table[1:].ravel()
    for got, want in zip(state.cache_k + state.cache_v, ref.cache_k + ref.cache_v):
        for g, w in (zip(got, want) if kv_quant else [(got, want)]):
            torch.testing.assert_close(g[live], w[live], atol=0, rtol=0)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_dead_row_past_its_width_changes_no_live_row_contiguous(weights, kv_quant):
    _, state_dict = weights
    model = _model(state_dict, kv_quant)
    ids, mask, _, _ = _prompts()
    steps = 5
    with torch.inference_mode():
        def fresh():
            st = port_llama.init_decode_state(model, torch.from_numpy(ids),
                                              torch.from_numpy(mask), MAX_LEN)
            return dataclasses.replace(st, steps=None)  # rows at different steps

        ref, ref_toks = port_llama.generate_chunk(model, fresh(), steps)
        state = fresh()
        _kill_row_near_the_end(state, state.key_valid.shape[1], MAX_LEN)
        state, toks = port_llama.generate_chunk(model, state, steps)
    np.testing.assert_array_equal(toks[1:].numpy(), ref_toks[1:].numpy())
    np.testing.assert_array_equal(state.tokens[1:].numpy(), ref.tokens[1:].numpy())
    for got, want in zip(state.cache_k + state.cache_v, ref.cache_k + ref.cache_v):
        for g, w in (zip(got, want) if kv_quant else [(got, want)]):
            torch.testing.assert_close(g[1:], w[1:], atol=0, rtol=0)
