"""The port's llama against the JAX package's on the same weights (JAX
``init_params(PRNGKey(0))`` carried across by ``llama_params_from_jax``),
at a small config with TinyLlama's head width (64) and GQA.  f32 on both
sides: RoPE tables and RMSNorm to 1e-6, int8 KV payloads exact and their
scales to 1e-7, logits to 1e-4, greedy tokens identical (dense and int8
caches; the JAX side both through its Pallas decode kernel in interpret
mode and through its jnp path)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlmicroservicetemplate_tpu.convert import llama_state_to_pytree as jax_llama_state_to_pytree
from mlmicroservicetemplate_tpu.models import common as jax_common
from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu_torch.convert.hf_maps import llama_state_to_pytree
from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
from mlmicroservicetemplate_tpu_torch.models import common as port_common
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig(**SMALL)
    params = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = port_llama.LlamaConfig(**SMALL)
    model = port_llama.build_model(cfg, llama_params_from_jax(params, cfg),
                                   torch.device("cpu"), torch.float32)
    return jcfg, params, cfg, model


def _batch():
    """A right-padded batch of unequal prompt lengths."""
    rng = np.random.default_rng(0)
    lens = [5, 13, 9]
    ids = np.zeros((3, 16), np.int32)
    mask = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(3, SMALL["vocab_size"], n)
        mask[i, :n] = 1
    return ids, mask


def test_rope_tables_and_rmsnorm(models):
    jcfg, _, cfg, _ = models
    pos = np.arange(SMALL["max_position"], dtype=np.int32)
    jcos, jsin = jax_llama._rope_tables(jcfg, jnp.asarray(pos), jnp.float32)
    cos, sin = port_llama.rope_tables(cfg, torch.from_numpy(pos), torch.float32)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 256)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = jax_common.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), eps=1e-5)
    got = port_common.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_kv_quantize_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 11, 2, 64)) * rng.uniform(0.01, 3.0, (3, 11, 2, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero head: the 1e-8 guard
    j8, js = jax_common.kv_quantize(jnp.asarray(x))
    p8, ps = port_common.kv_quantize(torch.from_numpy(x))
    assert p8.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(p8.numpy(), np.asarray(j8))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-7, rtol=0)


def test_mha_attention_kv8_matches_jax():
    """Attention over an int8 cache with the scales factored out, for a
    window of queries under a causal mask."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 4, 64)).astype(np.float32) for _ in range(2))
    (k8, ks), (v8, vs) = (
        tuple(np.array(a) for a in jax_common.kv_quantize(jnp.asarray(x))) for x in (k, v)
    )
    mask = np.tril(np.ones((3, 9), bool), k=6)[None, None]
    want = jax_common.mha_attention_kv8(*(jnp.asarray(x) for x in (q, k8, ks, v8, vs)),
                                        mask=jnp.asarray(mask))
    got = port_common.mha_attention_kv8(*(torch.from_numpy(x) for x in (q, k8, ks, v8, vs)),
                                        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_lm_logits_match_jax(models):
    jcfg, params, _, model = models
    ids, mask = _batch()
    want = np.asarray(jax_llama.lm_logits(params, jcfg, ids, mask))
    with torch.inference_mode():
        got = port_llama.lm_logits(model, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    for i, n in enumerate(mask.sum(axis=1)):  # padding positions are don't-care
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n], atol=1e-4, rtol=0)


@pytest.mark.parametrize("jax_kernel", [True, False], ids=["jax-pallas", "jax-jnp"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_greedy_tokens_identical_to_jax(models, kv_quant, jax_kernel):
    jcfg, params, cfg, model = models
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant, pallas_decode=jax_kernel,
                               pallas_interpret=jax_kernel)
    model.cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    ids, mask = _batch()
    max_len = 12
    want = np.asarray(jax_llama.greedy_generate(params, jcfg, ids, mask, max_len))
    launches = decode_attention.launches
    try:
        with torch.inference_mode():
            got = port_llama.greedy_generate(model, torch.from_numpy(ids),
                                             torch.from_numpy(mask), max_len)
    finally:
        model.cfg = cfg
    assert got.dtype == torch.int32 and got.shape == (3, max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert decode_attention.launches == launches  # CPU: the plain version


def test_decode_state_mirrors_jax(models):
    """The first step re-embeds the last prompt token: write_idx starts at
    length - 1 and the cache holds the prompt's rotated K/V."""
    jcfg, params, _, model = models
    ids, mask = _batch()
    want = jax_llama.init_decode_state(params, jcfg, ids, mask, 8)
    with torch.inference_mode():
        got = port_llama.init_decode_state(model, torch.from_numpy(ids),
                                           torch.from_numpy(mask), 8)
    np.testing.assert_array_equal(got.write_idx.numpy(), np.asarray(want.write_idx))
    np.testing.assert_array_equal(got.last_token.numpy(), np.asarray(want.last_token))
    np.testing.assert_array_equal(got.key_valid.numpy(), np.asarray(want.key_valid))
    np.testing.assert_allclose(got.cache_k[1].numpy(), np.asarray(want.cache_k[1]),
                               atol=1e-5, rtol=0)


def test_generate_chunk_refuses_to_overrun_the_cache(models):
    _, _, _, model = models
    ids, mask = _batch()
    with torch.inference_mode():
        state = port_llama.init_decode_state(model, torch.from_numpy(ids),
                                             torch.from_numpy(mask), 4)
        state, toks = port_llama.generate_chunk(model, state, 4)
        assert toks.shape == (3, 4) and state.steps == 4
        with pytest.raises(ValueError, match="overrun"):
            port_llama.generate_chunk(model, state, 1)


def _hf_state(rng, n_layers, d, kv, ff, vocab, tied=False):
    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    s = {"model.embed_tokens.weight": w(vocab, d), "model.norm.weight": 1.0 + w(d)}
    if not tied:
        s["lm_head.weight"] = w(vocab, d)
    for i in range(n_layers):
        b = f"model.layers.{i}"
        s[f"{b}.input_layernorm.weight"] = 1.0 + w(d)
        s[f"{b}.post_attention_layernorm.weight"] = 1.0 + w(d)
        for name, shape in {"self_attn.q_proj": (d, d), "self_attn.k_proj": (kv, d),
                            "self_attn.v_proj": (kv, d), "self_attn.o_proj": (d, d),
                            "mlp.gate_proj": (ff, d), "mlp.up_proj": (ff, d),
                            "mlp.down_proj": (d, ff)}.items():
            s[f"{b}.{name}.weight"] = w(*shape)
    return s


@pytest.mark.parametrize("tied", [False, True])
def test_llama_state_to_pytree_matches_jax(tied):
    state = _hf_state(np.random.default_rng(3), 2, 256, 128, 512, 300, tied)
    want = jax_llama_state_to_pytree(state)
    got = llama_state_to_pytree(state)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    # ... and the weights carried into the port give the JAX logits.
    cfg = port_llama.LlamaConfig(**SMALL)
    model = port_llama.build_model(cfg, llama_params_from_jax(got, cfg),
                                   torch.device("cpu"), torch.float32)
    ids, mask = _batch()
    ref = np.asarray(jax_llama.lm_logits(want, jax_llama.LlamaConfig(**SMALL), ids, mask))
    with torch.inference_mode():
        out = port_llama.lm_logits(model, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out[0, :5].numpy(), ref[0, :5], atol=1e-4, rtol=0)


def test_model_path_npz_loads_the_jax_weights(tmp_path):
    """MODEL_PATH=*.npz of HF names: the registry's weights equal the JAX
    package's load_pytree + llama_state_to_pytree on the same file."""
    import types

    from mlmicroservicetemplate_tpu.models.checkpoint import load_pytree
    from mlmicroservicetemplate_tpu_torch.models import registry as port_registry

    path = tmp_path / "llama.npz"
    np.savez(path, **_hf_state(np.random.default_rng(4), 2, 256, 128, 512, 300))
    cfg = port_llama.LlamaConfig(**SMALL)
    got = port_registry._llama_state(types.SimpleNamespace(model_path=str(path)), cfg, None)
    want = llama_params_from_jax(
        jax.tree.map(np.asarray, load_pytree(str(path), jax_llama_state_to_pytree)), cfg
    )
    assert got.keys() == want.keys()
    for name in got:
        torch.testing.assert_close(got[name], want[name], atol=0, rtol=0)


def test_llama_params_from_jax_rejects_a_wrong_tree(models):
    _, params, cfg, _ = models
    with pytest.raises(ValueError, match="shape"):
        llama_params_from_jax(params, dataclasses.replace(cfg, d_ff=256))
    broken = {**params, "extra": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="unused"):
        llama_params_from_jax(broken, cfg)
