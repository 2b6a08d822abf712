"""T5 in the port against the JAX package, f32 on the CPU, at a small config
(two layers, d_model 64, four heads of 16, vocab 512, 32 buckets over a
max distance of 128) with an untied random head (a tied head on random
weights argmax-locks onto one token, and every token check would pass
vacuously).  The weights are the JAX init's, carried across by
``t5_params_from_jax``.

- Bucket tables: integer-equal to the JAX ``_relative_bucket`` for every
  relative position in [-1024, 1024], bidirectional or not; the encoder's
  and the decoder's host tables equal the JAX buckets at their widths.
- Position biases bitwise equal to the JAX ``_position_bias`` (encoder)
  and ``_position_bias_rows`` (decoder rows at their own positions).
- K1's plain version with a bias and ``scale=1.0`` within 2e-5 of the JAX
  ``fused_attention`` in interpret mode.
- ``encode`` within 1e-4 at valid positions; each decode step's logits
  within 1e-4; the one-pass ``teacher_forced_logits`` within 1e-4 of the
  steps'; ``greedy_generate`` tokens identical; seeded sampled chunks give
  identical tokens and rng chains.
- ``t5_params_from_jax`` bitwise; ``t5_state_to_pytree`` equal to the JAX
  map on a synthetic HF state dict, the untied ``lm_head.weight`` too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.convert import hf_maps as jax_hf_maps
from mlmicroservicetemplate_tpu.models import sampling as js
from mlmicroservicetemplate_tpu.models import t5 as jax_t5
from mlmicroservicetemplate_tpu.ops import attention as jax_attention
from mlmicroservicetemplate_tpu_torch.convert import hf_maps
from mlmicroservicetemplate_tpu_torch.convert.jax_params import t5_params_from_jax
from mlmicroservicetemplate_tpu_torch.models import sampling as ps
from mlmicroservicetemplate_tpu_torch.models import t5 as port_t5
from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention, fused_attention_ref

DIMS = dict(vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_layers=2)
TOL = 1e-4  # f32 hidden states and logits against the JAX forward
K1_TOL = 2e-5  # the plain K1 against the JAX kernel in interpret mode


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """JAX params (untied head) as numpy, and the port model on them."""
    jcfg = jax_t5.T5Config(**DIMS)
    params = jax_t5.init_params(jax.random.PRNGKey(0), cfg=jcfg)
    params["lm_head"] = {"kernel": jax.random.normal(jax.random.PRNGKey(99),
                                                     (DIMS["d_model"], DIMS["vocab_size"]))}
    params = jax.tree.map(np.asarray, params)
    cfg = port_t5.T5Config(**DIMS)
    model = port_t5.build_model(cfg, t5_params_from_jax(params, cfg), torch.device("cpu"),
                                torch.float32)
    return jcfg, params, cfg, model


def _batch(b: int = 3, s: int = 17, seed: int = 3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(10, DIMS["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 12:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# buckets and biases


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_tables_equal_jax(bidirectional):
    rel = np.arange(-1024, 1025, dtype=np.int32)
    want = np.asarray(jax.jit(lambda r: jax_t5._relative_bucket(r, bidirectional, 32, 128))(rel))
    got = port_t5.relative_bucket(rel, bidirectional, 32, 128)
    np.testing.assert_array_equal(got, want)
    cfg = port_t5.T5Config(**DIMS)
    for width in (1, 17, 130, 512):
        pos = np.arange(width, dtype=np.int32)
        if bidirectional:
            jb = jax_t5._relative_bucket(pos[None, :] - pos[:, None], True, 32, 128)
            np.testing.assert_array_equal(port_t5.encoder_buckets(cfg, width), np.asarray(jb))
        else:
            jb = jax_t5._relative_bucket(-pos, False, 32, 128)
            np.testing.assert_array_equal(port_t5.decoder_buckets(cfg, width), np.asarray(jb))


def test_position_biases_bitwise_equal_jax(weights):
    jcfg, params, _, model = weights
    for s in (1, 17, 40):
        pos = jnp.arange(s, dtype=jnp.int32)
        want = np.asarray(jax_t5._position_bias(
            params["encoder"]["layers"][0]["attn"]["rel_bias"], jcfg, pos, pos, True))
        with torch.inference_mode():
            got = port_t5.encoder_position_bias(model, s, torch.float32, "cpu")
        assert got.is_contiguous() and got.shape == (1, DIMS["num_heads"], s, s)
        np.testing.assert_array_equal(got.numpy(), want)
    width = 12
    t = np.array([0, 5, 11, 3], np.int32)
    want = np.asarray(jax_t5._position_bias_rows(
        params["decoder"]["layers"][0]["self_attn"]["rel_bias"], jcfg, jnp.asarray(t),
        jnp.arange(width, dtype=jnp.int32)))
    with torch.inference_mode():
        got = port_t5.decoder_position_bias(model, _t(t).long(), width)
    # Keys past a row's position are masked: only the causal part is read.
    causal = (np.arange(width)[None, :] <= t[:, None])[:, None, None, :]
    causal = np.broadcast_to(causal, want.shape)
    np.testing.assert_array_equal(got.numpy()[causal], want[causal])


@pytest.mark.parametrize("s", [16, 40])
def test_plain_k1_with_bias_matches_jax_kernel(s):
    rng = np.random.default_rng(s)
    b, h, d = 3, 4, 64
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, h, s, s)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, s // 3:] = 0
    mask[2] = 0
    want = np.asarray(jax_attention.fused_attention(q, k, v, mask, bias=bias, scale=1.0,
                                                    interpret=True))
    launches = fused_attention.launches
    got = fused_attention(_t(q), _t(k), _t(v), _t(mask), bias=_t(bias), scale=1.0)
    assert fused_attention.launches == launches  # CPU: the plain version ran
    np.testing.assert_allclose(got.numpy(), want, atol=K1_TOL, rtol=0)
    np.testing.assert_array_equal(got.numpy(), fused_attention_ref(
        _t(q), _t(k), _t(v), _t(mask), _t(bias), 1.0).numpy())


# ---------------------------------------------------------------------------
# the model


def test_encode_matches_jax(weights):
    jcfg, params, _, model = weights
    ids, mask = _batch()
    want = np.asarray(jax_t5.encode(params, jcfg, ids, mask))
    with torch.inference_mode():
        got = port_t5.encode(model, _t(ids), _t(mask)).numpy()
    valid = mask.astype(bool)  # padded query rows differ between K1 and XLA
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL, rtol=0)


def _recorded(mp, module, name):
    """Patch ``module.name`` to record every value it returns."""
    seen = []
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        seen.append(np.asarray(out))
        return out

    mp.setattr(module, name, wrapper)
    return seen


def test_decode_step_logits_match_jax(weights):
    jcfg, params, _, model = weights
    ids, mask = _batch()
    steps = 6
    with pytest.MonkeyPatch.context() as mp:
        want = _recorded(mp, jax_t5, "_lm_logits")
        enc = jax_t5.encode(params, jcfg, ids, mask)
        state = jax_t5.init_decode_state(params, jcfg, enc, jnp.asarray(mask), steps)
        for _ in range(steps):
            state, _ = jax_t5._decode_step(params, jcfg, state)
        got = _recorded(mp, port_t5, "lm_logits")
        with torch.inference_mode():
            enc_p = port_t5.encode(model, _t(ids), _t(mask))
            pstate = port_t5.init_decode_state(model, enc_p, _t(mask), steps)
            port_t5.generate_chunk(model, pstate, steps)
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    np.testing.assert_array_equal(pstate.tokens.numpy(), np.asarray(state.tokens))
    # The one-pass decoder forward over the emitted tokens gives the steps'
    # logits (what the card's teacher-forced check holds tokens against).
    with torch.inference_mode():
        tf = port_t5.teacher_forced_logits(model, _t(ids), _t(mask), pstate.tokens)
    np.testing.assert_allclose(tf.numpy(), np.stack(want, axis=1), atol=TOL, rtol=0)


@pytest.mark.parametrize("max_len", [6, 12])
def test_greedy_generate_matches_jax(weights, max_len):
    jcfg, params, _, model = weights
    ids, mask = _batch(seed=5)
    want = np.asarray(jax_t5.greedy_generate(params, jcfg, ids, mask, max_len))
    with torch.inference_mode():
        got = port_t5.greedy_generate(model, _t(ids), _t(mask), max_len).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 3  # the untied head: not a locked argmax


def test_seeded_sampled_chunks_match_jax(weights):
    jcfg, params, _, model = weights
    ids, mask = _batch(b=4, seed=7)
    mask[2] = 1
    args = ([11, 12, 13, 14], [0.8, 0.0, 1.2, 0.6], [0, 0, 40, 5], [1.0, 1.0, 0.9, 0.5])
    jsp, psp = js.make_params(*args), ps.make_params(*args)
    max_len, chunk = 12, 4
    enc = jax_t5.encode(params, jcfg, ids, mask)
    jstate = jax_t5.init_decode_state(params, jcfg, enc, jnp.asarray(mask), max_len, sample=jsp)
    with torch.inference_mode():
        pstate = port_t5.init_decode_state(model, port_t5.encode(model, _t(ids), _t(mask)),
                                           _t(mask), max_len, sample=psp)
        for _ in range(max_len // chunk):
            jstate, jtoks = jax_t5.generate_chunk(params, jcfg, jstate, chunk, sample=True)
            pstate, ptoks = port_t5.generate_chunk(model, pstate, chunk, sample=True)
            np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
            np.testing.assert_array_equal(pstate.sample.rng.numpy(),
                                          np.asarray(jstate.sample.rng).astype(np.int64))
    np.testing.assert_array_equal(pstate.tokens.numpy(), np.asarray(jstate.tokens))


def test_empty_encoder_rows_are_born_done(weights):
    """A bucket-padding row (no valid encoder key) is done from the start
    and emits only pad, as the JAX engine marks such rows."""
    _, _, cfg, model = weights
    ids, mask = _batch()
    mask[2] = 0
    with torch.inference_mode():
        state = port_t5.init_decode_state(model, port_t5.encode(model, _t(ids), _t(mask)),
                                          _t(mask), 8)
        assert state.done.tolist() == [False, False, True]
        state, _ = port_t5.generate_chunk(model, state, 8)
    assert (state.tokens[2] == cfg.pad_id).all()


# ---------------------------------------------------------------------------
# weights


def test_params_from_jax_are_bitwise(weights):
    _, params, cfg, model = weights
    state = model.state_dict()
    assert torch.equal(state["shared.weight"], _t(params["shared"]["embedding"]))
    assert torch.equal(state["encoder.layers.0.attn.rel_bias.weight"],
                       _t(params["encoder"]["layers"][0]["attn"]["rel_bias"]["embedding"]))
    assert torch.equal(state["decoder.layers.1.cross_attn.q.weight"],
                       _t(params["decoder"]["layers"][1]["cross_attn"]["q"]["kernel"].T.copy()))
    assert torch.equal(state["decoder.final_ln.weight"],
                       _t(params["decoder"]["final_ln"]["scale"]))
    assert torch.equal(state["lm_head.weight"], _t(params["lm_head"]["kernel"].T.copy()))
    tied = {k: v for k, v in params.items() if k != "lm_head"}
    assert "lm_head.weight" not in t5_params_from_jax(tied, cfg)
    with pytest.raises(KeyError, match="lack"):
        t5_params_from_jax({**params, "shared": {}}, cfg)


@pytest.mark.parametrize("untied", [False, True])
def test_hf_map_matches_jax_map(untied):
    """A synthetic HF T5 state dict: the port's map gives the JAX map's
    pytree (linear weights transposed, layer 0's relative tables, the
    untied head when the dict has one), and the port loads it."""
    cfg = port_t5.T5Config(**DIMS)
    rng = np.random.default_rng(4)
    d, inner, f = cfg.d_model, cfg.inner_dim, cfg.d_ff

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    state = {"shared.weight": w(cfg.vocab_size, d), "encoder.final_layer_norm.weight": w(d),
             "decoder.final_layer_norm.weight": w(d)}

    def attn(base, first):
        for name, shape in (("q", (inner, d)), ("k", (inner, d)), ("v", (inner, d)),
                            ("o", (d, inner))):
            state[f"{base}.{name}.weight"] = w(*shape)
        if first:
            state[f"{base}.relative_attention_bias.weight"] = w(cfg.rel_buckets, cfg.num_heads)

    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        attn(f"{b}.0.SelfAttention", i == 0)
        state[f"{b}.0.layer_norm.weight"] = w(d)
        state[f"{b}.1.DenseReluDense.wi.weight"] = w(f, d)
        state[f"{b}.1.DenseReluDense.wo.weight"] = w(d, f)
        state[f"{b}.1.layer_norm.weight"] = w(d)
        b = f"decoder.block.{i}.layer"
        attn(f"{b}.0.SelfAttention", i == 0)
        attn(f"{b}.1.EncDecAttention", False)
        for j in range(3):
            state[f"{b}.{j}.layer_norm.weight"] = w(d)
        state[f"{b}.2.DenseReluDense.wi.weight"] = w(f, d)
        state[f"{b}.2.DenseReluDense.wo.weight"] = w(d, f)
    if untied:
        state["lm_head.weight"] = w(cfg.vocab_size, d)
    tree = hf_maps.t5_state_to_pytree(state, cfg.num_layers)
    jtree = jax_hf_maps.t5_state_to_pytree(state, cfg.num_layers)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, jtree))
    got = t5_params_from_jax(tree, cfg)
    np.testing.assert_array_equal(got["encoder.layers.1.mlp.wi.weight"].numpy(),
                                  state["encoder.block.1.layer.1.DenseReluDense.wi.weight"])
    np.testing.assert_array_equal(
        got["decoder.layers.0.self_attn.rel_bias.weight"].numpy(),
        state["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
    assert ("lm_head.weight" in got) == untied
