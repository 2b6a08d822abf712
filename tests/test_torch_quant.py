"""Weight-only int8 (``QUANTIZE=int8``) in the port against the JAX package,
f32 on the CPU, at small configs of all six served models (both packages'
config classes patched to the same small dims, as ``test_torch_gpt.py``
does for GPT-2).

- Leaf by leaf: the port quantizing a float JAX tree gives the int8
  modules that the JAX package's ``quantize_pytree`` tree carries across
  to, q8 integer-equal and scales bit-equal, and the same leaves stay
  float (norms, biases, tables under 4096 elements such as T5's
  ``rel_bias`` and BERT's ``token_type``, llama's narrow k/v here).
- The quantized primitives (``dense``, ``embed``, the LM head tied and
  untied, the conv) within 2e-5 of the JAX functions.
- Logits within 1e-4 of the JAX package's: BERT-base, bert-long at SP = 2
  and ResNet (engine-served, built from the JAX package's quantized tree),
  GPT-2's forward, llama's decode steps over a dense and an int8 KV cache,
  and T5's decode steps.  ResNet's tolerance is 2e-4: the port folds each
  BN into its conv's per-channel scale (``conv(x, q8 * (s * g)) + b``)
  where the reference applies it after the conv (``conv(x, q8 * s) * g +
  b``), which reorders the f32 products.
- Greedy and seeded sampled tokens identical to the JAX batcher's through
  the contiguous and the paged loop and the per-stream path (llama and
  GPT-2), and a port built from the float tree with ``QUANTIZE=int8``
  serves what one built from the JAX package's quantized tree serves.
"""

import asyncio
import contextlib
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models import bert as jax_bert
from mlmicroservicetemplate_tpu.models import common as jax_common
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu.models import quant as jax_quant
from mlmicroservicetemplate_tpu.models import resnet as jax_resnet
from mlmicroservicetemplate_tpu.models import t5 as jax_t5
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.convert import jax_params
from mlmicroservicetemplate_tpu_torch.models import bert as port_bert
from mlmicroservicetemplate_tpu_torch.models import common as port_common
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.models import quant as port_quant
from mlmicroservicetemplate_tpu_torch.models import resnet as port_resnet
from mlmicroservicetemplate_tpu_torch.models import t5 as port_t5
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.serve import build_service

PRIM_TOL = 2e-5  # a quantized primitive against the JAX function
TOL = 1e-4  # f32 logits against the JAX forward
RESNET_TOL = 2e-4  # the BN folded into the int8 conv's scale (module docstring)

BERT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
            num_labels=3)
GPT = dict(vocab_size=300, d_model=64, num_heads=2, num_layers=2, d_ff=128, max_position=128)
LLAMA = dict(vocab_size=300, d_model=64, num_heads=4, num_kv_heads=2, num_layers=2, d_ff=128,
             max_position=128)
T5 = dict(vocab_size=384, d_model=64, d_kv=32, num_heads=2, d_ff=128, num_layers=2)
RESNET = dict(embedding_size=32, hidden_sizes=(64, 128, 128, 256), depths=(1, 1, 1, 1),
              num_labels=10, image_size=32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def small_models():
    """Both packages' registries build the small configs above."""
    with pytest.MonkeyPatch.context() as mp:
        for jm, pm, cls, dims in ((jax_bert, port_bert, "BertConfig", BERT),
                                  (jax_gpt, port_gpt, "GPTConfig", GPT),
                                  (jax_t5, port_t5, "T5Config", T5),
                                  (jax_resnet, port_resnet, "ResNetConfig", RESNET)):
            mp.setattr(jm, cls, functools.partial(getattr(jm, cls), **dims))
            mp.setattr(pm, cls, functools.partial(getattr(pm, cls), **dims))
        mp.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# leaf by leaf


def _t5_untied(key, cfg):
    params = jax_t5.init_params(key, cfg=cfg)
    params["lm_head"] = {"kernel": jax.random.normal(jax.random.PRNGKey(99),
                                                     (cfg.d_model, cfg.vocab_size))}
    return params


# name: (JAX init, JAX config, port config, converter, port module)
FAMILIES = {
    "bert-base": (lambda k, c: jax_bert.init_params(k, cfg=c), jax_bert.BertConfig(**BERT),
                  port_bert.BertConfig(**BERT), jax_params.bert_params_from_jax,
                  port_bert.BertModel),
    "bert-long": (lambda k, c: jax_bert.init_params(k, cfg=c),
                  jax_bert.BertConfig(**BERT, max_position=1024),
                  port_bert.BertConfig(**BERT, max_position=1024),
                  jax_params.bert_params_from_jax, port_bert.BertModel),
    "gpt2": (jax_gpt.init_params, jax_gpt.GPTConfig(**GPT), port_gpt.GPTConfig(**GPT),
             jax_params.gpt_params_from_jax, port_gpt.GPTModel),
    "llama": (jax_llama.init_params, jax_llama.LlamaConfig(**LLAMA),
              port_llama.LlamaConfig(**LLAMA), jax_params.llama_params_from_jax,
              port_llama.LlamaModel),
    "t5-small": (_t5_untied, jax_t5.T5Config(**T5), port_t5.T5Config(**T5),
                 jax_params.t5_params_from_jax,
                 functools.partial(port_t5.T5Model, untied_head=True)),
    "resnet50": (lambda k, c: jax_resnet.init_params(k, cfg=c), jax_resnet.ResNetConfig(**RESNET),
                 port_resnet.ResNetConfig(**RESNET), jax_params.resnet_params_from_jax,
                 port_resnet.ResNet),
}


# A rank-2+ weight each small config keeps float (GPT-2's are all large).
KEPT_FLOAT = {"bert-base": "embeddings.token_type.weight",
              "bert-long": "embeddings.token_type.weight", "gpt2": None,
              "llama": "layers.0.attn.k.weight",
              "t5-small": "encoder.layers.0.attn.rel_bias.weight",
              "resnet50": "stages.0.0.conv1.weight"}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_quantized_leaves_equal_jax(name):
    """The port quantizing the float tree's weights (``quantize_model``,
    before any BN fold) gives, entry for entry, the state the JAX package's
    quantized tree carries across to: q8 int8-equal, scales f32-equal, the
    same entries quantized and the same left float."""
    init, jcfg, pcfg, convert, module = FAMILIES[name]
    params = _np(init(jax.random.PRNGKey(0), jcfg))
    qtree = _np(jax_quant.quantize_pytree(params, "int8"))
    want = convert(qtree, pcfg)
    with torch.device("meta"):
        model = module(pcfg)
    port_quant.load_weights(model, convert(params, pcfg), torch.device("cpu"), torch.float32,
                            quantize=True)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        assert torch.equal(got[key], w), key
    n_q8 = sum(k.endswith(".q8") for k in got)
    leaves = jax.tree_util.tree_leaves_with_path(qtree)
    assert n_q8 == sum(str(p[-1]) == "['q8']" for p, _ in leaves) > 0
    if KEPT_FLOAT[name] is not None:  # under 4096 elements: float in both
        assert got[KEPT_FLOAT[name]].is_floating_point()


def test_quant_error_stats_match_jax():
    w = np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32)
    j = jax_quant._quantize_array(jnp.asarray(w), per_row=False)
    q8, scale = port_quant.quantize_weight(torch.from_numpy(w.T.copy()))
    want = jax_quant.quant_error_stats(w, j)
    got = port_quant.quant_error_stats(w.T, q8.numpy(), scale.numpy())
    assert got == pytest.approx(want, abs=1e-7)


# ---------------------------------------------------------------------------
# primitives


def _q(w, per_row=False):
    q = jax_quant._quantize_array(jnp.asarray(w), per_row=per_row)
    return {k: np.array(v) for k, v in q.items()}


@pytest.mark.parametrize("prim", ["dense", "embed", "head_tied", "head_untied", "conv"])
def test_quantized_primitives_match_jax(prim):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    if prim == "dense":
        w, b = rng.normal(size=(64, 96)).astype(np.float32), rng.normal(size=96).astype(np.float32)
        q = _q(w)
        want = jax_common.dense({"kernel": q, "bias": b}, jnp.asarray(x))
        mod = port_quant.Int8Linear(torch.from_numpy(q["q8"].T.copy()),
                                    torch.from_numpy(q["scale"].T.copy()), torch.from_numpy(b))
        got = mod(torch.from_numpy(x))
    elif prim == "embed":
        table = rng.normal(size=(300, 64)).astype(np.float32)
        ids = rng.integers(0, 300, (3, 7)).astype(np.int32)
        q = _q(table, per_row=True)
        want = jax_common.embed({"embedding": q}, jnp.asarray(ids), jnp.float32)
        mod = port_quant.Int8Embedding(torch.from_numpy(q["q8"]), torch.from_numpy(q["scale"]))
        got = port_common.embed(mod, torch.from_numpy(ids).long(), torch.float32)
    elif prim == "head_tied":
        q = _q(rng.normal(size=(300, 64)).astype(np.float32), per_row=True)
        want = jax_common.lm_head_logits(jnp.asarray(x), q, transposed=True)
        mod = port_quant.Int8Embedding(torch.from_numpy(q["q8"]), torch.from_numpy(q["scale"]))
        got = port_common.lm_head_logits(torch.from_numpy(x), mod)
    elif prim == "head_untied":
        q = _q(rng.normal(size=(64, 300)).astype(np.float32))
        want = jax_common.lm_head_logits(jnp.asarray(x), q, transposed=False)
        mod = port_quant.Int8Linear(torch.from_numpy(q["q8"].T.copy()),
                                    torch.from_numpy(q["scale"].T.copy()), None)
        got = port_common.lm_head_logits(torch.from_numpy(x), mod)
    else:
        img = rng.normal(size=(2, 9, 9, 16)).astype(np.float32)
        q = _q(rng.normal(size=(3, 3, 16, 32)).astype(np.float32))
        want = jax_common.conv2d({"kernel": q}, jnp.asarray(img), stride=1, padding="SAME")
        perm = (3, 2, 0, 1)
        mod = port_quant.Int8Conv(torch.from_numpy(q["q8"].transpose(perm).copy()),
                                  torch.from_numpy(q["scale"].transpose(perm).copy()), None, 1, 1)
        xin = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        got = mod(xin).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=PRIM_TOL, rtol=0)


# ---------------------------------------------------------------------------
# logits


def _served_pair(env: dict):
    """The JAX service and the port's under ``QUANTIZE=int8`` at the small
    configs, the port on the JAX package's quantized tree."""
    with small_models():
        _, jbundle, jengine, _, _ = jax_build_service({**env, "QUANTIZE": "int8"})
        _, bundle, engine, _ = build_service({**env, "QUANTIZE": "int8"},
                                             params=_np(jbundle.params))
    return jbundle, jengine, bundle, engine


@pytest.mark.parametrize("name,sp", [("bert-base", None), ("bert-long", "2")])
def test_bert_logits_match_jax(name, sp, cpu_devices):
    env = {"DEVICE": "cpu", "MODEL_NAME": name, "WARMUP": "0", "BATCH_BUCKETS": "1,2",
           "SEQ_BUCKETS": "32,64", **({"SP": sp} if sp else {})}
    jbundle, jengine, bundle, engine = _served_pair(env)
    assert type(bundle.model.layers[0].attn.q).__name__ == "Int8Linear"
    assert type(bundle.model.embeddings.token_type).__name__ == "Embedding"  # 2 x 64 rows
    rng = np.random.RandomState(3)
    feats = [{"input_ids": rng.randint(5, 500, (n,)).astype(np.int32), "length": np.int32(n)}
             for n in (40, 17)]
    got, want = engine.run_batch(feats), jengine.run_batch(feats)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=TOL, rtol=0)


def test_resnet_logits_match_jax():
    env = {"DEVICE": "cpu", "MODEL_NAME": "resnet50", "WARMUP": "0", "BATCH_BUCKETS": "1,2"}
    jbundle, jengine, bundle, engine = _served_pair(env)
    assert any(type(m).__name__ == "Int8Conv" for m in bundle.model.modules())
    assert not any(type(m).__name__ == "BatchNorm" for m in bundle.model.modules())
    rng = np.random.RandomState(4)
    feats = [{"image": rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)} for _ in range(2)]
    got, want = engine.run_batch(feats), jengine.run_batch(feats)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=RESNET_TOL, rtol=0)


def _converted(name):
    init, jcfg, pcfg, convert, module = FAMILIES[name]
    qtree = _np(jax_quant.quantize_pytree(_np(init(jax.random.PRNGKey(0), jcfg)), "int8"))
    with torch.device("meta"):
        model = module(pcfg)
    port_quant.load_weights(model, convert(qtree, pcfg), torch.device("cpu"), torch.float32)
    return jcfg, qtree, model


def _batch(vocab: int):
    rng = np.random.default_rng(0)
    ids = rng.integers(5, vocab, (3, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    mask[2, 2:] = 0
    return ids, mask


def _recorded(mp, mod, name):
    out = []
    fn = getattr(mod, name)

    def rec(*a, **k):
        r = fn(*a, **k)
        out.append(np.array(r))
        return r

    mp.setattr(mod, name, rec)
    return out


def test_gpt2_logits_match_jax():
    jcfg, qtree, model = _converted("gpt2")
    ids, mask = _batch(GPT["vocab_size"])
    want = jax_gpt.lm_logits(qtree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        got = port_gpt.lm_logits(model, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "int8"])
def test_llama_decode_logits_match_jax(kv_quant):
    """Prefill logits, then each decode step's, over a dense or an int8 KV
    cache; the greedy tokens equal."""
    import dataclasses

    jcfg, qtree, model = _converted("llama")
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    model.cfg = dataclasses.replace(model.cfg, kv_quant=kv_quant)
    ids, mask = _batch(LLAMA["vocab_size"])
    steps = 6
    want_lm = jax_llama.lm_logits(qtree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with pytest.MonkeyPatch.context() as mp:
        want = _recorded(mp, jax_llama, "lm_head_logits")
        state = jax_llama.init_decode_state(qtree, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                            steps)
        for _ in range(steps):
            state, _ = jax_llama._decode_step(qtree, jcfg, state)
        got = _recorded(mp, port_llama, "lm_head_logits")
        with torch.inference_mode():
            got_lm = port_llama.lm_logits(model, torch.from_numpy(ids), torch.from_numpy(mask))
            pstate = port_llama.init_decode_state(model, torch.from_numpy(ids),
                                                  torch.from_numpy(mask), steps)
            port_llama.generate_chunk(model, pstate, steps)
    np.testing.assert_allclose(got_lm.numpy(), np.asarray(want_lm), atol=TOL, rtol=0)
    got, want = got[1:], want[-steps:]  # the port's first record is lm_logits'
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    np.testing.assert_array_equal(pstate.tokens.numpy(), np.asarray(state.tokens))


def test_t5_decode_step_logits_match_jax():
    jcfg, qtree, model = _converted("t5-small")
    assert type(model.lm_head).__name__ == "Int8Linear"
    assert type(model.encoder.layers[0].attn.rel_bias).__name__ == "Embedding"
    ids, mask = _batch(T5["vocab_size"])
    steps = 5
    with pytest.MonkeyPatch.context() as mp:
        want = _recorded(mp, jax_t5, "_lm_logits")
        enc = jax_t5.encode(qtree, jcfg, ids, mask)
        state = jax_t5.init_decode_state(qtree, jcfg, enc, jnp.asarray(mask), steps)
        for _ in range(steps):
            state, _ = jax_t5._decode_step(qtree, jcfg, state)
        got = _recorded(mp, port_t5, "lm_logits")
        with torch.inference_mode():
            enc_p = port_t5.encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
            pstate = port_t5.init_decode_state(model, enc_p, torch.from_numpy(mask), steps)
            port_t5.generate_chunk(model, pstate, steps)
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    np.testing.assert_array_equal(pstate.tokens.numpy(), np.asarray(state.tokens))


# ---------------------------------------------------------------------------
# tokens through the serving paths

SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
             stream_chunk_tokens=4, max_streams=4, kv_block_size=8)
PORT_SERVE = {"BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
              "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "KV_BLOCK_SIZE": "8",
              "BATCH_TIMEOUT_MS": "1"}
# (text, max_tokens, temperature, seed): greedy and seeded sampled rows.
REQUESTS = [("hi", None, 0.0, None), ("the quick brown fox", 3, 0.9, 7),
            ("serving tokens, twice", None, 0.0, None), ("a", 7, 1.3, 11)]


def _item(cls, t, m, temp, seed):
    return cls(text=t, max_tokens=m, temperature=temp, top_k=20 if temp else 0, seed=seed)


async def _stream_queued(batcher, bundle, item_cls):
    """Every request streamed, all queued before the loop's thread starts
    (one first wave, whatever the host's load)."""
    feats = [bundle.preprocess(_item(item_cls, *r)) for r in REQUESTS]

    async def drain(gen):
        return [t async for chunk in gen for t in np.asarray(chunk).tolist()]

    loop = batcher._cdl
    await batcher.start()
    try:
        if loop is not None:
            loop._ensure_thread = lambda: None
        try:
            gens = [batcher.submit_stream(f) for f in feats]
        finally:
            if loop is not None:
                del loop._ensure_thread
                loop._ensure_thread()
        return await asyncio.gather(*(drain(g) for g in gens))
    finally:
        await batcher.stop()


def _jax_batcher(model: str, **kw):
    with small_models():
        cfg = JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                               batch_timeout_ms=1.0, quantize="int8", **SERVE, **kw)
        bundle = jax_build_model(cfg)
    return bundle, JaxBatcher(JaxEngine(bundle, cfg, ReplicaSet(make_mesh(1))), cfg)


@pytest.mark.parametrize("model", ["llama", "gpt2"])
@pytest.mark.parametrize("path", ["contiguous", "paged", "per_stream"])
def test_tokens_match_jax_batcher(model, path):
    """Greedy and seeded sampled streams over the int8 weights: the JAX
    batcher's tokens through the contiguous loop, the paged loop and the
    per-stream path (CONTINUOUS_BATCHING=0)."""
    jkw = {"paged_kv": path == "paged", "continuous_batching": path != "per_stream"}
    jbundle, jbatcher = _jax_batcher(model, **jkw)
    want = asyncio.run(_stream_queued(jbatcher, jbundle, JaxRawItem))
    with small_models():
        _, bundle, _, batcher = build_service(
            {"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0", "QUANTIZE": "int8",
             "PAGED_KV": "1" if path == "paged" else "0",
             "CONTINUOUS_BATCHING": "0" if path == "per_stream" else "1", **PORT_SERVE},
            params=_np(jbundle.params))
    got = asyncio.run(_stream_queued(batcher, bundle, RawItem))
    assert got == want
    assert len({tuple(g) for g in got}) > 1


def test_port_quantizes_the_float_tree_as_jax_does():
    """A port built from the float tree with QUANTIZE=int8 serves the very
    tokens of one built from the JAX package's quantized tree, and holds
    the same int8 buffers."""
    with small_models():
        fbundle = jax_build_model(JaxServiceConfig(device="cpu", model_name="llama",
                                                   warmup=False, **SERVE))
    qbundle, _ = _jax_batcher("llama")
    env = {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "QUANTIZE": "int8",
           **PORT_SERVE}
    with small_models():
        _, a, _, ba = build_service(env, params=_np(fbundle.params))
        _, b, _, bb = build_service(env, params=_np(qbundle.params))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert asyncio.run(_stream_queued(ba, a, RawItem)) == asyncio.run(
        _stream_queued(bb, b, RawItem))


def test_quantize_is_off_unless_set():
    with small_models():
        _, bundle, _, _ = build_service({"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0",
                                         **PORT_SERVE})
    assert not any(isinstance(m, (port_quant.Int8Linear, port_quant.Int8Embedding))
                   for m in bundle.model.modules())
