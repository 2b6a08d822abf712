"""The port's prompt-prefix overlay against the JAX package's, f32 on the
CPU, at small llama (dense and int8 KV) and GPT-2 configs on the same
weights:

- ``compute_prefix_kv`` equal; ``forward_hidden`` with ``prefix_kv`` (the
  suffix at positions ``P ..``, the prefix fully visible) and
  ``init_decode_state`` with the overlay (caches, ``key_valid``,
  ``write_idx``) within 1e-4; int8 prefix entries copied bit for bit;
- ``PROMPT_PREFIX``: greedy and seeded-sampled tokens identical to the
  JAX service's, whole, through the continuous loop and on the per-stream
  path; the prefix's terminal specials stripped; the JAX refusals
  (``PROMPT_PREFIX`` or ``PREFIX_CACHE`` on a family without a prefix,
  both at once, ``PROMPT_PREFIX`` with ``PAGED_KV``) with the JAX
  messages."""

import asyncio
import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from test_torch_gpt import DIMS as GPT_DIMS
from test_torch_gpt import small_gpt2

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
    gpt_params_from_jax,
    llama_params_from_jax,
)
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.serve import build_service

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
P, S = 16, 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama_models():
    jcfg = jax_llama.LlamaConfig(**SMALL)
    params = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = port_llama.LlamaConfig(**SMALL)
    model = port_llama.build_model(cfg, llama_params_from_jax(params, cfg),
                                   torch.device("cpu"), torch.float32)
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def gpt_models():
    ids = dict(GPT_DIMS, eos_id=1, pad_id=0)  # inside the small vocabulary
    jcfg = jax_gpt.GPTConfig(**ids)
    params = jax.tree.map(np.asarray, jax_gpt.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = port_gpt.GPTConfig(**ids)
    model = port_gpt.build_model(cfg, gpt_params_from_jax(params, cfg), torch.device("cpu"),
                                 torch.float32)
    return jcfg, params, cfg, model


def _ids(n: int, seed: int, vocab: int = 300) -> np.ndarray:
    return np.random.default_rng(seed).integers(3, vocab, n).astype(np.int32)


def _suffix_batch(rows: int = 3):
    """Right-padded suffixes of unequal lengths (one row fully padded)."""
    ids = np.zeros((rows, S), np.int32)
    mask = np.zeros((rows, S), np.int32)
    for i, n in enumerate([5, 8, 0][:rows]):
        ids[i, :n] = _ids(n, 10 + i)
        mask[i, :n] = 1
    return ids, mask


def _leaves(x):
    return [np.asarray(t) for t in jax.tree.leaves(x)]


def _port_leaves(x):
    out = []
    for t in x if isinstance(x, (list, tuple)) else [x]:
        out.extend(_port_leaves(t) if isinstance(t, (list, tuple)) else [t.detach().numpy()])
    return out


def _family(name, llama_models, gpt_models, kv_quant=False):
    if name == "llama":
        jcfg, params, cfg, model = llama_models
        jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
        model.cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
        return jax_llama, port_llama, jcfg, params, model
    jcfg, params, cfg, model = gpt_models
    return jax_gpt, port_gpt, jcfg, params, model


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_compute_prefix_kv_and_prefixed_forward_match_jax(name, llama_models, gpt_models):
    jmod, pmod, jcfg, params, model = _family(name, llama_models, gpt_models)
    pre_ids = _ids(P, 1)
    jpkv = jmod.compute_prefix_kv(params, jcfg, pre_ids)
    with torch.inference_mode():
        pkv = pmod.compute_prefix_kv(model, pre_ids)
        for a, b in zip(_port_leaves(pkv["k"] + pkv["v"]), _leaves(jpkv["k"] + jpkv["v"])):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        ids, mask = _suffix_batch()
        jpairs = list(zip(jpkv["k"], jpkv["v"]))
        want, jkv = jmod.forward_hidden(params, jcfg, ids, mask, collect_kv=True,
                                        prefix_kv=jpairs)
        got, kv = pmod.forward_hidden(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                      collect_kv=True, prefix_kv=port_gpt.prefix_pairs(pkv))
    for i, n in enumerate(mask.sum(axis=1)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], atol=1e-4,
                                   rtol=0)
    for (k, v), (jk, jv) in zip(kv, jkv):
        np.testing.assert_allclose(k[:2].numpy(), np.asarray(jk)[:2], atol=1e-4, rtol=0)
        np.testing.assert_allclose(v[:2].numpy(), np.asarray(jv)[:2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name,kv_quant,entry", [
    ("llama", False, "dense"), ("llama", True, "dense"), ("llama", True, "int8"),
    ("gpt2", False, "dense"),
])
def test_init_decode_state_with_prefix_matches_jax(name, kv_quant, entry, llama_models,
                                                   gpt_models):
    """Caches, ``key_valid``, ``write_idx`` and the first chunk's tokens of
    a prefixed prefill equal the JAX state's; int8 prefix entries (a
    capture's, or ``quantize_prefix_kv``'s) land in the cache bit for
    bit, dense ones quantize with the cache's scheme."""
    jmod, pmod, jcfg, params, model = _family(name, llama_models, gpt_models, kv_quant)
    try:
        pre_ids = _ids(P, 2)
        jpkv = jmod.compute_prefix_kv(params, jcfg, pre_ids)
        with torch.inference_mode():
            pkv = pmod.compute_prefix_kv(model, pre_ids)
            if entry == "int8":
                jpkv = jax_llama.quantize_prefix_kv(jpkv)
                pkv = port_llama.quantize_prefix_kv(pkv)
                for a, b in zip(_port_leaves(pkv["k"]), _leaves(jpkv["k"])):
                    if a.dtype == np.int8:
                        np.testing.assert_array_equal(a, b)
            ids, mask = _suffix_batch()
            max_len = 8
            jstate = jmod.init_decode_state(dict(params, __prefix__=jpkv), jcfg, ids, mask,
                                            max_len)
            state = pmod.init_decode_state(model, torch.from_numpy(ids),
                                           torch.from_numpy(mask), max_len, prefix_kv=pkv)
            jstate, jtoks = jmod.generate_chunk(params, jcfg, jstate, 4)
            state, toks = pmod.generate_chunk(model, state, 4)
        assert state.key_valid.shape[1] == P + S + max_len
        np.testing.assert_array_equal(state.key_valid.numpy(), np.asarray(jstate.key_valid))
        np.testing.assert_array_equal(state.write_idx.numpy(), np.asarray(jstate.write_idx))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
        for a, b in zip(_port_leaves(state.cache_k + state.cache_v),
                        _leaves(list(jstate.cache_k) + list(jstate.cache_v))):
            a, b = a[:2], b[:2]  # the fully padded row's rows are don't-cares
            if a.dtype != np.int8:
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
            elif entry == "int8":  # the prefix's int8 rows copied bit for bit
                np.testing.assert_array_equal(a[:, :P], b[:, :P])
            else:  # quantized on both sides: a rounding tie may part by one
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    finally:
        if name == "llama":
            model.cfg = llama_models[2]


# ---------------------------------------------------------------------------
# PROMPT_PREFIX through the service

SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=12,
             stream_chunk_tokens=4, max_streams=4)
PREFIX_TEXT = "You are a terse assistant."
TEXTS = [("hello there", 8), ("the quick brown fox jumps", 12), ("abc", 5)]


def _env(kw: dict) -> dict:
    return {k.upper(): (",".join(map(str, v)) if isinstance(v, tuple)
                        else ("1" if v else "0") if isinstance(v, bool) else str(v))
            for k, v in kw.items()}


def _services(model: str, **kw):
    """The JAX (cfg, bundle, engine) and the port's (cfg, bundle, engine,
    batcher) at ``kw`` on the JAX bundle's weights."""
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        with small_gpt2() if model == "gpt2" else contextlib.nullcontext():
            jcfg = JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                                    batch_timeout_ms=1.0, **kw)
            jbundle = jax_build_model(jcfg)
            jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
            params = {k: v for k, v in jax.tree.map(np.asarray, jbundle.params).items()
                      if k != "__prefix__"}
            port = build_service({"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0",
                                  "LLAMA_CONFIG": json.dumps(SMALL), "BATCH_TIMEOUT_MS": "1",
                                  **_env(kw)}, params=params)
    finally:
        del os.environ["LLAMA_CONFIG"]
    return (jcfg, jbundle, jengine), port


def _items(item_cls, sampled: bool):
    extra = dict(temperature=0.9, top_k=20, seed=11) if sampled else {}
    return [item_cls(text=t, max_tokens=m, **extra) for t, m in TEXTS]


async def _streams(batcher, bundle, items):
    async def one(item):
        return [int(t) async for chunk in batcher.submit_stream(bundle.preprocess(item))
                for t in np.asarray(chunk).tolist()]

    await batcher.start()
    try:
        return await asyncio.gather(*(one(it) for it in items))
    finally:
        await batcher.stop()


async def _whole(batcher, bundle, items):
    await batcher.start()
    try:
        rows = await asyncio.gather(*(batcher.submit(bundle.preprocess(it)) for it in items))
        return [np.asarray(r).tolist() for r in rows]
    finally:
        await batcher.stop()


@pytest.mark.parametrize("model,quant", [("llama", None), ("llama", "int8"), ("gpt2", None)])
def test_prompt_prefix_state_matches_jax(model, quant):
    """The global prefix: its length, its ids (terminal specials
    stripped), its per-layer K/V (int8 under ``QUANT_KV``) and the
    position budget equal the JAX bundle's."""
    kw = dict(SERVE, prompt_prefix=PREFIX_TEXT, **({"quant_kv": quant} if quant else {}))
    (_, jbundle, jengine), (_, bundle, engine, _) = _services(model, **kw)
    assert engine.global_prefix_len() == jengine._global_prefix_len() > 0
    assert bundle.max_prompt_len == jbundle.max_prompt_len
    jpre = jbundle.params["__prefix__"]
    for a, b in zip(_port_leaves(bundle.prompt_prefix["k"] + bundle.prompt_prefix["v"]),
                    _leaves(list(jpre["k"]) + list(jpre["v"]))):
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    f, jf = (b.preprocess(cls(text="hi")) for b, cls in ((bundle, RawItem),
                                                         (jbundle, JaxRawItem)))
    np.testing.assert_array_equal(f["input_ids"], jf["input_ids"])
    assert engine.kv_bytes_estimate(f) == jengine.kv_bytes_estimate(jf)


@pytest.mark.parametrize("path", ["whole", "loop", "per-stream"])
@pytest.mark.parametrize("model,quant,sampled", [
    ("llama", None, False), ("llama", "int8", False), ("gpt2", None, False),
    ("llama", None, True),
], ids=["llama", "llama-int8", "gpt2", "llama-sampled"])
def test_prompt_prefix_tokens_match_jax(model, quant, sampled, path):
    kw = dict(SERVE, prompt_prefix=PREFIX_TEXT, **({"quant_kv": quant} if quant else {}))
    if path == "per-stream":
        kw["continuous_batching"] = False
    (jcfg, jbundle, jengine), (cfg, bundle, engine, batcher) = _services(model, **kw)
    items, jitems = _items(RawItem, sampled), _items(JaxRawItem, sampled)
    run = _whole if path == "whole" else _streams
    want = asyncio.run(run(JaxBatcher(jengine, jcfg), jbundle, jitems))
    got = asyncio.run(run(batcher, bundle, items))
    if path == "whole":
        got = [g[:len(w)] for g, w in zip(got, want)]
    assert got == want
    assert any(len(g) > 1 for g in got)
    if path == "loop":
        assert batcher._cdl is not None and batcher._cdl.prefill_dispatches > 0


@pytest.mark.parametrize("knobs,model,message", [
    ({"PROMPT_PREFIX": "x"}, "t5-small", "PROMPT_PREFIX is not supported for 't5-small'"),
    ({"PREFIX_CACHE": "1"}, "t5-small", "PREFIX_CACHE is not supported for 't5-small'"),
    ({"PROMPT_PREFIX": "x"}, "bert-base", "PROMPT_PREFIX is not supported for 'bert-base'"),
    ({"PROMPT_PREFIX": "x", "PREFIX_CACHE": "1"}, "llama",
     "PREFIX_CACHE and PROMPT_PREFIX are mutually exclusive"),
    ({"PROMPT_PREFIX": "x", "PAGED_KV": "1"}, "llama",
     "PAGED_KV and PROMPT_PREFIX are mutually exclusive"),
], ids=["prefix-t5", "cache-t5", "prefix-bert", "both", "paged"])
def test_prefix_refusals_carry_the_jax_messages(knobs, model, message):
    kw = {"prompt_prefix": knobs.get("PROMPT_PREFIX"),
          "prefix_cache": knobs.get("PREFIX_CACHE") == "1",
          "paged_kv": knobs.get("PAGED_KV") == "1"}
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        with pytest.raises(ValueError) as jerr:
            jax_build_model(JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                                             seq_buckets=(16, 32), max_decode_len=12, **kw))
        with pytest.raises(ValueError) as err:
            build_service({"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0",
                           "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "12",
                           "LLAMA_CONFIG": json.dumps(SMALL), **knobs})
    finally:
        del os.environ["LLAMA_CONFIG"]
    assert message in str(jerr.value)
    assert str(err.value) == str(jerr.value)


class _SpecialsTokenizer:
    """Encodes any text to terminal specials alone (EOS, then [SEP])."""

    eos_id, sep_id = 1, 4

    def encode(self, text: str, max_len: int):
        ids = np.zeros(max_len, np.int32)
        ids[:3] = [1, 4, 1]
        mask = (np.arange(max_len) < 3).astype(np.int32)
        return ids, mask


def test_prompt_prefix_of_only_specials_raises_like_jax():
    """Terminal specials are stripped from the prefix; one of nothing else
    is refused with the JAX message."""
    from mlmicroservicetemplate_tpu.models import registry as jax_registry
    from mlmicroservicetemplate_tpu_torch.models import registry as port_registry

    cfg = JaxServiceConfig(device="cpu", model_name="llama", prompt_prefix="<eos>")
    with pytest.raises(ValueError) as jerr:
        jax_registry._attach_prompt_prefix({}, _SpecialsTokenizer(), cfg, None, 64)
    with pytest.raises(ValueError) as err:
        port_registry._attach_prompt_prefix(None, port_llama, _SpecialsTokenizer(), cfg, None,
                                            64)
    assert str(err.value) == str(jerr.value) == (
        "PROMPT_PREFIX tokenized to zero (non-special) tokens")
