"""GPT-2 in the port against the JAX package, f32 on the CPU, at a small
config (two layers, four heads of 32; the JAX ``GPTConfig`` defaults are
replaced for the test, as the port's are).

- ``lm_logits`` within 1e-4 of the JAX ``lm_logits`` on the same weights
  (carried across by ``gpt_params_from_jax``, bitwise).
- Greedy tokens identical to the JAX package's through ``greedy_generate``,
  the engine (whole generations) and the continuous loop (paged and
  contiguous), and the HTTP bodies (``/predict`` whole and ndjson,
  ``/v1/completions`` whole and SSE) identical to the JAX app's.
- ``QUANT_KV=int8`` is refused for gpt2 with the JAX package's reason (its
  int8 KV cache covers the llama family only).
- The HF map on a synthetic GPT-2 state dict: Conv1D weights reach the
  port's linear layers transposed.
- The byte-level BPE tokenizer gives the JAX one's ids on an ASCII and a
  Unicode corpus over a vocab and merges the test writes; its
  standard-library pre-tokenizer splits as GPT-2's regex does.
"""

import asyncio
import contextlib
import functools
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax
import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.convert import hf_maps as jax_hf_maps
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import tokenizer as jax_tok
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.convert import hf_maps
from mlmicroservicetemplate_tpu_torch.convert.jax_params import gpt_params_from_jax
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import tokenizer as port_tok
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service

# Small GPT-2 dims; eos/pad are the byte tokenizer's, as both registries set.
DIMS = dict(vocab_size=300, d_model=128, num_heads=4, num_layers=2, d_ff=256,
            max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
             stream_chunk_tokens=4, max_streams=4, kv_block_size=8)
PORT_SERVE = {"BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
              "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "KV_BLOCK_SIZE": "8",
              "BATCH_TIMEOUT_MS": "1"}
REQUESTS = [("hi", None), ("the quick brown fox", 3), ("serving tokens, twice", None),
            ("a", 7)]
LOG_TOL = 1e-4  # f32 logits against the JAX forward


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def small_gpt2():
    """Both packages' GPT-2 builders at ``DIMS`` (their configs default to
    GPT-2 small)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gpt, "GPTConfig", functools.partial(jax_gpt.GPTConfig, **DIMS))
        mp.setattr(port_gpt, "GPTConfig", functools.partial(port_gpt.GPTConfig, **DIMS))
        yield


def jax_service(**kw):
    with small_gpt2():
        cfg = JaxServiceConfig(device="cpu", model_name="gpt2", warmup=False,
                               batch_timeout_ms=1.0, **{**SERVE, **kw})
        bundle = jax_build_model(cfg)
    return cfg, bundle


def port_service(params, **overrides):
    with small_gpt2():
        return build_service({"MODEL_NAME": "gpt2", "DEVICE": "cpu", "WARMUP": "0",
                              **PORT_SERVE, **overrides}, params=params)


@pytest.fixture(scope="module")
def weights():
    cfg, bundle = jax_service(continuous_batching=False)
    return cfg, bundle, jax.tree.map(np.asarray, bundle.params)


def _model(params):
    cfg = port_gpt.GPTConfig(**DIMS, eos_id=1, pad_id=0)
    return cfg, port_gpt.build_model(cfg, gpt_params_from_jax(params, cfg),
                                     torch.device("cpu"), torch.float32)


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 261, (3, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    mask[2, 2:] = 0
    return ids, mask


def test_params_from_jax_are_bitwise(weights):
    _, bundle, params = weights
    cfg, model = _model(params)
    state = model.state_dict()
    assert torch.equal(state["wte.weight"],
                       torch.from_numpy(np.array(params["wte"]["embedding"])))
    assert torch.equal(state["layers.1.attn.qkv.weight"],
                       torch.from_numpy(params["layers"][1]["attn"]["qkv"]["kernel"].T.copy()))
    assert torch.equal(state["layers.0.ln2.bias"],
                       torch.from_numpy(np.array(params["layers"][0]["ln2"]["bias"])))
    with pytest.raises(KeyError, match="lack"):
        gpt_params_from_jax({**params, "wpe": {}}, cfg)


def test_logits_match_jax(weights):
    _, bundle, params = weights
    _, model = _model(params)
    ids, mask = _batch()
    want = np.asarray(jax_gpt.lm_logits(bundle.params, bundle.cfg, jnp.asarray(ids),
                                        jnp.asarray(mask)))
    with torch.inference_mode():
        got = port_gpt.lm_logits(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    keep = mask.astype(bool)
    np.testing.assert_allclose(got[keep], want[keep], atol=LOG_TOL, rtol=0)


@pytest.mark.parametrize("max_len", [6, 12])
def test_greedy_generate_matches_jax(weights, max_len):
    _, bundle, params = weights
    _, model = _model(params)
    ids, mask = _batch()
    want = np.asarray(jax_gpt.greedy_generate(bundle.params, bundle.cfg, jnp.asarray(ids),
                                              jnp.asarray(mask), max_len))
    launches = decode_attention.launches
    with torch.inference_mode():
        got = port_gpt.greedy_generate(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                       max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert decode_attention.launches == launches  # CPU: the plain version ran


def test_paged_chunks_match_contiguous(weights):
    """The paged step over a shuffled block table emits the contiguous
    step's tokens (the JAX paged step's, which equal its contiguous ones)."""
    _, _, params = weights
    _, model = _model(params)
    ids, mask = _batch()
    bs, n_steps = 8, 10
    with torch.inference_mode():
        ref = port_gpt.greedy_generate(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                       n_steps)
        state = port_gpt.init_decode_state(model, torch.from_numpy(ids),
                                           torch.from_numpy(mask), n_steps)
        t = (16 + n_steps + bs - 1) // bs
        nb = 3 * t + 2
        perm = torch.randperm(nb, generator=torch.Generator().manual_seed(1))[: 3 * t]
        table = perm.view(3, t).to(torch.int32)
        pools = []
        for c in state.cache_k + state.cache_v:
            pool = torch.zeros((nb + 1, bs) + tuple(c.shape[2:]))
            flat = pool.view((-1,) + tuple(c.shape[2:]))
            for r in range(3):
                for p in range(c.shape[1]):
                    flat[int(table[r, p // bs]) * bs + p % bs] = c[r, p]
            pools.append(pool)
        n = len(state.cache_k)
        kv_width = t * bs
        key_valid = torch.zeros(3, kv_width, dtype=torch.int32)
        key_valid[:, : state.key_valid.shape[1]] = state.key_valid[:, :kv_width]
        paged = port_gpt.PagedState(
            cache_k=pools[:n], cache_v=pools[n:], key_valid=key_valid,
            write_idx=state.write_idx, pos=state.pos, last_token=state.last_token,
            done=state.done, tokens=state.tokens, sample=state.sample)
        launches = paged_decode_attention.launches
        paged, toks = port_gpt.generate_chunk_paged(model, paged, table, bs, n_steps)
    np.testing.assert_array_equal(paged.tokens.numpy(), ref.numpy())
    assert paged_decode_attention.launches == launches


async def _submit(batcher, items):
    await batcher.start()
    try:
        return await asyncio.gather(*(batcher.submit(f) for f in items))
    finally:
        await batcher.stop()


def test_engine_rows_match_jax(weights):
    jcfg, jbundle, params = weights
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    want = jengine.run_batch([jbundle.preprocess(JaxRawItem(text=t, max_tokens=m))
                              for t, m in REQUESTS])
    cfg, bundle, engine, batcher = port_service(params)
    assert bundle.name == "gpt2" and bundle.cfg.num_kv_heads == bundle.cfg.num_heads
    assert bundle.max_prompt_len == jbundle.max_prompt_len
    got = asyncio.run(_submit(batcher, [bundle.preprocess(RawItem(text=t, max_tokens=m))
                                        for t, m in REQUESTS]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert engine.last_decode_steps == jengine.last_decode_steps


async def _streams(loop, preprocess) -> list[list[int]]:
    async def consume(gen):
        out = []
        async for chunk in gen:
            out.extend(np.asarray(chunk).tolist())
        return out

    first = await asyncio.gather(*(consume(loop.submit_stream(preprocess(t, m)))
                                   for t, m in REQUESTS[:3]))
    for _ in range(250):
        if loop._admitted == 0:
            break
        await asyncio.sleep(0.02)
    return list(first) + list(await asyncio.gather(
        *(consume(loop.submit_stream(preprocess(t, m))) for t, m in REQUESTS)))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_loop_streams_match_jax(weights, paged):
    _, _, params = weights
    jcfg, jbundle = jax_service(paged_kv=paged)
    jloop = JaxLoop(JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1))), jcfg)
    try:
        want = asyncio.run(_streams(
            jloop, lambda t, m: jbundle.preprocess(JaxRawItem(text=t, max_tokens=m))))
    finally:
        jloop.stop()
    _, bundle, engine, batcher = port_service(params, PAGED_KV="1" if paged else "0")
    loop = batcher._cdl
    try:
        got = asyncio.run(_streams(
            loop, lambda t, m: bundle.preprocess(RawItem(text=t, max_tokens=m))))
    finally:
        loop.stop()
    assert got == want
    if paged:
        assert engine.kv_pool.used_blocks == 0


def test_int8_kv_cache_is_refused_as_jax_refuses_it():
    with small_gpt2(), pytest.raises(ValueError) as want:
        jax_build_model(JaxServiceConfig(device="cpu", model_name="gpt2", warmup=False,
                                         quant_kv="int8", **SERVE))
    with pytest.raises(ValueError) as got:
        port_service(None, QUANT_KV="int8")
    assert str(got.value) == str(want.value)


async def _http(app, posts):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        return [(r.status, await r.text())
                for r in [await client.post(path, json=body) for path, body in posts]]
    finally:
        await client.close()


def _comparable(path: str, body: dict, text: str):
    if body.get("stream"):
        if path == "/predict":
            lines = [json.loads(ln) for ln in text.splitlines() if ln]
            lines[-1].pop("timing_ms")
            return lines
        return text
    answer = json.loads(text)
    answer.pop("timing_ms", None)
    return answer


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_http_bodies_match_jax(weights, paged):
    _, _, params = weights
    jcfg, jbundle = jax_service(paged_kv=paged)
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    cfg, bundle, engine, _ = port_service(params, PAGED_KV="1" if paged else "0")
    posts = [
        ("/predict", {"text": "the quick brown fox"}),
        ("/predict", {"text": "the quick brown fox", "stream": True, "max_tokens": 5}),
        ("/v1/completions", {"prompt": "hi", "max_tokens": 6}),
        ("/v1/completions", {"prompt": "hi", "stream": True,
                             "stream_options": {"include_usage": True}}),
        ("/predict", {"text": "hi", "stream": True, "temperature": 0.9, "seed": 5}),
        ("/v1/completions", {"prompt": "hi", "temperature": 0.7, "top_k": 5, "seed": 6}),
    ]
    want = asyncio.run(_http(jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)),
                             posts))
    got = asyncio.run(_http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), posts))
    for (path, body), (gs, g), (ws, w) in zip(posts, got, want):
        assert gs == ws == 200, (path, body, g)
        assert _comparable(path, body, g) == _comparable(path, body, w), (path, body)


# ---------------------------------------------------------------------------
# checkpoints and the tokenizer


def test_hf_map_transposes_conv1d_weights():
    """A synthetic HF GPT-2 state dict: the port's map gives the JAX map's
    pytree (Conv1D kept [in, out]), and the model built from it holds each
    Conv1D weight transposed into nn.Linear's [out, in]."""
    cfg = port_gpt.GPTConfig(**DIMS)
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff
    state = {"transformer.wte.weight": rng.standard_normal((cfg.vocab_size, d)),
             "transformer.wpe.weight": rng.standard_normal((cfg.max_position, d)),
             "transformer.ln_f.weight": rng.standard_normal(d),
             "transformer.ln_f.bias": rng.standard_normal(d)}
    for i in range(cfg.num_layers):
        b = f"transformer.h.{i}"
        for name, shape in (("ln_1", (d,)), ("ln_2", (d,))):
            state[f"{b}.{name}.weight"] = rng.standard_normal(shape)
            state[f"{b}.{name}.bias"] = rng.standard_normal(shape)
        for name, (n_in, n_out) in (("attn.c_attn", (d, 3 * d)), ("attn.c_proj", (d, d)),
                                    ("mlp.c_fc", (d, f)), ("mlp.c_proj", (f, d))):
            state[f"{b}.{name}.weight"] = rng.standard_normal((n_in, n_out))
            state[f"{b}.{name}.bias"] = rng.standard_normal(n_out)
    state = {k: v.astype(np.float32) for k, v in state.items()}
    tree = hf_maps.gpt2_state_to_pytree(state, cfg.num_layers)
    jtree = jax_hf_maps.gpt2_state_to_pytree(state, cfg.num_layers)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, jtree))
    got = gpt_params_from_jax(tree, cfg)
    np.testing.assert_array_equal(got["layers.1.attn.qkv.weight"].numpy(),
                                  state["transformer.h.1.attn.c_attn.weight"].T)
    np.testing.assert_array_equal(got["layers.0.mlp.down.weight"].numpy(),
                                  state["transformer.h.0.mlp.c_proj.weight"].T)
    np.testing.assert_array_equal(got["final_ln.bias"].numpy(), state["transformer.ln_f.bias"])


CORPUS = [
    "Hello world! It's a test, isn't it? We'll see: 42 apples & 7 pears.",
    "  leading spaces\tand\ttabs\n\nnew paragraphs   trailing   ",
    "naïve café, Größe, ΑΒΓ δέλτα, Ж жук, 東京タワー 123 ٣٤٥ ①②",
    "emoji 🙂🚀 mixed👍text, 'quoted' \"double\" I'M SHOUTING'S 'll 've 're 'd 'm",
    "edge\x1cseparators\x1f and nbsp em-space　ideographic  \n",
    "", " ", "'", "a'", "x  'sy", "\n\n \n",
]


def _write_bpe(tmp_path):
    """A byte-level vocab (every byte's symbol, some merges of the corpus's
    frequent pairs) and its merges file."""
    enc = port_tok._bytes_to_unicode()
    symbols = [enc[b] for b in range(256)]
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"), ("e", "r"),
              ("o", "n"), ("Ġ", "s"), ("in", "g"), ("l", "l"), ("'", "s"), ("Ã", "¯")]
    vocab = {s: i for i, s in enumerate(symbols)}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    return str(tmp_path / "vocab.json")


def test_bpe_ids_match_jax(tmp_path):
    path = _write_bpe(tmp_path)
    got, want = port_tok.build_tokenizer(path), jax_tok.build_tokenizer(path)
    assert isinstance(got, port_tok.ByteLevelBPETokenizer)
    assert (got.eos_id, got.pad_id, got.vocab_size, got.max_token_id) == \
        (want.eos_id, want.pad_id, want.vocab_size, want.max_token_id)
    for text in CORPUS:
        for max_len in (8, 256):
            g, w = got.encode(text, max_len), want.encode(text, max_len)
            np.testing.assert_array_equal(g[0], w[0], err_msg=repr(text))
            np.testing.assert_array_equal(g[1], w[1])
        ids = got.encode(text, 256)[0]
        assert got.decode(ids) == want.decode(ids) == text


def test_pretokenizer_matches_gpt2_regex():
    regex = pytest.importorskip("regex")
    pat = regex.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
    rng = np.random.default_rng(7)
    alphabet = list("ab Z9٣' \t\n\x1c !?.é東🙂s") + ["'s", "'ll", "  ", "\n\n"]
    texts = CORPUS + ["".join(rng.choice(alphabet, size=int(rng.integers(1, 30))))
                      for _ in range(300)]
    for text in texts:
        assert port_tok.gpt2_pretokenize(text) == pat.findall(text), repr(text)
