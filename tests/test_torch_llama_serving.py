"""The llama slice end to end on the CPU: the JAX package's llama service
and the port's, on the same weights (the JAX params carried across by
``llama_params_from_jax``) and the same buckets, at a small config.

- The port's ``Batcher.submit`` gives the token rows of the JAX
  ``InferenceEngine.run_batch``, per-request ``max_tokens`` budgets
  included, with a dense and with an int8 KV cache (f32: identical).
- HTTP ``/predict`` and ``/v1/completions`` answer with the fields and
  values of the JAX handlers for the same bodies.
- Seeded sampled requests, whole and streamed, get the JAX app's answer.
- What the port does not serve yet (the knobs of later slices) is an
  error, never a quiet answer without it.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
             stream_chunk_tokens=4)
# (text, max_tokens): one batch of four, prompts in both seq buckets.
REQUESTS = [("hi", None), ("the quick brown fox", 3), ("serving tokens, twice", None),
            ("a", 7)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_service(quant: bool):
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        cfg = JaxServiceConfig(
            device="cpu", model_name="llama", warmup=False, continuous_batching=False,
            batch_timeout_ms=1.0, quant_kv="int8" if quant else None, **SERVE,
        )
        bundle = jax_build_model(cfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    return cfg, bundle, JaxEngine(bundle, cfg, ReplicaSet(make_mesh(1)))


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "int8"])
def services(request):
    quant = request.param
    jcfg, jbundle, jengine = _jax_service(quant)
    params = jax.tree.map(np.asarray, jbundle.params)
    overrides = {
        "MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
        "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
        "STREAM_CHUNK_TOKENS": "4", "BATCH_TIMEOUT_MS": "1",
    }
    if quant:
        overrides["QUANT_KV"] = "int8"
    port = build_service(overrides, params=params)
    return (jcfg, jbundle, jengine), port


async def _submit_all(batcher, bundle):
    await batcher.start()
    try:
        feats = [bundle.preprocess(RawItem(text=t, max_tokens=m)) for t, m in REQUESTS]
        return await asyncio.gather(*(batcher.submit(f) for f in feats))
    finally:
        await batcher.stop()


def test_batcher_rows_match_jax_run_batch(services):
    (_, jbundle, jengine), (cfg, bundle, engine, batcher) = services
    assert bundle.cfg.kv_quant == jbundle.cfg.kv_quant
    assert bundle.max_prompt_len == jbundle.max_prompt_len == 128 - 12
    want = jengine.run_batch(
        [jbundle.preprocess(JaxRawItem(text=t, max_tokens=m)) for t, m in REQUESTS]
    )
    launches = decode_attention.launches
    got = asyncio.run(_submit_all(batcher, bundle))
    assert decode_attention.launches == launches  # CPU: the plain version ran
    assert engine.decode_steps > 0 and engine.decode_steps % cfg.stream_chunk_tokens == 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (engine.max_decode_len,)
        np.testing.assert_array_equal(g, w)
    # A budget stops a row at the next chunk boundary: pad after it.
    assert (got[1][4:] == bundle.cfg.pad_id).all()
    assert jengine.last_decode_steps == engine.last_decode_steps


async def _http(app, posts):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        out = []
        for path, body in posts:
            resp = await client.post(path, json=body)
            out.append((resp.status, await resp.json() if resp.status == 200 else None))
        return out
    finally:
        await client.close()


def test_http_matches_the_jax_handlers(services):
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = services
    full = jengine.run_batch([jbundle.preprocess(JaxRawItem(text="the quick brown fox"))])[0]
    text = jbundle.postprocess(full)["prediction"]["text"]
    stop = [text[3:5]] if len(text) >= 5 else ["zz"]
    posts = [
        ("/predict", {"text": "the quick brown fox"}),
        ("/predict", {"text": "the quick brown fox", "max_tokens": 4}),
        ("/predict", {"text": "the quick brown fox", "stop": stop}),
        ("/v1/completions", {"prompt": "the quick brown fox"}),
        ("/v1/completions", {"prompt": ["the quick brown fox"], "max_tokens": 3}),
        ("/v1/completions", {"prompt": "the quick brown fox", "stop": stop}),
        ("/v1/completions", {"prompt": "hi", "max_tokens": 64}),
    ]
    want = asyncio.run(_http(jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)),
                             posts))
    got = asyncio.run(_http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), posts))
    for (path, body), (gs, g), (ws, w) in zip(posts, got, want):
        assert gs == ws == 200, (path, body)
        if path == "/predict":
            assert g["prediction"] == w["prediction"] and g["model"] == w["model"]
        else:
            for key in ("object", "model", "choices", "usage"):
                assert g[key] == w[key], (path, body, key)


async def _http_text(app, posts):
    """(status, body text) per post: ndjson and SSE bodies too."""
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
    """A 200's body without its timing: JSON, ndjson lines or SSE frames."""
    if body.get("stream"):
        if path == "/predict":
            lines = [json.loads(ln) for ln in text.splitlines() if ln]
            lines[-1].pop("timing_ms")
            return lines
        return [f for f in text.split("\n\n") if f]
    answer = json.loads(text)
    answer.pop("timing_ms", None)
    return answer


@pytest.mark.parametrize(
    "path,body",
    [
        ("/predict", {"text": "hi", "stream": True, "temperature": 0.7, "seed": 3}),
        ("/predict", {"text": "hi", "temperature": 0.7, "top_k": 40, "seed": 4}),
        ("/v1/completions", {"prompt": "hi", "stream": True, "temperature": 0.7,
                             "top_p": 0.9, "seed": 5}),
        ("/v1/completions", {"prompt": "hi", "temperature": 1.0, "seed": 6}),
        ("/v1/completions", {"prompt": "hi", "n": 2}),
        ("/v1/completions", {"prompt": ""}),
        ("/predict", {"text": "hi", "max_tokens": 0}),
    ],
)
def test_unported_requests_answer_400(services, path, body):
    """What the port does not serve answers 400 and dispatches nothing.
    Sampling (the first four bodies, answered 400 until it was ported) is
    served now, whole and streamed: seeded, the JAX app's very answer."""
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = services
    dispatches = engine.dispatches
    ((status, text),) = asyncio.run(_http_text(
        build_app(cfg, bundle, engine, Batcher(engine, cfg)), [(path, body)]))
    if not body.get("temperature"):
        assert status == 400
        assert engine.dispatches == dispatches + 1  # the readiness canary, nothing else
        return
    ((jstatus, jtext),) = asyncio.run(_http_text(
        jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)), [(path, body)]))
    assert status == jstatus == 200, text
    assert _comparable(path, body, text) == _comparable(path, body, jtext)


@pytest.mark.parametrize(
    "knob",
    [
        {"PROMPT_PREFIX": "You are a helpful"}, {"PREFIX_CACHE": "1"},
        {"SPEC_DECODE": "ngram"}, {"KV_BUDGET_MB": "64"}, {"PREFILL_CHUNK": "64"},
        {"DECODE_WINDOW": "4"}, {"TP": "2"}, {"QUANTIZE": "int8"},
        {"ADAPTER_DIR": "/adapters"}, {"TOKENIZER_PATH": "tokenizer.model"},
        {"LLAMA_CONFIG": json.dumps({**SMALL, "pallas_decode": True})},
        {"CONTINUOUS_BATCHING": "0"}, {"STREAM_PIPELINE": "2"},
    ],
    ids=lambda k: next(iter(k)),
)
def test_unported_knobs_raise(knob, tmp_path):
    """Knobs the port does not serve raise "not ported".  Three it once
    refused serve now, and their cases pin what the JAX package does: a
    SentencePiece ``TOKENIZER_PATH`` loads with a leading <s> and no
    trailing </s> (the model's eos/pad the tokenizer's),
    ``CONTINUOUS_BATCHING=0`` builds no loop and streams every request on
    the per-stream path, with the JAX batcher's tokens, and
    ``KV_BUDGET_MB`` is the admission budget and, paged, sizes the pool to
    the JAX engine's blocks."""
    name = next(iter(knob))
    overrides = {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0",
                 "LLAMA_CONFIG": json.dumps(SMALL), **knob}
    if name == "TOKENIZER_PATH":
        from mlmicroservicetemplate_tpu.models.sentencepiece import MODEL_BPE, write_spiece_model
        from test_sentencepiece import _bpe_fixture

        path = str(tmp_path / knob[name])
        write_spiece_model(path, _bpe_fixture()[0], model_type=MODEL_BPE)
        os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
        try:
            jbundle = jax_build_model(JaxServiceConfig(
                device="cpu", model_name="llama", warmup=False, tokenizer_path=path, **SERVE))
        finally:
            del os.environ["LLAMA_CONFIG"]
        _, bundle, _, _ = build_service({**overrides, name: path, "SEQ_BUCKETS": "16,32",
                                         "MAX_DECODE_LEN": "10"})
        assert (bundle.cfg.eos_id, bundle.cfg.pad_id) == (jbundle.cfg.eos_id, jbundle.cfg.pad_id)
        for text in ("hello world", "the quick world"):
            got = bundle.preprocess(RawItem(text=text))
            want = jbundle.preprocess(JaxRawItem(text=text))
            np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        assert int(got["input_ids"][0]) == bundle.tokenizer.bos_id
        return
    if name == "CONTINUOUS_BATCHING":
        jcfg, jbundle, jengine = _jax_service(quant=False)
        _, bundle, engine, batcher = build_service(
            {**overrides, "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
             "STREAM_CHUNK_TOKENS": "4"}, params=jax.tree.map(np.asarray, jbundle.params))
        assert batcher._cdl is None
        want = asyncio.run(_stream_all(JaxBatcher(jengine, jcfg), jbundle, JaxRawItem))
        got = asyncio.run(_stream_all(batcher, bundle, RawItem))
        assert got == want and engine.dispatches == len(REQUESTS)
        return
    if name == "KV_BUDGET_MB":
        extra = {"PAGED_KV": "1", "KV_BLOCK_SIZE": "8", "SEQ_BUCKETS": "16,32",
                 "MAX_DECODE_LEN": "10"}
        _, _, engine, batcher = build_service({**overrides, **extra})
        os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
        try:
            jcfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False,
                                    paged_kv=True, kv_block_size=8, kv_budget_mb=64.0,
                                    **SERVE)
            jengine = JaxEngine(jax_build_model(jcfg), jcfg, ReplicaSet(make_mesh(1)))
        finally:
            del os.environ["LLAMA_CONFIG"]
        assert batcher.admission.kv_budget_bytes == 64_000_000
        assert (engine.kv_pool.num_blocks, engine.kv_pool.block_bytes) == (
            jengine.kv_pool.num_blocks, jengine.kv_pool.block_bytes)
        return
    with pytest.raises(ValueError, match="not ported"):
        build_service(overrides)


async def _stream_all(batcher, bundle, item_cls):
    """Every request of ``REQUESTS`` streamed at once through the batcher."""
    async def one(f):
        return [t async for chunk in batcher.submit_stream(f) for t in np.asarray(chunk).tolist()]

    await batcher.start()
    try:
        return await asyncio.gather(*(one(bundle.preprocess(item_cls(text=t, max_tokens=m)))
                                      for t, m in REQUESTS))
    finally:
        await batcher.stop()


def test_knobs_left_off_and_aliases_build():
    _, bundle, engine, _ = build_service({
        "MODEL_NAME": "tinyllama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
        "PAGED_KV": "0", "DECODE_WINDOW": "1", "TP": "1", "SEQ_BUCKETS": "16",
    })
    assert bundle.name == "llama" and bundle.cfg.eos_id == bundle.tokenizer.eos_id == 1
    assert engine.max_decode_len == 64
    with pytest.raises(ValueError, match="QUANT_KV"):
        build_service({"MODEL_NAME": "bert-base", "DEVICE": "cpu", "QUANT_KV": "int8"})
    with pytest.raises(ValueError, match="SEQ_BUCKETS"):
        build_service({"MODEL_NAME": "llama", "DEVICE": "cpu", "LLAMA_CONFIG": json.dumps(SMALL),
                       "SEQ_BUCKETS": "16,96"})


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        build_service({"DEVICE": "cuda", "MODEL_NAME": "llama",
                       "LLAMA_CONFIG": json.dumps(SMALL)})
