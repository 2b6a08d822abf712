"""T5 served by the port against the JAX package's service, f32 on the CPU,
at a small config (two layers, d_model 64, four heads of 16, vocab 512;
both packages' ``T5Config`` defaults are replaced for the test) with an
untied random head added to the JAX init's weights, which the port takes
through ``build_service(params=...)``.

- Engine rows (greedy, and seeded sampled) identical to the JAX engine's,
  with the same decode steps.
- Streams through the continuous loop identical to the JAX loop's.
- ``/predict`` (whole and ndjson), ``/v1/completions`` (whole and SSE),
  ``/v1/chat/completions`` (whole and SSE) and ``/v1/models`` bodies
  identical to the JAX app's.
- A prompt longer than the largest seq bucket, and every stream under
  ``CONTINUOUS_BATCHING=0``, stream the JAX tokens through
  ``InferenceEngine.generate_stream`` (the loop admits none of them);
  ``MAX_STREAMS`` caps both paths together.
- Through the graph path (the CPU stand-in capturer of
  ``tests/test_torch_graphs.py``): whole, loop and per-stream tokens equal
  the JAX package's, also when another dispatch of the stream's bucket
  overwrites the bucket's static state between two of its chunks.
- ``PAGED_KV=1`` and ``QUANT_KV=int8`` raise for t5 with the JAX package's
  reasons.
"""

import asyncio
import contextlib
import functools
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_graphs import _with_graphs

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models import t5 as jax_t5
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import t5 as port_t5
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher, QueueFullError
from mlmicroservicetemplate_tpu_torch.serve import build_service

DIMS = dict(vocab_size=512, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_layers=2)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=12,
             stream_chunk_tokens=4, max_streams=4)
PORT_SERVE = {"BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "12",
              "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "BATCH_TIMEOUT_MS": "1"}
# (text, max_tokens, sampling): prompts in both seq buckets, budgets, and
# seeded sampled rows beside greedy ones.
REQUESTS = [("hi", None, {}), ("the quick brown fox", 3, {}),
            ("serving tokens, twice", None, dict(temperature=0.8, seed=1)),
            ("a", 7, dict(temperature=1.2, top_k=40, top_p=0.9, seed=2))]
# 47 bytes + EOS: past the largest seq bucket (32), within T5's 512 cap.
LONG = "a prompt longer than the largest seq bucket is!"
LM_HEAD = jax.random.normal(jax.random.PRNGKey(99), (DIMS["d_model"], DIMS["vocab_size"]))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def small_t5():
    """Both packages' T5 builders at ``DIMS`` (their configs default to
    T5-small)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_t5, "T5Config", functools.partial(jax_t5.T5Config, **DIMS))
        mp.setattr(port_t5, "T5Config", functools.partial(port_t5.T5Config, **DIMS))
        yield


def jax_service(**kw):
    """The JAX config, bundle (with the untied head) and engine."""
    with small_t5():
        cfg = JaxServiceConfig(device="cpu", model_name="t5-small", warmup=False,
                               batch_timeout_ms=1.0, **{**SERVE, **kw})
        bundle = jax_build_model(cfg)
    bundle.params["lm_head"] = {"kernel": LM_HEAD}
    return cfg, bundle, JaxEngine(bundle, cfg, ReplicaSet(make_mesh(1)))


def port_service(params, **overrides):
    with small_t5():
        return build_service({"MODEL_NAME": "t5-small", "DEVICE": "cpu", "WARMUP": "0",
                              **PORT_SERVE, **overrides}, params=params)


@pytest.fixture(scope="module")
def weights():
    _, bundle, _ = jax_service()
    return jax.tree.map(np.asarray, bundle.params)


def _items(raw, requests=REQUESTS):
    return [raw(text=t, max_tokens=m, **kw) for t, m, kw in requests]


def test_engine_rows_match_jax(weights):
    jcfg, jbundle, jengine = jax_service(continuous_batching=False)
    want = jengine.run_batch([jbundle.preprocess(i) for i in _items(JaxRawItem)])
    cfg, bundle, engine, _ = port_service(weights)
    assert bundle.name == "t5-small" and bundle.max_prompt_len == 512
    assert isinstance(bundle.model, port_t5.T5Model) and bundle.model.lm_head is not None
    launches = fused_attention.launches
    got = engine.run_batch([bundle.preprocess(i) for i in _items(RawItem)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert engine.last_decode_steps == jengine.last_decode_steps
    assert fused_attention.launches == launches  # CPU: the plain version ran
    assert len({int(t) for row in got for t in row}) > 5  # not a locked argmax


async def _settled(idle, seconds: float = 10.0) -> None:
    """Wait until ``idle()``: a stream's place is freed by its worker (or
    loop) just after the consumer reads its last chunk."""
    for _ in range(int(seconds / 0.01)):
        if idle():
            return
        await asyncio.sleep(0.01)


async def _streams(submit, waves, idle=lambda: True) -> list[list[int]]:
    async def consume(gen):
        out = []
        async for chunk in gen:
            out.extend(np.asarray(chunk).tolist())
        return out

    out = []
    for wave in waves:
        await _settled(idle)  # the previous wave's places
        out += await asyncio.gather(*(consume(submit(f)) for f in wave))
    return out


def test_loop_streams_match_jax(weights):
    jcfg, jbundle, jengine = jax_service()
    jloop = JaxLoop(jengine, jcfg)
    jfeats = [jbundle.preprocess(i) for i in _items(JaxRawItem)]
    try:
        want = asyncio.run(_streams(jloop.submit_stream, [jfeats[:3], jfeats],
                                    idle=lambda: jloop._admitted == 0))
    finally:
        jloop.stop()
    _, bundle, engine, batcher = port_service(weights)
    loop = batcher._cdl
    feats = [bundle.preprocess(i) for i in _items(RawItem)]
    try:
        got = asyncio.run(_streams(batcher.submit_stream, [feats[:3], feats],
                                   idle=lambda: loop.admitted == 0))
    finally:
        loop.stop()
    assert got == want
    assert loop.prefill_dispatches >= 2 and isinstance(loop._state, port_t5.T5State)
    # The slot state: self caches MAX_DECODE_LEN wide, cross K/V and the
    # encoder mask as wide as the largest seq bucket.
    st = loop._state
    assert st.cache_k[0].shape == (4, 12, DIMS["num_heads"], DIMS["d_kv"])
    assert st.cross_k[0].shape == (4, 32, DIMS["num_heads"], DIMS["d_kv"])
    assert st.enc_mask.shape == (4, 32)


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
            r = await (client.get(path) if body is None else client.post(path, json=body))
            out.append((r.status, await r.text()))
        return out
    finally:
        await client.close()


def _comparable(path: str, body: dict | None, text: str):
    if body is not None and body.get("stream"):
        if path == "/predict":
            lines = [json.loads(ln) for ln in text.splitlines() if ln]
            lines[-1].pop("timing_ms")
            return lines
        return text
    answer = json.loads(text)
    answer.pop("timing_ms", None)
    for entry in answer.get("data", []):
        assert isinstance(entry.pop("created"), int)  # each app's own start time
    return answer


def test_http_bodies_match_jax(weights):
    jcfg, jbundle, jengine = jax_service()
    cfg, bundle, engine, _ = port_service(weights)
    chat = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
    posts = [
        ("/predict", {"text": "the quick brown fox"}),
        ("/predict", {"text": "the quick brown fox", "stream": True, "max_tokens": 5}),
        ("/predict", {"text": "hi", "stream": True, "temperature": 0.9, "seed": 5}),
        ("/v1/completions", {"prompt": "hi", "max_tokens": 6, "stop": ["zz"]}),
        ("/v1/completions", {"prompt": "hi", "stream": True,
                             "stream_options": {"include_usage": True}}),
        ("/v1/completions", {"prompt": "hi", "temperature": 0.7, "top_k": 5, "seed": 6}),
        ("/v1/chat/completions", {"messages": chat, "max_tokens": 7}),
        ("/v1/chat/completions", {"messages": chat, "stream": True, "temperature": 1.1,
                                  "seed": 8}),
        ("/v1/models", None),
    ]
    want = asyncio.run(_http(jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)),
                             posts))
    got = asyncio.run(_http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), posts))
    for (path, body), (gs, g), (ws, w) in zip(posts, got, want):
        assert gs == ws == 200, (path, body, g)
        assert _comparable(path, body, g) == _comparable(path, body, w), (path, body)


async def _batcher_streams(batcher, feats):
    await batcher.start()
    try:
        out = await _streams(batcher.submit_stream, [feats])
        await _settled(lambda: batcher._active_streams == 0 and (
            batcher._cdl is None or batcher._cdl._admitted == 0))
        return out
    finally:
        await batcher.stop()


@pytest.mark.parametrize("continuous", [True, False], ids=["oversized", "loop-off"])
def test_per_stream_path_matches_jax(weights, continuous):
    """An oversized prompt (any setting) and, under CONTINUOUS_BATCHING=0,
    every stream take the per-stream path in both packages."""
    # MAX_STREAMS (4) streams at once, across both paths.
    requests = REQUESTS[1:3] + [(LONG, None, {}), (LONG, 5, dict(temperature=0.9, seed=4))]
    jcfg, jbundle, jengine = jax_service(continuous_batching=continuous)
    want = asyncio.run(_batcher_streams(JaxBatcher(jengine, jcfg),
                                        [jbundle.preprocess(i) for i in _items(JaxRawItem,
                                                                               requests)]))
    cfg, bundle, engine, batcher = port_service(
        weights, CONTINUOUS_BATCHING="1" if continuous else "0")
    assert (batcher._cdl is not None) == continuous == cfg.continuous_batching
    feats = [bundle.preprocess(i) for i in _items(RawItem, requests)]
    assert int(feats[-1]["length"]) == len(LONG) + 1 > 32
    dispatches = engine.dispatches
    got = asyncio.run(_batcher_streams(batcher, feats))
    assert got == want
    per_stream = 2 if continuous else len(requests)
    assert engine.dispatches - dispatches == per_stream  # one generate_stream each
    if continuous:
        assert batcher._cdl.prefill_dispatches >= 1 and batcher._cdl.admitted == 0
    assert batcher._active_streams == 0


def test_max_streams_counts_both_paths(weights):
    """MAX_STREAMS caps the per-stream path's streams and the loop's
    together: with one oversized stream running, a short prompt sheds."""
    _, bundle, engine, batcher = port_service(weights, MAX_STREAMS="1")
    long_f, short_f = (bundle.preprocess(RawItem(text=t)) for t in (LONG, "hi"))

    async def drive():
        await batcher.start()
        try:
            first = batcher.submit_stream(long_f)
            with pytest.raises(QueueFullError):
                batcher.submit_stream(short_f)
            with pytest.raises(QueueFullError):
                batcher.submit_stream(long_f)
            toks = [t async for chunk in first for t in np.asarray(chunk).tolist()]
            await _settled(lambda: batcher._active_streams == 0)
            return toks
        finally:
            await batcher.stop()

    toks = asyncio.run(drive())
    want = np.concatenate(list(engine.generate_stream(long_f))).tolist()
    assert toks == want and batcher._active_streams == 0


def test_graph_path_matches_jax(weights):
    """Whole generations, the loop's chunk and the per-stream path through
    the graph path's dispatch (stand-in capturer): the JAX tokens.  A
    dispatch of the stream's own bucket between two of its chunks
    overwrites the bucket's static state; the stream's own copy keeps its
    tokens."""
    jcfg, jbundle, jengine = jax_service()
    jfeats = [jbundle.preprocess(i) for i in _items(JaxRawItem)]
    want_rows = jengine.run_batch(jfeats)
    want_stream = [np.concatenate(list(jengine.generate_stream(f))).tolist() for f in jfeats]
    _, bundle, engine, batcher = port_service(weights)
    cache = _with_graphs(engine)
    feats = [bundle.preprocess(i) for i in _items(RawItem)]
    for g, w in zip(engine.run_batch(feats), want_rows):
        np.testing.assert_array_equal(g, w)
    stream = engine.generate_stream(feats[2])
    got = list(next(stream))
    engine.run_batch([feats[0]])  # the same (1, 16) bucket, another request
    got += [t for chunk in stream for t in chunk.tolist()]
    assert got == want_stream[2]
    kinds = {e.kind for e in cache.entries(bundle)}
    assert {"start", "gen_chunk"} <= kinds
    try:
        loop_toks = asyncio.run(_streams(batcher.submit_stream, [feats]))
    finally:
        batcher._cdl.stop()
    assert loop_toks == want_stream
    assert "loop_chunk" in {e.kind for e in cache.entries(bundle)}


def test_long_prompts_share_one_width(weights):
    """Prompts past the largest seq bucket are served at their length
    rounded up to a multiple of 128 (at most T5's 512 cap): two of
    different lengths share one width, and so one ``start`` and one
    ``gen_chunk`` graph, and stream the JAX tokens, which the JAX package
    computes at each prompt's own width."""
    texts = [LONG[:40], LONG]
    jcfg, jbundle, jengine = jax_service()
    want = [np.concatenate(list(jengine.generate_stream(jbundle.preprocess(JaxRawItem(text=t)))))
            .tolist() for t in texts]
    _, bundle, engine, _ = port_service(weights)
    assert [engine.stream_width(n) for n in (16, 32, 33, 129, 500, 512)] == \
        [16, 32, 128, 256, 512, 512]
    cache = _with_graphs(engine)
    feats = [bundle.preprocess(RawItem(text=t)) for t in texts]
    assert len({int(f["length"]) for f in feats}) == 2
    got, inserts = [], []
    for f in feats:
        # Read each chunk as it comes: the stand-in's tokens are the graph's.
        got.append([t for chunk in engine.generate_stream(f) for t in chunk.tolist()])
        inserts.append(cache.stats()["insert"])
    assert got == want
    assert inserts[0] == 2 and inserts[1] == inserts[0]  # start and gen_chunk, once
    assert {k[2][:2] for k in cache._entries} == {(1, 128)}


@pytest.mark.parametrize("knob", [dict(paged_kv=True), dict(quant_kv="int8")],
                         ids=["PAGED_KV", "QUANT_KV"])
def test_kv_layouts_refused_as_jax_refuses_them(knob):
    with small_t5(), pytest.raises(ValueError) as want:
        jax_build_model(JaxServiceConfig(device="cpu", model_name="t5-small", warmup=False,
                                         **SERVE, **knob))
    env = {"PAGED_KV": "1"} if "paged_kv" in knob else {"QUANT_KV": "int8"}
    with pytest.raises(ValueError) as got:
        port_service(None, **env)
    assert str(got.value) == str(want.value)

