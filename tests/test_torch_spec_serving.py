"""``SPEC_DECODE=ngram`` through the port's engine, batcher and app against
the JAX package's on the same weights, f32 on the CPU at small widths
(GPT-2, llama and T5 with an untied head): the per-stream speculative
stream (``_spec_stream``) chunk for chunk, greedy and seeded sampled, its
budgets, the non-streaming ``full_spec`` rows and decode steps, a
prefix-cache hit, the routing gates (the batcher's ``spec_route``, the
engine's live-stream gate, ``SPEC_SAMPLED=0``), HTTP bodies, and every
refusal's message."""

import asyncio
import contextlib
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_gpt import _comparable, small_gpt2
from test_torch_t5_serving import LM_HEAD, small_t5

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils.config import load_config as jax_load_config
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.serve import build_service

LLAMA = dict(vocab_size=300, d_model=64, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=128, max_position=128)
SERVE = {"SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "16", "STREAM_CHUNK_TOKENS": "4",
         "MAX_STREAMS": "4", "BATCH_BUCKETS": "1,2,4", "BATCH_TIMEOUT_MS": "1",
         "SPEC_K": "4"}
MODELS = ["gpt2", "llama", "t5-small"]
# Quoting prompts (real n-gram matches) and a plain one.
TEXTS = ["abcabcabcabcabc", "the cat sat on the mat, the cat", "hi"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _small(model: str):
    if model == "t5-small":
        with small_t5():
            yield
    elif model == "gpt2":
        with small_gpt2():
            yield
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
            yield


def services(model: str, **env):
    """The JAX (cfg, bundle, engine) and the port's (cfg, bundle, engine,
    batcher) of ``model`` under the same env, on the JAX bundle's
    weights."""
    env = {"DEVICE": "cpu", "MODEL_NAME": model, "WARMUP": "0", **SERVE, **env}
    if model == "llama":
        env["LLAMA_CONFIG"] = json.dumps(LLAMA)
    with _small(model):
        jcfg = jax_load_config({**env, "REPLICAS": "1"})
        jbundle = jax_build_model(jcfg)
        if model == "t5-small":
            jbundle.params["lm_head"] = {"kernel": LM_HEAD}  # a tied random head locks
        if model == "gpt2":
            # GPT-2's head is tied: at its random init every prompt, which ends
            # in EOS, argmax-locks onto EOS.  Stronger MLPs part the hidden
            # states from the embedding.
            jbundle.params = jax.tree.map(np.asarray, jbundle.params)
            for layer in jbundle.params["layers"]:
                for name in ("up", "down"):
                    layer["mlp"][name]["kernel"] = layer["mlp"][name]["kernel"] * 4.0
        jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
        port = build_service(env, params=jax.tree.map(np.asarray, jbundle.params))
    return (jcfg, jbundle, jengine), port


def _feats(bundle, item_cls, text, **kw):
    return bundle.preprocess(item_cls(text=text, **kw))


def _chunks(gen) -> list[list[int]]:
    return [np.asarray(c).tolist() for c in gen]


@pytest.mark.parametrize("model", MODELS)
def test_spec_stream_matches_jax(model):
    """The per-stream speculative path chunk for chunk (the counts of each
    verify chunk included), greedy and seeded sampled, and the greedy
    tokens equal to the non-speculative stream's."""
    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        model, SPEC_DECODE="ngram", CONTINUOUS_BATCHING="0")
    (_, _, off, _) = services(model, CONTINUOUS_BATCHING="0")[1]
    assert engine.spec_enabled and engine.spec_sampled
    for text in TEXTS:
        for kw in ({}, {"temperature": 0.8, "seed": 7}, {"temperature": 1.1, "top_k": 5,
                                                         "seed": 3}):
            got = _chunks(engine.generate_stream(_feats(bundle, RawItem, text, **kw)))
            want = _chunks(jengine.generate_stream(_feats(jbundle, JaxRawItem, text, **kw)))
            assert got == want, (text, kw)
            if not kw:
                plain = sum(_chunks(off.generate_stream(_feats(bundle, RawItem, text))), [])
                flat = sum(got, [])
                assert flat == plain[:len(flat)]
    assert engine.spec_rounds > 0 and engine.decode_steps == 0


def test_spec_stream_budgets():
    """max_tokens below one dispatch's yield: one chunk; the server budget
    is never passed (JAX's tests)."""
    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        "gpt2", SPEC_DECODE="ngram", CONTINUOUS_BATCHING="0", MAX_DECODE_LEN="12")
    for kw in ({"max_tokens": 3}, {}, {"max_tokens": 9}):
        got = _chunks(engine.generate_stream(_feats(bundle, RawItem, "abababababab", **kw)))
        want = _chunks(jengine.generate_stream(_feats(jbundle, JaxRawItem, "abababababab",
                                                      **kw)))
        assert got == want
        assert sum(len(c) for c in got) <= kw.get("max_tokens", 12)
        if kw.get("max_tokens") == 3:
            assert len(got) == 1


def test_spec_sampled_off_streams_the_plain_path():
    """SPEC_SAMPLED=0: a seeded sampled stream takes the non-speculative
    chunks (the JAX engine's tokens), a greedy one still speculates."""
    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        "gpt2", SPEC_DECODE="ngram", SPEC_SAMPLED="0", CONTINUOUS_BATCHING="0")
    assert engine.spec_enabled and not engine.spec_sampled
    kw = {"temperature": 1.0, "seed": 9}
    got = _chunks(engine.generate_stream(_feats(bundle, RawItem, "ababab", **kw)))
    want = _chunks(jengine.generate_stream(_feats(jbundle, JaxRawItem, "ababab", **kw)))
    assert got == want and engine.spec_rounds == 0 and engine.decode_steps > 0
    _chunks(engine.generate_stream(_feats(bundle, RawItem, "ababab")))
    assert engine.spec_rounds > 0


def test_live_streams_gate():
    """With another per-stream stream live (SPEC_MAX_STREAMS=1), a stream
    does not speculate: the JAX engine's gate, same tokens."""
    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        "gpt2", SPEC_DECODE="ngram", CONTINUOUS_BATCHING="0")
    engine._live_streams = jengine._live_streams = 1
    got = _chunks(engine.generate_stream(_feats(bundle, RawItem, "abcabcabc")))
    want = _chunks(jengine.generate_stream(_feats(jbundle, JaxRawItem, "abcabcabc")))
    assert got == want
    assert engine.spec_rounds == 0 and engine._live_streams == 1


@pytest.mark.parametrize("model", MODELS)
def test_full_spec_matches_jax(model):
    """Non-streaming batches of at most SPEC_MAX_STREAMS rows run capped
    verify rounds: rows and decode steps (the state's ``pos.max()``) equal
    JAX's, greedy, seeded sampled, and two rows with a max_tokens cap."""
    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        model, SPEC_DECODE="ngram", SPEC_MAX_STREAMS="2")
    batches = [
        [dict(text="abcabcabcabc")],
        [dict(text="the cat sat on the mat, the cat", temperature=0.9, seed=4)],
        [dict(text="xyxyxyxyxy", max_tokens=3), dict(text="hello hello hello")],
    ]
    for items in batches:
        got = engine.run_batch([_feats(bundle, RawItem, **it) for it in items])
        want = jengine.run_batch([_feats(jbundle, JaxRawItem, **it) for it in items])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert engine.last_decode_steps == jengine.last_decode_steps
    assert engine.spec_rounds > 0 and engine.decode_steps == 0
    # Three rows pass SPEC_MAX_STREAMS: the chunked path.
    rows = engine.run_batch([_feats(bundle, RawItem, "hi")] * 3)
    np.testing.assert_array_equal(
        rows[0], np.asarray(jengine.run_batch([_feats(jbundle, JaxRawItem, "hi")] * 3)[0]))
    assert engine.decode_steps > 0


def test_spec_prefix_cache_hit_matches_jax():
    """SPEC_DECODE with PREFIX_CACHE on the per-stream path: the first
    prompt donates its 16-token prefix, the second hits it, prefills its
    suffix and drafts from the whole prompt; chunks and the cache's counts
    equal JAX's."""
    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        "gpt2", SPEC_DECODE="ngram", PREFIX_CACHE="1", CONTINUOUS_BATCHING="0")
    shared = "abcdabcdabcdabcd"
    for text in (shared + "xyz", shared + "abcdab", shared + "qq"):
        got = _chunks(engine.generate_stream(_feats(bundle, RawItem, text)))
        want = _chunks(jengine.generate_stream(_feats(jbundle, JaxRawItem, text)))
        assert got == want, text
    assert engine.prefix_cache.stats() == jengine.prefix_cache.stats()
    assert engine.prefix_cache.stats()["hits"] >= 2


async def _consume(gen, batcher=None) -> list[int]:
    """A stream's tokens; with ``batcher``, once its per-stream worker has
    released its place too (the release rides the worker's future)."""
    out = [t async for c in gen for t in np.asarray(c).tolist()]
    for _ in range(200):
        if batcher is None or batcher._active_streams == 0:
            break
        await asyncio.sleep(0.01)
    return out


def test_batcher_spec_route():
    """The JAX batcher's routing: an idle greedy stream takes the
    speculative per-stream path (the loop prefills nothing); with
    SPEC_SAMPLED=0 a sampled one takes the loop; by default a sampled one
    speculates too."""
    for sampled_on in (False, True):
        _, (_, bundle, engine, batcher) = services(
            "gpt2", SPEC_DECODE="ngram", SPEC_SAMPLED="1" if sampled_on else "0",
            MAX_DECODE_LEN="8")

        async def body():
            await batcher.start()
            try:
                await _consume(batcher.submit_stream(_feats(bundle, RawItem, "ab")), batcher)
                assert batcher._cdl.prefill_dispatches == 0
                await _consume(batcher.submit_stream(
                    _feats(bundle, RawItem, "ab", temperature=1.0, seed=1)))
                assert batcher._cdl.prefill_dispatches == (0 if sampled_on else 1)
            finally:
                await batcher.stop()

        asyncio.run(body())
        assert engine.spec_rounds > 0


def test_batcher_spec_route_under_load():
    """SPEC_MAX_STREAMS=1 with a stream admitted in the loop: the next
    greedy stream joins the loop (one batched dispatch beats serialized
    speculative streams)."""
    _, (_, bundle, engine, batcher) = services("gpt2", SPEC_DECODE="ngram")
    batcher._active_streams = 1  # a per-stream stream live
    before = engine.spec_rounds

    async def body():
        await batcher.start()
        try:
            await _consume(batcher.submit_stream(_feats(bundle, RawItem, "abab")))
        finally:
            await batcher.stop()

    asyncio.run(body())
    batcher._active_streams = 0
    assert batcher._cdl.prefill_dispatches == 1 and engine.spec_rounds == before


async def _http_settled(app, batcher, posts):
    """``_http``'s posts, each after the last one's stream released its
    place: a stream's place frees when its worker ends, after its body, and
    the routing of the next one (speculative or not) reads that count."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        out = []
        for path, body in posts:
            for _ in range(400):
                loop = batcher._cdl
                if not batcher._active_streams and not (loop and loop._admitted):
                    break
                await asyncio.sleep(0.01)
            resp = await client.post(path, json=body)
            out.append((resp.status, await resp.text()))
        return out
    finally:
        await client.close()


@pytest.mark.parametrize("model", ["gpt2", "t5-small"])
def test_http_bodies_match_jax(model):
    """/predict and /v1/completions of a spec service, whole and streamed,
    greedy and seeded sampled: the JAX app's bodies."""
    (jcfg, jbundle, jengine), (cfg, bundle, engine, batcher) = services(
        model, SPEC_DECODE="ngram")
    posts = [
        ("/predict", {"text": "abcabcabcabc"}),
        ("/predict", {"text": "abcabcabcabc", "stream": True, "max_tokens": 7}),
        ("/v1/completions", {"prompt": "the cat the cat the", "max_tokens": 9}),
        ("/v1/completions", {"prompt": "xyxyxy", "stream": True}),
        ("/predict", {"text": "hi hi hi", "stream": True, "temperature": 0.9, "seed": 5}),
        ("/v1/completions", {"prompt": "hi", "temperature": 0.7, "top_k": 5, "seed": 6}),
    ]
    jbatcher = JaxBatcher(jengine, jcfg)
    want = asyncio.run(_http_settled(jax_build_app(jcfg, jbundle, jengine, jbatcher), jbatcher,
                                     posts))
    got = asyncio.run(_http_settled(build_app(cfg, bundle, engine, batcher), batcher, posts))
    for (path, body), (gs, g), (ws, w) in zip(posts, got, want):
        assert gs == ws == 200, (path, body, g)
        assert _comparable(path, body, g) == _comparable(path, body, w), (path, body)
    assert engine.spec_rounds > 0


REFUSALS = [
    ("bert-base", {"SPEC_DECODE": "ngram"}),
    ("resnet50", {"SPEC_DECODE": "ngram"}),
    ("gpt2", {"SPEC_CONTINUOUS": "1"}),
    ("gpt2", {"SPEC_DECODE": "ngram", "SPEC_CONTINUOUS": "1", "PAGED_KV": "1"}),
    ("llama", {"SPEC_DECODE": "ngram", "SPEC_CONTINUOUS": "1", "PREFILL_CHUNK": "16"}),
    ("gpt2", {"SPEC_DECODE": "ngram", "SPEC_CONTINUOUS": "1", "DECODE_WINDOW": "4"}),
    ("gpt2", {"SPEC_DECODE": "eagle"}),
    ("gpt2", {"SPEC_DECODE": "ngram", "SPEC_K": "0"}),
    ("gpt2", {"SPEC_DECODE": "ngram", "SPEC_K": "65"}),
    ("gpt2", {"SPEC_DECODE": "ngram", "SPEC_NGRAM": "9"}),
    ("gpt2", {"SPEC_DECODE": "ngram", "SPEC_MAX_STREAMS": "-1"}),
]


@pytest.mark.parametrize("model,env", REFUSALS,
                         ids=[f"{m}-{'-'.join(e)}" for m, e in REFUSALS])
def test_refusals_carry_the_jax_messages(model, env):
    """Every combination the JAX package refuses raises here, its message
    within the JAX error's text (pydantic wraps a field's), at build
    time or, for DECODE_WINDOW, when the loop is made."""
    env = {"DEVICE": "cpu", "MODEL_NAME": model, "WARMUP": "0", **SERVE, **env}
    if model == "llama":
        env["LLAMA_CONFIG"] = json.dumps(LLAMA)

    def jax_build():
        from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service

        jax_build_service({**env, "REPLICAS": "1"})

    with _small(model):
        with pytest.raises(ValueError) as want:
            jax_build()
        with pytest.raises(ValueError) as got:
            build_service(env)
    assert str(got.value) in str(want.value)


def test_spec_stream_under_paged_kv_bypasses_the_prefix_cache():
    """PAGED_KV with SPEC_DECODE (the per-stream path; SPEC_CONTINUOUS is
    refused there): a lone stream speculates over a contiguous state and
    leaves the paged prefix cache alone, as the JAX engine does; the
    same chunks."""
    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        "gpt2", SPEC_DECODE="ngram", PAGED_KV="1", KV_BLOCK_SIZE="8", PREFIX_CACHE="1",
        CONTINUOUS_BATCHING="0")
    text = "abcdabcdabcdabcdabcd"
    for _ in range(2):
        got = _chunks(engine.generate_stream(_feats(bundle, RawItem, text)))
        want = _chunks(jengine.generate_stream(_feats(jbundle, JaxRawItem, text)))
        assert got == want
    assert engine.prefix_cache.stats() == jengine.prefix_cache.stats()
    assert engine.prefix_cache.stats()["entries"] == 0 and engine.spec_rounds > 0


def test_spec_paths_through_graphs_give_jax_tokens():
    """The speculative graphs on the CPU under the graph tests' stand-in
    capturer (a replay calls the captured function again into the first
    call's outputs): warmup captures every spec kind (the prefixed start of
    the prefix grid too), and streams, a prefix hit and a whole generation
    then replay them with no miss, with the JAX engine's tokens."""
    from test_torch_graphs import _with_graphs

    (_, jbundle, jengine), (_, bundle, engine, _) = services(
        "llama", SPEC_DECODE="ngram", CONTINUOUS_BATCHING="0", PREFIX_CACHE="1",
        BATCH_BUCKETS="1,2", WARMUP_SAMPLING="0")
    cache = _with_graphs(engine)
    engine.warmup()
    kinds = cache.kinds()
    assert {k: kinds[k] for k in ("spec_start", "spec_chunk", "full_spec", "full_spec_chunk",
                                  "spec_start_prefixed")} == {
        "spec_start": 2, "spec_chunk": 3, "full_spec": 2, "full_spec_chunk": 2,
        "spec_start_prefixed": 1}
    misses = cache.stats()["miss"]
    shared = "abcdabcdabcdabcd"
    for text in ("the cat sat on the mat, the cat", shared + "xy", shared + "abc"):
        got = _chunks(engine.generate_stream(_feats(bundle, RawItem, text)))
        want = _chunks(jengine.generate_stream(_feats(jbundle, JaxRawItem, text)))
        assert got == want, text
    rows = engine.run_batch([_feats(bundle, RawItem, "xyxyxyxyxy", max_tokens=9)])
    want = jengine.run_batch([_feats(jbundle, JaxRawItem, "xyxyxyxyxy", max_tokens=9)])
    np.testing.assert_array_equal(rows[0], np.asarray(want[0]))
    assert engine.prefix_cache.stats()["hits"] >= 1
    assert cache.stats()["miss"] == misses


def test_spec_loop_through_graphs_gives_jax_tokens():
    """SPEC_CONTINUOUS under the stand-in capturer: the loop's spec chunk
    graphs (argmax and sampled) captured with the slot state, replayed over
    it in place; the JAX loop's tokens."""
    from test_torch_graphs import _with_graphs

    from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher

    env = dict(SPEC_DECODE="ngram", SPEC_CONTINUOUS="1", SPEC_MAX_STREAMS="0",
               MAX_STREAM_QUEUE="8")
    (jcfg, jbundle, jengine), (_, bundle, engine, batcher) = services("gpt2", **env)
    cache = _with_graphs(engine)
    loop = batcher._cdl
    loop.warm()
    requests = [("abcabcabcabc", {}), ("hi there", {"temperature": 0.9, "seed": 3}),
                ("xyxyxyxy", {"max_tokens": 6})]

    async def run(b, bnd, item_cls):
        await b.start()
        try:
            return await asyncio.gather(*(_consume(b.submit_stream(_feats(bnd, item_cls, t, **kw)))
                                          for t, kw in requests))
        finally:
            await b.stop()

    want = asyncio.run(run(JaxBatcher(jengine, jcfg), jbundle, JaxRawItem))
    got = asyncio.run(run(batcher, bundle, RawItem))
    assert got == want
    assert len([e for e in cache.entries() if e.kind == "loop_spec_chunk"]) == 2
    assert "loop_chunk" not in cache.kinds()
    assert loop.chunk_graph(False).replays + loop.chunk_graph(True).replays >= loop.chunk_dispatches
    assert engine.graph_modes()["loop_spec_chunk"] == "graph"
