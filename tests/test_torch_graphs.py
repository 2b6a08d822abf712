"""The port's graph layer (``runtime/compile_cache.py``) on the CPU.

CUDA graphs need the card, so the graph path runs here under a stand-in
capturer (``call_capturer``): its "graph" calls the captured function
again at each replay and writes the results into the tensors the first
call returned, which is what a replay does to a graph's static outputs.
Through it the engine's and the loop's graph dispatch (static inputs,
``start`` before ``gen_chunk``, the loop's fixed slot state and block
table) run against the eager path and the JAX package on the same
weights.

- Keys never alias across bundle objects, kinds, descriptors or
  placements; hit / miss / insert counts and warm-phase seconds.
- A capture that raises makes ``warmup`` raise, with no eager retry, and
  the app stays not ready.
- An engine on the CPU never touches the cache.
- Every ``GPTState`` / ``PagedState`` tensor keeps its address across
  decode chunks, dense and int8, and greedy tokens stay identical to the
  JAX package's, whole and streamed, contiguous and paged.
"""

import asyncio
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention
from mlmicroservicetemplate_tpu_torch.runtime import compile_cache as cc
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils import metrics

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
LLAMA = {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0",
         "LLAMA_CONFIG": json.dumps(SMALL), "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32",
         "MAX_DECODE_LEN": "10", "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4",
         "KV_BLOCK_SIZE": "8", "BATCH_TIMEOUT_MS": "1"}
# (text, max_tokens): prompts in both seq buckets, some with a budget.
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


def _copy_into(dst, src) -> None:
    """Write ``src`` into the tensors of ``dst`` (same structure), in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))


class _CallGraph:
    """A CPU stand-in for a captured graph: a replay calls the function
    again and writes what it returns into the first call's outputs."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        _copy_into(self.outputs, self.fn())


def call_capturer(kind, fn, inputs, device):
    outputs = fn()
    return cc.GraphEntry(kind, _CallGraph(fn, outputs), inputs, outputs, {}, 0.0)


def _with_graphs(engine, capturer=call_capturer) -> cc.GraphCache:
    """Route ``engine``'s dispatches through a cache of its own."""
    engine.graphs = cc.GraphCache(capturer)
    return engine.graphs


# ---------------------------------------------------------------------------
# the cache


def _entry_maker(built):
    def make():
        token = object()
        built.append(token)
        return (lambda: token), None, "cpu"
    return make


def _token_capturer(kind, fn, inputs, device):
    return cc.GraphEntry(kind, None, inputs, fn(), {}, 0.25)


def test_cache_keying_never_aliases():
    cache = cc.GraphCache(_token_capturer)
    b1, b2 = types.SimpleNamespace(name="m"), types.SimpleNamespace(name="m")
    built = []
    make = _entry_maker(built)
    one = ("cuda:0",)
    # Same (bundle, kind, descriptor, placement): one capture, shared.
    e1 = cache.get(b1, "forward", (1, 32), one, make)
    assert cache.get(b1, "forward", (1, 32), one, make) is e1 and len(built) == 1
    # Distinct bundle objects never alias: same name, same descriptor.
    assert cache.get(b2, "forward", (1, 32), one, make) is not e1
    # Nor distinct kinds, descriptors or placements.
    assert cache.get(b1, "start", (1, 32), one, make) is not e1
    assert cache.get(b1, "forward", (1, 64), one, make) is not e1
    assert cache.get(b1, "forward", (1, 32), ("cuda:0", "cuda:1"), make) is not e1
    assert len(built) == 5
    assert len({id(e.outputs) for e in cache.entries()}) == 5
    # Fingerprints are sticky and unique; placements key by device.
    assert cc.fingerprint(b1) == cc.fingerprint(b1) != cc.fingerprint(b2)
    assert cc.placement_key([torch.device("cpu")] * 2) == ("cpu", "cpu")
    assert [e.outputs for e in cache.entries(b2)] == [built[1]]


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown graph kind"):
        cc.GraphCache(_token_capturer).get(types.SimpleNamespace(), "jit", (), (), None)


def _event_count(event: str) -> float:
    value = metrics.REGISTRY.get_sample_value("executable_cache_events_total",
                                              {"event": event})
    return value or 0.0


def test_hit_miss_insert_counts_and_warm_stats():
    cache = cc.GraphCache(_token_capturer)
    bundle = types.SimpleNamespace(name="m")
    events = {e: _event_count(e) for e in ("hit", "miss", "insert")}
    make = _entry_maker([])
    for desc in [(1,), (1,), (2,), (1,), (2,)]:
        cache.get(bundle, "forward", desc, ("cpu",), make)
    cache.get(bundle, "gen_chunk", (1,), ("cpu",), make)
    assert cache.stats() == {"entries": 3, "hit": 3, "miss": 3, "insert": 3}
    assert cache.kinds() == {"forward": 2, "gen_chunk": 1}
    assert cache.capture_stats() == {"count": 3, "seconds": 0.75}
    assert {e: _event_count(e) - events[e] for e in events} == \
        {"hit": 3.0, "miss": 3.0, "insert": 3.0}
    before = cc.warm_stats().get("test_phase", 0.0)
    with cc.warm_phase("m", "test_phase") as phase:
        pass
    assert phase.seconds >= 0.0
    assert cc.warm_stats()["test_phase"] == pytest.approx(before + phase.seconds, abs=1e-3)
    cache.clear()
    assert cache.stats() == {"entries": 0, "hit": 0, "miss": 0, "insert": 0}


def test_replay_adds_the_launches_recorded_at_capture():
    calls = []
    entry = cc.GraphEntry("forward", types.SimpleNamespace(replay=lambda: calls.append(1)),
                          None, None, {"fused_attention": 12}, 0.0)
    before = fused_attention.launches
    try:
        entry.replay()
        entry.replay()
        assert fused_attention.launches - before == 24
    finally:
        fused_attention.launches = before  # the process-wide counter other tests read
    assert entry.replays == 2 and len(calls) == 2


# ---------------------------------------------------------------------------
# the engine


def _boom(kind, fn, inputs, device):
    raise RuntimeError(f"capture of {kind} failed")


BERT = {"MODEL_NAME": "bert-base", "DEVICE": "cpu", "WARMUP": "0", "BATCH_BUCKETS": "1,2",
        "SEQ_BUCKETS": "16,32"}


@pytest.mark.parametrize("overrides,kind", [
    (BERT, "forward"),
    ({"MODEL_NAME": "resnet50", "DEVICE": "cpu", "WARMUP": "0", "BATCH_BUCKETS": "1,2"},
     "forward_images"),
    (LLAMA, "start"),
], ids=["bert", "resnet", "llama"])
def test_failed_capture_makes_warmup_raise_without_eager_retry(overrides, kind):
    _, bundle, engine, _ = build_service(overrides)
    _with_graphs(engine, _boom)
    calls = []
    name = "init_state" if kind == "start" else "forward"
    real = getattr(bundle, name)
    setattr(bundle, name, lambda *a: calls.append(1) or real(*a))
    with pytest.raises(RuntimeError, match=f"capture of {kind} failed"):
        engine.warmup()
    assert calls == [] and engine.dispatches == 0


def test_failed_capture_keeps_the_app_not_ready():
    cfg, bundle, engine, batcher = build_service(BERT)
    _with_graphs(engine, _boom)
    app = build_app(dataclasses.replace(cfg, warmup=True), bundle, engine, batcher)

    async def body():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            for _ in range(200):
                status = await (await client.get("/status")).json()
                if "ready_error" in status:
                    break
                await asyncio.sleep(0.02)
            ready = await client.get("/readyz")
            return ready.status, status
        finally:
            await client.close()

    code, status = asyncio.run(body())
    assert code == 503 and not status["ready"]
    assert "capture of forward failed" in status["ready_error"]
    assert status["compile"]["kinds"] == {"forward": "graph"}


@pytest.mark.parametrize("overrides", [
    BERT, {**LLAMA, "PAGED_KV": "1"},
    {"MODEL_NAME": "bert-long", "DEVICE": "cpu", "WARMUP": "0", "SP": "2",
     "BATCH_BUCKETS": "1", "SEQ_BUCKETS": "64"},
], ids=["bert", "llama", "bert-long"])
def test_cpu_engine_never_touches_the_cache(overrides):
    cfg, bundle, engine, batcher = build_service(overrides)
    before = (cc.cache_stats(), cc.capture_stats())
    engine.warmup()
    engine.run_batch([bundle.preprocess(RawItem(text="hello graphs"))])
    batcher.warm_streams()
    assert engine.graphs is None
    assert (cc.cache_stats(), cc.capture_stats()) == before
    modes = batcher.compile_status()["kinds"]
    assert modes and set(modes.values()) == {"eager: cpu has no CUDA graphs"}
    if engine.paged_kv:
        assert set(modes) == {"start", "gen_chunk", "loop_chunk_paged"}


def _card_engine(devices=None):
    """An engine of a fake text bundle on ``cuda:0``, its shards on
    ``devices`` (no placement: None); nothing touches a card."""
    from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine
    from mlmicroservicetemplate_tpu_torch.models.registry import KIND_TEXT
    from mlmicroservicetemplate_tpu_torch.utils.config import ServiceConfig

    placement = None if devices is None else types.SimpleNamespace(
        devices=devices, seq_multiple=lambda: len(devices))
    bundle = types.SimpleNamespace(name="fake", kind=KIND_TEXT,
                                   device=torch.device("cuda", 0), placement=placement,
                                   cfg=types.SimpleNamespace(max_position=512))
    return InferenceEngine(bundle, ServiceConfig(device="cuda", seq_buckets=(32, 64)))


def test_a_placement_over_several_cards_stays_eager_and_says_why():
    """Capture is per card: an engine on the card whose shards sit on two
    cards runs eagerly, and names the reason; shards sharing one card, or
    no placement, get graphs."""
    two = _card_engine([torch.device("cuda", 0), torch.device("cuda", 1)])
    assert two.graphs is None
    assert two.graph_modes() == {
        "forward": "eager: placement spans 2 cards (multi-card capture is not ported)"}
    for devices in ([torch.device("cuda", 0)] * 4, None):
        one = _card_engine(devices)
        assert one.graphs is cc.CACHE and one.graph_modes() == {"forward": "graph"}
    assert _card_engine([torch.device("cuda", 0)] * 4).placement_key == ("cuda:0",) * 4


def test_engines_on_one_card_dispatch_under_its_pool_lock():
    """A graph's outputs hold until the pool's next replay, whichever
    engine makes it: every engine that replays into a card's pool
    dispatches under that pool's one lock; an eager engine keeps its own."""
    a, b = _card_engine(), _card_engine([torch.device("cuda", 0)] * 4)
    assert a._lock is b._lock is cc.device_lock("cuda:0") is cc.device_lock(
        torch.device("cuda", 0))
    assert cc.device_lock("cuda:1") is not a._lock
    eager = _card_engine([torch.device("cuda", 0), torch.device("cuda", 1)])
    assert eager._lock is not a._lock
    with a._lock, b._lock:  # reentrant: one dispatch may hold it twice
        pass


def test_compile_status_has_the_jax_fields_and_the_graph_ones():
    _, _, _, batcher = build_service(BERT)
    status = batcher.compile_status()
    assert set(status) == {"executable_cache", "warm_phases_s", "graph_captures",
                           "graph_capture_s", "graph_pool_bytes", "kinds"}
    assert set(status["executable_cache"]) == {"entries", "hit", "miss", "insert"}
    assert status["graph_pool_bytes"] == 0


def test_graph_path_gives_the_eager_logits():
    _, bundle, eager, _ = build_service(BERT)
    _, _, engine, _ = build_service(BERT)
    cache = _with_graphs(engine)
    feats = [bundle.preprocess(RawItem(text=t)) for t in ("one", "two words here and more")]
    engine.warmup()
    assert cache.stats()["miss"] == 4 and cache.kinds() == {"forward": 4}
    for batch in (feats, feats[:1]):
        np.testing.assert_array_equal(np.stack(engine.run_batch(batch)),
                                      np.stack(eager.run_batch(batch)))
    stats = cache.stats()
    assert stats["miss"] == stats["insert"] == 4 and stats["hit"] == 2


def test_graph_path_of_an_image_model():
    over = {"MODEL_NAME": "resnet50", "DEVICE": "cpu", "WARMUP": "0", "BATCH_BUCKETS": "1,2"}
    _, bundle, eager, _ = build_service(over)
    _, _, engine, _ = build_service(over)
    cache = _with_graphs(engine)
    rng = np.random.default_rng(3)
    feats = [{"image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)} for _ in range(2)]
    got = engine.run_batch(feats)  # WARMUP=0: the first dispatch captures
    assert cache.stats() == {"entries": 1, "hit": 0, "miss": 1, "insert": 1}
    np.testing.assert_array_equal(np.stack(got), np.stack(eager.run_batch(feats)))
    assert cache.kinds() == {"forward_images": 1}


def test_graph_path_of_a_sequence_parallel_placement():
    over = {"MODEL_NAME": "bert-long", "DEVICE": "cpu", "WARMUP": "0", "SP": "2",
            "BATCH_BUCKETS": "1,2", "SEQ_BUCKETS": "64"}
    _, bundle, eager, _ = build_service(over)
    _, _, engine, _ = build_service(over)
    cache = _with_graphs(engine)
    feats = [bundle.preprocess(RawItem(text="x" * n)) for n in (20, 50)]
    got = engine.run_batch(feats)
    (entry,) = cache.entries()
    assert [len(t) for t in entry.inputs] == [2, 2]  # two shards of ids and of mask
    np.testing.assert_array_equal(np.stack(got), np.stack(eager.run_batch(feats)))


# ---------------------------------------------------------------------------
# llama: decode state in place, tokens identical to the JAX package's


def _jax_bundle(**kw):
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        cfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False,
                               batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
                               stream_chunk_tokens=4, batch_timeout_ms=1.0, **kw)
        return cfg, jax_build_model(cfg)
    finally:
        del os.environ["LLAMA_CONFIG"]


def _tensors(state) -> list[torch.Tensor]:
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        for t in (v if isinstance(v, list) else [v]):
            out.extend(t if isinstance(t, tuple) else [t] if isinstance(t, torch.Tensor) else [])
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_contiguous_state_keeps_its_addresses_and_jax_tokens(quant):
    jcfg, jbundle = _jax_bundle(quant_kv="int8" if quant else None,
                                continuous_batching=False)
    params = jax.tree.map(np.asarray, jbundle.params)
    _, bundle, _, _ = build_service({**LLAMA, **({"QUANT_KV": "int8"} if quant else {})},
                                    params=params)
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    feats = [jbundle.preprocess(JaxRawItem(text=t)) for t, _ in REQUESTS]
    want = np.stack(jengine.run_batch(feats))
    ids = np.zeros((4, 32), np.int32)
    mask = np.zeros_like(ids)
    for i, f in enumerate(feats):
        n = int(f["length"])
        ids[i, :n], mask[i, :n] = f["input_ids"], 1
    with torch.inference_mode():
        state = bundle.init_state(torch.from_numpy(ids), torch.from_numpy(mask), 12)
        ptrs = [t.data_ptr() for t in _tensors(state)]
        for _ in range(3):
            out, _ = bundle.generate_chunk(state, 4)
            assert out is state
            assert [t.data_ptr() for t in _tensors(state)] == ptrs
    assert state.steps == 12 and int(state.pos.max()) == 12
    np.testing.assert_array_equal(state.tokens.numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_paged_state_keeps_its_addresses(quant):
    """The loop's paged slot state over three chunks, one stream live: every
    tensor stays where it was (the loop's tokens are pinned to the JAX
    loop's below)."""
    _, bundle, engine, batcher = build_service(
        {**LLAMA, "PAGED_KV": "1", **({"QUANT_KV": "int8"} if quant else {})})
    loop = batcher._cdl
    loop.warm()
    state = loop._state
    ptrs = [t.data_ptr() for t in _tensors(state)]
    with torch.inference_mode(), engine._lock:
        loop._table[0, :3] = [0, 1, 2]
        state.done[0] = False
        state.key_valid[0, :5] = 1
        state.write_idx[0] = 4
        state.pos[0] = 0
        for _ in range(3):
            loop._state, _ = loop._chunk_call()
            assert loop._state is state
            assert [t.data_ptr() for t in _tensors(state)] == ptrs
    assert int(state.pos[0]) == 12 and int(state.key_valid[0].sum()) == 16


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_generation_through_graphs_gives_jax_tokens(quant):
    jcfg, jbundle = _jax_bundle(quant_kv="int8" if quant else None,
                                continuous_batching=False)
    params = jax.tree.map(np.asarray, jbundle.params)
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    want = jengine.run_batch(
        [jbundle.preprocess(JaxRawItem(text=t, max_tokens=m)) for t, m in REQUESTS])
    _, bundle, engine, _ = build_service({**LLAMA, **({"QUANT_KV": "int8"} if quant else {})},
                                         params=params)
    cache = _with_graphs(engine)
    engine.warmup()  # every bucket's argmax and sampled graphs, as JAX warms both
    assert cache.kinds() == {"start": 8, "gen_chunk": 8}
    misses = cache.stats()["miss"]
    got = engine.run_batch([bundle.preprocess(RawItem(text=t, max_tokens=m))
                            for t, m in REQUESTS])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert cache.stats()["miss"] == misses  # warmed: every dispatch replays
    assert engine.last_decode_steps == jengine.last_decode_steps
    # One prompt alone, in a bucket whose graphs are then replayed again.
    alone = engine.run_batch([bundle.preprocess(RawItem(text="hi"))])
    np.testing.assert_array_equal(alone[0], want[0])


# Seeded sampled requests beside greedy ones: (text, max_tokens, sampling).
SAMPLED = [("hi", None, dict(temperature=0.8, seed=1)),
           ("the quick brown fox", 3, {}),
           ("serving tokens, twice", None, dict(temperature=1.2, top_k=40, top_p=0.9, seed=2)),
           ("a", 7, dict(temperature=0.6, top_p=0.5, seed=3))]


@pytest.mark.parametrize("warm_sampling", [True, False], ids=["warmed", "unwarmed"])
def test_sampled_generation_through_graphs_gives_jax_tokens(warm_sampling):
    """A batch with a sampled row replays the sampled variant of its bucket's
    graphs, captured at warmup, or, under ``WARMUP_SAMPLING=0``, at its
    first dispatch (a miss); its seeded rows are the JAX engine's."""
    jcfg, jbundle = _jax_bundle(continuous_batching=False)
    params = jax.tree.map(np.asarray, jbundle.params)
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    want = jengine.run_batch(
        [jbundle.preprocess(JaxRawItem(text=t, max_tokens=m, **kw)) for t, m, kw in SAMPLED])
    _, bundle, engine, _ = build_service(
        {**LLAMA, "WARMUP_SAMPLING": "1" if warm_sampling else "0"}, params=params)
    cache = _with_graphs(engine)
    engine.warmup()
    n = 8 if warm_sampling else 4
    assert cache.kinds() == {"start": n, "gen_chunk": n}
    misses = cache.stats()["miss"]
    got = engine.run_batch([bundle.preprocess(RawItem(text=t, max_tokens=m, **kw))
                            for t, m, kw in SAMPLED])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert cache.stats()["miss"] == misses + (0 if warm_sampling else 2)
    sampled = [e for e in cache.entries() if e.replays and e.inputs is not None
               and e.kind == "start" and bool(e.inputs[2].temperature.any())]
    assert len(sampled) == 1


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


@pytest.mark.parametrize("warm", [True, False], ids=["warmed", "unwarmed"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_loop_through_graphs_gives_jax_tokens(paged, quant, warm):
    """Unwarmed (``WARMUP=0``), the chunk's graph is captured at the first
    admission, before any slot is live: the stand-in capturer, like the
    real one, runs the chunk once as it captures, which would advance live
    streams by a chunk."""
    jcfg, jbundle = _jax_bundle(quant_kv="int8" if quant else None, paged_kv=paged,
                                kv_block_size=8, max_streams=4)
    jloop = JaxLoop(JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1))), jcfg)
    try:
        want = asyncio.run(_streams(
            jloop, lambda t, m: jbundle.preprocess(JaxRawItem(text=t, max_tokens=m))))
    finally:
        jloop.stop()
    params = jax.tree.map(np.asarray, jbundle.params)
    _, bundle, engine, batcher = build_service(
        {**LLAMA, "PAGED_KV": "1" if paged else "0", **({"QUANT_KV": "int8"} if quant else {})},
        params=params)
    cache = _with_graphs(engine)
    loop = batcher._cdl
    if warm:
        loop.warm()
    state = loop._state
    ptrs = [t.data_ptr() for t in _tensors(state)] if warm else None
    try:
        got = asyncio.run(_streams(
            loop, lambda t, m: bundle.preprocess(RawItem(text=t, max_tokens=m))))
    finally:
        loop.stop()
    assert got == want
    kind = "loop_chunk_paged" if paged else "loop_chunk"
    assert len([e for e in cache.entries() if e.kind == kind]) == 2  # argmax and sampled
    chunk, sampled = loop.chunk_graph(False), loop.chunk_graph(True)
    # warm() replays once before the streams' chunks and, under
    # STREAM_PIPELINE=0, seven more to tune the depth (a priming chunk,
    # then one and five chained); no stream samples
    assert loop._auto_depth and loop.tuned is not None or not warm
    assert chunk.replays == loop.chunk_dispatches + 8 * warm and loop.chunk_dispatches > 0
    assert sampled.replays == 0
    if warm:
        assert loop._state is state and [t.data_ptr() for t in _tensors(state)] == ptrs
    assert chunk.inputs[0] is loop._state
    assert set(cache.kinds()) == {"start", kind}


def test_loop_chunk_is_never_captured_over_live_streams():
    _, bundle, engine, batcher = build_service({**LLAMA, "PAGED_KV": "1"})
    cache = _with_graphs(engine)
    loop = batcher._cdl
    loop.active[0] = object()
    with torch.inference_mode(), engine._lock, pytest.raises(RuntimeError, match="live"):
        loop._build_empty_state()
    assert loop._state is None and cache.stats()["insert"] == 0


def test_a_second_loop_never_replays_the_first_loops_graph():
    _, bundle, engine, batcher = build_service({**LLAMA, "PAGED_KV": "1"})
    cache = _with_graphs(engine)
    first = batcher._cdl
    first.warm()
    from mlmicroservicetemplate_tpu_torch.engine.streams import ContinuousDecodeLoop

    second = ContinuousDecodeLoop(engine, types.SimpleNamespace(max_streams=4))
    second.warm()
    a, b = first.chunk_graph(), second.chunk_graph()
    assert a is not b and a.inputs[0] is first._state and b.inputs[0] is second._state
    assert cache.kinds() == {"loop_chunk_paged": 4}  # each loop's argmax and sampled


def test_failed_dispatch_resets_the_slot_state_in_place():
    _, bundle, engine, batcher = build_service({**LLAMA, "PAGED_KV": "0"})
    loop = batcher._cdl
    loop.warm()
    state = loop._state
    ptrs = [t.data_ptr() for t in _tensors(state)]
    with torch.inference_mode():
        state.tokens.fill_(7)
        state.done.fill_(False)
        loop._fail_all(RuntimeError("injected"))
        loop._build_empty_state()
    assert loop._state is state and [t.data_ptr() for t in _tensors(state)] == ptrs
    assert bool(state.done.all()) and int(state.tokens.max()) == bundle.cfg.pad_id


def test_decode_step_updates_in_place():
    model = port_llama.build_model(
        port_llama.LlamaConfig(**SMALL), port_llama.init_params(
            port_llama.LlamaConfig(**SMALL), torch.Generator().manual_seed(0)),
        torch.device("cpu"), torch.float32)
    ids = torch.tensor([[5, 6, 7, 0], [8, 9, 0, 0]], dtype=torch.int32)
    mask = (ids != 0).to(torch.int32)
    with torch.inference_mode():
        state = port_llama.init_decode_state(model, ids, mask, 4)
        fields = {n: getattr(state, n) for n in ("write_idx", "pos", "last_token", "done")}
        ref = {n: t.clone() for n, t in fields.items()}
        out, tok = port_llama.decode_step(model, state)
    assert out is state and all(getattr(state, n) is t for n, t in fields.items())
    assert torch.equal(state.write_idx, ref["write_idx"] + 1)
    assert torch.equal(state.pos, ref["pos"] + 1) and torch.equal(state.last_token, tok)
    assert state.steps == 1
