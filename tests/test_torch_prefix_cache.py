"""The port's per-request prefix cache (``PREFIX_CACHE=1``) against the JAX
package's, f32 on the CPU, at small llama and GPT-2 configs on the same
weights:

- ``PrefixCache``: one operation sequence gives equal match results,
  stats, LRU order and ``on_evict`` calls (entry and key).
- The continuous loop, contiguous and paged (dense and int8): a growing
  conversation (miss, hit and donate the longer bucket, hit), a burst on
  one shared prefix admitted as one grouped hit wave, greedy and seeded
  sampled, each with the JAX loop's tokens, hits, misses, entries and
  bytes; paged, the pins' refcounts, the pool back to its pins after the
  streams and to 0 after a flush.
- A preempted sharer resumes by recast and hits the prefix its first
  admission donated; shared blocks stay with the pin.
- Pins reclaimed when an insert finds the pool dry; and pins alone keeping
  a queued stream from fitting: the JAX loop waits (the deadline sheds it),
  and so does the port's.
- The per-stream path (``CONTINUOUS_BATCHING=0``) hits through
  ``start_fused``; ``/status`` carries the JAX app's ``prefix_cache``.
"""

import asyncio
import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_gpt import small_gpt2

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine import prefix_cache as jax_pc
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdmission
from mlmicroservicetemplate_tpu.scheduler.policy import DeadlineExceededError as JaxDeadline
from mlmicroservicetemplate_tpu.utils import metrics as jax_metrics
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.engine import prefix_cache as port_pc
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.scheduler.policy import DeadlineExceededError
from mlmicroservicetemplate_tpu_torch.serve import build_service

SMALL_LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
                   d_ff=512, max_position=128)
LOOP = dict(batch_buckets=(1, 4), seq_buckets=(16, 32, 64), max_decode_len=12,
            stream_chunk_tokens=4, max_streams=4, prefix_cache=True)
PAGED = dict(paged_kv=True, kv_block_size=8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# PrefixCache


def _cache_script(pc, make_entry) -> list:
    """One sequence of cache calls; everything a caller observes."""
    log, evicted = [], []
    cache = pc.PrefixCache((16, 8, 32), budget_mb=0.0025,
                           on_evict=lambda entry, key: evicted.append(
                               (key[0], bytes(key[1]).hex(), tuple(np.shape(entry["k"][0])))))
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(3, 300, 40).astype(np.int32) for _ in range(3))

    def note(tag, out):
        log.append((tag, out, cache.stats(), len(cache), cache.bytes_used, list(evicted)))

    def match(ids, n, usable=None):
        m = cache.match(ids, n, usable=usable)
        return None if m is None else (m[0], tuple(np.shape(m[1]["k"][0])))

    note("buckets", cache.buckets)
    note("match empty", match(a, 20))
    note("bucket_for_insert", [cache.bucket_for_insert(n) for n in (1, 8, 9, 16, 17, 40)])
    cache.insert(a, 16, make_entry(16))
    note("insert a16", cache.contains(a, 16))
    cache.insert(a, 16, make_entry(16))
    note("insert a16 again", len(cache))
    note("match a 17", match(a, 17))
    note("match a 16 (one token must remain)", match(a, 16))
    note("match a unusable", match(a, 30, usable=lambda p: p < 16))
    note("peek", (cache.peek(a, 30), cache.peek(b, 30)))
    cache.insert(b, 8, make_entry(8))
    cache.insert(c, 32, make_entry(32))  # over the budget: LRU evicts
    note("after c32", (cache.contains(a, 16), cache.contains(b, 8), cache.contains(c, 32)))
    note("match c", match(c, 40))
    cache.insert(a, 8, make_entry(8))
    note("pop_lru", tuple(np.shape(cache.pop_lru()["k"][0])))
    note("pop all", [cache.pop_lru() is None for _ in range(3)])
    return log


def test_prefix_cache_matches_jax_call_for_call():
    def np_entry(p):
        return {"k": [np.zeros((1, p, 2, 8), np.float32)] * 2,
                "v": [np.zeros((1, p, 2, 8), np.float32)] * 2}

    def torch_entry(p):
        return {"k": [torch.zeros(1, p, 2, 8)] * 2, "v": [torch.zeros(1, p, 2, 8)] * 2}

    got, want = _cache_script(port_pc, torch_entry), _cache_script(jax_pc, np_entry)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g[0], g, w)
    assert any(entry[5] for entry in got)  # something was evicted


def test_prefix_cache_entry_bytes_of_pins_and_int8_pairs():
    from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import PagedPrefix

    assert port_pc.PrefixCache._entry_bytes(PagedPrefix(16, (0, 1), 1234)) == 1234
    pair = (torch.zeros(1, 16, 2, 8, dtype=torch.int8), torch.ones(1, 16, 2, 1))
    assert port_pc.PrefixCache._entry_bytes({"k": [pair], "v": [pair]}) == 2 * (256 + 128)


# ---------------------------------------------------------------------------
# the loop and the engine against the JAX package's


def _env(kw: dict) -> dict:
    return {k.upper(): (",".join(map(str, v)) if isinstance(v, tuple)
                        else ("1" if v else "0") if isinstance(v, bool) else str(v))
            for k, v in kw.items()}


def _services(model: str, **kw):
    """The JAX (cfg, bundle, engine) and the port's (cfg, bundle, engine,
    batcher) of ``model`` on the same weights."""
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL_LLAMA)
    try:
        with small_gpt2() if model == "gpt2" else contextlib.nullcontext():
            jcfg = JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                                    batch_timeout_ms=1.0, **kw)
            jbundle = jax_build_model(jcfg)
            jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
            port = build_service({"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0",
                                  "LLAMA_CONFIG": json.dumps(SMALL_LLAMA),
                                  "BATCH_TIMEOUT_MS": "1", **_env(kw)},
                                 params=jax.tree.map(np.asarray, jbundle.params))
    finally:
        del os.environ["LLAMA_CONFIG"]
    return (jcfg, jbundle, jengine), port


def _loops(model: str, **kw):
    """(JAX loop, JAX engine, port loop, port engine)."""
    (jcfg, _, jengine), (_, _, engine, batcher) = _services(model, **kw)
    jloop = JaxLoop(jengine, jcfg)
    jloop.admission = JaxAdmission(jcfg, jengine)
    return jloop, jengine, batcher._cdl, engine


def _ids(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(5, 250, n).astype(np.int32)


def _feats(ids: np.ndarray, **extra) -> dict:
    return {"input_ids": np.asarray(ids, np.int32), "length": np.int32(len(ids)), **extra}


async def _collect(gen) -> list[int]:
    return [int(t) async for chunk in gen for t in np.asarray(chunk).tolist()]


async def _run_seq(loop, feats_list) -> list[list[int]]:
    """Streams one after another."""
    return [await _collect(loop.submit_stream(dict(f))) for f in feats_list]


async def _run_burst(loop, feats_list) -> list[list[int]]:
    return list(await asyncio.gather(*(_collect(loop.submit_stream(dict(f)))
                                       for f in feats_list)))


def _conversation(ids_seed: int = 1, **extra) -> list[dict]:
    """Three turns of one conversation: a 20-token system prompt and user
    turn, then each turn the whole history plus a new user turn (20 -> 40
    -> 60 tokens: miss; hit at 16, donating 32; hit at 32)."""
    sys_ids = _ids(20, ids_seed)
    turn2 = np.concatenate([sys_ids, _ids(20, ids_seed + 10)])
    turn3 = np.concatenate([turn2, _ids(20, ids_seed + 20)])
    return [_feats(t, **extra) for t in (sys_ids, turn2, turn3)]


def _burst(n: int = 3, **extra) -> list[dict]:
    """A shared 36-token prompt (so the 32 bucket is donated) opened once,
    then ``n`` streams on it with their own 6-12-token tails."""
    shared = _ids(36, 7)
    first = _feats(shared, **extra)
    rest = [_feats(np.concatenate([shared, _ids(6 + 3 * i, 30 + i)]), **extra)
            for i in range(n)]
    return [first, rest]


def _stalls(loop, engine) -> int:
    """Dry-pool stalls so far: the port's loop counts them, the JAX loop
    only in its metric."""
    if hasattr(loop, "kv_growth_stalls"):
        return loop.kv_growth_stalls
    return int(jax_metrics.KV_GROWTH_STALLS.labels(engine.bundle.name)._value.get())


def _state(loop, engine, stalls0: int = 0) -> dict:
    """What the two loops must agree on after a run (``stalls0``: the
    stall count before it)."""
    cache = engine.prefix_cache
    out = {"cache": cache.stats(), "stalls": _stalls(loop, engine) - stalls0}
    if engine.paged_kv:
        out["pool"] = {k: v for k, v in engine.kv_pool.stats().items()}
        pins = [e.block_ids for e in cache._entries.values()]
        out["pins"] = sorted(len(b) for b in pins)
        out["pinned_blocks"] = len(set().union(*pins))
    return out


def _settle(loop, timeout: float = 10.0) -> None:
    t_end = time.monotonic() + timeout
    while loop._admitted and time.monotonic() < t_end:
        time.sleep(0.01)
    assert loop._admitted == 0


@pytest.mark.parametrize("model,extra,sampled", [
    ("llama", {}, False), ("llama", PAGED, False), ("llama", dict(PAGED, quant_kv="int8"), False),
    ("gpt2", {}, False), ("gpt2", PAGED, True), ("llama", {}, True),
], ids=["llama", "llama-paged", "llama-paged-int8", "gpt2", "gpt2-paged-sampled",
        "llama-sampled"])
def test_conversation_and_grouped_hits_match_jax(model, extra, sampled):
    """A growing conversation, then a burst on one shared prefix (one
    grouped prefixed start): the port's tokens and cache counts are the
    JAX loop's; paged, only the pins hold blocks afterwards."""
    jloop, jengine, loop, engine = _loops(model, **LOOP, **extra)
    sample = dict(temperature=0.8, top_k=30, seed=5) if sampled else {}
    conv = _conversation(**sample)
    first, rest = _burst(**sample)
    outs, states = [], []
    for lp, eng in ((jloop, jengine), (loop, engine)):
        stalls0 = _stalls(lp, eng)
        try:
            toks = asyncio.run(_run_seq(lp, conv + [first]))
            toks += asyncio.run(_run_burst(lp, rest))
        finally:
            lp.stop()
        outs.append(toks)
        states.append(_state(lp, eng, stalls0))
    assert outs[1] == outs[0]
    assert all(len(t) > 0 for t in outs[1])
    assert states[1] == states[0]
    stats = states[1]["cache"]
    # turn 1 and the shared prompt miss; turns 2, 3 and the burst hit
    assert (stats["hits"], stats["misses"]) == (5, 2)
    assert loop.prefix_hit_waves == 1
    _settle(loop)
    if engine.paged_kv:
        assert engine.kv_pool.used_blocks == states[1]["pinned_blocks"] > 0
        assert loop.peak_shared_blocks > 0 and loop.peak_shared_in_chunk > 0
        engine.prefix_cache.flush()
        assert engine.kv_pool.used_blocks == 0


def test_prefixed_tokens_equal_a_run_without_the_cache():
    """Hits change the prefill's shape, not the tokens: a conversation
    through the cache gets the tokens of the same prompts without it."""
    jloop, jengine, loop, engine = _loops("llama", **LOOP)
    jloop.stop()
    conv = _conversation(3)
    try:
        got = asyncio.run(_run_seq(loop, conv))
    finally:
        loop.stop()
    (_, _, plain_engine, _) = _services("llama", **dict(LOOP, prefix_cache=False))[1]
    want = [[int(t) for c in plain_engine.generate_stream(dict(f)) for t in c] for f in conv]
    assert got == want
    assert engine.prefix_cache.stats()["hits"] == 2


def _hold_first_chunk(loop) -> None:
    """The loop's first chunk dispatch waits until an interactive stream is
    queued (or preemption already happened)."""
    orig = loop._dispatch_chunk
    opened = threading.Event()

    def held():
        t_end = time.monotonic() + 30.0
        while not opened.is_set():
            if (loop.queue.waiting("interactive") > 0 or loop.preemptions
                    or time.monotonic() > t_end):
                opened.set()
            else:
                time.sleep(0.002)
        return orig()

    loop._dispatch_chunk = held


async def _preempted(loop, batch_feats: dict, inter_feats: dict):
    g_b = loop.submit_stream(batch_feats)
    first = np.asarray(await g_b.__anext__()).tolist()
    out_i = await _collect(loop.submit_stream(inter_feats))
    return first + await _collect(g_b), out_i


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_preempted_sharer_recasts_into_its_prefix_like_jax(paged):
    """A batch stream that hit a pinned prefix holds the only slot; an
    interactive arrival preempts it; its recast (prompt + delivered) hits
    the longer prefix its first admission donated.  Tokens, counts and the
    pins equal the JAX loop's."""
    # Paged: a pool of 24 blocks (one slot's worst case is 11), so the
    # pins never keep the recast from fitting (see the test below).
    kw = dict(LOOP, max_streams=1, max_stream_queue=4, preempt=True, max_decode_len=24,
              **(dict(PAGED, kv_budget_mb=24 * 16384 / 1e6) if paged else {}))
    jloop, jengine, loop, engine = _loops("llama", **kw)
    donor = _feats(_ids(20, 2))
    sharer = _feats(np.concatenate([_ids(20, 2), _ids(14, 3)]), priority="batch")
    inter = _feats(_ids(9, 4), priority="interactive")
    outs, states = [], []
    for lp, eng in ((jloop, jengine), (loop, engine)):
        stalls0 = _stalls(lp, eng)
        try:
            asyncio.run(_run_seq(lp, [donor]))
            _hold_first_chunk(lp)
            outs.append(asyncio.run(_preempted(lp, dict(sharer), dict(inter))))
        finally:
            lp.stop()
        assert lp.preemptions >= 1
        states.append(_state(lp, eng, stalls0))
    assert outs[1] == outs[0]
    assert states[1] == states[0]
    assert loop.recasts >= 1 and loop.recast_hits >= 1
    _settle(loop)
    if paged:
        assert engine.kv_pool.used_blocks == states[1]["pinned_blocks"]


def _dry_pool(blocks: int):
    """Small GPT-2 over a pool of ``blocks`` 8-token blocks (by
    ``KV_BUDGET_MB``), the prefix cache allowed more than the pool."""
    bb = 2 * 2 * 4 * 32 * 4 * 8  # K/V x layers x heads x head_dim x f32 x block
    return _loops("gpt2", **dict(LOOP, **PAGED, max_streams=2, max_stream_queue=4,
                                 kv_budget_mb=blocks * bb / 1e6, prefix_cache_mb=64.0))


def test_pins_reclaimed_when_a_growth_finds_the_pool_dry_like_jax():
    """Nine blocks; each 18-token stream takes 5 at insert and grows to 6,
    and pins 2 when it is in its slot.  The third fits the dequeue gate
    (5 free) and its growth finds the pool dry: the loop evicts the LRU pin
    instead of checkpointing it.  Tokens, counts and pins equal JAX's."""
    jloop, jengine, loop, engine = _dry_pool(9)
    prompts = [_feats(_ids(18, s)) for s in (1, 2, 3)]
    outs, states = [], []
    for lp, eng in ((jloop, jengine), (loop, engine)):
        stalls0 = _stalls(lp, eng)
        try:
            outs.append(asyncio.run(_run_seq(lp, prompts)))
        finally:
            lp.stop()
        states.append(_state(lp, eng, stalls0))
    assert outs[1] == outs[0]
    assert states[1] == states[0]
    assert len(engine.prefix_cache) == 2 and states[1]["stalls"] == 0
    _settle(loop)


def test_pins_alone_keep_a_queued_stream_waiting_like_jax():
    """Six blocks: one stream leaves a 2-block pin, and the next needs 5 at
    its insert.  The dequeue gate counts pinned blocks as used, and pins
    are reclaimed only at an insert or a growth, so with nothing running
    the JAX loop leaves the stream queued until its deadline sheds it (504);
    the port's loop does the same."""
    jloop, jengine, loop, engine = _dry_pool(6)
    donor = _feats(_ids(18, 1))
    late = _feats(_ids(18, 2), deadline_ms=300.0)
    results = []
    for lp, eng, exc in ((jloop, jengine, JaxDeadline), (loop, engine, DeadlineExceededError)):
        try:
            asyncio.run(_run_seq(lp, [donor]))
            with pytest.raises(exc):
                asyncio.run(_run_seq(lp, [late]))
        finally:
            lp.stop()
        results.append((eng.kv_pool.used_blocks, eng.prefix_cache.stats()))
    assert results[1] == results[0]
    assert results[1][0] == 2


def test_per_stream_path_hits_through_start_fused_like_jax():
    """``CONTINUOUS_BATCHING=0``: each stream runs on its own through
    ``start_fused``; the conversation hits and donates as in the JAX
    engine."""
    kw = dict(LOOP, continuous_batching=False)
    (jcfg, jbundle, jengine), (cfg, bundle, engine, batcher) = _services("llama", **kw)
    conv = _conversation(5)
    want = [[int(t) for c in jengine.generate_stream(dict(f)) for t in c] for f in conv]
    got = [[int(t) for c in engine.generate_stream(dict(f)) for t in c] for f in conv]
    assert got == want
    assert engine.prefix_cache.stats() == jengine.prefix_cache.stats()
    assert engine.prefix_cache.stats()["hits"] == 2


async def _http_status(app, posts):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        bodies = []
        for body in posts:
            resp = await client.post("/v1/completions", json=body)
            bodies.append(await resp.text())
        return bodies, (await (await client.get("/status")).json())["prefix_cache"]
    finally:
        await client.close()


def test_status_prefix_cache_matches_the_jax_app():
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = _services("llama", **LOOP)
    history = "You are terse, ok? "  # 19 bytes: the 16 bucket is donated
    posts = [{"prompt": history + "hello", "max_tokens": 4, "stream": True},
             {"prompt": history + "hello there", "max_tokens": 4, "stream": True}]
    want, jstats = asyncio.run(_http_status(
        jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)), posts))
    got, stats = asyncio.run(_http_status(build_app(cfg, bundle, engine, Batcher(engine, cfg)),
                                          posts))
    assert stats == jstats
    assert stats["entries"] >= 1 and stats["hits"] >= 1
    assert [g.count("data:") for g in got] == [w.count("data:") for w in want]
