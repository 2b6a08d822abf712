"""``SPEC_CONTINUOUS``: speculative verify rounds in the port's continuous
loop against the JAX loop, f32 on the CPU at small widths, on the same
weights: every stream's tokens equal the JAX loop's (and, greedy, the
non-speculative loop's) with more streams than slots (late admissions),
budgets, seeded sampled rows, a prefix-cache hit wave (llama with the int8
cache too), two dispatches in flight, and T5; ``SPEC_SAMPLED=0`` routes
sampled streams around the loop; the history row of a first chunk that
fills the budget is clamped (the JAX tests' cases)."""

import asyncio

import numpy as np
import pytest
import torch
from test_torch_spec_serving import _feats, services

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

SPEC = {"SPEC_DECODE": "ngram", "SPEC_CONTINUOUS": "1", "SPEC_MAX_STREAMS": "0",
        "MAX_STREAM_QUEUE": "8"}
REQUESTS = [("abcabcabcabcabc", {}), ("the cat sat on the mat, the cat", {"max_tokens": 5}),
            ("xyxyxyxyxy", {}), ("hi", {}), ("hello hello hello", {"max_tokens": 11}),
            ("one two one two one", {})]
SAMPLED = [("abcababab", {"temperature": 1.0, "seed": 13}), ("greedy neighbour", {}),
           ("xyzxyzxyz", {"temperature": 0.7, "top_k": 5, "seed": 2})]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


async def _stream_all(batcher, bundle, item_cls, requests, stagger: float = 0.0):
    """Every request streamed through the batcher at once (``stagger``
    seconds apart); each stream's tokens."""
    async def one(i, text, kw):
        await asyncio.sleep(stagger * i)
        f = _feats(bundle, item_cls, text, **kw)
        return [t async for c in batcher.submit_stream(f) for t in np.asarray(c).tolist()]

    await batcher.start()
    try:
        return await asyncio.gather(*(one(i, t, kw) for i, (t, kw) in enumerate(requests)))
    finally:
        await batcher.stop()


def _both(model: str, requests, stagger: float = 0.0, **env):
    """(port tokens, JAX tokens, port batcher, JAX batcher) of ``requests``
    through both services' batchers."""
    (jcfg, jbundle, jengine), (_, bundle, _, batcher) = services(model, **env)
    jbatcher = JaxBatcher(jengine, jcfg)
    want = asyncio.run(_stream_all(jbatcher, jbundle, JaxRawItem, requests, stagger))
    got = asyncio.run(_stream_all(batcher, bundle, RawItem, requests, stagger))
    return got, want, batcher, jbatcher


@pytest.mark.parametrize("model", ["gpt2", "llama", "t5-small"])
def test_spec_continuous_matches_jax(model):
    """Six streams over four slots, two with max_tokens: each stream's
    tokens equal the JAX speculative loop's and the port's plain loop's;
    the loop ran verify rounds, emitting more than one token a round."""
    got, want, batcher, jbatcher = _both(model, REQUESTS, **SPEC)
    assert got == want
    loop = batcher._cdl
    assert loop.spec and jbatcher._cdl.spec
    assert loop.spec_rounds > 0 and loop.decode_steps == 0
    assert loop.tokens_emitted > loop.spec_rounds + loop.prefill_dispatches * loop.chunk
    (_, bundle, _, plain) = services(model, MAX_STREAM_QUEUE="8")[1]
    ref = asyncio.run(_stream_all(plain, bundle, RawItem, REQUESTS))
    assert got == ref


def test_spec_continuous_late_admissions():
    """Streams arriving while others decode join the speculative slots
    mid-flight; a max_tokens cap trims a round's overshoot."""
    got, want, batcher, _ = _both("gpt2", REQUESTS, stagger=0.05, **SPEC,
                                  MAX_DECODE_LEN="24")
    assert got == want
    assert len(got[1]) == 5 and batcher._cdl.prefill_dispatches >= 2


@pytest.mark.parametrize("model", ["gpt2", "t5-small"])
def test_spec_continuous_sampled_matches_jax(model):
    """Seeded sampled rows beside a greedy one accept by rejection
    sampling in the shared rounds: the JAX loop's tokens, and the same
    alone as in the batch."""
    got, want, _, _ = _both(model, SAMPLED, **SPEC)
    assert got == want
    solo, _, _, _ = _both(model, SAMPLED[:1], **SPEC)
    assert solo[0] == got[0]


def test_spec_sampled_off_routes_around_the_loop():
    """SPEC_CONTINUOUS with SPEC_SAMPLED=0: a sampled stream takes the
    per-stream non-speculative path (the loop prefills nothing), with the
    JAX batcher's tokens; a greedy one still speculates in the loop."""
    requests = [("ababab", {"temperature": 1.0, "seed": 9})]
    got, want, batcher, jbatcher = _both("gpt2", requests, **SPEC, SPEC_SAMPLED="0")
    assert got == want
    assert batcher._cdl.prefill_dispatches == jbatcher._cdl.prefill_dispatches == 0
    got, want, batcher, _ = _both("gpt2", [("greedy", {})], **SPEC, SPEC_SAMPLED="0")
    assert got == want and batcher._cdl.spec_rounds > 0


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_spec_continuous_with_prefix_cache(quant):
    """PREFIX_CACHE with SPEC_CONTINUOUS (llama, dense and int8 KV): a
    first stream donates, later ones hit and join the speculative slots
    through prefixed starts; tokens and the cache's counts equal JAX's."""
    shared = "abcdeabcdeabcdeab"
    requests = [(shared + "xy", {})]
    env = dict(SPEC, PREFIX_CACHE="1", **({"QUANT_KV": "int8"} if quant else {}))
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = services("llama", **env)
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher

    for reqs in (requests, [(shared + "q", {}), (shared + "abcde", {}), ("zz", {})]):
        want = asyncio.run(_stream_all(JaxBatcher(jengine, jcfg), jbundle, JaxRawItem, reqs))
        got = asyncio.run(_stream_all(Batcher(engine, cfg), bundle, RawItem, reqs))
        assert got == want
    assert engine.prefix_cache.stats() == jengine.prefix_cache.stats()
    assert engine.prefix_cache.stats()["hits"] >= 2


def test_spec_continuous_with_two_dispatches_in_flight():
    """STREAM_PIPELINE=2: two chunks of verify rounds in flight, the same
    tokens."""
    got, want, batcher, _ = _both("gpt2", REQUESTS, **SPEC, STREAM_PIPELINE="2")
    assert got == want and batcher._cdl.chain_depth == 2


def test_hist_row_full_budget_chunk():
    """A first chunk that fills the whole decode budget (T5: chunk ==
    MAX_DECODE_LEN) clamps into the history's decoder region, start token
    first, as the JAX loop's row; a decoder-only row holds prompt and chunk
    where the cache embeds them."""
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = services(
        "t5-small", **SPEC, SEQ_BUCKETS="16", MAX_DECODE_LEN="8", STREAM_CHUNK_TOKENS="8")
    from mlmicroservicetemplate_tpu_torch.engine.streams import ContinuousDecodeLoop

    loop, jloop = ContinuousDecodeLoop(engine, cfg), JaxLoop(jengine, jcfg)
    loop._build_empty_state()
    jloop._build_empty_state()
    feats = _feats(bundle, RawItem, "abc")
    first = np.arange(1, 9, dtype=np.int32)
    row = loop._hist_row(feats, first)
    np.testing.assert_array_equal(row, jloop._hist_row(feats, first)[0])
    hoff = loop._hist_w - loop._kv_w
    assert row[hoff] == bundle.cfg.decoder_start_id
    np.testing.assert_array_equal(row[hoff + 1:], np.arange(1, 8))
    (jcfg, _, jengine), (cfg, bundle, engine, _) = services("gpt2", **SPEC)
    loop, jloop = ContinuousDecodeLoop(engine, cfg), JaxLoop(jengine, jcfg)
    loop._build_empty_state()
    jloop._build_empty_state()
    feats = _feats(bundle, RawItem, "hello there")
    np.testing.assert_array_equal(loop._hist_row(feats, first),
                                  jloop._hist_row(feats, first)[0])
    assert (loop._hist_w, loop._kv_w) == (jloop._hist_w, jloop._kv_w)


@pytest.mark.parametrize("model,extra", [
    ("llama", {}), ("t5-small", {}), ("llama", {"temperature": 0.8, "top_k": 40, "seed": 7}),
], ids=["llama-recast", "t5-replay", "llama-sampled-replay"])
def test_spec_loop_preempts_and_resumes_like_jax(model, extra):
    """Priority classes and preemption in the speculative loop: a batch
    stream holds the one slot, an interactive arrival preempts it, the
    victim resumes (a greedy llama by recast, whose history is rebuilt
    from the longer prompt; T5 and sampled rows by replay); both streams'
    tokens equal the JAX speculative loop's, greedy ones also the plain
    per-stream path's."""
    from test_torch_preempt import (
        BATCH_LEN,
        INTER_LEN,
        ONE_SLOT,
        _hold_first_chunk,
        _loops,
        _preempted,
        _prompt,
        _settle,
        _solo,
    )

    kw = dict(ONE_SLOT, spec_decode="ngram", spec_continuous=True, spec_k=4,
              spec_max_streams=0)
    jloop, jengine, loop, engine = _loops(model, **kw)
    assert loop.spec and jloop.spec
    batch = _prompt(BATCH_LEN, priority="batch", **extra)
    inter = _prompt(INTER_LEN, priority="interactive")
    outs = []
    for lp in (jloop, loop):
        _hold_first_chunk(lp)
        try:
            outs.append(asyncio.run(_preempted(lp, dict(batch), dict(inter))))
        finally:
            lp.stop()
        assert lp.preemptions >= 1, "the interactive arrival must preempt"
    assert list(outs[1]) == list(outs[0])
    if not extra:
        assert list(outs[1]) == [_solo(engine, batch), _solo(engine, inter)]
    assert loop.spec_rounds > 0 and (loop.recasts + loop.replays) >= 1
    _settle(loop, engine)
