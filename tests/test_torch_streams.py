"""The port's continuous decode loop against the JAX package's
``ContinuousDecodeLoop`` on the same llama weights (the JAX params carried
across by ``llama_params_from_jax``), f32 on the CPU, for ``PAGED_KV`` 0
and 1 with a dense and an int8 KV cache.

- Concurrent streams of different prompt lengths and ``max_tokens``,
  admitted in one wave, late into a live batch and into reused slots, get
  tokens identical to the JAX loop's; the paged pool drains to 0 blocks.
- A cancelled consumer frees its slot; ``max_streams + 1`` concurrent
  streams shed ``QueueFullError``; without a supervisor a failed dispatch
  ends the live streams with its error and the loop serves again; stopping ends waiting streams
  with ``StreamClosedError``; streams and whole requests racing for the
  engine leak nothing and get the tokens the whole path gives.
- On the CPU no kernel launch is counted."""

import asyncio
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.engine.streams import StreamClosedError
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
from mlmicroservicetemplate_tpu_torch.scheduler.policy import QueueFullError
from mlmicroservicetemplate_tpu_torch.serve import build_service

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
             stream_chunk_tokens=4, max_streams=4)
# (text, max_tokens): a first wave of three, one late arrival, then four
# concurrent streams into reused slots; prompts in both seq buckets.
ROUND_A = [("hi", None), ("the quick brown fox", 3), ("serving tokens, twice", 7)]
LATE = ("a late arrival", 5)
ROUND_B = [("a", None), ("streams share one batch", 9), ("xyz", 2), ("more text", None)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _overrides(paged: bool, quant: bool, **extra) -> dict:
    ov = {
        "MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
        "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
        "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "PAGED_KV": "1" if paged else "0",
        "KV_BLOCK_SIZE": "8",
    }
    if quant:
        ov["QUANT_KV"] = "int8"
    ov.update(extra)
    return ov


def _jax_loop(paged: bool, quant: bool):
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        cfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False,
                               paged_kv=paged, kv_block_size=8,
                               quant_kv="int8" if quant else None, **SERVE)
        bundle = jax_build_model(cfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    return bundle, JaxLoop(JaxEngine(bundle, cfg, ReplicaSet(make_mesh(1))), cfg)


async def _consume(gen, first=None) -> list[int]:
    out = []
    async for chunk in gen:
        out.extend(np.asarray(chunk).tolist())
        if first is not None:
            first.set()
    return out


async def _drive(loop, preprocess) -> list[list[int]]:
    """Round A (three at once, one more once the first stream has its
    first chunk), then, once round A's slots are released, round B (four
    at once)."""
    first = asyncio.Event()
    tasks = [asyncio.create_task(_consume(loop.submit_stream(preprocess(t, m)),
                                          first if i == 0 else None))
             for i, (t, m) in enumerate(ROUND_A)]
    await first.wait()
    tasks.append(asyncio.create_task(_consume(loop.submit_stream(preprocess(*LATE)))))
    out = await asyncio.gather(*tasks)
    for _ in range(250):
        if loop._admitted == 0:
            break
        await asyncio.sleep(0.02)
    return out + list(await asyncio.gather(*(_consume(loop.submit_stream(preprocess(t, m)))
                                             for t, m in ROUND_B)))


def _wait(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_streams_match_the_jax_loop(paged, quant):
    jbundle, jloop = _jax_loop(paged, quant)
    try:
        want = asyncio.run(_drive(
            jloop, lambda t, m: jbundle.preprocess(JaxRawItem(text=t, max_tokens=m))))
    finally:
        jloop.stop()
    params = jax.tree.map(np.asarray, jbundle.params)
    _, bundle, engine, batcher = build_service(_overrides(paged, quant), params=params)
    loop = batcher._cdl
    launches = (decode_attention.launches, paged_decode_attention.launches)
    try:
        got = asyncio.run(_drive(
            loop, lambda t, m: bundle.preprocess(RawItem(text=t, max_tokens=m))))
    finally:
        loop.stop()
    assert (decode_attention.launches, paged_decode_attention.launches) == launches
    assert got == want
    budgets = [m or engine.max_decode_len for _, m in ROUND_A + [LATE] + ROUND_B]
    assert [len(g) for g in got] == [min(b, engine.max_decode_len) for b in budgets]
    assert loop.prefill_dispatches >= 3 and loop.chunk_dispatches > 0
    assert loop.decode_steps == loop.chunk_dispatches * engine.chunk_tokens
    assert _wait(lambda: loop.admitted == 0)
    if paged:
        assert engine.kv_pool.used_blocks == 0
        assert (loop._table == engine.kv_pool.num_blocks).all()


@pytest.fixture(params=[False, True], ids=["contiguous", "paged"])
def service(request):
    svc = build_service(_overrides(request.param, False, MAX_STREAMS="2", MAX_DECODE_LEN="32"))
    yield svc
    svc[3]._cdl.stop()


def _feats(bundle, text="spans several chunks of decode", max_tokens=None):
    return bundle.preprocess(RawItem(text=text, max_tokens=max_tokens))


def test_cancelled_consumer_frees_its_slot(service):
    _, bundle, engine, batcher = service
    loop = batcher._cdl

    async def body():
        gen = loop.submit_stream(_feats(bundle))
        async for _ in gen:
            break  # the client leaves after the first chunk
        await gen.aclose()
        for _ in range(200):
            if loop.admitted == 0:
                break
            await asyncio.sleep(0.02)
        assert loop.admitted == 0
        return await _consume(loop.submit_stream(_feats(bundle)))

    assert len(asyncio.run(body())) == engine.max_decode_len
    if engine.paged_kv:
        assert _wait(lambda: engine.kv_pool.used_blocks == 0)


def test_one_stream_past_max_streams_sheds(service):
    _, bundle, _, batcher = service
    loop = batcher._cdl

    async def body():
        gens = [loop.submit_stream(_feats(bundle, max_tokens=4)) for _ in range(loop.max_streams)]
        with pytest.raises(QueueFullError):
            loop.submit_stream(_feats(bundle))
        return [await _consume(g) for g in gens]

    assert [len(out) for out in asyncio.run(body())] == [4] * loop.max_streams
    assert _wait(lambda: loop.admitted == 0)


def test_failed_dispatch_ends_live_streams_and_the_loop_serves_again(service):
    """Without a supervisor (SUPERVISE=0, as the JAX loop without one): a
    failed chunk ends the live stream with its error.  The supervised
    recovery of the default is held against the JAX loop in
    tests/test_torch_faults.py."""
    _, bundle, engine, batcher = service
    loop = batcher._cdl
    sup, loop.supervisor = loop.supervisor, None
    name = "paged_chunk" if engine.paged_kv else "generate_chunk"
    real = getattr(bundle, name)
    armed = {"on": True}

    def flaky(*args):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected device fault")
        return real(*args)

    setattr(bundle, name, flaky)
    try:
        async def body():
            with pytest.raises(RuntimeError, match="injected device fault"):
                await _consume(loop.submit_stream(_feats(bundle)))
            for _ in range(200):
                if loop.admitted == 0:
                    break
                await asyncio.sleep(0.02)
            assert loop.admitted == 0, "the failure path leaked an admission"
            return await _consume(loop.submit_stream(_feats(bundle, max_tokens=6)))

        assert len(asyncio.run(body())) == 6
    finally:
        setattr(bundle, name, real)
        loop.supervisor = sup
    if engine.paged_kv:
        assert _wait(lambda: engine.kv_pool.used_blocks == 0)


def test_stop_ends_waiting_streams():
    _, bundle, engine, batcher = build_service(_overrides(True, False, MAX_STREAMS="1"))
    loop = batcher._cdl

    async def body():
        gen = loop.submit_stream(_feats(bundle))
        await asyncio.get_running_loop().run_in_executor(None, loop.stop)
        with pytest.raises(StreamClosedError):
            await _consume(gen)

    asyncio.run(body())
    assert loop.admitted == 0 and engine.kv_pool.used_blocks == 0
    with pytest.raises(RuntimeError, match="stopped"):
        asyncio.run(_consume(loop.submit_stream(_feats(bundle))))


def test_streams_and_whole_requests_share_the_engine_under_churn(service):
    """Time-bounded stress with a short switch interval: whole requests
    through ``Batcher.submit`` and streams racing for too few slots
    (retried when shed, some consumers leaving early) all finish; every
    stream read to the end gets the tokens of the same prompt served
    whole, and no slot, admission or block leaks."""
    _, bundle, engine, batcher = service
    loop = batcher._cdl
    rng = np.random.default_rng(3)
    words = ["churn", "slot", "chunk", "block", "wave"]
    items = [(" ".join(rng.choice(words, size=int(rng.integers(1, 6)))),
              int(rng.integers(1, 20))) for _ in range(12)]
    want = engine.run_batch([_feats(bundle, t, m) for t, m in items])

    async def stream(i, text, max_tokens):
        while True:
            try:
                gen = loop.submit_stream(_feats(bundle, text, max_tokens))
                break
            except QueueFullError:
                await asyncio.sleep(0.01)
        if i % 4 == 3:  # leaves after the first chunk
            async for _ in gen:
                break
            await gen.aclose()
            return None
        return await _consume(gen)

    async def body():
        await batcher.start()
        try:
            whole = [batcher.submit(_feats(bundle, t, m)) for t, m in items[:4]]
            streamed = [stream(i, t, m) for i, (t, m) in enumerate(items)]
            return await asyncio.wait_for(asyncio.gather(*whole, *streamed), 120)
        finally:
            await batcher.stop()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = asyncio.run(body())
    finally:
        sys.setswitchinterval(interval)
    for got, row in zip(out[:4], want):
        np.testing.assert_array_equal(got, row)
    eos = bundle.cfg.eos_id
    for i, (got, row) in enumerate(zip(out[4:], want)):
        if got is None:
            continue
        budget = min(items[i][1], engine.max_decode_len)
        assert got == row[: len(got)].tolist()
        # The whole budget, or (EOS) through the end of the chunk holding it.
        assert len(got) == budget or (eos in got and len(got) <= budget)
    assert loop.admitted == 0 and not loop.active and sorted(loop.free) == list(range(2))
    if engine.paged_kv:
        assert engine.kv_pool.used_blocks == 0
