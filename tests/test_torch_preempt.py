"""Preemption, checkpoint-resume and the dry-pool requeue of the port's
continuous loop against the JAX package's ``ContinuousDecodeLoop``, each
with its own ``AdmissionController``, on the same weights and prompts, f32
on the CPU, at small llama, GPT-2 and T5 configs:

- An interactive stream arriving while a batch-class stream holds the only
  slot preempts it; the preempted stream resumes token-identically, by
  replay (T5; sampled llama) or recast (greedy llama and GPT-2, contiguous
  and paged): both streams get the tokens of an unpreempted run, and the
  JAX loop's.
- The checkpoint releases the stream's KV reservation and re-estimates its
  footprint off the recast prompt, to the JAX loop's numbers.
- A paged pool that runs dry at growth, or at a wave's insert, checkpoints
  a stream and resumes it token-identically; nothing raises and the pool
  drains.
- An unseeded sampled stream gets its seed at admission, so its replay
  draws the tokens its first run delivered (the JAX engine's for that seed).
- A replay whose regenerated tokens part from those it delivered resumes
  as a recast with its key chain moved past them (the port's guard for the
  card's bf16 draws; on the CPU the parting is forced).
- Over HTTP, ``X-Priority: batch`` is served: ``/predict``, ndjson and SSE
  bodies and ``/status``'s KV ledger equal the JAX app's; the per-stream
  path sheds ``drain`` and ``kv_budget`` as the JAX batcher does.

The preemption window is made certain by holding the loop's first chunk
dispatch after admission (both packages call ``_dispatch_chunk`` once per
live chunk) until the interactive stream waits in its queue or has
preempted."""

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
from test_torch_t5_serving import LM_HEAD, small_t5

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdmission
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service

SMALL_LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
                   d_ff=512, max_position=128)
# One slot, room to wait, 6 chunks of budget: a batch stream is still live
# when the interactive one arrives.
ONE_SLOT = dict(batch_buckets=(1, 2), seq_buckets=(16, 32, 64), max_decode_len=24,
                stream_chunk_tokens=4, max_streams=1, max_stream_queue=4, preempt=True)
# Prompt lengths of the batch and the interactive stream: random ids, whose
# greedy runs reach the budget at each small config (a random head often
# ends a text prompt at once).
BATCH_LEN, INTER_LEN = 20, 9


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _model_ctx(model: str):
    """Both packages' builders at the small config of ``model``."""
    ctx = {"gpt2": small_gpt2, "t5-small": small_t5}.get(model, contextlib.nullcontext)
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL_LLAMA)
    try:
        with ctx():
            yield
    finally:
        del os.environ["LLAMA_CONFIG"]


def _env(kw: dict) -> dict:
    return {k.upper(): (",".join(map(str, v)) if isinstance(v, tuple)
                        else ("1" if v else "0") if isinstance(v, bool) else str(v))
            for k, v in kw.items()}


def _services(model: str, **kw):
    """The JAX (cfg, bundle, engine) and the port (cfg, bundle, engine,
    batcher) of ``model`` on the same weights, at ``kw``."""
    with _model_ctx(model):
        jcfg = JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                                batch_timeout_ms=1.0, **kw)
        jbundle = jax_build_model(jcfg)
        if model == "t5-small":
            jbundle.params["lm_head"] = {"kernel": LM_HEAD}  # a tied random head locks
        jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
        port = build_service({"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0",
                              "LLAMA_CONFIG": json.dumps(SMALL_LLAMA), "BATCH_TIMEOUT_MS": "1",
                              **_env(kw)}, params=jax.tree.map(np.asarray, jbundle.params))
    return (jcfg, jbundle, jengine), port


def _loops(model: str, **kw):
    """(JAX loop, JAX engine, port loop, port engine)."""
    (jcfg, _, jengine), (_, _, engine, batcher) = _services(model, **kw)
    jloop = JaxLoop(jengine, jcfg)
    jloop.admission = JaxAdmission(jcfg, jengine)
    return jloop, jengine, batcher._cdl, engine


def _prompt(n: int, ids_seed: int = 4, **extra) -> dict:
    ids = np.random.default_rng(ids_seed + n).integers(5, 250, n).astype(np.int32)
    return {"input_ids": ids, "length": np.int32(n), **extra}


def _hold_first_chunk(loop) -> None:
    """The loop's first chunk dispatch waits until an interactive stream is
    queued (or the loop has preempted already: the arrival came before the
    iteration that dispatches); later ones pass."""
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


async def _collect(gen) -> list[int]:
    return [int(t) async for chunk in _chunks(gen) for t in chunk]


async def _chunks(gen):
    async for chunk in gen:
        yield np.asarray(chunk).tolist()


async def _preempted(loop, batch_feats: dict, inter_feats: dict):
    """A batch stream holds the slot (its first chunk read), an interactive
    one arrives: (batch tokens, interactive tokens)."""
    g_b = loop.submit_stream(batch_feats)
    first = np.asarray(await g_b.__anext__()).tolist()
    out_i = await _collect(loop.submit_stream(inter_feats))
    return first + await _collect(g_b), out_i


def _solo(engine, feats: dict) -> list[int]:
    return [int(t) for chunk in engine.generate_stream(dict(feats)) for t in chunk]


def _settle(loop, engine, timeout: float = 10.0) -> None:
    t_end = time.monotonic() + timeout
    while loop._admitted and time.monotonic() < t_end:
        time.sleep(0.01)
    assert loop._admitted == 0
    if engine.paged_kv:
        assert engine.kv_pool.used_blocks == 0


@pytest.mark.parametrize("model,extra,resume", [
    ("t5-small", {}, "replay"),
    ("llama", {"temperature": 0.8, "top_k": 40, "seed": 7}, "replay"),
    ("llama", {}, "recast"),
    ("gpt2", {}, "recast"),
    ("llama-paged", {}, "recast"),
], ids=["t5-replay", "llama-sampled-replay", "llama-recast", "gpt2-recast",
        "llama-paged-recast"])
def test_interactive_preempts_batch_and_resumes_like_jax(model, extra, resume):
    paged = model.endswith("-paged")
    kw = dict(ONE_SLOT, **(dict(paged_kv=True, kv_block_size=8) if paged else {}))
    jloop, jengine, loop, engine = _loops(model.removesuffix("-paged"), **kw)
    batch = _prompt(BATCH_LEN, priority="batch", **extra)
    inter = _prompt(INTER_LEN, priority="interactive")
    refs = [_solo(engine, batch), _solo(engine, inter)]
    assert refs == [_solo(jengine, batch), _solo(jengine, inter)]
    outs = []
    for lp, eng in ((jloop, jengine), (loop, engine)):
        _hold_first_chunk(lp)
        try:
            outs.append(asyncio.run(_preempted(lp, dict(batch), dict(inter))))
        finally:
            lp.stop()
        assert lp.preemptions >= 1, "the interactive arrival must preempt"
    assert list(outs[1]) == list(outs[0]) == refs
    assert len(refs[0]) > 2 * engine.chunk_tokens  # preempted mid-generation
    assert (loop.recasts > 0, loop.replays > 0) == (resume == "recast", resume == "replay")
    _settle(loop, engine)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_a_replay_that_parts_resumes_as_a_recast(paged):
    """A sampled replay whose regenerated tokens part from those it
    delivered (on the card, bf16 draws of another batch shape at a near
    tie; here one suppressed token is altered) leaves its slot at the next
    iteration top and resumes as a recast: its delivered tokens join the
    prompt and its key chain moves past them, so it gets the tokens of its
    unpreempted run all the same."""
    kw = dict(ONE_SLOT, **(dict(paged_kv=True, kv_block_size=8) if paged else {}))
    jloop, _, loop, engine = _loops("llama", **kw)
    jloop.stop()
    batch = _prompt(BATCH_LEN, priority="batch", temperature=0.8, top_k=40, seed=7)
    inter = _prompt(INTER_LEN, priority="interactive")
    refs = [_solo(engine, batch), _solo(engine, inter)]
    emit, altered = loop._emit_tokens, []

    def altering(st, chunk):
        arr = np.array(chunk)
        if st.skip and not altered:
            k = min(st.skip, int(arr.size))
            arr[k - 1] = 5 + (int(arr[k - 1]) + 1) % 250
            altered.append(k)
        return emit(st, arr)

    loop._emit_tokens = altering
    _hold_first_chunk(loop)
    try:
        got = asyncio.run(_preempted(loop, dict(batch), dict(inter)))
    finally:
        loop.stop()
    assert altered and loop.replays == 1 and loop.replays_parted == 1
    assert loop.recasts == 1  # the parted replay's resume
    assert list(got) == refs
    _settle(loop, engine)


def test_a_victim_admitted_again_at_once_gets_no_stale_tokens():
    """Two batch streams in two slots, two interactive arrivals: both
    batch streams are preempted, and with ``CLASS_WEIGHT=1`` the wave
    takes one of them back at once, into the slot it left, while the
    chunk dispatched before the preemption is still in flight.  That
    chunk's row for the slot is not the resumed stream's: every stream
    gets the tokens of its unpreempted run (the JAX engine's)."""
    kw = dict(ONE_SLOT, max_streams=2, class_weight=1)
    jloop, jengine, loop, engine = _loops("llama", **kw)
    jloop.stop()
    batch = [_prompt(BATCH_LEN, ids_seed, priority="batch") for ids_seed in (4, 5)]
    inter = [_prompt(INTER_LEN, ids_seed) for ids_seed in (6, 7)]
    orig = loop._dispatch_chunk
    at_gate, opened = threading.Event(), threading.Event()

    def held():
        """The first chunk of the two batch streams waits here until both
        interactive streams are queued: the next iteration top preempts
        with that chunk in flight."""
        at_gate.set()
        t_end = time.monotonic() + 30.0
        while not opened.is_set():
            if loop.queue.waiting("interactive") >= 2 or time.monotonic() > t_end:
                opened.set()
            else:
                time.sleep(0.002)
        return orig()

    loop._dispatch_chunk = held

    async def drive():
        batch_runs = [asyncio.create_task(_collect(loop.submit_stream(dict(f))))
                      for f in batch]
        while not at_gate.is_set():
            await asyncio.sleep(0.002)
        inter_runs = [asyncio.create_task(_collect(loop.submit_stream(dict(f))))
                      for f in inter]
        return list(await asyncio.gather(*batch_runs, *inter_runs))

    try:
        got = asyncio.run(drive())
    finally:
        loop.stop()
    assert loop.preemptions == 2
    assert got == [_solo(jengine, f) for f in batch + inter]
    _settle(loop, engine)


def test_checkpoint_releases_kv_and_refreshes_footprint_like_jax():
    """At the checkpoint the ledger holds nothing (the victim released, the
    interactive stream reserves only when it leaves the queue), and the
    recast footprint is estimated off the longer prompt."""
    kw = dict(ONE_SLOT, kv_budget_mb=64.0)
    jloop, jengine, loop, engine = _loops("gpt2", **kw)
    batch = _prompt(14, priority="batch")  # bucket 16; the recast's is 32
    inter = _prompt(INTER_LEN)
    got = []
    for lp in (jloop, loop):
        seen = {}
        orig = lp._requeue_preempted

        def spy(st, lp=lp, orig=orig, seen=seen):
            seen.setdefault("committed", lp.admission.committed_bytes)
            seen.setdefault("kv_before", st.kv)
            orig(st)
            seen.setdefault("kv_after", st.kv)
            seen.setdefault("length", int(st.feats["length"]))

        lp._requeue_preempted = spy
        _hold_first_chunk(lp)
        try:
            out_b, _ = asyncio.run(_preempted(lp, dict(batch), dict(inter)))
        finally:
            lp.stop()
        got.append((seen, out_b))
    assert got[0] == got[1]
    seen, out_b = got[1]
    assert seen["committed"] == 0
    assert seen["length"] > int(batch["length"]) and seen["kv_after"] > seen["kv_before"]
    assert out_b == _solo(engine, batch)
    assert loop.admission.committed_bytes == 0


def _paged_gpt2(blocks: int):
    """Small GPT-2, 8-token blocks, a pool of ``blocks`` blocks (by
    ``KV_BUDGET_MB``), two 14-token prompts (bucket 16: 3 blocks each at
    insert, 4 at their last chunk)."""
    bb = 2 * 2 * 4 * 32 * 4 * 8  # K/V x layers x heads x head_dim x f32 x block
    kw = dict(batch_buckets=(1, 2), seq_buckets=(16, 32), max_decode_len=10,
              stream_chunk_tokens=4, max_streams=2, max_stream_queue=4, paged_kv=True,
              kv_block_size=8, kv_budget_mb=blocks * bb / 1e6)
    jloop, jengine, loop, engine = _loops("gpt2", **kw)
    assert engine.kv_pool.num_blocks == jengine.kv_pool.num_blocks == blocks
    return jloop, jengine, loop, engine, [_prompt(14, ids_seed) for ids_seed in (1, 2)]


async def _together(loop, prompts) -> list[list[int]]:
    return list(await asyncio.gather(*(_collect(loop.submit_stream(dict(f))) for f in prompts)))


@pytest.mark.parametrize("blocks,site", [(6, "growth"), (5, "insert")])
def test_dry_pool_checkpoints_and_resumes_like_jax(blocks, site):
    """6 blocks: both streams insert, and growth to their fourth block runs
    dry; 5 blocks: each fits the dequeue gate alone, the wave's second
    insert finds the pool dry.  Either way one stream is checkpointed and
    resumes token-identically once blocks free."""
    jloop, jengine, loop, engine, prompts = _paged_gpt2(blocks)
    outs = []
    for lp in (jloop, loop):
        try:
            outs.append(asyncio.run(_together(lp, prompts)))
        finally:
            lp.stop()
    assert outs[1] == outs[0] == [_solo(engine, f) for f in prompts]
    assert loop.kv_growth_stalls >= 1 and loop.recasts >= 1 and loop.preemptions == 0
    _settle(loop, engine)
    assert (loop._table == engine.kv_pool.num_blocks).all()


def test_unseeded_sampled_stream_resumes_with_its_pinned_seed():
    jloop, jengine, loop, engine = _loops("llama", **ONE_SLOT)
    inter = _prompt(INTER_LEN)
    outs = []
    for lp in (jloop, loop):
        batch = _prompt(BATCH_LEN, priority="batch", temperature=1.0, top_k=50)
        _hold_first_chunk(lp)
        try:
            out_b, _ = asyncio.run(_preempted(lp, batch, dict(inter)))
        finally:
            lp.stop()
        assert lp.preemptions >= 1 and batch.get("seed") is not None
        outs.append((out_b, batch))
    for (out_b, batch), eng in zip(outs, (jengine, engine)):
        assert out_b == _solo(eng, batch)
    port_out, port_feats = outs[1]
    assert port_out == _solo(jengine, port_feats)  # the JAX draws of that seed
    assert loop.replays >= 1


# ---------------------------------------------------------------------------
# HTTP and the per-stream path

HTTP_SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
                  stream_chunk_tokens=4, max_streams=2, max_stream_queue=2, kv_budget_mb=8.0)


def _count_idle_pops(loop) -> list:
    """Count the loop's queue pops: once every response is in, no stream
    arrives, so a pop is the loop's idle wait at an iteration top."""
    calls = [0]
    pop = loop.queue.pop

    def counted(*a, **kw):
        calls[0] += 1
        return pop(*a, **kw)

    loop.queue.pop = counted
    return calls


async def _http(app, posts, loop=None):
    calls = None if loop is None else _count_idle_pops(loop)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        out = []
        for path, body, headers in posts:
            resp = await client.post(path, json=body, headers=headers)
            out.append((resp.status, await resp.text()))
        if calls is not None:
            # A stream's end reaches its client before the loop releases its
            # KV commitment (``_finish``: emit, then release): under load
            # /status can land in between.  Settle both loops by waiting for
            # two idle pops to start after the last response, so the
            # iteration that ended the last stream has run to its end.
            seen = calls[0]
            for _ in range(400):
                if calls[0] >= seen + 2:
                    break
                await asyncio.sleep(0.025)
        status = await (await client.get("/status")).json()
        return out, status["scheduler"]
    finally:
        await client.close()


def _comparable(path: str, body: dict, text: str):
    if body.get("stream"):
        if path == "/predict":
            lines = [json.loads(ln) for ln in text.splitlines() if ln]
            lines[-1].pop("timing_ms")
            return lines
        return [f for f in text.split("\n\n") if f]
    answer = json.loads(text)
    answer.pop("timing_ms", None)
    return answer


def test_batch_priority_over_http_like_jax():
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = _services("llama", **HTTP_SERVE)
    batch = {"X-Priority": "batch", "X-Request-Id": "r1"}
    posts = [
        ("/predict", {"text": "hi there", "max_tokens": 6}, batch),
        ("/predict", {"text": "the quick brown fox", "stream": True}, batch),
        ("/v1/completions", {"prompt": "hello", "stream": True, "max_tokens": 7}, batch),
        ("/predict", {"text": "seeded", "stream": True, "temperature": 0.9, "seed": 3},
         {"X-Priority": "batch", "X-Deadline-Ms": "60000", "X-Request-Id": "r2"}),
        ("/predict", {"text": "hi"}, {"X-Priority": "Batch", "X-Request-Id": "r3"}),
        ("/predict", {"text": "hi"}, {"X-Priority": "urgent", "X-Request-Id": "r4"}),
    ]
    jbatcher = JaxBatcher(jengine, jcfg)
    want, jsched = asyncio.run(_http(
        jax_build_app(jcfg, jbundle, jengine, jbatcher), posts, jbatcher._cdl))
    batcher = Batcher(engine, cfg)
    got, sched = asyncio.run(_http(build_app(cfg, bundle, engine, batcher), posts,
                                   batcher._cdl))
    assert [s for s, _ in got] == [s for s, _ in want] == [200] * 5 + [400]
    for (path, body, _), (_, g), (_, w) in zip(posts[:5], got, want):
        assert _comparable(path, body, g) == _comparable(path, body, w)
    # Every key the JAX app's section has (the port adds ``pending``); the
    # rest of /status: tests/test_torch_status.py.
    assert set(sched) - {"pending"} == set(jsched)
    for key in jsched:
        assert sched[key] == jsched[key], key
    assert sched["kv_budget_bytes"] == 8_000_000 and sched["kv_committed_bytes"] == 0


@pytest.mark.parametrize("gate", ["drain", "kv_budget"])
def test_per_stream_path_sheds_like_jax(gate):
    kw = dict(HTTP_SERVE, continuous_batching=False)
    if gate == "kv_budget":
        kw["kv_budget_mb"] = 0.01  # below one stream's footprint
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = _services("llama", **kw)
    feats = jbundle.preprocess(JaxRawItem(text="hi", max_tokens=4))
    reasons = []
    for batcher in (JaxBatcher(jengine, jcfg), Batcher(engine, cfg)):
        if gate == "drain":
            batcher.begin_drain()
        with pytest.raises(Exception) as e:
            batcher.submit_stream(dict(feats))
        reasons.append((type(e.value).__name__, e.value.reason))
        asyncio.run(batcher.stop())
    assert reasons[1] == reasons[0] == ("QueueFullError", gate)
