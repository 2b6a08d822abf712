"""Chunked prefill's admission, pacing and surface against the JAX
package's, f32 on the CPU (the services of ``test_torch_prefill_loop.py``):

- ``PrefillPacer`` makes the JAX pacer's decisions over a seeded sequence.
- Routing: a prompt past the largest seq bucket joins the loop (never the
  per-stream path) and is marked ``chunked``; ``PREFILL_CHUNK=0`` leaves
  the loop's ceiling at the largest bucket and such a prompt on the
  per-stream path.
- A dry pool mid-prefill: the job is checkpointed holding no block, its
  reservation its first window, and resumes token-identically; both
  pools drain to 0.
- The ledger: ``kv_bytes_for_resume`` of a chunked prompt is its first
  window, as JAX's; the pool holds at most one block past the live tokens
  at JAX's ``(chunk, length)`` cases.
- Build gates: t5, ``PROMPT_PREFIX`` and a chunk off the block grid raise
  JAX's messages.
- A deadline that passes mid-prefill answers 504, as the JAX app does.
- ``/status``'s ``prefill`` body and the ``/metrics`` names and labels
  (``stream_ttft_seconds`` with its ``mode``) equal the JAX app's.
"""

import asyncio
import json
import os
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families
from test_torch_prefill_loop import (
    LOOP,
    PAGED,
    SMALL_LLAMA,
    feats,
    ids_of,
    loops,
    run_burst,
    services,
    settle,
)

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdmission
from mlmicroservicetemplate_tpu.scheduler.policy import PrefillPacer as JaxPacer
from mlmicroservicetemplate_tpu.utils import metrics as jax_metrics
from mlmicroservicetemplate_tpu.utils.config import load_config as jax_load_config
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import blocks_for
from mlmicroservicetemplate_tpu_torch.models.registry import build_model as port_build_model
from mlmicroservicetemplate_tpu_torch.scheduler.admission import AdmissionController
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.scheduler.policy import PrefillPacer
from mlmicroservicetemplate_tpu_torch.utils import metrics as port_metrics
from mlmicroservicetemplate_tpu_torch.utils.config import load_config as port_load_config


@pytest.mark.parametrize("weight", [1, 2, 4])
def test_pacer_decides_like_jax(weight):
    """Over a seeded sequence of (class, interactive decode live), the
    port's pacer allows and holds exactly the windows JAX's does."""
    rng = np.random.default_rng(weight)
    port, ref = PrefillPacer(weight), JaxPacer(weight)
    got, want = [], []
    for _ in range(200):
        klass = ("interactive", "batch")[int(rng.integers(0, 2))]
        live = bool(rng.integers(0, 2))
        got.append(port.allow(klass, live))
        want.append(ref.allow(klass, live))
    assert got == want
    assert port.holds == want.count(False) > (0 if weight > 1 else -1)
    assert port.recorder is None


async def _through_batcher(batcher, f):
    try:
        return [int(t) async for c in batcher.submit_stream(f) for t in np.asarray(c)]
    finally:
        await batcher.stop()


def test_an_oversized_prompt_joins_the_loop_chunked():
    """45 tokens, past the largest bucket (32): the loop prefills it in
    windows (the per-stream path is never called) and marks the feats the
    API submitted ``chunked``; the tokens are the JAX batcher's."""
    (jcfg, _, jengine), (cfg, _, engine, batcher) = services("gpt2", **LOOP)
    f = feats(ids_of(45, 2))

    def no_per_stream(feats):
        raise AssertionError("a prompt the loop takes went to the per-stream path")

    engine.generate_stream = jengine.generate_stream = no_per_stream
    submitted, jsubmitted = dict(f), dict(f)
    got = asyncio.run(_through_batcher(batcher, submitted))
    want = asyncio.run(_through_batcher(JaxBatcher(jengine, jcfg), jsubmitted))
    assert got == want and len(got) > 0
    assert submitted["prefill_mode"] == jsubmitted["prefill_mode"] == "chunked"
    assert batcher._cdl.prefill_chunk_dispatches == -(-45 // 4)


def test_prefill_chunk_off_leaves_routing_as_it_was():
    """``PREFILL_CHUNK=0``: the loop's ceiling is the largest bucket, no
    prompt chunks, and a 45-token prompt streams on the per-stream path."""
    (jcfg, _, jengine), (cfg, _, engine, batcher) = services("gpt2", **dict(LOOP,
                                                                           prefill_chunk=0))
    loop = batcher._cdl
    assert loop.prefill_chunk == 0 and loop.max_prompt == 32
    assert not engine.chunked_prefill_applies(64)
    calls = []
    per_stream = engine.generate_stream

    def counted(feats):
        calls.append(int(feats["length"]))
        return per_stream(feats)

    engine.generate_stream = counted
    f = feats(ids_of(45, 2))
    got = asyncio.run(_through_batcher(batcher, dict(f)))
    want = [int(t) for c in jengine.generate_stream(dict(f)) for t in c]
    assert got == want and calls == [45]
    assert "prefill_mode" not in f and loop.prefill_chunk_dispatches == 0


def test_dry_pool_mid_prefill_checkpoints_and_resumes_like_jax():
    """Fourteen 4-token blocks and two 30-token prompts at once: the windows
    run the pool dry, so a job is checkpointed mid-prefill; it then holds
    no block (the pool holds exactly the other holders' blocks), reserves
    its first window again, and resumes.  Tokens equal the JAX loop's,
    and both pools drain to 0."""
    bb = 2 * 2 * 2 * 16 * 4 * 4  # K/V x layers x KV heads x head_dim x f32 x block
    jloop, jengine, loop, engine = loops("llama", **dict(LOOP, **PAGED, max_stream_queue=4,
                                                         kv_budget_mb=14 * bb / 1e6))
    assert engine.kv_pool.num_blocks == jengine.kv_pool.num_blocks == 14
    seen = []
    checkpoint = loop._checkpoint_job

    def watched(job):
        checkpoint(job)
        held = sum(len(st.blocks.ids) for st in loop.active.values() if st.blocks is not None)
        held += sum(len(j.sb.ids) for j in loop._prefilling if j.sb is not None)
        seen.append((job.sb, engine.kv_pool.used_blocks, held, job.st.kv))

    loop._checkpoint_job = watched
    batch = [feats(ids_of(30, 7)), feats(ids_of(30, 8))]
    outs = []
    for lp in (jloop, loop):
        try:
            outs.append(asyncio.run(run_burst(lp, batch)))
        finally:
            lp.stop()
    assert outs[1] == outs[0] and all(len(t) > 0 for t in outs[1])
    assert loop.prefill_checkpoints >= 1 and seen
    for sb, used, held, kv in seen:
        assert sb is None and used == held
        assert kv == blocks_for(4, 4) * engine.kv_pool.block_bytes
    settle(loop)
    assert engine.kv_pool.used_blocks == jengine.kv_pool.used_blocks == 0


def test_kv_bytes_for_resume_of_a_chunked_prompt_is_its_first_window():
    (jcfg, _, jengine), (cfg, _, engine, _) = services(
        "llama", **dict(LOOP, paged_kv=True, kv_block_size=4, prefill_chunk=8,
                        kv_budget_mb=0.5))
    f = feats(np.arange(5, 35, dtype=np.int32))
    initial, worst = engine.kv_blocks_estimate(f)
    assert (initial, worst) == jengine.kv_blocks_estimate(f) == (2, blocks_for(30 + 12, 4))
    got = AdmissionController(cfg, engine).kv_bytes_for_resume(f)
    assert got == JaxAdmission(jcfg, jengine).kv_bytes_for_resume(f)
    assert got == initial * engine.kv_pool.block_bytes


@pytest.mark.parametrize("chunk,length", [(8, 19), (16, 30), (24, 30)])
def test_the_ledger_stays_within_a_block_of_the_live_tokens(chunk, length):
    """JAX's property cases: while a chunked stream prefills and decodes,
    the pool never holds more than its exact tokens' blocks plus one
    (windows grow off the exact length, not the padded bucket), and every
    block returns."""
    _, (_, _, engine, batcher) = services("gpt2", **dict(
        LOOP, paged_kv=True, kv_block_size=8, prefill_chunk=chunk, prefill_max_prompt=48))
    assert engine.chunked_prefill_applies(length)
    pool = engine.kv_pool
    high = [0]
    alloc = pool.alloc

    def watched(n):
        ids = alloc(n)
        high[0] = max(high[0], pool.used_blocks)
        return ids

    pool.alloc = watched
    loop = batcher._cdl
    try:
        out = asyncio.run(run_burst(loop, [feats(ids_of(length, 3))]))
    finally:
        loop.stop()
    assert len(out[0]) > 0
    assert high[0] <= blocks_for(length + engine.max_decode_len, 8) + 1
    if length == 19:
        assert high[0] < 6  # the monolithic reservation at bucket 32 holds 6
    settle(loop)
    assert pool.used_blocks == 0


def _refusal(build, load, env: dict) -> str:
    with pytest.raises(ValueError) as e:
        build(load(env))
    return str(e.value)


@pytest.mark.parametrize("case", ["t5", "prompt_prefix", "off_block_grid"])
def test_build_refuses_what_chunked_prefill_does_not_serve_like_jax(case):
    base = {"DEVICE": "cpu", "MODEL_NAME": "llama", "WARMUP": "0", "PREFILL_CHUNK": "16",
            "SEQ_BUCKETS": "16,32", "BATCH_BUCKETS": "1,2", "MAX_DECODE_LEN": "12",
            "LLAMA_CONFIG": json.dumps(SMALL_LLAMA)}
    env = dict(base, **{"t5": {"MODEL_NAME": "t5-small"},
                        "prompt_prefix": {"PROMPT_PREFIX": "sys"},
                        "off_block_grid": {"PAGED_KV": "1", "PREFILL_CHUNK": "12",
                                           "KV_BLOCK_SIZE": "8"}}[case])
    os.environ["LLAMA_CONFIG"] = env["LLAMA_CONFIG"]
    try:
        want = _refusal(jax_build_model, jax_load_config, env)
    finally:
        del os.environ["LLAMA_CONFIG"]
    assert _refusal(port_build_model, port_load_config, env) == want
    assert want.startswith("PREFILL_CHUNK")
    if case == "t5":
        return
    # A llama service with the knob builds (and its bundle has the windows).
    ok = dict(base, PAGED_KV="1", KV_BLOCK_SIZE="8") if case == "off_block_grid" else base
    assert port_build_model(port_load_config(ok)).prefill_chunk is not None


def _slow_windows(loop, seconds: float) -> None:
    orig = loop._dispatch_prefill_window

    def slow(job):
        time.sleep(seconds)
        return orig(job)

    loop._dispatch_prefill_window = slow


async def _http(app, posts, headers=None, warm=(), after_warm=None):
    """``warm`` bodies are posted first, without ``headers``, their answers
    read whole; then ``after_warm()``; then ``posts``."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        for body in warm:
            resp = await client.post("/v1/completions", json=body)
            assert resp.status == 200, await resp.text()
            await resp.read()
        if after_warm is not None:
            after_warm()
        out = []
        for body in posts:
            resp = await client.post("/v1/completions", json=body, headers=headers or {})
            out.append((resp.status, await resp.text()))
        status = (await (await client.get("/status")).json()).get("prefill")
        metrics = await (await client.get("/metrics")).text()
        return out, status, metrics
    finally:
        await client.close()


def _apps(**kw):
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = services("llama", **kw)
    jbatcher, batcher = JaxBatcher(jengine, jcfg), Batcher(engine, cfg)
    return ((jax_build_app(jcfg, jbundle, jengine, jbatcher), jbatcher),
            (build_app(cfg, bundle, engine, batcher), batcher))


def _deadline_after_first_window(loop, seconds: float) -> None:
    """The stream's deadline re-armed ``seconds`` ahead when its first
    window dispatches: it cannot pass in the queue or before that window,
    whatever the machine's load, and passes a few windows later."""
    orig = loop._dispatch_prefill_window
    armed = set()

    def first(job):
        if id(job.st) not in armed:
            armed.add(id(job.st))
            job.st.deadline = time.monotonic() + seconds
        return orig(job)

    loop._dispatch_prefill_window = first


def test_a_deadline_passing_mid_prefill_answers_504_like_jax():
    """A 60-byte streamed prompt (15 windows of 4), each window slowed by
    50 ms, with an ``X-Deadline-Ms`` deadline that the first window re-arms
    300 ms ahead: it passes mid-prefill, before the first token, and both
    apps answer 504.  A warm request of the same shape runs first, with no
    deadline and at full speed, so the timed one meets no first-call
    compile."""
    posts = [{"prompt": "x" * 60, "max_tokens": 4, "stream": True}]
    statuses = []
    for app, batcher in _apps(**LOOP):
        loop = batcher._cdl
        before = {}

        def slow_from_now():
            before["windows"] = loop.prefill_chunk_dispatches
            _slow_windows(loop, 0.05)
            _deadline_after_first_window(loop, 0.3)

        out, _, _ = asyncio.run(_http(app, posts, {"X-Deadline-Ms": "60000"}, warm=posts,
                                      after_warm=slow_from_now))
        statuses.append([s for s, _ in out])
        assert 0 < loop.prefill_chunk_dispatches - before["windows"] < 15
    assert statuses[1] == statuses[0] == [504]


def _families(text: str, names: tuple) -> dict:
    """{metric name: sorted label names of its samples} of ``names``."""
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in names:
            out[fam.name] = sorted({k for s in fam.samples for k in s.labels})
    return out


def test_status_prefill_and_metrics_match_the_jax_app():
    """After the same streamed requests (one chunked, one monolithic) the
    ``/status`` ``prefill`` bodies are equal but for the measured stall
    seconds, and the chunked prefill's metrics and ``stream_ttft_seconds``
    carry JAX's names and labels, a ``mode="chunked"`` sample among them."""
    posts = [{"prompt": "a chunked prompt of forty-five bytes or so....", "max_tokens": 4,
              "stream": True},
             {"prompt": "hi", "max_tokens": 4, "stream": True}]
    got = []
    for app, _ in _apps(**dict(LOOP, prefill_budget=8, prefill_max_prompt=64)):
        out, status, metrics = asyncio.run(_http(app, posts))
        assert [s for s, _ in out] == [200, 200]
        got.append((out, status, metrics))
    (jout, jstatus, jmetrics), (out, status, metrics) = got
    assert [t.count("data:") for _, t in out] == [t.count("data:") for _, t in jout]
    stall, jstall = status.pop("stall_seconds"), jstatus.pop("stall_seconds")
    assert status == jstatus and stall >= 0 and jstall >= 0
    assert status["chunk"] == 4 and status["budget"] == 8 and status["max_prompt"] == 64
    assert status["chunks_total"] > 0 and status["backlog_tokens"] == 0
    names = ("prefill_chunks", "prefill_stall_seconds", "prefill_backlog_tokens",
             "stream_ttft_seconds")
    assert _families(metrics, names) == _families(jmetrics, names)
    assert set(_families(metrics, names)) == set(names)
    for text in (metrics, jmetrics):
        assert 'stream_ttft_seconds_count{mode="chunked",model="llama"}' in text
        assert 'stream_ttft_seconds_count{mode="monolithic",model="llama"}' in text
    assert port_metrics.TTFT._labelnames == jax_metrics.TTFT._labelnames
