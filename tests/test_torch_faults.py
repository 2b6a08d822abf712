"""Fault injection, the dispatch watchdog and supervised recovery of the port
(``engine/faults.py``, ``engine/supervisor.py``, the loop's ``_recover``)
against the JAX package's, f32 on the CPU:

- ``parse_spec`` and the seeded firing schedule equal the reference's for
  the same spec strings and seeds; ``rN:`` rules for N != 0 never fire on
  the one engine;
- the watchdog retries transients with backoff and cuts a dispatch that
  hangs (deadlines far above CPU-load jitter: a dispatch that blocks until
  released, never a sub-second wall race), and a dispatch cut while it hung
  in the injector never runs;
- the supervisor's lifetime and sliding-window budgets on an injected
  clock;
- the classification of CUDA errors by the messages torch raises: sticky
  ones poison the context, out-of-memory does not;
- a fatal chunk fault mid-decode in the paged and the contiguous loop,
  greedy and seeded-sampled, gives the tokens and the ``restarts`` of the
  JAX loop under the same ``FAULT_SPEC``, and the tokens of a clean run;
  transient faults are invisible; a hang cut by the watchdog recovers; a
  poisoned context fails the supervisor outright;
- a spent budget fails the streams, and ``/readyz`` and
  ``/status.fault_tolerance`` of both apps alike.
"""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine import faults as jax_faults
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.engine.supervisor import Supervisor as JaxSupervisor
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.engine import faults
from mlmicroservicetemplate_tpu_torch.engine.supervisor import Supervisor
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.serve import build_service

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=12,
             stream_chunk_tokens=4, max_streams=4)
TEXTS = [("hello there", None), ("the quick brown fox", 9), ("serving tokens", None)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the grammar and the seeded schedule

SPECS = ["chunk:fatal@5", "chunk:transient@2+3", "*:transient~0.25", "grow:oob@2+3",
         "hang(1.5)@1", "r1:chunk:fatal@3;chunk:transient~0.5", "r0:chunk:device_lost(1)@4",
         "prefill_chunk:fatal@2; fetch:transient~0.1 ;", "handoff:hang(2)@1+2;swap:oob~1"]


def _rules(mod, spec):
    return [(repr(r), r.site, r.kind, r.arg, r.nth, r.count, r.rate, r.replica)
            for r in mod.parse_spec(spec)]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    assert _rules(faults, spec) == _rules(jax_faults, spec)


@pytest.mark.parametrize("spec", ["chunk:explode@1", "bogus:fatal@1", "fatal", "fatal~2.0",
                                  "chunk:fatal@x", "r:chunk:fatal@1"])
def test_bad_specs_are_refused_like_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        faults.parse_spec(spec)
    assert str(got.value) == str(want.value)


def _schedule(mod, spec, seed, sites):
    inj = mod.FaultInjector.from_spec(spec, seed)
    out = []
    for site in sites:
        try:
            inj.fire(site)
            out.append(None)
        except Exception as e:
            out.append(type(e).__name__)
    return out, [(r.seen, r.fired) for r in inj.rules]


@pytest.mark.parametrize("spec,seed", [("*:fatal~0.3", 7), ("*:fatal~0.3", 8),
                                       ("chunk:transient@2+3;*:fatal~0.1", 3),
                                       ("r1:chunk:fatal@1;chunk:transient~0.5", 11),
                                       ("fetch:oob@2;chunk:device_lost@3;prefill:fatal~0.2", 5)])
def test_seeded_schedule_matches_jax(spec, seed):
    sites = ["chunk", "fetch", "prefill", "chunk", "grow", "chunk", "fetch"] * 12
    assert _schedule(faults, spec, seed, sites) == _schedule(jax_faults, spec, seed, sites)


def test_rules_of_another_replica_never_fire():
    assert faults.FaultInjector.from_spec("r1:chunk:fatal@1") is None
    inj = faults.FaultInjector.from_spec("r1:chunk:fatal@1;r0:chunk:fatal@2")
    assert [r.replica for r in inj.rules] == [0]
    inj.fire("chunk")
    with pytest.raises(faults.FatalDeviceError):
        inj.fire("chunk")


# ---------------------------------------------------------------------------
# the watchdog and the supervisor


def test_watchdog_retries_transients_with_capped_backoff(monkeypatch):
    sleeps = []
    monkeypatch.setattr(faults.time, "sleep", sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise faults.TransientDeviceError("flaky")
        return "ok"

    wd = faults.Watchdog("m", retries=3, backoff_s=1.5)
    assert wd.run("chunk", flaky) == "ok" and calls["n"] == 4
    assert sleeps == [1.5, 2.0, 2.0]  # exponential, capped at 2 s
    with pytest.raises(faults.TransientDeviceError):
        faults.Watchdog("m", retries=1, backoff_s=0.0).run(
            "chunk", lambda: (_ for _ in ()).throw(faults.TransientDeviceError()))
    calls["n"] = 0

    def fatal():
        calls["n"] += 1
        raise faults.FatalDeviceError("gone")

    with pytest.raises(faults.FatalDeviceError):
        wd.run("chunk", fatal)
    assert calls["n"] == 1  # fatal errors never retry
    # No spec, no deadline, no retries: a plain call on the caller's thread.
    wd0 = faults.Watchdog("m", retries=0)
    assert wd0._passthrough and wd0.run("x", threading.get_ident) == threading.get_ident()


def test_watchdog_cuts_a_dispatch_that_does_not_return():
    release = threading.Event()
    wd = faults.Watchdog("m", timeout_s=1.0)
    with pytest.raises(faults.DispatchTimeoutError, match="DISPATCH_TIMEOUT_S=1.0"):
        wd.run("chunk", release.wait)
    release.set()
    # Under a deadline far above the call's time: its result, in the
    # caller's inference mode.
    wd = faults.Watchdog("m", timeout_s=60.0)
    with torch.inference_mode():
        assert wd.run("chunk", torch.is_inference_mode_enabled) is True
    assert wd.run("chunk", torch.is_inference_mode_enabled) is False


def test_a_dispatch_cut_while_it_hung_in_the_injector_never_runs():
    inj = faults.FaultInjector.from_spec("chunk:hang(3)@1")
    ran = []
    wd = faults.Watchdog("m", timeout_s=0.5, retries=0, injector=inj)
    with pytest.raises(faults.DispatchTimeoutError):
        wd.run("chunk", lambda: ran.append(1))
    for t in threading.enumerate():
        if t.name == "dispatch-chunk":
            t.join(30)  # the hang ends, and the worker returns without the dispatch
    assert inj.rules[0].fired == 1 and ran == []


def test_supervisor_budgets_on_an_injected_clock():
    now = [100.0]
    sup = Supervisor(max_restarts=2, window_s=10.0, clock=lambda: now[0])
    jsup = JaxSupervisor(max_restarts=2, window_s=10.0, clock=lambda: now[0])
    for step in (0.0, 1.0, 1.0, 9.5, 0.1):
        now[0] += step
        assert sup.allow_restart() == jsup.allow_restart()
        assert sup.stats() == jsup.stats()
    life = Supervisor(max_restarts=1)
    assert life.allow_restart() and not life.allow_restart() and life.failed
    assert life.stats() == {"restarts": 1, "max_restarts": 1, "failed": True}
    poisoned = Supervisor(max_restarts=3)
    poisoned.fail()
    assert poisoned.failed and not poisoned.allow_restart() and poisoned.restarts == 0


# ---------------------------------------------------------------------------
# classification of CUDA errors: the out-of-memory error and the device-side
# assert (and the call after it) are what torch raised on an H100 in
# chip_smoke.py's ``serve llama faults sticky`` (a child process indexing
# past a tensor, and allocating 4 TiB); the other sticky kinds are the CUDA
# runtime's messages for its other sticky codes.

_TAIL = ("\nCUDA kernel errors might be asynchronously reported at some other API call, "
         "so the stacktrace below might be incorrect.\nFor debugging consider passing "
         "CUDA_LAUNCH_BLOCKING=1\nCompile with `TORCH_USE_CUDA_DSA` to enable device-side "
         "assertions.\n")
_ERR = getattr(torch, "AcceleratorError", RuntimeError)


@pytest.mark.parametrize("exc,poisoned", [
    (_ERR("CUDA error: an illegal memory access was encountered" + _TAIL), True),
    (_ERR("CUDA error: device-side assert triggered" + _TAIL), True),
    (_ERR("CUDA error: unspecified launch failure" + _TAIL), True),
    (_ERR("CUDA error: uncorrectable ECC error encountered" + _TAIL), True),
    (_ERR("CUDA error: misaligned address" + _TAIL), True),
    (RuntimeError("paged_decode_attention kernel launch failed (700): an illegal memory "
                  "access was encountered"), True),
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 4096.00 GiB. GPU 0 has a total capacity of "
        "79.18 GiB of which 55.33 GiB is free. Process 1 has 23.83 GiB memory in use. Of the "
        "allocated memory 0 bytes is allocated by PyTorch, and 0 bytes is reserved by PyTorch "
        "but unallocated."), False),
    (RuntimeError("CUDA error: invalid argument" + _TAIL), False),
    (faults.FatalDeviceError("injected fatal device fault at chunk"), False),
    (faults.DispatchTimeoutError("chunk dispatch exceeded DISPATCH_TIMEOUT_S=5s"), False),
    (ValueError("an illegal memory access was encountered"), False),
])
def test_cuda_errors_are_classified_by_what_torch_raises(exc, poisoned):
    assert faults.is_context_poisoned(exc) is poisoned
    assert faults.is_fatal_device(exc) is (poisoned or isinstance(
        exc, (faults.FatalDeviceError, faults.DispatchTimeoutError)))
    assert not faults.is_transient(exc)


# ---------------------------------------------------------------------------
# supervised recovery in the loop, against the JAX loop


def _feats(preprocess, sampled: bool) -> list[dict]:
    out = []
    for i, (t, m) in enumerate(TEXTS):
        f = preprocess(t, m)
        if sampled:
            f.update(temperature=0.8, top_k=40, seed=11 + i)
        out.append(f)
    return out


async def _consume(gen) -> list[int]:
    return [t async for chunk in gen for t in np.asarray(chunk).tolist()]


def _run_queued(loop, feats: list[dict]) -> list:
    """Every stream queued before the loop's thread starts (one wave), then
    each consumed; a stream's exception is its result."""
    async def body():
        loop._ensure_thread = lambda: None
        try:
            gens = [loop.submit_stream(dict(f)) for f in feats]
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        return await asyncio.gather(*(_consume(g) for g in gens), return_exceptions=True)

    try:
        return asyncio.run(body())
    finally:
        loop.stop()


def _jax_loop(paged: bool, **kw):
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        cfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False,
                               paged_kv=paged, kv_block_size=8, **SERVE, **kw)
        bundle = jax_build_model(cfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    eng = JaxEngine(bundle, cfg, ReplicaSet(make_mesh(1)))
    loop = JaxLoop(eng, cfg)
    loop.supervisor = JaxSupervisor(cfg)
    return bundle, eng, loop


def _port(paged: bool, params, **env):
    ov = {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0",
          "LLAMA_CONFIG": json.dumps(SMALL), "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32",
          "MAX_DECODE_LEN": "12", "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4",
          "PAGED_KV": "1" if paged else "0", "KV_BLOCK_SIZE": "8", **env}
    return build_service(ov, params=params)


def _jax_run(paged, sampled, **kw):
    jbundle, jeng, jloop = _jax_loop(paged, **kw)
    got = _run_queued(jloop, _feats(lambda t, m: jbundle.preprocess(
        JaxRawItem(text=t, max_tokens=m)), sampled))
    return jbundle, jeng, jloop, got


def _port_run(paged, sampled, params, **env):
    _, bundle, engine, batcher = _port(paged, params, **env)
    got = _run_queued(batcher._cdl, _feats(lambda t, m: bundle.preprocess(
        RawItem(text=t, max_tokens=m)), sampled))
    return engine, batcher, got


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_a_fatal_chunk_fault_resumes_like_the_jax_loop(paged, sampled):
    """``chunk:fatal@2`` kills the second chunk dispatch mid-decode: both
    supervised loops checkpoint, rebuild and resume every stream, with the
    tokens of a clean run and one restart each."""
    jbundle, jeng, jloop, want = _jax_run(paged, sampled, fault_spec="chunk:fatal@2")
    params = jax.tree.map(np.asarray, jbundle.params)
    engine, batcher, got = _port_run(paged, sampled, params, FAULT_SPEC="chunk:fatal@2")
    _, _, clean = _port_run(paged, sampled, params)
    assert got == want == clean
    assert all(isinstance(g, list) and g for g in got)
    assert jeng.faults.rules[0].fired == engine.faults.rules[0].fired == 1
    assert batcher.supervisor.stats() == jloop.supervisor.stats() == {
        "restarts": 1, "max_restarts": 3, "failed": False}
    loop = batcher._cdl
    assert loop.admitted == 0
    if paged:
        assert engine.kv_pool.used_blocks == 0
        assert (loop._table == engine.kv_pool.num_blocks).all()


def test_transient_chunk_faults_are_invisible():
    """``chunk:transient@2+3`` with three retries: every failed attempt is
    retried, no restart, the clean run's tokens."""
    params = jax.tree.map(np.asarray, _jax_loop(True)[0].params)
    engine, batcher, got = _port_run(True, False, params, FAULT_SPEC="chunk:transient@2+3",
                                     DISPATCH_RETRIES="3", DISPATCH_BACKOFF_S="0.001")
    _, _, clean = _port_run(True, False, params)
    assert got == clean
    assert engine.faults.rules[0].fired == 3
    assert batcher.supervisor.restarts == 0


def test_a_hang_cut_by_the_watchdog_recovers():
    """``chunk:hang(600)@2`` under a 10 s deadline: the watchdog cuts it
    (a fatal fault), the loop rebuilds and the streams finish with the
    clean run's tokens."""
    params = jax.tree.map(np.asarray, _jax_loop(False)[0].params)
    _, _, clean = _port_run(False, False, params)
    engine, batcher, got = _port_run(False, False, params, FAULT_SPEC="chunk:hang(600)@2",
                                     DISPATCH_TIMEOUT_S="10")
    assert got == clean
    assert batcher.supervisor.restarts == 1 and engine.faults.rules[0].fired == 1


def test_a_poisoned_context_fails_the_supervisor_outright():
    """A sticky CUDA error (the message torch raises for an illegal address)
    spends no restart: the supervisor fails, the streams end with it and
    the loop stops."""
    params = jax.tree.map(np.asarray, _jax_loop(False)[0].params)
    _, bundle, engine, batcher = _port(False, params)
    real = bundle.generate_chunk
    n = {"calls": 0}

    def chunk(*a, **k):
        n["calls"] += 1
        if n["calls"] == 2:  # the first chunk past the wave's start
            raise _ERR("CUDA error: an illegal memory access was encountered" + _TAIL)
        return real(*a, **k)

    bundle.generate_chunk = chunk
    got = _run_queued(batcher._cdl, _feats(lambda t, m: bundle.preprocess(
        RawItem(text=t, max_tokens=m)), False))
    assert all(isinstance(g, RuntimeError) and "illegal memory access" in str(g) for g in got)
    assert batcher.supervisor.stats() == {"restarts": 0, "max_restarts": 3, "failed": True}
    assert batcher._cdl._stop.is_set()


# ---------------------------------------------------------------------------
# a spent budget through both apps

APP_ENV = {"DEVICE": "cpu", "MODEL_NAME": "llama", "WARMUP": "0", "SEQ_BUCKETS": "16,32",
           "MAX_DECODE_LEN": "12", "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "2",
           "BATCH_BUCKETS": "1,2", "BATCH_TIMEOUT_MS": "1", "FAULT_SPEC": "chunk:fatal~1",
           "ENGINE_RESTARTS_MAX": "1", "LLAMA_CONFIG": json.dumps(SMALL)}


async def _spend(app) -> tuple:
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        before = (await client.get("/status")).status
        resp = await client.post("/v1/completions", json={
            "prompt": "hello there", "max_tokens": 12, "stream": True})
        body = await resp.text()
        for _ in range(400):
            ready = await client.get("/readyz")
            if ready.status == 503:
                break
            await asyncio.sleep(0.05)
        status = await (await client.get("/status")).json()
        return (before, resp.status, "error" in body, ready.status, await ready.json(),
                status["fault_tolerance"])
    finally:
        await client.close()


def test_a_spent_budget_fails_streams_and_readyz_like_the_jax_app(monkeypatch):
    monkeypatch.setenv("LLAMA_CONFIG", APP_ENV["LLAMA_CONFIG"])
    jcfg, jbundle, jengine, jbatcher, _ = jax_build_service({**APP_ENV, "REPLICAS": "1"})
    cfg, bundle, engine, batcher = build_service(
        APP_ENV, params=jax.tree.map(np.asarray, jbundle.params))
    want = asyncio.run(_spend(jax_build_app(jcfg, jbundle, jengine, jbatcher)))
    got = asyncio.run(_spend(build_app(cfg, bundle, engine, batcher)))
    assert got == want
    assert got[3] == 503 and got[4] == {
        "ready": False, "error": "engine restart budget exhausted (ENGINE_RESTARTS_MAX)"}
    assert got[5] == {"restarts": 1, "max_restarts": 1, "failed": True}
