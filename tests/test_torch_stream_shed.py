"""Stream sheds of the port against the JAX package, on the small llama of
``tests/test_torch_streams.py`` (the JAX params carried across), f32 on
the CPU, each package served by its own ``Batcher`` (and app):

- A stream still queued in the continuous loop when its deadline passes
  (``deadline_ms`` from ``X-Deadline-Ms``, else ``DEADLINE_MS``) fails with
  ``DeadlineExceededError``, counted as a ``deadline`` shed, and answers
  504 on ndjson ``/predict``, SSE ``/v1/completions`` and a chat stream, as
  in the JAX package; the live stream beside it gets the tokens it gets
  with no deadline at all.
- ``Retry-After`` of a stream shed past ``MAX_STREAMS`` follows each
  path's EWMA of stream lifetimes: after a stream of known lifetime it
  equals the JAX app's header, in the loop and on the per-stream path
  (``CONTINUOUS_BATCHING=0``).
- The queue the loop and the batcher wait in orders by deadline, FIFO
  among equals, and expires on its injected clock, as the JAX queue does.

A loop is held by gating its ``_dispatch_chunk`` (both packages call it
once per live chunk, after the iteration's admission has popped the
queue), a per-stream worker by gating ``engine.generate_stream``: the
test queues or sheds a stream while the others are admitted and held.
The loop queue's clock runs a minute ahead, so a deadline under a minute
(``X-Deadline-Ms: 0.001``, or ``DEADLINE_MS=1000``, which the app's
whole-request canary meets) has passed at the next iteration top whatever
the machine's pace, and the live stream's ten minutes have not; a lifetime
is made exact by freezing the modules' monotonic clock from submit to
release and moving it by the lifetime in between."""

import asyncio
import dataclasses
import json
import math
import os
import threading
import time
import types

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
import mlmicroservicetemplate_tpu.engine.streams as jax_streams
import mlmicroservicetemplate_tpu.scheduler.batcher as jax_batcher
import mlmicroservicetemplate_tpu_torch.engine.streams as port_streams
import mlmicroservicetemplate_tpu_torch.scheduler.batcher as port_batcher
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.scheduler import policy as jax_policy
from mlmicroservicetemplate_tpu.utils import metrics as jax_metrics
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.scheduler import policy
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils import metrics

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
             stream_chunk_tokens=4, max_streams=2)
LIVE = ("the quick brown fox", 10)  # the stream held in a slot: (text, max_tokens)
LATE = ("a stream that waits", 6)
TINY_MS = 0.001  # a deadline 1 µs after submit
DEFAULT_MS = 1000.0  # DEADLINE_MS
LONG_MS = 600_000.0  # the live stream's own deadline beside DEADLINE_MS
QUEUE_AHEAD_S = 60.0  # the loop queue's clock ahead of the real one
LIFETIME_S = 11.0  # the stream of known lifetime: Retry-After (2+1)·(0.8+0.2·11)/2 = 4.5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, bundle, engine), (port cfg, bundle, engine): one engine
    each, shared by the batchers the tests build over config variants."""
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        jcfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False,
                                batch_timeout_ms=1.0, **SERVE)
        jbundle = jax_build_model(jcfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    cfg, bundle, engine, batcher = build_service({
        "MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
        "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
        "STREAM_CHUNK_TOKENS": "4", "BATCH_TIMEOUT_MS": "1", "MAX_STREAMS": "2",
    }, params=jax.tree.map(np.asarray, jbundle.params))
    batcher._cdl.stop()
    return (jcfg, jbundle, jengine), (cfg, bundle, engine)


class _Gate:
    """Wraps a callable so that, while the gate is held, its next call
    waits (and says it got there) until the gate is released."""

    def __init__(self):
        self.opened = threading.Event()
        self.opened.set()
        self.reached = threading.Event()

    def hold(self) -> None:
        self.reached.clear()
        self.opened.clear()

    def release(self) -> None:
        self.opened.set()

    def wrap(self, fn):
        def gated(*args, **kwargs):
            if not self.opened.is_set():
                self.reached.set()
                assert self.opened.wait(60), "gate never released"
            return fn(*args, **kwargs)

        return gated


class _Clock:
    """A ``time`` module whose ``monotonic`` the test can freeze and move."""

    def __init__(self):
        self.frozen: float | None = None

    def monotonic(self) -> float:
        return time.monotonic() if self.frozen is None else self.frozen

    def __getattr__(self, name):
        return getattr(time, name)


class _Side:
    """One package's half of a test: its batcher, app factory, feats,
    error classes, shed counter and the modules whose clock a lifetime
    reads."""

    def __init__(self, jax_side: bool, models, **cfg_changes):
        (jcfg, jbundle, jengine), (cfg, bundle, engine) = models
        self.jax = jax_side
        self.cfg = (jcfg.model_copy(update=cfg_changes) if jax_side
                    else dataclasses.replace(cfg, **cfg_changes))
        self.bundle = jbundle if jax_side else bundle
        self.engine = jengine if jax_side else engine
        self.batcher = (JaxBatcher if jax_side else Batcher)(self.engine, self.cfg)
        self.loop = self.batcher._cdl
        self.gate = _Gate()
        if self.loop is not None:
            self.loop._dispatch_chunk = self.gate.wrap(self.loop._dispatch_chunk)
            self.loop.queue._clock = lambda: time.monotonic() + QUEUE_AHEAD_S
        self.pol = jax_policy if jax_side else policy
        self.metrics = jax_metrics if jax_side else metrics
        self.modules = (jax_streams, jax_batcher) if jax_side else (port_streams, port_batcher)

    def feats(self, text: str, max_tokens: int, **extra) -> dict:
        raw = (JaxRawItem if self.jax else RawItem)(text=text, max_tokens=max_tokens)
        return {**self.bundle.preprocess(raw), **extra}

    def app(self):
        if self.jax:
            return jax_build_app(self.cfg, self.bundle, self.engine, self.batcher)
        return build_app(self.cfg, self.bundle, self.engine, self.batcher)

    def sheds(self, reason: str) -> float:
        return self.metrics.SHED.labels("llama", reason)._value.get()

    def admitted(self) -> int:
        if self.loop is not None:
            return self.loop._admitted
        return self.batcher._active_streams

    async def stop(self) -> None:
        self.gate.release()
        await self.batcher.stop()  # stops the loop too


async def _until(cond, timeout: float = 30.0) -> None:
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "condition never held"
        await asyncio.sleep(0.005)


async def _tokens(gen) -> list[int]:
    return [int(t) for chunk in [c async for c in gen] for t in np.asarray(chunk)]


async def _deadline_in_the_loop(side: _Side, late_extra: dict, live_extra: dict):
    """A live stream held at its next chunk, a second stream queued behind
    it: (the live stream's tokens, the error the second ends with, deadline
    sheds counted)."""
    sheds = side.sheds("deadline")
    try:
        side.gate.hold()
        live = asyncio.ensure_future(_tokens(side.batcher.submit_stream(
            side.feats(*LIVE, **live_extra))))
        await _until(side.gate.reached.is_set)
        late = asyncio.ensure_future(_tokens(side.batcher.submit_stream(
            side.feats(*LATE, **late_extra))))
        await _until(lambda: side.loop.queue.qsize() == 1)
        side.gate.release()
        err = (await asyncio.gather(late, return_exceptions=True))[0]
        return await live, err, side.sheds("deadline") - sheds
    finally:
        await side.stop()


async def _plain_tokens(side: _Side) -> list[int]:
    try:
        return await _tokens(side.batcher.submit_stream(side.feats(*LIVE)))
    finally:
        await side.stop()


@pytest.mark.parametrize("source", ["deadline_ms", "DEADLINE_MS"])
def test_queued_stream_past_its_deadline_sheds_like_jax(models, source):
    """deadline_ms: the late stream brings a 1 µs deadline, the live one
    none.  DEADLINE_MS: the service's default deadline passes in the
    queue; the live stream brings a long deadline of its own, the late one
    none."""
    if source == "deadline_ms":
        changes, late, live = {}, {"deadline_ms": TINY_MS}, {}
    else:
        changes, late, live = {"deadline_ms": DEFAULT_MS}, {}, {"deadline_ms": LONG_MS}
    out = {}
    for name in ("jax", "port"):
        side = _Side(name == "jax", models, **changes)
        tokens, err, shed = asyncio.run(_deadline_in_the_loop(side, late, live))
        assert isinstance(err, side.pol.DeadlineExceededError), err
        assert "deadline passed while queued" in str(err)
        assert shed == 1
        assert side.loop._admitted == 0
        out[name] = tokens
    plain = asyncio.run(_plain_tokens(_Side(False, models)))
    assert out["port"] == out["jax"] == plain
    assert len(plain) == LIVE[1]


def _bodies(route: str) -> tuple[str, dict, dict]:
    """(path, live body, late body) of one streaming route."""
    if route == "predict":
        return ("/predict", {"text": LIVE[0], "stream": True, "max_tokens": LIVE[1]},
                {"text": LATE[0], "stream": True, "max_tokens": LATE[1]})
    if route == "completions":
        return ("/v1/completions", {"prompt": LIVE[0], "stream": True, "max_tokens": LIVE[1]},
                {"prompt": LATE[0], "stream": True, "max_tokens": LATE[1]})
    # short messages: the chat template's own text must leave the prompt
    # within the loop's largest seq bucket (32 bytes)
    return ("/v1/chat/completions",
            {"messages": [{"role": "user", "content": "fox"}], "stream": True,
             "max_tokens": LIVE[1]},
            {"messages": [{"role": "user", "content": "wait"}], "stream": True,
             "max_tokens": LATE[1]})


async def _client(app) -> TestClient:
    client = TestClient(TestServer(app))
    await client.start_server()
    for _ in range(400):
        if (await client.get("/readyz")).status == 200:
            return client
        await asyncio.sleep(0.05)
    raise AssertionError("never ready")


async def _post(client, path, body, headers=None) -> tuple[int, str, dict]:
    resp = await client.post(path, json=body, headers=headers or {})
    return resp.status, await resp.text(), dict(resp.headers)


async def _deadline_http(side: _Side, source: str) -> list:
    """Per route: (live status, live body, late status, late body)."""
    tiny = {"X-Deadline-Ms": str(TINY_MS)}
    long = {"X-Deadline-Ms": str(LONG_MS)}
    client = await _client(side.app())
    out = []
    try:
        for route in ("predict", "completions", "chat"):
            path, live_body, late_body = _bodies(route)
            side.gate.hold()
            live = asyncio.ensure_future(_post(client, path, live_body,
                                               long if source == "DEADLINE_MS" else None))
            await _until(lambda: side.gate.reached.is_set() or live.done())
            assert not live.done(), (route, live.result())
            late = asyncio.ensure_future(_post(client, path, late_body,
                                               tiny if source == "X-Deadline-Ms" else None))
            await _until(lambda: side.loop.queue.qsize() == 1)
            side.gate.release()
            (ls, lt, _), (ds, dt, _) = await live, await late
            out.append((ls, lt, ds, dt))
            await _until(lambda: side.loop._admitted == 0)
    finally:
        await client.close()
        await side.stop()
    return out


def _strip_timing(route: str, body: str) -> str:
    if route != "predict":
        return body
    lines = [json.loads(ln) for ln in body.splitlines() if ln]
    lines[-1].pop("timing_ms", None)
    return json.dumps(lines)


@pytest.mark.parametrize("source", ["X-Deadline-Ms", "DEADLINE_MS"])
def test_deadline_shed_answers_504_like_jax(models, source):
    changes = {"deadline_ms": DEFAULT_MS} if source == "DEADLINE_MS" else {}
    got = asyncio.run(_deadline_http(_Side(False, models, **changes), source))
    want = asyncio.run(_deadline_http(_Side(True, models, **changes), source))
    for route, g, w in zip(("predict", "completions", "chat"), got, want):
        assert g[0] == w[0] == 200, (route, g[1])
        assert _strip_timing(route, g[1]) == _strip_timing(route, w[1]), route
        assert g[2] == w[2] == 504, (route, g[3], w[3])
        assert g[3] == w[3], route


async def _retry_after(side: _Side) -> tuple[int, str, int]:
    """After one stream of known lifetime, two streams held and a third
    shed over HTTP: (its status, its Retry-After, deadline-free streams
    served in all)."""
    clock = _Clock()
    client = await _client(side.app())
    try:
        with pytest.MonkeyPatch.context() as mp:
            for mod in side.modules:
                mp.setattr(mod, "time", clock)
            clock.frozen = time.monotonic()
            gen = side.batcher.submit_stream(side.feats("a stream of known lifetime", 4))
            clock.frozen += LIFETIME_S
            assert len(await _tokens(gen)) == 4
            await _until(lambda: side.admitted() == 0)
        side.gate.hold()
        path, live_body, _ = _bodies("predict")
        held = [asyncio.ensure_future(_post(client, path, live_body)) for _ in range(2)]
        await _until(lambda: side.admitted() == 2)
        status, _, headers = await _post(client, path, live_body)
        side.gate.release()
        served = sum(s == 200 for s, _, _ in await asyncio.gather(*held))
        return status, headers.get("Retry-After"), served
    finally:
        await client.close()
        await side.stop()


@pytest.mark.parametrize("path", ["loop", "per_stream"])
def test_shed_retry_after_matches_jax(models, path, monkeypatch):
    changes = {"continuous_batching": path == "loop"}
    sides = [_Side(name == "jax", models, **changes) for name in ("jax", "port")]
    if path == "per_stream":
        for side in sides:
            monkeypatch.setattr(side.engine, "generate_stream",
                                side.gate.wrap(side.engine.generate_stream))
    want, got = (asyncio.run(_retry_after(side)) for side in sides)
    expect = math.ceil(min(60.0, (2 + 1) * (0.8 * 1.0 + 0.2 * LIFETIME_S) / 2))
    assert got == want == (503, str(expect), 2)


def _waiter(name: str, deadline: float | None):
    # the attributes the JAX stream queue reads, beside the port's one
    return types.SimpleNamespace(name=name, deadline=deadline, klass="interactive",
                                 started=False, tenant="")


def test_deadline_queue_orders_and_expires_like_jax():
    """EDF, FIFO among equal deadlines, no deadline last; ``expire`` on
    the injected clock takes exactly the passed ones, as the JAX stream
    queue does; what stays pops in the same order from both."""
    now = [100.0]
    queues = [policy.DeadlineQueue(8, clock=lambda: now[0]),
              jax_policy.DeadlineQueue(8, clock=lambda: now[0])]
    spec = [("a", None), ("b", 105.0), ("c", 101.0), ("d", None), ("e", 101.0),
            ("f", 103.0)]
    for q in queues:
        for name, dl in spec:
            q.put(_waiter(name, dl))
    now[0] = 102.0
    expired = [[it.name for it in q.expire()] for q in queues]
    assert expired[0] == expired[1] == ["c", "e"]
    assert [q.qsize() for q in queues] == [4, 4]
    assert [[q.pop_nowait().name for _ in range(4)] for q in queues] == [["f", "b", "a", "d"]] * 2
    assert queues[0].pop_nowait() is None and queues[0].expire() == []


def test_deadline_queue_pop_waits_on_its_clock_and_drains():
    """``pop`` returns an arrival from another thread, or None once its
    timeout passes; ``drain_all`` empties in pop order; a full queue
    sheds."""
    q = policy.DeadlineQueue(3)
    assert q.pop(timeout=0.01) is None
    threading.Timer(0.02, lambda: q.put(_waiter("late", None))).start()
    assert q.pop(timeout=10.0).name == "late"
    for name, dl in (("x", None), ("y", time.monotonic() + 50), ("z", None)):
        q.put(_waiter(name, dl))
    with pytest.raises(policy.QueueFullError):
        q.put(_waiter("over", None))
    assert [it.name for it in q.drain_all()] == ["y", "x", "z"]
    assert q.qsize() == 0 and q.next_deadline() is None
