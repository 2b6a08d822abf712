"""The port's flight recorder, span tracer and JSON logs (``utils/tracing.py``)
in its continuous loop, engine and supervisor, against the JAX package's,
f32 on the CPU, at a small llama config.

- For one queued workload with a preemption, a shed and an injected
  transient fault, the port's iteration frames and events equal the JAX
  loop's in every field but the clock's (``t``).
- A fatal fault under the supervisor dumps the ring once, with the events
  that led there; the resumed stream keeps its request id across the
  restart (a second ``queue_wait`` span); an unsupervised fault and a spent
  restart budget dump with the reference's reasons.
- The pacer's holds and grants and the window governor's drops are the
  reference's events; ``FLIGHT_RING=0`` records nothing.
- Under ``TRACE=1`` one chunked-prefill stream has every stage span, the
  dispatch spans parented under their stages with host and device halves;
  under ``TRACE=0`` no span object is made and no device time is measured.
- The Chrome export and the JSON log lines have the reference's schema and
  text.
"""

import asyncio
import json
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.engine.supervisor import Supervisor as JaxSupervisor
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdmission
from mlmicroservicetemplate_tpu.scheduler.policy import (
    DecodeWindowGovernor as JaxWindowGovernor,
)
from mlmicroservicetemplate_tpu.scheduler.policy import PrefillPacer as JaxPacer
from mlmicroservicetemplate_tpu.utils import tracing as jax_tracing
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.engine.supervisor import Supervisor
from mlmicroservicetemplate_tpu_torch.scheduler.policy import DecodeWindowGovernor, PrefillPacer
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils import tracing

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
# One slot, one waiter: a batch stream holds the slot, an interactive one
# waits and preempts it, a third is shed.
ONE_SLOT = dict(batch_buckets=(1, 2), seq_buckets=(16, 32, 64), max_decode_len=24,
                stream_chunk_tokens=4, max_streams=1, max_stream_queue=1, preempt=True,
                paged_kv=True, kv_block_size=8, stream_pipeline=1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _env(kw: dict) -> dict:
    return {k.upper(): (",".join(map(str, v)) if isinstance(v, tuple)
                        else ("1" if v else "0") if isinstance(v, bool) else str(v))
            for k, v in kw.items()}


def _loops(**kw):
    """(JAX loop, JAX engine, port loop, port engine) of the small llama on
    the same weights, at ``kw``."""
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        jcfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False,
                                batch_timeout_ms=1.0, **kw)
        jbundle = jax_build_model(jcfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    jloop = JaxLoop(jengine, jcfg)
    jloop.admission = JaxAdmission(jcfg, jengine)
    _, _, engine, batcher = build_service(
        {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0",
         "LLAMA_CONFIG": json.dumps(SMALL), "BATCH_TIMEOUT_MS": "1", **_env(kw)},
        params=jax.tree.map(np.asarray, jbundle.params))
    return jloop, jengine, batcher._cdl, engine


def _prompt(n: int, rid: str, **extra) -> dict:
    ids = np.random.default_rng(n).integers(5, 250, n).astype(np.int32)
    return {"input_ids": ids, "length": np.int32(n), "request_id": rid, **extra}


async def _read(gen) -> list[int]:
    return [int(t) async for chunk in gen for t in np.asarray(chunk).tolist()]


def _preempt_and_shed(loop):
    """A batch stream queued before the thread starts; at the loop's first
    chunk dispatch (on its thread, which waits) an interactive stream
    arrives, then a third, which is shed.  Returns (tokens of the batch
    and interactive streams, whether the third was shed)."""
    batch = _prompt(20, "b", priority="batch")
    inter = _prompt(9, "i", priority="interactive")
    extra = _prompt(12, "x", priority="batch")

    async def main():
        evloop = asyncio.get_running_loop()
        arrived = asyncio.Event()
        got = {}

        async def arrive():
            try:
                got["i"] = loop.submit_stream(dict(inter))
                loop.submit_stream(dict(extra))
                got["shed"] = False
            except Exception as e:  # either package's QueueFullError
                got["shed"] = type(e).__name__ == "QueueFullError" and e.reason == "queue_full"
            finally:
                arrived.set()

        orig = loop._dispatch_chunk
        first = threading.Event()

        def hooked():
            if not first.is_set():
                first.set()
                asyncio.run_coroutine_threadsafe(arrive(), evloop).result(30)
            return orig()

        loop._dispatch_chunk = hooked
        loop._ensure_thread = lambda: None
        try:
            g_b = loop.submit_stream(dict(batch))
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        out_b = asyncio.ensure_future(_read(g_b))
        await arrived.wait()
        out_i = await _read(got["i"])
        return [await out_b, out_i], got["shed"]

    try:
        return asyncio.run(main())
    finally:
        loop.stop()


def _clock_free(rows: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "t"} for r in rows]


def test_frames_and_events_equal_the_jax_loops():
    jloop, jengine, loop, engine = _loops(fault_spec="chunk:transient@3", dispatch_retries=2,
                                          dispatch_backoff_s=0.001, **ONE_SLOT)
    (want, jshed), (got, shed) = _preempt_and_shed(jloop), _preempt_and_shed(loop)
    assert got == want and shed and jshed
    assert loop.preemptions == jloop.preemptions == 1
    jsnap, snap = jengine.flight.snapshot(), engine.flight.snapshot()
    assert _clock_free(snap["events"]) == _clock_free(jsnap["events"])
    kinds = [e["event"] for e in snap["events"]]
    assert {"shed", "preempt", "checkpoint_requeue", "dispatch_retry"} <= set(kinds), kinds
    assert _clock_free(snap["iterations"]) == _clock_free(jsnap["iterations"])
    assert snap["iterations"] and any(it["slots"] for it in snap["iterations"])
    assert {"pool_free_blocks", "pool_used_blocks"} <= set(snap["iterations"][0])
    assert snap["dumps"] == jsnap["dumps"] == 0 and snap["size"] == 256


def _consume(loop, feats: dict) -> list[int]:
    async def main():
        return await _read(loop.submit_stream(dict(feats)))

    try:
        return asyncio.run(main())
    finally:
        loop.stop()


@pytest.fixture
def traced():
    tr = tracing.configure(True, 4096)
    yield tr
    tracing.configure(False)


def test_a_fatal_fault_dumps_once_and_the_stream_keeps_its_rid(traced):
    kw = dict(batch_buckets=(1, 2), seq_buckets=(16, 32, 64), max_decode_len=16,
              stream_chunk_tokens=4, max_streams=2)
    jloop, jengine, loop, engine = _loops(fault_spec="chunk:fatal@2", **kw)
    traced = tracing.configure(True, 4096)  # build_service set TRACE's (off)
    feats = _prompt(10, "req-resume")
    outs = []
    for lp, eng, sup_cls in ((jloop, jengine, JaxSupervisor), (loop, engine, Supervisor)):
        lp.supervisor = sup_cls(eng.cfg, recorder=eng.flight)
        outs.append(_consume(lp, feats))
        assert lp.supervisor.restarts == 1
    assert outs[1] == outs[0] and len(outs[0]) == 16
    jsnap, snap = jengine.flight.snapshot(), engine.flight.snapshot()
    assert snap["dumps"] == jsnap["dumps"] == 1
    assert snap["last_dump"]["reason"] == jsnap["last_dump"]["reason"]
    assert snap["last_dump"]["reason"].startswith("fatal fault, supervised restart 1/3")
    assert _clock_free(snap["last_dump"]["events"]) == _clock_free(jsnap["last_dump"]["events"])
    kinds = {e["event"] for e in snap["events"]}
    assert {"engine_restart", "checkpoint_requeue"} <= kinds
    spans = [s for s in traced.snapshot() if s.rid == "req-resume"]
    waits = [s for s in spans if s.name == "queue_wait"]
    assert len(waits) >= 2 and any(s.args.get("resumed") for s in waits)
    assert [s.name for s in spans].count("stream") == 1


def test_unrecoverable_faults_dump_with_the_reference_reasons():
    kw = dict(batch_buckets=(1, 2), seq_buckets=(16, 32), max_decode_len=12,
              stream_chunk_tokens=4, max_streams=2)
    jloop, jengine, loop, engine = _loops(fault_spec="chunk:fatal@1", **kw)
    feats = _prompt(10, "req-lost")
    for lp in (jloop, loop):  # no supervisor: the stream ends with the error
        lp.supervisor = None
        with pytest.raises(Exception, match="injected fatal device fault"):
            _consume(lp, feats)
    assert engine.flight.dumps == jengine.flight.dumps == 1
    assert engine.flight.last_dump["reason"] == jengine.flight.last_dump["reason"]
    # A spent budget: the supervisor refuses and dumps, once.
    reasons = []
    for cls, mod in ((JaxSupervisor, jax_tracing), (Supervisor, tracing)):
        rec = mod.FlightRecorder(8)
        sup = cls(None, max_restarts=1, window_s=30.0, clock=lambda: 5.0, recorder=rec)
        assert sup.allow_restart() and not sup.allow_restart() and not sup.allow_restart()
        snap = rec.snapshot()
        reasons.append((snap["dumps"], snap["last_dump"]["reason"],
                        _clock_free(snap["events"])))
    assert reasons[1] == reasons[0]
    assert reasons[1][0] == 1 and reasons[1][1] == (
        "engine restart budget exhausted (1/1 in 30s window)")


class _Events:
    def __init__(self):
        self.rows = []

    def event(self, kind, **fields):
        self.rows.append((kind, fields))


def test_pacer_and_window_governor_events_equal_the_reference():
    got = []
    for pacer_cls, gov_cls in ((JaxPacer, JaxWindowGovernor), (PrefillPacer, DecodeWindowGovernor)):
        pacer, gov = pacer_cls(weight=3), gov_cls(cap=8)
        pacer.recorder = gov.recorder = rec = _Events()
        decisions = [pacer.allow(k, live) for k, live in
                     [("batch", True)] * 4 + [("interactive", True), ("batch", False)]]
        depths = [gov.pick(m, live, waiting) for m, live, waiting in
                  [(8, False, False), (3, True, False), (5, False, False), (2, False, True),
                   (1, True, True)]]
        got.append((decisions, depths, rec.rows))
    assert got[1] == got[0]
    kinds = [k for k, _ in got[1][2]]
    assert kinds.count("pacer_hold") == 3 and kinds.count("pacer_grant") == 1
    assert kinds.count("window_drop") == 2


def test_flight_ring_zero_records_nothing():
    rec = tracing.FlightRecorder(0)
    rec.record_iteration(active=1)
    rec.event("x")
    snap = rec.snapshot()
    assert snap["iterations"] == [] and snap["events"] == [] and snap["size"] == 0
    d = rec.dump("test")  # a dump still answers, empty
    assert d["reason"] == "test" and d["iterations"] == [] and rec.dumps == 1
    _, _, engine, batcher = build_service(
        {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
         "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "8", "STREAM_CHUNK_TOKENS": "4",
         "MAX_STREAMS": "2", "FLIGHT_RING": "0", "FAULT_SPEC": "chunk:transient@1",
         "DISPATCH_BACKOFF_S": "0.001"})
    assert len(_consume(batcher._cdl, _prompt(9, "r"))) == 8
    snap = engine.flight.snapshot()
    assert snap["iterations"] == [] and snap["events"] == [] and snap["dumps"] == 0


def test_stage_spans_parent_their_dispatch_spans(traced):
    _, _, engine, batcher = build_service(
        {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
         "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "12", "STREAM_CHUNK_TOKENS": "4",
         "MAX_STREAMS": "2", "PREFILL_CHUNK": "8", "TRACE": "1"})
    tr = tracing.tracer()  # TRACE=1: the service installed a fresh ring, as the reference's does
    assert tr is not None and tr is not traced and not tr.snapshot()
    toks = _consume(batcher._cdl, _prompt(44, "req-span"))
    assert len(toks) == 12
    by: dict = {}
    for s in tr.snapshot():
        by.setdefault(s.name, []).append(s)
    for name in ("admission", "queue_wait", "prefill_window", "decode_chunk",
                 "dispatch:prefill_chunk", "dispatch:chunk", "dispatch:fetch", "stream"):
        assert name in by, (name, sorted(by))
    assert len(by["prefill_window"]) == 44 // 8 + 1
    for name in ("admission", "queue_wait", "prefill_window", "stream"):
        assert all(s.rid == "req-span" for s in by[name]), name
    assert by["decode_chunk"][0].args["streams"] == ["req-span"]
    windows = {s.sid for s in by["prefill_window"]}
    assert all(s.parent in windows for s in by["dispatch:prefill_chunk"])
    chunks = {s.sid for s in by["decode_chunk"]}
    assert all(s.parent in chunks for s in by["dispatch:chunk"])
    for s in by["dispatch:chunk"]:
        assert "host_ms" in s.args and "device_ms" in s.args
    (stream,) = by["stream"]
    lo, hi = stream.t0 - 0.05, stream.t0 + stream.dur + 0.05
    for name in ("queue_wait", "prefill_window", "decode_chunk"):
        assert all(lo <= s.t0 and s.t0 + s.dur <= hi for s in by[name]), name
    attr = engine.dispatch_attribution()
    assert attr["chunk"]["count"] == len(by["dispatch:chunk"])


def test_trace_off_makes_no_span(monkeypatch):
    tracing.configure(False)
    created = []
    orig = tracing.Span.__init__

    def spy(self, *a, **kw):
        created.append(self)
        orig(self, *a, **kw)

    monkeypatch.setattr(tracing.Span, "__init__", spy)
    _, _, engine, batcher = build_service(
        {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
         "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "12", "STREAM_CHUNK_TOKENS": "4",
         "MAX_STREAMS": "2", "PREFILL_CHUNK": "8"})
    assert len(_consume(batcher._cdl, _prompt(44, "req-off"))) == 12
    assert tracing.tracer() is None and created == []
    attr = engine.dispatch_attribution()
    assert attr["chunk"]["count"] > 0 and attr["chunk"]["device_s"] == 0.0
    assert attr["chunk"]["count"] == engine.dispatch_counts["chunk"]


def _spans(mod):
    """Spans of both kinds on a fixed clock: nested, after the fact, an
    instant and one that raised."""
    times = iter([10.0 + 0.25 * i for i in range(64)])
    now = mod._now
    mod._now = lambda: next(times)
    try:
        tr = mod.Tracer(32)
        tr.t_anchor, tr.wall_anchor = 10.0, 1.5e9
        with tr.span("outer", cat="engine", rid="r1", n=2) as sp:
            with tr.span("inner", cat="dispatch"):
                pass
            sp.set(extra=1)
        tr.add("queue_wait", cat="sched", rid="r1", t0=10.1, dur=0.3, klass="batch")
        tr.instant("mark", rid="r2")
        with pytest.raises(RuntimeError):
            with tr.span("failed"):
                raise RuntimeError("boom")
        return tr
    finally:
        mod._now = now


def test_the_chrome_export_equals_the_reference():
    want, got = _spans(jax_tracing), _spans(tracing)
    for last in (None, 2):
        a, b = got.chrome_trace(last), want.chrome_trace(last)
        # Thread names carry the thread's id; both ran on this one.
        assert a == b
    out = got.chrome_trace()
    assert out["displayTimeUnit"] == "ms"
    assert set(out["otherData"]) == {"wall_anchor", "spans_created", "ring"}
    phases = {ev["ph"] for ev in out["traceEvents"]}
    assert phases == {"M", "X", "i"}


def _record(msg: str, rid: str | None, exc: bool):
    try:
        raise ValueError("bad")
    except ValueError:
        info = sys.exc_info() if exc else None
    rec = logging.LogRecord("serve", logging.WARNING, __file__, 1, msg, ("x",), info)
    rec.created = 1700000000.123456
    if rid:
        rec.request_id = rid
    return rec


@pytest.mark.parametrize("rid,exc", [(None, False), ("req-7", False), ("req-8", True)])
def test_json_log_lines_equal_the_reference(rid, exc):
    got = tracing.JsonLogFormatter().format(_record("hello %s", rid, exc))
    want = jax_tracing.JsonLogFormatter().format(_record("hello %s", rid, exc))
    assert got == want
    line = json.loads(got)
    assert line["message"] == "hello x" and line.get("request_id") == rid
    assert ("exc" in line) == exc
