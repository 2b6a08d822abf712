"""The port's ``/debug/*`` routes against the JAX app's, on the same small
llama weights (paged loop), f32 on the CPU.

- ``GET /debug/trace``: under ``TRACE=0`` the very body of the reference's
  (200, empty ``traceEvents``, its ``otherData``); under ``TRACE=1``, after
  the same streamed request, the same Chrome schema, ``otherData`` keys and
  span names (the port's per-batch ``dispatch`` span aside); ``?last``
  refused with the reference's reasons.
- ``GET /debug/engine`` (and ``?all=1``, which without a fleet is the same
  ring): the reference's keys, loop summary and per-site dispatch counts.
- ``GET /debug/perf``: the reference's keys, with the SLO section under
  ``SLO_*``.
- ``POST /debug/profile``: the reference's 400 answers for a bad
  ``seconds`` and 409 while a capture runs; on the CPU a capture writes a
  Chrome trace of CPU activity only into ``PROFILE_DIR``.
- ``/status.observability`` carries ``FLIGHT_RING``'s size, as the
  reference's does.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.api.app import K_STATE as JAX_K_STATE
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu.utils import tracing as jax_tracing
from mlmicroservicetemplate_tpu_torch.api.app import K_STATE, build_app
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils import tracing

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
SERVE = {"DEVICE": "cpu", "MODEL_NAME": "llama", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
         "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "8", "STREAM_CHUNK_TOKENS": "4",
         "MAX_STREAMS": "4", "BATCH_BUCKETS": "1,4", "BATCH_TIMEOUT_MS": "1", "PAGED_KV": "1",
         "KV_BLOCK_SIZE": "8"}
STREAM = ("/predict", {"text": "the quick brown fox", "stream": True})


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    tracing.configure(False)
    jax_tracing.configure(False)


def _apps(**extra):
    env = {**SERVE, **extra}
    os.environ["LLAMA_CONFIG"] = env["LLAMA_CONFIG"]  # the JAX registry reads it there
    try:
        jcfg, jbundle, jengine, jbatcher, _ = jax_build_service({**env, "REPLICAS": "1"})
    finally:
        del os.environ["LLAMA_CONFIG"]
    cfg, bundle, engine, batcher = build_service(env, params=jax.tree.map(np.asarray,
                                                                          jbundle.params))
    return (jax_build_app(jcfg, jbundle, jengine, jbatcher),
            build_app(cfg, bundle, engine, batcher))


async def _session(app, posts, gets):
    """Each post, then each get: [(status, JSON body or reason text)]."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(600):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        assert (await client.get("/readyz")).status == 200
        for path, body in posts:
            resp = await client.post(path, json=body)
            assert resp.status == 200, await resp.text()
            await resp.read()
        await asyncio.sleep(0.2)  # the loop releases the stream after its body ends
        out = []
        for method, path, body in gets:
            resp = await client.request(method, path, json=body)
            text = await resp.text()
            try:
                out.append((resp.status, json.loads(text)))
            except ValueError:
                out.append((resp.status, resp.reason))
        return out
    finally:
        await client.close()


def _both(apps, posts, gets):
    return [asyncio.run(_session(app, posts, gets)) for app in apps]


LAST = [("GET", "/debug/trace?last=0", None), ("GET", "/debug/trace?last=x", None)]


def test_debug_trace_off_is_the_references_body():
    want, got = _both(_apps(), [STREAM], [("GET", "/debug/trace", None)] + LAST)
    assert got == want
    assert got[0] == (200, {"traceEvents": [], "displayTimeUnit": "ms",
                            "otherData": {"trace_enabled": False,
                                          "hint": "start the server with TRACE=1"}})
    assert [s for s, _ in got[1:]] == [400, 400]


def _schema(body: dict) -> dict:
    keys_by_phase: dict = {}
    for ev in body["traceEvents"]:
        keys_by_phase.setdefault(ev["ph"], set()).update(ev)
    return {"top": set(body), "other": set(body["otherData"]), "phases": keys_by_phase,
            "names": {ev["name"] for ev in body["traceEvents"] if ev["ph"] != "M"}}


def test_debug_trace_on_has_the_references_schema():
    japp, app = _apps(TRACE="1")
    (want, *wlast), (got, *glast) = _both((japp, app), [STREAM],
                                          [("GET", "/debug/trace", None)] + LAST)
    assert glast == wlast
    assert got[0] == want[0] == 200
    gschema, wschema = _schema(got[1]), _schema(want[1])
    # The port's engine also records one ``dispatch`` span per /predict batch
    # (shapes and size), which the reference's engine does not.
    assert gschema.pop("names") - {"dispatch"} == wschema.pop("names")
    assert gschema == wschema
    assert {"request", "admission", "queue_wait", "decode_chunk", "dispatch:chunk",
            "dispatch:prefill", "dispatch:fetch", "stream"} <= _schema(got[1])["names"]
    assert got[1]["otherData"]["trace_enabled"] is True
    assert got[1]["otherData"]["ring"] == want[1]["otherData"]["ring"] == 4096


def test_debug_engine_and_perf_have_the_references_keys():
    gets = [("GET", "/debug/engine", None), ("GET", "/debug/engine?all=1", None),
            ("GET", "/debug/perf", None), ("GET", "/status", None)]
    want, got = _both(_apps(SLO_TTFT_MS="60000", FLIGHT_RING="32"), [STREAM, STREAM], gets)
    (ws, weng), (_, weng_all), (_, wperf), (_, wstatus) = want
    (gs, geng), (_, geng_all), (gps, gperf), (_, gstatus) = got
    assert gs == ws == gps == 200
    assert set(geng) == set(weng) and set(geng_all) == set(geng)
    assert geng["loop"] == weng["loop"] and geng["size"] == weng["size"] == 32
    assert geng["dumps"] == weng["dumps"] == 0 and geng["last_dump"] is None
    assert {k: v["count"] for k, v in geng["dispatch_attribution"].items()} == \
        {k: v["count"] for k, v in weng["dispatch_attribution"].items()}
    assert len(geng["iterations"]) > 0 and geng_all["loop"] == geng["loop"]
    assert set(gperf) == set(wperf)
    assert gperf["slo"]["objectives_ms"] == wperf["slo"]["objectives_ms"]
    assert gperf["slo"]["samples"] == wperf["slo"]["samples"]
    assert gperf["enabled"] is True and gperf["mfu_estimate"] is None
    assert gstatus["observability"] == wstatus["observability"]
    assert gstatus["observability"]["flight_ring"] == 32
    assert set(gstatus["perf"]) == set(wstatus["perf"])


BAD_SECONDS = [{"seconds": 0}, {"seconds": 31}, {"seconds": "x"}, {"seconds": "nan"},
               {"seconds": -1}]


def test_debug_profile_refuses_like_the_reference(tmp_path):
    japp, app = _apps(PROFILE_DIR=str(tmp_path))
    for a, key in ((japp, JAX_K_STATE), (app, K_STATE)):
        a[key]["tracing"] = True  # a capture is running: seconds are checked first
    gets = [("POST", "/debug/profile", b) for b in BAD_SECONDS + [{"seconds": 1}]]
    want, got = _both((japp, app), [], gets)
    assert got == want
    assert [s for s, _ in got] == [400] * len(BAD_SECONDS) + [409]


def test_a_cpu_capture_writes_a_chrome_trace(tmp_path):
    _, app = _apps(PROFILE_DIR=str(tmp_path / "prof"))
    (status, body), = asyncio.run(_session(app, [STREAM], [("POST", "/debug/profile",
                                                            {"seconds": 0.2})]))
    assert status == 200 and body["trace_dir"] == str(tmp_path / "prof")
    assert body["seconds"] == 0.2 and os.path.dirname(body["trace_file"]) == body["trace_dir"]
    with open(body["trace_file"]) as f:
        trace = json.load(f)
    cats = {ev.get("cat") for ev in trace["traceEvents"]}
    assert "kernel" not in cats and "cuda_runtime" not in cats  # CPU activity only
