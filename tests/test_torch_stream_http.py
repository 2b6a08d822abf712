"""Streaming HTTP of the port against the JAX app, on the same llama
weights and buckets, f32 on the CPU: ndjson ``/predict`` and SSE
``/v1/completions`` bodies equal the JAX handlers' for the same requests
(``max_tokens``, ``stop`` strings, ``stream_options.include_usage``; the
final ndjson line's ``timing_ms`` aside), the deltas concatenate to the
final text, and a seeded ``temperature > 0`` stream is the JAX app's."""

import asyncio
import json
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
PROMPT = "the quick brown fox"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[(False, False), (True, True)],
                ids=["contiguous-dense", "paged-int8"])
def services(request):
    paged, quant = request.param
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        jcfg = JaxServiceConfig(
            device="cpu", model_name="llama", warmup=False, batch_timeout_ms=1.0,
            batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
            stream_chunk_tokens=4, max_streams=4, paged_kv=paged, kv_block_size=8,
            quant_kv="int8" if quant else None,
        )
        jbundle = jax_build_model(jcfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    port = build_service({
        "MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
        "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
        "STREAM_CHUNK_TOKENS": "4", "BATCH_TIMEOUT_MS": "1", "MAX_STREAMS": "4",
        "PAGED_KV": "1" if paged else "0", "KV_BLOCK_SIZE": "8",
        **({"QUANT_KV": "int8"} if quant else {}),
    }, params=jax.tree.map(np.asarray, jbundle.params))
    return (jcfg, jbundle, jengine), port


async def _http(app, posts):
    """(status, raw body text) per post, one after the other."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        out = []
        for path, body in posts:
            resp = await client.post(path, json=body)
            out.append((resp.status, await resp.text()))
        return out
    finally:
        await client.close()


def _both(services, posts):
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = services
    want = asyncio.run(_http(jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)),
                             posts))
    got = asyncio.run(_http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), posts))
    return got, want


def _ndjson(text: str) -> list[dict]:
    lines = [json.loads(ln) for ln in text.splitlines() if ln]
    lines[-1].pop("timing_ms")
    return lines


def _stop_string(services) -> str:
    """Two characters from the middle of the prompt's whole greedy text."""
    (_, jbundle, jengine), _ = services
    row = jengine.run_batch([jbundle.preprocess(JaxRawItem(text=PROMPT))])[0]
    text = jbundle.postprocess(row)["prediction"]["text"]
    return text[3:5] if len(text) >= 5 else "zz"


def test_ndjson_predict_matches_jax(services):
    stop = _stop_string(services)
    posts = [
        ("/predict", {"text": PROMPT, "stream": True}),
        ("/predict", {"text": PROMPT, "stream": True, "max_tokens": 5}),
        ("/predict", {"text": PROMPT, "stream": True, "stop": [stop]}),
        ("/predict", {"text": "hi", "stream": True, "max_tokens": 64}),
    ]
    got, want = _both(services, posts)
    for (path, body), (gs, g), (ws, w) in zip(posts, got, want):
        assert gs == ws == 200, (body, g)
        lines, ref = _ndjson(g), _ndjson(w)
        assert lines == ref, body
        final = lines[-1]
        assert final["done"] and final["model"] == "llama"
        assert "".join(ln["delta"] for ln in lines[:-1]) == final["prediction"]["text"]
        if "stop" in body:
            assert stop not in final["prediction"]["text"]


def test_sse_completions_match_jax(services):
    stop = _stop_string(services)
    posts = [
        ("/v1/completions", {"prompt": PROMPT, "stream": True}),
        ("/v1/completions", {"prompt": [PROMPT], "stream": True, "max_tokens": 3,
                             "stream_options": {"include_usage": True}}),
        ("/v1/completions", {"prompt": PROMPT, "stream": True, "stop": stop}),
    ]
    got, want = _both(services, posts)
    for (path, body), (gs, g), (ws, w) in zip(posts, got, want):
        assert gs == ws == 200, (body, g)
        assert g == w, body
        frames = [f for f in g.split("\n\n") if f]
        assert frames[-1] == "data: [DONE]"
        events = [json.loads(f[len("data: "):]) for f in frames[:-1]]
        text = "".join(e["choices"][0]["text"] for e in events if e["choices"])
        finals = [e for e in events if e["choices"] and e["choices"][0]["finish_reason"]]
        assert len(finals) == 1 and finals[0]["choices"][0]["text"] == ""
        if body.get("stream_options"):
            assert events[-1]["usage"]["completion_tokens"] <= 3
            assert all(e["usage"] is None for e in events[:-1])
        assert stop not in text or "stop" not in body


@pytest.mark.parametrize("path,body", [
    ("/predict", {"text": "hi", "stream": True, "temperature": 0.7, "top_k": 40, "seed": 11}),
    ("/v1/completions", {"prompt": "hi", "stream": True, "temperature": 1.0, "top_p": 0.9,
                         "seed": 12}),
])
def test_sampled_streams_answer_400(services, path, body):
    """Sampled streams answered 400 until sampling was ported; now they are
    served, and a seeded one streams the JAX app's very body."""
    got, want = _both(services, [(path, body)])
    ((gs, g),), ((ws, w),) = got, want
    assert gs == ws == 200, g
    if path == "/predict":
        assert _ndjson(g) == _ndjson(w)
    else:
        assert g == w


def test_stream_past_the_largest_bucket_answers_400(services):
    """A prompt longer than the largest seq bucket (32 here), once answered
    400, streams on the per-stream path as in the JAX package: the JAX
    app's very bodies, ndjson and SSE, and none of it through the loop."""
    posts = [("/predict", {"text": "x" * 40, "stream": True}),
             ("/v1/completions", {"prompt": "y" * 45, "stream": True, "max_tokens": 6})]
    dispatches = services[1][2].dispatches
    got, want = _both(services, posts)
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200], got
    assert _ndjson(got[0][1]) == _ndjson(want[0][1])
    assert got[1][1] == want[1][1]
    assert services[1][2].dispatches - dispatches == 1 + len(posts)  # canary + streams
