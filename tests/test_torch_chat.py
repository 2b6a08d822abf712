"""Chat in the port against the JAX package, on the CPU in f32.

- ``render_chat``: every template's prompt identical to the JAX one for
  the same messages, and the same validation errors; the tokenizer probe
  gives the same warnings.
- ``/v1/chat/completions`` (whole, SSE, with and without usage) and
  ``/v1/models`` answer with the JAX app's bodies for the same requests on
  llama and GPT-2 (greedy, and seeded sampled), ``/status`` shows the
  template, and bad bodies get the JAX app's status and reason.
"""

import asyncio
import contextlib
import functools
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.api import chat as jax_chat
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import tokenizer as jax_tok
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api import chat
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import tokenizer as port_tok
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service

CONVERSATIONS = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"},
     {"role": "assistant", "content": "hello"}, {"role": "user", "content": "again"}],
    [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}],
    [{"role": "assistant", "content": "first"}, {"role": "user", "content": "then"}],
    [{"role": "system", "content": "only system"}],
    [{"role": "user", "content": "naïve 東京\nline"}],
]
BAD = [None, [], "hi", [{"role": "bot", "content": "x"}], [{"role": "user"}],
       [{"role": "user", "content": 3}]]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except (ValueError, LookupError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("template", list(jax_chat.TEMPLATES) + ["unknown"])
def test_render_chat_matches_jax(template):
    assert list(chat.TEMPLATES) == list(jax_chat.TEMPLATES)
    for messages in CONVERSATIONS + BAD:
        assert _outcome(chat.render_chat, messages, template) == \
            _outcome(jax_chat.render_chat, messages, template), (template, messages)


@pytest.mark.parametrize("template", list(jax_chat.TEMPLATES))
def test_template_probe_matches_jax(template):
    for port, ref in ((port_tok.build_tokenizer(None, for_t5=True),
                       jax_tok.build_tokenizer(None, for_t5=True)), (None, None)):
        assert chat.validate_chat_template(template, port) == \
            jax_chat.validate_chat_template(template, ref)


LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
GPT = dict(vocab_size=300, d_model=128, num_heads=4, num_layers=2, d_ff=256,
           max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32, 112), max_decode_len=10,
             stream_chunk_tokens=4, max_streams=4)
PORT_SERVE = {"BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32,112", "MAX_DECODE_LEN": "10",
              "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "BATCH_TIMEOUT_MS": "1"}


@contextlib.contextmanager
def _family(name: str, template: str):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CHAT_TEMPLATE", template)  # the JAX app reads it at build
        if name == "llama":
            mp.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
        else:
            mp.setattr(jax_gpt, "GPTConfig", functools.partial(jax_gpt.GPTConfig, **GPT))
            mp.setattr(port_gpt, "GPTConfig", functools.partial(port_gpt.GPTConfig, **GPT))
        yield mp


@pytest.fixture(scope="module", params=[("llama", "zephyr"), ("gpt2", "chatml")],
                ids=["llama-zephyr", "gpt2-chatml"])
def apps(request):
    """(JAX app factory, port app factory) of one family and template."""
    name, template = request.param
    with _family(name, template):
        jcfg = JaxServiceConfig(device="cpu", model_name=name, warmup=False,
                                batch_timeout_ms=1.0, **SERVE)
        jbundle = jax_build_model(jcfg)
        overrides = {"MODEL_NAME": name, "DEVICE": "cpu", "WARMUP": "0", **PORT_SERVE,
                     "CHAT_TEMPLATE": template}
        if name == "llama":
            overrides["LLAMA_CONFIG"] = json.dumps(LLAMA)
        cfg, bundle, engine, _ = build_service(
            overrides, params=jax.tree.map(np.asarray, jbundle.params))
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))

    def jax_app():
        with _family(name, template):
            return jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg))

    return name, template, jax_app, lambda: build_app(cfg, bundle, engine, Batcher(engine, cfg))


async def _http(app, requests):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        out = []
        for method, path, body in requests:
            if method == "GET":
                r = await client.get(path)
            elif isinstance(body, str):
                r = await client.post(path, data=body,
                                      headers={"Content-Type": "application/json"})
            else:
                r = await client.post(path, json=body)
            out.append((r.status, r.reason, await r.text()))
        return out
    finally:
        await client.close()


def _comparable(body: dict | None, text: str):
    if body is not None and body.get("stream"):
        return text
    try:
        answer = json.loads(text)
    except json.JSONDecodeError:
        return text
    for entry in answer.get("data", []) if isinstance(answer, dict) else []:
        assert isinstance(entry.pop("created"), int)  # each app's own start time
    return answer


MESSAGES = CONVERSATIONS[1]


def test_chat_and_models_match_jax(apps):
    name, template, jax_app, port_app = apps
    requests = [
        ("POST", "/v1/chat/completions", {"messages": MESSAGES}),
        ("POST", "/v1/chat/completions", {"messages": CONVERSATIONS[0], "max_tokens": 4}),
        ("POST", "/v1/chat/completions", {"messages": CONVERSATIONS[2], "stream": True}),
        ("POST", "/v1/chat/completions", {"messages": CONVERSATIONS[5], "stream": True,
                                          "stream_options": {"include_usage": True}}),
        ("POST", "/v1/chat/completions", {"messages": MESSAGES, "temperature": 0.8,
                                          "seed": 9}),
        ("POST", "/v1/chat/completions", {"messages": CONVERSATIONS[0], "stream": True,
                                          "temperature": 1.1, "top_k": 40, "seed": 10}),
        ("GET", "/v1/models", None),
    ]
    want = asyncio.run(_http(jax_app(), requests))
    got = asyncio.run(_http(port_app(), requests))
    for (_, path, body), (gs, _, g), (ws, _, w) in zip(requests, got, want):
        assert gs == ws == 200, (path, body, g)
        assert _comparable(body, g) == _comparable(body, w), (path, body)
    frames = [f for f in got[2][2].split("\n\n") if f]
    assert frames[0].startswith("data: ") and '"role": "assistant"' in frames[0]
    assert frames[-1] == "data: [DONE]"


def test_bad_chat_requests_answer_as_jax(apps):
    name, template, jax_app, port_app = apps
    requests = [("POST", "/v1/chat/completions", {"messages": m}) for m in BAD]
    requests += [("POST", "/v1/chat/completions", "{not json"),
                 ("POST", "/v1/chat/completions", {"messages": MESSAGES, "n": 3}),
                 ("POST", "/v1/chat/completions", {"messages": MESSAGES, "temperature": -1})]
    if template == "llama2":
        requests.append(("POST", "/v1/chat/completions", {"messages": CONVERSATIONS[4]}))
    want = asyncio.run(_http(jax_app(), requests))
    got = asyncio.run(_http(port_app(), requests))
    for req, (gs, gr, _), (ws, wr, _) in zip(requests, got, want):
        assert (gs, gr) == (ws, wr) and gs == 400, req


def test_status_shows_the_template(apps):
    name, template, _, port_app = apps
    ((status, _, text),) = asyncio.run(_http(port_app(), [("GET", "/status", None)]))
    assert status == 200 and json.loads(text)["chat_template"] == template
    assert json.loads(text)["chat_template_warnings"]  # the byte vocab shatters markers
