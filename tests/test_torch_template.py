"""The template surface of the port against the JAX package's:
``register_model`` (a custom builder served through ``build_service`` and
``/predict``; its contract), parent registration under ``SERVER_URL`` (the
payload the JAX client posts, then the heartbeat), ``python -m``, and the
package import that loads nothing eagerly."""

import asyncio
import dataclasses
import logging
import pathlib
import subprocess
import sys
import types

import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from mlmicroservicetemplate_tpu.api.registration import (
    register_with_parent as jax_register_with_parent,
)
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api import registration
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import registry
from mlmicroservicetemplate_tpu_torch.models.tokenizer import build_tokenizer
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils.config import load_config

REPO = pathlib.Path(__file__).resolve().parents[1]


def tiny_builder(svc_cfg, policy, device, params=None):
    """A two-label text classifier: label 1 scores the largest token id."""

    def forward(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        score = (ids * mask).amax(-1).float()
        return torch.stack([torch.full_like(score, 100.0), score], dim=-1)

    return registry.ModelBundle(
        name="tiny-custom", kind=registry.KIND_TEXT, cfg=types.SimpleNamespace(max_position=64),
        model=torch.nn.Identity(), device=device, policy=policy,
        tokenizer=build_tokenizer(None), labels=["low", "high"], forward=forward)


@pytest.fixture
def fresh_registry(monkeypatch):
    """Registrations land in a copy of the registry, dropped after the test."""
    monkeypatch.setattr(registry, "MODEL_REGISTRY", dict(registry.MODEL_REGISTRY))
    return registry.MODEL_REGISTRY


async def _post_predict(app, body: dict):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(200):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        resp = await client.post("/predict", json=body)
        return resp.status, await resp.json()
    finally:
        await client.close()


def test_registered_builder_serves_through_predict(fresh_registry):
    import mlmicroservicetemplate_tpu_torch

    mlmicroservicetemplate_tpu_torch.register_model("tiny-custom", tiny_builder)
    assert fresh_registry["tiny-custom"] is tiny_builder
    cfg, bundle, engine, batcher = build_service(
        {"DEVICE": "cpu", "MODEL_NAME": "tiny-custom", "WARMUP": "0", "SEQ_BUCKETS": "16,64"})
    assert bundle.name == "tiny-custom" and bundle.device.type == "cpu"
    status, body = asyncio.run(_post_predict(build_app(cfg, bundle, engine, batcher),
                                             {"text": "~~~~"}))
    assert status == 200, body
    # '~' is byte 126: its byte-tokenizer id is above 100 -> "high".
    assert body["model"] == "tiny-custom" and body["prediction"]["label"] == "high"
    assert engine.dispatches >= 2  # the canary and the request


def test_register_model_contract(fresh_registry, caplog):
    with pytest.raises(TypeError, match="callable"):
        registry.register_model("broken", "not a builder")
    assert "broken" not in fresh_registry
    with caplog.at_level(logging.WARNING, logger=registry.__name__):
        registry.register_model("resnet50", tiny_builder)
    assert "overriding existing model 'resnet50'" in caplog.text
    assert fresh_registry["resnet50"] is tiny_builder


def test_importing_the_package_loads_nothing_eagerly():
    check = (
        "import sys\n"
        "import mlmicroservicetemplate_tpu_torch as m\n"
        "assert callable(m.register_model)\n"
        "bad = [n for n in ('torch', 'mlmicroservicetemplate_tpu_torch.models.registry')"
        " if n in sys.modules]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", check], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_python_dash_m_help_exits_0():
    out = subprocess.run([sys.executable, "-m", "mlmicroservicetemplate_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--server-url" in out.stdout and "resnet50" in out.stdout


async def _fake_parent(statuses: list[int]):
    """A parent server whose POST /register answers ``statuses`` in turn
    (then 200) and records each payload."""
    seen: list[dict] = []

    async def register(request: web.Request) -> web.Response:
        seen.append(await request.json())
        return web.Response(status=statuses.pop(0) if statuses else 200)

    app = web.Application()
    app.router.add_post("/register", register)
    server = TestServer(app)
    await server.start_server()
    return server, seen


def test_server_url_registers_like_the_jax_client_then_heartbeats(fresh_registry):
    fresh_registry["tiny-custom"] = tiny_builder

    async def main():
        server, seen = await _fake_parent([503])
        url = str(server.make_url(""))
        try:
            jcfg = JaxServiceConfig(device="cpu", server_url=url, port=8123,
                                    register_retry_s=0.01)
            assert await jax_register_with_parent(jcfg, "tiny-custom")
            jax_payloads = list(seen)
            seen.clear()
            cfg, bundle, engine, batcher = build_service({
                "DEVICE": "cpu", "MODEL_NAME": "tiny-custom", "WARMUP": "0", "PORT": "8123",
                "SEQ_BUCKETS": "16,64", "SERVER_URL": url, "REGISTER_HEARTBEAT_S": "0.05"})
            cfg = dataclasses.replace(cfg, register_retry_s=0.01)
            client = TestClient(TestServer(build_app(cfg, bundle, engine, batcher)))
            await client.start_server()
            try:
                for _ in range(200):
                    if len(seen) >= 2:
                        break
                    await asyncio.sleep(0.02)
            finally:
                await client.close()
            n_at_close = len(seen)
            await asyncio.sleep(0.2)  # cleanup cancelled the loop: no more beats
            return jax_payloads, seen, n_at_close
        finally:
            await server.close()

    jax_payloads, seen, n_at_close = asyncio.run(main())
    # JAX: one refused attempt (503), then the ack.
    assert jax_payloads == [{"name": "tiny-custom", "host": "localhost", "port": 8123}] * 2
    assert len(seen) >= 2 and all(p == jax_payloads[0] for p in seen)
    assert len(seen) == n_at_close


def test_registration_gives_up_after_max_tries():
    async def main():
        server, seen = await _fake_parent([500] * 10)
        try:
            cfg = load_config({"DEVICE": "cpu", "SERVER_URL": str(server.make_url(""))})
            cfg = dataclasses.replace(cfg, register_retry_s=0.0, register_max_tries=3)
            return await registration.register_with_parent(cfg, "resnet50"), seen
        finally:
            await server.close()

    acked, seen = asyncio.run(main())
    assert acked is False and len(seen) == 3
    assert all(p["name"] == "resnet50" for p in seen)
