"""bert-long end to end on the CPU, mirroring tests/test_longctx.py: the
port's engine-served bert-long with SP=8 (eight sequence shards on the
host) against the JAX package's on its 8-device ('sp',) mesh, on the JAX
service's params carried across.  f32 on both sides; logits within 1e-4
(twelve layers of full-width products, and each ring's eight hops, summed
in another order).

Also: the port's SP widths agree with each other and with its dense
forward, the bucket and position-table checks, /predict and /status over
HTTP, and SP past the visible cards.
"""

import asyncio

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.models import bert as jax_bert
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import bert as port_bert
from mlmicroservicetemplate_tpu_torch.models.registry import build_model
from mlmicroservicetemplate_tpu_torch.parallel import (
    SeqParallelSet,
    make_sp_devices,
    ring_hop,
)
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils.config import ServiceConfig

ENV = {"DEVICE": "cpu", "MODEL_NAME": "bert-long", "SP": "8", "WARMUP": "0",
       "BATCH_BUCKETS": "1,2", "SEQ_BUCKETS": "32,64"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def services(cpu_devices):
    jcfg, jbundle, jengine, _, _ = jax_build_service(ENV)
    params = jax.tree.map(np.asarray, jbundle.params)
    return jengine, build_service(ENV, params=params)


def _feats():
    rng = np.random.RandomState(3)
    return [
        {"input_ids": rng.randint(5, 1000, (n,)).astype(np.int32), "length": np.int32(n)}
        for n in (40, 17)
    ]


def _padded(feats, seq: int = 64):
    ids = np.zeros((len(feats), seq), np.int32)
    mask = np.zeros((len(feats), seq), np.int32)
    for i, f in enumerate(feats):
        n = int(f["length"])
        ids[i, :n] = f["input_ids"]
        mask[i, :n] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def test_engine_served_bert_long_matches_jax(services):
    jengine, (cfg, bundle, engine, _) = services
    assert engine.placement.n_devices == 8 and engine.seq_multiple == 8
    assert bundle.cfg.max_position == 512 and bundle.cfg.hidden_size == 768
    before = ring_hop.launches
    got = engine.run_batch(_feats())
    want = jengine.run_batch(_feats())
    assert ring_hop.launches == before  # CPU: the plain hop ran
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-4, rtol=0)

    # ... and equals the port's dense forward on the padded inputs (the
    # engine's bucket: 64, divisible by 8).
    with torch.inference_mode():
        dense = bundle.model.classify(*_padded(_feats()))
    np.testing.assert_allclose(np.stack(got), dense.numpy(), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def sp1_logits(services):
    _, (_, bundle, _, _) = services
    with torch.inference_mode():
        return port_bert.classify_seq_parallel([bundle.model], *([t] for t in _padded(_feats())))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sp_widths_give_the_same_logits(services, sp1_logits, n):
    _, (_, bundle, _, _) = services
    ids, mask = _padded(_feats())
    placement = SeqParallelSet(make_sp_devices("cpu", n))
    replicas = placement.place_params(lambda dev: bundle.model)
    with torch.inference_mode():
        got = port_bert.classify_seq_parallel(
            replicas, placement.place_batch(ids.numpy()), placement.place_batch(mask.numpy()))
        if n == 1:  # one shard: one hop over the whole block, K1's key-mask forward
            want = bundle.model.classify(ids, mask, use_kernel=True)
        else:
            want = sp1_logits
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _cfg(**kw) -> ServiceConfig:
    return ServiceConfig(**{"device": "cpu", "model_name": "bert-long", "warmup": False,
                            "batch_buckets": (1, 2), "seq_buckets": (32, 64), **kw})


def test_seq_buckets_not_divisible_by_the_width_raise():
    with pytest.raises(ValueError, match="not divisible"):
        build_model(_cfg(sp=8, seq_buckets=(32, 36)))


def test_undersized_position_table_raises():
    small = jax_bert.BertConfig(vocab_size=64, hidden_size=8, num_layers=1, num_heads=2,
                                intermediate_size=16, max_position=64, num_labels=2)
    params = jax.tree.map(np.asarray, jax_bert.init_params(jax.random.PRNGKey(0), cfg=small))
    with pytest.raises(ValueError, match="position-embedding"):
        build_model(_cfg(sp=8, seq_buckets=(512, 1024)), params=params)


def test_sp_past_the_visible_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="SP=2 but only 1 devices visible"):
        build_model(_cfg(device="cuda", sp=2))


def test_http_predict_and_status(services):
    _, (cfg, bundle, engine, _) = services

    async def main():
        app = build_app(cfg, bundle, engine, Batcher(engine, cfg))
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            for _ in range(200):
                resp = await client.get("/readyz")
                if resp.status == 200:
                    break
                await asyncio.sleep(0.05)
            assert resp.status == 200, await resp.text()
            resp = await client.post("/predict", json={"text": "a long context request " * 8})
            assert resp.status == 200, await resp.text()
            return await resp.json(), await (await client.get("/status")).json()
        finally:
            await client.close()

    body, status = asyncio.run(main())
    assert body["model"] == "bert-long" and "label_id" in body["prediction"]
    assert status["n_devices"] == 8 and status["model"] == "bert-long"
