"""The slice end to end on the CPU: BERT-base at full width served by the
JAX package and by the PyTorch port on the same weights (the JAX
service's params carried across by bert_params_from_jax), the same texts
through both ``Batcher.submit`` paths, then one HTTP /predict through the
port's aiohttp app.  Labels must be equal and probabilities within 1e-4
(f32 on both sides; twelve layers of products summed in another order).

Also the MODEL_PATH=*.npz route: a tiny HF-named state dict loads into
the same weights as the JAX package's load_pytree + bert_state_to_pytree.
"""

import asyncio
import functools
import types

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.convert import bert_state_to_pytree as jax_bert_state_to_pytree
from mlmicroservicetemplate_tpu.models import bert as jax_bert
from mlmicroservicetemplate_tpu.models.checkpoint import load_pytree
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.convert.jax_params import bert_params_from_jax
from mlmicroservicetemplate_tpu_torch.models import bert as port_bert
from mlmicroservicetemplate_tpu_torch.models import registry as port_registry
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher, batch_results
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils import tracing

TEXTS = [
    "hi",
    "the quick brown fox jumps over the lazy dog",
    "serving " * 9,
    "a longer request that lands in a bigger sequence bucket than the others do. " * 2,
]


async def _submit_all(batcher, bundle, item_cls):
    await batcher.start()
    try:
        feats = [bundle.preprocess(item_cls(text=t)) for t in TEXTS]
        return await asyncio.gather(*(batcher.submit(f) for f in feats))
    finally:
        await batcher.stop()


@pytest.fixture(scope="module")
def services():
    jcfg, jbundle, jengine, jbatcher, _ = jax_build_service(
        {"DEVICE": "cpu", "MODEL_NAME": "bert-base", "WARMUP": "0", "REPLICAS": "1"}
    )
    params = jax.tree.map(np.asarray, jbundle.params)
    port = build_service(
        {"DEVICE": "cpu", "MODEL_NAME": "bert-base", "WARMUP": "0"}, params=params
    )
    return (jbundle, jbatcher), port


def test_predict_matches_jax_service(services):
    (jbundle, jbatcher), (cfg, bundle, engine, batcher) = services
    assert bundle.device.type == "cpu" and bundle.cfg.hidden_size == 768
    want = asyncio.run(_submit_all(jbatcher, jbundle, JaxRawItem))
    got = asyncio.run(_submit_all(batcher, bundle, RawItem))
    assert engine.dispatches >= 1
    assert fused_attention.launches == 0  # CPU: the plain version ran
    np.testing.assert_allclose(batch_results(got), batch_results(want), atol=1e-4, rtol=0)
    for w, g in zip(want, got):
        pw, pg = jbundle.postprocess(w), bundle.postprocess(g)
        assert pg["prediction"]["label_id"] == pw["prediction"]["label_id"]
        np.testing.assert_allclose(pg["probs"], pw["probs"], atol=1e-4, rtol=0)


def test_http_predict_healthz_readyz(services):
    (jbundle, _), (cfg, bundle, engine, _) = services
    want = jbundle.postprocess(
        engine.run_batch([bundle.preprocess(RawItem(text=TEXTS[1]))])[0]
    )

    async def main():
        tracing.configure(True)
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
            health = await client.get("/healthz")
            assert health.status == 200 and (await health.json())["alive"] is True
            resp = await client.post("/predict", json={"text": TEXTS[1]})
            assert resp.status == 200, await resp.text()
            body = await resp.json()
            bad = await client.post("/predict", json={"nope": 1})
            assert bad.status == 400
            status = await (await client.get("/status")).json()
            metrics = await (await client.get("/metrics")).text()
            return body, status, metrics, tracing.tracer().snapshot()
        finally:
            tracing.configure(False)
            await client.close()

    body, status, metrics, spans = asyncio.run(main())
    assert body["model"] == "bert-base"
    assert body["prediction"]["label_id"] == want["prediction"]["label_id"]
    np.testing.assert_allclose(body["probs"], want["probs"], atol=1e-4, rtol=0)
    assert status["device"] == "cpu" and status["ready"] is True
    assert "predict_requests_total" in metrics
    # TRACE=1's spans: the request, its queue wait and its batch dispatch.
    rid = {s.rid for s in spans if s.name == "request" and s.args.get("path") == "/predict"}
    assert {"request", "queue_wait", "dispatch"} <= {s.name for s in spans}
    assert rid & {s.rid for s in spans if s.name == "queue_wait"}


def _tiny_hf_state(rng, n_layers, d, inter, vocab, labels):
    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    s = {
        "bert.embeddings.word_embeddings.weight": w(vocab, d),
        "bert.embeddings.position_embeddings.weight": w(512, d),
        "bert.embeddings.token_type_embeddings.weight": w(2, d),
        "bert.pooler.dense.weight": w(d, d),
        "bert.pooler.dense.bias": w(d),
        "classifier.weight": w(labels, d),
        "classifier.bias": w(labels),
    }

    def ln(prefix):
        s[f"{prefix}.weight"] = 1.0 + w(d)
        s[f"{prefix}.bias"] = w(d)

    ln("bert.embeddings.LayerNorm")
    for i in range(n_layers):
        base = f"bert.encoder.layer.{i}"
        for name, (o, n) in {
            "attention.self.query": (d, d), "attention.self.key": (d, d),
            "attention.self.value": (d, d), "attention.output.dense": (d, d),
            "intermediate.dense": (inter, d), "output.dense": (d, inter),
        }.items():
            s[f"{base}.{name}.weight"] = w(o, n)
            s[f"{base}.{name}.bias"] = w(o)
        ln(f"{base}.attention.output.LayerNorm")
        ln(f"{base}.output.LayerNorm")
    return s


def test_model_path_npz_loads_the_jax_weights(tmp_path):
    cfg = port_bert.BertConfig(vocab_size=300, hidden_size=32, num_layers=2, num_heads=2,
                               intermediate_size=64)
    path = tmp_path / "bert.npz"
    np.savez(path, **_tiny_hf_state(np.random.default_rng(0), 2, 32, 64, 300, 2))

    jax_tree = load_pytree(str(path), functools.partial(jax_bert_state_to_pytree, n_layers=2))
    got = port_registry._bert_state(types.SimpleNamespace(model_path=str(path)), cfg, None)
    want = bert_params_from_jax(jax.tree.map(np.asarray, jax_tree), cfg)
    assert got.keys() == want.keys()
    for name in got:
        torch.testing.assert_close(got[name], want[name], atol=0, rtol=0)

    # ... and the loaded weights classify as the JAX model does on them.
    jcfg = jax_bert.BertConfig(vocab_size=300, hidden_size=32, num_layers=2, num_heads=2,
                               intermediate_size=64)
    ids = np.random.default_rng(1).integers(0, 300, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 10:] = 0
    ref = jax_bert.classify(jax_tree, jcfg, ids, mask)
    model = port_bert.build_model(cfg, got, torch.device("cpu"), torch.float32)
    with torch.inference_mode():
        out = model.classify(torch.from_numpy(ids), torch.from_numpy(mask), use_kernel=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["t5-small", "t5small", "gpt2"])
def test_unported_model_names_raise(name, tmp_path):
    """The names these cases once saw refused now serve as the JAX package
    serves them: t5-small under both names (shrunk in both packages; the
    port on the JAX service's weights answers a request with the JAX
    engine's tokens), and gpt2 with a SentencePiece ``spiece.model``
    (the JAX factory's tokenizer: the same ids, a trailing EOS, and the
    model's eos/pad taken from it)."""
    from mlmicroservicetemplate_tpu.models import t5 as jax_t5
    from mlmicroservicetemplate_tpu.models import tokenizer as jax_tok
    from mlmicroservicetemplate_tpu.models.sentencepiece import write_spiece_model
    from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
    from mlmicroservicetemplate_tpu_torch.models import t5 as port_t5
    from test_sentencepiece import _pieces

    if name == "gpt2":
        path = str(tmp_path / "spiece.model")
        write_spiece_model(path, _pieces())
        small = dict(vocab_size=512, d_model=64, num_heads=2, num_layers=1, d_ff=128,
                     max_position=128)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_gpt, "GPTConfig", functools.partial(port_gpt.GPTConfig, **small))
            _, bundle, _, _ = build_service({"DEVICE": "cpu", "MODEL_NAME": name, "WARMUP": "0",
                                             "TOKENIZER_PATH": path, "SEQ_BUCKETS": "32",
                                             "MAX_DECODE_LEN": "8"})
        want = jax_tok.build_tokenizer(path, for_t5=True)
        assert bundle.tokenizer.add_eos and bundle.cfg.eos_id == bundle.tokenizer.eos_id
        for text in ("hello world", "the quick"):
            got = bundle.preprocess(RawItem(text=text))
            ids, mask = want.encode(text, bundle.max_prompt_len)
            np.testing.assert_array_equal(got["input_ids"], ids[: int(mask.sum())])
        return
    dims = dict(vocab_size=300, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=1)
    overrides = {"DEVICE": "cpu", "MODEL_NAME": name, "WARMUP": "0", "SEQ_BUCKETS": "16",
                 "BATCH_BUCKETS": "1", "MAX_DECODE_LEN": "8"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_t5, "T5Config", functools.partial(jax_t5.T5Config, **dims))
        mp.setattr(port_t5, "T5Config", functools.partial(port_t5.T5Config, **dims))
        _, jbundle, jengine, _, _ = jax_build_service({**overrides, "REPLICAS": "1"})
        _, bundle, engine, _ = build_service(overrides,
                                             params=jax.tree.map(np.asarray, jbundle.params))
    assert bundle.name == jbundle.name == "t5-small"
    want = jengine.run_batch([jbundle.preprocess(JaxRawItem(text="hello"))])
    got = engine.run_batch([bundle.preprocess(RawItem(text="hello"))])
    np.testing.assert_array_equal(got[0], want[0])


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        build_service({"DEVICE": "cuda", "MODEL_NAME": "bert-base"})
