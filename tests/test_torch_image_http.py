"""ResNet-50 ``/predict`` end to end on the CPU: the port's aiohttp app
against the JAX package's, on the same weights (the JAX service's params,
every BN drawn at random, carried across by ``resnet_params_from_jax``)
and the same image bytes.

- Raw ``image/png`` and multipart bodies (a ``file``, ``image`` or
  ``upload`` part, or an unnamed part with a filename) answer with the
  class id and top-5 ids of the JAX bundle's ``postprocess`` of the JAX
  forward, scores within 1e-5.
- A multipart ``text`` part is a text request (served by bert-base).
- What the JAX app answers 400 (an empty body, corrupt bytes, a multipart
  body with no usable part, JSON to resnet50, an image to bert-base), the
  port answers 400 with the same reason.
- The readiness canary (``WARMUP=0``) is a zero uint8 image; concurrent
  images form batches above 1 in the batcher.
"""

import asyncio
import io

import jax
import numpy as np
import pytest
import torch
from aiohttp import MultipartWriter
from aiohttp.test_utils import TestClient, TestServer

from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.models import preprocess as jax_pre
from mlmicroservicetemplate_tpu.models.registry import KIND_TEXT as JAX_KIND_TEXT
from mlmicroservicetemplate_tpu.models.registry import ModelBundle as JaxBundle
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service

SERVE = {"DEVICE": "cpu", "MODEL_NAME": "resnet50", "WARMUP": "0", "BATCH_BUCKETS": "1,2,4,8",
         "MAX_BATCH": "8"}
SIZES = [(300, 200), (180, 320), (256, 256), (40, 90), (500, 400), (224, 224)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomized_bn(tree, rng):
    """Every BN's statistics and affine drawn at random (``bn3`` scaled
    down so activations stay O(1) through 16 blocks)."""
    if isinstance(tree, list):
        return [randomized_bn(v, rng) for v in tree]
    out = {}
    for k, v in tree.items():
        if k.startswith("bn"):
            c = np.shape(v["scale"])[0]
            lo, hi = (0.1, 0.3) if k == "bn3" else (0.8, 1.2)
            v = {"scale": rng.uniform(lo, hi, c), "bias": 0.1 * rng.standard_normal(c),
                 "mean": 0.1 * rng.standard_normal(c), "var": rng.uniform(0.5, 1.5, c)}
            out[k] = {n: a.astype(np.float32) for n, a in v.items()}
        elif isinstance(v, (dict, list)):
            out[k] = randomized_bn(v, rng)
        else:
            out[k] = np.asarray(v)
    return out


def png(h: int, w: int, seed: int) -> bytes:
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def services():
    jcfg, jbundle, jengine, _, _ = jax_build_service({**SERVE, "REPLICAS": "1"})
    params = randomized_bn(jax.tree.map(np.asarray, jbundle.params), np.random.default_rng(0))
    forward = jax.jit(jbundle.forward)
    images = [png(h, w, i) for i, (h, w) in enumerate(SIZES)]
    want = [jbundle.postprocess(np.asarray(forward(params, jax_pre.decode_image_u8(d)[None]))[0])
            for d in images]
    port = build_service(SERVE, params=params)
    return (jcfg, jbundle, jengine), port, images, want


async def _http(app, posts):
    """Wait for /readyz, then POST each body; returns (status, reason, JSON
    or None) per post, and the app's /status."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            resp = await client.get("/readyz")
            if resp.status == 200:
                break
            await asyncio.sleep(0.05)
        assert resp.status == 200, await resp.text()
        out = []
        for kw in posts:
            resp = await client.post("/predict", **kw)
            out.append((resp.status, resp.reason,
                        await resp.json() if resp.status == 200 else None))
        return out, await (await client.get("/status")).json()
    finally:
        await client.close()


def _multipart(name: str | None, data: bytes | str, filename: str | None = None,
               ctype: str = "image/png") -> dict:
    """A ``multipart/form-data`` body of one part, named ``name`` (none if
    None), with a ``filename`` if given."""
    writer = MultipartWriter("form-data")
    part = writer.append(data, {"Content-Type": ctype})
    disposition = {k: v for k, v in (("name", name), ("filename", filename)) if v is not None}
    part.set_content_disposition("form-data", **disposition)
    return {"data": writer}


def _assert_matches(got: dict, want: dict) -> None:
    assert got["model"] == "resnet50"
    assert got["prediction"]["class_id"] == want["prediction"]["class_id"]
    assert [t["class_id"] for t in got["topk"]] == [t["class_id"] for t in want["topk"]]
    np.testing.assert_allclose([t["score"] for t in got["topk"]],
                               [t["score"] for t in want["topk"]], atol=1e-5, rtol=0)


@pytest.mark.parametrize("body", ["raw", "file", "image", "upload", "unnamed-with-filename"])
def test_image_bodies_match_the_jax_forward(services, body):
    _, (cfg, bundle, engine, _), images, want = services
    i = ["raw", "file", "image", "upload", "unnamed-with-filename"].index(body)
    data = images[i]
    if body == "raw":
        post = {"data": data, "headers": {"Content-Type": "image/png"}}
    elif body == "unnamed-with-filename":
        post = _multipart(None, data, filename="cat.png")
    else:
        post = _multipart(body, data)
    dispatches = engine.dispatches
    ((status, reason, got),), status_body = asyncio.run(
        _http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), [post]))
    assert status == 200, reason
    _assert_matches(got, want[i])
    # The readiness canary (WARMUP=0) and the request: two dispatches.
    assert engine.dispatches == dispatches + 2
    assert status_body["kind"] == "image_classification" and status_body["ready"] is True


def test_canary_is_a_zero_uint8_image(services):
    _, (cfg, bundle, engine, _), _, _ = services
    seen = []
    run_batch = engine.run_batch

    def recording(feats):
        seen.extend(feats)
        return run_batch(feats)

    engine.run_batch = recording
    try:
        asyncio.run(_http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), []))
    finally:
        del engine.run_batch
    (canary,) = seen
    assert canary["image"].dtype == np.uint8 and canary["image"].shape == (224, 224, 3)
    assert not canary["image"].any()


def test_concurrent_images_batch_above_one(services):
    _, (cfg, bundle, engine, _), images, want = services
    sizes = []
    run_batch = engine.run_batch

    def recording(feats):
        sizes.append(len(feats))
        return run_batch(feats)

    async def main():
        batcher = Batcher(engine, cfg)
        await batcher.start()
        try:
            feats = [bundle.preprocess(RawItem(image=d)) for d in images]
            return await asyncio.gather(*(batcher.submit(f) for f in feats))
        finally:
            await batcher.stop()

    engine.run_batch = recording
    try:
        rows = asyncio.run(main())
    finally:
        del engine.run_batch
    assert max(sizes) > 1 and sum(sizes) == len(images)
    for row, w in zip(rows, want):
        _assert_matches({**bundle.postprocess(row), "model": bundle.name}, w)


def test_multipart_text_part_is_a_text_request():
    cfg, bundle, engine, _ = build_service({"DEVICE": "cpu", "MODEL_NAME": "bert-base",
                                            "WARMUP": "0"})
    post = _multipart("text", "a multipart text request", ctype="text/plain")
    ((status, reason, got),), _ = asyncio.run(
        _http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), [post]))
    assert status == 200, reason
    want = bundle.postprocess(
        engine.run_batch([bundle.preprocess(RawItem(text="a multipart text request"))])[0])
    assert got["prediction"] == want["prediction"]
    # An image to a text model: the JAX bundle's reason.
    with pytest.raises(ValueError) as jax_err:
        JaxBundle(name="bert-base", kind=JAX_KIND_TEXT, cfg=None, params=None, policy=None,
                  tokenizer=None, labels=None, forward=None).preprocess(
            JaxRawItem(image=b"\x89PNG"))
    ((status, reason, _),), _ = asyncio.run(_http(
        build_app(cfg, bundle, engine, Batcher(engine, cfg)),
        [{"data": png(32, 32, 9), "headers": {"Content-Type": "image/png"}}]))
    assert (status, reason) == (400, str(jax_err.value))


BAD = {
    "empty": {"data": b"", "headers": {"Content-Type": "image/png"}},
    "corrupt": {"data": b"\x89PNG not really an image", "headers": {"Content-Type": "image/png"}},
    "octet-corrupt": {"data": b"\x00" * 64,
                      "headers": {"Content-Type": "application/octet-stream"}},
    "multipart-without-part": _multipart("other", "x", ctype="text/plain"),
    "json-to-resnet": {"json": {"text": "hello"}},
}


def test_bad_bodies_answer_400_with_the_jax_reasons(services):
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _), _, _ = services
    posts = list(BAD.values())
    want, _ = asyncio.run(_http(jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)),
                                posts))
    # A multipart writer is consumed by a post: a fresh one for the port.
    posts[3] = _multipart("other", "x", ctype="text/plain")
    got, _ = asyncio.run(_http(build_app(cfg, bundle, engine, Batcher(engine, cfg)), posts))
    for name, (gs, gr, _), (ws, wr, _) in zip(BAD, got, want):
        assert gs == ws == 400, (name, gr, wr)
        # PIL's message names the buffer object (an address): compare up
        # to it.
        assert gr.split(" <")[0] == wr.split(" <")[0], name
