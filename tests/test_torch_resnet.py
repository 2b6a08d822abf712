"""The port's ResNet against the JAX package's, on the CPU in f32: the
forward on the same params and images (a small config, one with the
downsample in the first stage, and ResNet-50 at full width), the
converters (JAX pytree -> the port's state, bitwise; the HF name maps of
both packages -> the same model), the image preprocessing byte for byte,
and the engine's uint8 image batches."""

import functools
import io
import threading
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.convert import resnet_state_to_pytree as jax_hf_map
from mlmicroservicetemplate_tpu.models.checkpoint import load_pytree
from mlmicroservicetemplate_tpu.models import preprocess as jax_pre
from mlmicroservicetemplate_tpu.models import resnet as jax_resnet
from mlmicroservicetemplate_tpu_torch.convert.hf_maps import resnet_state_to_pytree
from mlmicroservicetemplate_tpu_torch.convert.jax_params import resnet_params_from_jax
from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine
from mlmicroservicetemplate_tpu_torch.models import preprocess as port_pre
from mlmicroservicetemplate_tpu_torch.models import resnet as port_resnet
from mlmicroservicetemplate_tpu_torch.models.registry import KIND_IMAGE, KIND_TEXT, RawItem
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils.config import ServiceConfig

TINY = dict(depths=(1, 1, 1, 1), hidden_sizes=(32, 64, 128, 256), embedding_size=16,
            num_labels=10)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomized_bn(tree, rng):
    """The pytree with every BN's statistics and affine drawn at random
    (``bn3``, the residual branch's last, scaled down so activations stay
    O(1) through 16 blocks), so no BN is the identity."""
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


def jax_params(cfg, seed: int = 0) -> dict:
    params = jax.tree.map(np.asarray, jax_resnet.init_params(jax.random.PRNGKey(seed), cfg))
    return randomized_bn(params, np.random.default_rng(seed))


def port_logits(params, cfg, x: np.ndarray) -> np.ndarray:
    model = port_resnet.build_model(cfg, resnet_params_from_jax(params, cfg),
                                    torch.device("cpu"), torch.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        return port_resnet.apply(model, xt).numpy()


@pytest.mark.parametrize("kw,img,batch", [
    (TINY, 64, 2),
    ({**TINY, "downsample_in_first_stage": True}, 64, 2),
    ({}, 224, 1),  # ResNet-50 at full width
], ids=["small", "downsample_first", "resnet50"])
def test_apply_matches_jax(kw, img, batch):
    jcfg, pcfg = jax_resnet.ResNetConfig(**kw), port_resnet.ResNetConfig(**kw)
    params = jax_params(jcfg)
    x = np.random.default_rng(1).standard_normal((batch, img, img, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jax_resnet.apply(p, jcfg, v))(params, x))
    got = port_logits(params, pcfg, x)
    assert got.shape == (batch, pcfg.num_labels)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_channels_last_holds_through_the_model():
    """Every conv weight, and every activation a conv takes, is
    channels-last (a contiguous NCHW tensor would cost cuDNN a transpose
    on each side of the conv)."""
    cfg = port_resnet.ResNetConfig(**TINY)
    model = port_resnet.build_model(cfg, resnet_params_from_jax(jax_params(cfg), cfg),
                                    torch.device("cpu"), torch.float32)
    seen = []

    def check(mod, args):
        seen.append(args[0].is_contiguous(memory_format=torch.channels_last)
                    and mod.weight.is_contiguous(memory_format=torch.channels_last))

    hooks = [m.register_forward_pre_hook(check) for m in model.modules()
             if isinstance(m, port_resnet.Conv)]
    x = torch.zeros(2, 32, 32, 3).permute(0, 3, 1, 2)
    with torch.inference_mode():
        port_resnet.apply(model, x)
    for h in hooks:
        h.remove()
    assert len(seen) == 1 + 4 * 3 + 4 and all(seen)


@pytest.mark.parametrize("kw", [TINY, {}], ids=["small", "resnet50"])
def test_build_folds_every_batchnorm_and_applies_none(kw, monkeypatch):
    """``build_model`` folds each BN into its conv: no BN module is left,
    every conv (53 at full width) carries a bias, and the forward runs no
    BatchNorm and no per-channel affine, yet gives the unfolded logits."""
    cfg = port_resnet.ResNetConfig(**kw)
    params = jax_params(jax_resnet.ResNetConfig(**kw))
    model = port_resnet.build_model(cfg, resnet_params_from_jax(params, cfg),
                                    torch.device("cpu"), torch.float32)
    assert not any(isinstance(m, port_resnet.BatchNorm) for m in model.modules())
    convs = [m for m in model.modules() if isinstance(m, port_resnet.Conv)]
    assert len(convs) == 1 + 3 * sum(cfg.depths) + len(cfg.depths)
    assert all(c.bias is not None and c.bias.shape == (c.weight.shape[0],) for c in convs)
    if not kw:
        assert len(convs) == 53

    def refuse(*a, **k):
        raise AssertionError("a BatchNorm ran at run time")

    for mod, name in ((torch, "addcmul"), (torch, "batch_norm"),
                      (torch.nn.functional, "batch_norm")):
        monkeypatch.setattr(mod, name, refuse)
    x = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        got = port_resnet.apply(model, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    monkeypatch.undo()
    want = np.asarray(jax_resnet.apply(params, jax_resnet.ResNetConfig(**kw), x))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_fold_is_the_conv_then_its_affine():
    """One conv and its BN, folded, against the conv followed by the BN's
    f32 affine, and an unfolded model is refused by ``apply``."""
    cfg = port_resnet.ResNetConfig(**TINY)
    state = resnet_params_from_jax(jax_params(cfg), cfg)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 3, 32, 32))
                         .astype(np.float32)).contiguous(memory_format=torch.channels_last)
    g = state["embedder.bn.scale"] / torch.sqrt(state["embedder.bn.var"] + 1e-5)
    b = state["embedder.bn.bias"] - state["embedder.bn.mean"] * g
    want = torch.nn.functional.conv2d(x, state["embedder.conv.weight"], stride=2, padding=3)
    want = want * g[:, None, None] + b[:, None, None]
    model = port_resnet.build_model(cfg, state, torch.device("cpu"), torch.float32)
    with torch.inference_mode():
        got = model.embedder.conv(x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with torch.device("meta"):
        unfolded = port_resnet.ResNet(cfg)
    with pytest.raises(ValueError, match="folded"):
        port_resnet.apply(unfolded, x)


def test_params_from_jax_are_exact():
    cfg = port_resnet.ResNetConfig(**TINY)
    params = jax_params(cfg)
    state = resnet_params_from_jax(params, cfg)
    np.testing.assert_array_equal(state["embedder.conv.weight"].numpy(),
                                  params["embedder"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["stages.1.0.shortcut.conv.weight"].numpy(),
                                  params["stages"][1][0]["shortcut"]["conv"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["stages.2.0.bn3.var"].numpy(),
                                  params["stages"][2][0]["bn3"]["var"])
    np.testing.assert_array_equal(state["classifier.weight"].numpy(),
                                  params["classifier"]["kernel"].T)
    assert len(state) == len(jax.tree.leaves(params))


def test_params_from_jax_reject_a_wrong_tree():
    cfg = port_resnet.ResNetConfig(**TINY)
    params = jax_params(cfg)
    del params["stages"][0][0]["bn2"]["mean"]
    with pytest.raises(KeyError, match="lack"):
        resnet_params_from_jax(params, cfg)
    params = jax_params(cfg)
    params["stages"][0][0]["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="unused"):
        resnet_params_from_jax(params, cfg)
    params = jax_params(cfg)
    with pytest.raises(ValueError, match="shape"):
        resnet_params_from_jax(params, port_resnet.ResNetConfig(**{**TINY, "num_labels": 7}))


def hf_state(cfg, rng) -> dict[str, np.ndarray]:
    """A synthetic ``ResNetForImageClassification`` state dict (numpy)."""

    def conv(co, ci, k):
        return (rng.standard_normal((co, ci, k, k)) * np.sqrt(2.0 / (ci * k * k))).astype(
            np.float32)

    def bn(prefix, c, lo=0.8, hi=1.2):
        s[f"{prefix}.weight"] = rng.uniform(lo, hi, c).astype(np.float32)
        s[f"{prefix}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        s[f"{prefix}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        s[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        s[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    s = {"resnet.embedder.embedder.convolution.weight": conv(cfg.embedding_size, 3, 7)}
    bn("resnet.embedder.embedder.normalization", cfg.embedding_size)
    c_in = cfg.embedding_size
    for si, (depth, c_out) in enumerate(zip(cfg.depths, cfg.hidden_sizes)):
        for bi in range(depth):
            base = f"resnet.encoder.stages.{si}.layers.{bi}"
            c_mid = c_out // cfg.reduction
            if bi == 0:
                s[f"{base}.shortcut.convolution.weight"] = conv(c_out, c_in, 1)
                bn(f"{base}.shortcut.normalization", c_out)
            for li, (co, ci, k) in enumerate(((c_mid, c_in, 1), (c_mid, c_mid, 3),
                                              (c_out, c_mid, 1))):
                s[f"{base}.layer.{li}.convolution.weight"] = conv(co, ci, k)
                bn(f"{base}.layer.{li}.normalization", co, *((0.1, 0.3) if li == 2 else ()))
            c_in = c_out
    s["classifier.1.weight"] = (0.05 * rng.standard_normal((cfg.num_labels, c_in))).astype(
        np.float32)
    s["classifier.1.bias"] = (0.1 * rng.standard_normal(cfg.num_labels)).astype(np.float32)
    return s


def test_hf_maps_of_both_packages_give_the_same_model():
    jcfg, pcfg = jax_resnet.ResNetConfig(**TINY), port_resnet.ResNetConfig(**TINY)
    state = hf_state(pcfg, np.random.default_rng(3))
    jtree = jax_hf_map(state, depths=jcfg.depths)
    ported = resnet_state_to_pytree(state, depths=pcfg.depths)
    carried = resnet_params_from_jax(jtree, pcfg)
    assert ported.keys() == carried.keys()
    for name, arr in ported.items():
        np.testing.assert_array_equal(arr, carried[name].numpy(), err_msg=name)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_resnet.apply(jtree, jcfg, x))
    model = port_resnet.build_model(pcfg, ported, torch.device("cpu"), torch.float32)
    with torch.inference_mode():
        got = port_resnet.apply(model, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_model_path_npz_serves_the_jax_packages_weights(tmp_path, monkeypatch):
    """MODEL_PATH=*.npz of HF names: the port's bundle (at the small config)
    classifies as the JAX package's load_pytree + HF map does."""
    pcfg = port_resnet.ResNetConfig(**TINY)
    jcfg = jax_resnet.ResNetConfig(**TINY)
    path = tmp_path / "resnet.npz"
    np.savez(path, **hf_state(pcfg, np.random.default_rng(8)))
    monkeypatch.setattr(port_resnet, "ResNetConfig", lambda: pcfg)
    svc = build_service({"DEVICE": "cpu", "MODEL_NAME": "resnet50", "WARMUP": "0",
                         "MODEL_PATH": str(path)})
    bundle = svc[1]
    jtree = load_pytree(str(path), functools.partial(jax_hf_map, depths=jcfg.depths))
    x = np.random.default_rng(9).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(jax_resnet.apply(jtree, jcfg, np.asarray(jax_pre.normalize_imagenet(x))))
    with torch.inference_mode():
        got = bundle.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def encode(arr: np.ndarray, fmt: str) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("h,w", [(300, 200), (180, 320), (256, 256), (40, 90)],
                         ids=["w<h", "w>h", "w=h", "upsampled"])
def test_decode_image_u8_matches_jax_byte_for_byte(fmt, h, w):
    arr = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    data = encode(arr, fmt)
    got, want = port_pre.decode_image_u8(data, 224), jax_pre.decode_image_u8(data, 224)
    assert got.dtype == np.uint8 and got.shape == (224, 224, 3)
    np.testing.assert_array_equal(got, want)


def test_normalize_and_topk_match_jax():
    x = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = port_pre.normalize_imagenet(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pre.normalize_imagenet(x)),
                               atol=1e-6, rtol=0)
    logits = np.random.default_rng(6).standard_normal((3, 1000)).astype(np.float32)
    for k in (1, 5):
        for got_a, want_a in zip(port_pre.topk_np(logits, k), jax_pre.topk_np(logits, k)):
            np.testing.assert_array_equal(got_a, want_a)


@pytest.mark.parametrize("name", ["resnet50", "resnet-50"])
def test_resnet_names_build(name):
    cfg, bundle, engine, _ = build_service({"DEVICE": "cpu", "MODEL_NAME": name, "WARMUP": "0"})
    assert bundle.name == "resnet50" and bundle.kind == "image_classification"
    assert bundle.cfg.hidden_sizes == (256, 512, 1024, 2048) and bundle.image_size == 224
    assert bundle.model.classifier.weight.shape == (1000, 2048)


def test_engine_collates_uint8_batches_at_the_batch_bucket():
    cfg, bundle, engine, _ = build_service({"DEVICE": "cpu", "MODEL_NAME": "resnet50",
                                            "WARMUP": "0", "BATCH_BUCKETS": "1,4"})
    rng = np.random.default_rng(7)
    feats = [bundle.preprocess(RawItem(image=encode(
        rng.integers(0, 256, (230, 250, 3), dtype=np.uint8), "PNG"))) for _ in range(3)]
    batch, n = engine._collate_images(feats)
    assert (batch.dtype, tuple(batch.shape), n) == (torch.uint8, (4, 224, 224, 3), 3)
    np.testing.assert_array_equal(batch[1].numpy(), feats[1]["image"])
    assert not batch[3].any()
    rows = engine.run_batch(feats)
    alone = engine.run_batch(feats[2:])
    assert len(rows) == 3 and rows[0].shape == (1000,) and rows[0].dtype == np.float32
    np.testing.assert_allclose(rows[2], alone[0], atol=1e-4, rtol=1e-4)
    assert isinstance(engine, InferenceEngine) and engine.dispatches == 2


@pytest.mark.parametrize("kind,threads", [(KIND_IMAGE, 3), (KIND_TEXT, 1)])
def test_warm_engine_warms_every_dispatch_thread_of_an_image_model(kind, threads):
    """cuDNN keeps its execution plans per thread: an image model's warmup
    runs in each of the batcher's dispatch threads, a text model's once."""
    seen = []
    engine = types.SimpleNamespace(bundle=types.SimpleNamespace(name="fake", kind=kind),
                                   warmup=lambda: seen.append(threading.get_ident()))
    batcher = Batcher(engine, ServiceConfig(device="cpu", pipeline_depth=3))
    try:
        assert batcher.warm_engine() >= 0.0
    finally:
        batcher._executor.shutdown(wait=True)
    assert len(seen) == len(set(seen)) == threads
    assert threading.get_ident() not in seen
