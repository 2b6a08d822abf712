"""Batched multi-adapter LoRA (``ADAPTER_DIR``, ``ADAPTER_SLOTS``,
``X-Adapter``) in the port against the JAX package, f32 on the CPU, on the
cases of the JAX package's ``tests/test_tenancy.py`` (section 3) at small
GPT-2 and llama configs.

- ``lora.delta`` equals the JAX function; the pool's slot stacks (rank
  zero-padded, alpha / r folded into B) equal the JAX pool's after the
  same installs.
- A mixed-adapter wave (rows on adapter A, adapter B and none in one
  dispatch) gives each row its solo run's tokens and the JAX loop's, over
  the contiguous and the paged loop, with a dense and an int8 KV cache; an
  adapter changes the tokens; a row without one gets the tokens of a
  service without ``ADAPTER_DIR``, bit for bit; the pool's refs drain to 0.
- Installs and evictions after warm-up capture no graph (the graph path
  under the stand-in capturer of ``test_torch_graphs.py``): the slot stacks
  and the loop's row buffers keep their addresses.
- The pool's refcounts, coldest-idle eviction and ``AdapterBusy``; a full
  pool sheds a stream with 503 ``adapter_pool`` and the JAX app's
  Retry-After; the per-stream path sheds adapter streams with the JAX
  batcher's reason.
- The JAX package's boot refusals: ``SPEC_DECODE``, adapters of another
  architecture, and ``QUANTIZE=int8`` (its validation fails on the int8
  kernels, so the port refuses the pair too); ``X-Adapter`` 400s with the
  JAX app's reasons.
"""

import asyncio
import contextlib
import functools
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_graphs import _with_graphs

import jax
import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import lora as jax_lora
from mlmicroservicetemplate_tpu.models import t5 as jax_t5
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.scheduler.policy import QueueFullError as JaxQueueFullError
from mlmicroservicetemplate_tpu.tenancy.adapters import AdapterPool as JaxAdapterPool
from mlmicroservicetemplate_tpu.tenancy.adapters import load_adapter_dir as jax_load_dir
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import lora
from mlmicroservicetemplate_tpu_torch.models import t5 as port_t5
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.scheduler.policy import QueueFullError
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.tenancy.adapters import (
    AdapterBusy,
    AdapterPool,
    load_adapter_dir,
)

GPT = dict(vocab_size=300, d_model=64, num_heads=2, num_layers=2, d_ff=128, max_position=128)
LLAMA = dict(vocab_size=300, d_model=64, num_heads=4, num_kv_heads=2, num_layers=2, d_ff=128,
             max_position=128)
T5 = dict(vocab_size=384, d_model=64, d_kv=32, num_heads=2, d_ff=128, num_layers=2)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=8,
             stream_chunk_tokens=4, max_streams=4, kv_block_size=8)
PORT_SERVE = {"BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "8",
              "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "KV_BLOCK_SIZE": "8",
              "BATCH_TIMEOUT_MS": "1"}
DELTA_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def projections(model: str, dims: dict) -> dict:
    """The adapted projections' [d_in, d_out] (the reference's: llama
    q/k/v/o, GPT-2 qkv and out)."""
    d = dims["d_model"]
    if model == "llama":
        kv = d // dims["num_heads"] * dims["num_kv_heads"]
        return {"q": (d, d), "k": (d, kv), "v": (d, kv), "o": (d, d)}
    return {"qkv": (d, 3 * d), "out": (d, d)}


def write_adapters(path, model: str = "llama", dims: dict = LLAMA,
                   specs=(("alpha", 4, None, 0.5), ("beta", 2, 4.0, 0.5))) -> str:
    """One ``.npz`` adapter per (name, rank, alpha or None, std) under
    ``path``, for ``model`` at ``dims``; returns the directory."""
    rng = np.random.default_rng(7)
    for name, r, alpha, std in specs:
        arrs = {} if alpha is None else {"alpha": np.float32(alpha)}
        for li in range(dims["num_layers"]):
            for proj, (d_in, d_out) in projections(model, dims).items():
                arrs[f"layers.{li}.{proj}.lora_a"] = rng.normal(0, std, (d_in, r)).astype(
                    np.float32)
                arrs[f"layers.{li}.{proj}.lora_b"] = rng.normal(0, std, (r, d_out)).astype(
                    np.float32)
        np.savez(str(path / f"{name}.npz"), **arrs)
    return str(path)


@contextlib.contextmanager
def small(model: str):
    """Both packages' registries at the small configs above (T5 too)."""
    with pytest.MonkeyPatch.context() as mp:
        for jm, pm, cls, dims in ((jax_gpt, port_gpt, "GPTConfig", GPT),
                                  (jax_t5, port_t5, "T5Config", T5)):
            mp.setattr(jm, cls, functools.partial(getattr(jm, cls), **dims))
            mp.setattr(pm, cls, functools.partial(getattr(pm, cls), **dims))
        mp.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_service(model: str, **kw):
    with small(model):
        cfg = JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                               batch_timeout_ms=1.0, **{**SERVE, **kw})
        bundle = jax_build_model(cfg)
        engine = JaxEngine(bundle, cfg, ReplicaSet(make_mesh(1)))
    return cfg, bundle, engine


def port_service(model: str, params, **env):
    with small(model):
        return build_service({"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0",
                              **PORT_SERVE, **env}, params=params)


async def _collect(gen) -> list[int]:
    return [t async for chunk in gen for t in np.asarray(chunk).tolist()]


def _feats(bundle, item_cls, aid=None, text="hello world"):
    f = bundle.preprocess(item_cls(text=text))
    if aid is not None:
        f["adapter_id"] = aid
    return f


def _run_tenancy_case(batcher, bundle, item_cls):
    """The JAX test's body: base, alpha and beta solo, then the three as one
    wave (queued before the loop's thread starts, so one dispatch holds
    them)."""
    f, fa, fb = (_feats(bundle, item_cls, a) for a in (None, "alpha", "beta"))

    async def solo(feats):
        return await _collect(batcher.submit_stream(dict(feats)))

    async def body():
        base, a_solo, b_solo = await solo(f), await solo(fa), await solo(fb)
        loop = batcher._cdl
        loop._ensure_thread = lambda: None
        try:
            gens = [batcher.submit_stream(dict(x)) for x in (fa, fb, f)]
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        mixed = await asyncio.gather(*(_collect(g) for g in gens))
        return base, a_solo, b_solo, list(mixed)

    try:
        return asyncio.run(body())
    finally:
        asyncio.run(batcher.stop())


# ---------------------------------------------------------------------------
# the delta and the pool


def test_delta_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 2, 16, 4)).astype(np.float32)  # [S, L, d_in, r]
    b = rng.normal(size=(3, 2, 4, 24)).astype(np.float32)
    a[0] = b[0] = 0
    x = rng.normal(size=(4, 5, 16)).astype(np.float32)
    rows = np.array([2, 0, 1, 2], np.int32)
    want = jax_lora.apply({"rows": jnp.asarray(rows), "p": {"a": a, "b": b}}, "p", 1,
                          jnp.asarray(x), jnp.zeros((4, 5, 24)))
    ov = lora.Overlay(torch.from_numpy(rows).long(),
                      {"p": (torch.from_numpy(a), torch.from_numpy(b))})
    got = lora.apply(ov, "p", 1, torch.from_numpy(x), torch.zeros(4, 5, 24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DELTA_TOL, rtol=0)
    assert not got[1].any()  # slot 0: the zero delta
    y = torch.ones(2)
    assert lora.apply(None, "p", 0, x, y) is y and lora.apply(ov, "other", 0, x, y) is y
    assert lora.adapter_tables(object()) is None


def test_pool_stacks_equal_the_jax_pool(tmp_path):
    """Ranks 4 and 2 (the second padded, with alpha / r folded into B):
    after the same acquires, every slot of every stack equals the JAX
    pool's, and the status too."""
    adir = write_adapters(tmp_path)
    jpool = JaxAdapterPool(jax_load_dir(adir), slots=2, model="m")
    pool = AdapterPool(load_adapter_dir(adir), slots=2, model="m")
    assert (pool.rank, pool.num_layers, pool.projections) == (
        jpool.rank, jpool.num_layers, jpool.projections)
    for aid in ("beta", "alpha", "beta"):
        assert pool.acquire(aid) == jpool.acquire(aid)
    for proj in pool.projections:
        sa, sb = pool._stacks[proj]
        np.testing.assert_array_equal(sa.numpy(), np.asarray(jpool._stacks[proj]["a"]))
        np.testing.assert_array_equal(sb.numpy(), np.asarray(jpool._stacks[proj]["b"]))
    assert pool.status() == jpool.status()


def test_pool_refcounts_eviction_and_busy():
    """The JAX test's pool: every slot held -> AdapterBusy; an unknown id
    -> KeyError; a release lets the coldest idle slot take the next
    adapter; the refs drain to 0."""
    rng = np.random.default_rng(0)
    host = {name: {"p": (rng.normal(size=(1, 8, 2)).astype(np.float32),
                         rng.normal(size=(1, 2, 8)).astype(np.float32))}
            for name in ("a1", "a2")}
    pool = AdapterPool(host, slots=1)
    s1 = pool.acquire("a1")
    assert s1 == 1
    with pytest.raises(AdapterBusy):
        pool.acquire("a2")
    with pytest.raises(KeyError):
        pool.acquire("missing")
    pool.release(s1)
    assert pool.acquire("a2") == 1  # the coldest idle slot reused
    pool.release(1)
    pool.release(0)  # the zero slot is never counted
    assert pool.status()["live_refs"] == 0
    assert (pool.installs, pool.demotions) == (2, 1)


# ---------------------------------------------------------------------------
# mixed waves against solo runs and the JAX loop


@pytest.mark.parametrize("model,paged,kv_quant", [
    ("gpt2", False, False), ("gpt2", True, False),
    ("llama", False, True), ("llama", True, True),
])
def test_mixed_adapter_wave_matches_solo_and_jax(tmp_path, model, paged, kv_quant):
    dims = GPT if model == "gpt2" else LLAMA
    adir = write_adapters(tmp_path, model, dims)
    kw = {"adapter_dir": adir, "adapter_slots": 2, "paged_kv": paged,
          "quant_kv": "int8" if kv_quant else None}
    jcfg, jbundle, jengine = jax_service(model, **kw)
    jbatcher = JaxBatcher(jengine, jcfg)
    want = _run_tenancy_case(jbatcher, jbundle, JaxRawItem)
    env = {"ADAPTER_DIR": adir, "ADAPTER_SLOTS": "2", "PAGED_KV": "1" if paged else "0",
           **({"QUANT_KV": "int8"} if kv_quant else {})}
    params = _np(jbundle.params)
    _, bundle, engine, batcher = port_service(model, params, **env)
    got = _run_tenancy_case(batcher, bundle, RawItem)
    base, a_solo, b_solo, mixed = got
    assert mixed == [a_solo, b_solo, base]
    assert a_solo != base and b_solo != base  # the adapters change the tokens
    assert got == want
    assert batcher.adapters.status() == jbatcher.adapters.status()
    assert batcher.adapters.status()["live_refs"] == 0
    if paged:
        assert engine.kv_pool.used_blocks == 0
    # A row without an adapter: the tokens of a service without ADAPTER_DIR.
    plain = {k: v for k, v in env.items() if not k.startswith("ADAPTER")}
    _, pbundle, _, pbatcher = port_service(model, params, **plain)
    assert pbatcher.adapters is None and pbatcher.tenancy_status() is None

    async def one():
        return await _collect(pbatcher.submit_stream(_feats(pbundle, RawItem)))

    try:
        assert asyncio.run(one()) == base
    finally:
        asyncio.run(pbatcher.stop())


def test_install_and_evict_capture_no_graph(tmp_path):
    """One slot, on the graph path: after the warm-up and one base and one
    alpha stream, beta evicts alpha and alpha evicts beta, and no graph is
    captured; the stacks and the loop's row buffer keep their addresses and
    alpha's tokens are the same before and after."""
    adir = write_adapters(tmp_path, "gpt2", GPT)
    jcfg, jbundle, _ = jax_service("gpt2")
    _, bundle, engine, batcher = port_service("gpt2", _np(jbundle.params),
                                              ADAPTER_DIR=adir, ADAPTER_SLOTS="1")
    graphs = _with_graphs(engine)
    pool, loop = batcher.adapters, batcher._cdl
    engine.warmup()
    batcher.warm_streams()
    addrs = [t.data_ptr() for pair in pool._stacks.values() for t in pair]
    rows_addr = loop._ad_rows.data_ptr()

    async def run(aid):
        # With one slot, an acquire can meet the previous stream's reference
        # a moment before the loop releases it: that shed (503
        # adapter_pool) is the serving behavior, so retry it, as the JAX
        # test's churn loop does.
        for _ in range(100):
            try:
                return await _collect(batcher.submit_stream(_feats(bundle, RawItem, aid)))
            except QueueFullError as e:
                if e.reason != "adapter_pool":
                    raise
                await asyncio.sleep(0.05)
        raise AssertionError("the adapter slot never freed")

    async def body():
        first = [await run(None), await run("alpha")]
        captured = graphs.stats()["insert"]
        installs = pool.status()["installs"]
        churn = [await run("beta"), await run("alpha")]
        return first, captured, installs, churn

    try:
        (base, alpha), captured, installs, (beta, alpha2) = asyncio.run(body())
    finally:
        asyncio.run(batcher.stop())
    assert graphs.stats()["insert"] == captured
    assert pool.status()["installs"] == installs + 2 and pool.status()["demotions"] >= 2
    assert alpha2 == alpha and len({tuple(base), tuple(alpha), tuple(beta)}) == 3
    assert [t.data_ptr() for pair in pool._stacks.values() for t in pair] == addrs
    assert loop._ad_rows.data_ptr() == rows_addr
    assert engine.graph_modes()["loop_chunk"] == "graph"


# ---------------------------------------------------------------------------
# sheds, refusals, HTTP


async def _http(app, calls):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        return [await call(client) for call in calls]
    finally:
        await client.close()


async def _held_then(client, adapter_held, adapter_next):
    """Hold one stream on ``adapter_held`` open (its first line read), then
    stream on ``adapter_next``: (status, Retry-After, reason).  The held
    stream asks for 48 tokens, so it is still live (its adapter slot taken)
    when the second request arrives, however the loop's chunks are timed."""
    held = await client.post("/predict", json={"text": "a long prompt here", "stream": True,
                                               "max_tokens": 48},
                             headers={"X-Adapter": adapter_held})
    assert held.status == 200
    await held.content.readline()
    resp = await client.post("/predict", json={"text": "hi", "stream": True},
                             headers={"X-Adapter": adapter_next})
    out = (resp.status, resp.headers.get("Retry-After"), resp.reason)
    await resp.read()
    held.close()
    return out


def test_exhausted_pool_sheds_503_with_the_jax_retry_after(tmp_path):
    adir = write_adapters(tmp_path, "gpt2", GPT)
    jcfg, jbundle, jengine = jax_service("gpt2", adapter_dir=adir, adapter_slots=1,
                                         max_decode_len=64)
    japp = jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg))
    cfg, bundle, engine, batcher = port_service("gpt2", _np(jbundle.params), ADAPTER_DIR=adir,
                                                ADAPTER_SLOTS="1", MAX_DECODE_LEN="64")
    app = build_app(cfg, bundle, engine, batcher)
    calls = [lambda c: _held_then(c, "alpha", "beta")]
    (want,) = asyncio.run(_http(japp, calls))
    (got,) = asyncio.run(_http(app, calls))
    assert got == want
    assert got[0] == 503 and got[1] == "1"


def test_per_stream_path_sheds_adapter_streams_as_jax(tmp_path):
    adir = write_adapters(tmp_path)
    jcfg, jbundle, jengine = jax_service("llama", adapter_dir=adir, continuous_batching=False)
    jbatcher = JaxBatcher(jengine, jcfg)
    _, bundle, _, batcher = port_service("llama", _np(jbundle.params), ADAPTER_DIR=adir,
                                         CONTINUOUS_BATCHING="0")

    async def shed(b, bd, item_cls, err):
        with pytest.raises(err) as e:
            b.submit_stream(_feats(bd, item_cls, "alpha"))
        return e.value

    want = asyncio.run(shed(jbatcher, jbundle, JaxRawItem, JaxQueueFullError))
    got = asyncio.run(shed(batcher, bundle, RawItem, QueueFullError))
    assert (got.reason, str(got)) == (want.reason, str(want)) == ("adapter_pool", str(want))
    asyncio.run(batcher.stop())


def _boot_error(build):
    with pytest.raises(Exception) as e:
        build()
    return e.value


@pytest.mark.parametrize("case", ["spec", "wrong_width", "wrong_depth", "t5"])
def test_boot_refusals_carry_the_jax_reasons(tmp_path, case):
    """SPEC_DECODE with adapters, adapters of another width or depth, and a
    family without adapted layers (T5) fail the boot with the JAX
    package's message."""
    if case == "t5":
        adir = write_adapters(tmp_path)
        jcfg, _, jengine = jax_service("t5-small", adapter_dir=adir)
        jerr = _boot_error(lambda: JaxBatcher(jengine, jcfg))
        err = _boot_error(lambda: port_service("t5-small", None, ADAPTER_DIR=adir))
        assert type(err) is ValueError and str(err) == str(jerr)
        return
    dims = {"wrong_width": dict(LLAMA, d_model=32),
            "wrong_depth": dict(LLAMA, num_layers=3)}.get(case, LLAMA)
    adir = write_adapters(tmp_path, "llama", dims)
    kw = {"spec_decode": "ngram"} if case == "spec" else {}
    jcfg, jbundle, jengine = jax_service("llama", adapter_dir=adir, **kw)
    jerr = _boot_error(lambda: JaxBatcher(jengine, jcfg))
    env = {"SPEC_DECODE": "ngram"} if case == "spec" else {}
    err = _boot_error(lambda: port_service("llama", _np(jbundle.params), ADAPTER_DIR=adir,
                                           **env))
    assert type(err) is ValueError and str(err) == str(jerr)
    if case == "spec":
        assert "ADAPTER_DIR" in str(err)


def test_quantize_and_adapters_refuse_the_boot_as_jax(tmp_path):
    """The JAX package's validation reads each adapted projection's dense
    kernel, which QUANTIZE=int8 has made an int8 leaf: its boot fails, and
    the port refuses the pair at boot too."""
    adir = write_adapters(tmp_path)
    jcfg, jbundle, jengine = jax_service("llama", adapter_dir=adir, quantize="int8")
    with pytest.raises(AttributeError):
        JaxBatcher(jengine, jcfg)
    with pytest.raises(ValueError, match="QUANTIZE=int8"):
        port_service("llama", _np(jbundle.params), ADAPTER_DIR=adir, QUANTIZE="int8")


def test_x_adapter_400s_carry_the_jax_reasons(tmp_path):
    adir = write_adapters(tmp_path)
    jcfg, jbundle, jengine = jax_service("llama", adapter_dir=adir)
    params = _np(jbundle.params)
    japp = jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg))
    cfg, bundle, engine, batcher = port_service("llama", params, ADAPTER_DIR=adir)
    app = build_app(cfg, bundle, engine, batcher)
    pcfg, pjbundle, pjengine = jax_service("llama")
    plain_japp = jax_build_app(pcfg, pjbundle, pjengine, JaxBatcher(pjengine, pcfg))
    pcfg2, pbundle, pengine, pbatcher = port_service("llama", params)
    plain_app = build_app(pcfg2, pbundle, pengine, pbatcher)

    async def post(client, adapter):
        resp = await client.post("/predict", json={"text": "hi"},
                                 headers={"X-Adapter": adapter})
        body = await resp.text()
        return resp.status, resp.reason, body if resp.status == 400 else ""

    unknown = [lambda c: post(c, "nope"), lambda c: post(c, " ")]
    got = asyncio.run(_http(app, unknown))
    assert got == asyncio.run(_http(japp, unknown))
    assert got[0][0] == 400 and "alpha, beta" in got[0][1] and got[1][0] == 200
    without = [lambda c: post(c, "alpha")]
    got = asyncio.run(_http(plain_app, without))
    assert got == asyncio.run(_http(plain_japp, without))
    assert got[0][:2] == (400, "X-Adapter requires ADAPTER_DIR to be configured")
