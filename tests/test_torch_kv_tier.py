"""The host KV tier (``KV_HOST_BUDGET_MB``, ``KV_PREFETCH_BLOCKS``) of the
port against the JAX package's, f32 on the CPU, at small gpt2 and llama
configs on the same weights (the services of ``test_torch_prefill_loop.py``;
pools sized as the JAX package's own tier tests size them: 8-token blocks,
a pool of 6 so that two 14-token streams admit and cannot both grow):

- Primitives: the host pool's round trip and discipline, the swap ledger's
  conservation and eviction (prefix entries first), the lazy pool and its
  gate, each against the JAX classes on the same sequence; the config's
  validators and the build gate with the JAX messages.
- Swap resume, {gpt2, llama, llama int8} x {greedy, seeded sampled}: the
  dry-pool checkpoint swaps out and resumes by prefetch, with the tokens
  of uninterrupted runs and of the JAX loop, the JAX loop's swap counts
  (sampled: as many or fewer swaps, each resumed; see the test), both
  pools drained, and the restored blocks equal bit for bit to the blocks
  swapped out.
- A swapped checkpoint holds no device block while it waits.
- Fallbacks: a tier too small for the swap, and a host copy evicted while
  its stream waits: the same tokens, counted as the JAX loop counts them.
- Demotion and promotion of an evicted prefix pin, token-identically.
- A job checkpointed mid-prefill resumes partially: no window prefilled
  twice.
- ``/status.kv_tier`` and the tier's metrics equal the JAX app's.
"""

import asyncio
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families
from test_torch_prefill_loop import feats, ids_of, loops, services, settle

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine import kv_blocks as jax_kv
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.utils import metrics as jax_metrics
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.engine import kv_blocks as port_kv
from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import blocks_for
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.utils import metrics as port_metrics
from mlmicroservicetemplate_tpu_torch.utils.config import ServiceConfig, load_config

LEAF_SPECS = [((4, 2, 8), torch.float32), ((4, 2, 1), torch.float32)]
JAX_LEAF_SPECS = [((4, 2, 8), np.float32), ((4, 2, 1), np.float32)]
# The loop of the JAX package's tier tests: 8-token blocks, 4 slots.
TIER = dict(batch_buckets=(1, 2, 4), seq_buckets=(16, 32), max_decode_len=12,
            stream_chunk_tokens=4, max_streams=4, paged_kv=True, kv_block_size=8,
            max_stream_queue=4)


def _block_bytes(model: str, quant: str | None = None) -> int:
    """Bytes of one 8-token f32 block of the small configs (K and V, 2
    layers); int8: one f32 scale a token and head beside the payload."""
    heads, head_dim = (4, 32) if model == "gpt2" else (2, 16)
    per_head = head_dim + 4 if quant == "int8" else head_dim * 4
    return 2 * 2 * heads * per_head * 8


def _tier_loops(model: str, n_blocks: int = 6, host_mb: float = 1.0, **kw):
    """(JAX loop, JAX engine, port loop, port engine) over a pool of
    ``n_blocks`` blocks and a host tier of ``host_mb``."""
    bb = _block_bytes(model, kw.get("quant_kv"))
    out = loops(model, **TIER, kv_budget_mb=(n_blocks * bb + bb // 2) / 1e6,
                kv_host_budget_mb=host_mb, **kw)
    assert out[1].kv_pool.num_blocks == out[3].kv_pool.num_blocks == n_blocks
    return out


def _prompts(n: int = 2, length: int = 14, seed: int = 3, **extra) -> list[dict]:
    return [feats(ids_of(length, seed + i), **extra) for i in range(n)]


async def _collect(gen) -> list[int]:
    return [int(t) async for chunk in gen for t in np.asarray(chunk).tolist()]


def _run(loop, batch) -> list[list[int]]:
    async def body():
        out = list(await asyncio.gather(*(_collect(loop.submit_stream(dict(f)))
                                          for f in batch)))
        # A loop releases a stream's admission after its last chunk, the
        # JAX loop through this event loop (``call_soon_threadsafe``): keep
        # it running until both have, or a release queued as it closes is
        # lost.
        for _ in range(1000):
            if not loop._admitted:
                break
            await asyncio.sleep(0.01)
        return out
    try:
        return asyncio.run(body())
    finally:
        loop.stop()


def _solo(engine, f: dict) -> list[int]:
    return [int(t) for chunk in engine.generate_stream(dict(f)) for t in chunk]


def _swap_counts(loop) -> dict:
    return {k: getattr(loop, k) for k in ("swap_outs", "swap_ins", "swap_fallbacks",
                                          "swap_out_bytes", "swap_in_bytes",
                                          "host_prefix_promotes")}


def _drained(loop, engine) -> None:
    settle(loop)
    deadline = time.monotonic() + 5.0
    while engine.kv_pool.used_blocks and time.monotonic() < deadline:
        time.sleep(0.02)
    assert engine.kv_pool.used_blocks == 0
    assert engine.kv_host.pool.used_blocks == 0


# ---------------------------------------------------------------------------
# primitives


def test_host_pool_write_read_roundtrip_like_jax():
    pool = port_kv.HostBlockPool(4, block_bytes=64, leaf_specs=LEAF_SPECS)
    ref = jax_kv.HostBlockPool(4, block_bytes=64, leaf_specs=JAX_LEAF_SPECS)
    ids = pool.alloc(2)
    assert ref.alloc(2) == ids
    vals = [np.arange(2 * 4 * 2 * 8, dtype=np.float32).reshape(2, 4, 2, 8),
            np.ones((2, 4, 2, 1), np.float32) * 7]
    pool.write(ids, [torch.from_numpy(v) for v in vals])
    ref.write(ids, vals)
    for order in (ids, list(reversed(ids))):
        for got, want in zip(pool.read(order), ref.read(order)):
            np.testing.assert_array_equal(got.numpy(), want)
    # Into given (staging) tensors, in place.
    out = [torch.empty(2, *shape, dtype=dtype) for shape, dtype in LEAF_SPECS]
    assert pool.read(ids, out=out) is out
    np.testing.assert_array_equal(out[0].numpy(), vals[0])
    # bf16 leaves round trip too (numpy has no bf16: the port's buffers are tensors).
    bf = port_kv.HostBlockPool(2, 64, [((4, 2, 8), torch.bfloat16)])
    x = torch.randn(1, 4, 2, 8).to(torch.bfloat16)
    bf.write([1], [x])
    assert torch.equal(bf.read([1])[0], x)


def test_pool_discipline_holds_in_both_tiers_like_jax():
    for pool in (port_kv.BlockPool(4, block_bytes=100),
                 port_kv.HostBlockPool(4, block_bytes=100, leaf_specs=LEAF_SPECS),
                 jax_kv.HostBlockPool(4, block_bytes=100, leaf_specs=JAX_LEAF_SPECS)):
        a = pool.alloc(3)
        assert pool.free_blocks == 1
        with pytest.raises(Exception, match="need 2 blocks"):
            pool.alloc(2)
        assert pool.free_blocks == 1  # all or nothing
        pool.free(a)
        assert pool.used_blocks == 0
        with pytest.raises(ValueError, match="double free"):
            pool.free(a[:1])


@pytest.mark.parametrize("kv", [port_kv, jax_kv], ids=["port", "jax"])
def test_swap_ledger_conservation_and_eviction(kv):
    """Every host block has one live owner: releasing every entry drains
    the pool; a second release is absorbed; eviction takes the prefix entry
    before an older stream entry; a reservation past the tier evicts
    nothing.  The same sequence gives the same stats in both packages."""
    specs = LEAF_SPECS if kv is port_kv else JAX_LEAF_SPECS
    pool = kv.HostBlockPool(4, block_bytes=64, leaf_specs=specs)
    ledger = kv.SwapLedger(pool)
    s1 = ledger.reserve(2, tokens=16, kind="stream")
    p1 = ledger.reserve(1, tokens=8, kind="prefix", key=("k", 1))
    assert pool.used_blocks == 3 and len(ledger) == 2
    assert ledger.prefix_get(("k", 1)) is p1
    s2 = ledger.reserve(2, tokens=16, kind="stream")
    assert s2 is not None and not p1.alive and s1.alive
    assert ledger.prefix_get(("k", 1)) is None
    assert ledger.reserve(5, tokens=40, kind="stream") is None
    assert s1.alive and s2.alive
    mid = ledger.stats()
    ledger.release(s1)
    ledger.release(s1)
    ledger.release(s2)
    assert pool.used_blocks == 0 and len(ledger) == 0
    assert mid == {"entries": 2, "stream_entries": 2, "prefix_entries": 0, "evictions": 1,
                   "used_blocks": 4, "free_blocks": 0}
    with pytest.raises(ValueError, match="double free"):
        pool.free(s1.ids)


def test_kv_host_tier_lazy_pool_and_gate_like_jax():
    tier = port_kv.KVHostTier(budget_mb=1.0, block_bytes=4096)
    ref = jax_kv.KVHostTier(budget_mb=1.0, block_bytes=4096)
    assert tier.enabled and tier.pool is None and tier.stats() == ref.stats()
    assert tier.ensure_pool(LEAF_SPECS) and ref.ensure_pool(JAX_LEAF_SPECS)
    assert tier.pool.num_blocks == ref.pool.num_blocks == 244
    assert [tuple(b.shape) for b in tier.pool.leaves] == [b.shape for b in ref.pool.leaves]
    assert tier.stats() == ref.stats() and tier.pin_seconds >= 0
    assert tier.pool.leaves[0].is_pinned() is False  # pinned only on the card
    off = port_kv.KVHostTier(budget_mb=0.0, block_bytes=4096)
    assert not off.enabled and not off.ensure_pool(LEAF_SPECS) and off.pool is None


@pytest.mark.parametrize("field,value,name", [("kv_host_budget_mb", -1.0, "KV_HOST_BUDGET_MB"),
                                              ("kv_prefetch_blocks", 0, "KV_PREFETCH_BLOCKS"),
                                              ("kv_prefetch_blocks", 4097,
                                               "KV_PREFETCH_BLOCKS")])
def test_config_validators_give_the_jax_messages(field, value, name):
    with pytest.raises(ValueError) as want:
        JaxServiceConfig(**{field: value})
    with pytest.raises(ValueError, match=name) as got:
        ServiceConfig(device="cpu", **{field: value})
    assert str(got.value) in str(want.value)
    env = {"DEVICE": "cpu", name: str(value)}
    with pytest.raises(ValueError, match=name):
        load_config(env)


def test_build_gate_needs_paged_kv_with_the_jax_message():
    """Without PAGED_KV the tier has no blocks to swap: both engines refuse
    to build with the same message; with it, the engine holds the tier
    (its pool built later, off the pools' leaves); a budget of 0 (the
    default) builds none."""
    (jcfg, jbundle, _), (cfg, bundle, engine, _) = services("llama", **TIER)
    from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine

    bad = dict(TIER, paged_kv=False, kv_host_budget_mb=1.0)
    with pytest.raises(ValueError) as want:
        JaxEngine(jbundle, JaxServiceConfig(device="cpu", warmup=False, model_name="llama",
                                            **bad), ReplicaSet(make_mesh(1)))
    with pytest.raises(ValueError) as got:
        InferenceEngine(bundle, ServiceConfig(device="cpu", model_name="llama", **bad))
    assert str(got.value) == str(want.value) and "requires PAGED_KV=1" in str(got.value)
    assert engine.kv_host is None and _loop_tier(cfg, bundle) is None
    on = ServiceConfig(device="cpu", model_name="llama", **dict(TIER, kv_host_budget_mb=1.0))
    eng = InferenceEngine(bundle, on)
    assert eng.kv_host is not None and eng.kv_host.pool is None
    assert eng.kv_host.block_bytes == eng.kv_block_bytes()
    assert eng.kv_host.num_blocks == int(1e6) // eng.kv_block_bytes()


def _loop_tier(cfg, bundle):
    """The loop's tier of a service built without the knob."""
    from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine

    return Batcher(InferenceEngine(bundle, cfg), cfg)._cdl._host_tier()


def test_host_buffers_follow_the_pool_leaves_order():
    """The host buffers mirror the paged pools leaf by leaf (cache_k then
    cache_v, layer by layer, an int8 payload before its scale), built once
    when the slot state is, and written in place afterwards."""
    _, _, loop, engine = _tier_loops("llama", quant_kv="int8")
    try:
        loop.warm()
        tier = engine.kv_host
        leaves = loop._pool_leaves()
        assert len(leaves) == 2 * 2 * 2  # K/V x layers x (payload, scale)
        assert [(tuple(b.shape[1:]), b.dtype) for b in tier.pool.leaves] == \
            [(tuple(x.shape[1:]), x.dtype) for x in leaves]
        assert [b.dtype for b in tier.pool.leaves[:2]] == [torch.int8, torch.float32]
        first = [b.data_ptr() for b in tier.pool.leaves]
        with torch.inference_mode(), engine._lock:
            loop._build_empty_state()  # a reset: the same buffers
        assert [b.data_ptr() for b in tier.pool.leaves] == first
    finally:
        loop.stop()


# ---------------------------------------------------------------------------
# swap resume


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("model,quant", [("gpt2", None), ("llama", None), ("llama", "int8")],
                         ids=["gpt2", "llama", "llama-int8"])
def test_swap_resume_is_token_identical_like_jax(model, quant, sampled):
    """Two 14-token streams over 6 blocks: growth runs dry, one stream is
    checkpointed, its blocks swap out and come back by prefetch.  Tokens
    equal uninterrupted runs and the JAX loop's, the swap counts the JAX
    loop's, both pools drain, and every restored block equals the block
    swapped out bit for bit."""
    jloop, jengine, loop, engine = _tier_loops(model, **({"quant_kv": quant} if quant else {}))
    extra = [dict(temperature=0.9, seed=4321 + i) if sampled else {} for i in range(2)]
    batch = [dict(f, **e) for f, e in zip(_prompts(), extra)]
    swapped, restored = {}, []
    swap_out, handoff = loop._swap_out_blocks, loop._swap_handoff

    def on_swap_out(st, block_ids, cov):
        nb = blocks_for(cov, loop.block_size)
        swapped[id(st)] = [leaf[block_ids[:nb]].clone() for leaf in loop._pool_leaves()]
        return swap_out(st, block_ids, cov)

    def on_handoff(job):
        rows = [leaf[job.sb.ids].clone() for leaf in loop._pool_leaves()]
        restored.append(all(torch.equal(a, b) for a, b in zip(rows, swapped[id(job.st)])))
        return handoff(job)

    loop._swap_out_blocks, loop._swap_handoff = on_swap_out, on_handoff
    want = _run(jloop, batch)
    got = _run(loop, batch)
    assert got == want == [_solo(engine, f) for f in batch]
    assert loop.swap_outs >= 1 and loop.swap_fallbacks == jloop.swap_fallbacks == 0
    if sampled:
        # A replayed stream grows again from its prompt after its resume, and
        # the JAX loop routes the other stream's last chunk an iteration
        # later than the port (it waits for XLA's asynchronous result), so
        # it runs dry and swaps the resumed stream out once more.
        for lp in (loop, jloop):
            assert lp.swap_ins == lp.swap_outs and lp.prefetch_blocks_total > 0
        assert loop.swap_outs <= jloop.swap_outs
    else:
        assert _swap_counts(loop) == _swap_counts(jloop)
        assert loop.prefetch_blocks_total == jloop.prefetch_blocks_total > 0
    assert restored and all(restored) and len(restored) == loop.swap_ins
    _drained(loop, engine)
    _drained(jloop, jengine)


def test_swapped_stream_holds_no_device_block_while_waiting():
    """At every chunk boundary while a swapped checkpoint waits in the
    queue, it holds no block: the pool holds one live stream's blocks at
    most."""
    _, _, loop, engine = _tier_loops("gpt2")
    seen = []
    advance = loop._advance_swapins

    def spy():
        waiting = [it for heap in loop.queue._heaps.values() for _, it in heap
                   if not it._removed and it.swap is not None]
        if waiting:
            assert all(s.blocks is None for s in waiting)
            seen.append(engine.kv_pool.used_blocks)
        return advance()

    loop._advance_swapins = spy
    _run(loop, _prompts())
    assert loop.swap_outs >= 1 and seen, "no swapped checkpoint ever waited"
    assert max(seen) <= blocks_for(16 + 12 + 4, 8), seen
    _drained(loop, engine)


@pytest.mark.parametrize("case", ["tier_too_small", "evicted_while_waiting"])
def test_fallback_resumes_by_recompute_like_jax(case):
    """A tier of one block cannot hold a 3-block swap: no swap, a recompute
    resume.  A host copy evicted while its stream waits: the resume falls
    back to recompute, counted as a fallback.  Either way the tokens are
    the uninterrupted runs' and the JAX loop's, with its counts."""
    host_mb = 4096 / 1e6 if case == "tier_too_small" else 1.0
    jloop, jengine, loop, engine = _tier_loops("gpt2", host_mb=host_mb)
    if case == "tier_too_small":
        assert engine.kv_host.num_blocks == jengine.kv_host.num_blocks == 0
    else:
        for lp in (jloop, loop):
            start = lp._start_swapin

            def evicted(st, lp=lp, start=start):
                lp._drain_swapouts()
                if st.swap is not None:
                    st.swap.ledger.release(st.swap)
                return start(st)

            lp._start_swapin = evicted
    batch = _prompts()
    want = _run(jloop, batch)
    assert _run(loop, batch) == want == [_solo(engine, f) for f in batch]
    assert loop.swap_ins == 0 and _swap_counts(loop) == _swap_counts(jloop)
    assert loop.recasts >= 1
    if case == "evicted_while_waiting":
        assert loop.swap_outs >= 1 and loop.swap_fallbacks == loop.swap_outs
    settle(loop)
    assert engine.kv_pool.used_blocks == 0


def test_demoted_prefix_pin_promotes_back_like_jax():
    """A prefix cache that holds one 16-token pin: donor A pins, donor B's
    pin evicts A's, which is demoted to the host (its device refs free when
    the copy lands); A's conversation returns and promotes the pin back.
    Tokens equal a service without the cache and the JAX loop's; the
    promotion, the ledgers and the cache's counts are the JAX loop's."""
    pin = 16 * _block_bytes("gpt2") // 8
    kw = dict(TIER, prefix_cache=True, prefix_cache_mb=1.5 * pin / 1e6, kv_host_budget_mb=1.0)
    kw.pop("max_stream_queue")
    jloop, jengine, loop, engine = loops("gpt2", **kw)
    rng = np.random.default_rng(0)
    shared_a, shared_b = (rng.integers(5, 250, 20).astype(np.int32) for _ in range(2))
    f_a1, f_b1, f_a2 = (feats(np.concatenate([shared, rng.integers(5, 250, n).astype(np.int32)]))
                        for shared, n in ((shared_a, 5), (shared_b, 5), (shared_a, 9)))
    outs, states = [], []
    for lp, eng in ((jloop, jengine), (loop, engine)):
        try:
            out = [asyncio.run(_first(lp, f_a1)), asyncio.run(_first(lp, f_b1))]
            deadline = time.monotonic() + 5.0
            while eng.kv_pool.used_blocks > 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            demoted = (eng.kv_pool.used_blocks, eng.kv_host.ledger.stats()["prefix_entries"])
            out.append(asyncio.run(_first(lp, f_a2)))
        finally:
            lp.stop()
        outs.append(out)
        states.append((demoted, lp.host_prefix_promotes, eng.prefix_cache.stats()))
    assert outs[1] == outs[0]
    (_, _, plain, _) = services("gpt2", **dict(kw, prefix_cache=False, kv_host_budget_mb=0.0))[1]
    assert outs[1] == [_solo(plain, f) for f in (f_a1, f_b1, f_a2)]
    assert states[1] == states[0]
    assert states[1][0] == (2, 1) and states[1][1] == 1
    assert _swap_counts(loop) == _swap_counts(jloop)
    assert engine.kv_host.ledger.stats()["prefix_entries"] >= 1


async def _first(loop, f) -> list[int]:
    return await _collect(loop.submit_stream(dict(f)))


def test_midprefill_checkpoint_resumes_partially_like_jax():
    """Chunked prefill in 8-token windows over 7 blocks, two 30-token
    prompts at once: a window finds the pool dry and a job is checkpointed
    mid-prefill; its consumed windows swap out and come back, and it
    prefills only the windows it never ran: the windows equal the
    uninterrupted count.  Tokens and counts equal the JAX loop's."""
    jloop, jengine, loop, engine = _tier_loops("gpt2", n_blocks=7, prefill_chunk=8)
    batch = [feats(p, request_id=f"m{i}") for i, p in enumerate(
        np.random.default_rng(7).integers(5, 250, (2, 30)).astype(np.int32))]
    partial = []
    to_prefill = loop._swapin_to_prefill

    def on_partial(job):
        partial.append((job.resume_at, job.L))
        return to_prefill(job)

    loop._swapin_to_prefill = on_partial
    want = _run(jloop, batch)
    assert _run(loop, batch) == want == [_solo(engine, f) for f in batch]
    assert loop.swap_outs >= 1 and loop.swap_ins >= 1 and loop.swap_fallbacks == 0
    assert partial and all(0 < at < length and at % 8 == 0 for at, length in partial)
    assert loop.prefill_chunk_dispatches == jloop.prefill_chunk_dispatches == \
        2 * blocks_for(30, 8)
    assert _swap_counts(loop) == _swap_counts(jloop)
    assert loop.prefill_checkpoints >= 1
    _drained(loop, engine)


def test_kv_bytes_for_resume_charges_the_prefetch_like_jax():
    from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdm
    from mlmicroservicetemplate_tpu_torch.scheduler.admission import AdmissionController

    (jcfg, _, jengine), (cfg, _, engine, _) = services(
        "llama", **dict(TIER, prefill_chunk=8, kv_budget_mb=0.5, kv_host_budget_mb=1.0))
    adm, jadm = AdmissionController(cfg, engine), JaxAdm(jcfg, jengine)
    for length, swap in ((14, None), (14, 14), (30, 16), (45, 8), (45, None)):
        f = feats(ids_of(length, 1))
        got = adm.kv_bytes_for_resume(f, swap_tokens=swap)
        assert got == jadm.kv_bytes_for_resume(f, swap_tokens=swap)
        if swap:
            assert got == blocks_for(swap, 8) * engine.kv_pool.block_bytes


# ---------------------------------------------------------------------------
# /status and /metrics


async def _http(app, posts):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        resps = await asyncio.gather(*(client.post("/v1/completions", json=b) for b in posts))
        out = [(r.status, await r.text()) for r in resps]
        status = (await (await client.get("/status")).json()).get("kv_tier")
        metrics = await (await client.get("/metrics")).text()
        return out, status, metrics
    finally:
        await client.close()


def _families(text: str, names: tuple) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in names:
            out[fam.name] = sorted({k for s in fam.samples for k in s.labels})
    return out


def test_status_kv_tier_and_metrics_match_the_jax_app(monkeypatch):
    """Two 14-byte streamed completions at once over the 6-block pool (an
    admission grace long enough that both join one wave in either app):
    the apps' ``/status.kv_tier`` bodies are equal (swap counts, bytes, the
    overlap ratio, the host pool's stats), and the tier's four series carry
    the JAX names and labels."""
    monkeypatch.setenv("ADMIT_GRACE_MS", "300")
    bb = _block_bytes("llama")
    kw = dict(TIER, kv_budget_mb=(6 * bb + bb // 2) / 1e6, kv_host_budget_mb=1.0)
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = services("llama", **kw)
    apps = [jax_build_app(jcfg, jbundle, jengine, JaxBatcher(jengine, jcfg)),
            build_app(cfg, bundle, engine, Batcher(engine, cfg))]
    posts = [{"prompt": text, "max_tokens": 12, "stream": True}
             for text in ("tier swap one.", "tier swap two!")]
    got = [asyncio.run(_http(app, posts)) for app in apps]
    (jout, jstatus, jmetrics), (out, status, metrics) = got
    assert [s for s, _ in out] == [s for s, _ in jout] == [200, 200]
    assert [t for _, t in out] == [t for _, t in jout]
    assert status == jstatus
    assert status["swap_outs"] >= 1 and status["swap_resumes"] >= 1
    assert status["host_pool"]["used_blocks"] == 0 and status["prefetch_blocks"] == 4
    names = ("kv_host_pool_blocks", "kv_swap_bytes", "kv_swap_resumes",
             "kv_host_prefix_hits")
    fams = _families(metrics, names[:3])
    assert fams == _families(jmetrics, names[:3]) and set(fams) == set(names[:3])
    for name in ("KV_HOST_POOL_BLOCKS", "KV_SWAP_BYTES", "KV_SWAP_RESUMES",
                 "KV_HOST_PREFIX_HITS"):
        assert getattr(port_metrics, name)._labelnames == getattr(jax_metrics, name)._labelnames
        assert getattr(port_metrics, name)._name == getattr(jax_metrics, name)._name
    for text in (metrics, jmetrics):
        assert 'kv_swap_bytes_total{dir="out",model="llama"}' in text
        assert 'kv_swap_resumes_total{model="llama",outcome="swapped"}' in text
        assert 'kv_host_pool_blocks{model="llama",state="free"}' in text
