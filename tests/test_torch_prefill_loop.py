"""The port's continuous loop under chunked prefill (``PREFILL_CHUNK``)
against the JAX package's, f32 on the CPU, at small gpt2 and llama
configs on the same weights (2 layers, narrow widths; seq buckets 16/32,
decode 12, chunk 4, 4 slots):

- Loop identity: streams of mixed lengths at once, one past the largest
  bucket (gpt2 and llama, contiguous and paged, dense and int8, greedy and
  seeded sampled): the JAX loop's tokens and window count; paged, both
  pools back to 0.
- A prefix hit's suffix in windows: the contiguous seed and the paged
  adopt, with the JAX loop's tokens and cache counts, and the tokens of a
  service without the cache.

The helpers here serve ``test_torch_prefill_pacer.py`` too.
"""

import asyncio
import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch
from test_torch_gpt import small_gpt2

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdmission
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.serve import build_service

# The services' llama (LLAMA_CONFIG) and the loop's knobs.
SMALL_LLAMA = dict(vocab_size=300, d_model=64, num_heads=4, num_kv_heads=2, num_layers=2,
                   d_ff=128, max_position=96)
LOOP = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=12,
            stream_chunk_tokens=4, max_streams=4, prefill_chunk=4)
PAGED = dict(paged_kv=True, kv_block_size=4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ids_of(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(5, 250, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the continuous loop against the JAX package's


def _env(kw: dict) -> dict:
    return {k.upper(): (",".join(map(str, v)) if isinstance(v, tuple)
                        else ("1" if v else "0") if isinstance(v, bool) else str(v))
            for k, v in kw.items()}


def services(model: str, **kw):
    """The JAX (cfg, bundle, engine) and the port's (cfg, bundle, engine,
    batcher) of ``model`` on the same weights."""
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL_LLAMA)
    try:
        with small_gpt2() if model == "gpt2" else contextlib.nullcontext():
            jcfg = JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                                    batch_timeout_ms=1.0, **kw)
            jbundle = jax_build_model(jcfg)
            jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
            port = build_service({"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0",
                                  "LLAMA_CONFIG": json.dumps(SMALL_LLAMA),
                                  "BATCH_TIMEOUT_MS": "1", **_env(kw)},
                                 params=jax.tree.map(np.asarray, jbundle.params))
    finally:
        del os.environ["LLAMA_CONFIG"]
    return (jcfg, jbundle, jengine), port


def loops(model: str, **kw):
    """(JAX loop, JAX engine, port loop, port engine)."""
    (jcfg, _, jengine), (_, _, engine, batcher) = services(model, **kw)
    jloop = JaxLoop(jengine, jcfg)
    jloop.admission = JaxAdmission(jcfg, jengine)
    return jloop, jengine, batcher._cdl, engine


def feats(ids: np.ndarray, **extra) -> dict:
    return {"input_ids": np.asarray(ids, np.int32), "length": np.int32(len(ids)), **extra}


async def collect(gen) -> list[int]:
    return [int(t) async for chunk in gen for t in np.asarray(chunk).tolist()]


async def run_burst(loop, feats_list) -> list[list[int]]:
    return list(await asyncio.gather(*(collect(loop.submit_stream(dict(f)))
                                       for f in feats_list)))


async def run_seq(loop, feats_list) -> list[list[int]]:
    return [await collect(loop.submit_stream(dict(f))) for f in feats_list]


def settle(loop, timeout: float = 10.0) -> None:
    t_end = time.monotonic() + timeout
    while loop._admitted and time.monotonic() < t_end:
        time.sleep(0.01)
    assert loop._admitted == 0


# A 3-token prompt keeps the wave (one window or less); 19 and 30 chunk; 45
# is past the largest seq bucket (32).
LENGTHS = (3, 19, 30, 45)


@pytest.mark.parametrize("model,extra,sampled", [
    ("gpt2", {}, False), ("gpt2", PAGED, False), ("llama", dict(quant_kv="int8"), False),
    ("llama", dict(PAGED, quant_kv="int8"), False), ("llama", PAGED, True), ("gpt2", {}, True),
], ids=["gpt2", "gpt2-paged", "llama-int8", "llama-paged-int8", "llama-paged-sampled",
        "gpt2-sampled"])
def test_loop_tokens_match_jax(model, extra, sampled):
    """Streams of mixed lengths at once, one past the largest bucket: the
    port's loop gives the JAX loop's tokens and windows; paged, both pools
    drain to 0."""
    jloop, jengine, loop, engine = loops(model, **LOOP, **extra)
    sample = [dict(temperature=0.8, top_k=30, seed=11 + i) if sampled and i % 2 else {}
              for i in range(len(LENGTHS))]
    batch = [feats(ids_of(n, 20 + n), **s) for n, s in zip(LENGTHS, sample)]
    outs = []
    for lp in (jloop, loop):
        try:
            outs.append(asyncio.run(run_burst(lp, batch)))
        finally:
            lp.stop()
    assert outs[1] == outs[0]
    assert all(len(t) > 0 for t in outs[1])
    assert loop.prefill_chunk_dispatches == jloop.prefill_chunk_dispatches == sum(
        -(-n // 4) for n in LENGTHS if n > 4)
    assert loop.max_prompt == jloop.max_prompt > 32
    settle(loop)
    if engine.paged_kv:
        assert engine.kv_pool.used_blocks == 0 and jengine.kv_pool.used_blocks == 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_prefix_hit_prefills_its_suffix_in_windows_like_jax(paged):
    """A donor of 25 tokens (chunked; it donates the 16 bucket), then a
    34-token prompt on the same 20-token start: a hit whose suffix goes
    through windows, seeded into the job's state (contiguous) or behind the
    donor's adopted blocks (paged).  Tokens, windows and cache counts equal
    the JAX loop's, and the tokens a service without the cache gives."""
    kw = dict(LOOP, prefix_cache=True, **(PAGED if paged else {}))
    jloop, jengine, loop, engine = loops("llama", **kw)
    shared = ids_of(20, 3)
    donor = feats(np.concatenate([shared, ids_of(5, 4)]))
    hit = feats(np.concatenate([shared, ids_of(14, 5)]))
    outs, stats = [], []
    for lp, eng in ((jloop, jengine), (loop, engine)):
        try:
            outs.append(asyncio.run(run_seq(lp, [donor, hit])))
        finally:
            lp.stop()
        stats.append((eng.prefix_cache.stats(), lp.prefill_chunk_dispatches))
    assert outs[1] == outs[0]
    assert stats[1] == stats[0]
    assert stats[1][0]["hits"] == 1
    # The hit prefilled only its suffix: 34 - 16 tokens in windows of 4.
    assert stats[1][1] == -(-25 // 4) + -(-(34 - 16) // 4)
    (_, _, plain, _) = services("llama", **dict(LOOP, prefix_cache=False))[1]
    want = [[int(t) for c in plain.generate_stream(dict(f)) for t in c] for f in (donor, hit)]
    assert outs[1] == want
    settle(loop)
    if paged:
        pins = {b for e in engine.prefix_cache._entries.values() for b in e.block_ids}
        assert engine.kv_pool.used_blocks == len(pins) > 0
        engine.prefix_cache.flush()
        assert engine.kv_pool.used_blocks == 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_windows_through_graphs_give_jax_tokens(paged):
    """The graph path under the stand-in capturer of
    ``test_torch_graphs.py`` (a replay calls the captured function again):
    the window's graph is captured once, with the loop's chunk, while every
    slot is dead; each window replays it (contiguous: the job's state copied
    into the graph's detached state and back), and the tokens are the JAX
    loop's."""
    from test_torch_graphs import _with_graphs

    jloop, _, loop, engine = loops("llama", **LOOP, **(PAGED if paged else {}))
    cache = _with_graphs(engine)
    batch = [feats(ids_of(n, 40 + n)) for n in (3, 19, 45)]
    outs = []
    kind = "prefill_window_paged" if paged else "prefill_window"
    loop.warm()
    assert [e.kind for e in cache.entries()].count(kind) == 1
    captured = cache.stats()["insert"]
    for lp in (jloop, loop):
        try:
            outs.append(asyncio.run(run_burst(lp, batch)))
        finally:
            lp.stop()
    assert outs[1] == outs[0]
    windows = [e for e in cache.entries() if e.kind == kind]
    assert len(windows) == 1 and cache.stats()["insert"] - captured == 1  # the short prompt's start
    assert windows[0].replays == loop.prefill_chunk_dispatches == -(-19 // 4) + -(-45 // 4)
