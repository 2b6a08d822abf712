"""The continuous loop's dispatch pipeline of the port against the JAX
package's ``ContinuousDecodeLoop``, f32 on the CPU, at the small gpt2,
llama and T5 configs of the preemption tests (the same weights, carried
across), the counterparts of the JAX tests of ``STREAM_PIPELINE`` and
``HOST_PREP_DOUBLE`` (``tests/test_streams.py``,
``tests/test_compile_cache.py``).  Tolerances: tokens, counts, step cursors
and block ledgers exact.

- Depth 3 with a late admission: gpt2, llama and llama int8, contiguous
  and paged, greedy and seeded sampled, and T5 contiguous; the JAX loop's
  tokens at the same depth; never more than three dispatches in flight.
  On the CPU a host copy has landed once it exists, so the paged loop
  routes every dispatch at the next iteration top (``_deliver_ready``).
- Depth 3 composed with a preemption, a dry-pool stall, a prefix hit, a
  chunked prefill and a host-tier swap-resume: the JAX loop's tokens.
- ``depth_from`` and ``_apply_tuned_depth`` against JAX's on the same
  numbers; ``warm()`` tunes under ``STREAM_PIPELINE=0`` only and cuts the
  admission grace to a tenth of the measured round trip.
- ``STREAM_PIPELINE``, ``HOST_PREP_DOUBLE`` and ``ADMIT_OVERLAP`` parse
  as the JAX package parses them.

The staged host prep, ``ADMIT_OVERLAP=0`` and the ready delivery are in
``tests/test_torch_pipeline_prep.py`` (a file of its own, so the two halves
run on two workers)."""

import asyncio
import types

import numpy as np
import pytest
import torch
from test_torch_decode_window import SEED_KW
from test_torch_kv_tier import _drained, _tier_loops
from test_torch_kv_tier import _run as _run_tier
from test_torch_preempt import (
    ONE_SLOT,
    _collect,
    _hold_first_chunk,
    _loops,
    _preempted,
    _prompt,
    _settle,
    _solo,
)

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.utils import metrics as jax_metrics
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu.utils.config import load_config as jax_load_config
from mlmicroservicetemplate_tpu_torch.engine.streams import ContinuousDecodeLoop
from mlmicroservicetemplate_tpu_torch.utils import config as port_config
from mlmicroservicetemplate_tpu_torch.utils import metrics as port_metrics
from mlmicroservicetemplate_tpu_torch.utils.config import load_config

SERVE = dict(batch_buckets=(1, 2, 4), seq_buckets=(16, 32), max_decode_len=24,
             stream_chunk_tokens=4, max_streams=4)
PAGED = dict(paged_kv=True, kv_block_size=8)
FAMILIES = {"gpt2": ("gpt2", {}), "llama": ("llama", {}),
            "llama-int8": ("llama", {"quant_kv": "int8"})}
# Budgets that end the streams at different chunk boundaries.
LENGTHS, BUDGETS = (7, 13, 20, 9), (24, 10, 17, 24)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _streams(sampled: bool, seed: int = 0) -> list[dict]:
    out = []
    for i, (n, budget) in enumerate(zip(LENGTHS, BUDGETS)):
        extra = dict(SEED_KW, seed=SEED_KW["seed"] + i) if sampled and i % 2 == 0 else {}
        out.append(_prompt(n, seed + i, max_tokens=budget, **extra))
    return out


def _in_flight(loop) -> list[int]:
    """Dispatches in flight at each chunk dispatch, before it goes out."""
    seen = []
    orig = loop._dispatch_chunk
    inflight = "_inflight" if hasattr(loop, "_inflight") else "_inflight_chunks"

    def spy():
        seen.append(len(getattr(loop, inflight)))
        return orig()

    loop._dispatch_chunk = spy
    return seen


def _late(loop, feats: list[dict], n_first: int = 2) -> list[list[int]]:
    """The first ``n_first`` streams at once; the rest once the loop has a
    chunk in flight (a late admission); every stream read to its end, then
    the loop released and drained and stopped."""
    async def body():
        tasks = [asyncio.ensure_future(_collect(loop.submit_stream(dict(f))))
                 for f in feats[:n_first]]
        for _ in range(1000):
            if loop.chunk_dispatches:
                break
            await asyncio.sleep(0.002)
        tasks += [asyncio.ensure_future(_collect(loop.submit_stream(dict(f))))
                  for f in feats[n_first:]]
        out = list(await asyncio.gather(*tasks))
        for _ in range(500):
            if not loop._admitted:
                break
            await asyncio.sleep(0.01)
        return out

    try:
        return asyncio.run(body())
    finally:
        loop.stop()


# ---------------------------------------------------------------------------
# 1. depth D


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_depth_3_with_a_late_admission_matches_jax(family, layout, mode):
    model, extra = FAMILIES[family]
    paged = layout == "paged"
    jloop, jengine, loop, engine = _loops(model, stream_pipeline=3, **SERVE, **extra,
                                          **(PAGED if paged else {}))
    assert loop.chain_depth == jloop.chain_depth == 3
    assert not loop._auto_depth and not jloop._auto_depth
    feats = _streams(mode == "sampled")
    jseen, seen = _in_flight(jloop), _in_flight(loop)
    want = _late(jloop, feats)
    got = _late(loop, feats)
    assert got == want
    assert all(0 < len(t) <= b for t, b in zip(got, BUDGETS))  # an eos may end one early
    assert max(jseen) <= 3
    # Contiguous, the chain fills to its depth; paged on the CPU, every
    # dispatch is routed at the next iteration top.
    assert max(seen) == (0 if paged else 3)
    _settle(loop, engine)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_depth_3_t5_contiguous_matches_jax(mode):
    jloop, jengine, loop, engine = _loops("t5-small", stream_pipeline=3, **SERVE)
    assert loop.chain_depth == jloop.chain_depth == 3
    feats = _streams(mode == "sampled")
    seen = _in_flight(loop)
    want = _late(jloop, feats)
    assert _late(loop, feats) == want
    assert max(seen) == 3
    _settle(loop, engine)


def _preemption():
    kw = dict(ONE_SLOT, stream_pipeline=3, **PAGED)
    jloop, jengine, loop, engine = _loops("llama", **kw)
    batch = _prompt(20, priority="batch")
    inter = _prompt(9, priority="interactive")
    outs = []
    for lp in (jloop, loop):
        _hold_first_chunk(lp)
        try:
            outs.append(list(asyncio.run(_preempted(lp, dict(batch), dict(inter)))))
        finally:
            lp.stop()
        assert lp.preemptions >= 1
    assert outs[1] == outs[0] == [_solo(engine, batch), _solo(engine, inter)]
    assert loop.recasts >= 1
    return loop, engine


def _dry_pool():
    bb = 2 * 2 * 4 * 32 * 4 * 8  # a small GPT-2's f32 block of 8 tokens
    kw = dict(batch_buckets=(1, 2), seq_buckets=(16, 32), max_decode_len=10,
              stream_chunk_tokens=4, max_streams=2, max_stream_queue=4, kv_budget_mb=6 * bb / 1e6,
              stream_pipeline=3, **PAGED)
    jloop, jengine, loop, engine = _loops("gpt2", **kw)
    prompts = [_prompt(14, ids_seed) for ids_seed in (1, 2)]
    want = _late(jloop, prompts)
    assert _late(loop, prompts) == want == [_solo(engine, f) for f in prompts]
    assert loop.kv_growth_stalls >= 1
    return loop, engine


def _prefix_hit():
    jloop, jengine, loop, engine = _loops("llama", prefix_cache=True, stream_pipeline=3,
                                          **SERVE, **PAGED)
    donor = _prompt(20, 3)
    hit = dict(_prompt(22, 5), input_ids=np.concatenate(
        [donor["input_ids"][:16], _prompt(6, 9)["input_ids"]]))
    async def one_by_one(lp):
        return [await _collect(lp.submit_stream(dict(f))) for f in (donor, hit)]

    outs = []
    for lp in (jloop, loop):
        try:
            outs.append(asyncio.run(one_by_one(lp)))
        finally:
            lp.stop()
    assert outs[1] == outs[0]
    assert engine.prefix_cache.stats()["hits"] == jengine.prefix_cache.stats()["hits"] >= 1
    return loop, engine


def _chunked():
    jloop, jengine, loop, engine = _loops("llama", prefill_chunk=8, stream_pipeline=3,
                                          **SERVE, **PAGED)
    feats = [_prompt(n, 11) for n in (6, 30, 9, 27)]
    want = _late(jloop, feats)
    assert _late(loop, feats) == want
    assert loop.prefill_chunk_dispatches == jloop.prefill_chunk_dispatches > 0
    return loop, engine


def _swap():
    jloop, jengine, loop, engine = _tier_loops("gpt2", stream_pipeline=3)
    batch = [_prompt(14, 3 + i) for i in range(2)]
    want = _run_tier(jloop, batch)
    assert _run_tier(loop, batch) == want == [_solo(engine, f) for f in batch]
    assert loop.swap_outs >= 1 and loop.swap_ins == loop.swap_outs and loop.swap_fallbacks == 0
    _drained(jloop, jengine)
    return loop, engine


@pytest.mark.parametrize("case", ["preemption", "dry-pool", "prefix-hit", "chunked", "swap"])
def test_depth_3_composes_like_jax(case):
    """Depth 3 under each checkpoint and admission path: the JAX loop's
    tokens at the same depth, the pool drained."""
    loop, engine = {"preemption": _preemption, "dry-pool": _dry_pool,
                    "prefix-hit": _prefix_hit, "chunked": _chunked, "swap": _swap}[case]()
    assert loop.chain_depth == 3
    if case == "swap":
        _drained(loop, engine)
        return
    if case == "prefix-hit":
        engine.prefix_cache.flush()  # the pins hold blocks
    _settle(loop, engine)


# ---------------------------------------------------------------------------
# 2. the auto-tuned depth and admission grace


@pytest.fixture(scope="module")
def pair():
    """A JAX loop and a port loop of the small gpt2, never started."""
    jloop, _, loop, _ = _loops("gpt2", **SERVE)
    return jloop, loop


def test_depth_from_matches_jax():
    grid = [0.0, 1e-5, 5e-5, 1e-4, 2.4e-4, 2.5e-4, 1e-3, 3.5e-3, 0.0125, 0.115, 2.0]
    for rtt in grid:
        for compute in grid:
            assert ContinuousDecodeLoop.depth_from(rtt, compute) == JaxLoop.depth_from(
                rtt, compute), (rtt, compute)


@pytest.mark.parametrize("rtt,compute", [(0.115, 0.012), (3e-5, 3.5e-3), (0.0, 1e-4),
                                         (0.05, 0.001), (0.0004, 0.0004)])
def test_apply_tuned_depth_matches_jax(pair, rtt, compute):
    """The same numbers give both loops the same depth, grace and gauge."""
    jloop, loop = pair
    loop.admit_grace_s = jloop._admit_grace_s = 0.008
    jloop._apply_tuned_depth(rtt, compute)
    jgauge = jax_metrics.CHAIN_DEPTH.labels(jloop.engine.bundle.name)._value.get()
    loop._apply_tuned_depth(rtt, compute)
    gauge = port_metrics.CHAIN_DEPTH.labels(loop.model)._value.get()
    assert loop.chain_depth == jloop.chain_depth == gauge == jgauge
    assert loop.admit_grace_s == jloop._admit_grace_s == min(0.008, rtt / 10.0)
    assert loop.tuned == (rtt, compute)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("pipeline", [0, 2])
def test_warm_tunes_only_the_auto_depth(layout, pipeline, monkeypatch):
    """STREAM_PIPELINE=0: warm() measures (the paged loop over its table)
    and the grace drops to min(ADMIT_GRACE_MS, RTT / 10); a fixed depth
    tunes nothing and keeps the configured grace.  Either way every slot
    is dead again after warm(), and the gauge reads the depth."""
    monkeypatch.setenv("ADMIT_GRACE_MS", "8")
    kw = dict(SERVE, stream_pipeline=pipeline, **(PAGED if layout == "paged" else {}))
    _, _, loop, _ = _loops("gpt2", **kw)
    tuners = []
    for name in ("_tune_chain_depth", "_tune_chain_depth_paged"):
        orig = getattr(loop, name)

        def spy(orig=orig, name=name):
            tuners.append(name)
            return orig()

        setattr(loop, name, spy)
    assert loop.chain_depth == max(1, pipeline) and loop.admit_grace_s == 0.008
    loop.warm()
    if pipeline:
        assert tuners == [] and loop.tuned is None
        assert loop.chain_depth == 2 and loop.admit_grace_s == 0.008
    else:
        want = (["_tune_chain_depth_paged", "_tune_chain_depth"] if layout == "paged"
                else ["_tune_chain_depth"])
        assert tuners == want
        rtt, compute = loop.tuned
        assert compute >= 1e-4 and rtt >= 0.0
        assert loop.chain_depth == JaxLoop.depth_from(rtt, compute)
        assert loop.admit_grace_s == min(0.008, rtt / 10.0) < 0.008 or rtt >= 0.08
    assert port_metrics.CHAIN_DEPTH.labels(loop.model)._value.get() == loop.chain_depth
    state = loop._state
    assert bool(state.done.all()) and int(state.pos.abs().sum()) == 0


# ---------------------------------------------------------------------------
# 3. the knobs


@pytest.mark.parametrize("env", [{}, {"STREAM_PIPELINE": "0"}, {"STREAM_PIPELINE": "3"},
                                 {"HOST_PREP_DOUBLE": "0"}, {"HOST_PREP_DOUBLE": "no"},
                                 {"HOST_PREP_DOUBLE": "True"}, {"STREAM_PIPELINE": "8",
                                                                "HOST_PREP_DOUBLE": "false"}])
def test_pipeline_knobs_parse_like_jax(env):
    port, ref = load_config({"DEVICE": "cpu", **env}), jax_load_config({"DEVICE": "cpu", **env})
    assert (port.stream_pipeline, port.host_prep_double) == (ref.stream_pipeline,
                                                             ref.host_prep_double)
    for name in ("STREAM_PIPELINE", "HOST_PREP_DOUBLE", "ADMIT_OVERLAP"):
        assert name not in port_config.UNPORTED_KNOBS and name not in port_config.INERT_KNOBS


def test_negative_stream_pipeline_is_refused_with_the_jax_message():
    with pytest.raises(ValueError) as want:
        jax_load_config({"DEVICE": "cpu", "STREAM_PIPELINE": "-1"})
    with pytest.raises(ValueError) as got:
        load_config({"DEVICE": "cpu", "STREAM_PIPELINE": "-1"})
    assert str(got.value) in str(want.value) and "STREAM_PIPELINE" in str(got.value)


@pytest.mark.parametrize("value", ["0", "false", "No", "1", "yes", "true", "anything"])
def test_admit_overlap_reads_as_the_jax_loop_reads_it(value, monkeypatch, pair):
    """The JAX loop reads ADMIT_OVERLAP from the environment when it is
    built; the port's config reads it under the same off values."""
    jloop, _ = pair
    monkeypatch.setenv("ADMIT_OVERLAP", value)
    want = JaxLoop(jloop.engine, JaxServiceConfig(device="cpu", warmup=False,
                                                  **SERVE)).overlap_admission
    cfg = load_config({"DEVICE": "cpu"})
    assert cfg.admit_overlap is want
    assert _bare_loop(cfg).overlap_admission is want


def _bare_loop(cfg) -> ContinuousDecodeLoop:
    return ContinuousDecodeLoop(types.SimpleNamespace(
        bundle=types.SimpleNamespace(name="m"), seq_buckets=(16,), chunk_tokens=4,
        paged_kv=False), cfg)


def test_the_loop_reads_the_three_knobs():
    cfg = load_config({"DEVICE": "cpu", "STREAM_PIPELINE": "4", "HOST_PREP_DOUBLE": "0",
                       "ADMIT_OVERLAP": "0"})
    loop = _bare_loop(cfg)
    assert (loop.chain_depth, loop._auto_depth, loop.host_prep_double,
            loop.overlap_admission) == (4, False, False, False)
    loop = _bare_loop(load_config({"DEVICE": "cpu"}))
    assert (loop.chain_depth, loop._auto_depth, loop.host_prep_double,
            loop.overlap_admission) == (1, True, True, True)
