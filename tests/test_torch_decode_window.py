"""Fused decode windows (``DECODE_WINDOW``, ``DECODE_WINDOW_AUTO``) of the
port against the JAX package, f32 on the CPU, at the JAX tests' tiny gpt
and llama configs (``tests/helpers.py``: the same weights, carried across
by ``gpt_params_from_jax`` / ``llama_params_from_jax``), the counterparts
of ``tests/test_decode_window.py``.  Tolerances: tokens, done histories,
chunk counts and block ids exact; no logit is compared here (the model
tests hold logits within 1e-4).

- ``models/window.decode_window``: the chunks run, the history and the
  tokens equal JAX's ``decode_window`` on one stub schedule each (an early
  exit, zero chunks when every row is done at entry, none, the cap).
- ``decode_window`` over ``generate_chunk(_paged)`` (what the loop runs
  on the CPU; on the card the chunk's graph) of gpt, llama and
  llama-int8, greedy and seeded sampled, with an ``eos_id`` that ends the
  window early: tokens, history and ``n_chunks`` equal JAX's
  ``generate_window(_paged)``, and the per-chunk path's.
- The loop at ``DECODE_WINDOW=4``, AUTO off: tokens equal the JAX loop's
  and the port's at W = 1, the window counts equal JAX's, the paged pool
  drains; a budget that is no multiple of the window; a slot's next
  tenants after early-exited windows; an EOS row's blocks freed while
  another decodes; the block ledger at every boundary; preemption, a dry
  pool and the host tier's swap-out with windows in flight; chunked
  prefill's windows a boundary.
- ``StreamBlocks.trim``, ``DecodeWindowGovernor``, the two metrics and
  the refusals (T5, a depth outside [1, 64]) against JAX's."""

import asyncio
import dataclasses
import functools
import itertools
import json
import os
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch
from helpers import TINY_GPT, TINY_LLAMA, tiny_gpt_bundle, tiny_llama_bundle, tiny_t5_bundle
from test_torch_graphs import LLAMA, SMALL, _with_graphs
from test_torch_kv_tier import _drained, _prompts, _solo, _tier_loops
from test_torch_preempt import (
    _collect,
    _hold_first_chunk,
    _loops,
    _paged_gpt2,
    _preempted,
    _prompt,
    _together,
)
from test_torch_t5_serving import small_t5

import jax
import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.kv_blocks import BlockPool as JaxBlockPool
from mlmicroservicetemplate_tpu.engine.kv_blocks import StreamBlocks as JaxStreamBlocks
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu.models import sampling as jax_sampling
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.models.window import decode_window as jax_decode_window
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler.policy import DecodeWindowGovernor as JaxGovernor
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu.utils import metrics as jax_metrics
from mlmicroservicetemplate_tpu.utils.config import load_config as jax_load_config
from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
    gpt_params_from_jax,
    llama_params_from_jax,
    paged_state_from_jax,
)
from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import BlockPool, StreamBlocks
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models.gpt import clone_state
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.models import sampling as port_sampling
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.models.window import decode_window
from mlmicroservicetemplate_tpu_torch.scheduler.policy import DecodeWindowGovernor
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils import metrics as port_metrics
from mlmicroservicetemplate_tpu_torch.utils.config import load_config

# The JAX decode-window tests' serving shape.
SERVE = dict(batch_buckets=(1, 2, 4), seq_buckets=(16, 32), max_decode_len=24,
             stream_chunk_tokens=4, max_streams=4)
CHUNK, W = 4, 4
# ADMIT_GRACE_MS long enough that a wave's streams, submitted at once,
# land in one admission wave however loaded the machine: the tests that
# compare window counts with the JAX loop's need the same waves on both
# sides.
GRACE_MS = "250"
SEED_KW = dict(temperature=0.9, top_k=20, seed=4321)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 1. decode_window


@dataclasses.dataclass
class _Stub:
    counter: torch.Tensor  # [] chunks run
    done: torch.Tensor  # [B]


def _schedules():
    """(done_at per row, depth, done at entry): the chunk after which each
    row goes done."""
    return [([2, 3], 8, False), ([1, 1], 8, True), ([9, 9], 4, False), ([1, 4], 4, False),
            ([1, 2], 1, False)]


@pytest.mark.parametrize("done_at,depth,at_entry", _schedules(),
                         ids=["early-exit", "zero-chunks", "never-done", "at-cap", "depth-1"])
def test_decode_window_matches_jax(done_at, depth, at_entry):
    """Tokens encode (chunk, step, row), so a routing or ordering error
    shows in the values: chunks run, tokens and history equal JAX's."""
    class JState(NamedTuple):
        counter: jax.Array
        done: jax.Array

    n_steps, b = 4, len(done_at)

    def jax_chunk(s):
        i = s.counter
        toks = ((i + 1) * 100 + jnp.arange(n_steps)[None, :]
                + 10_000 * jnp.arange(b)[:, None]).astype(jnp.int32)
        return JState(i + 1, (i + 1) >= jnp.asarray(done_at)), toks

    def port_chunk(s):
        i = s.counter
        toks = ((i + 1) * 100 + torch.arange(n_steps)[None, :]
                + 10_000 * torch.arange(b)[:, None]).to(torch.int32)
        return _Stub(i + 1, (i + 1) >= torch.tensor(done_at)), toks

    _, jt, jh, jn = jax_decode_window(
        jax_chunk, JState(jnp.int32(0), jnp.full(b, at_entry)), n_steps, depth, -1)
    _, pt, ph, pn = decode_window(
        port_chunk, _Stub(torch.tensor(0), torch.full((b,), at_entry)), n_steps, depth, -1)
    assert int(pn) == int(jn)
    assert pn.dtype == torch.int32 and pt.dtype == torch.int32 and ph.dtype == torch.bool
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    if at_entry:
        assert int(pn) == 0 and (pt == -1).all()


# ---------------------------------------------------------------------------
# 2. model-level windows


def _family(name: str, eos: int):
    """(JAX module, port module, JAX cfg, JAX params, port model) at the
    tiny config with ``eos_id`` = ``eos``."""
    if name == "gpt":
        jcfg = jax_gpt.GPTConfig(**{**TINY_GPT, "eos_id": eos})
        params = jax_gpt.init_params(jax.random.PRNGKey(0), jcfg)
        pcfg = port_gpt.GPTConfig(**{**TINY_GPT, "eos_id": eos})
        sd = gpt_params_from_jax(jax.tree.map(np.asarray, params), pcfg)
        return jax_gpt, port_gpt, jcfg, params, port_gpt.build_model(
            pcfg, sd, torch.device("cpu"), torch.float32)
    quant = name == "llama-int8"
    jcfg = jax_llama.LlamaConfig(**{**TINY_LLAMA, "eos_id": eos, "kv_quant": quant})
    params = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    pcfg = port_llama.LlamaConfig(**{**TINY_LLAMA, "eos_id": eos, "kv_quant": quant})
    sd = llama_params_from_jax(jax.tree.map(np.asarray, params), pcfg)
    return jax_llama, port_llama, jcfg, params, port_llama.build_model(
        pcfg, sd, torch.device("cpu"), torch.float32)


def _init(name, eos, paged, sampled):
    """JAX and port decode states of one 11-token prompt (paged: over a
    shuffled table with room for the whole window)."""
    jmod, pmod, jcfg, params, model = _family(name, eos)
    ids = np.random.default_rng(0).integers(5, 250, (1, 11)).astype(np.int32)
    mask = np.ones_like(ids)
    args = ([7], [SEED_KW["temperature"] if sampled else 0.0],
            [SEED_KW["top_k"] if sampled else 0], [1.0])
    jsp, psp = jax_sampling.make_params(*args), port_sampling.make_params(*args)
    max_len = CHUNK * W
    if not paged:
        jst = jmod.init_decode_state(params, jcfg, jnp.asarray(ids), jnp.asarray(mask), max_len,
                                     sample=jsp)
        with torch.inference_mode():
            pst = pmod.init_decode_state(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                         max_len, sample=psp)
        return jmod, pmod, jcfg, params, model, jst, pst, None
    bs = 4
    nb = -(-(ids.shape[1] + max_len) // bs)
    table = np.random.RandomState(2).permutation(nb).reshape(1, nb).astype(np.int32)
    jst = jmod.init_paged_state(params, jcfg, jnp.asarray(ids), jnp.asarray(mask), max_len,
                                jnp.asarray(table), nb, bs, sample=jsp)
    pst = paged_state_from_jax(jax.tree.map(np.asarray, jst))
    return jmod, pmod, jcfg, params, model, jst, pst, table


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", ["gpt", "llama", "llama-int8"])
def test_model_window_matches_jax(name, paged, mode):
    sampled = mode == "sampled"
    # The eos: the token the prompt's own run emits at step 5 (-1: none).
    jmod, _, jcfg, params, _, jst, _, table = _init(name, -1, paged, sampled)
    if paged:
        _, toks = jmod.generate_chunk_paged(params, jcfg, jst, jnp.asarray(table), CHUNK * W,
                                            sampled)
    else:
        _, toks = jmod.generate_chunk(params, jcfg, jst, CHUNK * W, sampled)
    eos = int(np.asarray(toks)[0, 5])
    jmod, pmod, jcfg, params, model, jst, pst, table = _init(name, eos, paged, sampled)
    with torch.inference_mode():
        chunks, dones = [], []
        if paged:
            t = torch.from_numpy(table)
            _, jt, jh, jn = jmod.generate_window_paged(params, jcfg, jst, jnp.asarray(table),
                                                       CHUNK, W, sampled)
            ref = paged_state_from_jax(jax.tree.map(np.asarray, jst))
            for _ in range(W):
                ref, c = pmod.generate_chunk_paged(model, ref, t, 4, CHUNK, sampled)
                chunks.append(c.numpy())
                dones.append(ref.done.numpy().copy())
            _, pt, ph, pn = decode_window(
                lambda s: pmod.generate_chunk_paged(model, s, t, 4, CHUNK, sampled),
                pst, CHUNK, W, model.cfg.pad_id)
        else:
            _, jt, jh, jn = jmod.generate_window(params, jcfg, jst, CHUNK, W, sampled)
            ref = clone_state(pst)
            for _ in range(W):
                ref, c = pmod.generate_chunk(model, ref, CHUNK, sampled)
                chunks.append(c.numpy())
                dones.append(ref.done.numpy().copy())
            _, pt, ph, pn = decode_window(
                lambda s: pmod.generate_chunk(model, s, CHUNK, sampled),
                pst, CHUNK, W, model.cfg.pad_id)
    n = int(pn)
    assert n == int(jn) and 0 < n < W  # the eos ends the window early
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    # The window's first n chunks are the per-chunk path's.
    np.testing.assert_array_equal(pt.numpy()[:, : n * CHUNK],
                                  np.concatenate(chunks, axis=1)[:, : n * CHUNK])
    np.testing.assert_array_equal(ph.numpy()[:n], np.stack(dones)[:n])


def test_paged_window_writes_only_its_blocks_or_scratch():
    """The chunks a window runs past ``n_chunks`` write K/V for its done
    rows through their table (``paged_dest``): into the blocks granted to
    the row or the scratch block, never into another block, and never
    below the row's prompt (where an adopted prefix lives)."""
    ids = np.random.default_rng(0).integers(5, 250, (1, 11)).astype(np.int32)
    bs, nb = 4, 12
    # 5 granted blocks (20 positions: the prompt and 9 steps), then
    # sentinels: the window's 16 steps run past them.
    table = np.full((1, 7), nb, np.int32)
    table[0, :5] = [9, 2, 7, 4, 0]

    def state(eos):
        jmod, pmod, jcfg, params, model = _family("gpt", eos)
        return jmod, pmod, jcfg, params, model, jmod.init_paged_state(
            params, jcfg, jnp.asarray(ids), jnp.asarray(np.ones_like(ids)), CHUNK * W,
            jnp.asarray(table), nb, bs)

    jmod, _, jcfg, params, _, jst = state(-1)
    _, toks = jmod.generate_chunk_paged(params, jcfg, jst, jnp.asarray(table), 8)
    _, pmod, _, _, model, jst = state(int(np.asarray(toks)[0, 5]))  # ends the window early
    pst = paged_state_from_jax(jax.tree.map(np.asarray, jst))
    before = [c.clone() for c in pst.cache_k + pst.cache_v]
    with torch.inference_mode():
        t = torch.from_numpy(table)
        _, _, _, n = decode_window(lambda s: pmod.generate_chunk_paged(model, s, t, bs, CHUNK),
                                   pst, CHUNK, W, model.cfg.pad_id)
    assert 0 < int(n) < W
    granted = set(table[0, :5].tolist())
    prefix = set(table[0, :2].tolist())  # positions 0-7: below the prompt's last token
    for old, new in zip(before, pst.cache_k + pst.cache_v):
        changed = {b for b in range(nb + 1) if not torch.equal(old[b], new[b])}
        assert changed <= granted | {nb} and not changed & prefix, changed
        assert nb in changed  # the steps past the table went to the scratch block


# ---------------------------------------------------------------------------
# 3. the loop, against the JAX loop on the JAX tests' tiny bundles


def _jcfg(**kw) -> JaxServiceConfig:
    return JaxServiceConfig(**{"device": "cpu", "warmup": False, **SERVE, **kw})


def _pair(family: str, quant: bool = False, eos: int | None = None, **kw):
    """The JAX (engine, cfg) over the tiny ``family`` bundle and the port's
    (engine, batcher) on its weights, both at ``kw`` (JAX ServiceConfig
    names) and, with ``eos``, that ``eos_id`` (the port's configs rigged
    after the build: its registry takes eos and pad from its tokenizer)."""
    over = {} if eos is None else {"eos_id": eos}
    jbundle = (tiny_gpt_bundle(**over) if family == "gpt"
               else tiny_llama_bundle(kv_quant=quant, **over))
    if quant:
        kw["quant_kv"] = "int8"
    jcfg = _jcfg(**kw)
    jengine = JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))
    env = {k.upper(): (",".join(map(str, v)) if isinstance(v, tuple)
                       else ("1" if v else "0") if isinstance(v, bool) else str(v))
           for k, v in {**SERVE, **kw}.items()}
    env.update(MODEL_NAME="gpt2" if family == "gpt" else "llama", DEVICE="cpu", WARMUP="0")
    dims = {k: v for k, v in (TINY_GPT if family == "gpt" else TINY_LLAMA).items()
            if k not in ("eos_id", "pad_id")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_gpt, "GPTConfig", functools.partial(port_gpt.GPTConfig, **dims))
        if family != "gpt":
            env["LLAMA_CONFIG"] = json.dumps(dims)
        _, bundle, engine, batcher = build_service(env, params=jax.tree.map(np.asarray,
                                                                             jbundle.params))
    bundle.cfg = dataclasses.replace(bundle.cfg, eos_id=jbundle.cfg.eos_id,
                                     pad_id=jbundle.cfg.pad_id)
    bundle.model.cfg = bundle.cfg
    return jengine, jcfg, engine, batcher


def _feats(lengths, rng_seed: int = 0, **extra):
    rng = np.random.default_rng(rng_seed)
    out = []
    for n in lengths:
        p = rng.integers(5, 250, n).astype(np.int32)
        out.append({"input_ids": p, "length": np.int32(n), **extra})
    return out


async def _streams(loop, feats):
    return list(await asyncio.gather(*(_collect(loop.submit_stream(dict(f))) for f in feats)))


def _run(loop, waves):
    """Each wave's streams at once, the next wave once every stream of the
    last one is released; the loop stopped after."""
    async def body():
        out = []
        for wave in waves:
            out.append(await _streams(loop, wave))
            for _ in range(500):  # released, and the window in flight routed
                if loop._admitted == 0 and not getattr(
                        loop, "_inflight", getattr(loop, "_inflight_chunks", None)):
                    break
                await asyncio.sleep(0.01)
        return out

    try:
        return asyncio.run(body())
    finally:
        loop.stop()


COUNTS = ("window_dispatches", "window_chunks", "window_early_exits")


def _counts(loop) -> dict:
    return {k: getattr(loop, k) for k in COUNTS}


def _same_counts(loop, jloop, paged: bool) -> None:
    """The window counts equal the JAX loop's.  Paged, only where no
    window ended early: there the JAX loop routes a window before the next
    dispatch when XLA has its result already (``_deliver_ready``, a race
    on the CPU), which the port does not do, so after an early exit the
    JAX loop may or may not dispatch one window fewer."""
    if not paged or not jloop.window_early_exits:
        assert _counts(loop) == _counts(jloop)


def _wait(cond, timeout: float = 5.0) -> bool:
    t_end = time.monotonic() + timeout
    while not cond() and time.monotonic() < t_end:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("family,paged,quant", [
    ("gpt", False, False), ("gpt", True, False), ("llama", False, True), ("llama", True, True),
], ids=["gpt-contiguous", "gpt-paged", "llama-int8-contiguous", "llama-int8-paged"])
def test_loop_window_matches_jax(family, paged, quant, monkeypatch):
    """Three streams at DECODE_WINDOW=4 with AUTO off: the JAX loop's
    tokens, the port's at W = 1, and windows formed, counted as JAX's."""
    monkeypatch.setenv("ADMIT_GRACE_MS", GRACE_MS)
    kw = dict(decode_window=4, decode_window_auto=False)
    if paged:
        kw.update(paged_kv=True, kv_block_size=8)
    jengine, jcfg, engine, batcher = _pair(family, quant, **kw)
    _, _, engine1, batcher1 = _pair(family, quant, **{**kw, "decode_window": 1})
    waves = [_feats((7, 13, 20))]
    jloop, loop = JaxLoop(jengine, jcfg), batcher._cdl
    want = _run(jloop, waves)
    got = _run(loop, waves)
    assert got == want == _run(batcher1._cdl, waves)
    assert loop.window_dispatches > 0 and loop.window_chunks > 0
    assert batcher1._cdl.window_dispatches == 0
    _same_counts(loop, jloop, paged)
    if paged:
        assert _wait(lambda: engine.kv_pool.used_blocks == 0)


def test_loop_window_sampled_seeded_and_non_divisor_budget():
    """A pinned-seed sampled stream and a greedy one whose budget (10) is
    no multiple of a window's 16 tokens: JAX's tokens and the port's at
    W = 1."""
    kw = dict(decode_window=4, decode_window_auto=False, max_decode_len=32)
    jengine, jcfg, engine, batcher = _pair("gpt", **kw)
    _, _, _, batcher1 = _pair("gpt", **{**kw, "decode_window": 1})
    sampled = _feats((9,), 1, **SEED_KW)
    short = _feats((12,), 2, max_tokens=10)
    waves = [sampled + short]
    want = _run(JaxLoop(jengine, jcfg), waves)
    got = _run(batcher._cdl, waves)
    assert got == want == _run(batcher1._cdl, waves)
    assert len(got[0][1]) == 10 and batcher._cdl.window_dispatches > 0


def _solo_jax(feats: dict, max_len: int = 32) -> list[int]:
    """The tiny gpt's tokens for ``feats`` alone (the JAX engine)."""
    eng = JaxEngine(tiny_gpt_bundle(), _jcfg(max_decode_len=max_len), ReplicaSet(make_mesh(1)))
    return np.concatenate(list(eng.generate_stream(dict(feats)))).tolist()


def _rigged_eos(feats: dict, lo: int, hi: int) -> int:
    """A token ``feats``' own run (greedy, or its seed's draws) emits first
    at a step in [``lo``, ``hi``): rigged as the eos, it ends that stream
    there (for steps past the first chunk: inside a window)."""
    toks = _solo_jax(feats)
    return next(t for k, t in enumerate(toks) if lo <= k < hi and t not in toks[:k])


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_next_tenants_after_early_exits_match_jax(paged, mode, monkeypatch):
    """A stream alone whose eos comes a few steps into its first window:
    the window ends early, and the port's extra chunks step its done row
    past ``n_chunks`` (position, rng chain, K/V writes into its own blocks
    or the scratch block).  The next tenants of the slots, greedy or seeded
    sampled, get JAX's tokens all the same."""
    extra = SEED_KW if mode == "sampled" else {}
    first = _feats((7,), 0, **extra)[0]
    eos = _rigged_eos(first, CHUNK + 1, 3 * CHUNK)
    monkeypatch.setenv("ADMIT_GRACE_MS", GRACE_MS)
    kw = dict(decode_window=4, decode_window_auto=False, max_decode_len=32)
    if paged:
        kw.update(paged_kv=True, kv_block_size=8)
    jengine, jcfg, engine, batcher = _pair("gpt", eos=eos, **kw)
    waves = [[first], _feats((9, 14), 3, **extra) + _feats((11,), 5),
             _feats((13, 6, 10, 8), 6, **extra), [first]]
    jloop, loop = JaxLoop(jengine, jcfg), batcher._cdl
    want = _run(jloop, waves)
    got = _run(loop, waves)
    assert got == want
    assert eos in got[0][0] and len(got[0][0]) <= 3 * CHUNK  # then pad to the chunk's end
    assert loop.window_early_exits >= 1
    _same_counts(loop, jloop, paged)
    if paged:
        assert _wait(lambda: engine.kv_pool.used_blocks == 0)


def test_eos_row_blocks_freed_while_others_decode():
    """The stream that ends on its first token returns its blocks at the
    window boundary that fetched its done flag, while the other stream
    still decodes."""
    a, b = _feats((7,))[0], _feats((9,), 8, max_tokens=48)[0]
    eos = _rigged_eos(a, 0, 1)
    jengine, jcfg, engine, batcher = _pair(
        "gpt", eos=eos, decode_window=4, decode_window_auto=False, paged_kv=True,
        kv_block_size=8, max_decode_len=48)
    assert eos not in _solo_jax(b, 48)[:24]
    loop, pool = batcher._cdl, engine.kv_pool
    b_max = -(-(16 + 48) // 8)

    async def body():
        task_b = asyncio.ensure_future(_collect(loop.submit_stream(dict(b))))
        out_a = await _collect(loop.submit_stream(dict(a)))
        held = None
        for _ in range(500):
            if pool.used_blocks <= b_max and not task_b.done():
                held = pool.used_blocks
                break
            await asyncio.sleep(0.005)
        running = not task_b.done()
        return out_a, await task_b, held, running

    try:
        out_a, out_b, held, running = asyncio.run(body())
    finally:
        loop.stop()
    assert out_a[0] == eos and len(out_a) <= CHUNK
    assert running and held is not None and held <= b_max
    assert _wait(lambda: pool.used_blocks == 0)


def test_window_ledger_at_every_boundary():
    """Mixed budgets, early device EOS and deep windows: at every dispatch
    boundary the pool's used blocks are exactly the live rows' (no block
    leaked, none granted twice), and the pool drains after each round."""
    first = _feats((7,))[0]
    eos = _rigged_eos(first, CHUNK + 1, 3 * CHUNK)
    jengine, jcfg, engine, batcher = _pair(
        "gpt", eos=eos, decode_window=4, decode_window_auto=False, paged_kv=True,
        kv_block_size=8, max_decode_len=32)
    loop, pool = batcher._cdl, engine.kv_pool
    seen, bad = [0], []
    orig = loop._dispatch_chunk

    def checked():
        held = sum(len(st.blocks.ids) for st in loop.active.values() if st.blocks is not None)
        if pool.used_blocks != held:
            bad.append((pool.used_blocks, held))
        seen[0] += 1
        return orig()

    loop._dispatch_chunk = checked
    rng = np.random.default_rng(4)
    waves = [[first]]  # alone: its window ends early
    for _ in range(3):
        wave = []
        for _ in range(4):
            n = int(rng.integers(5, 28))
            wave.append({"input_ids": rng.integers(5, 250, n).astype(np.int32),
                         "length": np.int32(n), "max_tokens": int(rng.integers(3, 32))})
        waves.append(wave)
    chunks = port_metrics.DECODE_WINDOW_CHUNKS.labels("gpt2")
    exits = port_metrics.WINDOW_EARLY_EXITS.labels("gpt2")
    before = (chunks._sum.get(), exits._value.get())
    want = _run(JaxLoop(jengine, jcfg), waves)
    got = _run(loop, waves)
    assert got == want and seen[0] > 0 and not bad, bad
    assert loop.window_early_exits > 0
    assert _wait(lambda: pool.used_blocks == 0)
    # Every dispatch observes its depth; every early exit counts.
    assert chunks._sum.get() - before[0] == loop.decode_steps // loop.chunk
    assert exits._value.get() - before[1] == loop.window_early_exits


def test_window_metrics_are_the_jax_series():
    for name in ("DECODE_WINDOW_CHUNKS", "WINDOW_EARLY_EXITS"):
        port, ref = getattr(port_metrics, name), getattr(jax_metrics, name)
        assert (port._name, port._documentation, port._labelnames) == (
            ref._name, ref._documentation, ref._labelnames)
    assert (port_metrics.DECODE_WINDOW_CHUNKS._upper_bounds
            == jax_metrics.DECODE_WINDOW_CHUNKS._upper_bounds)


def test_auto_windows_only_without_interactive_work():
    """AUTO (the default): interactive streams, the default class, never
    see a window; batch-class streams fuse."""
    jengine, jcfg, engine, batcher = _pair("gpt", decode_window=4)
    loop = batcher._cdl
    f = _feats((9,), 6)
    _run(loop, [f])
    assert loop.window_dispatches == 0 and loop.chunk_dispatches > 0
    _, _, _, batcher = _pair("gpt", decode_window=4)
    loop = batcher._cdl
    _run(loop, [[dict(f[0], priority="batch")]])
    assert loop.window_dispatches > 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_windows_replay_the_chunk_graph_like_jax(paged):
    """The card's path on the CPU: under the graph tests' stand-in capturer
    a window replays the loop's one chunk graph W times (no graph of its
    own), each chunk's results copied out before the next replay; tokens
    equal the JAX loop's, and the replays are the loop's decode steps over
    the chunk."""
    kw = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=24,
              stream_chunk_tokens=4, max_streams=4, kv_block_size=8, paged_kv=paged,
              decode_window=4, decode_window_auto=False)
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        jcfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False, **kw)
        jbundle = jax_build_model(jcfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    texts = [("hi", None), ("the quick brown fox", 9), ("serving tokens, twice", None)]
    jwave = [jbundle.preprocess(JaxRawItem(text=t, max_tokens=m)) for t, m in texts]
    want = _run(JaxLoop(JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1))), jcfg), [jwave])
    _, bundle, engine, batcher = build_service(
        {**LLAMA, "MAX_DECODE_LEN": "24", "PAGED_KV": "1" if paged else "0",
         "DECODE_WINDOW": "4", "DECODE_WINDOW_AUTO": "0"},
        params=jax.tree.map(np.asarray, jbundle.params))
    cache = _with_graphs(engine)
    loop = batcher._cdl
    wave = [bundle.preprocess(RawItem(text=t, max_tokens=m)) for t, m in texts]
    assert _run(loop, [wave]) == want
    kind = "loop_chunk_paged" if paged else "loop_chunk"
    assert set(cache.kinds()) == {"start", kind}
    replays = loop.chunk_graph(False).replays + loop.chunk_graph(True).replays
    assert loop.window_dispatches > 0 and replays == loop.decode_steps // loop.chunk


# ---------------------------------------------------------------------------
# 4. checkpoints and chunked prefill with windows in flight


WINDOWED = dict(decode_window=4, decode_window_auto=False)


def test_preemption_with_a_window_in_flight_resumes_like_jax():
    """One slot held by a batch stream decoding in windows (AUTO off); an
    interactive arrival preempts it at a window boundary; both streams get
    the tokens of unpreempted runs, the JAX loop's."""
    kw = dict(batch_buckets=(1, 2), seq_buckets=(16, 32, 64), max_decode_len=32,
              stream_chunk_tokens=4, max_streams=1, max_stream_queue=4, preempt=True,
              **WINDOWED)
    jloop, jengine, loop, engine = _loops("llama", **kw)
    batch = _prompt(20, priority="batch")
    inter = _prompt(9, priority="interactive")
    outs = []
    for lp in (jloop, loop):
        _hold_first_chunk(lp)
        try:
            outs.append(asyncio.run(_preempted(lp, dict(batch), dict(inter))))
        finally:
            lp.stop()
        assert lp.preemptions >= 1
    assert outs[1] == outs[0]
    assert loop.window_dispatches > 0 and loop.recasts > 0


def test_dry_pool_with_windows_checkpoints_and_resumes_like_jax():
    """A window's growth grants all its chunks' blocks at once, so a small
    pool runs dry sooner: a stream is checkpointed at a window's growth
    and resumes token-identically; the pool drains."""
    jloop, jengine, loop, engine, prompts = _paged_gpt2(6)
    jloop.stop()
    loop.stop()
    bb = 2 * 2 * 4 * 32 * 4 * 8
    kw = dict(batch_buckets=(1, 2), seq_buckets=(16, 32), max_decode_len=10,
              stream_chunk_tokens=4, max_streams=2, max_stream_queue=4, paged_kv=True,
              kv_block_size=8, kv_budget_mb=6 * bb / 1e6, **WINDOWED)
    jloop, jengine, loop, engine = _loops("gpt2", **kw)
    outs = []
    for lp in (jloop, loop):
        try:
            outs.append(asyncio.run(_together(lp, [dict(p, priority="batch")
                                                   for p in prompts])))
        finally:
            lp.stop()
    assert outs[1] == outs[0]
    assert loop.kv_growth_stalls >= 1 and loop.window_dispatches > 0
    assert _wait(lambda: engine.kv_pool.used_blocks == 0)


def test_host_tier_swap_with_windows_resumes_like_jax():
    """The host KV tier under windows: a window's growth runs the 6-block
    pool dry, the checkpointed stream's blocks swap out and come back by
    prefetch; tokens equal uninterrupted runs and the JAX loop's, and both
    tiers drain."""
    jloop, jengine, loop, engine = _tier_loops("gpt2", **WINDOWED)
    batch = _prompts()
    want = _run(jloop, [batch])
    got = _run(loop, [batch])
    assert got == want == [[_solo(engine, f) for f in batch]]
    assert loop.swap_outs >= 1 and loop.swap_ins == loop.swap_outs
    assert loop.swap_fallbacks == 0 and loop.window_dispatches > 0
    _drained(loop, engine)
    _drained(jloop, jengine)


def test_chunked_prefill_windows_a_boundary_match_jax():
    """PREFILL_CHUNK with windows: the prompt windows each boundary
    dispatches (the budget scaled by the last window) are the JAX loop's,
    and so are the tokens."""
    kw = dict(WINDOWED, prefill_chunk=8, max_decode_len=32)
    jengine, jcfg, engine, batcher = _pair("llama", **kw)
    waves = [_feats((6, 9, 30, 27), 9, priority="batch")]

    def per_boundary(loop):
        counts = []
        orig = loop._advance_prefill

        def spy():
            before, live = loop.prefill_chunk_dispatches, bool(loop.active)
            out = orig()
            if live:  # with nothing live the backlog runs unbounded
                counts.append(loop.prefill_chunk_dispatches - before)
            return out

        loop._advance_prefill = spy
        return counts

    outs = []
    for loop in (JaxLoop(jengine, jcfg), batcher._cdl):
        counts = per_boundary(loop)
        outs.append((_run(loop, waves), loop.prefill_chunk_dispatches,
                     [c for c in counts if c]))
    (want, jn, jcounts), (got, n, counts) = outs
    assert got == want and n == jn > 0
    assert counts == jcounts
    # One window's budget (PREFILL_BUDGET = PREFILL_CHUNK), scaled by a
    # window of more than one chunk.
    assert batcher._cdl.window_dispatches > 0 and max(counts) > 1, counts


# ---------------------------------------------------------------------------
# 5. blocks, the governor, the refusals


def test_stream_blocks_trim_matches_jax():
    out = []
    for pool_cls, sb_cls in ((JaxBlockPool, JaxStreamBlocks), (BlockPool, StreamBlocks)):
        pool = pool_cls(16)
        sb = sb_cls(pool, 8)
        sb.ensure(100)
        steps = [pool.used_blocks, sb.trim(40), pool.used_blocks, sb.trim(40)]
        donor = sb_cls(pool, 8)
        donor.ensure(16)
        sharer = sb_cls(pool, 8)
        sharer.adopt(list(donor.ids))
        sharer.ensure(40)
        steps += [sharer.trim(0), list(sharer.ids), sharer.shared, sharer.trim(20),
                  pool.used_blocks]
        sharer.release()
        donor.release()
        sb.release()
        out.append(steps + [pool.used_blocks])
    assert out[1] == out[0]
    assert out[1][0] == 13 and len(out[1][1]) == 8 and out[1][-1] == 0
    assert len(out[1][5]) == out[1][6] == 2  # never into the adopted prefix


def test_governor_matches_jax():
    """``pick`` (with its last depth carried across calls) and ``preview``
    over a grid of (cap, auto, max_chunks, live, waiting)."""
    grid = list(itertools.product((0, 1, 2, 3, 5, 8, 13, 64), (False, True), (False, True)))
    for cap, auto in itertools.product((1, 2, 4, 6, 8, 64), (False, True)):
        jg, pg = JaxGovernor(cap, auto), DecodeWindowGovernor(cap, auto)
        for max_chunks, live, waiting in grid:
            assert pg.preview(max_chunks, live, waiting) == jg.preview(max_chunks, live, waiting)
            assert pg.pick(max_chunks, live, waiting) == jg.pick(max_chunks, live, waiting)
            assert pg._last == jg._last
        assert pg.recorder is None


def test_t5_window_refused_with_the_jax_message():
    cfg = _jcfg(decode_window=4)
    with pytest.raises(ValueError, match="DECODE_WINDOW") as want:
        JaxLoop(JaxEngine(tiny_t5_bundle(), cfg, ReplicaSet(make_mesh(1))), cfg)
    with small_t5(), pytest.raises(ValueError) as got:
        build_service({"MODEL_NAME": "t5-small", "DEVICE": "cpu", "WARMUP": "0",
                       "SEQ_BUCKETS": "16,32", "DECODE_WINDOW": "4"})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["0", "65", "-1"])
def test_decode_window_range_message_matches_jax(value):
    with pytest.raises(ValueError) as want:
        jax_load_config({"DEVICE": "cpu", "DECODE_WINDOW": value})
    with pytest.raises(ValueError) as got:
        load_config({"DEVICE": "cpu", "DECODE_WINDOW": value})
    assert "DECODE_WINDOW must be in [1, 64]" in str(want.value)
    assert str(got.value) == "DECODE_WINDOW must be in [1, 64]"


def test_decode_window_knobs_read_like_jax():
    for env in ({"DECODE_WINDOW": "8"}, {"DECODE_WINDOW": "64", "DECODE_WINDOW_AUTO": "0"},
                {"DECODE_WINDOW_AUTO": "false"}, {"DECODE_WINDOW_AUTO": "yes"}, {}):
        j = jax_load_config({"DEVICE": "cpu", **env})
        p = load_config({"DEVICE": "cpu", **env})
        assert (p.decode_window, p.decode_window_auto) == (j.decode_window,
                                                           j.decode_window_auto)

