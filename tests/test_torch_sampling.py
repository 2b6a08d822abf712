"""Per-row sampling in the port against the JAX package, on the CPU in f32.

- threefry: ``row_split`` and ``random_bits`` equal ``jax.random.split`` and
  ``jax.random.bits`` bit for bit, and the uniforms ``jax.random.uniform``
  (minval tiny), for several keys; the Gumbel noise agrees within 2e-6
  (torch's and XLA's ``log`` differ in the last bits).
- ``filtered_logits`` within 1e-6 of the JAX one for top_k in {0, 1, 5}
  and top_p in {1, 0.9, 0.5} at V in {257, 50257}; an entry may flip only
  at the top-p cut, where the mass before it is within twice the two
  packages' measured cumulative-sum difference of p.
- ``select_token``: tokens and rng chains identical to JAX's over several
  steps of greedy/sampled mixes.  A token may differ only where the JAX
  step's two best perturbed scores are closer than twice the measured
  difference of the perturbed scores; every such case is reported.
- A seeded row draws the same tokens alone and inside a batch.
- Seeded sampled requests through the engine (whole generations) and the
  continuous loop (contiguous and paged), for a tiny llama and a tiny
  GPT-2: tokens identical to the JAX package's, under the same rule, with
  the margin measured teacher-forced on both packages' logits.
"""

import asyncio
import contextlib
import functools
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models import gpt as jax_gpt
from mlmicroservicetemplate_tpu.models import llama as jax_llama
from mlmicroservicetemplate_tpu.models import sampling as js
from mlmicroservicetemplate_tpu.models.registry import RawItem as JaxRawItem
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.models import gpt as port_gpt
from mlmicroservicetemplate_tpu_torch.models import llama as port_llama
from mlmicroservicetemplate_tpu_torch.models import sampling as ps
from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
from mlmicroservicetemplate_tpu_torch.serve import build_service

GUMBEL_TOL = 2e-6
FILTER_TOL = 1e-6
KEYS = [0, 1, 42, 12345, 2**31 - 1, 2**32 - 1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# threefry


@pytest.mark.parametrize("seed", KEYS)
def test_split_bits_and_uniforms_match_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    rng = ps.make_params([seed], [1.0], [0], [1.0]).rng
    np.testing.assert_array_equal(rng.numpy()[0], np.asarray(key).astype(np.int64))
    chain, step = jax.random.split(key)
    got_chain, got_step = ps.row_split(rng)
    np.testing.assert_array_equal(got_chain.numpy()[0], np.asarray(chain))
    np.testing.assert_array_equal(got_step.numpy()[0], np.asarray(step))
    for n in (1, 257, 4099):
        bits = ps.random_bits(got_step, n)
        np.testing.assert_array_equal(bits.numpy()[0],
                                      np.asarray(jax.random.bits(step, (n,), jnp.uint32)))
        tiny = float(np.finfo(np.float32).tiny)
        want_u = np.asarray(jax.random.uniform(step, (n,), jnp.float32, minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(ps.uniforms(bits).numpy()[0], want_u)
        want_g = np.asarray(jax.random.gumbel(step, (n,), jnp.float32))
        np.testing.assert_allclose(ps.gumbel(got_step, n).numpy()[0], want_g,
                                   atol=GUMBEL_TOL, rtol=GUMBEL_TOL)


def test_make_params_layout_matches_jax():
    seeds = np.array([0, 7, 2**32 - 1], np.uint32)
    want = js.make_params(seeds, [0.0, 1.0, 0.5], [0, 5, 1], [1.0, 0.9, 0.5])
    got = ps.make_params(seeds, [0.0, 1.0, 0.5], [0, 5, 1], [1.0, 0.9, 0.5])
    for g, w in zip(got.fields(), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    greedy = ps.greedy_params(3)
    for g, w in zip(greedy.fields(), js.greedy_params(3)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# filtering and selection


def _rows(v: int, seed: int = 0):
    """Nine rows: every (top_k, top_p) pair of {0, 1, 5} x {1, 0.9, 0.5},
    at mixed temperatures (two greedy), over N(0, 3^2) logits."""
    rng = np.random.default_rng(seed)
    pairs = [(k, p) for k in (0, 1, 5) for p in (1.0, 0.9, 0.5)]
    top_k = np.array([k for k, _ in pairs], np.int32)
    top_p = np.array([p for _, p in pairs], np.float32)
    temp = np.array([0.0, 1.0, 0.7, 1.3, 0.0, 1.0, 0.5, 2.0, 0.9], np.float32)
    seeds = rng.integers(0, 2**32, len(pairs)).astype(np.uint32)
    logits = (rng.standard_normal((len(pairs), v)) * 3).astype(np.float32)
    return logits, seeds, temp, top_k, top_p


def _mass_before(z, top_p):
    """Per row, the sorted distribution's cumulative mass before each sorted
    position (JAX's) and its largest difference from the port's."""
    sz = -jnp.sort(-jnp.asarray(z), axis=-1)
    probs = jax.nn.softmax(sz, axis=-1)
    jbefore = np.asarray(jnp.cumsum(probs, axis=-1) - probs)
    tz = torch.sort(torch.from_numpy(np.array(z)), dim=-1, descending=True).values
    tp = torch.softmax(tz, dim=-1)
    pbefore = (torch.cumsum(tp, dim=-1) - tp).numpy()
    return np.asarray(sz), jbefore, np.abs(jbefore - pbefore).max(axis=-1)


@pytest.mark.parametrize("v", [257, 50257])
def test_filtered_logits_match_jax(v):
    logits, _, temp, top_k, top_p = _rows(v)
    want = np.asarray(js.filtered_logits(jnp.asarray(logits), jnp.asarray(temp),
                                         jnp.asarray(top_k), jnp.asarray(top_p)))
    got = ps.filtered_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                             torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    z = logits / np.maximum(temp, 1e-6)[:, None]
    z_topk = np.asarray(js._filter_top_k(jnp.asarray(z), jnp.asarray(top_k),
                                         -jnp.sort(-jnp.asarray(z), axis=-1)))
    sz, before, cum_err = _mass_before(z_topk, top_p)
    flips = []
    for r, c in zip(*np.nonzero(np.abs(got - want) > FILTER_TOL)):
        # Only the top-p cut may flip: the flipped entry's sorted position
        # has its mass-before within 2x the cumsum difference of p.
        pos = int(np.nonzero(sz[r] == z[r, c])[0][0])
        gap = abs(float(before[r, pos]) - float(top_p[r]))
        flips.append(dict(row=int(r), col=int(c), gap=gap, cum_err=float(cum_err[r])))
        assert gap < 2 * cum_err[r], flips
    assert len(flips) <= 2, flips
    kept = (got > -1e8).sum(axis=-1)
    assert (kept[3:6] == 1).all() and (kept[6:] <= 5).all()  # top_k 1 and 5
    assert (kept[[0, 3, 6]] == np.minimum(top_k[[0, 3, 6]] + v * (top_k[[0, 3, 6]] == 0), v)).all()


def _margin_and_diff(jax_logits, port_logits, temp, top_k, top_p, seed, step):
    """For one row's step: the gap between the JAX step's two best perturbed
    scores (filtered logits plus Gumbel noise), and the largest difference
    between the two packages' perturbed scores over the entries both keep."""
    key = jax.random.PRNGKey(seed)
    rng = ps.make_params([seed], [temp], [top_k], [top_p]).rng
    for _ in range(step + 1):
        key, jkey = jax.random.split(key)
        rng, pkey = ps.row_split(rng)
    zj = np.asarray(js.filtered_logits(jnp.asarray(jax_logits)[None], jnp.asarray([temp]),
                                       jnp.asarray([top_k]), jnp.asarray([top_p]))[0])
    zp = ps.filtered_logits(torch.from_numpy(np.asarray(port_logits))[None],
                            torch.tensor([temp]), torch.tensor([top_k], dtype=torch.int32),
                            torch.tensor([top_p])).numpy()[0]
    sj = zj + np.asarray(jax.random.gumbel(jkey, zj.shape, jnp.float32))
    sp = zp + ps.gumbel(pkey, zp.shape[0]).numpy()[0]
    both = (zj > -1e8) & (zp > -1e8)
    top = np.sort(sj)
    return float(top[-1] - top[-2]), float(np.abs(sj - sp)[both].max())


@pytest.mark.parametrize("v", [257, 50257])
def test_select_token_matches_jax(v):
    logits, seeds, temp, top_k, top_p = _rows(v, seed=1)
    jsp = js.make_params(seeds, temp, top_k, top_p)
    psp = ps.make_params(seeds, temp, top_k, top_p)
    report = []
    for step in range(6):
        jtok, jsp = js.select_token(jnp.asarray(logits), jsp)
        ptok, psp = ps.select_token(torch.from_numpy(logits), psp)
        np.testing.assert_array_equal(psp.rng.numpy(), np.asarray(jsp.rng).astype(np.int64))
        for r in np.nonzero(np.asarray(jtok) != ptok.numpy())[0]:
            margin, diff = _margin_and_diff(logits[r], logits[r], float(temp[r]), int(top_k[r]),
                                            float(top_p[r]), int(seeds[r]), step)
            report.append(dict(step=step, row=int(r), margin=margin, score_diff=diff))
            assert temp[r] > 0 and margin < 2 * diff, report
        logits = np.roll(logits, 17, axis=-1)
    assert len(report) <= 1, report


def test_seeded_rows_batched_equal_solo():
    v = 4099
    logits, seeds, temp, top_k, top_p = _rows(v, seed=2)
    batch = ps.make_params(seeds, temp, top_k, top_p)
    solo = ps.make_params(seeds[3:4], temp[3:4], top_k[3:4], top_p[3:4])
    for step in range(5):
        tb, batch = ps.select_token(torch.from_numpy(logits), batch)
        ts, solo = ps.select_token(torch.from_numpy(logits[3:4]), solo)
        assert int(tb[3]) == int(ts[0])
        torch.testing.assert_close(batch.rng[3:4], solo.rng, rtol=0, atol=0)
        logits = np.roll(logits, 5, axis=-1)


# ---------------------------------------------------------------------------
# through the engine and the loop, llama and GPT-2

LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
GPT = dict(vocab_size=300, d_model=128, num_heads=4, num_layers=2, d_ff=256,
           max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
             stream_chunk_tokens=4, max_streams=4, kv_block_size=8)
PORT_SERVE = {"BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "10",
              "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "KV_BLOCK_SIZE": "8",
              "BATCH_TIMEOUT_MS": "1"}
# (text, max_tokens, sampling): seeded sampled rows beside a greedy one.
REQUESTS = [("hi", None, dict(temperature=0.8, seed=1)),
            ("the quick brown fox", 3, {}),
            ("serving tokens, twice", None, dict(temperature=1.2, top_k=40, top_p=0.9, seed=2)),
            ("a", 7, dict(temperature=0.6, top_p=0.5, seed=3))]


@contextlib.contextmanager
def _family(name: str):
    """Both packages' builders of ``name`` at the small dims."""
    with pytest.MonkeyPatch.context() as mp:
        if name == "llama":
            mp.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
        else:
            mp.setattr(jax_gpt, "GPTConfig", functools.partial(jax_gpt.GPTConfig, **GPT))
            mp.setattr(port_gpt, "GPTConfig", functools.partial(port_gpt.GPTConfig, **GPT))
        yield


def _services(name: str, paged: bool):
    with _family(name):
        jcfg = JaxServiceConfig(device="cpu", model_name=name, warmup=False,
                                batch_timeout_ms=1.0, paged_kv=paged, **SERVE)
        jbundle = jax_build_model(jcfg)
        overrides = {"MODEL_NAME": name, "DEVICE": "cpu", "WARMUP": "0", **PORT_SERVE,
                     "PAGED_KV": "1" if paged else "0"}
        if name == "llama":
            overrides["LLAMA_CONFIG"] = os.environ["LLAMA_CONFIG"]
        port = build_service(overrides, params=jax.tree.map(np.asarray, jbundle.params))
    return (jcfg, jbundle, JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1)))), port


def _logits_fns(name: str, jbundle, bundle):
    """(JAX, port) f32 next-token logits [S, V] of one unpadded sequence."""
    jmod, pmod = (jax_llama, port_llama) if name == "llama" else (jax_gpt, port_gpt)

    def jax_fn(ids):
        a = jnp.asarray([ids], jnp.int32)
        return np.asarray(jmod.lm_logits(jbundle.params, jbundle.cfg, a, jnp.ones_like(a)))[0]

    def port_fn(ids):
        t = torch.tensor([ids], dtype=torch.int32)
        with torch.inference_mode():
            return pmod.lm_logits(bundle.model, t, torch.ones_like(t)).numpy()[0]

    return jax_fn, port_fn


def _check_rows(got, want, feats, fns) -> list[dict]:
    """Identical rows, or rows that part at a sampled step whose two best
    perturbed scores (JAX's, teacher-forced on JAX's tokens) are closer
    than twice the measured difference of the two packages' perturbed
    scores there; returns the report of every such step."""
    report = []
    for g, w, f in zip(got, want, feats):
        g, w = [int(t) for t in g], [int(t) for t in w]
        n = min(len(g), len(w))
        at = next((t for t in range(n) if g[t] != w[t]), None)
        if at is None:
            assert len(g) == len(w)
            continue
        assert float(f.get("temperature", 0.0)) > 0, "a greedy row parted"
        ids = [int(t) for t in f["input_ids"]] + w[:at]
        margin, diff = _margin_and_diff(
            fns[0](ids)[-1], fns[1](ids)[-1], float(f["temperature"]), int(f.get("top_k", 0)),
            float(f.get("top_p", 1.0)), int(f["seed"]), at)
        report.append(dict(step=at, margin=margin, score_diff=diff))
        assert margin < 2 * diff, report
    return report


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_seeded_sampling_through_the_engine_matches_jax(name):
    (jcfg, jbundle, jengine), (cfg, bundle, engine, _) = _services(name, paged=False)
    jfeats = [jbundle.preprocess(JaxRawItem(text=t, max_tokens=m, **kw)) for t, m, kw in REQUESTS]
    feats = [bundle.preprocess(RawItem(text=t, max_tokens=m, **kw)) for t, m, kw in REQUESTS]
    want = jengine.run_batch(jfeats)
    got = engine.run_batch(feats)
    report = _check_rows(got, want, feats, _logits_fns(name, jbundle, bundle))
    assert len(report) <= 1, report
    # Alone, the seeded row draws what it drew in the batch.
    alone = engine.run_batch(feats[2:3])
    np.testing.assert_array_equal(alone[0], got[2])


async def _streams(loop, items):
    async def consume(gen):
        out = []
        async for chunk in gen:
            out.extend(np.asarray(chunk).tolist())
        return out

    return list(await asyncio.gather(*(consume(loop.submit_stream(f)) for f in items)))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_seeded_sampling_through_the_loop_matches_jax(name, paged):
    (jcfg, jbundle, jengine), (cfg, bundle, engine, batcher) = _services(name, paged)
    jloop = JaxLoop(jengine, jcfg)
    try:
        want = asyncio.run(_streams(jloop, [
            jbundle.preprocess(JaxRawItem(text=t, max_tokens=m, **kw)) for t, m, kw in REQUESTS]))
    finally:
        jloop.stop()
    feats = [bundle.preprocess(RawItem(text=t, max_tokens=m, **kw)) for t, m, kw in REQUESTS]
    loop = batcher._cdl
    try:
        got = asyncio.run(_streams(loop, feats))
        for _ in range(250):  # the loop frees a slot just after its last chunk
            if loop.admitted == 0:
                break
            time.sleep(0.02)
        assert loop.admitted == 0 and not loop.sampled_slots  # no live slot samples
        solo = asyncio.run(_streams(loop, feats[:1]))
    finally:
        loop.stop()
    report = _check_rows(got, want, feats, _logits_fns(name, jbundle, bundle))
    assert len(report) <= 1, report
    assert solo[0] == got[0]
    if paged:
        assert engine.kv_pool.used_blocks == 0
