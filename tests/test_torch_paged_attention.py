"""Paged decode attention (K3) of the port against the JAX package's on the
same numpy inputs: the plain version and the wrapper's CPU path against
the Pallas kernel in interpret mode and against the JAX reference, dense
f32 and int8 pools, over a shuffled block table with a sentinel entry and
a row with no valid key, to 2e-5 plus 1e-6 relative (f32 summation
order; the int8 pools' outputs reach ~100).  Also ``gather_pages`` /
``scatter_pages`` (sentinel clamp, sentinel drop) and the wrapper's
refusals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.ops import paged_attention as jax_pa
from mlmicroservicetemplate_tpu_torch.ops import paged_attention as port_pa

B, T, BS, KVH, NREP, D = 3, 3, 8, 2, 4, 64
POOL = 10  # blocks; id POOL is the sentinel
TOL, RTOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(quant: bool, seed: int = 0):
    """q [B, H, D], pools [POOL, BS, KVH, D] (int8 with f32 scales when
    ``quant``), a shuffled table whose row 1 ends in the sentinel, and
    key_valid with row 2 all invalid."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH * NREP, D)).astype(np.float32)
    kp = rng.standard_normal((POOL, BS, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((POOL, BS, KVH, D)).astype(np.float32)
    table = rng.permutation(POOL)[: B * T].reshape(B, T).astype(np.int32)
    table[1, -1] = POOL
    valid = (rng.random((B, T * BS)) > 0.3).astype(np.int32)
    valid[:2, 0] = 1
    valid[1, (T - 1) * BS:] = 0  # the sentinel block's keys
    valid[2] = 0
    ks = vs = None
    if quant:
        kp = np.clip(np.round(kp * 16), -127, 127).astype(np.int8)
        vp = np.clip(np.round(vp * 16), -127, 127).astype(np.int8)
        ks = (np.abs(rng.standard_normal((POOL, BS, KVH, 1))) + 0.01).astype(np.float32)
        vs = (np.abs(rng.standard_normal((POOL, BS, KVH, 1))) + 0.01).astype(np.float32)
    return q, kp, vp, table, valid, ks, vs


def _jax(fn, q, kp, vp, table, valid, ks, vs, **kw):
    opt = {} if ks is None else {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                         jnp.asarray(valid), BS, **opt, **kw))


def _port(fn, q, kp, vp, table, valid, ks, vs):
    opt = {} if ks is None else {"k_scale": torch.from_numpy(ks),
                                 "v_scale": torch.from_numpy(vs)}
    return fn(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
              torch.from_numpy(table), torch.from_numpy(valid), BS, **opt).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("port_fn", ["paged_attention_ref", "paged_decode_attention"])
def test_matches_the_jax_kernel_and_reference(quant, port_fn):
    args = _inputs(quant)
    want_kernel = _jax(jax_pa.paged_decode_attention, *args, interpret=True)
    want_ref = _jax(jax_pa.paged_attention_ref, *args)
    launches = port_pa.paged_decode_attention.launches
    got = _port(getattr(port_pa, port_fn), *args)
    assert port_pa.paged_decode_attention.launches == launches  # CPU: the plain version
    assert got.dtype == np.float32 and got.shape == (B, KVH * NREP, D)
    np.testing.assert_allclose(got, want_kernel, atol=TOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=RTOL)


def test_row_without_valid_keys_is_the_uniform_average():
    q, kp, vp, table, valid, _, _ = _inputs(False)
    got = _port(port_pa.paged_attention_ref, q, kp, vp, table, valid, None, None)
    rows = kp.shape[0] - 1
    vd = vp[np.clip(table[2], 0, rows)].reshape(T * BS, KVH, D)
    want = np.repeat(vd.mean(axis=0), NREP, axis=0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[2], want, atol=TOL, rtol=0)


def test_gather_pages_matches_jax_and_clamps_the_sentinel():
    _, kp, _, table, _, _, _ = _inputs(False)
    want = np.asarray(jax_pa.gather_pages(jnp.asarray(kp), jnp.asarray(table), BS))
    got = port_pa.gather_pages(torch.from_numpy(kp), torch.from_numpy(table), BS).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1, (T - 1) * BS:], kp[POOL - 1])


@pytest.mark.parametrize("start,width", [(0, T * BS), (5, 12), (BS * (T - 1) + 3, 9)])
def test_scatter_pages_matches_jax_and_drops_at_the_sentinel(start, width):
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((POOL, BS, KVH, D)).astype(np.float32)
    vals = rng.standard_normal((width, KVH, D)).astype(np.float32)
    row = np.array([4, 7, POOL], np.int32)  # ends in the sentinel
    want = np.asarray(jax_pa.scatter_pages(jnp.asarray(pool), jnp.asarray(row),
                                           jnp.asarray(vals), BS, start=start))
    port_pool = torch.from_numpy(pool.copy())
    out = port_pa.scatter_pages(port_pool, torch.from_numpy(row), torch.from_numpy(vals), BS,
                                start=start)
    assert out is port_pool  # in place
    np.testing.assert_array_equal(port_pool.numpy(), want)
    untouched = [b for b in range(POOL) if b not in (4, 7)]
    np.testing.assert_array_equal(port_pool.numpy()[untouched], pool[untouched])


def test_wrapper_refuses_a_device_it_does_not_take():
    args = [torch.empty(x.shape, dtype=torch.from_numpy(x).dtype, device="meta")
            for x in _inputs(False)[:5]]
    with pytest.raises(ValueError, match="unsupported device"):
        port_pa.paged_decode_attention(*args, BS)


# ---------------------------------------------------------------------------
# The kernel's split over the table (csrc/decode_sm90.cuh), emulated

from test_torch_decode_attention import split_emulation  # noqa: E402


def _split_inputs(quant: bool, bs: int, t: int, seed: int = 5):
    """B=4 rows over a shuffled table of t blocks of bs: row 0 a short valid
    prefix, row 1 valid keys only in its last tile, row 2 no valid key and a
    table ending in sentinels, row 3 random; pools of 4 t + 3 blocks."""
    rng = np.random.default_rng(seed)
    pool = 4 * t + 3
    n = t * bs
    q = rng.standard_normal((4, KVH * NREP, D)).astype(np.float32)
    kp = rng.standard_normal((pool, bs, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((pool, bs, KVH, D)).astype(np.float32)
    table = rng.permutation(pool)[: 4 * t].reshape(4, t).astype(np.int32)
    table[2, t // 2:] = pool  # sentinels: they clamp to the last block
    valid = np.zeros((4, n), np.int32)
    valid[0, :5] = 1
    valid[1, n - 6:] = 1
    valid[3] = rng.random(n) < 0.6
    ks = vs = None
    if quant:
        kp = np.clip(np.round(kp * 16), -127, 127).astype(np.int8)
        vp = np.clip(np.round(vp * 16), -127, 127).astype(np.int8)
        ks = (np.abs(rng.standard_normal((pool, bs, KVH, 1))) + 0.01).astype(np.float32)
        vs = (np.abs(rng.standard_normal((pool, bs, KVH, 1))) + 0.01).astype(np.float32)
    return q, kp, vp, table, valid, ks, vs


# (block size, table width, splits, tiles a split).  Block size 8: 240 keys
# in 4 tiles, split 1, 2 even, and a ragged last split.  Block size 128:
# 384 keys in 6 tiles, a split a whole number of 2-tile blocks (3 even, 2
# with a ragged last).
PAGED_SPLITS = [(8, 30, 1, 4), (8, 30, 2, 2), (8, 30, 2, 3), (128, 3, 3, 2), (128, 3, 2, 4)]


@pytest.mark.parametrize("bs,t,splits,split_tiles", PAGED_SPLITS)
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_split_algebra_matches_the_jax_kernel_and_the_plain_version(quant, bs, t, splits,
                                                                     split_tiles):
    """The split, skip, merge and closed-form row of the CUDA kernel over
    the gathered, clamped view give the JAX kernel's answer (interpret
    mode) and the plain version's, to 1e-6 of the output's scale in f32."""
    assert split_tiles % port_pa.block_unit_tiles(bs) == 0
    q, kp, vp, table, valid, ks, vs = _split_inputs(quant, bs, t)
    opt = {} if ks is None else {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    args = [jnp.asarray(x) for x in (q, kp, vp, table, valid)]
    want_jax = np.asarray(jax_pa.paged_decode_attention(*args, bs, **opt, interpret=True))
    tq, tk, tv, tt, tvalid = (torch.from_numpy(x) for x in (q, kp, vp, table, valid))
    tks, tvs = (None, None) if ks is None else (torch.from_numpy(ks), torch.from_numpy(vs))
    want_ref = port_pa.paged_attention_ref(tq, tk, tv, tt, tvalid, bs, tks, tvs).numpy()

    def view(x):
        return None if x is None else port_pa.gather_pages(x, tt, bs)

    got = split_emulation(tq, view(tk), view(tv), tvalid, splits, split_tiles,
                          view(tks), view(tvs)).numpy()
    assert np.isfinite(got).all()
    # 1e-6 of the output's scale: f32 summation order (the int8 pools'
    # outputs reach ~100)
    atol = 1e-6 * max(1.0, float(np.abs(want_ref).max()))
    np.testing.assert_allclose(got, want_jax, atol=atol, rtol=1e-6)
    np.testing.assert_allclose(got, want_ref, atol=atol, rtol=1e-6)


def test_a_cached_signature_still_checks_the_data(monkeypatch):
    """The plan is built once per signature (block size included); a later
    call with the same signature but a pool that is not 16-byte aligned
    still raises."""
    monkeypatch.setattr(port_pa, "_paged_plans", {})
    calls = []
    check = port_pa._check
    monkeypatch.setattr(port_pa, "_check", lambda *a: calls.append(1) or check(*a))
    n = POOL * BS * KVH * D
    base = torch.zeros(n + 16, dtype=torch.bfloat16)
    ok = base[8:8 + n].view(POOL, BS, KVH, D)
    bad = base[1:1 + n].view(POOL, BS, KVH, D)
    q = torch.zeros(B, KVH * NREP, D, dtype=torch.bfloat16)
    table = torch.zeros(B, T, dtype=torch.int32)
    valid = torch.ones(B, T * BS, dtype=torch.int32)
    plan = port_pa._paged_plan(q, ok, ok, table, valid, BS)
    assert port_pa._paged_plan(q, ok, ok, table, valid, BS) is plan and len(calls) == 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_pa._paged_plan(q, ok, bad, table, valid, BS)
    assert len(calls) == 1
