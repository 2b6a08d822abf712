"""The port's decode_attention (CPU: its plain version) against the JAX
package's Pallas decode kernel run in interpret mode, on the same numpy
inputs: grouped-query widths 1 and 4, dense f32 and the int8 cache built
by the JAX package's own ``kv_quantize``, random masks with one
all-masked row, and a cache length (40) that is no multiple of a tile.
Tolerance atol=rtol=2e-5 in f32, the JAX package's own kernel tolerance
(tests/test_ops.py)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlmicroservicetemplate_tpu.models.common import kv_quantize as jax_kv_quantize
from mlmicroservicetemplate_tpu.ops.attention import decode_attention as jax_decode_attention
from mlmicroservicetemplate_tpu_torch.models.common import mha_attention, repeat_kv
from mlmicroservicetemplate_tpu_torch.ops import attention as port_attention

TOL = dict(atol=2e-5, rtol=2e-5)
B, T, KVH, D = 3, 40, 2, 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores, and these tests are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int, n_rep: int, quant: bool):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH * n_rep, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KVH, D)).astype(np.float32) for _ in range(2))
    mask = (rng.random((B, T)) < 0.7).astype(np.int32)
    mask[1] = 0  # an all-masked row, as a padded batch row is
    if not quant:
        return q, k, v, mask, None, None
    k8, ks = (np.array(a) for a in jax_kv_quantize(jnp.asarray(k)))
    v8, vs = (np.array(a) for a in jax_kv_quantize(jnp.asarray(v)))
    return q, k8, v8, mask, ks, vs


def _both(q, k, v, mask, ks, vs, ref=False):
    """The JAX kernel's answer (interpret mode) and the port's: the CPU
    wrapper's, or with ``ref`` its plain version's."""
    want = jax_decode_attention(
        *(jnp.asarray(x) for x in (q, k, v, mask)),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True,
    )
    port = port_attention.decode_attention_ref if ref else port_attention.decode_attention
    got = port(
        *(torch.from_numpy(x) for x in (q, k, v, mask)),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs),
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_matches_jax_kernel_in_interpret_mode(n_rep, quant):
    q, k, v, mask, ks, vs = _inputs(n_rep + 10 * quant, n_rep, quant)
    launches = port_attention.decode_attention.launches
    want, got = _both(q, k, v, mask, ks, vs)
    assert got.shape == (B, KVH * n_rep, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert port_attention.decode_attention.launches == launches
    # The all-masked row is the uniform average of its group's V.
    vf = v.astype(np.float32) * (1.0 if vs is None else vs)
    uniform = np.repeat(vf[1].mean(axis=0), n_rep, axis=0)  # [H, D]
    np.testing.assert_allclose(got[1], uniform, **TOL)


def test_plain_version_is_the_repeated_kv_attention():
    """decode_attention_ref is mha_attention over the GQA-repeated cache
    for a single query (the two paths the JAX package pins equal)."""
    q, k, v, mask, _, _ = _inputs(7, 4, False)
    qt, kt, vt, mt = (torch.from_numpy(x) for x in (q, k, v, mask))
    got = port_attention.decode_attention_ref(qt, kt, vt, mt)
    want = mha_attention(qt[:, None], repeat_kv(kt, 4), repeat_kv(vt, 4),
                         mask=mt[:, None, None, :].bool())[:, 0]
    torch.testing.assert_close(got, want, **TOL)


def _bad(change):
    q = torch.zeros(2, 8, 64)
    k = torch.zeros(2, 24, 2, 64)
    mask = torch.ones(2, 24, dtype=torch.int32)
    scales = (None, None)
    return change(q, k, mask, scales)


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda q, k, m, s: (q.half(), k, k, m, *s), TypeError),  # q type
        (lambda q, k, m, s: (q, k.bfloat16(), k.bfloat16(), m, *s), TypeError),  # dense type
        (lambda q, k, m, s: (q, k.to(torch.int8), k.to(torch.int8), m, *s), TypeError),
        (lambda q, k, m, s: (q[..., :32], k[..., :32], k[..., :32], m, *s), ValueError),
        (lambda q, k, m, s: (q[:, :7], k, k, m, *s), ValueError),  # 7 heads over 2
        (lambda q, k, m, s: (q, k, k, m[:, :16], *s), ValueError),  # mask shape
        (lambda q, k, m, s: (q, k, k[:, :20], m, *s), ValueError),  # k/v shapes
        (lambda q, k, m, s: (q, k.to(torch.int8), k.to(torch.int8), m,
                             torch.ones(2, 24, 2), torch.ones(2, 24, 2)), ValueError),
        (lambda q, k, m, s: (q, k.to(torch.int8), k.to(torch.int8), m,
                             torch.ones(2, 24, 2, 1), torch.ones(2, 24, 2, 1).half()),
         TypeError),
    ],
)
def test_kernel_wrapper_rejects_inputs_it_does_not_take(change, err):
    """The checks that guard the CUDA launch raise on what the kernel does
    not take (run directly: the CPU has no kernel to reach)."""
    with pytest.raises(err):
        port_attention._check_decode(*_bad(change))


# ---------------------------------------------------------------------------
# The kernels' split (csrc/decode_sm90.cuh), emulated in plain PyTorch


def split_emulation(q, k, v, keep, splits, split_tiles, k_scale=None, v_scale=None):
    """The decode kernels' algebra in f32: keys split into ``splits`` runs of
    ``split_tiles`` 64-key tiles; a row with a valid key walks only the
    tiles that hold one (online softmax, invalid keys at -inf) and a split
    with none gives the empty state (m = -inf, l = 0); a row with none gives
    each split (sum v, m = 0, l = count), its plain mean after the merge;
    the merge weighs split s by exp(m_s - max m).  q [B, H, D]; k, v
    [B, N, KVH, D] (for the paged kernel the gathered view); keep [B, N]."""
    b, h, d = q.shape
    n, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    span = split_tiles * 64
    assert (splits - 1) * span < n <= splits * span and split_tiles <= 16
    kf = k.float() if k_scale is None else k.float() * k_scale.float()
    vf = v.float() if v_scale is None else v.float() * v_scale.float()
    qf = q.float() / math.sqrt(d)
    out = torch.empty(b, h, d)
    for bi in range(b):
        valid = keep[bi] != 0
        row_any = bool(valid.any())
        for g in range(kvh):
            qg = qf[bi, g * rep:(g + 1) * rep]
            parts = []
            for s in range(splits):
                k0, k1 = s * span, min(n, (s + 1) * span)
                if not row_any:
                    parts.append((vf[bi, k0:k1, g].sum(0).expand(rep, d), torch.zeros(rep),
                                  torch.full((rep,), float(k1 - k0))))
                    continue
                m = torch.full((rep,), -math.inf)
                l, o = torch.zeros(rep), torch.zeros(rep, d)
                for t0 in range(k0, k1, 64):
                    t1 = min(k1, t0 + 64)
                    if not valid[t0:t1].any():
                        continue  # a tile with no valid key is never loaded
                    sc = torch.where(valid[t0:t1], qg @ kf[bi, t0:t1, g].T, -math.inf)
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * alpha + p.sum(dim=1)
                    o = o * alpha[:, None] + p @ vf[bi, t0:t1, g]
                    m = m_new
                parts.append((o, m, l))
            top = torch.stack([m for _, m, _ in parts]).max(dim=0).values
            w = [torch.exp(m - top) for _, m, _ in parts]
            num = sum(wi[:, None] * o for wi, (o, _, _) in zip(w, parts))
            den = sum(wi * l for wi, (_, _, l) in zip(w, parts))
            out[bi, g * rep:(g + 1) * rep] = num / den[:, None]
    return out


ST = 200  # keys: three whole tiles and a ragged fourth


def _split_inputs(quant: bool, seed: int = 3):
    """B=4 rows over ST keys: row 0 a short valid prefix, row 1 valid keys
    only in the last tile, row 2 no valid key, row 3 random."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, KVH * 4, D)).astype(np.float32)
    k, v = (rng.standard_normal((4, ST, KVH, D)).astype(np.float32) for _ in range(2))
    mask = np.zeros((4, ST), np.int32)
    mask[0, :5] = 1
    mask[1, ST - 6:] = 1
    mask[3] = rng.random(ST) < 0.6
    if not quant:
        return q, k, v, mask, None, None
    k8, ks = (np.array(a) for a in jax_kv_quantize(jnp.asarray(k)))
    v8, vs = (np.array(a) for a in jax_kv_quantize(jnp.asarray(v)))
    return q, k8, v8, mask, ks, vs


# (splits, tiles a split) over 4 tiles: one split, two even, a ragged last
# split (3 tiles, then 8 keys), one tile each
SPLITS = [(1, 4), (2, 2), (2, 3), (4, 1)]


@pytest.mark.parametrize("splits,split_tiles", SPLITS)
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_split_algebra_matches_the_jax_kernel_and_the_plain_version(quant, splits,
                                                                     split_tiles):
    """The split, skip, merge and closed-form row of the CUDA kernels give
    the JAX kernel's answer (interpret mode) and the plain version's, to
    1e-6 of the output's scale in f32."""
    q, k, v, mask, ks, vs = _split_inputs(quant)
    want_jax, want_ref = _both(q, k, v, mask, ks, vs, ref=True)
    got = split_emulation(*(torch.from_numpy(x) for x in (q, k, v, mask)), splits, split_tiles,
                          None if ks is None else torch.from_numpy(ks),
                          None if vs is None else torch.from_numpy(vs)).numpy()
    assert np.isfinite(got).all()
    # 1e-6 of the output's scale: f32 summation order (the int8 pools'
    # outputs reach ~100)
    atol = 1e-6 * max(1.0, float(np.abs(want_ref).max()))
    np.testing.assert_allclose(got, want_jax, atol=atol, rtol=1e-6)
    np.testing.assert_allclose(got, want_ref, atol=atol, rtol=1e-6)
    vf = v.astype(np.float32) * (1.0 if vs is None else vs)  # row 2: the plain mean
    np.testing.assert_allclose(got[2], np.repeat(vf[2].mean(axis=0), 4, axis=0),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("n_keys", [1, 65, 576, 9000])
@pytest.mark.parametrize("unit", [1, 3, 16])
def test_split_plan_covers_every_key_in_whole_units(batch, n_keys, unit):
    """split_plan depends on shapes only; every split holds a key, the
    splits cover the keys, a split is a whole number of units of at most
    16 tiles, and a small grid splits toward two CTAs an SM (at least half
    the splits that would take, where the keys allow)."""
    splits, per = port_attention.split_plan(batch, 4, n_keys, unit)
    span = per * 64
    assert per % unit == 0 and 1 <= per <= port_attention.MAX_SPLIT_TILES
    assert (splits - 1) * span < n_keys <= splits * span
    units = -(-n_keys // (64 * unit))
    want = -(-port_attention.TARGET_CTAS // (batch * 4))
    assert 2 * splits >= min(units, want)


def test_a_cached_signature_still_checks_the_data(monkeypatch):
    """The wrapper's plan (shape, type and stride checks, strides, splits)
    is built once per signature; a later call with the same signature but
    a K row that is not 16-byte aligned still raises."""
    monkeypatch.setattr(port_attention, "_decode_plans", {})
    calls = []
    check = port_attention._check_decode
    monkeypatch.setattr(port_attention, "_check_decode",
                        lambda *a: calls.append(1) or check(*a))
    n = 2 * 24 * 2 * 64
    base = torch.zeros(n + 16, dtype=torch.bfloat16)
    k_ok = base[8:8 + n].view(2, 24, 2, 64)  # 16 bytes in
    k_bad = base[1:1 + n].view(2, 24, 2, 64)  # 2 bytes in: same signature
    assert k_ok.stride() == k_bad.stride() and k_ok.data_ptr() % 16 == 0
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    mask = torch.ones(2, 24, dtype=torch.int32)
    plan = port_attention._decode_plan(q, k_ok, k_ok, mask)
    assert port_attention._decode_plan(q, k_ok, k_ok, mask) is plan and len(calls) == 1
    assert (plan.splits, plan.split_tiles) == port_attention.split_plan(2, 2, 24)
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_attention._decode_plan(q, k_bad, k_ok, mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_attention._decode_plan(q, k_ok, k_bad, mask)
    assert len(calls) == 1  # the cached signature: only the data checks ran
