"""The port's decode_attention (CPU: its plain version) against the JAX
package's Pallas decode kernel run in interpret mode, on the same numpy
inputs: grouped-query widths 1 and 4, dense f32 and the int8 cache built
by the JAX package's own ``kv_quantize``, random masks with one
all-masked row, and a cache length (40) that is no multiple of a tile.
Tolerance atol=rtol=2e-5 in f32, the JAX package's own kernel tolerance
(tests/test_ops.py)."""

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


def _both(q, k, v, mask, ks, vs):
    want = jax_decode_attention(
        *(jnp.asarray(x) for x in (q, k, v, mask)),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True,
    )
    got = port_attention.decode_attention(
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
