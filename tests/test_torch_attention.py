"""The port's fused_attention (CPU: its plain version) against the JAX
package's Pallas kernel run in interpret mode, on the same numpy inputs.
Tolerance atol=rtol=2e-5 in f32, the JAX package's own kernel tolerance
(tests/test_ops.py); the kernel's key-tile skip (a row's keys in tiles with
no valid key dropped) against the whole row within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlmicroservicetemplate_tpu.ops.attention import fused_attention as jax_fused_attention
from mlmicroservicetemplate_tpu_torch.ops import attention as port_attention

TOL = dict(atol=2e-5, rtol=2e-5)


def _both(q, k, v, mask, bias=None, scale=None):
    want = jax_fused_attention(
        *(jnp.asarray(x) for x in (q, k, v, mask)),
        bias=None if bias is None else jnp.asarray(bias), scale=scale, interpret=True,
    )
    got = port_attention.fused_attention(
        *(torch.from_numpy(x) for x in (q, k, v, mask)),
        bias=None if bias is None else torch.from_numpy(bias), scale=scale,
    )
    return np.asarray(want), got.numpy()


def _qkv(rng, b, s, h, d):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s,d,h", [(32, 16, 2), (128, 64, 4)])
def test_matches_jax_with_padded_row(s, d, h):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 3, s, h, d)
    mask = np.ones((3, s), np.int32)
    mask[1, s // 2:] = 0
    launches = port_attention.fused_attention.launches
    want, got = _both(q, k, v, mask)
    np.testing.assert_allclose(got, want, **TOL)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert port_attention.fused_attention.launches == launches


def test_all_masked_row_is_uniform_average():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 32, 2, 16)
    mask = np.ones((2, 32), np.int32)
    mask[0] = 0
    want, got = _both(q, k, v, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    uniform = np.broadcast_to(v[0].mean(axis=0, keepdims=True), v[0].shape)
    np.testing.assert_allclose(got[0], uniform, **TOL)


def test_bias_with_unit_scale():
    rng = np.random.default_rng(2)
    s, h, d = 64, 4, 16
    q, k, v = _qkv(rng, 2, s, h, d)
    bias = rng.standard_normal((1, h, s, s)).astype(np.float32)
    mask = np.ones((2, s), np.int32)
    mask[0, s - 5:] = 0
    want, got = _both(q, k, v, mask, bias=bias, scale=1.0)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_version_matches_mha_attention():
    """fused_attention_ref is the same function as common.mha_attention
    with a broadcast key mask (the two attention paths of the layer)."""
    from mlmicroservicetemplate_tpu_torch.models.common import mha_attention

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 2, 32, 2, 64))
    mask = torch.ones(2, 32, dtype=torch.int32)
    mask[1, 20:] = 0
    got = port_attention.fused_attention_ref(q, k, v, mask)
    want = mha_attention(q, k, v, mask=mask[:, None, None, :].bool())
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda q, m: (q.to(torch.float16), m), TypeError),
        (lambda q, m: (q[..., :32], m), ValueError),
        (lambda q, m: (q, m[:, :16]), ValueError),
    ],
)
def test_kernel_wrapper_rejects_inputs_it_does_not_take(change, err):
    """The checks that guard the CUDA launch raise on what the kernel does
    not take (run directly: the CPU has no kernel to reach)."""
    q = torch.zeros(2, 32, 2, 64)
    mask = torch.ones(2, 32, dtype=torch.int32)
    q2, m2 = change(q, mask)
    with pytest.raises(err):
        port_attention._check(q2, q2, q2, m2, None)


@pytest.mark.parametrize("layout", ["interior", "tail"])
def test_attention_without_fully_masked_tiles_equals_the_whole_row(layout):
    """The kernel's skip: a batch row with a valid key, attended over only
    its key tiles (8 keys here, 128 in the kernel) that hold one, gives the
    JAX kernel's attention over every key: masked keys weigh exp(-1e9 - m)
    = 0 once the row max is a valid key's."""
    rng = np.random.default_rng(4)
    b, s, h, d, tile = 2, 32, 2, 16, 8
    q, k, v = _qkv(rng, b, s, h, d)
    mask = np.zeros((b, s), np.int32)
    mask[0, 1:6] = 1
    mask[1, :7] = 1
    if layout == "interior":
        mask[0, 26:31] = 1  # tiles 1 and 2 of row 0 hold no valid key
    want, whole = _both(q, k, v, mask)
    for row in range(b):
        live = mask[row].reshape(-1, tile).any(axis=1).repeat(tile)
        assert not live.all()
        got = port_attention.fused_attention_ref(
            torch.from_numpy(q[row:row + 1]),
            *(torch.from_numpy(np.ascontiguousarray(x[row:row + 1, live])) for x in (k, v)),
            torch.from_numpy(mask[row:row + 1, live]),
        ).numpy()[0]
        np.testing.assert_allclose(got, whole[row], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, want[row], **TOL)


def test_kernel_wrapper_rejects_a_row_past_the_key_bitmap():
    q = torch.zeros(1, port_attention.MAX_SEQ + 1, 1, 64)
    with pytest.raises(ValueError, match="keys"):
        port_attention._check(q, q, q, torch.ones(1, q.shape[1], dtype=torch.int32), None)
