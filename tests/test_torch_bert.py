"""Small BERT: the port's classify against the JAX package's, on the JAX
init_params(PRNGKey(0)) weights carried across by bert_params_from_jax.
f32 on the CPU with padded rows; atol 1e-4 (two layers of f32 products
summed in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlmicroservicetemplate_tpu.models import bert as jax_bert
from mlmicroservicetemplate_tpu.ops import attention as jax_attention
from mlmicroservicetemplate_tpu_torch.convert.jax_params import bert_params_from_jax
from mlmicroservicetemplate_tpu_torch.models import bert as port_bert

JAX_CFG = jax_bert.BertConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128
)
PORT_CFG = port_bert.BertConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128
)


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, jax_bert.init_params(jax.random.PRNGKey(0), JAX_CFG))
    model = port_bert.build_model(
        PORT_CFG, bert_params_from_jax(params, PORT_CFG), torch.device("cpu"), torch.float32
    )
    return params, model


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1000, (3, 32)).astype(np.int32)
    mask = np.ones((3, 32), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("use_pallas", [True, False])
def test_classify_matches_jax(weights, monkeypatch, use_pallas):
    params, model = weights
    ids, mask = _inputs()
    if use_pallas:
        # Run the JAX kernel path in interpret mode on the CPU, as
        # tests/test_ops.py does.
        orig = jax_attention.fused_attention

        def interp(*a, **kw):
            kw["interpret"] = True
            return orig(*a, **kw)

        monkeypatch.setattr(jax_attention, "fused_attention", interp)
    want = jax_bert.classify(
        params, JAX_CFG, jnp.asarray(ids), jnp.asarray(mask), use_pallas=use_pallas
    )
    with torch.inference_mode():
        got = model.classify(
            torch.from_numpy(ids), torch.from_numpy(mask), use_kernel=use_pallas
        )
    assert got.dtype == torch.float32 and got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_kernel_and_plain_attention_paths_agree(weights):
    _, model = weights
    ids, mask = (torch.from_numpy(x) for x in _inputs())
    with torch.inference_mode():
        a = model.encode(ids, mask, use_kernel=True)
        b = model.encode(ids, mask, use_kernel=False)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_carry_across_rejects_missing_leaf(weights):
    params, _ = weights
    broken = jax.tree.map(lambda x: x, params)
    del broken["layers"][1]["mlp"]["down"]["bias"]
    with pytest.raises(KeyError, match="layers.1.mlp.down.bias"):
        bert_params_from_jax(broken, PORT_CFG)


def test_carry_across_rejects_unused_leaf(weights):
    params, _ = weights
    extra = jax.tree.map(lambda x: x, params)
    extra["pooler"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="pooler.extra"):
        bert_params_from_jax(extra, PORT_CFG)


def test_carry_across_transposes_dense_kernels(weights):
    params, _ = weights
    state = bert_params_from_jax(params, PORT_CFG)
    np.testing.assert_array_equal(
        state["layers.0.mlp.up.weight"].numpy(), params["layers"][0]["mlp"]["up"]["kernel"].T
    )
    np.testing.assert_array_equal(
        state["embeddings.word.weight"].numpy(), params["embeddings"]["word"]["embedding"]
    )
