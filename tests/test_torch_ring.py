"""Ring attention (K4's plain version, the ring, the placement) against the
JAX package's, on the same numpy inputs, f32 on the CPU.

- ``ring_hop_ref`` against the JAX ``_hop_pallas`` in interpret mode (as
  ``tests/test_ring.py`` runs the Pallas path): fresh and mid-ring carried
  states, a partly padded row and a block with no valid key, D = 16 and
  64; o, m and l within 1e-5 (f32, products summed in another order).
- The hop's ``fresh`` and ``out`` arguments against ``_hop_pallas`` from
  (0, -inf, 0) and followed by ``o / max(l, 1e-20)``; the kernel's key-tile
  skip (keys of tiles with no valid key dropped) against the whole block;
  a block with no valid key against its algebra (m <= -1e9: o + sum v,
  l + S; m > -1e9: unchanged); the wrapper's checks of the new arguments.
- ``ring_attention`` over 1, 2, 4 and 8 CPU shards against the JAX ring
  over the 8-device mesh and against dense attention, within 1e-5; bf16
  within 2e-2 (the output's rounding to bf16); a row masked in every hop.
- ``SeqParallelSet`` / ``make_sp_devices``: the JAX placement contract.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mlmicroservicetemplate_tpu.models.common import mha_attention
from mlmicroservicetemplate_tpu.parallel.ring import _hop_pallas, make_ring_attention
from mlmicroservicetemplate_tpu_torch.parallel import ring as port_ring
from mlmicroservicetemplate_tpu_torch.parallel import (
    SeqParallelSet,
    make_sp_devices,
    ring_attention,
    ring_hop,
    ring_hop_ref,
)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes on
    shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hop_inputs(d: int, state: str, seed: int = 0):
    """q, k, v [2, 24, 2, d] (S = 24: no multiple of a 64-key tile), a key
    mask with row 0 padded from key 10 and row 1 without a valid key, and a
    carried (o, m, l): fresh (0, -inf, 0) or mid-ring (random o, finite m,
    positive l)."""
    rng = np.random.default_rng(seed)
    b, s, h = 2, 24, 2
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, 10:] = 0
    mask[1] = 0
    if state == "fresh":
        o = np.zeros((b, h, s, d), np.float32)
        m = np.full((b, h, s), -np.inf, np.float32)
        l = np.zeros((b, h, s), np.float32)
    else:
        o = rng.standard_normal((b, h, s, d)).astype(np.float32)
        m = rng.standard_normal((b, h, s)).astype(np.float32)
        l = rng.uniform(0.5, 2.0, (b, h, s)).astype(np.float32)
    return q, k, v, mask, o, m, l


def _jax_hop(q, k, v, mask, o, m, l, scale):
    out = _hop_pallas(*(jnp.asarray(x) for x in (q, k, v, mask, o, m, l)),
                      scale=scale, interpret=True)
    return [np.asarray(x) for x in out]


def _port_hop(q, k, v, mask, o, m, l, scale, hop=ring_hop_ref):
    out = hop(*(torch.from_numpy(np.array(x)) for x in (q, k, v, mask, o, m, l)), scale)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("state", ["fresh", "mid"])
@pytest.mark.parametrize("d", [16, 64])
def test_ring_hop_ref_matches_jax_hop(d, state):
    args = _hop_inputs(d, state)
    scale = 1.0 / math.sqrt(d)
    want = _jax_hop(*args, scale)
    got = _port_hop(*args, scale)
    for name, g, w in zip("oml", got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    if state == "fresh":  # no valid key: every key weighs exp(0), m is the mask value
        np.testing.assert_array_equal(got[1][1], -1e9)
        np.testing.assert_array_equal(got[2][1], 24.0)


@pytest.mark.parametrize("order", ["masked_then_valid", "valid_then_masked"])
def test_ring_hop_chain_with_a_masked_block_matches_jax(order):
    """Three hops from a fresh state where row 1 meets a block with no
    valid key before (or after) blocks with valid ones: the carried state
    after every hop equals the JAX kernel's."""
    q, k, v, _, o, m, l = _hop_inputs(64, "fresh", seed=1)
    rng = np.random.default_rng(2)
    blocks = []
    for i in range(3):
        kb, vb = (rng.standard_normal(k.shape).astype(np.float32) for _ in range(2))
        mask = np.ones((2, 24), np.int32)
        mask[0, 5 + i:] = 0
        masked_hop = 0 if order == "masked_then_valid" else 2
        if i == masked_hop:
            mask[1] = 0
        blocks.append((kb, vb, mask))
    scale = 1.0 / 8.0
    want, got = (o, m, l), (o, m, l)
    for kb, vb, mask in blocks:
        want = _jax_hop(q, kb, vb, mask, *want, scale)
        got = _port_hop(q, kb, vb, mask, *got, scale)
        for name, g, w in zip("oml", got, want):
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_ring_hop_wrapper_takes_the_plain_version_on_cpu():
    args = _hop_inputs(64, "mid")
    before = ring_hop.launches
    got = _port_hop(*args, 0.125, hop=ring_hop)
    want = _port_hop(*args, 0.125)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ring_hop.launches == before


def test_ring_hop_wrapper_rejects_other_devices():
    t = torch.zeros(1, 4, 1, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ring_hop(t, t, t, torch.ones(1, 4, device="meta"), t, t, t, 0.125)


def _normalised(o, l):
    """The ring's output from a carried state: [B, S, H, D] of o / max(l, 1e-20)."""
    return np.swapaxes(o / np.maximum(l, 1e-20)[..., None], 1, 2)


@pytest.mark.parametrize("final", [False, True])
def test_fresh_hop_matches_jax_hop_from_the_empty_state(final):
    """``fresh=True`` ignores whatever o, m, l hold and starts from (0, -inf,
    0); with ``out`` the hop writes o / max(l, 1e-20) and returns it."""
    q, k, v, mask, o, m, l = _hop_inputs(64, "fresh", seed=3)
    want = _jax_hop(q, k, v, mask, o, m, l, 0.125)
    junk = [torch.full(x.shape, 7.0) for x in (o, m, l)]
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    if final:
        out = torch.empty(q.shape)
        got = ring_hop_ref(*args, None, None, None, 0.125, fresh=True, out=out)
        assert got is out
        np.testing.assert_allclose(out.numpy(), _normalised(want[0], want[2]), **TOL)
    else:
        got = ring_hop_ref(*args, *junk, 0.125, fresh=True)
        for name, g, w in zip("oml", got, want):
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("order", ["masked_then_valid", "valid_then_masked"])
def test_chain_with_fresh_first_and_out_last_matches_jax(order):
    """Three hops as the ring runs them (fresh, carried, out) against the
    JAX kernel's three hops from (0, -inf, 0) and the normalisation after;
    row 1 meets a block with no valid key first or last."""
    q, k, v, _, o, m, l = _hop_inputs(64, "fresh", seed=4)
    rng = np.random.default_rng(5)
    blocks = []
    for i in range(3):
        kb, vb = (rng.standard_normal(k.shape).astype(np.float32) for _ in range(2))
        mask = np.ones((2, 24), np.int32)
        mask[0, 3 + 2 * i:] = 0
        if i == (0 if order == "masked_then_valid" else 2):
            mask[1] = 0
        blocks.append((kb, vb, mask))
    want = (o, m, l)
    for kb, vb, mask in blocks:
        want = _jax_hop(q, kb, vb, mask, *want, 0.125)
    tq = torch.from_numpy(q)
    state = (None, None, None)
    for i, (kb, vb, mask) in enumerate(blocks[:2]):
        state = ring_hop_ref(tq, *(torch.from_numpy(x) for x in (kb, vb, mask)), *state,
                             0.125, fresh=i == 0)
    out = torch.empty(q.shape)
    ring_hop_ref(tq, *(torch.from_numpy(x) for x in blocks[2]), *state, 0.125, out=out)
    np.testing.assert_allclose(out.numpy(), _normalised(want[0], want[2]), **TOL)


def _tiled_mask(layout: str) -> np.ndarray:
    """[2, 32] key masks in tiles of 8 keys (the kernel's 128 scaled down):
    row 0 valid in tiles 0 and 3 with tiles 1-2 fully masked (an interior
    run); row 1 valid in tile 0 only, a masked tail."""
    mask = np.zeros((2, 32), np.int32)
    mask[0, 2:7] = 1
    mask[0, 25:30] = 1
    mask[1, :5] = 1
    if layout == "tail":
        mask[0, 8:] = 0
    return mask


@pytest.mark.parametrize("state", ["fresh", "mid"])
@pytest.mark.parametrize("layout", ["interior", "tail"])
def test_hop_without_fully_masked_tiles_equals_the_whole_block(layout, state):
    """The kernel's skip: a batch row with a valid key, hopped over only its
    tiles that hold one, gives the JAX hop over the whole block (masked keys
    weigh exp(-1e9 - m) = 0, whatever the carried state)."""
    rng = np.random.default_rng(6)
    b, s, h, d, tile = 2, 32, 2, 16, 8
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = _tiled_mask(layout)
    if state == "fresh":
        o = np.zeros((b, h, s, d), np.float32)
        m = np.full((b, h, s), -np.inf, np.float32)
        l = np.zeros((b, h, s), np.float32)
    else:
        o = rng.standard_normal((b, h, s, d)).astype(np.float32)
        m = rng.standard_normal((b, h, s)).astype(np.float32)
        l = rng.uniform(0.5, 2.0, (b, h, s)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    want = _jax_hop(q, k, v, mask, o, m, l, scale)
    whole = _port_hop(q, k, v, mask, o, m, l, scale)
    for row in range(b):
        live = mask[row].reshape(-1, tile).any(axis=1).repeat(tile)  # keys of kept tiles
        assert not live.all()  # something is skipped
        kept = [torch.from_numpy(np.ascontiguousarray(x[row:row + 1, live]))
                for x in (k, v)]
        got = ring_hop_ref(torch.from_numpy(q[row:row + 1]), *kept,
                           torch.from_numpy(mask[row:row + 1, live]),
                           *(torch.from_numpy(x[row:row + 1]) for x in (o, m, l)), scale)
        for name, g, w, p in zip("oml", got, want, whole):
            np.testing.assert_allclose(g.numpy()[0], p[row], rtol=1e-6, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(g.numpy()[0], w[row], err_msg=name, **TOL)


def test_block_without_a_valid_key_follows_its_algebra():
    """No valid key in the block: every score is -1e9, so a query row whose
    carried m is at most -1e9 (-inf fresh, or -1e9 after such blocks) ends
    at m = -1e9, l = l·corr + S, o = o·corr + sum v (corr 0 from -inf, 1
    from -1e9), and a row with m > -1e9 keeps its state exactly: the JAX
    hop and the plain hop both."""
    rng = np.random.default_rng(7)
    b, s, h, d = 1, 24, 2, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, s), np.int32)
    o = rng.standard_normal((b, h, s, d)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (b, h, s)).astype(np.float32)
    m = rng.standard_normal((b, h, s)).astype(np.float32)
    m[:, :, :8] = -np.inf
    m[:, :, 8:16] = -1e9
    o[:, :, :8], l[:, :, :8] = 0.0, 0.0
    sum_v = v.sum(axis=1)[:, :, None, :]  # [1, H, 1, D]
    want_o, want_m, want_l = o.copy(), m.copy(), l.copy()
    want_o[:, :, :8] = np.broadcast_to(sum_v, want_o[:, :, :8].shape)
    want_o[:, :, 8:16] += sum_v
    want_m[:, :, :16] = -1e9
    want_l[:, :, :8] = s
    want_l[:, :, 8:16] += s
    for hop in (_jax_hop, _port_hop):
        got = hop(q, k, v, mask, o, m, l, 0.25)
        np.testing.assert_array_equal(got[1], want_m)
        np.testing.assert_allclose(got[2], want_l, rtol=1e-6)
        np.testing.assert_allclose(got[0], want_o, **TOL)
        # m > -1e9: corr = exp(0) = 1 and every p = 0, bit for bit
        np.testing.assert_array_equal(got[0][:, :, 16:], o[:, :, 16:])
        np.testing.assert_array_equal(got[2][:, :, 16:], l[:, :, 16:])


def _check_args(**change):
    b, s, h, d = 1, 8, 2, 64
    q = torch.zeros(b, s, h, d)
    args = dict(q=q, k=q, v=q, mask=torch.ones(b, s, dtype=torch.int32),
                o=torch.zeros(b, h, s, d), m=torch.zeros(b, h, s), l=torch.zeros(b, h, s),
                fresh=False, out=None)
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change,err",
    [
        (dict(fresh=False, o=None), "unless fresh"),
        (dict(out=torch.zeros(1, 8, 2, 32)), "out must be"),
        (dict(out=torch.zeros(1, 2, 8, 64)), "out must be"),
        (dict(out=torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)), "out must be"),
        (dict(out=torch.zeros(1, 8, 2, 128)[..., ::2]), "unit head_dim"),
    ],
    ids=["fresh_false_without_o", "out_head_dim", "out_layout", "out_dtype", "out_strides"],
)
def test_ring_hop_wrapper_rejects_bad_fresh_and_out(change, err):
    """The checks that guard the CUDA launch (run directly: the CPU has no
    kernel to reach)."""
    with pytest.raises(ValueError, match=err):
        port_ring._check(**_check_args(**change))


@pytest.mark.parametrize("final", [False, True])
def test_ring_hop_checks_accept_a_fresh_hop_without_state(final):
    """A fresh hop reads no state: the last one writes only ``out``, an
    earlier one gets new o, m, l from the wrapper."""
    out = torch.zeros(1, 8, 2, 64) if final else None
    port_ring._check(**_check_args(fresh=True, o=None, m=None, l=None, out=out))


B, S, H, D = 2, 64, 4, 16


def _ring_inputs():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    mask[0, 50:] = 0
    return q, k, v, mask


@pytest.fixture(scope="module")
def jax_ring(cpu_devices):
    mesh = Mesh(np.array(cpu_devices).reshape(8), ("sp",))
    ring = make_ring_attention(mesh)
    q, k, v, mask = _ring_inputs()
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    return {
        "mesh": mesh,
        "f32": np.asarray(jax.jit(ring)(jq, jk, jv, jm)),
        "dense": np.asarray(mha_attention(jq, jk, jv, mask=jm[:, None, None, :].astype(bool))),
        "bf16": np.asarray(jax.jit(ring)(*(x.astype(jnp.bfloat16) for x in (jq, jk, jv)), jm)
                           .astype(jnp.float32)),
    }


def _port_ring(n: int, q, k, v, mask, dtype=torch.float32) -> np.ndarray:
    shards = [torch.from_numpy(x).to(dtype).chunk(n, dim=1) for x in (q, k, v)]
    out = ring_attention(*shards, torch.from_numpy(mask).chunk(n, dim=1))
    assert len(out) == n and all(o.dtype == dtype for o in out)
    return torch.cat(out, dim=1).float().numpy()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_attention_matches_jax_ring_and_dense(jax_ring, n):
    got = _port_ring(n, *_ring_inputs())
    np.testing.assert_allclose(got, jax_ring["f32"], **TOL)
    np.testing.assert_allclose(got, jax_ring["dense"], **TOL)


def test_ring_attention_matches_jax_pallas_ring(jax_ring):
    """The JAX ring with its Pallas hop (interpret mode), 8 devices."""
    ring = make_ring_attention(jax_ring["mesh"])
    q, k, v, mask = _ring_inputs()
    want = np.asarray(jax.jit(lambda *a: ring(*a, use_pallas=True, interpret=True))(
        *(jnp.asarray(x) for x in (q, k, v, mask))))
    np.testing.assert_allclose(_port_ring(8, q, k, v, mask), want, **TOL)


def test_ring_attention_bf16_matches_jax(jax_ring):
    got = _port_ring(8, *_ring_inputs(), dtype=torch.bfloat16)
    np.testing.assert_allclose(got, jax_ring["bf16"], atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("n", [1, 4])
def test_row_masked_in_every_hop_is_the_mean_of_v(n):
    q, k, v, mask = _ring_inputs()
    mask[1] = 0
    got = _port_ring(n, q, k, v, mask)
    assert np.isfinite(got).all()
    want = np.broadcast_to(v[1].mean(axis=0, keepdims=True), got[1].shape)
    np.testing.assert_allclose(got[1], want, **TOL)


@pytest.mark.parametrize("n", [1, 3])
def test_ring_attention_hops_fresh_first_and_into_the_output_last(n):
    """One shard: one hop, fresh and final, no carried state handed in. n
    shards: n² hops, the first n fresh, the last n writing the output."""
    calls = []

    def spy(q, k, v, mask, o, m, l, scale, *, fresh=False, out=None):
        calls.append((fresh, out is not None, o is None))
        return ring_hop_ref(q, k, v, mask, o, m, l, scale, fresh=fresh, out=out)

    q, k, v, mask = _ring_inputs()
    shards = [torch.from_numpy(x[:, :48]).chunk(n, dim=1) for x in (q, k, v)]
    ring_attention(*shards, torch.from_numpy(mask[:, :48]).chunk(n, dim=1), hop=spy)
    assert len(calls) == n * n
    assert calls[:n] == [(True, n == 1, True)] * n
    assert calls[-n:] == [(n == 1, True, n == 1)] * n
    assert all(c == (False, False, False) for c in calls[n:-n])


def test_ring_attention_rejects_mismatched_shard_lists():
    q = [torch.zeros(1, 4, 1, 16)] * 2
    with pytest.raises(ValueError, match="shards"):
        ring_attention(q, q[:1], q, [torch.ones(1, 4)] * 2)


def test_seq_parallel_set_contract():
    sps = SeqParallelSet(make_sp_devices("cpu", 8))
    assert sps.n_devices == 8 and sps.seq_multiple() == 8
    a = np.arange(2 * 64, dtype=np.int32).reshape(2, 64)
    shards = sps.place_batch(a)
    assert [tuple(s.shape) for s in shards] == [(2, 8)] * 8
    np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy(), a)
    with pytest.raises(ValueError, match="divide"):
        sps.place_batch(np.zeros((2, 60), np.int32))


def test_place_params_makes_one_replica_per_distinct_device():
    made = []
    sps = SeqParallelSet([torch.device("cpu")] * 4)
    replicas = sps.place_params(lambda dev: made.append(dev) or object())
    assert made == [torch.device("cpu")]
    assert len(replicas) == 4 and all(r is replicas[0] for r in replicas)


def test_make_sp_devices_on_the_cpu():
    assert make_sp_devices("cpu", 0) == [torch.device("cpu")]
    assert make_sp_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_sp_devices("cpu", -1)


def test_make_sp_devices_on_cuda_counts_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_sp_devices("cuda", 0) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert make_sp_devices("cuda", 1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="SP=3 but only 2 devices visible"):
        make_sp_devices("cuda", 3)
