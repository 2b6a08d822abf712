"""The port's block-paged KV bookkeeping against the JAX package's: the
same sequence of calls on ``BlockPool`` and ``StreamBlocks`` hands out the
same ids, keeps the same counts, fails in the same places (``OutOfBlocks``
leaving nothing allocated, double frees), and ``blocks_for`` /
``kv_token_bytes`` agree."""

import pytest

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import kv_blocks as jax_kv
from mlmicroservicetemplate_tpu_torch.engine import kv_blocks as port_kv


def _script(kv) -> list:
    """Drive one implementation through the calls the port keeps; return
    everything a caller can observe."""
    log = []

    def note(tag, fn):
        try:
            out = fn()
        except Exception as e:  # the failure's type is part of the contract
            out = f"raised {type(e).__name__}"
        log.append((tag, out, pool.used_blocks, list(a.ids), list(b.ids)))

    pool = kv.BlockPool(10)
    a = kv.StreamBlocks(pool, block_size=4)
    b = kv.StreamBlocks(pool, block_size=4)
    note("alloc 3", lambda: pool.alloc(3))
    note("alloc 0", lambda: pool.alloc(0))
    note("alloc too many", lambda: pool.alloc(8))  # all-or-nothing
    note("a.ensure 9", lambda: a.ensure(9))
    note("a.ensure 9 again", lambda: a.ensure(9))
    note("a.ensure 13", lambda: a.ensure(13))
    note("b.ensure 7", lambda: b.ensure(7))
    note("b.ensure past the pool", lambda: b.ensure(40))
    note("a.release", a.release)
    note("a.release again", a.release)
    note("free first three", lambda: pool.free([0, 1, 2]))
    note("double free", lambda: pool.free([0]))
    note("free of a never-held block", lambda: pool.free([9]))
    note("b.ensure 20 after the frees", lambda: b.ensure(20))
    note("alloc the rest", lambda: pool.alloc(pool.num_blocks - pool.used_blocks))
    note("alloc 1 of an empty pool", lambda: pool.alloc(1))
    note("b.release", b.release)
    return log


def test_pool_and_stream_blocks_match_jax_call_for_call():
    got, want = _script(port_kv), _script(jax_kv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g[0], g, w)


@pytest.mark.parametrize("tokens,bs", [(0, 16), (1, 16), (16, 16), (17, 16), (576, 16), (5, 1)])
def test_blocks_for_matches_jax(tokens, bs):
    assert port_kv.blocks_for(tokens, bs) == jax_kv.blocks_for(tokens, bs)


@pytest.mark.parametrize("quant", [False, True])
def test_kv_token_bytes_matches_jax(quant):
    # TinyLlama: 22 layers, 4 KV heads of 64, bf16.
    args = (22, 4, 64, 2, quant)
    assert port_kv.kv_token_bytes(*args) == jax_kv.kv_token_bytes(*args)
    assert port_kv.kv_token_bytes(22, 4, 64, 2) == 22528


def _refcount_script(kv) -> list:
    """Refcounts, adoption and stats through one call sequence; return
    everything a caller can observe."""
    log = []
    pool = kv.BlockPool(8)
    donor = kv.StreamBlocks(pool, block_size=4)
    sharer = kv.StreamBlocks(pool, block_size=4)
    late = kv.StreamBlocks(pool, block_size=4)

    def note(tag, fn):
        try:
            out = fn()
        except Exception as e:  # the failure's type and message are the contract
            out = f"raised {type(e).__name__}: {e}"
        log.append((tag, out, pool.stats(), [pool.refcount(b) for b in range(8)],
                    list(donor.ids), list(sharer.ids), sharer.shared))

    note("donor.ensure 10", lambda: donor.ensure(10))
    note("pin the first two", lambda: pool.ref(donor.ids[:2]))
    note("sharer.adopt", lambda: sharer.adopt(donor.ids[:2]))
    note("sharer.ensure 13", lambda: sharer.ensure(13))
    note("adopt after alloc", lambda: sharer.adopt(donor.ids[:1]))
    note("late.ensure 4", lambda: late.ensure(4))
    note("late.adopt after alloc", lambda: late.adopt(donor.ids[:1]))
    note("donor.release", donor.release)
    note("unpin", lambda: pool.free([0, 1]))
    note("ref of a free block", lambda: pool.ref([7]))
    note("sharer.release", sharer.release)
    note("double free", lambda: pool.free([0]))
    note("late.release", late.release)
    return log


def test_refcounts_and_adopt_match_jax_call_for_call():
    got, want = _refcount_script(port_kv), _refcount_script(jax_kv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g[0], g, w)
    assert got[-1][2] == {"num_blocks": 8, "free": 8, "used": 0, "shared": 0}


def test_paged_prefix_matches_jax():
    a = port_kv.PagedPrefix(32, (3, 4), 2048)
    b = jax_kv.PagedPrefix(32, (3, 4), 2048)
    assert (a.p_len, a.block_ids, a.nbytes) == (b.p_len, b.block_ids, b.nbytes)
    with pytest.raises(AttributeError):
        a.p_len = 16  # frozen, as the reference's
