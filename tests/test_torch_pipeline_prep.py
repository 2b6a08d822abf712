"""The continuous loop's staged host prep (``HOST_PREP_DOUBLE``), blocking
admission (``ADMIT_OVERLAP=0``) and ready delivery (``_deliver_ready``) of
the port against the JAX package's ``ContinuousDecodeLoop``, f32 on the
CPU, on the services of ``tests/test_torch_pipeline.py`` (the depth and its
tuning are there), the counterparts of the JAX tests of
``HOST_PREP_DOUBLE`` (``tests/test_compile_cache.py``).  Tolerances:
tokens, counts, step cursors and block ledgers exact.

- ``HOST_PREP_DOUBLE`` on against off over gpt2, llama and llama int8,
  contiguous and paged, greedy and seeded sampled: the same tokens, the
  JAX loop's (its default, on); paged runs stage plans and use them, two
  ``prep`` boundaries each, contiguous runs and runs with the knob off
  stage none; the pool drains.
- A plan whose tenants change before its dispatch is rolled back to the
  ledger and table rows it was staged from, and every dispatch sees the
  serial run's.
- ``ADMIT_OVERLAP=0``: the JAX loop's tokens, no chunk dispatched while a
  wave's admission is pending.
- ``_deliver_ready``: a paged window that ended early is routed before the
  next dispatch, so no all-done window follows it."""

import asyncio

import pytest
import torch
from test_torch_decode_window import SEED_KW, _feats, _pair, _rigged_eos, _run, _wait
from test_torch_pipeline import FAMILIES, LENGTHS, BUDGETS, PAGED, SERVE, _late, _streams
from test_torch_preempt import _collect, _loops, _prompt, _settle
from test_torch_status import _settle_ready

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 1. staged host prep (HOST_PREP_DOUBLE)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_host_prep_double_is_token_identical_like_jax(family, layout, mode):
    model, extra = FAMILIES[family]
    paged = layout == "paged"
    kw = dict(SERVE, **extra, **(PAGED if paged else {}))
    jloop, jengine, loop, engine = _loops(model, **kw)
    off = _loops(model, host_prep_double=False, **kw)[2]
    assert loop.host_prep_double and jloop.host_prep_double and not off.host_prep_double
    feats = _streams(mode == "sampled")
    want = _late(jloop, feats)
    assert _late(loop, feats) == _late(off, feats) == want
    assert off.prep_staged == 0
    if paged:
        assert loop.prep_staged > 0 and loop.prep_hits > 0
        assert loop.prep_hits + loop.prep_misses <= loop.prep_staged
        assert engine.dispatch_counts["prep"] == 2 * loop.prep_staged
        _settle(loop, engine)
        assert _wait(lambda: off.engine.kv_pool.used_blocks == 0)
    else:
        assert loop.prep_staged == 0


def _ledger_row(loop, slot: int) -> tuple:
    """One tenant's blocks, step cursor and table row."""
    st = loop.active[slot]
    return (list(st.blocks.ids), loop._dispatched_steps.get(slot),
            loop._table[slot].tolist())


def _per_dispatch(loop) -> list:
    """At each chunk call: the step cursors, each live row's granted blocks
    and the pool's used blocks."""
    seen = []
    orig = loop._chunk_call

    def spy(*a, **kw):
        rows = (loop._table != loop.pool.num_blocks).sum(axis=1).tolist()
        seen.append((dict(loop._dispatched_steps), rows, loop.pool.used_blocks))
        return orig(*a, **kw)

    loop._chunk_call = spy
    return seen


def test_a_plan_whose_tenants_change_is_rolled_back_like_the_serial_run(monkeypatch):
    """Every staged plan's tenants change before its dispatch (a tenant is
    added to its snapshot): the dispatch rolls the grants back, so every
    tenant still live has the blocks, step cursor and table row it had
    before the plan was staged, and the pool holds exactly the live rows'
    blocks; then it preps inline.  Every dispatch sees the serial run's
    cursors, granted blocks and pool, and the tokens are the serial run's."""
    monkeypatch.setenv("ADMIT_GRACE_MS", "250")  # one wave on both loops
    kw = dict(SERVE, **PAGED)
    _, _, loop, engine = _loops("gpt2", **kw)
    serial = _loops("gpt2", host_prep_double=False, **kw)[2]
    before, rolled, bad = {}, [], []
    stage, consume = loop._stage_host_prep, loop._consume_staged_prep

    def staged():
        before.clear()
        before.update({slot: (st, _ledger_row(loop, slot)) for slot, st in loop.active.items()})
        stage()
        if loop._staged_prep is not None:
            tenants = loop._staged_prep["tenants"]
            loop._staged_prep["tenants"] = {**tenants, loop.n_slots: object()}

    def consumed(w):
        had = loop._staged_prep is not None
        out = consume(w)
        if had:
            rolled.append(w)
            for slot, (st, row) in before.items():
                if loop.active.get(slot) is st and _ledger_row(loop, slot) != row:
                    bad.append((slot, row, _ledger_row(loop, slot)))
            held = sum(len(st.blocks.ids) for st in loop.active.values())
            if loop.pool.used_blocks != held:
                bad.append((loop.pool.used_blocks, held))
        return out

    loop._stage_host_prep, loop._consume_staged_prep = staged, consumed
    got_seen, want_seen = _per_dispatch(loop), _per_dispatch(serial)
    feats = [_prompt(n, 20 + n, max_tokens=b) for n, b in zip(LENGTHS, BUDGETS)]

    async def burst(lp):
        return list(await asyncio.gather(*(_collect(lp.submit_stream(dict(f))) for f in feats)))

    for lp in (loop, serial):
        try:
            out = asyncio.run(burst(lp))
        finally:
            lp.stop()
        if lp is serial:
            assert out == got
        got = out
    assert loop.prep_staged > 0 and loop.prep_hits == 0 and loop.prep_misses == len(rolled) > 0
    assert not bad, bad
    assert got_seen == want_seen
    _settle(loop, engine)
    assert serial.prep_staged == 0


# ---------------------------------------------------------------------------
# 2. ADMIT_OVERLAP=0 and ready delivery


def _pending_at_dispatch(loop) -> list[bool]:
    seen = []
    orig = loop._dispatch_chunk

    def spy():
        seen.append(bool(loop._pending_wave or loop._pending_admissions))
        return orig()

    loop._dispatch_chunk = spy
    return seen


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_blocking_admission_matches_jax(layout, monkeypatch):
    """ADMIT_OVERLAP=0 on both loops: the JAX loop's tokens, and no chunk
    goes out while a wave's admission is pending; with the default order a
    late wave's admission is pending at a dispatch."""
    kw = dict(SERVE, **(PAGED if layout == "paged" else {}))
    overlapped = _loops("llama", **kw)[2]
    monkeypatch.setenv("ADMIT_OVERLAP", "0")
    jloop, jengine, loop, engine = _loops("llama", **kw)
    assert not loop.overlap_admission and not jloop.overlap_admission
    assert overlapped.overlap_admission
    feats = _streams(True)
    seen, seen_overlapped = _pending_at_dispatch(loop), _pending_at_dispatch(overlapped)
    want = _late(jloop, feats)
    assert _late(loop, feats) == _late(overlapped, feats) == want
    assert seen and not any(seen)
    assert any(seen_overlapped)
    _settle(loop, engine)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_ready_delivery_leaves_no_all_done_window_like_jax(mode, monkeypatch):
    """A paged stream alone whose eos comes in its first window: the window
    ends early, is routed at the next iteration top and frees the row, so
    the loop dispatches nothing more (the JAX loop, its ready check settled
    as the CPU port's, the same); then the slot's next tenants get the JAX
    loop's tokens."""
    extra = SEED_KW if mode == "sampled" else {}
    first = _feats((7,), 0, **extra)[0]
    eos = _rigged_eos(first, 5, 11)
    monkeypatch.setenv("ADMIT_GRACE_MS", "250")
    jengine, jcfg, engine, batcher = _pair(
        "gpt", eos=eos, decode_window=4, decode_window_auto=False, max_decode_len=32, **PAGED)
    jloop, loop = JaxLoop(jengine, jcfg), batcher._cdl
    _settle_ready(jloop)
    waves = [[first], _feats((9, 14), 3, **extra)]
    counts = []
    for lp in (jloop, loop):
        dispatches = []
        orig = lp._dispatch_chunk

        def spy(lp=lp, orig=orig, dispatches=dispatches):
            dispatches.append(lp.window_early_exits)
            return orig()

        lp._dispatch_chunk = spy
        counts.append(dispatches)
    want = _run(jloop, waves)
    assert _run(loop, waves) == want
    assert eos in want[0][0] and loop.window_early_exits >= 1
    # The first wave's one window ends early; no dispatch follows it until
    # the next wave arrives.
    assert counts[1][:2] == counts[0][:2] == [0, 1]
    assert loop.chunk_dispatches == jloop.chunk_dispatches
    assert _wait(lambda: engine.kv_pool.used_blocks == 0)


