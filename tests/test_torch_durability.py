"""Durable serving (``JOURNAL_DIR``; ``runtime/durability.py``) of the port
against the JAX package's, f32 on the CPU, at small gpt2 and llama configs
on the same weights (the services of ``test_torch_prefill_loop.py``; the
JAX references are built once per family for the module):

- Framing: a torn tail at any offset of the last record, and a flipped
  payload byte, replay to the clean prefix (hypothesis); each package
  reads the other's journal, record kind by record kind, clock fields set
  aside.
- The journal's state after replay, compaction and tombstones equals
  ``StreamJournal``'s for the same records; a second journal on the same
  directory is refused; with ``JOURNAL_DIR`` unset nothing is built, and
  the build refuses the disk tier without its stack, with the JAX
  messages.
- The restart matrix {gpt2, llama} x {greedy, pinned-seed sampled} x
  {contiguous, paged}, simulated as the JAX package's
  ``_restart_resume_case`` does it: the journal dies at ``kill_after``
  tokens, then a fresh engine and loop replay it; delivered +
  continuation equals the JAX package's uninterrupted tokens, and the
  paged pool drains to 0.
- The disk tier: ``BlockPool.take``, the swap ledger's hooks, ``restore``
  and ``touch`` against the JAX classes; the index across a restart with
  the exact ids taken; a wipe on layout drift; bf16 stored bit for bit,
  never matching an f16 layout.  The full ladder: a dry-pool checkpoint
  swaps out to the host and writes through to disk, the process is
  killed and restarted, and the resume promotes disk -> host -> device
  with no prefill dispatch, its restored blocks bit-equal to those
  swapped out and its tokens the JAX package's.
- A mid-prefill checkpoint's partial KV: no window prefilled twice, the
  JAX loop's counts.
- Unary dedup by ``X-Request-Id`` across a restart, no dispatch; a minted
  id does not dedup.
- ``GET /v1/streams/{rid}``: the body of the JAX app's (``timing_ms`` set
  aside), 404 and 410 as the JAX app answers them.
- The real ``kill -9`` of a server process (marked ``chaos``).
"""

import asyncio
import contextlib
import functools
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as hs
from test_torch_gpt import small_gpt2
from test_torch_prefill_loop import SMALL_LLAMA, _env, ids_of, services

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine import kv_blocks as jax_kv
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.runtime import durability as jax_dur
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.scheduler.admission import AdmissionController as JaxAdmission
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.engine import kv_blocks as port_kv
from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import blocks_for
from mlmicroservicetemplate_tpu_torch.engine.streams import ContinuousDecodeLoop
from mlmicroservicetemplate_tpu_torch.runtime import durability as port_dur
from mlmicroservicetemplate_tpu_torch.scheduler.admission import AdmissionController
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils.config import ServiceConfig

# The JAX package's durability tests' loop: 8-token blocks, 4 slots.
LOOP = dict(batch_buckets=(1, 2, 4), seq_buckets=(16, 32), max_decode_len=12,
            stream_chunk_tokens=4, max_streams=4)
PAGED = dict(paged_kv=True, kv_block_size=8, max_stream_queue=4)
FAMILY = {"gpt": "gpt2", "llama": "llama"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(model: str):
    """One JAX engine (the uninterrupted runs) and the weights of ``model``,
    built once for the module."""
    (_, jbundle, jengine), _ = services(model, **LOOP)
    return jengine, jax.tree.map(np.asarray, jbundle.params)


def _port(model: str, **kw):
    """(cfg, engine) of the port on the reference's weights at ``kw``."""
    _, params = _reference(model)
    env = {"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0", "BATCH_TIMEOUT_MS": "1",
           "LLAMA_CONFIG": json.dumps(SMALL_LLAMA), **_env({**LOOP, **kw})}
    with small_gpt2() if model == "gpt2" else contextlib.nullcontext():
        cfg, _, engine, _ = build_service(env, params=params)
    return cfg, engine


def _loop(cfg, engine):
    loop = ContinuousDecodeLoop(engine, cfg)
    loop.admission = AdmissionController(cfg, engine)
    return loop


def _solo(model: str, feats: dict) -> list[int]:
    """The JAX package's uninterrupted tokens of one stream."""
    jengine, _ = _reference(model)
    return [int(t) for c in jengine.generate_stream(dict(feats)) for t in np.asarray(c)]


async def _consume(gen) -> list[int]:
    return [int(t) async for c in gen for t in np.asarray(c).tolist()]


def _wait_drained(pool, timeout: float = 5.0) -> int:
    deadline = time.monotonic() + timeout
    while pool.used_blocks > 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    return pool.used_blocks


def _records(path: str, reader) -> list[dict]:
    """A journal's records, kind by kind, with no clock fields (the job
    store's ``created``/``t``; the stream journal has none)."""
    frames, _ = reader(path)
    out = []
    for payload in frames:
        rec = json.loads(payload)
        rec.pop("created", None)
        rec.pop("t", None)
        out.append(rec)
    return out


def _segment(d: str) -> str:
    (name,) = [n for n in os.listdir(d) if n.startswith("wal-")]
    return os.path.join(d, name)


# ---------------------------------------------------------------------------
# framing


@settings(max_examples=25, deadline=None)
@given(payloads=hs.lists(hs.binary(min_size=0, max_size=40), min_size=1, max_size=6),
       data=hs.data())
def test_frame_torn_tail_property(payloads, data):
    """Any truncation inside the last record, or a flipped byte of its
    payload, replays to exactly the records before it, in both packages."""
    d = tempfile.mkdtemp()
    try:
        path = os.path.join(d, "wal-000001.log")
        with open(path, "wb") as f:
            for p in payloads:
                port_dur.append_frame(f, p + b"\n")
        data_ = open(path, "rb").read()
        frames, good = port_dur.read_frames(path)
        assert good == len(data_) and frames == [p + b"\n" for p in payloads]
        last = len(data_) - (8 + len(payloads[-1]) + 1)
        cut = data.draw(hs.integers(last + 1, len(data_) - 1))
        torn = os.path.join(d, "torn")
        with open(torn, "wb") as f:
            f.write(data_[:cut])
        for reader in (port_dur.read_frames, jax_dur.read_frames):
            fr, g = reader(torn)
            assert fr == frames[:-1] and g == last, cut
        bad = bytearray(data_)
        bad[last + 8 + data.draw(hs.integers(0, len(payloads[-1])))] ^= 0xFF
        with open(torn, "wb") as f:
            f.write(bytes(bad))
        for reader in (port_dur.read_frames, jax_dur.read_frames):
            fr, g = reader(torn)
            assert fr == frames[:-1] and g == last
    finally:
        shutil.rmtree(d)


def _write_records(journal) -> None:
    journal.admit("a", {"input_ids": np.asarray([1, 2], np.int32), "length": 2, "max_tokens": 8,
                        "seed": 7, "temperature": 0.5, "priority": "batch",
                        "request_id": "a", "deadline_ms": 100.0},
                  "interactive", 8, stop=("xx",))
    journal.tokens("a", np.asarray([4, 5], np.int32))
    journal.checkpoint("a")
    journal.tokens("a", [6])
    journal.admit("b", {"input_ids": [9], "length": 1, "stop_strs": ["q"]}, "batch", 4)
    journal.tokens("b", [1, 2, 3, 4])
    journal.done("b")
    journal.done("b")  # exactly once
    journal.result("u1", np.asarray([10, 11], np.int64))


def _state(journal) -> dict:
    return {
        "streams": {rid: (rs.feats, rs.klass, rs.budget, rs.tokens, rs.done, rs.outcome,
                          rs.stop) for rid, rs in journal.streams.items()},
        "results": dict(journal.results),
        "tombs": dict(journal.tombs),
        "incomplete": [rs.rid for rs in journal.incomplete()],
        "stats": {k: v for k, v in journal.stats().items() if k != "dir"},
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_journal(tmp_path, writer):
    """One package writes the journal, the other replays it: the records
    agree kind by kind, and the replayed state equals the writer's own."""
    mods = {"port": port_dur, "jax": jax_dur}
    reader = "jax" if writer == "port" else "port"
    d = str(tmp_path / "j")
    j = mods[writer].StreamJournal(d, fsync="off", model="t")
    _write_records(j)
    j.close()
    seg = _segment(d)
    assert _records(seg, port_dur.read_frames) == _records(seg, jax_dur.read_frames)
    kinds = [r["k"] for r in _records(seg, port_dur.read_frames)]
    assert kinds == ["admit", "tokens", "checkpoint", "tokens", "admit", "tokens", "done",
                     "result"]
    shutil.copytree(d, str(tmp_path / "copy"))
    os.unlink(str(tmp_path / "copy" / ".lock"))
    got = mods[reader].StreamJournal(d, fsync="off", model="t")
    want = mods[writer].StreamJournal(str(tmp_path / "copy"), fsync="off", model="t")
    try:
        assert _state(got) == _state(want)
        a = got.incomplete()[0].np_feats()
        assert a["input_ids"].dtype == np.int32 and a["input_ids"].tolist() == [1, 2]
        assert int(a["length"]) == 2 and "deadline_ms" not in a
    finally:
        got.close()
        want.close()


def test_journal_state_after_compaction_and_tombstones_matches_jax(tmp_path, monkeypatch):
    """The same record sequence through both journals, reopened three
    times under small compaction bounds: the replayed streams, results and
    tombstones, the compacted segment's records and the stats agree; a
    compacted stream answers its outcome (410), an unknown one None."""
    for mod in (port_dur, jax_dur):
        monkeypatch.setattr(mod, "_KEEP_DONE", 2)
        monkeypatch.setattr(mod, "_KEEP_RESULTS", 3)
        monkeypatch.setattr(mod, "_KEEP_TOMBS", 2)
    states = {}
    for name, mod in (("port", port_dur), ("jax", jax_dur)):
        d = str(tmp_path / name)
        j = mod.StreamJournal(d, fsync="interval", model="t")
        for i in range(6):
            rid = f"s{i}"
            j.admit(rid, {"input_ids": [i, i + 1], "length": 2}, "interactive", 4)
            j.tokens(rid, [i, 7])
            if i % 3:
                j.done(rid, "end" if i % 2 else "error")
            j.result(f"u{i}", [i])
        j.close()
        seen = []
        for _ in range(3):
            j = mod.StreamJournal(d, fsync="off", model="t")
            seen.append(_state(j))
            seen.append([j.terminal_status(r) for r in ("s0", "s1", "s2", "s4", "s5", "zz")])
            j.close()
        seen.append(_records(_segment(d), port_dur.read_frames))
        states[name] = seen
    assert states["port"] == states["jax"]
    assert states["port"][1][-1] is None


def test_journal_lock_is_exclusive(tmp_path):
    d = str(tmp_path / "j")
    j = port_dur.StreamJournal(d, fsync="off")
    with pytest.raises(RuntimeError, match="locked"):
        port_dur.StreamJournal(d, fsync="off")
    # The JAX package's journal respects the same lock.
    with pytest.raises(RuntimeError, match="locked"):
        jax_dur.StreamJournal(d, fsync="off")
    j.close()
    port_dur.StreamJournal(d, fsync="off").close()  # released on close


def test_journal_disabled_default_builds_nothing():
    """JOURNAL_DIR unset: no journal, no disk tier, no job object, every
    loop hook None; the build refuses the disk tier without its stack,
    with the JAX package's messages."""
    cfg, engine = _port("gpt2")
    batcher = Batcher(engine, cfg)
    assert engine.journal is None and engine.kv_disk is None and batcher.jobs is None
    assert batcher._cdl._journal() is None and batcher._cdl._disk_tier() is None
    with pytest.raises(ValueError, match="JOURNAL_FSYNC"):
        ServiceConfig(journal_fsync="sometimes")
    with pytest.raises(ValueError, match="KV_DISK_BUDGET_MB"):
        ServiceConfig(kv_disk_budget_mb=-1)
    with pytest.raises(ValueError, match="KV_DISK_BUDGET_MB requires JOURNAL_DIR"):
        _port("gpt2", **PAGED, kv_host_budget_mb=1.0, kv_disk_budget_mb=1.0)
    with pytest.raises(ValueError, match="KV_HOST_BUDGET_MB>0"):
        _port("gpt2", **PAGED, kv_disk_budget_mb=1.0, journal_dir="/nonexistent/j")


# ---------------------------------------------------------------------------
# the disk tier's primitives

LEAF_SPECS = [((4, 2, 8), torch.float32), ((4, 2, 1), torch.float32)]


def test_block_pool_take_like_jax():
    pools = [port_kv.BlockPool(6, 16), jax_kv.BlockPool(6, 16)]
    for pool in pools:
        pool.take([4, 1])
        assert pool.alloc(2) == [0, 2]
        for bad in ([6], [1], [3, 3], [-1]):
            with pytest.raises(ValueError) as e:
                pool.take(bad)
            e.value.args = (e.value.args[0],)
        pool.take([3])  # all-or-nothing: the refused takes took nothing
    assert [p.free_blocks for p in pools] == [1, 1]
    msgs = []
    for pool in pools:
        for bad in ([6], [1], [5, 5]):
            with pytest.raises(ValueError) as e:
                pool.take(bad)
            msgs.append(str(e.value))
    assert msgs[:3] == msgs[3:]


def test_swap_ledger_hooks_restore_and_touch_like_jax():
    """Spill and release hooks, ``restore`` at exact ids and ``touch``, on
    the same sequence through both ledgers: the same victims, spills,
    releases and free lists; a spill that raises still evicts."""
    logs = []
    for kv in (port_kv, jax_kv):
        pool = kv.BlockPool(5, 8)
        ledger = kv.SwapLedger(pool)
        log_ = []
        ledger.spill = lambda e, log_=log_: log_.append(("spill", e.kind, e.key, tuple(e.ids)))
        ledger.on_release = lambda e, log_=log_: log_.append(("rel", e.key, tuple(e.ids)))
        a = ledger.restore([3, 4], 16, "stream", ("stream", "a"))
        b = ledger.reserve(2, 12, "prefix", key=(16, b"k"))
        b.ready = True
        ledger.touch(a)
        c = ledger.reserve(2, 9, "stream", key=("stream", "c"))  # evicts the prefix
        c.ready = True
        log_.append(("get", ledger.get(("stream", "a")) is a, ledger.get((16, b"k"))))

        def boom(e):
            raise OSError("disk full")

        ledger.spill = boom
        ledger.reserve(3, 1, "stream")  # evicts a, then c; the spill fails
        log_.append(("alive", a.alive, c.alive, pool.free_blocks, ledger.evictions))
        logs.append(log_)
    assert logs[0] == logs[1]


def test_disk_tier_index_survives_restart(tmp_path):
    """Put, close, reopen: the index restores the entry at its exact ids,
    the payload bit for bit; release drains; a layout drift wipes."""
    d = str(tmp_path / "kv")
    tier = port_dur.KVDiskTier(1.0, block_bytes=4096, dir=d)
    assert tier.attach(LEAF_SPECS)
    tier.put(("stream", "r0"), 8, "stream", [torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 1)])
    vals = [torch.arange(2 * 4 * 2 * 8, dtype=torch.float32).reshape(2, 4, 2, 8),
            torch.full((2, 4, 2, 1), 7.0)]
    e = tier.put(("stream", "r1"), tokens=16, kind="stream", leaf_vals=vals)
    assert e is not None and e.ready and e.ids == [1, 2]
    tier.release_key(("stream", "r0"))
    tier.close()

    tier2 = port_dur.KVDiskTier(1.0, block_bytes=4096, dir=d)
    e2 = tier2.get(("stream", "r1"))
    assert e2 is not None and e2.ready and e2.tokens == 16 and e2.ids == [1, 2]
    assert tier2.pool.used_blocks == 2 and tier2.pool.book.refcount(1) == 1
    assert tier2.get(("stream", "r0")) is None
    assert tier2.prefix_get(("stream", "r1")) is None  # not attached yet
    assert tier2.attach(LEAF_SPECS)
    for w, g in zip(vals, tier2.pool.read(e2.ids)):
        assert torch.equal(w, g)
    tier2.release_key(("stream", "r1"))
    assert tier2.pool.used_blocks == 0
    tier2.put(("stream", "r2"), 8, "stream", [v[:1] for v in vals])
    tier2.close()
    tier3 = port_dur.KVDiskTier(1.0, block_bytes=4096, dir=d)
    assert tier3.attach([((2, 2, 8), torch.float32), ((2, 2, 1), torch.float32)])
    assert tier3.get(("stream", "r2")) is None and tier3.pool.used_blocks == 0
    tier3.close()


def test_disk_tier_stores_bf16_bit_for_bit_and_never_as_f16(tmp_path):
    d = str(tmp_path / "kv")
    bf16 = [((4, 2, 8), torch.bfloat16)]
    tier = port_dur.KVDiskTier(1.0, block_bytes=4096, dir=d)
    assert tier.attach(bf16)
    vals = torch.randn(3, 4, 2, 8).to(torch.bfloat16)
    vals[0, 0, 0, :4] = torch.tensor([float("nan"), float("-inf"), -0.0, 1e-40])
    e = tier.put(("stream", "b"), 24, "stream", [vals])
    host = port_kv.HostBlockPool(4, 4096, bf16)
    tier.pool.read_into(e.ids, host, [3, 0, 1])
    for got in (tier.pool.read(e.ids)[0], host.leaves[0][[3, 0, 1]]):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), vals.view(torch.int16))
    tier.close()
    # The same shape in f16 is another layout: the stale tier is wiped.
    tier2 = port_dur.KVDiskTier(1.0, block_bytes=4096, dir=d)
    assert tier2.get(("stream", "b")) is not None
    assert port_dur.leaf_layout(bf16) != port_dur.leaf_layout([((4, 2, 8), torch.float16)])
    assert tier2.attach([((4, 2, 8), torch.float16)])
    assert tier2.get(("stream", "b")) is None
    tier2.close()
    # And f32's tag is the JAX package's.
    assert port_dur.leaf_layout(LEAF_SPECS) == [((4, 2, 8), "<f4"), ((4, 2, 1), "<f4")]


def test_get_disk_tier_is_one_per_directory(tmp_path):
    d = str(tmp_path / "kv")
    a = port_dur.get_disk_tier(1.0, 4096, d)
    assert port_dur.get_disk_tier(1.0, 4096, d + "/") is a
    a.close()
    b = port_dur.get_disk_tier(1.0, 4096, d)
    assert b is not a
    b.close()


# ---------------------------------------------------------------------------
# process-restart resume identity


def _prompt(family: str, sampled: bool) -> dict:
    feats = {"input_ids": np.random.default_rng(3).integers(5, 250, 14).astype(np.int32),
             "length": np.int32(14), "request_id": f"rid-{family}"}
    if sampled:
        feats["temperature"] = 0.9
        feats["seed"] = 4321
    return feats


def _restart_resume_case(model: str, kw: dict, feats: dict, solo: list[int],
                         kill_after: int = 8):
    """A simulated SIGKILL, as the JAX package's test makes it: the moment
    the cursor reaches ``kill_after`` tokens the journal is closed and
    detached on the loop thread (a killed process writes nothing more);
    then a fresh engine and loop replay the directory and resume."""
    d = tempfile.mkdtemp()
    cfg, eng1 = _port(model, **kw)
    j1 = port_dur.StreamJournal(d, fsync="off", model=model)
    eng1.journal = j1
    loop1 = _loop(cfg, eng1)
    write = j1.tokens

    def killing_tokens(rid, toks):
        write(rid, toks)
        if len(j1.streams[rid].tokens) >= kill_after and eng1.journal:
            j1.close()
            eng1.journal = None

    j1.tokens = killing_tokens
    async def serve():
        return await _consume(loop1.submit_stream(dict(feats)))

    try:
        got = asyncio.run(serve())
    finally:
        loop1.stop()
    assert got == solo

    cfg2, eng2 = _port(model, **kw)
    j2 = port_dur.StreamJournal(d, fsync="off", model=model)
    eng2.journal = j2
    loop2 = _loop(cfg2, eng2)
    try:
        (rs,) = j2.incomplete()
        assert rs.rid == feats["request_id"]
        delivered = list(rs.tokens)
        assert len(delivered) >= kill_after and delivered == solo[: len(delivered)]

        async def resume():
            gen = loop2.resume_stream(rs.np_feats(), delivered)
            return await _consume(gen) if gen is not None else []

        cont = asyncio.run(resume())
        assert delivered + cont == solo, (delivered, cont, solo)
        if kw.get("paged_kv"):
            assert _wait_drained(eng2.kv_pool) == 0
        # The continuation's cursor and terminal record landed.
        assert j2.streams[rs.rid].tokens == solo and j2.streams[rs.rid].done
    finally:
        loop2.stop()
        j2.close()
        shutil.rmtree(d)
    return delivered, cont


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_restart_resume_token_identity(family, sampled, paged):
    """kill -9, restart, journal replay: the journaled cursor plus the
    continuation equal the JAX package's uninterrupted tokens, with no
    token twice (a greedy recast or a pinned-seed replay)."""
    model = FAMILY[family]
    feats = _prompt(family, sampled)
    solo = _solo(model, feats)
    assert len(solo) == LOOP["max_decode_len"]
    _restart_resume_case(model, PAGED if paged else {}, feats, solo)


# ---------------------------------------------------------------------------
# the disk rung across a restart


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_restart_resume_from_disk_tier(family, tmp_path):
    """The offload ladder across a restart, as the JAX package's test runs
    it: a dry-pool checkpoint swaps out to the host and writes through to
    disk; the journal directory is copied at that instant (a state a
    SIGKILL could leave); a fresh engine on the copy resumes both streams,
    the checkpointed one promoted disk -> host -> device with no prefill
    dispatch of its own, its restored blocks bit-equal to those swapped
    out, every token the JAX package's."""
    model = FAMILY[family]
    probe_cfg, probe = _port(model, **PAGED)
    bb = probe.kv_pool.block_bytes
    jd = str(tmp_path / "j")
    kw = dict(PAGED, kv_budget_mb=6 * bb / 1e6, kv_host_budget_mb=1.0,
              kv_disk_budget_mb=1.0, journal_dir=jd)
    feats = [{"input_ids": p, "length": np.int32(14), "request_id": f"r{i}"}
             for i, p in enumerate(np.random.default_rng(3).integers(5, 250, (2, 14))
                                   .astype(np.int32))]
    solos = {f["request_id"]: _solo(model, f) for f in feats}

    # The service's batcher opened the journal (JOURNAL_FSYNC=always).
    cfg, eng1 = _port(model, **kw)
    assert eng1.kv_pool.num_blocks == 6 and eng1.journal.fsync == "always"
    loop1 = _loop(cfg, eng1)
    snap = str(tmp_path / "snap")
    swapped = {}
    start = loop1._start_swapin

    def gated(st):
        # The first swap-in: the host copy has landed and written through.
        if not swapped and st.swap is not None:
            loop1._drain_swapouts()
            swapped["rid"] = st.rid
            swapped["vals"] = [t.clone() for t in st.swap.pool.read(st.swap.ids)]
            shutil.copytree(jd, snap)
        return start(st)

    loop1._start_swapin = gated

    async def phase1():
        gens = [loop1.submit_stream(dict(f)) for f in feats]
        return await asyncio.gather(*[_consume(g) for g in gens])

    try:
        outs = asyncio.run(phase1())
    finally:
        loop1.stop()
    assert outs == [solos[f["request_id"]] for f in feats]
    assert swapped, "a dry-pool swap checkpoint must have fired"
    assert eng1.kv_disk.spills >= 1
    eng1.journal.close()
    eng1.kv_disk.close()
    os.unlink(os.path.join(snap, ".lock"))

    cfg2, eng2 = _port(model, **{**kw, "journal_dir": snap})
    j2 = eng2.journal
    loop2 = _loop(cfg2, eng2)
    inc = {rs.rid: rs for rs in j2.incomplete()}
    assert swapped["rid"] in inc
    disk_entry = eng2.kv_disk.get(("stream", swapped["rid"]))
    assert disk_entry is not None and disk_entry.ready
    restored = {}
    handoff = loop2._swap_handoff

    def watched(job):
        # The device blocks the prefetch filled, read before they go live.
        leaves = loop2._pool_leaves()
        idx = torch.as_tensor(job.sb.ids[: len(swapped["vals"][0])])
        restored["vals"] = [leaf.index_select(0, idx).clone() for leaf in leaves]
        return handoff(job)

    loop2._swap_handoff = watched
    prefills = eng2.dispatch_counts.get("prefill", 0)

    async def phase2(rids):
        full = {}
        for rid in rids:
            rs = inc[rid]
            gen = loop2.resume_stream(rs.np_feats(), list(rs.tokens))
            full[rid] = list(rs.tokens) + (await _consume(gen) if gen is not None else [])
        return full

    try:
        full = asyncio.run(phase2([swapped["rid"]]))
        # The checkpointed stream resumed with no prefill dispatch.
        assert eng2.dispatch_counts.get("prefill", 0) == prefills
        full.update(asyncio.run(phase2([r for r in inc if r != swapped["rid"]])))
    finally:
        loop2.stop()
    for rid, toks in full.items():
        assert toks == solos[rid], rid
    assert eng2.kv_disk.promotes >= 1
    assert loop2.swap_ins >= 1 and loop2.swap_fallbacks == 0
    for want, got in zip(swapped["vals"], restored["vals"]):
        assert torch.equal(want, got.cpu())
    assert _wait_drained(eng2.kv_pool) == 0
    # Every stream ended: nothing of theirs is left on disk.
    assert eng2.kv_disk.pool.used_blocks == 0
    j2.close()
    eng2.kv_disk.close()


def test_midprefill_checkpoint_swaps_partial_kv():
    """A dry-pool checkpoint mid-prefill swaps the consumed windows' KV out
    and prefetches it back: the windows equal an uninterrupted count (none
    prefilled twice), the swap counts and tokens the JAX loop's."""
    model = "gpt2"
    probe_cfg, probe = _port(model, **PAGED)
    bb = probe.kv_pool.block_bytes
    kw = dict(PAGED, prefill_chunk=8, kv_budget_mb=7 * bb / 1e6, kv_host_budget_mb=1.0)
    cfg, engine = _port(model, **kw)
    assert engine.kv_pool.num_blocks == 7
    jcfg = _reference(model)[0].cfg.model_copy(update=dict(kw))
    jengine = JaxEngine(_reference(model)[0].bundle, jcfg, ReplicaSet(make_mesh(1)))
    jloop = JaxLoop(jengine, jcfg)
    jloop.admission = JaxAdmission(jcfg, jengine)
    loop = _loop(cfg, engine)
    feats = [{"input_ids": ids_of(30, 7 + i), "length": np.int32(30), "request_id": f"m{i}"}
             for i in range(2)]
    solos = [_solo(model, f) for f in feats]
    counts = []
    for lp in (jloop, loop):
        async def body(lp=lp):
            return await asyncio.gather(*[_consume(lp.submit_stream(dict(f))) for f in feats])
        try:
            assert asyncio.run(body()) == solos
        finally:
            lp.stop()
        counts.append((lp.swap_outs, lp.swap_ins, lp.swap_fallbacks,
                       lp.prefill_chunk_dispatches))
    assert counts[1] == counts[0]
    assert counts[1][0] >= 1 and counts[1][1] >= 1 and counts[1][2] == 0
    assert counts[1][3] == 2 * blocks_for(30, 8)
    assert _wait_drained(engine.kv_pool) == 0 and engine.kv_host.pool.used_blocks == 0


# ---------------------------------------------------------------------------
# over HTTP: unary dedup and the reconnect route


def _app(kind: str, jd: str, model: str = "gpt2", **kw):
    """The JAX app or the port's on journal directory ``jd``, on the
    reference's weights."""
    jengine, params = _reference(model)
    if kind == "jax":
        jcfg = jengine.cfg.model_copy(update=dict(kw, journal_dir=jd, batch_timeout_ms=1.0))
        jeng = JaxEngine(jengine.bundle, jcfg, ReplicaSet(make_mesh(1)))
        return jax_build_app(jcfg, jengine.bundle, jeng, JaxBatcher(jeng, jcfg)), jeng
    env = {"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0", "BATCH_TIMEOUT_MS": "1",
           "LLAMA_CONFIG": json.dumps(SMALL_LLAMA), **_env({**LOOP, **kw}), "JOURNAL_DIR": jd}
    with small_gpt2() if model == "gpt2" else contextlib.nullcontext():
        cfg, bundle, engine, batcher = build_service(env, params=params)
    return build_app(cfg, bundle, engine, batcher), engine


async def _drive(app, calls, between=None):
    """``[(method, path, body, headers)]`` -> ``[(status, text)]``;
    ``between()`` is called before the first call and after each."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        out = []
        if between is not None:
            between()
        for method, path, body, headers in calls:
            if method == "SETTLE":
                # Until every resumed stream has finished, so a reconnect's
                # chunking does not depend on when it attached.
                for _ in range(400):
                    st = await (await client.get("/status")).json()
                    if st["durability"]["reconnect"]["live"] == 0:
                        break
                    await asyncio.sleep(0.025)
                continue
            resp = await client.request(method, path, json=body, headers=headers or {})
            out.append((resp.status, await resp.text()))
            if between is not None:
                between()
        return out
    finally:
        await client.close()


def test_unary_dedup_by_request_id_across_a_restart(tmp_path):
    """A /predict with a client X-Request-Id is journaled; its retry, in
    this process and after a restart, returns the journaled body with no
    dispatch; a minted id dispatches every time.  The bodies and statuses
    are the JAX app's."""
    body = {"text": "hello there", "max_tokens": 6}
    calls = [("POST", "/predict", body, {"X-Request-Id": "u-1"}),
             ("POST", "/predict", body, {"X-Request-Id": "u-1"}),
             ("POST", "/predict", body, None)]
    answers = {}
    seen = []
    for kind in ("jax", "port"):
        runs = []
        for _life in range(2):
            app, engine = _app(kind, str(tmp_path / kind))
            counts = []
            note = (lambda e=engine, c=counts: c.append(e.dispatches)) if kind == "port" else None
            out = asyncio.run(_drive(app, calls, note))
            runs.append([(status, json.loads(t)["prediction"]) for status, t in out])
            if kind == "port":
                seen.append(counts)
        answers[kind] = runs
    assert answers["port"] == answers["jax"]
    assert answers["port"][0][0] == answers["port"][0][1] == answers["port"][1][0]
    # First life: the call dispatches, its retry does not, a minted id does;
    # after the restart the retry is answered from the journal.
    (c0, c1) = seen
    assert c0[1] > c0[0] and c0[2] == c0[1] and c0[3] > c0[2]
    assert c1[1] == c1[0] and c1[2] == c1[1] and c1[3] > c1[2]


def _journal_with(d: str, mod, records: list) -> None:
    j = mod.StreamJournal(d, fsync="off", model="gpt2")
    for kind, *args in records:
        getattr(j, kind)(*args)
    j.close()


def test_stream_attach_body_404_and_410_like_jax(tmp_path, monkeypatch):
    """After a restart, ``GET /v1/streams/{rid}`` of a finished stream and
    of one that resumes: the ndjson body of the JAX app (``timing_ms`` set
    aside), each token once; an unknown id 404, a compacted one 410 with
    the JAX app's body."""
    model = "gpt2"
    feats = {"input_ids": ids_of(14, 5), "length": np.int32(14), "request_id": "live"}
    solo = _solo(model, feats)
    done_toks = _solo(model, {**feats, "request_id": "fin", "input_ids": ids_of(14, 6)})
    for mod in (port_dur, jax_dur):
        monkeypatch.setattr(mod, "_KEEP_DONE", 1)
    records = [
        ("admit", "old", {"input_ids": [5, 6], "length": 2}, "interactive", 12),
        ("tokens", "old", [7]), ("done", "old"),
        ("admit", "fin", {"input_ids": ids_of(14, 6), "length": 14}, "interactive", 12,
         ("zz",)),
        ("tokens", "fin", done_toks), ("done", "fin"),
        ("admit", "live", dict(feats, max_tokens=12), "interactive", 12),
        ("tokens", "live", solo[:8]),
    ]
    bodies = {}
    for name, mod in (("jax", jax_dur), ("port", port_dur)):
        jd = str(tmp_path / name)
        _journal_with(jd, mod, records)
        # A restart compacts "old" to a tombstone (one finished kept).
        mod.StreamJournal(jd, fsync="off", model=model).close()
    for name in ("jax", "port"):
        a, _ = _app(name, str(tmp_path / name))
        calls = [("SETTLE", None, None, None)] + [
            ("GET", f"/v1/streams/{r}", None, None) for r in ("live", "fin", "old", "nope")]
        bodies[name] = asyncio.run(_drive(a, calls))

    def norm(text):
        lines = [json.loads(ln) for ln in text.splitlines() if ln]
        for ln in lines:
            ln.pop("timing_ms", None)
        return lines

    (ls, lt), (fs, ft), (os_, ot), (ns, _) = bodies["port"]
    assert [ls, fs, os_, ns] == [s for s, _ in bodies["jax"]] == [200, 200, 410, 404]
    assert norm(lt) == norm(bodies["jax"][0][1]) and norm(ft) == norm(bodies["jax"][1][1])
    assert json.loads(ot) == json.loads(bodies["jax"][2][1])
    assert norm(lt)[-1]["tokens_generated"] == len(solo)


# ---------------------------------------------------------------------------
# the real kill -9 (chaos: not in tier 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method: str, url: str, body: dict | None = None, timeout: float = 60.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          "X-Request-Id": "chaos-1"})
    return urllib.request.urlopen(req, timeout=timeout)


def _serve(jd: str, port: int) -> subprocess.Popen:
    """A port server on the CPU: llama from the seed-0 random init."""
    env = {**os.environ, "DEVICE": "cpu", "MODEL_NAME": "llama", "WARMUP": "0",
           "LLAMA_CONFIG": json.dumps(SMALL_LLAMA),
           "SEQ_BUCKETS": "16,32", "BATCH_BUCKETS": "1,4", "MAX_DECODE_LEN": "40",
           "STREAM_CHUNK_TOKENS": "2", "JOURNAL_DIR": jd, "JOURNAL_FSYNC": "always",
           "PORT": str(port), "HOST": "127.0.0.1"}
    return subprocess.Popen([sys.executable, "-m", "mlmicroservicetemplate_tpu_torch.serve"],
                            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                            start_new_session=True)


def _ready(port: int, proc, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, "server exited"
        try:
            if _http("GET", f"http://127.0.0.1:{port}/readyz", timeout=2).status == 200:
                return
        except OSError:
            time.sleep(0.3)
    raise TimeoutError("server never ready")


@pytest.mark.chaos
def test_crash_smoke(tmp_path):
    """SIGKILL a port server mid-stream, restart it on the same JOURNAL_DIR:
    ``GET /v1/streams/{rid}`` drains the journaled prefix and the
    continuation, each token once, the tokens of an uninterrupted server."""
    body = {"text": "the quick brown fox", "max_tokens": 40, "stream": True}
    ref_port = _free_port()
    ref = _serve(str(tmp_path / "ref"), ref_port)
    try:
        _ready(ref_port, ref)
        want = [json.loads(ln) for ln in _http(
            "POST", f"http://127.0.0.1:{ref_port}/predict", body).read().splitlines()]
    finally:
        os.killpg(ref.pid, signal.SIGTERM)
        ref.wait(30)
    jd = str(tmp_path / "j")
    port = _free_port()
    a = _serve(jd, port)
    try:
        _ready(port, a)
        resp = _http("POST", f"http://127.0.0.1:{port}/predict", body)
        first = [json.loads(resp.readline()) for _ in range(3)]
        assert all("delta" in ev for ev in first)
    finally:
        os.killpg(a.pid, signal.SIGKILL)
        a.wait(30)
    port = _free_port()
    b = _serve(jd, port)
    try:
        _ready(port, b)
        got = [json.loads(ln) for ln in _http(
            "GET", f"http://127.0.0.1:{port}/v1/streams/chaos-1").read().splitlines()]
    finally:
        os.killpg(b.pid, signal.SIGTERM)
        b.wait(30)
    text = "".join(ev.get("delta", "") for ev in got)
    assert text == "".join(ev.get("delta", "") for ev in want)
    assert got[-1]["tokens_generated"] == want[-1]["tokens_generated"]
    assert got[-1]["prediction"] == want[-1]["prediction"]


def test_debug_perf_kernels_on_request(tmp_path):
    """``/debug/perf?kernels=1`` adds the process's kernel launch counters
    and the graphs' replays (what the card check reads from a child); the
    plain route keeps the JAX app's keys (``test_torch_debug_routes.py``)."""
    app, _ = _app("port", str(tmp_path / "j"))
    out = asyncio.run(_drive(app, [("GET", "/debug/perf", None, None),
                                   ("GET", "/debug/perf?kernels=1", None, None)]))
    (s0, plain), (s1, withk) = [(s, json.loads(t)) for s, t in out]
    assert s0 == s1 == 200 and "kernels" not in plain
    assert set(withk) - set(plain) == {"kernels"}
    launches = withk["kernels"]["launches"]
    assert {"paged_decode_attention", "decode_attention", "fused_attention"} <= set(launches)
    assert all(isinstance(n, int) for n in launches.values())
    assert isinstance(withk["kernels"]["graphs"], list)


def test_prefix_spilled_to_disk_promotes_back_like_jax(tmp_path):
    """A host tier of two blocks (one 16-token pin) over the disk rung:
    donors A, B and C pin in turn, each pin evicting the one before; A's,
    demoted to the host, is spilled to disk when B's demotion needs the
    room; A's conversation then finds its prefix on disk and promotes it
    disk -> host -> device.  Tokens, the promotion and spill counts and
    the cache's counts are the JAX loop's (each side on its own
    directory)."""
    from test_torch_kv_tier import TIER, _block_bytes, _first
    from test_torch_prefill_loop import feats, loops

    bb = _block_bytes("gpt2")
    pin = 2 * bb
    rng = np.random.default_rng(0)
    shared = [rng.integers(5, 250, 20).astype(np.int32) for _ in range(3)]
    f_a1, f_b1, f_c1, f_a2 = (feats(np.concatenate([s, rng.integers(5, 250, n).astype(np.int32)]))
                              for s, n in ((shared[0], 5), (shared[1], 5), (shared[2], 5),
                                           (shared[0], 9)))
    outs, states = [], []
    for side in ("jax", "port"):
        kw = dict(TIER, prefix_cache=True, prefix_cache_mb=1.5 * pin / 1e6,
                  kv_host_budget_mb=(pin + bb // 2) / 1e6, kv_disk_budget_mb=1.0,
                  journal_dir=str(tmp_path / side))
        kw.pop("max_stream_queue")
        jloop, jengine, loop, engine = loops("gpt2", **kw)
        lp, eng = (jloop, jengine) if side == "jax" else (loop, engine)
        (loop if side == "jax" else jloop).stop()
        assert eng.kv_host.num_blocks == 2
        try:
            out = []
            for f in (f_a1, f_b1, f_c1):
                out.append(asyncio.run(_first(lp, f)))
                deadline = time.monotonic() + 5.0
                while eng.kv_pool.used_blocks > 2 and time.monotonic() < deadline:
                    time.sleep(0.02)
            spilled = (eng.kv_disk.spills, eng.kv_disk.stats()["prefix_entries"])
            out.append(asyncio.run(_first(lp, f_a2)))
        finally:
            lp.stop()
        outs.append(out)
        states.append((spilled, lp.host_prefix_promotes, eng.kv_disk.promotes,
                       eng.prefix_cache.stats()))
        eng.kv_disk.close()
    assert outs[1] == outs[0]
    assert states[1] == states[0]
    assert states[1][0] == (1, 1) and states[1][1] == 1 and states[1][2] == 1
