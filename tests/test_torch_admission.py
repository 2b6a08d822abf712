"""The port's priority classes and admission controller against the JAX
package's (``scheduler/policy.py``, ``scheduler/admission.py``), on the same
inputs:

- ``DeadlineQueue``: EDF within a class, the class-weighted dequeue, the
  overflow victim (lowest class, latest deadline, only if the newcomer
  outranks it), ``evict_for``, expiry sparing ``started`` items,
  ``waiting_started``, ``prefer_interactive`` and the ``fits`` gate give the
  JAX queue's answers.
- ``AdmissionController``: a request that can never fit the KV budget
  sheds ``kv_budget``, transient overcommit down-classes interactive to
  batch, the budget gates dequeue, drain sheds ``drain``; paged, the block
  ledger: the same decisions as the JAX controller.
- The batcher: a later interactive request dispatches before earlier batch
  ones, an interactive newcomer to a full queue evicts the latest batch
  waiter (503), the budget holds a request until capacity returns, as in
  the JAX batcher; the per-stream path keeps the drain and KV gates.
- ``InferenceEngine.kv_bytes_estimate`` and ``kv_blocks_estimate`` equal
  the JAX engine's for llama (dense and int8 cache), GPT-2 and T5 (its
  cross-attention term included) at small configs, f32 on the CPU, and a
  ``KV_BUDGET_MB`` pool holds the JAX engine's blocks.
"""

import asyncio
import json
import os
import threading
import time
import types

import numpy as np
import pytest

from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler import Batcher as JaxBatcher
from mlmicroservicetemplate_tpu.scheduler import admission as jax_admission
from mlmicroservicetemplate_tpu.scheduler import policy as jax_policy
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.scheduler import admission, policy
from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
from mlmicroservicetemplate_tpu_torch.serve import build_service

SIDES = ((policy, admission, Batcher), (jax_policy, jax_admission, JaxBatcher))
INTERACTIVE, BATCH = policy.INTERACTIVE, policy.BATCH


def _item(name, klass=INTERACTIVE, deadline=None, kv=0, started=False):
    return types.SimpleNamespace(name=name, klass=klass, deadline=deadline, started=started,
                                 kv=kv, kv_held=False, tenant="")


def _both(build):
    """``build(policy module)`` on the port and on the JAX package."""
    return [build(side[0]) for side in SIDES]


# ---------------------------------------------------------------------------
# the queue


def test_edf_within_class_like_jax():
    now = 100.0

    def run(pol):
        q = pol.DeadlineQueue(16, clock=lambda: now)
        for name, dl in (("a", now + 3), ("b", now + 1), ("c", None), ("d", now + 2),
                         ("e", None)):
            q.put(_item(name, deadline=dl))
        return [q.pop_nowait().name for _ in range(5)], q.pop_nowait()

    got, want = _both(run)
    assert got == want == (["b", "d", "a", "c", "e"], None)


@pytest.mark.parametrize("weight", [1, 2, 4])
def test_class_weighted_dequeue_like_jax(weight):
    def run(pol):
        q = pol.DeadlineQueue(32, weight=weight)
        for i in range(7):
            q.put(_item(f"i{i}"))
        for i in range(4):
            q.put(_item(f"b{i}", BATCH))
        order = [q.pop_nowait().name for _ in range(5)]
        q.prefer_interactive()
        return order + [q.pop_nowait().name for _ in range(6)]

    got, want = _both(run)
    assert got == want
    assert got[:weight + 1] == [f"i{i}" for i in range(weight)] + ["b0"]


def test_overflow_evicts_lowest_class_latest_deadline_like_jax():
    now = time.monotonic()

    def run(pol):
        out = []
        q = pol.DeadlineQueue(2)
        q.put(_item("b_early", BATCH, now + 1))
        q.put(_item("b_late", BATCH, now + 5))
        out.append(q.put(_item("i", INTERACTIVE)).name)
        q2 = pol.DeadlineQueue(1)
        q2.put(_item("i"))
        with pytest.raises(pol.QueueFullError):
            q2.put(_item("b", BATCH))
        q3 = pol.DeadlineQueue(1)
        q3.put(_item("late", deadline=now + 10))
        out.append(q3.put(_item("early", deadline=now + 1)).name)
        with pytest.raises(pol.QueueFullError):
            q3.put(_item("later", deadline=now + 20))
        # Started waiters are never evicted; evict_for takes without adding.
        q4 = pol.DeadlineQueue(4)
        q4.put(_item("resumed", BATCH, now + 9, started=True))
        q4.put(_item("b", BATCH, now + 2))
        out.append(q4.evict_for(_item("x", INTERACTIVE)).name)
        out.append(q4.evict_for(_item("y", INTERACTIVE)))
        out.append((q4.qsize(), q4.waiting(BATCH), q4.waiting_started()))
        out.append(q4.put(_item("forced"), force=True))
        return out

    got, want = _both(run)
    assert got == want == ["b_late", "late", "b", None, (1, 1, 1), None]


def test_expiry_spares_started_and_pop_gates_on_fits_like_jax():
    now = [50.0]

    def run(pol):
        q = pol.DeadlineQueue(8, clock=lambda: now[0])
        for it in (_item("stale", deadline=49.0), _item("fresh", deadline=110.0, kv=5),
                   _item("resumed", BATCH, 40.0, kv=1, started=True),
                   _item("small", deadline=120.0, kv=1)):
            q.put(it)
        expired = [it.name for it in q.expire()]
        nd = q.next_deadline()
        fits = lambda it: it.kv <= 2  # noqa: E731
        popped = [q.pop_nowait(fits=fits).name, q.pop_nowait(fits=fits).name,
                  q.pop_nowait(fits=fits), q.pop(timeout=0.01, fits=fits)]
        return expired, nd, popped, q.qsize(), q.pop_nowait().name

    got, want = _both(run)
    assert got == want == (["stale"], 110.0, ["small", "resumed", None, None], 1, "fresh")


def test_pop_waits_for_a_waiter_that_fits():
    q = policy.DeadlineQueue(4)
    big = _item("big", kv=9)
    q.put(big)
    threading.Timer(0.02, lambda: q.put(_item("small", kv=1))).start()
    assert q.pop(timeout=10.0, fits=lambda it: it.kv < 5).name == "small"
    assert q.pop_nowait() is big


# ---------------------------------------------------------------------------
# the controller


def _fake_engine(**kw):
    return types.SimpleNamespace(bundle=types.SimpleNamespace(name="fake"),
                                 kv_bytes_estimate=lambda feats: int(feats.get("kv", 0)), **kw)


def _cfg(**kw):
    base = dict(max_batch=1, batch_timeout_ms=2.0, max_queue=1024, pipeline_depth=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_kv_budget_sheds_and_downclasses_like_jax():
    def run(side):
        pol, adm_mod, _ = side
        adm = adm_mod.AdmissionController(_cfg(kv_budget_mb=1.0), _fake_engine())
        out = []
        with pytest.raises(pol.QueueFullError) as e:
            adm.admit({"kv": 2_000_000}, INTERACTIVE)
        out.append(e.value.reason)
        held = types.SimpleNamespace(kv=800_000, kv_held=False)
        adm.reserve(held)
        out.append(adm.admit({"kv": 500_000}, INTERACTIVE))
        out.append(adm.admit({"kv": 500_000}, BATCH))
        out.append((adm.fits(types.SimpleNamespace(kv=500_000)), adm.committed_bytes))
        adm.release(held)
        adm.release(held)  # once only
        out.append((adm.fits(types.SimpleNamespace(kv=500_000)), adm.committed_bytes))
        out.append(adm.admit({"kv": 500_000}, INTERACTIVE))
        out.append(adm.classify({"priority": "batch"})[0])
        out.append(adm.classify({"priority": "BATCH"})[0])
        adm.draining = True
        with pytest.raises(pol.QueueFullError) as e:
            adm.admit({"kv": 1}, BATCH)
        out.append((e.value.reason, e.value.retry_after_s))
        return out

    got, want = [run(side) for side in SIDES]
    assert got == want
    assert got[1] == (BATCH, 500_000) and got[3] == (False, 800_000)


def test_priority_default_and_deadline_default_like_jax():
    def run(side):
        adm = side[1].AdmissionController(_cfg(priority_default="batch", deadline_ms=250.0),
                                          _fake_engine())
        t0 = time.monotonic()
        klass, dl = adm.classify({})
        k2, dl2 = adm.classify({"priority": "interactive", "deadline_ms": 1000.0})
        return klass, 0.25 <= dl - t0 < 0.35, k2, 1.0 <= dl2 - t0 < 1.1

    got, want = [run(side) for side in SIDES]
    assert got == want == (BATCH, True, INTERACTIVE, True)


class _Pool:
    """A stand-in block pool with the JAX pool's read surface."""

    def __init__(self, num, used, block_bytes):
        self.num_blocks, self.used_blocks, self.block_bytes = num, used, block_bytes

    @property
    def free_blocks(self):
        return self.num_blocks - self.used_blocks

    @property
    def used_bytes(self):
        return self.used_blocks * self.block_bytes


def test_paged_block_ledger_like_jax():
    def run(side):
        pol, adm_mod, _ = side
        pool = _Pool(10, 0, 100)
        eng = _fake_engine(paged_kv=True, kv_pool=pool,
                           kv_blocks_estimate=lambda f: (f["initial"], f["worst"]))
        adm = adm_mod.AdmissionController(_cfg(kv_budget_mb=0.0), eng)
        out = []
        with pytest.raises(pol.QueueFullError) as e:
            adm.admit({"initial": 2, "worst": 11}, INTERACTIVE)
        out.append(e.value.reason)
        out.append(adm.admit({"initial": 3, "worst": 10}, INTERACTIVE))
        pool.used_blocks = 8
        out.append(adm.admit({"initial": 3, "worst": 10}, INTERACTIVE))
        stream = types.SimpleNamespace(is_stream=True, kv=300, kv_held=False)
        out.append(adm.fits(stream))
        pool.used_blocks = 7
        out.append(adm.fits(stream))
        adm.reserve(stream)
        out.append((stream.kv_held, adm.committed_bytes))
        out.append(adm.kv_bytes_for_resume({"initial": 4, "worst": 9}))
        return out

    got, want = [run(side) for side in SIDES]
    assert got == want == ["kv_budget", (INTERACTIVE, 300), (BATCH, 300), False, True,
                           (False, 700), 400]


# ---------------------------------------------------------------------------
# the batcher


class _Engine:
    """Answers each item with its id, each batch held ``delay_s``; records
    the order."""

    def __init__(self, delay_s=0.05, kv=False):
        self.bundle = types.SimpleNamespace(name="fake")
        self.delay_s = delay_s
        self.served: list = []
        if kv:
            self.kv_bytes_estimate = lambda feats: int(feats.get("kv", 0))

    def run_batch(self, feats):
        time.sleep(self.delay_s)
        self.served.extend(f["id"] for f in feats)
        return [np.array([0]) for _ in feats]


async def _served(batcher_cls, engine, cfg, body):
    b = batcher_cls(engine, cfg)
    await b.start()
    try:
        return await body(b)
    finally:
        await b.stop()


def test_priority_orders_dequeue_like_jax():
    async def body(b):
        first = asyncio.ensure_future(b.submit({"id": "warm"}))
        await asyncio.sleep(0.02)
        tasks = [asyncio.ensure_future(b.submit({"id": f"b{i}", "priority": "batch"}))
                 for i in range(3)]
        await asyncio.sleep(0)
        tasks.append(asyncio.ensure_future(b.submit({"id": "i0", "priority": "interactive"})))
        await asyncio.gather(first, *tasks)

    orders = []
    for _, _, batcher_cls in SIDES:
        eng = _Engine()
        asyncio.run(_served(batcher_cls, eng, _cfg(), body))
        orders.append(eng.served)
    assert orders[0] == orders[1] == ["warm", "i0", "b0", "b1", "b2"]


def test_full_queue_evicts_a_batch_waiter_like_jax():
    async def body(b):
        first = asyncio.ensure_future(b.submit({"id": "warm"}))
        await asyncio.sleep(0.02)
        waiting = [asyncio.ensure_future(b.submit({"id": f"b{i}", "priority": "batch",
                                                   "deadline_ms": 1000.0 * (i + 1)}))
                   for i in range(2)]
        await asyncio.sleep(0)
        inter = asyncio.ensure_future(b.submit({"id": "i0"}))
        out = await asyncio.gather(first, *waiting, inter, return_exceptions=True)
        return [type(r).__name__ if isinstance(r, Exception) else "ok" for r in out]

    results = []
    for _, _, batcher_cls in SIDES:
        eng = _Engine()
        results.append((asyncio.run(_served(batcher_cls, eng, _cfg(max_queue=2), body)),
                        eng.served))
    assert results[0] == results[1] == (["ok", "ok", "QueueFullError", "ok"],
                                        ["warm", "i0", "b0"])


def test_kv_budget_holds_a_request_until_capacity_returns_like_jax():
    """Budget 1 MB: a 0.8 MB request dispatches, the 0.5 MB one behind it
    (down-classed) waits until the first releases; one over the budget
    sheds ``kv_budget``."""
    async def body(b):
        a = asyncio.ensure_future(b.submit({"id": "a", "kv": 800_000}))
        await asyncio.sleep(0.01)
        c = asyncio.ensure_future(b.submit({"id": "c", "kv": 500_000}))
        await asyncio.sleep(0.01)
        committed = b.admission.committed_bytes
        try:
            await b.submit({"id": "x", "kv": 2_000_000})
        except Exception as e:  # noqa: BLE001
            shed = e.reason
        await asyncio.gather(a, c)
        return committed, shed, b.admission.committed_bytes

    results = []
    for _, _, batcher_cls in SIDES:
        eng = _Engine(delay_s=0.1, kv=True)
        results.append((asyncio.run(_served(batcher_cls, eng,
                                            _cfg(kv_budget_mb=1.0, pipeline_depth=2), body)),
                        eng.served))
    assert results[0] == results[1] == ((800_000, "kv_budget", 0), ["a", "c"])


# ---------------------------------------------------------------------------
# the engine's estimates

SMALL_LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
                   d_ff=512, max_position=128)
SERVE = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=10,
             stream_chunk_tokens=4, kv_block_size=8)
LENGTHS = ((1, None), (10, 3), (16, None), (17, 7), (32, 10), (32, 64))


def _engines(model: str, **extra):
    """The JAX and the port engine of ``model`` at a small config."""
    from test_torch_gpt import small_gpt2
    from test_torch_t5_serving import small_t5

    quant = extra.pop("quant_kv", None)
    kw = dict(SERVE, **extra)
    ctx = {"gpt2": small_gpt2, "t5-small": small_t5}.get(model)
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL_LLAMA)
    try:
        with (ctx() if ctx else _nothing()):
            jcfg = JaxServiceConfig(device="cpu", model_name=model, warmup=False,
                                    quant_kv=quant, **kw)
            jengine = JaxEngine(jax_build_model(jcfg), jcfg, ReplicaSet(make_mesh(1)))
            env = {"MODEL_NAME": model, "DEVICE": "cpu", "WARMUP": "0",
                   "LLAMA_CONFIG": json.dumps(SMALL_LLAMA),
                   **{k.upper(): (",".join(map(str, v)) if isinstance(v, tuple)
                                  else "1" if v is True else str(v)) for k, v in kw.items()}}
            if quant:
                env["QUANT_KV"] = quant
            _, _, engine, _ = build_service(env)
    finally:
        del os.environ["LLAMA_CONFIG"]
    return jengine, engine


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("model,extra", [
    ("llama", {}), ("llama", {"quant_kv": "int8"}), ("gpt2", {}), ("t5-small", {}),
    ("llama", {"paged_kv": True}), ("gpt2", {"paged_kv": True, "kv_budget_mb": 0.3}),
], ids=["llama", "llama-int8", "gpt2", "t5", "llama-paged", "gpt2-paged-budget"])
def test_kv_estimates_equal_the_jax_engines(model, extra):
    jengine, engine = _engines(model, **extra)
    for length, max_tokens in LENGTHS:
        feats = {"input_ids": np.ones(length, np.int32), "length": np.int32(length)}
        if max_tokens is not None:
            feats["max_tokens"] = max_tokens
        assert engine.kv_bytes_estimate(feats) == jengine.kv_bytes_estimate(feats) > 0
        assert engine.kv_blocks_estimate(feats) == jengine.kv_blocks_estimate(feats)
    assert engine.kv_token_bytes() == jengine.kv_token_bytes()
    if engine.paged_kv:
        assert (engine.kv_pool.num_blocks, engine.kv_pool.block_bytes) == (
            jengine.kv_pool.num_blocks, jengine.kv_pool.block_bytes)
        assert engine.kv_pool.used_bytes == 0
