"""The port's dynamic batcher and its wait queue, with a stand-in engine:
batch formation, load shedding (503), deadline expiry (504), failure
routing and shutdown."""

import asyncio
import threading
import time
import types

import numpy as np
import pytest

from mlmicroservicetemplate_tpu_torch.scheduler.batcher import (
    Batcher,
    DeadlineExceededError,
    QueueFullError,
)
from mlmicroservicetemplate_tpu_torch.scheduler.policy import DeadlineQueue


class FakeEngine:
    """Records each batch it is given; answers each item with its id."""

    def __init__(self, delay_s: float = 0.0, fail: bool = False):
        self.bundle = types.SimpleNamespace(name="fake")
        self.batches: list[list[int]] = []
        self.delay_s = delay_s
        self.fail = fail
        self.release = threading.Event()
        self.release.set()

    def run_batch(self, feats):
        self.release.wait(5.0)
        time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("device fault")
        self.batches.append([f["id"] for f in feats])
        return [np.array([f["id"]], np.float32) for f in feats]


def _cfg(**kw):
    base = dict(max_batch=4, batch_timeout_ms=20.0, max_queue=64)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _run(engine, cfg, body):
    async def main():
        batcher = Batcher(engine, cfg)
        await batcher.start()
        try:
            return await body(batcher)
        finally:
            engine.release.set()
            await batcher.stop()

    return asyncio.run(main())


def test_burst_forms_full_batches_and_routes_results():
    engine = FakeEngine()

    async def body(b):
        return await asyncio.gather(*(b.submit({"id": i}) for i in range(10)))

    rows = _run(engine, _cfg(), body)
    assert [int(r[0]) for r in rows] == list(range(10))
    assert [len(x) for x in engine.batches] == [4, 4, 2]
    assert sorted(i for x in engine.batches for i in x) == list(range(10))


def test_lone_request_dispatches_after_the_timeout():
    engine = FakeEngine()

    async def body(b):
        t0 = time.monotonic()
        row = await b.submit({"id": 7})
        return row, time.monotonic() - t0

    row, dt = _run(engine, _cfg(batch_timeout_ms=30.0), body)
    assert int(row[0]) == 7 and engine.batches == [[7]]
    assert dt >= 0.025


def test_full_queue_sheds_with_retry_after():
    engine = FakeEngine()
    engine.release.clear()  # the first batch holds the device

    async def body(b):
        first = [asyncio.ensure_future(b.submit({"id": i})) for i in range(2)]
        await asyncio.sleep(0.05)  # both dispatch slots taken, queue empty
        waiting = [asyncio.ensure_future(b.submit({"id": 10 + i})) for i in range(2)]
        await asyncio.sleep(0.01)
        with pytest.raises(QueueFullError) as e:
            await b.submit({"id": 99})
        assert e.value.retry_after_s >= 1.0
        engine.release.set()
        return await asyncio.gather(*first, *waiting)

    rows = _run(engine, _cfg(max_batch=1, max_queue=2), body)
    assert sorted(int(r[0]) for r in rows) == [0, 1, 10, 11]


def test_expired_deadline_fails_before_dispatch():
    engine = FakeEngine()
    engine.release.clear()

    async def body(b):
        busy = [asyncio.ensure_future(b.submit({"id": i})) for i in range(2)]
        await asyncio.sleep(0.05)
        # Every dispatch slot is held, yet the waiter fails on time.
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceededError):
            await b.submit({"id": 5, "deadline_ms": 20.0})
        assert time.monotonic() - t0 < 1.0
        engine.release.set()
        await asyncio.gather(*busy)

    _run(engine, _cfg(max_batch=1), body)
    assert [5] not in engine.batches


def test_engine_failure_fails_every_item_of_the_batch():
    engine = FakeEngine(fail=True)

    async def body(b):
        return await asyncio.gather(
            *(b.submit({"id": i}) for i in range(3)), return_exceptions=True
        )

    out = _run(engine, _cfg(), body)
    assert all(isinstance(e, RuntimeError) for e in out)


def test_stop_finishes_queued_work_and_refuses_new():
    engine = FakeEngine(delay_s=0.01)

    async def main():
        b = Batcher(engine, _cfg(max_batch=2))
        await b.start()
        futs = [asyncio.ensure_future(b.submit({"id": i})) for i in range(6)]
        await asyncio.sleep(0)
        await b.stop()
        with pytest.raises(RuntimeError):
            await b.submit({"id": 9})
        return await asyncio.gather(*futs)

    rows = asyncio.run(main())
    assert sorted(int(r[0]) for r in rows) == list(range(6))


def test_deadline_queue_is_edf_with_fifo_ties():
    q = DeadlineQueue(8)
    now = time.monotonic()
    items = [types.SimpleNamespace(name=n, deadline=d, klass="interactive", started=False)
             for n, d in (("a", None), ("b", now + 5), ("c", None), ("d", now + 1))]
    for it in items:
        q.put(it)
    assert [q.pop_nowait().name for _ in range(4)] == ["d", "b", "a", "c"]
    assert q.pop_nowait() is None


def test_draining_sheds_new_work_as_drain():
    engine = FakeEngine()

    async def body(b):
        row = await b.submit({"id": 1})
        b.draining = True
        with pytest.raises(QueueFullError) as e:
            await b.submit({"id": 2})
        assert e.value.reason == "drain"
        return row

    assert int(_run(engine, _cfg(), body)[0]) == 1
