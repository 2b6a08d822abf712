"""The bulk-job executor: idle-compute backfill behind the SLA scheduler.

Counterpart of the JAX package's ``jobs/executor.py``.  ``JobManager``
turns durable job manifests (``store.py``) into batch-class streams
through the serving stack as it is: each line is one headless stream
submitted through ``Batcher.submit_stream`` with ``priority=batch`` and no
deadline, so the deadline queue's class weights, chunk-boundary
preemption by interactive arrivals, the prefill pacer and the KV ledger
all apply unchanged.  On top: a cap of lines in flight a job
(``JOB_MAX_CONCURRENT_LINES``) that the ``BackfillGovernor`` lowers while
interactive work is live or waiting, claims that stop while draining (the
job resumes at the next boot), a shed line that backs off instead of
spinning on the shed counters, and cancellation at the next chunk
boundary.

Crash safety is the store's: a line's result is written before it counts,
lines in flight run again after a restart (their seeds were pinned at
submit), and ``replay()`` (the app's startup hook, after warm-up and the
stream journal's replay) resumes every unfinished job from its last
completed line.  Lines carry no request id: their durability is the
store's, and a stream-journal record would have the stream replay and the
job replay resume the same work.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..models.registry import KIND_SEQ2SEQ, RawItem
from ..scheduler.policy import BackfillGovernor, QueueFullError
from ..utils import metrics
from .store import CANCELLED, COMPLETED, RUNNING, JobStore

log = logging.getLogger(__name__)

#: Backoff while the scheduler sheds bulk admissions (seconds).
_RETRY_MIN_S = 0.05
_RETRY_MAX_S = 2.0
#: Generic line failures retried before the error becomes the result.
_LINE_RETRIES = 2


class JobManager:
    """The JobStore and the per-job executor tasks (event loop)."""

    def __init__(self, engine, batcher, cfg):
        jdir = getattr(cfg, "journal_dir", None)
        if not jdir:
            raise ValueError(
                "JOBS_ENABLED=1 requires JOURNAL_DIR (the job store "
                "rides the write-ahead journal machinery)"
            )
        if getattr(engine.bundle, "kind", None) != KIND_SEQ2SEQ:
            raise ValueError("JOBS_ENABLED=1 requires a generative (seq2seq) model")
        self.engine = engine
        self.batcher = batcher
        self.bundle = engine.bundle
        self.model = engine.bundle.name
        self.store = JobStore(os.path.join(jdir, "jobs"),
                              fsync=getattr(cfg, "journal_fsync", "always"), model=self.model,
                              ttl_s=getattr(cfg, "job_result_ttl_s", 0.0))
        self.max_lines = max(1, int(getattr(cfg, "job_max_concurrent_lines", 4) or 4))
        self.governor = BackfillGovernor(self.max_lines)
        self._tasks: dict[str, asyncio.Task] = {}
        self._cancelled: set[str] = set()
        self.replayed: dict | None = None

    # -- lifecycle -----------------------------------------------------

    def submit(self, lines: list[dict], key: str | None = None):
        """Persist and launch one job (event loop); ``(job, created)``,
        ``created`` False when the idempotency key named a job already."""
        job, created = self.store.create(lines, key=key)
        if created:
            self._launch(job)
        return job, created

    def cancel(self, jid: str):
        """Mark a job ``cancelled`` (journaled) and stop its lines at the
        next chunk boundary; a finished job stays as it is."""
        job = self.store.get(jid)
        if job is None:
            return None
        if not job.terminal:
            unfinished = len(job.remaining())
            self._cancelled.add(jid)
            self.store.set_state(jid, CANCELLED)
            task = self._tasks.get(jid)
            if task is not None and not task.done():
                task.cancel()
            if unfinished:
                metrics.JOB_LINES.labels(self.model, "cancelled").inc(unfinished)
        return job

    def replay(self) -> dict:
        """The startup readmission: every unfinished job resumes from its
        last completed line; one whose lines all finished before the kill
        is closed here."""
        counts = {"resumed": 0, "complete": 0, "failed": 0}
        for job in self.store.list():
            if job.terminal:
                continue
            try:
                if not job.remaining():
                    self.store.set_state(job.id, COMPLETED)
                    counts["complete"] += 1
                else:
                    self._launch(job)
                    counts["resumed"] += 1
            except Exception:
                log.exception("job replay: could not resume %s", job.id)
                counts["failed"] += 1
        for outcome, n in counts.items():
            if n:
                metrics.JOB_REPLAYS.labels(self.model, outcome).inc(n)
        self.replayed = counts
        if counts["resumed"]:
            log.info("job replay: %d incomplete job(s) re-admitted from their last "
                     "completed line", counts["resumed"])
        return counts

    async def stop(self) -> None:
        for task in list(self._tasks.values()):
            task.cancel()
        for task in list(self._tasks.values()):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        self._note_active()
        self.store.close()

    def active_jobs(self) -> int:
        return sum(1 for t in self._tasks.values() if not t.done())

    def stats(self) -> dict:
        body = self.store.stats()
        body["executor_active"] = self.active_jobs()
        body["max_concurrent_lines"] = self.max_lines
        if self.replayed is not None:
            body["replay"] = self.replayed
        return body

    # -- executor ------------------------------------------------------

    def _note_active(self) -> None:
        metrics.JOBS_ACTIVE.labels(self.model).set(self.active_jobs())

    def _launch(self, job) -> None:
        task = asyncio.get_running_loop().create_task(self._run_job(job))
        self._tasks[job.id] = task
        task.add_done_callback(lambda _t: self._note_active())
        self._note_active()

    async def _run_job(self, job) -> None:
        self.store.set_state(job.id, RUNNING)
        pending = job.remaining()
        in_flight: set[asyncio.Task] = set()
        try:
            while pending or in_flight:
                if job.id in self._cancelled:
                    break
                # Draining: lines in flight finish, no new claims (the
                # store resumes the rest at the next boot).
                claiming = not self.batcher.draining
                target = (self.governor.target(*self.batcher.interactive_load())
                          if claiming else 0)
                while pending and len(in_flight) < target:
                    i = pending.pop(0)
                    in_flight.add(asyncio.get_running_loop().create_task(
                        self._run_line(job, i)))
                if not in_flight:
                    if not claiming:
                        return  # draining: the job stays resumable
                    await asyncio.sleep(_RETRY_MIN_S)
                    continue
                done, in_flight = await asyncio.wait(in_flight, timeout=0.25,
                                                     return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    exc = t.exception() if not t.cancelled() else None
                    if exc is not None:
                        raise exc
            if job.id not in self._cancelled and not job.remaining():
                self.store.set_state(job.id, COMPLETED)
                self.store.sweep()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("job %s executor failed", job.id)
        finally:
            for t in in_flight:
                t.cancel()
            for t in in_flight:
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass

    def _line_item(self, line: dict) -> RawItem:
        return RawItem(
            text=str(line.get("text", "")), stream=True,
            temperature=float(line.get("temperature", 0.0) or 0.0),
            top_k=int(line.get("top_k", 0) or 0),
            top_p=float(line.get("top_p", 1.0) or 1.0),
            seed=int(line["seed"]) if line.get("seed") is not None else None,
            max_tokens=int(line["max_tokens"]) if line.get("max_tokens") is not None else None,
            stop=tuple(line.get("stop") or ()),
        )

    async def _run_line(self, job, i: int) -> None:
        """One line, once: preprocess, a batch-class stream, its result
        record.  A shed retries with backoff (bulk has no deadline); a
        generation error retries ``_LINE_RETRIES`` times and then is the
        line's result (the job still completes)."""
        # The interactive streams' delta machinery (stop strings,
        # max_tokens, finish_reason); imported here so that loading the
        # scheduler never loads the API.
        from ..api.app import _delta_stream
        from ..engine.streams import StreamClosedError
        from ..scheduler.policy import DeadlineExceededError

        item = self._line_item(job.lines[i])
        loop = asyncio.get_running_loop()
        feats = await loop.run_in_executor(None, self.bundle.preprocess, item)
        feats["priority"] = "batch"
        feats["deadline_ms"] = 0.0  # bulk lines never 504
        if item.seed is not None:
            feats["seed"] = item.seed
        backoff = _RETRY_MIN_S
        failures = 0
        while True:
            if job.id in self._cancelled or self.batcher.draining:
                return
            adm = getattr(self.batcher, "admission", None)
            if adm is not None and not adm.backfill_ok():
                # No headroom: defer the claim rather than shed it.
                await asyncio.sleep(backoff)
                backoff = min(_RETRY_MAX_S, backoff * 2)
                continue
            try:
                gen = self.batcher.submit_stream(dict(feats))
            except QueueFullError as e:
                await asyncio.sleep(min(_RETRY_MAX_S, e.retry_after_s or backoff))
                backoff = min(_RETRY_MAX_S, backoff * 2)
                continue
            try:
                final = None
                async for ev in _delta_stream(self.bundle, gen, item):
                    if ev.get("done"):
                        final = ev
                if final is None:
                    raise RuntimeError("line stream produced no final event")
                self.store.line_done(job.id, i, final["text"], final["tokens"],
                                     final["finish_reason"])
                return
            except (QueueFullError, DeadlineExceededError, StreamClosedError) as e:
                # Shed in the queue (eviction, a drain race): later.
                await asyncio.sleep(min(_RETRY_MAX_S,
                                        getattr(e, "retry_after_s", None) or backoff))
                backoff = min(_RETRY_MAX_S, backoff * 2)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                failures += 1
                if failures > _LINE_RETRIES:
                    log.exception("job %s line %d failed terminally", job.id, i)
                    self.store.line_done(job.id, i, "", 0, "error",
                                         error=str(e) or type(e).__name__)
                    return
                await asyncio.sleep(backoff)
                backoff = min(_RETRY_MAX_S, backoff * 2)
            finally:
                try:
                    await gen.aclose()
                except Exception:
                    pass
