"""Durable bulk-job state, the backbone of ``/v1/batches``.

Counterpart of the JAX package's ``jobs/store.py``: a job is a manifest of
prompt lines whose per-line progress outlives the process, kept with the
stream journal's machinery (``runtime/durability.py``): one JSON object a
record, framed by a ``<u32 length><u32 crc32>`` header, in append-only
segments ``jobs-NNNNNN.log`` under ``JOURNAL_DIR/jobs``; a torn tail is
truncated at replay, and opening compacts the live state into a fresh
segment.

Records: ``job`` (the manifest: id, idempotency key, creation time and
every line's validated parameters, a sampled line's seed pinned at submit;
written before the submit answers), ``line`` (one line's result, written
before the line counts as done, so a kill loses only lines in flight,
which run again to the same result; a second result of a line is refused
and never written), ``state`` (queued -> running -> completed | cancelled,
with the end's time for the TTL) and ``purge`` (the TTL's tombstone: the
job's records go at the next compaction).  The stream journal's lock on
``JOURNAL_DIR`` makes one process the directory's owner.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid

from ..runtime.durability import SegmentLog, record_bytes
from ..utils import metrics

log = logging.getLogger(__name__)

QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
CANCELLED = "cancelled"
#: The states a startup replay readmits (every non-terminal one).
ACTIVE_STATES = (QUEUED, RUNNING)

#: The most lines a job may have: it bounds one manifest record's size.
MAX_LINES = 10_000


class Job:
    """One bulk job: its manifest and per-line results."""

    __slots__ = ("id", "key", "created", "lines", "results", "state", "done_at")

    def __init__(self, jid: str, key: str | None, created: float, lines: list[dict]):
        self.id = jid
        self.key = key
        self.created = float(created)
        self.lines = lines
        #: line index -> {"text", "tokens", "finish", ("error")}
        self.results: dict[int, dict] = {}
        self.state = QUEUED
        self.done_at: float | None = None

    @property
    def total(self) -> int:
        return len(self.lines)

    @property
    def terminal(self) -> bool:
        return self.state in (COMPLETED, CANCELLED)

    def remaining(self) -> list[int]:
        """The lines with no recorded result: a resume's work list."""
        return [i for i in range(self.total) if i not in self.results]

    def counts(self) -> dict:
        failed = sum(1 for r in self.results.values() if r.get("error"))
        return {"total": self.total, "completed": len(self.results) - failed,
                "failed": failed}

    def to_json(self) -> dict:
        """The API's object (``GET /v1/batches/{id}``)."""
        body = {"id": self.id, "object": "batch", "status": self.state,
                "created_at": self.created, "line_counts": self.counts()}
        if self.key:
            body["idempotency_key"] = self.key
        if self.done_at is not None:
            body["finished_at"] = self.done_at
        return body


class JobStore:
    """The crash-safe store of jobs, lines and results (module docstring).
    Thread-safe: the executor records results while HTTP handlers read."""

    def __init__(self, dir: str, fsync: str = "always", model: str = "", ttl_s: float = 0.0):
        self.dir = dir
        self.ttl_s = max(0.0, float(ttl_s or 0.0))
        os.makedirs(dir, exist_ok=True)
        self._seg = SegmentLog(dir, "jobs-", fsync, model)
        self.fsync = self._seg.fsync
        self.model = self._seg.model
        self._lock: threading.RLock = self._seg._lock
        self.jobs: dict[str, Job] = {}
        self.by_key: dict[str, str] = {}
        purged: set[str] = set()
        segs = self._seg.replay(lambda rec: self._apply(rec, purged), "job store")
        # A TTL past at open purges too.
        now = time.time()
        if self.ttl_s:
            for job in self.jobs.values():
                if job.terminal and job.done_at is not None and now - job.done_at >= self.ttl_s:
                    purged.add(job.id)
        for jid in purged:
            job = self.jobs.pop(jid, None)
            if job is not None and job.key:
                self.by_key.pop(job.key, None)
        self._seg.open_next(segs)
        self._compact_into_open_segment()
        for _, path in segs:
            try:
                os.unlink(path)
            except OSError:
                pass

    @property
    def records_written(self) -> int:
        return self._seg.records_written

    @property
    def torn_bytes(self) -> int:
        return self._seg.torn_bytes

    # -- replay --------------------------------------------------------

    def _apply(self, rec: dict, purged: set[str]) -> None:
        k = rec.get("k")
        jid = str(rec.get("id", ""))
        if k == "job":
            job = Job(jid, rec.get("key") or None, float(rec.get("created", 0.0)),
                      list(rec.get("lines", [])))
            self.jobs[jid] = job
            if job.key:
                self.by_key[job.key] = jid
            purged.discard(jid)
        elif k == "line":
            job = self.jobs.get(jid)
            if job is not None:
                i = int(rec.get("i", -1))
                if 0 <= i < job.total:
                    row = {"text": rec.get("text", ""), "tokens": int(rec.get("tokens", 0)),
                           "finish": rec.get("finish", "stop")}
                    if rec.get("error"):
                        row["error"] = str(rec["error"])
                    job.results[i] = row
        elif k == "state":
            job = self.jobs.get(jid)
            if job is not None:
                job.state = str(rec.get("state", job.state))
                if "t" in rec:
                    job.done_at = float(rec["t"])
        elif k == "purge":
            purged.add(jid)

    def _compact_into_open_segment(self) -> None:
        frames = []
        for job in self.jobs.values():
            frames.append(record_bytes({"k": "job", "id": job.id, "key": job.key,
                                  "created": job.created, "lines": job.lines}))
            for i in sorted(job.results):
                frames.append(record_bytes({"k": "line", "id": job.id, "i": i, **job.results[i]}))
            if job.state != QUEUED:
                rec = {"k": "state", "id": job.id, "state": job.state}
                if job.done_at is not None:
                    rec["t"] = job.done_at
                frames.append(record_bytes(rec))
        self._seg.write_compacted(frames)

    # -- the API -------------------------------------------------------

    def create(self, lines: list[dict], key: str | None = None) -> tuple[Job, bool]:
        """Persist one manifest; returns ``(job, created)``, ``created``
        False when ``key`` names a job already: a retried submit sees the
        first one instead of doubling the work."""
        if not lines:
            raise ValueError("a job needs at least one line")
        if len(lines) > MAX_LINES:
            raise ValueError(f"{len(lines)} lines > MAX_LINES={MAX_LINES}")
        with self._lock:
            if key:
                jid = self.by_key.get(key)
                if jid is not None and jid in self.jobs:
                    return self.jobs[jid], False
            jid = "job-" + uuid.uuid4().hex[:16]
            job = Job(jid, key, time.time(), lines)
            self.jobs[jid] = job
            if key:
                self.by_key[key] = jid
            self._seg.append({"k": "job", "id": jid, "key": key, "created": job.created,
                              "lines": lines})
        return job, True

    def line_done(self, jid: str, i: int, text: str, tokens: int, finish: str,
                  error: str | None = None) -> bool:
        """Record one line's result exactly once, written before the count
        moves; False when the line has one already (nothing written)."""
        with self._lock:
            job = self.jobs.get(jid)
            if job is None or i in job.results:
                return False
            rec = {"k": "line", "id": jid, "i": int(i), "text": text, "tokens": int(tokens),
                   "finish": finish}
            if error:
                rec["error"] = error
            self._seg.append(rec)
            row = {"text": text, "tokens": int(tokens), "finish": finish}
            if error:
                row["error"] = error
            job.results[int(i)] = row
        metrics.JOB_LINES.labels(self.model, "failed" if error else "completed").inc()
        return True

    def set_state(self, jid: str, state: str) -> None:
        with self._lock:
            job = self.jobs.get(jid)
            if job is None or job.state == state or job.terminal:
                return
            job.state = state
            rec = {"k": "state", "id": jid, "state": state}
            if state in (COMPLETED, CANCELLED):
                job.done_at = time.time()
                rec["t"] = job.done_at
            self._seg.append(rec)

    def get(self, jid: str) -> Job | None:
        with self._lock:
            return self.jobs.get(jid)

    def list(self) -> list[Job]:
        with self._lock:
            return sorted(self.jobs.values(), key=lambda j: j.created)

    def sweep(self) -> int:
        """Purge finished jobs older than ``ttl_s`` (0 = keep them); the
        ``purge`` record makes it durable, the next compaction reclaims
        the bytes."""
        if not self.ttl_s:
            return 0
        now = time.time()
        dropped = 0
        with self._lock:
            for jid in list(self.jobs):
                job = self.jobs[jid]
                if job.terminal and job.done_at is not None and now - job.done_at >= self.ttl_s:
                    self._seg.append({"k": "purge", "id": jid})
                    del self.jobs[jid]
                    if job.key:
                        self.by_key.pop(job.key, None)
                    dropped += 1
        return dropped

    def stats(self) -> dict:
        with self._lock:
            active = sum(1 for j in self.jobs.values() if j.state in ACTIVE_STATES)
            return {"dir": self.dir, "jobs_tracked": len(self.jobs), "jobs_active": active,
                    "records_written": self.records_written,
                    "torn_bytes_truncated": self.torn_bytes, "result_ttl_s": self.ttl_s}

    def close(self) -> None:
        self._seg.close()
