"""The ``/v1/batches`` HTTP surface, as the JAX package's ``jobs/api.py``.

- ``POST /v1/batches``: submit a job, a JSON body with a ``lines`` array
  or a raw JSONL body (one /predict-shaped object or string a line).
  Each line goes through the /predict JSON validator; a sampled line's
  seed is pinned here, so a re-run after a crash is deterministic.  An
  ``Idempotency-Key`` header (or body field) maps a retried submit onto
  the first job (200; a new job is 201).
- ``GET /v1/batches``: the jobs.
- ``GET /v1/batches/{id}``: one job's status and line counts.
- ``GET /v1/batches/{id}/results``: the finished lines as ndjson, in index
  order (partial while the job runs).
- ``POST /v1/batches/{id}/cancel``: stop at the next chunk boundary.

The routes exist only when the batcher built a ``JobManager``
(``JOBS_ENABLED=1``).
"""

from __future__ import annotations

import json
import logging
import random

from aiohttp import web

log = logging.getLogger(__name__)

K_JOBS = web.AppKey("jobs", object)


def add_job_routes(app: web.Application, manager) -> None:
    app[K_JOBS] = manager
    app.router.add_post("/v1/batches", handle_submit)
    app.router.add_get("/v1/batches", handle_list)
    app.router.add_get("/v1/batches/{jid}", handle_get)
    app.router.add_get("/v1/batches/{jid}/results", handle_results)
    app.router.add_post("/v1/batches/{jid}/cancel", handle_cancel)


def _parse_line(obj, idx: int) -> dict:
    """One line -> its validated manifest entry, the seed pinned."""
    from ..api.app import _parse_json_item

    if isinstance(obj, str):
        obj = {"text": obj}
    if not isinstance(obj, dict):
        raise web.HTTPBadRequest(reason=f"line {idx}: each line must be a JSON object or string")
    try:
        item = _parse_json_item(dict(obj))
    except web.HTTPBadRequest as e:
        raise web.HTTPBadRequest(reason=f"line {idx}: {e.reason}") from None
    seed = item.seed
    if item.temperature > 0.0 and seed is None:
        # Pinned at submit, not at execution: a line run again after a
        # crash reproduces the result the first run would have recorded.
        seed = random.getrandbits(32)
    return {"text": item.text, "temperature": item.temperature, "top_k": item.top_k,
            "top_p": item.top_p, "seed": seed, "max_tokens": item.max_tokens,
            "stop": list(item.stop)}


async def _parse_lines(request: web.Request) -> tuple[list[dict], str | None]:
    """(validated lines, idempotency key) from either body shape."""
    key = request.headers.get("Idempotency-Key")
    if request.content_type == "application/json":
        try:
            body = await request.json()
        except json.JSONDecodeError:
            raise web.HTTPBadRequest(reason="invalid JSON body") from None
        if not isinstance(body, dict) or not isinstance(body.get("lines"), list):
            raise web.HTTPBadRequest(
                reason='JSON body needs a "lines" array (or POST raw JSONL)')
        key = key or body.get("idempotency_key")
        raw = body["lines"]
    else:
        text = (await request.read()).decode("utf-8", "replace")
        raw = []
        for ln in text.splitlines():
            ln = ln.strip()
            if not ln:
                continue
            try:
                raw.append(json.loads(ln))
            except json.JSONDecodeError:
                raise web.HTTPBadRequest(reason=f"line {len(raw)}: invalid JSON") from None
    if not raw:
        raise web.HTTPBadRequest(reason="job has no lines")
    lines = [_parse_line(obj, i) for i, obj in enumerate(raw)]
    return lines, (str(key) if key else None)


async def handle_submit(request: web.Request) -> web.Response:
    from ..api.app import K_BATCHER, _failure
    from ..scheduler.policy import QueueFullError

    manager = request.app[K_JOBS]
    batcher = request.app[K_BATCHER]
    if batcher.draining:
        # A draining server must not take a manifest it will never run.
        _failure(request, manager.model,
                 QueueFullError("server is draining", reason="drain", retry_after_s=5.0))
    lines, key = await _parse_lines(request)
    try:
        job, created = manager.submit(lines, key=key)
    except ValueError as e:
        raise web.HTTPBadRequest(reason=str(e)) from None
    return web.json_response(job.to_json(), status=201 if created else 200)


async def handle_list(request: web.Request) -> web.Response:
    manager = request.app[K_JOBS]
    manager.store.sweep()
    return web.json_response({"object": "list",
                              "data": [j.to_json() for j in manager.store.list()]})


def _job_or_404(request: web.Request):
    manager = request.app[K_JOBS]
    jid = request.match_info["jid"]
    job = manager.store.get(jid)
    if job is None:
        raise web.HTTPNotFound(reason=f"unknown job {jid!r}")
    return manager, job


async def handle_get(request: web.Request) -> web.Response:
    _manager, job = _job_or_404(request)
    return web.json_response(job.to_json())


async def handle_results(request: web.Request) -> web.StreamResponse:
    _manager, job = _job_or_404(request)
    resp = web.StreamResponse(status=200, headers={"Content-Type": "application/x-ndjson",
                                                   "X-Job-Status": job.state})
    resp.enable_chunked_encoding()
    await resp.prepare(request)
    try:
        for i in sorted(job.results):
            r = job.results[i]
            row = {"line": i, "text": r["text"], "tokens": r["tokens"],
                   "finish_reason": r["finish"]}
            if r.get("error"):
                row["error"] = r["error"]
            await resp.write((json.dumps(row) + "\n").encode())
    except ConnectionError:
        pass  # the client left; the results stay for the next fetch
    finally:
        try:
            await resp.write_eof()
        except ConnectionError:
            pass
    return resp


async def handle_cancel(request: web.Request) -> web.Response:
    manager, job = _job_or_404(request)
    job = manager.cancel(job.id) or job
    return web.json_response(job.to_json())
