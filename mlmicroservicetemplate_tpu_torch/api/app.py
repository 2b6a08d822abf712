"""aiohttp application: ``POST /predict`` plus health and observability.

Request path, as in the JAX package's ``api/app.py``: parse the JSON
``{"text": ...}`` body -> preprocess (thread offloaded) -> dynamic-batching
queue -> engine dispatch -> postprocess -> JSON.  Also ``/healthz``,
``/readyz``, ``/status`` and ``/metrics``.  This is the only module of the
package that imports aiohttp.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time
import uuid

import numpy as np
import torch
from aiohttp import web

from ..models.registry import ModelBundle, RawItem
from ..scheduler.batcher import Batcher, DeadlineExceededError, QueueFullError
from ..utils import metrics, tracing

log = logging.getLogger(__name__)

K_CFG = web.AppKey("cfg", object)
K_BUNDLE = web.AppKey("bundle", ModelBundle)
K_ENGINE = web.AppKey("engine", object)
K_BATCHER = web.AppKey("batcher", Batcher)
K_READY = web.AppKey("ready", asyncio.Event)
K_STARTED_AT = web.AppKey("started_at", float)
K_STATE = web.AppKey("state", dict)


def _error_body(etype: str, message: str, rid: str) -> dict:
    return {"error": {"type": etype, "message": message, "request_id": rid}}


@web.middleware
async def request_id_middleware(request: web.Request, handler):
    """Echo (or mint) X-Request-Id, turn unmapped exceptions into a JSON
    500 that carries it, and record the ``request`` span."""
    rid = request.headers.get("X-Request-Id") or uuid.uuid4().hex[:16]
    request["request_id"] = rid
    t0 = time.monotonic()
    status = 500
    try:
        resp = await handler(request)
        status = resp.status
    except web.HTTPException as e:
        status = e.status
        e.headers.setdefault("X-Request-Id", rid)
        raise
    except Exception as e:
        log.exception("unhandled error on %s (request_id=%s)", request.path, rid)
        return web.json_response(
            _error_body(type(e).__name__, str(e) or "internal error", rid),
            status=500, headers={"X-Request-Id": rid},
        )
    finally:
        tr = tracing.tracer()
        if tr is not None:
            tr.add("request", cat="http", rid=rid, t0=t0, path=request.path,
                   status=status)
    resp.headers.setdefault("X-Request-Id", rid)
    return resp


def build_app(cfg, bundle: ModelBundle, engine, batcher: Batcher) -> web.Application:
    app = web.Application(client_max_size=1024 * 1024, middlewares=[request_id_middleware])
    app[K_CFG] = cfg
    app[K_BUNDLE] = bundle
    app[K_ENGINE] = engine
    app[K_BATCHER] = batcher
    app[K_READY] = asyncio.Event()
    app[K_STARTED_AT] = time.time()
    # Runtime state goes in one mutable dict: aiohttp freezes the app
    # mapping once it starts.
    app[K_STATE] = {"ready_error": None, "warmup_s": None}
    app.router.add_post("/predict", handle_predict)
    app.router.add_get("/healthz", handle_healthz)
    app.router.add_get("/readyz", handle_readyz)
    app.router.add_get("/status", handle_status)
    app.router.add_get("/metrics", handle_metrics)
    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    return app


async def _on_startup(app: web.Application) -> None:
    cfg, engine, batcher = app[K_CFG], app[K_ENGINE], app[K_BATCHER]
    await batcher.start()

    async def warm_then_ready():
        # A failure here is logged and shown by /readyz; the server stays
        # not-ready instead of serving from a broken device.
        try:
            if cfg.warmup:
                loop = asyncio.get_running_loop()
                app[K_STATE]["warmup_s"] = await loop.run_in_executor(None, engine.warmup)
            else:
                # Canary: ready means "the device answers".
                await batcher.submit({"input_ids": np.ones(8, np.int32), "length": 8})
        except asyncio.CancelledError:
            raise
        except Exception as e:
            app[K_STATE]["ready_error"] = f"{type(e).__name__}: {e}"
            log.exception("warmup/canary failed; server will stay not-ready")
            return
        app[K_READY].set()
        log.info("model %s ready", app[K_BUNDLE].name)

    app[K_STATE]["_ready_task"] = asyncio.get_running_loop().create_task(warm_then_ready())


async def _on_cleanup(app: web.Application) -> None:
    task = app[K_STATE].get("_ready_task")
    if task is not None:
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
    await app[K_BATCHER].stop()


def _deadline_field(request: web.Request) -> dict:
    d = request.headers.get("X-Deadline-Ms")
    if d is None:
        return {}
    try:
        dv = float(d)
    except ValueError:
        raise web.HTTPBadRequest(reason="X-Deadline-Ms must be a number") from None
    if not dv > 0:  # also rejects NaN
        raise web.HTTPBadRequest(reason="X-Deadline-Ms must be > 0")
    return {"deadline_ms": dv}


async def _parse_request(request: web.Request) -> RawItem:
    if request.content_type != "application/json":
        raise web.HTTPBadRequest(
            reason='this model takes a JSON body {"text": ...} (image payloads are not ported)'
        )
    try:
        body = await request.json()
    except json.JSONDecodeError:
        raise web.HTTPBadRequest(reason="invalid JSON body") from None
    if not isinstance(body, dict):
        raise web.HTTPBadRequest(reason="JSON body must be an object")
    text = body.get("text") or body.get("input")
    if not isinstance(text, str) or not text:
        raise web.HTTPBadRequest(reason='JSON body needs a non-empty "text" field')
    return RawItem(text=text)


async def handle_predict(request: web.Request) -> web.Response:
    app = request.app
    bundle: ModelBundle = app[K_BUNDLE]
    t0 = time.monotonic()
    try:
        item = await _parse_request(request)
        sched = _deadline_field(request)
    except web.HTTPBadRequest:
        metrics.REQUESTS.labels(bundle.name, "400").inc()
        raise
    loop = asyncio.get_running_loop()
    try:
        feats = await loop.run_in_executor(None, bundle.preprocess, item)
    except ValueError as e:
        metrics.REQUESTS.labels(bundle.name, "400").inc()
        raise web.HTTPBadRequest(reason=str(e) or "undecodable payload") from None
    feats.update(sched)
    feats["request_id"] = request.get("request_id", "")
    try:
        row = await app[K_BATCHER].submit(feats)
        result = bundle.postprocess(row)
    except QueueFullError as e:
        metrics.REQUESTS.labels(bundle.name, "503").inc()
        ra = max(1, int(math.ceil(e.retry_after_s or 1.0)))
        raise web.HTTPServiceUnavailable(
            reason=str(e) or "overloaded, retry later", headers={"Retry-After": str(ra)}
        ) from None
    except DeadlineExceededError:
        metrics.REQUESTS.labels(bundle.name, "504").inc()
        raise web.HTTPGatewayTimeout(
            reason="deadline passed before dispatch; request shed"
        ) from None
    except Exception as e:
        metrics.REQUESTS.labels(bundle.name, "500").inc()
        rid = request.get("request_id", "")
        log.exception("inference dispatch failed (request_id=%s)", rid)
        return web.json_response(
            _error_body(type(e).__name__, "inference failed", rid), status=500
        )
    dt = time.monotonic() - t0
    result["model"] = bundle.name
    result["timing_ms"] = round(dt * 1000.0, 3)
    metrics.REQUESTS.labels(bundle.name, "200").inc()
    metrics.LATENCY.labels(bundle.name).observe(dt)
    return web.json_response(result)


async def handle_healthz(request: web.Request) -> web.Response:
    """Liveness: 200 while the process runs, draining or not."""
    return web.json_response({"alive": True, "draining": request.app[K_BATCHER].draining})


async def handle_readyz(request: web.Request) -> web.Response:
    if request.app[K_BATCHER].draining:
        return web.json_response({"ready": False, "draining": True}, status=503)
    if request.app[K_READY].is_set():
        return web.json_response({"ready": True})
    body = {"ready": False}
    err = request.app[K_STATE]["ready_error"]
    if err:
        body["error"] = err
    return web.json_response(body, status=503)


async def handle_status(request: web.Request) -> web.Response:
    app = request.app
    bundle: ModelBundle = app[K_BUNDLE]
    engine = app[K_ENGINE]
    dev = bundle.device
    body = {
        "model": bundle.name,
        "kind": bundle.kind,
        "ready": app[K_READY].is_set(),
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "max_batch": app[K_CFG].max_batch,
        "uptime_s": round(time.time() - app[K_STARTED_AT], 1),
        "batch_buckets": list(engine.batch_buckets),
        "seq_buckets": list(engine.seq_buckets),
        "warmup_s": app[K_STATE]["warmup_s"],
        "dispatches": engine.dispatches,
        "scheduler": {
            "draining": app[K_BATCHER].draining,
            "pending": app[K_BATCHER].pending_work(),
        },
    }
    err = app[K_STATE]["ready_error"]
    if err:
        body["ready_error"] = err
    return web.json_response(body)


async def handle_metrics(request: web.Request) -> web.Response:
    body, ctype = metrics.render()
    return web.Response(body=body, content_type=ctype.split(";")[0])


async def drain_app(app: web.Application, grace_s: float = 30.0) -> bool:
    """SIGTERM drain: stop admitting (readyz -> 503, new requests 503),
    then wait up to ``grace_s`` for queued and in-flight work."""
    batcher: Batcher = app[K_BATCHER]
    batcher.draining = True
    deadline = time.monotonic() + grace_s
    while batcher.pending_work() > 0 and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
    return batcher.pending_work() == 0
