"""aiohttp application: ``POST /predict`` plus health and observability.

Request path, as in the JAX package's ``api/app.py``: parse the body (JSON
``{"text": ...}``; multipart with a ``file``/``image``/``upload`` part, or
any part with a filename, or a ``text`` part; or raw image bytes) ->
preprocess (thread offloaded: image decode, or tokenize) -> dynamic-
batching queue -> engine dispatch -> postprocess -> JSON.  A generative
model also takes ``max_tokens``, ``stop`` and the sampling fields
(``temperature``, ``top_k``, ``top_p``, ``seed``) on ``/predict`` and
answers ``POST /v1/completions`` and ``POST /v1/chat/completions`` (the
message list rendered by ``CHAT_TEMPLATE``, ``api/chat.py``); with
``stream: true`` they stream through the continuous decode loop (or the
per-stream path: a prompt past the largest seq bucket, or
``CONTINUOUS_BATCHING=0``), ``/predict`` as ndjson lines of text deltas and the ``/v1`` routes as
server-sent events ending in ``data: [DONE]``.  Also ``GET /v1/models``,
``/healthz``, ``/readyz``, ``/status`` and ``/metrics``.  With ``SERVER_URL`` set, the
app registers with its parent on startup (``api/registration.py``).  The
``api`` package is the only part of the port that imports aiohttp.
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

from ..engine.streams import StreamClosedError
from ..models.registry import KIND_IMAGE, KIND_SEQ2SEQ, ModelBundle, RawItem
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
    # Image uploads: up to 32 MiB, as the JAX package takes.
    app = web.Application(client_max_size=32 * 1024 * 1024,
                          middlewares=[request_id_middleware])
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
    app.router.add_post("/v1/completions", handle_completions)
    app.router.add_post("/v1/chat/completions", handle_chat_completions)
    app.router.add_get("/v1/models", handle_models)
    app.router.add_get("/healthz", handle_healthz)
    app.router.add_get("/readyz", handle_readyz)
    app.router.add_get("/status", handle_status)
    app.router.add_get("/metrics", handle_metrics)

    # A misconfigured CHAT_TEMPLATE fails at startup, not as 500s once the
    # server is ready; a tokenizer that shatters the template's markers was
    # not tuned on it, which is logged and shown on /status.
    from .chat import TEMPLATES, validate_chat_template

    template = cfg.chat_template
    if template not in TEMPLATES:
        raise ValueError(f"unknown CHAT_TEMPLATE {template!r} ({'|'.join(TEMPLATES)})")
    warnings = (validate_chat_template(template, bundle.tokenizer)
                if bundle.kind == KIND_SEQ2SEQ else [])
    for w in warnings:
        log.warning("%s", w)
    app[K_STATE]["chat_template"] = template
    app[K_STATE]["chat_template_warnings"] = warnings
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
                app[K_STATE]["warmup_s"] = await loop.run_in_executor(
                    None, batcher.warm_engine)
                app[K_STATE]["warmup_s"] += await loop.run_in_executor(
                    None, batcher.warm_streams)
            else:
                # Canary: ready means "the device answers".
                await batcher.submit(_canary_feats(app[K_BUNDLE]))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            app[K_STATE]["ready_error"] = f"{type(e).__name__}: {e}"
            log.exception("warmup/canary failed; server will stay not-ready")
            return
        app[K_READY].set()
        log.info("model %s ready", app[K_BUNDLE].name)

    app[K_STATE]["_ready_task"] = asyncio.get_running_loop().create_task(warm_then_ready())
    if cfg.server_url:
        from .registration import registration_loop

        app[K_STATE]["_register_task"] = asyncio.get_running_loop().create_task(
            registration_loop(cfg, app[K_BUNDLE].name))


def _canary_feats(bundle: ModelBundle) -> dict:
    """The smallest real request: a zero uint8 image (the wire type of every
    image) or eight tokens."""
    if bundle.kind == KIND_IMAGE:
        return {"image": np.zeros((bundle.image_size, bundle.image_size, 3), np.uint8)}
    return {"input_ids": np.ones(8, np.int32), "length": 8}


async def _on_cleanup(app: web.Application) -> None:
    for key in ("_ready_task", "_register_task"):
        task = app[K_STATE].get(key)
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    await app[K_BATCHER].stop()


def _sched_fields(request: web.Request) -> dict:
    """X-Priority / X-Deadline-Ms headers -> the scheduling fields of the
    feats dict that the admission controller reads (``priority``,
    ``deadline_ms``); a malformed header answers 400 with the JAX package's
    reason.  A request without them takes ``PRIORITY_DEFAULT`` and
    ``DEADLINE_MS``."""
    out: dict = {}
    p = request.headers.get("X-Priority")
    if p is not None:
        p = p.strip().lower()
        if p not in ("interactive", "batch"):
            raise web.HTTPBadRequest(reason='X-Priority must be "interactive" or "batch"')
        out["priority"] = p
    d = request.headers.get("X-Deadline-Ms")
    if d is not None:
        try:
            dv = float(d)
        except ValueError:
            raise web.HTTPBadRequest(reason="X-Deadline-Ms must be a number") from None
        if not dv > 0:  # also rejects NaN
            raise web.HTTPBadRequest(reason="X-Deadline-Ms must be > 0")
        out["deadline_ms"] = dv
    return out


async def _parse_request(request: web.Request) -> RawItem:
    """JSON, multipart or raw image bytes -> a RawItem; whether the model
    takes what came is ``bundle.preprocess``'s call."""
    ctype = request.content_type
    if ctype == "application/json":
        try:
            body = await request.json()
        except json.JSONDecodeError:
            raise web.HTTPBadRequest(reason="invalid JSON body") from None
        if not isinstance(body, dict):
            raise web.HTTPBadRequest(reason="JSON body must be an object")
        return _parse_json_item(body)
    if ctype.startswith("multipart/"):
        reader = await request.multipart()
        async for part in reader:
            if part.name in ("file", "image", "upload") or part.filename is not None:
                data = await part.read(decode=False)
                if data:
                    return RawItem(image=bytes(data))
            elif part.name == "text":
                text = (await part.text()).strip()
                if text:
                    return RawItem(text=text)
        raise web.HTTPBadRequest(reason="multipart body had no file/image/text part")
    # Raw image bytes (image/* or octet-stream).
    data = await request.read()
    if not data:
        raise web.HTTPBadRequest(reason="empty request body")
    return RawItem(image=data)


def _parse_json_item(body: dict) -> RawItem:
    """Validate a JSON /predict-shaped body into a RawItem (shared with the
    /v1 translations; every failure is an HTTPBadRequest)."""
    text = body.get("text") or body.get("input")
    if not isinstance(text, str) or not text:
        raise web.HTTPBadRequest(reason='JSON body needs a non-empty "text" field')
    try:
        temperature = float(body.get("temperature") or 0.0)
        top_k = int(body.get("top_k") or 0)
        top_p = float(body.get("top_p") if body.get("top_p") is not None else 1.0)
        seed = body.get("seed")
        seed = int(seed) if seed is not None else None
    except (TypeError, ValueError):
        raise web.HTTPBadRequest(
            reason="temperature/top_p must be numbers, top_k/seed integers"
        ) from None
    if temperature < 0 or not (0.0 < top_p <= 1.0) or top_k < 0:
        raise web.HTTPBadRequest(reason="need temperature >= 0, 0 < top_p <= 1, top_k >= 0")
    if seed is not None and not (0 <= seed < 2**32):
        raise web.HTTPBadRequest(reason="seed must be in [0, 2**32)")
    try:
        max_tokens = body.get("max_tokens")
        max_tokens = int(max_tokens) if max_tokens is not None else None
    except (TypeError, ValueError):
        raise web.HTTPBadRequest(reason="max_tokens must be an integer") from None
    if max_tokens is not None and max_tokens < 1:
        raise web.HTTPBadRequest(reason="max_tokens must be >= 1")
    stop = body.get("stop")
    if stop is None:  # JSON null == absent
        stop = ()
    if isinstance(stop, str):
        stop = (stop,)
    if not isinstance(stop, (list, tuple)) or len(stop) > 8 or not all(
        isinstance(s, str) and s for s in stop
    ):
        raise web.HTTPBadRequest(reason='"stop" must be a non-empty string or a list of up to 8')
    return RawItem(text=text, stream=bool(body.get("stream", False)),
                   temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
                   max_tokens=max_tokens, stop=tuple(stop))


async def handle_predict(request: web.Request) -> web.Response:
    app = request.app
    bundle: ModelBundle = app[K_BUNDLE]
    t0 = time.monotonic()
    generative = bundle.kind == KIND_SEQ2SEQ
    try:
        item = await _parse_request(request)
        if request.query.get("stream", "") in ("1", "true"):
            item.stream = True
        sched = _sched_fields(request)
    except web.HTTPBadRequest:
        metrics.REQUESTS.labels(bundle.name, "400").inc()
        raise
    feats = await _preprocess(request, bundle, item, sched)
    if generative and item.stream:
        return await _stream_predict(request, feats, t0, item)
    try:
        row = await app[K_BATCHER].submit(feats)
        if generative and item.max_tokens is not None:
            row = row[: item.max_tokens]
        result = bundle.postprocess(row)
        if generative and item.stop:
            result["prediction"]["text"] = _apply_stop(result["prediction"]["text"], item.stop)
    except Exception as e:
        return _failure(request, bundle.name, e)
    dt = time.monotonic() - t0
    result["model"] = bundle.name
    result["timing_ms"] = round(dt * 1000.0, 3)
    metrics.REQUESTS.labels(bundle.name, "200").inc()
    metrics.LATENCY.labels(bundle.name).observe(dt)
    return web.json_response(result)


async def _preprocess(request: web.Request, bundle: ModelBundle, item: RawItem,
                      sched: dict) -> dict:
    """Decode or tokenize off the event loop; an undecodable payload is a
    400 (``OSError`` covers PIL's ``UnidentifiedImageError`` on corrupt
    bytes)."""
    loop = asyncio.get_running_loop()
    try:
        feats = await loop.run_in_executor(None, bundle.preprocess, item)
    except (ValueError, OSError) as e:
        metrics.REQUESTS.labels(bundle.name, "400").inc()
        raise web.HTTPBadRequest(reason=str(e) or "undecodable payload") from None
    feats.update(sched)
    feats["request_id"] = request.get("request_id", "")
    return feats


def _failure(request: web.Request, model: str, e: Exception) -> web.Response:
    """The answer to a failed dispatch, counted: a shed raises 503 with
    Retry-After, a passed deadline 504; anything else is a structured 500."""
    if isinstance(e, QueueFullError):
        metrics.REQUESTS.labels(model, "503").inc()
        ra = max(1, int(math.ceil(e.retry_after_s or 1.0)))
        raise web.HTTPServiceUnavailable(
            reason=str(e) or "overloaded, retry later", headers={"Retry-After": str(ra)}
        ) from None
    if isinstance(e, DeadlineExceededError):
        metrics.REQUESTS.labels(model, "504").inc()
        raise web.HTTPGatewayTimeout(
            reason="deadline passed before dispatch; request shed"
        ) from None
    metrics.REQUESTS.labels(model, "500").inc()
    rid = request.get("request_id", "")
    log.exception("inference dispatch failed (request_id=%s)", rid, exc_info=e)
    return web.json_response(_error_body(type(e).__name__, "inference failed", rid), status=500)


def _apply_stop(text: str, stops) -> str:
    """Truncate at the first occurrence of any stop string."""
    cut = len(text)
    for s in stops:
        i = text.find(s)
        if i != -1:
            cut = min(cut, i)
    return text[:cut]


def _tokens_covering(decode, tokens, target_len: int) -> int:
    """Smallest n with len(decode(tokens[:n])) >= target_len (bisection,
    then a walk down through plateaus at split multi-byte characters);
    len(tokens) when even the full decode falls short."""
    if len(decode(tokens)) < target_len:
        return len(tokens)
    lo, hi = 0, len(tokens)
    while lo < hi:
        mid = (lo + hi) // 2
        if len(decode(tokens[:mid])) >= target_len:
            hi = mid
        else:
            lo = mid + 1
    while lo > 0 and len(decode(tokens[: lo - 1])) >= target_len:
        lo -= 1
    return lo


# ---------------------------------------------------------------------------
# streaming: token chunks from the batcher's stream paths as text deltas


def _stop_holdback(text: str, stops) -> int:
    """Chars to withhold from streaming: the longest suffix of ``text``
    that is a strict prefix of some stop string (it may complete into a
    stop next chunk, and an emitted delta cannot be retracted)."""
    hb = 0
    for s in stops:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                hb = max(hb, k)
                break
    return hb


async def _delta_stream(bundle: ModelBundle, stream_iter, item: RawItem):
    """Token chunks -> text deltas, for both streaming endpoints.

    Yields ``{"delta": str}`` per chunk, then one final ``{"done": True,
    "text", "tokens", "steps", "finish_reason"}``.  The deltas concatenate
    to the final text; stop strings never appear in it (a suffix that may
    complete into one is held back, and flushed if the stream ends
    otherwise); ``tokens`` never counts past a stop truncation;
    finish_reason is "stop" (EOS or a stop string) or "length"."""
    eos, pad = bundle.cfg.eos_id, bundle.cfg.pad_id
    tokens: list[int] = []
    prev_text = ""
    steps = 0
    finished = False
    reason = "length"

    def decode(toks: list[int]) -> str:
        return bundle.tokenizer.decode(np.array(toks, np.int32))

    async for chunk in stream_iter:
        steps += int(chunk.size)
        for t in chunk.tolist():
            if t == eos:
                finished, reason = True, "stop"
                break
            if item.max_tokens is not None and len(tokens) >= item.max_tokens:
                finished, reason = True, "length"
                break
            if t != pad or not tokens:
                tokens.append(int(t))
        text = decode(tokens)
        if item.stop:
            stopped = _apply_stop(text, item.stop)
            if stopped != text and len(stopped) >= len(prev_text):
                text, finished, reason = stopped, True, "stop"
                tokens = tokens[: _tokens_covering(decode, tokens, len(text))]
            elif not finished:
                text = text[: len(text) - _stop_holdback(text, item.stop)]
        if len(text) < len(prev_text):
            text = prev_text  # emission only grows
        delta = text[len(prev_text):]
        prev_text = text
        yield {"delta": delta}
        if finished:
            break
    if not finished and item.stop:
        # Budget spent with a held-back suffix: it can no longer complete
        # into a stop string.
        text = _apply_stop(decode(tokens), item.stop)
        if len(text) > len(prev_text):
            yield {"delta": text[len(prev_text):]}
            prev_text = text
    yield {"done": True, "text": prev_text, "tokens": len(tokens), "steps": steps,
           "finish_reason": reason}


async def _open_stream(request: web.Request, feats: dict, item: RawItem, t0: float):
    """Submit the stream and pull its first event before any response
    bytes go out, so a shed (503), a drain (503) or a prompt too long for
    the loop (400) still gets its HTTP status; the TTFT observation point.
    Returns (event iterator, stream iterator)."""
    app = request.app
    bundle: ModelBundle = app[K_BUNDLE]
    try:
        stream_iter = app[K_BATCHER].submit_stream(feats)
    except ValueError as e:
        metrics.REQUESTS.labels(bundle.name, "400").inc()
        raise web.HTTPBadRequest(reason=str(e)) from None
    except QueueFullError as e:
        _failure(request, bundle.name, e)
    events = _delta_stream(bundle, stream_iter, item)
    try:
        first = await events.__anext__()
    except (QueueFullError, DeadlineExceededError, StreamClosedError) as e:
        await stream_iter.aclose()
        if isinstance(e, StreamClosedError):
            e = QueueFullError(str(e), reason="drain")
        _failure(request, bundle.name, e)  # 503, or 504 for a passed deadline
    except Exception:
        await stream_iter.aclose()
        metrics.REQUESTS.labels(bundle.name, "500").inc()
        raise
    metrics.TTFT.labels(bundle.name).observe(time.monotonic() - t0)

    async def chained():
        yield first
        async for ev in events:
            yield ev

    return chained(), stream_iter


async def _stream_predict(request: web.Request, feats: dict, t0: float,
                          item: RawItem) -> web.StreamResponse:
    """``/predict`` streaming: ndjson lines of text deltas, then a final
    line with the text, token counts and finish reason."""
    bundle: ModelBundle = request.app[K_BUNDLE]
    rid = request.get("request_id", "")
    events, stream_iter = await _open_stream(request, feats, item, t0)
    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "application/x-ndjson", "X-Accel-Buffering": "no",
        "X-Request-Id": rid,
    })
    resp.enable_chunked_encoding()
    await resp.prepare(request)
    try:
        async for ev in events:
            if "delta" in ev:
                # One line per chunk, even when its delta is empty.
                await resp.write((json.dumps({"delta": ev["delta"]}) + "\n").encode())
                continue
            dt = time.monotonic() - t0
            await resp.write((json.dumps({
                "done": True,
                "prediction": {"text": ev["text"]},
                "tokens_generated": ev["tokens"],
                "decode_steps": ev["steps"],
                "finish_reason": ev["finish_reason"],
                "model": bundle.name,
                "timing_ms": round(dt * 1000.0, 3),
            }) + "\n").encode())
            metrics.REQUESTS.labels(bundle.name, "200").inc()
            metrics.LATENCY.labels(bundle.name).observe(dt)
    except ConnectionError:
        pass  # client gone mid-write
    except Exception as e:
        # After the 200 went out, an in-band error line is the only signal.
        metrics.REQUESTS.labels(bundle.name, "500").inc()
        log.exception("stream failed mid-flight (request_id=%s)", rid)
        try:
            await resp.write((json.dumps(_error_body(
                type(e).__name__, str(e) or "stream failed", rid)) + "\n").encode())
        except ConnectionError:
            pass
    finally:
        # Closing the stream now (not at garbage collection) frees its slot
        # at the next chunk boundary.
        await stream_iter.aclose()
        try:
            await resp.write_eof()
        except ConnectionError:
            pass
    return resp


def _sse_frame(payload: dict) -> bytes:
    return f"data: {json.dumps(payload)}\n\n".encode()


async def _sse_stream(request: web.Request, feats: dict, item: RawItem, t0: float,
                      frames, preamble: bytes | None = None) -> web.StreamResponse:
    """Server-sent events: ``preamble`` first (chat's role chunk), then
    ``frames(ev) -> list[bytes]`` shapes each event, ``data: [DONE]``
    closes the stream."""
    bundle: ModelBundle = request.app[K_BUNDLE]
    rid = request.get("request_id", "")
    events, stream_iter = await _open_stream(request, feats, item, t0)
    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
        "X-Accel-Buffering": "no", "X-Request-Id": rid,
    })
    resp.enable_chunked_encoding()
    await resp.prepare(request)
    try:
        if preamble is not None:
            await resp.write(preamble)
        async for ev in events:
            for frame in frames(ev):
                await resp.write(frame)
            if ev.get("done"):
                await resp.write(b"data: [DONE]\n\n")
                metrics.REQUESTS.labels(bundle.name, "200").inc()
                metrics.LATENCY.labels(bundle.name).observe(time.monotonic() - t0)
    except ConnectionError:
        pass
    except Exception as e:
        metrics.REQUESTS.labels(bundle.name, "500").inc()
        log.exception("SSE stream failed mid-flight (request_id=%s)", rid)
        try:
            await resp.write(b"event: error\ndata: " + json.dumps(_error_body(
                type(e).__name__, str(e) or "stream failed", rid)).encode() + b"\n\n")
        except ConnectionError:
            pass
    finally:
        await stream_iter.aclose()
        try:
            await resp.write_eof()
        except ConnectionError:
            pass
    return resp


# ---------------------------------------------------------------------------
# /v1/completions: the OpenAI completions shape over the same serving path


def _usage(feats: dict, completion_tokens: int) -> dict:
    """OpenAI ``usage``: ``completion_tokens`` counts the tokens of the
    returned text (capped by max_tokens, trimmed to a stop string)."""
    prompt = int(feats.get("length", 0))
    return {
        "prompt_tokens": prompt,
        "completion_tokens": int(completion_tokens),
        "total_tokens": prompt + int(completion_tokens),
    }


async def _generate_once(request: web.Request, bundle: ModelBundle, feats: dict,
                         item: RawItem) -> tuple[str, str, int]:
    """Submit, trim to max_tokens, apply the stop strings; returns (text,
    finish_reason, completion token count)."""
    row = await request.app[K_BATCHER].submit(feats)
    full_len = int(np.count_nonzero(np.asarray(row) != bundle.cfg.pad_id))
    if item.max_tokens is not None:
        row = row[: item.max_tokens]
    text = bundle.postprocess(row)["prediction"]["text"]
    n_tok = min(full_len, item.max_tokens or full_len)
    stopped_by_string = False
    if item.stop:
        cut = _apply_stop(text, item.stop)
        stopped_by_string = cut != text
        if stopped_by_string:
            # The count must not run past the truncation: the smallest
            # count whose decode covers the final text.
            row_list = [int(t) for t in np.asarray(row).tolist()][:n_tok]
            n_tok = _tokens_covering(
                lambda ts: bundle.tokenizer.decode(np.array(ts, np.int32)), row_list, len(cut)
            )
        text = cut
    finish = "stop" if (
        stopped_by_string or item.max_tokens is None or full_len <= item.max_tokens
    ) else "length"
    return text, finish, n_tok


async def _openai_prologue(request: web.Request, to_prompt):
    """The /v1 routes' shared start: the generative-model gate, the JSON
    body, an explicit 400 for the OpenAI fields not served, the prompt
    (``to_prompt(body)``: ValueError is the client's 400, LookupError the
    server's 500), the fields carried onto /predict's validator, and the
    preprocess.  Returns (bundle, item, feats, t0, include_usage)."""
    bundle: ModelBundle = request.app[K_BUNDLE]
    if bundle.kind != KIND_SEQ2SEQ:
        metrics.REQUESTS.labels(bundle.name, "400").inc()
        raise web.HTTPBadRequest(reason=f"{bundle.name} is not a generative model")
    t0 = time.monotonic()
    try:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            raise web.HTTPBadRequest(reason="invalid JSON body") from None
        if not isinstance(body, dict):
            raise web.HTTPBadRequest(reason="invalid JSON body")
        if body.get("n") not in (None, 1):
            raise web.HTTPBadRequest(reason='"n" > 1 is not supported (one choice per request)')
        if body.get("best_of") not in (None, 1):
            raise web.HTTPBadRequest(reason='"best_of" > 1 is not supported')
        if (body.get("logprobs") is not None and body.get("logprobs") is not False) or (
            body.get("top_logprobs") not in (None, 0)
        ):
            raise web.HTTPBadRequest(reason='"logprobs" is not supported')
        try:
            prompt = to_prompt(body)
        except LookupError as e:
            metrics.REQUESTS.labels(bundle.name, "500").inc()
            rid = request.get("request_id", "")
            log.error("%s (request_id=%s)", e, rid)
            raise web.HTTPInternalServerError(
                text=json.dumps(_error_body(type(e).__name__, str(e), rid)),
                content_type="application/json") from None
        except ValueError as e:
            raise web.HTTPBadRequest(reason=str(e)) from None
        item = _parse_json_item({
            "text": prompt,
            "stream": body.get("stream", False),
            "temperature": body.get("temperature", 0.0),
            "top_k": body.get("top_k", 0),  # a common extension field
            "top_p": body.get("top_p", 1.0),
            "seed": body.get("seed"),
            "max_tokens": body.get("max_tokens"),
            "stop": body.get("stop"),
        })
        sched = _sched_fields(request)
    except web.HTTPBadRequest:
        metrics.REQUESTS.labels(bundle.name, "400").inc()
        raise
    feats = await _preprocess(request, bundle, item, sched)
    # Usage rides in a stream only when the client asks
    # (stream_options.include_usage); a whole answer always carries it.
    include_usage = bool((body.get("stream_options") or {}).get("include_usage", False))
    return bundle, item, feats, t0, include_usage


async def handle_completions(request: web.Request) -> web.StreamResponse:
    """``POST /v1/completions`` for generative models: the field names
    OpenAI-style clients speak (``prompt``, ``max_tokens``, ``temperature``,
    ``top_p``, ``stop``, ``stream``), served by the same batcher and engine
    as /predict.  Streaming answers with server-sent events ending in
    ``data: [DONE]``."""

    def to_prompt(body: dict) -> str:
        prompt = body.get("prompt")
        if isinstance(prompt, list):  # the API allows a singleton batch
            prompt = prompt[0] if len(prompt) == 1 else None
        if not isinstance(prompt, str) or not prompt:
            raise ValueError('"prompt" must be a non-empty string')
        return prompt

    bundle, item, feats, t0, include_usage = await _openai_prologue(request, to_prompt)
    if item.stream:
        def frame(text, finish) -> dict:
            payload = {"object": "text_completion", "model": bundle.name,
                       "choices": [{"index": 0, "text": text, "finish_reason": finish}]}
            if include_usage:
                payload["usage"] = None
            return payload

        def frames(ev) -> list[bytes]:
            if "delta" in ev:
                return [_sse_frame(frame(ev["delta"], None))] if ev["delta"] else []
            out = [_sse_frame(frame("", ev["finish_reason"]))]
            if include_usage:
                out.append(_sse_frame({"object": "text_completion", "model": bundle.name,
                                       "choices": [], "usage": _usage(feats, ev["tokens"])}))
            return out

        return await _sse_stream(request, feats, item, t0, frames)
    try:
        text, finish, n_tok = await _generate_once(request, bundle, feats, item)
    except Exception as e:
        return _failure(request, bundle.name, e)
    metrics.REQUESTS.labels(bundle.name, "200").inc()
    metrics.LATENCY.labels(bundle.name).observe(time.monotonic() - t0)
    return web.json_response({
        "object": "text_completion",
        "model": bundle.name,
        "choices": [{"index": 0, "text": text, "finish_reason": finish}],
        "usage": _usage(feats, n_tok),
    })


async def handle_chat_completions(request: web.Request) -> web.StreamResponse:
    """``POST /v1/chat/completions``: the message list rendered into one
    prompt by the template validated at startup (``CHAT_TEMPLATE``), served
    as /v1/completions is, in the chat answer shapes (a stream opens with
    the assistant's role chunk)."""
    from .chat import render_chat

    template = request.app[K_STATE]["chat_template"]
    bundle, item, feats, t0, include_usage = await _openai_prologue(
        request, lambda body: render_chat(body.get("messages"), template))
    if item.stream:
        def chunk(delta: dict, finish) -> bytes:
            payload = {"object": "chat.completion.chunk", "model": bundle.name,
                       "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}
            if include_usage:
                payload["usage"] = None
            return _sse_frame(payload)

        def frames(ev) -> list[bytes]:
            if "delta" in ev:
                return [chunk({"content": ev["delta"]}, None)] if ev["delta"] else []
            out = [chunk({}, ev["finish_reason"])]
            if include_usage:
                out.append(_sse_frame({"object": "chat.completion.chunk", "model": bundle.name,
                                       "choices": [], "usage": _usage(feats, ev["tokens"])}))
            return out

        return await _sse_stream(request, feats, item, t0, frames,
                                 preamble=chunk({"role": "assistant"}, None))
    try:
        text, finish, n_tok = await _generate_once(request, bundle, feats, item)
    except Exception as e:
        return _failure(request, bundle.name, e)
    metrics.REQUESTS.labels(bundle.name, "200").inc()
    metrics.LATENCY.labels(bundle.name).observe(time.monotonic() - t0)
    return web.json_response({
        "object": "chat.completion",
        "model": bundle.name,
        "choices": [{"index": 0, "message": {"role": "assistant", "content": text},
                     "finish_reason": finish}],
        "usage": _usage(feats, n_tok),
    })


async def handle_models(request: web.Request) -> web.Response:
    """OpenAI ``/v1/models``: one entry, the served model."""
    app = request.app
    return web.json_response({
        "object": "list",
        "data": [{
            "id": app[K_BUNDLE].name,
            "object": "model",
            "created": int(app[K_STARTED_AT]),
            "owned_by": "mlmicroservicetemplate-tpu",
        }],
    })


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
        # Shards of a sequence-parallel placement (bert-long), else 1.
        "n_devices": bundle.placement.n_devices if bundle.placement is not None else 1,
        "max_batch": app[K_CFG].max_batch,
        "uptime_s": round(time.time() - app[K_STARTED_AT], 1),
        "batch_buckets": list(engine.batch_buckets),
        "seq_buckets": list(engine.seq_buckets),
        "warmup_s": app[K_STATE]["warmup_s"],
        "dispatches": engine.dispatches,
        "decode_steps": engine.decode_steps,
        "scheduler": {
            "draining": app[K_BATCHER].draining,
            "pending": app[K_BATCHER].pending_work(),
            "kv_committed_bytes": app[K_BATCHER].admission.committed_bytes,
            "kv_budget_bytes": app[K_BATCHER].admission.kv_budget_bytes,
        },
        "compile": app[K_BATCHER].compile_status(),
    }
    err = app[K_STATE]["ready_error"]
    if err:
        body["ready_error"] = err
    if bundle.kind == KIND_SEQ2SEQ:
        body["chat_template"] = app[K_STATE]["chat_template"]
        warnings = app[K_STATE]["chat_template_warnings"]
        if warnings:
            body["chat_template_warnings"] = warnings
    return web.json_response(body)


async def handle_metrics(request: web.Request) -> web.Response:
    body, ctype = metrics.render()
    return web.Response(body=body, content_type=ctype.split(";")[0])


async def drain_app(app: web.Application, grace_s: float = 30.0) -> bool:
    """SIGTERM drain: stop admitting (readyz -> 503, new requests 503),
    then wait up to ``grace_s`` for queued and in-flight work."""
    batcher: Batcher = app[K_BATCHER]
    batcher.begin_drain()
    deadline = time.monotonic() + grace_s
    while batcher.pending_work() > 0 and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
    return batcher.pending_work() == 0
