"""Request-level span tracing, the engine's flight recorder and JSON logs.

Counterpart of the JAX package's ``utils/tracing.py``, with its names,
defaults and export schema.

- **Span tracer** (``TRACE=1``, off by default): wall-clock spans at the
  serving layers' seams, keyed by the request id.  The ``/predict`` path
  records the HTTP ``request``, the batcher's ``queue_wait`` and the
  engine's ``dispatch`` (one per batch); the continuous decode loop an
  ``admission`` span per stream submit, a ``queue_wait`` and a ``stream``
  (its whole lifetime) span per stream, a ``decode_chunk`` span per
  dispatch of a chunk or a fused decode window and, under chunked
  prefill, a ``prefill_window`` span per window; every
  ``dispatch_guard`` site a ``dispatch:{site}`` span with its host
  submit-to-return and device halves (the device half synchronizes the
  engine's stream, so ``TRACE=1`` is an attribution mode that serializes
  the loop's pipeline, as the reference's ``block_until_ready`` does).
  Spans sit in a bounded ring (``TRACE_RING``) and export as Chrome
  trace-event JSON (``chrome_trace``, served at ``GET /debug/trace``).
  With tracing off, ``tracer()`` is None and ``span()`` returns one shared
  no-op context manager: the hot paths make no span object.
- **Flight recorder** (``FLIGHT_RING``, 256 by default): a bounded ring of
  the loop's last iterations (batch composition, slot occupancy, KV pool
  state) and of scheduling and fault events (sheds, pacer holds,
  preemptions, dispatch retries and timeouts, engine restarts).  It dumps
  on fatal faults (the supervisor snapshots the ring the moment it grants
  or refuses a restart) and on demand at ``GET /debug/engine``.  Recording
  reads host state only.
- **JSON logs** (``LOG_FORMAT=json``): one JSON object per log line.

Timestamps are ``time.monotonic()`` (the base the scheduler stamps
``t_in`` with), anchored to the wall clock once per tracer.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time

log = logging.getLogger(__name__)

_now = time.monotonic


# ---------------------------------------------------------------------------
# span tracer


class _NoopSpan:
    """Shared do-nothing span of the ``TRACE=0`` path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


NOOP = _NoopSpan()


class Span:
    """One timed interval: a context manager (recorded on exit), or made
    after the fact through ``Tracer.add``."""

    __slots__ = ("name", "cat", "rid", "t0", "dur", "tid", "sid", "parent", "args",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str, rid: str, args: dict):
        self.name = name
        self.cat = cat
        self.rid = rid
        self.args = args
        self.t0 = _now()
        self.dur = 0.0
        self.tid = threading.get_ident()
        self.sid = tracer._next_sid()
        self.parent = 0
        self._tracer = tracer

    def set(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        if stack:
            self.parent = stack[-1].sid
        stack.append(self)
        return self

    def __exit__(self, etype, exc, tb):
        self.dur = _now() - self.t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if etype is not None:
            self.args.setdefault("error", f"{etype.__name__}: {exc}")
        self._tracer._record(self)
        return False


class Tracer:
    """Bounded ring of completed spans.  Appends are thread-safe; a span
    opened inside another on the same thread records the outer one's sid
    as its ``parent``; across threads the request id correlates."""

    def __init__(self, ring: int = 4096):
        self.ring = max(16, int(ring))
        self._spans: collections.deque = collections.deque(maxlen=self.ring)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sid = 0
        # Spans made since the tracer was installed (``/status.observability``).
        self.spans_created = 0
        self.t_anchor = _now()
        self.wall_anchor = time.time()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_sid(self) -> int:
        with self._lock:
            self._sid += 1
            self.spans_created += 1
            return self._sid

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)

    def span(self, name: str, cat: str = "app", rid: str = "", **args) -> Span:
        return Span(self, name, cat, rid, args)

    def add(self, name: str, cat: str = "app", rid: str = "",
            t0: float | None = None, dur: float | None = None, **args) -> None:
        """Record a finished interval ``[t0, t0 + dur]`` (dur defaults to
        now - t0), with no parent."""
        sp = Span(self, name, cat, rid, args)
        if t0 is not None:
            sp.t0 = t0
        sp.dur = dur if dur is not None else max(0.0, _now() - sp.t0)
        self._record(sp)

    def instant(self, name: str, cat: str = "app", rid: str = "", **args) -> None:
        """A zero-duration marker."""
        self.add(name, cat, rid, dur=0.0, **args)

    def snapshot(self, last: int | None = None) -> list[Span]:
        with self._lock:
            spans = list(self._spans)
        return spans[-last:] if last else spans

    def chrome_trace(self, last: int | None = None) -> dict:
        """Chrome trace-event JSON (Perfetto, ``chrome://tracing``): spans
        become ``ph: "X"`` complete events, zero-duration ones ``ph: "i"``
        instants; ``ts`` is microseconds since the tracer's anchor."""
        spans = self.snapshot(last)
        tids: dict[int, int] = {}
        events: list[dict] = []
        for sp in spans:
            tid = tids.setdefault(sp.tid, len(tids) + 1)
            args = dict(sp.args)
            if sp.rid:
                args["request_id"] = sp.rid
            if sp.parent:
                args["parent_sid"] = sp.parent
            args["sid"] = sp.sid
            ev = {"name": sp.name, "cat": sp.cat, "pid": 1, "tid": tid,
                  "ts": round((sp.t0 - self.t_anchor) * 1e6, 3), "args": args}
            if sp.dur > 0.0:
                ev["ph"] = "X"
                ev["dur"] = round(sp.dur * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "mlmicroservicetemplate-tpu"}}]
        for raw, tid in tids.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                         "args": {"name": f"thread-{raw}"}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"wall_anchor": self.wall_anchor,
                          "spans_created": self.spans_created, "ring": self.ring},
        }


_TRACER: Tracer | None = None


def tracer() -> Tracer | None:
    """The process tracer, or None when ``TRACE=0``."""
    return _TRACER


def configure(enabled: bool, ring: int = 4096) -> Tracer | None:
    """Install (a fresh ring) or remove (``enabled=False``) the process
    tracer."""
    global _TRACER
    _TRACER = Tracer(ring) if enabled else None
    return _TRACER


def span(name: str, cat: str = "app", rid: str = "", **args):
    """A context-manager span, or the shared no-op when tracing is off.
    The caller evaluates ``args`` either way."""
    tr = _TRACER
    if tr is None:
        return NOOP
    return tr.span(name, cat, rid, **args)


# ---------------------------------------------------------------------------
# flight recorder


class FlightRecorder:
    """Bounded ring of the loop's iteration frames and of discrete events,
    dumped on fatal faults and served at ``GET /debug/engine``.  ``size=0``
    records nothing (``dump`` still answers, with empty rings)."""

    def __init__(self, size: int = 256):
        self.size = max(0, int(size))
        cap = self.size or 1
        self._iters: collections.deque = collections.deque(maxlen=cap)
        self._events: collections.deque = collections.deque(maxlen=cap)
        self._lock = threading.Lock()
        self.last_dump: dict | None = None
        self.dumps = 0

    def record_iteration(self, **fields) -> None:
        if not self.size:
            return
        fields["t"] = round(_now(), 4)
        with self._lock:
            self._iters.append(fields)

    def event(self, kind: str, **fields) -> None:
        if not self.size:
            return
        fields["event"] = kind
        fields["t"] = round(_now(), 4)
        with self._lock:
            self._events.append(fields)

    def snapshot(self) -> dict:
        with self._lock:
            return {"size": self.size, "iterations": list(self._iters),
                    "events": list(self._events), "dumps": self.dumps,
                    "last_dump": self.last_dump}

    def dump(self, reason: str) -> dict:
        """Keep the rings as ``last_dump`` and log them as one JSON line:
        the post-mortem a fatal fault leaves even if nobody reads
        ``/debug/engine``.  Never raises into the recovery that calls it."""
        with self._lock:
            snap = {"reason": reason, "t": round(_now(), 4), "wall": time.time(),
                    "iterations": list(self._iters), "events": list(self._events)}
            self.last_dump = snap
            self.dumps += 1
        try:
            log.error("engine flight recorder dump: %s", json.dumps(snap, default=str))
        except Exception:  # a dump must never raise into recovery
            log.exception("flight recorder dump serialization failed")
        return snap


# ---------------------------------------------------------------------------
# structured JSON logs


class JsonLogFormatter(logging.Formatter):
    """One JSON object per log line (``LOG_FORMAT=json``): timestamp, level,
    logger, message and, when the record carries one
    (``extra={"request_id": ...}``), the request id."""

    def format(self, record: logging.LogRecord) -> str:
        out = {"ts": round(record.created, 4), "level": record.levelname,
               "logger": record.name, "message": record.getMessage()}
        rid = getattr(record, "request_id", None)
        if rid:
            out["request_id"] = rid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)
