"""Request-level span tracing, off by default (``TRACE=1`` turns it on).

The ``/predict`` path records three spans, keyed by the request id: the
HTTP ``request``, the batcher's ``queue_wait`` and the engine's
``dispatch`` (one per batch).  The continuous decode loop records an
``admission`` span per stream submit, a ``decode_chunk`` span per
dispatch of a chunk or a fused decode window (with its live streams and
the window's depth ``window``) and, under chunked prefill, a
``prefill_window`` span per window (``start``, ``end`` and ``total`` prompt
positions, ``paged``).  Spans sit in a bounded ring
(``Tracer.snapshot``); ``spans_created`` counts every span made.  With
tracing off, ``tracer()`` is None and
``span()`` returns one shared no-op context manager.
"""

from __future__ import annotations

import collections
import threading
import time

_now = time.monotonic


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "cat", "rid", "t0", "dur", "args", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str, rid: str, args: dict):
        self.name = name
        self.cat = cat
        self.rid = rid
        self.args = args
        self.t0 = _now()
        self.dur = 0.0
        self._tracer = tracer

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, etype, exc, tb):
        self.dur = _now() - self.t0
        if etype is not None:
            self.args.setdefault("error", f"{etype.__name__}: {exc}")
        self._tracer._record(self)
        return False


class Tracer:
    """Bounded ring of completed spans; appends are thread-safe."""

    def __init__(self, ring: int = 4096):
        self._spans: collections.deque = collections.deque(maxlen=max(16, int(ring)))
        self._lock = threading.Lock()
        # Spans made since the tracer was installed (``/status.observability``).
        self.spans_created = 0

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)

    def span(self, name: str, cat: str = "app", rid: str = "", **args) -> Span:
        with self._lock:
            self.spans_created += 1
        return Span(self, name, cat, rid, args)

    def add(self, name: str, cat: str = "app", rid: str = "",
            t0: float | None = None, dur: float | None = None, **args) -> None:
        """Record a finished interval ``[t0, t0 + dur]`` (dur defaults to
        now - t0)."""
        sp = self.span(name, cat, rid, **args)
        if t0 is not None:
            sp.t0 = t0
        sp.dur = dur if dur is not None else max(0.0, _now() - sp.t0)
        self._record(sp)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)


_TRACER: Tracer | None = None


def tracer() -> Tracer | None:
    return _TRACER


def configure(enabled: bool, ring: int = 4096) -> Tracer | None:
    """Install (or remove, ``enabled=False``) the process tracer."""
    global _TRACER
    _TRACER = Tracer(ring) if enabled else None
    return _TRACER


def span(name: str, cat: str = "app", rid: str = "", **args):
    tr = _TRACER
    if tr is None:
        return NOOP
    return tr.span(name, cat, rid, **args)
