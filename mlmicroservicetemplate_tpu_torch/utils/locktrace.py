"""Opt-in runtime lock-order detector (``LOCKTRACE=1``).

Counterpart of the JAX package's ``utils/locktrace.py``.  The serving
stack is threaded (the decode loop's thread, the batcher's executor, the
watchdog's dispatch threads, the HTTP thread's profiler capture), and its
lock discipline is kept by review.  With ``LOCKTRACE=1``
(``serve.build_service`` calls ``auto_install`` before any engine lock
exists) every lock made through ``threading.Lock`` / ``threading.RLock``
(and so ``threading.Condition``'s default) is wrapped to record each
thread's acquisition graph, and two kinds of violation are flagged:

- **lock-order inversion**: a thread took L2 while holding L1, and some
  thread now takes L1 while holding L2 (deadlock potential, caught on the
  edge, before an interleaving wedges the service);
- **lock held across a dispatch boundary**: a lock held while
  ``dispatch_guard`` submits device work.  Only locks registered with
  ``allow_across_dispatch`` may be: the graph pool's replay lock
  (``runtime/compile_cache.device_lock``), under which every replay runs.

Violations are recorded, not raised (raising inside ``acquire`` would break
the invariants being watched).  With the detector off nothing is patched,
``tracer()`` is None, and ``dispatch_guard``'s one ``is_active()`` check
reads a module attribute.  ``_REAL_LOCK`` is ``threading.Lock`` as this
module found it at import.

Usage::

    from mlmicroservicetemplate_tpu_torch.utils import locktrace
    locktrace.install()          # or LOCKTRACE=1 and auto_install()
    ...
    assert not locktrace.violations()
"""

from __future__ import annotations

import _thread
import itertools
import os
import sys
import threading

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_tracer: "LockTracer | None" = None


def _creation_site() -> str:
    """First stack frame outside this module: the lock's identity in
    reports (``engine/engine.py:85``)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "locktrace" not in fn and "threading" not in fn:
            short = fn
            for marker in ("mlmicroservicetemplate_tpu", "tests", "scripts"):
                idx = fn.find(marker)
                if idx >= 0:
                    short = fn[idx:]
                    break
            return f"{short}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class LockTracer:
    """Acquisition-graph recorder shared by every traced lock."""

    def __init__(self):
        # Raw (untraced) lock for the tracer's own state — the wrapper
        # classes must never recurse into themselves.
        self._raw = _thread.allocate_lock()
        self._uid = itertools.count(1)
        self._names: dict[int, str] = {}
        # held[tid] = [uid, ...] in acquisition order (RLock levels
        # push/pop like distinct holds; self-edges are skipped).
        self._held: dict[int, list[int]] = {}
        # edges[a] = {b, ...}: some thread acquired b while holding a.
        self._edges: dict[int, set[int]] = {}
        self._seen_pairs: set[tuple[int, int]] = set()
        self._seen_dispatch: set[tuple[int, str]] = set()
        self._allowed_across: set[int] = set()
        self.violation_list: list[dict] = []

    # -- wrapper callbacks --------------------------------------------

    def register(self, lock) -> int:
        uid = next(self._uid)
        with self._raw:
            self._names[uid] = lock._lt_name
        return uid

    def note_acquire(self, lock) -> None:
        tid = _thread.get_ident()
        uid = lock._lt_uid
        with self._raw:
            held = self._held.setdefault(tid, [])
            for h in held:
                if h == uid:
                    continue  # RLock re-entry: no self-edge
                self._check_edge_locked(h, uid)
            held.append(uid)

    def note_release(self, lock) -> None:
        tid = _thread.get_ident()
        uid = lock._lt_uid
        with self._raw:
            held = self._held.get(tid)
            if held:
                # Remove the LAST occurrence (LIFO is the common case,
                # but out-of-order releases are legal for Locks).
                for i in range(len(held) - 1, -1, -1):
                    if held[i] == uid:
                        del held[i]
                        break

    def note_dispatch(self, site: str) -> None:
        """Called at dispatch_guard entry on the dispatching thread:
        flags locks held across the device-dispatch boundary."""
        tid = _thread.get_ident()
        with self._raw:
            held = self._held.get(tid, [])
            for uid in held:
                if uid in self._allowed_across:
                    continue
                key = (uid, site)
                if key in self._seen_dispatch:
                    continue
                self._seen_dispatch.add(key)
                self.violation_list.append({
                    "kind": "held_across_dispatch",
                    "lock": self._names.get(uid, "?"),
                    "site": site,
                    "detail": (
                        f"lock {self._names.get(uid, '?')} held across "
                        f"dispatch_guard({site!r}) — a relay RTT under "
                        f"this lock stalls every thread that needs it "
                        f"(allow_across_dispatch() if deliberate)"
                    ),
                })

    def allow_across_dispatch(self, lock) -> None:
        uid = getattr(lock, "_lt_uid", None)
        if uid is None:
            return  # untraced (created before install, or LOCKTRACE=0)
        with self._raw:
            self._allowed_across.add(uid)

    # -- graph --------------------------------------------------------

    def _check_edge_locked(self, a: int, b: int) -> None:
        """Record edge a→b; flag an inversion if b→…→a already exists."""
        succ = self._edges.setdefault(a, set())
        if b in succ:
            return
        if self._reachable_locked(b, a):
            pair = (min(a, b), max(a, b))
            if pair not in self._seen_pairs:
                self._seen_pairs.add(pair)
                self.violation_list.append({
                    "kind": "lock_order_inversion",
                    "locks": [self._names.get(a, "?"),
                              self._names.get(b, "?")],
                    "detail": (
                        f"acquiring {self._names.get(b, '?')} while "
                        f"holding {self._names.get(a, '?')}, but the "
                        f"opposite order was also observed — deadlock "
                        f"potential"
                    ),
                })
        succ.add(b)

    def _reachable_locked(self, src: int, dst: int) -> bool:
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False


class _TracedLock:
    """threading.Lock wrapper feeding the tracer."""

    _lt_rlock = False

    def __init__(self):
        self._inner = _REAL_LOCK()
        self._lt_name = _creation_site()
        self._lt_uid = _tracer.register(self) if _tracer else 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok and _tracer is not None:
            _tracer.note_acquire(self)
        return ok

    def release(self):
        if _tracer is not None:
            _tracer.note_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def __getattr__(self, name):
        # Delegate everything else (e.g. _at_fork_reinit, which
        # concurrent.futures registers with os.register_at_fork) to
        # the real lock.  Only reached when normal lookup fails, so
        # the tracked acquire/release above always win.
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<TracedLock {self._lt_name}>"


class _TracedRLock(_TracedLock):
    """threading.RLock wrapper; forwards the Condition protocol so
    ``Condition(RLock())`` waits release/re-acquire through the
    tracer's bookkeeping."""

    _lt_rlock = True

    def __init__(self):
        self._inner = _REAL_RLOCK()
        self._lt_name = _creation_site()
        self._lt_uid = _tracer.register(self) if _tracer else 0

    def locked(self):  # RLock has no .locked() pre-3.12
        locked = getattr(self._inner, "locked", None)
        return locked() if locked else False

    # Condition protocol (threading.Condition probes these).
    def _release_save(self):
        if _tracer is not None:
            _tracer.note_release(self)
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        if _tracer is not None:
            _tracer.note_acquire(self)

    def _is_owned(self):
        return self._inner._is_owned()


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` so every lock created from
    now on is traced.  Locks created earlier stay raw (and silent)."""
    global _tracer
    if _tracer is not None:
        return
    _tracer = LockTracer()
    threading.Lock = _TracedLock
    threading.RLock = _TracedRLock


def uninstall() -> None:
    """Restore the real factories.  Existing traced locks keep working
    (their inner locks are real); they just stop reporting."""
    global _tracer
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _tracer = None


def auto_install(env=None) -> bool:
    """Install iff ``LOCKTRACE`` is on in ``env`` (default: the process
    environment; ``serve.build_service`` passes it with its overrides)."""
    env = os.environ if env is None else env
    if str(env.get("LOCKTRACE", "0") or "0").lower() not in ("0", "false", ""):
        install()
        return True
    return False


def tracer() -> LockTracer | None:
    return _tracer


def is_active() -> bool:
    return _tracer is not None


def note_dispatch(site: str) -> None:
    """Engine hook: called at every dispatch_guard entry (no-op off)."""
    if _tracer is not None:
        _tracer.note_dispatch(site)


def allow_across_dispatch(lock) -> None:
    """Mark one lock as legitimately held across dispatch boundaries
    (the engine's dispatch-serialization lock)."""
    if _tracer is not None:
        _tracer.allow_across_dispatch(lock)


def violations() -> list[dict]:
    return list(_tracer.violation_list) if _tracer is not None else []


def reset() -> None:
    if _tracer is not None:
        _tracer.violation_list.clear()
        _tracer._seen_pairs.clear()
        _tracer._seen_dispatch.clear()
        _tracer._edges.clear()
