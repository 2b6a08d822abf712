"""Engine supervisor: the restart budget of crash recovery.

Counterpart of the JAX package's ``engine/supervisor.py``.  The continuous
loop detects faults on its thread and owns the recovery (``streams._recover``:
checkpoint every stream at its delivered tokens, rebuild the device state
in place, queue the checkpoints again for a token-identical resume); this
object holds the policy: how many rebuilds a process may spend before it
declares itself broken.

- **Lifetime** (``ENGINE_RESTART_WINDOW_S=0``, the default):
  ``ENGINE_RESTARTS_MAX`` rebuilds in all.  Once ``failed`` flips it stays.
- **Sliding window** (``ENGINE_RESTART_WINDOW_S>0``): only restarts inside
  the trailing window count; ``stats`` says when the oldest expires.

Once ``failed`` flips the loop stops, every remaining consumer gets an
error, new submissions are refused and ``/readyz`` stays unready.  On the
card ``fail`` flips it outright, without spending a restart, when a CUDA
error poisoned the process's context (``faults.is_context_poisoned``).
``recorder`` (the engine's flight recorder) gets an ``engine_restart``
event for each restart granted and dumps the moment the budget refuses
one, so the post-mortem shows the iterations that led to the fault.
"""

from __future__ import annotations

import threading
import time


class Supervisor:
    """Bounded-restart policy shared by the decode loop and /readyz."""

    def __init__(self, cfg=None, max_restarts: int | None = None,
                 window_s: float | None = None, clock=None, recorder=None):
        if max_restarts is None:
            max_restarts = int(getattr(cfg, "engine_restarts_max", 3) or 0)
        if window_s is None:
            window_s = float(getattr(cfg, "engine_restart_window_s", 0.0) or 0.0)
        self.max_restarts = max(0, int(max_restarts))
        # 0 = lifetime budget; > 0 = sliding window.
        self.window_s = max(0.0, float(window_s))
        # Injectable clock: the tests pin window behavior without sleeping.
        self._clock = clock if clock is not None else time.monotonic
        self.restarts = 0  # lifetime count, in either mode
        self._times: list[float] = []  # in-window restart stamps
        self.failed = False
        self.recorder = recorder
        self._lock = threading.Lock()

    def _prune_locked(self, now: float) -> None:
        if self.window_s > 0:
            cutoff = now - self.window_s
            self._times = [t for t in self._times if t > cutoff]

    def allow_restart(self) -> bool:
        """Spend one restart; False (and ``failed``) once the budget is
        spent.  In window mode only in-window restarts count."""
        with self._lock:
            now = self._clock()
            self._prune_locked(now)
            used = len(self._times) if self.window_s > 0 else self.restarts
            if self.failed or used >= self.max_restarts:
                first = not self.failed
                self.failed = True
                if self.recorder is not None and first:
                    self.recorder.dump(
                        f"engine restart budget exhausted ({used}/{self.max_restarts}"
                        + (f" in {self.window_s:.0f}s window)" if self.window_s > 0 else ")"))
                return False
            self.restarts += 1
            if self.window_s > 0:
                self._times.append(now)
            if self.recorder is not None:
                self.recorder.event("engine_restart", n=self.restarts, max=self.max_restarts)
            return True

    def fail(self) -> None:
        """Declare the engine broken without a restart (a poisoned CUDA
        context: nothing in this process can serve again)."""
        with self._lock:
            self.failed = True

    def stats(self) -> dict:
        with self._lock:
            now = self._clock()
            self._prune_locked(now)
            out = {
                "restarts": self.restarts,
                "max_restarts": self.max_restarts,
                "failed": self.failed,
            }
            if self.window_s > 0:
                out["window_s"] = self.window_s
                out["window_used"] = len(self._times)
                out["window_free_in_s"] = round(
                    max(0.0, self._times[0] + self.window_s - now)
                    if len(self._times) >= self.max_restarts and self._times
                    else 0.0,
                    3,
                )
            return out
