"""Fault injection and the dispatch watchdog.

Counterpart of the JAX package's ``engine/faults.py``: the same grammar,
the same seeded schedule, the same exception classes and the same watchdog.
Both pieces are off by default:

- **FaultInjector** (``FAULT_SPEC``): a deterministic, seedable fault
  schedule at the device-dispatch boundaries (the continuous loop's
  ``prefill``/``prefill_chunk``/``chunk``/``fetch``/``prep``/``handoff``/
  ``swap`` sites, the paged allocator's ``grow`` site and the batcher's
  ``batch`` site).  It raises transient or fatal device errors, injects
  hangs and forces ``OutOfBlocks``, on the Nth matching dispatch or at a
  seeded rate.  With no spec the injector is None and every site skips it.
- **Watchdog** (``DISPATCH_TIMEOUT_S`` / ``DISPATCH_RETRIES`` /
  ``DISPATCH_BACKOFF_S``): runs one dispatch under a deadline and retries
  transient failures with capped exponential backoff.  An overrun raises
  ``DispatchTimeoutError``, classified fatal: the supervisor rebuilds.
  With timeout 0, retries 0 and no injector, ``run`` is a plain call.

FAULT_SPEC grammar (``;``-separated rules)::

    rule   := [replica ":"] [site ":"] kind ["(" seconds ")"] trigger
    replica:= "r" N           rule applies only to fleet replica N
    site   := prefill | prefill_chunk | chunk | fetch | batch | grow
            | handoff | swap | prep | *
    kind   := transient | fatal | hang | oob | device_lost
    trigger:= "@" N ["+" M]   fire on matching dispatches N..N+M-1
            | "~" RATE        fire with probability RATE per dispatch
                              (seeded RNG: FAULT_SEED)

``seconds`` applies to ``hang`` (default 3600); for ``device_lost`` the
argument is the shard ordinal that died (default 0).  ``@N`` counters are
per rule and count only dispatches at the rule's site.  The port serves one
engine, replica 0: an ``rN:`` rule with N != 0 parses and never fires.

What differs on the card:

- The dispatches are not functional: a CUDA graph replay updates the slot
  state in place.  A fault fires at the top of an attempt, before the
  dispatch touches the device, so a retried transient replays once; and a
  dispatch whose attempt the watchdog cut while it hung in the injector
  never runs (``_attempt``), so no replay lands on state the rebuild has
  reset.  A real hang inside the dispatch cannot be taken back.
- Classification: ``is_context_poisoned`` reads CUDA's messages instead of
  XLA's.  An error the CUDA runtime makes sticky (an illegal address, a
  launch failure, an uncorrectable ECC error, a device-side assert) leaves
  the process's context unusable: no rebuild inside the process can serve
  again, so the supervisor fails outright.  ``torch.cuda.OutOfMemoryError``
  is not sticky.  An injected fault, a watchdog cut or any other error goes
  through the rebuild.
"""

from __future__ import annotations

import logging
import re
import threading
import time

import torch

from ..utils import metrics

log = logging.getLogger(__name__)

SITES = ("prefill", "prefill_chunk", "chunk", "fetch", "batch", "grow",
         "handoff", "swap", "prep", "*")
KINDS = ("transient", "fatal", "hang", "oob", "device_lost")


class TransientDeviceError(Exception):
    """A dispatch failed in a way a retry can fix; the watchdog retries it
    with backoff."""


class FatalDeviceError(Exception):
    """The device state is lost; retrying the same dispatch cannot succeed.
    The supervisor checkpoints streams and rebuilds."""


class DeviceLostError(FatalDeviceError):
    """One device of the replica's placement died.  ``device_index`` is the
    shard ordinal within the replica's device group (0 for one card)."""

    def __init__(self, msg: str, device_index: int = 0):
        super().__init__(msg)
        self.device_index = int(device_index)


class DispatchTimeoutError(Exception):
    """A dispatch exceeded ``DISPATCH_TIMEOUT_S``.  Classified fatal: the
    dispatch thread may be wedged, so recovery means a rebuild."""


# The CUDA runtime's messages for the errors it makes sticky (the context
# answers every later call with the same error), as torch and the kernel
# wrappers report them: ``cudaGetErrorString`` of cudaErrorIllegalAddress,
# cudaErrorLaunchFailure, cudaErrorECCUncorrectable, cudaErrorAssert,
# cudaErrorMisalignedAddress, cudaErrorIllegalInstruction,
# cudaErrorHardwareStackError, cudaErrorInvalidPc and cudaErrorLaunchTimeout,
# and those codes' names.
_STICKY_RE = re.compile(
    r"illegal memory access|illegal address|unspecified launch failure|"
    r"uncorrectable ECC error|device-side assert triggered|misaligned address|"
    r"illegal instruction|hardware stack error|invalid program counter|"
    r"launch timed out|cudaErrorIllegalAddress|cudaErrorLaunchFailure|"
    r"cudaErrorECCUncorrectable|cudaErrorAssert|cudaErrorMisalignedAddress|"
    r"cudaErrorIllegalInstruction|cudaErrorHardwareStackError|"
    r"cudaErrorInvalidPc|cudaErrorLaunchTimeout",
    re.IGNORECASE,
)


def is_context_poisoned(exc: BaseException) -> bool:
    """True for a CUDA error the runtime makes sticky: the process's
    context cannot run another kernel, so no in-place rebuild can help.
    Out-of-memory errors and the injected kinds are not."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    if not isinstance(exc, RuntimeError):
        return False
    return bool(_STICKY_RE.search(str(exc)))


def is_transient(exc: BaseException) -> bool:
    return isinstance(exc, (TransientDeviceError, ConnectionError)) or bool(
        getattr(exc, "transient", False))


def is_device_loss(exc: BaseException) -> bool:
    """The injected ``DeviceLostError``, or a CUDA error that poisoned the
    context (this process has lost the device)."""
    return isinstance(exc, DeviceLostError) or is_context_poisoned(exc)


def is_fatal_device(exc: BaseException) -> bool:
    return isinstance(exc, (FatalDeviceError, DispatchTimeoutError)) or is_device_loss(exc)


class FaultRule:
    """One parsed FAULT_SPEC rule with its own dispatch counter."""

    __slots__ = ("site", "kind", "arg", "nth", "count", "rate", "seen",
                 "fired", "replica")

    def __init__(self, site: str, kind: str, arg: float,
                 nth: int = 0, count: int = 1, rate: float = 0.0,
                 replica: int | None = None):
        self.site = site
        self.kind = kind
        self.arg = arg
        self.nth = nth
        self.count = count
        self.rate = rate
        self.seen = 0
        self.fired = 0
        # None = every replica; an int scopes the rule to that replica.
        self.replica = replica

    def __repr__(self) -> str:
        trig = f"~{self.rate}" if self.rate else f"@{self.nth}+{self.count}"
        rep = f"r{self.replica}:" if self.replica is not None else ""
        return f"{rep}{self.site}:{self.kind}{trig}"


_RULE_RE = re.compile(
    r"^(?:r(?P<replica>\d+):)?"
    r"(?:(?P<site>[a-z_*]+):)?"
    r"(?P<kind>[a-z_]+)"
    r"(?:\((?P<arg>[0-9.]+)\))?"
    r"(?:@(?P<nth>\d+)(?:\+(?P<count>\d+))?|~(?P<rate>[0-9.]+))$"
)


def parse_spec(spec: str) -> list[FaultRule]:
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        m = _RULE_RE.match(part)
        if m is None:
            raise ValueError(f"unparseable FAULT_SPEC rule {part!r}")
        site = m.group("site") or "*"
        kind = m.group("kind")
        if site not in SITES:
            raise ValueError(f"FAULT_SPEC site must be one of {SITES}, got {site!r}")
        if kind not in KINDS:
            raise ValueError(f"FAULT_SPEC kind must be one of {KINDS}, got {kind!r}")
        rate = float(m.group("rate") or 0.0)
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"FAULT_SPEC rate must be in [0, 1], got {rate}")
        rep = m.group("replica")
        # hang seconds (default one hour), or the shard that a device_lost
        # kills (default 0)
        default_arg = 0.0 if kind == "device_lost" else 3600.0
        rules.append(FaultRule(
            site, kind,
            arg=float(m.group("arg") or default_arg),
            nth=int(m.group("nth") or 0),
            count=int(m.group("count") or 1),
            rate=rate,
            replica=int(rep) if rep is not None else None,
        ))
    return rules


class FaultInjector:
    """Deterministic fault schedule over the dispatch sites.  The trigger
    decision (counters and the seeded draw) happens under a lock; the fault
    itself (raise or sleep) outside it."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        import random

        self.rules = rules
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str | None, seed: int = 0,
                  replica: int = 0) -> "FaultInjector | None":
        """The injector of one engine: rules scoped to another replica
        (``rN:``) are dropped."""
        if not spec:
            return None
        rules = [r for r in parse_spec(spec) if r.replica is None or r.replica == int(replica)]
        return cls(rules, seed) if rules else None

    def fire(self, site: str) -> None:
        """Count one dispatch at ``site``; raise or sleep if a rule says so.
        Called at the top of each attempt, so a watchdog retry re-rolls the
        schedule as a real retry would touch the device again."""
        hit = None
        with self._lock:
            for rule in self.rules:
                if rule.site != "*" and rule.site != site:
                    continue
                rule.seen += 1
                if rule.rate > 0.0:
                    trigger = self._rng.random() < rule.rate
                else:
                    trigger = rule.nth <= rule.seen < rule.nth + rule.count
                if trigger:
                    rule.fired += 1
                    hit = rule
                    break
        if hit is None:
            return
        log.warning("fault injected at %s: %r", site, hit)
        if hit.kind == "transient":
            raise TransientDeviceError(f"injected transient fault at {site}")
        if hit.kind == "fatal":
            raise FatalDeviceError(f"injected fatal device fault at {site}")
        if hit.kind == "device_lost":
            shard = int(hit.arg)
            raise DeviceLostError(f"injected device loss at {site} (group shard {shard})",
                                  device_index=shard)
        if hit.kind == "oob":
            from .kv_blocks import OutOfBlocks

            raise OutOfBlocks(f"injected OutOfBlocks at {site}")
        # hang: sleep through the watchdog's deadline (unwatched, stall the
        # caller for the whole duration)
        time.sleep(hit.arg)


class Watchdog:
    """Deadline and transient-retry wrapper for one dispatch.

    ``run(site, fn)`` runs ``injector.fire(site)`` then ``fn()``; with
    ``timeout_s > 0`` the attempt runs on a fresh daemon thread (in the
    caller's inference mode) and an overrun raises ``DispatchTimeoutError``:
    the thread is abandoned, and if it was still in the injector its
    dispatch never runs.  Transient failures retry up to ``retries`` times
    with capped exponential backoff.  Retries and timeouts are events of
    ``recorder`` (the engine's flight recorder) when there is one."""

    def __init__(self, model: str, timeout_s: float = 0.0, retries: int = 0,
                 backoff_s: float = 0.05, injector: FaultInjector | None = None,
                 recorder=None):
        self.model = model
        self.timeout_s = max(0.0, float(timeout_s))
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))
        self.injector = injector
        self.recorder = recorder
        self._passthrough = (
            self.injector is None and self.timeout_s <= 0 and self.retries <= 0)

    def run(self, site: str, fn):
        if self._passthrough:
            return fn()
        attempt = 0
        while True:
            try:
                return self._attempt(site, fn)
            except Exception as e:
                if is_transient(e) and attempt < self.retries:
                    metrics.DISPATCH_RETRIES.labels(self.model, type(e).__name__).inc()
                    if self.recorder is not None:
                        self.recorder.event("dispatch_retry", site=site, attempt=attempt + 1,
                                            error=f"{type(e).__name__}: {e}")
                    time.sleep(min(self.backoff_s * (2 ** attempt), 2.0))
                    attempt += 1
                    continue
                raise

    def _attempt(self, site: str, fn):
        if self.timeout_s <= 0:
            if self.injector is not None:
                self.injector.fire(site)
            return fn()
        box: dict = {}
        done = threading.Event()
        abandoned = threading.Event()
        inference = torch.is_inference_mode_enabled()

        def worker():
            try:
                with torch.inference_mode(inference):
                    if self.injector is not None:
                        self.injector.fire(site)
                    if abandoned.is_set():
                        return  # cut while it hung: the dispatch never runs
                    box["r"] = fn()
            except BaseException as e:
                box["e"] = e
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True, name=f"dispatch-{site}")
        t.start()
        if not done.wait(self.timeout_s):
            abandoned.set()
            metrics.DISPATCH_TIMEOUTS.labels(self.model).inc()
            if self.recorder is not None:
                self.recorder.event("dispatch_timeout", site=site, timeout_s=self.timeout_s)
            raise DispatchTimeoutError(
                f"{site} dispatch exceeded DISPATCH_TIMEOUT_S={self.timeout_s}s")
        if "e" in box:
            raise box["e"]
        return box.get("r")
