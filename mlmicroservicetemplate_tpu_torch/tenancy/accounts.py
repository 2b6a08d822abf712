"""Tenant accounts: classification, quotas, usage and per-tenant SLO burn
(the reference's ``tenancy/accounts.py``, the same behaviour).

- **Classification**: ``X-Api-Key`` to a :class:`TenantSpec` through the key
  table built from ``TENANTS`` (inline ``name=weight`` pairs; a tenant's
  name is its API key) or ``TENANTS_FILE`` (full JSON specs: keys, quotas,
  default adapter).  An unknown or missing key is the anonymous tenant
  (``""``): default weight, no quotas.
- **Quota ledger**: clock-injected and thread-safe, per tenant the live
  concurrency, the committed KV bytes and a sliding-window token ledger
  (one deque, pruned to ``window_s``).  ``admit`` charges all three and
  returns an idempotent lease, or raises :class:`QuotaExceeded` with the
  tenant's own ``retry_after_s`` (until the oldest window entry ages out).
  Concurrency and KV are occupancy, returned at ``release``; window tokens
  are rate, never refunded.  ``readmit`` charges a stream re-entering
  service its occupancy only, and never raises.
- **Per-tenant SLO burn**: the port's ``scheduler.policy.SLOTracker``,
  exported as ``tenant_slo_ttft_burn_rate{tenant, window}`` (the worst TTFT
  objective of each window).

Metric labels are bounded: the first ``topk`` configured tenants (in
declaration order) keep their names, the others export as ``other`` and
anonymous traffic as ``anon``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque

from ..utils import metrics


class QuotaExceeded(Exception):
    """A tenant's concurrency, token window or KV quota is spent; admission
    turns it into ``QueueFullError(reason="quota")``, HTTP 429 with
    Retry-After."""

    def __init__(self, msg: str, tenant: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's identity, weight and quotas (0 = no cap)."""

    name: str
    weight: float = 1.0
    api_keys: tuple[str, ...] = ()
    max_concurrency: int = 0
    tokens_per_window: int = 0
    kv_budget_mb: float = 0.0
    adapter: str = ""

    @property
    def kv_budget_bytes(self) -> int:
        return int(self.kv_budget_mb * 1024 * 1024)


def parse_tenants(inline: str | None, path: str | None) -> list[TenantSpec]:
    """The tenant specs of ``TENANTS`` and ``TENANTS_FILE``; a malformed one
    raises ``ValueError`` with the reference's message (at config load).

    ``TENANTS``: comma-separated ``name=weight`` (or a bare ``name``,
    weight 1), each name its own API key.  ``TENANTS_FILE``: a JSON list (or
    ``{"tenants": [...]}``) of objects with a ``name`` and optional
    ``weight``, ``api_keys``, ``max_concurrency``, ``tokens_per_window``,
    ``kv_mb`` and ``adapter``.  With both, the file wins for a name in
    both."""
    specs: dict[str, TenantSpec] = {}
    if inline:
        for part in str(inline).split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition("=")
            name = name.strip()
            if not name:
                raise ValueError(f"TENANTS entry {part!r} has an empty name")
            try:
                weight = float(w) if w else 1.0
            except ValueError:
                raise ValueError(f"TENANTS weight in {part!r} is not a number") from None
            if not weight > 0:
                raise ValueError(f"TENANTS weight for {name!r} must be > 0")
            specs[name] = TenantSpec(name=name, weight=weight, api_keys=(name,))
    if path:
        if not os.path.isfile(path):
            raise ValueError(f"TENANTS_FILE {path!r} does not exist")
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"TENANTS_FILE {path!r}: invalid JSON ({e})") from None
        entries = doc.get("tenants") if isinstance(doc, dict) else doc
        if not isinstance(entries, list):
            raise ValueError(f"TENANTS_FILE {path!r} must be a JSON list or "
                             '{"tenants": [...]}')
        for ent in entries:
            if not isinstance(ent, dict) or not ent.get("name"):
                raise ValueError(f"TENANTS_FILE entry {ent!r} needs a non-empty name")
            name = str(ent["name"])
            try:
                spec = TenantSpec(
                    name=name,
                    weight=float(ent.get("weight", 1.0)),
                    api_keys=tuple(str(k) for k in (ent.get("api_keys") or (name,))),
                    max_concurrency=int(ent.get("max_concurrency", 0)),
                    tokens_per_window=int(ent.get("tokens_per_window", 0)),
                    kv_budget_mb=float(ent.get("kv_mb", 0.0)),
                    adapter=str(ent.get("adapter", "")),
                )
            except (TypeError, ValueError) as e:
                raise ValueError(f"TENANTS_FILE entry {name!r}: {e}") from None
            if not spec.weight > 0:
                raise ValueError(f"TENANTS_FILE tenant {name!r} weight must be > 0")
            if spec.max_concurrency < 0 or spec.tokens_per_window < 0 or spec.kv_budget_mb < 0:
                raise ValueError(f"TENANTS_FILE tenant {name!r} quotas must be >= 0")
            specs[name] = spec
    return list(specs.values())


#: The metric label of anonymous (keyless or unknown-key) traffic.
ANON = "anon"
#: The metric label of configured tenants past the top-K cap.
OTHER = "other"


class TenantRegistry:
    """Classification, quota ledger and per-tenant SLO of every tenant of
    one batcher.  Thread-safe; the clock is injectable, so tests drive the
    token window without sleeping."""

    def __init__(self, specs: list[TenantSpec], model: str = "", default_weight: float = 1.0,
                 window_s: float = 60.0, topk: int = 8, clock=None):
        self.model = model
        self.window_s = max(1e-3, float(window_s))
        self.default_weight = float(default_weight)
        self._clock = clock if clock is not None else time.monotonic
        self._specs = {s.name: s for s in specs}
        self._by_key = {k: s for s in specs for k in s.api_keys}
        self._anon = TenantSpec(name="", weight=self.default_weight)
        self._labels = {s.name: (s.name if i < int(topk) else OTHER)
                        for i, s in enumerate(specs)}
        self._lock = threading.Lock()
        self._active: dict[str, int] = {}
        self._kv: dict[str, int] = {}
        self._window: dict[str, deque] = {}
        self._window_tokens: dict[str, int] = {}
        self._sheds: dict[str, int] = {}
        self._slo: dict[str, object] = {}
        self._slo_cfg = None

    @classmethod
    def from_cfg(cls, cfg, model: str = "", clock=None):
        """The registry of the service's knobs, or None when neither
        ``TENANTS`` nor ``TENANTS_FILE`` is set (then nothing of tenancy is
        built)."""
        inline = getattr(cfg, "tenants", None)
        path = getattr(cfg, "tenants_file", None)
        if not inline and not path:
            return None
        reg = cls(parse_tenants(inline, path), model=model,
                  default_weight=float(getattr(cfg, "tenant_default_weight", 1.0) or 1.0),
                  window_s=float(getattr(cfg, "tenant_window_s", 60.0) or 60.0),
                  topk=int(getattr(cfg, "tenant_metrics_topk", 8) or 8), clock=clock)
        reg._slo_cfg = cfg
        return reg

    # -- classification -------------------------------------------------

    def classify(self, api_key: str | None) -> TenantSpec:
        """The tenant of a request; an unknown or missing key is the
        anonymous tenant."""
        if api_key:
            spec = self._by_key.get(str(api_key))
            if spec is not None:
                return spec
        return self._anon

    def spec(self, name: str) -> TenantSpec | None:
        return self._specs.get(name)

    def weights(self) -> dict[str, float]:
        return {s.name: s.weight for s in self._specs.values()}

    def label(self, name: str) -> str:
        """The bounded metric label of a tenant name."""
        if not name:
            return ANON
        return self._labels.get(name, OTHER)

    # -- quota ledger ---------------------------------------------------

    def _prune_locked(self, name: str, now: float) -> None:
        q = self._window.get(name)
        if not q:
            return
        horizon = now - self.window_s
        while q and q[0][0] < horizon:
            _, n = q.popleft()
            self._window_tokens[name] -= n

    def admit(self, spec: TenantSpec, tokens: int, kv_bytes: int) -> dict:
        """Charge one request to ``spec``'s quotas and return its lease, or
        raise :class:`QuotaExceeded`.  Window tokens age out of the window;
        concurrency and KV bytes return at ``release``."""
        name = spec.name
        tokens = max(0, int(tokens))
        kv_bytes = max(0, int(kv_bytes))
        now = self._clock()
        with self._lock:
            self._prune_locked(name, now)
            if spec.max_concurrency and self._active.get(name, 0) >= spec.max_concurrency:
                self._sheds[name] = self._sheds.get(name, 0) + 1
                raise QuotaExceeded(f"tenant {name!r} at max_concurrency={spec.max_concurrency}",
                                    name, retry_after_s=1.0)
            used = self._window_tokens.get(name, 0)
            if spec.tokens_per_window and used + tokens > spec.tokens_per_window:
                q = self._window.get(name)
                retry = self.window_s
                if q:
                    # Until the oldest entry ages out: the first moment any
                    # of the window comes back.
                    retry = max(0.0, self.window_s - (now - q[0][0]))
                self._sheds[name] = self._sheds.get(name, 0) + 1
                raise QuotaExceeded(
                    f"tenant {name!r} over tokens_per_window={spec.tokens_per_window} "
                    f"(used {used}, wanted {tokens})", name, retry_after_s=max(1.0, retry))
            if spec.kv_budget_mb and self._kv.get(name, 0) + kv_bytes > spec.kv_budget_bytes:
                self._sheds[name] = self._sheds.get(name, 0) + 1
                raise QuotaExceeded(f"tenant {name!r} over kv_mb={spec.kv_budget_mb:g}", name,
                                    retry_after_s=1.0)
            self._active[name] = self._active.get(name, 0) + 1
            self._kv[name] = self._kv.get(name, 0) + kv_bytes
            if tokens:
                self._window.setdefault(name, deque()).append((now, tokens))
                self._window_tokens[name] = used + tokens
            kv_now = self._kv[name]
        label = self.label(name)
        if tokens:
            metrics.TENANT_TOKENS.labels(self.model, label).inc(tokens)
        metrics.TENANT_KV.labels(self.model, label).set(kv_now)
        return {"tenant": name, "tokens": tokens, "kv": kv_bytes, "released": False}

    def readmit(self, name: str, kv_bytes: int) -> dict:
        """Charge a stream re-entering service (a preemption or recovery
        resume) its concurrency and KV again, unconditionally: a started
        stream never turns into a quota error, and its window tokens were
        spent at its first admission."""
        kv_bytes = max(0, int(kv_bytes))
        with self._lock:
            self._active[name] = self._active.get(name, 0) + 1
            self._kv[name] = self._kv.get(name, 0) + kv_bytes
            kv_now = self._kv[name]
        metrics.TENANT_KV.labels(self.model, self.label(name)).set(kv_now)
        return {"tenant": name, "tokens": 0, "kv": kv_bytes, "released": False}

    def release(self, lease: dict | None) -> None:
        """Return a lease's occupancy (idempotent: a second release is a
        no-op)."""
        if not lease or lease.get("released"):
            return
        name = lease["tenant"]
        with self._lock:
            if lease.get("released"):
                return
            lease["released"] = True
            self._active[name] = max(0, self._active.get(name, 0) - 1)
            self._kv[name] = max(0, self._kv.get(name, 0) - lease["kv"])
            kv_now = self._kv[name]
        metrics.TENANT_KV.labels(self.model, self.label(name)).set(kv_now)

    def note_shed(self, name: str, reason: str) -> None:
        """Count a shed against a tenant (``admit`` counts its quota sheds
        in ``usage``; this is their metric)."""
        metrics.TENANT_SHED.labels(self.model, self.label(name), reason).inc()

    # -- per-tenant SLO ---------------------------------------------------

    def note_latency(self, name: str, kind: str, klass: str, value_s: float) -> None:
        """Score one TTFT or TBT delivery against the tenant's SLO burn
        tracker, built at its label's first note (none without an SLO
        objective)."""
        if self._slo_cfg is None:
            return
        label = self.label(name)
        tracker = self._slo.get(label)
        if tracker is None:
            with self._lock:
                tracker = self._slo.get(label)
                if tracker is None:
                    tracker = _tenant_slo_tracker(self.model, self._slo_cfg, label, self._clock)
                    self._slo[label] = tracker if tracker else False
        if tracker:
            tracker.note(kind, klass, value_s)

    # -- observability ----------------------------------------------------

    def usage(self) -> dict:
        """``/status.tenancy.tenants``: each tenant's live usage and
        quotas."""
        now = self._clock()
        with self._lock:
            names = sorted(set(self._specs) | set(self._active) | set(self._window))
            out = {}
            for name in names:
                self._prune_locked(name, now)
                spec = self._specs.get(name, self._anon)
                out[name or ANON] = {
                    "weight": spec.weight,
                    "active": self._active.get(name, 0),
                    "window_tokens": self._window_tokens.get(name, 0),
                    "kv_bytes": self._kv.get(name, 0),
                    "sheds": self._sheds.get(name, 0),
                    "quota": {"max_concurrency": spec.max_concurrency,
                              "tokens_per_window": spec.tokens_per_window,
                              "kv_mb": spec.kv_budget_mb},
                }
            return out

    def totals(self) -> dict:
        """Live concurrency and committed KV across every tenant."""
        with self._lock:
            return {"active": sum(self._active.values()), "kv_bytes": sum(self._kv.values())}


def _tenant_slo_tracker(model: str, cfg, label: str, clock):
    """An ``SLOTracker`` of the service's objectives whose gauges are the
    tenant's ``tenant_slo_ttft_burn_rate`` (the worst TTFT objective of each
    window), or None without an objective."""
    from ..scheduler.policy import SLOTracker

    class _TenantSLOTracker(SLOTracker):
        def export_gauges(self, now=None):
            now = self._clock() if now is None else now
            for win_name, win in zip(self.WINDOW_NAMES, self.windows_s):
                burn = max((self.burn_rate(kind, klass, win, now=now)
                            for kind, klass in self.objectives if kind == "ttft"), default=0.0)
                metrics.TENANT_SLO_BURN.labels(self.model, label, win_name).set(burn)

    return _TenantSLOTracker.from_cfg(model, cfg, clock=clock)
