"""Weighted fair share across tenants (the reference's
``tenancy/fairshare.py``, the same policy).

Virtual-time fair queueing (start-time fair queueing): each tenant carries
a virtual finish time ``v[t]``; serving one unit of work advances it by
``cost / weight(t)``, so a tenant of weight 3 accrues virtual time a third
as fast and is picked three times as often under sustained contention.
``pick`` chooses the eligible tenant with the smallest ``max(v[t], vnow)``:
the ``max`` with the global virtual clock is the re-activation floor, so a
tenant that idled re-enters at the present and banks no credit for a
burst.

Pure policy, no clock and no metric: ``DeadlineQueue`` calls ``pick`` and
``charge`` under its own lock.
"""

from __future__ import annotations

import threading
from typing import Iterable


class WeightedFairShare:
    """Virtual-time weighted fair queueing over tenant names.  Unknown
    tenants (the anonymous ``""`` among them) get ``default_weight``.
    Thread-safe."""

    def __init__(self, weights: dict[str, float] | None = None, default_weight: float = 1.0):
        self._weights = {str(k): float(v) for k, v in (weights or {}).items() if v and v > 0}
        self._default = max(1e-9, float(default_weight))
        self._v: dict[str, float] = {}
        self._vnow = 0.0
        self._served: dict[str, int] = {}
        self._lock = threading.Lock()

    def weight(self, tenant: str) -> float:
        return self._weights.get(str(tenant), self._default)

    def pick(self, eligible: Iterable[str]) -> str | None:
        """The eligible tenant to serve next (None when there is none);
        ties break by name."""
        with self._lock:
            best = best_key = None
            for t in eligible:
                t = str(t)
                key = (max(self._v.get(t, 0.0), self._vnow), t)
                if best_key is None or key < best_key:
                    best, best_key = t, key
            return best

    def charge(self, tenant: str, cost: float = 1.0) -> None:
        """Account one served unit of work against ``tenant``."""
        t = str(tenant)
        with self._lock:
            start = max(self._v.get(t, 0.0), self._vnow)
            self._v[t] = start + float(cost) / self.weight(t)
            # The global clock follows the last service start, so a tenant
            # coming back joins at the present.
            self._vnow = start
            self._served[t] = self._served.get(t, 0) + 1

    def snapshot(self) -> dict:
        """``/status.tenancy.fairshare``: weight, virtual time and pops
        served per tenant."""
        with self._lock:
            return {t: {"weight": self.weight(t), "vtime": round(self._v.get(t, 0.0), 6),
                        "served": self._served.get(t, 0)}
                    for t in sorted(set(self._v) | set(self._weights))}
