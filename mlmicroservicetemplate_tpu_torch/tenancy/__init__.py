"""Multi-tenant serving, the counterpart of the JAX package's ``tenancy``
package.  Each piece is built only when its knobs are set (``TENANTS`` or
``TENANTS_FILE``; ``ADAPTER_DIR``):

- ``accounts``: ``X-Api-Key`` to tenant, the per-tenant quota ledger
  (concurrency, sliding-window tokens, KV bytes) and per-tenant SLO burn;
- ``fairshare``: weighted virtual-time fair queueing across tenants within
  one priority class of ``scheduler.policy.DeadlineQueue``;
- ``adapters``: N LoRA deltas over one shared base model through a
  refcounted device-slot pool, as one batched decode dispatch with a
  per-row adapter index (``models/lora.py``).
"""

from .accounts import QuotaExceeded, TenantRegistry, TenantSpec
from .adapters import AdapterBusy, AdapterPool
from .fairshare import WeightedFairShare

__all__ = [
    "AdapterBusy",
    "AdapterPool",
    "QuotaExceeded",
    "TenantRegistry",
    "TenantSpec",
    "WeightedFairShare",
]
