"""Multi-tenant serving: the batched multi-adapter LoRA pool.

Counterpart of the JAX package's ``tenancy`` package.  ``adapters`` serves
N LoRA deltas over one shared base model through a refcounted device-slot
pool, as one batched decode dispatch with a per-row adapter index
(``models/lora.py``).  It is built only when ``ADAPTER_DIR`` is set.  The
reference's tenant accounts and fair share (``TENANTS``, ``TENANTS_FILE``)
are not ported yet.
"""

from .adapters import AdapterBusy, AdapterPool

__all__ = ["AdapterBusy", "AdapterPool"]
