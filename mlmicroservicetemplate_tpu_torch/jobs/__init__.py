"""The bulk-inference lane: durable ``/v1/batches`` jobs (``JOBS_ENABLED``).

Counterpart of the JAX package's ``jobs/``: ``store.py`` keeps job
manifests and per-line results in CRC-framed records under
``JOURNAL_DIR/jobs``, ``executor.py`` feeds job lines to the loop as
batch-class idle backfill, ``api.py`` is the HTTP surface.
"""

from .executor import JobManager
from .store import Job, JobStore

__all__ = ["Job", "JobManager", "JobStore"]
