"""Prometheus series of the serving path, exported at ``GET /metrics``.

Request count and latency, queue wait, device time per batch, batch size,
queue depth by class and load sheds; the admission ledger's committed KV
bytes; graph-cache events and warm-phase seconds;
for streaming generation, generated tokens,
live streams per loop chunk, time to first token, the gap between chunk
deliveries, preemptions, the paged KV pool's blocks and its dry-pool
stalls.  The series live in this package's own
registry, so a process that also imports the JAX package registers no
name twice.  Without ``prometheus_client`` every series is a no-op stub.
"""

from __future__ import annotations

try:
    from prometheus_client import (
        CONTENT_TYPE_LATEST,
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )
except ImportError:
    CONTENT_TYPE_LATEST = "text/plain"

    class _Noop:
        def labels(self, *a, **k):
            return self

        def inc(self, *a, **k):
            pass

        def observe(self, *a, **k):
            pass

        def set(self, *a, **k):
            pass

    def Counter(*a, **k):  # noqa: N802
        return _Noop()

    Gauge = Histogram = Counter

    def CollectorRegistry():  # noqa: N802
        return None

    def generate_latest(registry=None):
        return b"# prometheus_client not installed\n"


REGISTRY = CollectorRegistry()

_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0, 120.0,
)
_FINE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 30.0, 120.0,
)

REQUESTS = Counter(
    "predict_requests_total", "Completed /predict requests", ["model", "status"],
    registry=REGISTRY,
)
LATENCY = Histogram(
    "predict_latency_seconds", "End-to-end /predict latency", ["model"],
    buckets=_LATENCY_BUCKETS, registry=REGISTRY,
)
QUEUE_WAIT = Histogram(
    "batch_queue_wait_seconds", "Time a request waits in the batching queue",
    ["model"], buckets=_LATENCY_BUCKETS, registry=REGISTRY,
)
DEVICE_TIME = Histogram(
    "device_batch_seconds", "Device time per dispatched batch", ["model"],
    buckets=_LATENCY_BUCKETS, registry=REGISTRY,
)
BATCH_SIZE = Histogram(
    "batch_size", "Items per dispatched batch", ["model"],
    buckets=(1, 2, 4, 8, 16, 32, 64), registry=REGISTRY,
)
QUEUE_DEPTH = Gauge(
    "batch_queue_depth", "Requests currently queued", ["model"], registry=REGISTRY,
)
SHED = Counter(
    "requests_shed_total",
    "Load-shed requests by reason (queue_full | kv_budget | drain | deadline)",
    ["model", "reason"], registry=REGISTRY,
)
CLASS_QUEUE_DEPTH = Gauge(
    "sched_class_queue_depth",
    "Requests waiting in the deadline queue, by queue and priority class",
    ["model", "queue", "klass"], registry=REGISTRY,
)
PREEMPTIONS = Counter(
    "stream_preemptions_total",
    "Batch-class streams checkpointed and queued again to admit interactive work",
    ["model"], registry=REGISTRY,
)
KV_COMMITTED = Gauge(
    "kv_committed_bytes",
    "KV-cache bytes committed against the admission budget",
    ["model"], registry=REGISTRY,
)
KV_GROWTH_STALLS = Counter(
    "kv_growth_stalls_total",
    "Paged-KV insert or growth found the pool dry: the stream was checkpointed "
    "and queued again (it resumes when blocks free up)",
    ["model"], registry=REGISTRY,
)

TOKENS = Counter(
    "generated_tokens_total", "Seq2seq tokens generated", ["model"], registry=REGISTRY,
)
STREAM_BATCH = Histogram(
    "stream_batch_size", "Live streams served per continuous-batching chunk dispatch",
    ["model"], buckets=(1, 2, 4, 8, 16, 32), registry=REGISTRY,
)
TTFT = Histogram(
    "stream_ttft_seconds",
    "Streaming time-to-first-token-chunk (submit to first event)",
    ["model"], buckets=_LATENCY_BUCKETS, registry=REGISTRY,
)
KV_POOL_BLOCKS = Gauge(
    "kv_pool_blocks", "Paged-KV pool blocks by state (used | free)",
    ["model", "state"], registry=REGISTRY,
)
TBT = Histogram(
    "stream_tbt_seconds",
    "Streaming inter-chunk delivery gap (time between consecutive token-chunk "
    "deliveries to one stream after its first chunk)",
    ["model"], buckets=_FINE_BUCKETS, registry=REGISTRY,
)
WARM_SECONDS = Histogram(
    "engine_warm_seconds",
    "Wall seconds one warm phase took (engine = the bucket grid's graph "
    "captures, loop = the continuous loop's chunk capture)",
    ["model", "phase"], buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0),
    registry=REGISTRY,
)
EXEC_CACHE_EVENTS = Counter(
    "executable_cache_events_total",
    "Graph-cache lookups by event (hit = a captured graph replays; miss = "
    "none under the key; insert = a graph was captured) - "
    "runtime/compile_cache.py",
    ["event"], registry=REGISTRY,
)


def render() -> tuple[bytes, str]:
    return generate_latest(REGISTRY), CONTENT_TYPE_LATEST
