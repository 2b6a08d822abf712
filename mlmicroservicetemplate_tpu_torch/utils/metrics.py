"""Prometheus series of the serving path, exported at ``GET /metrics``.

Request count and latency, queue wait, device time per batch, batch size,
queue depth by class and load sheds; the admission ledger's committed KV
bytes; graph-cache events and warm-phase seconds;
for streaming generation, generated tokens,
live streams per loop chunk, time to first token, the gap between chunk
deliveries, preemptions, the paged KV pool's blocks and its dry-pool
stalls, the host KV tier's blocks, swap bytes, resumes and prefix
hits, the chunks of each fused decode window and its early exits, the
loop's pipelining depth, the host seconds of each dispatch by site, and
the tokens each speculative verify round emitted; per tenant its sheds,
committed KV bytes, offered tokens and TTFT SLO burn; the LoRA adapter
pool's slots by state; the decode-kernel autotuner's decisions; the
supervisor's engine rebuilds, watchdog retries and timeouts, and the
streams a fault recovered or lost; the perf observatory's device busy
and bubble seconds, modeled FLOPs by graph kind and MFU estimate, and
the SLO tracker's burn rates; the journal's records, replays and fsync
seconds, the disk KV tier's blocks, and the bulk jobs and their lines.  ``LATENCY_BUCKETS`` (comma-separated
ascending seconds) replaces the latency histograms' default edges.
The series live in this package's own
registry, so a process that also imports the JAX package registers no
name twice.  Without ``prometheus_client`` every series is a no-op stub.
"""

from __future__ import annotations

import os

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

# The default latency edges reach past 10 s, as the reference's do.
_DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0, 120.0,
)


def parse_buckets(spec: str | None) -> tuple[float, ...] | None:
    """Comma-separated ascending positive bucket edges, or None when unset
    or invalid (the default edges then apply; ``ServiceConfig`` refuses an
    invalid ``LATENCY_BUCKETS`` at startup)."""
    if not spec:
        return None
    try:
        vals = tuple(float(x) for x in spec.split(",") if x.strip())
    except ValueError:
        return None
    if not vals or any(v <= 0 for v in vals) or list(vals) != sorted(set(vals)):
        return None
    return vals


# Read once, at import, as the reference does: the histograms are made here.
_LATENCY_BUCKETS = parse_buckets(os.environ.get("LATENCY_BUCKETS")) or _DEFAULT_LATENCY_BUCKETS
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
    "Load-shed requests by reason (queue_full | kv_budget | drain | deadline | "
    "adapter_pool)",
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
SPEC_EMITTED = Histogram(
    "spec_tokens_per_verify_step",
    "Speculative decoding: tokens emitted per verify step (1.0 = no "
    "draft accepted; the acceptance-rate observability surface)",
    ["model"], buckets=(1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 9.0), registry=REGISTRY,
)
STREAM_BATCH = Histogram(
    "stream_batch_size", "Live streams served per continuous-batching chunk dispatch",
    ["model"], buckets=(1, 2, 4, 8, 16, 32), registry=REGISTRY,
)
TTFT = Histogram(
    "stream_ttft_seconds",
    "Streaming time-to-first-token-chunk (submit to first event), by "
    "admission mode (chunked = PREFILL_CHUNK windows, monolithic = "
    "one fused prefill dispatch)",
    ["model", "mode"], buckets=_LATENCY_BUCKETS, registry=REGISTRY,
)
PREFILL_CHUNKS = Counter(
    "prefill_chunks_total",
    "Prompt windows dispatched by chunked prefill (PREFILL_CHUNK)",
    ["model"], registry=REGISTRY,
)
PREFILL_STALL = Counter(
    "prefill_stall_seconds",
    "Host time spent dispatching prefill windows while decode streams "
    "were live: the decode-cadence delay chunked prefill bounds to one "
    "window (the windows queue behind the decode chunk on the device, so "
    "this is the interleaving overhead, not a full stall)",
    ["model"], registry=REGISTRY,
)
PREFILL_BACKLOG = Gauge(
    "prefill_backlog_tokens",
    "Prompt tokens admitted but not yet prefilled (chunked backlog)",
    ["model"], registry=REGISTRY,
)
KV_POOL_BLOCKS = Gauge(
    "kv_pool_blocks", "Paged-KV pool blocks by state (used | free; used includes "
    "prefix-cache pins)",
    ["model", "state"], registry=REGISTRY,
)
KV_HOST_POOL_BLOCKS = Gauge(
    "kv_host_pool_blocks",
    "Host-RAM KV tier blocks by state (KV_HOST_BUDGET_MB; used = "
    "swapped-out stream checkpoints + demoted prefix entries)",
    ["model", "state"], registry=REGISTRY,
)
KV_SWAP_BYTES = Counter(
    "kv_swap_bytes_total",
    "KV bytes moved across the device/host tier boundary, by direction "
    "(out = checkpoint swap-out + prefix demotion, in = resume "
    "prefetch + prefix promotion)",
    ["model", "dir"], registry=REGISTRY,
)
KV_SWAP_RESUMES = Counter(
    "kv_swap_resumes_total",
    "Checkpointed-stream resumes by outcome: swapped = KV prefetched "
    "from the host tier (zero re-prefill), fallback = host copy "
    "missing/evicted/foreign so the stream re-prefilled (recast or "
    "replay)",
    ["model", "outcome"], registry=REGISTRY,
)
KV_HOST_PREFIX_HITS = Counter(
    "kv_host_prefix_hits_total",
    "Prefix-cache matches served from the host tier: the entry was "
    "demoted under device-budget pressure and promoted back on match",
    ["model"], registry=REGISTRY,
)
JOURNAL_RECORDS = Counter(
    "journal_records_total",
    "Write-ahead stream-journal records appended, by kind (admit = "
    "stream admission, tokens = delivered-token cursor delta, done = "
    "terminal, result = unary /predict completion for X-Request-Id "
    "dedup)",
    ["model", "kind"], registry=REGISTRY,
)
JOURNAL_REPLAY = Counter(
    "journal_replay_streams_total",
    "Journaled streams processed at startup replay, by outcome "
    "(resumed = re-admitted for token-identical continuation, "
    "complete = already finished before the crash, failed = could not "
    "re-admit)",
    ["model", "outcome"], registry=REGISTRY,
)
JOBS_ACTIVE = Gauge(
    "jobs_active",
    "Bulk /v1/batches jobs with a live executor task (JOBS_ENABLED; "
    "their lines backfill idle compute as batch-class streams)",
    ["model"], registry=REGISTRY,
)
JOB_LINES = Counter(
    "job_lines_total",
    "Bulk job lines reaching a terminal state (completed = result "
    "journaled write-ahead to JOURNAL_DIR/jobs, failed = the error "
    "became the recorded result, cancelled = unfinished at job cancel)",
    ["model", "state"], registry=REGISTRY,
)
JOB_REPLAYS = Counter(
    "job_replays_total",
    "Jobs processed at startup replay, by outcome (resumed = "
    "re-admitted from the last completed line, complete = every line "
    "finished before the kill, failed = could not re-admit)",
    ["model", "outcome"], registry=REGISTRY,
)
KV_DISK_POOL_BLOCKS = Gauge(
    "kv_disk_pool_blocks",
    "Disk KV tier blocks by state (KV_DISK_BUDGET_MB; used = spilled "
    "stream checkpoints + demoted prefix entries persisted under "
    "JOURNAL_DIR/kv_disk)",
    ["model", "state"], registry=REGISTRY,
)
CHAIN_DEPTH = Gauge(
    "stream_chain_depth",
    "Chunk-chain pipelining depth the continuous decode loop runs at "
    "(STREAM_PIPELINE; auto-tuned at warmup from measured dispatch RTT "
    "vs chunk compute when 0)",
    ["model"], registry=REGISTRY,
)
DISPATCH_HOST = Histogram(
    "dispatch_host_seconds",
    "Host time one guarded device dispatch spent from submit to "
    "return, by dispatch site (prefill | prefill_chunk | chunk | "
    "fetch | batch | handoff | swap | prep) — the host-side half of "
    "the host-vs-device attribution split (TRACE=1 spans carry the "
    "device half); prep is the double-buffered host prep staged while "
    "the previous chunk is in flight",
    ["model", "site"], buckets=_FINE_BUCKETS, registry=REGISTRY,
)
DECODE_WINDOW_CHUNKS = Histogram(
    "decode_window_chunks",
    "Decode chunks fused per window dispatch (DECODE_WINDOW; 1 = the "
    "unfused per-chunk path) — host syncs per token scale inversely "
    "with this",
    ["model"], buckets=(1, 2, 4, 8, 16, 32, 64), registry=REGISTRY,
)
WINDOW_EARLY_EXITS = Counter(
    "decode_window_early_exits_total",
    "Fused decode windows that exited on-device before their chunk cap "
    "because every live row hit EOS",
    ["model"], registry=REGISTRY,
)
TBT = Histogram(
    "stream_tbt_seconds",
    "Streaming inter-chunk delivery gap (time between consecutive token-chunk "
    "deliveries to one stream after its first chunk)",
    ["model"], buckets=_FINE_BUCKETS, registry=REGISTRY,
)
JOURNAL_FSYNC = Histogram(
    "journal_fsync_seconds",
    "Wall time per journal fsync (JOURNAL_FSYNC=always pays one per "
    "record on the delivery path; interval amortizes; off never "
    "observes here)",
    ["model"], buckets=_FINE_BUCKETS, registry=REGISTRY,
)
WARM_SECONDS = Histogram(
    "engine_warm_seconds",
    "Wall seconds one warm phase took (engine = the bucket grid's graph "
    "captures, loop = the continuous loop's chunk capture)",
    ["model", "phase"], buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0),
    registry=REGISTRY,
)
# -- multi-tenancy (tenancy/).  The tenant label is bounded: the first
# TENANT_METRICS_TOPK configured tenants export by name, the others as
# "other", anonymous traffic as "anon" (TenantRegistry.label).
TENANT_SHED = Counter(
    "tenant_requests_shed_total",
    "Per-tenant load sheds by reason (quota = the tenant exhausted its "
    "own concurrency/token-window/KV envelope → HTTP 429; other "
    "reasons mirror requests_shed_total, attributed to the caller)",
    ["model", "tenant", "reason"], registry=REGISTRY,
)
TENANT_KV = Gauge(
    "tenant_kv_committed_bytes",
    "KV-cache bytes currently leased against each tenant's quota "
    "(tenancy/accounts.py occupancy ledger; drains to zero at idle)",
    ["model", "tenant"], registry=REGISTRY,
)
TENANT_TOKENS = Counter(
    "tenant_tokens_total",
    "Offered tokens charged to each tenant's sliding window (prompt "
    "length + clamped decode budget, charged at admission — metered "
    "work, not realized luck)",
    ["model", "tenant"], registry=REGISTRY,
)
TENANT_SLO_BURN = Gauge(
    "tenant_slo_ttft_burn_rate",
    "Per-tenant TTFT SLO burn rate by window (fast/slow), same budget "
    "arithmetic as slo_ttft_burn_rate — the noisy-neighbor blast-"
    "radius gauge fair share is supposed to keep flat",
    ["model", "tenant", "window"], registry=REGISTRY,
)
ADAPTER_SLOTS = Gauge(
    "adapter_pool_slots",
    "LoRA adapter device-slot pool by state (resident = installed "
    "adapters, active = slots refcounted by live streams, free = "
    "installable without eviction, host = adapters loaded host-side) "
    "- tenancy/adapters.py",
    ["model", "state"], registry=REGISTRY,
)
EXEC_CACHE_EVENTS = Counter(
    "executable_cache_events_total",
    "Graph-cache lookups by event (hit = a captured graph replays; miss = "
    "none under the key; insert = a graph was captured) - "
    "runtime/compile_cache.py",
    ["event"], registry=REGISTRY,
)

PALLAS_AUTOTUNE_EVENTS = Counter(
    "pallas_autotune_events_total",
    "Decode-kernel autotuner decisions by event (sweep = a measured "
    "split search ran; hit = the tuning table answered without one; "
    "pin = PALLAS_VARIANT honored; install = a winner entered the "
    "process table K3's plans read; reject_verify/reject_error = "
    "candidates dropped by the plain-version check / a failed launch; "
    "persist_error = a tuning-table read or write failed) - ops/autotune.py",
    ["event"], registry=REGISTRY,
)
ENGINE_RESTARTS = Counter(
    "engine_restarts_total",
    "Supervised engine rebuilds after a fatal dispatch fault or decode "
    "loop death (streams checkpoint and resume token-identically)",
    ["model"], registry=REGISTRY,
)
DISPATCH_RETRIES = Counter(
    "dispatch_retries_total",
    "Transient dispatch failures retried under the watchdog, by "
    "exception type",
    ["model", "reason"], registry=REGISTRY,
)
DISPATCH_TIMEOUTS = Counter(
    "dispatch_timeouts_total",
    "Dispatches cut off by the DISPATCH_TIMEOUT_S watchdog deadline",
    ["model"], registry=REGISTRY,
)
STREAMS_RECOVERED = Counter(
    "streams_recovered_total",
    "Live streams checkpointed and resumed token-identically, by "
    "replica and cause (restart = same-engine rebuild)",
    ["model", "replica", "cause"], registry=REGISTRY,
)
STREAMS_LOST = Counter(
    "streams_lost_total",
    "Live streams error-terminated by an unrecoverable engine fault, "
    "by replica and cause (fault = no supervisor, budget spent or a "
    "poisoned CUDA context)",
    ["model", "replica", "cause"], registry=REGISTRY,
)

# -- the perf observatory (utils/perfobs.py) and the SLO tracker
DEVICE_BUSY = Counter(
    "device_busy_seconds",
    "Estimated device-busy seconds by dispatch site, from submit stamps and "
    "the loop's fetch seams (no added synchronisation)",
    ["model", "site"], registry=REGISTRY,
)
DEVICE_BUBBLE = Counter(
    "device_bubble_seconds",
    "Estimated device idle gaps between attributed busy intervals",
    ["model"], registry=REGISTRY,
)
MODELED_FLOPS = Counter(
    "modeled_flops_total",
    "Modeled FLOPs accrued per replayed CUDA graph kind (counted once at "
    "capture, runtime/compile_cache.py)",
    ["model", "kind"], registry=REGISTRY,
)
MFU = Gauge(
    "mfu_estimate",
    "Rolling model-FLOPs-utilization estimate: modeled FLOP rate over the "
    "card's peak (PEAK_TFLOPS or the card table; 0 when unknown)",
    ["model"], registry=REGISTRY,
)
SLO_TTFT_BURN = Gauge(
    "slo_ttft_burn_rate",
    "Per-priority-class TTFT SLO burn rate by window (fast/slow): the share "
    "of the error budget (1 - SLO_TARGET) being consumed; 1.0 = at budget",
    ["model", "klass", "window"], registry=REGISTRY,
)
SLO_TBT_BURN = Gauge(
    "slo_tbt_burn_rate",
    "Per-priority-class TBT SLO burn rate by window (fast/slow), the same "
    "budget arithmetic as slo_ttft_burn_rate",
    ["model", "klass", "window"], registry=REGISTRY,
)


def render() -> tuple[bytes, str]:
    return generate_latest(REGISTRY), CONTENT_TYPE_LATEST
