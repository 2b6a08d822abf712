"""Env-var driven service configuration (12-factor), as a stdlib dataclass.

Holds the fields the ResNet-50, BERT-base, bert-long, llama, GPT-2 and
T5-small paths, chat, the scheduler's priority classes, KV budget and
preemption, the prompt prefix, the prefix cache, chunked prefill, the
host KV tier, the journal, the disk KV tier and the bulk-job lane, fused
decode windows, speculative decoding, tenant accounts and fair share, the decode
kernel's autotuner, fault injection, the dispatch watchdog, the engine
supervisor, observability (the flight recorder, the perf observatory, SLO
objectives, JSON logs, the lock-order detector and the profiler's
directory) and the parent registration read, under the same
environment names as the JAX package's ``ServiceConfig``.  ``DEVICE`` is
``cuda|cpu`` and defaults to ``cuda``; ``MODEL_NAME`` defaults to
``resnet50``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

VALID_DEVICES = ("cuda", "cpu")
_LOG_LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")


def _check_buckets(name: str, v: tuple[int, ...]) -> None:
    if not v:
        raise ValueError(f"{name} must be non-empty")
    if any(b < 1 for b in v):
        raise ValueError(f"{name}: bucket sizes must be >= 1")
    if list(v) != sorted(set(v)):
        raise ValueError(f"{name} must be strictly ascending (got {v})")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """All knobs for one model-serving process."""

    device: str = "cuda"
    model_name: str = "resnet50"
    # Checkpoint (HF state dict as .npz / .safetensors / .bin); unset =
    # deterministic random init from a seed.
    model_path: str | None = None
    # WordPiece vocab.txt; unset = byte-level tokenizer.
    tokenizer_path: str | None = None
    labels_path: str | None = None
    host: str = "0.0.0.0"
    port: int = 8000
    # Parent registration: with server_url set, POST {name, host, port} to
    # <server_url>/register, retrying every register_retry_s up to
    # register_max_tries times until a 2xx, then again every
    # register_heartbeat_s (0 = register once).
    server_url: str | None = None
    register_retry_s: float = 2.0
    register_max_tries: int = 30
    register_heartbeat_s: float = 0.0
    # Dynamic batching: a batch closes at max_batch items or
    # batch_timeout_ms after its first item; past max_queue waiting items
    # the server sheds (503).
    max_batch: int = 32
    batch_timeout_ms: float = 3.0
    max_queue: int = 1024
    # Shape buckets: requests are padded up to the nearest bucket.
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    seq_buckets: tuple[int, ...] = (32, 64, 128, 256, 512)
    # Run every (batch, seq) bucket once before reporting ready; a
    # generative model's sampled graphs too, unless warmup_sampling is off
    # (WARMUP_SAMPLING=0: greedy-only deployments, the first sampled
    # request of a bucket then captures its graphs).
    warmup: bool = True
    warmup_sampling: bool = True
    log_level: str = "INFO"
    # Log line shape: "text" or "json" (one object per line,
    # utils/tracing.JsonLogFormatter).
    log_format: str = "text"
    # TRACE=1 records request / queue-wait / dispatch spans, the newest
    # trace_ring of them (utils/tracing.py; GET /debug/trace).  Its
    # dispatch spans synchronize each dispatch to split host from device
    # time: an attribution mode, not a production default.
    trace: bool = False
    trace_ring: int = 4096
    # The engine's flight recorder: loop iterations and scheduling / fault
    # events kept for GET /debug/engine and the dump at a fatal fault; 0
    # records nothing.
    flight_ring: int = 256
    # Directory of POST /debug/profile's traces: PROFILE_DIR, else the
    # reference's JAX_TRACE_DIR; unset = /tmp/jax-trace.
    profile_dir: str | None = None
    # LOCKTRACE=1: the lock-order detector (utils/locktrace.py), installed
    # by serve.build_service before any engine lock exists.
    locktrace: bool = False
    # The perf observatory (utils/perfobs.py): device busy / bubble seconds
    # from submit stamps and the loop's fetch seams, with no added
    # synchronisation, and modeled FLOPs per CUDA graph replay; off keeps no
    # timestamps and counts no graph.
    perf_obs: bool = True
    # Peak TFLOP/s of the MFU estimate; 0 = the card's table entry
    # (unknown on the CPU: the estimate stays unset).
    peak_tflops: float = 0.0
    # Latency histogram edges (comma-separated ascending seconds); unset =
    # the defaults, which reach past 10 s.
    latency_buckets: str | None = None
    # SLO objectives per priority class in ms (0 = off), the attainment
    # target whose complement is the error budget, and the burn-rate
    # windows "fast,slow" in seconds (scheduler/policy.SLOTracker).
    slo_ttft_ms: float = 0.0
    slo_tbt_ms: float = 0.0
    slo_batch_ttft_ms: float = 0.0
    slo_batch_tbt_ms: float = 0.0
    slo_target: float = 0.99
    slo_windows_s: str = "60,600"
    # Batches in flight at once: the next batch is collated and queued on
    # the host while the current one runs (the engine runs one forward at
    # a time).  The JAX package's default is 8.
    pipeline_depth: int = 2
    # Deadline of a request that carries no X-Deadline-Ms header; 0 = none.
    deadline_ms: float = 0.0
    # Priority class of a request without an X-Priority header
    # (interactive | batch).
    priority_default: str = "interactive"
    # Interactive pops per batch pop while both classes wait.
    class_weight: int = 4
    # KV-cache bytes (MB) the admitted work may commit: a request that can
    # never fit sheds 503, interactive work over what is committed waits as
    # batch, and under PAGED_KV the pool holds this many MB of blocks.
    # 0 = no budget (the pool holds MAX_STREAMS worst cases).
    kv_budget_mb: float = 0.0
    # Streams that may wait in the loop's queue beyond MAX_STREAMS live
    # ones; 0 = the 503 past MAX_STREAMS at once.
    max_stream_queue: int = 0
    # Interactive arrivals preempt batch-class streams when every slot is
    # busy (checkpoint, free the slot, queue again for a token-identical
    # resume).  Needs MAX_STREAM_QUEUE > 0 for an arrival to wait.
    preempt: bool = True
    # Seconds the SIGTERM drain waits for queued and in-flight work.
    drain_grace_s: float = 30.0
    # Generative models: decode budget per request (rounded up to whole
    # chunks), and decode steps between the engine's checks for finished
    # rows (one device-to-host read per chunk).
    max_decode_len: int = 64
    stream_chunk_tokens: int = 4
    # "int8" = int8 KV cache with per-token, per-head scales (llama).
    quant_kv: str | None = None
    # "int8" = weight-only int8 on every model (models/quant.py): per-output
    # -channel (tables: per-row) f32 scales, dequantized in the compute type
    # at each use.  TP, the one knob the reference refuses beside it, is not
    # ported, so no refusal of the pair is needed here yet.
    quantize: str | None = None
    # JSON object of LlamaConfig overrides, e.g. '{"num_layers": 4}'.
    llama_config: str | None = None
    # Streaming generations: concurrent streams (the continuous decode
    # loop's slot count, and the cap on its streams and the per-stream
    # path's together) before new ones shed with 503.
    max_streams: int = 8
    # Streams share the continuous decode loop's batched chunks; off
    # (CONTINUOUS_BATCHING=0), each stream decodes on its own through
    # InferenceEngine.generate_stream, as do prompts past the largest seq
    # bucket either way.
    continuous_batching: bool = True
    # How long an idle loop waits for the rest of a concurrent burst before
    # admitting the wave (ms).
    admit_grace_ms: float = 8.0
    # How /v1/chat/completions renders a message list into a prompt
    # (api/chat.py: plain|llama2|chatml|zephyr|llama3); validated when the
    # app is built.
    chat_template: str = "plain"
    # Shared system prompt of the decoder families (gpt2, llama): its KV is
    # computed once at startup and sits at positions [0, P) of every
    # generation, whose prefill runs over the request's own tokens only.
    prompt_prefix: str | None = None
    # Per-request prefix cache (decoder families, streamed generation): the
    # KV of recurring token prefixes (a conversation's system prompt and
    # history) is kept from each prefill, matched by content hash at seq
    # bucket lengths, and a later request sharing one prefills its suffix
    # only; LRU within prefix_cache_mb.  Paged, an entry pins the donor's
    # prompt blocks, which hits share by refcount.  Warmup captures a
    # (prefix bucket x suffix bucket) grid of graphs.  Mutually exclusive
    # with prompt_prefix.
    prefix_cache: bool = False
    prefix_cache_mb: float = 256.0
    # Chunked prefill (decoder families, the continuous loop): prompts longer
    # than prefill_chunk tokens, or past the largest seq bucket, prefill in
    # prefill_chunk-token windows interleaved with the loop's decode chunks,
    # so one long prompt never stalls every live stream for its whole
    # prefill; the loop's prompt ceiling rises to prefill_max_prompt (0 =
    # the model's position budget less the decode budget).  While streams
    # decode, at most prefill_budget window tokens dispatch at a chunk
    # boundary (0 = one window).  0 = off.  Under PAGED_KV a multiple of
    # KV_BLOCK_SIZE; refused for t5 and with PROMPT_PREFIX.
    prefill_chunk: int = 0
    prefill_budget: int = 0
    prefill_max_prompt: int = 0
    # Block-paged KV for the continuous loop: a pool of kv_block_size-token
    # blocks with per-slot block tables instead of per-slot contiguous
    # caches.  Seq buckets round up to the block grid.
    paged_kv: bool = False
    kv_block_size: int = 16
    # Host-RAM KV tier under PAGED_KV (MB of pinned host buffers; 0 = off):
    # a checkpointed stream's blocks swap out to it and its resume
    # prefetches them back instead of prefilling again, and an evicted
    # prefix-cache pin demotes to it and promotes back on a later match.
    # kv_prefetch_blocks blocks a chunk boundary come back while streams
    # decode (as many for each resuming stream when none does).
    kv_host_budget_mb: float = 0.0
    kv_prefetch_blocks: int = 4
    # Durable serving (runtime/durability.py): the write-ahead stream
    # journal's directory (unset: no journal, no disk tier, no jobs), its
    # fsync policy ("always" a record, "interval" at most every 50 ms,
    # "off"), and the disk KV tier under the host tier (MB under
    # JOURNAL_DIR/kv_disk; 0 = off; needs PAGED_KV, KV_HOST_BUDGET_MB and
    # JOURNAL_DIR).
    journal_dir: str | None = None
    journal_fsync: str = "always"
    kv_disk_budget_mb: float = 0.0
    # The /v1/batches bulk-job lane (jobs/): durable jobs under
    # JOURNAL_DIR/jobs whose lines backfill idle compute as batch-class
    # streams, at most job_max_concurrent_lines of a job in flight; a
    # finished job's results stay job_result_ttl_s seconds (0 = forever).
    jobs_enabled: bool = False
    job_max_concurrent_lines: int = 4
    job_result_ttl_s: float = 3600.0
    # Fused decode windows (gpt2, llama; the continuous loop): up to
    # decode_window chunks dispatched back to back and fetched once, so the
    # host dispatches and fetches once a window instead of once a chunk.
    # 1 = one chunk a dispatch.  With decode_window_auto (the default) the
    # window drops to 1 while interactive streams are live or waiting and
    # fuses up to the cap for batch-class traffic; off, it always fuses to
    # the cap.  Refused for t5.
    decode_window: int = 1
    decode_window_auto: bool = True
    # STREAM_PIPELINE: chunks (or windows) the continuous loop keeps in
    # flight before it fetches the oldest; 0 (auto) measures the dispatch
    # round trip against the chunk's compute at warmup and picks the depth
    # from them, trimming ADMIT_GRACE_MS to a tenth of the round trip.
    stream_pipeline: int = 0
    # HOST_PREP_DOUBLE: with a chunk in flight, the paged loop stages the
    # next dispatch's growth pass and block-table upload, and uses them at
    # that dispatch only if nothing they derive from moved (else they are
    # rolled back and prepared again inline).  A no-op for contiguous slots.
    host_prep_double: bool = True
    # ADMIT_OVERLAP: a wave's prefill queues behind the live chunk and its
    # fetch rides behind it; off, the wave's prefill, fetch and insert all
    # finish before the next chunk dispatch (the blocking order).
    admit_overlap: bool = True
    # Speculative decoding (gpt2, llama, t5-small): "ngram" drafts the next
    # spec_k tokens by prompt lookup (the last spec_ngram tokens matched
    # against the prompt and the generation so far; for t5 against the
    # encoder input) and verifies them in one forward of spec_k + 1 tokens a
    # row.  Greedy output equals the non-speculative greedy tokens.  Streams
    # take the speculative per-stream path while fewer than
    # spec_max_streams generations are active (non-streaming batches of at
    # most that many rows speculate too); spec_continuous runs the verify
    # rounds in the continuous loop instead (contiguous KV only).
    # spec_sampled: sampled rows speculate by rejection sampling (the same
    # distribution, other draws than the sequential sampler's); off, they
    # take the non-speculative paths.
    spec_decode: str | None = None
    spec_k: int = 8
    spec_ngram: int = 2
    spec_max_streams: int = 1
    spec_continuous: bool = False
    spec_sampled: bool = True
    # LoRA adapter library (tenancy/adapters.py): each <name>.npz under
    # adapter_dir (keys "layers.{i}.{proj}.lora_a|lora_b", optional scalar
    # "alpha") is an adapter a request picks with X-Adapter; rows of
    # different adapters decode in one dispatch of the continuous loop over
    # adapter_slots device slots (slot 0 the zero delta).  Unset: no adapter
    # code runs.  Refused with SPEC_DECODE/SPEC_CONTINUOUS.
    adapter_dir: str | None = None
    adapter_slots: int = 8
    # Multi-tenant accounts and fair share (tenancy/accounts.py,
    # tenancy/fairshare.py): TENANTS is the inline table, comma-separated
    # "name=weight" (or a bare "name", weight 1), each name its own
    # X-Api-Key; TENANTS_FILE a JSON list of specs with optional "weight",
    # "api_keys", "max_concurrency", "tokens_per_window", "kv_mb" and
    # "adapter" (the file wins for a name in both).  A bad table fails at
    # load.  Unset, no tenancy object is built.  Keyless callers share the
    # anonymous tenant at tenant_default_weight; tokens_per_window counts
    # over a sliding tenant_window_s; the first tenant_metrics_topk tenants
    # keep their names as metric labels.
    tenants: str | None = None
    tenants_file: str | None = None
    tenant_default_weight: float = 1.0
    tenant_window_s: float = 60.0
    tenant_metrics_topk: int = 8
    # Sequence-parallel width for bert-long: the sequence axis shards over
    # this many devices and attention runs as a ring (parallel/ring.py).
    # 0 = every visible card (one shard on the CPU).
    sp: int = 0
    # K3's split autotuner (ops/autotune.py): at the paged loop's warm-up
    # every feasible split count of the decode kernel's grid is verified
    # against the plain version and timed at the serving shape; the winner
    # persists in the tuning table (pallas_tune_table, else
    # build/torch_kernels/pallas_tune.json).  pallas_variant pins one split
    # count ("s<N>"), checked here and against the table width at warm-up.
    pallas_autotune: bool = False
    pallas_variant: str | None = None
    pallas_tune_table: str | None = None
    pallas_autotune_iters: int = 4
    # Fault tolerance (engine/faults.py, engine/supervisor.py), with the JAX
    # package's defaults: a FAULT_SPEC schedule of injected faults at the
    # dispatch sites (its grammar checked when the engine is built), a
    # watchdog deadline per dispatch (0 = off) with transient retries and
    # capped exponential backoff, and supervised rebuilds of the continuous
    # loop within a lifetime (or sliding-window) restart budget.
    fault_spec: str | None = None
    fault_seed: int = 0
    dispatch_timeout_s: float = 0.0
    dispatch_retries: int = 2
    dispatch_backoff_s: float = 0.05
    engine_restarts_max: int = 3
    engine_restart_window_s: float = 0.0
    supervise: bool = True

    def __post_init__(self) -> None:
        dev = self.device.lower()
        if dev not in VALID_DEVICES:
            raise ValueError(f"DEVICE must be one of {VALID_DEVICES}, got {self.device!r}")
        object.__setattr__(self, "device", dev)
        if self.max_batch < 1:
            raise ValueError("MAX_BATCH must be >= 1")
        if self.max_queue < 1:
            raise ValueError("MAX_QUEUE must be >= 1")
        if self.batch_timeout_ms < 0:
            raise ValueError("BATCH_TIMEOUT_MS must be >= 0")
        if self.register_max_tries < 1:
            raise ValueError("REGISTER_MAX_TRIES must be >= 1")
        if not (self.register_retry_s >= 0 and self.register_heartbeat_s >= 0):  # also NaN
            raise ValueError("REGISTER_RETRY_S/REGISTER_HEARTBEAT_S must be >= 0")
        if not 0 <= self.port < 65536:
            raise ValueError(f"PORT must be in [0, 65535], got {self.port}")
        _check_buckets("BATCH_BUCKETS", self.batch_buckets)
        _check_buckets("SEQ_BUCKETS", self.seq_buckets)
        if self.log_level.upper() not in _LOG_LEVELS:
            raise ValueError(f"LOG_LEVEL must be a standard logging level, got {self.log_level!r}")
        if self.max_decode_len < 1 or self.stream_chunk_tokens < 1:
            raise ValueError("MAX_DECODE_LEN and STREAM_CHUNK_TOKENS must be >= 1")
        self._check_observability()
        if self.quant_kv is not None:
            q = self.quant_kv.lower()
            q = None if q in ("", "none", "0", "false") else q
            if q not in (None, "int8"):
                raise ValueError(f"QUANT_KV must be 'int8' or unset, got {self.quant_kv!r}")
            object.__setattr__(self, "quant_kv", q)
        if self.quantize is not None:
            q = self.quantize.lower()
            q = None if q in ("", "none", "0", "false") else q
            if q not in (None, "int8"):
                raise ValueError(f"QUANTIZE must be 'int8' or unset, got {q!r}")
            object.__setattr__(self, "quantize", q)
        if not (1 <= self.adapter_slots <= 256):
            raise ValueError("ADAPTER_SLOTS must be in [1, 256]")
        self._check_tenancy()
        if self.pallas_variant:
            from ..ops.autotune import parse_variant

            parse_variant(self.pallas_variant)  # ValueError with the grammar on junk
        if self.pallas_autotune_iters < 1:
            raise ValueError("PALLAS_AUTOTUNE_ITERS must be >= 1")
        if self.fault_spec is not None and self.fault_spec.strip().lower() in (
                "", "none", "off", "0"):
            object.__setattr__(self, "fault_spec", None)
        if not (self.dispatch_timeout_s >= 0 and self.dispatch_backoff_s >= 0):
            raise ValueError("dispatch timeout/backoff must be >= 0")
        if self.dispatch_retries < 0 or self.engine_restarts_max < 0:
            raise ValueError("DISPATCH_RETRIES/ENGINE_RESTARTS_MAX must be >= 0")
        if not self.engine_restart_window_s >= 0:
            raise ValueError("ENGINE_RESTART_WINDOW_S must be >= 0")
        if self.max_streams < 1:
            raise ValueError("MAX_STREAMS must be >= 1")
        if self.spec_decode is not None:
            v = self.spec_decode.lower()
            v = None if v in ("", "none", "off", "0", "false") else v
            if v not in (None, "ngram"):
                raise ValueError(f"SPEC_DECODE must be 'ngram' or unset, got {self.spec_decode!r}")
            object.__setattr__(self, "spec_decode", v)
        if not 1 <= self.spec_k <= 64:
            raise ValueError("SPEC_K must be in [1, 64]")
        if not 1 <= self.spec_ngram <= 8:
            raise ValueError("SPEC_NGRAM must be in [1, 8]")
        if not 1 <= self.kv_block_size <= 1024:
            raise ValueError("KV_BLOCK_SIZE must be in [1, 1024]")
        if not self.kv_host_budget_mb >= 0:  # also NaN
            raise ValueError("KV_HOST_BUDGET_MB must be >= 0")
        if not self.kv_disk_budget_mb >= 0:  # also NaN
            raise ValueError("KV_DISK_BUDGET_MB must be >= 0")
        fsync = self.journal_fsync.lower()
        if fsync not in ("always", "interval", "off"):
            raise ValueError(
                f"JOURNAL_FSYNC must be 'always', 'interval' or 'off', got {fsync!r}")
        object.__setattr__(self, "journal_fsync", fsync)
        if not 1 <= self.job_max_concurrent_lines <= 256:
            raise ValueError("JOB_MAX_CONCURRENT_LINES must be in [1, 256]")
        if not self.job_result_ttl_s >= 0:
            raise ValueError("JOB_RESULT_TTL_S must be >= 0")
        if not 1 <= self.kv_prefetch_blocks <= 4096:
            raise ValueError("KV_PREFETCH_BLOCKS must be in [1, 4096]")
        if not 1 <= self.decode_window <= 64:
            raise ValueError("DECODE_WINDOW must be in [1, 64]")
        if self.sp < 0:
            raise ValueError(f"SP must be >= 0, got {self.sp}")
        if self.stream_pipeline < 0 or self.spec_max_streams < 0:
            raise ValueError("REPLICAS/SP/TP/STREAM_PIPELINE/MAX_STREAM_QUEUE/"
                             "FAULT_SEED/SPEC_MAX_STREAMS must be >= 0 (0 = auto/off)")
        if self.pipeline_depth < 1 or self.trace_ring < 1:
            raise ValueError("PIPELINE_DEPTH and TRACE_RING must be >= 1")
        if not (self.deadline_ms >= 0 and self.drain_grace_s >= 0):  # also rejects NaN
            raise ValueError("DEADLINE_MS and DRAIN_GRACE_S must be >= 0")
        if not self.admit_grace_ms >= 0:
            raise ValueError("ADMIT_GRACE_MS must be >= 0")
        prio = self.priority_default.lower()
        if prio not in ("interactive", "batch"):
            raise ValueError(
                f"PRIORITY_DEFAULT must be 'interactive' or 'batch', got {self.priority_default!r}")
        object.__setattr__(self, "priority_default", prio)
        if self.class_weight < 1:
            raise ValueError("CLASS_WEIGHT must be >= 1")
        if not self.kv_budget_mb >= 0 or self.max_stream_queue < 0:  # also NaN
            raise ValueError("KV_BUDGET_MB and MAX_STREAM_QUEUE must be >= 0")
        if not self.prefix_cache_mb >= 0:
            raise ValueError("PREFIX_CACHE_MB must be >= 0")
        if min(self.prefill_chunk, self.prefill_budget, self.prefill_max_prompt) < 0:
            raise ValueError("PREFILL_CHUNK/PREFILL_BUDGET/PREFILL_MAX_PROMPT must be >= 0")
        object.__setattr__(self, "chat_template", self.chat_template.lower())
        object.__setattr__(self, "seq_buckets", _align_paged_seq_buckets(self))


    def _check_tenancy(self) -> None:
        """The reference's checks and messages for the tenancy knobs; the
        tenant table is parsed here, so a bad one fails at load."""
        if not (self.tenant_default_weight > 0 and self.tenant_window_s > 0):  # also NaN
            raise ValueError("TENANT_DEFAULT_WEIGHT/TENANT_WINDOW_S must be > 0")
        if not 1 <= self.tenant_metrics_topk <= 64:
            raise ValueError("TENANT_METRICS_TOPK must be in [1, 64]")
        if self.tenants or self.tenants_file:
            from ..tenancy.accounts import parse_tenants

            parse_tenants(self.tenants, self.tenants_file)

    def _check_observability(self) -> None:
        """The reference's validators and messages for the observability
        knobs."""
        fmt = self.log_format.lower()
        if fmt not in ("text", "json"):
            raise ValueError(f"LOG_FORMAT must be 'text' or 'json', got {fmt!r}")
        object.__setattr__(self, "log_format", fmt)
        if self.flight_ring < 0:
            raise ValueError("TRACE_RING/FLIGHT_RING must be >= 0")
        if not all(v >= 0 for v in (self.peak_tflops, self.slo_ttft_ms, self.slo_tbt_ms,
                                    self.slo_batch_ttft_ms, self.slo_batch_tbt_ms)):
            raise ValueError("PEAK_TFLOPS/SLO_TTFT_MS/SLO_TBT_MS/SLO_BATCH_TTFT_MS/"
                             "SLO_BATCH_TBT_MS/SCALE_UP_SLO_BURN must be >= 0 (0 = off/auto)")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError("SLO_TARGET must be in (0, 1) — the error budget is "
                             "1 - SLO_TARGET")
        try:
            parts = [float(x) for x in self.slo_windows_s.split(",") if x.strip()]
        except ValueError:
            raise ValueError(
                f"SLO_WINDOWS_S must be 'fast,slow' seconds, got {self.slo_windows_s!r}"
            ) from None
        if len(parts) != 2 or parts[0] <= 0 or parts[0] >= parts[1]:
            raise ValueError("SLO_WINDOWS_S must be two ascending positive durations "
                             f"'fast,slow', got {self.slo_windows_s!r}")
        if self.latency_buckets is not None and not self.latency_buckets.strip():
            object.__setattr__(self, "latency_buckets", None)
        if self.latency_buckets is not None:
            from .metrics import parse_buckets

            if parse_buckets(self.latency_buckets) is None:
                raise ValueError("LATENCY_BUCKETS must be comma-separated strictly "
                                 f"ascending positive seconds, got {self.latency_buckets!r}")


def _align_paged_seq_buckets(cfg: ServiceConfig) -> tuple[int, ...]:
    """Under PAGED_KV the seq buckets round up to the block grid (deduped,
    still ascending), so a prompt's collated width is whole blocks;
    aligned grids pass through unchanged."""
    if not cfg.paged_kv or cfg.kv_block_size <= 1:
        return cfg.seq_buckets
    bs = cfg.kv_block_size
    return tuple(sorted({-(-b // bs) * bs for b in cfg.seq_buckets}))


def _flag(v: str) -> bool:
    return v.lower() not in ("0", "false", "no")


# Knobs of the JAX package this port does not serve yet, with the values
# that leave them off (for a knob read only under another one, its JAX
# default).  Setting one to any other value raises instead of serving
# without it.
UNPORTED_KNOBS = {
    "TP": ("0", "1"),
    # Data-parallel replicas over several cards (ReplicaSet) and bert-long's
    # 2-D ('replica', 'sp') mesh; the fleet router and its autoscaler.
    "REPLICAS": ("0", "1"),
    "FLEET_REPLICAS": ("0", "1"),
    "FLEET_ROUTE": ("least",),
    "FLEET_BREAKER_N": ("3",),
    "FLEET_EVICT_S": ("10",),
    "FLEET_TP_GROUPS": (),
    "FLEET_MIN_REPLICAS": ("0",),
    "FLEET_MAX_REPLICAS": ("0",),
    "SCALE_UP_QUEUE": ("2",),
    "SCALE_UP_KV_FRAC": ("0.85",),
    "SCALE_UP_TTFT_MS": ("0",),
    "SCALE_UP_COOLDOWN_S": ("3",),
    "SCALE_DOWN_LOAD": ("0.25",),
    "SCALE_DOWN_COOLDOWN_S": ("10",),
    "SCALE_PERIOD_S": ("0.5",),
    # The scaling governor's SLO signal comes with the fleet.
    "SCALE_UP_SLO_BURN": ("0",),
}

# Knobs of the JAX package with no meaning on the card, each with the
# reason; the port accepts and ignores them.
INERT_KNOBS = {
    "COMPILE_CACHE_DIR": "XLA's persistent compilation cache; the port's kernels "
                         "are cached by source hash under build/torch_kernels",
    "PALLAS_INTERPRET": "runs Pallas kernels in interpret mode; CPU tensors take "
                        "the plain PyTorch versions instead",
    "PALLAS_SINGLE_BLOCK_MAX_SEQ": "caps the TPU encoder kernel's single VMEM block; "
                                   "the CUDA kernel walks 128-key tiles at any length",
    "DECODE_KERNEL_VMEM_BUDGET_MB": "TPU VMEM budget of the decode kernel's "
                                    "whole-slab blocks; the CUDA kernels stream tiles",
    "JAX_PLATFORMS": "picks JAX's backend; the port's device is DEVICE",
    "USE_PALLAS_ATTENTION": "switches the encoder's Pallas kernel on or off; the port "
                            "always launches its CUDA kernel on the card",
    "USE_PALLAS_DECODE": "switches the Pallas decode kernels on or off; the port "
                         "always launches its CUDA kernels on the card",
}


def _is_off(value: str, off: tuple[str, ...]) -> bool:
    """Whether ``value`` is one of ``off``, numbers compared as numbers."""
    v = value.strip().lower()
    if v in off:
        return True
    try:
        x = float(v)
    except ValueError:
        return False
    for o in off:
        try:
            if float(o) == x:
                return True
        except ValueError:
            pass
    return False


def load_config(overrides: dict[str, str] | None = None) -> ServiceConfig:
    """Build a ServiceConfig from environment variables, with ``overrides``
    (same names) taking precedence.

    Recognized: DEVICE, MODEL_NAME, MODEL_PATH, TOKENIZER_PATH, LABELS_PATH,
    HOST, PORT, SERVER_URL, REGISTER_HEARTBEAT_S, MAX_BATCH, BATCH_TIMEOUT_MS,
    MAX_QUEUE, BATCH_BUCKETS, SEQ_BUCKETS, WARMUP, LOG_LEVEL, TRACE, MAX_DECODE_LEN,
    STREAM_CHUNK_TOKENS, QUANT_KV, LLAMA_CONFIG, MAX_STREAMS, PAGED_KV,
    KV_BLOCK_SIZE, CONTINUOUS_BATCHING, SP, TRACE_RING, PIPELINE_DEPTH, DEADLINE_MS,
    DRAIN_GRACE_S, WARMUP_SAMPLING, ADMIT_GRACE_MS, CHAT_TEMPLATE, PRIORITY_DEFAULT,
    CLASS_WEIGHT, KV_BUDGET_MB, MAX_STREAM_QUEUE, PREEMPT, PROMPT_PREFIX,
    PREFIX_CACHE, PREFIX_CACHE_MB, PREFILL_CHUNK, PREFILL_BUDGET,
    PREFILL_MAX_PROMPT, KV_HOST_BUDGET_MB, KV_PREFETCH_BLOCKS, JOURNAL_DIR,
    JOURNAL_FSYNC, KV_DISK_BUDGET_MB, JOBS_ENABLED, JOB_MAX_CONCURRENT_LINES,
    JOB_RESULT_TTL_S, DECODE_WINDOW,
    DECODE_WINDOW_AUTO, STREAM_PIPELINE, HOST_PREP_DOUBLE, ADMIT_OVERLAP, SPEC_DECODE,
    SPEC_K, SPEC_NGRAM, SPEC_MAX_STREAMS, SPEC_SAMPLED, SPEC_CONTINUOUS, QUANTIZE,
    ADAPTER_DIR, ADAPTER_SLOTS, TENANTS, TENANTS_FILE, TENANT_DEFAULT_WEIGHT,
    TENANT_WINDOW_S, TENANT_METRICS_TOPK, PALLAS_AUTOTUNE, PALLAS_VARIANT,
    PALLAS_TUNE_TABLE, PALLAS_AUTOTUNE_ITERS, FAULT_SPEC, FAULT_SEED, DISPATCH_TIMEOUT_S,
    DISPATCH_RETRIES, DISPATCH_BACKOFF_S, ENGINE_RESTARTS_MAX,
    ENGINE_RESTART_WINDOW_S, SUPERVISE, LOG_FORMAT, FLIGHT_RING, PROFILE_DIR (else
    JAX_TRACE_DIR), LOCKTRACE, PERF_OBS, PEAK_TFLOPS, LATENCY_BUCKETS, SLO_TTFT_MS,
    SLO_TBT_MS, SLO_BATCH_TTFT_MS, SLO_BATCH_TBT_MS, SLO_TARGET, SLO_WINDOWS_S.  Any of
    ``UNPORTED_KNOBS`` set to a value that turns it on raises;
    ``INERT_KNOBS`` are accepted and ignored."""
    e = dict(os.environ)
    if overrides:
        e.update(overrides)

    def get(name: str) -> str | None:
        v = e.get(name)
        return v if v not in (None, "") else None

    on = sorted(
        var for var, off in UNPORTED_KNOBS.items()
        if get(var) is not None and not _is_off(get(var), off)
    )
    if on:
        raise ValueError(
            f"{', '.join(on)}: not ported yet to the PyTorch service "
            "(the JAX package serves them)"
        )
    kwargs: dict = {}
    for field, var in (
        ("device", "DEVICE"), ("model_name", "MODEL_NAME"),
        ("model_path", "MODEL_PATH"), ("tokenizer_path", "TOKENIZER_PATH"),
        ("labels_path", "LABELS_PATH"), ("host", "HOST"), ("server_url", "SERVER_URL"),
        ("log_level", "LOG_LEVEL"), ("quant_kv", "QUANT_KV"),
        ("llama_config", "LLAMA_CONFIG"), ("chat_template", "CHAT_TEMPLATE"),
        ("priority_default", "PRIORITY_DEFAULT"), ("prompt_prefix", "PROMPT_PREFIX"),
        ("spec_decode", "SPEC_DECODE"), ("quantize", "QUANTIZE"),
        ("adapter_dir", "ADAPTER_DIR"), ("pallas_variant", "PALLAS_VARIANT"),
        ("pallas_tune_table", "PALLAS_TUNE_TABLE"), ("fault_spec", "FAULT_SPEC"),
        ("log_format", "LOG_FORMAT"), ("latency_buckets", "LATENCY_BUCKETS"),
        ("slo_windows_s", "SLO_WINDOWS_S"), ("journal_dir", "JOURNAL_DIR"),
        ("journal_fsync", "JOURNAL_FSYNC"), ("tenants", "TENANTS"),
        ("tenants_file", "TENANTS_FILE"),
    ):
        v = get(var)
        if v is not None:
            kwargs[field] = v
    for field, var in (("port", "PORT"), ("max_batch", "MAX_BATCH"),
                       ("max_queue", "MAX_QUEUE"), ("max_decode_len", "MAX_DECODE_LEN"),
                       ("stream_chunk_tokens", "STREAM_CHUNK_TOKENS"),
                       ("max_streams", "MAX_STREAMS"), ("kv_block_size", "KV_BLOCK_SIZE"),
                       ("sp", "SP"), ("trace_ring", "TRACE_RING"),
                       ("pipeline_depth", "PIPELINE_DEPTH"), ("class_weight", "CLASS_WEIGHT"),
                       ("max_stream_queue", "MAX_STREAM_QUEUE"), ("prefill_chunk", "PREFILL_CHUNK"),
                       ("prefill_budget", "PREFILL_BUDGET"),
                       ("prefill_max_prompt", "PREFILL_MAX_PROMPT"),
                       ("kv_prefetch_blocks", "KV_PREFETCH_BLOCKS"),
                       ("decode_window", "DECODE_WINDOW"),
                       ("stream_pipeline", "STREAM_PIPELINE"), ("spec_k", "SPEC_K"),
                       ("spec_ngram", "SPEC_NGRAM"), ("spec_max_streams", "SPEC_MAX_STREAMS"),
                       ("adapter_slots", "ADAPTER_SLOTS"),
                       ("pallas_autotune_iters", "PALLAS_AUTOTUNE_ITERS"),
                       ("fault_seed", "FAULT_SEED"), ("dispatch_retries", "DISPATCH_RETRIES"),
                       ("engine_restarts_max", "ENGINE_RESTARTS_MAX"),
                       ("flight_ring", "FLIGHT_RING"),
                       ("job_max_concurrent_lines", "JOB_MAX_CONCURRENT_LINES"),
                       ("tenant_metrics_topk", "TENANT_METRICS_TOPK")):
        v = get(var)
        if v is not None:
            kwargs[field] = int(v)
    for field, var in (("batch_timeout_ms", "BATCH_TIMEOUT_MS"), ("deadline_ms", "DEADLINE_MS"),
                       ("drain_grace_s", "DRAIN_GRACE_S"), ("admit_grace_ms", "ADMIT_GRACE_MS"),
                       ("register_heartbeat_s", "REGISTER_HEARTBEAT_S"),
                       ("kv_budget_mb", "KV_BUDGET_MB"), ("prefix_cache_mb", "PREFIX_CACHE_MB"),
                       ("kv_host_budget_mb", "KV_HOST_BUDGET_MB"),
                       ("kv_disk_budget_mb", "KV_DISK_BUDGET_MB"),
                       ("job_result_ttl_s", "JOB_RESULT_TTL_S"),
                       ("dispatch_timeout_s", "DISPATCH_TIMEOUT_S"),
                       ("dispatch_backoff_s", "DISPATCH_BACKOFF_S"),
                       ("engine_restart_window_s", "ENGINE_RESTART_WINDOW_S"),
                       ("peak_tflops", "PEAK_TFLOPS"), ("slo_ttft_ms", "SLO_TTFT_MS"),
                       ("slo_tbt_ms", "SLO_TBT_MS"), ("slo_batch_ttft_ms", "SLO_BATCH_TTFT_MS"),
                       ("slo_batch_tbt_ms", "SLO_BATCH_TBT_MS"), ("slo_target", "SLO_TARGET"),
                       ("tenant_default_weight", "TENANT_DEFAULT_WEIGHT"),
                       ("tenant_window_s", "TENANT_WINDOW_S")):
        v = get(var)
        if v is not None:
            kwargs[field] = float(v)
    for field, var in (("batch_buckets", "BATCH_BUCKETS"), ("seq_buckets", "SEQ_BUCKETS")):
        v = get(var)
        if v is not None:
            buckets = tuple(int(x) for x in v.split(",") if x.strip())
            if not buckets:
                raise ValueError(f"{var}={v!r} parsed to no buckets")
            kwargs[field] = buckets
    for field, var in (("warmup", "WARMUP"), ("trace", "TRACE"), ("paged_kv", "PAGED_KV"),
                       ("warmup_sampling", "WARMUP_SAMPLING"),
                       ("continuous_batching", "CONTINUOUS_BATCHING"), ("preempt", "PREEMPT"),
                       ("prefix_cache", "PREFIX_CACHE"),
                       ("decode_window_auto", "DECODE_WINDOW_AUTO"),
                       ("host_prep_double", "HOST_PREP_DOUBLE"),
                       ("admit_overlap", "ADMIT_OVERLAP"), ("spec_sampled", "SPEC_SAMPLED"),
                       ("spec_continuous", "SPEC_CONTINUOUS"),
                       ("pallas_autotune", "PALLAS_AUTOTUNE"), ("supervise", "SUPERVISE"),
                       ("perf_obs", "PERF_OBS"), ("jobs_enabled", "JOBS_ENABLED")):
        v = get(var)
        if v is not None:
            kwargs[field] = _flag(v)
    # The profiler's directory: PROFILE_DIR, else the reference's older name.
    v = get("PROFILE_DIR") or get("JAX_TRACE_DIR")
    if v is not None:
        kwargs["profile_dir"] = v
    # LOCKTRACE is off for "0", "false" or empty, as the reference's
    # ``locktrace.auto_install`` reads it.
    v = get("LOCKTRACE")
    if v is not None:
        kwargs["locktrace"] = v.lower() not in ("0", "false")
    return ServiceConfig(**kwargs)
