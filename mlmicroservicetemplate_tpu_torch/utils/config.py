"""Env-var driven service configuration (12-factor), as a stdlib dataclass.

Holds the fields the ResNet-50, BERT-base, bert-long, llama, GPT-2 and
T5-small paths, chat, the scheduler's priority classes, KV budget and
preemption, and the parent registration read, under the same
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
    # TRACE=1 records request / queue-wait / dispatch spans, the newest
    # trace_ring of them.
    trace: bool = False
    trace_ring: int = 4096
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
    # Block-paged KV for the continuous loop: a pool of kv_block_size-token
    # blocks with per-slot block tables instead of per-slot contiguous
    # caches.  Seq buckets round up to the block grid.
    paged_kv: bool = False
    kv_block_size: int = 16
    # Sequence-parallel width for bert-long: the sequence axis shards over
    # this many devices and attention runs as a ring (parallel/ring.py).
    # 0 = every visible card (one shard on the CPU).
    sp: int = 0

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
        if self.quant_kv is not None:
            q = self.quant_kv.lower()
            q = None if q in ("", "none", "0", "false") else q
            if q not in (None, "int8"):
                raise ValueError(f"QUANT_KV must be 'int8' or unset, got {self.quant_kv!r}")
            object.__setattr__(self, "quant_kv", q)
        if self.max_streams < 1:
            raise ValueError("MAX_STREAMS must be >= 1")
        if not 1 <= self.kv_block_size <= 1024:
            raise ValueError("KV_BLOCK_SIZE must be in [1, 1024]")
        if self.sp < 0:
            raise ValueError(f"SP must be >= 0, got {self.sp}")
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
        object.__setattr__(self, "chat_template", self.chat_template.lower())
        object.__setattr__(self, "seq_buckets", _align_paged_seq_buckets(self))


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


_OFF = ("0", "false", "no")
_ON = ("1", "true", "yes")

# Knobs of the JAX package this port does not serve yet, with the values
# that leave them off (for a knob read only under another one, its JAX
# default).  Setting one to any other value raises instead of serving
# without it.
UNPORTED_KNOBS = {
    "PROMPT_PREFIX": (),
    "PREFIX_CACHE": _OFF,
    "PREFIX_CACHE_MB": ("256",),
    "SPEC_DECODE": ("none",) + _OFF,
    "SPEC_K": ("8",),
    "SPEC_NGRAM": ("2",),
    "SPEC_MAX_STREAMS": ("1",),
    "SPEC_SAMPLED": _ON,
    "SPEC_CONTINUOUS": _OFF,
    "PREFILL_CHUNK": ("0",),
    "PREFILL_BUDGET": ("0",),
    "PREFILL_MAX_PROMPT": ("0",),
    "DECODE_WINDOW": ("1",),
    "DECODE_WINDOW_AUTO": _ON,
    "TP": ("0", "1"),
    "QUANTIZE": ("none",) + _OFF,
    "ADAPTER_DIR": (),
    "ADAPTER_SLOTS": ("8",),
    # The continuous loop runs one chunk in flight (0 = auto picks that on
    # a directly attached card), preps each chunk after the last one, and
    # has no host KV tier; its other knobs wait for later slices.
    "STREAM_PIPELINE": ("0", "1"),
    "HOST_PREP_DOUBLE": _OFF,
    "KV_HOST_BUDGET_MB": ("0",),
    "KV_DISK_BUDGET_MB": ("0",),
    "KV_PREFETCH_BLOCKS": ("4",),
    "JOURNAL_DIR": (),
    "JOURNAL_FSYNC": ("always",),
    # The loop always admits behind the live chunk (the JAX default); the
    # blocking admission order of ADMIT_OVERLAP=0 is not ported.
    "ADMIT_OVERLAP": _ON,
    "TENANTS": (),
    "TENANTS_FILE": (),
    "TENANT_DEFAULT_WEIGHT": ("1",),
    "TENANT_WINDOW_S": ("60",),
    "TENANT_METRICS_TOPK": ("8",),
    "JOBS_ENABLED": _OFF,
    "JOB_MAX_CONCURRENT_LINES": ("4",),
    "JOB_RESULT_TTL_S": ("3600",),
    # Fault injection, dispatch watchdog and engine supervision.
    "FAULT_SPEC": (),
    "FAULT_SEED": ("0",),
    "DISPATCH_TIMEOUT_S": ("0",),
    "DISPATCH_RETRIES": ("2",),
    "DISPATCH_BACKOFF_S": ("0.05",),
    "ENGINE_RESTARTS_MAX": ("3",),
    "ENGINE_RESTART_WINDOW_S": ("0",),
    "SUPERVISE": _OFF,
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
    "SCALE_UP_SLO_BURN": ("0",),
    # Observability beyond /metrics and TRACE: the flight recorder, the
    # profiler endpoint, JSON logs, utilisation gauges, SLO burn rates.
    "FLIGHT_RING": ("256",),
    "PROFILE_DIR": (),
    # The lock-order detector and the /debug/profile route (its trace
    # directory).
    "LOCKTRACE": _OFF,
    "JAX_TRACE_DIR": (),
    "LOG_FORMAT": ("text",),
    "PERF_OBS": _OFF,
    "PEAK_TFLOPS": ("0",),
    "LATENCY_BUCKETS": (),
    "SLO_TTFT_MS": ("0",),
    "SLO_TBT_MS": ("0",),
    "SLO_BATCH_TTFT_MS": ("0",),
    "SLO_BATCH_TBT_MS": ("0",),
    "SLO_TARGET": ("0.99",),
    "SLO_WINDOWS_S": ("60,600",),
}

# Knobs of the JAX package with no meaning on the card, each with the
# reason; the port accepts and ignores them.
INERT_KNOBS = {
    "COMPILE_CACHE_DIR": "XLA's persistent compilation cache; the port's kernels "
                         "are cached by source hash under build/torch_kernels",
    "PALLAS_AUTOTUNE": "sweeps the Pallas kernels' TPU tuning variants; the CUDA "
                       "kernels have one configuration",
    "PALLAS_VARIANT": "names a Pallas tuning variant of the same function",
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
    "PALLAS_AUTOTUNE_ITERS": "timing iterations of the Pallas autotuner; the CUDA "
                             "kernels have one configuration",
    "PALLAS_TUNE_TABLE": "file of the Pallas autotuner's chosen variants; the CUDA "
                         "kernels have one configuration",
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
    CLASS_WEIGHT, KV_BUDGET_MB, MAX_STREAM_QUEUE, PREEMPT.  Any of
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
        ("priority_default", "PRIORITY_DEFAULT"),
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
                       ("max_stream_queue", "MAX_STREAM_QUEUE")):
        v = get(var)
        if v is not None:
            kwargs[field] = int(v)
    for field, var in (("batch_timeout_ms", "BATCH_TIMEOUT_MS"), ("deadline_ms", "DEADLINE_MS"),
                       ("drain_grace_s", "DRAIN_GRACE_S"), ("admit_grace_ms", "ADMIT_GRACE_MS"),
                       ("register_heartbeat_s", "REGISTER_HEARTBEAT_S"),
                       ("kv_budget_mb", "KV_BUDGET_MB")):
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
                       ("continuous_batching", "CONTINUOUS_BATCHING"), ("preempt", "PREEMPT")):
        v = get(var)
        if v is not None:
            kwargs[field] = _flag(v)
    return ServiceConfig(**kwargs)
