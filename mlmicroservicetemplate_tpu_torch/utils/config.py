"""Env-var driven service configuration (12-factor), as a stdlib dataclass.

Holds the fields the BERT-base, bert-long and llama paths read, under the
same environment names as the JAX package's ``ServiceConfig``.  ``DEVICE``
is ``cuda|cpu`` and defaults to ``cuda``.
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
    model_name: str = "bert-base"
    # Checkpoint (HF state dict as .npz / .safetensors / .bin); unset =
    # deterministic random init from a seed.
    model_path: str | None = None
    # WordPiece vocab.txt; unset = byte-level tokenizer.
    tokenizer_path: str | None = None
    labels_path: str | None = None
    host: str = "0.0.0.0"
    port: int = 8000
    # Dynamic batching: a batch closes at max_batch items or
    # batch_timeout_ms after its first item; past max_queue waiting items
    # the server sheds (503).
    max_batch: int = 32
    batch_timeout_ms: float = 3.0
    max_queue: int = 1024
    # Shape buckets: requests are padded up to the nearest bucket.
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    seq_buckets: tuple[int, ...] = (32, 64, 128, 256, 512)
    # Run every (batch, seq) bucket once before reporting ready.
    warmup: bool = True
    log_level: str = "INFO"
    # TRACE=1 records request / queue-wait / dispatch spans.
    trace: bool = False
    # Generative models: decode budget per request (rounded up to whole
    # chunks), and decode steps between the engine's checks for finished
    # rows (one device-to-host read per chunk).
    max_decode_len: int = 64
    stream_chunk_tokens: int = 4
    # "int8" = int8 KV cache with per-token, per-head scales (llama).
    quant_kv: str | None = None
    # JSON object of LlamaConfig overrides, e.g. '{"num_layers": 4}'.
    llama_config: str | None = None
    # Streaming generations: concurrent streams of the continuous decode
    # loop (its slot count) before new ones shed with 503.
    max_streams: int = 8
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


# Knobs of the JAX package this port does not serve yet, with the values
# that leave them off.  Setting one raises instead of serving without it.
UNPORTED_KNOBS = {
    "PROMPT_PREFIX": (),
    "PREFIX_CACHE": ("0", "false", "no"),
    "SPEC_DECODE": ("none", "0", "false", "no"),
    "PREFILL_CHUNK": ("0",),
    "DECODE_WINDOW": ("1",),
    "TP": ("0", "1"),
    "QUANTIZE": ("none", "0", "false", "no"),
    "ADAPTER_DIR": (),
    # The continuous loop runs one chunk in flight (0 = auto picks that on
    # a directly attached card) and holds a pool sized for MAX_STREAMS
    # worst cases; its other knobs wait for later slices.
    "STREAM_PIPELINE": ("0", "1"),
    "KV_BUDGET_MB": ("0", "0.0"),
    "MAX_STREAM_QUEUE": ("0",),
    "KV_HOST_BUDGET_MB": ("0", "0.0"),
    "KV_DISK_BUDGET_MB": ("0", "0.0"),
    "FLEET_REPLICAS": ("0", "1"),
    "SPEC_CONTINUOUS": ("0", "false", "no"),
    "JOURNAL_DIR": (),
    # Data-parallel replicas over several cards (ReplicaSet) and bert-long's
    # 2-D ('replica', 'sp') mesh.
    "REPLICAS": ("0", "1"),
}


def load_config(overrides: dict[str, str] | None = None) -> ServiceConfig:
    """Build a ServiceConfig from environment variables, with ``overrides``
    (same names) taking precedence.

    Recognized: DEVICE, MODEL_NAME, MODEL_PATH, TOKENIZER_PATH, LABELS_PATH,
    HOST, PORT, MAX_BATCH, BATCH_TIMEOUT_MS, MAX_QUEUE, BATCH_BUCKETS,
    SEQ_BUCKETS, WARMUP, LOG_LEVEL, TRACE, MAX_DECODE_LEN,
    STREAM_CHUNK_TOKENS, QUANT_KV, LLAMA_CONFIG, MAX_STREAMS, PAGED_KV,
    KV_BLOCK_SIZE, SP.  Any of ``UNPORTED_KNOBS`` set to a value that turns it
    on raises, as does ``CONTINUOUS_BATCHING=0`` (the per-stream decode
    workers are not ported)."""
    e = dict(os.environ)
    if overrides:
        e.update(overrides)

    def get(name: str) -> str | None:
        v = e.get(name)
        return v if v not in (None, "") else None

    on = sorted(
        var for var, off in UNPORTED_KNOBS.items()
        if get(var) is not None and get(var).strip().lower() not in off
    )
    if get("CONTINUOUS_BATCHING") is not None and not _flag(get("CONTINUOUS_BATCHING")):
        on.append("CONTINUOUS_BATCHING=0")
    if on:
        raise ValueError(
            f"{', '.join(on)}: not ported yet to the PyTorch service "
            "(the JAX package serves them)"
        )
    kwargs: dict = {}
    for field, var in (
        ("device", "DEVICE"), ("model_name", "MODEL_NAME"),
        ("model_path", "MODEL_PATH"), ("tokenizer_path", "TOKENIZER_PATH"),
        ("labels_path", "LABELS_PATH"), ("host", "HOST"),
        ("log_level", "LOG_LEVEL"), ("quant_kv", "QUANT_KV"),
        ("llama_config", "LLAMA_CONFIG"),
    ):
        v = get(var)
        if v is not None:
            kwargs[field] = v
    for field, var in (("port", "PORT"), ("max_batch", "MAX_BATCH"),
                       ("max_queue", "MAX_QUEUE"), ("max_decode_len", "MAX_DECODE_LEN"),
                       ("stream_chunk_tokens", "STREAM_CHUNK_TOKENS"),
                       ("max_streams", "MAX_STREAMS"), ("kv_block_size", "KV_BLOCK_SIZE"),
                       ("sp", "SP")):
        v = get(var)
        if v is not None:
            kwargs[field] = int(v)
    v = get("BATCH_TIMEOUT_MS")
    if v is not None:
        kwargs["batch_timeout_ms"] = float(v)
    for field, var in (("batch_buckets", "BATCH_BUCKETS"), ("seq_buckets", "SEQ_BUCKETS")):
        v = get(var)
        if v is not None:
            buckets = tuple(int(x) for x in v.split(",") if x.strip())
            if not buckets:
                raise ValueError(f"{var}={v!r} parsed to no buckets")
            kwargs[field] = buckets
    for field, var in (("warmup", "WARMUP"), ("trace", "TRACE"), ("paged_kv", "PAGED_KV")):
        v = get(var)
        if v is not None:
            kwargs[field] = _flag(v)
    return ServiceConfig(**kwargs)
