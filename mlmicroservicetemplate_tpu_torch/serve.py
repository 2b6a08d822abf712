"""Service entrypoint: config -> device -> model -> engine -> batcher -> HTTP.

Boots from env vars with optional CLI overrides, e.g.::

    python -m mlmicroservicetemplate_tpu_torch            # resnet50 on the card
    python -m mlmicroservicetemplate_tpu_torch.serve --device cuda --model bert-base
    QUANT_KV=int8 python -m mlmicroservicetemplate_tpu_torch.serve --model llama
    PAGED_KV=1 python -m mlmicroservicetemplate_tpu_torch.serve --model llama
    SP=1 SEQ_BUCKETS=512,1024,2048 python -m mlmicroservicetemplate_tpu_torch.serve \
        --model bert-long
    DEVICE=cpu MODEL_NAME=bert-base python -m mlmicroservicetemplate_tpu_torch.serve
    SERVER_URL=http://parent:9000 python -m mlmicroservicetemplate_tpu_torch
    PAGED_KV=1 KV_HOST_BUDGET_MB=512 KV_DISK_BUDGET_MB=4096 JOBS_ENABLED=1 \
        python -m mlmicroservicetemplate_tpu_torch.serve --model llama --journal-dir /var/journal

``build_service`` assembles everything but the HTTP layer, so it needs no
aiohttp; ``main`` adds the aiohttp app and serves until SIGTERM/SIGINT.
For a generative model the batcher holds the continuous decode loop that
serves streams: warmed with the engine before the service reports ready,
its thread started by the first stream and stopped with the batcher when
the app shuts down.
"""

from __future__ import annotations

import argparse
import logging
import sys


def parse_args(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description="PyTorch/CUDA inference microservice")
    p.add_argument("--model", dest="MODEL_NAME",
                   help="resnet50 (default) | bert-base | bert-long | llama (alias tinyllama)")
    p.add_argument("--device", dest="DEVICE", help="cuda | cpu")
    p.add_argument("--host", dest="HOST")
    p.add_argument("--port", dest="PORT")
    p.add_argument("--model-path", dest="MODEL_PATH")
    p.add_argument("--tokenizer-path", dest="TOKENIZER_PATH")
    p.add_argument("--server-url", dest="SERVER_URL",
                   help="parent server to register with (POST <url>/register)")
    p.add_argument("--max-batch", dest="MAX_BATCH")
    p.add_argument("--batch-timeout-ms", dest="BATCH_TIMEOUT_MS")
    p.add_argument("--journal-dir", dest="JOURNAL_DIR",
                   help="crash-safe stream journal directory (JOURNAL_DIR)")
    p.add_argument("--no-warmup", action="store_true")
    args = p.parse_args(argv)
    overrides = {k: str(v) for k, v in vars(args).items() if v is not None and k != "no_warmup"}
    if args.no_warmup:
        overrides["WARMUP"] = "0"
    return overrides


def build_service(overrides: dict | None = None, params=None):
    """Assemble (cfg, bundle, engine, batcher) without running anything.

    ``params``: optional param pytree in the JAX package's layout (numpy
    leaves) of the named model (ResNet-50, BERT-base, bert-long or llama),
    served in place of MODEL_PATH or random init.

    ``LOCKTRACE=1`` installs the lock-order detector before any engine lock
    exists (locks made earlier stay untraced); ``LOG_FORMAT=json`` gives the
    root logger's handlers one JSON object per line."""
    import os

    from .utils import locktrace

    locktrace.auto_install({**os.environ, **(overrides or {})})
    from .utils.config import load_config

    cfg = load_config(overrides)
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from .utils import tracing

    if cfg.log_format == "json":
        for h in logging.getLogger().handlers:
            h.setFormatter(tracing.JsonLogFormatter())
    tracing.configure(cfg.trace, cfg.trace_ring)

    from .engine.engine import InferenceEngine
    from .models.registry import build_model
    from .scheduler.batcher import Batcher

    bundle = build_model(cfg, params=params)
    engine = InferenceEngine(bundle, cfg)
    batcher = Batcher(engine, cfg)
    return cfg, bundle, engine, batcher


async def _serve_until_signalled(app, cfg, grace_s: float = 30.0) -> None:
    """Serve; on SIGTERM/SIGINT drain (readyz -> 503, in-flight work
    finishes within ``grace_s``, ``DRAIN_GRACE_S``) and exit."""
    import asyncio
    import signal

    from aiohttp import web

    from .api.app import drain_app

    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    logging.getLogger("serve").info("signal received: draining (grace %.0fs)", grace_s)
    await drain_app(app, grace_s)
    await runner.cleanup()


def main(argv: list[str] | None = None) -> None:
    import asyncio

    from .api.app import build_app

    cfg, bundle, engine, batcher = build_service(parse_args(argv))
    app = build_app(cfg, bundle, engine, batcher)
    logging.getLogger("serve").info(
        "serving %s on %s:%d (device=%s, max_batch=%d)",
        bundle.name, cfg.host, cfg.port, cfg.device, cfg.max_batch,
    )
    if cfg.journal_dir:
        # The startup replay (api/app.py) readmits every incomplete
        # journaled stream once the model is ready.
        logging.getLogger("serve").info(
            "durability: write-ahead journal at %s (fsync=%s, disk KV tier=%s)",
            cfg.journal_dir, cfg.journal_fsync,
            f"{cfg.kv_disk_budget_mb:g}MB" if cfg.kv_disk_budget_mb else "off",
        )
    if cfg.jobs_enabled:
        logging.getLogger("serve").info(
            "bulk jobs: /v1/batches enabled (store=%s/jobs, max_concurrent_lines=%d, "
            "result_ttl=%gs)",
            cfg.journal_dir, cfg.job_max_concurrent_lines, cfg.job_result_ttl_s,
        )
    asyncio.run(_serve_until_signalled(app, cfg, cfg.drain_grace_s))


if __name__ == "__main__":
    main(sys.argv[1:])
