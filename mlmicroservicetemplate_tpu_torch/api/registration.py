"""Parent-server registration client (the template's, as in the JAX
package's ``api/registration.py``).

With ``SERVER_URL`` set, the service announces itself on startup: a
retry loop POSTs ``{name, host, port}`` to ``<SERVER_URL>/register`` until
the parent answers 2xx, then, with ``REGISTER_HEARTBEAT_S`` above 0, again
at that period, so a restarted parent learns the service anew.
"""

from __future__ import annotations

import asyncio
import logging

import aiohttp

log = logging.getLogger(__name__)


async def register_with_parent(cfg, model_name: str) -> bool:
    """POST {name, host, port} to ``cfg.server_url`` until acked (2xx)
    or ``register_max_tries`` exhausted.  Returns True on ack."""
    payload = {
        "name": model_name,
        "host": cfg.host if cfg.host not in ("0.0.0.0", "::") else "localhost",
        "port": cfg.port,
    }
    url = cfg.server_url.rstrip("/") + "/register"
    async with aiohttp.ClientSession() as session:
        for attempt in range(1, cfg.register_max_tries + 1):
            try:
                async with session.post(url, json=payload,
                                        timeout=aiohttp.ClientTimeout(total=5)) as resp:
                    if 200 <= resp.status < 300:
                        log.info("registered %s with %s (attempt %d)", model_name, url, attempt)
                        return True
                    log.warning("registration attempt %d: HTTP %d", attempt, resp.status)
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                log.warning("registration attempt %d failed: %s", attempt, e)
            await asyncio.sleep(cfg.register_retry_s)
    log.error("giving up registering with %s after %d tries", url, cfg.register_max_tries)
    return False


async def registration_loop(cfg, model_name: str) -> None:
    """Register, then re-register every ``register_heartbeat_s`` (0 =
    register once)."""
    await register_with_parent(cfg, model_name)
    beat = float(cfg.register_heartbeat_s)
    if beat <= 0:
        return
    while True:
        await asyncio.sleep(beat)
        await register_with_parent(cfg, model_name)
