"""``GET /status`` of the port's app against the JAX app's, f32 on the CPU,
after the same traffic on the same weights, for a classifier (BERT at two
layers), a decoder with the continuous loop (llama, paged,
``DECODE_WINDOW=4``, one batch-class stream) and T5 (its contiguous loop,
one stream), a llama service under ``SPEC_DECODE`` with
``SPEC_CONTINUOUS``, one with ``ADAPTER_DIR`` (two LoRA adapters in two
slots, each installed once) and one with ``TENANTS_FILE`` (two tenants and
an anonymous caller, streamed and whole), whose ``tenancy`` sections are
compared whole.

Compared: the key sets, section by section, and every value that does not
depend on the clock.  Left out, by name:

- sections of features the port does not serve yet: ``fleet``;
- ``durability`` and ``jobs`` (under ``JOURNAL_DIR`` and
  ``JOBS_ENABLED``, each app on its own directory): compared key by key
  with the directory entries set aside;
- keys only the port serves: ``device_name``, ``dispatches``,
  ``decode_steps`` and ``scheduler.pending``;
- values measured by the clock (``uptime_s``, the ``compile`` section's,
  whose keys are the graph cache's on the port and XLA's in JAX, and the
  perf observatory's busy, bubble and overlap seconds);
- ``perf.modeled_flops_total``: the reference's XLA cost analysis counts
  every executable, the port counts CUDA graphs, which the CPU has none of
  (its count is held against a hand count in ``test_torch_perfobs.py``).

``observability`` (the tracer, the flight recorder's ring and dumps) is
compared whole; ``perf``'s keys and its clock-free values too.

``decode`` is compared whole: the pipelining depth (without a warmup
neither loop tunes it), the staged host prep's knob and counts, the
dispatch and fetch boundaries of every site and, under ``PALLAS_AUTOTUNE``,
the kernel variant, the autotuner's counters and its table (on the CPU
neither loop has a kernel to tune).  ``fault_tolerance`` (the supervisor
of the decode loop, on by default as in the JAX package) is compared
whole.  A paged llama service at
``STREAM_PIPELINE=2`` keeps two dispatches in flight."""

import asyncio
import contextlib
import functools
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_lora import write_adapters
from test_torch_t5_serving import LM_HEAD, small_t5

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
from mlmicroservicetemplate_tpu.models import bert as jax_bert
from mlmicroservicetemplate_tpu.ops import autotune as jax_autotune
from mlmicroservicetemplate_tpu.serve import build_service as jax_build_service
from mlmicroservicetemplate_tpu_torch.api.app import build_app
from mlmicroservicetemplate_tpu_torch.models import bert as port_bert
from mlmicroservicetemplate_tpu_torch.ops import autotune as port_autotune
from mlmicroservicetemplate_tpu_torch.serve import build_service

NOT_PORTED = {"fleet"}
# Sections holding the journal directory, which differs between the apps.
WITH_DIRS = {"durability", "jobs"}
PORT_ONLY = {"device_name", "dispatches", "decode_steps"}
MEASURED = {"uptime_s", "compile"}
# The perf section's values the clock or the FLOP mechanism decides.
PERF_MEASURED = {"device_busy_total_s", "device_bubble_s", "busy_ratio", "prep_overlap_s",
                 "modeled_flops_total"}
BERT = dict(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128)
LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
SERVE = {"SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "16", "STREAM_CHUNK_TOKENS": "4",
         "MAX_STREAMS": "4", "BATCH_BUCKETS": "1,4", "BATCH_TIMEOUT_MS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _small(model: str):
    if model == "t5-small":
        with small_t5():
            yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bert, "BertConfig", functools.partial(jax_bert.BertConfig, **BERT))
        mp.setattr(port_bert, "BertConfig", functools.partial(port_bert.BertConfig, **BERT))
        mp.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
        yield


CASES = {
    "bert-base": ({}, [("/predict", {"text": "hello there"}, {})]),
    "llama": ({"PAGED_KV": "1", "KV_BLOCK_SIZE": "8", "DECODE_WINDOW": "4"},
              [("/v1/completions", {"prompt": "hello there", "max_tokens": 16, "stream": True},
                {"X-Priority": "batch"})]),
    "t5-small": ({}, [("/predict", {"text": "summarize: a short text", "max_tokens": 8,
                                    "stream": True}, {})]),
    "llama-pipeline": ({"PAGED_KV": "1", "KV_BLOCK_SIZE": "8", "STREAM_PIPELINE": "2"},
                       [("/v1/completions", {"prompt": "hello there", "max_tokens": 16,
                                             "stream": True}, {})]),
    # A lone stream speculates on the per-stream path, the next two in the
    # speculative loop (SPEC_CONTINUOUS).
    "llama-spec": ({"SPEC_DECODE": "ngram", "SPEC_CONTINUOUS": "1", "SPEC_K": "4"},
                   [("/v1/completions", {"prompt": "hello hello hello", "max_tokens": 16,
                                         "stream": True}, {}),
                    ("/predict", {"text": "abcabcabcabc", "max_tokens": 12}, {})]),
    # K3's autotuner on: its counters and table join /status.decode.
    "llama-autotune": ({"PAGED_KV": "1", "KV_BLOCK_SIZE": "8", "PALLAS_AUTOTUNE": "1"},
                       [("/v1/completions", {"prompt": "hello there", "max_tokens": 16,
                                             "stream": True}, {})]),
    # ADAPTER_DIR (written per test): streams on each adapter and on none.
    "llama-lora": ({"ADAPTER_DIR": None, "ADAPTER_SLOTS": "2"},
                   [("/predict", {"text": "hello there", "max_tokens": 8, "stream": True},
                     {"X-Adapter": "alpha"}),
                    ("/v1/completions", {"prompt": "hello there", "max_tokens": 8,
                                         "stream": True}, {"X-Adapter": "beta"}),
                    ("/predict", {"text": "hello there", "max_tokens": 8, "stream": True},
                     {})]),
    # TENANTS_FILE (written per test): a stream and a whole request of two
    # tenants and an anonymous one.
    "llama-tenants": ({"TENANTS_FILE": None, "PAGED_KV": "1", "KV_BLOCK_SIZE": "8"},
                      [("/predict", {"text": "hello there", "max_tokens": 16, "stream": True},
                        {"X-Api-Key": "key-acme"}),
                       ("/v1/completions", {"prompt": "hello there", "max_tokens": 8},
                        {"X-Api-Key": "bob"}),
                       ("/predict", {"text": "hello", "max_tokens": 4}, {})]),
    # JOURNAL_DIR (one per app) with the disk tier and the job lane: a
    # journaled stream and a journaled unary result.
    "llama-durable": ({"PAGED_KV": "1", "KV_BLOCK_SIZE": "8", "KV_HOST_BUDGET_MB": "1",
                       "KV_DISK_BUDGET_MB": "1", "JOURNAL_DIR": None, "JOBS_ENABLED": "1"},
                      [("/predict", {"text": "hello there", "max_tokens": 16, "stream": True},
                        {"X-Request-Id": "s-1"}),
                       ("/predict", {"text": "hello", "max_tokens": 4},
                        {"X-Request-Id": "u-1"})]),
}


def _no_dirs(section: dict) -> dict:
    """A section with its directory entries (``dir``, at any depth) left out."""
    return {k: _no_dirs(v) if isinstance(v, dict) else v
            for k, v in section.items() if k != "dir"}


async def _status(app, posts) -> dict:
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for _ in range(400):
            if (await client.get("/readyz")).status == 200:
                break
            await asyncio.sleep(0.05)
        for path, body, headers in posts:
            resp = await client.post(path, json=body, headers=headers)
            assert resp.status == 200, await resp.text()
            await resp.read()
        # A stream's body ends before its loop releases it and routes the
        # dispatch still in flight: read /status once that has settled.
        for _ in range(200):
            status = await (await client.get("/status")).json()
            if status["scheduler"]["kv_committed_bytes"] == 0:
                break
            await asyncio.sleep(0.025)
        await asyncio.sleep(0.2)
        return await (await client.get("/status")).json()
    finally:
        await client.close()


def _settle_ready(jloop) -> None:
    """The JAX paged loop routes, at each iteration top, the dispatches XLA
    has finished (``is_ready``): a race with XLA's CPU thread, which at
    ``STREAM_PIPELINE`` > 1 moves the ``fetch`` count.  On the CPU the
    port's copies have always landed; the JAX loop is settled the same way,
    by waiting for its dispatches in flight before that check."""
    check = jloop._deliver_ready

    def ready():
        if jloop.paged and jloop._inflight_chunks:
            jax.block_until_ready([f for f, _, _ in jloop._inflight_chunks])
        check()

    jloop._deliver_ready = ready


def _apps(model: str, extra: dict, port_extra: dict | None = None):
    env = {"DEVICE": "cpu", "MODEL_NAME": model, "WARMUP": "0", **SERVE, **extra}
    with _small(model):
        if model == "llama":
            env["LLAMA_CONFIG"] = json.dumps(LLAMA)
        jcfg, jbundle, jengine, jbatcher, _ = jax_build_service({**env, "REPLICAS": "1"})
        if model == "t5-small":
            jbundle.params["lm_head"] = {"kernel": LM_HEAD}  # a tied random head locks
        if jbatcher._cdl is not None:
            _settle_ready(jbatcher._cdl)
        cfg, bundle, engine, batcher = build_service(
            {**env, **(port_extra or {})}, params=jax.tree.map(np.asarray, jbundle.params))
    return (jax_build_app(jcfg, jbundle, jengine, jbatcher),
            build_app(cfg, bundle, engine, batcher))


@pytest.mark.parametrize("case", list(CASES))
def test_status_has_the_jax_apps_keys_and_values(case, tmp_path):
    model = case.split("-")[0] if case.startswith("llama") else case
    port_autotune.clear()
    jax_autotune.clear()
    extra, posts = CASES[case]
    if "ADAPTER_DIR" in extra:
        extra = {**extra, "ADAPTER_DIR": write_adapters(tmp_path, "llama", LLAMA)}
    if "TENANTS_FILE" in extra:
        path = tmp_path / "tenants.json"
        path.write_text(json.dumps([
            {"name": "acme", "weight": 3, "api_keys": ["key-acme"], "max_concurrency": 2},
            {"name": "bob", "tokens_per_window": 100}]))
        extra = {**extra, "TENANTS_FILE": str(path)}
    port_extra = None
    if "JOURNAL_DIR" in extra:
        extra = {**extra, "JOURNAL_DIR": str(tmp_path / "jax")}
        port_extra = {"JOURNAL_DIR": str(tmp_path / "port")}
    japp, app = _apps(model, extra, port_extra)
    want = asyncio.run(_status(japp, posts))
    got = asyncio.run(_status(app, posts))
    assert set(got) - PORT_ONLY == set(want) - NOT_PORTED
    for key in set(want) - NOT_PORTED - MEASURED - WITH_DIRS - {"scheduler", "decode", "perf"}:
        assert got[key] == want[key], key
    assert (WITH_DIRS <= set(got)) == (WITH_DIRS <= set(want)) == (case == "llama-durable")
    for key in WITH_DIRS & set(want):
        assert _no_dirs(got[key]) == _no_dirs(want[key]), key
    if case == "llama-durable":
        dur = got["durability"]
        assert dur["journal"]["records_written"] > 0 and dur["journal"]["results_kept"] == 1
        assert dur["kv_disk"]["attached"] and dur["reconnect"] == {"streams": 0, "live": 0}
        assert got["jobs"]["replay"] == {"resumed": 0, "complete": 0, "failed": 0}
    sched = dict(got["scheduler"])
    assert sched.pop("pending") == 0
    assert sched == want["scheduler"]
    assert got["observability"]["flight_ring"] == 256 and got["observability"]["flight_dumps"] == 0
    assert got["perf"].keys() == want["perf"].keys()
    for key in set(want["perf"]) - PERF_MEASURED:
        assert got["perf"][key] == want["perf"][key], key
    assert got["perf"]["enabled"] is True and got["perf"]["mfu_estimate"] is None
    assert ("tenancy" in got) == ("tenancy" in want) == (case in ("llama-lora", "llama-tenants"))
    if case == "llama-lora":
        assert got["tenancy"]["adapters"]["installs"] == 2
    if case == "llama-tenants":
        ten = got["tenancy"]
        assert set(ten) == {"tenants", "totals", "fairshare"}
        assert ten["totals"] == {"active": 0, "kv_bytes": 0}
        # The batcher queue's pops: bob's whole request, the anonymous one
        # and the readiness canary's (the stream went through the loop's).
        assert {t: v["served"] for t, v in ten["fairshare"].items()} == {
            "acme": 0, "bob": 1, "": 2}
    assert ("decode" in got) == ("decode" in want) == (model != "bert-base")
    if "decode" not in want:
        return
    dec, jdec = got["decode"], want["decode"]
    assert dec == jdec
    for site in ("chunk", "fetch"):
        assert dec["dispatch_counts"][site] > 0, site
    assert dec["host_prep_double"] is True
    if case == "llama":
        assert dec["window_cap"] == 4 and dec["window_dispatches"] > 0
    if extra.get("PAGED_KV") == "1":
        assert dec["prep_staged"] > 0 and dec["dispatch_counts"]["prep"] == 2 * dec["prep_staged"]
    assert ("autotune" in dec) == (case == "llama-autotune")
    if case == "llama-autotune":
        assert dec["kernel_variant"] == "" and dec["autotune_table"] == {}
    assert got["fault_tolerance"] == {"restarts": 0, "max_restarts": 3, "failed": False}
    if case == "llama-pipeline":
        assert dec["chain_depth"] == 2 and not dec["chain_depth_auto"]
