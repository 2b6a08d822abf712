"""The port's config, device layer, tokenizers and bucketing against the
JAX package's, on the same inputs."""

import asyncio
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

from mlmicroservicetemplate_tpu.engine.engine import bucket_for as jax_bucket_for
from mlmicroservicetemplate_tpu.models import tokenizer as jax_tok
from mlmicroservicetemplate_tpu.utils.config import load_config as jax_load_config
from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine, bucket_for
from mlmicroservicetemplate_tpu_torch.models import tokenizer as port_tok
from mlmicroservicetemplate_tpu_torch.runtime.device import default_policy, get_device
from mlmicroservicetemplate_tpu_torch.utils.config import ServiceConfig, load_config

ENV = {
    "MODEL_NAME": "bert-base", "PORT": "8123", "MAX_BATCH": "16",
    "BATCH_TIMEOUT_MS": "2.5", "MAX_QUEUE": "77", "BATCH_BUCKETS": "1,4,16",
    "SEQ_BUCKETS": "32,128", "WARMUP": "0", "LOG_LEVEL": "debug",
    "TOKENIZER_PATH": "/vocab.txt", "HOST": "127.0.0.1",
}


def test_load_config_reads_the_jax_package_env_names():
    port = load_config({**ENV, "DEVICE": "cpu"})
    ref = jax_load_config({**ENV, "DEVICE": "cpu"})
    for field in ("device", "model_name", "port", "max_batch", "batch_timeout_ms",
                  "max_queue", "batch_buckets", "seq_buckets", "warmup", "log_level",
                  "tokenizer_path", "host"):
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("quant", ["int8", "none", "INT8"])
def test_generation_knobs_read_the_jax_package_env_names(quant):
    env = {"DEVICE": "cpu", "MAX_DECODE_LEN": "37", "STREAM_CHUNK_TOKENS": "8",
           "QUANT_KV": quant}
    port, ref = load_config(env), jax_load_config(env)
    for field in ("max_decode_len", "quant_kv"):
        assert getattr(port, field) == getattr(ref, field), field
    # The JAX ServiceConfig field has no env reader; the port reads it
    # under the name of the field's validator message.
    assert port.stream_chunk_tokens == 8 and ref.stream_chunk_tokens == 4
    assert load_config({"DEVICE": "cpu", "LLAMA_CONFIG": '{"num_layers": 2}'}).llama_config
    with pytest.raises(ValueError):
        load_config({"DEVICE": "cpu", "QUANT_KV": "int4"})


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.delenv("DEVICE", raising=False)
    assert load_config({}).device == "cuda"
    assert ServiceConfig().device == "cuda"


def test_model_name_defaults_to_resnet50_as_in_jax(monkeypatch):
    monkeypatch.delenv("MODEL_NAME", raising=False)
    assert load_config({"DEVICE": "cpu"}).model_name == "resnet50"
    assert jax_load_config({"DEVICE": "cpu"}).model_name == "resnet50"
    assert ServiceConfig().model_name == "resnet50"


def test_registration_knobs_read_the_jax_package_env_names():
    env = {"DEVICE": "cpu", "SERVER_URL": "http://parent:9000", "REGISTER_HEARTBEAT_S": "2.5"}
    port, ref = load_config(env), jax_load_config(env)
    for field in ("server_url", "register_heartbeat_s", "register_retry_s",
                  "register_max_tries"):
        assert getattr(port, field) == getattr(ref, field), field
    assert load_config({"DEVICE": "cpu"}).server_url is None
    for bad in ({"register_heartbeat_s": -1.0}, {"register_retry_s": -1.0},
                {"register_max_tries": 0}):
        with pytest.raises(ValueError):
            ServiceConfig(device="cpu", **bad)
    with pytest.raises(ValueError):
        load_config({"DEVICE": "cpu", "REGISTER_HEARTBEAT_S": "-1"})


@pytest.mark.parametrize(
    "overrides",
    [
        {"DEVICE": "tpu"},
        {"SEQ_BUCKETS": "64,32"},
        {"BATCH_BUCKETS": "0,1"},
        {"MAX_BATCH": "0"},
        {"LOG_LEVEL": "loud"},
        {"BATCH_TIMEOUT_MS": "-1"},
    ],
)
def test_load_config_rejects_bad_values(overrides):
    with pytest.raises(ValueError):
        load_config({"DEVICE": "cpu", **overrides})


def test_device_layer():
    assert get_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert default_policy("cuda").param_dtype == torch.bfloat16
    assert default_policy("cuda").output_dtype == torch.float32
    assert default_policy("cpu").compute_dtype == torch.float32
    with pytest.raises(ValueError):
        get_device("tpu")


@pytest.mark.parametrize("n", [1, 3, 8, 9, 31, 32, 33, 500])
def test_bucket_for_matches_jax(n):
    buckets = (1, 2, 4, 8, 16, 32)
    assert bucket_for(n, buckets) == jax_bucket_for(n, buckets)


def test_engine_rejects_seq_buckets_past_the_positions():
    bundle = type("B", (), {"device": torch.device("cpu"),
                            "cfg": type("C", (), {"max_position": 512})()})()
    cfg = ServiceConfig(device="cpu", seq_buckets=(128, 1024))
    with pytest.raises(ValueError, match="positions"):
        InferenceEngine(bundle, cfg)


TEXTS = ["Hello, world!", "naïve café — déjà vu", "x" * 600, "", "Don't stop; 3.14"]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches_jax(text):
    for max_len in (16, 512):
        got = port_tok.build_tokenizer(None).encode(text, max_len)
        want = jax_tok.build_tokenizer(None, for_t5=False).encode(text, max_len)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("text", TEXTS)
def test_wordpiece_matches_jax(tmp_path, text):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", ",", "world", "!", "na",
             "##ive", "cafe", "don", "'", "t", "stop", ";", "3", ".", "14", "x", "##x"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    port = port_tok.build_tokenizer(str(path))
    ref = jax_tok.build_tokenizer(str(path), for_t5=False)
    for max_len in (8, 64):
        got, want = port.encode(text, max_len), ref.encode(text, max_len)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert port.decode(got[0]) == ref.decode(want[0])


def test_unported_tokenizer_formats_raise(tmp_path):
    """SentencePiece files, once refused, load as the JAX factory loads
    them: the same ids and masks, with and without the trailing EOS."""
    from mlmicroservicetemplate_tpu.models.sentencepiece import write_spiece_model
    from test_sentencepiece import _pieces

    path = str(tmp_path / "spiece.model")
    write_spiece_model(path, _pieces())
    for for_t5 in (True, False):
        port = port_tok.build_tokenizer(path, for_t5=for_t5)
        ref = jax_tok.build_tokenizer(path, for_t5=for_t5)
        for text in TEXTS:
            got, want = port.encode(text, 32), ref.encode(text, 32)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert port.decode(got[0]) == ref.decode(want[0])


@pytest.mark.parametrize("buckets,paged", [("24,48", "1"), ("16,24,32", "1"), ("24,48", "0")])
def test_loop_knobs_and_paged_bucket_alignment_match_jax(buckets, paged):
    """MAX_STREAMS, PAGED_KV and KV_BLOCK_SIZE read as in the JAX package;
    under PAGED_KV the seq buckets round up to the block grid, deduped."""
    env = {"DEVICE": "cpu", "SEQ_BUCKETS": buckets, "PAGED_KV": paged, "MAX_STREAMS": "5",
           "KV_BLOCK_SIZE": "16"}
    port, ref = load_config(env), jax_load_config(env)
    for field in ("seq_buckets", "paged_kv", "kv_block_size", "max_streams"):
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("value,ok", [("2", False), ("8", False), ("1", True), ("0", True)])
def test_replicas_raises_unless_off(value, ok):
    """The port serves on one device: REPLICAS past 1 (data-parallel
    replicas) raises instead of being silently ignored."""
    env = {"DEVICE": "cpu", "REPLICAS": value}
    if ok:
        assert load_config(env).device == "cpu"
    else:
        with pytest.raises(ValueError, match="REPLICAS: not ported"):
            load_config(env)


@pytest.mark.parametrize("sp", ["0", "4", "8"])
def test_sp_reads_the_jax_package_env_name(sp):
    env = {"DEVICE": "cpu", "SP": sp}
    assert load_config(env).sp == jax_load_config(env).sp == int(sp)


def test_negative_sp_is_rejected():
    with pytest.raises(ValueError, match="SP"):
        load_config({"DEVICE": "cpu", "SP": "-1"})


@pytest.mark.parametrize("n", [1, 7, 8, 17, 33, 64, 65, 200])
@pytest.mark.parametrize("multiple", [1, 2, 8])
def test_bucket_for_with_a_multiple_matches_jax(n, multiple):
    for buckets in ((32, 64), (32, 36), (16, 24, 40)):
        assert bucket_for(n, buckets, multiple) == jax_bucket_for(n, buckets, multiple)


# ---------------------------------------------------------------------------
# Every knob the JAX load_config recognizes is read, refused or inert

def _jax_knob_names() -> list[str]:
    """The names of the JAX load_config's docstring list, every name its
    body reads, and every name any module of the JAX package reads from
    the environment: a string literal within two lines of ``environ`` or
    ``getenv`` in its sources."""
    import inspect
    import pathlib
    import re

    import mlmicroservicetemplate_tpu

    doc = jax_load_config.__doc__
    listed = re.findall(r"\b[A-Z][A-Z0-9_]{2,}\b", doc[doc.index("Recognized"):])
    read = re.findall(r'"([A-Z][A-Z0-9_]{2,})"', inspect.getsource(jax_load_config))
    anywhere = set()
    for path in pathlib.Path(mlmicroservicetemplate_tpu.__file__).parent.rglob("*.py"):
        lines = path.read_text(encoding="utf-8").splitlines()
        for i, line in enumerate(lines):
            if "environ" in line or "getenv" in line:
                for near in lines[max(0, i - 2): i + 3]:
                    anywhere.update(re.findall(r'"([A-Z][A-Z0-9_]{2,})"', near))
    return sorted(set(listed) | set(read) | anywhere)


# A value that asks for something other than what the port does when the
# name is unset.  For SUPERVISE, PERF_OBS and HOST_PREP_DOUBLE, whose JAX
# default is on and which the port does not do, that is "1"; for PREEMPT,
# which the port reads with the JAX default (on), "0".
NON_DEFAULT = {
    "DEVICE": "cuda", "MODEL_NAME": "llama", "MODEL_PATH": "/w.npz",
    "TOKENIZER_PATH": "/vocab.txt", "HOST": "127.0.0.1", "PORT": "8123",
    "MAX_BATCH": "7", "BATCH_TIMEOUT_MS": "9", "MAX_QUEUE": "5", "REPLICAS": "2",
    "SP": "2", "TP": "2", "MAX_DECODE_LEN": "12", "SERVER_URL": "http://127.0.0.1:9",
    "WARMUP": "0", "LOG_LEVEL": "debug", "PIPELINE_DEPTH": "8", "MAX_STREAMS": "3",
    "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,48", "QUANTIZE": "int8",
    "QUANT_KV": "int8", "REGISTER_HEARTBEAT_S": "5", "CONTINUOUS_BATCHING": "0",
    "PROMPT_PREFIX": "You are", "SPEC_DECODE": "ngram", "SPEC_K": "4", "SPEC_NGRAM": "3",
    "SPEC_MAX_STREAMS": "2", "SPEC_SAMPLED": "0", "SPEC_CONTINUOUS": "1",
    "PREFIX_CACHE": "1", "PREFIX_CACHE_MB": "64", "PRIORITY_DEFAULT": "batch",
    "DEADLINE_MS": "250", "CLASS_WEIGHT": "2", "KV_BUDGET_MB": "64",
    "MAX_STREAM_QUEUE": "4", "PREEMPT": "0", "DRAIN_GRACE_S": "5", "PAGED_KV": "1",
    "KV_BLOCK_SIZE": "32", "KV_HOST_BUDGET_MB": "128", "KV_DISK_BUDGET_MB": "128",
    "JOURNAL_DIR": "/journal", "JOURNAL_FSYNC": "never", "KV_PREFETCH_BLOCKS": "2",
    "JOBS_ENABLED": "1", "JOB_MAX_CONCURRENT_LINES": "2", "JOB_RESULT_TTL_S": "60",
    "TENANTS": "a:1", "TENANTS_FILE": "/tenants.json", "TENANT_DEFAULT_WEIGHT": "2",
    "TENANT_WINDOW_S": "30", "TENANT_METRICS_TOPK": "4", "ADAPTER_DIR": "/adapters",
    "ADAPTER_SLOTS": "4", "PREFILL_CHUNK": "64", "PREFILL_BUDGET": "128",
    "PREFILL_MAX_PROMPT": "256", "DECODE_WINDOW": "4", "DECODE_WINDOW_AUTO": "0",
    "STREAM_PIPELINE": "2", "FAULT_SPEC": "dispatch:error:0.1", "FAULT_SEED": "7",
    "DISPATCH_TIMEOUT_S": "5", "DISPATCH_RETRIES": "0", "DISPATCH_BACKOFF_S": "0.5",
    "ENGINE_RESTARTS_MAX": "1", "ENGINE_RESTART_WINDOW_S": "60", "SUPERVISE": "1",
    "FLEET_REPLICAS": "2", "FLEET_ROUTE": "round_robin", "FLEET_BREAKER_N": "5",
    "FLEET_EVICT_S": "20", "FLEET_TP_GROUPS": "2", "FLEET_MIN_REPLICAS": "1",
    "FLEET_MAX_REPLICAS": "4", "SCALE_UP_QUEUE": "4", "SCALE_UP_KV_FRAC": "0.5",
    "SCALE_UP_TTFT_MS": "200", "SCALE_UP_COOLDOWN_S": "1", "SCALE_DOWN_LOAD": "0.1",
    "SCALE_DOWN_COOLDOWN_S": "5", "SCALE_PERIOD_S": "1", "TRACE": "1", "TRACE_RING": "64",
    "FLIGHT_RING": "32", "PROFILE_DIR": "/profiles", "LOG_FORMAT": "json",
    "COMPILE_CACHE_DIR": "/cache", "HOST_PREP_DOUBLE": "1", "PERF_OBS": "1",
    "PEAK_TFLOPS": "989", "LATENCY_BUCKETS": "0.1,1", "SLO_TTFT_MS": "500",
    "SLO_TBT_MS": "50", "SLO_BATCH_TTFT_MS": "5000", "SLO_BATCH_TBT_MS": "500",
    "SLO_TARGET": "0.9", "SLO_WINDOWS_S": "30,300", "SCALE_UP_SLO_BURN": "2",
    "PALLAS_AUTOTUNE": "1", "PALLAS_VARIANT": "head_batched", "PALLAS_INTERPRET": "1",
    "PALLAS_SINGLE_BLOCK_MAX_SEQ": "256", "DECODE_KERNEL_VMEM_BUDGET_MB": "20",
    # Read outside load_config by the JAX package.
    "ADMIT_GRACE_MS": "20", "ADMIT_OVERLAP": "0", "CHAT_TEMPLATE": "chatml",
    "JAX_PLATFORMS": "tpu", "JAX_TRACE_DIR": "/traces", "LLAMA_CONFIG": '{"num_layers": 2}',
    "LOCKTRACE": "1", "PALLAS_AUTOTUNE_ITERS": "5", "PALLAS_TUNE_TABLE": "/tune.json",
    "USE_PALLAS_ATTENTION": "0", "USE_PALLAS_DECODE": "1", "WARMUP_SAMPLING": "0",
}


@pytest.mark.parametrize("name", _jax_knob_names())
def test_every_jax_knob_is_read_refused_or_inert(name, monkeypatch):
    """Each name the JAX package recognizes, set to a non-default value: the
    port reads it (a ServiceConfig field changes), raises "not ported", or
    lists it as inert with a reason.  A name the port has not classified
    fails here."""
    from mlmicroservicetemplate_tpu_torch.utils import config as port_config

    assert name in NON_DEFAULT, f"{name}: a JAX knob this test gives no value"
    for var in NON_DEFAULT:  # the process environment (e.g. WARMUP=0) stays out
        monkeypatch.delenv(var, raising=False)
    base_env = {"DEVICE": "cpu"}
    env = {**base_env, name: NON_DEFAULT[name]}
    if name in port_config.UNPORTED_KNOBS:
        assert name not in port_config.INERT_KNOBS
        with pytest.raises(ValueError, match=f"{name}.*not ported"):
            load_config(env)
        return
    got = dataclasses.asdict(load_config(env))
    base = dataclasses.asdict(load_config(base_env))
    if name in port_config.INERT_KNOBS:
        assert port_config.INERT_KNOBS[name].strip()
        assert got == base
    else:
        assert got != base, f"{name}: neither read, refused nor listed as inert"


@pytest.mark.parametrize("name", ["PREEMPT", "SUPERVISE", "PERF_OBS", "HOST_PREP_DOUBLE"])
def test_knobs_the_port_leaves_off_accept_off(name):
    """The JAX default of these is on.  The port does all but PREEMPT
    without, so it takes their off value and refuses the on one; PREEMPT
    it reads, on unless set off, as the JAX package does."""
    assert load_config({"DEVICE": "cpu", name: "0"}).device == "cpu"
    if name == "PREEMPT":
        assert load_config({"DEVICE": "cpu"}).preempt is True
        assert load_config({"DEVICE": "cpu", name: "0"}).preempt is False
        assert load_config({"DEVICE": "cpu", name: "true"}).preempt is True
        return
    with pytest.raises(ValueError, match="not ported"):
        load_config({"DEVICE": "cpu", name: "true"})


def test_numeric_off_values_compare_as_numbers():
    assert load_config({"DEVICE": "cpu", "KV_BUDGET_MB": "0.0", "SCALE_UP_QUEUE": "2.0",
                        "FLEET_EVICT_S": "10"}).device == "cpu"
    with pytest.raises(ValueError, match="SCALE_UP_KV_FRAC"):
        load_config({"DEVICE": "cpu", "SCALE_UP_KV_FRAC": "0.86"})


def test_read_knobs_reach_the_service():
    """PIPELINE_DEPTH sizes the batcher's dispatch slots, DEADLINE_MS is
    its default deadline, TRACE_RING the tracer's ring, DRAIN_GRACE_S the
    drain's wait; the defaults stay the port's (2, none, 4096, 30 s)."""
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher

    engine = types.SimpleNamespace(bundle=types.SimpleNamespace(name="fake"))
    cfg = load_config({"DEVICE": "cpu", "PIPELINE_DEPTH": "5", "DEADLINE_MS": "40",
                       "DRAIN_GRACE_S": "2.5", "TRACE_RING": "64"})
    batcher = Batcher(engine, cfg)
    assert (batcher.pipeline_depth, batcher.default_deadline_ms) == (5, 40.0)
    assert cfg.drain_grace_s == 2.5 and cfg.trace_ring == 64
    default = load_config({"DEVICE": "cpu"})
    assert (default.pipeline_depth, default.deadline_ms, default.drain_grace_s,
            default.trace_ring) == (2, 0.0, 30.0, 4096)
    assert Batcher(engine, default).pipeline_depth == 2
    for bad in ({"PIPELINE_DEPTH": "0"}, {"DEADLINE_MS": "-1"}, {"DRAIN_GRACE_S": "nan"}):
        with pytest.raises(ValueError):
            load_config({"DEVICE": "cpu", **bad})


class _HeldEngine:
    """Answers each item with its id once ``release`` is set."""

    def __init__(self):
        self.bundle = types.SimpleNamespace(name="fake")
        self.release = threading.Event()

    def run_batch(self, feats):
        self.release.wait(5.0)
        return [np.array([f["id"]], np.float32) for f in feats]


def test_deadline_ms_is_the_deadline_of_a_request_without_one():
    """With DEADLINE_MS=60, an item queued behind a held dispatch and
    bringing no deadline of its own is shed (504) after ~60 ms; one that
    brings its own longer deadline waits and is served."""
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import (
        Batcher,
        DeadlineExceededError,
    )

    cfg = load_config({"DEVICE": "cpu", "DEADLINE_MS": "60", "PIPELINE_DEPTH": "1",
                       "MAX_BATCH": "1", "BATCH_TIMEOUT_MS": "0"})
    engine = _HeldEngine()

    async def main():
        batcher = Batcher(engine, cfg)
        await batcher.start()
        try:
            first = asyncio.ensure_future(batcher.submit({"id": 0}))
            await asyncio.sleep(0.05)  # the first holds the only dispatch slot
            t0 = time.monotonic()
            defaulted = asyncio.ensure_future(batcher.submit({"id": 1}))
            own = asyncio.ensure_future(batcher.submit({"id": 2, "deadline_ms": 5000.0}))
            with pytest.raises(DeadlineExceededError):
                await defaulted
            shed_after = time.monotonic() - t0
            engine.release.set()
            return shed_after, await first, await own
        finally:
            engine.release.set()
            await batcher.stop()

    shed_after, first, own = asyncio.run(main())
    assert 0.05 <= shed_after < 2.0
    assert int(first[0]) == 0 and int(own[0]) == 2


TINY_LLAMA = ('{"vocab_size": 512, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, '
              '"num_layers": 1, "d_ff": 128}')


@pytest.mark.parametrize("priority,status", [(None, 200), ("interactive", 200),
                                             ("Interactive", 200), ("batch", 200),
                                             ("urgent", 400)])
def test_x_priority_header(priority, status):
    """X-Priority interactive, batch (or none) is served, as by the JAX
    app; any other value answers 400 with the JAX package's reason."""
    from aiohttp.test_utils import TestClient, TestServer

    from mlmicroservicetemplate_tpu_torch.api.app import build_app
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(
        {"DEVICE": "cpu", "MODEL_NAME": "llama", "LLAMA_CONFIG": TINY_LLAMA, "WARMUP": "0",
         "MAX_DECODE_LEN": "4", "SEQ_BUCKETS": "32", "BATCH_BUCKETS": "1"})

    async def main():
        client = TestClient(TestServer(build_app(cfg, bundle, engine, batcher)))
        await client.start_server()
        try:
            headers = {} if priority is None else {"X-Priority": priority}
            resp = await client.post("/predict", json={"text": "hi", "max_tokens": 2},
                                     headers=headers)
            return resp.status, resp.reason
        finally:
            await client.close()

    got, reason = asyncio.run(main())
    assert got == status, reason
    if priority == "urgent":
        assert reason == 'X-Priority must be "interactive" or "batch"'


def test_the_knob_list_covers_every_module():
    """The parametrisation above reaches past load_config: the names the
    JAX package reads in its engine, loop, app, registry, kernels and
    device layer are all in it."""
    names = set(_jax_knob_names())
    assert {"CHAT_TEMPLATE", "WARMUP_SAMPLING", "ADMIT_OVERLAP", "LOCKTRACE", "JAX_TRACE_DIR",
            "JAX_PLATFORMS", "USE_PALLAS_ATTENTION", "USE_PALLAS_DECODE",
            "PALLAS_AUTOTUNE_ITERS", "PALLAS_TUNE_TABLE", "ADMIT_GRACE_MS"} <= names


@pytest.mark.parametrize("name,off", [("LOCKTRACE", "0"), ("LOCKTRACE", "false"),
                                      ("ADMIT_OVERLAP", "1"), ("ADMIT_OVERLAP", "yes")])
def test_unported_loop_and_debug_knobs_accept_their_default(name, off):
    assert load_config({"DEVICE": "cpu", name: off}).device == "cpu"


def test_bad_chat_template_fails_at_startup_with_the_jax_reason(monkeypatch):
    """An unknown CHAT_TEMPLATE stops the app from being built, with the JAX
    package's reason; a known one is read (any case) and shown."""
    from mlmicroservicetemplate_tpu.api import build_app as jax_build_app
    from mlmicroservicetemplate_tpu_torch.api.app import build_app
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    monkeypatch.setenv("CHAT_TEMPLATE", "alpaca")
    with pytest.raises(ValueError) as want:
        jax_build_app(None, types.SimpleNamespace(kind="seq2seq", tokenizer=None), None,
                      types.SimpleNamespace(jobs=None))
    monkeypatch.delenv("CHAT_TEMPLATE")
    cfg, bundle, engine, batcher = build_service(
        {"DEVICE": "cpu", "MODEL_NAME": "bert-base", "WARMUP": "0", "CHAT_TEMPLATE": "alpaca"})
    with pytest.raises(ValueError) as got:
        build_app(cfg, bundle, engine, batcher)
    assert str(got.value) == str(want.value)
    ok = load_config({"DEVICE": "cpu", "CHAT_TEMPLATE": "ChatML"})
    assert ok.chat_template == "chatml"


def test_admit_grace_ms_is_the_loops_grace():
    from mlmicroservicetemplate_tpu_torch.engine.streams import ContinuousDecodeLoop

    cfg = load_config({"DEVICE": "cpu", "ADMIT_GRACE_MS": "20"})
    loop = ContinuousDecodeLoop(types.SimpleNamespace(
        bundle=types.SimpleNamespace(name="m"), seq_buckets=(16,), chunk_tokens=4,
        paged_kv=False), cfg)
    assert loop.admit_grace_s == 0.02
    with pytest.raises(ValueError, match="ADMIT_GRACE_MS"):
        load_config({"DEVICE": "cpu", "ADMIT_GRACE_MS": "-1"})
