"""The port's config, device layer, tokenizers and bucketing against the
JAX package's, on the same inputs."""

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


def test_unported_tokenizer_formats_raise():
    with pytest.raises(ValueError, match="not ported"):
        port_tok.build_tokenizer("spiece.model")


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
