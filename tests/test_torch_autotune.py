"""The decode-kernel autotuner of the port (``ops/autotune.py``, K3's split
plan) against the JAX package's ``ops/autotune.py`` and paged kernel, f32 on
the CPU:

- ``tune_key`` is the reference's string for the same shapes, and the
  paged loop asks for the key the JAX loop's ``_autotune_kernel`` builds;
- the variant space: ``split_plan``'s split count first, then every other
  split count a plan over the table can have; the ``s<N>`` grammar, a
  Pallas key refused with a message naming it, a split count the table
  cannot hold refused at the pin;
- every candidate split's plain form (``paged_attention_split_ref``, the
  kernel's per-split (o, m, l) and combine) equals JAX's
  ``paged_decode_attention`` in interpret mode within 2e-5, dense and
  int8, a row with no valid key among them;
- a sweep verifies every candidate before timing it (a wrong or failing
  candidate is counted and never timed), installs the fastest, persists the
  table atomically in the reference's format; a second resolution hits it;
  a corrupt file or a junk entry is survived and counted; the counters have
  the reference's names;
- K3's plan takes the tuned split for its key, a plan cached before a pin
  is not reused after it, and one built again after the cache was cleared
  reads the table again.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
import jax.numpy as jnp

from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.ops import autotune as jax_autotune
from mlmicroservicetemplate_tpu.ops import paged_attention as jax_pa
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.ops import autotune
from mlmicroservicetemplate_tpu_torch.ops import paged_attention as port_pa
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils.config import load_config


@pytest.fixture(autouse=True)
def _fresh_table():
    autotune.clear()
    yield
    autotune.clear()


KEYS = [dict(b=8, kvh=4, n_rep=8, d=64, block_size=16, t=32, dtype="bfloat16", quant=False),
        dict(b=1, kvh=12, n_rep=1, d=64, block_size=8, t=5, dtype="float32", quant=True),
        dict(b=4, kvh=2, n_rep=2, d=64, block_size=128, t=3, dtype="float32", quant=False,
             tp=2)]


@pytest.mark.parametrize("shape", KEYS)
def test_tune_key_is_the_references(shape):
    assert autotune.tune_key("paged_decode", **shape) == jax_autotune.tune_key(
        "paged_decode", **shape)


@pytest.mark.parametrize("t,bs,b,kvh", [(32, 16, 8, 4), (30, 8, 4, 2), (3, 128, 4, 2),
                                        (130, 16, 2, 2), (1, 16, 1, 1)])
def test_variants_are_split_plans_default_first(t, bs, b, kvh):
    cands = autotune.enumerate_variants(b=b, kvh=kvh, t=t, bs=bs)
    assert cands[0] == port_pa.split_plan(b, kvh, t * bs, port_pa.block_unit_tiles(bs))[0]
    assert sorted(cands) == port_pa.feasible_splits(t, bs) and len(set(cands)) == len(cands)
    n_tiles = -(-t * bs // 64)
    for n in cands:
        splits, tiles = port_pa.split_count(b, kvh, t, bs, n)
        # whole units, at most MAX_SPLIT_TILES, every split holds a key,
        # the splits cover every key
        assert splits == n and tiles % port_pa.block_unit_tiles(bs) == 0
        assert tiles <= port_pa.MAX_SPLIT_TILES
        assert (splits - 1) * tiles < n_tiles <= splits * tiles


def test_the_variant_grammar():
    assert autotune.parse_variant("") == autotune.parse_variant(None) == 0
    assert autotune.parse_variant("s4") == 4 and autotune.variant_key(4) == "s4"
    for bad in ("b4-hb", "head_batched", "s0", "s", "4", "s2-hb"):
        with pytest.raises(ValueError, match=r"s<N>"):
            autotune.parse_variant(bad)
    # Parsed when the configuration loads: a typo fails before readiness.
    assert load_config({"DEVICE": "cpu", "PALLAS_VARIANT": "s3"}).pallas_variant == "s3"
    with pytest.raises(ValueError, match="Pallas kernel's keys such as 'b4-hb'"):
        load_config({"DEVICE": "cpu", "PALLAS_VARIANT": "b4-hb"})


def _jax_args(args):
    return [None if a is None else jnp.asarray(a.numpy()) for a in args]


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("bs,t", [(8, 30), (16, 9), (128, 3)])
def test_every_candidate_split_matches_the_jax_kernel(bs, t, quant):
    shape = dict(b=4, kvh=2, n_rep=2, d=64, bs=bs, t=t, dtype="float32", quant=quant)
    args, ref = autotune._probe(**shape, device="cpu", seed=3)
    q, kp, vp, table, valid, ks, vs = _jax_args(args)
    want = np.asarray(jax_pa.paged_decode_attention(q, kp, vp, table, valid, bs,
                                                    k_scale=ks, v_scale=vs, interpret=True))
    assert not args[4][1].any()  # the probe's row with no valid key
    for n in autotune.enumerate_variants(b=4, kvh=2, t=t, bs=bs):
        splits, tiles = port_pa.split_count(4, 2, t, bs, n)
        got = port_pa.paged_attention_split_ref(*args[:5], bs, splits, tiles,
                                                k_scale=args[5], v_scale=args[6]).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"s{n}")
    np.testing.assert_allclose(ref.numpy(), want, atol=2e-5, rtol=2e-5)


SHAPE = dict(b=4, kvh=2, n_rep=2, d=64, block_size=8, t=30, dtype="float32", quant=False)


def _launch(wrong=(), broken=()):
    """The CPU stand-in for the kernel at a split count: its plain split
    form, wrong (a shifted output) or raising for the given counts."""
    calls = []

    def launch(n, q, kp, vp, table, valid, ks, vs):
        calls.append(n)
        if n in broken:
            raise RuntimeError(f"launch of s{n} failed")
        splits, tiles = port_pa.split_count(q.shape[0], kp.shape[2], table.shape[1], 8, n)
        out = port_pa.paged_attention_split_ref(q, kp, vp, table, valid, 8, splits, tiles,
                                                k_scale=ks, v_scale=vs)
        return out + 1.0 if n in wrong else out

    return launch, calls


def _timer(per_split: dict):
    timed = []

    def timer(fn, args, iters, reps):
        n = fn.__kwdefaults__["n"]
        timed.append((n, iters, reps))
        return per_split[n]

    return timer, timed


def test_a_sweep_verifies_times_installs_and_persists(tmp_path):
    path = str(tmp_path / "tune" / "pallas_tune.json")
    cands = autotune.enumerate_variants(b=4, kvh=2, t=30, bs=8)
    assert cands == [4, 1, 2]  # split_plan's own choice first
    launch, calls = _launch(wrong={1})
    timer, timed = _timer({4: 3e-6, 2: 2e-6})
    got = autotune.ensure_tuned("paged_decode", **SHAPE, launch=launch, timer=timer,
                                table_path=path, iters=7)
    assert got == "s2"
    assert calls == [4, 1, 2] and timed == [(4, 7, autotune.SWEEP_REPS), (2, 7, autotune.SWEEP_REPS)]
    stats = autotune.stats()
    assert set(stats["counts"]) == set(jax_autotune.stats()["counts"])
    assert stats["counts"] == dict.fromkeys(stats["counts"], 0) | {
        "sweeps": 1, "candidates": 3, "timed": 2, "installs": 1, "reject_verify": 1}
    key = autotune.tune_key("paged_decode", **SHAPE)
    assert stats["table"] == {key: "s2"}
    assert stats["sweeps"][key] == {"winner": "s2", "default": "s4", "candidates": 3,
                                    "timed": 2, "per_call_us": {"s2": 2.0, "s4": 3.0}}
    assert autotune.lookup("paged_decode", **SHAPE) == "s2"
    with open(path) as f:
        assert json.load(f) == {"version": 1, "table": {key: "s2"}}
    assert os.listdir(os.path.dirname(path)) == ["pallas_tune.json"]  # no tmp left
    # A new process on the same table: a hit, no sweep, nothing launched.
    autotune.clear()
    launch, calls = _launch()
    assert autotune.ensure_tuned("paged_decode", **SHAPE, launch=launch, table_path=path) == "s2"
    assert calls == [] and autotune.stats()["counts"]["hits"] == 1
    assert autotune.stats()["counts"]["sweeps"] == 0


def test_a_failing_candidate_is_counted_and_never_timed():
    launch, calls = _launch(broken={4})
    timer, timed = _timer({1: 5e-6, 2: 4e-6})
    assert autotune.ensure_tuned("paged_decode", **SHAPE, launch=launch, timer=timer,
                                 table_path=None) == "s2"
    assert [n for n, *_ in timed] == [1, 2]
    counts = autotune.stats()["counts"]
    assert counts["reject_error"] == 1 and counts["timed"] == 2 and counts["reject_vmem"] == 0


@pytest.mark.parametrize("junk", ["{not json", '{"version": 1, "table": ["s2"]}',
                                  '{"version": 1, "table": {"k": "b4-hb"}}'])
def test_a_corrupt_table_is_survived_and_counted(tmp_path, junk):
    path = tmp_path / "pallas_tune.json"
    path.write_text(junk)
    launch, _ = _launch()
    timer, _ = _timer({4: 3e-6, 1: 1e-6, 2: 2e-6})
    assert autotune.ensure_tuned("paged_decode", **SHAPE, launch=launch, timer=timer,
                                 table_path=str(path)) == "s1"
    counts = autotune.stats()["counts"]
    assert counts["persist_errors"] == 1 and counts["sweeps"] == 1
    assert json.loads(path.read_text())["table"] == {
        autotune.tune_key("paged_decode", **SHAPE): "s1"}


def test_an_entry_no_plan_can_have_is_swept_again(tmp_path):
    key = autotune.tune_key("paged_decode", **SHAPE)
    path = tmp_path / "pallas_tune.json"
    path.write_text(json.dumps({"version": 1, "table": {key: "s3"}}))
    launch, _ = _launch()
    timer, _ = _timer({4: 3e-6, 1: 1e-6, 2: 2e-6})
    assert autotune.ensure_tuned("paged_decode", **SHAPE, launch=launch, timer=timer,
                                 table_path=str(path)) == "s1"
    counts = autotune.stats()["counts"]
    assert counts["persist_errors"] == 1 and counts["hits"] == 0 and counts["sweeps"] == 1


def test_a_pin_is_validated_and_skips_the_sweep():
    launch, calls = _launch()
    assert autotune.ensure_tuned("paged_decode", **SHAPE, pin="s1", launch=launch,
                                 table_path=None) == "s1"
    assert calls == [] and autotune.stats()["counts"]["pins"] == 1
    assert autotune.stats()["counts"]["installs"] == 1
    with pytest.raises(ValueError, match=r"PALLAS_VARIANT='s3': 3 splits do not fit"):
        autotune.ensure_tuned("paged_decode", **SHAPE, pin="s3", table_path=None)
    with pytest.raises(ValueError, match=r"s<N>"):
        autotune.ensure_tuned("paged_decode", **SHAPE, pin="b2-hb", table_path=None)


def test_the_plan_takes_the_tuned_split_and_never_a_stale_one(monkeypatch):
    """K3's plan (built on the CPU, never launched there): the heuristic's
    split count without an entry; the pinned one after a pin, although a
    plan for the same signature was cached before it; the pinned one again
    when the cache was cleared (``_PLAN_CACHE_MAX``)."""
    monkeypatch.setattr(port_pa, "_paged_plans", {})
    shape = dict(b=4, kvh=4, n_rep=8, d=64, block_size=16, t=32, dtype="float32", quant=False)
    args, _ = autotune._probe(b=4, kvh=4, n_rep=8, d=64, bs=16, t=32, dtype="float32",
                              quant=False, device="cpu")
    default = port_pa._paged_plan(*args[:5], 16)
    assert (default.splits, default.split_tiles) == port_pa.split_plan(4, 4, 512, 1) == (8, 1)
    assert port_pa._paged_plan(*args[:5], 16) is default
    autotune.ensure_tuned("paged_decode", **shape, pin="s2", table_path=None)
    tuned = port_pa._paged_plan(*args[:5], 16)
    assert (tuned.splits, tuned.split_tiles) == (2, 4)
    port_pa._paged_plans.clear()
    again = port_pa._paged_plan(*args[:5], 16)
    assert (again.splits, again.split_tiles) == (2, 4)
    # A forced split count (the sweep's candidates) is its own plan.
    assert port_pa._paged_plan(*args[:5], 16, splits=4).splits == 4
    # Another shape (another key) keeps the heuristic.
    other, _ = autotune._probe(b=2, kvh=4, n_rep=8, d=64, bs=16, t=32, dtype="float32",
                               quant=False, device="cpu")
    assert port_pa._paged_plan(*other[:5], 16).splits == port_pa.split_plan(2, 4, 512, 1)[0]


LLAMA = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_the_loop_tunes_the_key_the_jax_loop_tunes(monkeypatch, quant):
    """``_autotune_kernel`` of the paged loop asks for the JAX loop's key
    (slots, KV heads, group, head dim, block size, table width, dtype,
    int8) and is a no-op off the card, for the contiguous loop and with
    neither knob set."""
    env = {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0",
           "LLAMA_CONFIG": json.dumps(LLAMA), "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "24",
           "MAX_STREAMS": "3", "PAGED_KV": "1", "KV_BLOCK_SIZE": "8", "PALLAS_AUTOTUNE": "1",
           "PALLAS_AUTOTUNE_ITERS": "9", **({"QUANT_KV": "int8"} if quant else {})}
    _, bundle, engine, batcher = build_service(env)
    loop = batcher._cdl
    seen = []
    monkeypatch.setattr(autotune, "ensure_tuned",
                        lambda kind, **kw: seen.append((kind, kw)) or "s2")
    loop._autotune_kernel()
    assert seen == [] and loop.kernel_variant == ""  # the CPU: no kernel to tune
    monkeypatch.setattr(engine, "device", torch.device("cuda"))
    loop._autotune_kernel()
    ((kind, kw),) = seen
    assert loop.kernel_variant == "s2" and kw["iters"] == 9 and kw["pin"] is None
    monkeypatch.setenv("LLAMA_CONFIG", json.dumps(LLAMA))
    jcfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False, paged_kv=True,
                            kv_block_size=8, seq_buckets=(16, 32), max_decode_len=24,
                            max_streams=3, quant_kv="int8" if quant else None)
    jloop = JaxLoop(JaxEngine(jax_build_model(jcfg), jcfg, ReplicaSet(make_mesh(1))), jcfg)
    jb = jloop.engine.bundle.cfg
    want = jax_autotune.tune_key(
        "paged_decode", b=jloop.n_slots, kvh=jb.num_kv_heads, n_rep=jb.num_heads // jb.num_kv_heads,
        d=jb.head_dim, block_size=jloop.block_size, t=jloop.nb_max, dtype="float32",
        quant=bool(jb.kv_quant))
    kw = {k: v for k, v in kw.items() if k in ("b", "kvh", "n_rep", "d", "block_size", "t",
                                               "dtype", "quant")}
    assert autotune.tune_key(kind, **kw) == want
