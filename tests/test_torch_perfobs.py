"""The port's perf observatory (``utils/perfobs.py``), its graph-cost count
(``runtime/compile_cache.py``) and its SLO tracker (``scheduler/policy.py``)
against the JAX package's, f32 on the CPU, at a small llama config.

- The occupancy estimator fed the same submit and complete sequence on an
  injected clock gives the reference's snapshot, exactly (busy, bubble,
  linearity, the synchronous and host sites, the pending bound), and
  merged snapshots the reference's merge.
- ``PERF_OBS=0`` keeps no timestamps; on and off, the loop's dispatch and
  fetch counts per site and its tokens are identical (and the JAX loop's).
- A matmul graph's modeled FLOPs are 2·M·K·N; a small llama decode chunk's
  graph counts exactly the hand count of its linears and LM head (attention,
  the hand-written kernels' work, is counted on neither device), and each
  replay accrues it.  Counts are integers: no tolerance.
- The SLO tracker's burn rates and snapshot equal the reference's; the
  default configuration builds none; the new series sample after a run.
- ``LATENCY_BUCKETS``' validation and the bucket parser agree with the
  reference; the card table gives the H100 peaks, ``PEAK_TFLOPS`` overrides
  it and the CPU has none.
"""

import asyncio
import json
import os
import types

import numpy as np
import pytest
import torch
from test_torch_graphs import _with_graphs

import jax

from test_torch_jax_cache import isolated_jax_cache  # noqa: F401
from mlmicroservicetemplate_tpu.engine import InferenceEngine as JaxEngine
from mlmicroservicetemplate_tpu.engine.streams import ContinuousDecodeLoop as JaxLoop
from mlmicroservicetemplate_tpu.models.registry import build_model as jax_build_model
from mlmicroservicetemplate_tpu.parallel import ReplicaSet, make_mesh
from mlmicroservicetemplate_tpu.scheduler.policy import SLOTracker as JaxSLOTracker
from mlmicroservicetemplate_tpu.utils import metrics as jax_metrics
from mlmicroservicetemplate_tpu.utils import perfobs as jax_perfobs
from mlmicroservicetemplate_tpu.utils.config import ServiceConfig as JaxServiceConfig
from mlmicroservicetemplate_tpu_torch.runtime import compile_cache as cc
from mlmicroservicetemplate_tpu_torch.scheduler.policy import BATCH, INTERACTIVE, SLOTracker
from mlmicroservicetemplate_tpu_torch.serve import build_service
from mlmicroservicetemplate_tpu_torch.utils import metrics, perfobs
from mlmicroservicetemplate_tpu_torch.utils.config import ServiceConfig, load_config

SMALL = dict(vocab_size=300, d_model=256, num_heads=4, num_kv_heads=2, num_layers=2,
             d_ff=512, max_position=128)
SERVE = {"MODEL_NAME": "llama", "DEVICE": "cpu", "WARMUP": "0", "LLAMA_CONFIG": json.dumps(SMALL),
         "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "16,32", "MAX_DECODE_LEN": "12",
         "STREAM_CHUNK_TOKENS": "4", "MAX_STREAMS": "4", "KV_BLOCK_SIZE": "8",
         "STREAM_PIPELINE": "1"}
# Three prompts of random ids (the small config's vocabulary), one sampled.
PROMPTS = [(9, {}), (14, {}), (20, {"temperature": 0.8, "top_k": 40, "seed": 5})]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _perf_default():
    """Engines set the process switch; every test leaves it at its default."""
    yield
    perfobs.configure(True)


def _feats() -> list[dict]:
    out = []
    for n, extra in PROMPTS:
        ids = np.random.default_rng(n).integers(5, 250, n).astype(np.int32)
        out.append({"input_ids": ids, "length": np.int32(n), **extra})
    return out


def _drive(loop) -> list[list[int]]:
    """Every prompt's stream queued before the loop's thread starts (one
    wave), each read to its end."""
    async def read(gen):
        return [int(t) async for chunk in gen for t in np.asarray(chunk).tolist()]

    async def main():
        loop._ensure_thread = lambda: None
        try:
            gens = [loop.submit_stream(dict(f)) for f in _feats()]
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        return await asyncio.gather(*(read(g) for g in gens))

    try:
        return asyncio.run(main())
    finally:
        loop.stop()


def _port(paged: bool = True, params=None, **env):
    _, _, engine, batcher = build_service(
        {**SERVE, "PAGED_KV": "1" if paged else "0", **env}, params=params)
    return engine, batcher._cdl


# ---------------------------------------------------------------------------
# the estimator against the reference's


def _feed(occ, now, steps) -> None:
    for step in steps:
        if step[0] == "guard":
            occ.on_guard(step[1], step[2], step[3])
        elif step[0] == "complete":
            now[0] = step[2]
            occ.note_complete(step[1], *step[3:])
        else:  # "cost"
            step[1].note_cost(occ.model, step[2], step[3], step[4])


SEQUENCES = {
    # A prefill_chunk window without a fetch of its own, closed by the next
    # chunk's completion (linearity); then an idle gap (bubble).
    "linearity-bubble": [("guard", "prefill_chunk", 0.0, 0.01), ("guard", "chunk", 0.02, 0.03),
                         ("complete", "chunk", 0.5), ("guard", "chunk", 1.5, 1.51),
                         ("complete", "chunk", 1.8)],
    # Host prep with and without device work in flight.
    "prep-overlap": [("guard", "prep", 0.0, 0.1), ("guard", "chunk", 0.0, 0.01),
                     ("guard", "prep", 0.1, 0.3), ("complete", "chunk", 0.4)],
    # The whole-batch site closes itself; untracked sites are ignored; a
    # completion of a site with nothing pending samples nothing.
    "sync-untracked": [("guard", "batch", 0.0, 0.2), ("guard", "fetch", 0.3, 0.31),
                       ("guard", "swap", 0.3, 0.32), ("complete", "prefill", 0.4),
                       ("guard", "prefill", 0.5, 0.51), ("guard", "chunk", 0.52, 0.53),
                       ("guard", "chunk", 0.54, 0.55), ("complete", "prefill", 0.7),
                       ("complete", "chunk", 0.9, 2)],
    # Modeled cost accrued between completions, with a peak: the MFU terms.
    "mfu": [("cost", None, "loop_chunk_paged", 2e6, 1e4), ("guard", "chunk", 100.0, 100.001),
            ("complete", "chunk", 100.2), ("cost", None, "loop_chunk_paged", 2e6, 1e4),
            ("guard", "chunk", 100.2, 100.201), ("complete", "chunk", 100.4)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_occupancy_snapshots_equal_the_reference(name):
    snaps = []
    for mod in (jax_perfobs, perfobs):
        now = [0.0 if name != "mfu" else 100.0]
        occ = mod.DeviceOccupancy(f"occ-{name}", peak_flops=1e9 if name == "mfu" else 0.0,
                                  clock=lambda now=now: now[0])
        mod.reset_book()
        steps = [(s[0], mod, *s[2:]) if s[0] == "cost" else s for s in SEQUENCES[name]]
        _feed(occ, now, steps)
        snaps.append(occ.snapshot())
    assert snaps[1] == snaps[0]
    assert snaps[1]["pending_dispatches"] == 0


def test_merged_snapshots_equal_the_reference():
    snaps = []
    for mod in (jax_perfobs, perfobs):
        rows = []
        for name in ("linearity-bubble", "sync-untracked"):
            now = [0.0]
            occ = mod.DeviceOccupancy(f"merge-{name}", clock=lambda now=now: now[0])
            _feed(occ, now, SEQUENCES[name])
            rows.append(occ.snapshot())
        snaps.append(mod.merge_snapshots(rows))
    assert snaps[1] == snaps[0]
    assert snaps[1]["replicas"] == 2 and snaps[1]["completion_samples"] == 5


def test_the_pending_bound_drops_the_oldest_like_the_reference():
    snaps = []
    for mod in (jax_perfobs, perfobs):
        occ = mod.DeviceOccupancy("bound", clock=lambda: 0.0)
        occ.MAX_PENDING = 3
        for i in range(5):
            occ.on_guard("chunk" if i % 2 else "prefill", float(i), float(i) + 0.1)
        snaps.append(occ.snapshot())
    assert snaps[1] == snaps[0]
    assert snaps[1]["dropped_submits"] == 2 and snaps[1]["pending_dispatches"] == 3


def test_mfu_estimate_agrees_with_the_modeled_flops():
    now = [100.0]
    perfobs.reset_book()
    occ = perfobs.DeviceOccupancy("mfu-model", enabled=True, peak_flops=1e9,
                                  clock=lambda: now[0])
    for _ in range(5):
        perfobs.note_cost("mfu-model", "loop_chunk_paged", 2_000_000.0, 0.0)
        occ.on_guard("chunk", now[0], now[0] + 0.001)
        now[0] += 0.2
        occ.note_complete("chunk")
    snap = occ.snapshot()
    assert snap["modeled_flops_total"] == 5 * 2_000_000.0
    expected = snap["modeled_flops_total"] / snap["elapsed_s"] / 1e9
    assert snap["mfu_epoch"] == pytest.approx(expected, rel=0.01)  # rounding of elapsed_s
    assert snap["mfu_estimate"] == pytest.approx(expected, rel=0.25)  # rolling vs epoch


# ---------------------------------------------------------------------------
# the layer on and off in the loop


def test_perf_obs_off_keeps_no_timestamps():
    engine, loop = _port(PERF_OBS="0")
    assert engine.perf.enabled is False and not perfobs.enabled()
    rows = _drive(loop)
    assert all(rows)
    snap = engine.perf.snapshot()
    assert snap["enabled"] is False
    assert engine.perf._pending == {}
    assert snap["completion_samples"] == 0 and snap["device_busy_total_s"] == 0.0
    assert snap["device_bubble_s"] == 0.0 and snap["prep_host_s"] == 0.0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_dispatch_counts_and_tokens_identical_with_the_layer_on(paged):
    jcfg = JaxServiceConfig(device="cpu", model_name="llama", warmup=False,
                            batch_buckets=(1, 4), seq_buckets=(16, 32), max_decode_len=12,
                            stream_chunk_tokens=4, max_streams=4, paged_kv=paged,
                            kv_block_size=8, stream_pipeline=1)
    os.environ["LLAMA_CONFIG"] = json.dumps(SMALL)
    try:
        jbundle = jax_build_model(jcfg)
    finally:
        del os.environ["LLAMA_CONFIG"]
    params = jax.tree.map(np.asarray, jbundle.params)
    want = _drive(JaxLoop(JaxEngine(jbundle, jcfg, ReplicaSet(make_mesh(1))), jcfg))
    runs = {}
    for on in (True, False):
        engine, loop = _port(paged, params=params, PERF_OBS="1" if on else "0")
        runs[on] = (_drive(loop), dict(engine.dispatch_counts), engine.perf.snapshot())
    assert runs[True][0] == runs[False][0] == want
    assert runs[True][1] == runs[False][1]
    snap = runs[True][2]
    assert snap["completion_samples"] > 0 and snap["device_busy_total_s"] > 0
    assert snap["pending_dispatches"] == 0  # every submit closed by a fetch seam


# ---------------------------------------------------------------------------
# modeled cost per graph


def _standin(kind, fn, inputs, device):
    outputs = fn()
    return cc.GraphEntry(kind, types.SimpleNamespace(replay=fn), inputs, outputs, {}, 0.0)


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_modeled_flops_of_a_matmul_graph(on):
    perfobs.configure(on)
    m, k, n = 8, 16, 32
    x, y = torch.ones(m, k), torch.ones(k, n)
    bundle = types.SimpleNamespace(name=f"matmul-{on}")
    cache = cc.GraphCache(_standin)
    perfobs.reset_book()
    with torch.inference_mode():
        entry = cache.get(bundle, "forward", (m, k, n), ("cpu",), lambda: (lambda: x @ y, None,
                                                                          "cpu"))
        for _ in range(3):
            entry.replay()
    got = perfobs.book_totals(bundle.name)
    if not on:
        assert entry.cost is None and got["flops"] == 0.0 and cache.cost_stats() == {}
        return
    assert entry.cost.flops == 2 * m * k * n
    assert entry.cost.bytes == 4 * (m * k + k * n + m * n)  # operands read once, out written
    assert got == {"flops": 3 * 2 * m * k * n, "bytes": 3 * entry.cost.bytes,
                   "by_kind": {"forward": 3 * 2 * m * k * n}}
    assert cache.cost_stats() == {"forward": 1}


def _hand_count(rows: int, steps: int) -> int:
    """The linears and the LM head of ``steps`` decode steps of ``rows``
    rows of the small llama: 2 FLOPs a multiply-add."""
    d, f, v = SMALL["d_model"], SMALL["d_ff"], SMALL["vocab_size"]
    hd = d // SMALL["num_heads"]
    q = o = d * SMALL["num_heads"] * hd
    kv = d * SMALL["num_kv_heads"] * hd
    per_token = SMALL["num_layers"] * 2 * (q + 2 * kv + o + 3 * d * f) + 2 * d * v
    return rows * steps * per_token


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_llama_decode_graph_counts_the_hand_count(paged):
    engine, loop = _port(paged)
    _with_graphs(engine)
    loop.warm()
    entry = loop.chunk_graph(False)
    assert entry.kind == ("loop_chunk_paged" if paged else "loop_chunk")
    want = _hand_count(loop.n_slots, engine.chunk_tokens)
    assert entry.cost.flops == want
    perfobs.reset_book()
    rows = _drive(loop)
    assert all(rows)
    # Every replay since the reset accrued its graph's count; the warm run's
    # replay of the chunk graph came before it.
    book = perfobs.book_totals("llama")
    chunks = [e for e in engine.graphs.entries() if e.kind == entry.kind]
    assert book["by_kind"][entry.kind] == want * (sum(e.replays for e in chunks) - 1)
    assert book["flops"] == sum(e.cost.flops * e.replays for e in engine.graphs.entries()) - want


# ---------------------------------------------------------------------------
# the SLO tracker


def _objectives():
    return {("ttft", INTERACTIVE): 0.5, ("tbt", INTERACTIVE): 0.1, ("ttft", BATCH): 5.0}


def test_slo_burn_rates_equal_the_reference():
    trackers = []
    for cls in (JaxSLOTracker, SLOTracker):
        now = [1000.0]
        t = cls("slo-model", _objectives(), target=0.9, windows_s=(60.0, 600.0),
                clock=lambda now=now: now[0])
        for _ in range(8):
            t.note("ttft", INTERACTIVE, 0.1)
        for _ in range(2):
            t.note("ttft", INTERACTIVE, 1.0)
        t.note("tbt", INTERACTIVE, 0.05)
        t.note("tbt", BATCH, 9.0)  # no objective: ignored
        first = (t.burn_rate("ttft", INTERACTIVE), t.worst_burn(), t.snapshot())
        now[0] += 120.0
        t.note("ttft", INTERACTIVE, 0.1)
        trackers.append((first, t.burn_rate("ttft", INTERACTIVE, 60.0),
                         t.burn_rate("ttft", INTERACTIVE, 600.0), t.snapshot()))
    assert trackers[1] == trackers[0]
    (burn, worst, _), fast, slow, _ = trackers[1]
    assert burn == pytest.approx(2.0) and worst == pytest.approx(2.0)  # 0.2 bad / 0.1 budget
    assert fast == 0.0 and slow == pytest.approx((2 / 11) / 0.1)


def test_slo_tracker_from_the_knobs_like_the_reference():
    assert SLOTracker.from_cfg("m", ServiceConfig(device="cpu")) is None
    env = {"DEVICE": "cpu", "SLO_TTFT_MS": "500", "SLO_BATCH_TBT_MS": "80", "SLO_TARGET": "0.95",
           "SLO_WINDOWS_S": "30,300"}
    from mlmicroservicetemplate_tpu.utils.config import load_config as jax_load_config

    got = SLOTracker.from_cfg("m", load_config(env))
    want = JaxSLOTracker.from_cfg("m", jax_load_config(env))
    assert got.objectives == want.objectives == {("ttft", INTERACTIVE): 0.5, ("tbt", BATCH): 0.08}
    assert (got.target, got.windows_s) == (want.target, want.windows_s) == (0.95, (30.0, 300.0))


def test_the_new_series_sample_after_a_run():
    engine, loop = _port(SLO_TTFT_MS="60000", SLO_TBT_MS="60000", PEAK_TFLOPS="0.001")
    _with_graphs(engine)
    loop.warm()
    rows = _drive(loop)
    assert all(rows)
    text = metrics.render()[0].decode()
    assert 'device_busy_seconds_total{model="llama",site="chunk"}' in text
    assert 'modeled_flops_total{kind="loop_chunk_paged",model="llama"}' in text
    assert 'mfu_estimate{model="llama"}' in text
    assert 'slo_ttft_burn_rate{klass="interactive",model="llama",window="fast"}' in text
    assert 'slo_tbt_burn_rate{klass="interactive",model="llama",window="slow"}' in text
    snap = engine.perf.snapshot()
    assert snap["peak_flops"] == 1e9 and snap["mfu_estimate"] > 0
    assert loop.slo.snapshot()["burn"]["ttft:interactive:fast"] == 0.0  # a 60 s objective


# ---------------------------------------------------------------------------
# buckets and the peak


@pytest.mark.parametrize("spec", ["0.1,1,10,60", "1,0.5", "0,-1", "", "x,1", "1,1", None])
def test_latency_buckets_parse_and_validate_like_the_reference(spec):
    assert metrics.parse_buckets(spec) == jax_metrics.parse_buckets(spec)
    ok = jax_metrics.parse_buckets(spec) is not None or not (spec or "").strip()
    if ok:
        assert load_config({"DEVICE": "cpu", "LATENCY_BUCKETS": spec or ""}).latency_buckets == (
            spec or None)
    else:
        with pytest.raises(ValueError, match="LATENCY_BUCKETS must be comma-separated"):
            ServiceConfig(device="cpu", latency_buckets=spec)
    assert max(metrics._DEFAULT_LATENCY_BUCKETS) > 10.0
    assert metrics._DEFAULT_LATENCY_BUCKETS == jax_metrics._DEFAULT_LATENCY_BUCKETS


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989.4e12),
                                       ("NVIDIA H100 PCIe", 756e12),
                                       ("NVIDIA A10G", 0.0)])
def test_the_card_table_and_the_knob(monkeypatch, name, peak):
    monkeypatch.delenv("PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    assert perfobs.peak_flops(ServiceConfig(device="cuda")) == peak
    assert perfobs.peak_flops(ServiceConfig(device="cuda", peak_tflops=500.0)) == 500e12
    # The CPU has no entry, as in the reference (whose CPU backend has none).
    assert perfobs.peak_flops(ServiceConfig(device="cpu")) == 0.0
    assert jax_perfobs.peak_flops(JaxServiceConfig(device="cpu")) == 0.0
