#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check every kernel it runs.

    python3 chip_smoke.py                  # on a machine with a CUDA GPU
    python3 chip_smoke.py --cpu-rehearsal  # small CPU dry run of the paths

Phases, one JSON line each; any failure exits non-zero and prints no
result line:

1. env: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions.
2. build: nvcc builds every ``csrc/*.cu`` of the package (in parallel).
3. kernel fused_attention: the CUDA kernel against its plain PyTorch
   version on the card, bf16 and f32, at the serving shapes, with a padded
   row, an all-masked row and a bias + scale=1.0 case; CUDA-event times of
   the kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only; the port never calls it) beside the kernel's bound.
4. serve bert-base: the full-width service through ``Batcher.submit`` in
   waves that hit several batch and seq buckets; every kernel launch
   counter must show the path went through the kernel (12 launches per
   dispatch), and the answers must match the same port on the CPU in f32
   on the same weights.
5. forward: where one forward's time goes at three buckets: wall time
   (CUDA events) against the card's busy time from ``torch.profiler``'s
   kernel records, split into K1, GEMMs and the rest.
6. http: one ``/predict`` over loopback through the aiohttp app (skipped,
   and said so, where aiohttp is missing).

The last lines are the kernels summary, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  ``--cpu-rehearsal`` skips the build
and kernel phases, serves on the CPU at small buckets, and prints no result
line.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import re
import socket
import subprocess
import sys
import time
import traceback

# Tolerances of the kernel against its plain version in f32 on the same
# inputs: f32 differs only by summation order; bf16 adds the output's and
# the probabilities' rounding to bf16 (8 bits of mantissa).
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Served probabilities, bf16 weights and activations through 12 layers
# against the port's own f32 run on the CPU.
PROB_TOL = 2e-2
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s for bf16 tensor cores and for f32 outside the tensor cores.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HEADS, HEAD_DIM, LAYERS = 12, 64, 12
# cuBLAS / CUTLASS matrix-product kernels, by name
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b: int, s: int, dtype, bias) -> tuple[float, str]:
    """Least time for the function on an H100: every input read once and
    the output written once over HBM, or its FLOPs at the type's peak."""
    el = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = 4 * b * s * HEADS * HEAD_DIM * el + b * s * 4
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    flops = 4 * b * HEADS * s * s * HEAD_DIM
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F

    from mlmicroservicetemplate_tpu_torch.ops.attention import (
        fused_attention,
        fused_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    headline = None
    cases = [(b, s, False) for b, s in ((1, 32), (8, 128), (32, 512))] + [(8, 128, True)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, s, with_bias in cases:
            q, k, v = (
                torch.randn(b, s, HEADS, HEAD_DIM, device="cuda", generator=gen).to(dtype)
                for _ in range(3)
            )
            mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
            if b > 2:
                mask[1, s // 3:] = 0  # a padded row
                mask[2, :] = 0  # an all-masked row, as a padded batch row is
            bias = scale = None
            if with_bias:
                bias = torch.randn(1, HEADS, s, s, device="cuda", generator=gen).to(dtype)
                scale = 1.0
            out = fused_attention(q, k, v, mask, bias, scale)
            torch.cuda.synchronize()
            ref = fused_attention_ref(
                q.float(), k.float(), v.float(), mask,
                None if bias is None else bias.float(), scale,
            )
            diff = (out.float() - ref).abs()
            tol = KERNEL_TOL[name]
            max_err = diff.max().item()
            ok = bool(torch.isfinite(out).all()) and bool(
                (diff <= tol + tol * ref.abs()).all()
            )
            if b > 2:  # the all-masked row is the plain mean of v
                uniform = v[2].float().mean(0, keepdim=True).expand(s, -1, -1)
                ok = ok and bool(((out[2].float() - uniform).abs() <= tol * 4).all())
            iters = 20 if s >= 512 else 100
            kernel_ms = cuda_ms(lambda: fused_attention(q, k, v, mask, bias, scale), iters)
            plain_ms = cuda_ms(lambda: fused_attention_ref(q, k, v, mask, bias, scale), iters)
            add = torch.where(mask[:, None, None, :] != 0, 0.0, -1e9).to(dtype)
            if bias is not None:
                add = add + bias
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add, scale=scale),
                iters,
            )
            bound_ms, bound_by = attention_bound(b, s, dtype, bias)
            row = dict(
                dtype=name, shape=[b, s, HEADS, HEAD_DIM], bias=with_bias,
                max_abs_err=max_err, tol=f"atol=rtol={tol}", ok=ok,
                kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by,
            )
            emit("kernel fused_attention", **row)
            if not ok:
                raise AssertionError(f"fused_attention disagrees with its plain version: {row}")
            if name == "bfloat16" and (b, s, with_bias) == (32, 512, False):
                headline = row
    return headline


def make_waves(rehearsal: bool):
    """Text requests in five waves of 1, 2, 5, 8 and 16, each wave longer,
    so dispatches land in several batch and seq buckets."""
    import numpy as np

    rng = np.random.default_rng(0)
    words = ["serve", "batch", "token", "kernel", "queue", "model", "card", "bucket"]
    caps = (20, 50, 110, 240, 480) if not rehearsal else (20, 40, 60, 90, 110)
    waves = []
    for n, cap in zip((1, 2, 5, 8, 16), caps):
        wave = []
        for _ in range(n):
            length = int(rng.integers(cap // 2, cap))
            text = " ".join(rng.choice(words, size=length))[:length]
            wave.append(text)
        waves.append(wave)
    return waves


async def drive(batcher, bundle, waves):
    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    await batcher.start()
    latencies, rows = [], []

    async def one(text):
        t0 = time.monotonic()
        row = await batcher.submit(bundle.preprocess(RawItem(text=text)))
        latencies.append(time.monotonic() - t0)
        return row

    try:
        t0 = time.monotonic()
        for wave in waves:
            rows.extend(await asyncio.gather(*(one(t) for t in wave)))
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return rows, latencies, wall


def phase_serve(rehearsal: bool, card_line: str):
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
    from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    overrides = {"MODEL_NAME": "bert-base", "DEVICE": "cpu" if rehearsal else "cuda"}
    if rehearsal:
        overrides.update(BATCH_BUCKETS="1,2,4,8,16", SEQ_BUCKETS="32,64,128")
    cfg, bundle, engine, batcher = build_service(overrides)
    warm_s = engine.warmup()
    waves = make_waves(rehearsal)

    fused_attention.launches = 0
    engine.dispatches = 0
    rows, latencies, wall = asyncio.run(drive(batcher, bundle, waves))
    launches, dispatches = fused_attention.launches, engine.dispatches

    if not rehearsal and (dispatches < 1 or launches != LAYERS * dispatches):
        raise AssertionError(
            f"fused_attention launched {launches} times over {dispatches} dispatches; "
            f"the main path must launch it {LAYERS} times per dispatch"
        )
    # The same port on the CPU in f32, same weights (random init is drawn
    # on the CPU from one seed), same requests.
    _, cpu_bundle, cpu_engine, cpu_batcher = build_service(
        {**overrides, "DEVICE": "cpu", "WARMUP": "0"}
    )
    asyncio.run(cpu_batcher.stop())
    ref = []
    for wave in waves:
        ref.extend(cpu_engine.run_batch(
            [cpu_bundle.preprocess(RawItem(text=t)) for t in wave]
        ))
    worst, label_checked = 0.0, 0
    for got, want in zip(rows, ref):
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"bad logits row {got} (want shape {want.shape})")
        pg, pw = bundle.postprocess(got), cpu_bundle.postprocess(want)
        err = float(np.max(np.abs(np.array(pg["probs"]) - np.array(pw["probs"]))))
        worst = max(worst, err)
        top2 = sorted(pw["probs"])[-2:]
        if top2[1] - top2[0] > 2 * PROB_TOL:  # a closer call may flip within tolerance
            label_checked += 1
            if pg["prediction"]["label_id"] != pw["prediction"]["label_id"]:
                raise AssertionError(f"label differs from the CPU f32 run: {pg} vs {pw}")
    if worst > PROB_TOL:
        raise AssertionError(f"probs differ from the CPU f32 run by {worst} > {PROB_TOL}")
    lat = np.array(latencies) * 1e3
    emit(
        "serve bert-base", device=str(bundle.device), card=card_line,
        requests=len(rows), dispatches=dispatches, fused_attention_launches=launches,
        warmup_s=warm_s, p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)), req_per_s=len(rows) / wall,
        max_prob_err_vs_cpu_f32=worst, prob_tol=PROB_TOL,
        labels_checked=label_checked,
    )
    return cfg, bundle, engine, launches


def phase_forward(bundle) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(1)
    reps = 5
    for b, s in ((1, 32), (8, 128), (32, 512)):
        ids = torch.randint(5, 261, (b, s), device="cuda", generator=gen, dtype=torch.int32)
        mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            wall_ms = cuda_ms(lambda: bundle.forward(ids, mask), 10)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    bundle.forward(ids, mask)
                torch.cuda.synchronize()
        split = {"attention": 0.0, "gemm": 0.0, "other": 0.0}
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            part = ("attention" if "fused_attention" in e.name
                    else "gemm" if GEMM_KERNEL.search(e.name) else "other")
            split[part] += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        busy_ms = sum(split.values()) / reps / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        emit(
            "forward", shape=[b, s], wall_ms=wall_ms,
            device_busy_ms=busy_ms if by_name else None,
            busy_share=busy_ms / wall_ms if by_name else None,
            **{f"{k}_ms": v / reps / 1e3 for k, v in split.items()},
            top_kernels=[[name[:80], us / reps / 1e3] for name, us in top],
            note=None if by_name else "torch.profiler recorded no device kernels",
        )


async def http_predict(cfg, bundle, engine) -> dict:
    import aiohttp
    from aiohttp import web

    from mlmicroservicetemplate_tpu_torch.api.app import build_app
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    app = build_app(dataclasses.replace(cfg, warmup=False), bundle, engine, Batcher(engine, cfg))
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    try:
        await web.TCPSite(runner, "127.0.0.1", port).start()
        url = f"http://127.0.0.1:{port}"
        async with aiohttp.ClientSession() as session:
            for _ in range(600):
                async with session.get(f"{url}/readyz") as r:
                    if r.status == 200:
                        break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError("/readyz never turned 200")
            async with session.post(f"{url}/predict", json={"text": "hello card"}) as r:
                body = await r.json()
                if r.status != 200 or "prediction" not in body:
                    raise AssertionError(f"/predict answered {r.status}: {body}")
        return body
    finally:
        await runner.cleanup()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="skip build and kernel phases; serve on the CPU at small buckets")
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    phase = "env"
    try:
        import torch

        from mlmicroservicetemplate_tpu_torch.ops import _build

        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             python=sys.version.split()[0])
        headline = None
        if rehearsal:
            emit("build", skipped="cpu rehearsal: no nvcc, no kernels")
            emit("kernel fused_attention", skipped="cpu rehearsal: the plain version runs")
        else:
            phase = "build"
            t0 = time.monotonic()
            built = _build.build()
            emit(phase, seconds=time.monotonic() - t0, libraries=[
                {"name": b.name, "seconds": b.seconds,
                 "ptxas": [ln.strip() for ln in b.log.splitlines() if "Used" in ln]}
                for b in built
            ])
            phase = "kernel fused_attention"
            headline = phase_kernel()
        phase = "serve bert-base"
        cfg, bundle, engine, launches = phase_serve(rehearsal, card_line)
        if rehearsal:
            emit("forward", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "forward"
            phase_forward(bundle)
        phase = "http"
        try:
            import aiohttp  # noqa: F401
        except ImportError:
            emit(phase, skipped="aiohttp is not installed; HTTP is no device path")
        else:
            body = asyncio.run(http_predict(cfg, bundle, engine))
            emit(phase, status=200, prediction=body["prediction"])
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    if rehearsal:
        print("chip_smoke: cpu rehearsal passed (no result line: nothing ran on a card)")
        return 0
    print(json.dumps({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "mlmicroservicetemplate_tpu_torch/csrc/fused_attention.cu",
        "replaces": "mlmicroservicetemplate_tpu/ops/attention.py:400",
        "launches": launches, "max_abs_err": headline["max_abs_err"],
        "ms": headline["kernel_ms"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_us"] / 1e3, "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"], "dtype": headline["dtype"],
        "shape": headline["shape"],
    }]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
