#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check every kernel it runs.

    python3 chip_smoke.py                  # on a machine with a CUDA GPU
    python3 chip_smoke.py --cpu-rehearsal  # small CPU dry run of the paths
    python3 chip_smoke.py --perf           # decode kernels' timing phases only

Phases, one JSON line each; any failure exits non-zero and prints no
result line:

1. env: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions.
2. build: nvcc builds every ``csrc/*.cu`` of the package (in parallel);
   ptxas's registers and spills per kernel and the SASS HGMMA and HMMA
   counts per library are printed; K1's and K4's HGMMA (the shared wgmma
   loop of ``csrc/attention_sm90.cuh``) and K2's and K3's HMMA (mma.sync
   in ``csrc/decode_sm90.cuh``) must be > 0.
3. kernel fused_attention: the CUDA kernel against its plain PyTorch
   version on the card, bf16 and f32, at the serving shapes, with a padded
   row, an all-masked row, ragged valid prefixes, masks with whole 128-key
   tiles masked between valid keys, and bias + scale=1.0 cases (the
   headline keeps its original inputs); CUDA-event times of
   the kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only; the port never calls it) beside the kernel's bound.
3a. kernel fused_attention t5: K1 at T5-small's shape (H=8, D=64) with
   its position bias in q's type and ``scale=1.0``: bf16 and f32, B in {1,
   8, 32}, S in {18, 64, 128, 417, 512} (the seq buckets the T5 phases
   serve, and two widths whose bias rows end inside a 128-key tile and
   off 16 bytes), unpadded and padded masks, against its plain
   version; CUDA-event ms, device µs (bf16, S 128 and 512), the bound over q, k, v, mask,
   bias and output bytes, and SDPA with the same bias folded into its
   ``attn_mask``; each row names how the kernel read the bias
   (``bias_path``: "smem tile", TMA tiles through shared memory, for a
   bf16 bias with 16-byte aligned rows; "per-element" otherwise); then
   ptxas's registers and spills of every instantiation of the wgmma loop
   (each bias variant, K1 without a bias, K4) with its stages, shared
   memory and CTAs an SM at S=512 (K4: 2048).
4. kernel decode_attention: the same for the decode kernel, dense bf16,
   dense f32 and int8 with bf16 scales, B in {1, 8, 32}, H=32, KVH=4,
   D=64, T in {96, 576, 2048}; one row padded to a third of T, and (B > 1)
   an all-masked row; then ``DECODE_EXTRA_CASES``: valid prefixes of an
   eighth of T, valid keys only in the last tile, T < 64, B=32 at T=2048.
   Each row also gives ``device_us`` (the profiler's kernel time a call:
   split kernel and combine; ``library_device_us`` SDPA's) and ``host_us``
   (the wrapper's host time a call, back to back, no synchronisation).
   Then GPT-2's shape at one query head per KV head (H = KVH = 12, R = 1):
   every dtype at B in {1, 8, 16} over a 320-key cache with a padded row
   and (B > 1) a row with no valid key, then valid prefixes and last-tile
   keys (``GPT2_DECODE_CASES``).
4b. kernel paged_decode_attention: the same for the paged decode kernel
   over pools of 16-token blocks, B in {1, 8, 16}, table width T in {6,
   36, 128} blocks; a shuffled table with a sentinel tail on one row and
   (B > 1) a row with no valid key; then ``PAGED_EXTRA_CASES``: short
   rows (1-3 blocks valid, the table past them sentinels) at up to 128
   blocks, with a row with no valid key whose table is half sentinels; the
   yardstick gathers the dense view, expands it to 32 heads and runs
   ``scaled_dot_product_attention``.  Then GPT-2's shape at R = 1 over
   tables of 20 blocks (``GPT2_PAGED_CASES``).
4a. sampler: ``models/sampling.py`` on the card against the CPU at B = 16,
   V = 50257: threefry keys, bits and uniforms of three chained steps equal
   bit for bit, Gumbel noise within 2e-6, ``select_token``'s rng chains
   equal and its tokens equal (or parted only inside the measured score
   difference).
4c. kernel ring_hop: the ring-hop kernel (K4) against its plain version,
   bf16 and f32, B in {1, 8}, S_loc in {96, 512, 2048}, H=12, D=64, from a
   fresh carried state and a mid-ring one; a padded row and (B > 1) a row
   with no valid key in the block; o, m and l checked; then
   ``RING_EXTRA_CASES``: the ``fresh`` and ``out`` arguments (the SP=1 hop,
   a ring's first and last), ragged and interior masks, and a carried m of
   exactly -1e9 over a block row with no valid key; the yardstick is
   ``scaled_dot_product_attention`` over the same block (the hop's work
   without the carried merge).
4d. kernel graphs: each of K1-K4 captured alone in a CUDA graph at a
   serving shape (its library links its own static CUDA runtime), replayed
   on new inputs against an eager call: equal bit for bit, one launch
   counted a replay, and the profiler's trace of a replay naming it.
5. serve bert-base: the full-width service through ``Batcher.submit`` in
   waves that hit several batch and seq buckets, every bucket captured as
   a CUDA graph at warmup; every kernel launch counter must show the path
   went through the kernel (12 launches per dispatch, counted from the
   replays), and the answers must match the same port on the CPU in f32
   on the same weights.
5a. graphs <service> (after each service): captures, capture seconds,
   replays and static output bytes by kind, the graph pools' bytes, cache
   misses after warmup (must be 0), the launch counters of the drive
   against the launches its replays made (must agree), one replay of each
   kind traced by ``torch.profiler`` with K1-K4 by name (as many as its
   capture recorded), and the same batch through the graph and, with the
   engine's graphs off, eagerly: logits within 1e-3 of a row's largest
   |logit|, greedy tokens identical (a loop chunk of 16 live slots for the
   streaming services).
6. forward: where one BERT forward's time goes at three buckets, eager
   and as the bucket's graph replay side by side: wall time (CUDA events)
   against the card's busy time from ``torch.profiler``'s kernel records,
   split into K1, GEMMs and the rest, and the kernels a call.
6a. serve resnet50: ResNet-50 v1.5 at full width (random weights from seed
   0, every BN drawn at random; bf16, channels-last cuDNN convs; no TPU
   kernel on this path) with every batch bucket warmed in every dispatch
   thread (the warmup first timed on fresh threads: the first, then one
   with cuDNN's autotuning off and one with it on), uint8 images in
   waves of 1, 2, 5, 8, 16 through ``Batcher.submit`` (batches above 1
   required); every row's logits within 3e-2 of the reference row's
   largest |logit| of the port's f32 run on the CPU on the same weights,
   and the same top-1 where the reference's top two are further apart than
   twice that.  No phase but the ``http`` one imports PIL.  Then ``forward
   resnet50``: one forward at B=1 and B=32 (and B=32 with the autotuning
   flipped), each on a fresh thread: the first call's time, wall against
   busy time, img/s, TFLOP/s over 2 x 4.09 GMAC an image, the conv
   kernels' share and the layout transposes a forward (0 while
   channels-last holds), eager and (not autotuned) as the bucket's graph
   replay.  The BNs are folded into the convs at load, and each conv with
   a ReLU after it is one fused cuDNN call.
6b. serve bert-long: the long-context BERT at full width (12 layers, 768
   hidden, position table 2048, random weights from seed 0, bf16) at SP=1,
   SEQ_BUCKETS=512,1024,2048, through ``Batcher.submit`` in waves of texts
   up to ~2000 bytes; the ring-hop kernel must launch 12 times per dispatch
   and K1 never; the answers must match an f32 forward on the card of the
   same weights through the plain hop.
6c. forward bert-long: one B=8, S=2048 forward timed and split into K4,
   GEMMs and the rest, eager and as its graph, as in 6.
6d. ring 4-shard: the same weights through a 4-shard placement whose
   shards all sit on the one card, over the 2048 bucket (4 hops of
   S_loc=512 a layer, 192 launches a forward); probabilities must match the
   SP=1 run; the same placement served by an engine of its own, whose
   graph (every shard on one card) must match the eager forward within
   1e-3 of a row's largest |logit|; eager and graph timed beside the SP=1
   forward and split by kernel.
7. serve llama / serve llama int8: full-width TinyLlama (22 layers, random
   weights from seed 0; the int8 service at CUT_LAYERS = 6 layers of
   weights of their own from seed 0, to keep the run within its time
   limit), bf16, the dense and the int8 KV cache, through ``Batcher.submit`` in waves over
   several buckets, some with ``max_tokens``, every third sampled and
   seeded (temperature 0.7 or 1, top_k 0 or 40, top_p 1 or 0.9).  The
   decode kernel must launch 22 times per decode step and never in
   prefill; every emitted token is checked teacher-forced against an f32
   forward of the plain path on the same weights: a greedy one against the
   step's best logit, a sampled one against the draw rebuilt from its seed
   and step (the reference's filtered logits plus the same Gumbel noise),
   both within 3x the logit error measured in the run.  The last sampled
   request of the full wave is served again alone: the same tokens, or a
   first parting where the reference's two best perturbed scores are within
   the tolerance (batch buckets run other GEMM shapes in bf16).  Warmup
   captures every bucket's argmax and sampled graphs.
7b. serve llama stream / stream int8 / stream contiguous: the same weights
   (the int8 and the contiguous loop at CUT_LAYERS layers) streamed through ``Batcher.submit_stream`` and the continuous decode
   loop (16 slots, 64-token budget): paged KV (16-token blocks) with the
   dense and the int8 cache, then contiguous slots; 32 streams in waves of
   1, 2, 5, 8 and 16.  Every token is teacher-forced as in 7; the paged
   kernel must launch 22 times per slot decode step, the decode kernel 22
   times per step of each admission wave's first chunk (and, contiguous,
   per slot step); the pool must hold 0 blocks after the last stream.
   Every bucket's ``start`` and the loop's chunk are captured before the
   first stream, as the app warms.  Then one chunk of the 16-slot state at
   full width is timed (CUDA events) and split by kernel
   (``torch.profiler``), eager and as the loop's graph.
7c. serve llama classes: the same full-depth weights through the paged
   loop (16 slots, 64-token budget, ``MAX_STREAM_QUEUE`` 16, ``PREEMPT``)
   over a pool of ``KV_BUDGET_MB`` = 4 of the engine's worst-case streams
   (its block bytes times its blocks a stream): 16 ``batch``-class
   streams (a third sampled and seeded) hold the slots and the pool, then
   8 interactive ones arrive.  At least one preemption and one dry-pool
   requeue; every delivered token teacher-forced across the resume seams
   (recast and replay); K2 and K3 held against the loop's counts; the pool
   back to 0 blocks, no KV committed; 0 graph misses after warmup;
   preemptions, recasts, replays, dry-pool stalls and TTFT p50/p99 per
   class printed.
8. decode step: where one llama decode step's time goes at B in {1, 8,
   32}, T=576: wall time against busy time, split into K2, GEMMs, other,
   eager and as a graph of the step.
8a. serve gpt2, serve gpt2 stream (paged), serve gpt2 stream contiguous,
   each with its graphs phase: GPT-2 small at full width (12 layers, 768
   hidden, 12 heads, vocab 50257, position table 1024; random weights from
   seed 0; bf16; the byte tokenizer), as 7 and 7b: K2 or K3 launch 12 times
   a decode step (R = 1) and never in prefill.
8b. decode step gpt2: one GPT-2 step at B in {1, 8, 16} over a 320-key
   cache, greedy against sampled, eager and as graphs, split into K2,
   GEMMs and the rest; the sampler alone as graphs on [B, 50257] logits
   (threefry Gumbel noise, sort and filter, ``select_token``, argmax).
8c. serve t5, serve t5 stream, serve t5 long prompt, serve t5 per-stream,
   each with its graphs phase: T5-small at full width (6+6 layers, d_model
   512, 8 heads of 64, d_ff 2048, vocab 32128; random weights from seed 0
   at the JAX init's scales with an untied head; bf16; the byte
   tokenizer), whole, through the contiguous loop, with two prompts of
   different lengths past a cut SEQ_BUCKETS on the per-stream path (one
   width, their lengths rounded up to a multiple of 128: 2 misses), and
   with ``CONTINUOUS_BATCHING=0``; the waves of 7 and four long prompts
   (the 512 bucket).  K1 must launch 6 times per run of a ``start`` graph
   and K2 never; every token is teacher-forced against an f32 one-pass
   forward through K1's plain version; the device's bucket tables must
   equal the CPU's; graphs against eager for the batch, the loop's chunk
   and a per-stream generation.  Then ``start t5``: encode + cross K/V +
   first chunk at B in {1, 8, 32}, S=512, eager and as graphs, split into
   K1, GEMMs and the rest, and ``decode step t5`` at the same batches.
   ``serve t5 classes``: 4 batch streams in T5's 4 contiguous slots, then 4
   interactive ones; the victims replay (K1 runs their ``start`` again);
   at least one preemption, every token teacher-forced.
9. http: ``/predict`` on bert-base, ``/predict`` and ``/status`` (its
   ``n_devices``) on bert-long, ``/predict``, ``/v1/completions`` (greedy
   and sampled), ``/v1/chat/completions`` and ``/v1/models`` on llama and
   gpt2 and t5-small, whole and streamed (ndjson, and SSE ending in
   ``data: [DONE]``),
   over loopback through the aiohttp app (skipped, and said so, where
   aiohttp is missing); where PIL is installed, a PNG to resnet50 as a raw
   ``image/png`` body and as a multipart ``file`` part, each answered with
   the engine's top-1 on the decoded image (skipped, and said so, without
   PIL).

The last lines are the kernels summary (K1's and K4's with the headline's
TFLOP/s, K4's also with the SP=1 hop's time), the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  ``--cpu-rehearsal`` skips the build,
kernel and graphs phases (the CPU runs the eager functions), serves
BERT-base, ResNet-50 (f32, batch buckets 1-8), bert-long (SP=2,
SEQ_BUCKETS=64,128), a 2-layer llama (``LLAMA_CONFIG``) and full-width
GPT-2 (batch buckets 1-4, 16 decode positions) and full-width T5-small
(batch buckets 1-4, seq buckets 32-128), whole and streamed, on the
CPU at small buckets, and prints no result line.
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

# Tolerances of a kernel against its plain version in f32 on the same
# inputs: f32 differs only by summation order; bf16 adds the output's and
# the probabilities' rounding to bf16 (8 bits of mantissa); the int8 cache
# (f32 dequantization in both) adds only the bf16 output's rounding.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 1e-2}
# K4's normalised context o / l (what the ring passes on), held tighter than
# KERNEL_TOL in bf16: about twice the largest error of the ring_hop phase on
# an H100 (0.0023), where a kernel that drops its last key tile or skips the
# rescale of the carried o misses by more than 1.
RING_CTX_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
# Served probabilities, bf16 weights and activations through 12 layers
# against the port's own f32 run on the CPU.
PROB_TOL = 2e-2
# Served ResNet-50 logits, bf16 weights and activations through 53 convs,
# against the port's own f32 run on the CPU: the largest logit error of a
# row, as a fraction of the reference row's largest |logit|.
RESNET_LOGIT_TOL = 3e-2
# ResNet-50 v1.5 at 224x224: multiply-accumulates of one image's forward.
RESNET_MACS = 4.09e9
# cuDNN's convolution kernels, and the layout transposes it inserts around
# a conv whose tensors are not channels-last.
CONV_KERNEL = r"conv|fprop|implicit_gemm|nhwckrsc|nchwkcrs"
TRANSPOSE_KERNEL = r"nchwToNhwc|nhwcToNchw|[Tt]ranspose"
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# operations/s for bf16 tensor cores, int8 tensor cores and f32 outside
# the tensor cores.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
HEADS, HEAD_DIM, LAYERS = 12, 64, 12
# TinyLlama's decode shape: 32 query heads over 4 KV heads; KV blocks of
# PAGE tokens under PAGED_KV.
LLAMA_HEADS, LLAMA_KV_HEADS, PAGE = 32, 4, 16
# Depth of the llama services cut to stay within the run's time limit (the
# int8 services and the contiguous loop; the rest keep TinyLlama's 22).
CUT_LAYERS = 6
# The llama the rehearsal serves on the CPU.
REHEARSAL_LLAMA = dict(vocab_size=512, d_model=256, num_heads=4, num_kv_heads=2,
                       num_layers=2, d_ff=512)
# GPT-2 small's decode shape: 12 query heads over 12 KV heads (one query
# head per KV head, R = 1), and its vocabulary (the sampler's width).
GPT2_HEADS, GPT2_VOCAB = (12, 12), 50257
# T5-small's encoder: 8 heads of 64, 6 layers (K1 launches per start).
T5_HEADS, T5_LAYERS = 8, 6
# Card against CPU Gumbel noise: torch's log on the card and on the CPU may
# differ in the last bits of f32 (the bits and uniforms under them must be
# equal).
GUMBEL_TOL = 2e-6
# Teacher-forced check: an emitted token may trail the f32 reference's
# best logit at its step by at most TF_FACTOR times the logit error
# measured in the same run (the served precision's, plus the int8 cache's
# under QUANT_KV), never less than TF_FLOOR (f32 summation order).  A
# greedy pick under logit error e is within 2e of the true best; the
# factor 3 covers the decode path's other kernels and GEMM shapes.
TF_FACTOR, TF_FLOOR = 3.0, 1e-4
# cuBLAS / CUTLASS matrix-product kernels, by name
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)
# Libraries built on the shared wgmma loop (csrc/attention_sm90.cuh), and
# the names of K1's and K4's kernels in a profile (the loop's kernel
# carries its Op in its name; the f32 kernels carry the library's).
WGMMA_LIBRARIES = ("fused_attention", "ring_hop")
K1_KERNEL, K4_KERNEL = r"fused_attention|EncoderOp", r"ring_hop|HopOp"
# The decode kernels K2 and K3 (csrc/decode_sm90.cuh: the split kernel and
# the combine, the bool template argument naming K3), and the names of their
# first design's kernels, so a build of that design profiles the same way.
# Their libraries must hold mma.sync (SASS HMMA) for the dense bf16 cache.
K2_KERNEL = r"(?<!paged_)decode_attention_kernel|decode_(split|combine)_kernel<.*false>"
K3_KERNEL = r"paged_decode_attention_kernel|decode_(split|combine)_kernel<.*true>"
# One device kernel per wrapper launch, by name (K2 and K3: the split
# kernel; the combine runs past one split only), by launch counter.
LAUNCHED_KERNEL = {"fused_attention": r"EncoderOp", "decode_attention": r"decode_split_kernel<.*false>",
                   "paged_decode_attention": r"decode_split_kernel<.*true>",
                   "ring_hop": r"HopOp"}
# torch.profiler, started, first runs PRIMER_KERNELS short spin kernels and
# waits PROFILER_SETTLE_S before the traced work (``profiler_primer``); the
# spin kernels are left out of every count by their name.
PRIMER_KERNELS, PROFILER_SETTLE_S = 256, 0.05
PRIMER_KERNEL = re.compile(r"spin_kernel")
# Served logits through a CUDA graph against the same engine's eager
# dispatch on the same batch: the largest error of a row, as a fraction of
# that row's largest |logit| (the same kernels on the same inputs; only a
# library's choice of algorithm under capture could differ).
GRAPH_LOGIT_TOL = 1e-3
MMA_LIBRARIES = ("decode_attention", "paged_decode_attention")
# Valid prefix of batch row i, in thousandths of S, for the "ragged" masks
# (at S = 2048: 700, 2, 2045, 129, 1024, 1802, 63, 2048 keys).
RAGGED = (342, 1, 999, 63, 500, 880, 31, 1000)


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


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """Least time (ms) on an H100: the bytes over HBM, or the operations
    at the type's peak; the larger wins."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(b: int, s: int, dtype, bias, heads: int = HEADS) -> tuple[float, str]:
    """K1: q, k, v, mask (and bias) read once, the output written once;
    4·B·H·S²·D operations."""
    el = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = 4 * b * s * heads * HEAD_DIM * el + b * s * 4
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    return bound(nbytes, 4 * b * heads * s * s * HEAD_DIM, str(dtype).split(".")[-1])


def rates(mask, ms: float, heads: int = HEADS) -> dict:
    """K1's and K4's tensor-core rate in TFLOP/s: ``tflops`` counts q·k and
    p·v over each batch row's valid keys (what the bounds count, and the
    least the kernels do, since they skip only tiles with no valid key);
    ``tflops_every_key`` counts every key, as a dense attention would."""
    b, s = mask.shape
    per_key = 4 * heads * s * HEAD_DIM
    return {"tflops": per_key * int(mask.ne(0).sum()) / ms / 1e9,
            "tflops_every_key": per_key * b * s / ms / 1e9}


def ptxas_report(log: str) -> list[dict]:
    """Per kernel of a library, what ptxas reported: registers and barriers,
    and the stack frame with its spill stores and loads."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)[:200]}
            out.append(cur)
        elif cur is not None and "spill" in line:
            cur["frame"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["used"] = line.split(":", 1)[-1].strip()
    return out


def mma_counts(path) -> tuple[int, int]:
    """wgmma (SASS HGMMA) and mma.sync (SASS HMMA) instructions in a built
    library."""
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or str(Path(_nvcc_dir()) / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout.splitlines()
    return sum("HGMMA" in ln for ln in sass), sum("HMMA" in ln for ln in sass)


def _nvcc_dir() -> str:
    from pathlib import Path

    from mlmicroservicetemplate_tpu_torch.ops._build import nvcc

    return str(Path(nvcc()).parent)


def phase_build(require_mma: bool = True) -> None:
    """nvcc builds every kernel source; ptxas's report per kernel and the
    HGMMA and HMMA counts per library are printed; K1's and K4's libraries
    (the shared wgmma loop) must hold HGMMA instructions, K2's and K3's
    (mma.sync for the dense bf16 cache) HMMA."""
    from mlmicroservicetemplate_tpu_torch.ops import _build

    t0 = time.monotonic()
    built = _build.build()
    libraries = []
    for b in built:
        hgmma, hmma = mma_counts(b.path)
        libraries.append({"name": b.name, "seconds": b.seconds, "hgmma": hgmma, "hmma": hmma,
                          "ptxas": ptxas_report(b.log),
                          "warnings": sorted({ln.strip()[:240] for ln in b.log.splitlines()
                                              if "warning" in ln.lower()})})
    emit("build", seconds=time.monotonic() - t0, libraries=libraries)
    for lib in libraries if require_mma else ():
        if lib["name"] in WGMMA_LIBRARIES and lib["hgmma"] == 0:
            raise AssertionError(f"{lib['name']}: no HGMMA instruction in the built library")
        if lib["name"] in MMA_LIBRARIES and lib["hmma"] == 0:
            raise AssertionError(f"{lib['name']}: no HMMA instruction in the built library")
    return libraries


def k1_mask(b: int, s: int, layout: str):
    """K1's key mask on the card.  pad: row 1 padded from a third of S, row
    2 without a valid key (B > 2).  ragged: every row's valid prefix ends at
    another place, most inside a 128-key tile.  interior: rows whose valid
    keys leave whole 128-key tiles masked between them (and a row valid
    only in its last tile)."""
    import torch

    mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
    if layout == "pad" and b > 2:
        mask[1, s // 3:] = 0  # a padded row
        mask[2, :] = 0  # an all-masked row, as a padded batch row is
    elif layout == "ragged":
        for i in range(b):
            mask[i, max(1, s * RAGGED[i % len(RAGGED)] // 1000):] = 0
    elif layout == "interior":
        mask[0, 100:s - s // 3] = 0
        mask[1, : s - 50] = 0
        mask[2, 130:] = 0
        mask[2, s - 7:] = 1
    return mask


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F

    from mlmicroservicetemplate_tpu_torch.ops.attention import (
        fused_attention,
        fused_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    headline = None
    cases = [(b, s, False, "pad") for b, s in ((1, 32), (8, 128), (32, 512))] + [
        (8, 128, True, "pad"), (8, 512, False, "ragged"), (8, 512, False, "interior"),
        (8, 512, True, "interior")]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, s, with_bias, layout in cases:
            q, k, v = (
                torch.randn(b, s, HEADS, HEAD_DIM, device="cuda", generator=gen).to(dtype)
                for _ in range(3)
            )
            mask = k1_mask(b, s, layout)
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
            if b > 2 and layout == "pad":  # the all-masked row is the plain mean of v
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
                dtype=name, shape=[b, s, HEADS, HEAD_DIM], bias=with_bias, mask=layout,
                max_abs_err=max_err, tol=f"atol=rtol={tol}", ok=ok,
                kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                **rates(mask, kernel_ms),
            )
            emit("kernel fused_attention", **row)
            if not ok:
                raise AssertionError(f"fused_attention disagrees with its plain version: {row}")
            if name == "bfloat16" and (b, s, with_bias, layout) == (32, 512, False, "pad"):
                headline = row
    return headline


# K1's and K4's instantiations of the shared wgmma loop by their mangled
# Op (EncoderOp<bias type, tiles>), and K1's f32 kernel (which takes a bias
# as an argument): a label, and the bias dtype and tiling its library's
# config query takes (None: not the loop, no query).
SM90_VARIANTS = (
    ("EncoderOpIvLb0E", "K1 no bias", (-1, 0)),
    ("EncoderOpIfLb0E", "K1 f32 bias, per-element", (0, 0)),
    ("EncoderOpI13__nv_bfloat16Lb0E", "K1 bf16 bias, per-element", (1, 0)),
    ("EncoderOpI13__nv_bfloat16Lb1E", "K1 bf16 bias, smem tile", (1, 1)),
    ("fused_attention_f32_kernel", "K1 f32 kernel (bias or not)", None),
    ("HopOp", "K4 ring hop", "ring_hop"),
)


def kernel_config(library: str, key, seq: int) -> dict:
    """The loop's stages, dynamic shared memory, CTAs an SM (the occupancy
    calculator) and launch-bound CTAs for one instantiation at ``seq``
    keys, from the library's config query."""
    import ctypes

    import torch

    from mlmicroservicetemplate_tpu_torch.ops._build import load_library

    lib = load_library(library)
    out = (ctypes.c_int * 4)()
    dev = torch.cuda.current_device()
    if key == "ring_hop":
        lib.ring_hop_config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        rc = lib.ring_hop_config(seq, dev, out)
    else:
        lib.fused_attention_config.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        rc = lib.fused_attention_config(key[0], key[1], seq, dev, out)
    if rc != 0:
        raise RuntimeError(f"{library}: config query failed ({rc})")
    return {"seq": seq, "stages": out[0], "smem_bytes": out[1], "ctas_per_sm": out[2],
            "launch_bound_ctas": out[3]}


def bias_read(q, bias) -> str:
    """How ``fused_attention`` on the card reads ``bias`` for ``q``, by the
    library's own rule (``fused_attention_bias_tiled``): "smem tile" (a bf16 bias with 16-byte aligned
    base and rows, as TMA tiles through shared memory) or "per-element"
    (one load a score)."""
    import ctypes

    import torch

    from mlmicroservicetemplate_tpu_torch.ops._build import load_library

    lib = load_library("fused_attention")
    fn = lib.fused_attention_bias_tiled
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int]
    code = {torch.float32: 0, torch.bfloat16: 1}
    tiled = fn(code[q.dtype], code[bias.dtype], bias.data_ptr(), bias.stride(1),
               bias.stride(2), q.shape[1])
    return "smem tile" if tiled else "per-element"


def bias_variants(libraries) -> list[dict]:
    """ptxas's registers, barriers and spills of K1's kernels (each bias
    variant, the no-bias one, the f32 kernel) and of K4's, with each loop
    instantiation's stages, dynamic shared memory and CTAs an SM at S=512
    (K4 at its 2048-key headline)."""
    out = []
    for lib in libraries or ():
        if lib["name"] not in WGMMA_LIBRARIES:
            continue
        for k in lib.get("ptxas", []):
            hit = next((v for v in SM90_VARIANTS if v[0] in k["kernel"]), None)
            if hit is None:
                continue
            row = {"variant": hit[1], **k}
            if hit[2] is not None:
                seq = 2048 if hit[2] == "ring_hop" else 512
                row.update(kernel_config(lib["name"], hit[2], seq))
            out.append(row)
    return out


# K1's widths at T5's shape: 64, a partial key tile, and 128 and 512, whole
# tiles, as every seq bucket of the T5 phases and every multiple of 128 a
# prompt past the largest bucket is served at; and two widths whose last key
# tile is partial and whose bf16 bias rows (36 and 834 bytes) are not whole
# 16-byte words, as a SEQ_BUCKETS entry may be.
T5_K1_SEQS = (18, 64, 128, 417, 512)


def phase_t5_kernel(libraries) -> dict:
    """K1 at T5-small's shape (H=8, D=64) with its position bias: bf16 and
    f32, B in {1, 8, 32}, S in ``T5_K1_SEQS``, the bias in q's type and
    ``scale=1.0``, on unpadded and padded masks; against its plain version,
    with CUDA-event ms, device µs (bf16 at S 128 and 512), the bound over
    q, k, v, mask, bias
    and output bytes, and SDPA with the same additive bias folded into its
    ``attn_mask`` as the library time.  Returns the bf16 B=32, S=512 padded
    row with the bias variants' registers and spills."""
    import torch
    import torch.nn.functional as F

    from mlmicroservicetemplate_tpu_torch.ops.attention import (
        fused_attention,
        fused_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(10)
    headline = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, s, layout in [(b, s, m) for b in (1, 8, 32) for s in T5_K1_SEQS
                             for m in ("none", "pad")]:
            q, k, v = (torch.randn(b, s, T5_HEADS, HEAD_DIM, device="cuda",
                                   generator=gen).to(dtype) for _ in range(3))
            bias = torch.randn(1, T5_HEADS, s, s, device="cuda", generator=gen).to(dtype)
            mask = k1_mask(b, s, layout)
            if layout == "pad" and b <= 2:
                mask[0, 2 * s // 3:] = 0
            out = fused_attention(q, k, v, mask, bias, 1.0)
            torch.cuda.synchronize()
            ref = fused_attention_ref(q.float(), k.float(), v.float(), mask, bias.float(), 1.0)
            diff = (out.float() - ref).abs()
            tol = KERNEL_TOL[name]
            ok = bool(torch.isfinite(out).all()) and bool((diff <= tol + tol * ref.abs()).all())
            iters = 20 if s >= 512 else 100
            add = torch.where(mask[:, None, None, :] != 0, 0.0, -1e9).to(dtype) + bias
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bound_ms, bound_by = attention_bound(b, s, dtype, bias, heads=T5_HEADS)
            kernel_ms = cuda_ms(lambda: fused_attention(q, k, v, mask, bias, 1.0), iters)
            row = dict(
                dtype=name, shape=[b, s, T5_HEADS, HEAD_DIM], bias=name, scale=1.0,
                bias_path=bias_read(q, bias),
                mask=layout, max_abs_err=diff.max().item(), tol=f"atol=rtol={tol}", ok=ok,
                kernel_ms=kernel_ms,
                device_us=(device_us(lambda: fused_attention(q, k, v, mask, bias, 1.0))
                           if name == "bfloat16" and s in (128, 512) else None),
                plain_ms=cuda_ms(lambda: fused_attention_ref(q, k, v, mask, bias, 1.0),
                                 iters),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=add, scale=1.0), iters),
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                **rates(mask, kernel_ms, heads=T5_HEADS),
            )
            emit("kernel fused_attention t5", **row)
            if not ok:
                raise AssertionError(f"fused_attention with T5's bias disagrees with its "
                                     f"plain version: {row}")
            if name == "bfloat16" and (b, s, layout) == (32, 512, "pad"):
                headline = row
    headline["bias_variants_ptxas"] = bias_variants(libraries)
    emit("kernel fused_attention t5 registers", variants=headline["bias_variants_ptxas"])
    return headline


def decode_mask(b: int, t: int, layout: str):
    """K2's key mask on the card.  pad: row 0 valid for a third of T.
    prefix8: every row valid for the first eighth of T.  last_tile: every
    row valid only in the last 64-key tile (from a row-dependent key of
    it).  In each, for B > 1, row 1 holds no valid key."""
    import torch

    mask = torch.zeros(b, t, dtype=torch.int32, device="cuda")
    if layout == "pad":
        mask[:] = 1
        mask[0, t // 3:] = 0
    elif layout == "prefix8":
        mask[:, : max(1, t // 8)] = 1
    elif layout == "last_tile":
        last = (t - 1) // 64 * 64
        for i in range(b):
            mask[i, min(t - 1, last + i % 7):] = 1
    if b > 1:
        mask[1, :] = 0
    return mask


def decode_case(gen, kind: str, b: int, t: int, layout: str = "pad",
                heads: tuple = (LLAMA_HEADS, LLAMA_KV_HEADS)):
    """Decode-attention inputs on the card: q [B, H, D], a [B, T, KVH, D]
    cache (dense in ``kind``, or int8 with bf16 scales and a bf16 q), and
    a ``decode_mask`` of ``layout``; (H, KVH) = ``heads``."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models.common import kv_quantize

    qdtype = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn(b, heads[0], HEAD_DIM, device="cuda", generator=gen).to(qdtype)
    k, v = (torch.randn(b, t, heads[1], HEAD_DIM, device="cuda", generator=gen)
            for _ in range(2))
    mask = decode_mask(b, t, layout)
    if kind != "int8":
        return q, k.to(qdtype), v.to(qdtype), mask, None, None
    (k8, ks), (v8, vs) = kv_quantize(k), kv_quantize(v)
    return q, k8, v8, mask, ks.to(torch.bfloat16), vs.to(torch.bfloat16)


def decode_bound(q, k, v, mask, ks, vs, kind: str) -> tuple[float, str]:
    """K2, counting what this mask needs, each byte once: a row with a valid
    key needs the K and V (and scales) of its valid keys, since every other
    key weighs exactly 0; a row with none, whose output is the plain mean
    of V, its V (and scales); q, the mask, the output written.  Operations:
    4·R·D per valid key and KV head (q·k and p·v), D per position of a row
    with no valid key."""
    b, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    per_pos = kvh * d * k.element_size() + (kvh * ks.element_size() if ks is not None else 0)
    live = mask.ne(0).sum(dim=1)
    n_valid = int(live.sum())
    dead = int((live == 0).sum())
    nbytes = 2 * n_valid * per_pos + dead * t * per_pos
    nbytes += 2 * q.numel() * q.element_size() + mask.numel() * mask.element_size()
    return bound(nbytes, 4 * h * d * n_valid + dead * t * kvh * d, kind)


def profiler_primer() -> None:
    """Inside a started torch.profiler: PRIMER_KERNELS short device kernels,
    waited for, then PROFILER_SETTLE_S on the host, before the traced work.
    A long-lived process's traces have lost their first ~20 device records
    (a GPT-2 chunk's trace began at its first layer's norm, a spin kernel
    before it missing too), so those records are the primer's."""
    import torch

    for _ in range(PRIMER_KERNELS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    time.sleep(PROFILER_SETTLE_S)


def device_us(fn, reps: int = 20) -> float | None:
    """Device time of one call of ``fn`` in microseconds: the kernels
    ``torch.profiler`` records over ``reps`` calls (for the port's wrappers
    the split kernel and the combine), summed, over ``reps``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then records no device kernel: again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_primer()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not PRIMER_KERNEL.search(e.name))
        if us:
            return us / reps
    return None


def host_us(fn, reps: int = 50) -> float:
    """Host time of one call of ``fn`` in microseconds: ``reps`` calls back
    to back with no synchronisation between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


# K2's cases beyond the base grid (dtype x B in {1, 8, 32} x T in {96, 576,
# 2048}, pad masks, TinyLlama's heads): (dtype, B, T, mask layout[, heads]).
# GPT-2's, at one query head per KV head: every dtype at B in {1, 8, 16} over
# a 320-key cache (the loop's slot width: 256-token prompts + 64 decode
# positions), a padded row and (B > 1) a row with no valid key; then valid
# prefixes and last-tile keys.
GPT2_DECODE_CASES = tuple(
    (kind, b, 320, "pad", GPT2_HEADS) for kind in ("bfloat16", "float32", "int8")
    for b in (1, 8, 16)) + (
    ("bfloat16", 16, 320, "prefix8", GPT2_HEADS),
    ("bfloat16", 16, 1024, "last_tile", GPT2_HEADS),
)
DECODE_EXTRA_CASES = (
    ("bfloat16", 8, 576, "prefix8"),
    ("bfloat16", 8, 576, "last_tile"),
    ("bfloat16", 8, 40, "pad"),
    ("bfloat16", 32, 2048, "prefix8"),
    ("bfloat16", 32, 2048, "last_tile"),
    ("float32", 8, 40, "pad"),
    ("float32", 8, 576, "last_tile"),
    ("int8", 8, 576, "last_tile"),
    ("int8", 32, 2048, "prefix8"),
)


def phase_decode_kernel() -> tuple[dict, dict]:
    """K2 against its plain version over the cases above; returns the
    headline rows: TinyLlama's (bf16, B=8, T=576) and GPT-2's (bf16, B=16,
    T=320)."""
    import torch
    import torch.nn.functional as F

    from mlmicroservicetemplate_tpu_torch.ops.attention import (
        decode_attention,
        decode_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    headline = gpt2_headline = None
    grid = [(kind, b, t, "pad") for kind in ("bfloat16", "float32", "int8")
            for b in (1, 8, 32) for t in (96, 576, 2048)]
    for kind, b, t, layout, *heads in grid + list(DECODE_EXTRA_CASES) + list(GPT2_DECODE_CASES):
        heads = tuple(heads[0]) if heads else (LLAMA_HEADS, LLAMA_KV_HEADS)
        rep = heads[0] // heads[1]
        q, k, v, mask, ks, vs = decode_case(gen, kind, b, t, layout, heads)
        out = decode_attention(q, k, v, mask, ks, vs)
        torch.cuda.synchronize()
        ref = decode_attention_ref(
            q.float(), k if ks is not None else k.float(),
            v if vs is not None else v.float(), mask,
            None if ks is None else ks.float(), None if vs is None else vs.float(),
        )
        diff = (out.float() - ref).abs()
        tol = KERNEL_TOL[kind]
        ok = bool(torch.isfinite(out).all()) and bool((diff <= tol + tol * ref.abs()).all())
        # dense (or dequantized) cache at H heads, for the masked-row check
        # and the yardstick
        vf = v.float() if vs is None else v.float() * vs.float()
        if b > 1:  # the all-masked row is the plain mean of its group's V
            uniform = vf[1].mean(0).repeat_interleave(rep, dim=0)
            ok = ok and bool(((out[1].float() - uniform).abs() <= tol * 4).all())
        iters = 50 if b * t >= 32 * 576 else 200

        def kernel():
            return decode_attention(q, k, v, mask, ks, vs)

        kernel_ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, mask, ks, vs), iters)
        kf = k.float() if ks is None else k.float() * ks.float()
        kt, vt = (x.to(q.dtype).transpose(1, 2).repeat_interleave(rep, dim=1) for x in (kf, vf))
        add = torch.where(mask[:, None, None, :] != 0, 0.0, -1e9).to(q.dtype)
        q4 = q[:, :, None]

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=add)

        library_ms = cuda_ms(library, iters)
        bound_ms, bound_by = decode_bound(q, k, v, mask, ks, vs, kind)
        row = dict(
            dtype=kind, shape=[b, t, *heads, HEAD_DIM], mask=layout,
            max_abs_err=diff.max().item(), tol=f"atol=rtol={tol}", ok=ok,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            device_us=device_us(kernel), library_device_us=device_us(library),
            host_us=host_us(kernel), bound_us=bound_ms * 1e3, bound_by=bound_by,
        )
        emit("kernel decode_attention", **row)
        if not ok:
            raise AssertionError(f"decode_attention disagrees with its plain version: {row}")
        if (kind, b, t, layout, heads) == ("bfloat16", 8, 576, "pad", (32, 4)):
            headline = row
        if (kind, b, t, layout, heads) == ("bfloat16", 16, 320, "pad", GPT2_HEADS):
            gpt2_headline = row
    return headline, gpt2_headline


def paged_case(gen, kind: str, b: int, t: int, layout: str = "pad",
               heads: tuple = (LLAMA_HEADS, LLAMA_KV_HEADS)):
    """Paged decode-attention inputs on the card at block size PAGE: q
    [B, H, D]; pools of B·T + 4 blocks (dense in ``kind``, or int8 with
    bf16 scale pools and a bf16 q); a shuffled table.  pad: each row's
    leading keys valid (half to all of them), row 0's table ending in a
    third of sentinel entries (their keys invalid).  short: each row valid
    for 1 to 3 blocks' worth of keys, its table past them sentinels, as the
    loop's rows are.  For B > 1, row 1 holds no valid key (short: its table
    half sentinels).  (H, KVH) = ``heads``."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models.common import kv_quantize

    nb = b * t + 4
    qdtype = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn(b, heads[0], HEAD_DIM, device="cuda", generator=gen).to(qdtype)
    k, v = (torch.randn(nb, PAGE, heads[1], HEAD_DIM, device="cuda", generator=gen)
            for _ in range(2))
    table = torch.randperm(nb, device="cuda", generator=gen)[: b * t].reshape(b, t)
    table = table.to(torch.int32)
    keys = t * PAGE
    pos = torch.arange(keys, device="cuda")[None, :]
    if layout == "short":
        lengths = torch.randint(1, 3 * PAGE + 1, (b,), device="cuda", generator=gen)
        valid = (pos < lengths[:, None]).to(torch.int32)
        blocks = (lengths + PAGE - 1) // PAGE
        table[torch.arange(t, device="cuda")[None, :] >= blocks[:, None]] = nb
        if b > 1:
            valid[1] = 0
            table[1, t // 2:] = nb
    else:
        lengths = torch.randint(keys // 2, keys + 1, (b,), device="cuda", generator=gen)
        valid = (pos < lengths[:, None]).to(torch.int32)
        tail = max(1, t // 3)
        table[0, t - tail:] = nb
        valid[0, (t - tail) * PAGE:] = 0
        if b > 1:
            valid[1] = 0
    if kind != "int8":
        return q, k.to(qdtype), v.to(qdtype), table, valid, None, None
    (k8, ks), (v8, vs) = kv_quantize(k), kv_quantize(v)
    return q, k8, v8, table, valid, ks.to(torch.bfloat16), vs.to(torch.bfloat16)


def paged_bound(q, k, table, valid, ks, kind: str) -> tuple[float, str]:
    """K3: the bytes this run's data needs, each read once: the K and V
    (and scales) of every valid key; for a row with no valid key, whose
    output is the plain mean of its gathered values, the V (and scales) of
    each distinct block its table names, sentinels clamped; q, the table
    and key_valid; the output written once.  Operations: 4·H·D per valid
    key (q·k and p·v), 2·H·D per position of a row with no valid key."""
    b, h, d = q.shape
    kvh = k.shape[2]
    per_pos = kvh * d * k.element_size()
    if ks is not None:
        per_pos += kvh * ks.element_size()
    live = valid.sum(dim=1)
    n_valid = int(live.sum())
    nbytes, ops = 2 * n_valid * per_pos, 4 * h * d * n_valid
    for row in (live == 0).nonzero().flatten().tolist():
        blocks = table[row].clamp(max=k.shape[0] - 1).unique().numel()
        nbytes += blocks * PAGE * per_pos
        ops += 2 * h * d * table.shape[1] * PAGE
    nbytes += 2 * q.numel() * q.element_size() + table.numel() * 4 + valid.numel() * 4
    return bound(nbytes, ops, kind)


# K3's cases beyond the base grid (dtype x B in {1, 8, 16} x T in {6, 36,
# 128} blocks, pad layout, TinyLlama's heads): (dtype, B, T, layout[,
# heads]).  GPT-2's at R = 1: every dtype at B in {1, 8, 16} over tables of
# 20 blocks (the loop's: 320 keys), then the loop's short rows.
GPT2_PAGED_CASES = tuple(
    (kind, b, 20, "pad", GPT2_HEADS) for kind in ("bfloat16", "float32", "int8")
    for b in (1, 8, 16)) + (
    ("bfloat16", 16, 20, "short", GPT2_HEADS),
    ("int8", 16, 20, "short", GPT2_HEADS),
)
PAGED_EXTRA_CASES = (
    ("bfloat16", 16, 128, "short"),
    ("bfloat16", 1, 128, "short"),
    ("bfloat16", 16, 36, "short"),
    ("float32", 8, 128, "short"),
    ("int8", 16, 128, "short"),
)


def phase_paged_kernel() -> tuple[dict, dict]:
    """K3 against its plain version over the cases above; returns the
    headline rows: TinyLlama's (bf16, B=16, 36 blocks) and GPT-2's (bf16,
    B=16, 20 blocks)."""
    import torch
    import torch.nn.functional as F

    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import (
        gather_pages,
        paged_attention_ref,
        paged_decode_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    headline = gpt2_headline = None
    grid = [(kind, b, t, "pad") for kind in ("bfloat16", "float32", "int8")
            for b in (1, 8, 16) for t in (6, 36, 128)]
    for kind, b, t, layout, *heads in grid + list(PAGED_EXTRA_CASES) + list(GPT2_PAGED_CASES):
        heads = tuple(heads[0]) if heads else (LLAMA_HEADS, LLAMA_KV_HEADS)
        rep = heads[0] // heads[1]
        q, k, v, table, valid, ks, vs = paged_case(gen, kind, b, t, layout, heads)
        out = paged_decode_attention(q, k, v, table, valid, PAGE, ks, vs)
        torch.cuda.synchronize()
        ref = paged_attention_ref(
            q.float(), k if ks is not None else k.float(),
            v if vs is not None else v.float(), table, valid, PAGE,
            None if ks is None else ks.float(), None if vs is None else vs.float(),
        )
        diff = (out.float() - ref).abs()
        tol = KERNEL_TOL[kind]
        ok = bool(torch.isfinite(out).all()) and bool((diff <= tol + tol * ref.abs()).all())
        vf = v.float() if vs is None else v.float() * vs.float()
        if b > 1:  # no valid key: the plain mean of the row's gathered V
            vrow = gather_pages(vf, table[1:2], PAGE)[0]
            uniform = vrow.mean(0).repeat_interleave(rep, dim=0)
            ok = ok and bool(((out[1].float() - uniform).abs() <= tol * 4).all())
        iters = 50 if b * t >= 16 * 36 else 200

        def kernel():
            return paged_decode_attention(q, k, v, table, valid, PAGE, ks, vs)

        kernel_ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(
            lambda: paged_attention_ref(q, k, v, table, valid, PAGE, ks, vs), iters)
        kf = k.float() if ks is None else k.float() * ks.float()
        kq, vq = kf.to(q.dtype), vf.to(q.dtype)
        add = torch.where(valid[:, None, None, :] != 0, 0.0, -1e30).to(q.dtype)
        q4 = q[:, :, None]

        def library():
            kt, vt = (gather_pages(x, table, PAGE).transpose(1, 2)
                      .repeat_interleave(rep, dim=1) for x in (kq, vq))
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=add)

        library_ms = cuda_ms(library, iters)
        bound_ms, bound_by = paged_bound(q, k, table, valid, ks, kind)
        row = dict(
            dtype=kind, shape=[b, t, PAGE, *heads, HEAD_DIM], mask=layout,
            max_abs_err=diff.max().item(), tol=f"atol=rtol={tol}", ok=ok,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            device_us=device_us(kernel), library_device_us=device_us(library),
            host_us=host_us(kernel), bound_us=bound_ms * 1e3, bound_by=bound_by,
        )
        emit("kernel paged_decode_attention", **row)
        if not ok:
            raise AssertionError(
                f"paged_decode_attention disagrees with its plain version: {row}")
        if (kind, b, t, layout, heads) == ("bfloat16", 16, 36, "pad", (32, 4)):
            headline = row
        if (kind, b, t, layout, heads) == ("bfloat16", 16, 20, "pad", GPT2_HEADS):
            gpt2_headline = row
    return headline, gpt2_headline


def ring_hop_case(gen, dtype, b: int, s: int, state: str, layout: str = "pad"):
    """Ring-hop inputs on the card: q, k, v [B, S, H, D] in ``dtype``, a
    key mask (``k1_mask``'s layouts; pad: row 0 padded from a third of S
    and, for B > 1, row 1 without a valid key), and a carried (o, m, l):
    fresh (0, -inf, 0), mid-ring (random o, finite m, positive l) or
    masked_mid (mid-ring, with m exactly -1e9 on batch row 1, whose block
    holds no valid key: the state after an earlier all-masked block)."""
    import torch

    q, k, v = (torch.randn(b, s, HEADS, HEAD_DIM, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    if layout == "pad":
        mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
        mask[0, s // 3:] = 0
        if b > 1:
            mask[1] = 0
    else:
        mask = k1_mask(b, s, layout)
    if state == "fresh":
        o = torch.zeros(b, HEADS, s, HEAD_DIM, device="cuda")
        m = torch.full((b, HEADS, s), float("-inf"), device="cuda")
        l = torch.zeros(b, HEADS, s, device="cuda")
    else:
        o = torch.randn(b, HEADS, s, HEAD_DIM, device="cuda", generator=gen)
        m = torch.randn(b, HEADS, s, device="cuda", generator=gen)
        l = torch.rand(b, HEADS, s, device="cuda", generator=gen) + 0.5
        if state == "masked_mid":
            m[1] = -1e9
    return q, k, v, mask, o, m, l


def ring_hop_bound(mask, state: str, dtype, fresh: bool = False,
                   final: bool = False) -> tuple[float, str]:
    """K4, counting what this mask needs.  Once a row has a valid key, a
    masked key weighs exp(-1e9 - m) = 0 exactly in f32, so a batch row with
    n valid keys needs q, the n keys' k and v, the mask, the carried o, m
    and l read (unless ``fresh``) and written (or, ``final``, the output
    o / l written in q's type), and 4·H·S·n·D operations (q·k and p·v).
    A batch row with no valid key from m = -inf (a fresh state) makes every
    query row the block's plain sum of v: v read, the result written, H·S·D
    additions; from m = -1e9 (masked_mid) o + Σv and l + S: v and the state
    read, the result written; from a finite m exp(-1e9 - m) = 0 and the
    state stands: nothing to move, or, final, o / l of the state."""
    b, s = mask.shape
    el = 2 if str(dtype).endswith("bfloat16") else 4
    block = s * HEADS * HEAD_DIM  # elements of one batch row's q, k, v or output
    carried = HEADS * s * (HEAD_DIM + 2) * 4  # one batch row's o, m, l in f32
    written = block * el if final else carried
    nbytes, ops = mask.numel() * mask.element_size(), 0
    for n in mask.ne(0).sum(dim=1).tolist():
        if n:
            nbytes += block * el + 2 * n * HEADS * HEAD_DIM * el + written
            nbytes += 0 if fresh else carried
            ops += 4 * HEADS * s * n * HEAD_DIM
        elif fresh or state == "fresh":
            nbytes += block * el + written
            ops += block
        elif state == "masked_mid":
            nbytes += block * el + carried + written
            ops += 2 * block
        elif final:
            nbytes += carried + written
            ops += block
    return bound(nbytes, ops, str(dtype).split(".")[-1])


# K4's cases beyond the base grid (dtype x B in {1, 8} x S_loc in {96, 512,
# 2048} x fresh / mid, flags off): (S_loc, state, mask layout, fresh flag,
# out), at B = 8.  fresh + out is the SP=1 hop every bert-long layer runs;
# fresh alone and out alone are a multi-shard ring's first and last hops.
RING_EXTRA_CASES = (
    (2048, "fresh", "pad", True, True),
    (96, "fresh", "pad", True, True),
    (512, "fresh", "pad", True, False),
    (512, "mid", "pad", False, True),
    (2048, "fresh", "ragged", False, False),
    (2048, "mid", "interior", False, False),
    (512, "fresh", "interior", True, True),
    (2048, "masked_mid", "pad", False, False),
    (96, "masked_mid", "pad", False, True),
)


def phase_ring_kernel() -> tuple[dict, dict]:
    """K4 against its plain version; returns the headline row (bf16, B=8,
    S_loc=2048, from a fresh carried state, flags off: the original call) and the
    SP=1 serving hop's row (the same inputs, fresh and final)."""
    import torch
    import torch.nn.functional as F

    from mlmicroservicetemplate_tpu_torch.parallel.ring import ring_hop, ring_hop_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    scale = 1.0 / HEAD_DIM ** 0.5
    headline = serving = None
    grid = [(b, s, state, "pad", False, False)
            for b in (1, 8) for s in (96, 512, 2048) for state in ("fresh", "mid")]
    grid += [(8, *case) for case in RING_EXTRA_CASES]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        tol, ctx_tol = KERNEL_TOL[name], RING_CTX_TOL[name]
        for b, s, state, layout, fresh, final in grid:
            q, k, v, mask, o, m, l = ring_hop_case(gen, dtype, b, s, state, layout)
            out = torch.empty(q.shape, dtype=dtype, device="cuda") if final else None
            # fresh: the kernel must not read the state, so it is handed junk
            junk = [torch.full_like(x, float("nan")) for x in (o, m, l)] if fresh else None
            got = ring_hop(q, k, v, mask, *(junk or (x.clone() for x in (o, m, l))), scale,
                           fresh=fresh, out=out)
            torch.cuda.synchronize()
            want = ring_hop_ref(q.float(), k.float(), v.float(), mask, o, m, l, scale,
                                fresh=fresh, out=torch.empty(q.shape, device="cuda")
                                if final else None)
            if final:  # the normalised context in q's type
                ok = bool(torch.isfinite(got).all())
                ctx, ctx_want = got.float().transpose(1, 2), want.transpose(1, 2)
                errs = {}
            else:
                ok = all(bool(torch.isfinite(g).all()) for g in got)
                errs = {part: (g - w).abs().max().item()
                        for part, g, w in zip("oml", got, want)}
                # m and l against the reference; o, the unnormalised sum
                # of up to S_loc terms of p·v, through o / l: the ring's
                # output and the scale its bf16 error lives on.
                for g, w in zip(got[1:], want[1:]):
                    ok = ok and bool(((g - w).abs() <= tol + tol * w.abs()).all())
                ctx, ctx_want = (x[0] / x[2][..., None] for x in (got, want))
            ctx_err = (ctx - ctx_want).abs()
            ok = ok and bool((ctx_err <= ctx_tol + ctx_tol * ctx_want.abs()).all())
            if b > 1 and layout == "pad" and state == "fresh":
                # no valid key: o / l is the plain mean of v.  p = 1 exactly
                # for every key, so only f32 summation order (and, final,
                # the output's rounding) separates the two: held to the
                # mean's own scale.
                mean = v[1].float().mean(0)[:, None, :]  # [H, 1, D]
                ok = ok and bool(((ctx[1] - mean).abs() <= ctx_tol * mean.abs().max()).all())
            if state == "masked_mid" and not final:  # from m = -1e9: m stays -1e9
                ok = ok and bool((got[1][1] == -1e9).all())
            iters = 20 if s >= 2048 else 50
            bufs = [x.clone() for x in (o, m, l)]
            kernel_ms = cuda_ms(
                lambda: ring_hop(q, k, v, mask, *bufs, scale, fresh=fresh, out=out), iters)
            plain_ms = cuda_ms(
                lambda: ring_hop_ref(q, k, v, mask, o, m, l, scale, fresh=fresh,
                                     out=torch.empty_like(q) if final else None), iters)
            add = torch.where(mask[:, None, None, :] != 0, 0.0, -1e9).to(dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add), iters)
            bound_ms, bound_by = ring_hop_bound(mask, state, dtype, fresh, final)
            err_ctx = ctx_err.max().item()
            row = dict(
                dtype=name, shape=[b, s, HEADS, HEAD_DIM], state=state, mask=layout,
                fresh=fresh, final=final,
                max_abs_err=max(err_ctx, errs.get("m", 0.0), errs.get("l", 0.0)),
                err_o=errs.get("o"), err_m=errs.get("m"), err_l=errs.get("l"),
                err_o_over_l=err_ctx,
                tol=f"m, l: atol=rtol={tol}; o / l: atol=rtol={ctx_tol}", ok=ok,
                kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_us=bound_ms * 1e3,
                bound_by=bound_by,
                **rates(mask, kernel_ms),
            )
            emit("kernel ring_hop", **row)
            if not ok:
                raise AssertionError(f"ring_hop disagrees with its plain version: {row}")
            key = (name, b, s, state, layout)
            if key == ("bfloat16", 8, 2048, "fresh", "pad"):
                if not fresh and not final:
                    headline = row
                elif fresh and final:
                    serving = row
    return headline, serving


def phase_kernel_graphs() -> dict:
    """Each hand-written kernel captured alone in a CUDA graph at a serving
    shape, then replayed twice on new inputs written into its static ones,
    against an eager call on the same inputs: outputs equal bit for bit,
    and the launch counter moving by the one launch its capture recorded.
    The kernels launch from libraries that nvcc links to their own static
    CUDA runtime (``ops/_build.py``), on PyTorch's capturing stream."""
    import torch

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention, fused_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.parallel.ring import ring_hop
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import capture_graph

    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16

    def k1():
        q, k, v = (torch.randn(8, 128, HEADS, HEAD_DIM, device="cuda", generator=gen).to(bf16)
                   for _ in range(3))
        return (q, k, v, k1_mask(8, 128, "pad")), lambda a: fused_attention(*a)

    def k2():
        return decode_case(gen, "bfloat16", 8, 576), lambda a: decode_attention(*a)

    def k3():
        q, kp, vp, table, valid, _, _ = paged_case(gen, "bfloat16", 16, 36)
        return (q, kp, vp, table, valid), lambda a: paged_decode_attention(*a[:5], PAGE)

    def k4():
        q, k, v, mask, *_ = ring_hop_case(gen, bf16, 2, 512, "fresh")
        return (q, k, v, mask), lambda a: ring_hop(
            *a, None, None, None, HEAD_DIM ** -0.5, fresh=True,
            out=torch.empty(a[0].shape, dtype=bf16, device="cuda"))

    rows = {}
    for name, case in (("fused_attention", k1), ("decode_attention", k2),
                       ("paged_decode_attention", k3), ("ring_hop", k4)):
        counter = {"fused_attention": fused_attention, "decode_attention": decode_attention,
                   "paged_decode_attention": paged_decode_attention, "ring_hop": ring_hop}[name]
        args, call = case()
        with torch.inference_mode():
            entry = capture_graph(f"kernel {name}", lambda: call(args), args, "cuda")
            diffs = []
            for _ in range(2):
                fresh, _ = case()
                for dst, src in zip(args, fresh):
                    if dst is not None:
                        dst.copy_(src)
                want = call(args)
                before = counter.launches
                entry.replay()
                torch.cuda.synchronize()
                if counter.launches - before != 1:
                    raise AssertionError(f"{name}: a replay counted {counter.launches - before} "
                                         "launches, its capture recorded one")
                diffs.append(float((entry.outputs.float() - want.float()).abs().max()))
        if entry.launches != {name: 1} or any(diffs):
            raise AssertionError(f"{name}: captured launches {entry.launches}, replay against "
                                 f"eager max |diff| {diffs}")
        rows[name] = {"captured_launches": entry.launches[name], "capture_s": entry.capture_s,
                      "replay_vs_eager_max_abs_diff": max(diffs),
                      "trace_one_replay": graph_trace(entry)}
    emit("kernel graphs", cudart="static, one per library (nvcc default)", **rows)
    return rows


def make_waves(rehearsal: bool):
    """Text requests in five waves of 1, 2, 5, 8 and 16, each wave longer,
    so dispatches land in several batch and seq buckets."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(0)
    words = ["serve", "batch", "token", "kernel", "queue", "model", "card", "bucket"]
    caps = (20, 50, 110, 240, 480) if not rehearsal else (20, 40, 60, 90, 110)
    waves = []
    for n, cap in zip((1, 2, 5, 8, 16), caps):
        wave = []
        for _ in range(n):
            length = int(rng.integers(cap // 2, cap))
            text = " ".join(rng.choice(words, size=length))[:length]
            wave.append(RawItem(text=text))
        waves.append(wave)
    return waves


def long_waves(rehearsal: bool):
    """Byte-tokenizer texts for bert-long in waves of 1, 2, 5 and 8, each
    wave longer (on the card up to ~2000 bytes, the 2048 bucket)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(6)
    words = ["context", "ring", "shard", "sequence", "attention", "long", "hop", "block"]
    caps = (40, 70, 100, 126) if rehearsal else (300, 700, 1300, 2040)
    waves = []
    for n, cap in zip((1, 2, 5, 8), caps):
        wave = []
        for _ in range(n):
            length = int(rng.integers(cap // 2, cap))
            text = " ".join(rng.choice(words, size=length))[:length]
            wave.append(RawItem(text=text))
        waves.append(wave)
    return waves


def check_probs(bundle, rows, ref_rows, what: str) -> tuple[float, int]:
    """Served logits against reference logits: finite, the reference's
    shape, probabilities within PROB_TOL and, where the reference's top two
    are further apart than 2·PROB_TOL, the same label.  Returns the worst
    probability error and the labels checked."""
    import numpy as np

    worst, label_checked = 0.0, 0
    for got, want in zip(rows, ref_rows):
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"bad logits row {got} (want shape {want.shape})")
        pg, pw = bundle.postprocess(got), bundle.postprocess(want)
        worst = max(worst, float(np.max(np.abs(np.array(pg["probs"]) - np.array(pw["probs"])))))
        top2 = sorted(pw["probs"])[-2:]
        if top2[1] - top2[0] > 2 * PROB_TOL:  # a closer call may flip within tolerance
            label_checked += 1
            if pg["prediction"]["label_id"] != pw["prediction"]["label_id"]:
                raise AssertionError(f"label differs from {what}: {pg} vs {pw}")
    if worst > PROB_TOL:
        raise AssertionError(f"probs differ from {what} by {worst} > {PROB_TOL}")
    return worst, label_checked


def phase_serve_long(rehearsal: bool, card_line: str):
    """bert-long through the batcher: K4 launched 12·SP² times per dispatch
    (each layer's ring: SP hops of SP shards), K1 never; every answer held
    against an f32 forward of the same weights through the plain hop."""
    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.models import bert as bert_mod
    from mlmicroservicetemplate_tpu_torch.models.registry import INIT_SEED
    from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention
    from mlmicroservicetemplate_tpu_torch.parallel.ring import ring_hop, ring_hop_ref
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    sp = 2 if rehearsal else 1
    overrides = {"MODEL_NAME": "bert-long", "DEVICE": "cpu" if rehearsal else "cuda",
                 "SP": str(sp), "BATCH_BUCKETS": "1,2,4,8",
                 "SEQ_BUCKETS": "64,128" if rehearsal else "512,1024,2048"}
    cfg, bundle, engine, batcher = build_service(overrides)
    warm_s = engine.warmup()
    waves = long_waves(rehearsal)

    ring_hop.launches = fused_attention.launches = 0
    engine.dispatches = 0
    marks = graph_marks(bundle)
    feats, rows, latencies, wall = asyncio.run(drive(batcher, bundle, waves))
    launches, k1, dispatches = ring_hop.launches, fused_attention.launches, engine.dispatches
    gdrive = graph_drive(bundle, marks, {"ring_hop": launches, "fused_attention": k1})
    want = 0 if rehearsal else LAYERS * sp * sp * dispatches
    if dispatches < 1 or launches != want or k1 != 0:
        raise AssertionError(
            f"ring_hop launched {launches} times (want {want}) and fused_attention {k1} "
            f"(want 0) over {dispatches} dispatches"
        )
    # The same weights in f32 on the same device (random init is drawn on
    # the CPU from one seed), attention through the plain hop.
    state = bert_mod.init_params(bundle.cfg, torch.Generator().manual_seed(INIT_SEED))
    ref_model = bert_mod.build_model(bundle.cfg, state, bundle.device, torch.float32)
    ref = []
    with torch.inference_mode():
        for f in feats:
            ids = torch.from_numpy(f["input_ids"][None]).to(bundle.device)
            logits = bert_mod.classify_seq_parallel(
                [ref_model], [ids], [torch.ones_like(ids)], hop=ring_hop_ref)
            ref.append(logits[0].cpu().numpy())
    del ref_model, state
    worst, label_checked = check_probs(bundle, rows, ref, "the f32 plain-hop forward")
    lat = np.array(latencies) * 1e3
    emit(
        "serve bert-long", device=str(bundle.device), card=card_line, sp=sp,
        seq_buckets=list(engine.seq_buckets), max_len=max(int(f["length"]) for f in feats),
        requests=len(rows), dispatches=dispatches, ring_hop_launches=launches,
        fused_attention_launches=k1, warmup_s=warm_s, p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)), req_per_s=len(rows) / wall,
        max_prob_err_vs_f32_plain_hop=worst, prob_tol=PROB_TOL, labels_checked=label_checked,
        graph_modes=engine.graph_modes(),
    )
    return cfg, bundle, engine, launches, feats, gdrive


def phase_ring_4shard(cfg, bundle, engine, feats, rehearsal: bool) -> int:
    """The served weights through a 4-shard placement whose shards share
    the service's device, over the largest bucket: K4 launched 12 · 4 · 4
    times a forward; probabilities within PROB_TOL of the served (one-shard
    on the card) forward of the same batch.  On the card the same placement
    also serves through an engine of its own, whose forward graph (every
    shard on one card, so captured) is held against the eager forward
    within GRAPH_LOGIT_TOL and timed beside it."""
    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine
    from mlmicroservicetemplate_tpu_torch.models.bert import classify_seq_parallel
    from mlmicroservicetemplate_tpu_torch.parallel import SeqParallelSet
    from mlmicroservicetemplate_tpu_torch.parallel.ring import ring_hop

    shards = 4
    seq = max(engine.seq_buckets)
    batch = feats[-8:]
    ids = np.zeros((len(batch), seq), np.int32)
    mask = np.zeros_like(ids)
    for i, f in enumerate(batch):
        n = int(f["length"])
        ids[i, :n], mask[i, :n] = f["input_ids"], 1
    placement = SeqParallelSet([bundle.device] * shards)
    replicas = placement.place_params(lambda dev: bundle.model)
    dtype = bundle.policy.compute_dtype

    def four():
        return classify_seq_parallel(replicas, placement.place_batch(ids),
                                     placement.place_batch(mask), dtype=dtype)

    def served():
        return bundle.forward(bundle.placement.place_batch(ids),
                              bundle.placement.place_batch(mask))

    with torch.inference_mode():
        ring_hop.launches = 0
        got = four().float().cpu().numpy()
        launches = ring_hop.launches
        want = served().float().cpu().numpy()
    timing = {}
    if not rehearsal:
        bundle4 = dataclasses.replace(
            bundle, placement=placement,
            forward=lambda i, m: classify_seq_parallel(replicas, i, m, dtype=dtype))
        engine4 = InferenceEngine(bundle4, dataclasses.replace(
            cfg, batch_buckets=(len(batch),), seq_buckets=(seq,)))
        graph_rows = np.stack(engine4.run_batch(batch))  # captures, then replays
        entry = engine_graph(engine4, "forward", (len(batch), seq))
        diff = float((np.abs(graph_rows - got).max(axis=1) / np.abs(got).max(axis=1)).max())
        if diff > GRAPH_LOGIT_TOL or entry.launches != {"ring_hop": LAYERS * shards * shards}:
            raise AssertionError(f"4-shard graph: logits {diff} x max|logit| from eager, "
                                 f"launches {entry.launches}")
        with torch.inference_mode():
            timing = eager_and_graph(four, entry.replay, 3, K4_KERNEL, "ring_hop", iters=5)
            timing["wall_ms_served"] = cuda_ms(served, 5)
        timing.update(graph_modes=engine4.graph_modes(),
                      graph_logit_diff_over_max_logit=diff,
                      graph_trace_one_replay=graph_trace(entry))
    if launches != (0 if rehearsal else LAYERS * shards * shards):
        raise AssertionError(f"ring_hop launched {launches} times over one {shards}-shard "
                             f"forward; want {LAYERS * shards * shards}")
    worst, label_checked = check_probs(bundle, list(got), list(want), "the served forward")
    emit("ring 4-shard", device=str(bundle.device), shards=shards, shape=[len(batch), seq],
         s_loc=seq // shards, ring_hop_launches=launches, max_prob_err_vs_served=worst,
         prob_tol=PROB_TOL, labels_checked=label_checked, **timing)
    return launches


def phase_forward_long(bundle, engine) -> None:
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    b, s = 8, 2048
    ids = rng.integers(5, 261, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    placement = bundle.placement
    ids_s, mask_s = placement.place_batch(ids), placement.place_batch(mask)
    entry = engine_graph(engine, "forward", (b, s))
    with torch.inference_mode():
        for static, shards in zip(entry.inputs, (ids_s, mask_s)):
            for dst, src in zip(static, shards):
                dst.copy_(src)
        out = eager_and_graph(lambda: bundle.forward(ids_s, mask_s), entry.replay, 3,
                              K4_KERNEL, "ring_hop", iters=5)
    emit("forward bert-long", shape=[b, s], sp=placement.n_devices, **out)


def resnet_pytree(cfg, seed: int) -> dict:
    """Random weights in the JAX package's ResNet layout (numpy f32, HWIO
    convs, ``[d_in, d_out]`` classifier): He-normal convs, Xavier-uniform
    classifier, and every BN's statistics and affine drawn at random, as
    ``tests/test_resnet_golden.py`` randomizes them (``bn3``, the residual
    branch's last, scaled down so activations stay O(1) through 16 blocks)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def conv(k, c_in, c_out):
        w = rng.standard_normal((k, k, c_in, c_out), dtype=np.float32)
        w *= np.float32(np.sqrt(2.0 / (k * k * c_in)))
        return {"kernel": w}

    def bn(c, lo=0.8, hi=1.2):
        return {"scale": rng.uniform(lo, hi, c).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}

    p = {"embedder": {"conv": conv(7, 3, cfg.embedding_size), "bn": bn(cfg.embedding_size)}}
    stages, c_in = [], cfg.embedding_size
    for depth, c_out in zip(cfg.depths, cfg.hidden_sizes):
        blocks = []
        for bi in range(depth):
            c_mid = c_out // cfg.reduction
            block = {"conv1": conv(1, c_in, c_mid), "bn1": bn(c_mid),
                     "conv2": conv(3, c_mid, c_mid), "bn2": bn(c_mid),
                     "conv3": conv(1, c_mid, c_out), "bn3": bn(c_out, 0.1, 0.3)}
            if bi == 0:  # the width or the resolution changes
                block["shortcut"] = {"conv": conv(1, c_in, c_out), "bn": bn(c_out)}
            blocks.append(block)
            c_in = c_out
        stages.append(blocks)
    p["stages"] = stages
    a = np.sqrt(6.0 / (c_in + cfg.num_labels))
    p["classifier"] = {"kernel": rng.uniform(-a, a, (c_in, cfg.num_labels)).astype(np.float32),
                       "bias": np.zeros(cfg.num_labels, np.float32)}
    return p


def image_waves(rehearsal: bool):
    """uint8 224x224 images (the decoded wire type) from a seed, in waves
    of 1, 2, 5, 8 and 16 (rehearsal: 1, 2 and 5) submitted at once."""
    import numpy as np

    rng = np.random.default_rng(8)
    return [[{"image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)}
             for _ in range(n)] for n in ((1, 2, 5) if rehearsal else (1, 2, 5, 8, 16))]


def check_logits(rows, ref_rows, what: str) -> tuple[float, int]:
    """Served image logits against reference logits: finite, the
    reference's shape, each row's largest error within RESNET_LOGIT_TOL of
    the reference row's largest |logit| and, where the reference's top two
    are further apart than twice that, the same top-1.  Returns the worst
    error ratio and the top-1s checked."""
    import numpy as np

    worst, checked = 0.0, 0
    for got, want in zip(rows, ref_rows):
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"bad logits row {got} (want shape {want.shape})")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        worst = max(worst, err)
        if err > RESNET_LOGIT_TOL:
            raise AssertionError(f"logits differ from {what} by {err} x max|logit| "
                                 f"> {RESNET_LOGIT_TOL}")
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 2 * RESNET_LOGIT_TOL * scale:
            checked += 1
            if int(np.argmax(got)) != int(np.argmax(want)):
                raise AssertionError(f"top-1 {np.argmax(got)} differs from {what}'s "
                                     f"{np.argmax(want)}")
    return worst, checked


def in_new_thread(fn):
    """``fn()`` on a thread of its own (cuDNN keeps its execution plans per
    thread, so its first call there builds them); returns its result."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        return pool.submit(fn).result()


def phase_serve_resnet(rehearsal: bool, card_line: str):
    """ResNet-50 at full width through the batcher: every batch bucket
    warmed in every dispatch thread (``Batcher.warm_engine``, as the app
    does), waves of uint8 images batched dynamically, each answer held
    against the port's f32 forward on the CPU on the same weights.  On the
    card the warmup of the six buckets is first timed on fresh threads:
    the process's first (cuDNN's start included), then a second thread
    with cuDNN's autotuning off and a third with it on."""
    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.models.resnet import ResNetConfig
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    overrides = {"MODEL_NAME": "resnet50", "DEVICE": "cpu" if rehearsal else "cuda"}
    if rehearsal:
        overrides["BATCH_BUCKETS"] = "1,2,4,8"
    params = resnet_pytree(ResNetConfig(), seed=0)
    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    warm = {}
    if not rehearsal:
        kept = torch.backends.cudnn.benchmark
        try:
            for key, autotune in (("warmup_s_first_thread", kept),
                                  ("warmup_s_new_thread", False),
                                  ("warmup_s_new_thread_autotune", True)):
                torch.backends.cudnn.benchmark = autotune
                warm[key] = in_new_thread(engine.warmup)
        finally:
            torch.backends.cudnn.benchmark = kept
    warm["warmup_s"] = batcher.warm_engine()
    waves = image_waves(rehearsal)
    sizes = []
    run_batch = engine.run_batch

    def recording(feats):
        sizes.append(len(feats))
        return run_batch(feats)

    engine.run_batch = recording
    engine.dispatches = 0
    marks = graph_marks(bundle)
    try:
        feats, rows, latencies, wall = asyncio.run(drive(batcher, bundle, waves, prep=dict))
    finally:
        del engine.run_batch
    gdrive = graph_drive(bundle, marks, {})
    if max(sizes) < 2:
        raise AssertionError(f"dynamic batching formed no batch above 1: {sizes}")
    _, cpu_bundle, cpu_engine, cpu_batcher = build_service(
        {**overrides, "DEVICE": "cpu", "WARMUP": "0"}, params=params)
    asyncio.run(cpu_batcher.stop())
    ref = cpu_engine.run_batch(feats)
    worst, checked = check_logits(rows, ref, "the CPU f32 run")
    lat = np.array(latencies) * 1e3
    emit("serve resnet50", device=str(bundle.device), card=card_line, requests=len(rows),
         dispatches=engine.dispatches, batch_sizes=sizes, **warm,
         p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
         img_per_s=len(rows) / wall, max_logit_err_over_max_logit=worst,
         logit_tol=RESNET_LOGIT_TOL, top1_checked=checked, graph_modes=engine.graph_modes())
    return cfg, bundle, engine, gdrive, feats


def phase_forward_resnet(bundle, engine) -> None:
    """One forward at B=1 and B=32, and B=32 with cuDNN's autotuning
    flipped, each on a fresh thread (so each setting picks its own plans):
    the first call's time (plan building), wall (CUDA events) against busy
    time, the conv kernels' share, the layout transposes a forward and the
    rate over 2 x 4.09 GMAC an image; with the heuristics' plans also the
    bucket's graph replay side by side (the BNs folded into the convs in
    both)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    kept = torch.backends.cudnn.benchmark

    def rates(b, row):
        busy, wall = row["device_busy_ms"], row["wall_ms"]
        flops = 2 * RESNET_MACS * b
        return dict(img_per_s=b / wall * 1e3, tflops_wall=flops / wall / 1e9,
                    tflops_busy=flops / busy / 1e9 if busy else None,
                    conv_share=row["conv_ms"] / busy if busy else None,
                    transposes=row.pop("counted"))

    def measure(images, graph):
        with torch.inference_mode():
            t0 = time.monotonic()
            bundle.forward(images)
            torch.cuda.synchronize()
            first_ms = (time.monotonic() - t0) * 1e3
            if graph is None:
                wall_ms = cuda_ms(lambda: bundle.forward(images), 10)
                split = profile_split(lambda: bundle.forward(images), 5, CONV_KERNEL, "conv",
                                      count=TRANSPOSE_KERNEL)
                return first_ms, {"eager": {"wall_ms": wall_ms, "busy_share":
                                            split["device_busy_ms"] / wall_ms, **split}}
            return first_ms, eager_and_graph(lambda: bundle.forward(images), graph.replay, 5,
                                             CONV_KERNEL, "conv", count=TRANSPOSE_KERNEL)

    for b, autotune in ((1, kept), (32, kept), (32, not kept)):
        images = torch.randint(0, 256, (b, 224, 224, 3), device="cuda", generator=gen,
                               dtype=torch.uint8)
        graph = None
        if autotune == kept:
            graph = engine_graph(engine, "forward_images", (b, 224, 224, 3))
            with torch.inference_mode():
                graph.inputs.copy_(images)
        torch.backends.cudnn.benchmark = autotune
        try:
            first_ms, out = in_new_thread(lambda: measure(images, graph))
        finally:
            torch.backends.cudnn.benchmark = kept
        for mode in ("eager", "graph"):
            if mode in out:
                out[mode].update(rates(b, out[mode]))
        emit("forward resnet50", batch=b, cudnn_autotune=autotune, first_call_ms=first_ms,
             **out)


def png_bytes(seed: int) -> bytes:
    """A PNG of a seeded 256x320 array (needs PIL)."""
    import io

    import numpy as np
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (256, 320, 3),
                                                         dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def multipart_file(data: bytes):
    """A multipart/form-data body with the image as its ``file`` part."""
    from aiohttp import MultipartWriter

    writer = MultipartWriter("form-data")
    writer.append(data, {"Content-Type": "image/png"}).set_content_disposition(
        "form-data", name="file", filename="image.png")
    return writer


def gen_waves(rehearsal: bool):
    """Prompts in waves of 1, 2, 5, 8 and 16 (rehearsal: 1, 2, 3, 4),
    growing so prefill lands in several seq buckets; every third request
    carries a max_tokens below MAX_DECODE_LEN, and every third (another
    one) is sampled and seeded: temperature 0.7 or 1.0, top_k in {0, 40},
    top_p in {1, 0.9}."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(1)
    words = ["decode", "cache", "prompt", "greedy", "llama", "token", "step", "wave"]
    sizes = (1, 2, 3, 4) if rehearsal else (1, 2, 5, 8, 16)
    caps = (20, 40, 60, 60) if rehearsal else (24, 50, 110, 200, 250)
    budgets = (5, 17, 30)
    waves, i = [], 0
    for n, cap in zip(sizes, caps):
        wave = []
        for _ in range(n):
            length = int(rng.integers(cap // 2, cap))
            text = " ".join(rng.choice(words, size=length))[:length]
            sampling = {}
            if i % 3 == 2:
                j = i // 3
                sampling = dict(temperature=(0.7, 1.0)[j % 2], top_k=(0, 40)[j // 2 % 2],
                                top_p=(1.0, 0.9)[j // 4 % 2], seed=1000 + i)
            wave.append(RawItem(text=text, **sampling,
                                max_tokens=budgets[i // 3 % 3] if i % 3 == 1 else None))
            i += 1
        waves.append(wave)
    return waves


async def drive(batcher, bundle, waves, prep=None):
    """Submit each wave at once and wait for it; returns (feats, rows,
    per-request latencies, wall seconds).  ``prep`` turns an item into its
    feats (default ``bundle.preprocess``)."""
    await batcher.start()
    feats, rows, latencies = [], [], []
    prep = prep or bundle.preprocess

    async def one(item):
        t0 = time.monotonic()
        f = prep(item)
        row = await batcher.submit(f)
        latencies.append(time.monotonic() - t0)
        return f, row

    try:
        t0 = time.monotonic()
        for wave in waves:
            for f, row in await asyncio.gather(*(one(item) for item in wave)):
                feats.append(f)
                rows.append(row)
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return feats, rows, latencies, wall


def phase_serve(rehearsal: bool, card_line: str):
    import numpy as np

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
    marks = graph_marks(bundle)
    feats, rows, latencies, wall = asyncio.run(drive(batcher, bundle, waves))
    launches, dispatches = fused_attention.launches, engine.dispatches
    gdrive = graph_drive(bundle, marks, {"fused_attention": launches})

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
        ref.extend(cpu_engine.run_batch([cpu_bundle.preprocess(item) for item in wave]))
    worst, label_checked = check_probs(bundle, rows, ref, "the CPU f32 run")
    lat = np.array(latencies) * 1e3
    emit(
        "serve bert-base", device=str(bundle.device), card=card_line,
        requests=len(rows), dispatches=dispatches, fused_attention_launches=launches,
        warmup_s=warm_s, p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)), req_per_s=len(rows) / wall,
        max_prob_err_vs_cpu_f32=worst, prob_tol=PROB_TOL,
        labels_checked=label_checked, graph_modes=engine.graph_modes(),
    )
    return cfg, bundle, engine, launches, gdrive, feats


def profile_split(fn, reps: int, kernel_name: str, label: str, count: str | None = None) -> dict:
    """Device busy time of ``reps`` calls of ``fn`` from ``torch.profiler``'s
    kernel records, per call, split into the port's kernel (names matching
    the regex ``kernel_name``),
    GEMMs and the rest, with the four busiest kernels and the device
    kernels a call (``kernels``); with ``count``, also the kernels a call
    whose names match that regex (``counted``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_primer()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {label: 0.0, "gemm": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    counted = launched = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or PRIMER_KERNEL.search(e.name):
            continue
        launched += 1
        counted += bool(count and re.search(count, e.name))
        us = e.time_range.elapsed_us()
        part = (label if re.search(kernel_name, e.name)
                else "gemm" if GEMM_KERNEL.search(e.name) else "other")
        split[part] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = sum(split.values()) / reps / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return dict(
        device_busy_ms=busy_ms if by_name else None,
        **{f"{k}_ms": v / reps / 1e3 for k, v in split.items()},
        top_kernels=[[name[:80], us / reps / 1e3] for name, us in top],
        note=None if by_name else "torch.profiler recorded no device kernels",
        kernels=launched / reps,
        **({"counted": counted / reps} if count else {}),
    )


def eager_and_graph(eager, graph, reps: int, kernel_name: str, label: str, iters: int = 10,
                    count: str | None = None) -> dict:
    """Wall time (CUDA events over ``iters`` calls) and ``profile_split``
    over ``reps`` calls of the eager function and of the graph replay, side
    by side; the kernel launches a call are the profile's ``kernels``."""
    out = {}
    for mode, fn in (("eager", eager), ("graph", graph)):
        wall = cuda_ms(fn, iters)
        split = profile_split(fn, reps, kernel_name, label, count=count)
        busy = split["device_busy_ms"]
        out[mode] = {"wall_ms": wall, "busy_share": busy / wall if busy else None, **split}
    out["wall_speedup"] = out["eager"]["wall_ms"] / out["graph"]["wall_ms"]
    return out


def engine_graph(engine, kind: str, shape: tuple):
    """The engine's ``forward`` or ``forward_images`` graph for the bucket
    ``shape`` (captured if it is missing)."""
    import torch

    make = {"forward": engine._make_forward, "forward_images": engine._make_images}[kind]
    with engine._lock, torch.inference_mode():
        return engine._graph(kind, shape, None, lambda: make(shape))


def graph_marks(bundle) -> tuple:
    """What a drive's graph accounting starts from: the bundle's replays
    and the cache's misses so far."""
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    return replays_of(bundle), CACHE.stats()["miss"]


def graph_drive(bundle, marks: tuple, counted: dict) -> dict:
    """A drive's graph accounting since ``marks``: cache misses, the launch
    counters' counts and the launches the replays made."""
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    return {"misses": CACHE.stats()["miss"] - marks[1], "counted": counted,
            "replayed": launches_replayed(bundle, marks[0])}


def replays_of(bundle) -> dict:
    """Replays so far of each of the bundle's graphs, by entry."""
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    return {id(e): e.replays for e in CACHE.entries(bundle)}


def launches_replayed(bundle, before: dict) -> dict:
    """Kernel launches the bundle's graphs made since ``before``
    (``replays_of``): each entry's new replays times the launches recorded
    at its capture, and once more for an entry captured since, whose
    capture ran its call eagerly."""
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    out = {}
    for e in CACHE.entries(bundle):
        calls = e.replays - before.get(id(e), 0) + (id(e) not in before)
        for name, n in e.launches.items():
            out[name] = out.get(name, 0) + calls * n
    return out


def graph_trace(entry, attempts: int = 3) -> dict:
    """One replay of ``entry`` under ``torch.profiler``: its device kernels,
    and those of each hand-written kernel by name, which must be as many as
    its capture recorded.  The profiler has lost kernels of a one-replay
    window: once all of them; in a long-lived process the first ~20 of
    every GPT-2 chunk's trace (its first decode kernel among them, while
    the same graph traced in full in a fresh process and its tokens matched
    eager), and now and then a block of 200-1000; so the replay follows
    ``profiler_primer``.  A replay runs the same
    kernels every time, so a trace short of the capture that shows fewer
    device kernels in all than another trace of the same graph lost
    records: a short trace is taken again, up to ``attempts`` times in all,
    and the check holds on the fullest one; a trace that shows more of a
    kernel than the capture recorded fails at once.  Every attempt's counts
    are returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import device_lock

    want = {name: entry.launches.get(name, 0) for name in LAUNCHED_KERNEL}
    tries, best = [], None
    for _ in range(attempts):
        with device_lock(torch.device("cuda", torch.cuda.current_device())):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profiler_primer()
                entry.replay()
                torch.cuda.synchronize()
        seen = dict.fromkeys(LAUNCHED_KERNEL, 0)
        kernels = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or PRIMER_KERNEL.search(e.name):
                continue
            kernels += 1
            for name, pattern in LAUNCHED_KERNEL.items():
                seen[name] += bool(re.search(pattern, e.name))
        tries.append({"kernels": kernels, **{k: v for k, v in seen.items() if v}})
        if any(seen[k] > want[k] for k in want):
            break
        if best is None or kernels > best[0]:
            best = (kernels, seen)
        if seen == want:
            break
    if best is None or not best[0] or best[1] != want:
        import pathlib

        out = pathlib.Path("chiprun_out")
        if out.is_dir():
            names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            names.append(f"(timeline {tries})")
            (out / f"trace_{entry.kind}.txt").write_text("\n".join(n[:120] for n in names))
        raise AssertionError(f"{entry.kind}: one replay's traces show {tries}; its capture "
                             f"recorded {want}")
    return {**tries[-1], "attempts": tries}


def phase_graphs(label: str, bundle, misses: int, counted: dict, replayed: dict,
                 want_misses: int = 0, **checks) -> dict:
    """A service's graphs: captures, capture seconds and replays by kind,
    the graph pools' bytes, the misses after warmup (must be 0: every
    bucket was captured at warmup), the launch counters of the drive held
    against the launches its replays made, and one replay of each kind
    traced by the profiler with the hand-written kernels by name."""
    from mlmicroservicetemplate_tpu_torch.runtime import compile_cache

    if misses != want_misses:
        raise AssertionError(f"{label}: {misses} graph-cache misses after warmup; "
                             f"want {want_misses}")
    if {k: v for k, v in counted.items() if v} != {k: v for k, v in replayed.items() if v}:
        raise AssertionError(f"{label}: launch counters {counted} but the replays made "
                             f"{replayed}")
    kinds: dict = {}
    for e in compile_cache.CACHE.entries(bundle):
        k = kinds.setdefault(e.kind, {"captures": 0, "capture_s": 0.0, "replays": 0,
                                      "static_output_bytes": 0, "launches_per_replay": {},
                                      "_entry": e})
        k["captures"] += 1
        k["capture_s"] += e.capture_s
        k["replays"] += e.replays
        k["static_output_bytes"] += tensor_bytes(e.outputs)
        # The first captured (the smallest bucket, argmax) of those with the
        # most kernel launches: the profiler drops records in the largest
        # traces (``graph_trace``).
        if sum(e.launches.values()) > sum(k["_entry"].launches.values()):
            k["_entry"] = e
    for k in kinds.values():
        e = k.pop("_entry")
        k["launches_per_replay"] = e.launches
        k["trace_one_replay"] = graph_trace(e)
    out = dict(kinds=kinds, graph_pool_bytes=compile_cache.graph_pool_bytes(),
               misses_after_warmup=misses, launches_counted=counted,
               launches_by_replays=replayed, **checks)
    emit(f"graphs {label}", **out)
    return out


def logits_graph_vs_eager(engine, feats) -> dict:
    """The same batch through the engine's graph and, with its graphs off,
    its eager dispatch: each row's largest difference within
    GRAPH_LOGIT_TOL of that row's largest |logit|."""
    import numpy as np

    graphs = engine.graphs
    got = engine.run_batch(feats)
    engine.graphs = None
    try:
        want = engine.run_batch(feats)
    finally:
        engine.graphs = graphs
    worst = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
    if worst > GRAPH_LOGIT_TOL:
        raise AssertionError(f"graph logits differ from eager by {worst} x max|logit|")
    return {"rows": len(got), "max_logit_diff_over_max_logit": worst,
            "tol": GRAPH_LOGIT_TOL}


def tokens_graph_vs_eager(engine, feats) -> dict:
    """One generation batch through the engine's ``start`` and
    ``gen_chunk`` graphs and, with its graphs off, eagerly: greedy tokens
    identical."""
    import numpy as np

    graphs = engine.graphs
    got = engine.run_batch(feats)
    engine.graphs = None
    try:
        want = engine.run_batch(feats)
    finally:
        engine.graphs = graphs
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    if not same:
        raise AssertionError("greedy tokens through graphs differ from eager ones")
    return {"rows": len(got), "tokens_identical": same}


def chunk_graph_vs_eager(engine, loop) -> dict:
    """One loop chunk of the slot state with every slot live (as
    ``time_chunk`` sets it) through the chunk's graph and, from the same
    state restored, eagerly: tokens identical, for the argmax chunk and for
    the sampled one (every slot at temperature 1, top_k 40, top_p 0.9)."""
    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.models.gpt import state_tensors

    out = {}
    with torch.inference_mode(), engine._lock:
        st = loop._state
        every_key_valid(st)
        st.done.fill_(False)
        if engine.paged_kv:
            loop._table[:] = np.arange(loop._table.size).reshape(loop._table.shape) % \
                engine.kv_pool.num_blocks
        for sample in (False, True):
            if sample:
                st.sample.temperature.fill_(1.0)
                st.sample.top_k.fill_(40)
                st.sample.top_p.fill_(0.9)
                st.sample.rng.copy_(torch.arange(st.sample.rng.numel()).view_as(st.sample.rng))
            saved = [t.clone() for t in state_tensors(st)]
            _, toks = loop._chunk_call(sample)
            got = toks.clone()
            for t, s in zip(state_tensors(st), saved):
                t.copy_(s)
            graphs = engine.graphs
            engine.graphs = None
            try:
                _, want = loop._chunk_call(sample)
            finally:
                engine.graphs = graphs
            if not torch.equal(got, want):
                raise AssertionError(f"a loop chunk's tokens through its graph differ from "
                                     f"eager ones (sampled: {sample})")
            out["sampled" if sample else "argmax"] = True
    return {"slots": int(got.shape[0]), "steps": int(got.shape[1]),
            "tokens_identical": out}


def every_key_valid(state) -> None:
    """Every key of a slot state valid: a decoder's cache keys, or an
    encoder-decoder's encoder keys (its self-attention reads its cache up
    to each row's position)."""
    for name in ("key_valid", "enc_mask"):
        if hasattr(state, name):
            getattr(state, name).fill_(1)


def tensor_bytes(obj) -> int:
    """Bytes of the tensors in ``obj`` (a tensor, a decode state, or lists
    and tuples of them)."""
    from mlmicroservicetemplate_tpu_torch.models.gpt import state_tensors

    if hasattr(obj, "data_ptr"):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(t) for t in state_tensors(obj))
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(t) for t in obj)
    return 0


def phase_forward(bundle, engine) -> None:
    """One BERT forward at three buckets, eager and as the bucket's graph
    replay, side by side: wall, busy, the split and the kernels a call."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, s in ((1, 32), (8, 128), (32, 512)):
        ids = torch.randint(5, 261, (b, s), device="cuda", generator=gen, dtype=torch.int32)
        mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
        entry = engine_graph(engine, "forward", (b, s))
        with torch.inference_mode():
            entry.inputs[0][0].copy_(ids)
            entry.inputs[1][0].copy_(mask)
            out = eager_and_graph(lambda: bundle.forward(ids, mask), entry.replay, 5,
                                  K1_KERNEL, "attention")
        emit("forward", shape=[b, s], **out)


def llama_pytree(cfg, seed: int) -> dict:
    """Random weights in the JAX package's llama layout (numpy f32,
    ``[d_in, d_out]`` kernels): N(0, 0.02), unit RMSNorm scales."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def w(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= 0.02
        return a

    d, kv = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
    ones = np.ones(d, np.float32)
    return {
        "embed": {"embedding": w(cfg.vocab_size, d)},
        "layers": [
            {
                "attn_ln": {"scale": ones},
                "attn": {"q": {"kernel": w(d, d)}, "k": {"kernel": w(d, kv)},
                         "v": {"kernel": w(d, kv)}, "o": {"kernel": w(d, d)}},
                "mlp_ln": {"scale": ones},
                "mlp": {"gate": {"kernel": w(d, cfg.d_ff)}, "up": {"kernel": w(d, cfg.d_ff)},
                        "down": {"kernel": w(cfg.d_ff, d)}},
            }
            for _ in range(cfg.num_layers)
        ],
        "final_ln": {"scale": ones},
        "lm_head": {"kernel": w(d, cfg.vocab_size)},
    }


def family(bundle):
    """The model module of a generative bundle (``gpt``, ``llama`` or
    ``t5``)."""
    from mlmicroservicetemplate_tpu_torch.models import gpt, llama, t5

    return {"gpt2": gpt, "t5-small": t5}.get(bundle.name, llama)


def forced_logits(bundle, model, f: dict, toks: list, dtype=None, **kw):
    """f32 logits [L, V] of ``model`` at the steps that emitted ``toks``,
    in one pass (teacher-forced): a decoder over the prompt and the tokens
    before each, T5's decoder over its start token and the tokens before
    each with the prompt encoded (with ``dtype`` None: f32 and, for T5, K1's
    plain version: the reference)."""
    import torch

    prompt = [int(t) for t in f["input_ids"]]
    dev = bundle.device
    if bundle.name == "t5-small":
        ids = torch.tensor([prompt], dtype=torch.int32, device=dev)
        tgt = torch.tensor([toks], dtype=torch.long, device=dev)
        return family(bundle).teacher_forced_logits(
            model, ids, torch.ones_like(ids), tgt, dtype or torch.float32,
            plain=dtype is None)[0]
    ids = torch.tensor([prompt + toks[:-1]], dtype=torch.int32, device=dev)
    args = () if dtype is None else (dtype,)
    logits = family(bundle).lm_logits(model, ids, torch.ones_like(ids), *args, **kw)
    return logits[0, len(prompt) - 1:]


def step_keys(seed: int, n: int, device):
    """A seeded row's step keys [n, 2]: the key of its step j is the second
    half of the (j + 1)-th split of its chain."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models import sampling

    rng = sampling.make_params([seed], [1.0], [0], [1.0]).rng.to(device)
    keys = []
    for _ in range(n):
        rng, key = sampling.row_split(rng)
        keys.append(key)
    return torch.cat(keys)


def perturbed(ref, f: dict, steps, tol: float):
    """For a sampled row: the f32 reference logits ``ref`` [L, V] at its
    steps ``steps`` as its draws see them (temperature, top-k, top-p) plus
    the row's Gumbel noise at those steps.  Returns (scores [L, V], the
    temperature-scaled logits, the filter's cutoff a step, and the
    tolerance ``tol`` in score units).  An entry within the tolerance of a
    cutoff may fall either side of it in the served precision."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models import sampling

    temp = float(f["temperature"])
    n = ref.shape[0]
    params = [torch.full((n,), x, device=ref.device, dtype=dt) for x, dt in (
        (temp, torch.float32), (int(f.get("top_k", 0)), torch.int32),
        (float(f.get("top_p", 1.0)), torch.float32))]
    z = sampling.filtered_logits(ref, *params)
    raw = ref.float() / max(temp, 1e-6)
    cutoff = torch.where(z > -1e8, raw, torch.full_like(raw, float("inf"))).amin(dim=-1)
    keys = step_keys(int(f["seed"]), int(steps.max()) + 1, ref.device)[steps.to(ref.device)]
    return raw + sampling.gumbel(keys, ref.shape[1]), raw, cutoff, tol / temp


def sampled_gaps(ref, f: dict, toks, tol: float):
    """Each emitted token of a sampled row against the f32 reference's
    draw at its step: how far its perturbed score trails the best one among
    the tokens surely inside the filter, and how far its logit falls below
    the filter's cutoff; both must stay within the tolerance."""
    import torch

    steps = torch.arange(len(toks), device=ref.device)
    score, raw, cutoff, tol_s = perturbed(ref, f, steps, tol)
    t = torch.tensor(toks, device=ref.device)[:, None]
    sure = raw >= (cutoff + tol_s)[:, None]
    sure |= raw == raw.max(dim=-1, keepdim=True).values
    best = torch.where(sure, score, torch.full_like(score, -float("inf"))).amax(dim=-1)
    trail = best - score.gather(1, t)[:, 0]
    outside = cutoff - raw.gather(1, t)[:, 0]
    return float(torch.maximum(trail, outside).max()), tol_s


def teacher_forced(bundle, ref_model, feats, rows, max_len: int) -> dict:
    """Hold every emitted token against an f32 forward of the plain path
    over the prompt and the tokens emitted before it (same weights).  A
    greedy token must be within the tolerance of that step's best reference
    logit.  A sampled token's draw is rebuilt from its seed and step: the
    reference's filtered logits plus the same Gumbel noise, where its
    perturbed score must be within the tolerance (over its temperature) of
    the best one (``sampled_gaps``).  The tolerance comes from errors
    measured here, on the same sequences: the served model's plain forward
    against f32 and, for the int8 cache, f32 with K/V through int8 against
    f32."""
    import torch

    cfg = bundle.cfg
    dev = bundle.device
    kv_quant = cfg.kv_quant
    gaps, err_served, err_kv8, exact, checked = [], 0.0, 0.0, 0, 0
    sampled = []
    with torch.inference_mode():
        for f, row in zip(feats, rows):
            budget = min(int(f.get("max_tokens", max_len)), max_len)
            toks = [int(t) for t in row[:budget]]
            if cfg.eos_id in toks:
                toks = toks[: toks.index(cfg.eos_id) + 1]
            ref = forced_logits(bundle, ref_model, f, toks)
            served = forced_logits(bundle, bundle.model, f, toks, bundle.policy.compute_dtype)
            err_served = max(err_served, (served - ref).abs().max().item())
            if kv_quant:
                kq = forced_logits(bundle, ref_model, f, toks, kv_int8_roundtrip=True)
                err_kv8 = max(err_kv8, (kq - ref).abs().max().item())
            checked += len(toks)
            if float(f.get("temperature", 0.0)) > 0:
                sampled.append((ref, f, toks))
                continue
            t = torch.tensor(toks, device=dev)
            gap = ref.max(dim=-1).values - ref.gather(1, t[:, None])[:, 0]
            exact += int((gap == 0).sum())
            gaps.append(gap.max().item())
        tol = max(TF_FACTOR * (err_served + err_kv8), TF_FLOOR)
        worst_s, n_s = 0.0, 0
        for ref, f, toks in sampled:
            gap, tol_s = sampled_gaps(ref, f, toks, tol)
            worst_s = max(worst_s, gap / tol_s)
            n_s += len(toks)
    worst = max(gaps) if gaps else 0.0
    out = dict(tokens_checked=checked, greedy_tokens=checked - n_s,
               argmax_equal_share=exact / max(1, checked - n_s), worst_gap=worst, tol=tol,
               sampled_rows=len(sampled), sampled_tokens=n_s,
               sampled_worst_gap_over_tol=worst_s, served_logit_err=err_served,
               kv8_logit_err=err_kv8 if kv_quant else None)
    if worst > tol or worst_s > 1.0:
        raise AssertionError(f"an emitted token trails the f32 reference's draw: {out}")
    return out


def alone_vs_batch(bundle, ref_model, f: dict, in_batch, alone, tol: float) -> dict:
    """A seeded sampled request's tokens served inside a full batch and
    alone.  Identical, or they part first at a step where the f32
    reference's two best perturbed scores (teacher-forced on the batch's
    tokens) are within twice the tolerance: batch buckets run different
    GEMM shapes in bf16, whose last bits may flip such a draw."""
    import torch

    a, b = [int(t) for t in alone], [int(t) for t in in_batch]
    n = min(len(a), len(b))
    at = next((j for j in range(n) if a[j] != b[j]), None)
    out = {"tokens": n, "identical": at is None and len(a) == len(b)}
    if at is None:
        if len(a) != len(b):
            raise AssertionError(f"alone {len(a)} tokens, in a batch {len(b)}")
        return out
    with torch.inference_mode():
        ref = forced_logits(bundle, ref_model, f, b[: at + 1])[-1:]
        score, raw, cutoff, tol_s = perturbed(ref, f, torch.tensor([at]), tol)
        kept = (raw >= (cutoff - tol_s)[:, None])[0]
        top = score[0][kept].topk(2).values
    out.update(parted_at=at, margin=float(top[0] - top[1]), tol=2 * tol_s)
    if out["margin"] > 2 * tol_s:
        raise AssertionError(f"a seeded request drew other tokens alone than in a batch: {out}")
    return out


def release(bundle) -> None:
    """Drop a finished service's graphs from the cache and return their
    memory (the http phase keeps the services it drives)."""
    import torch

    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    CACHE.drop(bundle)
    torch.cuda.empty_cache()


def with_solo(waves) -> tuple[list, int]:
    """``waves`` and, as a last wave of its own, the last sampled request of
    the largest wave again; returns them and that request's index in the
    drive's order (the solo run is the drive's last)."""
    items = [item for wave in waves for item in wave]
    i = max(i for i, item in enumerate(items) if item.temperature > 0)
    return waves + [[items[i]]], i


def phase_serve_gen(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                    card_line: str):
    """A generative service (llama or gpt2) through ``Batcher.submit``: the
    decode kernel's launches held against the decode steps, every token
    teacher-forced (greedy and sampled), and the last sampled request of
    the full wave served again alone."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    warm_s = engine.warmup()
    waves, solo = with_solo(gen_waves(rehearsal))

    decode_attention.launches = 0
    engine.decode_steps = 0
    engine.dispatches = 0
    marks = graph_marks(bundle)
    feats, rows, latencies, wall = asyncio.run(drive(batcher, bundle, waves))
    launches, steps = decode_attention.launches, engine.decode_steps
    gdrive = graph_drive(bundle, marks, {"decode_attention": launches})
    layers = bundle.cfg.num_layers
    want = 0 if rehearsal else layers * steps
    if steps < 1 or launches != want:
        raise AssertionError(
            f"decode_attention launched {launches} times over {steps} decode steps; "
            f"the main path must launch it {layers} times per step and never in prefill"
        )
    for row in rows:
        if row.dtype != np.int32 or row.shape != (engine.max_decode_len,):
            raise AssertionError(f"bad token row {row!r}")
    check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
    budget = min(int(feats[solo].get("max_tokens", engine.max_decode_len)),
                 engine.max_decode_len)
    alone = alone_vs_batch(bundle, ref_model, feats[solo], rows[solo][:budget],
                           rows[-1][:budget], check["tol"])
    lat = np.array(latencies) * 1e3
    emit(
        label, device=str(bundle.device), card=card_line, layers=layers,
        kv_quant=bundle.cfg.kv_quant, requests=len(rows), dispatches=engine.dispatches,
        decode_steps=steps, decode_attention_launches=launches, warmup_s=warm_s,
        p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
        generated_tok_per_s=check["tokens_checked"] / wall,
        wall_ms_per_decode_step=wall * 1e3 / steps, graph_modes=engine.graph_modes(),
        seeded_alone_vs_batch=alone, **check,
    )
    return cfg, bundle, engine, launches, gdrive, feats


async def drive_streams(batcher, bundle, waves):
    """Open each wave's streams at once through ``Batcher.submit_stream``
    and read them to the end; returns (feats, token rows, per-stream
    latencies, times to the first chunk, wall seconds)."""
    import numpy as np

    await batcher.start()
    feats, rows, latencies, ttfts = [], [], [], []

    async def one(item):
        t0 = time.monotonic()
        f = bundle.preprocess(item)
        toks, first = [], None
        async for chunk in batcher.submit_stream(f):
            if first is None:
                first = time.monotonic() - t0
            toks.extend(int(x) for x in chunk)
        latencies.append(time.monotonic() - t0)
        ttfts.append(first)
        return f, np.array(toks, np.int32)

    try:
        t0 = time.monotonic()
        for wave in waves:
            for f, row in await asyncio.gather(*(one(item) for item in wave)):
                feats.append(f)
                rows.append(row)
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return feats, rows, latencies, ttfts, wall


def phase_serve_stream(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                       card_line: str, warm_loop: bool = True):
    """A generative service (llama or gpt2) streaming through the continuous
    decode loop: every token teacher-forced (greedy and sampled), the
    kernels' launches held against the loop's counts, the paged pool back
    to 0 blocks, the last sampled stream of the full wave streamed again
    alone; on the card, one slot-state chunk timed and split by kernel.
    Without ``warm_loop`` the loop is not warmed (as under ``WARMUP=0``):
    its chunk's graphs (argmax and sampled) are captured at the first
    admission, two misses in the drive."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    loop = batcher._cdl
    # As the app warms: every bucket's start, then the loop's chunk.
    warm_s = batcher.warm_engine() + (batcher.warm_streams() if warm_loop else 0.0)
    waves, solo = with_solo(gen_waves(rehearsal))

    decode_attention.launches = paged_decode_attention.launches = 0
    loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
    marks = graph_marks(bundle)
    feats, rows, latencies, ttfts, wall = asyncio.run(drive_streams(batcher, bundle, waves))
    k2, k3 = decode_attention.launches, paged_decode_attention.launches
    gdrive = graph_drive(bundle, marks, {"decode_attention": k2, "paged_decode_attention": k3})
    layers, chunk = bundle.cfg.num_layers, engine.chunk_tokens
    first_chunks = chunk * loop.prefill_dispatches
    # Unwarmed, the chunks' captures (argmax, sampled) at the first admission
    # run one chunk each eagerly.
    slot_steps = loop.decode_steps + (0 if warm_loop else 2 * chunk)
    if rehearsal:
        want_k2 = want_k3 = 0
    elif engine.paged_kv:
        want_k2, want_k3 = layers * first_chunks, layers * slot_steps
    else:
        want_k2, want_k3 = layers * (first_chunks + slot_steps), 0
    if loop.decode_steps < 1 or (k2, k3) != (want_k2, want_k3) or (
        engine.paged_kv and not rehearsal and k3 < 1
    ):
        raise AssertionError(
            f"{label}: decode_attention launched {k2} times (want {want_k2}) and "
            f"paged_decode_attention {k3} (want {want_k3}) over {loop.prefill_dispatches} "
            f"admission waves and {loop.decode_steps} slot decode steps"
        )
    if engine.paged_kv and engine.kv_pool.used_blocks != 0:
        raise AssertionError(f"{label}: {engine.kv_pool.used_blocks} pool blocks still held")
    if loop.admitted != 0:
        raise AssertionError(f"{label}: {loop.admitted} streams never released")
    for f, row in zip(feats, rows):
        budget = min(int(f.get("max_tokens", engine.max_decode_len)), engine.max_decode_len)
        if not 1 <= len(row) <= budget:
            raise AssertionError(f"{label}: a stream of {len(row)} tokens, budget {budget}")
    check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
    alone = alone_vs_batch(bundle, ref_model, feats[solo], rows[solo], rows[-1], check["tol"])
    lat, ttft = np.array(latencies) * 1e3, np.array(ttfts) * 1e3
    out = dict(
        device=str(bundle.device), card=card_line, layers=layers,
        kv_quant=bundle.cfg.kv_quant, paged=engine.paged_kv, streams=len(rows),
        slots=loop.n_slots, admission_waves=loop.prefill_dispatches,
        chunk_dispatches=loop.chunk_dispatches, slot_decode_steps=loop.decode_steps,
        decode_attention_launches=k2, paged_decode_attention_launches=k3,
        pool_blocks=engine.kv_pool.num_blocks if engine.paged_kv else None,
        pool_mb=(engine.kv_pool.num_blocks * engine.kv_block_bytes() / 1e6
                 if engine.paged_kv else None),
        warm_s=warm_s, p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
        ttft_p50_ms=float(np.percentile(ttft, 50)), ttft_p99_ms=float(np.percentile(ttft, 99)),
        generated_tok_per_s=check["tokens_checked"] / wall,
        wall_ms_per_chunk_dispatch=wall * 1e3 / max(1, loop.chunk_dispatches),
        loop_warmed=warm_loop, graph_modes=engine.graph_modes(),
        seeded_alone_vs_batch=alone, **check,
    )
    if not rehearsal:
        out["chunk"] = time_chunk(engine, loop)
    emit(label, **out)
    return cfg, bundle, engine, k2, k3, gdrive, loop


def class_items(rehearsal: bool, n_batch: int, n_inter: int, cap: int):
    """``n_batch`` batch-class prompts (every third sampled and seeded) and
    ``n_inter`` interactive ones, each under ``cap`` bytes (the smallest
    seq bucket), none with a ``max_tokens``: every stream asks for the whole
    decode budget."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(3)
    words = ["batch", "class", "stream", "budget", "block", "resume", "slot", "pool"]
    items = []
    for i in range(n_batch + n_inter):
        length = int(rng.integers(cap // 2, cap))
        text = " ".join(rng.choice(words, size=length))[:length]
        sampling = {}
        if i < n_batch and i % 3 == 2:
            sampling = dict(temperature=(0.7, 1.0)[i // 3 % 2], top_k=(0, 40)[i // 6 % 2],
                            seed=2000 + i)
        items.append(RawItem(text=text, **sampling))
    return items[:n_batch], items[n_batch:]


async def drive_classes(batcher, bundle, batch_items, inter_items):
    """Open the batch-class streams at once; once each has its first chunk
    (they hold the slots and the pool), open the interactive ones; read
    every stream to its end.  Returns ([(feats, tokens, class, ttft s)],
    wall seconds)."""
    import numpy as np

    await batcher.start()

    async def one(item, klass, first_seen=None):
        t0 = time.monotonic()
        f = dict(bundle.preprocess(item), priority=klass)
        toks, ttft = [], None
        try:
            async for chunk in batcher.submit_stream(f):
                if ttft is None:
                    ttft = time.monotonic() - t0
                    if first_seen is not None:
                        first_seen.set()
                toks.extend(int(x) for x in chunk)
        finally:
            if first_seen is not None:
                first_seen.set()
        return f, np.array(toks, np.int32), klass, ttft

    try:
        t0 = time.monotonic()
        seen = [asyncio.Event() for _ in batch_items]
        tasks = [asyncio.create_task(one(item, "batch", ev))
                 for item, ev in zip(batch_items, seen)]
        for ev in seen:
            await ev.wait()
        tasks += [asyncio.create_task(one(item, "interactive")) for item in inter_items]
        done = await asyncio.gather(*tasks)
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return done, wall


def phase_serve_classes(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                        card_line: str, n_batch: int, n_inter: int, cap: int,
                        budget_streams: int | None = None):
    """Priority classes through the continuous loop: batch-class streams
    fill the slots (and, with ``budget_streams``, a paged pool of
    ``KV_BUDGET_MB`` = that many of the engine's worst-case streams), then
    interactive ones arrive and preempt them.  Gates: every stream ends
    with tokens, at least one preemption (and, paged, one dry-pool requeue),
    every delivered token teacher-forced across the resume seams, the
    kernels' launches held against the loop's counts, the pool back to 0
    blocks, every stream released.  Returns (bundle, {kernel: launches},
    graph accounting)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine
    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention, fused_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    budget_blocks = None
    if budget_streams:
        # KV_BUDGET_MB from this engine's blocks (half a block over, so the
        # pool's floor lands on the count), then the service over it.
        budget_blocks = budget_streams * engine.kv_blocks_per_stream
        bb = engine.kv_block_bytes()
        cfg = dataclasses.replace(cfg, kv_budget_mb=(budget_blocks * bb + bb // 2) / 1e6)
        engine = InferenceEngine(bundle, cfg)
        batcher = Batcher(engine, cfg)
        if engine.kv_pool.num_blocks != budget_blocks:
            raise AssertionError(f"{label}: KV_BUDGET_MB={cfg.kv_budget_mb} gave "
                                 f"{engine.kv_pool.num_blocks} blocks, want {budget_blocks}")
    loop = batcher._cdl
    warm_s = batcher.warm_engine() + batcher.warm_streams()
    batch_items, inter_items = class_items(rehearsal, n_batch, n_inter, cap)

    kernels = (fused_attention, decode_attention, paged_decode_attention)
    for k in kernels:
        k.launches = 0
    loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
    marks = graph_marks(bundle)
    done, wall = asyncio.run(drive_classes(batcher, bundle, batch_items, inter_items))
    k1, k2, k3 = (k.launches for k in kernels)
    t5 = bundle.name == "t5-small"
    counted = ({"fused_attention": k1} if t5
               else {"decode_attention": k2, "paged_decode_attention": k3})
    gdrive = graph_drive(bundle, marks, counted)
    layers, chunk = bundle.cfg.num_layers, engine.chunk_tokens
    if t5:
        starts = start_calls(bundle, marks[0])
        want = {"fused_attention": T5_LAYERS * starts, "decode_attention": 0}
    elif engine.paged_kv:
        want = {"decode_attention": layers * chunk * loop.prefill_dispatches,
                "paged_decode_attention": layers * loop.decode_steps}
    else:
        want = {"decode_attention": layers * (chunk * loop.prefill_dispatches
                                              + loop.decode_steps)}
    got = {"fused_attention": k1, "decode_attention": k2, "paged_decode_attention": k3}
    if not rehearsal and any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {got}, want {want} over "
                             f"{loop.prefill_dispatches} waves and {loop.decode_steps} steps")
    counts = dict(preemptions=loop.preemptions, recasts=loop.recasts, replays=loop.replays,
                  kv_growth_stalls=loop.kv_growth_stalls)
    if loop.preemptions < 1:
        raise AssertionError(f"{label}: no interactive arrival preempted a batch stream "
                             f"({counts})")
    if engine.paged_kv and loop.kv_growth_stalls < 1:
        raise AssertionError(f"{label}: the {engine.kv_pool.num_blocks}-block pool never ran "
                             f"dry ({counts})")
    if engine.paged_kv and engine.kv_pool.used_blocks != 0:
        raise AssertionError(f"{label}: {engine.kv_pool.used_blocks} pool blocks still held")
    if loop.admitted != 0 or batcher.admission.committed_bytes != 0:
        raise AssertionError(f"{label}: {loop.admitted} streams never released, "
                             f"{batcher.admission.committed_bytes} KV bytes still committed")
    feats = [f for f, *_ in done]
    rows = [row for _, row, *_ in done]
    for f, row in zip(feats, rows):
        if not 1 <= len(row) <= engine.max_decode_len:
            raise AssertionError(f"{label}: a stream of {len(row)} tokens")
    check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
    ttft = {klass: np.array([t for _, _, k, t in done if k == klass]) * 1e3
            for klass in ("batch", "interactive")}
    out = dict(
        device=str(bundle.device), card=card_line, layers=layers, paged=engine.paged_kv,
        slots=loop.n_slots, queue=loop.max_stream_queue, batch_streams=n_batch,
        interactive_streams=n_inter, kv_budget_mb=cfg.kv_budget_mb or None,
        pool_blocks=engine.kv_pool.num_blocks if engine.paged_kv else None,
        **counts, admission_waves=loop.prefill_dispatches,
        chunk_dispatches=loop.chunk_dispatches, slot_decode_steps=loop.decode_steps,
        launches={k: v for k, v in got.items() if v}, warm_s=warm_s,
        **{f"ttft_{k}_p{q}_ms": float(np.percentile(v, q)) for k, v in ttft.items()
           for q in (50, 99)},
        generated_tok_per_s=check["tokens_checked"] / wall, graph_modes=engine.graph_modes(),
        **check,
    )
    emit(label, **out)
    return bundle, {k: v for k, v in got.items() if v}, gdrive


def time_chunk(engine, loop) -> dict:
    """One chunk of the loop's slot state, eager and through its graph,
    timed (CUDA events) and split by kernel (``torch.profiler``): every
    slot live at full width (all keys valid and, paged, a table of distinct
    pool blocks; a dead row's compute is a live row's), so the attention
    reads what full streams would."""
    import numpy as np
    import torch

    bundle = engine.bundle
    with torch.inference_mode(), engine._lock:
        every_key_valid(loop._state)
        if engine.paged_kv:
            loop._table[:] = np.arange(loop._table.size).reshape(loop._table.shape) % \
                engine.kv_pool.num_blocks
            loop._table_dev.copy_(torch.from_numpy(loop._table))

        def eager():
            if engine.paged_kv:
                bundle.paged_chunk(loop._state, loop._table_dev, loop.chunk)
            else:
                bundle.generate_chunk(loop._state, loop.chunk)

        def graph():
            loop._chunk_call()

        return eager_and_graph(eager, graph, 5, K3_KERNEL if engine.paged_kv else K2_KERNEL,
                               "attention")


def phase_decode_step(bundle, label: str = "decode step", batches=(1, 8, 32),
                      prompt: int = 512, sampled: bool = False,
                      kernel: tuple[str, str] = (K2_KERNEL, "decode_attention")) -> None:
    """One decode step at each batch size over a (prompt + 64)-key cache,
    eager and as a captured graph of the step over the same state, side by
    side (37 steps in all, inside the 64 decode positions).  With
    ``sampled``, the sampled step too (every row at temperature 1, top_k 40,
    top_p 0.9; its own state), and the sampler alone on [B, V] f32 logits as
    graphs: the threefry Gumbel noise, the sort and filter, the whole
    ``select_token`` and, for scale, the greedy argmax.  ``kernel``: the
    (name regex, label) of the kernel the split sets apart."""
    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.models import sampling
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import capture_graph

    gen = torch.Generator(device="cuda").manual_seed(3)
    v = bundle.cfg.vocab_size
    for b in batches:
        ids = torch.randint(5, 261, (b, prompt), device="cuda", generator=gen, dtype=torch.int32)
        mask = torch.ones_like(ids)
        params = sampling.make_params(np.arange(b) + 7, [1.0] * b, [40] * b, [0.9] * b)
        out = {}
        for variant in ("greedy", "sampled") if sampled else ("greedy",):
            sample = variant == "sampled"
            with torch.inference_mode():
                state = bundle.init_state(ids, mask, 64, sample=params if sample else None)

                def step():
                    state.steps = 0  # the graph's steps are not counted on the host
                    return bundle.generate_chunk(state, 1, sample)[1]

                entry = capture_graph("gen_chunk", step, state, "cuda")
                out[variant] = eager_and_graph(step, entry.replay, 5, *kernel)
        # A decoder's cache holds prompt and decode positions; T5's self
        # cache only the decode ones, its encoder keys the prompt.
        cache = ({"self_cache_len": 64, "encoder_keys": prompt} if hasattr(state, "enc_mask")
                 else {"cache_len": prompt + 64})
        if not sampled:
            emit(label, batch=b, **cache, **out["greedy"])
            continue
        logits = torch.randn(b, v, device="cuda", generator=gen) * 3
        sp = params.to("cuda")
        keys = sampling.row_split(sp.rng)[1]
        parts = {
            "threefry_gumbel": lambda: sampling.gumbel(keys, v),
            "sort_filter": lambda: sampling.filtered_logits(logits, sp.temperature, sp.top_k,
                                                            sp.top_p),
            "select_token": lambda: sampling.select_token(logits, sp)[0],
            "argmax": lambda: logits.argmax(dim=-1),
        }
        sampler = {}
        for name, fn in parts.items():
            with torch.inference_mode():
                e = capture_graph("sampler", fn, None, "cuda")
                split = profile_split(e.replay, 3, r"^$", "none")
                sampler[name] = {"graph_ms": cuda_ms(e.replay, 20),
                                 "busy_ms": split["device_busy_ms"], "kernels": split["kernels"]}
        g, sm = out["greedy"]["graph"], out["sampled"]["graph"]
        emit(label, batch=b, **cache, vocab=v, **out, sampler=sampler,
             sampled_minus_greedy_busy_ms=(sm["device_busy_ms"] - g["device_busy_ms"]
                                           if sm["device_busy_ms"] and g["device_busy_ms"]
                                           else None),
             sampler_share_of_sampled_busy=(sampler["select_token"]["busy_ms"]
                                            / sm["device_busy_ms"]
                                            if sm["device_busy_ms"] else None))


def phase_sampler() -> dict:
    """The sampler on the card against the same functions on the CPU, at
    B = 16 and GPT-2's V = 50257: the split keys, threefry bits and
    uniforms of three chained steps equal bit for bit, the Gumbel noise
    within GUMBEL_TOL (the two sides' log), and ``select_token`` over four
    steps of the same f32 logits gives the same rng chains and tokens (a
    token may differ only where the CPU's two best perturbed scores are
    closer than twice the two sides' largest score difference)."""
    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.models import sampling

    b, v = 16, GPT2_VOCAB
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 2**32, b).astype(np.uint32)
    temp = np.array([0.0, 0.7, 1.0, 1.3] * 4, np.float32)
    top_k = np.array([0, 40, 1, 0, 40, 0, 5, 0] * 2, np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5] * 2 + [0.9, 1.0, 1.0, 0.9] * 2, np.float32)
    logits = torch.from_numpy((rng.standard_normal((b, v)) * 3).astype(np.float32))
    cpu = sampling.make_params(seeds, temp, top_k, top_p)
    card = cpu.to("cuda")
    rc, rg = cpu.rng, card.rng
    gumbel_err, gumbel_equal = 0.0, []
    for _ in range(3):
        rc, kc = sampling.row_split(rc)
        rg, kg = sampling.row_split(rg)
        bc, bg = sampling.random_bits(kc, v), sampling.random_bits(kg, v)
        uc, ug = sampling.uniforms(bc), sampling.uniforms(bg)
        if not (torch.equal(kc, kg.cpu()) and torch.equal(bc, bg.cpu())
                and torch.equal(uc, ug.cpu())):
            raise AssertionError("threefry keys, bits or uniforms differ between card and CPU")
        gc, gg = -torch.log(-torch.log(uc)), -torch.log(-torch.log(ug)).cpu()
        gumbel_err = max(gumbel_err, float(((gc - gg).abs() / (1 + gc.abs())).max()))
        gumbel_equal.append(float((gc == gg).float().mean()))
    if gumbel_err > GUMBEL_TOL:
        raise AssertionError(f"Gumbel noise differs between card and CPU by {gumbel_err}")
    lg = logits.to("cuda")
    parted = []
    for step in range(4):
        keys = sampling.row_split(cpu.rng)[1]
        tc, cpu = sampling.select_token(logits, cpu)
        tg, card = sampling.select_token(lg, card)
        if not torch.equal(cpu.rng, card.rng.cpu()):
            raise AssertionError("select_token's rng chains differ between card and CPU")
        for r in (tc != tg.cpu()).nonzero().flatten().tolist():
            z = [sampling.filtered_logits(x[r:r + 1], p.temperature[r:r + 1],
                                          p.top_k[r:r + 1], p.top_p[r:r + 1]).cpu()[0]
                 for x, p in ((logits, cpu), (lg, card))]
            g = sampling.gumbel(keys[r:r + 1], v)[0]
            sc, sg = z[0] + g, z[1] + g
            both = (z[0] > -1e8) & (z[1] > -1e8)
            margin = float(sc.topk(2).values[0] - sc.topk(2).values[1])
            diff = float((sc - sg).abs()[both].max()) + 2 * GUMBEL_TOL * float(g.abs().max())
            parted.append(dict(step=step, row=r, margin=margin, diff=diff))
            if temp[r] <= 0 or margin > 2 * diff:
                raise AssertionError(f"select_token differs between card and CPU: {parted}")
    out = dict(batch=b, vocab=v, steps=4, keys_bits_uniforms_equal=True,
               gumbel_max_rel_err=gumbel_err, gumbel_tol=GUMBEL_TOL,
               gumbel_bitwise_share=min(gumbel_equal), rng_chains_equal=True,
               tokens_parted=parted)
    emit("sampler", **out)
    return out


def gpt2_pytree(cfg, seed: int) -> dict:
    """Random weights in the JAX package's GPT-2 layout (numpy f32,
    ``[d_in, d_out]`` kernels) at its init's scales: N(0, 0.02) token
    table and projections, N(0, 0.01) positions, zero biases, unit
    LayerNorm scales."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def w(std, *shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= std
        return a

    d, f = cfg.d_model, cfg.d_ff

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def dense(n_in, n_out):
        return {"kernel": w(0.02, n_in, n_out), "bias": np.zeros(n_out, np.float32)}

    return {
        "wte": {"embedding": w(0.02, cfg.vocab_size, d)},
        "wpe": {"embedding": w(0.01, cfg.max_position, d)},
        "layers": [{"ln1": ln(), "attn": {"qkv": dense(d, 3 * d), "out": dense(d, d)},
                    "ln2": ln(), "mlp": {"up": dense(d, f), "down": dense(f, d)}}
                   for _ in range(cfg.num_layers)],
        "final_ln": ln(),
    }


def t5_pytree(cfg, seed: int) -> dict:
    """Random weights in the JAX package's T5 layout (numpy f32, ``[d_in,
    d_out]`` kernels) at the JAX init's scales, with an untied N(0, 1)
    ``lm_head`` kernel: a tied head on random weights argmax-locks onto one
    token, and every token check would pass vacuously."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def w(std, *shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= std
        return a

    d, inner, f = cfg.d_model, cfg.inner_dim, cfg.d_ff

    def ln():
        return {"scale": np.ones(d, np.float32)}

    def attn(rel: bool) -> dict:
        p = {"q": {"kernel": w((d * cfg.d_kv) ** -0.5, d, inner)},
             "k": {"kernel": w(d ** -0.5, d, inner)}, "v": {"kernel": w(d ** -0.5, d, inner)},
             "out": {"kernel": w(inner ** -0.5, inner, d)}}
        if rel:
            p["rel_bias"] = {"embedding": w(d ** -0.5, cfg.rel_buckets, cfg.num_heads)}
        return p

    def mlp() -> dict:
        return {"wi": {"kernel": w(d ** -0.5, d, f)}, "wo": {"kernel": w(f ** -0.5, f, d)}}

    layers = range(cfg.num_layers)
    return {
        "shared": {"embedding": w(1.0, cfg.vocab_size, d)},
        "encoder": {"layers": [{"attn": attn(i == 0), "attn_ln": ln(), "mlp": mlp(),
                                "mlp_ln": ln()} for i in layers], "final_ln": ln()},
        "decoder": {"layers": [{"self_attn": attn(i == 0), "self_attn_ln": ln(),
                                "cross_attn": attn(False), "cross_attn_ln": ln(),
                                "mlp": mlp(), "mlp_ln": ln()} for i in layers],
                    "final_ln": ln()},
        "lm_head": {"kernel": w(1.0, d, cfg.vocab_size)},
    }


def t5_long_wave(rehearsal: bool, n: int = 4, lengths=None):
    """``n`` document-like prompts (rehearsal: 100-120 bytes; on the card
    300-480, the 512 bucket), the second sampled and seeded, the third with
    a max_tokens."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(2)
    words = ["summarize", "the", "document", "encoder", "decoder", "relative", "bias", "wave"]
    lo, hi = lengths or ((100, 120) if rehearsal else (300, 480))
    wave = []
    for i in range(n):
        length = int(rng.integers(lo, hi))
        text = " ".join(rng.choice(words, size=length))[:length]
        kw = dict(temperature=0.9, top_k=40, seed=77) if i == 1 else {}
        wave.append(RawItem(text=text, max_tokens=20 if i == 2 else None, **kw))
    return wave


def start_calls(bundle, before: dict) -> int:
    """Runs of the bundle's ``start`` graphs since ``before``
    (``replays_of``): replays, and a capture's eager run."""
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    return sum(e.replays - before.get(id(e), 0) + (id(e) not in before)
               for e in CACHE.entries(bundle) if e.kind == "start")


def bucket_tables_check(bundle) -> dict:
    """T5's bucket tables on the device against the CPU's (numpy f32, the
    reference's integers), every width the run used."""
    import numpy as np

    t5 = family(bundle)
    checked = []
    for (kind, width, _), table in sorted(bundle.model._buckets.items()):
        fn = t5.encoder_buckets if kind == "encoder" else t5.decoder_buckets
        if not np.array_equal(table.cpu().numpy(), fn(bundle.cfg, width)):
            raise AssertionError(f"T5 {kind} bucket table at width {width} differs on the "
                                 f"device from the CPU's")
        checked.append(f"{kind}:{width}")
    if not checked:
        raise AssertionError("no T5 bucket table was built")
    return {"tables": checked}


def stream_graph_vs_eager(engine, f: dict) -> dict:
    """One stream through ``generate_stream`` with the engine's graphs and,
    with its graphs off, eagerly: tokens identical."""
    import numpy as np

    graphs = engine.graphs
    got = np.concatenate(list(engine.generate_stream(f)))
    engine.graphs = None
    try:
        want = np.concatenate(list(engine.generate_stream(f)))
    finally:
        engine.graphs = graphs
    if not np.array_equal(got, want):
        raise AssertionError("per-stream tokens through graphs differ from eager ones")
    return {"tokens": int(got.size), "tokens_identical": True}


def phase_serve_t5(label: str, overrides: dict, params, ref_model, waves, rehearsal: bool,
                   card_line: str, stream: bool = False):
    """T5-small served at full width, whole through ``Batcher.submit`` or
    streamed through ``Batcher.submit_stream`` (the continuous loop, or the
    per-stream path for prompts past the largest seq bucket and under
    ``CONTINUOUS_BATCHING=0``): K1 launched 6 times per run of a ``start``
    graph (replays and capture runs) and K2 never; every token teacher-forced
    (greedy and sampled) against an f32 forward through K1's plain version
    on the same weights, the solo request (the last of ``waves``, from
    ``with_solo``) against its run in the full wave, the device's bucket
    tables against the CPU's; streamed through the loop, one chunk of its
    slot state timed."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention, fused_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    loop = batcher._cdl
    warm_s = batcher.warm_engine() + (batcher.warm_streams() if stream else 0.0)
    waves, solo = with_solo(waves)

    fused_attention.launches = decode_attention.launches = 0
    engine.dispatches = engine.decode_steps = 0
    if loop is not None:
        loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
    marks = graph_marks(bundle)
    if stream:
        feats, rows, latencies, ttfts, wall = asyncio.run(drive_streams(batcher, bundle, waves))
    else:
        feats, rows, latencies, wall = asyncio.run(drive(batcher, bundle, waves))
        ttfts = None
    k1, k2 = fused_attention.launches, decode_attention.launches
    starts = start_calls(bundle, marks[0])
    gdrive = graph_drive(bundle, marks, {"fused_attention": k1})
    if not rehearsal and (starts < 1 or k1 != T5_LAYERS * starts):
        raise AssertionError(f"{label}: fused_attention launched {k1} times over {starts} "
                             f"start runs; the encoder must launch it {T5_LAYERS} times each")
    if k2:
        raise AssertionError(f"{label}: decode_attention launched {k2} times; T5's decoder "
                             "attention is plain PyTorch")
    if loop is not None and loop.admitted != 0:
        raise AssertionError(f"{label}: {loop.admitted} streams never released")
    if batcher._active_streams:
        raise AssertionError(f"{label}: {batcher._active_streams} per-stream workers left")
    for f, row in zip(feats, rows):
        budget = min(int(f.get("max_tokens", engine.max_decode_len)), engine.max_decode_len)
        if row.dtype != np.int32 or not (1 <= len(row) <= budget if stream
                                         else row.shape == (engine.max_decode_len,)):
            raise AssertionError(f"{label}: bad token row {row!r} (budget {budget})")
    check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
    budget = min(int(feats[solo].get("max_tokens", engine.max_decode_len)),
                 engine.max_decode_len)
    alone = alone_vs_batch(bundle, ref_model, feats[solo], rows[solo][:budget],
                           rows[-1][:budget], check["tol"])
    lat = np.array(latencies) * 1e3
    out = dict(
        device=str(bundle.device), card=card_line, layers=bundle.cfg.num_layers,
        streamed=stream, path=("loop" if loop is not None else "per-stream") if stream
        else "whole", requests=len(rows), longest_prompt=max(int(f["length"]) for f in feats),
        dispatches=engine.dispatches, start_runs=starts, fused_attention_launches=k1,
        admission_waves=loop.prefill_dispatches if loop is not None else None,
        chunk_dispatches=loop.chunk_dispatches if loop is not None else None,
        warmup_s=warm_s, p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        ttft_p50_ms=float(np.percentile(np.array(ttfts) * 1e3, 50)) if ttfts else None,
        generated_tok_per_s=check["tokens_checked"] / wall,
        graph_modes=engine.graph_modes(), bucket_tables=bucket_tables_check(bundle),
        seeded_alone_vs_batch=alone, **check,
    )
    if stream and loop is not None and not rehearsal:
        out["chunk"] = time_chunk(engine, loop)
    emit(label, **out)
    return cfg, bundle, engine, k1, gdrive, feats, loop


def phase_t5_timings(bundle, engine) -> None:
    """Where T5's time goes on the card: ``start`` (encode, the cross K/V,
    the first chunk) at B in {1, 8, 32}, S=512, eager and as the bucket's
    graph, split into K1, GEMMs and the rest; then one decode step at the
    same batches over a 64-position cache (``phase_decode_step``; K1 runs in
    none)."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models.sampling import greedy_params

    gen = torch.Generator(device="cuda").manual_seed(4)
    for b in (1, 8, 32):
        shape = (b, 512)
        ids = torch.randint(5, 261, shape, device="cuda", generator=gen, dtype=torch.int32)
        mask = torch.ones_like(ids)
        with engine._lock, torch.inference_mode():
            entry = engine._graph("start", shape, False,
                                  lambda: engine._make_start(shape, False))
            entry.inputs[0].copy_(ids)
            entry.inputs[1].copy_(mask)
            entry.inputs[2].copy_(greedy_params(b, "cuda"))

            def eager():
                state = bundle.init_state(ids, mask, engine.max_decode_len)
                return bundle.generate_chunk(state, engine.chunk_tokens)

            out = eager_and_graph(eager, entry.replay, 5, K1_KERNEL, "attention",
                                  count=LAUNCHED_KERNEL["fused_attention"])
        emit("start t5", shape=list(shape), chunk=engine.chunk_tokens, **out)
    phase_decode_step(bundle, "decode step t5", batches=(1, 8, 32), prompt=512,
                      kernel=(K1_KERNEL, "attention"))


def ndjson_text(body: str) -> dict:
    """The final line of an ndjson stream, checked: its deltas concatenate
    to its text."""
    lines = [json.loads(ln) for ln in body.splitlines() if ln]
    final = lines[-1]
    if not final.get("done") or "".join(ln["delta"] for ln in lines[:-1]) != \
            final["prediction"]["text"]:
        raise AssertionError(f"bad ndjson stream: {body[:400]}")
    return {k: final[k] for k in ("tokens_generated", "decode_steps", "finish_reason")}


def sse_text(body: str) -> dict:
    """An SSE completion stream, checked: it ends with ``data: [DONE]``
    and exactly one event carries a finish reason."""
    frames = [f for f in body.split("\n\n") if f]
    if frames[-1] != "data: [DONE]":
        raise AssertionError(f"SSE stream without [DONE]: {body[-400:]}")
    events = [json.loads(f[len("data: "):]) for f in frames[:-1]]
    finals = [e["choices"][0]["finish_reason"] for e in events
              if e["choices"] and e["choices"][0]["finish_reason"]]
    if len(finals) != 1:
        raise AssertionError(f"SSE stream with finish reasons {finals}")
    return {"events": len(events), "finish_reason": finals[0]}


async def http_check(cfg, bundle, engine, posts) -> list:
    """POST each ``(path, body, read)`` (GET where ``body`` is None) over
    loopback through the aiohttp app: a dict as JSON, bytes as a raw
    ``image/png`` body, anything else (a multipart writer) as it is;
    ``read`` turns a 200's body text into what is collected."""
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
        out = []
        async with aiohttp.ClientSession() as session:
            for _ in range(600):
                async with session.get(f"{url}/readyz") as r:
                    if r.status == 200:
                        break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError("/readyz never turned 200")
            for path, body, read in posts:
                if body is None:
                    request = session.get(f"{url}{path}")
                elif isinstance(body, dict):
                    request = session.post(f"{url}{path}", json=body)
                elif isinstance(body, bytes):
                    request = session.post(f"{url}{path}", data=body,
                                           headers={"Content-Type": "image/png"})
                else:
                    request = session.post(f"{url}{path}", data=body)
                async with request as r:
                    text = await r.text()
                    if r.status != 200:
                        raise AssertionError(f"{path} answered {r.status}: {text[:400]}")
                    out.append(read(text))
        return out
    finally:
        await runner.cleanup()


def json_key(key: str):
    def read(text: str):
        answer = json.loads(text)
        if key not in answer:
            raise AssertionError(f"answer without {key!r}: {answer}")
        return answer[key]

    return read


def perf_main() -> int:
    """``--perf``: the phases that time the decode kernels, alone and inside
    the decode step and the loop chunk; prints no result line.  Run from
    the root of another tree's checkout, the same phases time that tree's
    kernels, so two trees compare on one card, in turns."""
    import torch

    from mlmicroservicetemplate_tpu_torch.serve import build_service

    phase = "env"
    try:
        if not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        emit(phase, card=card(), torch=torch.__version__, cuda=torch.version.cuda, mode="perf")
        phase = "build"
        phase_build(require_mma=False)  # counted, not required: any tree's kernels
        phase = "kernel decode_attention"
        phase_decode_kernel()
        phase = "kernel paged_decode_attention"
        phase_paged_kernel()
        phase = "decode step"
        llama = {"MODEL_NAME": "llama", "DEVICE": "cuda", "WARMUP": "0",
                 "BATCH_BUCKETS": "1,2,4,8,16", "SEQ_BUCKETS": "32,64,128,256"}
        bundle = build_service(llama)[1]
        phase_decode_step(bundle)
        del bundle
        for phase, paged in (("stream chunk", "1"), ("stream chunk contiguous", "0")):
            torch.cuda.empty_cache()
            _, bundle, engine, batcher = build_service(
                {**llama, "PAGED_KV": paged, "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "16",
                 "MAX_DECODE_LEN": "64"})
            batcher.warm_streams()
            emit(phase, paged=engine.paged_kv, **time_chunk(engine, batcher._cdl))
            del bundle, engine, batcher
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="skip build and kernel phases; serve on the CPU at small buckets")
    ap.add_argument("--perf", action="store_true",
                    help="only the decode kernels' phases, the decode step and a loop chunk")
    args = ap.parse_args(argv)
    if args.perf:
        return perf_main()
    rehearsal = args.cpu_rehearsal
    phase = "env"
    try:
        import torch

        import mlmicroservicetemplate_tpu_torch  # noqa: F401  (fails without the package)

        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             python=sys.version.split()[0])
        headline = decode_headline = paged_headline = ring_headline = ring_serving = None
        t5_headline = None
        skip_graphs = "cpu rehearsal: no CUDA graphs on the CPU"

        def graphs(label, bundle, gdrive, **checks):
            if rehearsal:
                emit(f"graphs {label}", skipped=skip_graphs)
            else:
                phase_graphs(label, bundle, **gdrive, **{k: f() for k, f in checks.items()})

        if rehearsal:
            emit("build", skipped="cpu rehearsal: no nvcc, no kernels")
            for name in ("fused_attention", "fused_attention t5", "decode_attention",
                         "paged_decode_attention", "ring_hop"):
                emit(f"kernel {name}", skipped="cpu rehearsal: the plain version runs")
            emit("sampler", skipped="cpu rehearsal: no card to hold the CPU against")
            emit("kernel graphs", skipped=skip_graphs)
        else:
            phase = "build"
            libraries = phase_build()
            phase = "kernel fused_attention"
            headline = phase_kernel()
            phase = "kernel fused_attention t5"
            t5_headline = phase_t5_kernel(libraries)
            phase = "kernel decode_attention"
            decode_headline, gpt2_decode = phase_decode_kernel()
            phase = "kernel paged_decode_attention"
            paged_headline, gpt2_paged = phase_paged_kernel()
            phase = "sampler"
            phase_sampler()
            phase = "kernel ring_hop"
            ring_headline, ring_serving = phase_ring_kernel()
            phase = "kernel graphs"
            phase_kernel_graphs()
        phase = "serve bert-base"
        cfg, bundle, engine, launches, gdrive, feats = phase_serve(rehearsal, card_line)
        phase = "graphs bert-base"
        graphs("bert-base", bundle, gdrive,
               graph_vs_eager=lambda: logits_graph_vs_eager(engine, feats[-16:]))
        if rehearsal:
            emit("forward", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "forward"
            phase_forward(bundle, engine)

        phase = "serve resnet50"
        img_cfg, img_bundle, img_engine, gdrive, feats = phase_serve_resnet(rehearsal, card_line)
        phase = "graphs resnet50"
        graphs("resnet50", img_bundle, gdrive,
               graph_vs_eager=lambda: logits_graph_vs_eager(img_engine, feats[-16:]))
        if rehearsal:
            emit("forward resnet50", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "forward resnet50"
            phase_forward_resnet(img_bundle, img_engine)

        phase = "serve bert-long"
        (long_cfg, long_bundle, long_engine, long_launches, long_feats,
         gdrive) = phase_serve_long(rehearsal, card_line)
        phase = "graphs bert-long"
        graphs("bert-long", long_bundle, gdrive,
               graph_vs_eager=lambda: logits_graph_vs_eager(long_engine, long_feats[-8:]))
        if rehearsal:
            emit("forward bert-long", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "forward bert-long"
            phase_forward_long(long_bundle, long_engine)
        phase = "ring 4-shard"
        shard4_launches = phase_ring_4shard(long_cfg, long_bundle, long_engine, long_feats,
                                            rehearsal)

        phase = "serve llama"
        from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
            gpt_params_from_jax,
            llama_params_from_jax,
        )
        from mlmicroservicetemplate_tpu_torch.models import gpt as gpt_mod
        from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

        device = "cpu" if rehearsal else "cuda"
        llama_overrides = {"MODEL_NAME": "llama", "DEVICE": device,
                           "BATCH_BUCKETS": "1,2,4,8,16", "SEQ_BUCKETS": "32,64,128,256"}
        dims = {}
        if rehearsal:
            dims = REHEARSAL_LLAMA
            llama_overrides.update(LLAMA_CONFIG=json.dumps(dims), SEQ_BUCKETS="32,64")
        # eos/pad of the byte tokenizer, as the registry sets them
        lcfg = llama_mod.LlamaConfig(**dims, eos_id=1, pad_id=0)
        params = llama_pytree(lcfg, seed=0)
        ref_model = llama_mod.build_model(lcfg, llama_params_from_jax(params, lcfg),
                                          torch.device(device), torch.float32)
        llama_svc = phase_serve_gen(phase, llama_overrides, params, ref_model,
                                    rehearsal, card_line)
        phase = "graphs llama"
        graphs("llama", llama_svc[1], llama_svc[4],
               graph_vs_eager=lambda: tokens_graph_vs_eager(llama_svc[2], llama_svc[5][-16:]))
        # The int8 services and the contiguous loop run at CUT_LAYERS layers
        # (the whole-generation and paged-loop services keep TinyLlama's 22),
        # with weights of their own from seed 0: a llama service's warmup
        # captures 80 graphs, and the run must stay within its time limit.
        cut = {**dims, "num_layers": CUT_LAYERS} if not rehearsal else dims
        ccfg = llama_mod.LlamaConfig(**cut, eos_id=1, pad_id=0)
        cparams = llama_pytree(ccfg, seed=0)
        cref = llama_mod.build_model(ccfg, llama_params_from_jax(cparams, ccfg),
                                     torch.device(device), torch.float32)
        cut_overrides = {**llama_overrides, "LLAMA_CONFIG": json.dumps(cut)}
        phase = "serve llama int8"
        llama8 = phase_serve_gen(phase, {**cut_overrides, "QUANT_KV": "int8"}, cparams, cref,
                                 rehearsal, card_line)
        llama8_launches = llama8[3]
        phase = "graphs llama int8"
        graphs("llama int8", llama8[1], llama8[4],
               graph_vs_eager=lambda: tokens_graph_vs_eager(llama8[2], llama8[5][-16:]))
        release(llama8[1])
        del llama8
        # Streaming through the continuous decode loop: paged (dense, int8),
        # then contiguous slots.
        stream = {"PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "16",
                  "MAX_DECODE_LEN": "64"}
        k2_streams = k3_streams = 0
        stream_svc = None
        # The int8 loop runs unwarmed: its chunks are captured at the first
        # admission, before any slot is live.
        for phase, extra, warm_loop, weights in (
                ("serve llama stream", {}, True, (llama_overrides, params, ref_model)),
                ("serve llama stream int8", {"QUANT_KV": "int8"}, False,
                 (cut_overrides, cparams, cref)),
                ("serve llama stream contiguous", {"PAGED_KV": "0"}, True,
                 (cut_overrides, cparams, cref))):
            svc = phase_serve_stream(phase, {**weights[0], **stream, **extra}, *weights[1:],
                                     rehearsal, card_line, warm_loop)
            k2_streams += svc[3]
            k3_streams += svc[4]
            label = phase[len("serve "):]
            phase = f"graphs {label}"
            graphs(label, svc[1], {**svc[5], "want_misses": 0 if warm_loop else 2},
                   graph_vs_eager=lambda: chunk_graph_vs_eager(svc[2], svc[6]))
            if stream_svc is None:
                stream_svc = svc  # kept for the http phase
            else:
                release(svc[1])
        # Priority classes at full depth: 16 batch streams over a pool of 4
        # worst-case streams (KV_BUDGET_MB; the rehearsal's smaller buckets
        # take 7), then 8 interactive arrivals.  Batch buckets cut to 1, 4
        # and 16 (a wave pads to one): warmup captures 48 graphs, not 80.
        phase = "serve llama classes"
        classes = phase_serve_classes(
            phase, {**llama_overrides, **stream, "BATCH_BUCKETS": "1,4,16",
                    "MAX_STREAM_QUEUE": "16", "PREEMPT": "1"},
            params, ref_model, rehearsal, card_line, n_batch=16, n_inter=8, cap=28,
            budget_streams=7 if rehearsal else 4)
        k2_streams += classes[1].get("decode_attention", 0)
        k3_streams += classes[1].get("paged_decode_attention", 0)
        phase = "graphs llama classes"
        graphs("llama classes", classes[0], classes[2])
        release(classes[0])
        del ref_model, params, cref, cparams
        if rehearsal:
            emit("decode step", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "decode step"
            phase_decode_step(llama_svc[1])

        # GPT-2 small at full width, random weights from seed 0, bf16: whole,
        # then streamed through the loop (paged, then contiguous).
        phase = "serve gpt2"
        gcfg = gpt_mod.GPTConfig(eos_id=1, pad_id=0)
        gparams = gpt2_pytree(gcfg, seed=0)
        gref = gpt_mod.build_model(gcfg, gpt_params_from_jax(gparams, gcfg),
                                   torch.device(device), torch.float32)
        gpt2_overrides = {"MODEL_NAME": "gpt2", "DEVICE": device,
                          "BATCH_BUCKETS": "1,2,4,8,16", "SEQ_BUCKETS": "32,64,128,256"}
        if rehearsal:
            gpt2_overrides.update(BATCH_BUCKETS="1,2,4", SEQ_BUCKETS="32,64",
                                  MAX_DECODE_LEN="16")
        gpt2_svc = phase_serve_gen(phase, gpt2_overrides, gparams, gref, rehearsal, card_line)
        phase = "graphs gpt2"
        graphs("gpt2", gpt2_svc[1], gpt2_svc[4],
               graph_vs_eager=lambda: tokens_graph_vs_eager(gpt2_svc[2], gpt2_svc[5][-16:]))
        gpt2_k2, gpt2_k3 = gpt2_svc[3], 0
        gpt2_stream = None
        for phase, extra in (("serve gpt2 stream", {}),
                             ("serve gpt2 stream contiguous", {"PAGED_KV": "0"})):
            svc = phase_serve_stream(phase, {**gpt2_overrides, "PAGED_KV": "1",
                                             "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "16",
                                             "MAX_DECODE_LEN": "16" if rehearsal else "64",
                                             **extra},
                                     gparams, gref, rehearsal, card_line)
            gpt2_k2 += svc[3]
            gpt2_k3 += svc[4]
            label = phase[len("serve "):]
            phase = f"graphs {label}"
            graphs(label, svc[1], svc[5],
                   graph_vs_eager=lambda: chunk_graph_vs_eager(svc[2], svc[6]))
            if gpt2_stream is None:
                gpt2_stream = svc  # kept for the http phase
            else:
                release(svc[1])
        del gref, gparams
        if rehearsal:
            emit("decode step gpt2", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "decode step gpt2"
            phase_decode_step(gpt2_svc[1], phase, batches=(1, 8, 16), prompt=256,
                              sampled=True)

        # T5-small at full width (6+6 layers, d_model 512, 8 heads of 64,
        # d_ff 2048, vocab 32128), seed-0 weights at the JAX init's scales
        # with an untied head, bf16, the byte tokenizer: whole, through the
        # contiguous loop, and on the per-stream path (two prompts past a cut
        # SEQ_BUCKETS; every stream under CONTINUOUS_BATCHING=0).
        from mlmicroservicetemplate_tpu_torch.convert.jax_params import t5_params_from_jax
        from mlmicroservicetemplate_tpu_torch.models import t5 as t5_mod

        tcfg = t5_mod.T5Config()
        tparams = t5_pytree(tcfg, seed=0)
        tref = t5_mod.build_model(tcfg, t5_params_from_jax(tparams, tcfg), torch.device(device),
                                  torch.float32)
        t5_overrides = {"MODEL_NAME": "t5-small", "DEVICE": device, "BATCH_BUCKETS": "1,4,8,32",
                        "SEQ_BUCKETS": "64,128,512", "MAX_DECODE_LEN": "64",
                        "MAX_STREAMS": "16"}
        cut_seq, long_lens = "64,128,256", ((400, 420), (385, 400))
        if rehearsal:
            t5_overrides.update(BATCH_BUCKETS="1,2,4", SEQ_BUCKETS="32,64,128",
                                MAX_DECODE_LEN="16")
            cut_seq, long_lens = "32,64", ((100, 110), (70, 90))
        t5_waves = gen_waves(rehearsal) + [t5_long_wave(rehearsal)]
        phase = "serve t5"
        t5_svc = phase_serve_t5(phase, t5_overrides, tparams, tref, t5_waves, rehearsal,
                                card_line)
        phase = "graphs t5"
        graphs("t5", t5_svc[1], t5_svc[4],
               graph_vs_eager=lambda: tokens_graph_vs_eager(t5_svc[2], t5_svc[5][-16:]))
        if rehearsal:
            for name in ("start t5", "decode step t5"):
                emit(name, skipped="cpu rehearsal: no card to profile")
        else:
            phase = "start t5"
            phase_t5_timings(t5_svc[1], t5_svc[2])
        phase = "serve t5 stream"
        t5_stream = phase_serve_t5(phase, t5_overrides, tparams, tref, t5_waves, rehearsal,
                                   card_line, stream=True)
        phase = "graphs t5 stream"
        graphs("t5 stream", t5_stream[1], t5_stream[4],
               graph_vs_eager=lambda: chunk_graph_vs_eager(t5_stream[2], t5_stream[6]))
        t5_k1 = t5_svc[3] + t5_stream[3]
        # Priority classes through T5's contiguous loop: 4 batch streams in
        # the 4 slots, then 4 interactive arrivals; the victims replay.
        phase = "serve t5 classes"
        classes = phase_serve_classes(
            phase, {**t5_overrides, "MAX_STREAMS": "4", "MAX_STREAM_QUEUE": "8",
                    "PREEMPT": "1", "BATCH_BUCKETS": "1,4"},
            tparams, tref, rehearsal, card_line, n_batch=4, n_inter=4, cap=28)
        t5_k1 += classes[1].get("fused_attention", 0)
        phase = "graphs t5 classes"
        graphs("t5 classes", classes[0], classes[2])
        release(classes[0])
        # The per-stream path: two prompts of different lengths past the
        # largest of cut buckets (one width, a multiple of 128: start and
        # gen_chunk captured at first use, 2 misses for both), then every
        # stream with the loop off (B=1 buckets, all warmed).
        long_wave = [t5_long_wave(rehearsal, n=1, lengths=lens)[0] for lens in long_lens]
        for phase, extra, waves, misses in (
                ("serve t5 long prompt", {"SEQ_BUCKETS": cut_seq, "BATCH_BUCKETS": "1,4,16"},
                 gen_waves(rehearsal) + [long_wave], 2),
                ("serve t5 per-stream", {"CONTINUOUS_BATCHING": "0", "BATCH_BUCKETS": "1"},
                 gen_waves(rehearsal), 0)):
            if rehearsal and "BATCH_BUCKETS" in extra:
                extra = {**extra, "BATCH_BUCKETS": "1,2,4"}
            svc = phase_serve_t5(phase, {**t5_overrides, **extra}, tparams, tref, waves,
                                 rehearsal, card_line, stream=True)
            widest = max(svc[5], key=lambda f: int(f["length"]))
            label = phase[len("serve "):]
            phase = f"graphs {label}"
            graphs(label, svc[1], {**svc[4], "want_misses": misses},
                   graph_vs_eager=lambda: stream_graph_vs_eager(svc[2], widest))
            t5_k1 += svc[3]
            release(svc[1])
        del tref, tparams

        phase = "http"
        try:
            import aiohttp  # noqa: F401
        except ImportError:
            emit(phase, skipped="aiohttp is not installed; HTTP is no device path")
        else:
            (prediction,) = asyncio.run(http_check(
                cfg, bundle, engine,
                [("/predict", {"text": "hello card"}, json_key("prediction"))]))
            long_prediction, n_devices = asyncio.run(http_check(
                long_cfg, long_bundle, long_engine,
                [("/predict", {"text": "a long context request " * 80}, json_key("prediction")),
                 ("/status", None, json_key("n_devices"))]))
            if n_devices != long_bundle.placement.n_devices:
                raise AssertionError(f"/status n_devices {n_devices}, placement "
                                     f"{long_bundle.placement.n_devices}")
            chat = [{"role": "system", "content": "be brief"},
                    {"role": "user", "content": "hello card"}]
            generated = asyncio.run(http_check(*llama_svc[:3], [
                ("/predict", {"text": "hello card", "max_tokens": 8, "stop": ["zz"]},
                 json_key("prediction")),
                ("/v1/completions", {"prompt": "hello card", "max_tokens": 8}, json_key("usage")),
                ("/v1/completions", {"prompt": "hello card", "max_tokens": 8,
                                     "temperature": 0.8, "top_k": 40, "seed": 3},
                 json_key("usage")),
                ("/v1/chat/completions", {"messages": chat, "max_tokens": 8},
                 json_key("choices")),
                ("/v1/models", None, json_key("data")),
            ]))
            gpt2_whole = asyncio.run(http_check(*gpt2_svc[:3], [
                ("/v1/chat/completions", {"messages": chat, "max_tokens": 8, "temperature": 0.9,
                                          "top_p": 0.9, "seed": 5}, json_key("choices")),
                ("/v1/models", None, json_key("data")),
            ]))
            try:
                import PIL  # noqa: F401  (decodes the image bodies)
            except ImportError:
                image = {"skipped": "PIL is not installed; it is needed only to decode "
                                    "image bodies"}
            else:
                from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

                data = png_bytes(9)
                raw, multipart = asyncio.run(http_check(img_cfg, img_bundle, img_engine, [
                    ("/predict", data, json_key("prediction")),
                    ("/predict", multipart_file(data), json_key("prediction")),
                ]))
                top1 = int(img_engine.run_batch(
                    [img_bundle.preprocess(RawItem(image=data))])[0].argmax())
                if raw["class_id"] != top1 or multipart["class_id"] != top1:
                    raise AssertionError(f"/predict class ids {raw}, {multipart}; "
                                         f"the engine's top-1 {top1}")
                image = {"raw_png": raw, "multipart_file": multipart, "engine_top1": top1}
            streamed = asyncio.run(http_check(*stream_svc[:3], [
                ("/predict", {"text": "hello card", "stream": True, "max_tokens": 12},
                 ndjson_text),
                ("/v1/completions", {"prompt": "hello card", "stream": True, "max_tokens": 12,
                                     "stream_options": {"include_usage": True}}, sse_text),
                ("/v1/chat/completions", {"messages": chat, "stream": True, "max_tokens": 12},
                 sse_text),
            ]))
            gpt2_streamed = asyncio.run(http_check(*gpt2_stream[:3], [
                ("/predict", {"text": "hello card", "stream": True, "max_tokens": 12,
                              "temperature": 0.8, "top_k": 40, "seed": 6}, ndjson_text),
                ("/v1/chat/completions", {"messages": chat, "stream": True, "max_tokens": 12,
                                          "temperature": 1.0, "seed": 7}, sse_text),
                ("/v1/completions", {"prompt": "hello card", "stream": True, "max_tokens": 12},
                 sse_text),
            ]))
            t5_whole = asyncio.run(http_check(*t5_svc[:3], [
                ("/predict", {"text": "summarize: hello card", "max_tokens": 8},
                 json_key("prediction")),
                ("/v1/completions", {"prompt": "hello card", "max_tokens": 8,
                                     "temperature": 0.8, "top_k": 40, "seed": 3},
                 json_key("usage")),
                ("/v1/chat/completions", {"messages": chat, "max_tokens": 8},
                 json_key("choices")),
                ("/v1/models", None, json_key("data")),
            ]))
            t5_streamed = asyncio.run(http_check(*t5_stream[:3], [
                ("/predict", {"text": "summarize: hello card", "stream": True,
                              "max_tokens": 12}, ndjson_text),
                ("/v1/completions", {"prompt": "hello card", "stream": True, "max_tokens": 12,
                                     "temperature": 0.9, "seed": 4}, sse_text),
                ("/v1/chat/completions", {"messages": chat, "stream": True, "max_tokens": 12},
                 sse_text),
            ]))
            emit(phase, status=200, prediction=prediction,
                 bert_long_prediction=long_prediction, bert_long_n_devices=n_devices,
                 resnet50=image, llama_prediction=generated[0],
                 llama_completion_usage=generated[1], llama_sampled_usage=generated[2],
                 llama_chat=generated[3], llama_models=generated[4],
                 llama_stream_predict=streamed[0], llama_stream_completions=streamed[1],
                 llama_stream_chat=streamed[2], gpt2_chat_sampled=gpt2_whole[0],
                 gpt2_models=gpt2_whole[1], gpt2_stream_predict_sampled=gpt2_streamed[0],
                 gpt2_stream_chat_sampled=gpt2_streamed[1],
                 gpt2_stream_completions=gpt2_streamed[2], t5_prediction=t5_whole[0],
                 t5_sampled_usage=t5_whole[1], t5_chat=t5_whole[2], t5_models=t5_whole[3],
                 t5_stream_predict=t5_streamed[0], t5_stream_completions_sampled=t5_streamed[1],
                 t5_stream_chat=t5_streamed[2])
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    if rehearsal:
        print("chip_smoke: cpu rehearsal passed (no result line: nothing ran on a card)")
        return 0

    def gpt2_entry(row: dict, launches: int) -> dict:
        return {"launches": launches, "shape": row["shape"], "dtype": row["dtype"],
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "device_us": row["device_us"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "library_device_us": row.get("library_device_us")}

    def kernel_entry(name: str, replaces: str, launches: int, row: dict, **extra) -> dict:
        return {
            "name": name, "route": "cuda",
            "source": f"mlmicroservicetemplate_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "dtype": row["dtype"], "shape": row["shape"],
            **{key: row[key] for key in ("device_us", "host_us", "library_device_us")
               if key in row},
            **extra,
        }

    print(json.dumps({"kernels": [
        # launches: BERT-base's and T5's encoder (with its bias, beside its
        # own case's numbers), each served path of the run.
        kernel_entry("fused_attention", "mlmicroservicetemplate_tpu/ops/attention.py:400",
                     launches + t5_k1, headline, tflops=headline["tflops"],
                     tflops_every_key=headline["tflops_every_key"],
                     t5={**gpt2_entry(t5_headline, t5_k1), "bias": t5_headline["bias"],
                         "bias_path": t5_headline["bias_path"],
                         "mask": t5_headline["mask"], "tflops": t5_headline["tflops"],
                         "bias_variants_ptxas": t5_headline["bias_variants_ptxas"]}),
        # launches: llama's and GPT-2's (at R = 1, beside its own case's
        # numbers), each served path of the run.
        kernel_entry("decode_attention", "mlmicroservicetemplate_tpu/ops/attention.py:310",
                     llama_svc[3] + llama8_launches + k2_streams + gpt2_k2, decode_headline,
                     gpt2=gpt2_entry(gpt2_decode, gpt2_k2)),
        kernel_entry("paged_decode_attention",
                     "mlmicroservicetemplate_tpu/ops/paged_attention.py:353",
                     k3_streams + gpt2_k3, paged_headline, gpt2=gpt2_entry(gpt2_paged, gpt2_k3)),
        # launches: the served bert-long path; the 4-shard check (a direct
        # call, no serving path) is counted apart.
        kernel_entry("ring_hop", "mlmicroservicetemplate_tpu/parallel/ring.py:58",
                     long_launches, ring_headline, launches_4shard_check=shard4_launches,
                     tflops=ring_headline["tflops"],
                     tflops_every_key=ring_headline["tflops_every_key"],
                     fresh_final_ms=ring_serving["kernel_ms"],
                     fresh_final_bound_ms=ring_serving["bound_us"] / 1e3),
    ]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
