#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check every kernel it runs.

    python3 chip_smoke.py                  # on a machine with a CUDA GPU
    python3 chip_smoke.py --cpu-rehearsal  # small CPU dry run of the paths
    python3 chip_smoke.py --perf           # decode kernels' timing phases only
    python3 chip_smoke.py --chunked        # the chunked-prefill phases only
    python3 chip_smoke.py --tier           # the host KV tier's phase only
    python3 chip_smoke.py --window         # the fused decode-window phases only
    python3 chip_smoke.py --pipeline       # the dispatch pipeline's phase only
    python3 chip_smoke.py --spec           # the speculative decoding phase only
    python3 chip_smoke.py --quant          # the QUANTIZE=int8 phase only
    python3 chip_smoke.py --lora           # the LoRA adapters phase only
    python3 chip_smoke.py --faults         # faults, tuning and the converter only
    python3 chip_smoke.py --observe        # the observability phase only
    python3 chip_smoke.py --durable        # the durable-serving phase only
    python3 chip_smoke.py --tenants        # the tenant accounts and fair-share phase only

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
   Each bf16 row also gives ``device_us`` (the profiler's kernel time a
   call: split kernel and combine; ``library_device_us`` SDPA's) and
   ``host_us`` (the wrapper's host time a call, back to back, no
   synchronisation); the other dtypes' rows give None for the three.
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
   weights from seed 0; the int8 service at CUT_LAYERS = 6 layers, the
   first 6 of those weights, to keep the run within its time limit), bf16,
   the dense and the int8 KV cache, on CUT_GRID's buckets (batch 1 and 16,
   seq 256; GPT-2's whole service on the same grid), through
   ``Batcher.submit`` in waves over several buckets, some with ``max_tokens``, every third sampled and
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
7b. serve llama stream / stream int8 / stream contiguous: TinyLlama at
   CUT_LAYERS layers on CUT_GRID's buckets (8g and 8h drive the paged loop
   at full depth) streamed through ``Batcher.submit_stream`` and the
   continuous decode loop (16 slots, 64-token budget): paged KV (16-token blocks) with the
   dense and the int8 cache, then contiguous slots; 32 streams in waves of
   1, 2, 5, 8 and 16.  Every token is teacher-forced as in 7; the paged
   kernel must launch 22 times per slot decode step, the decode kernel 22
   times per step of each admission wave's first chunk (and, contiguous,
   per slot step); the pool must hold 0 blocks after the last stream.
   Every bucket's ``start`` and the loop's chunk are captured before the
   first stream, as the app warms.  Then one chunk of the 16-slot state is
   timed (CUDA events) and split by kernel (``torch.profiler``), eager and
   as the loop's graph.
7c. serve llama classes: TinyLlama at CUT_LAYERS layers through the paged
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
7d. serve llama prefix: TinyLlama at CUT_LAYERS layers through the paged loop with ``PREFIX_CACHE=1`` (16 slots, batch buckets 1 and 16,
   ``PREFIX_CACHE_MB`` of 16 pins of 128 tokens, the default pool of 16
   worst-case streams): 4 conversations of 3 growing turns (each turn a
   wave of 4; a 150-byte system prompt), a shared document once, then 8
   questions on it at once (one grouped hit wave, its rows sharing the
   document's blocks in K3's tables), then 16 batch-class streams that
   each pin 32 tokens hold every slot and 4 interactive ones preempt them
   (the greedy victims recast into their own pins); a third sampled and
   seeded.  Gates: hits and misses, grouped hit waves, recast hits, the
   most blocks shared at once and within one chunk's tables, preemptions
   all > 0; K2 22 a step of every start's first chunk and K3 22 a slot
   step, equal to the replays'; 0 graph misses after warmup (the prefix
   grid, 9 (prefix, suffix) pairs x B 1 and 16 x 2 variants, captured at
   warmup, its captures, seconds and graph-pool bytes printed); the pool
   back to exactly the pins' blocks, 0 after a flush; every token
   teacher-forced against an f32 forward of the whole prompt without the
   cache; TTFT p50/p99 of hits and misses apart.
7e. serve llama chunked: TinyLlama at CUT_LAYERS layers (full depth until
   PR 19, which gave 8g and 8h its time) through the paged loop with
   ``PREFILL_CHUNK=128`` (the budget one window) and
   ``PREFIX_CACHE=1`` (16 slots, batch buckets 1 and 16, 16-token blocks,
   the default pool of 320 blocks, tables of 128 blocks: the position
   budget): 8 short interactive streams decode, then three long prompts
   of 1760-1800 bytes arrive (one interactive, two batch, one of those
   sampled and seeded; each past the largest bucket, 14-15 windows), then
   a fourth that shares the first one's opening once the cache holds it.
   Gates: every token teacher-forced against an f32 forward of the whole
   prompt; ``prefill_chunks_total`` and the loop's count equal to the
   windows the jobs ran (redone windows of checkpointed jobs included); a
   pacer hold, a mid-prefill checkpoint (the batch prompts and the fourth
   outgrow the pool) and a prefix hit whose suffix went through windows;
   K2 and K3 held against the counts; the pool back to its pins, 0 after a
   flush.  Printed: one window's wall and busy time at the longest prompt's
   end (eager and as its graph), one chunk of the 16 slots over their
   128-block tables with every key valid timed and split as in 7b, the
   short streams' largest and median chunk gap during the long prefills
   beside those before, and the long prompts' TTFT.
7f. serve llama tier: TinyLlama at CUT_LAYERS layers (full depth until PR
   19) through the paged loop (16
   slots, 16-token blocks, batch buckets 1 and 16) with ``PREEMPT``,
   ``PREFILL_CHUNK=128``, ``PREFIX_CACHE=1`` (``PREFIX_CACHE_MB`` of two
   and a half 128-token pins) and the host KV tier (``KV_HOST_BUDGET_MB``
   1000, pinned, ``KV_PREFETCH_BLOCKS=4``), over a pool of the long
   prompt's worst case, the pins' blocks and 4 more (140 blocks; 7 worst-case
   streams of the 256 bucket): four conversations on 150-byte system prompts (the last two
   evict the first two pins, which are demoted), 16 batch streams then 8
   interactive ones (the victims swap out; greedy ones recast, sampled
   ones replay), the first conversation's next turn (its pin promoted back),
   then 8 short interactive streams and a 1780-byte prompt that outgrows
   the pool mid-prefill (its consumed windows swap out; it resumes
   partially).  Gates: every token teacher-forced; swap-outs, whole and
   partial swap-ins, promotions and prefetch blocks copied while decode
   was live > 0; no fallback; the long prompt's windows its uninterrupted
   count; K2 and K3 held against the counts; 0 misses; the pool back to
   its pins, then 0 after a flush; no stream entry left on the host.
   Printed: swap bytes, one swap-out (gather and copy to the host) and one
   4-block prefetch (copy to the card and scatter) timed by CUDA events
   with GB/s, the pinning time, the overlap ratio, the resume latency of
   swapped streams and of the long prompt, its TTFT and the chunk
   boundaries its prefetch took.
7g. serve llama window (``--window`` only; the main run keeps GPT-2's
   windows, 8d): fused decode windows, TinyLlama at full depth
   through the paged loop (16 slots, 16-token blocks, batch buckets 1 and
   16, one seq bucket) with ``DECODE_WINDOW=8`` and AUTO on.  A probe
   service (``DECODE_WINDOW=1``, the model's own eos) streams 240 candidate
   prompts (every third sampled and seeded) and 8 interactive ones alone;
   the token that first appears at steps 8-55 of the most candidates is
   rigged as the eos; 15 batch-class streams that end on it (a third
   sampled where that many do; budgets mixed, each past its eos) start at
   once and, once one has 12 tokens, an interactive one that ends on it
   too arrives.  The same traffic runs on a service at
   ``DECODE_WINDOW=1`` and on one at 8, twice each (the second pass
   measured), then the batch streams alone (the interactive one holds W
   at 1 from its arrival on, so only this pass measures windows end to
   end), then a stream alone whose eos comes a chunk or two into its first
   window.  Gates: windows formed, the lone stream's first window ended
   early; the same tokens at both depths, in every measured pass (any
   stream that differs is printed); the governor at 1 while the interactive stream is live or
   waiting and above 1 before; every token teacher-forced; K2 and K3 held
   against the loop's counts; the pool empty.  Printed, for the mixed
   pass and the batch-only one: window dispatches, chunks and early
   exits, the governor's depths over time, chunk and fetch boundaries per
   token and tokens/s at both depths, the device ms of the chunks windows
   ran past every row's end (CUDA events around each chunk), K2/K3
   launches, and each service's warm-up seconds.
8. decode step: where one llama decode step's time goes at B in {1, 8,
   32}, T=576: wall time against busy time, split into K2, GEMMs, other,
   eager and as a graph of the step.
8g. serve quantize (``--quant`` runs the build and 8g alone): weight-only
   int8 (``QUANTIZE=int8``).  TinyLlama at full width (22 layers under
   ``--quant``, the first ``CUT_LAYERS`` in the main run; seed-0 weights
   cast to bf16, then quantized on the card) whole (K2) and through
   the paged loop (16 slots, K3), batch buckets 1 and 16, the waves of 7
   (a third sampled and seeded); the service's q8 and scales must equal
   those of a model quantized the same way, and every token is
   teacher-forced against that model's f32 run on the card (the very int8
   weights, dequantized in f32), with the gates of 7 and 7b.  Printed: the
   resident weight bytes, int8 against bf16 (``torch.cuda.memory_allocated``
   across each service's build), and one decode step at B = 8, T = 576 as a
   graph, int8 against bf16: wall, busy time split into K2, GEMMs, the int8
   converts, the multiplies and the rest.  Then BERT-base (K1 12 a
   dispatch) and ResNet-50 under ``QUANTIZE=int8`` through
   ``Batcher.submit``, every answer against the port's f32 run on the CPU
   of the same int8 weights (the card's state loaded into a CPU service),
   within PROB_TOL and RESNET_LOGIT_TOL as 5 and 6a; 0 graph misses; one
   ``/predict`` each over loopback (ResNet's a PNG, where PIL is installed).
8h. serve llama lora (``--lora`` runs the build and 8h alone): batched
   multi-adapter LoRA.  TinyLlama at full width (22 layers under
   ``--lora``, the first ``CUT_LAYERS`` in the main run) through the paged
   loop (16 slots, one batch bucket, 16, so every start pads to it) with
   ``ADAPTER_DIR`` a temporary directory of three adapters of q/k/v/o
   written from seed 0 (ranks 8, 16 with alpha 32, 8 with alpha 16) and
   ``ADAPTER_SLOTS=2``: two waves of 12 streams on alpha, beta and none in
   turn (every fourth sampled and seeded), a wave of 4 on gamma and 2 on
   none (gamma's install evicts), then alpha and beta streams hold both
   slots and a gamma one sheds ``adapter_pool``.  Gates: every token
   teacher-forced against the f32 run on the card of the same weights
   through that row's adapter; every row without an adapter gets the
   tokens of a service without ``ADAPTER_DIR`` on the same traffic, and
   adapted rows other ones; installs and evictions > 0 and no graph
   captured after warmup (an install after the drive too); K2 and K3 held
   against the loop's counts; the pool's refs back to 0, no block left.
   Printed: an install's ms, and one chunk of the 16 slots with and
   without the adapters (as 7b, as graphs only), whose busy difference
   over the chunk's steps is the delta's device ms a step.
8i. serve llama faults (``--faults`` runs the build, 8i and ``convert
   gpt2`` alone): TinyLlama at full width (22 layers, seed-0 weights)
   through the paged loop's graphs (4 slots, one seq bucket of 256, 48
   tokens in chunks of 4), four streams (one sampled), each case an engine of its
   own over one bundle.  clean: the heuristic split, every token
   teacher-forced, K3 22 a slot step.  autotune: ``PALLAS_AUTOTUNE=1`` on
   a fresh table; every feasible split count of K3 verified against the
   plain version, then timed (CUDA events behind a device spin), each
   candidate's device µs and the winner printed; the loop's K3 plans at
   the winner, its tokens the clean run's; a second engine on the table
   (the process table forgotten) hits it, no sweep.  pin:
   ``PALLAS_VARIANT`` at a split that is not the heuristic's.  fatal
   (``chunk:fatal@5``), transient (``chunk:transient@2+3``, three retries)
   and hang (``chunk:hang(30)@5``, ``DISPATCH_TIMEOUT_S=3``): the streams
   resume with the clean run's tokens (identical, or a greedy row parting
   at a near tie; every token teacher-forced), one rebuild for fatal and
   hang (none for transient), no capture in the drive, the chunk graphs
   replayed after the rebuild over the slot state's same addresses; the rebuild's ms and the fault to the
   first resumed token printed.  budget (``chunk:fatal~1``,
   ``ENGINE_RESTARTS_MAX=1``): through the app, the stream fails,
   ``/readyz`` answers 503 with the reference's body.  Then (in the main
   run while 8k's first child boots) ``convert gpt2``: the converter CLI's entry point on a
   seed-0 GPT-2 HF state dict at full width (the main run: its first
   ``CUT_LAYERS`` layers, through ``--num-layers``); ``MODEL_PATH`` at its
   output and at the ``.npz`` give equal parameters and bf16 logits on the
   card.  Beside it, ``serve llama faults sticky``: a child process's
   device-side assert and the call after it classify as a poisoned
   context, its out-of-memory error does not.
8j. serve llama observe (``--observe`` runs the build and 8j alone):
   TinyLlama at full width (22 layers, seed-0 weights, bf16; the main run's
   at CUT_LAYERS) through the
   paged loop's graphs (8 slots, one seq bucket of 128, 64 tokens in
   chunks of 4, one dispatch in flight), eight streams (one sampled) queued
   as one wave under ``FAULT_SPEC=chunk:fatal@1;chunk:transient@4`` (the
   fatal fault at the first loop chunk, when nothing is in flight, so the
   resume is the same in both runs), and eight BERT-base ``/predict``
   requests one at a time (K1, 12 launches each), served twice: the layer
   off (``PERF_OBS=0 TRACE=0 FLIGHT_RING=0``) and on (``PERF_OBS=1 TRACE=1
   LOG_FORMAT=json LOCKTRACE=1``, built through ``serve.build_service``).
   Gates: the on-run's tokens the off-run's (identical, or a greedy row
   parting at a near tie; every token teacher-forced), its
   ``dispatch_counts`` and K1 and K3 launches equal; neither drive
   captures a graph; CUDA-event busy time of the drive's graph replays <=
   the estimator's ``device_busy_total_s`` over the drive <= the drive's
   wall time, and the estimate at most ``OBSERVE_BUSY_FACTOR`` (1.5) times
   the events' busy; the chunk graph's modeled FLOPs
   a decode step equal to the hand count of TinyLlama's linears and LM head
   (exact: integer counts), and the book's accrual over the drive equal to
   count x replays; ``mfu_estimate`` > 0; over HTTP, ``/debug/trace``
   parses and holds ``decode_chunk`` and ``dispatch:chunk`` spans,
   ``/debug/engine`` holds iterations, the ``dispatch_retry`` event and one
   dump, ``/status.observability.flight_dumps`` is 1; ``POST /debug/profile
   {"seconds": 2}`` while streams run writes a Chrome trace that names K3's
   split kernel; the lock-order detector reports no violation; every log
   line of the on-run parses as JSON.  Printed: tokens/s with the layer on
   and off (no gate).  Then ``serve llama observe cost``: the same llama
   service at the layer's defaults (``PERF_OBS=1 FLIGHT_RING=256
   TRACE=0``), no fault, the wave's start graph left to the first drive:
   a cold drive (which captures it inside its guarded prefill) and a
   warm one, each with CUDA events around every replay (printed: the
   estimator's busy, the events', the drive's capture seconds; gates: the
   warm drive's tokens teacher-forced, its event busy <= estimated busy <=
   wall), then three pairs
   of drives (two waves each) with the layer's default parts switched on
   and off at run time (on, off, off, on, on, off): tokens/s of each and
   the ratio of the medians (no gate).
8k. serve llama durable (``--durable`` runs the build and 8k alone):
   TinyLlama at full width (22 layers, seed-0 weights; the main run's at
   CUT_LAYERS) written once as a
   converter checkpoint directory (f32 ``.npz``) and served in bf16 by
   child processes of ``python -m mlmicroservicetemplate_tpu_torch.serve``
   through ``MODEL_PATH``: the paged loop's graphs (4 slots, one batch
   bucket of 4 and one seq bucket of 256, 128 tokens in chunks of 4),
   ``KV_HOST_BUDGET_MB`` and
   ``KV_DISK_BUDGET_MB``, ``JOURNAL_DIR`` in a temporary directory,
   ``JOURNAL_FSYNC=always``, ``JOBS_ENABLED=1``.  Child A serves a sampled
   seeded batch-class stream, a job of 8 lines (batch class) and a
   ``/predict`` with ``X-Request-Id``; once the stream has 8 tokens and 2
   lines are done, three greedy interactive streams arrive, find every
   slot busy and preempt the batch holders: the sampled stream's
   checkpoint swaps out to the host and writes through to disk.  A is
   killed with SIGKILL once every stream's journaled cursor holds 8
   tokens, the disk index holds that checkpoint and 2 lines are done
   (read from the files).  Child B starts on the same directory.  Gates:
   each stream's tokens in B's journal are A's cursor at the kill plus
   the continuation, as many as its budget (no token twice), and ``GET
   /v1/streams/{rid}`` serves them; they equal an uninterrupted run of the
   same four streams in this process (or a greedy row parts at a near
   tie, as 8i allows), every token teacher-forced; the checkpointed
   stream resumes through the disk rung (``kv_disk.promotes`` >= 1, a
   swap resume, no fallback, so no prefill of its own); the job ends
   completed, no line done before the kill runs again (B's store appends
   exactly the remaining lines and the end) and every line's result
   equals B's streamed ``/predict`` answer; the ``/predict`` retry returns
   the journaled body with no ``batch`` dispatch; K3's launch counter in
   each child equals what its graphs' replays account for
   (``/debug/perf?kernels=1``); the pool drains to 0.  Printed: restart
   to readiness and the journal replay's ms (the same files opened on a
   copy), restart to the first resumed token (its journal record), one
   write-through's ms and GB/s and one disk -> host -> device prefetch's
   ms (a ``KVDiskTier`` of the pool's layout, warm page cache), the fsync
   histogram's p50 and p99 bucket edges in both children, and tokens/s of
   the same four streams in this process with the journal on
   (``fsync=always``) and off.
8l. serve llama tenants (``--tenants`` runs the build and 8l alone, at 22
   layers; the main run's at CUT_LAYERS on 8h's warmed engine and adapter
   pool): ``TENANTS_FILE`` over 8h's service (the paged loop, 16 slots,
   one batch bucket of 16, ``ADAPTER_SLOTS=2``): acme at weight 3 on
   adapter alpha, bob at 1, carol at 1 with ``max_concurrency`` 2 and a
   ``tokens_per_window`` of two and a half of her requests, keyless callers
   anonymous; a batcher of its own on the engine.  A backlog of 48
   batch-class streams (acme's and bob's in turn, every fourth sampled and
   seeded) queued at once behind a full set of slots; then, over loopback
   HTTP with the loop held at its chunk dispatch, carol's two streams, her
   third (429), bob's stream and an anonymous stream and whole request; the
   loop let go, carol over her window (429) and bob again.  Gates: while
   acme and bob both had waiters, acme took 3 of every 4 of the loop
   queue's pops, within one pop; each queue's fair-share ``served`` (the
   batcher's in ``/status.tenancy``) equals the pops logged; carol's third
   stream 429 with Retry-After >= 1, her request over the window 429 with
   Retry-After the window less her oldest charge's age (within 1 s), bob
   served after each; ``predict_requests_total{status="429"}`` and
   ``tenant_requests_shed_total{reason="quota"}`` grew by 2; after the
   drive the ledger's ``active`` and ``kv_bytes``, every
   ``tenant_kv_committed_bytes``, the pool's ``live_refs`` and its used
   blocks are 0; every row teacher-forced through its adapter; K2 and K3
   held against the loop's and the engine's counts; no capture after the
   loop's warm-up.  Printed: TTFT p50 and p99 by tenant, and tokens/s of the
   backlog with ``TENANTS_FILE`` and on a batcher without it.
8a. serve gpt2, serve gpt2 stream (paged), serve gpt2 stream contiguous,
   each with its graphs phase: GPT-2 small at full width (12 layers, 768
   hidden, 12 heads, vocab 50257, position table 1024; random weights from
   seed 0; bf16; the byte tokenizer), as 7 and 7b (every service on
   CUT_GRID; the two loops, the prefix services and the speculative loop
   at the first ``CUT_LAYERS`` of its 12 layers; the
   whole service, ``serve gpt2 chunked`` (its tokens held against the
   whole one's) and the window and pipeline phases (their eos picked from
   a probe) at 12): K2 or K3 launch once a layer a decode step (R = 1) and
   never in prefill.
8a'. serve gpt2 prefix, serve gpt2 prefix per-stream, serve gpt2 prompt
   prefix, each with its graphs phase: GPT-2 small (4 slots, batch
   buckets 1 and 4) with ``PREFIX_CACHE=1`` on the contiguous loop (a
   conversation's solo hits, a grouped burst of 4), with
   ``CONTINUOUS_BATCHING=0`` (two conversations' hits through
   ``start_fused`` on the per-stream path, whose chunks replay the
   ``gen_chunk`` graphs of the prefixed shapes), and with a 59-token
   ``PROMPT_PREFIX``, whole and through the loop; the gates of 7d, every
   token teacher-forced over the prefix's ids and the prompt.
8a''. serve gpt2 chunked: GPT-2 small on the contiguous loop (4 slots as
   wide as the position table, 1024, so K2 decodes over 1024 keys) with
   ``PREFILL_CHUNK=64`` and ``PREFIX_CACHE=1``: five prompts of 300-900
   bytes at once (every other sampled and seeded), then one that opens
   with the longest one's first 300 bytes (a hit seeded into its job's
   state).  Gates: every token teacher-forced; each request's tokens
   against the whole-generation service's (``serve gpt2``'s engine, alone),
   identical or parted first inside the tie margin; the windows equal the
   jobs'; K2 held against the counts.
8d. serve gpt2 window: GPT-2 small through the contiguous loop (16
   slots, K2) with ``DECODE_WINDOW=4`` and AUTO off, 15 batch streams (a
   third sampled and seeded) chosen and rigged as in 7g, against
   ``DECODE_WINDOW=1``; the gates and prints of 7g but the governor's and
   the early exit.
8e. serve gpt2 pipeline: the loop's dispatch pipeline, GPT-2 small through
   the paged loop (16 slots, 16-token blocks, K3; every wave padded to the
   one batch bucket, 16, and one seq bucket used): a probe picks a common
   token as the eos as in 7g; 15 batch streams (a third sampled and seeded)
   that end on it open at once and, once one has 12 tokens, a late wave of
   4 arrives with chunks in flight, on four services: ``STREAM_PIPELINE=1
   HOST_PREP_DOUBLE=0`` (the serial order), ``STREAM_PIPELINE=3
   HOST_PREP_DOUBLE=1``, the same with ``DECODE_WINDOW=4``, and
   ``ADMIT_OVERLAP=0`` at the defaults (the depth tuned at warmup); every
   start graph captured first, then one pass and three measured.  Gates:
   every pass of every service the serial order's tokens; every token
   teacher-forced; depth 3 staged plans and used one; never more
   dispatches in flight at a dispatch than the depth; K2 and K3 held
   against the loop's counts; the pool empty and every stream released.  Then 8 requests each alone on an
   idle loop, at the defaults (the tuned depth and admission grace) and at
   ``STREAM_PIPELINE=1`` (the configured 8 ms grace).  Printed: the tuned
   depth with the measured RTT and compute, the grace, the host seconds by
   dispatch site (count, p50, sum), chunk and fetch boundaries per token,
   tokens/s (the faster of two passes, and both), the staged-prep
   counts, the most dispatches in flight, and the lone requests' TTFT.
8f. serve spec (``--spec`` runs the build and its three services alone;
   in the main run ``serve spec llama`` comes after 7f, ``serve spec gpt2
   loop`` after 8e and ``serve spec t5`` after 8c, each over the weights
   its section built):
   speculative decoding, ``SPEC_DECODE=ngram`` (``SPEC_K`` 8, 4 verify
   rounds a chunk, 64 decode positions).  ``serve spec llama``: TinyLlama
   at full width (22 layers; CUT_LAYERS in the main run) per stream (``CONTINUOUS_BATCHING=0``, the
   prefix cache on, buckets 1 x 64/128): six prompts, four quoting
   themselves, two seeded sampled, each alone, then a prompt that hits the
   first one's 64-token prefix, then a greedy and a sampled one whole
   (``full_spec``); the same greedy prompts again with speculation off (the
   plain path's graphs) for tokens/s; a verify round against a decode step
   at B = 1 over the 128 bucket (CUDA events, split by ``torch.profiler``
   into GEMMs and the rest; the window's attention timed alone).  ``serve
   spec gpt2 loop``: GPT-2 small under ``SPEC_CONTINUOUS`` in the
   contiguous loop (4 slots, every stream routed there), the items twice
   at once.  ``serve spec t5``: T5-small per stream, K1 in its encoder.
   Gates: 0 misses after warmup; launches equal to the replays' (K2 never
   on the per-stream spec paths, 12 x 4 a GPT-2 loop wave's first chunk,
   K1 6 a T5 generation); every greedy token teacher-forced against an f32
   forward within 3x the run's logit error, every sampled token inside its
   filtered support under that forward; a whole generation and a loop
   chunk of verify rounds through graphs equal to eager; a prefix hit.
   Printed: tokens per verify step, spec against plain tokens/s.
8b. decode step gpt2: one GPT-2 step at B = 16 over a 320-key
   cache, greedy against sampled, eager and as graphs, split into K2,
   GEMMs and the rest; the sampler alone as graphs on [B, 50257] logits
   (threefry Gumbel noise, sort and filter, ``select_token``, argmax).
8c. serve t5, serve t5 stream, serve t5 long prompt, serve t5 per-stream,
   each with its graphs phase: T5-small at full width (6+6 layers, d_model
   512, 8 heads of 64, d_ff 2048, vocab 32128; random weights from seed 0
   at the JAX init's scales with an untied head; bf16; the byte
   tokenizer), whole, through the contiguous loop, with two prompts of
   different lengths past a cut SEQ_BUCKETS on the per-stream path (one
   width, their lengths rounded up to a multiple of 128; alone in their
   service, the second sampled: 4 misses), and
   with ``CONTINUOUS_BATCHING=0``; the waves of 7 and four long prompts
   (the 512 bucket).  K1 must launch 6 times per run of a ``start`` graph
   and K2 never; every token is teacher-forced against an f32 one-pass
   forward through K1's plain version; the device's bucket tables must
   equal the CPU's; graphs against eager for the batch, the loop's chunk
   and a per-stream generation.  Then ``start t5``: encode + cross K/V +
   first chunk at B = 32, S=512, eager and as graphs, split into
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
import contextlib
import functools
import json
import os
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
# int8 KV services, the loop phases, the classes, prefix, chunked and tier
# phases, 8f's llama, 8g and 8h in the main run; the whole service and 8i
# keep TinyLlama's 22, as do ``--spec``, ``--quant`` and ``--lora``).
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
# The bucket grid of the services that repeat a path (every llama and
# GPT-2 service of the main run, GPT-2's whole one included): 2 x 1
# buckets, a wave of 2 to 8 padded to 16 and every prompt to 256, so a
# llama service's warmup captures 8 graphs, not 80.
CUT_GRID = {"BATCH_BUCKETS": "1,16", "SEQ_BUCKETS": "256"}
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


# Every phase line carries the seconds since the script started
# (``at_s``): the differences are what each phase cost of the run's limit.
T_START = time.monotonic()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "at_s": round(time.monotonic() - T_START, 1)}),
          flush=True)


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
    from concurrent.futures import ThreadPoolExecutor

    from mlmicroservicetemplate_tpu_torch.ops import _build

    t0 = time.monotonic()
    built = _build.build()
    libraries = []
    with ThreadPoolExecutor(len(built)) as pool:  # one cuobjdump a library, all at once
        counts = list(pool.map(lambda b: mma_counts(b.path), built))
    for b, (hgmma, hmma) in zip(built, counts):
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


def profiled(kind: str, kernel, library) -> dict:
    """``device_us``, ``library_device_us`` and ``host_us`` of a decode
    kernel's case: profiled for bf16, the dtype every path serves, and
    None for the others (each profile costs a fraction of a second)."""
    if kind != "bfloat16":
        return {"device_us": None, "library_device_us": None, "host_us": None}
    return {"device_us": device_us(kernel), "library_device_us": device_us(library),
            "host_us": host_us(kernel)}


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
            bound_us=bound_ms * 1e3, bound_by=bound_by, **profiled(kind, kernel, library),
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
            bound_us=bound_ms * 1e3, bound_by=bound_by, **profiled(kind, kernel, library),
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
    by side; the kernel launches a call are the profile's ``kernels``.
    With ``eager`` None, the graph alone."""
    out = {}
    for mode, fn in (("eager", eager), ("graph", graph)):
        if fn is None:
            continue
        wall = cuda_ms(fn, iters)
        split = profile_split(fn, reps, kernel_name, label, count=count)
        busy = split["device_busy_ms"]
        out[mode] = {"wall_ms": wall, "busy_share": busy / wall if busy else None, **split}
    if eager is not None:
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
    ``[d_in, d_out]`` kernels): N(0, 0.02), unit RMSNorm scales.  Each
    kernel is the transpose of a row-major ``[d_out, d_in]`` array, so
    carrying it into the port's layout is a plain copy (``kernel``)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def w(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= 0.02
        return a

    def k(d_in, d_out):
        return w(d_out, d_in).T

    d, kv = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
    ones = np.ones(d, np.float32)
    return {
        "embed": {"embedding": w(cfg.vocab_size, d)},
        "layers": [
            {
                "attn_ln": {"scale": ones},
                "attn": {"q": {"kernel": k(d, d)}, "k": {"kernel": k(d, kv)},
                         "v": {"kernel": k(d, kv)}, "o": {"kernel": k(d, d)}},
                "mlp_ln": {"scale": ones},
                "mlp": {"gate": {"kernel": k(d, cfg.d_ff)}, "up": {"kernel": k(d, cfg.d_ff)},
                        "down": {"kernel": k(cfg.d_ff, d)}},
            }
            for _ in range(cfg.num_layers)
        ],
        "final_ln": {"scale": ones},
        "lm_head": {"kernel": k(d, cfg.vocab_size)},
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
    half of the (j + 1)-th split of its chain (split on the CPU, where the
    threefry rounds' small ops cost no launches, and kept: every phase
    draws the same seeds)."""
    return _step_keys_cpu(seed, n).to(device)


@functools.lru_cache(maxsize=None)
def _step_keys_cpu(seed: int, n: int):
    import torch

    from mlmicroservicetemplate_tpu_torch.models import sampling

    rng = sampling.make_params([seed], [1.0], [0], [1.0]).rng
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


@contextlib.contextmanager
def gpt2_layers(n: int):
    """Every GPT-2 the registry builds inside has ``n`` layers (it takes the
    first ``n`` of the weights it is given): the registry's config is GPT-2
    small's, whose depth no knob sets."""
    from mlmicroservicetemplate_tpu_torch.models import gpt as gpt_mod

    full = gpt_mod.GPTConfig
    gpt_mod.GPTConfig = functools.partial(full, num_layers=n)
    try:
        yield
    finally:
        gpt_mod.GPTConfig = full


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
            # A stream's place frees when the loop or the per-stream worker
            # releases it, which can come after its consumer read the end:
            # the next wave, as large as MAX_STREAMS, waits for every place.
            t_wait = time.monotonic() + 10.0
            while (batcher._active_streams or (batcher._cdl is not None
                                               and batcher._cdl.admitted)) \
                    and time.monotonic() < t_wait:
                await asyncio.sleep(0.001)
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return feats, rows, latencies, ttfts, wall


def phase_serve_stream(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                       card_line: str, warm_loop: bool = True, eager_chunk: bool = True):
    """A generative service (llama or gpt2) streaming through the continuous
    decode loop: every token teacher-forced (greedy and sampled), the
    kernels' launches held against the loop's counts, the paged pool back
    to 0 blocks, the last sampled stream of the full wave streamed again
    alone; on the card, one slot-state chunk timed and split by kernel.
    Without ``warm_loop`` the loop is not warmed (as under ``WARMUP=0``):
    its chunk's graphs (argmax and sampled) are captured at the first
    admission, two misses in the drive.  Without ``eager_chunk`` the
    chunk is timed as a graph only."""
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
        out["chunk"] = time_chunk(engine, loop, eager=eager_chunk)
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
                  replays_parted=loop.replays_parted,
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


PREFIX_WORDS = ["system", "prompt", "history", "assistant", "answer", "user", "turn",
                "prefix", "cache", "shared"]


def prefix_sampling(i: int) -> dict:
    """Every third stream sampled and seeded (temperature 0.7 or 1.0,
    top_k 0 or 40)."""
    if i % 3 != 2:
        return {}
    j = i // 3
    return dict(temperature=(0.7, 1.0)[j % 2], top_k=(0, 40)[j // 2 % 2], seed=3000 + i)


def prefix_text(rng, n: int) -> str:
    return " ".join(rng.choice(PREFIX_WORDS, size=n))[:n]


def prefix_steps(s_max: int, n_conv: int, n_burst: int, n_batch: int = 0,
                 n_inter: int = 0) -> list:
    """Traffic for a prefix-cache service whose largest seq bucket is
    ``s_max`` (byte tokenizer: a token a byte, and a trailing EOS):

    - ``n_conv`` conversations of three turns, each turn the conversation
      so far and a new user turn (a system prompt of 0.55 ``s_max`` bytes,
      turns of 0.66, 0.8 and 0.93 ``s_max``): each first turn misses and
      donates the bucket of half ``s_max``, the later turns hit it; the
      conversations' turns run as waves of ``n_conv``;
    - a shared document (0.52 ``s_max``) with a question once (0.6), then
      ``n_burst`` other questions on it at once, whose suffixes fall in one
      bucket: one grouped hit wave;
    - with ``n_batch``: that many unique batch-class prompts of 40-60 bytes
      (each donates 32 tokens), the last quarter sampled and seeded, hold
      every slot, then ``n_inter`` interactive ones arrive and preempt.

    Every third conversation and burst stream is sampled and seeded.
    Returns steps ``("wave", items)`` or ``("classes", (batch, inter))``."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(13)
    i = 0

    def item(text: str, **kw):
        nonlocal i
        out = RawItem(text=text, **prefix_sampling(i), **kw)
        i += 1
        return out

    convs = []
    for _ in range(n_conv):
        whole = prefix_text(rng, int(0.55 * s_max)) + " user: " + prefix_text(rng, s_max)
        convs.append([whole[: int(f * s_max)] for f in (0.66, 0.8, 0.93)])
    steps = [("wave", [item(c[t]) for c in convs]) for t in range(3)]
    doc = prefix_text(rng, int(0.52 * s_max))
    q = prefix_text(rng, s_max)
    if n_burst:
        steps.append(("wave", [item((doc + q)[: int(0.6 * s_max)])]))
    if n_burst:
        lo, step = int(0.645 * s_max), max(1, int(0.012 * s_max))
        steps.append(("wave", [item(doc + prefix_text(rng, s_max)[: lo + step * k - len(doc)])
                               for k in range(n_burst)]))
    if n_batch:
        batch = [RawItem(text=prefix_text(rng, int(rng.integers(40, 60))),
                         **(dict(temperature=0.8, top_k=40, seed=4000 + k)
                            if k >= 3 * n_batch // 4 else {}))
                 for k in range(n_batch)]
        inter = [RawItem(text=prefix_text(rng, 20)) for _ in range(n_inter)]
        steps.append(("classes", (batch, inter)))
    return steps


async def drive_prefix(batcher, bundle, engine, steps):
    """Run ``prefix_steps``' steps in order through
    ``Batcher.submit_stream``: a wave's streams at once; a classes step's
    batch-class streams at once and, once each has its first chunk, the
    interactive ones; a ``whole`` step's requests at once through
    ``Batcher.submit`` (rows of the decode budget, no first chunk).  Each
    stream is recorded as a hit when the prefix cache held a prefix of its
    prompt as it was submitted (``peek``).
    Returns ([(feats, tokens, time to the first chunk s, hit)], wall s)."""
    import numpy as np

    await batcher.start()
    cache = engine.prefix_cache

    async def one(item, klass=None, first_seen=None):
        f = bundle.preprocess(item)
        if klass:
            f["priority"] = klass
        hit = cache is not None and cache.peek(f["input_ids"], int(f["length"])) > 0
        t0 = time.monotonic()
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
        return f, np.array(toks, np.int32), ttft, hit

    async def whole(item):
        f = bundle.preprocess(item)
        return f, await batcher.submit(f), None, False

    out = []
    try:
        t0 = time.monotonic()
        for kind, items in steps:
            if kind in ("wave", "whole"):
                out += await asyncio.gather(*((one if kind == "wave" else whole)(it)
                                              for it in items))
                continue
            batch, inter = items
            seen = [asyncio.Event() for _ in batch]
            tasks = [asyncio.create_task(one(it, "batch", ev)) for it, ev in zip(batch, seen)]
            for ev in seen:
                await ev.wait()
            tasks += [asyncio.create_task(one(it, "interactive")) for it in inter]
            out += await asyncio.gather(*tasks)
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return out, wall


def ttft_split(results) -> dict:
    """TTFT p50 / p99 ms of the hits and of the misses, apart."""
    import numpy as np

    out = {}
    for name, want in (("hit", True), ("miss", False)):
        t = np.array([r[2] for r in results if r[3] == want and r[2] is not None]) * 1e3
        out[f"{name}_streams"] = int(t.size)
        for q in (50, 99):
            out[f"ttft_{name}_p{q}_ms"] = float(np.percentile(t, q)) if t.size else None
    return out


def with_prefix_ids(feats, prefix_ids):
    """Feats whose ids carry a global prefix's ids first (the context the
    model saw), for the teacher-forced reference."""
    import numpy as np

    if prefix_ids is None:
        return feats
    return [dict(f, input_ids=np.concatenate([prefix_ids, np.asarray(f["input_ids"])]),
                 length=np.int32(len(prefix_ids) + int(f["length"]))) for f in feats]


def held_launches(label: str, bundle, engine, loop, k2: int, k3: int, rehearsal: bool) -> None:
    """K2 and K3 held against the counts of what ran: K2 a layer at every
    step of each start's first chunk (loop admissions, prefixed or not) and
    of the engine's own decode (whole generations, the per-stream path),
    and at every slot step of a contiguous loop; K3 a layer at every slot
    step of a paged loop."""
    layers, chunk = bundle.cfg.num_layers, engine.chunk_tokens
    want_k2, want_k3 = engine.decode_steps, 0
    if loop is not None:
        want_k2 += chunk * loop.prefill_dispatches
        if engine.paged_kv:
            want_k3 = loop.decode_steps
        else:
            want_k2 += loop.decode_steps
    want = (0, 0) if rehearsal else (layers * want_k2, layers * want_k3)
    if (k2, k3) != want:
        raise AssertionError(f"{label}: decode_attention launched {k2} times and "
                             f"paged_decode_attention {k3}; want {want}")


GPT2_PROMPT_PREFIX = "You are a helpful assistant. Answer in one short sentence. "


def prompt_items(n: int, seed: int) -> list:
    """``n`` short prompts behind a global prefix, every third sampled and
    seeded."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(seed)
    return [RawItem(text=prefix_text(rng, int(rng.integers(10, 40))), **prefix_sampling(k))
            for k in range(n)]


def phase_serve_prefix(label: str, overrides: dict, params, ref_model, steps, rehearsal: bool,
                       card_line: str, gates: tuple = (), prompt_prefix=None):
    """A decoder service with ``PREFIX_CACHE=1`` (or a ``PROMPT_PREFIX``,
    ``prompt_prefix``) driven by ``steps`` (``drive_prefix``).  Gates: the cache's hits and misses
    (and each counter of the loop's named in ``gates``) > 0; K2/K3 held
    against the counts; every token teacher-forced against an f32 forward
    of the whole context (a global prefix's ids, the prompt, the tokens
    before) on the same weights without any cache; every stream released;
    paged, the pool holding exactly the pins' blocks, then 0 after a
    flush.  TTFT p50 / p99 of hits and misses printed apart.  Returns
    (bundle, {kernel: launches}, graph accounting)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import prompt_prefix_ids
    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    loop = batcher._cdl
    warm_s = batcher.warm_engine() + batcher.warm_streams()
    prefix_ids = (prompt_prefix_ids(bundle.tokenizer, prompt_prefix, bundle.cfg.max_position)
                  if prompt_prefix else None)
    kernels = (decode_attention, paged_decode_attention)
    for k in kernels:
        k.launches = 0
    engine.decode_steps = engine.dispatches = 0
    if loop is not None:
        loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
    marks = graph_marks(bundle)
    results, wall = asyncio.run(drive_prefix(batcher, bundle, engine, steps))
    k2, k3 = (k.launches for k in kernels)
    gdrive = graph_drive(bundle, marks, {"decode_attention": k2, "paged_decode_attention": k3})
    held_launches(label, bundle, engine, loop, k2, k3, rehearsal)
    counts = {}
    cache = engine.prefix_cache
    if cache is not None:
        counts = dict(cache.stats())
        if not (counts["hits"] > 0 and counts["misses"] > 0):
            raise AssertionError(f"{label}: prefix cache {counts}")
    for name in gates:
        counts[name] = getattr(loop, name)
        if counts[name] < 1:
            raise AssertionError(f"{label}: {name} = 0 ({counts})")
    if loop is not None and loop.admitted != 0:
        raise AssertionError(f"{label}: {loop.admitted} streams never released")
    pool = None
    if engine.paged_kv:
        pins = {b for e in cache._entries.values() for b in e.block_ids}
        pool = {"pinned_blocks": len(pins), "used_after_streams": engine.kv_pool.used_blocks,
                **{k: v for k, v in engine.kv_pool.stats().items() if k != "used"}}
        if engine.kv_pool.used_blocks != len(pins):
            raise AssertionError(f"{label}: the pool holds {engine.kv_pool.used_blocks} "
                                 f"blocks, the pins {len(pins)}")
        pool["flushed_pins"] = cache.flush()
        pool["used_after_flush"] = engine.kv_pool.used_blocks
        if pool["used_after_flush"] != 0:
            raise AssertionError(f"{label}: {pool['used_after_flush']} blocks after a flush")
    stream_feats = [f for f, *_ in results]
    stream_rows = [r for _, r, *_ in results]
    for f, row in zip(stream_feats, stream_rows):
        if not 1 <= len(row) <= engine.max_decode_len:
            raise AssertionError(f"{label}: a stream of {len(row)} tokens")
    check = teacher_forced(bundle, ref_model, with_prefix_ids(stream_feats, prefix_ids),
                           stream_rows, engine.max_decode_len)
    out = dict(
        device=str(bundle.device), card=card_line, layers=bundle.cfg.num_layers,
        kv_quant=bundle.cfg.kv_quant, paged=engine.paged_kv,
        slots=loop.n_slots if loop is not None else None, streams=len(results),
        prompt_prefix_tokens=engine.global_prefix_len(),
        **counts, pool=pool,
        admission_waves=loop.prefill_dispatches if loop is not None else None,
        slot_decode_steps=loop.decode_steps if loop is not None else None,
        engine_decode_steps=engine.decode_steps, decode_attention_launches=k2,
        paged_decode_attention_launches=k3, warm_s=warm_s, prefix_warm=engine.prefix_warm,
        **ttft_split(results), generated_tok_per_s=check["tokens_checked"] / wall,
        graph_modes=engine.graph_modes(), **check,
    )
    emit(label, **out)
    return bundle, {k: v for k, v in (("decode_attention", k2),
                                       ("paged_decode_attention", k3)) if v}, gdrive, engine, loop


def chunked_llama(rehearsal: bool) -> dict:
    """``serve llama chunked``'s knobs over the paged loop's (16 slots,
    16-token blocks, a 64-token budget): batch buckets 1 and 16, the prefix
    cache, 128-token windows (64 in the rehearsal's smaller buckets)."""
    return {"BATCH_BUCKETS": "1,16", "PREFIX_CACHE": "1",
            "PREFILL_CHUNK": "64" if rehearsal else "128"}


def chunked_gpt2(rehearsal: bool) -> dict:
    """``serve gpt2 chunked``'s knobs over the GPT-2 prefix phases' (4
    contiguous slots, batch buckets 1 and 4): a queue for the fifth
    stream, the prefix cache, 64-token windows (32 in the rehearsal)."""
    return {"MAX_STREAM_QUEUE": "8", "PREFIX_CACHE": "1",
            "PREFILL_CHUNK": "32" if rehearsal else "64"}


def chunked_items(rehearsal: bool):
    """Traffic of ``serve llama chunked``: 8 short interactive prompts of
    40-60 bytes; three long prompts of 1760-1800 bytes (byte tokenizer: a
    token a byte), one interactive and two batch-class, the last sampled and
    seeded; and a fourth long one that opens with the first long prompt's
    first 400 bytes (a prefix the cache holds once that prompt went live).
    The two batch prompts and the fourth prefill together once the
    interactive one decodes: their blocks alone pass the default pool of 16
    worst-case streams of a 256 bucket (320 blocks of 16) less the pins.
    Returns (shorts, [(item, class)] of the three, (item, class) of the
    fourth)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(17)
    shorts = [RawItem(text=prefix_text(rng, int(rng.integers(40, 61)))) for _ in range(8)]
    sizes, share = ((800, 790, 780, 770), 100) if rehearsal else ((1800, 1780, 1760, 1740), 400)
    texts = [prefix_text(rng, n) for n in sizes]
    texts[3] = texts[0][:share] + texts[3][share:]
    longs = [(RawItem(text=texts[0]), "interactive"), (RawItem(text=texts[1]), "batch"),
             (RawItem(text=texts[2], temperature=0.8, top_k=40, seed=5150), "batch")]
    return shorts, longs, (RawItem(text=texts[3]), "batch")


async def drive_chunked(batcher, bundle, shorts, longs, hit):
    """Open the short streams; once each has 3 chunks (or ended), open the
    three long ones; once the first long one has its first chunk (it went
    live and donated its prefix), open the fourth.  Returns ([{feats,
    tokens, kind, klass, submitted, chunk arrival times}], wall s)."""
    import numpy as np

    await batcher.start()

    async def one(item, klass, kind, seen=None, after=1):
        f = dict(bundle.preprocess(item), priority=klass)
        rec = {"feats": f, "kind": kind, "klass": klass, "t_submit": time.monotonic(),
               "t_chunks": [], "toks": []}
        try:
            async for chunk in batcher.submit_stream(f):
                rec["t_chunks"].append(time.monotonic())
                rec["toks"].extend(int(x) for x in chunk)
                if seen is not None and len(rec["t_chunks"]) >= after:
                    seen.set()
        finally:
            if seen is not None:
                seen.set()
        rec["toks"] = np.array(rec["toks"], np.int32)
        return rec

    try:
        t0 = time.monotonic()
        seen = [asyncio.Event() for _ in shorts]
        tasks = [asyncio.create_task(one(it, "interactive", "short", ev, 3))
                 for it, ev in zip(shorts, seen)]
        for ev in seen:
            await ev.wait()
        first_live = asyncio.Event()
        tasks.append(asyncio.create_task(one(*longs[0], "long", first_live)))
        tasks += [asyncio.create_task(one(it, klass, "long")) for it, klass in longs[1:]]
        await first_live.wait()
        tasks.append(asyncio.create_task(one(*hit, "hit")))
        recs = await asyncio.gather(*tasks)
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return recs, wall


def chunk_gaps(recs) -> dict:
    """The short streams' gaps between consecutive chunks: the largest (and
    median) of those that overlap a long prompt's prefill (from the first
    long submit to the last long first chunk) and of those that end before
    the first long submit."""
    import numpy as np

    longs = [r for r in recs if r["kind"] != "short"]
    lo = min(r["t_submit"] for r in longs)
    hi = max(r["t_chunks"][0] for r in longs if r["t_chunks"])
    during, before = [], []
    for r in recs:
        if r["kind"] != "short":
            continue
        for a, b in zip(r["t_chunks"], r["t_chunks"][1:]):
            if b <= lo:
                before.append(b - a)
            elif a < hi:
                during.append(b - a)
    out = {}
    for name, gaps in (("without_prefill", before), ("during_prefill", during)):
        g = np.array(gaps) * 1e3
        out[f"gaps_{name}"] = int(g.size)
        out[f"max_gap_{name}_ms"] = float(g.max()) if g.size else None
        out[f"p50_gap_{name}_ms"] = float(np.median(g)) if g.size else None
    return out


def time_window(engine, loop, length: int) -> dict:
    """One paged prefill window at the end of a ``length``-token prompt (its
    queries over every earlier key), eager and through the window's graph,
    over blocks taken for the purpose: CUDA-event wall, busy time split."""
    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import StreamBlocks

    c = loop.prefill_chunk
    start = (length - 1) // c * c
    sb = StreamBlocks(loop.pool, loop.block_size)
    sb.ensure(length)
    row = np.full(loop.nb_max, loop.pool.num_blocks, np.int32)
    row[: len(sb.ids)] = sb.ids
    try:
        with torch.inference_mode(), engine._lock:
            entry = loop.window_graph()
            ids, mask, s_start, target = entry.inputs
            ids.fill_(7)
            mask.zero_()
            mask[:, : length - start] = 1
            s_start.fill_(start)
            target.copy_(torch.from_numpy(row))

            def eager():
                engine.bundle.paged_prefill_chunk(loop._state, target, ids, mask, s_start)

            out = eager_and_graph(eager, entry.replay, 5, K3_KERNEL, "k3")
            target.fill_(loop.pool.num_blocks)
    finally:
        sb.release()
    return {"window_tokens": c, "keys": length, **out}


def phase_serve_chunked(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                        card_line: str):
    """A decoder service with ``PREFILL_CHUNK`` over the paged loop with the
    prefix cache, driven by ``chunked_items`` (``drive_chunked``).  Gates:
    every token teacher-forced against an f32 forward of the whole prompt;
    ``prefill_chunks_total`` (and the loop's count) equal to the windows
    the jobs ran (each job that went live ceil((L - P) / C) from its
    prefix P, each job checkpointed mid-prefill the windows it ran); at
    least one pacer hold, one mid-prefill checkpoint and one prefix hit
    whose suffix went through windows; every long prompt live (a stream
    checkpointed after it went live prefills again); K2 and K3 held
    against the counts;
    every stream released; the pool back to its pins, then 0 after a
    flush.  Printed: one window's device ms, one chunk of the 16 slots over
    tables of the position budget with every key valid (``time_chunk``),
    the short streams' largest chunk gap during the long prefills beside
    the one before them, the long prompts' TTFT.  Returns (bundle, {kernel: launches}, graph
    accounting)."""
    import math

    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service
    from mlmicroservicetemplate_tpu_torch.utils import metrics

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    loop = batcher._cdl
    warm_s = batcher.warm_engine() + batcher.warm_streams()
    c = loop.prefill_chunk
    went_live, checkpointed = [], []
    handoff, checkpoint = loop._handoff_job, loop._checkpoint_job

    def on_handoff(job):
        rec = (job.L, job.p_len)
        live = handoff(job)
        if live:
            went_live.append(rec)
        return live

    def on_checkpoint(job):
        checkpointed.append((job.consumed, job.p_len))
        return checkpoint(job)

    loop._handoff_job, loop._checkpoint_job = on_handoff, on_checkpoint
    kernels = (decode_attention, paged_decode_attention)
    for k in kernels:
        k.launches = 0
    engine.decode_steps = engine.dispatches = 0
    loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
    loop.prefill_chunk_dispatches = 0
    counter = metrics.PREFILL_CHUNKS.labels(bundle.name)
    windows_metric0 = counter._value.get()
    marks = graph_marks(bundle)
    shorts, longs, hit = chunked_items(rehearsal)
    recs, wall = asyncio.run(drive_chunked(batcher, bundle, shorts, longs, hit))
    k2, k3 = (k.launches for k in kernels)
    gdrive = graph_drive(bundle, marks, {"decode_attention": k2, "paged_decode_attention": k3})
    held_launches(label, bundle, engine, loop, k2, k3, rehearsal)
    implied = (sum(math.ceil((n - p) / c) for n, p in went_live)
               + sum(math.ceil((done - p) / c) for done, p in checkpointed))
    counts = dict(prefill_chunks=loop.prefill_chunk_dispatches,
                  prefill_chunks_metric=counter._value.get() - windows_metric0,
                  implied_windows=implied, jobs_live=sorted(went_live),
                  checkpoints=sorted(checkpointed), pacer_holds=loop._pacer.holds,
                  prefix_cache=engine.prefix_cache.stats())
    long_lengths = sorted(int(r["feats"]["length"]) for r in recs if r["kind"] != "short")
    if counts["prefill_chunks"] != implied or counts["prefill_chunks_metric"] != implied:
        raise AssertionError(f"{label}: windows {counts}")
    if sorted({n for n, _ in went_live}) != long_lengths:
        raise AssertionError(f"{label}: jobs live {went_live}, long prompts {long_lengths}")
    # A hit's suffix went through windows: it went live, or was checkpointed
    # (a dry pool evicts the pins first, so its resume may miss) after
    # windows past its prefix.
    counts["hits_through_windows"] = (sum(p > 0 for _, p in went_live)
                                      + sum(0 < p < done for done, p in checkpointed))
    if not (counts["pacer_holds"] >= 1 and checkpointed and counts["hits_through_windows"]):
        raise AssertionError(f"{label}: want a pacer hold, a mid-prefill checkpoint and a "
                             f"prefix hit through windows: {counts}")
    if loop.admitted != 0:
        raise AssertionError(f"{label}: {loop.admitted} streams never released")
    cache = engine.prefix_cache
    pins = {b for e in cache._entries.values() for b in e.block_ids}
    pool = {"pinned_blocks": len(pins), "used_after_streams": engine.kv_pool.used_blocks,
            "num_blocks": engine.kv_pool.num_blocks, "table_blocks": loop.nb_max}
    if engine.kv_pool.used_blocks != len(pins):
        raise AssertionError(f"{label}: the pool holds {engine.kv_pool.used_blocks} blocks, "
                             f"the pins {len(pins)}")
    window = None if rehearsal else time_window(engine, loop, long_lengths[-1])
    chunk = None if rehearsal else time_chunk(engine, loop)
    pool["flushed_pins"] = cache.flush()
    pool["used_after_flush"] = engine.kv_pool.used_blocks
    if pool["used_after_flush"] != 0:
        raise AssertionError(f"{label}: {pool['used_after_flush']} blocks after a flush")
    feats = [r["feats"] for r in recs]
    rows = [r["toks"] for r in recs]
    for f, row in zip(feats, rows):
        if not 1 <= len(row) <= engine.max_decode_len:
            raise AssertionError(f"{label}: a stream of {len(row)} tokens")
    check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
    ttft = {f"ttft_{r['kind']}_{int(r['feats']['length'])}_ms":
            (r["t_chunks"][0] - r["t_submit"]) * 1e3 for r in recs if r["kind"] != "short"}
    out = dict(
        device=str(bundle.device), card=card_line, layers=bundle.cfg.num_layers,
        paged=engine.paged_kv, slots=loop.n_slots, streams=len(recs), prefill_chunk=c,
        budget=loop.prefill_budget, max_prompt=loop.max_prompt, long_prompts=long_lengths,
        **counts, pool=pool, admission_waves=loop.prefill_dispatches,
        slot_decode_steps=loop.decode_steps, decode_attention_launches=k2,
        paged_decode_attention_launches=k3, kv_growth_stalls=loop.kv_growth_stalls,
        warm_s=warm_s, **ttft, **chunk_gaps(recs), window=window, chunk=chunk,
        generated_tok_per_s=check["tokens_checked"] / wall, graph_modes=engine.graph_modes(),
        **check)
    emit(label, **out)
    return bundle, {k: v for k, v in (("decode_attention", k2),
                                       ("paged_decode_attention", k3)) if v}, gdrive


def tier_llama(rehearsal: bool) -> dict:
    """``serve llama tier``'s knobs over the paged loop's (16 slots,
    16-token blocks, a 64-token budget): batch buckets 1 and 16, preemption
    with a queue, 128-token windows (64 in the rehearsal), the prefix cache
    and the host tier, 4 blocks a chunk boundary.  ``KV_BUDGET_MB`` and
    ``PREFIX_CACHE_MB`` come from the engine's blocks (``phase_serve_tier``);
    the host budget holds every swap of the phase."""
    return {"BATCH_BUCKETS": "1,16", "MAX_STREAM_QUEUE": "32", "PREEMPT": "1",
            "PREFILL_CHUNK": "64" if rehearsal else "128", "PREFIX_CACHE": "1",
            "KV_HOST_BUDGET_MB": "1000", "KV_PREFETCH_BLOCKS": "4"}


def tier_items(rehearsal: bool, s_max: int):
    """Traffic of ``serve llama tier`` at a largest seq bucket of ``s_max``
    (byte tokenizer: a token a byte, and a trailing EOS), in four steps:

    - ``convs``: four conversations, each a system prompt of 0.6 ``s_max``
      bytes and a question: each donates a pin of half ``s_max``, and the
      third and fourth evict the first two (``PREFIX_CACHE_MB`` holds two
      and a half), which are demoted to the host;
    - ``classes``: 16 batch-class prompts under 28 bytes (a third sampled
      and seeded), then 8 interactive ones (``class_items``): preemptions,
      greedy victims recast and sampled ones replayed, all swapped out;
    - ``back``: the first conversation's second turn, whose pin comes back
      from the host;
    - ``long``: 8 interactive prompts of 0.4-0.48 ``s_max`` bytes (bucket
      ``s_max / 2``), half with ``max_tokens`` 16, then one long interactive
      prompt of 1780 bytes (800 in the rehearsal; interactive, so the pacer
      lets a window through at every boundary) that the pool cannot hold
      beside them: it is checkpointed mid-prefill and resumes partially."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(23)
    system = [prefix_text(rng, int(0.6 * s_max)) for _ in range(4)]
    q1 = [" " + prefix_text(rng, int(0.12 * s_max)) for _ in range(4)]
    convs = [RawItem(text=system[i] + q1[i]) for i in range(4)]
    back = RawItem(text=system[0] + q1[0] + " " + prefix_text(rng, int(0.15 * s_max)))
    batch_items, inter_items = class_items(rehearsal, 16, 8, 28)
    shorts = [RawItem(text=prefix_text(rng, int(rng.integers(int(0.4 * s_max),
                                                             int(0.48 * s_max)))),
                      **({"max_tokens": 16} if i % 2 else {})) for i in range(8)]
    long_item = RawItem(text=prefix_text(rng, 800 if rehearsal else 1780))
    return convs, (batch_items, inter_items), back, (shorts, long_item)


async def drive_tier(batcher, bundle, items):
    """Run ``tier_items``' steps in order, each to its end: the
    conversations one at a time, the classes (the interactive prompts once
    every batch stream has its first chunk), the returning turn, then the
    short streams and, once each has its first chunk, the long prompt.
    Returns ([{feats, toks, kind, klass, t_submit, t_chunks}], wall s)."""
    import numpy as np

    convs, (batch_items, inter_items), back, (shorts, long_item) = items
    await batcher.start()
    n = [0]

    async def one(item, klass, kind, seen=None):
        f = dict(bundle.preprocess(item), priority=klass, request_id=f"{kind}{n[0]}")
        n[0] += 1
        rec = {"feats": f, "kind": kind, "klass": klass, "t_submit": time.monotonic(),
               "t_chunks": [], "toks": []}
        try:
            async for chunk in batcher.submit_stream(f):
                rec["t_chunks"].append(time.monotonic())
                rec["toks"].extend(int(x) for x in chunk)
                if seen is not None:
                    seen.set()
        finally:
            if seen is not None:
                seen.set()
        rec["toks"] = np.array(rec["toks"], np.int32)
        return rec

    async def after_first(first, then):
        seen = [asyncio.Event() for _ in first]
        tasks = [asyncio.create_task(one(*it, ev)) for it, ev in zip(first, seen)]
        for ev in seen:
            await ev.wait()
        tasks += [asyncio.create_task(one(*it)) for it in then]
        return await asyncio.gather(*tasks)

    try:
        t0 = time.monotonic()
        recs = [await one(item, "interactive", "conv") for item in convs]
        recs += await after_first([(it, "batch", "class") for it in batch_items],
                                  [(it, "interactive", "class") for it in inter_items])
        recs.append(await one(back, "interactive", "back"))
        recs += await after_first([(it, "interactive", "short") for it in shorts],
                                  [(long_item, "interactive", "long")])
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return recs, wall


def time_swaps(engine, loop, n_out: int) -> dict:
    """One swap-out of ``n_out`` blocks (the gather from every pool leaf
    and the copy to pinned host memory) and one prefetch of
    ``KV_PREFETCH_BLOCKS`` blocks (the host rows into pinned staging, the
    copy to the card and the scatter into the pools), 5 times each over
    blocks taken for the purpose: CUDA-event ms and wall ms of the best,
    GB/s over the blocks' bytes."""
    import torch

    tier = engine.kv_host
    k = loop.swap_chunk_blocks
    ids = loop.pool.alloc(n_out)
    entry = tier.reserve(n_out, n_out * loop.block_size, kind="stream")
    out = {"swap_out_blocks": n_out, "prefetch_blocks": k,
           "block_bytes": loop.pool.block_bytes}
    try:
        with torch.inference_mode():
            for name, n, fn in (
                    ("swap_out", n_out, lambda: loop._gather(ids)[1].tensors()),
                    ("prefetch", k, lambda: loop._host_to_device(entry, 0, ids[:k]))):
                best = None
                for _ in range(5):
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    torch.cuda.synchronize()
                    w0 = time.perf_counter()
                    e0.record()
                    with engine._lock:
                        got = fn()
                    e1.record()
                    e1.synchronize()
                    wall = (time.perf_counter() - w0) * 1e3
                    ms = e0.elapsed_time(e1)
                    if best is None or ms < best[0]:
                        best = (ms, wall)
                    if name == "swap_out":
                        entry.pool.write(entry.ids, got)
                nbytes = n * loop.pool.block_bytes
                out[f"{name}_ms"], out[f"{name}_wall_ms"] = best
                out[f"{name}_gb_s"] = nbytes / best[0] / 1e6
    finally:
        tier.release(entry)
        loop.pool.free(ids)
    return out


def phase_serve_tier(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                     card_line: str):
    """The host KV tier over the paged loop with preemption, chunked
    prefill and the prefix cache, driven by ``tier_items``
    (``drive_tier``).  The pool holds the long prompt's worst case, the
    pins' blocks and 4 more, and at least 6 of the engine's worst-case
    streams (``KV_BUDGET_MB`` from its block bytes); ``PREFIX_CACHE_MB``
    two and a half pins of half the largest bucket.  Gates: every token
    teacher-forced against an f32 forward of the whole prompt; swap-outs,
    whole swap-ins, partial swap-ins, promotions and prefetch blocks
    copied while decode was live all > 0; no fallback; the long prompt's
    windows its uninterrupted count; K2 and K3 held against the counts; 0
    graph misses; every stream released, the pool back to its pins, then
    0 after a flush, no stream entry left in the host ledger.  Printed:
    swap bytes, one swap-out's and one prefetch's time and GB/s, the
    pinning time, the overlap ratio, the swapped streams' resume latency
    (checkpoint to the first chunk after it), the partial resume's TTFT
    and chunk boundaries.  Returns (bundle, {kernel: launches}, graph
    accounting)."""
    import math

    import numpy as np

    from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine
    from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import blocks_for
    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    s_max = max(engine.seq_buckets)
    items = tier_items(rehearsal, s_max)
    long_len = int(bundle.preprocess(items[3][1])["length"])
    long_worst = blocks_for(long_len + engine.max_decode_len, engine.kv_block_size)
    pin_bytes = (s_max // 2) * engine.kv_token_bytes()
    # Room for the long prompt's worst case beside the pins the cache may
    # hold: pins count as used at the dequeue gate and are reclaimed only
    # at an insert or a growth, so a resume that needs more than the rest
    # would wait for ever once nothing else runs (ROADMAP, kept on purpose).
    pins_blocks = math.ceil(2.5 * blocks_for(s_max // 2, engine.kv_block_size))
    blocks = max(long_worst + pins_blocks + 4, 6 * engine.kv_blocks_per_stream)
    bb = engine.kv_block_bytes()
    cfg = dataclasses.replace(cfg, kv_budget_mb=(blocks * bb + bb // 2) / 1e6,
                              prefix_cache_mb=2.5 * pin_bytes / 1e6)
    engine = InferenceEngine(bundle, cfg)
    batcher = Batcher(engine, cfg)
    if engine.kv_pool.num_blocks != blocks or engine.kv_host is None:
        raise AssertionError(f"{label}: {engine.kv_pool.num_blocks} pool blocks, want {blocks}; "
                             f"host tier {engine.kv_host}")
    loop = batcher._cdl
    warm_s = batcher.warm_engine() + batcher.warm_streams()
    tier = engine.kv_host
    pin_s = tier.pin_seconds
    if tier.pool is None:
        raise AssertionError(f"{label}: warmup built no host buffers")
    swaps, partials, copies, windows, swapins = [], [], [], {}, {}
    swap_out_blocks, to_prefill, h2d, window, start_swapin = (
        loop._swap_out_blocks, loop._swapin_to_prefill, loop._host_to_device,
        loop._dispatch_prefill_window, loop._start_swapin)

    def on_swap_out(st, block_ids, cov):
        before = loop.swap_outs
        swap_out_blocks(st, block_ids, cov)
        if loop.swap_outs > before:
            swaps.append((st.rid, time.monotonic(), blocks_for(cov, loop.block_size), cov))

    def on_partial(job):
        partials.append((job.st.rid, job.resume_at, job.L, time.monotonic()))
        return to_prefill(job)

    def on_swapin(st):
        t = time.monotonic()
        started = start_swapin(st)
        if any(j.st is st for j in loop._swapping):
            swapins.setdefault(st.rid, []).append(t)
        return started

    def on_h2d(entry, pos, dev_ids):
        rid = next((j.st.rid for j in loop._swapping if j.st.swap is entry), "promotion")
        copies.append((rid, len(dev_ids), bool(loop.active)))
        return h2d(entry, pos, dev_ids)

    def on_window(job):
        window(job)
        windows[job.st.rid] = windows.get(job.st.rid, 0) + 1

    loop._swap_out_blocks, loop._swapin_to_prefill, loop._host_to_device = (
        on_swap_out, on_partial, on_h2d)
    loop._dispatch_prefill_window, loop._start_swapin = on_window, on_swapin
    kernels = (decode_attention, paged_decode_attention)
    for kern in kernels:
        kern.launches = 0
    engine.decode_steps = engine.dispatches = 0
    loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
    loop.prefill_chunk_dispatches = 0
    marks = graph_marks(bundle)
    recs, wall = asyncio.run(drive_tier(batcher, bundle, items))
    k2, k3 = (kern.launches for kern in kernels)
    gdrive = graph_drive(bundle, marks, {"decode_attention": k2, "paged_decode_attention": k3})
    held_launches(label, bundle, engine, loop, k2, k3, rehearsal)
    by_rid = {r["feats"]["request_id"]: r for r in recs}
    long_rec = next(r for r in recs if r["kind"] == "long")
    long_rid = long_rec["feats"]["request_id"]
    partial_ins = len(partials)
    counts = dict(
        swap_outs=loop.swap_outs, swap_ins=loop.swap_ins, whole_swap_ins=loop.swap_ins
        - partial_ins, partial_swap_ins=partial_ins, swap_fallbacks=loop.swap_fallbacks,
        host_prefix_promotes=loop.host_prefix_promotes,
        prefetch_blocks_total=loop.prefetch_blocks_total,
        prefetch_blocks_live=loop.prefetch_blocks_live,
        swap_out_bytes=loop.swap_out_bytes, swap_in_bytes=loop.swap_in_bytes,
        preemptions=loop.preemptions, recasts=loop.recasts, replays=loop.replays,
        replays_parted=loop.replays_parted,
        kv_growth_stalls=loop.kv_growth_stalls, prefill_checkpoints=loop.prefill_checkpoints,
        prefill_chunks=loop.prefill_chunk_dispatches, windows_by_stream=windows,
        host_ledger=tier.ledger.stats(),
        prefix_cache=engine.prefix_cache.stats())
    counts["overlap_ratio"] = (loop.prefetch_blocks_live / loop.prefetch_blocks_total
                               if loop.prefetch_blocks_total else None)
    want_windows = math.ceil(long_len / loop.prefill_chunk)
    gates = ("swap_outs", "whole_swap_ins", "partial_swap_ins", "host_prefix_promotes",
             "prefetch_blocks_live")
    if any(counts[g] < 1 for g in gates) or counts["swap_fallbacks"] != 0:
        raise AssertionError(f"{label}: want {gates} > 0 and no fallback: {counts}")
    if windows.get(long_rid) != want_windows:
        raise AssertionError(f"{label}: the long prompt ran {windows.get(long_rid)} windows, "
                             f"its uninterrupted count {want_windows} ({windows})")
    if loop.admitted != 0:
        raise AssertionError(f"{label}: {loop.admitted} streams never released")
    cache = engine.prefix_cache
    pins = {b for e in cache._entries.values() for b in e.block_ids}
    pool = {"num_blocks": engine.kv_pool.num_blocks, "pinned_blocks": len(pins),
            "used_after_streams": engine.kv_pool.used_blocks}
    if engine.kv_pool.used_blocks != len(pins):
        raise AssertionError(f"{label}: the pool holds {engine.kv_pool.used_blocks} blocks, "
                             f"the pins {len(pins)}")
    if tier.ledger.stats()["stream_entries"] != 0:
        raise AssertionError(f"{label}: stream entries left in the host ledger "
                             f"{tier.ledger.stats()}")
    timing = None if rehearsal else time_swaps(engine, loop, max(nb for _, _, nb, _ in swaps))
    pool["flushed_pins"] = cache.stats()["entries"]
    with engine._lock:
        loop._flush_pins()
    pool["used_after_flush"] = engine.kv_pool.used_blocks
    if pool["used_after_flush"] != 0:
        raise AssertionError(f"{label}: {pool['used_after_flush']} blocks after a flush")
    # Resume latency: a swap-out to the stream's first chunk after it.
    resume_ms = {"stream": [], "job": []}
    for rid, t_out, _, _ in swaps:
        later = [t for t in by_rid[rid]["t_chunks"] if t > t_out]
        if later:
            resume_ms["job" if rid == long_rid else "stream"].append((later[0] - t_out) * 1e3)
    resume = {f"resume_{k}_{q}_ms": (float(np.percentile(v, q)) if v else None)
              for k, v in resume_ms.items() for q in (50, 100)}
    resume.update({f"resumed_{k}s": len(v) for k, v in resume_ms.items()})
    # The partial resume: its copies (one a chunk boundary), how many ran
    # beside live decode, and the time from its swap-in's start to its
    # last block back (the prefetch's pace) beside the copies' own time.
    partial_runs = []
    for rid, at, length, t_done in partials:
        mine = [(n, live) for r, n, live in copies if r == rid]
        t_start = max(t for t in swapins.get(rid, [t_done]) if t <= t_done)
        partial_runs.append({
            "resume_at": at, "prompt": length, "blocks": blocks_for(at, loop.block_size),
            "boundaries": len(mine), "live_boundaries": sum(live for _, live in mine),
            "prefetch_ms": (t_done - t_start) * 1e3})
    feats = [r["feats"] for r in recs]
    rows = [r["toks"] for r in recs]
    for f, row in zip(feats, rows):
        if not 1 <= len(row) <= engine.max_decode_len:
            raise AssertionError(f"{label}: a stream of {len(row)} tokens")
    check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
    out = dict(
        device=str(bundle.device), card=card_line, layers=bundle.cfg.num_layers,
        slots=loop.n_slots, streams=len(recs), long_prompt=long_len, long_windows=want_windows,
        long_ttft_ms=(long_rec["t_chunks"][0] - long_rec["t_submit"]) * 1e3,
        partial_resumes=partial_runs, **counts, pool=pool,
        host_tier={"budget_mb": cfg.kv_host_budget_mb, "num_blocks": tier.num_blocks,
                   "pin_seconds": pin_s},
        swap_timing=timing, **resume, admission_waves=loop.prefill_dispatches,
        slot_decode_steps=loop.decode_steps, decode_attention_launches=k2,
        paged_decode_attention_launches=k3, warm_s=warm_s,
        generated_tok_per_s=check["tokens_checked"] / wall, graph_modes=engine.graph_modes(),
        **check)
    emit(label, **out)
    return bundle, {k: v for k, v in (("decode_attention", k2),
                                       ("paged_decode_attention", k3)) if v}, gdrive


def gpt2_chunked_items(rehearsal: bool):
    """Traffic of ``serve gpt2 chunked``: five prompts of 300-900 bytes (a
    token a byte), every other sampled and seeded, then a sixth that opens
    with the longest one's first 300 bytes (a prefix hit)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(19)
    sizes, share = ((100, 130, 160, 190, 220, 200), 80) if rehearsal else (
        (300, 450, 600, 750, 900, 800), 300)
    texts = [prefix_text(rng, n) for n in sizes]
    texts[5] = texts[4][:share] + texts[5][share:]
    items = [RawItem(text=t, **(dict(temperature=0.9, top_k=40, seed=6100 + i) if i % 2 else {}))
             for i, t in enumerate(texts)]
    return items[:5], items[5]


async def drive_gpt2_chunked(batcher, bundle, wave, hit):
    """The wave at once, then the hit once the longest prompt of the wave
    has its first chunk.  Returns ([(feats, tokens)], wall s)."""
    import numpy as np

    await batcher.start()

    async def one(item, seen=None):
        f = bundle.preprocess(item)
        toks = []
        try:
            async for chunk in batcher.submit_stream(f):
                toks.extend(int(x) for x in chunk)
                if seen is not None:
                    seen.set()
        finally:
            if seen is not None:
                seen.set()
        return f, np.array(toks, np.int32)

    try:
        t0 = time.monotonic()
        live = asyncio.Event()
        tasks = [asyncio.create_task(one(it, live if i == len(wave) - 1 else None))
                 for i, it in enumerate(wave)]
        await live.wait()
        tasks.append(asyncio.create_task(one(hit)))
        done = await asyncio.gather(*tasks)
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return done, wall


def whole_vs_chunked(bundle, ref_model, f: dict, chunked, whole, tol: float) -> dict:
    """A request's tokens through the chunked loop against the whole
    generation's: identical, or parted first at a step where both picks
    are ones the f32 reference (teacher-forced on the common tokens)
    admits within the run's tolerance, the teacher-forced check's margin:
    greedy, each within ``tol`` of the best logit; sampled, each within the
    tolerance of the best perturbed score among the tokens surely inside
    the filter and no further than it below the filter's cutoff (bf16 at
    other shapes may flip a near tie, or a token's side of the top-k /
    top-p cutoff)."""
    import torch

    a, b = [int(t) for t in whole], [int(t) for t in chunked]
    n = min(len(a), len(b))
    at = next((j for j in range(n) if a[j] != b[j]), None)
    out = {"tokens": n, "identical": at is None and len(a) == len(b)}
    if at is None:
        if len(a) != len(b):
            raise AssertionError(f"whole {len(a)} tokens, chunked {len(b)}")
        return out
    picks = torch.tensor([a[at], b[at]])
    with torch.inference_mode():
        ref = forced_logits(bundle, ref_model, f, b[: at + 1])[-1:]
        if float(f.get("temperature", 0.0)) > 0:
            score, raw, cutoff, tol_s = perturbed(ref, f, torch.tensor([at]), tol)
            sure = raw[0] >= cutoff[0] + tol_s
            sure |= raw[0] == raw[0].max()
            best = score[0][sure].max()
            gaps = torch.maximum(best - score[0][picks], cutoff[0] - raw[0][picks])
            limit = tol_s
        else:
            gaps, limit = ref[0].max() - ref[0][picks], tol
    out.update(parted_at=at, whole_gap=float(gaps[0]), chunked_gap=float(gaps[1]), tol=limit)
    if float(gaps.max()) > limit:
        raise AssertionError(f"the chunked loop and the whole generation part: {out}")
    return out


def phase_serve_gpt2_chunked(label: str, overrides: dict, params, ref_model, whole_engine,
                             rehearsal: bool, card_line: str):
    """GPT-2 with ``PREFILL_CHUNK`` on the contiguous loop with the prefix
    cache (``gpt2_chunked_items``): every token teacher-forced, and each
    request's tokens against the whole-generation service's
    (``whole_vs_chunked``); the windows equal the jobs' (a hit's from its
    prefix); one prefix hit whose suffix went through windows; K2 held
    against the counts (R = 1, over a slot as wide as the position table).
    Returns (bundle, {kernel: launches}, graph accounting)."""
    import math

    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    loop = batcher._cdl
    warm_s = batcher.warm_engine() + batcher.warm_streams()
    c = loop.prefill_chunk
    went_live = []
    handoff = loop._handoff_job

    def on_handoff(job):
        rec = (job.L, job.p_len)
        live = handoff(job)
        if live:
            went_live.append(rec)
        return live

    loop._handoff_job = on_handoff
    kernels = (decode_attention, paged_decode_attention)
    for k in kernels:
        k.launches = 0
    engine.decode_steps = engine.dispatches = 0
    loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
    loop.prefill_chunk_dispatches = 0
    marks = graph_marks(bundle)
    wave, hit = gpt2_chunked_items(rehearsal)
    done, wall = asyncio.run(drive_gpt2_chunked(batcher, bundle, wave, hit))
    k2, k3 = (k.launches for k in kernels)
    gdrive = graph_drive(bundle, marks, {"decode_attention": k2, "paged_decode_attention": k3})
    held_launches(label, bundle, engine, loop, k2, k3, rehearsal)
    implied = sum(math.ceil((n - p) / c) for n, p in went_live)
    if loop.prefill_chunk_dispatches != implied or not any(p > 0 for _, p in went_live):
        raise AssertionError(f"{label}: windows {loop.prefill_chunk_dispatches}, jobs "
                             f"{went_live}")
    if loop.admitted != 0:
        raise AssertionError(f"{label}: {loop.admitted} streams never released")
    feats = [f for f, _ in done]
    rows = [r for _, r in done]
    check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
    versus = []
    with torch.inference_mode():
        for f, row in zip(feats, rows):
            budget = min(int(f.get("max_tokens", engine.max_decode_len)), engine.max_decode_len)
            whole = [int(t) for t in whole_engine.run_batch([dict(f)])[0][:budget]]
            if bundle.cfg.eos_id in whole:
                whole = whole[: whole.index(bundle.cfg.eos_id) + 1]
            versus.append(whole_vs_chunked(bundle, ref_model, f, row, whole, check["tol"]))
    out = dict(
        device=str(bundle.device), card=card_line, layers=bundle.cfg.num_layers,
        paged=engine.paged_kv, slots=loop.n_slots, slot_width=loop._slot_width(),
        prefill_chunk=c,
        prompts=[int(f["length"]) for f in feats], jobs_live=sorted(went_live),
        prefill_chunks=loop.prefill_chunk_dispatches, prefix_cache=engine.prefix_cache.stats(),
        admission_waves=loop.prefill_dispatches, slot_decode_steps=loop.decode_steps,
        decode_attention_launches=k2, warm_s=warm_s, whole_vs_chunked=versus,
        identical=sum(v["identical"] for v in versus),
        generated_tok_per_s=check["tokens_checked"] / wall, graph_modes=engine.graph_modes(),
        **check)
    emit(label, **out)
    return bundle, {"decode_attention": k2} if k2 else {}, gdrive


def time_chunk(engine, loop, eager: bool = True) -> dict:
    """One chunk of the loop's slot state, eager (unless ``eager`` is
    false) and through its graph, timed (CUDA events) and split by kernel
    (``torch.profiler``): every slot live at full width (all keys valid
    and, paged, a table of distinct pool blocks; a dead row's compute is a
    live row's), so the attention reads what full streams would."""
    import numpy as np
    import torch

    bundle = engine.bundle
    with torch.inference_mode(), engine._lock:
        every_key_valid(loop._state)
        if engine.paged_kv:
            loop._table[:] = np.arange(loop._table.size).reshape(loop._table.shape) % \
                engine.kv_pool.num_blocks
            loop._table_dev.copy_(torch.from_numpy(loop._table))

        def eager_chunk():
            if engine.paged_kv:
                bundle.paged_chunk(loop._state, loop._table_dev, loop.chunk)
            else:
                bundle.generate_chunk(loop._state, loop.chunk)

        def graph():
            loop._chunk_call()

        return eager_and_graph(eager_chunk if eager else None, graph, 5,
                               K3_KERNEL if engine.paged_kv else K2_KERNEL, "attention")


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
    ``[d_in, d_out]`` kernels, each the transpose of a row-major ``[d_out,
    d_in]`` array as ``llama_pytree``'s) at its init's scales: N(0, 0.02)
    token table and projections, N(0, 0.01) positions, zero biases, unit
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
        return {"kernel": w(0.02, n_out, n_in).T, "bias": np.zeros(n_out, np.float32)}

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


def phase_t5_timings(bundle, engine, batches=(32,)) -> None:
    """Where T5's time goes on the card: ``start`` (encode, the cross K/V,
    the first chunk) at S=512 and each of ``batches`` (B = 32 in the main
    run, for its time), eager and as the bucket's graph, split into K1,
    GEMMs and the rest; then one decode step at the same batches over a
    64-position cache (``phase_decode_step``; K1 runs in none)."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models.sampling import greedy_params

    gen = torch.Generator(device="cuda").manual_seed(4)
    for b in batches:
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
    phase_decode_step(bundle, "decode step t5", batches=batches, prompt=512,
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


# ---------------------------------------------------------------------------
# fused decode windows (DECODE_WINDOW)

WINDOW_WORDS = ["window", "fused", "chunk", "batch", "exit", "early", "token", "slot"]


def window_candidates(rehearsal: bool, n: int, seed: int):
    """``n`` prompts under 31 bytes (one seq bucket, 32, with a BOS), every
    third sampled and seeded (temperature 0.7 or 1.0, top_k 0 or 40)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        length = int(rng.integers(12, 30))
        text = " ".join(rng.choice(WINDOW_WORDS, size=length))[:length]
        sampling = {}
        if i % 3 == 2:
            sampling = dict(temperature=(0.7, 1.0)[i // 3 % 2], top_k=(0, 40)[i // 6 % 2],
                            seed=3000 + seed * 100 + i)
        items.append(RawItem(text=text, **sampling))
    return items


def rig_eos(bundle, eos: int) -> None:
    """``eos`` as the model's end token, before anything is captured: the
    phase's streams end on it (the random weights' own eos is rare)."""
    bundle.cfg = dataclasses.replace(bundle.cfg, eos_id=int(eos))
    bundle.model.cfg = bundle.cfg


def pick_eos(batch_rows, inter_rows, lo: int, hi: int, need_inter: bool):
    """The token whose first appearance falls in steps [lo, hi) of the most
    batch rows (and, with ``need_inter``, at a step >= ``lo`` + 8 of an
    interactive row); returns (token, {batch row: its step}, interactive
    row or None)."""
    def firsts(row):
        seen = {}
        for k, t in enumerate(int(x) for x in row):
            seen.setdefault(t, k)
        return seen

    counts: dict[int, dict] = {}
    for i, row in enumerate(batch_rows):
        for t, k in firsts(row).items():
            if lo <= k < hi:
                counts.setdefault(t, {})[i] = k
    inter_at = [firsts(row) for row in inter_rows]
    for t in sorted(counts, key=lambda t: -len(counts[t])):
        j = next((j for j, f in enumerate(inter_at) if lo + 8 <= f.get(t, -1) < hi), None)
        if j is not None or not need_inter:
            return t, counts[t], j
    raise AssertionError("no token ends several streams of the probe")


async def drive_window(batcher, bundle, min_tokens: int, reset, read, passes,
                       late_klass: str = "interactive"):
    """For each of ``passes`` (its batch items and its late items):
    ``reset()``, open the batch-class streams at once; once one has
    ``min_tokens`` tokens, open the late ones (of class ``late_klass``);
    read every stream to its end and wait until the loop released them.
    Returns each pass's ([(feats, tokens)] batch first, wall seconds,
    ``read(its index)`` after it)."""
    import numpy as np

    await batcher.start()
    loop = batcher._cdl

    async def one(item, klass, go, batch: bool):
        f = dict(bundle.preprocess(item), priority=klass)
        toks = []
        try:
            async for chunk in batcher.submit_stream(f):
                toks.extend(int(x) for x in chunk)
                if batch and len(toks) >= min_tokens:
                    go.set()
        finally:
            go.set()
        return f, np.array(toks, np.int32)

    out = []
    try:
        for i, (batch_items, late_items) in enumerate(passes):
            reset()
            go = asyncio.Event()
            t0 = time.monotonic()
            tasks = [asyncio.create_task(one(item, "batch", go, True)) for item in batch_items]
            if late_items:
                await go.wait()
                tasks += [asyncio.create_task(one(item, late_klass, go, False))
                          for item in late_items]
            done = await asyncio.gather(*tasks)
            wall = time.monotonic() - t0
            while loop.admitted or loop._inflight:
                await asyncio.sleep(0.005)
            out.append((done, wall, read(i)))
    finally:
        await batcher.stop()
    return out


def window_llama(rehearsal: bool, device: str) -> tuple[dict, int]:
    """``serve llama window``'s service (TinyLlama at 22 layers, paged, 16
    slots, one seq bucket used) and its batch streams (rehearsal: the small
    llama, 6)."""
    ov = {"MODEL_NAME": "llama", "DEVICE": device, "BATCH_BUCKETS": "1,16",
          "SEQ_BUCKETS": "32,64", "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE),
          "MAX_STREAMS": "16", "MAX_DECODE_LEN": "64"}
    if rehearsal:
        ov["LLAMA_CONFIG"] = json.dumps(REHEARSAL_LLAMA)
    return ov, 6 if rehearsal else 15


def window_gpt2(rehearsal: bool, device: str) -> tuple[dict, int]:
    """``serve gpt2 window``'s service (GPT-2 small, contiguous, 16 slots)
    and its batch streams (rehearsal: 6)."""
    return ({"MODEL_NAME": "gpt2", "DEVICE": device, "BATCH_BUCKETS": "1,16",
             "SEQ_BUCKETS": "32,64", "MAX_STREAMS": "16", "MAX_DECODE_LEN": "64"},
            6 if rehearsal else 15)


def window_service(overrides: dict, params, eos: int | None):
    """A service of the phase's model with ``eos`` rigged, its engine's
    bucket graphs captured and its loop's slot state built and chunk graphs
    captured (``warm_engine``, ``warm_streams``): no pass captures a start
    graph, whose eager run would launch K2 outside the loop's counts (a
    pass's waves form as the streams arrive)."""
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    if eos is not None:
        rig_eos(bundle, eos)
    warm_s = batcher.warm_engine() + batcher.warm_streams()
    return cfg, bundle, engine, batcher, warm_s


def phase_serve_window(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                       card_line: str, cap: int, auto: bool, n_batch: int, n_inter: int,
                       want_early_exit: bool):
    """Fused decode windows through the continuous loop: a probe service
    (``DECODE_WINDOW=1``, the model's own eos) streams candidate prompts
    and the token that first appears early in most of them becomes the eos;
    the ``n_batch`` batch-class streams that end on it (budgets mixed, each
    past its eos) and, once they decode, ``n_inter`` interactive ones run
    on a service at ``DECODE_WINDOW=1`` and on one at ``cap`` (AUTO
    ``auto``), twice each (the first pass captures the start graphs; the
    second is measured).  A third of the batch streams are sampled and
    seeded where that many sampled candidates end on the eos.  A window
    ends early only when every slot's row is done, and a row whose stream
    ended on its budget never is: so every stream ends on the eos.  Gates:
    windows formed and (``want_early_exit``) one ended early; the same tokens at both
    depths, greedy and seeded; under AUTO the governor at 1 while an
    interactive stream is live or waiting; every token teacher-forced; K2
    and K3 held against the loop's counts; the pool empty, every stream
    released.  Printed: window counts, the governor's depths over time,
    chunk and fetch boundaries per token and tokens/s at both depths, the
    device ms of the chunks a window ran past every row's end."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention

    t_phase = time.monotonic()
    base = {**overrides, "DECODE_WINDOW_AUTO": "1" if auto else "0"}
    # The probe: every candidate alone or in waves of 16 (one seq bucket,
    # the wave's batch bucket as in the measured run).
    n_cand = (2 if rehearsal else 16) * n_batch
    cands = window_candidates(rehearsal, n_cand, 1)
    inter_cands = window_candidates(rehearsal, (4 if rehearsal else 8) * n_inter, 2)
    inter_cands = [dataclasses.replace(it, temperature=0.0, seed=None) for it in inter_cands]
    cfg, bundle, engine, batcher, _ = window_service({**base, "DECODE_WINDOW": "1"}, params,
                                                     None)
    max_len, chunk = engine.max_decode_len, engine.chunk_tokens
    waves = [cands[i:i + n_batch] for i in range(0, n_cand, n_batch)]
    probe = asyncio.run(drive_streams(batcher, bundle, waves + [[it] for it in inter_cands]))
    rows = probe[1]
    release(bundle)
    del cfg, bundle, engine, batcher
    eos, hits, j = pick_eos(rows[:n_cand], rows[n_cand:], 8, max_len - 8, bool(n_inter))
    by_step = sorted(hits, key=lambda i: hits[i])
    sampled = [i for i in by_step if cands[i].temperature > 0][: n_batch // 3]
    chosen = sorted(sampled + [i for i in by_step if i not in sampled][: n_batch - len(sampled)])
    if len(chosen) < 3:
        raise AssertionError(f"{label}: the eos {eos} ends {len(chosen)} probe streams")
    rng = np.random.default_rng(7)
    batch_items = [dataclasses.replace(
        cands[i], max_tokens=int(min(max_len, hits[i] + 1 + 8 * rng.integers(1, 4))))
        for i in chosen]
    inter_items = [inter_cands[j]] if n_inter else []
    # A greedy stream alone with the whole budget whose eos comes before the
    # last chunk of its first window (``cap`` chunks from step ``chunk``):
    # that window ends early on the device.  Taken from the probe's lone
    # greedy streams (the same batch bucket, 1, as the pass; its start graph
    # captured in the first pass, by the interactive stream), else from the
    # greedy candidates.
    def first(row):
        return next((k for k, t in enumerate(row.tolist()) if t == eos), -1)

    in_window = [(inter_cands[k], first(row)) for k, row in enumerate(rows[n_cand:])]
    in_window += [(cands[i], hits[i]) for i in by_step if cands[i].temperature == 0]
    lone = next((it for it, at in in_window if chunk <= at < chunk * cap), None)
    if want_early_exit and lone is None:
        raise AssertionError(f"{label}: no greedy probe stream ends on {eos} in its first "
                             "window")
    lone_item = dataclasses.replace(lone, max_tokens=max_len) if want_early_exit else None

    runs = {}
    for w in (1, cap):
        cfg, bundle, engine, batcher, warm_s = window_service(
            {**base, "DECODE_WINDOW": str(w)}, params, eos)
        loop = batcher._cdl
        picks = []
        if w > 1:
            gov, t0 = loop._window_gov, time.monotonic()
            orig_pick = gov.pick

            def pick(max_chunks, interactive_live, interactive_waiting, orig=orig_pick, t0=t0):
                got = orig(max_chunks, interactive_live, interactive_waiting)
                picks.append((round(time.monotonic() - t0, 4), got,
                              bool(interactive_live or interactive_waiting)))
                return got

            gov.pick = pick
        def reset(loop=loop, engine=engine, w=w):
            picks.clear()
            decode_attention.launches = paged_decode_attention.launches = 0
            for name in ("prefill_dispatches", "chunk_dispatches", "decode_steps",
                         "window_dispatches", "window_chunks", "window_early_exits",
                         "tokens_emitted", "window_tail_chunks"):
                setattr(loop, name, 0)
            loop.window_tail_ms = 0.0
            loop.time_windows = w > 1 and not rehearsal
            engine.decode_steps = 0
            engine.dispatch_stats.clear()

        def read(i, loop=loop, engine=engine, bundle=bundle, w=w):
            """The pass's counts; K2 and K3 held against them from the
            second pass on (the first captures the start graphs)."""
            if i > 0:
                held_launches(label, bundle, engine, loop, decode_attention.launches,
                              paged_decode_attention.launches, rehearsal)
            dc = dict(engine.dispatch_counts)
            out = dict(
                admission_waves=loop.prefill_dispatches, dispatches=loop.chunk_dispatches,
                slot_decode_steps=loop.decode_steps, window_dispatches=loop.window_dispatches,
                window_chunks=loop.window_chunks, window_early_exits=loop.window_early_exits,
                tokens_emitted=loop.tokens_emitted, dispatch_counts=dc,
                chunk_fetch_per_token=(dc.get("chunk", 0) + dc.get("fetch", 0))
                / max(1, loop.tokens_emitted),
                decode_attention_launches=decode_attention.launches,
                paged_decode_attention_launches=paged_decode_attention.launches,
                picks=list(picks))
            if w > 1:
                out.update(
                    window_tail_ms=loop.window_tail_ms if not rehearsal else None,
                    window_tail_chunks=loop.window_tail_chunks,
                    window_tail_ms_per_chunk=(loop.window_tail_ms / loop.window_tail_chunks
                                              if loop.window_tail_chunks and not rehearsal
                                              else None))
            return out

        # The first pass captures the start graphs it meets; the second is
        # the one measured and checked.  With interactive streams a third
        # pass runs the batch streams alone: under AUTO the interactive
        # one holds W at 1 from its arrival on, so only this pass measures
        # windows end to end.  Where an early exit is wanted, a last pass
        # runs one stream alone whose eos comes inside its first window.
        passes = [(batch_items, inter_items)] * 2
        if inter_items:
            passes.append((batch_items, []))
        if want_early_exit:
            passes.append(([lone_item], []))
        measured = asyncio.run(drive_window(batcher, bundle, 3 * engine.chunk_tokens, reset,
                                            read, passes))
        done, wall, counts = measured[1]
        pass_picks = counts.pop("picks")
        if engine.paged_kv and engine.kv_pool.used_blocks != 0:
            raise AssertionError(f"{label}: {engine.kv_pool.used_blocks} pool blocks still held")
        if loop.admitted != 0:
            raise AssertionError(f"{label}: {loop.admitted} streams never released")
        tokens = sum(len(row) for _, row in done)
        runs[w] = dict(
            feats=[f for f, _ in done], rows=[row for _, row in done], bundle=bundle,
            out=dict(warm_s=warm_s, tokens=tokens, generated_tok_per_s=tokens / wall,
                     wall_s=wall, **counts),
            loop=loop, picks=pass_picks)
        if want_early_exit:
            l_done, _, l_counts = measured.pop()
            runs[w]["lone_feats"], runs[w]["lone_row"] = l_done[0]
            runs[w]["lone"] = {k: l_counts[k] for k in (
                "dispatches", "window_dispatches", "window_chunks", "window_early_exits",
                "slot_decode_steps")}
        if len(measured) > 2:
            b_done, b_wall, b_counts = measured[2]
            b_picks = b_counts.pop("picks")
            b_tokens = sum(len(row) for _, row in b_done)
            runs[w]["batch_rows"] = [row for _, row in b_done]
            runs[w]["batch_only"] = dict(
                tokens=b_tokens, generated_tok_per_s=b_tokens / b_wall, wall_s=b_wall,
                **b_counts, governor=[p[1] for p in b_picks] if w > 1 else None)
        if w > 1:
            lone = [runs[w]["lone_feats"]] if want_early_exit else []
            lone_rows = [runs[w]["lone_row"]] if want_early_exit else []
            check = teacher_forced(bundle, ref_model, runs[w]["feats"] + lone,
                                   runs[w]["rows"] + lone_rows, max_len)
        release(bundle)
        del cfg, bundle, engine, batcher, loop
    one, fused = runs[1], runs[cap]
    parted = [i for i, (a, b) in enumerate(zip(one["rows"], fused["rows"]))
              if a.tolist() != b.tolist()]
    if parted:
        raise AssertionError(f"{label}: streams {parted} differ between DECODE_WINDOW=1 and "
                             f"{cap}: " + "; ".join(
                                 f"{one['rows'][i].tolist()} vs {fused['rows'][i].tolist()}"
                                 for i in parted[:3]))
    if "batch_rows" in one:
        parted = [i for i, (a, b) in enumerate(zip(one["batch_rows"], fused["batch_rows"]))
                  if a.tolist() != b.tolist()]
        if parted or fused["batch_only"]["window_dispatches"] < 1:
            raise AssertionError(f"{label}: batch streams alone: {parted} differ between "
                                 f"DECODE_WINDOW=1 and {cap}; windows "
                                 f"{fused['batch_only']['window_dispatches']}")
    fo = fused["out"]
    early = not want_early_exit or (
        fused["lone"]["window_early_exits"] >= 1
        and one["lone_row"].tolist() == fused["lone_row"].tolist())
    if fo["window_dispatches"] < 1 or not early or one["out"]["window_dispatches"] != 0:
        raise AssertionError(f"{label}: windows {fo['window_dispatches']}, early exits "
                             f"{fo['window_early_exits']} (the lone stream's: "
                             f"{fused.get('lone')})")
    picks = fused["picks"]
    if auto and n_inter:
        under = [p for p in picks if p[2]]
        if not under or any(p[1] != 1 for p in under) or not any(p[1] > 1 for p in picks):
            raise AssertionError(f"{label}: the governor's picks {picks}: W must be 1 while "
                                 "an interactive stream is live or waiting, and > 1 otherwise")
    ended = sum(1 for f, row in zip(fused["feats"], fused["rows"])
                if eos in row.tolist())
    emit(label, device=str(fused["bundle"].device), card=card_line,
         layers=fused["bundle"].cfg.num_layers, paged=bool(overrides.get("PAGED_KV") == "1"),
         cap=cap, auto=auto, eos=eos, batch_streams=len(batch_items),
         interactive_streams=len(inter_items), streams_ended_on_eos=ended,
         budgets=[it.max_tokens for it in batch_items],
         identical_at_both_depths=True, sampled_streams=sum(
             1 for it in batch_items if it.temperature > 0),
         w1=one["out"], fused=fo,
         governor=[p[:2] for p in picks] if auto else None,
         w1_batch_only=one.get("batch_only"), fused_batch_only=fused.get("batch_only"),
         w1_lone=one.get("lone"), fused_lone=fused.get("lone"),
         phase_s=time.monotonic() - t_phase, **check)
    return fo


def window_main(rehearsal: bool) -> int:
    """``--window``: the build and the two fused-window phases (``serve
    llama window`` at 22 layers, ``serve gpt2 window``); with
    ``--cpu-rehearsal`` the same phases on the CPU at the small llama and
    no build.  Prints no result line."""
    import torch

    from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
        gpt_params_from_jax,
        llama_params_from_jax,
    )
    from mlmicroservicetemplate_tpu_torch.models import gpt as gpt_mod
    from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

    phase = "env"
    device = "cpu" if rehearsal else "cuda"
    try:
        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="window")
        if not rehearsal:
            phase = "build"
            phase_build()
        phase = "serve llama window"
        lcfg = llama_mod.LlamaConfig(**(REHEARSAL_LLAMA if rehearsal else {}), eos_id=1,
                                     pad_id=0)
        params = llama_pytree(lcfg, seed=0)
        ref = llama_mod.build_model(lcfg, llama_params_from_jax(params, lcfg),
                                    torch.device(device), torch.float32)
        ov, n = window_llama(rehearsal, device)
        phase_serve_window(phase, ov, params, ref, rehearsal, card_line, cap=8, auto=True,
                           n_batch=n, n_inter=1, want_early_exit=True)
        del ref, params
        phase = "serve gpt2 window"
        gcfg = gpt_mod.GPTConfig(eos_id=1, pad_id=0)
        gparams = gpt2_pytree(gcfg, seed=0)
        gref = gpt_mod.build_model(gcfg, gpt_params_from_jax(gparams, gcfg),
                                   torch.device(device), torch.float32)
        ov, n = window_gpt2(rehearsal, device)
        phase_serve_window(phase, ov, gparams, gref, rehearsal, card_line, cap=4, auto=False,
                           n_batch=n, n_inter=0, want_early_exit=False)
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


# ---------------------------------------------------------------------------
# the loop's dispatch pipeline (STREAM_PIPELINE, HOST_PREP_DOUBLE, ADMIT_OVERLAP)


def pipeline_gpt2(rehearsal: bool, device: str) -> tuple[dict, int, int]:
    """``serve gpt2 pipeline``'s service (GPT-2 small through the paged
    loop, 16 slots, 16-token blocks; every wave padded to the one batch
    bucket of 16 and the prompts under one seq bucket, so a stream's
    arithmetic is the same whatever wave it joins), its batch streams and
    its late wave (rehearsal: 6 and 2)."""
    ov = {"MODEL_NAME": "gpt2", "DEVICE": device, "BATCH_BUCKETS": "16",
          "SEQ_BUCKETS": "32,64", "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE),
          "MAX_STREAMS": "16", "MAX_STREAM_QUEUE": "8", "MAX_DECODE_LEN": "64"}
    return ov, (6 if rehearsal else 15), (2 if rehearsal else 4)


# Measured passes a service (after one more).
PIPELINE_PASSES = 2
PIPELINE_SERVICES = (
    ("serial", {"STREAM_PIPELINE": "1", "HOST_PREP_DOUBLE": "0"}),
    ("depth3", {"STREAM_PIPELINE": "3", "HOST_PREP_DOUBLE": "1"}),
    ("depth3_window4", {"STREAM_PIPELINE": "3", "HOST_PREP_DOUBLE": "1",
                        "DECODE_WINDOW": "4"}),
    ("blocking_admission", {"ADMIT_OVERLAP": "0"}),
)


def pipeline_service(overrides: dict, params, eos: int | None):
    """``window_service`` with every start graph captured too (as the app
    warms), so that no pass captures one: a capture runs its call eagerly
    once, which the launch counts would see."""
    cfg, bundle, engine, batcher, warm_s = window_service(overrides, params, eos)
    return cfg, bundle, engine, batcher, warm_s + batcher.warm_engine()


def host_seconds(samples: dict) -> dict:
    """Per dispatch site: the count, p50 and sum of the host seconds the
    loop observed into ``dispatch_host_seconds``."""
    import numpy as np

    return {site: {"count": len(v), "p50_ms": float(np.percentile(v, 50)) * 1e3,
                   "sum_ms": float(np.sum(v)) * 1e3}
            for site, v in sorted(samples.items())}


async def lone_ttfts(batcher, bundle, items) -> list[float]:
    """Each item alone on an idle loop: seconds from submit to its first
    chunk."""
    await batcher.start()
    loop = batcher._cdl
    out = []

    async def one(item):
        t0 = time.monotonic()
        first = None
        async for _ in batcher.submit_stream(bundle.preprocess(item)):
            if first is None:
                first = time.monotonic() - t0
        while loop.admitted or loop._inflight:
            await asyncio.sleep(0.002)
        await asyncio.sleep(0.05)  # the loop thread back at its idle wait
        return first

    try:
        for item in items:
            out.append(await one(item))
    finally:
        await batcher.stop()
    return out


def phase_serve_pipeline(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                         card_line: str, n_batch: int, n_late: int):
    """The loop's dispatch pipeline through the paged loop (K3): a probe
    service picks a common token as the eos and the streams that end on it,
    as in 7g; then ``n_batch`` batch-class streams (a third sampled and
    seeded) open at once and, once one has 12 tokens, a late wave of
    ``n_late`` arrives while chunks are in flight, on four services
    (``PIPELINE_SERVICES``: the serial order, depth 3 with the staged host
    prep, the same with windows of 4, the blocking admission at the
    defaults), every start graph captured first as the app warms, then a
    pass and three measured passes each.
    Gates: every service the serial one's tokens; every token teacher-forced;
    depth 3 staged plans and used them; never more than the depth in flight
    at a dispatch; K2 and K3 held against the loop's counts; the pool empty
    and every stream released after each.  Then 8 lone requests on an idle
    loop at the defaults (the tuned depth and grace) and at
    ``STREAM_PIPELINE=1`` (the configured 8 ms grace): their TTFT.
    Printed: the tuned depth, RTT, compute and grace, the host seconds by
    dispatch site, chunk and fetch boundaries per token, tokens/s and the
    staged-prep counts of each service."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention

    t_phase = time.monotonic()
    n_cand = (2 if rehearsal else 16) * n_batch
    cands = window_candidates(rehearsal, n_cand, 1)
    cfg, bundle, engine, batcher, _ = window_service({**overrides, "STREAM_PIPELINE": "1"},
                                                     params, None)
    max_len = engine.max_decode_len
    waves = [cands[i:i + n_batch] for i in range(0, n_cand, n_batch)]
    rows = asyncio.run(drive_streams(batcher, bundle, waves))[1]
    release(bundle)
    del cfg, bundle, engine, batcher
    eos, hits, _ = pick_eos(rows, [], 8, max_len - 8, False)
    by_step = sorted(hits, key=lambda i: hits[i])
    sampled = [i for i in by_step if cands[i].temperature > 0][: n_batch // 3]
    chosen = sorted(sampled + [i for i in by_step if i not in sampled][: n_batch - len(sampled)])
    spare = [i for i in by_step if i not in chosen] + [
        i for i in range(n_cand) if i not in hits]
    late = spare[:n_late]
    if len(chosen) < 3:
        raise AssertionError(f"{label}: the eos {eos} ends {len(chosen)} probe streams")
    rng = np.random.default_rng(11)

    def budget(i):
        if i not in hits:
            return max_len
        return int(min(max_len, hits[i] + 1 + 8 * rng.integers(1, 4)))

    batch_items = [dataclasses.replace(cands[i], max_tokens=budget(i)) for i in chosen]
    late_items = [dataclasses.replace(cands[i], max_tokens=budget(i)) for i in late]

    runs = {}
    for name, knobs in PIPELINE_SERVICES:
        cfg, bundle, engine, batcher, warm_s = pipeline_service({**overrides, **knobs}, params,
                                                                eos)
        loop = batcher._cdl
        in_flight, samples = [], {}
        orig_dispatch, orig_note = loop._dispatch_chunk, engine.note_dispatch

        def dispatch(loop=loop, orig=orig_dispatch, in_flight=in_flight):
            in_flight.append(len(loop._inflight))
            return orig()

        def note(site, host_s=None, orig=orig_note, samples=samples):
            if host_s is not None:
                samples.setdefault(site, []).append(host_s)
            return orig(site, host_s)

        loop._dispatch_chunk, engine.note_dispatch = dispatch, note

        def reset(loop=loop, engine=engine, in_flight=in_flight, samples=samples):
            in_flight.clear()
            samples.clear()
            decode_attention.launches = paged_decode_attention.launches = 0
            for key in ("prefill_dispatches", "chunk_dispatches", "decode_steps",
                        "window_dispatches", "window_chunks", "window_early_exits",
                        "tokens_emitted", "prep_staged", "prep_hits", "prep_misses"):
                setattr(loop, key, 0)
            engine.decode_steps = 0
            engine.dispatch_stats.clear()

        def read(i, loop=loop, engine=engine, bundle=bundle, in_flight=in_flight,
                 samples=samples):
            if i > 0:
                held_launches(label, bundle, engine, loop, decode_attention.launches,
                              paged_decode_attention.launches, rehearsal)
            dc = dict(engine.dispatch_counts)
            return dict(
                admission_waves=loop.prefill_dispatches, dispatches=loop.chunk_dispatches,
                slot_decode_steps=loop.decode_steps, window_dispatches=loop.window_dispatches,
                tokens_emitted=loop.tokens_emitted, dispatch_counts=dc,
                chunk_fetch_per_token=(dc.get("chunk", 0) + dc.get("fetch", 0))
                / max(1, loop.tokens_emitted),
                prep_staged=loop.prep_staged, prep_hits=loop.prep_hits,
                prep_misses=loop.prep_misses, max_in_flight_at_dispatch=max(in_flight,
                                                                            default=0),
                host_seconds=host_seconds(samples),
                decode_attention_launches=decode_attention.launches,
                paged_decode_attention_launches=paged_decode_attention.launches)

        measured = asyncio.run(drive_window(batcher, bundle, 3 * engine.chunk_tokens, reset,
                                            read, [(batch_items, late_items)] * (1 + PIPELINE_PASSES),
                                            late_klass="batch"))[1:]
        # The middle pass by tokens/s (of two, the faster; the passes are
        # short: their spread is printed).
        rates = [sum(len(row) for _, row in d) / wall for d, wall, _ in measured]
        done, wall, counts = measured[int(np.argsort(rates)[len(rates) // 2])]
        rows_of = [[row.tolist() for _, row in d] for d, _, _ in measured]
        if any(r != rows_of[0] for r in rows_of):
            raise AssertionError(f"{label} {name}: the passes gave different tokens")
        if engine.kv_pool.used_blocks != 0:
            raise AssertionError(f"{label} {name}: {engine.kv_pool.used_blocks} pool blocks "
                                 "still held")
        if loop.admitted != 0:
            raise AssertionError(f"{label} {name}: {loop.admitted} streams never released")
        most = max(c["max_in_flight_at_dispatch"] for _, _, c in measured)
        if most > loop.chain_depth:
            raise AssertionError(f"{label} {name}: {most} "
                                 f"dispatches in flight at depth {loop.chain_depth}")
        tokens = sum(len(row) for _, row in done)
        runs[name] = dict(
            feats=[f for f, _ in done], rows=[row for _, row in done],
            out=dict(knobs=knobs, chain_depth=loop.chain_depth, auto=loop._auto_depth,
                     tuned_rtt_ms=loop.tuned[0] * 1e3 if loop.tuned else None,
                     tuned_compute_ms=loop.tuned[1] * 1e3 if loop.tuned else None,
                     admit_grace_ms=loop.admit_grace_s * 1e3, warm_s=warm_s, tokens=tokens,
                     generated_tok_per_s=tokens / wall, tok_per_s_passes=rates, wall_s=wall,
                     **counts))
        if name == "serial":
            check = teacher_forced(bundle, ref_model, runs[name]["feats"], runs[name]["rows"],
                                   max_len)
        release(bundle)
        del cfg, bundle, engine, batcher, loop
    serial = runs["serial"]["rows"]
    for name, run in runs.items():
        parted = [i for i, (a, b) in enumerate(zip(serial, run["rows"]))
                  if a.tolist() != b.tolist()]
        if parted or len(run["rows"]) != len(serial):
            raise AssertionError(f"{label}: streams {parted} of {name} differ from the serial "
                                 "order's: " + "; ".join(
                                     f"{serial[i].tolist()} vs {run['rows'][i].tolist()}"
                                     for i in parted[:3]))
    d3 = runs["depth3"]["out"]
    if d3["prep_staged"] < 1 or d3["prep_hits"] < 1:
        raise AssertionError(f"{label}: depth 3 staged {d3['prep_staged']} plans and used "
                             f"{d3['prep_hits']}")
    if runs["depth3_window4"]["out"]["window_dispatches"] < 1:
        raise AssertionError(f"{label}: no window formed at DECODE_WINDOW=4")

    # Lone requests on an idle loop: the tuned grace against the configured.
    lone = [dataclasses.replace(item, max_tokens=8) for item in cands[:8]]
    ttft = {}
    for name, knobs in (("tuned", {}), ("configured_8ms", {"STREAM_PIPELINE": "1"})):
        cfg, bundle, engine, batcher, warm_s = pipeline_service({**overrides, **knobs}, params,
                                                                None)
        loop = batcher._cdl
        got = np.array(asyncio.run(lone_ttfts(batcher, bundle, lone))) * 1e3
        ttft[name] = dict(chain_depth=loop.chain_depth, admit_grace_ms=loop.admit_grace_s * 1e3,
                          tuned_rtt_ms=loop.tuned[0] * 1e3 if loop.tuned else None,
                          tuned_compute_ms=loop.tuned[1] * 1e3 if loop.tuned else None,
                          ttft_p50_ms=float(np.percentile(got, 50)),
                          ttft_ms=[float(x) for x in got])
        release(bundle)
        del cfg, bundle, engine, batcher, loop
    k2 = sum(r["out"]["decode_attention_launches"] for r in runs.values())
    k3 = sum(r["out"]["paged_decode_attention_launches"] for r in runs.values())
    emit(label, device=overrides["DEVICE"], card=card_line, eos=eos,
         batch_streams=len(batch_items), late_streams=len(late_items),
         sampled_streams=sum(1 for it in batch_items + late_items if it.temperature > 0),
         streams_ended_on_eos=sum(1 for row in serial if eos in row.tolist()),
         identical_across_services=True,
         services={name: run["out"] for name, run in runs.items()}, lone_requests=ttft,
         ttft_gain_ms=ttft["configured_8ms"]["ttft_p50_ms"] - ttft["tuned"]["ttft_p50_ms"],
         phase_s=time.monotonic() - t_phase, **check)
    return k2, k3


def pipeline_main(rehearsal: bool) -> int:
    """``--pipeline``: the build and ``serve gpt2 pipeline`` (8e); with
    ``--cpu-rehearsal`` the phase on the CPU at full width, no build.
    Prints no result line."""
    import torch

    from mlmicroservicetemplate_tpu_torch.convert.jax_params import gpt_params_from_jax
    from mlmicroservicetemplate_tpu_torch.models import gpt as gpt_mod

    phase = "env"
    device = "cpu" if rehearsal else "cuda"
    try:
        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="pipeline")
        if not rehearsal:
            phase = "build"
            phase_build()
        phase = "serve gpt2 pipeline"
        gcfg = gpt_mod.GPTConfig(eos_id=1, pad_id=0)
        gparams = gpt2_pytree(gcfg, seed=0)
        gref = gpt_mod.build_model(gcfg, gpt_params_from_jax(gparams, gcfg),
                                   torch.device(device), torch.float32)
        ov, n, n_late = pipeline_gpt2(rehearsal, device)
        phase_serve_pipeline(phase, ov, gparams, gref, rehearsal, card_line, n, n_late)
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


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


def chunked_main() -> int:
    """``--chunked``: the build and the two chunked-prefill phases with
    their graphs phases (``serve llama chunked`` at 22 layers, ``serve gpt2
    chunked`` against GPT-2's whole-generation service); prints no result
    line."""
    import torch

    from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
        gpt_params_from_jax,
        llama_params_from_jax,
    )
    from mlmicroservicetemplate_tpu_torch.models import gpt as gpt_mod
    from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    phase = "env"
    try:
        if not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="chunked")
        phase = "build"
        phase_build()
        phase = "serve llama chunked"
        lcfg = llama_mod.LlamaConfig(eos_id=1, pad_id=0)
        params = llama_pytree(lcfg, seed=0)
        ref = llama_mod.build_model(lcfg, llama_params_from_jax(params, lcfg),
                                    torch.device("cuda"), torch.float32)
        svc = phase_serve_chunked(
            phase, {"MODEL_NAME": "llama", "DEVICE": "cuda", "SEQ_BUCKETS": "32,64,128,256",
                    "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "16",
                    "MAX_DECODE_LEN": "64", **chunked_llama(False)},
            params, ref, False, card_line)
        phase = "graphs llama chunked"
        phase_graphs("llama chunked", svc[0], **svc[2])
        release(svc[0])
        del ref, params, svc
        phase = "serve gpt2 chunked"
        gcfg = gpt_mod.GPTConfig(eos_id=1, pad_id=0)
        gparams = gpt2_pytree(gcfg, seed=0)
        gref = gpt_mod.build_model(gcfg, gpt_params_from_jax(gparams, gcfg),
                                   torch.device("cuda"), torch.float32)
        gpt2 = {"MODEL_NAME": "gpt2", "DEVICE": "cuda", "SEQ_BUCKETS": "32,64,128,256"}
        whole = build_service({**gpt2, "BATCH_BUCKETS": "1,2,4,8,16"}, params=gparams)[2]
        svc = phase_serve_gpt2_chunked(
            phase, {**gpt2, "BATCH_BUCKETS": "1,4", "MAX_STREAMS": "4", "MAX_DECODE_LEN": "64",
                    **chunked_gpt2(False)},
            gparams, gref, whole, False, card_line)
        phase = "graphs gpt2 chunked"
        phase_graphs("gpt2 chunked", svc[0], **svc[2])
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


def tier_main() -> int:
    """``--tier``: the build and ``serve llama tier`` at 22 layers with its
    graphs phase; prints no result line."""
    import torch

    from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
    from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

    phase = "env"
    try:
        if not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="tier")
        phase = "build"
        phase_build()
        phase = "serve llama tier"
        lcfg = llama_mod.LlamaConfig(eos_id=1, pad_id=0)
        params = llama_pytree(lcfg, seed=0)
        ref = llama_mod.build_model(lcfg, llama_params_from_jax(params, lcfg),
                                    torch.device("cuda"), torch.float32)
        svc = phase_serve_tier(
            phase, {"MODEL_NAME": "llama", "DEVICE": "cuda", "SEQ_BUCKETS": "32,64,128,256",
                    "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "16",
                    "MAX_DECODE_LEN": "64", **tier_llama(False)},
            params, ref, False, card_line)
        phase = "graphs llama tier"
        phase_graphs("llama tier", svc[0], **svc[2])
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


# ---------------------------------------------------------------------------
# 8f: speculative decoding (SPEC_DECODE, SPEC_CONTINUOUS)


def spec_items(rehearsal: bool, t5: bool = False):
    """Prompts that quote themselves (prompt lookup's regime) and plain
    ones, greedy, and two seeded sampled ones; each a wave of its own, so
    every stream is alone (the per-stream path speculates only then)."""
    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    lead = "summarize: " if t5 else ""
    texts = [lead + "the cat sat on the mat. the cat sat on the mat. the cat sat on the mat. "
                    "the cat sat on",
             lead + "one two three four one two three four one two three",
             lead + "a plain prompt with nothing to quote",
             lead + "abcabcabcabcabcabcabcabc"]
    items = [RawItem(text=t) for t in texts]
    items += [RawItem(text=texts[0], temperature=0.8, top_k=40, seed=11),
              RawItem(text=texts[1], temperature=1.0, top_p=0.9, seed=12)]
    if rehearsal:
        items = [items[0], items[3], items[4]]
    return items


def spec_tokens_check(bundle, ref_model, feats, rows, max_len: int) -> dict:
    """Every emitted token against an f32 forward: greedy rows
    teacher-forced (``teacher_forced``: each token within TF_FACTOR times
    the run's logit error of the reference's best); a sampled row's draws
    are rejection sampling's, not the sequential sampler's, so each of its
    tokens must lie inside the row's filtered support under the reference
    (its temperature-scaled logit no further below the filter's cutoff than
    the tolerance)."""
    import torch

    greedy = [(f, r) for f, r in zip(feats, rows) if float(f.get("temperature", 0.0)) == 0.0]
    check = teacher_forced(bundle, ref_model, [f for f, _ in greedy], [r for _, r in greedy],
                           max_len)
    worst, n = 0.0, 0
    with torch.inference_mode():
        for f, row in zip(feats, rows):
            if float(f.get("temperature", 0.0)) == 0.0:
                continue
            toks = [int(t) for t in row]
            if bundle.cfg.eos_id in toks:
                toks = toks[: toks.index(bundle.cfg.eos_id) + 1]
            ref = forced_logits(bundle, ref_model, f, toks)
            steps = torch.arange(len(toks), device=ref.device)
            _, raw, cutoff, tol_s = perturbed(ref, f, steps, check["tol"])
            t = torch.tensor(toks, device=ref.device)[:, None]
            outside = float((cutoff - raw.gather(1, t)[:, 0]).max())
            worst = max(worst, outside / tol_s)
            n += len(toks)
    if worst > 1.0:
        raise AssertionError(f"a sampled spec token lies outside its filtered support: {worst}")
    return {**check, "sampled_tokens": n, "sampled_worst_outside_over_tol": worst}


def verify_vs_step(engine, s: int) -> dict:
    """A verify round against a decode step at B = 1 over an S-token
    prompt's cache: each the bucket's graph replay (``spec_chunk``: the
    chunk's rounds; ``gen_chunk``: its steps) timed by CUDA events a round
    or step, and split by ``torch.profiler`` into GEMMs (attention's
    einsums among them) and the rest, K2 apart in the step; and the verify
    window's attention alone (``_window_attention`` at the round's shapes,
    the GQA repeat included) timed and split, times the layers."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models import llama

    bundle = engine.bundle
    cfg = bundle.cfg
    n, k = engine.chunk_tokens, engine.spec_k
    shape = (1, s)
    with torch.inference_mode(), engine._lock:
        start = engine._spec_start_graph(shape, False)
        spec = engine._graph("spec_chunk", shape, False,
                             lambda: engine._make_spec_chunk(shape, False))
        gstart = engine._start_graph(shape, False)
        gchunk = engine._graph("gen_chunk", shape, False,
                               lambda: engine._make_gen_chunk(shape, False))

        def round_():
            start.replay()
            spec.replay()

        def step():
            gstart.replay()
            gchunk.replay()

        # The start's share is timed apart and taken off.
        t_start, t_round = cuda_ms(start.replay, 10), cuda_ms(round_, 10)
        t_gstart, t_step = cuda_ms(gstart.replay, 10), cuda_ms(step, 10)
        p_start = profile_split(start.replay, 3, r"^$", "none")
        p_round = profile_split(round_, 3, r"^$", "none")
        p_gstart = profile_split(gstart.replay, 3, K2_KERNEL, "attention")
        p_step = profile_split(step, 3, K2_KERNEL, "attention")
        total = s + engine.max_decode_len
        dt = bundle.policy.compute_dtype
        q = torch.randn(1, k + 1, cfg.num_heads, cfg.head_dim, device="cuda", dtype=dt)
        kv = [torch.randn(1, total, cfg.num_kv_heads, cfg.head_dim, device="cuda", dtype=dt)
              for _ in range(2)]
        mask = torch.ones(1, 1, k + 1, total, dtype=torch.bool, device="cuda")

        def attend():
            llama._window_attention(cfg, q, kv[0], kv[1], mask)

        # Alone, eager: its wall time is the launches', so its busy time
        # (the profiler's) stands for its share.
        p_attn = profile_split(attend, 5, r"^$", "none")

    def per(a: dict, b: dict, div: int) -> dict:
        return {key: (a[key] - b[key]) / div for key in ("gemm_ms", "other_ms")
                if a.get(key) is not None and b.get(key) is not None}

    verify_ms, step_ms = (t_round - t_start) / n, (t_step - t_gstart) / n
    round_split = per(p_round, p_start, n)
    step_split = per(p_step, p_gstart, n)
    step_split["k2_ms"] = (p_step["attention_ms"] - p_gstart["attention_ms"]) / n
    attn = {key: p_attn[key] * cfg.num_layers for key in ("gemm_ms", "other_ms")}
    attn_busy = sum(attn.values())
    return {
        "batch": 1, "prompt_bucket": s, "cache_len": total, "window": k + 1,
        "verify_round_ms": verify_ms, "decode_step_ms": step_ms,
        "verify_over_step": verify_ms / step_ms,
        "verify_round_busy_split_ms": round_split,
        "decode_step_busy_split_ms": step_split,
        "window_attention_busy_ms": attn_busy, "window_attention_busy_split_ms": attn,
        "window_attention_share_of_round_busy": attn_busy / sum(round_split.values()),
        "window_attention_kernels_a_layer": p_attn["kernels"],
    }


def spec_stream_service(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                        card_line: str, t5: bool = False) -> tuple:
    """A per-stream speculative service (``CONTINUOUS_BATCHING=0``,
    ``SPEC_DECODE=ngram``): warmed, its spec items streamed each alone
    through ``Batcher.submit_stream``, a greedy and a sampled one whole
    through ``Batcher.submit`` (``full_spec``), and with the prefix cache
    on (decoder families) a second prompt that hits the first's bucket
    prefix.  Gates: 0 graph misses after warmup, the launch counters
    against the replays, every token checked (``spec_tokens_check``), a
    whole greedy generation through graphs equal to eager.  Then the same
    streams with speculation off (the engine's plain path, same graphs
    warmed) for tokens/s, and on the card a verify round against a decode
    step.  Returns (launches by kernel, the emitted line)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention, fused_attention
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    warm_s = engine.warmup()
    items = spec_items(rehearsal, t5)
    greedy = [it for it in items if it.temperature == 0.0]
    if not t5:
        # A prompt whose first bucket (a byte a token) is the first one's:
        # the first donates that prefix, this one hits it.
        s_lo = min(engine.seq_buckets)
        items.append(type(greedy[0])(text=greedy[0].text[:s_lo + 4] + " and then the dog"))
    # Tokens a verify round of each streamed chunk, as the
    # ``spec_tokens_per_verify_step`` histogram observes them.
    per_round = []
    emitted = engine._spec_emitted

    def record(out_np, ns_np, n_verify, row=0):
        chunk = emitted(out_np, ns_np, n_verify, row)
        per_round.append(chunk.size / n_verify)
        return chunk

    engine._spec_emitted = record
    fused_attention.launches = decode_attention.launches = 0
    engine.spec_rounds = engine.decode_steps = engine.dispatches = 0
    marks = graph_marks(bundle)
    feats, rows, latencies, ttfts, wall = asyncio.run(
        drive_streams(batcher, bundle, [[it] for it in items]))
    stream_rounds = engine.spec_rounds
    whole_items = [greedy[0]] + [it for it in items if it.temperature > 0][:1]
    wfeats, wrows, _, _ = asyncio.run(drive(Batcher(engine, cfg), bundle,
                                            [[it] for it in whole_items]))
    engine._spec_emitted = emitted
    counted = {"fused_attention": fused_attention.launches,
               "decode_attention": decode_attention.launches}
    gdrive = graph_drive(bundle, marks, counted)
    rounds, tokens = engine.spec_rounds, sum(len(r) for r in rows)
    if gdrive["misses"] or rounds < 1:
        raise AssertionError(f"{label}: {gdrive['misses']} misses after warmup, {rounds} rounds")
    enc_layers = bundle.cfg.num_layers if t5 else 0
    want = {"fused_attention": 0 if rehearsal else enc_layers * engine.dispatches,
            "decode_attention": 0}
    if counted != want:
        raise AssertionError(f"{label}: launches {counted}, want {want} over "
                             f"{engine.dispatches} generations")
    check = spec_tokens_check(bundle, ref_model, feats + wfeats,
                              rows + [r[: int(f.get("max_tokens", engine.max_decode_len))]
                                      for f, r in zip(wfeats, wrows)], engine.max_decode_len)
    hits = engine.prefix_cache.stats()["hits"] if engine.prefix_cache is not None else None
    if engine.prefix_cache is not None and not hits:
        raise AssertionError(f"{label}: no prefix-cache hit")
    graph_eager = ({"skipped": "cpu rehearsal"} if rehearsal
                   else tokens_graph_vs_eager(engine, [feats[0]]))
    # Speculation off: the same greedy streams through the plain per-stream
    # path (its start and gen_chunk graphs were warmed too).
    gitems = [it for it in items if it.temperature == 0.0]
    engine.spec_enabled = False
    try:
        _, plain_rows, _, _, plain_wall = asyncio.run(
            drive_streams(Batcher(engine, cfg), bundle, [[it] for it in gitems]))
    finally:
        engine.spec_enabled = True
    k2_plain = decode_attention.launches - counted["decode_attention"]
    spec_greedy = [r for f, r in zip(feats, rows) if float(f.get("temperature", 0.0)) == 0.0]
    spec_wall = wall * len(spec_greedy) / len(rows)  # the greedy streams' share
    out = dict(
        device=str(bundle.device), card=card_line, layers=bundle.cfg.num_layers,
        spec_k=engine.spec_k, chunk_tokens=engine.chunk_tokens, streams=len(rows),
        whole=len(wrows), verify_rounds=rounds, stream_tokens=tokens,
        stream_verify_rounds=stream_rounds,
        tokens_per_verify_step=float(np.mean(per_round)), prefix_hits=hits,
        misses_after_warmup=gdrive["misses"], launches=counted,
        plain_decode_attention_launches=k2_plain, warm_s=warm_s,
        ttft_p50_ms=float(np.percentile(np.array(ttfts) * 1e3, 50)),
        spec_tok_per_s=sum(len(r) for r in spec_greedy) / spec_wall,
        plain_tok_per_s=sum(len(r) for r in plain_rows) / plain_wall,
        graph_vs_eager=graph_eager, **check)
    if not rehearsal and not t5:
        out["verify_vs_step"] = verify_vs_step(engine, max(engine.seq_buckets))
    emit(label, **out)
    graphs_out = None
    if not rehearsal:
        graphs_out = phase_graphs(label[len("serve "):], bundle, **gdrive)
    release(bundle)
    return {"fused_attention": counted["fused_attention"],
            "decode_attention": k2_plain}, out, graphs_out


def spec_loop_graph_vs_eager(engine, loop) -> dict:
    """One chunk of verify rounds of the speculative slot state, every slot
    live, through its graph and, from the same state restored, eagerly:
    outputs and counts identical, argmax and sampled."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models.gpt import state_tensors

    with torch.inference_mode(), engine._lock:
        st = loop._state
        every_key_valid(st.base)
        st.base.done.fill_(False)
        out = {}
        for sample in (False, True):
            if sample:
                sp = st.base.sample
                sp.temperature.fill_(1.0)
                sp.top_k.fill_(40)
                sp.top_p.fill_(0.9)
                sp.rng.copy_(torch.arange(sp.rng.numel()).view_as(sp.rng))
            saved = [t.clone() for t in state_tensors(st)]
            _, got = loop._chunk_call(sample)
            got = [t.clone() for t in got]
            for t, s in zip(state_tensors(st), saved):
                t.copy_(s)
            graphs, engine.graphs = engine.graphs, None
            try:
                _, want = loop._chunk_call(sample)
            finally:
                engine.graphs = graphs
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"a spec loop chunk through its graph differs from eager "
                                     f"(sampled: {sample})")
            out["sampled" if sample else "argmax"] = True
    return {"slots": loop.n_slots, "rounds": loop.chunk, "identical": out}


def spec_loop_service(label: str, overrides: dict, params, ref_model, rehearsal: bool,
                      card_line: str) -> tuple:
    """GPT-2 under ``SPEC_CONTINUOUS`` in the contiguous loop (every stream
    routed there: ``SPEC_MAX_STREAMS=0``): the spec items twice over, at
    once, more streams than slots.  Gates: K2 launches = layers x the
    admission waves' first chunks (a wave's start decodes through K2, the
    verify rounds never), 0 misses after warmup, every token checked, the
    loop's spec chunk through its graph equal to eager.  Printed: tokens
    per verify round of a live row."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    cfg, bundle, engine, batcher = build_service(overrides, params=params)
    loop = batcher._cdl
    warm_s = batcher.warm_engine() + batcher.warm_streams()
    items = spec_items(rehearsal) * 2
    routed = {"rows": 0, "tokens": 0}
    route = loop._route_chunk

    def counting(toks_np, done_np, snapshot):
        out_np, ns_np = toks_np
        for slot, st in snapshot.items():
            if loop.active.get(slot) is st:
                routed["rows"] += loop.chunk
                routed["tokens"] += int(ns_np[slot].sum())
        route(toks_np, done_np, snapshot)

    loop._route_chunk = counting
    decode_attention.launches = 0
    loop.prefill_dispatches = loop.chunk_dispatches = loop.spec_rounds = 0
    marks = graph_marks(bundle)
    feats, rows, latencies, ttfts, wall = asyncio.run(drive_streams(batcher, bundle, [items]))
    k2 = decode_attention.launches
    gdrive = graph_drive(bundle, marks, {"decode_attention": k2})
    layers = bundle.cfg.num_layers
    want = 0 if rehearsal else layers * engine.chunk_tokens * loop.prefill_dispatches
    if k2 != want or loop.spec_rounds < 1 or gdrive["misses"]:
        raise AssertionError(f"{label}: K2 {k2} (want {want}), {loop.spec_rounds} rounds, "
                             f"{gdrive['misses']} misses")
    if loop.admitted:
        raise AssertionError(f"{label}: {loop.admitted} streams never released")
    check = spec_tokens_check(bundle, ref_model, feats, rows, engine.max_decode_len)
    out = dict(
        device=str(bundle.device), card=card_line, layers=layers, slots=loop.n_slots,
        spec_k=engine.spec_k, streams=len(rows), admission_waves=loop.prefill_dispatches,
        chunk_dispatches=loop.chunk_dispatches, verify_rounds=loop.spec_rounds,
        tokens_per_verify_round_per_row=routed["tokens"] / max(1, routed["rows"]),
        decode_attention_launches=k2, misses_after_warmup=gdrive["misses"], warm_s=warm_s,
        tok_per_s=sum(len(r) for r in rows) / wall,
        ttft_p50_ms=float(np.percentile(np.array(ttfts) * 1e3, 50)),
        graph_vs_eager=({"skipped": "cpu rehearsal"} if rehearsal
                        else spec_loop_graph_vs_eager(engine, loop)), **check)
    emit(label, **out)
    if not rehearsal:
        phase_graphs(label[len("serve "):], bundle, **gdrive)
    release(bundle)
    return k2, out


SPEC = {"SPEC_DECODE": "ngram", "MAX_DECODE_LEN": "64"}


def spec_llama(params, ref_model, rehearsal: bool, card_line: str,
               dims: dict | None = None) -> int:
    """8f, ``serve spec llama``: TinyLlama (22 layers, or ``dims``' config;
    the rehearsal's small llama on the CPU) per stream with the prefix
    cache; returns the K2 launches of its plain comparison run."""
    ov = {**SPEC, "MODEL_NAME": "llama", "DEVICE": "cpu" if rehearsal else "cuda",
          "BATCH_BUCKETS": "1", "SEQ_BUCKETS": "64,128", "CONTINUOUS_BATCHING": "0",
          "PREFIX_CACHE": "1"}
    if dims:
        ov["LLAMA_CONFIG"] = json.dumps(dims)
    if rehearsal:
        ov.update(LLAMA_CONFIG=json.dumps(REHEARSAL_LLAMA), MAX_DECODE_LEN="16")
    launches, _, _ = spec_stream_service("serve spec llama", ov, params, ref_model, rehearsal,
                                         card_line)
    return launches["decode_attention"]


def spec_gpt2(params, ref_model, rehearsal: bool, card_line: str) -> int:
    """8f, ``serve spec gpt2 loop``: GPT-2 small under ``SPEC_CONTINUOUS``;
    returns its K2 launches (the waves' first chunks)."""
    ov = {**SPEC, "MODEL_NAME": "gpt2", "DEVICE": "cpu" if rehearsal else "cuda",
          "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "64,128", "MAX_STREAMS": "4",
          "MAX_STREAM_QUEUE": "16", "SPEC_CONTINUOUS": "1", "SPEC_MAX_STREAMS": "0"}
    if rehearsal:
        ov.update(MAX_DECODE_LEN="16")
    return spec_loop_service("serve spec gpt2 loop", ov, params, ref_model, rehearsal,
                             card_line)[0]


def spec_t5(params, ref_model, rehearsal: bool, card_line: str) -> int:
    """8f, ``serve spec t5``: T5-small per stream; returns K1's launches
    (6 an encoder pass)."""
    ov = {**SPEC, "MODEL_NAME": "t5-small", "DEVICE": "cpu" if rehearsal else "cuda",
          "BATCH_BUCKETS": "1", "SEQ_BUCKETS": "64,128", "CONTINUOUS_BATCHING": "0"}
    if rehearsal:
        ov.update(SEQ_BUCKETS="32,64,128", MAX_DECODE_LEN="16")
    launches, _, _ = spec_stream_service("serve spec t5", ov, params, ref_model, rehearsal,
                                         card_line, t5=True)
    return launches["fused_attention"]


def spec_main(rehearsal: bool) -> int:
    """``--spec``: the build and ``serve spec`` (8f: its three services); with
    ``--cpu-rehearsal`` the phase on the CPU at small sizes, no build.
    Prints no result line."""
    import torch

    phase = "env"
    try:
        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="spec")
        if not rehearsal:
            phase = "build"
            phase_build()
        from mlmicroservicetemplate_tpu_torch.convert.jax_params import (
            gpt_params_from_jax,
            llama_params_from_jax,
            t5_params_from_jax,
        )
        from mlmicroservicetemplate_tpu_torch.models import gpt as gpt_mod
        from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod
        from mlmicroservicetemplate_tpu_torch.models import t5 as t5_mod

        dev = torch.device("cpu" if rehearsal else "cuda")
        t0 = time.monotonic()
        launches = {}
        for phase, mod, cfg, pytree, convert, serve in (
                ("serve spec llama", llama_mod,
                 llama_mod.LlamaConfig(**(REHEARSAL_LLAMA if rehearsal else {}), eos_id=1,
                                       pad_id=0), llama_pytree, llama_params_from_jax,
                 spec_llama),
                ("serve spec gpt2 loop", gpt_mod, gpt_mod.GPTConfig(eos_id=1, pad_id=0),
                 gpt2_pytree, gpt_params_from_jax, spec_gpt2),
                ("serve spec t5", t5_mod, t5_mod.T5Config(), t5_pytree, t5_params_from_jax,
                 spec_t5)):
            params = pytree(cfg, seed=0)
            ref = mod.build_model(cfg, convert(params, cfg), dev, torch.float32)
            launches[phase] = serve(params, ref, rehearsal, card_line)
            del params, ref
        emit("serve spec", launches=launches, seconds=time.monotonic() - t0)
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


# ---------------------------------------------------------------------------
# 8g. serve quantize (QUANTIZE=int8) and 8h. serve llama lora (ADAPTER_DIR)

# The int8 weights' dequantization in a profile: the convert of q8 to the
# compute type (a copy kernel) and the multiply by the scale.
CONVERT_KERNEL, MUL_KERNEL = r"direct_copy|copy_kernel", r"MulFunctor"
# 8h's adapters: (name, rank, alpha or None), N(0, 0.02) factors from seed 0.
LORA_SPECS = (("alpha", 8, None), ("beta", 16, 32.0), ("gamma", 8, 16.0))


def kernel_split(fn, reps: int, parts: dict) -> dict:
    """``profile_split`` over named parts: each device kernel of ``reps``
    calls of ``fn`` goes to the first part whose regex its name matches,
    else to ``other``; per call, each part's ms and kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_primer()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = list(parts) + ["other"]
    us, n = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or PRIMER_KERNEL.search(e.name):
            continue
        part = next((k for k, rx in parts.items() if re.search(rx, e.name)), "other")
        t = e.time_range.elapsed_us()
        us[part] += t
        n[part] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_busy_ms=sum(us.values()) / reps / 1e3 if by_name else None,
                **{f"{k}_ms": us[k] / reps / 1e3 for k in names},
                kernels={k: n[k] / reps for k in names},
                top_kernels=[[name[:80], t / reps / 1e3] for name, t in top],
                note=None if by_name else "torch.profiler recorded no device kernels")


def resident_bytes(build):
    """(device bytes ``build()`` leaves allocated, its result): the
    difference of ``torch.cuda.memory_allocated`` across it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - m0, out


def model_bytes(model) -> int:
    """Bytes of a model's parameters and buffers (int8 payloads, f32 scales
    and the float weights left)."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def quant_step(bundles: dict, b: int = 8, prompt: int = 512) -> dict:
    """One decode step at ``b`` rows over a (prompt + 64)-key cache as a
    captured graph, per bundle: CUDA-event wall of a replay and its kernels
    split into K2, GEMMs, the int8 converts, the multiplies (the scales'
    and the model's own) and the rest."""
    import torch

    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import capture_graph

    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(5, 261, (b, prompt), device="cuda", generator=gen, dtype=torch.int32)
    mask = torch.ones_like(ids)
    parts = {"K2": K2_KERNEL, "gemm": GEMM_KERNEL.pattern, "convert": CONVERT_KERNEL,
             "mul": MUL_KERNEL}
    out = {}
    for name, bundle in bundles.items():
        with torch.inference_mode():
            state = bundle.init_state(ids, mask, 64)

            def step():
                state.steps = 0
                return bundle.generate_chunk(state, 1)[1]

            entry = capture_graph("gen_chunk", step, state, "cuda")
            out[name] = {"graph_wall_ms": cuda_ms(entry.replay, 20),
                         **kernel_split(entry.replay, 5, parts)}
    i8, bf = out["int8"], out["bf16"]
    out["int8_over_bf16_wall"] = i8["graph_wall_ms"] / bf["graph_wall_ms"]
    out["dequant_ms"] = i8["convert_ms"] + i8["mul_ms"] - bf["convert_ms"] - bf["mul_ms"]
    return out


def quant_llama_models(cfg, params, device: str, dtype):
    """QUANTIZE=int8's TinyLlama as the service builds it (the weights cast
    to ``dtype``, then quantized on the device) and its f32 reference: the
    very q8 and scales, the rest of the weights in f32."""
    import torch

    from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
    from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

    dev = torch.device(device)
    q = llama_mod.build_model(cfg, llama_params_from_jax(params, cfg), dev, dtype, quantize=True)
    return q, llama_mod.build_model(cfg, q.state_dict(), dev, torch.float32)


def same_int8(model, want) -> int:
    """How many int8 buffers ``model`` holds; raises unless each equals
    ``want``'s (the served weights are the reference's)."""
    import torch

    got, ref = model.state_dict(), want.state_dict()
    keys = [k for k in got if k.endswith((".q8", ".scale")) and k.rpartition(".")[0] + ".q8" in got]
    if not keys or any(not torch.equal(got[k], ref[k].to(got[k].device)) for k in keys):
        raise AssertionError("the served int8 weights differ from the reference's")
    return sum(k.endswith(".q8") for k in keys)


def quant_classifier(name: str, rehearsal: bool, card_line: str) -> int:
    """8g's BERT-base or ResNet-50 under QUANTIZE=int8 through
    ``Batcher.submit`` (every bucket captured first): each answer held
    against the port's f32 run on the CPU of the same int8 weights (the
    card's state loaded into a CPU service), within PROB_TOL / RESNET_LOGIT_TOL
    as the bf16 services; K1 12 launches a BERT dispatch.  Returns K1's
    launches."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.resnet import ResNetConfig
    from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    bert = name == "bert-base"
    ov = {"MODEL_NAME": name, "DEVICE": "cpu" if rehearsal else "cuda", "QUANTIZE": "int8"}
    if rehearsal:
        ov.update(BATCH_BUCKETS="1,4,8,16", SEQ_BUCKETS="32,64,128") if bert else ov.update(
            BATCH_BUCKETS="1,8")
    elif not bert:
        ov["BATCH_BUCKETS"] = "1,8,16"
    else:  # 9 graphs, not 30, for the run's time; the waves still pad up
        ov.update(BATCH_BUCKETS="1,4,16", SEQ_BUCKETS="64,256,512")
    params = None if bert else resnet_pytree(ResNetConfig(), seed=0)
    t0 = time.monotonic()
    nbytes, (cfg, bundle, engine, batcher) = (
        (None, build_service(ov, params=params)) if rehearsal
        else resident_bytes(lambda: build_service(ov, params=params)))
    warm_s = engine.warmup() if bert else batcher.warm_engine()
    waves = make_waves(rehearsal) if bert else image_waves(rehearsal)
    fused_attention.launches = 0
    engine.dispatches = 0
    misses = graph_marks(bundle)[1]
    feats, rows, latencies, wall = asyncio.run(drive(batcher, bundle, waves,
                                                     prep=None if bert else dict))
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    misses = CACHE.stats()["miss"] - misses
    launches = fused_attention.launches
    if bert and not rehearsal and launches != LAYERS * engine.dispatches:
        raise AssertionError(f"{name} int8: fused_attention launched {launches} times over "
                             f"{engine.dispatches} dispatches")
    if misses and not rehearsal:
        raise AssertionError(f"{name} int8: {misses} graph misses after warmup")
    _, cpu_bundle, cpu_engine, cpu_batcher = build_service(
        {**ov, "DEVICE": "cpu", "WARMUP": "0"}, params=params)
    asyncio.run(cpu_batcher.stop())
    cpu_bundle.model.load_state_dict(bundle.model.state_dict())
    n_q8 = same_int8(cpu_bundle.model, bundle.model)
    ref = cpu_engine.run_batch(feats)
    if bert:
        worst, checked = check_probs(bundle, rows, ref, "the CPU f32 run of the int8 weights")
        errs = dict(max_prob_err_vs_cpu_f32=worst, prob_tol=PROB_TOL, labels_checked=checked)
    else:
        worst, checked = check_logits(rows, ref, "the CPU f32 run of the int8 weights")
        errs = dict(max_logit_err_over_max_logit=worst, logit_tol=RESNET_LOGIT_TOL,
                    top1_checked=checked)
    http = {"skipped": "cpu rehearsal"} if rehearsal else {}
    if not rehearsal and bert:
        (http["predict"],) = asyncio.run(http_check(
            cfg, bundle, engine, [("/predict", {"text": "hello card"}, json_key("prediction"))]))
    elif not rehearsal:
        try:
            import PIL  # noqa: F401  (decodes the image body)
        except ImportError:
            http = {"skipped": "PIL is not installed; it is needed only to decode image bodies"}
        else:
            (http["predict"],) = asyncio.run(http_check(
                cfg, bundle, engine, [("/predict", png_bytes(9), json_key("prediction"))]))
    lat = np.array(latencies) * 1e3
    emit(f"serve quantize {name}", device=str(bundle.device), card=card_line, http=http,
         int8_tensors=n_q8, resident_bytes=nbytes, model_bytes=model_bytes(bundle.model),
         requests=len(rows), dispatches=engine.dispatches, fused_attention_launches=launches,
         misses=misses, warmup_s=warm_s, p50_ms=float(np.percentile(lat, 50)),
         p99_ms=float(np.percentile(lat, 99)), per_s=len(rows) / wall, **errs,
         seconds=time.monotonic() - t0)
    release(bundle)
    return launches


def phase_serve_quant(params, cfg, rehearsal: bool, card_line: str) -> dict:
    """8g, ``serve quantize``: TinyLlama (``cfg``, seed-0 ``params``) under
    QUANTIZE=int8 whole (K2) and through the paged loop (K3), greedy and
    seeded sampled, every token teacher-forced against the f32 run of the
    same int8 weights; the resident weight bytes and one decode step (B =
    8, T = 576, as a graph) against bf16; then BERT-base (K1) and
    ResNet-50.  Returns each kernel's launches."""
    import torch

    from mlmicroservicetemplate_tpu_torch.serve import build_service

    t0 = time.monotonic()
    device = "cpu" if rehearsal else "cuda"
    dtype = torch.float32 if rehearsal else torch.bfloat16
    base = {"MODEL_NAME": "llama", "DEVICE": device, "BATCH_BUCKETS": "1,16",
            "SEQ_BUCKETS": "64,128" if rehearsal else "128,256",
            "LLAMA_CONFIG": json.dumps({f.name: getattr(cfg, f.name)
                                        for f in dataclasses.fields(cfg)
                                        if f.name not in ("eos_id", "pad_id", "kv_quant")})}
    quant = {**base, "QUANTIZE": "int8"}
    qmodel, qref = quant_llama_models(cfg, params, device, dtype)
    whole = phase_serve_gen("serve quantize llama", quant, params, qref, rehearsal, card_line)
    n_q8 = same_int8(whole[1].model, qmodel)
    stream = phase_serve_stream(
        "serve quantize llama stream", {**quant, "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE),
                                        "MAX_STREAMS": "16", "MAX_DECODE_LEN": "64"},
        params, qref, rehearsal, card_line, eager_chunk=False)
    same_int8(stream[1].model, qmodel)
    del qmodel, qref
    out = {"decode_attention": whole[3] + stream[3], "paged_decode_attention": stream[4]}
    if rehearsal:
        emit("serve quantize llama step", skipped="cpu rehearsal: no card to profile")
    else:
        bf16_bytes, bf16 = resident_bytes(lambda: build_service(
            {**base, "WARMUP": "0"}, params=params))
        i8_bytes, i8 = resident_bytes(lambda: build_service(
            {**quant, "WARMUP": "0"}, params=params))
        step = quant_step({"bf16": bf16[1], "int8": i8[1]})
        emit("serve quantize llama step", card=card_line, layers=cfg.num_layers,
             resident_bytes={"bf16": bf16_bytes, "int8": i8_bytes,
                             "int8_over_bf16": i8_bytes / bf16_bytes},
             model_bytes={"bf16": model_bytes(bf16[1].model), "int8": model_bytes(i8[1].model)},
             int8_tensors=n_q8, batch=8, cache_len=576, **step)
        release(bf16[1])
        release(i8[1])
        del bf16, i8
    release(whole[1])
    release(stream[1])
    del whole, stream
    out["fused_attention"] = quant_classifier("bert-base", rehearsal, card_line)
    quant_classifier("resnet50", rehearsal, card_line)
    emit("serve quantize", launches=out, seconds=time.monotonic() - t0)
    return out


def write_lora_dir(path: str, cfg, seed: int = 0) -> str:
    """``LORA_SPECS``' adapters of llama ``cfg``'s q/k/v/o as ``.npz`` files
    under ``path``, N(0, 0.02) factors from ``seed``."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    d, kv = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
    projs = {"q": (d, d), "k": (d, kv), "v": (d, kv), "o": (d, d)}
    for name, r, alpha in LORA_SPECS:
        arrs = {} if alpha is None else {"alpha": np.float32(alpha)}
        for li in range(cfg.num_layers):
            for proj, (d_in, d_out) in projs.items():
                for leaf, shape in (("lora_a", (d_in, r)), ("lora_b", (r, d_out))):
                    a = rng.standard_normal(shape, dtype=np.float32)
                    a *= 0.02
                    arrs[f"layers.{li}.{proj}.{leaf}"] = a
        np.savez(os.path.join(path, f"{name}.npz"), **arrs)
    return path


def lora_waves():
    """8h's traffic, (item, adapter id or None) a stream: two mixed waves of
    12 (alpha, beta and none in turn, every fourth sampled and seeded), then
    a wave of 4 on gamma (an install that evicts) and 2 on none."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(5)
    words = ["adapter", "tenant", "slot", "delta", "rank", "batch", "row", "wave"]
    aids, waves, i = ("alpha", "beta", None), [], 0
    for size, pick in ((12, None), (12, None), (6, ("gamma",) * 4 + (None, None))):
        wave = []
        for j in range(size):
            length = int(rng.integers(20, 60))
            text = " ".join(rng.choice(words, size=length))[:length]
            sampling = (dict(temperature=0.8, top_k=40, seed=2000 + i) if i % 4 == 3 else {})
            wave.append((RawItem(text=text, **sampling), aids[j % 3] if pick is None
                         else pick[j]))
            i += 1
        waves.append(wave)
    return waves


async def drive_lora(batcher, bundle, waves, shed: bool):
    """Each wave's streams opened at once (their adapter ids set), read to
    the end; then, with ``shed``, alpha and beta streams hold both slots and
    a gamma one must shed with ``adapter_pool``.  Returns (feats, rows,
    adapter ids, the shed's reason and Retry-After, wall seconds)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.scheduler.policy import QueueFullError

    await batcher.start()
    feats, rows, aids = [], [], []

    def prep(item, aid):
        f = bundle.preprocess(item)
        if aid is not None:
            f["adapter_id"] = aid
        return f

    async def read(f, gen, aid):
        return f, np.array([int(x) async for chunk in gen for x in chunk], np.int32), aid

    async def one(item, aid):
        f = prep(item, aid)
        return await read(f, batcher.submit_stream(f), aid)

    async def settle():
        t_wait = time.monotonic() + 10.0
        while batcher._cdl.admitted and time.monotonic() < t_wait:
            await asyncio.sleep(0.001)

    shed_out = None
    try:
        t0 = time.monotonic()
        for wave in waves:
            for f, row, aid in await asyncio.gather(*(one(*x) for x in wave)):
                feats.append(f)
                rows.append(row)
                aids.append(aid)
            await settle()
        if shed:
            held = [(prep(x, a), a) for x, a in ((waves[0][0][0], "alpha"),
                                                  (waves[0][1][0], "beta"))]
            gens = [(f, batcher.submit_stream(f), a) for f, a in held]
            try:
                batcher.submit_stream(prep(waves[2][0][0], "gamma"))
            except QueueFullError as e:
                shed_out = {"reason": e.reason, "retry_after_s": e.retry_after_s}
            for f, row, aid in await asyncio.gather(*(read(*g) for g in gens)):
                feats.append(f)
                rows.append(row)
                aids.append(aid)
            await settle()
            if not shed_out or shed_out["reason"] != "adapter_pool":
                raise AssertionError(f"a third adapter with both slots held: {shed_out}")
        wall = time.monotonic() - t0
    finally:
        await batcher.stop()
    return feats, rows, aids, shed_out, wall


def lora_teacher_forced(bundle, ref_model, adir: str, feats, rows, aids, max_len: int) -> dict:
    """``teacher_forced`` per adapter: the served model and the f32
    reference each seen through the overlay of that row's adapter (a pool
    of their own holding all three, f32 factors as the service's)."""
    import torch

    from mlmicroservicetemplate_tpu_torch.models import lora
    from mlmicroservicetemplate_tpu_torch.tenancy.adapters import AdapterPool, load_adapter_dir

    pool = AdapterPool(load_adapter_dir(adir), slots=len(LORA_SPECS), device=bundle.device)
    out = {}
    for aid in sorted({a for a in aids if a is not None}) + [None]:
        idx = [i for i, a in enumerate(aids) if a == aid]
        ov = None
        if aid is not None:
            ov = pool.overlay(torch.tensor([pool.acquire(aid)], device=bundle.device))
        served = dataclasses.replace(bundle, model=lora.attach(bundle.model, ov))
        out[aid or "none"] = teacher_forced(served, lora.attach(ref_model, ov),
                                            [feats[i] for i in idx], [rows[i] for i in idx],
                                            max_len)
    return out


def lora_overrides(cfg, rehearsal: bool) -> dict:
    """The llama service of 8h and 8l (``cfg``'s TinyLlama): the paged loop,
    16 slots, one batch bucket of 16 and one seq bucket of 64, 64 tokens
    (16 in the rehearsal)."""
    return {"MODEL_NAME": "llama", "DEVICE": "cpu" if rehearsal else "cuda",
            "BATCH_BUCKETS": "16", "SEQ_BUCKETS": "64", "MAX_STREAMS": "16",
            "MAX_DECODE_LEN": "16" if rehearsal else "64", "PAGED_KV": "1",
            "KV_BLOCK_SIZE": str(PAGE),
            "LLAMA_CONFIG": json.dumps({f.name: getattr(cfg, f.name)
                                        for f in dataclasses.fields(cfg)
                                        if f.name not in ("eos_id", "pad_id", "kv_quant")})}


def phase_serve_lora(params, ref_model, cfg, rehearsal: bool, card_line: str,
                     keep: bool = False):
    """8h, ``serve llama lora``: TinyLlama (``cfg``) through the paged loop
    with ``ADAPTER_DIR`` (three adapters, ``ADAPTER_SLOTS=2``) and the same
    traffic on a service without it; returns K2's and K3's launches and,
    with ``keep``, the warmed adapter service for 8l (``lora_service``'s
    dict: its graphs and its adapter directory stay until 8l releases
    them)."""
    import tempfile

    import numpy as np

    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.runtime import compile_cache
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    t0 = time.monotonic()
    waves = lora_waves()
    ov = lora_overrides(cfg, rehearsal)
    tmp = tempfile.TemporaryDirectory()
    with (contextlib.nullcontext(tmp.name) if keep else tmp) as adir:
        write_lora_dir(adir, cfg)
        cfg_, bundle, engine, batcher = build_service(
            {**ov, "ADAPTER_DIR": adir, "ADAPTER_SLOTS": "2"}, params=params)
        loop, pool = batcher._cdl, batcher.adapters
        warm_s = batcher.warm_engine() + batcher.warm_streams()
        captures = compile_cache.capture_stats()["count"]
        decode_attention.launches = paged_decode_attention.launches = 0
        loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
        marks = graph_marks(bundle)
        feats, rows, aids, shed, wall = asyncio.run(drive_lora(batcher, bundle, waves, True))
        k2, k3 = decode_attention.launches, paged_decode_attention.launches
        gdrive = graph_drive(bundle, marks, {})
        held_launches("serve llama lora", bundle, engine, loop, k2, k3, rehearsal)
        st = pool.status()
        if st["installs"] < 1 or st["demotions"] < 1 or st["live_refs"] != 0:
            raise AssertionError(f"serve llama lora: pool {st}")
        if compile_cache.capture_stats()["count"] != captures or gdrive["misses"]:
            raise AssertionError(f"serve llama lora: graphs captured after warmup {gdrive}")
        if engine.kv_pool.used_blocks or loop.admitted:
            raise AssertionError("serve llama lora: blocks or streams left")
        check = lora_teacher_forced(bundle, ref_model, adir, feats, rows, aids,
                                    engine.max_decode_len)
        timing = {}
        if not rehearsal:
            import torch

            free = [a for a in pool.ids() if a not in {r["adapter"] for r in
                                                        st["resident"].values()}]
            ti = time.perf_counter()
            slot = pool.acquire(free[0])
            torch.cuda.synchronize()
            timing["install_ms"] = (time.perf_counter() - ti) * 1e3
            pool.release(slot)
            if compile_cache.capture_stats()["count"] != captures:
                raise AssertionError("serve llama lora: an install captured a graph")
            timing["chunk"] = time_chunk(engine, loop, eager=False)
        # The same traffic, adapter ids dropped, on a service without
        # ADAPTER_DIR: every row that had none gets its very tokens.
        _, pbundle, pengine, pbatcher = build_service(ov, params=params)
        pbatcher.warm_engine()
        pbatcher.warm_streams()
        plain = [[(item, None) for item, _ in wave] for wave in waves]
        _, prows, _, _, _ = asyncio.run(drive_lora(pbatcher, pbundle, plain, False))
        base = [i for i, a in enumerate(aids[:len(prows)]) if a is None]
        differ = [i for i in base if not np.array_equal(rows[i], prows[i])]
        adapted = [i for i, a in enumerate(aids[:len(prows)]) if a is not None]
        changed = sum(not np.array_equal(rows[i], prows[i]) for i in adapted)
        if differ or not changed:
            raise AssertionError(f"serve llama lora: base rows {differ} differ from the plain "
                                 f"service's, {changed} adapted rows changed")
        if not rehearsal:
            base_chunk = time_chunk(pengine, pbatcher._cdl, eager=False)
            lb, bb = timing["chunk"]["graph"]["device_busy_ms"], base_chunk["graph"][
                "device_busy_ms"]
            timing["base_chunk"] = base_chunk
            timing["delta_ms_per_step"] = ((lb - bb) / engine.chunk_tokens
                                           if lb and bb else None)
        emit("serve llama lora", device=str(bundle.device), card=card_line,
             layers=bundle.cfg.num_layers, adapters=[list(s) for s in LORA_SPECS],
             slots=pool.n_slots, rank=pool.rank, streams=len(rows),
             adapted_streams=len(adapted) + 2, base_rows_equal=len(base),
             adapted_rows_changed=changed, shed=shed, pool=st, warm_s=warm_s,
             graph_captures_across_installs=0, misses=gdrive["misses"],
             admission_waves=loop.prefill_dispatches, slot_decode_steps=loop.decode_steps,
             decode_attention_launches=k2, paged_decode_attention_launches=k3,
             generated_tok_per_s=sum(len(r) for r in rows) / wall, teacher_forced=check,
             **timing, seconds=time.monotonic() - t0)
        if not keep:
            release(bundle)
        release(pbundle)
    launches = {"decode_attention": k2, "paged_decode_attention": k3}
    if keep:
        return launches, {"cfg": cfg_, "bundle": bundle, "engine": engine, "pool": pool,
                          "adir": tmp}
    return launches


# 8l, ``serve llama tenants``: tenant accounts and weighted fair share over
# 8h's adapter service.  Carol's token window, in seconds.
TENANT_WINDOW_S = 60.0
TENANT_WORDS = ["tenant", "quota", "share", "window", "lease", "weight", "slot", "queue"]
CAROL_BODY = {"text": "carol asks about the quota window", "stream": True, "max_tokens": 32}


def tenant_table(carol_cost: int) -> list:
    """8l's ``TENANTS_FILE``: acme at weight 3 on adapter alpha, bob at 1,
    carol at 1 with two concurrent streams and a token window of two and a
    half of her requests (``carol_cost`` tokens each); keyless callers are
    the anonymous tenant."""
    return [{"name": "acme", "weight": 3, "api_keys": ["key-acme"], "adapter": "alpha"},
            {"name": "bob", "weight": 1, "api_keys": ["key-bob"]},
            {"name": "carol", "weight": 1, "api_keys": ["key-carol"], "max_concurrency": 2,
             "tokens_per_window": 2 * carol_cost + carol_cost // 2}]


def tenant_backlog() -> list:
    """8l's backlog, (API key, item) a stream: 48 streams, acme's and bob's
    in turn, every fourth sampled and seeded (two of each eight: one of
    each tenant's)."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(11)
    out = []
    for i in range(48):
        length = int(rng.integers(20, 60))
        text = " ".join(rng.choice(TENANT_WORDS, size=length))[:length]
        sampling = dict(temperature=0.8, top_k=40, seed=3000 + i) if i % 8 in (3, 6) else {}
        out.append(("key-acme" if i % 2 == 0 else "key-bob", RawItem(text=text, **sampling)))
    return out


def tenant_feats(bundle, registry, key, item) -> dict:
    """A stream's feats as the app's edge makes them: the key's tenant and
    its default adapter (none without a registry), batch class."""
    f = dict(bundle.preprocess(item), priority="batch")
    if registry is not None:
        spec = registry.classify(key)
        if spec.name:
            f["tenant"] = spec.name
        if spec.adapter:
            f["adapter_id"] = spec.adapter
    elif key == "key-acme":
        f["adapter_id"] = "alpha"
    return f


def log_pops(queue) -> list:
    """Each pick of ``queue``'s fair share: (tenants with waiters, tenants
    eligible, the one picked)."""
    fs = queue._fairshare
    pick = fs.pick
    log = []

    def logged(eligible):
        eligible = sorted(eligible)
        waiting = sorted({getattr(it, "tenant", "") or "" for heap in queue._heaps.values()
                          for _, it in heap if not it._removed})
        t = pick(eligible)
        log.append((waiting, eligible, t))
        return t

    fs.pick = logged
    return log


def share_check(log) -> dict:
    """acme's share of the pops while both acme and bob had waiters: after
    each such pop, acme's count within one of three quarters of them."""
    both = [t for waiting, _, t in log if {"acme", "bob"} <= set(waiting)
            and t in ("acme", "bob")]
    worst = max((abs(both[:n].count("acme") - 0.75 * n) for n in range(1, len(both) + 1)),
                default=0.0)
    out = {"pops_both_waiting": len(both), "acme": both.count("acme"),
           "bob": both.count("bob"), "worst_lag_pops": worst,
           "skipped_unfit": sum(1 for w, e, _ in log if set(w) != set(e))}
    if not both or worst > 1.0:
        raise AssertionError(f"serve llama tenants: acme's share is not 3 of 4 pops: {out}")
    return out


def percentiles(xs) -> dict:
    import numpy as np

    if not xs:
        return {"n": 0}
    return {"n": len(xs), "p50_ms": float(np.percentile(xs, 50)) * 1e3,
            "p99_ms": float(np.percentile(xs, 99)) * 1e3}


async def backlog_drive(batcher, feats, stop: bool = False):
    """Every stream queued before the loop's thread starts (the first
    admission pops a full set of slots, the rest wait), read to the end;
    with ``stop`` the batcher stops after.  Returns (rows, TTFT seconds,
    wall seconds)."""
    import numpy as np

    loop = batcher._cdl
    await batcher.start()
    loop._ensure_thread = lambda: None
    t0 = time.monotonic()
    try:
        gens = [batcher.submit_stream(f) for f in feats]
    finally:
        del loop._ensure_thread
    loop._ensure_thread()

    async def read(gen):
        toks, first = [], None
        async for chunk in gen:
            if first is None:
                first = time.monotonic() - t0
            toks.extend(int(x) for x in chunk)
        return np.array(toks, np.int32), first

    out = await asyncio.gather(*(read(g) for g in gens))
    wall = time.monotonic() - t0
    t_wait = time.monotonic() + 30.0
    while loop.admitted and time.monotonic() < t_wait:
        await asyncio.sleep(0.001)
    if stop:
        await batcher.stop()
    return [r for r, _ in out], [t for _, t in out], wall


def metric_samples(text: str, prefixes) -> dict:
    """The samples of ``/metrics`` whose name starts with one of
    ``prefixes`` ({line key: value}; counters' ``_created`` left out)."""
    out = {}
    for line in text.splitlines():
        if line.startswith(tuple(prefixes)) and "_created{" not in line:
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


async def tenant_http(batcher, cfg, bundle, engine, on_ready) -> dict:
    """Carol's and the anonymous callers' requests (and bob's beside them)
    over loopback through the app, the loop held at its chunk dispatch
    while carol's two streams hold her slots; ``on_ready()`` runs once the
    app's readiness canary has.  Returns what each answered, the 429s'
    Retry-After, TTFT by tenant, /status.tenancy and the metric samples
    around the drive.  The app's cleanup stops the batcher."""
    import threading

    import aiohttp
    from aiohttp import web

    from mlmicroservicetemplate_tpu_torch.api.app import build_app

    loop = batcher._cdl
    opened = threading.Event()
    opened.set()
    dispatch = loop._dispatch_chunk

    def gated():
        if not opened.wait(120):
            raise AssertionError("serve llama tenants: the loop's gate never opened")
        return dispatch()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    app = build_app(dataclasses.replace(cfg, warmup=False), bundle, engine, batcher)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    out = {"answers": {}, "ttft_s": {}}
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
                raise AssertionError("serve llama tenants: /readyz never turned 200")
            reg = batcher.tenants

            async def metrics_now():
                async with session.get(f"{url}/metrics") as r:
                    return metric_samples(await r.text(), ("predict_requests_total",
                                                           "tenant_"))

            async def post(who, body, key):
                headers = {"X-Api-Key": key} if key else {}
                t0 = time.monotonic()
                async with session.post(f"{url}/predict", json=body, headers=headers) as r:
                    first = None
                    lines = []
                    async for line in r.content:
                        if first is None:
                            first = time.monotonic() - t0
                        lines.append(line)
                    if r.status == 200:
                        out["ttft_s"].setdefault(who, []).append(first)
                    out["answers"].setdefault(who, []).append(r.status)
                    return r.status, r.headers.get("Retry-After"), b"".join(lines)

            async def until(what, cond, timeout=60.0):
                t_end = time.monotonic() + timeout
                while not cond():
                    if time.monotonic() > t_end:
                        raise AssertionError(f"serve llama tenants: {what} never happened")
                    await asyncio.sleep(0.002)

            def active(name):
                return reg.usage().get(name, {}).get("active", 0)

            on_ready()
            before = await metrics_now()
            loop._dispatch_chunk = gated
            opened.clear()
            carol = "key-carol"
            held = [asyncio.ensure_future(post("carol", CAROL_BODY, carol)) for _ in range(2)]
            await until("carol's two admissions", lambda: active("carol") == 2)
            oldest = reg._window["carol"][0][0]  # her first charge, on the registry's clock
            third = await post("carol", CAROL_BODY, carol)
            bob1 = asyncio.ensure_future(post("bob", {"text": "bob right after carol",
                                                      "stream": True}, "key-bob"))
            await until("bob's admission after carol's 429", lambda: active("bob") == 1)
            anon = [asyncio.ensure_future(post("anon", {"text": "keyless stream",
                                                        "stream": True}, None)),
                    asyncio.ensure_future(post("anon", {"text": "keyless whole",
                                                        "max_tokens": 16}, None))]
            mid = reg.usage()
            opened.set()
            await asyncio.gather(*held, bob1, *anon)
            await until("carol's streams' release", lambda: active("carol") == 0)
            window = await post("carol", CAROL_BODY, carol)
            age = reg._clock() - oldest
            bob2 = await post("bob", {"text": "bob after the window", "stream": True}, "key-bob")
            await until("every lease's release", lambda: reg.totals()["active"] == 0)
            async with session.get(f"{url}/status") as r:
                status = await r.json()
            after = await metrics_now()
            out.update(third=third[:2], window=window[:2], window_age_s=age,
                       bob_after=(bob1.result()[0], bob2[0]), mid=mid,
                       tenancy=status["tenancy"], metrics_before=before,
                       metrics_after=after)
    finally:
        opened.set()
        loop._dispatch_chunk = dispatch
        await runner.cleanup()
    return out


def tenant_service(params, cfg, rehearsal: bool) -> dict:
    """8h's adapter service, built and warmed (``--tenants`` alone: the
    main run hands 8l the one 8h drove)."""
    import tempfile

    from mlmicroservicetemplate_tpu_torch.serve import build_service

    tmp = tempfile.TemporaryDirectory()
    write_lora_dir(tmp.name, cfg)
    cfg_, bundle, engine, batcher = build_service(
        {**lora_overrides(cfg, rehearsal), "ADAPTER_DIR": tmp.name, "ADAPTER_SLOTS": "2"},
        params=params)
    batcher.warm_engine()
    return {"cfg": cfg_, "bundle": bundle, "engine": engine, "pool": batcher.adapters,
            "adir": tmp}


def tenant_batcher(svc: dict, **changes):
    """A batcher of its own on ``svc``'s engine (its loop warmed), with the
    service's adapter pool: the pool the engine's start graphs read."""
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher

    cfg = dataclasses.replace(svc["cfg"], adapter_dir=None, max_stream_queue=64, **changes)
    batcher = Batcher(svc["engine"], cfg)
    batcher.adapters = batcher._cdl.adapters = svc["pool"]
    batcher.warm_streams()
    return cfg, batcher


def phase_serve_tenants(params, ref_model, cfg, rehearsal: bool, card_line: str,
                        svc: dict | None = None) -> dict:
    """8l, ``serve llama tenants``: ``TENANTS_FILE`` over 8h's adapter
    service (``svc``, else one built here); returns K2's and K3's
    launches."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.runtime import compile_cache

    t0 = time.monotonic()
    if svc is None:
        svc = tenant_service(params, cfg, rehearsal)
    bundle, engine, pool, adir = svc["bundle"], svc["engine"], svc["pool"], svc["adir"].name
    carol = bundle.preprocess(RawItem(text=CAROL_BODY["text"]))
    carol_cost = int(carol["length"]) + engine.budget_for({"max_tokens": CAROL_BODY[
        "max_tokens"]})
    table = os.path.join(adir, "tenants.json")
    with open(table, "w") as f:
        json.dump(tenant_table(carol_cost), f)
    tcfg, batcher = tenant_batcher(svc, tenants_file=table, tenant_window_s=TENANT_WINDOW_S)
    loop, reg = batcher._cdl, batcher.tenants
    loop_pops, batch_pops = log_pops(loop.queue), log_pops(batcher._queue)
    captures = compile_cache.capture_stats()["count"]
    items = tenant_backlog()
    feats = [tenant_feats(bundle, reg, key, item) for key, item in items]

    def zero():
        decode_attention.launches = paged_decode_attention.launches = 0
        loop.prefill_dispatches = loop.chunk_dispatches = loop.decode_steps = 0
        engine.decode_steps = 0

    # The backlog (48 streams behind a full set of slots), then carol's and
    # the anonymous callers' requests over HTTP, the streams' tokens taken
    # off the loop as they are routed; one event loop for both.
    zero()
    marks = graph_marks(bundle)
    captured = []
    submit = loop.submit_stream

    def capture(f):
        gen = submit(f)
        rec = (f, [])
        captured.append(rec)

        async def tee():
            async for chunk in gen:
                rec[1].extend(int(x) for x in np.asarray(chunk).tolist())
                yield chunk

        return tee()


    async def drive():
        backlog = await backlog_drive(batcher, feats)
        share = share_check(loop_pops)
        held_launches("serve llama tenants", bundle, engine, loop, decode_attention.launches,
                      paged_decode_attention.launches, rehearsal)
        launched[:] = [decode_attention.launches, paged_decode_attention.launches]
        loop.submit_stream = capture
        try:
            return backlog, share, await tenant_http(batcher, tcfg, bundle, engine, zero)
        finally:
            del loop.submit_stream

    launched = []
    (rows, ttft, wall), share, http = asyncio.run(drive())
    k2, k3 = launched
    backlog_ttft = {t: percentiles([x for f, x in zip(feats, ttft) if f["tenant"] == t])
                    for t in ("acme", "bob")}
    tok_s = sum(len(r) for r in rows) / wall
    held_launches("serve llama tenants http", bundle, engine, loop, decode_attention.launches,
                  paged_decode_attention.launches, rehearsal)
    k2 += decode_attention.launches
    k3 += paged_decode_attention.launches
    gdrive = graph_drive(bundle, marks, {})
    if compile_cache.capture_stats()["count"] != captures or gdrive["misses"]:
        raise AssertionError(f"serve llama tenants: graphs captured after warmup {gdrive}")
    # The gates of the HTTP drive.
    ans = http["answers"]
    if http["third"][0] != 429 or int(http["third"][1]) < 1:
        raise AssertionError(f"serve llama tenants: carol's third stream got {http['third']}")
    # The window less her oldest charge's age when the answer came; the
    # header rounds the server's value (taken a moment before) up to whole
    # seconds.
    want_ra = max(1.0, TENANT_WINDOW_S - http["window_age_s"])
    if http["window"][0] != 429 or not -0.05 <= int(http["window"][1]) - want_ra <= 1.05:
        raise AssertionError(f"serve llama tenants: carol over her window got {http['window']}"
                             f", want 429 with Retry-After {want_ra:.2f} (within 1 s)")
    if ans["carol"].count(200) != 2 or any(a != 200 for t in ("bob", "anon") for a in ans[t]):
        raise AssertionError(f"serve llama tenants: answers {ans}")
    if http["bob_after"] != (200, 200):
        raise AssertionError(f"serve llama tenants: bob after carol's 429s {http['bob_after']}")
    if http["mid"]["carol"]["active"] != 2 or http["mid"]["bob"]["active"] != 1:
        raise AssertionError(f"serve llama tenants: the ledger while held {http['mid']}")
    name = bundle.name
    before, after = http["metrics_before"], http["metrics_after"]

    def grew(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    c429 = grew(f'predict_requests_total{{model="{name}",status="429"}}')
    quota = grew(f'tenant_requests_shed_total{{model="{name}",reason="quota",tenant="carol"}}')
    if c429 != 2 or quota != 2:
        raise AssertionError(f"serve llama tenants: 429s counted {c429}, quota sheds {quota}")
    kv_gauges = {k: v for k, v in after.items() if k.startswith("tenant_kv_committed_bytes")}
    ten = http["tenancy"]
    if (ten["totals"] != {"active": 0, "kv_bytes": 0} or any(kv_gauges.values())
            or ten["adapters"]["live_refs"] or engine.kv_pool.used_blocks or loop.admitted):
        raise AssertionError(f"serve llama tenants: left behind: {ten['totals']}, "
                             f"{kv_gauges}, {ten['adapters']}, {engine.kv_pool.used_blocks} "
                             f"blocks, {loop.admitted} streams")
    # /status.tenancy.fairshare is the batcher queue's (the whole requests:
    # the canary, the anonymous one); the loop's fair share its streams'.
    for fs, log, what in ((ten["fairshare"], batch_pops, "batcher"),
                          (loop.queue._fairshare.snapshot(), loop_pops, "loop")):
        served = {t: v["served"] for t, v in fs.items() if v["served"]}
        logged = {}
        for _, _, t in log:
            logged[t] = logged.get(t, 0) + 1
        if served != logged:
            raise AssertionError(f"serve llama tenants: the {what} queue served {served}, "
                                 f"pops logged {logged}")
    # Every row teacher-forced through its adapter.
    rows_all = rows + [np.array(toks, np.int32) for _, toks in captured]
    feats_all = feats + [f for f, _ in captured]
    aids = [f.get("adapter_id") for f in feats_all]
    check = lora_teacher_forced(bundle, ref_model, adir, feats_all, rows_all, aids,
                                engine.max_decode_len)
    # The same backlog on a batcher without TENANTS_FILE (the fair share
    # and the ledger not built): tokens/s only.
    _, plain = tenant_batcher(svc)
    plain_feats = [tenant_feats(bundle, None, key, item) for key, item in items]
    zero()
    prows, _, pwall = asyncio.run(backlog_drive(plain, plain_feats, stop=True))
    held_launches("serve llama tenants unset", bundle, engine, plain._cdl,
                  decode_attention.launches, paged_decode_attention.launches, rehearsal)
    k2 += decode_attention.launches
    k3 += paged_decode_attention.launches
    plain_tok_s = sum(len(r) for r in prows) / pwall
    http_ttft = {t: percentiles(v) for t, v in http["ttft_s"].items()}
    emit("serve llama tenants", device=str(bundle.device), card=card_line,
         layers=bundle.cfg.num_layers, tenants=tenant_table(carol_cost), slots=loop.n_slots,
         backlog_streams=len(rows), http_streams=len(captured), share=share,
         carol_third=http["third"], carol_window=http["window"],
         carol_window_want_retry_after=want_ra, answers=ans, counted_429=c429,
         quota_sheds=quota, tenancy=ten, backlog_ttft=backlog_ttft, http_ttft=http_ttft,
         tok_s_tenants=tok_s, tok_s_unset=plain_tok_s, tok_s_ratio=tok_s / plain_tok_s,
         decode_attention_launches=k2, paged_decode_attention_launches=k3,
         misses=gdrive["misses"], teacher_forced=check, seconds=time.monotonic() - t0)
    release(bundle)
    svc["adir"].cleanup()
    return {"decode_attention": k2, "paged_decode_attention": k3}


def weight_main(which: str, rehearsal: bool) -> int:
    """``--quant`` / ``--lora`` / ``--tenants``: the build and 8g, 8h or 8l
    alone, TinyLlama at full width (the rehearsal's small llama on the CPU,
    no build).  Prints no result line."""
    import torch

    phase = "env"
    try:
        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode=which)
        if not rehearsal:
            phase = "build"
            phase_build()
        from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
        from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

        device = "cpu" if rehearsal else "cuda"
        cfg = llama_mod.LlamaConfig(**(REHEARSAL_LLAMA if rehearsal else {}), eos_id=1, pad_id=0)
        params = llama_pytree(cfg, seed=0)
        if which == "quant":
            phase = "serve quantize"
            phase_serve_quant(params, cfg, rehearsal, card_line)
        else:
            phase = "serve llama lora" if which == "lora" else "serve llama tenants"
            ref = llama_mod.build_model(cfg, llama_params_from_jax(params, cfg),
                                        torch.device(device), torch.float32)
            run = phase_serve_lora if which == "lora" else phase_serve_tenants
            run(params, ref, cfg, rehearsal, card_line)
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


# Faults, the watchdog, the supervisor and K3's split autotuner (8i), and
# the converter CLI, over TinyLlama at full width through the paged loop's
# graphs.  One bundle; each case is an engine and a batcher of its own over
# it (the engines share the bundle's start graphs, each loop captures its
# chunk graphs at its warm-up).
FAULT_WORDS = ["fault", "rebuild", "resume", "split", "tune", "graph", "slot", "watchdog"]


def fault_items(rehearsal: bool) -> list:
    """Four prompts of 14-58 bytes (under every seq bucket of the phase),
    the last sampled and seeded; each asks for the whole decode budget."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(8)
    items = []
    for i, n in enumerate((14, 30, 45, 58)):
        text = " ".join(rng.choice(FAULT_WORDS, size=n))[:n]
        sampling = dict(temperature=0.8, top_k=40, seed=2024) if i == 3 else {}
        items.append(RawItem(text=text, **sampling))
    return items


def faults_overrides(device: str, rehearsal: bool) -> dict:
    """The phase's service: TinyLlama, paged (16-token blocks), 4 slots,
    one seq bucket (256: a table of 19 blocks, 5 key tiles, so K3 has four
    split counts to choose from), 48 tokens in chunks of 4 (12 chunk
    dispatches a wave), one dispatch in flight."""
    ov = {"MODEL_NAME": "llama", "DEVICE": device, "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE),
          "MAX_STREAMS": "4", "BATCH_BUCKETS": "1,4", "SEQ_BUCKETS": "256",
          "MAX_DECODE_LEN": "48", "STREAM_CHUNK_TOKENS": "4", "STREAM_PIPELINE": "1"}
    if rehearsal:
        ov["SEQ_BUCKETS"] = "64"
    if rehearsal:
        ov["LLAMA_CONFIG"] = json.dumps(REHEARSAL_LLAMA)
    return ov


def fault_engine(bundle, overrides: dict, **knobs):
    """An engine and a batcher over ``bundle`` under the phase's overrides
    and ``knobs``, warmed as the app warms (the bucket graphs, then the
    loop: its tuning, then its chunk graphs); returns (cfg, engine,
    batcher, warm seconds)."""
    from mlmicroservicetemplate_tpu_torch.engine.engine import InferenceEngine
    from mlmicroservicetemplate_tpu_torch.scheduler.batcher import Batcher
    from mlmicroservicetemplate_tpu_torch.utils.config import load_config

    cfg = load_config({**overrides, **knobs})
    engine = InferenceEngine(bundle, cfg)
    batcher = Batcher(engine, cfg)
    t0 = time.monotonic()
    batcher.warm_engine()
    batcher.warm_streams()
    return cfg, engine, batcher, time.monotonic() - t0


async def drive_queued(batcher, bundle, items):
    """Every item's stream queued before the loop's thread starts (one
    wave), each read to its end; returns (feats, [its tokens, or the
    stream's exception])."""
    loop = batcher._cdl
    await batcher.start()
    feats = [bundle.preprocess(item) for item in items]

    async def read(gen):
        return [int(x) async for chunk in gen for x in chunk]

    try:
        loop._ensure_thread = lambda: None
        try:
            gens = [batcher.submit_stream(dict(f)) for f in feats]
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        outs = await asyncio.gather(*(read(g) for g in gens), return_exceptions=True)
    finally:
        await batcher.stop()
    return feats, outs


def spy_recover(loop) -> list:
    """Record each supervised recovery of ``loop``: (start, end) monotonic
    seconds and whether it rebuilt."""
    seen = []
    orig = loop._recover

    def timed(exc):
        t0 = time.monotonic()
        ok = orig(exc)
        seen.append((t0, time.monotonic(), ok))
        return ok

    loop._recover = timed
    return seen


def greedy_parting(bundle, ref_model, f: dict, want, got, tol: float) -> dict:
    """Two greedy rows of one request: identical, or they part first at a
    step where both tokens are within the tolerance of the f32 reference's
    best logit (teacher-forced on ``want``), so twice it of each other:
    another split's summation order, a recast's prefill or another batch
    shape in bf16 may flip such a step."""
    import torch

    a, b = [int(t) for t in want], [int(t) for t in got]
    n = min(len(a), len(b))
    at = next((j for j in range(n) if a[j] != b[j]), None)
    out = {"tokens": n, "identical": at is None and len(a) == len(b)}
    if at is None:
        if len(a) != len(b):
            raise AssertionError(f"{len(a)} tokens against {len(b)}")
        return out
    with torch.inference_mode():
        ref = forced_logits(bundle, ref_model, f, a[: at + 1])[-1]
    best = float(ref.max())
    gaps = (best - float(ref[a[at]]), best - float(ref[b[at]]))
    out.update(parted_at=at, gaps=gaps, tol=tol)
    if max(gaps) > tol:
        raise AssertionError(f"a greedy stream parted from the clean run off a near tie: {out}")
    return out


def same_tokens(label: str, bundle, ref_model, feats, want_rows, got_rows, tol: float,
                max_len: int) -> dict:
    """Each stream's tokens against the clean run's: identical, or a greedy
    row parting only at a near tie (``greedy_parting``); and every token of
    every row teacher-forced against the f32 reference (a sampled row's
    draws too, where a token at the top-k or top-p boundary may fall either
    side of it)."""
    exact, parted = 0, []
    for f, want, got in zip(feats, want_rows, got_rows):
        if isinstance(got, BaseException):
            raise AssertionError(f"{label}: a stream failed: {type(got).__name__}: {got}")
        if [int(t) for t in want] == [int(t) for t in got]:
            exact += 1
        elif float(f.get("temperature", 0.0)) > 0:
            at = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
                      min(len(want), len(got)))
            parted.append({"sampled": True, "parted_at": at})
        else:
            parted.append(greedy_parting(bundle, ref_model, f, want, got, tol))
    check = teacher_forced(bundle, ref_model, feats, got_rows, max_len)
    return {"streams": len(got_rows), "identical": exact, "parted": parted,
            "worst_gap": check["worst_gap"], "tol": check["tol"],
            "sampled_worst_gap_over_tol": check["sampled_worst_gap_over_tol"]}


def loop_plan_splits(loop) -> list[int]:
    """The split counts of the K3 plans built, under the tuning table's
    current state and with no forced count, for this loop's decode shape
    (its slots, its table width)."""
    from mlmicroservicetemplate_tpu_torch.ops import autotune
    from mlmicroservicetemplate_tpu_torch.ops import paged_attention as pa

    gen = autotune.generation()
    # key: (block size, forced splits, generation) + the signature, whose
    # 13th field is the table's shape
    return sorted({plan.splits for key, plan in pa._paged_plans.items()
                   if key[1] is None and key[2] == gen
                   and tuple(key[15]) == (loop.n_slots, loop.nb_max)})


def graph_replays(loop) -> int:
    """Replays so far of the loop's chunk graphs (argmax and sampled)."""
    return sum(loop.chunk_graph(s).replays for s in (False, True))


def state_addresses(loop) -> list[int]:
    from mlmicroservicetemplate_tpu_torch.models.gpt import state_tensors

    return [t.data_ptr() for t in state_tensors(loop._state)]


def recovery_case(label: str, bundle, ref_model, overrides: dict, clean, tol: float, drive,
                  rehearsal: bool, card_line: str, restarts: int, fired: int, **knobs) -> dict:
    """One fault case: an engine under ``knobs``, the phase's streams
    driven, then held: the clean run's tokens (``same_tokens``),
    ``restarts`` supervised rebuilds and ``fired`` injected faults, every
    stream released and every block back; on the card no graph captured in
    the drive, the chunk graphs replayed after the rebuild, and the slot
    state at the addresses the graphs were captured over.  Times: each
    rebuild, and from its start to the loop's first emission after it (a
    resumed stream's first token)."""
    from mlmicroservicetemplate_tpu_torch.runtime.compile_cache import CACHE

    cfg, engine, batcher, warm_s = fault_engine(bundle, overrides, **knobs)
    loop = batcher._cdl
    recs = spy_recover(loop)
    # The loop's emissions (tokens sent to a stream), by time.
    emitted = []
    emit_tokens = loop._emit_tokens

    def emit_spy(st, chunk):
        before = loop.tokens_emitted
        emit_tokens(st, chunk)
        if loop.tokens_emitted > before:
            emitted.append(time.monotonic())

    loop._emit_tokens = emit_spy
    at_recover = []
    if not rehearsal:
        orig = loop._recover

        def probe(exc):
            at_recover.append(graph_replays(loop))
            return orig(exc)

        loop._recover = probe
        addresses, inserts = state_addresses(loop), CACHE.counts["insert"]
    t0 = time.monotonic()
    feats, outs = drive(batcher)
    wall = time.monotonic() - t0
    tokens = same_tokens(label, bundle, ref_model, feats, clean,
                         outs, tol,
                         engine.max_decode_len)
    sup = batcher.supervisor.stats()
    got_fired = sum(r.fired for r in engine.faults.rules)
    out = dict(card=card_line, knobs=knobs, warm_s=warm_s, wall_s=wall,
               tokens=tokens, supervisor=sup, fired=got_fired,
               chunk_dispatches=loop.chunk_dispatches,
               dispatch_counts=dict(sorted(engine.dispatch_counts.items())))
    if sup["restarts"] != restarts or sup["failed"] or got_fired != fired:
        raise AssertionError(f"{label}: {sup}, {got_fired} faults fired "
                             f"(want {restarts} restarts, {fired} faults)")
    if loop.admitted or engine.kv_pool.used_blocks:
        raise AssertionError(f"{label}: {loop.admitted} streams, "
                             f"{engine.kv_pool.used_blocks} blocks never released")
    if recs:
        start, end, _ = recs[0]
        after = [t for t in emitted if t > end]
        out.update(rebuild_ms=(end - start) * 1e3,
                   fault_to_first_resumed_token_ms=(min(after) - start) * 1e3 if after else None)
    if not rehearsal:
        after = graph_replays(loop) - (at_recover[0] if at_recover else 0)
        out.update(captures_in_drive=CACHE.counts["insert"] - inserts,
                   chunk_replays_after_rebuild=after if at_recover else None,
                   state_addresses_kept=state_addresses(loop) == addresses)
        if out["captures_in_drive"] or not out["state_addresses_kept"] or (
                at_recover and after < 1):
            raise AssertionError(f"{label}: the rebuild left the graphs: {out}")
    emit(label, **out)
    return out


async def budget_http(cfg, bundle, engine, batcher) -> dict:
    """The app over ``batcher`` (its canary through the batch path), one
    streamed completion whose chunks fault until the budget is spent, then
    ``/readyz`` until it answers 503, and ``/status.fault_tolerance``."""
    import aiohttp
    from aiohttp import web

    from mlmicroservicetemplate_tpu_torch.api.app import build_app

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    app = build_app(dataclasses.replace(cfg, warmup=False), bundle, engine, batcher)
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
            async with session.post(f"{url}/v1/completions", json={
                    "prompt": "a budget spent", "max_tokens": 32, "stream": True}) as r:
                stream_status, body = r.status, await r.text()
            for _ in range(600):
                async with session.get(f"{url}/readyz") as r:
                    ready_status, ready = r.status, await r.json()
                if ready_status == 503:
                    break
                await asyncio.sleep(0.05)
            async with session.get(f"{url}/status") as r:
                status = await r.json()
        return {"stream_status": stream_status, "stream_error": "error" in body,
                "readyz_status": ready_status, "readyz": ready,
                "fault_tolerance": status.get("fault_tolerance")}
    finally:
        await runner.cleanup()


def gpt2_hf_state(cfg, seed: int) -> dict:
    """A random HF GPT-2 state dict at ``cfg``'s widths (``transformer.*``
    names, Conv1D weights ``[in, out]``): N(0, 0.02) weights, unit
    LayerNorm scales, zero biases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff

    def w(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= 0.02
        return a

    state = {"transformer.wte.weight": w(cfg.vocab_size, d),
             "transformer.wpe.weight": w(cfg.max_position, d),
             "transformer.ln_f.weight": np.ones(d, np.float32),
             "transformer.ln_f.bias": np.zeros(d, np.float32)}
    for i in range(cfg.num_layers):
        b = f"transformer.h.{i}"
        for name in ("ln_1", "ln_2"):
            state[f"{b}.{name}.weight"] = np.ones(d, np.float32)
            state[f"{b}.{name}.bias"] = np.zeros(d, np.float32)
        for name, (n_in, n_out) in (("attn.c_attn", (d, 3 * d)), ("attn.c_proj", (d, d)),
                                    ("mlp.c_fc", (d, f)), ("mlp.c_proj", (f, d))):
            state[f"{b}.{name}.weight"] = w(n_in, n_out)
            state[f"{b}.{name}.bias"] = np.zeros(n_out, np.float32)
    return state


# A child process that meets the two kinds of CUDA error: an allocation
# past the card (out of memory) and an out-of-range index (a device-side
# assert, which the runtime makes sticky: the next call fails too).  It
# prints what torch raised, as [type, message], one JSON object.
STICKY_CHILD = """
import json, torch
out = {}
try:
    torch.empty(1 << 40, device="cuda")
except Exception as e:
    out["oom"] = [type(e).__name__, str(e)]
try:
    t = torch.zeros(4, device="cuda")
    t[torch.tensor([10], device="cuda")] = 1.0
    torch.cuda.synchronize()
except Exception as e:
    out["assert"] = [type(e).__name__, str(e)]
try:
    (torch.ones(1, device="cuda") + 1).cpu()
except Exception as e:
    out["after"] = [type(e).__name__, str(e)]
print(json.dumps(out))
"""


def sticky_child() -> subprocess.Popen:
    """Start ``phase_sticky_errors``' child (it runs beside the converter's
    check, which does not time the card)."""
    return subprocess.Popen([sys.executable, "-c", STICKY_CHILD], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def converter_and_sticky(card_line: str, rehearsal: bool, layers: int | None = None) -> None:
    """``convert gpt2`` (at ``layers`` when given), then the sticky errors
    of the child started before it; the child is stopped whatever fails."""
    if rehearsal:
        emit("convert gpt2", skipped="cpu rehearsal: GPT-2 at full width runs on the card")
        emit("serve llama faults sticky", skipped="cpu rehearsal: no CUDA error to raise")
        return
    child = sticky_child()
    try:
        phase_convert_gpt2(card_line, layers=layers)
        phase_sticky_errors(card_line, child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def phase_sticky_errors(card_line: str, child: subprocess.Popen) -> dict:
    """The fault classifier on what torch really raises on the card, from a
    child process (a sticky error ends the process's use of the card):
    its device-side assert, and the call after it, must read as a poisoned
    context; its out-of-memory error must not."""
    import torch

    from mlmicroservicetemplate_tpu_torch.engine.faults import is_context_poisoned

    stdout, stderr = child.communicate(timeout=300)
    got = json.loads(stdout.strip().splitlines()[-1])
    if set(got) != {"oom", "assert", "after"}:
        raise AssertionError(f"serve llama faults sticky: the child raised {got}, "
                             f"stderr {stderr[-2000:]}")
    kinds = {"OutOfMemoryError": torch.cuda.OutOfMemoryError,
             "AcceleratorError": getattr(torch, "AcceleratorError", RuntimeError)}
    out = {}
    for key, (kind, msg) in got.items():
        exc = kinds.get(kind, RuntimeError)(msg)
        out[key] = {"type": kind, "message": msg.splitlines()[0],
                    "poisoned": is_context_poisoned(exc)}
    if (out["oom"]["poisoned"] or not out["assert"]["poisoned"]
            or not out["after"]["poisoned"]):
        raise AssertionError(f"serve llama faults sticky: misclassified {out}")
    emit("serve llama faults sticky", card=card_line, **out)
    return out


def phase_convert_gpt2(card_line: str, device: str = "cuda", layers: int | None = None) -> dict:
    """The converter CLI's entry point on a seed-0 random GPT-2 HF state
    dict at full width (``.npz``; its first ``layers`` layers when given,
    ``--num-layers``), then ``MODEL_PATH`` at its output and at the
    ``.npz`` itself: the two models' parameters and bf16 logits on the
    card must be equal."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mlmicroservicetemplate_tpu_torch.convert.__main__ import main as convert_main
    from mlmicroservicetemplate_tpu_torch.models import gpt as gpt_mod
    from mlmicroservicetemplate_tpu_torch.models.registry import build_model
    from mlmicroservicetemplate_tpu_torch.utils.config import load_config

    work = tempfile.mkdtemp(prefix="chip_smoke_convert_")
    try:
        src, ckpt = f"{work}/gpt2.npz", f"{work}/ckpt"
        cfg = gpt_mod.GPTConfig() if layers is None else gpt_mod.GPTConfig(num_layers=layers)
        np.savez(src, **gpt2_hf_state(cfg, seed=0))
        depth = [] if layers is None else ["--num-layers", str(layers)]
        t0 = time.monotonic()
        convert_main(["--model", "gpt2", "--input", src, "--output", ckpt, *depth])
        convert_s = time.monotonic() - t0
        models = {}
        with gpt2_layers(cfg.num_layers):
            for name, path in (("checkpoint", ckpt), ("npz", src)):
                models[name] = build_model(load_config(
                    {"MODEL_NAME": "gpt2", "DEVICE": device, "MODEL_PATH": path, "WARMUP": "0",
                     "SEQ_BUCKETS": "64", "MAX_DECODE_LEN": "16"}))
        a, b = models["checkpoint"], models["npz"]
        sa, sb = a.model.state_dict(), b.model.state_dict()
        if sorted(sa) != sorted(sb) or not all(torch.equal(sa[k], sb[k]) for k in sa):
            raise AssertionError("MODEL_PATH at the checkpoint built other weights than at "
                                 "the .npz")
        ids = torch.tensor([list(b"the converter's checkpoint serves these logits")],
                           dtype=torch.int32, device=device)
        with torch.inference_mode():
            la, lb = (gpt_mod.lm_logits(m.model, ids, torch.ones_like(ids),
                                        m.policy.compute_dtype).float() for m in (a, b))
        diff = float((la - lb).abs().max())
        out = dict(card=card_line, layers=cfg.num_layers, convert_s=convert_s, parameters=len(sa),
                   checkpoint_mb=os.path.getsize(f"{ckpt}/params.npz") / 1e6,
                   npz_mb=os.path.getsize(src) / 1e6, logits=list(la.shape),
                   logits_max_abs_diff=diff, logits_finite=bool(la.isfinite().all()))
        if diff != 0.0 or not out["logits_finite"]:
            raise AssertionError(f"convert gpt2: logits differ: {out}")
        emit("convert gpt2", **out)
        del models, a, b
        if device == "cuda":
            torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_serve_faults(params, ref_model, rehearsal: bool, card_line: str) -> dict:
    """8i: TinyLlama (the rehearsal's small llama on the CPU) through the
    paged loop's graphs, four streams (one sampled) of 48 tokens:

    - clean: the heuristic split, no fault; every token teacher-forced;
    - (a) ``PALLAS_AUTOTUNE=1`` with a fresh table: the sweep verifies every
      candidate split against the plain version before timing it (none
      rejected), each candidate's device µs and the winner printed, the
      loop's K3 plans at the winner's split, its tokens the clean run's; a
      second engine on the same table (the process table forgotten) hits
      it with no sweep;
    - (b) ``PALLAS_VARIANT`` pinned to a split that is not the heuristic's:
      its plans at the pin, the clean run's tokens;
    - (c) ``chunk:fatal@5`` under the supervisor: one rebuild, the streams
      resumed with the clean run's tokens, the chunk graphs replayed after
      it over the same slot state, no capture;
    - (d) ``chunk:transient@2+3`` with three retries: invisible, no rebuild;
    - (e) ``chunk:hang(30)@5`` cut by a 3 s ``DISPATCH_TIMEOUT_S``: one
      rebuild, as (c);
    - (f) ``chunk:fatal~1`` with ``ENGINE_RESTARTS_MAX=1``: through the app,
      the stream fails, ``/readyz`` answers 503 with the reference's body
      and ``/status.fault_tolerance`` reads the spent budget.

    Tokens "the clean run's": identical, or a greedy row parting only at a
    near tie, and every token teacher-forced against the f32 reference
    (``same_tokens``).  Returns the K2 and K3 launches of its drives."""
    import tempfile

    from mlmicroservicetemplate_tpu_torch.models.registry import build_model
    from mlmicroservicetemplate_tpu_torch.ops import autotune
    from mlmicroservicetemplate_tpu_torch.ops.attention import decode_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import (
        feasible_splits,
        paged_decode_attention,
    )
    from mlmicroservicetemplate_tpu_torch.utils.config import load_config

    device = "cpu" if rehearsal else "cuda"
    ov = faults_overrides(device, rehearsal)
    bundle = build_model(load_config(ov), params=params)
    items = fault_items(rehearsal)
    launches = {"decode_attention": 0, "paged_decode_attention": 0}

    def drive(batcher):
        k2, k3 = decode_attention.launches, paged_decode_attention.launches
        out = asyncio.run(drive_queued(batcher, bundle, items))
        launches["decode_attention"] += decode_attention.launches - k2
        launches["paged_decode_attention"] += paged_decode_attention.launches - k3
        return out

    autotune.clear()
    try:
        # clean
        cfg0, engine0, batcher0, warm0 = fault_engine(bundle, ov)
        loop0 = batcher0._cdl
        default_splits = [] if rehearsal else loop_plan_splits(loop0)
        k3 = paged_decode_attention.launches
        feats, outs = drive(batcher0)
        k3 = paged_decode_attention.launches - k3
        if any(isinstance(o, BaseException) for o in outs):
            raise AssertionError(f"serve llama faults clean: {outs}")
        clean = outs
        check = teacher_forced(bundle, ref_model, feats, clean, engine0.max_decode_len)
        want_k3 = 0 if rehearsal else bundle.cfg.num_layers * loop0.decode_steps
        if k3 != want_k3 or any(len(r) != engine0.max_decode_len for r in clean):
            raise AssertionError(f"serve llama faults clean: K3 {k3} launches (want {want_k3}), "
                                 f"rows of {[len(r) for r in clean]} tokens")
        emit("serve llama faults clean", card=card_line, layers=bundle.cfg.num_layers,
             slots=loop0.n_slots, table_blocks=loop0.nb_max, warm_s=warm0,
             heuristic_splits=default_splits, chunk_dispatches=loop0.chunk_dispatches,
             paged_decode_attention_launches=k3, **check)
        tol = check["tol"]
        if rehearsal:
            for name in ("autotune", "pin"):
                emit(f"serve llama faults {name}",
                     skipped="cpu rehearsal: the loop tunes K3 on the card only")
        else:
            # (a) the sweep, then a second engine on its table
            table = f"{tempfile.mkdtemp(prefix='chip_smoke_tune_')}/pallas_tune.json"
            knobs = {"PALLAS_AUTOTUNE": "1", "PALLAS_TUNE_TABLE": table}
            autotune.clear()
            sweep_s = []
            ensure = autotune.ensure_tuned

            def timed(*a, **k):
                t0 = time.monotonic()
                got = ensure(*a, **k)
                sweep_s.append(time.monotonic() - t0)
                return got

            autotune.ensure_tuned = timed
            try:
                _, _, batcher_a, warm_a = fault_engine(bundle, ov, **knobs)
            finally:
                autotune.ensure_tuned = ensure
            loop_a = batcher_a._cdl
            stats = autotune.stats()
            ((key, sweep),) = stats["sweeps"].items()
            counts = stats["counts"]
            cands = feasible_splits(loop_a.nb_max, loop_a.block_size)
            winner = int(sweep["winner"][1:])
            tuned_splits = loop_plan_splits(loop_a)
            if (counts["sweeps"] != 1 or counts["candidates"] != len(cands)
                    or counts["timed"] != len(cands) or counts["reject_verify"]
                    or counts["reject_error"] or loop_a.kernel_variant != sweep["winner"]
                    or tuned_splits != [winner]):
                raise AssertionError(f"serve llama faults autotune: {stats}, the loop's "
                                     f"variant {loop_a.kernel_variant!r}, its plans "
                                     f"{tuned_splits}, feasible {cands}")
            _, outs_a = drive(batcher_a)
            tokens_a = same_tokens("serve llama faults autotune", bundle, ref_model, feats,
                                   clean, outs_a, tol, engine0.max_decode_len)
            autotune.clear()  # a new process on the same table
            _, _, batcher_a2, _ = fault_engine(bundle, ov, **knobs)
            counts2 = autotune.stats()["counts"]
            if (counts2["hits"] != 1 or counts2["sweeps"] != 0
                    or batcher_a2._cdl.kernel_variant != sweep["winner"]
                    or loop_plan_splits(batcher_a2._cdl) != [winner]):
                raise AssertionError(f"serve llama faults autotune: the second engine "
                                     f"{counts2}, {batcher_a2._cdl.kernel_variant!r}")
            emit("serve llama faults autotune", card=card_line, key=key,
                 candidates=[f"s{n}" for n in cands], default=sweep["default"],
                 winner=sweep["winner"], device_us=sweep["per_call_us"],
                 sweep_s=sweep_s[0], warm_s=warm_a, counts=counts, tokens=tokens_a,
                 second_engine=counts2)
            # (b) a pin that is not the heuristic's split
            others = [n for n in cands if n not in default_splits]
            if not others:
                raise AssertionError(f"serve llama faults pin: no split but {default_splits}")
            pin = next((n for n in others if n != winner), others[0])
            autotune.clear()
            _, _, batcher_b, _ = fault_engine(bundle, ov, PALLAS_VARIANT=f"s{pin}")
            pinned = loop_plan_splits(batcher_b._cdl)
            if pinned != [pin] or autotune.stats()["counts"]["pins"] != 1:
                raise AssertionError(f"serve llama faults pin: plans {pinned}, pin s{pin}")
            _, outs_b = drive(batcher_b)
            tokens_b = same_tokens("serve llama faults pin", bundle, ref_model, feats, clean,
                                   outs_b, tol, engine0.max_decode_len)
            emit("serve llama faults pin", card=card_line, pin=f"s{pin}", plans=pinned,
                 tokens=tokens_b)
            autotune.clear()  # the fault cases run the heuristic's split
        # (c) fatal, (d) transient, (e) hang
        fatal = recovery_case("serve llama faults fatal", bundle, ref_model, ov, clean, tol,
                              drive, rehearsal, card_line, restarts=1, fired=1,
                              FAULT_SPEC="chunk:fatal@5")
        recovery_case("serve llama faults transient", bundle, ref_model, ov, clean, tol, drive,
                      rehearsal, card_line, restarts=0, fired=3,
                      FAULT_SPEC="chunk:transient@2+3", DISPATCH_RETRIES="3",
                      DISPATCH_BACKOFF_S="0.001")
        hang = recovery_case("serve llama faults hang", bundle, ref_model, ov, clean, tol,
                             drive, rehearsal, card_line, restarts=1, fired=1,
                             FAULT_SPEC="chunk:hang(30)@5", DISPATCH_TIMEOUT_S="3")
        # (f) the budget spent, through the app
        cfg_f, engine_f, batcher_f, _ = fault_engine(bundle, ov, FAULT_SPEC="chunk:fatal~1",
                                                     ENGINE_RESTARTS_MAX="1")
        try:
            import aiohttp  # noqa: F401
        except ImportError:
            feats_f, outs_f = drive(batcher_f)
            budget = {"http": "aiohttp is not installed; the loop driven directly",
                      "streams_failed": all(isinstance(o, BaseException) for o in outs_f),
                      "fault_tolerance": batcher_f.supervisor.stats()}
            ok = budget["streams_failed"]
        else:
            budget = asyncio.run(budget_http(cfg_f, bundle, engine_f, batcher_f))
            ok = (budget["readyz_status"] == 503 and budget["readyz"] == {
                "ready": False, "error": "engine restart budget exhausted (ENGINE_RESTARTS_MAX)"}
                and budget["stream_error"])
        if not ok or budget["fault_tolerance"] != {"restarts": 1, "max_restarts": 1,
                                                   "failed": True}:
            raise AssertionError(f"serve llama faults budget: {budget}")
        emit("serve llama faults budget", card=card_line, **budget)
        emit("serve llama faults", card=card_line, ok=True, launches=launches,
             fatal_rebuild_ms=fatal.get("rebuild_ms"),
             fatal_to_first_resumed_token_ms=fatal.get("fault_to_first_resumed_token_ms"),
             hang_rebuild_ms=hang.get("rebuild_ms"),
             hang_cut_to_first_resumed_token_ms=hang.get("fault_to_first_resumed_token_ms"))
        return launches
    finally:
        autotune.clear()
        if not rehearsal:
            release(bundle)


def faults_main(rehearsal: bool) -> int:
    """``--faults``: the build and 8i alone (the converter's check on the
    card), TinyLlama at full width (the rehearsal's small llama on the CPU,
    no build).  Prints no result line."""
    import torch

    phase = "env"
    try:
        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="faults")
        if not rehearsal:
            phase = "build"
            phase_build()
        from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
        from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

        device = "cpu" if rehearsal else "cuda"
        cfg = llama_mod.LlamaConfig(**(REHEARSAL_LLAMA if rehearsal else {}), eos_id=1, pad_id=0)
        params = llama_pytree(cfg, seed=0)
        ref = llama_mod.build_model(cfg, llama_params_from_jax(params, cfg), torch.device(device),
                                    torch.float32)
        phase = "serve llama faults"
        phase_serve_faults(params, ref, rehearsal, card_line)
        phase = "convert gpt2"
        converter_and_sticky(card_line, rehearsal)
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


OBSERVE_WORDS = ["trace", "flight", "ring", "busy", "bubble", "graph", "replay", "span"]
# The phase's layer, on and off.
LAYER_ON = {"PERF_OBS": "1", "TRACE": "1", "LOG_FORMAT": "json", "LOCKTRACE": "1"}
LAYER_OFF = {"PERF_OBS": "0", "TRACE": "0", "FLIGHT_RING": "0", "LOG_FORMAT": "text",
             "LOCKTRACE": "0"}
OBSERVE_FAULTS = "chunk:fatal@1;chunk:transient@4"
# 8j's gate on the estimator's looseness under TRACE=1: its busy time at
# most this many times the CUDA-event busy time of the same replays.
OBSERVE_BUSY_FACTOR = 1.5
# The cost part's layer: the defaults (TRACE off), no fault; its on/off
# pairs of drives; the flight ring it switches back on.
OBSERVE_RING = 256
LAYER_DEFAULT = {"PERF_OBS": "1", "TRACE": "0", "FLIGHT_RING": str(OBSERVE_RING),
                 "LOG_FORMAT": "text", "LOCKTRACE": "0", "FAULT_SPEC": ""}
OBSERVE_AB_PAIRS = 3


def observe_items(rehearsal: bool) -> list:
    """Eight prompts of 12-96 bytes (under the seq bucket), the last sampled
    and seeded; each asks for the whole decode budget."""
    import numpy as np

    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem

    rng = np.random.default_rng(9)
    items = []
    for i, n in enumerate((12, 20, 31, 40, 52, 64, 80, 96)):
        if rehearsal:
            n = min(n, 48)
        text = " ".join(rng.choice(OBSERVE_WORDS, size=n))[:n]
        sampling = dict(temperature=0.8, top_k=40, seed=77) if i == 7 else {}
        items.append(RawItem(text=text, **sampling))
    return items


def observe_overrides(device: str, rehearsal: bool, layers: int | None = None) -> dict:
    """TinyLlama, paged (16-token blocks), 8 slots, one seq bucket of 128,
    64 tokens in chunks of 4 (16 chunk dispatches a wave), one dispatch in
    flight; a fatal fault at the first loop chunk and a transient one at
    the fourth after it.  ``layers``: the weights' depth, when it is not
    TinyLlama's (the main run's 8j at ``CUT_LAYERS``)."""
    ov = {"MODEL_NAME": "llama", "DEVICE": device, "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE),
          "MAX_STREAMS": "8", "BATCH_BUCKETS": "1,8", "SEQ_BUCKETS": "128",
          "MAX_DECODE_LEN": "64", "STREAM_CHUNK_TOKENS": "4", "STREAM_PIPELINE": "1",
          "WARMUP": "0", "FAULT_SPEC": OBSERVE_FAULTS, "DISPATCH_RETRIES": "2",
          "DISPATCH_BACKOFF_S": "0.001"}
    if rehearsal:  # 3 loop chunks a stream after the resume: the transient at the second
        ov.update(SEQ_BUCKETS="64", MAX_DECODE_LEN="16", LLAMA_CONFIG=json.dumps(REHEARSAL_LLAMA),
                  FAULT_SPEC="chunk:fatal@1;chunk:transient@2")
    elif layers is not None:
        ov["LLAMA_CONFIG"] = json.dumps({"num_layers": layers})
    return ov


def llama_hand_flops(cfg, rows: int) -> int:
    """FLOPs of one decode step of ``rows`` rows through the linears and the
    LM head of a llama (2 a multiply-add; attention, the hand-written
    kernels' work, is left out, as the graph count leaves it)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    q = o = d * cfg.num_heads * cfg.head_dim
    kv = d * cfg.num_kv_heads * cfg.head_dim
    return rows * (cfg.num_layers * 2 * (q + 2 * kv + o + 3 * d * f) + 2 * d * v)


def loop_rows(batcher) -> int:
    """The batch bucket a wave of the loop's every slot collates to."""
    from mlmicroservicetemplate_tpu_torch.engine.engine import bucket_for

    return bucket_for(batcher._cdl.n_slots, batcher.engine.batch_buckets)


def observe_drive(loop, bundle, items):
    """Every item's stream queued before the loop's thread starts (one wave),
    straight into the loop (its batcher stays unstarted, for the app);
    returns (feats, rows, wall seconds)."""
    feats = [bundle.preprocess(item) for item in items]

    async def read(gen):
        return [int(x) async for chunk in gen for x in chunk]

    async def main():
        loop._ensure_thread = lambda: None
        try:
            gens = [loop.submit_stream(dict(f)) for f in feats]
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        return await asyncio.gather(*(read(g) for g in gens), return_exceptions=True)

    t0 = time.perf_counter()
    rows = asyncio.run(main())
    wall = time.perf_counter() - t0
    bad = [r for r in rows if isinstance(r, BaseException)]
    if bad:
        raise AssertionError(f"serve llama observe: a stream failed: {bad[0]!r}")
    return feats, rows, wall


def graph_captures(engine) -> tuple[int, float]:
    """The graph cache's captures so far and their host seconds."""
    graphs = engine.graphs
    return (graphs.counts["insert"], graphs.capture_s) if graphs is not None else (0, 0.0)


def replay_events(enabled: bool):
    """CUDA events around every graph replay while the returned list is
    being filled (``enabled``), and a function that stops it."""
    from mlmicroservicetemplate_tpu_torch.runtime import compile_cache

    events: list = []
    orig = compile_cache.GraphEntry.replay
    if not enabled:
        return events, lambda: None

    def replay(self):
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        orig(self)
        b.record()
        events.append((a, b))

    compile_cache.GraphEntry.replay = replay
    return events, lambda: setattr(compile_cache.GraphEntry, "replay", orig)


async def observe_http(llama_svc, bert_svc, n_bert: int, full: bool) -> dict:
    """Serve both apps over loopback: ``n_bert`` BERT ``/predict`` requests
    one at a time; with ``full``, the llama app's ``/debug/perf``,
    ``/debug/trace``, ``/debug/engine`` and ``/status``, then
    ``POST /debug/profile {"seconds": 2}`` while streams run."""
    import aiohttp
    from aiohttp import web

    from mlmicroservicetemplate_tpu_torch.api.app import build_app

    runners, urls = [], []
    try:
        for cfg, bundle, engine, batcher in (llama_svc, bert_svc):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            app = build_app(dataclasses.replace(cfg, warmup=False), bundle, engine, batcher)
            runner = web.AppRunner(app, access_log=None)
            await runner.setup()
            runners.append(runner)
            await web.TCPSite(runner, "127.0.0.1", port).start()
            urls.append(f"http://127.0.0.1:{port}")
        llama_url, bert_url = urls
        out: dict = {}
        async with aiohttp.ClientSession() as session:
            for url in urls:
                for _ in range(1200):
                    async with session.get(f"{url}/readyz") as r:
                        if r.status == 200:
                            break
                    await asyncio.sleep(0.05)
                else:
                    raise AssertionError(f"{url}/readyz never turned 200")
            for i in range(n_bert):
                async with session.post(f"{bert_url}/predict",
                                        json={"text": f"observe the card {i}"}) as r:
                    if r.status != 200:
                        raise AssertionError(f"bert /predict {r.status}: {await r.text()}")
                    await r.read()
            if not full:
                return out
            for key, path in (("perf", "/debug/perf"), ("trace", "/debug/trace"),
                              ("engine", "/debug/engine"), ("status", "/status")):
                async with session.get(f"{llama_url}{path}") as r:
                    if r.status != 200:
                        raise AssertionError(f"{path} answered {r.status}")
                    out[key] = json.loads(await r.text())
            stop = asyncio.Event()
            streamed = [0]

            async def one(i: int):
                body = {"prompt": f"observe {i} " * 4, "stream": True, "max_tokens": 32}
                async with session.post(f"{llama_url}/v1/completions", json=body) as r:
                    if r.status != 200:
                        raise AssertionError(f"/v1/completions {r.status}")
                    await r.read()
                streamed[0] += 1

            async def traffic():
                # Waves of 2 streams with pauses: the profile only has to
                # name K3, and each kernel event costs the export time.
                i = 0
                while not stop.is_set():
                    await asyncio.gather(*(one(i + j) for j in range(2)))
                    await asyncio.sleep(0.2)
                    i += 2

            load = asyncio.create_task(traffic())
            try:
                await asyncio.sleep(0.2)  # the first wave is in the loop
                async with session.post(f"{llama_url}/debug/profile",
                                        json={"seconds": 2}) as r:
                    out["profile_status"] = r.status
                    out["profile"] = json.loads(await r.text())
            finally:
                stop.set()
                await load
            out["profile_streams"] = streamed[0]
        return out
    finally:
        for runner in runners:
            await runner.cleanup()


def observe_run(layer: dict, params, items, rehearsal: bool, full: bool) -> dict:
    """One run of 8j's traffic under ``layer``: the llama and BERT services
    built through ``serve.build_service``, warmed as the app warms, the
    queued wave through the loop, then the HTTP part."""
    import torch

    from mlmicroservicetemplate_tpu_torch.ops.attention import fused_attention
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    device = "cpu" if rehearsal else "cuda"
    llama = build_service({**observe_overrides(device, rehearsal, len(params["layers"])),
                           **layer}, params=params)
    bert = build_service({"MODEL_NAME": "bert-base", "DEVICE": device, "WARMUP": "0",
                          "BATCH_BUCKETS": "1", "SEQ_BUCKETS": "32", **layer})
    cfg, bundle, engine, batcher = llama
    # WARMUP=0, as the app would serve it: the loop's slot state and chunk
    # graphs are built (they must be before a stream), and of the bucket
    # graphs only the wave's (8 rows at 128, argmax and sampled), so that
    # the drive captures nothing; the app's canary captures its own.
    batcher.warm_streams()
    if engine.graphs is not None:
        with engine._lock, torch.inference_mode():
            for sample in (False, True):
                engine._start_graph((loop_rows(batcher), max(engine.seq_buckets)), sample)
    bert[3].warm_engine()
    loop = batcher._cdl
    def entries():
        return engine.graphs.entries(bundle) if engine.graphs is not None else []

    replays0 = {id(e): e.replays for e in entries()}
    perf0 = engine.perf.snapshot()
    k3 = paged_decode_attention.launches
    captures0 = graph_captures(engine)
    events, stop_events = replay_events(full and not rehearsal)
    try:
        feats, rows, wall = observe_drive(loop, bundle, items)
    finally:
        stop_events()
    if not rehearsal:
        torch.cuda.synchronize()
    perf1 = engine.perf.snapshot()
    captures1 = graph_captures(engine)
    # What the drive's replays should have accrued, graph kind by kind (a
    # bucket's graph captured in the drive accrues from its first replay).
    expected: dict = {}
    for e in entries():
        n = e.replays - replays0.get(id(e), 0)
        if e.cost is not None and n > 0:
            expected[e.kind] = expected.get(e.kind, 0) + e.cost.flops * n
    run = {"cfg": cfg, "bundle": bundle, "engine": engine, "loop": loop, "feats": feats,
           "rows": rows, "wall_s": wall, "k3": paged_decode_attention.launches - k3,
           "dispatch_counts": dict(engine.dispatch_counts),
           "restarts": batcher.supervisor.restarts, "perf0": perf0, "perf1": perf1,
           "expected_flops": expected,
           "event_busy_s": sum(a.elapsed_time(b) for a, b in events) / 1e3,
           "replays": len(events), "drive_captures": captures1[0] - captures0[0],
           "drive_capture_s": captures1[1] - captures0[1]}
    k1 = fused_attention.launches
    run["http"] = asyncio.run(observe_http(llama, bert, 8, full))
    run["k1"] = fused_attention.launches - k1
    run["bert_bundle"] = bert[1]
    return run


def phase_serve_observe(params, ref_model, rehearsal: bool, card_line: str) -> dict:
    """8j (the module docstring has the gates); returns the K1 and K3
    launches of both runs' drives."""
    import io
    import logging
    import tempfile

    import torch

    from mlmicroservicetemplate_tpu_torch.utils import locktrace, perfobs, tracing

    items = observe_items(rehearsal)
    launches = {"fused_attention": 0, "paged_decode_attention": 0}
    off = observe_run(LAYER_OFF, params, items, rehearsal, full=False)
    for key, name in (("k1", "fused_attention"), ("k3", "paged_decode_attention")):
        launches[name] += off[key]
    if not rehearsal:
        release(off["bundle"])
        release(off["bert_bundle"])
    # The on-run's log lines, in whatever shape build_service gives them.
    root = logging.getLogger()
    captured = io.StringIO()
    capture = logging.StreamHandler(captured)
    formatters = {h: h.formatter for h in root.handlers}
    root.addHandler(capture)
    profile_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        on = observe_run({**LAYER_ON, "PROFILE_DIR": profile_dir}, params, items, rehearsal,
                         full=True)
        violations = locktrace.violations()
    finally:
        root.removeHandler(capture)
        for h, fmt in formatters.items():
            h.setFormatter(fmt)
        locktrace.uninstall()
        tracing.configure(False)
        perfobs.configure(True)
    for key, name in (("k1", "fused_attention"), ("k3", "paged_decode_attention")):
        launches[name] += on[key]
    label = "serve llama observe"
    bundle, engine, loop, http = on["bundle"], on["engine"], on["loop"], on["http"]
    try:
        # 1. the layer changes nothing the card computes
        check = teacher_forced(bundle, ref_model, on["feats"], on["rows"], engine.max_decode_len)
        if on["rows"] == off["rows"]:
            tokens = {"streams": len(on["rows"]), "identical": len(on["rows"]), "parted": [],
                      **{k: check[k] for k in ("worst_gap", "tol", "sampled_worst_gap_over_tol")}}
        else:
            tokens = same_tokens(label, bundle, ref_model, on["feats"], off["rows"], on["rows"],
                                 check["tol"], engine.max_decode_len)
        if (on["dispatch_counts"] != off["dispatch_counts"] or on["k1"] != off["k1"]
                or on["k3"] != off["k3"] or on["restarts"] != 1 or off["restarts"] != 1):
            raise AssertionError(
                f"{label}: dispatch counts {on['dispatch_counts']} vs {off['dispatch_counts']}, "
                f"K1 {on['k1']} vs {off['k1']}, K3 {on['k3']} vs {off['k3']}, restarts "
                f"{on['restarts']} vs {off['restarts']}")
        # K1: the eight requests and the app's canary, 12 layers each; K3:
        # every layer at every step of each loop chunk dispatched.
        want_k3 = 0 if rehearsal else (bundle.cfg.num_layers * engine.chunk_tokens
                                        * on["dispatch_counts"]["chunk"])
        if on["k3"] != want_k3 or on["k1"] != (0 if rehearsal else 9 * LAYERS):
            raise AssertionError(f"{label}: K3 {on['k3']} (want {want_k3}), K1 {on['k1']}")
        # 2. event busy <= estimated busy <= wall, and the estimate within
        # OBSERVE_BUSY_FACTOR of the events, over a drive that captured no
        # graph (a capture inside a guarded dispatch is host time the
        # estimator counts as busy: the cost phase below measures that case)
        busy = on["perf1"]["device_busy_total_s"] - on["perf0"]["device_busy_total_s"]
        if on["drive_captures"] or off["drive_captures"]:
            raise AssertionError(f"{label}: the drives captured {on['drive_captures']} and "
                                 f"{off['drive_captures']} graphs (warm-up missed a bucket)")
        if not rehearsal and not (on["event_busy_s"] <= busy <= on["wall_s"]
                                  and busy <= OBSERVE_BUSY_FACTOR * on["event_busy_s"]):
            raise AssertionError(f"{label}: CUDA-event busy {on['event_busy_s']:.4f} s, "
                                 f"estimated {busy:.4f} s (at most {OBSERVE_BUSY_FACTOR}x the "
                                 f"events), wall {on['wall_s']:.4f} s")
        # 3. modeled FLOPs of a decode step against the hand count
        hand = llama_hand_flops(bundle.cfg, loop.n_slots)
        flops = {"hand_per_step": hand, "tolerance": "exact (integer counts)"}
        accrued = {}
        if engine.graphs is not None:
            entry = loop.chunk_graph(False)
            per_step = entry.cost.flops // engine.chunk_tokens
            by0, by1 = (on[k]["modeled_flops_by_kind"] for k in ("perf0", "perf1"))
            accrued = {k: v - by0.get(k, 0.0) for k, v in by1.items() if v != by0.get(k, 0.0)}
            flops.update(graph_per_step=per_step, kind=entry.kind, accrued=accrued,
                         expected=on["expected_flops"])
            if per_step * engine.chunk_tokens != entry.cost.flops or per_step != hand:
                raise AssertionError(f"{label}: modeled {entry.cost.flops} FLOPs a chunk of "
                                     f"{engine.chunk_tokens} steps, hand {hand} a step")
            if accrued != on["expected_flops"]:
                raise AssertionError(f"{label}: accrued {accrued}, the replays' "
                                     f"{on['expected_flops']}")
        # 4. MFU
        mfu = http["perf"]["mfu_estimate"]
        if not rehearsal and not (mfu and mfu > 0):
            raise AssertionError(f"{label}: mfu_estimate {mfu}")
        # 5. /debug/trace
        names = {ev["name"] for ev in http["trace"]["traceEvents"]}
        if not {"decode_chunk", "dispatch:chunk"} <= names:
            raise AssertionError(f"{label}: /debug/trace spans {sorted(names)}")
        # 6. /debug/engine and /status
        dbg = http["engine"]
        kinds = {e["event"] for e in dbg["events"]}
        if (not dbg["iterations"] or "dispatch_retry" not in kinds or dbg["dumps"] != 1
                or http["status"]["observability"]["flight_dumps"] != 1):
            raise AssertionError(f"{label}: /debug/engine {len(dbg['iterations'])} iterations, "
                                 f"events {sorted(kinds)}, dumps {dbg['dumps']}, /status "
                                 f"{http['status']['observability']}")
        # 7. the profile
        prof = http["profile"]
        if http["profile_status"] != 200 or not os.path.exists(prof.get("trace_file", "")):
            raise AssertionError(f"{label}: /debug/profile {http['profile_status']} {prof}")
        with open(prof["trace_file"]) as f:
            text = f.read()
        if not text.lstrip().startswith("{") or '"traceEvents"' not in text:
            raise AssertionError(f"{label}: {prof['trace_file']} is no Chrome trace")
        # Event names by a regex over the text (a full parse of the ~250 MB
        # file costs seconds of the run); K3's appear on its kernel events.
        event_names = sorted(set(re.findall(r'"name":\s*"([^"]*)"', text)))
        k3_named = [n for n in event_names if re.search(K3_KERNEL, n)]
        if not rehearsal and not k3_named:
            raise AssertionError(f"{label}: the profile names no K3 kernel "
                                 f"({len(event_names)} event names)")
        # 8. locks and logs
        lines = [ln for ln in captured.getvalue().splitlines() if ln.strip()]
        not_json = []
        for ln in lines:
            try:
                json.loads(ln)
            except ValueError:
                not_json.append(ln)
        if violations or not lines or not_json:
            raise AssertionError(f"{label}: locktrace {violations}, {len(lines)} log lines, "
                                 f"not JSON: {not_json[:3]}")
        toks = sum(len(r) for r in on["rows"])
        peak, drive_flops = http["perf"]["peak_flops"], sum(accrued.values())
        emit(label, card=card_line, layers=bundle.cfg.num_layers, slots=loop.n_slots,
             fault_spec=on["cfg"].fault_spec, tokens=tokens, dispatch_counts=on["dispatch_counts"],
             launches={"fused_attention": on["k1"], "paged_decode_attention": on["k3"]},
             restarts=on["restarts"], wall_s=on["wall_s"], estimated_busy_s=busy,
             event_busy_s=on["event_busy_s"], replays=on["replays"],
             busy_gap_s=busy - on["event_busy_s"], bubble_s=(
                 on["perf1"]["device_bubble_s"] - on["perf0"]["device_bubble_s"]),
             modeled_flops=flops, mfu_estimate=mfu, peak_flops=peak,
             # The drive's accrued FLOPs over its busy and its wall time (the
             # book is per model name, so /debug/perf's mfu_busy also holds
             # the run's earlier llama services).
             mfu_drive_busy=drive_flops / busy / peak if peak and busy else None,
             mfu_drive_wall=drive_flops / on["wall_s"] / peak if peak else None,
             trace_spans=len(http["trace"]["traceEvents"]),
             flight={"iterations": len(dbg["iterations"]), "events": sorted(kinds),
                     "dumps": dbg["dumps"], "last_dump": dbg["last_dump"]["reason"]},
             profile={"seconds": prof["seconds"], "streams": http["profile_streams"],
                      "event_names": len(event_names), "k3_names": k3_named[:2],
                      "bytes": os.path.getsize(prof["trace_file"])},
             locktrace_violations=len(violations), log_lines=len(lines),
             tokens_per_s_on=toks / on["wall_s"],
             tokens_per_s_off=sum(len(r) for r in off["rows"]) / off["wall_s"])
    finally:
        if not rehearsal:
            release(bundle)
            release(on["bert_bundle"])
    cost = phase_observe_cost(params, ref_model, items, off["rows"], rehearsal, card_line)
    launches["paged_decode_attention"] += cost["paged_decode_attention"]
    return launches


def observe_switch(engine, on: bool) -> None:
    """The layer's default hot-path parts on or off at run time, between
    drives: the replays' cost accrual, the occupancy estimator and the
    flight recorder (``PERF_OBS=0 FLIGHT_RING=0`` turn off the same)."""
    from mlmicroservicetemplate_tpu_torch.utils import perfobs

    perfobs.configure(on)
    engine.perf.enabled = on
    engine.flight.size = OBSERVE_RING if on else 0


def phase_observe_cost(params, ref_model, items, off_rows, rehearsal: bool,
                       card_line: str) -> dict:
    """8j's cost part: TinyLlama as 8j serves it (a queue of 8 behind its 8
    slots), with the layer at its defaults (``PERF_OBS=1 FLIGHT_RING=256
    TRACE=0``) and no fault, its loop warmed but not the wave's start
    graphs.  A cold drive captures the wave's start graph inside its
    guarded prefill; a warm drive follows; each with CUDA events around
    every replay (the estimator's busy against the events' and the drive's
    capture seconds, printed; the warm drive's every token teacher-forced
    and its event busy <= estimated busy <= wall).  Then OBSERVE_AB_PAIRS
    pairs of drives of two waves each, on, off, off, on, ..., the layer
    switched at run time between them (``observe_switch``): tokens/s of each
    (printed, no gate).  Returns the K3 launches of its drives."""
    import statistics

    import torch

    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    label = "serve llama observe cost"
    device = "cpu" if rehearsal else "cuda"
    cfg, bundle, engine, batcher = build_service(
        {**observe_overrides(device, rehearsal, len(params["layers"])), **LAYER_DEFAULT,
         "MAX_STREAM_QUEUE": "8"},
        params=params)
    try:
        batcher.warm_streams()
        loop = batcher._cdl
        k3 = paged_decode_attention.launches
        drives = {}
        for name in ("cold", "warm"):
            perf0, captures0 = engine.perf.snapshot(), graph_captures(engine)
            events, stop_events = replay_events(not rehearsal)
            try:
                feats, rows, wall = observe_drive(loop, bundle, items)
            finally:
                stop_events()
            if not rehearsal:
                torch.cuda.synchronize()
            perf1, captures1 = engine.perf.snapshot(), graph_captures(engine)
            busy = perf1["device_busy_total_s"] - perf0["device_busy_total_s"]
            event_busy = sum(a.elapsed_time(b) for a, b in events) / 1e3
            drives[name] = {"wall_s": wall, "estimated_busy_s": busy,
                            "event_busy_s": event_busy, "busy_gap_s": busy - event_busy,
                            "replays": len(events), "captures": captures1[0] - captures0[0],
                            "capture_s": captures1[1] - captures0[1],
                            "pending_after": perf1["pending_dispatches"],
                            "rows_as_off": sum(a == b for a, b in zip(rows, off_rows))}
        # No fault here: rows may part from the faulted runs' after their
        # recast (bf16, ROADMAP C9); every token is held to the reference.
        check = teacher_forced(bundle, ref_model, feats, rows, engine.max_decode_len)
        warm = drives["warm"]
        warm["teacher_forced"] = {k: check[k] for k in ("worst_gap", "tol",
                                                        "sampled_worst_gap_over_tol")}
        if not rehearsal and (drives["cold"]["captures"] == 0 or warm["captures"]):
            raise AssertionError(f"{label}: captures cold {drives['cold']['captures']}, "
                                 f"warm {warm['captures']}")
        if not rehearsal and not (warm["event_busy_s"] <= warm["estimated_busy_s"]
                                  <= warm["wall_s"]):
            raise AssertionError(f"{label}: warm drive CUDA-event busy "
                                 f"{warm['event_busy_s']:.4f} s, estimated "
                                 f"{warm['estimated_busy_s']:.4f} s, wall {warm['wall_s']:.4f} s")
        emit(label, card=card_line, layer=LAYER_DEFAULT, drives=drives)
        ab = {"on": [], "off": []}
        for i in range(2 * OBSERVE_AB_PAIRS):
            on = i % 4 in (0, 3)
            observe_switch(engine, on)
            _, rows, wall = observe_drive(loop, bundle, items * 2)  # two waves
            ab["on" if on else "off"].append(sum(len(r) for r in rows) / wall)
        observe_switch(engine, True)
        on_med, off_med = statistics.median(ab["on"]), statistics.median(ab["off"])
        emit(label, card=card_line, tokens_per_s_on=ab["on"], tokens_per_s_off=ab["off"],
             median_on=on_med, median_off=off_med, on_over_off=on_med / off_med)
        return {"paged_decode_attention": paged_decode_attention.launches - k3}
    finally:
        observe_switch(engine, True)
        asyncio.run(batcher.stop())  # joins the loop's thread
        if not rehearsal:
            release(bundle)


def observe_main(rehearsal: bool) -> int:
    """``--observe``: the build and 8j alone, TinyLlama at full width (the
    rehearsal's small llama on the CPU, no build).  Prints no result line."""
    import torch

    phase = "env"
    try:
        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="observe")
        if not rehearsal:
            phase = "build"
            phase_build()
        from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
        from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

        device = "cpu" if rehearsal else "cuda"
        cfg = llama_mod.LlamaConfig(**(REHEARSAL_LLAMA if rehearsal else {}), eos_id=1, pad_id=0)
        params = llama_pytree(cfg, seed=0)
        ref = llama_mod.build_model(cfg, llama_params_from_jax(params, cfg), torch.device(device),
                                    torch.float32)
        phase = "serve llama observe"
        phase_serve_observe(params, ref, rehearsal, card_line)
    except Exception as e:
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    return 0


# Durable serving (8k): TinyLlama from child processes of the port's serve
# entry, one killed with SIGKILL mid-traffic and a second on its JOURNAL_DIR.
DURABLE_WORDS = ["journal", "resume", "disk", "restart", "cursor", "replay", "block", "tier"]
DURABLE_BUDGET = 128  # tokens a stream asks for (the children's MAX_DECODE_LEN)
DURABLE_MIN_TOKENS = 8  # each stream's cursor before the kill
DURABLE_LINES, DURABLE_LINE_TOKENS, DURABLE_LINES_DONE = 8, 32, 2
DURABLE_TIMEOUT_S = 240.0


def durable_texts(n: int, length: int, seed: int) -> list[str]:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(DURABLE_WORDS, size=length))[:length] for _ in range(n)]


def durable_env(device: str, rehearsal: bool, jd: str, ckpt: str, port: int,
                layers: int | None = None) -> dict:
    """A child's environment: TinyLlama from the checkpoint (at ``layers``
    when given), paged (16-token blocks, 4 slots, one batch bucket of 4 and
    one seq bucket of 256, 128 tokens in chunks of 4), the host and disk
    tiers, the journal (fsync always) and the job lane."""
    env = {k: v for k, v in os.environ.items()}
    env.update({"MODEL_NAME": "llama", "DEVICE": device, "MODEL_PATH": ckpt,
                "PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "4",
                "BATCH_BUCKETS": "4", "SEQ_BUCKETS": "256",
                "MAX_DECODE_LEN": str(DURABLE_BUDGET), "STREAM_CHUNK_TOKENS": "4",
                "MAX_STREAM_QUEUE": "16", "KV_HOST_BUDGET_MB": "256",
                "KV_DISK_BUDGET_MB": "256", "JOURNAL_DIR": jd, "JOURNAL_FSYNC": "always",
                "JOBS_ENABLED": "1", "HOST": "127.0.0.1", "PORT": str(port),
                "WARMUP": "1", "LOG_LEVEL": "INFO"})
    if rehearsal:
        env.update(LLAMA_CONFIG=json.dumps(REHEARSAL_LLAMA), SEQ_BUCKETS="64",
                   MAX_DECODE_LEN="48", WARMUP="0")
    elif layers is not None:
        env["LLAMA_CONFIG"] = json.dumps({"num_layers": layers})
    return env


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def durable_child(env: dict, log_path: str) -> subprocess.Popen:
    """``python -m mlmicroservicetemplate_tpu_torch.serve`` in a session of
    its own (so a kill reaches nothing else), its output to ``log_path``."""
    log = open(log_path, "ab")
    try:
        return subprocess.Popen([sys.executable, "-m", "mlmicroservicetemplate_tpu_torch.serve"],
                                env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    finally:
        log.close()


def stop_child(proc: subprocess.Popen, sig=None) -> None:
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, sig or signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)


def http_call(method: str, url: str, body=None, headers=None, timeout: float = 120.0,
              raw: bool = False):
    """(status, JSON body or text) over loopback; an HTTP error's status too."""
    import urllib.error
    import urllib.request

    data = None
    hdrs = dict(headers or {})
    if isinstance(body, (dict, list)):
        data = json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    elif isinstance(body, str):
        data = body.encode()
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            text = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as e:
        text, status = e.read().decode(), e.code
    if raw:
        return status, text
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def wait_ready(base: str, proc: subprocess.Popen, log_path: str,
               timeout: float = DURABLE_TIMEOUT_S) -> float:
    """Seconds until ``/readyz`` answers 200."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"the child exited ({proc.returncode}): "
                                 f"{open(log_path).read()[-3000:]}")
        try:
            if http_call("GET", base + "/readyz", timeout=2)[0] == 200:
                return time.monotonic() - t0
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"the child was not ready in {timeout} s: "
                         f"{open(log_path).read()[-3000:]}")


class StreamRead:
    """One streamed ``/predict`` read on a thread, line by line (it ends
    with an error when its server is killed)."""

    def __init__(self, url: str, body: dict, headers: dict):
        import threading

        self.lines: list = []
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(url, body, headers), daemon=True)
        self.thread.start()

    def _run(self, url, body, headers):
        import urllib.request

        req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json", **headers})
        try:
            with urllib.request.urlopen(req, timeout=DURABLE_TIMEOUT_S) as resp:
                for ln in resp:
                    if ln.strip():
                        self.lines.append(json.loads(ln))
        except Exception as e:  # the kill cuts the connection
            self.error = f"{type(e).__name__}: {e}"


def journal_view(jd: str) -> dict:
    """The stream journal's state read from its segments, without opening
    it (its server holds the lock): rid -> tokens, done, admission."""
    from mlmicroservicetemplate_tpu_torch.runtime.durability import read_frames

    out: dict = {}
    names = sorted(n for n in os.listdir(jd) if n.startswith("wal-") and n.endswith(".log"))
    for name in names:
        frames, _ = read_frames(os.path.join(jd, name))
        for payload in frames:
            rec = json.loads(payload)
            rid, k = rec.get("rid"), rec.get("k")
            if k == "admit":
                out[rid] = {"tokens": list(rec.get("delivered", [])), "done": False,
                            "budget": rec.get("budget"), "feats": rec.get("feats")}
            elif k == "tokens" and rid in out:
                out[rid]["tokens"].extend(rec["t"])
            elif k == "done" and rid in out:
                out[rid]["done"] = True
    return out


def disk_stream_keys(jd: str) -> set:
    """Request ids whose checkpoint the disk tier's index holds."""
    from mlmicroservicetemplate_tpu_torch.runtime.durability import read_frames

    live = set()
    frames, _ = read_frames(os.path.join(jd, "kv_disk", "index.log"))
    for payload in frames:
        rec = json.loads(payload)
        key = rec.get("key")
        if not (isinstance(key, list) and key and key[0] == "s"):
            continue
        if rec.get("op") == "put":
            live.add(key[1])
        elif rec.get("op") == "del":
            live.discard(key[1])
    return live


def job_view(jd: str) -> dict:
    """jid -> {i: result row} read from the job store's segments."""
    from mlmicroservicetemplate_tpu_torch.runtime.durability import read_frames

    out: dict = {}
    d = os.path.join(jd, "jobs")
    if not os.path.isdir(d):
        return out
    for name in sorted(n for n in os.listdir(d) if n.startswith("jobs-")):
        frames, _ = read_frames(os.path.join(d, name))
        for payload in frames:
            rec = json.loads(payload)
            if rec.get("k") == "job":
                out.setdefault(rec["id"], {})
            elif rec.get("k") == "line":
                out.setdefault(rec["id"], {})[int(rec["i"])] = {
                    k: rec.get(k) for k in ("text", "tokens", "finish", "error")}
    return out


def until(what: str, cond, timeout: float = DURABLE_TIMEOUT_S, poll: float = 0.01):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        got = cond()
        if got:
            return got
        time.sleep(poll)
    raise AssertionError(f"serve llama durable: {what} never held in {timeout} s")


def histogram_quantiles(metrics_text: str, name: str, qs=(0.5, 0.99)) -> dict:
    """Quantiles of a Prometheus histogram from its cumulative buckets (each
    the upper edge of the bucket the rank falls in), and its count."""
    buckets, count = [], 0.0
    for ln in metrics_text.splitlines():
        m = re.match(name + r'_bucket\{[^}]*le="([^"]+)"[^}]*\}\s+([0-9.e+-]+)', ln)
        if m:
            buckets.append((float(m.group(1)), float(m.group(2))))
        m = re.match(name + r"_count\{[^}]*\}\s+([0-9.e+-]+)", ln)
        if m:
            count = float(m.group(1))
    out = {"count": int(count)}
    for q in qs:
        edge = next((le for le, c in sorted(buckets) if count and c >= q * count), None)
        out[f"p{int(q * 100)}_s_at_most"] = edge
    return out


def kernel_book(perf: dict, name: str) -> tuple[int, int]:
    """(the process's launch counter of ``name``, what its graphs' replays
    account for: each graph's replays and its capture's eager run, times its
    launches a replay)."""
    k = perf["kernels"]
    replayed = sum((g["replays"] + 1) * g["launches"].get(name, 0) for g in k["graphs"])
    return k["launches"].get(name, 0), replayed


def child_log(path: str, t_spawn: float, keep: int = 30) -> list[str]:
    """A child's log lines (the serve entry logs a few dozen at INFO), each
    with its seconds after the child was spawned (``t_spawn``, wall clock)
    instead of the clock."""
    import datetime

    out, t0 = [], t_spawn
    with open(path, errors="replace") as f:
        for ln in f:
            ln = ln.rstrip()
            m = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) (.*)", ln)
            if not m:
                continue
            t = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
            out.append(f"+{t - t0:.2f}s {m.group(2)[:200]}")
    return out[:keep]


def write_durable_checkpoint(cfg, params, path: str) -> float:
    """TinyLlama's seed-0 weights (f32, the port's names) as the converter
    writes a checkpoint directory, which ``MODEL_PATH`` loads."""
    from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
    from mlmicroservicetemplate_tpu_torch.models.checkpoint import save_checkpoint

    t0 = time.monotonic()
    save_checkpoint(path, "llama", cfg.num_layers, llama_params_from_jax(params, cfg))
    return time.monotonic() - t0


def disk_rung_timing(engine, n_blocks: int, reps: int = 3) -> dict:
    """One write-through (``KVDiskTier.put`` of ``n_blocks`` of the pool's
    layout, as the loop's swap-out lands) and one disk -> host -> device
    prefetch (``read_into`` the host pool's pinned buffers, then the copy
    into device blocks), best of ``reps``, on a tier under a temporary
    directory."""
    import tempfile

    import torch

    from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import HostBlockPool
    from mlmicroservicetemplate_tpu_torch.runtime.durability import KVDiskTier

    cfg = engine.bundle.cfg
    dtype = engine.bundle.policy.compute_dtype
    spec = ((PAGE, cfg.num_kv_heads, cfg.head_dim), dtype)
    specs = [spec] * (2 * cfg.num_layers)
    bb = engine.kv_block_bytes()
    dev = engine.device
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disk_") as d:
        tier = KVDiskTier(2 * n_blocks * bb / 1e6 + 1, bb, d)
        tier.attach(specs)
        host = HostBlockPool(n_blocks, bb, specs, pin=dev.type == "cuda")
        dev_leaves = [torch.empty((n_blocks,) + spec[0], dtype=dtype, device=dev)
                      for _ in specs]
        vals = [torch.randn((n_blocks,) + spec[0]).to(dtype) for _ in specs]
        put_s, pre_s = [], []
        for i in range(reps):
            t0 = time.perf_counter()
            entry = tier.put(("stream", f"t{i}"), n_blocks * PAGE, "stream", vals)
            put_s.append(time.perf_counter() - t0)
            ids = list(range(n_blocks))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            tier.pool.read_into(entry.ids, host, ids)
            for leaf, buf in zip(dev_leaves, host.leaves):
                leaf.copy_(buf, non_blocking=True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            pre_s.append(time.perf_counter() - t0)
            tier.release(entry)
        same = all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.cpu().view(torch.int16) if b.dtype == torch.bfloat16
                               else b.cpu())
                   for a, b in zip(vals, dev_leaves))
        tier.close()
    nbytes = n_blocks * bb
    if not same:
        raise AssertionError("serve llama durable: the disk round trip changed the blocks")
    return {"blocks": n_blocks, "bytes": nbytes, "write_through_ms": min(put_s) * 1e3,
            "write_through_gb_s": nbytes / min(put_s) / 1e9,
            "prefetch_ms": min(pre_s) * 1e3, "bit_equal": same,
            "read": "warm (page cache)"}


def durable_service(params, device: str, rehearsal: bool, layers: int | None):
    """The children's service in this process (no journal, no tiers): the
    teacher-forcing bundle, the uninterrupted run and the journal's A/B."""
    from mlmicroservicetemplate_tpu_torch.serve import build_service

    env = durable_env(device, rehearsal, "", "", 0, layers)
    ov = {k: env[k] for k in ("MODEL_NAME", "DEVICE", "PAGED_KV", "KV_BLOCK_SIZE",
                              "MAX_STREAMS", "BATCH_BUCKETS", "SEQ_BUCKETS", "MAX_DECODE_LEN",
                              "STREAM_CHUNK_TOKENS", "MAX_STREAM_QUEUE", "WARMUP")}
    if "LLAMA_CONFIG" in env:
        ov["LLAMA_CONFIG"] = env["LLAMA_CONFIG"]
    cfg, bundle, engine, batcher = build_service(ov, params=params)
    if cfg.warmup:
        batcher.warm_engine()
    batcher.warm_streams()
    return cfg, bundle, engine, batcher


def durable_drive(loop, feats) -> tuple[list, float]:
    """The streams as one wave through ``loop``; (rows, wall seconds)."""
    async def read(gen):
        return [int(x) async for chunk in gen for x in chunk]

    async def main():
        loop._ensure_thread = lambda: None
        try:
            gens = [loop.submit_stream(dict(f)) for f in feats]
        finally:
            del loop._ensure_thread
        loop._ensure_thread()
        return await asyncio.gather(*(read(g) for g in gens))

    t0 = time.perf_counter()
    rows = asyncio.run(main())
    return rows, time.perf_counter() - t0


def phase_serve_durable(params, ref_model, rehearsal: bool, card_line: str,
                        beside=None) -> dict:
    """8k (the module docstring has the gates), at the depth of ``params``
    (TinyLlama's 22 layers, or the main run's ``CUT_LAYERS``); ``beside``
    (a phase that times nothing on the card) runs while the first child
    boots.  Returns K3's launches: the children's (A's read just before
    its kill) and this process's drives."""
    import signal
    import tempfile

    import torch

    from mlmicroservicetemplate_tpu_torch.engine.kv_blocks import blocks_for
    from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod
    from mlmicroservicetemplate_tpu_torch.models.registry import RawItem
    from mlmicroservicetemplate_tpu_torch.ops.paged_attention import paged_decode_attention
    from mlmicroservicetemplate_tpu_torch.runtime.durability import StreamJournal

    label = "serve llama durable"
    device = "cpu" if rehearsal else "cuda"
    layers = len(params["layers"])
    dims = REHEARSAL_LLAMA if rehearsal else {"num_layers": layers}
    cfg = llama_mod.LlamaConfig(**dims, eos_id=1, pad_id=0)
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    ckpt, jd = os.path.join(root, "ckpt"), os.path.join(root, "journal")
    ckpt_s = write_durable_checkpoint(cfg, params, ckpt)
    prompt_len = 40 if rehearsal else 200
    texts = durable_texts(4, prompt_len, seed=11)
    sampling = dict(temperature=0.8, top_k=40, seed=2026)
    streams = [{"text": t, "max_tokens": DURABLE_BUDGET, "stream": True} for t in texts]
    streams[0].update(sampling)  # the sampled one, batch class: the checkpoint's victim
    rids = [f"durable-{i}" for i in range(4)]
    lines = [{"text": t, "max_tokens": DURABLE_LINE_TOKENS}
             for t in durable_texts(DURABLE_LINES, 20, seed=12)]
    unary = {"text": "the journal answers a retry", "max_tokens": 16}
    procs = []
    k3_children = 0
    try:
        # -- child A: the traffic, then SIGKILL -----------------------------
        port_a = free_port()
        base_a = f"http://127.0.0.1:{port_a}"
        log_a = os.path.join(root, "a.log")
        t_wall_a = time.time()
        a = durable_child(durable_env(device, rehearsal, jd, ckpt, port_a, layers), log_a)
        procs.append(a)
        # This process's service (the uninterrupted run, the teacher-forcing
        # bundle, the journal's A/B) builds and warms while A boots; its
        # timed drives come once no child runs.
        service = durable_service(params, device, rehearsal, layers)
        if beside is not None:
            beside()
        ready_a = wait_ready(base_a, a, log_a)
        reads = [StreamRead(base_a + "/predict", streams[0],
                            {"X-Request-Id": rids[0], "X-Priority": "batch"})]
        status, job = http_call("POST", base_a + "/v1/batches", {"lines": lines})
        if status != 201:
            raise AssertionError(f"{label}: job submit {status} {job}")
        status, unary_a = http_call("POST", base_a + "/predict", unary,
                                    {"X-Request-Id": "durable-unary"})
        if status != 200:
            raise AssertionError(f"{label}: /predict {status} {unary_a}")
        until("the batch stream's 8 tokens and 2 job lines", lambda: (
            len(journal_view(jd).get(rids[0], {}).get("tokens", ())) >= DURABLE_MIN_TOKENS
            and len(job_view(jd).get(job["id"], {})) >= DURABLE_LINES_DONE))
        # The interactive arrivals find every slot busy with batch work: the
        # preemption checkpoints the batch stream (the oldest batch holder),
        # its blocks swap out to the host and write through to disk.
        for i in range(1, 4):
            reads.append(StreamRead(base_a + "/predict", streams[i], {"X-Request-Id": rids[i]}))

        def kill_gate():
            view = journal_view(jd)
            return (all(len(view.get(r, {}).get("tokens", ())) >= DURABLE_MIN_TOKENS
                        for r in rids)
                    and rids[0] in disk_stream_keys(jd)
                    and len(job_view(jd).get(job["id"], {})) >= DURABLE_LINES_DONE)

        until("the kill gate (every stream 8 tokens, a checkpoint on disk, 2 lines)",
              kill_gate)
        perf_a = http_call("GET", base_a + "/debug/perf?kernels=1", timeout=30)[1]
        metrics_a = http_call("GET", base_a + "/metrics", timeout=30, raw=True)[1]
        os.killpg(a.pid, signal.SIGKILL)
        a.wait(30)
        at_kill = journal_view(jd)
        lines_at_kill = job_view(jd).get(job["id"], {})
        k3_a, k3_a_replayed = kernel_book(perf_a, "paged_decode_attention")
        k3_children += k3_a
        incomplete = [r for r in rids if not at_kill[r]["done"]]
        if rids[0] not in incomplete or len(incomplete) < 2:
            raise AssertionError(f"{label}: at the kill {incomplete} were incomplete")
        # The journal's replay, timed on a copy (the open compacts it).
        import shutil

        copy = os.path.join(root, "journal-copy")
        shutil.copytree(jd, copy, ignore=shutil.ignore_patterns("kv_disk", "jobs", ".lock"))
        t0 = time.perf_counter()
        StreamJournal(copy, fsync="off").close()
        replay_ms = (time.perf_counter() - t0) * 1e3

        # -- child B on the same directory ---------------------------------
        port_b = free_port()
        base_b = f"http://127.0.0.1:{port_b}"
        log_b = os.path.join(root, "b.log")
        t_spawn_b, t_wall_b = time.monotonic(), time.time()
        b = durable_child(durable_env(device, rehearsal, jd, ckpt, port_b, layers), log_b)
        procs.append(b)
        ready_b = wait_ready(base_b, b, log_b)

        def resumed():
            view = journal_view(jd)
            return any(len(view.get(r, {}).get("tokens", ())) > len(at_kill[r]["tokens"])
                       for r in incomplete)

        until("a resumed token", resumed, poll=0.002)
        first_token_s = time.monotonic() - t_spawn_b
        attach = {}
        for r in rids:
            st, text = http_call("GET", f"{base_b}/v1/streams/{r}", raw=True)
            attach[r] = (st, [json.loads(x) for x in text.splitlines() if x.strip()])
        final_job = until("the job's completion", lambda: (
            lambda s: s if s[1].get("status") == "completed" else None)(
                http_call("GET", f"{base_b}/v1/batches/{job['id']}")), poll=0.05)[1]
        results = {r["line"]: r for r in (json.loads(x) for x in http_call(
            "GET", f"{base_b}/v1/batches/{job['id']}/results", raw=True)[1].splitlines()
            if x.strip())}
        interactive = []
        for ln in lines:
            st, text = http_call("POST", base_b + "/predict", {**ln, "stream": True}, raw=True)
            last = [json.loads(x) for x in text.splitlines() if x.strip()][-1]
            interactive.append((last["prediction"]["text"], last["tokens_generated"],
                                last["finish_reason"]))
        until("the pool's drain", lambda: http_call("GET", base_b + "/status")[1]
              ["scheduler"]["kv_committed_bytes"] == 0, poll=0.05)
        status_b0 = http_call("GET", base_b + "/status")[1]
        st, unary_b = http_call("POST", base_b + "/predict", unary,
                                {"X-Request-Id": "durable-unary"})
        status_b = http_call("GET", base_b + "/status")[1]
        perf_b = http_call("GET", base_b + "/debug/perf?kernels=1")[1]
        metrics_b = http_call("GET", base_b + "/metrics", raw=True)[1]
        stop_child(b)
        view_b = journal_view(jd)
        k3_b, k3_b_replayed = kernel_book(perf_b, "paged_decode_attention")
        k3_children += k3_b
    finally:
        for p in procs:
            stop_child(p, signal.SIGKILL)

    # -- the gates ---------------------------------------------------------
    fails = []
    for r in rids:
        got, pre = view_b[r]["tokens"], at_kill[r]["tokens"]
        st, body = attach[r]
        eos = cfg.eos_id in got
        if (got[: len(pre)] != pre or not view_b[r]["done"]
                or (len(got) != at_kill[r]["budget"] and not eos)):
            fails.append(f"{r}: {len(pre)} tokens at the kill, {len(got)} after")
        if st != 200 or not body or body[-1].get("tokens_generated") != len(got) - (
                1 if eos else 0):
            fails.append(f"{r}: /v1/streams {st} {body[-1:]}")
    lines_b = {i: (row["text"], row["tokens"], row["finish_reason"]) for i, row in results.items()}
    if (final_job["line_counts"] != {"total": DURABLE_LINES, "completed": DURABLE_LINES,
                                     "failed": 0}
            or [lines_b[i] for i in range(DURABLE_LINES)] != interactive):
        fails.append(f"job {final_job} results {lines_b} interactive {interactive}")
    for i, row in lines_at_kill.items():
        if (row["text"], row["tokens"], row["finish"]) != lines_b[i]:
            fails.append(f"job line {i} ran again: {row} then {lines_b[i]}")
    jobs_b = status_b["jobs"]
    if jobs_b["records_written"] != DURABLE_LINES - len(lines_at_kill) + 1:
        fails.append(f"job store appended {jobs_b['records_written']} records for "
                     f"{DURABLE_LINES - len(lines_at_kill)} lines")
    disk = status_b["durability"]["kv_disk"]
    tier = status_b.get("kv_tier", {})
    if disk["promotes"] < 1 or tier.get("swap_resumes", 0) < 1 or tier.get("swap_fallbacks"):
        fails.append(f"disk rung: kv_disk {disk}, kv_tier {tier}")
    batch0 = status_b0["decode"]["dispatch_counts"].get("batch", 0)
    if (st != 200 or unary_b["prediction"] != unary_a["prediction"]
            or status_b["decode"]["dispatch_counts"].get("batch", 0) != batch0):
        fails.append(f"/predict retry {st} {unary_b} (first {unary_a}), batch dispatches "
                     f"{batch0} -> {status_b['decode']['dispatch_counts'].get('batch')}")
    if k3_b != k3_b_replayed or k3_a != k3_a_replayed or (k3_b == 0) != rehearsal:
        fails.append(f"K3 launches: B {k3_b} against its replays' {k3_b_replayed}, A {k3_a} "
                     f"against {k3_a_replayed}")
    if status_b["scheduler"]["kv_committed_bytes"] != 0:
        fails.append(f"pool not drained: {status_b['scheduler']}")
    if fails:
        raise AssertionError(f"{label}: " + "; ".join(fails))

    # -- the uninterrupted run in this process, and the journal's A/B ---------
    k3_0 = paged_decode_attention.launches
    scfg, bundle, engine, batcher = service
    loop = batcher._cdl
    feats = [bundle.preprocess(RawItem(text=s["text"], max_tokens=DURABLE_BUDGET,
                                       **{key: s[key] for key in sampling if key in s}))
             for s in streams]
    for f, r in zip(feats, rids):
        f["request_id"] = r
    clean, plain_s = durable_drive(loop, feats)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_journal_") as d:
        engine.journal = StreamJournal(d, fsync="always", model="llama")
        try:
            journaled, journal_s = durable_drive(loop, feats)
        finally:
            engine.journal.close()
            engine.journal = None
    k3_here = paged_decode_attention.launches - k3_0
    got_rows = [view_b[r]["tokens"] for r in rids]
    try:
        check = teacher_forced(bundle, ref_model, feats, clean, engine.max_decode_len)
        tokens = same_tokens(label, bundle, ref_model, feats, clean, got_rows, check["tol"],
                             engine.max_decode_len)
        rung = disk_rung_timing(engine, blocks_for(len(feats[0]["input_ids"]), PAGE))
    finally:
        if not rehearsal:
            release(bundle)
    n_tok = sum(len(r) for r in clean)
    emit(f"{label} children", a=child_log(log_a, t_wall_a), b=child_log(log_b, t_wall_b))
    emit(label, card=card_line, layers=cfg.num_layers, checkpoint_write_s=ckpt_s,
         ready_a_s=ready_a, restart_to_ready_s=ready_b, journal_replay_ms=replay_ms,
         restart_to_first_resumed_token_s=first_token_s,
         at_kill={r: len(at_kill[r]["tokens"]) for r in rids},
         incomplete_at_kill=incomplete, job_lines_at_kill=sorted(lines_at_kill),
         tokens=tokens, identical_to_journaled_drive=journaled == clean,
         kv_disk=disk, kv_tier=tier, jobs=jobs_b,
         journal=status_b["durability"]["journal"],
         k3={"a": k3_a, "b": k3_b, "b_replays_account": k3_b_replayed, "here": k3_here},
         disk_rung=rung,
         fsync_a=histogram_quantiles(metrics_a, "journal_fsync_seconds"),
         fsync_b=histogram_quantiles(metrics_b, "journal_fsync_seconds"),
         tokens_per_s_plain=n_tok / plain_s, tokens_per_s_journaled=n_tok / journal_s,
         journal_fsync="always")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return {"paged_decode_attention": k3_children + k3_here}


def durable_main(rehearsal: bool) -> int:
    """``--durable``: the build and 8k alone, TinyLlama at full width (the
    rehearsal's small llama on the CPU, no build).  Prints no result line."""
    import torch

    phase = "env"
    try:
        if not rehearsal and not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 1
        card_line = "cpu (rehearsal)" if rehearsal else card()
        emit(phase, card=card_line, torch=torch.__version__, cuda=torch.version.cuda,
             mode="durable")
        if not rehearsal:
            phase = "build"
            phase_build()
        from mlmicroservicetemplate_tpu_torch.convert.jax_params import llama_params_from_jax
        from mlmicroservicetemplate_tpu_torch.models import llama as llama_mod

        device = "cpu" if rehearsal else "cuda"
        cfg = llama_mod.LlamaConfig(**(REHEARSAL_LLAMA if rehearsal else {}), eos_id=1, pad_id=0)
        params = llama_pytree(cfg, seed=0)
        ref = llama_mod.build_model(cfg, llama_params_from_jax(params, cfg), torch.device(device),
                                    torch.float32)
        phase = "serve llama durable"
        phase_serve_durable(params, ref, rehearsal, card_line)
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
    ap.add_argument("--chunked", action="store_true",
                    help="only the build and the two chunked-prefill phases")
    ap.add_argument("--tier", action="store_true",
                    help="only the build and the host KV tier's phase")
    ap.add_argument("--window", action="store_true",
                    help="only the build and the two fused decode-window phases")
    ap.add_argument("--pipeline", action="store_true",
                    help="only the build and the dispatch pipeline's phase")
    ap.add_argument("--spec", action="store_true",
                    help="only the build and the speculative decoding phase")
    ap.add_argument("--quant", action="store_true",
                    help="only the build and the QUANTIZE=int8 phase")
    ap.add_argument("--lora", action="store_true",
                    help="only the build and the LoRA adapters phase")
    ap.add_argument("--faults", action="store_true",
                    help="only the build, the faults and tuning phase and the converter's")
    ap.add_argument("--observe", action="store_true",
                    help="only the build and the observability phase")
    ap.add_argument("--tenants", action="store_true",
                    help="only the build and the tenant accounts and fair-share phase")
    ap.add_argument("--durable", action="store_true",
                    help="only the build and the durable-serving phase")
    args = ap.parse_args(argv)
    if args.perf:
        return perf_main()
    if args.chunked:
        return chunked_main()
    if args.tier:
        return tier_main()
    if args.window:
        return window_main(args.cpu_rehearsal)
    if args.pipeline:
        return pipeline_main(args.cpu_rehearsal)
    if args.spec:
        return spec_main(args.cpu_rehearsal)
    if args.quant or args.lora:
        return weight_main("quant" if args.quant else "lora", args.cpu_rehearsal)
    if args.faults:
        return faults_main(args.cpu_rehearsal)
    if args.observe:
        return observe_main(args.cpu_rehearsal)
    if args.durable:
        return durable_main(args.cpu_rehearsal)
    if args.tenants:
        return weight_main("tenants", args.cpu_rehearsal)
    rehearsal = args.cpu_rehearsal
    t_start = time.monotonic()
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
        grid = {} if rehearsal else CUT_GRID
        llama_svc = phase_serve_gen(phase, {**llama_overrides, **grid}, params, ref_model,
                                    rehearsal, card_line)
        phase = "graphs llama"
        graphs("llama", llama_svc[1], llama_svc[4],
               graph_vs_eager=lambda: tokens_graph_vs_eager(llama_svc[2], llama_svc[5][-16:]))
        # The int8 services and the contiguous loop run at CUT_LAYERS layers
        # (8g and 8h drive TinyLlama's 22), on the first CUT_LAYERS layers of
        # the weights above, and the int8 and loop services on CUT_GRID: a
        # llama service's warmup captures 80 graphs on the whole grid, and
        # the run must stay within its time limit.
        cut = {**dims, "num_layers": CUT_LAYERS} if not rehearsal else dims
        ccfg = llama_mod.LlamaConfig(**cut, eos_id=1, pad_id=0)
        cparams = {**params, "layers": params["layers"][:ccfg.num_layers]}
        cref = llama_mod.build_model(ccfg, llama_params_from_jax(cparams, ccfg),
                                     torch.device(device), torch.float32)
        cut_overrides = {**llama_overrides, "LLAMA_CONFIG": json.dumps(cut)}
        phase = "serve llama int8"
        llama8 = phase_serve_gen(phase, {**cut_overrides, **grid, "QUANT_KV": "int8"}, cparams,
                                 cref, rehearsal, card_line)
        llama8_launches = llama8[3]
        phase = "graphs llama int8"
        graphs("llama int8", llama8[1], llama8[4],
               graph_vs_eager=lambda: tokens_graph_vs_eager(llama8[2], llama8[5][-16:]))
        release(llama8[1])
        del llama8
        # Streaming through the continuous decode loop: paged (dense, int8),
        # then contiguous slots, all at CUT_LAYERS layers: the prefix phase
        # below drives the paged loop at full depth (and times its chunk).
        stream = {"PAGED_KV": "1", "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "16",
                  "MAX_DECODE_LEN": "64"}
        k2_streams = k3_streams = 0
        stream_svc = None
        # The int8 loop runs unwarmed: its chunks are captured at the first
        # admission, before any slot is live.
        for phase, extra, warm_loop, weights in (
                ("serve llama stream", {}, True, (cut_overrides, cparams, cref)),
                ("serve llama stream int8", {"QUANT_KV": "int8"}, False,
                 (cut_overrides, cparams, cref)),
                ("serve llama stream contiguous", {"PAGED_KV": "0"}, True,
                 (cut_overrides, cparams, cref))):
            svc = phase_serve_stream(phase, {**weights[0], **stream, **grid, **extra},
                                     *weights[1:], rehearsal, card_line, warm_loop)
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
        # Priority classes at CUT_LAYERS layers: 16 batch streams over a pool
        # of 4 worst-case streams (KV_BUDGET_MB; the rehearsal's smaller
        # buckets take 7), then 8 interactive arrivals.  Batch buckets cut to
        # 1, 4 and 16 (a wave pads to one): warmup captures 48 graphs, not 80.
        phase = "serve llama classes"
        classes = phase_serve_classes(
            phase, {**cut_overrides, **stream, "BATCH_BUCKETS": "1,16",
                    "MAX_STREAM_QUEUE": "16", "PREEMPT": "1",
                    **({} if rehearsal else {"SEQ_BUCKETS": "32,256"})},
            cparams, cref, rehearsal, card_line, n_batch=16, n_inter=8, cap=28,
            budget_streams=7 if rehearsal else 4)
        k2_streams += classes[1].get("decode_attention", 0)
        k3_streams += classes[1].get("paged_decode_attention", 0)
        phase = "graphs llama classes"
        graphs("llama classes", classes[0], classes[2])
        release(classes[0])
        # The prefix cache at full depth over the paged loop: conversations,
        # a burst on one shared prefix (one grouped hit wave, K3 over tables
        # whose rows share its blocks), then 16 batch streams that each pin
        # 32 tokens hold every slot and 4 interactive arrivals preempt them:
        # the greedy victims recast into their own pins.  PREFIX_CACHE_MB
        # holds 16 pins of half the largest bucket.  The pool is the default
        # (16 worst-case streams): a pool small enough to stall growth would
        # evict every pin before it checkpointed a stream.
        # At CUT_LAYERS layers for the run's time (the chunked phase below
        # drives the paged loop at full depth and times its chunk).
        phase = "serve llama prefix"
        s_max = 64 if rehearsal else 256
        token_bytes = 2 * ccfg.num_layers * ccfg.num_kv_heads * ccfg.head_dim * (
            4 if rehearsal else 2)
        prefix = phase_serve_prefix(
            phase, {**cut_overrides, **stream, "BATCH_BUCKETS": "1,16",
                    "MAX_STREAM_QUEUE": "16", "PREEMPT": "1", "PREFIX_CACHE": "1",
                    "PREFIX_CACHE_MB": str(16 * (s_max // 2) * token_bytes / 1e6)},
            cparams, cref, prefix_steps(s_max, 4, 8, 16, 4), rehearsal, card_line,
            gates=("prefix_hit_waves", "peak_shared_blocks", "peak_shared_in_chunk",
                   "preemptions") + (() if rehearsal else ("recast_hits",)))
        k2_streams += prefix[1].get("decode_attention", 0)
        k3_streams += prefix[1].get("paged_decode_attention", 0)
        phase = "graphs llama prefix"
        graphs("llama prefix", prefix[0], prefix[2])
        release(prefix[0])
        # Chunked prefill over the paged loop with the prefix cache: short
        # interactive streams decode while three long prompts (past the
        # largest bucket) prefill in windows between their chunks, a fourth
        # hits the first one's prefix, and the default pool (16 worst-case
        # streams of the largest bucket) runs dry mid-prefill.  At
        # CUT_LAYERS layers, as the host tier below, for the run's time: 8g
        # and 8h drive TinyLlama at full depth.
        phase = "serve llama chunked"
        chunked = phase_serve_chunked(phase, {**cut_overrides, **stream,
                                              **chunked_llama(rehearsal),
                                              **({} if rehearsal else {"SEQ_BUCKETS": "64,256"})},
                                      cparams, cref, rehearsal, card_line)
        k2_streams += chunked[1].get("decode_attention", 0)
        k3_streams += chunked[1].get("paged_decode_attention", 0)
        phase = "graphs llama chunked"
        graphs("llama chunked", chunked[0], chunked[2])
        release(chunked[0])
        # The host KV tier over the paged loop with the three above:
        # conversations whose pins are demoted and come back, preempted
        # streams swapped out and prefetched back, and a long prompt
        # checkpointed mid-prefill that resumes partially.
        phase = "serve llama tier"
        tiered = phase_serve_tier(phase, {**cut_overrides, **stream, **tier_llama(rehearsal)},
                                  cparams, cref, rehearsal, card_line)
        k2_streams += tiered[1].get("decode_attention", 0)
        k3_streams += tiered[1].get("paged_decode_attention", 0)
        phase = "graphs llama tier"
        graphs("llama tier", tiered[0], tiered[2])
        release(tiered[0])
        # Fused decode windows over the paged loop at full depth (7g) run
        # behind ``--window`` (GPT-2's 8d keeps windows here); speculative
        # decoding per stream (8f) at CUT_LAYERS layers (``--spec`` at full
        # depth) for the run's time.
        phase = "serve spec llama"
        spec_k2 = spec_llama(cparams, cref, rehearsal, card_line, cut)
        if rehearsal:
            emit("decode step", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "decode step"
            phase_decode_step(llama_svc[1])
        # Weight int8 (8g) and LoRA adapters (8h) at CUT_LAYERS layers for
        # the run's time (``--quant`` and ``--lora`` keep 22).
        phase = "serve quantize"
        quant_launches = phase_serve_quant(cparams, ccfg, rehearsal, card_line)
        phase = "serve llama lora"
        lora_launches, lora_svc = phase_serve_lora(cparams, cref, ccfg, rehearsal, card_line,
                                                   keep=True)
        # Tenant accounts and fair share (8l) on 8h's warmed engine and its
        # adapter pool (``--tenants`` builds its own at 22 layers).
        phase = "serve llama tenants"
        tenant_launches = phase_serve_tenants(cparams, cref, ccfg, rehearsal, card_line,
                                              svc=lora_svc)
        del lora_svc
        # Faults, the watchdog, the supervisor and K3's autotuner (8i) at
        # full depth, then the converter CLI at GPT-2's full width.
        phase = "serve llama faults"
        fault_launches = phase_serve_faults(params, ref_model, rehearsal, card_line)
        del ref_model, params
        # Observability (8j) at CUT_LAYERS layers for the run's time (the
        # layer off and on, K1 in a BERT-base wave beside it, then its cost
        # at the defaults; ``--observe`` keeps 22).
        phase = "serve llama observe"
        observe_launches = phase_serve_observe(cparams, cref, rehearsal, card_line)
        # Durable serving (8k) at CUT_LAYERS layers (``--durable`` keeps
        # 22): child processes of the serve entry, one killed with SIGKILL,
        # a second resuming its journal.
        # The converter CLI at GPT-2's full width and CUT_LAYERS layers
        # (``--faults`` converts all 12), 8i's sticky-error child beside it,
        # both while 8k's first child boots.
        phase = "serve llama durable"
        durable_launches = phase_serve_durable(
            cparams, cref, rehearsal, card_line,
            beside=lambda: converter_and_sticky(card_line, rehearsal, CUT_LAYERS))
        del cref, cparams

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
        gpt2_svc = phase_serve_gen(phase, {**gpt2_overrides, **grid}, gparams, gref, rehearsal,
                                   card_line)
        phase = "graphs gpt2"
        graphs("gpt2", gpt2_svc[1], gpt2_svc[4],
               graph_vs_eager=lambda: tokens_graph_vs_eager(gpt2_svc[2], gpt2_svc[5][-16:]))
        gpt2_k2, gpt2_k3 = gpt2_svc[3], 0
        prefix_base = {**gpt2_overrides, "BATCH_BUCKETS": "1,4", "MAX_STREAMS": "4",
                       "MAX_DECODE_LEN": "16" if rehearsal else "64"}
        # Chunked prefill on the contiguous loop (slots as wide as the
        # position table) with the prefix cache: prompts of 300-900 tokens,
        # one a hit seeded into its job's state; against the whole service,
        # so at its 12 layers.
        phase = "serve gpt2 chunked"
        svc = phase_serve_gpt2_chunked(phase, {**prefix_base, **chunked_gpt2(rehearsal)},
                                       gparams, gref, gpt2_svc[2], rehearsal, card_line)
        gpt2_k2 += svc[1].get("decode_attention", 0)
        phase = "graphs gpt2 chunked"
        graphs("gpt2 chunked", svc[0], svc[2])
        release(svc[0])
        # Fused decode windows over the contiguous loop, AUTO off, a third
        # of the streams sampled and seeded (at 12 layers: its eos is picked
        # from a probe's streams).
        phase = "serve gpt2 window"
        ov, n = window_gpt2(rehearsal, device)
        gwin = phase_serve_window(phase, ov, gparams, gref, rehearsal, card_line, cap=4,
                                  auto=False, n_batch=n, n_inter=0, want_early_exit=False)
        gpt2_k2 += gwin["decode_attention_launches"]
        # The loop's dispatch pipeline over the paged loop: the serial order,
        # depth 3 with the staged host prep (and windows), the blocking
        # admission; lone requests at the tuned and the configured grace.
        phase = "serve gpt2 pipeline"
        ov, n, n_late = pipeline_gpt2(rehearsal, device)
        pipe_k2, pipe_k3 = phase_serve_pipeline(phase, ov, gparams, gref, rehearsal,
                                                card_line, n, n_late)
        gpt2_k2 += pipe_k2
        gpt2_k3 += pipe_k3
        # The loops, the prefix services and speculation at CUT_LAYERS layers
        # for the run's time: the first CUT_LAYERS layers of the same
        # weights.
        gcut = gpt_mod.GPTConfig(num_layers=CUT_LAYERS, eos_id=1, pad_id=0)
        cgparams = {**gparams, "layers": gparams["layers"][:CUT_LAYERS]}
        cgref = gpt_mod.build_model(gcut, gpt_params_from_jax(cgparams, gcut),
                                    torch.device(device), torch.float32)
        gpt2_stream = None
        with gpt2_layers(CUT_LAYERS):
            for phase, extra in (("serve gpt2 stream", {}),
                                 ("serve gpt2 stream contiguous", {"PAGED_KV": "0"})):
                svc = phase_serve_stream(phase, {**gpt2_overrides, **grid, "PAGED_KV": "1",
                                                 "KV_BLOCK_SIZE": str(PAGE), "MAX_STREAMS": "16",
                                                 "MAX_DECODE_LEN": "16" if rehearsal else "64",
                                                 **extra},
                                         cgparams, cgref, rehearsal, card_line)
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
            # The prefix cache on the contiguous loop (a conversation's solo
            # hits, a grouped burst), on the per-stream path
            # (CONTINUOUS_BATCHING=0: start_fused), then PROMPT_PREFIX, whole and
            # in the loop.
            s_max = 64 if rehearsal else 256
            for phase, extra, steps, gates, kw in (
                    ("serve gpt2 prefix", {"PREFIX_CACHE": "1"}, prefix_steps(s_max, 1, 4),
                     ("prefix_hit_waves",), {}),
                    ("serve gpt2 prefix per-stream",
                     {"PREFIX_CACHE": "1", "CONTINUOUS_BATCHING": "0", "BATCH_BUCKETS": "1"},
                     prefix_steps(s_max, 2, 0), (), {}),
                    ("serve gpt2 prompt prefix", {"PROMPT_PREFIX": GPT2_PROMPT_PREFIX},
                     [("whole", prompt_items(4, 2)), ("wave", prompt_items(4, 1))], (),
                     {"prompt_prefix": GPT2_PROMPT_PREFIX})):
                svc = phase_serve_prefix(phase, {**prefix_base, **extra}, cgparams, cgref, steps,
                                         rehearsal, card_line, gates=gates, **kw)
                gpt2_k2 += svc[1].get("decode_attention", 0)
                label = phase[len("serve "):]
                phase = f"graphs {label}"
                graphs(label, svc[0], svc[2])
                release(svc[0])
            # SPEC_CONTINUOUS in the contiguous loop (8f).
            phase = "serve spec gpt2 loop"
            spec_k2 += spec_gpt2(cgparams, cgref, rehearsal, card_line)
        del gref, gparams, cgref, cgparams
        if rehearsal:
            emit("decode step gpt2", skipped="cpu rehearsal: no card to profile")
        else:
            phase = "decode step gpt2"
            # B = 16 only, for the run's time.
            phase_decode_step(gpt2_svc[1], phase, batches=(16,), prompt=256,
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
        # Batch buckets 1, 8 and 32 by seq 64 and 512, for the run's time.
        t5_overrides = {"MODEL_NAME": "t5-small", "DEVICE": device, "BATCH_BUCKETS": "1,8,32",
                        "SEQ_BUCKETS": "64,512", "MAX_DECODE_LEN": "64",
                        "MAX_STREAMS": "16"}
        cut_seq, long_lens = "64", ((400, 420), (385, 400))
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
        # gen_chunk captured at first use, greedy and sampled: 4 misses), then every
        # stream with the loop off (B=1 buckets, all warmed).
        # The long prompts alone (the loop's waves on cut
        # buckets ran here too; `serve t5 stream` drives the loop), the
        # second sampled and seeded.
        long_wave = [t5_long_wave(rehearsal, n=i + 1, lengths=lens)[i]
                     for i, lens in enumerate(long_lens)]
        for phase, extra, waves, misses in (
                ("serve t5 long prompt", {"SEQ_BUCKETS": cut_seq, "BATCH_BUCKETS": "1"},
                 [long_wave], 4),
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
        # T5 per stream with speculation (8f): K1 in every spec start.
        phase = "serve spec t5"
        t5_k1 += spec_t5(tparams, tref, rehearsal, card_line)
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

    emit("total", seconds=time.monotonic() - t_start, card=card_line)
    print(json.dumps({"kernels": [
        # launches: BERT-base's and T5's encoder (with its bias, beside its
        # own case's numbers), each served path of the run.
        kernel_entry("fused_attention", "mlmicroservicetemplate_tpu/ops/attention.py:400",
                     launches + t5_k1 + quant_launches["fused_attention"]
                     + observe_launches["fused_attention"], headline,
                     tflops=headline["tflops"],
                     tflops_every_key=headline["tflops_every_key"],
                     t5={**gpt2_entry(t5_headline, t5_k1), "bias": t5_headline["bias"],
                         "bias_path": t5_headline["bias_path"],
                         "mask": t5_headline["mask"], "tflops": t5_headline["tflops"],
                         "bias_variants_ptxas": t5_headline["bias_variants_ptxas"]}),
        # launches: llama's and GPT-2's (at R = 1, beside its own case's
        # numbers), each served path of the run.
        kernel_entry("decode_attention", "mlmicroservicetemplate_tpu/ops/attention.py:310",
                     llama_svc[3] + llama8_launches + k2_streams + gpt2_k2 + spec_k2
                     + quant_launches["decode_attention"] + lora_launches["decode_attention"]
                     + tenant_launches["decode_attention"] + fault_launches["decode_attention"],
                     decode_headline,
                     gpt2=gpt2_entry(gpt2_decode, gpt2_k2)),
        kernel_entry("paged_decode_attention",
                     "mlmicroservicetemplate_tpu/ops/paged_attention.py:353",
                     k3_streams + gpt2_k3 + quant_launches["paged_decode_attention"]
                     + lora_launches["paged_decode_attention"]
                     + tenant_launches["paged_decode_attention"]
                     + fault_launches["paged_decode_attention"]
                     + observe_launches["paged_decode_attention"]
                     + durable_launches["paged_decode_attention"], paged_headline,
                     gpt2=gpt2_entry(gpt2_paged, gpt2_k3)),
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
