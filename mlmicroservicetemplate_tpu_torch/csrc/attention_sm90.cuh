// The Hopper (sm_90a) main loop shared by the encoder-attention kernel K1
// (csrc/fused_attention.cu) and the ring-hop kernel K4 (csrc/ring_hop.cu):
// bf16 q, k, v in [B, S, H, D] (D = 64), f32 online softmax over the keys of
// one batch row, scores never written to device memory.
//
// Replaces the design both kernels had first (FlashAttention-2 style
// mma.sync.m16n8k16: 64 query rows a CTA, 64-key tiles double-buffered with
// cp.async, K re-read from shared memory as scalar 32-bit loads per MMA).
// That design ran at ~160-174 TFLOP/s on an H100, above both kernels' bounds
// and slower than PyTorch's own scaled_dot_product_attention on the same
// work.  What bounds the two functions: K4 at its headline (B=8, S_loc=2048,
// H=12) does 4·B·H·S²·D ≈ 1.03e11 operations against ~54 us of bytes, so
// the tensor cores bound it; K1 at B=32, S=512 moves ~100 MB against ~26 us
// of tensor-core time, so bytes bound it, but only once the tensor cores
// are fed at their rate.  At D = 64 one exp2 on the SFU (16 a clock an SM)
// comes with 256 tensor-core operations, which is the H100's own ratio, so
// the softmax must overlap the MMAs.  This design:
//
// - Tiles: a CTA is one consumer warpgroup that owns 64 query rows of one
//   (b, h), and one producer warp.  The consumers walk the keys in 128-key
//   tiles that arrive through a ring of 3 stages in shared memory (8 KB of
//   Q, 32 KB of K + V a stage), and two CTAs share an SM (~166 registers,
//   ~105 KB).  On the H100 this beat two warpgroups of 128 rows a CTA and
//   3 CTAs an SM of 2 stages (128 registers: spills); PERF.md has the times.
// - wgmma for both products: S = Q.K^T as m64n128k16 with Q and K read from
//   shared memory (K-major, 128-byte swizzle); O += P.V as m64n64k16 with P
//   in registers (the S accumulator converted in place to bf16 A fragments)
//   and V from shared memory, MN-major (the transpose bit).  Tile i + 1's
//   Q.K^T and tile i's P.V are issued together, and tile i + 1's softmax
//   runs while P.V is in flight; the two CTAs of an SM fill each other's
//   gaps on the tensor cores and the SFU.
// - TMA with warp specialisation: one producer warp issues the
//   cp.async.bulk.tensor loads (Q once, K/V per stage) against full/empty
//   mbarriers; the consumer warpgroups run the MMAs and the softmax.  Each of
//   q, k, v is described by a 4-D tensor map over (D, H, S, B) built on the
//   host from its strides, so rows past S are zero-filled, never read from
//   the next batch row, and no layout is copied.
// - Key-tile skipping, exact.  Before the loop the CTA builds a bitmap of its
//   batch row's valid keys in shared memory (a warp ballot per 32 keys), and
//   producer and consumers walk the same list of tiles:
//   * The row holds at least one valid key: tiles with no valid key are
//     skipped.  Such a key scores -1e9, and once any valid key (score s_v >
//     -1e9 + 104) has been seen the running max is >= s_v, so the key weighs
//     exp(-1e9 - m) = 0 exactly in f32 (and 0 in bf16 p): m, l and o cannot
//     move.  Had the full loop met such a tile before the first valid one,
//     the valid tile's rescale exp(m_old - m_new) = exp(-1e9 - s_v) = 0 would
//     have wiped what it added.  So the skip changes no bit of the result.
//   * The row holds none: every key scores -1e9 whatever q.k is, so Q.K^T is
//     not computed and K is not loaded; every tile runs the softmax and P.V
//     as before (K1: the mean of V; K4: from a carried m <= -1e9, m = -1e9,
//     l = l·corr + S, o = o·corr + sum v with corr 0 from -inf and 1 from
//     -1e9; from a carried m > -1e9 the state stays exactly as it was).
//   Keys past S in the last tile, and masked keys of a tile that holds a
//   valid key, score -inf and weigh 0, as -1e9 would.
//
// - A bias as TMA tiles (an Op with kBiasTile: K1 with T5's bf16
//   [1, H, S, S] relative-position bias).  Read one global load a score, as
//   first designed, the bias made K1 1.35x slower than SDPA with the bias
//   in its mask: 64 scalar 2-byte loads a thread a tile, 8 rows x 8
//   bytes a warp each, on the consumers' critical path, while K and V came
//   by TMA.  Now the producer warp also loads, for each key tile, the bias
//   block of the CTA's 64 query rows x 128 keys (16 KB of bf16, two 64-key
//   boxes with the 128-byte swizzle, rows and keys past S zero-filled) onto
//   the stage's full barrier, and a consumer thread reads its 64 scores'
//   bias with eight ldmatrix.x4, which deliver it in the accumulator's own
//   layout; scale and bias are one FFMA (scores in natural units).  The
//   swizzle puts the 8 rows of each ldmatrix phase in 8 different 16-byte
//   chunks, so no phase has a bank conflict (unswizzled, 128-byte rows would
//   put all 8 in the same 4 banks); tests/test_torch_k1_bias_tile.py models
//   these addresses in numpy (a model of the layout, not a reading of this
//   code; no bank-conflict counter has been read on the card).  Bytes: the 4.2 MB bias of T5's B=32, S=512 call comes
//   from HBM once and stays in L2; each CTA moves 16 KB of it to shared
//   memory a key tile beside 32 KB of K and V.  Shared memory: 16 KB more
//   a stage, so the bias ring runs at 2 stages (~105 KB, two CTAs an SM, as
//   the 3-stage ring without a bias); 3 stages (~153 KB) leave one CTA an
//   SM.  On an NVIDIA H100 80GB HBM3 at 700 W, bf16 B=32, S=512, H=8,
//   padded (chip_smoke.py's T5 kernel phase; PERF.md): 0.0885 ms at 2
//   stages against 0.1399 ms read one load a score and 0.1026 ms for SDPA;
//   3 stages took 0.1288 ms.  A bias
//   whose base or row stride is not 16-byte aligned (S not a multiple of
//   8), or in f32, keeps the one-load-a-score read; without a bias nothing
//   of this is compiled in (3 stages, 156 / 166 registers for K1 / K4).
//
// Scores, softmax and the P.V sum stay in f32; P is rounded to bf16 before
// P.V.  An Op (see below) supplies the start state, the score's extras and
// the epilogue of each kernel.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace sm90 {

constexpr int kHeadDim = 64;
constexpr int kConsumers = 1;       // consumer warpgroups a CTA
constexpr int kMinBlocks = 2;       // CTAs an SM
constexpr int kMaxDevices = 64;     // devices whose shared-memory cap is remembered
constexpr int kRowsPerGroup = 64;   // query rows of one consumer warpgroup
constexpr int kTileKeys = 128;      // keys of one K/V tile
constexpr int kRowBytes = kHeadDim * 2;                // one bf16 row: 128 B
constexpr int kTileBytes = kTileKeys * kRowBytes;      // 16 KB
constexpr int kGroupQBytes = kRowsPerGroup * kRowBytes;  // 8 KB
// A bias tile: the CTA's 64 query rows x 128 keys in bf16, as two TMA boxes
// of 64 keys (128 B a row, the 128-byte swizzle's span).
constexpr int kBiasBoxKeys = 64;
constexpr int kBiasBoxBytes = kConsumers * kRowsPerGroup * kBiasBoxKeys * 2;  // 8 KB
constexpr int kBiasTileBytes = 2 * kBiasBoxBytes;                             // 16 KB

// The ring of an Op: K/V tiles in flight.  An Op that brings its bias
// through shared memory (kBiasTile) adds a 16 KB bias tile to every stage;
// at 2 stages a CTA keeps the ~105 KB of the 3-stage K/V ring and two CTAs
// still share an SM (3 stages: ~153 KB, one CTA an SM, measured slower).
template <class Op>
struct Ring {
  static constexpr int kStages = Op::kBiasTile ? 2 : 3;
  static constexpr int kBiasBytes = Op::kBiasTile ? kBiasTileBytes : 0;  // a stage's
};
constexpr int kMaxSeq = 1 << 16;    // keys a CTA's bitmap covers (8 KB)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTmaError = -2;       // a tensor map could not be built

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the SFU, results below 2^-126 flushed to 0 (p and the rescale of
// O; the flushed terms are below any f32 sum they join).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (keys, rows, H) of the bias into shared memory.
__device__ __forceinline__ void tma_load_bias(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int key, int row, int h) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(key), "r"(row), "r"(h)
      : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i .. 8i + 7 give the row
// addresses of matrix i, and lane 4g + t receives, in w[i], the 32-bit word
// at row g, columns 2t and 2t + 1 of matrix i -- the accumulator's layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&w)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "r"(addr) : "memory");
}

// One box of a 4-D tensor map (D, H, S, B) into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(0), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// Shared-memory matrix descriptor of a tile TMA wrote with the 128-byte
// swizzle: rows of 128 B, 8-row atoms 1024 B apart (SBO), layout type 1.
// The leading offset is unused for these layouts (one atom wide).  A
// 16-element step along K adds 32 B to the start address (K-major), a
// 16-row step along K adds 2048 B (MN-major V).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most kPending committed groups are still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}
// Keeps the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= Q . K^T over one 16-wide slice of D: m64n128k16, A and B from
// shared memory (both K-major).  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += P . V over one 16-key slice: m64n64k16, A = P from registers (each
// warp's 16 rows in the m16n8k16 A-fragment layout), B = V from shared
// memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// ---------------------------------------------------------------------------
// The kernel

// The next tile at or after t + 1 that the loop visits: every tile when the
// row has no valid key, else the next one with a valid key.
__device__ __forceinline__ int next_tile(const uint32_t* bits, int t, int n_tiles, bool every) {
  ++t;
  if (every) return t;
  while (t < n_tiles && (bits[4 * t] | bits[4 * t + 1] | bits[4 * t + 2] | bits[4 * t + 3]) == 0) {
    ++t;
  }
  return t;
}

// S = Q . K^T for one tile: four m64n128k16 steps over D (+32 B each).
__device__ __forceinline__ void qk_tile(float (&s)[64], uint64_t desc_q, const uint8_t* k_tile) {
  const uint64_t desc_k = make_desc(smem_u32(k_tile));
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) wgmma_qk(s, desc_q + 2 * ks, desc_k + 2 * ks, ks);
}

// Issues O += P . V for one tile: eight m64n64k16 steps over the keys
// (+2048 B each).  The caller fences, commits and waits.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[kTileKeys / 16][4],
                                         const uint8_t* v_tile) {
  const uint64_t desc_v = make_desc(smem_u32(v_tile));
#pragma unroll
  for (int kk = 0; kk < kTileKeys / 16; ++kk) {
    wgmma_pv(o, pa[kk], desc_v + kk * (16 * kRowBytes >> 4));
  }
}

// O += P . V, waited for.
__device__ __forceinline__ void pv_tile(float (&o)[32], const uint32_t (&pa)[kTileKeys / 16][4],
                                        const uint8_t* v_tile) {
  fence_regs(o);
  wgmma_fence();
  issue_pv(o, pa, v_tile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// Rescales accumulator half r (this thread's row g or g + 8) by alpha.
__device__ __forceinline__ void rescale(float (&o)[32], int r, float alpha) {
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    o[4 * j + 2 * r] *= alpha;
    o[4 * j + 2 * r + 1] *= alpha;
  }
}

// The online-softmax step of one tile whose batch row holds a valid key:
// raw scores s (q.k) in, the rows' new max and sum, the rescale alpha of
// the old O, and P as bf16 A fragments out.  A masked key, or one past the
// end, scores -inf: with a valid key in the tile it weighs exactly what
// -1e9 would, 0.  Columns 16kk .. 16kk + 15 of the score accumulator are
// the A fragment of P's 16-key slice kk.  A row's 128 scores sit in the 4
// lanes of one quad (32 each), so its reductions are two xor shuffles.
// A tile's scores in the op's units, the bias added (kBias), masked keys
// at -inf.  kFull: every key of the tile is valid, so no key is tested and
// the bias is read unchecked; else a key past the end reads no bias from
// device memory (a bias tile holds zeros there).  bias_tile (kBiasTile):
// this lane's ldmatrix row address in the stage's bias tile.
template <bool kFull, class Op>
__device__ __forceinline__ void score_tile(const Op& op, float (&s)[64], const uint32_t (&word)[4],
                                           int k0, int h, const int (&rows)[2],
                                           uint32_t bias_tile) {
  const int t = threadIdx.x % 4;
  if constexpr (Op::kBiasTile) {
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; j += 2) {
      // s[4j .. 4j + 7]: columns 8j + 2t (+1) of rows g and g + 8, then
      // the same of 8(j + 1), from matrices (row half 0, key octet j),
      // (1, j), (0, j + 1), (1, j + 1).  The swizzle puts 16-byte chunk c
      // of row R at c ^ (R % 8): the lane's address holds its row's chunk
      // of j in bits 4-6, so j moves it by xor.
      uint32_t w[4];
      ldmatrix_x4(w, (bias_tile ^ ((j % 8) << 4)) + (j / 8) * kBiasBoxBytes);
      float b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[2 * i] = __uint_as_float(w[i] << 16);
        b[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * (j + i / 4) + 2 * t + (i & 1);
        const bool keep = kFull || ((word[(j + i / 4) / 4] >> (col % 32)) & 1u);
        const float x = fmaf(s[4 * j + i], op.scale, b[i]);
        s[4 * j + i] = keep ? x : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const bool keep = kFull || ((word[j / 4] >> (col % 32)) & 1u);
        float x = s[4 * j + e];
        if constexpr (Op::kBias) {
          x = x * op.scale + op.template add<kFull>(h, rows[e >> 1], k0 + col);
        }
        s[4 * j + e] = keep ? x : -INFINITY;
      }
    }
  }
}

template <class Op>
__device__ __forceinline__ void softmax_tile(const Op& op, float (&s)[64], const uint32_t* words,
                                             int k0, int h, const int (&rows)[2],
                                             uint32_t bias_tile, float (&row_max)[2],
                                             float (&row_sum)[2], float (&alpha)[2],
                                             uint32_t (&pa)[kTileKeys / 16][4]) {
  uint32_t word[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) word[i] = words[i];
  const bool full_tile = (word[0] & word[1] & word[2] & word[3]) == 0xffffffffu;
  if (!full_tile) {
    score_tile<false>(op, s, word, k0, h, rows, bias_tile);
  } else if constexpr (Op::kBias) {
    score_tile<true>(op, s, word, k0, h, rows, bias_tile);
  }
  // Scores in the op's units are x·scale (x biased: x); exp2 takes them
  // times to2, folded into one FFMA with the row's max.
  const float to2 = Op::kNatural ? kLog2e : 1.f;
  const float coef = Op::kBias ? to2 : op.scale * to2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(row_max[r], Op::kBias ? mx : mx * op.scale);
    alpha[r] = exp2f((row_max[r] - m_new) * to2);
    const float neg = -m_new * to2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float pe = exp2_ftz(fmaf(s[4 * j + e], coef, neg));
        sum += pe;
        s[4 * j + e] = pe;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    row_sum[r] = row_sum[r] * alpha[r] + sum;
    row_max[r] = m_new;
  }
#pragma unroll
  for (int kk = 0; kk < kTileKeys / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <class Op>
constexpr int smem_bytes(int n_tiles) {
  // 1 KB of slack to align the tiles to the swizzle's 1024 B, Q, the K and
  // V rings (and the bias ring), full/empty barriers per stage and Q's, the
  // key bitmap.
  using R = Ring<Op>;
  return 1024 + kConsumers * kGroupQBytes + R::kStages * (2 * kTileBytes + R::kBiasBytes) +
         (2 * R::kStages + 1) * 8 + n_tiles * 16;
}

// Op, per kernel:
//   const int32_t* mask; long long mask_sb; int seq;   // the key mask row
//   float scale;                  // multiplies q.k
//   static constexpr bool kNatural;   // scores in natural units (else log2)
//   static constexpr bool kBias;      // a bias is added to the scaled score
//   static constexpr bool kBiasTile;  // ... read from bias tiles in shared
//                                     // memory (b_map), else add(h, row, col)
//   static constexpr float kMaskedScore;  // a masked key's score, same units
//   begin(b, h, row, r, t, o, m, l)   // the start state of accumulator half r
//   add<kFull>(h, row, col)           // extra score term (kBias); kFull:
//                                     // col is a valid key, else any key
//   end(b, h, row, r, t, o, m, l)     // the epilogue of half r (row < seq)
template <class Op>
__global__ void __launch_bounds__(kConsumers * 128 + 32, kMinBlocks)
attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap b_map, const Op op) {
  constexpr int kStages = Ring<Op>::kStages;
  static_assert(!Op::kBiasTile || kConsumers == 1, "a bias box holds one group's rows");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_s = base;
  uint8_t* k_s = q_s + kConsumers * kGroupQBytes;
  uint8_t* v_s = k_s + kStages * kTileBytes;
  uint8_t* b_s = v_s + kStages * kTileBytes;  // bias tiles (kBiasTile)
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * Ring<Op>::kBiasBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint32_t* bits = reinterpret_cast<uint32_t*>(q_full + 1);

  const int q0 = blockIdx.x * kConsumers * kRowsPerGroup;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = op.seq;
  const int n_tiles = (seq + kTileKeys - 1) / kTileKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kProducerWarp = kConsumers * 4;

  if (threadIdx.x == kProducerWarp * 32) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, kConsumers * kGroupQBytes);
    tma_load(q_s, &q_map, q_full, h, q0, b);
  }

  // The batch row's key bitmap, 32 keys a word, 4 words a tile; each warp
  // loads 8 words' keys before it votes, so their latencies overlap.
  const int32_t* mask = op.mask + b * op.mask_sb;
  constexpr int kWarps = kProducerWarp + 1;
  int any = 0;
  for (int w0 = warp; w0 < 4 * n_tiles; w0 += 8 * kWarps) {
    bool keep[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int key = (w0 + u * kWarps) * 32 + lane;
      keep[u] = key < seq && __ldg(mask + key) != 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + u * kWarps;
      const uint32_t word = __ballot_sync(0xffffffffu, keep[u]);
      if (lane == 0 && w < 4 * n_tiles) bits[w] = word;
      any |= word != 0;
    }
  }
  const bool every = __syncthreads_or(any) == 0;  // no valid key: all tiles, no Q.K^T

  if (warp == kProducerWarp) {
    if (lane == 0) {
      const uint32_t bytes = every ? kTileBytes : 2 * kTileBytes;
      int stage = 0, phase = 0;
      for (int t = next_tile(bits, -1, n_tiles, every); t < n_tiles;
           t = next_tile(bits, t, n_tiles, every)) {
        // The bias of the tile's keys for the CTA's rows (none where no Q.K^T
        // runs); a second box only where the tile has keys past its first 64.
        const bool bias = Op::kBiasTile && !every;
        const bool box2 = bias && t * kTileKeys + kBiasBoxKeys < seq;
        const uint32_t bias_bytes = !bias ? 0 : box2 ? kBiasTileBytes : kBiasBoxBytes;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], bytes + bias_bytes);
        if (!every) tma_load(k_s + stage * kTileBytes, &k_map, &full[stage], h, t * kTileKeys, b);
        tma_load(v_s + stage * kTileBytes, &v_map, &full[stage], h, t * kTileKeys, b);
        if constexpr (Op::kBiasTile) {
          uint8_t* dst = b_s + stage * kBiasTileBytes;
          if (bias) tma_load_bias(dst, &b_map, &full[stage], t * kTileKeys, q0, h);
          if (box2) {
            tma_load_bias(dst + kBiasBoxBytes, &b_map, &full[stage], t * kTileKeys + kBiasBoxKeys,
                          q0, h);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers.  Accumulator coordinates (wgmma m64nN, f32): warp wl of the
  // group owns rows 16·wl .. 16·wl + 15; with lane = 4·g + t, entry 4j + e
  // is row g + 8·(e / 2), column 8j + 2t + (e % 2).
  const int group = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + group * kRowsPerGroup + (warp % 4) * 16 + g;
  const int rows[2] = {row0, row0 + 8};
  // This lane's ldmatrix row in stage 0's bias tile (score_tile): lanes
  // 8i .. 8i + 7 address matrix i = (row half i % 2, key octet i / 2) of a
  // pair, row 8·(i % 2) + (lane % 8) of the warp's 16, the octet's chunk
  // swizzled by the row: chunk (i / 2) ^ (lane % 8) for the pair's first
  // octet 0.
  uint32_t bias_lane = 0;
  if constexpr (Op::kBiasTile) {
    const int mi = lane / 8, i = lane % 8;
    bias_lane = smem_u32(b_s) + ((warp % 4) * 16 + 8 * (mi % 2) + i) * 128 +
                (((mi / 2) ^ i) << 4);
  }

  float o[32];
  float row_max[2], row_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) op.begin(b, h, rows[r], r, t, o, row_max[r], row_sum[r]);

  int stage = 0, phase = 0;
  auto advance = [&] {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  };
  uint32_t pa[kTileKeys / 16][4];  // P of the tile whose P.V is next
  // Every consumer waits for Q, even where it reads none: a CTA must not
  // exit while a TMA load still writes into its shared memory.
  mbar_wait(q_full, 0);

  if (every) {
    // No valid key in the row: every real key scores kMaskedScore, so P is
    // one value per query row (1 or 0) for the tile's real keys.
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int real = min(kTileKeys, seq - tile * kTileKeys);
      mbar_wait(&full[stage], phase);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(row_max[r], Op::kMaskedScore);
        const float to2 = Op::kNatural ? kLog2e : 1.f;
        const float alpha = exp2f((row_max[r] - m_new) * to2);
        const float p_val = exp2f((Op::kMaskedScore - m_new) * to2);
        row_sum[r] = row_sum[r] * alpha + p_val * static_cast<float>(real);
        row_max[r] = m_new;
        rescale(o, r, alpha);
#pragma unroll
        for (int j = 0; j < kTileKeys / 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float p0 = col < real ? p_val : 0.f;
          const float p1 = col + 1 < real ? p_val : 0.f;
          pa[j / 2][(j % 2) * 2 + r] = pack_bf16(p0, p1);
        }
      }
      pv_tile(o, pa, v_s + stage * kTileBytes);
      release(stage);
      advance();
    }
  } else {
    // Each warpgroup overlaps its own softmax with its MMAs: tile i + 1's
    // Q.K^T and tile i's P.V are issued together, the softmax of tile i + 1
    // runs while P.V is in flight, and O is rescaled after it lands.
    const uint64_t desc_q = make_desc(smem_u32(q_s + group * kGroupQBytes));
    float s[64];
    int tile = next_tile(bits, -1, n_tiles, false);
    mbar_wait(&full[stage], phase);
    wgmma_fence();
    qk_tile(s, desc_q, k_s + stage * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    float alpha[2];
    softmax_tile(op, s, bits + 4 * tile, tile * kTileKeys, h, rows,
                 bias_lane + stage * Ring<Op>::kBiasBytes, row_max, row_sum, alpha, pa);
#pragma unroll
    for (int r = 0; r < 2; ++r) rescale(o, r, alpha[r]);
    int cur = stage;
    advance();
    for (int next = next_tile(bits, tile, n_tiles, false); next < n_tiles;
         next = next_tile(bits, next, n_tiles, false)) {
      mbar_wait(&full[stage], phase);
      fence_regs(o);
      wgmma_fence();
      qk_tile(s, desc_q, k_s + stage * kTileBytes);
      wgmma_commit();
      issue_pv(o, pa, v_s + cur * kTileBytes);
      wgmma_commit();
      wgmma_wait<1>();  // Q.K^T of the next tile has landed; P.V may still run
      fence_regs(s);
      uint32_t pn[kTileKeys / 16][4];
      softmax_tile(op, s, bits + 4 * next, next * kTileKeys, h, rows,
                   bias_lane + stage * Ring<Op>::kBiasBytes, row_max, row_sum, alpha, pn);
      wgmma_wait<0>();
      fence_regs(o);
      release(cur);
#pragma unroll
      for (int r = 0; r < 2; ++r) rescale(o, r, alpha[r]);
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pn[kk][i];
      cur = stage;
      advance();
    }
    pv_tile(o, pa, v_s + cur * kTileBytes);
    release(cur);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < seq) op.end(b, h, rows[r], r, t, o, row_max[r], row_sum[r]);
  }
}

// ---------------------------------------------------------------------------
// Host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links against no libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A bf16 [B, S, H, D] tensor by its element strides (batch, seq, head; the
// D stride is 1).
struct Tensor {
  const void* ptr;
  long long sb, ss, sh;
};

// The 4-D map (D, H, S, B) of `x`, boxes of (D, 1, rows, 1), 128-byte
// swizzle, out-of-range rows zero-filled.
inline bool encode(CUtensorMap* map, const Tensor& x, int batch, int seq, int heads, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(x.sh) * 2,
                                 static_cast<cuuint64_t>(x.ss) * 2,
                                 static_cast<cuuint64_t>(x.sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kHeadDim), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether a bf16 [1, H, S, S] bias at `ptr` with element strides (head,
// query row; unit key stride) can be read as TMA boxes: a 16-byte aligned
// base and row strides, rows and heads that do not overlap.
inline bool bias_tileable(const void* ptr, long long b_sh, long long b_sq, int seq) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && b_sq % 8 == 0 && b_sh % 8 == 0 &&
         b_sq >= seq && b_sh >= b_sq * seq;
}

// The 3-D map (keys, query rows, H) of a bf16 bias, boxes of 64 keys x the
// CTA's rows, 128-byte swizzle, keys and rows past S zero-filled.
inline bool encode_bias(CUtensorMap* map, const void* ptr, long long b_sh, long long b_sq,
                        int seq, int heads) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(b_sq) * 2,
                                 static_cast<cuuint64_t>(b_sh) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBiasBoxKeys),
                             static_cast<cuuint32_t>(kConsumers * kRowsPerGroup), 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises the kernel's dynamic shared-memory cap to what the longest sequence
// needs, once per device (the cap is an attribute of the function on the
// current device), so a launch pays no attribute call.
template <class Op>
cudaError_t allow_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(attention_sm90_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<Op>(kMaxSeq / kTileKeys));
  if (known && err == cudaSuccess) done[device].store(true, std::memory_order_relaxed);
  return err;
}

// The kernel of `op` at `seq` keys, on `device` (the current one): out[0]
// stages, out[1] dynamic shared memory in bytes, out[2] CTAs an SM can hold
// (the occupancy calculator), out[3] the CTAs an SM its launch bounds ask.
// Returns 0 or a cudaError_t.
template <class Op>
int config(int seq, int device, int* out) {
  const int smem = smem_bytes<Op>((seq + kTileKeys - 1) / kTileKeys);
  cudaError_t err = allow_smem<Op>(device);
  int ctas = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, attention_sm90_kernel<Op>,
                                                        kConsumers * 128 + 32, smem);
  }
  out[0] = Ring<Op>::kStages;
  out[1] = smem;
  out[2] = ctas;
  out[3] = kMinBlocks;
  return static_cast<int>(err);
}

// Launches the bf16 kernel for `op` over q, k, v on `device` (the current
// one).  Returns 0, a cudaError_t, kTmaError, or -1 for a sequence longer
// than kMaxSeq.
template <class Op>
int launch(const Op& op, const Tensor& q, const Tensor& k, const Tensor& v, int batch,
           int heads, int device, cudaStream_t stream) {
  const int seq = op.seq;
  if (seq > kMaxSeq) return -1;
  CUtensorMap q_map, k_map, v_map, b_map = {};
  if (!encode(&q_map, q, batch, seq, heads, kConsumers * kRowsPerGroup) ||
      !encode(&k_map, k, batch, seq, heads, kTileKeys) ||
      !encode(&v_map, v, batch, seq, heads, kTileKeys)) {
    return kTmaError;
  }
  if constexpr (Op::kBiasTile) {
    if (!encode_bias(&b_map, op.bias, op.b_sh, op.b_sq, seq, heads)) return kTmaError;
  }
  const cudaError_t err = allow_smem<Op>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = kConsumers * kRowsPerGroup;
  const dim3 grid((seq + rows - 1) / rows, heads, batch);
  attention_sm90_kernel<Op><<<grid, kConsumers * 128 + 32,
                              smem_bytes<Op>((seq + kTileKeys - 1) / kTileKeys), stream>>>(
      q_map, k_map, v_map, b_map, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
