// The Hopper (sm_90a) core shared by the two decode-attention kernels, K2
// (csrc/decode_attention.cu, a contiguous [B, T, KVH, D] cache) and K3
// (csrc/paged_decode_attention.cu, a [NB, BS, KVH, D] pool read through a
// [B, T] block table).  Both compute one function: for batch row b and KV
// head g, the R = H / KVH query heads of the group attend to the row's keys,
// out[b, g R + r] = softmax(q . K^T * scale over valid keys) . V, with
// f32 scores and softmax; only the addressing of a key differs.
//
// What bounds it: bytes.  At TinyLlama's serving shapes the function reads
// 4.7 MB (K2, B=8, T=576) or ~9.4 MB (K3, B=16, 36 blocks of 16) once, 1.4
// and 2.8 us at 3.35 TB/s, against well under 0.1 us of tensor-core work.
// The first versions were one CTA per (KV head, row) walking 64-key tiles
// serially on scalar FMAs with single-buffered loads: 32 CTAs at B=8 on 132
// SMs, each waiting on one tile at a time, ~20x their bound.  This design:
//
// - Split keys (flash-decoding).  The grid is (KV head, row, split); a split
//   holds a whole number of 64-key tiles (for K3 a whole number of table
//   blocks where the block size allows), at most kMaxSplitTiles.  The caller
//   picks the split count from B, KVH and T alone (ops/attention.py,
//   split_plan), so the grid never depends on the data and the host never
//   reads it.  With one split the CTA writes the output; with more, each CTA
//   writes its partial (o[R, D], m[R], l[R]) in f32 to a workspace and
//   decode_combine_kernel merges them and writes the output.
// - Exact tile skipping.  A CTA reads its split's keep flags (the mask, or
//   key_valid) before its first load.  If the row holds at least one valid
//   key, a key that is not valid weighs exactly 0 in f32 once a valid key is
//   in the max (K2's -1e9, K3's -1e30), so tiles with no valid key are not
//   loaded at all, and a split with none writes the empty state (m = -inf,
//   l = 0), which the merge weighs 0.  Only a split with no valid key reads
//   the rest of the row's flags (from L2, one read an entry), to learn
//   whether the row holds one.  A row with none comes out as the plain mean
//   of V over all of its positions, as the reference's uniform softmax over
//   -1e9 (-1e30) scores gives: its CTAs load V only (K3 through the clamped
//   table, sentinels included) and write (sum v, m = 0, l = count).
// - Pipelined loads.  The queries, the split's keep flags and (K3) its
//   slice of the block table, clamped to [0, NB), arrive in one round of
//   loads before the first tile.  K and V tiles (and the tile's keep flags)
//   then stream through two stages of shared memory by cp.async, 16 bytes a
//   thread, in their stored type (bf16, f32 or int8), one tile in flight
//   while the last is computed.  128 threads, 128 registers and 44-49 KB
//   (bf16; the warps' merge buffer reuses the stages) let four CTAs share
//   an SM, so the grid of about two CTAs an SM runs in one wave.
// - Tensor cores for the dense bf16 cache: each of the 4 warps takes 16 keys
//   of a tile with its own running (m, l, o), S = Q K^T and O += P V as
//   mma.sync.m16n8k16 with the group's (up to 16) query heads as the 16 rows
//   (heads past R are zero), Q and K by ldmatrix, V by ldmatrix.trans, and P
//   reused from the S accumulator as the A fragment, rounded to bf16 as K2's
//   reference rounds the probabilities (K3's reference keeps them f32: its
//   bf16 pool adds the rounding's remainder as a second bf16 A fragment and
//   MMA, which leaves ~2^-17 of each p).  The f32 and int8 caches run the same
//   split, skip and pipeline on f32 FMAs; the int8 cache dequantizes in f32
//   (K = k8 * k_scale, V = v8 * v_scale) and keeps its probabilities in f32.
//   The 4 warps' states merge in shared memory at the end.
//
// Scores use exp2 with scale * log2(e) folded in; m is kept in log2 units in
// the partials.  Outputs are o / max(l, 1e-20) in q's type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace decode_sm90 {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;           // keys per tile
constexpr int kMaxGroup = 16;       // query heads per KV head
constexpr int kThreads = 128;       // 4 warps, 16 keys of each tile apiece
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = kTile / kWarps;
constexpr int kMaxSplitTiles = 16;  // tiles per split at most
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;        // [B, H, D]
  const void* k;        // K2: [B, T, KVH, D]; K3: [NB, BS, KVH, D]
  const void* v;
  const void* k_scale;  // same layout, last dim 1; null for a dense cache
  const void* v_scale;
  const int32_t* keep;  // [B, n_keys], unit stride along keys; nonzero = attend
  const int32_t* table; // K3: [B, T] block ids, unit stride; null for K2
  void* out;            // [B, H, D]
  float* ws;            // [B, KVH, splits, R * (D + 2)] partials; null at one split
  int n_keys;           // K2: T; K3: T * BS
  int group;            // R
  int splits;
  int split_tiles;      // tiles per split
  int block_size;       // K3: BS
  int num_blocks;       // K3: NB
  // Element strides (the head_dim stride is 1).  K2: (batch, token, head);
  // K3: (block, token, head).
  long long q_sb, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long ks_sb, ks_st, ks_sh;
  long long vs_sb, vs_st, vs_sh;
  long long o_sb, o_sh;
  long long keep_sb, tbl_sb;
  float scale_log2;     // scale * log2(e)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <typename TKV, bool kPaged>
struct Smem {
  static constexpr int kStages = 2;
  static constexpr bool kFma = sizeof(TKV) != 2;
  // Rows padded by 16 bytes: ldmatrix's 8 rows land on distinct banks.
  static constexpr int kLd = kHeadDim + 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kStageBytes = kStages * 2 * kTile * kLd * static_cast<int>(sizeof(TKV));
  static constexpr int kMergeBytes = kWarps * kMaxGroup * kHeadDim * 4;
  // The K and V stages; after the walk, the warps' o for the merge.
  alignas(16) unsigned char kv[kStageBytes > kMergeBytes ? kStageBytes : kMergeBytes];
  int keep[kStages][kTile];
  float ks[kStages][kTile];  // int8 cache: the tile's scales
  float vs[kStages][kTile];
  // The group's queries, rows >= R zero: f32 rows of kHeadDim + 4 (FMA
  // path), or bf16 rows of kHeadDim + 8 in the same bytes (mma path).
  alignas(16) float q[kMaxGroup][kHeadDim + 4];
  float p[kFma ? kWarps : 1][kMaxGroup][kWarpKeys];  // FMA path: a warp's probabilities
  float alpha[kFma ? kWarps : 1][kMaxGroup];         // FMA path: a warp's rescale
  float m_w[kWarps][kMaxGroup];                      // each warp's state, merged at the end
  float l_w[kWarps][kMaxGroup];
  int blk[kPaged ? kMaxSplitTiles * kTile : 1];      // K3: pool block of each key of the split
  unsigned tile_bits[kWarps];                        // tiles of the split holding a valid key

  __device__ __forceinline__ TKV* krow(int st, int r) {
    return reinterpret_cast<TKV*>(kv) + (st * kTile + r) * kLd;
  }
  __device__ __forceinline__ TKV* vrow(int st, int r) {
    return reinterpret_cast<TKV*>(kv) + ((kStages + st) * kTile + r) * kLd;
  }
  __device__ __forceinline__ float* ow(int w, int h) {
    return reinterpret_cast<float*>(kv) + (w * kMaxGroup + h) * kHeadDim;
  }
  __device__ __forceinline__ bf16* qh(int r, int d) {
    return reinterpret_cast<bf16*>(&q[0][0]) + r * (kHeadDim + 8) + d;
  }
};

template <typename TQ, typename TKV, typename TS, bool kPaged>
struct Core {
  using S = Smem<TKV, kPaged>;
  static constexpr int kStages = S::kStages;
  static constexpr bool kMma = sizeof(TKV) == 2;  // the dense bf16 cache
  static constexpr bool kQuant = sizeof(TKV) == 1;
  static constexpr int kPerThread = kMaxSplitTiles * kTile / kThreads;  // keys a thread scans

  const Params& p;
  S& sm;
  int g, b, s, k0, k1;
  unsigned todo;  // the split's tiles still to walk, bit j = tile first + j
  const TKV* kbase;
  const TKV* vbase;
  const TS* ksbase;
  const TS* vsbase;

  __device__ Core(const Params& p_, S& sm_) : p(p_), sm(sm_) {
    g = blockIdx.x;
    b = blockIdx.y;
    s = blockIdx.z;
    k0 = s * p.split_tiles * kTile;
    k1 = min(p.n_keys, k0 + p.split_tiles * kTile);
    // K2 rows start at the batch row; K3 rows are found per key through blk.
    const long long kb = kPaged ? 0 : b * p.k_sb;
    const long long vb = kPaged ? 0 : b * p.v_sb;
    kbase = static_cast<const TKV*>(p.k) + kb + g * p.k_sh;
    vbase = static_cast<const TKV*>(p.v) + vb + g * p.v_sh;
    ksbase = kQuant ? static_cast<const TS*>(p.k_scale) + (kPaged ? 0 : b * p.ks_sb) + g * p.ks_sh
                    : nullptr;
    vsbase = kQuant ? static_cast<const TS*>(p.v_scale) + (kPaged ? 0 : b * p.vs_sb) + g * p.vs_sh
                    : nullptr;
  }

  // Row offsets of key t (k0 <= t < k1) in the K and V arrays and scales.
  __device__ __forceinline__ long long row(int t, long long sb, long long st) const {
    if constexpr (kPaged) {
      return static_cast<long long>(sm.blk[t - k0]) * sb + (t % p.block_size) * st;
    }
    return t * st;
  }

  // Issues the loads of tile `tile` (absolute) into stage `st`: K and keep
  // flags unless `v_only`, V always, and the int8 scales.
  __device__ __forceinline__ void issue(int tile, int st, bool v_only) {
    constexpr int kChunks = kHeadDim * static_cast<int>(sizeof(TKV)) / 16;  // per row
    constexpr int kElems = 16 / static_cast<int>(sizeof(TKV));
    const int t0 = tile * kTile;
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * kElems;
      const int t = t0 + r;
      const bool in = t < k1;
      if (!v_only) {
        const TKV* src = in ? kbase + row(t, p.k_sb, p.k_st) + c : kbase;
        cp_async16(sm.krow(st, r) + c, src, in ? 16 : 0);
      }
      const TKV* src = in ? vbase + row(t, p.v_sb, p.v_st) + c : vbase;
      cp_async16(sm.vrow(st, r) + c, src, in ? 16 : 0);
    }
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const int t = t0 + r;
      const bool in = t < k1;
      if (!v_only) {
        const int32_t* src = p.keep + b * p.keep_sb + (in ? t : 0);
        cp_async4(&sm.keep[st][r], src, in ? 4 : 0);
      }
      if constexpr (kQuant) {  // 2- or 4-byte scales at any stride: plain loads
        if (!v_only) sm.ks[st][r] = in ? to_f32(ksbase[row(t, p.ks_sb, p.ks_st)]) : 0.f;
        sm.vs[st][r] = in ? to_f32(vsbase[row(t, p.vs_sb, p.vs_st)]) : 0.f;
      }
    }
  }

  // Reads the queries, the split's keep flags and (K3) its table slice in
  // one round of loads, and sets `todo`.  Returns whether the row holds a
  // valid key.
  __device__ bool setup() {
    const int warp = threadIdx.x / 32;
    const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb + g * p.group * p.q_sh;
    const int32_t* keep = p.keep + b * p.keep_sb;
    float qv[kMaxGroup * kHeadDim / kThreads];
    int kv[kPerThread];
    int tv[kPaged ? kPerThread : 1];
#pragma unroll
    for (int j = 0; j < kMaxGroup * kHeadDim / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kHeadDim;
      qv[j] = r < p.group ? to_f32(q[r * p.q_sh + i % kHeadDim]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int t = k0 + threadIdx.x + j * kThreads;
      kv[j] = t < k1 ? keep[t] : 0;
      if constexpr (kPaged) tv[j] = t < k1 ? p.table[b * p.tbl_sb + t / p.block_size] : 0;
    }
#pragma unroll
    for (int j = 0; j < kMaxGroup * kHeadDim / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if constexpr (kMma) {
        *sm.qh(i / kHeadDim, i % kHeadDim) = __float2bfloat16(qv[j]);
      } else {
        sm.q[i / kHeadDim][i % kHeadDim] = qv[j];
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;  // key of the split
      if (kv[j] != 0) bits |= 1u << (i / kTile);
      if constexpr (kPaged) sm.blk[i] = min(max(tv[j], 0), p.num_blocks - 1);
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (threadIdx.x % 32 == 0) sm.tile_bits[warp] = bits;
    __syncthreads();
    bits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) bits |= sm.tile_bits[w];
    bool row_any = bits != 0;
    if (!row_any) {  // none in this split: does the rest of the row hold one?
      int any = 0;
      for (int t0 = threadIdx.x; t0 < p.n_keys && !any; t0 += 8 * kThreads) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // 8 loads in flight a thread
          const int t = t0 + j * kThreads;
          if (t < p.n_keys && (t < k0 || t >= k1) && keep[t] != 0) any = 1;
        }
      }
      row_any = __syncthreads_or(any) != 0;
    }
    // A row with a valid key walks the tiles that hold one; a row with none
    // walks every tile of the split (V only).
    const int count = (k1 - k0 + kTile - 1) / kTile;
    todo = row_any ? bits : (count == 32 ? ~0u : (1u << count) - 1);
    return row_any;
  }

  // The walk over the split's tiles, kStages - 1 loads in flight.
  template <typename Body>
  __device__ __forceinline__ void walk(bool v_only, Body&& body) {
    const int first = k0 / kTile;
    unsigned to_issue = todo;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (to_issue) {
        issue(first + __ffs(to_issue) - 1, i, v_only);
        to_issue &= to_issue - 1;
      }
      cp_async_commit();
    }
    for (int i = 0; todo; ++i) {
      if (to_issue) {
        issue(first + __ffs(to_issue) - 1, (i + kStages - 1) % kStages, v_only);
        to_issue &= to_issue - 1;
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      body(first + __ffs(todo) - 1, i % kStages);
      todo &= todo - 1;
      __syncthreads();  // the stage is free for the next issue
    }
    cp_async_wait<0>();
  }

  // ---- the dense bf16 cache: mma.sync --------------------------------
  __device__ void run_mma() {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    unsigned qa[4][4];  // Q as the A operand, one fragment per 16 dims
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      ldmatrix_x4(qa[ks], sm.qh(lane % 16, ks * 16 + (lane / 16) * 8));
    }
    // rows lane / 4 and lane / 4 + 8 of the 16 head rows
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    const int kw = warp * kWarpKeys;
    walk(false, [&](int, int st) {
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        unsigned kb[4];
        const int mat = lane / 8;
        ldmatrix_x4(kb, sm.krow(st, kw + (mat / 2) * 8 + lane % 8) + ks * 16 + (mat % 2) * 8);
        mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + nt * 8 + (lane % 4) * 2 + (e & 1);
          const float x = sm.keep[st][key] != 0 ? sc[nt][e] * p.scale_log2 : -INFINITY;
          sc[nt][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - m_use);
        m[h] = m_new;
        mx[h] = m_use;
      }
      // P as the A operand, rounded to bf16; K3 (f32 probabilities in the
      // reference) adds the rounding's remainder as a second bf16 term.
      unsigned pa[4], pa_lo[4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[e] = exp2f(sc[nt][e] - mx[e / 2]);
        sum[0] += pr[0] + pr[1];
        sum[1] += pr[2] + pr[3];
        pa[nt * 2] = pack_bf16(pr[0], pr[1]);
        pa[nt * 2 + 1] = pack_bf16(pr[2], pr[3]);
        if constexpr (kPaged) {
          float lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) lo[e] = pr[e] - __bfloat162float(__float2bfloat16(pr[e]));
          pa_lo[nt * 2] = pack_bf16(lo[0], lo[1]);
          pa_lo[nt * 2 + 1] = pack_bf16(lo[2], lo[3]);
        }
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        unsigned vb[4];
        const int mat = lane / 8;
        ldmatrix_x4_trans(vb, sm.vrow(st, kw + (mat % 2) * 8 + lane % 8) + (2 * jj + mat / 2) * 8);
        mma_bf16(o[2 * jj], pa, vb[0], vb[1]);
        mma_bf16(o[2 * jj + 1], pa, vb[2], vb[3]);
        if constexpr (kPaged) {
          mma_bf16(o[2 * jj], pa_lo, vb[0], vb[1]);
          mma_bf16(o[2 * jj + 1], pa_lo, vb[2], vb[3]);
        }
      }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const int r0 = lane / 4;
    if (lane % 4 == 0) {
      sm.m_w[warp][r0] = m[0];
      sm.l_w[warp][r0] = l[0];
      sm.m_w[warp][r0 + 8] = m[1];
      sm.l_w[warp][r0 + 8] = l[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = j * 8 + (lane % 4) * 2;
      sm.ow(warp, r0)[d] = o[j][0];
      sm.ow(warp, r0)[d + 1] = o[j][1];
      sm.ow(warp, r0 + 8)[d] = o[j][2];
      sm.ow(warp, r0 + 8)[d + 1] = o[j][3];
    }
  }

  // ---- the f32 and int8 caches: f32 FMAs -----------------------------
  // Lane L scores key L % 16 of the warp's 16 for heads L / 16 + 2 i, then
  // accumulates head dims 2 L, 2 L + 1 of every head.
  __device__ void run_fma() {
    constexpr int kSlots = kMaxGroup / 2;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int kk = lane % 16;
    const int kw = warp * kWarpKeys;
    const int group = p.group;
    float m[kSlots], l[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    float o[kMaxGroup][2];
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) o[h][0] = o[h][1] = 0.f;
    walk(false, [&](int, int st) {
      const TKV* krow = sm.krow(st, kw + kk);
      const float kscale = kQuant ? sm.ks[st][kw + kk] : 1.f;
      float acc[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kHeadDim; d += 4) {
        float kf[4];
        if constexpr (kQuant) {
          const char4 c = *reinterpret_cast<const char4*>(krow + d);
          kf[0] = static_cast<float>(c.x) * kscale;
          kf[1] = static_cast<float>(c.y) * kscale;
          kf[2] = static_cast<float>(c.z) * kscale;
          kf[3] = static_cast<float>(c.w) * kscale;
        } else {
          const float4 c = *reinterpret_cast<const float4*>(krow + d);
          kf[0] = to_f32(c.x);
          kf[1] = to_f32(c.y);
          kf[2] = to_f32(c.z);
          kf[3] = to_f32(c.w);
        }
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const int h = lane / 16 + 2 * i;
          if (h < group) {
            const float4 qv = *reinterpret_cast<const float4*>(&sm.q[h][d]);
            acc[i] = fmaf(qv.x, kf[0], acc[i]);
            acc[i] = fmaf(qv.y, kf[1], acc[i]);
            acc[i] = fmaf(qv.z, kf[2], acc[i]);
            acc[i] = fmaf(qv.w, kf[3], acc[i]);
          }
        }
      }
      const bool keep = sm.keep[st][kw + kk] != 0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int h = lane / 16 + 2 * i;
        const float x = keep ? acc[i] * p.scale_log2 : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(m[i], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[i] - m_use);
        const float pr = exp2f(x - m_use);
        l[i] = l[i] * alpha + pr;
        m[i] = m_new;
        if (h < group) {
          sm.p[warp][h][kk] = pr;
          if (kk == 0) sm.alpha[warp][h] = alpha;
        }
      }
      __syncwarp();
      const int d = 2 * lane;
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < group) {
          o[h][0] *= sm.alpha[warp][h];
          o[h][1] *= sm.alpha[warp][h];
        }
      }
#pragma unroll 4
      for (int j = 0; j < kWarpKeys; ++j) {
        float v0, v1;
        const TKV* vr = sm.vrow(st, kw + j) + d;
        if constexpr (kQuant) {
          const char2 c = *reinterpret_cast<const char2*>(vr);
          const float vsc = sm.vs[st][kw + j];
          v0 = static_cast<float>(c.x) * vsc;
          v1 = static_cast<float>(c.y) * vsc;
        } else {
          v0 = to_f32(vr[0]);
          v1 = to_f32(vr[1]);
        }
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h) {
          if (h < group) {
            const float pr = sm.p[warp][h][j];
            o[h][0] = fmaf(pr, v0, o[h][0]);
            o[h][1] = fmaf(pr, v1, o[h][1]);
          }
        }
      }
      __syncwarp();
    });
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
      const int h = lane / 16 + 2 * i;
      if (kk == 0 && h < group) {
        sm.m_w[warp][h] = m[i];
        sm.l_w[warp][h] = l[i];
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h < group) {
        sm.ow(warp, h)[2 * lane] = o[h][0];
        sm.ow(warp, h)[2 * lane + 1] = o[h][1];
      }
    }
  }

  // ---- a row with no valid key: the plain mean of V ------------------
  __device__ void run_mean() {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int kw = warp * kWarpKeys;
    float o0 = 0.f, o1 = 0.f;
    int count = 0;
    walk(true, [&](int tile, int st) {
      const int d = 2 * lane;
      for (int j = 0; j < kWarpKeys; ++j) {
        if (tile * kTile + kw + j >= k1) break;
        const TKV* vr = sm.vrow(st, kw + j) + d;
        const float vsc = kQuant ? sm.vs[st][kw + j] : 1.f;
        o0 += to_f32(vr[0]) * vsc;
        o1 += to_f32(vr[1]) * vsc;
        ++count;
      }
    });
    for (int h = 0; h < p.group; ++h) {
      sm.ow(warp, h)[2 * lane] = o0;
      sm.ow(warp, h)[2 * lane + 1] = o1;
      if (lane == 0) {
        sm.m_w[warp][h] = 0.f;
        sm.l_w[warp][h] = static_cast<float>(count);
      }
    }
  }

  // Merges the 4 warps' states; writes the output (one split) or this
  // split's partial.
  __device__ void finish() {
    __syncthreads();
    const int group = p.group;
    TQ* out = static_cast<TQ*>(p.out) + b * p.o_sb + g * group * p.o_sh;
    float* part = p.ws == nullptr
                      ? nullptr
                      : p.ws + ((static_cast<long long>(b) * gridDim.x + g) * p.splits + s) *
                                   group * (kHeadDim + 2);
    for (int i = threadIdx.x; i < group * kHeadDim; i += kThreads) {
      const int h = i / kHeadDim;
      const int d = i % kHeadDim;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.m_w[w][h]);
      float o = 0.f, l = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float wt = exp2f(sm.m_w[w][h] - mx);
          o += wt * sm.ow(w, h)[d];
          l += wt * sm.l_w[w][h];
        }
      }
      if (part == nullptr) {
        store(out + h * p.o_sh + d, o / fmaxf(l, 1e-20f));
      } else {
        part[h * kHeadDim + d] = o;
        if (d == 0) {
          part[group * kHeadDim + h] = mx;
          part[group * kHeadDim + group + h] = l;
        }
      }
    }
  }
};

template <typename TQ, typename TKV, typename TS, bool kPaged>
__global__ void __launch_bounds__(kThreads, 4) decode_split_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<TKV, kPaged>*>(smem_raw);
  Core<TQ, TKV, TS, kPaged> core(p, sm);
  if (!core.setup()) {
    core.run_mean();
  } else if constexpr (Core<TQ, TKV, TS, kPaged>::kMma) {
    core.run_mma();
  } else {
    core.run_fma();
  }
  core.finish();
}

// Merges the splits' partials of one (KV head, row): out = sum_s w_s o_s /
// sum_s w_s l_s with w_s = exp2(m_s - max m); a split with no valid key
// (m = -inf) weighs 0.  One thread an output (h, d), one pass over the
// splits with a running max and no branch, so the loads of several splits
// are in flight together.  kPaged only names K3's instantiation apart.
template <typename TQ, bool kPaged>
__global__ void __launch_bounds__(kMaxGroup * kHeadDim)
    decode_combine_kernel(const __grid_constant__ Params p) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int group = p.group;
  const int i = threadIdx.x;  // output (i / kHeadDim, i % kHeadDim); group * kHeadDim threads
  const int h = i / kHeadDim;
  const int stride = group * (kHeadDim + 2);
  const float* part = p.ws + (static_cast<long long>(b) * gridDim.x + g) * p.splits * stride;
  float mx = -INFINITY, o = 0.f, l = 0.f;
#pragma unroll 8
  for (int s = 0; s < p.splits; ++s) {
    const float* ps = part + s * stride;
    const float ms = ps[group * kHeadDim + h];
    const float ls = ps[group * kHeadDim + group + h];
    const float os = ps[i];
    const float m_new = fmaxf(mx, ms);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float c = exp2f(mx - base);  // 0 while mx is -inf
    const float w = exp2f(ms - base);  // 0 for a split with no valid key
    o = o * c + os * w;
    l = l * c + ls * w;
    mx = m_new;
  }
  TQ* out = static_cast<TQ*>(p.out) + b * p.o_sb + g * group * p.o_sh;
  store(out + h * p.o_sh + i % kHeadDim, o / fmaxf(l, 1e-20f));
}

// Launches the split kernel (and, past one split, the combine) on `stream`.
// The dynamic shared-memory cap is raised once per device and kernel.
template <typename TQ, typename TKV, typename TS, bool kPaged>
int launch(const Params& p, int batch, int kv_heads, int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  auto* kernel = decode_split_kernel<TQ, TKV, TS, kPaged>;
  constexpr int kSmem = static_cast<int>(sizeof(Smem<TKV, kPaged>));
  const bool known = device >= 0 && device < kMaxDevices;
  if (!known || !done[device].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (known) done[device].store(true, std::memory_order_relaxed);
  }
  kernel<<<dim3(kv_heads, batch, p.splits), kThreads, kSmem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  decode_combine_kernel<TQ, kPaged><<<dim3(kv_heads, batch), p.group * kHeadDim, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Checks what every entry point shares; returns false for arguments the
// kernels do not take.
inline bool valid_split(int n_keys, int splits, int split_tiles, bool has_ws) {
  if (n_keys < 1 || splits < 1 || splits > 65535) return false;
  if (split_tiles < 1 || split_tiles > kMaxSplitTiles) return false;
  const long long span = static_cast<long long>(split_tiles) * kTile;
  // every split holds at least one key, and the splits cover every key
  if ((splits - 1) * span >= n_keys || splits * span < n_keys) return false;
  return has_ws == (splits > 1);
}

// Dispatches on the dtype codes (q: 0 float32, 1 bfloat16; kv: 0 / 1 dense
// in q's type, 2 int8; scales: 0 / 1, -1 dense).
template <bool kPaged>
int dispatch(const Params& p, int q_dtype, int kv_dtype, int scale_dtype, int batch,
             int kv_heads, int device, cudaStream_t s) {
  const bool quant = kv_dtype == 2;
  if (quant != (p.k_scale != nullptr && p.v_scale != nullptr)) return -1;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, float, kPaged>(p, batch, kv_heads, device, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<bf16, bf16, float, kPaged>(p, batch, kv_heads, device, s);
  if (quant && q_dtype == 0 && scale_dtype == 0)
    return launch<float, int8_t, float, kPaged>(p, batch, kv_heads, device, s);
  if (quant && q_dtype == 0 && scale_dtype == 1)
    return launch<float, int8_t, bf16, kPaged>(p, batch, kv_heads, device, s);
  if (quant && q_dtype == 1 && scale_dtype == 0)
    return launch<bf16, int8_t, float, kPaged>(p, batch, kv_heads, device, s);
  if (quant && q_dtype == 1 && scale_dtype == 1)
    return launch<bf16, int8_t, bf16, kPaged>(p, batch, kv_heads, device, s);
  return -1;
}

}  // namespace decode_sm90
