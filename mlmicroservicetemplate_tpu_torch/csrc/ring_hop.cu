// One ring-attention hop for Hopper (sm_90a): for every (batch, head), the
// local queries' online-softmax update over one visiting K/V block,
//   s = (q . k^T) * scale, masked keys at -1e9,
//   m_new = max(m, rowmax s), p = exp(s - m_new), corr = exp(m - m_new),
//   l <- l * corr + sum p,  o <- o * corr + p . v,  m <- m_new,
// with the carried f32 state o [B, H, S, D], m and l [B, H, S] updated in
// place and left unnormalised.  One CTA per (64-row query tile, head, batch).
//
// Replaces the Pallas TPU kernel mlmicroservicetemplate_tpu/parallel/ring.py
// (_hop_kernel, launched by _hop_pallas).  That kernel holds one head's whole
// [S_loc, S_loc] f32 score tile in VMEM; at S_loc = 2048 that is 16 MB, far
// more than the 227 KB of shared memory an SM gives one block.  Here the
// visiting keys are walked in 64-key tiles with an online softmax, as in K1
// (csrc/fused_attention.cu): each query row starts from its carried (m, l, o)
// instead of (-inf, 0, 0), and ends by writing (m, l, o) back instead of o / l.
// Scores never reach device memory.
//
// What bounds it: at bert-long's largest bucket on one card (B=8, S_loc=2048,
// H=12, D=64, bf16) one hop does 4·B·H·S²·D ≈ 1.03e11 operations, ~104 us of
// bf16 tensor-core time, and must move ~179 MB (q, k, v read in bf16; o read
// and written in f32; m, l; the mask), ~54 us of memory time: the bound is
// operations.  With 4 shards (S_loc = 512) a hop is bytes-bound instead (the
// f32 carried o dominates).  Two kernels share the design:
//
// - bf16 (the serving path) runs both products on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 style:
//   4 warps each own 16 query rows, the probabilities stay in registers
//   between the two products, V is read transposed with ldmatrix, and K/V
//   tiles are double-buffered with cp.async.  No wgmma/TMA yet.
// - f32 (the parity path) uses scalar f32 FMAs (4x4 register tiles, float4
//   shared-memory reads), compute-bound on the f32 pipe.
//
// Both read q/k/v in [B, S, H, D] through strides, so the transposes the TPU
// wrapper pays are not paid here.
//
// Numerics follow the TPU kernel: scores, softmax, the carried state and the
// PV sum in f32 (bf16 q, widened by the tensor cores' exact products, is the
// reference's f32 q); masked keys are -1e9, never -inf, so m stays finite
// after any hop and a row whose keys are all masked averages V.  The first
// hop's m = -inf gives corr = exp(-inf) = 0.  Keys past S_loc in a partial
// tile get -inf and weigh exactly 0.  m and l stay in natural units, so a
// block whose keys are all masked after another such block keeps corr = 1
// exactly, as the reference does.  bf16 rounds p to bf16 before p . v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kHeadDim = 64;
constexpr float kMasked = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;  // [B, S], nonzero = keep; stride 1 along S
  float* o;             // [B, H, S, D] contiguous, carried, updated in place
  float* m;             // [B, H, S] contiguous
  float* l;             // [B, H, S] contiguous
  int seq;
  int heads;
  // Element strides (batch, seq, head) of q, k, v; the head_dim stride is 1.
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long m_sb;
  float scale;
};

// Offset of (b, h)'s first row in the carried m / l (times kHeadDim in o).
__device__ __forceinline__ long long state_row0(const Params& p, int b, int h) {
  return (static_cast<long long>(b) * p.heads + h) * p.seq;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, f32 accumulate)

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
// Shared row length in bf16: 8 elements of padding keep rows 16-byte aligned
// (uint4 stores, ldmatrix) and make the fragment reads conflict-free.
constexpr int kLdh = kHeadDim + 8;

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b for a 16x16 (row) bf16 A fragment and a 16x8 (col) B fragment.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed; lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte asynchronous copy global -> shared; with valid = false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Starts copying a [64, 64] bf16 tile (row r at src + r * row_stride) into
// shared rows of kLdh, zero-filling rows at or past `rows`.
__device__ __forceinline__ void copy_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int rows) {
  for (int i = threadIdx.x; i < 64 * kHeadDim / 8; i += kMmaThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = (i % (kHeadDim / 8)) * 8;
    const bool valid = r < rows;
    cp_async_16(dst + r * kLdh + c, valid ? src + r * row_stride + c : src, valid);
  }
}

__global__ void __launch_bounds__(kMmaThreads) ring_hop_mma_kernel(const Params p) {
  // K/V tiles are double-buffered: tile i + 1 streams in while tile i is
  // computed on.
  __shared__ __align__(16) __nv_bfloat16 q_s[kTileQ * kLdh];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTileK * kLdh];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTileK * kLdh];
  // per key of a tile: 1 keep, 0 masked (-1e9), -1 past the block's end
  __shared__ int8_t keep_s[2][kTileK];

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Fragment coordinates: lane = 4 * g + t.  This thread's accumulator
  // entries are rows g and g + 8 of its warp's 16, columns 2t and 2t + 1 of
  // each 8-wide tile.
  const int g = lane / 4;
  const int t = lane % 4;

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const long long row0 = state_row0(p, b, h);
  float* o_bh = p.o + row0 * kHeadDim;
  float* m_bh = p.m + row0;
  float* l_bh = p.l + row0;

  // Starts the copies of K/V tile `tile` into buffer tile % 2 and fills
  // its key flags.
  auto prefetch = [&](int tile) {
    const int k0 = tile * kTileK;
    const int buf = tile & 1;
    copy_tile_async(k_s[buf], k + k0 * p.k_ss, p.k_ss, p.seq - k0);
    copy_tile_async(v_s[buf], v + k0 * p.v_ss, p.v_ss, p.seq - k0);
    cp_async_commit();
    if (threadIdx.x < kTileK) {
      const int col = k0 + threadIdx.x;
      keep_s[buf][threadIdx.x] = col >= p.seq ? -1 : (mask[col] != 0 ? 1 : 0);
    }
  };

  copy_tile_async(q_s, q + q0 * p.q_ss, p.q_ss, p.seq - q0);
  prefetch(0);  // one group: Q and the first K/V tile

  // The carried state of this thread's two rows (rows past the block's end
  // start fresh and are never written).
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[kHeadDim / 8][4];
  float row_max[2];
  float row_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool real = rows[r] < p.seq;
    row_max[r] = real ? m_bh[rows[r]] : -INFINITY;
    row_sum[r] = real ? l_bh[rows[r]] : 0.f;
    const float* src = o_bh + static_cast<long long>(rows[r]) * kHeadDim + 2 * t;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      const float2 x = real ? *reinterpret_cast<const float2*>(src + j * 8)
                            : make_float2(0.f, 0.f);
      o[j][2 * r] = x.x;
      o[j][2 * r + 1] = x.y;
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  // The warp's 16 query rows as A fragments, one per 16-wide slice of D.
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    const bf16* base = q_s + (warp * 16 + g) * kLdh + ks * 16 + 2 * t;
    qa[ks][0] = ld_b32(base);
    qa[ks][1] = ld_b32(base + 8 * kLdh);
    qa[ks][2] = ld_b32(base + 8);
    qa[ks][3] = ld_b32(base + 8 * kLdh + 8);
  }

  const int n_tiles = (p.seq + kTileK - 1) / kTileK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      prefetch(tile + 1);
      cp_async_wait<1>();  // this tile's group is done, the next may run on
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys, each summed over 4 slices of D.
    float s[kTileK / 8][4];
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        const bf16* kb = k_s[buf] + (j * 8 + g) * kLdh + ks * 16 + 2 * t;
        mma_16816(s[j], qa[ks], ld_b32(kb), ld_b32(kb + 8));
      }
    }

    // scale and key mask, in natural units as the carried m; keys past the
    // block's end get -inf so they weigh exactly 0 (every tile holds at
    // least one real key, so the row max stays finite).
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int keep = keep_s[buf][j * 8 + 2 * t + (e & 1)];
        s[j][e] = keep > 0 ? s[j][e] * p.scale : (keep == 0 ? kMasked : -INFINITY);
      }
    }

    // online softmax, all in f32; differences to the new max are taken
    // before the change of base, so equal maxima give exp(0) = 1 exactly.
    // A row's 64 scores sit in the 4 lanes of one group (16 each), so its
    // reductions are two xor shuffles.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[r], mx);
      const float alpha = exp2f((row_max[r] - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = exp2f((s[j][e] - m_new) * kLog2e);
          sum += pe;
          s[j][e] = pe;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      row_sum[r] = row_sum[r] * alpha + sum;
      row_max[r] = m_new;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V.  The score accumulators of key tiles 2kk and 2kk+1 are the
    // A fragment of P's 16-key slice kk, rounded to bf16 in registers.
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const int mi = lane / 8;  // matrices: keys +0/+8 x head dims +0/+8
#pragma unroll
      for (int dn = 0; dn < kHeadDim / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, v_s[buf] + (kk * 16 + (mi & 1) * 8 + lane % 8) * kLdh + dn * 16 + (mi >> 1) * 8);
        mma_16816(o[2 * dn], pa, vb[0], vb[1]);
        mma_16816(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // buffer `buf` is refilled by the next iteration's prefetch
  }

  // The carried state back, unnormalised; the 4 lanes of a group hold the
  // same m and l, lane t == 0 writes them.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < p.seq) {
      float* dst = o_bh + static_cast<long long>(rows[r]) * kHeadDim + 2 * t;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
      }
      if (t == 0) {
        m_bh[rows[r]] = row_max[r];
        l_bh[rows[r]] = row_sum[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs

constexpr int kThreads = 256;
// Leading dimension of the f32 shared tiles: 4 floats of padding keep rows
// 16-byte aligned for float4 reads and spread the transposing stores.
constexpr int kLd = 68;
constexpr int kTileFloats = 64 * kLd;
constexpr int kSmemBytes = 4 * kTileFloats * static_cast<int>(sizeof(float));

// Stores a [64, 64] f32 tile of `src` (row r at src + r * row_stride) into
// `dst` transposed (dst[d * kLd + r]), zero-filling rows at or past `rows`.
__device__ __forceinline__ void load_tile_t(float* dst, const float* src,
                                            long long row_stride, int rows) {
  for (int i = threadIdx.x; i < 64 * kHeadDim / 4; i += kThreads) {
    const int r = i / (kHeadDim / 4);
    const int d = (i % (kHeadDim / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = *reinterpret_cast<const float4*>(src + r * row_stride + d);
    dst[(d + 0) * kLd + r] = x.x;
    dst[(d + 1) * kLd + r] = x.y;
    dst[(d + 2) * kLd + r] = x.z;
    dst[(d + 3) * kLd + r] = x.w;
  }
}

// As load_tile_t, without the transpose (dst[r * kLd + d]).
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows) {
  for (int i = threadIdx.x; i < 64 * kHeadDim / 4; i += kThreads) {
    const int r = i / (kHeadDim / 4);
    const int d = (i % (kHeadDim / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = *reinterpret_cast<const float4*>(src + r * row_stride + d);
    *reinterpret_cast<float4*>(dst + r * kLd + d) = x;
  }
}

__global__ void __launch_bounds__(kThreads) ring_hop_f32_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_t = smem;                 // [d][row]   query tile, transposed
  float* k_t = q_t + kTileFloats;    // [d][key]   key tile, transposed
  float* v_s = k_t + kTileFloats;    // [key][d]   value tile
  float* p_t = v_s + kTileFloats;    // [key][row] probabilities, transposed

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // Thread (ty, tx) owns rows ty*4..ty*4+3 of the tile and, in both
  // products, columns tx*4..tx*4+3 (keys for the scores, head dims for
  // the output).  The 16 threads of one row group are lanes 0-15 or
  // 16-31 of a warp, so row reductions are xor shuffles within 16 lanes.
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const long long row0 = state_row0(p, b, h);
  float* o_bh = p.o + row0 * kHeadDim;
  float* m_bh = p.m + row0;
  float* l_bh = p.l + row0;

  load_tile_t(q_t, q + q0 * p.q_ss, p.q_ss, p.seq - q0);

  // The carried state of this thread's four rows (rows past the block's
  // end start fresh and are never written).
  float acc[4][4];
  float row_max[4];
  float row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool real = row < p.seq;
    row_max[i] = real ? m_bh[row] : -INFINITY;
    row_sum[i] = real ? l_bh[row] : 0.f;
    const float4 x = real
        ? *reinterpret_cast<const float4*>(o_bh + static_cast<long long>(row) * kHeadDim + tx * 4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i][0] = x.x;
    acc[i][1] = x.y;
    acc[i][2] = x.z;
    acc[i][3] = x.w;
  }

  for (int k0 = 0; k0 < p.seq; k0 += kTileK) {
    __syncthreads();  // the previous tile's k_t / v_s / p_t reads are done
    load_tile_t(k_t, k + k0 * p.k_ss, p.k_ss, p.seq - k0);
    load_tile(v_s, v + k0 * p.v_ss, p.v_ss, p.seq - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(k_t + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // scale and key mask; keys past the block's end get -inf so they weigh
    // exactly 0 (every tile holds at least one real key, so the row max
    // stays finite).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      const bool real = col < p.seq;
      const bool keep = real && mask[col] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = keep ? s[i][j] * p.scale : (real ? kMasked : -INFINITY);
      }
    }

    // online softmax update, all in f32
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(row_max[i], mx);
      const float alpha = expf(row_max[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      row_sum[i] = row_sum[i] * alpha + sum;
      row_max[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(p_t + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(p_t + kk * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(v_s + kk * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
  }

  // The carried state back, unnormalised; the 16 threads of a row group hold
  // the same m and l, tx == 0 writes them.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < p.seq) {
      *reinterpret_cast<float4*>(o_bh + static_cast<long long>(row) * kHeadDim + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (tx == 0) {
        m_bh[row] = row_max[i];
        l_bh[row] = row_sum[i];
      }
    }
  }
}

int launch_f32(const Params& p, int batch, int heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ring_hop_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + kTileQ - 1) / kTileQ, heads, batch);
  ring_hop_f32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  const dim3 grid((p.seq + kTileQ - 1) / kTileQ, heads, batch);
  ring_hop_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).  o [B, H, S, D], m
// and l [B, H, S]: contiguous float32, read and updated in place.
// strides: q, k, v (batch, seq, head) each, then mask batch -- 10 element
// strides in that order.  Rows of q/k/v and o must be 16-byte aligned (the
// kernels move 16 bytes per access).
// Returns 0, a cudaError_t from the launch, or -1 for arguments the kernel
// does not take.
extern "C" int ring_hop_forward(const void* q, const void* k, const void* v,
                                const int32_t* mask, float* o, float* m, float* l, int dtype,
                                int batch, int seq, int heads, int head_dim,
                                const long long* strides, float scale, int device,
                                void* stream) {
  if (head_dim != kHeadDim || batch < 1 || seq < 1 || heads < 1) return -1;
  if (batch > 65535 || heads > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.o = o;
  p.m = m;
  p.l = l;
  p.seq = seq;
  p.heads = heads;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.m_sb = strides[9];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, batch, heads, s);
  if (dtype == 1) return launch_bf16(p, batch, heads, s);
  return -1;
}

extern "C" const char* ring_hop_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
