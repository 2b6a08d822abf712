// Encoder self-attention for Hopper (sm_90a): softmax(q.k^T * scale + bias,
// masked keys at -1e9) . v, one CTA per (64-row query tile, head, batch).
//
// Replaces the Pallas TPU kernel mlmicroservicetemplate_tpu/ops/attention.py
// (_attn_body, launched by fused_attention).  That kernel holds one head's
// whole [S, S] f32 score tile in VMEM; at S = 512 that is 1 MB, more than the
// 227 KB of shared memory an SM gives one block.  Here the key axis is walked
// in 64-key tiles with an online softmax: the running row max, row sum and the
// output accumulator stay in f32 registers, so scores never reach device
// memory.
//
// What bounds it: at BERT-base's biggest serving bucket (B=32, S=512, H=12,
// D=64, bf16) the function must move ~100 MB (q, k, v in, out back) and do
// ~25.8 GFLOP, i.e. ~30 us of memory time against ~26 us of bf16 tensor-core
// time, so the bound is bytes.  Two kernels share that design:
//
// - bf16 (the serving path) runs both products on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 style:
//   4 warps each own 16 query rows, the probabilities stay in registers
//   between the two products, V is read transposed with ldmatrix.  Loads are
//   single-buffered and there is no wgmma/TMA yet, so it stays above the
//   bound; those are later work.
// - f32 (the parity path) uses scalar f32 FMAs (4x4 register tiles, float4
//   shared-memory reads), compute-bound on the f32 pipe.
//
// Both read q/k/v and write the output in [B, S, H, D] through strides, so
// the [B,S,H,D] <-> [B,H,S,D] transposes the TPU wrapper pays are not paid
// here.
//
// Numerics follow the TPU kernel: scores, softmax and the PV sum in f32;
// masked keys are set to -1e9 (never -inf), so a row whose keys are all masked
// comes out as the uniform average of V, not NaN; probabilities are rounded
// to V's type before the PV product.

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
  const int32_t* mask;  // [B, S], 1 = keep; stride 1 along S
  const void* bias;     // [1, H, S, S] or null; stride 1 along the key axis
  void* out;
  int seq;
  // Element strides (batch, seq, head); the head_dim stride is 1.
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  long long b_sh, b_sq;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename TB>
__global__ void __launch_bounds__(kMmaThreads)
fused_attention_mma_kernel(const Params p) {
  // K/V tiles are double-buffered: tile i + 1 streams in while tile i is
  // computed on.
  __shared__ __align__(16) __nv_bfloat16 q_s[kTileQ * kLdh];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTileK * kLdh];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTileK * kLdh];
  // per key of a tile: 1 keep, 0 masked (-1e9), -1 past the sequence end
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
  bf16* out = static_cast<bf16*>(p.out) + b * p.o_sb + h * p.o_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const TB* bias =
      p.bias == nullptr ? nullptr : static_cast<const TB*>(p.bias) + h * p.b_sh;

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
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float o[kHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  // Scores are kept in log2 units (scale and bias times log2(e)) so the
  // softmax runs on exp2; a masked key's -1e9 scales with them, which keeps
  // its meaning (all-masked rows still average V).
  const float scale_log2 = p.scale * kLog2e;
  const int n_tiles = (p.seq + kTileK - 1) / kTileK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTileK;
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

    // scale, bias, key mask; keys past the sequence end get -inf so they
    // weigh exactly 0 (every tile holds at least one real key, so the row
    // max stays finite).
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const int row = rows[e >> 1];
        const int keep = keep_s[buf][c];
        float x = s[j][e] * scale_log2;
        if (bias != nullptr && keep >= 0 && row < p.seq) {
          x += to_f32(bias[row * p.b_sq + k0 + c]) * kLog2e;
        }
        s[j][e] = keep > 0 ? x : (keep == 0 ? kMasked * kLog2e : -INFINITY);
      }
    }

    // online softmax, all in f32 (base 2); a row's 64 scores sit in the 4
    // lanes of one group (16 each), so its reductions are two xor shuffles.
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
      const float alpha = exp2f(row_max[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = exp2f(s[j][e] - m_new);
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < p.seq) {
      const float inv = 1.f / row_sum[r];
      bf16* dst = out + rows[r] * p.o_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
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

__global__ void __launch_bounds__(kThreads)
fused_attention_f32_kernel(const Params p) {
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
  float* out = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const float* bias =
      p.bias == nullptr ? nullptr : static_cast<const float*>(p.bias) + h * p.b_sh;

  load_tile_t(q_t, q + q0 * p.q_ss, p.q_ss, p.seq - q0);

  float acc[4][4];
  float row_max[4];
  float row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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

    // scale, bias, key mask; keys past the sequence end get -inf so they
    // weigh exactly 0 (every tile holds at least one real key, so the row
    // max stays finite).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      const bool real = col < p.seq;
      const bool keep = real && mask[col] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        float x = s[i][j] * p.scale;
        if (bias != nullptr && real && row < p.seq) x += bias[row * p.b_sq + col];
        s[i][j] = keep ? x : (real ? kMasked : -INFINITY);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < p.seq) {
      const float inv = 1.f / row_sum[i];
      *reinterpret_cast<float4*>(out + row * p.o_ss + tx * 4) = make_float4(
          acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    }
  }
}

int launch_f32(const Params& p, int batch, int heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + kTileQ - 1) / kTileQ, heads, batch);
  fused_attention_f32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  const dim3 grid((p.seq + kTileQ - 1) / kTileQ, heads, batch);
  fused_attention_mma_kernel<TB><<<grid, kMmaThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype / bias_dtype: 0 = float32, 1 = bfloat16; bias_dtype -1 = no bias
// (f32 takes an f32 bias, bf16 either).
// strides: q, k, v, out (batch, seq, head) each, then mask batch, then bias
// head and query -- 15 element strides in that order.  Rows must be 16-byte
// aligned (the kernels move 16 bytes per access).
// Returns 0, a cudaError_t from the launch, or -1 for arguments the kernel
// does not take.
extern "C" int fused_attention_forward(
    const void* q, const void* k, const void* v, const int32_t* mask,
    const void* bias, void* out, int dtype, int bias_dtype, int batch, int seq,
    int heads, int head_dim, const long long* strides, float scale, int device,
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
  p.bias = bias;
  p.out = out;
  p.seq = seq;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.m_sb = strides[12];
  p.b_sh = strides[13];
  p.b_sq = strides[14];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bias_dtype <= 0) return launch_f32(p, batch, heads, s);
  if (dtype == 1 && bias_dtype <= 0) return launch_bf16<float>(p, batch, heads, s);
  if (dtype == 1 && bias_dtype == 1) return launch_bf16<__nv_bfloat16>(p, batch, heads, s);
  return -1;
}

extern "C" const char* fused_attention_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
