// One ring-attention hop for Hopper (sm_90a): for every (batch, head), the
// local queries' online-softmax update over one visiting K/V block,
//   s = (q . k^T) * scale, masked keys at -1e9,
//   m_new = max(m, rowmax s), p = exp(s - m_new), corr = exp(m - m_new),
//   l <- l * corr + sum p,  o <- o * corr + p . v,  m <- m_new,
// with the carried f32 state o [B, H, S, D], m and l [B, H, S] updated in
// place and left unnormalised.  A fresh hop starts from (0, -inf, 0) without
// reading the state; a final hop writes o / max(l, 1e-20) to [B, S, H, D] in
// q's type and no state.
//
// Replaces the Pallas TPU kernel mlmicroservicetemplate_tpu/parallel/ring.py
// (_hop_kernel, launched by _hop_pallas).  That kernel holds one head's whole
// [S_loc, S_loc] f32 score tile in VMEM; at S_loc = 2048 that is 16 MB, far
// more than the 227 KB of shared memory an SM gives one block.  Here the
// visiting keys are walked in tiles with an online softmax, each query row
// starting from its carried (m, l, o).  Scores never reach device memory.
//
// What bounds it: at bert-long's largest bucket on one card (B=8, S_loc=2048,
// H=12, D=64, bf16, one hop a layer) a hop does 4·B·H·S²·D ≈ 1.03e11
// operations, ~104 us of bf16 tensor-core time (~83 us over the valid keys of
// chip_smoke's mask), against ~54 us of bytes: the tensor cores bound it.
// With 4 shards (S_loc = 512) a hop is bytes-bound on the f32 carried o.
//
// - bf16 (the serving path) is the shared Hopper main loop of
//   csrc/attention_sm90.cuh: wgmma for both products, 64 query rows a CTA in
//   one consumer warpgroup, two CTAs an SM, 128-key tiles brought by TMA from
//   a producer warp through a three-stage mbarrier ring, key tiles with no
//   valid key skipped exactly (the header states why that is exact).  This
//   file adds the Op: scores and the carried m in natural units, the start
//   state (fresh or carried) and the epilogue (carried state, or the final
//   o / l in bf16).  At one shard a layer's ring
//   is one fresh and final hop: q, k, v in, the context out, no f32 state
//   allocated, read or written, no separate normalise, transpose or cast.
// - f32 (the parity path) uses scalar f32 FMAs (4x4 register tiles, float4
//   shared-memory reads), compute-bound on the f32 pipe.
//
// Both read q/k/v (and write the final output) in [B, S, H, D] through
// strides, so the transposes the TPU wrapper pays are not paid here.
//
// Numerics follow the TPU kernel: scores, softmax, the carried state and the
// PV sum in f32 (bf16 q, widened by the tensor cores' exact products, is the
// reference's f32 q); masked keys are -1e9, never -inf, so m stays finite
// after any hop and a row whose keys are all masked averages V.  The first
// hop's m = -inf gives corr = exp(-inf) = 0.  Keys past S_loc in a partial
// tile get -inf and weigh exactly 0.  m and l stay in natural units, and the
// differences to the new max are taken before the change of base, so a block
// whose keys are all masked after another such block keeps corr = 1 exactly
// (in log2 units a round trip of -1e9 through ×log2(e) can land 64 away), as
// the reference does.  bf16 rounds p to bf16 before p . v.

#include "attention_sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kHeadDim = 64;
constexpr float kMasked = -1e9f;
constexpr float kMinSum = 1e-20f;  // the final o / max(l, kMinSum)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;  // [B, S], nonzero = keep; stride 1 along S
  float* o;             // [B, H, S, D] contiguous, carried, updated in place
  float* m;             // [B, H, S] contiguous
  float* l;             // [B, H, S] contiguous
  void* out;            // [B, S, H, D] in q's type: the final hop's o / l, or null
  int fresh;            // start from (0, -inf, 0); o, m, l are not read
  int seq;
  int heads;
  // Element strides (batch, seq, head) of q, k, v and out; the head_dim
  // stride is 1.
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long m_sb;
  long long out_sb, out_ss, out_sh;
  float scale;
};

// Offset of (b, h)'s first row in the carried m / l (times kHeadDim in o).
__device__ __forceinline__ long long state_row0(const Params& p, int b, int h) {
  return (static_cast<long long>(b) * p.heads + h) * p.seq;
}

// ---------------------------------------------------------------------------
// bf16: the shared sm_90a loop (attention_sm90.cuh) with K4's Op

struct HopOp {
  static constexpr bool kNatural = true;
  static constexpr bool kBias = false;
  static constexpr bool kBiasTile = false;
  static constexpr float kMaskedScore = kMasked;

  const int32_t* mask;
  long long mask_sb;
  int seq;
  float scale;
  int heads;
  int fresh;
  float* o;
  float* m;
  float* l;
  __nv_bfloat16* out;
  long long out_sb, out_ss, out_sh;

  __device__ __forceinline__ long long state_row(int b, int h, int row) const {
    return (static_cast<long long>(b) * heads + h) * seq + row;
  }

  __device__ __forceinline__ void begin(int b, int h, int row, int r, int t, float (&acc)[32],
                                        float& mx, float& sum) const {
    const bool carried = !fresh && row < seq;
    const long long i = state_row(b, h, row);
    mx = carried ? m[i] : -INFINITY;
    sum = carried ? l[i] : 0.f;
    const float* src = o + i * kHeadDim + 2 * t;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      const float2 x = carried ? *reinterpret_cast<const float2*>(src + j * 8)
                               : make_float2(0.f, 0.f);
      acc[4 * j + 2 * r] = x.x;
      acc[4 * j + 2 * r + 1] = x.y;
    }
  }

  __device__ __forceinline__ void end(int b, int h, int row, int r, int t,
                                      const float (&acc)[32], float mx, float sum) const {
    if (out != nullptr) {
      const float den = fmaxf(sum, kMinSum);
      __nv_bfloat16* dst = out + b * out_sb + row * out_ss + h * out_sh + 2 * t;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            sm90::pack_bf16(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
      }
      return;
    }
    // The 4 lanes of a quad hold the same m and l; lane t == 0 writes them.
    const long long i = state_row(b, h, row);
    float* dst = o + i * kHeadDim + 2 * t;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
    if (t == 0) {
      m[i] = mx;
      l[i] = sum;
    }
  }
};

int launch_bf16(const Params& p, int batch, int heads, int device,
                cudaStream_t stream) {
  HopOp op;
  op.mask = p.mask;
  op.mask_sb = p.m_sb;
  op.seq = p.seq;
  op.scale = p.scale;
  op.heads = heads;
  op.fresh = p.fresh;
  op.o = p.o;
  op.m = p.m;
  op.l = p.l;
  op.out = static_cast<__nv_bfloat16*>(p.out);
  op.out_sb = p.out_sb;
  op.out_ss = p.out_ss;
  op.out_sh = p.out_sh;
  return sm90::launch(op, {p.q, p.q_sb, p.q_ss, p.q_sh}, {p.k, p.k_sb, p.k_ss, p.k_sh},
                      {p.v, p.v_sb, p.v_ss, p.v_sh}, batch, heads, device, stream);
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

  // The carried state of this thread's four rows (a fresh hop's rows, and
  // rows past the block's end, start at (0, -inf, 0); the latter are never
  // written).
  float acc[4][4];
  float row_max[4];
  float row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool real = row < p.seq && !p.fresh;
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

  // The carried state back, unnormalised (the 16 threads of a row group hold
  // the same m and l, tx == 0 writes them); or, on the final hop, o / l.
  float* out = static_cast<float*>(p.out) + b * p.out_sb + h * p.out_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < p.seq && p.out != nullptr) {
      const float den = fmaxf(row_sum[i], kMinSum);
      *reinterpret_cast<float4*>(out + row * p.out_ss + tx * 4) = make_float4(
          acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
    } else if (row < p.seq) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  o [B, H, S,
// D], m and l [B, H, S]: contiguous float32, read (unless fresh) and updated
// in place (unless out is given).  out: [B, S, H, D] or null; when given the
// hop writes o / max(l, 1e-20) there and no state, so o, m and l may be null
// on a fresh final hop.
// strides: q, k, v (batch, seq, head) each, the mask's batch stride, then
// out (batch, seq, head) -- 13 element strides in that order.  Rows of q/k/v,
// o and out must be 16-byte aligned and, for bf16, q/k/v strides multiples
// of 8 elements (TMA).
// Returns 0, a cudaError_t from the launch, -1 for arguments the kernel does
// not take, or -2 when a TMA descriptor cannot be built.
extern "C" int ring_hop_forward(const void* q, const void* k, const void* v,
                                const int32_t* mask, float* o, float* m, float* l, void* out,
                                int dtype, int fresh, int batch, int seq, int heads,
                                int head_dim, const long long* strides, float scale, int device,
                                void* stream) {
  if (head_dim != kHeadDim || batch < 1 || seq < 1 || heads < 1) return -1;
  if (batch > 65535 || heads > 65535) return -1;
  if (!fresh && (o == nullptr || m == nullptr || l == nullptr)) return -1;
  if (out == nullptr && (o == nullptr || m == nullptr || l == nullptr)) return -1;
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
  p.out = out;
  p.fresh = fresh;
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
  p.out_sb = strides[10];
  p.out_ss = strides[11];
  p.out_sh = strides[12];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, batch, heads, s);
  if (dtype == 1) return launch_bf16(p, batch, heads, device, s);
  return -1;
}

// The bf16 kernel's stages, shared memory, CTAs an SM and launch-bound
// CTAs (sm90::config) at `seq` keys.
extern "C" int ring_hop_config(int seq, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return sm90::config<HopOp>(seq, device, out);
}

extern "C" const char* ring_hop_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  if (code == sm90::kTmaError) return "a TMA tensor map could not be built";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
