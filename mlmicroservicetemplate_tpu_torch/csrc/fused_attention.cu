// Encoder self-attention for Hopper (sm_90a): softmax(q.k^T * scale + bias,
// masked keys at -1e9) . v over [B, S, H, D] (D = 64).
//
// Replaces the Pallas TPU kernel mlmicroservicetemplate_tpu/ops/attention.py
// (_attn_body, launched by fused_attention).  That kernel holds one head's
// whole [S, S] f32 score tile in VMEM; at S = 512 that is 1 MB, more than the
// 227 KB of shared memory an SM gives one block.  Here the key axis is walked
// in tiles with an online softmax: the running row max, row sum and output
// accumulator stay in f32 registers, so scores never reach device memory.
//
// What bounds it: at BERT-base's biggest serving bucket (B=32, S=512, H=12,
// D=64, bf16) the function must move ~100 MB (q, k, v in, out back) and do
// ~25.8 GFLOP, i.e. ~30 us of memory time against ~26 us of bf16 tensor-core
// time, so the bound is bytes -- reached only if the tensor cores run near
// their rate, which the first mma.sync design (~160 TFLOP/s) did not.
//
// - bf16 (the serving path) is the shared Hopper main loop of
//   csrc/attention_sm90.cuh: 64 query rows a CTA in one wgmma consumer
//   warpgroup, two CTAs an SM, 128-key K/V tiles brought by TMA from a
//   producer warp through a three-stage mbarrier ring, key tiles with no
//   valid key skipped exactly (the header states why that is exact), and for
//   a batch row with no valid key no Q.K^T at all.  This file adds the Op:
//   scores in log2 units (scale and bias times log2(e), masked keys
//   -1e9·log2(e)), a zero start state, and the epilogue o / l in bf16
//   through the output's strides.  A bf16 bias whose base and row strides
//   are 16-byte aligned (every T5 serving width) is read as TMA tiles
//   through shared memory (the header's bias ring: 16 KB a stage, 2
//   stages, two CTAs an SM; scores in natural units there): T5's B=32,
//   S=512, H=8 padded call went from 0.1399 to 0.0885 ms, SDPA's 0.1026 ms
//   (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md).  Any other bias (f32, or widths such as S = 18
//   or 417 whose rows end off 16 bytes) keeps one global load a score in
//   the same launch path.
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

#include "attention_sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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
// bf16: the shared sm_90a loop (attention_sm90.cuh) with K1's Op

// TB: the bias's element type, or void for no bias.  kTile: a bf16 bias
// read as TMA tiles through shared memory (attention_sm90.cuh), else one
// global load a score.
template <typename TB, bool kTile = false>
struct EncoderOp {
  // Scores in log2 units (scale and bias times log2(e)), except with bias
  // tiles: those hold the bias as it is, so scores stay in natural units,
  // scale and bias are one FFMA and the exp2's FFMA takes log2(e).
  static constexpr bool kBias = !std::is_void<TB>::value;
  static constexpr bool kBiasTile = kTile;
  static constexpr bool kNatural = kTile;
  static constexpr float kMaskedScore = kNatural ? kMasked : kMasked * kLog2e;
  static_assert(!kTile || std::is_same<TB, __nv_bfloat16>::value, "bias tiles are bf16");

  const int32_t* mask;
  long long mask_sb;
  int seq;
  float scale;  // scale, times log2(e) unless kNatural
  const void* bias;
  long long b_sh, b_sq;
  __nv_bfloat16* out;
  long long o_sb, o_ss, o_sh;

  __device__ __forceinline__ void begin(int, int, int, int r, int, float (&o)[32], float& m,
                                        float& l) const {
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) o[4 * j + 2 * r] = o[4 * j + 2 * r + 1] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  // The bias of one score in log2 units (kBias without kTile).  A row past
  // the end is never written and a key past the end scores -inf: neither
  // reads the bias, whose last row ends at the tensor's end.  kFull: col is
  // valid.
  template <bool kFull>
  __device__ __forceinline__ float add(int h, int row, int col) const {
    if (row >= seq || (!kFull && col >= seq)) return 0.f;
    return to_f32(static_cast<const TB*>(bias)[h * b_sh + row * b_sq + col]) * kLog2e;
  }

  __device__ __forceinline__ void end(int b, int h, int row, int r, int t, const float (&o)[32],
                                      float, float l) const {
    const float inv = 1.f / l;
    __nv_bfloat16* dst = out + b * o_sb + row * o_ss + h * o_sh + 2 * t;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          sm90::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
};

template <typename TB, bool kTile = false>
int launch_bf16(const Params& p, int batch, int heads, int device,
                cudaStream_t stream) {
  EncoderOp<TB, kTile> op;
  op.mask = p.mask;
  op.mask_sb = p.m_sb;
  op.seq = p.seq;
  op.scale = EncoderOp<TB, kTile>::kNatural ? p.scale : p.scale * kLog2e;
  op.bias = p.bias;
  op.b_sh = p.b_sh;
  op.b_sq = p.b_sq;
  op.out = static_cast<__nv_bfloat16*>(p.out);
  op.o_sb = p.o_sb;
  op.o_ss = p.o_ss;
  op.o_sh = p.o_sh;
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

}  // namespace

// dtype / bias_dtype: 0 = float32, 1 = bfloat16; bias_dtype -1 = no bias
// (f32 takes an f32 bias, bf16 either).
// strides: q, k, v, out (batch, seq, head) each, then mask batch, then bias
// head and query -- 15 element strides in that order.  Rows must be 16-byte
// aligned and, for bf16, every stride a multiple of 8 elements (TMA).
// Returns 0, a cudaError_t from the launch, -1 for arguments the kernel does
// not take, or -2 when a TMA descriptor cannot be built.
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
  if (dtype == 1 && bias_dtype == -1) return launch_bf16<void>(p, batch, heads, device, s);
  if (dtype == 1 && bias_dtype == 0) return launch_bf16<float>(p, batch, heads, device, s);
  if (dtype == 1 && bias_dtype == 1) {
    return sm90::bias_tileable(bias, p.b_sh, p.b_sq, seq)
               ? launch_bf16<__nv_bfloat16, true>(p, batch, heads, device, s)
               : launch_bf16<__nv_bfloat16, false>(p, batch, heads, device, s);
  }
  return -1;
}

// 1 when fused_attention_forward reads a bias of this dtype, base and
// strides as TMA tiles through shared memory, 0 when one load a score.
extern "C" int fused_attention_bias_tiled(int dtype, int bias_dtype, const void* bias,
                                          long long b_sh, long long b_sq, int seq) {
  return dtype == 1 && bias_dtype == 1 && sm90::bias_tileable(bias, b_sh, b_sq, seq);
}

// The bf16 kernel's stages, shared memory, CTAs an SM and launch-bound
// CTAs (sm90::config) at `seq` keys: no bias (bias_dtype -1), a bias of
// bias_dtype read one load a score (tiled 0) or as tiles (tiled 1, bf16).
extern "C" int fused_attention_config(int bias_dtype, int tiled, int seq, int device,
                                      int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bias_dtype == -1) return sm90::config<EncoderOp<void>>(seq, device, out);
  if (bias_dtype == 0 && !tiled) return sm90::config<EncoderOp<float>>(seq, device, out);
  if (bias_dtype == 1 && !tiled) return sm90::config<EncoderOp<__nv_bfloat16>>(seq, device, out);
  if (bias_dtype == 1) return sm90::config<EncoderOp<__nv_bfloat16, true>>(seq, device, out);
  return -1;
}

extern "C" const char* fused_attention_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  if (code == sm90::kTmaError) return "a TMA tensor map could not be built";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
