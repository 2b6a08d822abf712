// One decode step's attention over a contiguous KV cache, for Hopper
// (sm_90a): out[b, h] = softmax(q[b, h] . K[b, :, h / R]^T * scale, masked
// keys at -1e9) . V[b, :, h / R], with R = H / KVH query heads per KV head
// (grouped-query attention).  The cache is dense (bf16 or f32, q's type) or
// int8 with one scale per (token, KV head), dequantized here.
//
// Replaces the Pallas TPU kernel mlmicroservicetemplate_tpu/ops/attention.py
// (decode_attention; bodies _decode_body through _decode_kernel and
// _decode_kernel_kv8, and the tuning variants of _decode_body_v, which
// compute the same function).  That kernel gives one program a batch row and
// loops over its KV heads, so each KV head's slab crosses HBM once however
// many query heads read it.  Here one CTA takes one (KV head, batch row) and
// serves the R query heads of its group from one read of the slab: the
// materialized GQA repeat of the plain path (one cache read per query head)
// is not paid.  The CTA walks the cache in 64-key tiles with an f32 online
// softmax; scores stay in shared memory.
//
// What bounds it: bytes.  The function reads K and V once, plus their
// scales, q and the mask, and writes the output: at TinyLlama's serving
// shape (B=8, T=576, KVH=4, D=64, bf16) that is ~4.7 MB, ~1.4 us at
// 3.35 TB/s, against ~38 MFLOP (0.04 us of bf16 tensor-core time).  This
// first version is plain: scalar f32 FMAs (the work is tiny), single-
// buffered 16-byte loads, B x KVH CTAs (32 at B=8, a quarter of the 132
// SMs) and no split of T across CTAs, so it stays well above the bound;
// splitting T and prefetching tiles are later work.  At these sizes the
// launch and the host's wrapper cost more than the kernel.
//
// Numerics follow the TPU kernel: scores and softmax in f32, masked keys at
// -1e9 (never -inf), so a row whose keys are all masked comes out as the
// uniform average of V; keys past T inside the last tile get -inf and weigh
// exactly 0.  Dense cache: probabilities are rounded to V's type before the
// PV product, f32 accumulation.  int8 cache: K = k8 * k_scale and
// V = v8 * v_scale in f32, probabilities stay f32.  The output is in q's
// type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;       // keys per tile
constexpr int kMaxGroup = 16;   // query heads per KV head
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kMaxGroup / kWarps;
constexpr int kAccPerThread = kMaxGroup * kHeadDim / kThreads;
constexpr int kLdk = kHeadDim + 1;  // padded row of the f32 key tile
constexpr float kMasked = -1e9f;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;        // [B, H, D]
  const void* k;        // [B, T, KVH, D]
  const void* v;
  const void* k_scale;  // [B, T, KVH, 1] or null (dense cache)
  const void* v_scale;
  const int32_t* mask;  // [B, T], stride 1 along T
  void* out;            // [B, H, D]
  int seq;              // T
  int group;            // R
  // Element strides; the head_dim stride is 1.
  long long q_sb, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long ks_sb, ks_st, ks_sh;
  long long vs_sb, vs_st, vs_sh;
  long long o_sb, o_sh;
  long long m_sb;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// A probability as the PV product takes it: rounded to a bf16 cache's type,
// kept in f32 for an f32 or int8 cache.
template <typename TKV>
__device__ __forceinline__ float round_prob(float x) { return x; }
template <>
__device__ __forceinline__ float round_prob<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Loads rows [0, rows) of a [64, 64] cache tile (row r at src + r *
// row_stride) into f32 shared rows of `ld`, times the row's scale when
// `scale` is given; rows at or past `rows` are zero.  16 bytes per access.
template <typename TKV, typename TS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const TKV* src,
                                          long long row_stride, const TS* scale,
                                          long long scale_stride, int rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  constexpr int kPerRow = kHeadDim / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* o = dst + r * ld + c;
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      const TKV* x = reinterpret_cast<const TKV*>(&raw);
      if (scale != nullptr) {
        const float s = to_f32(scale[r * scale_stride]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = to_f32(x[e]) * s;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = to_f32(x[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = 0.f;
    }
  }
}

template <typename TQ, typename TKV, typename TS>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
  __shared__ float q_s[kMaxGroup * kHeadDim];  // the group's queries
  __shared__ float k_s[kTile * kLdk];          // [key][d]
  __shared__ float v_s[kTile * kHeadDim];      // [key][d]
  __shared__ float p_s[kMaxGroup * kTile];     // [row][key] scores, then probs
  __shared__ float alpha_s[kMaxGroup];         // this tile's rescale per row
  __shared__ float sum_s[kMaxGroup];
  // per key of a tile: 1 keep, 0 masked (-1e9), -1 past the cache end
  __shared__ int8_t keep_s[kTile];

  const int g = blockIdx.x;  // KV head
  const int b = blockIdx.y;
  const int group = p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb + g * group * p.q_sh;
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.k_sb + g * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.v_sb + g * p.v_sh;
  const TS* ks = p.k_scale == nullptr
                     ? nullptr
                     : static_cast<const TS*>(p.k_scale) + b * p.ks_sb + g * p.ks_sh;
  const TS* vs = p.v_scale == nullptr
                     ? nullptr
                     : static_cast<const TS*>(p.v_scale) + b * p.vs_sb + g * p.vs_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  TQ* out = static_cast<TQ*>(p.out) + b * p.o_sb + g * group * p.o_sh;

  for (int i = threadIdx.x; i < group * kHeadDim; i += kThreads) {
    q_s[i] = to_f32(q[(i / kHeadDim) * p.q_sh + i % kHeadDim]);
  }

  // Row r's running max and sum live in warp r % kWarps (every lane holds
  // them), slot r / kWarps.
  float row_max[kRowsPerWarp];
  float row_sum[kRowsPerWarp];
#pragma unroll
  for (int s = 0; s < kRowsPerWarp; ++s) {
    row_max[s] = -INFINITY;
    row_sum[s] = 0.f;
  }
  // Output entry (row, d) = idx / 64, idx % 64 for idx = threadIdx.x + j *
  // kThreads, j < kAccPerThread.
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;

  const int n_tiles = (p.seq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    const int rows = min(kTile, p.seq - t0);
    __syncthreads();  // the previous tile's reads of k_s, v_s, p_s are done
    load_tile<TKV, TS>(k_s, kLdk, k + t0 * p.k_st, p.k_st,
                       ks == nullptr ? nullptr : ks + t0 * p.ks_st, p.ks_st, rows);
    load_tile<TKV, TS>(v_s, kHeadDim, v + t0 * p.v_st, p.v_st,
                       vs == nullptr ? nullptr : vs + t0 * p.vs_st, p.vs_st, rows);
    if (threadIdx.x < kTile) {
      const int t = t0 + threadIdx.x;
      keep_s[threadIdx.x] = t >= p.seq ? -1 : (mask[t] != 0 ? 1 : 0);
    }
    __syncthreads();

    // Scores: a warp takes 32 keys of one row (lanes on consecutive keys;
    // the padded key rows keep their reads on distinct banks).
    for (int i = threadIdx.x; i < group * kTile; i += kThreads) {
      const float* qr = q_s + (i / kTile) * kHeadDim;
      const int j = i % kTile;
      const float* kj = k_s + j * kLdk;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHeadDim; ++d) s = fmaf(qr[d], kj[d], s);
      const int keep = keep_s[j];
      // Keys past the end get -inf and weigh exactly 0; every tile holds
      // at least one real key, so the running max stays finite.
      p_s[i] = keep > 0 ? s * p.scale : (keep == 0 ? kMasked : -INFINITY);
    }
    __syncthreads();

    // Online softmax in f32, one warp per row, two keys per lane.
#pragma unroll
    for (int slot = 0; slot < kRowsPerWarp; ++slot) {
      const int r = warp + slot * kWarps;
      if (r < group) {
        float* pr = p_s + r * kTile;
        const float s0 = pr[lane];
        const float s1 = pr[lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(row_max[slot], mx);
        const float alpha = expf(row_max[slot] - m_new);
        const float e0 = expf(s0 - m_new);
        const float e1 = expf(s1 - m_new);
        float sum = e0 + e1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        row_sum[slot] = row_sum[slot] * alpha + sum;
        row_max[slot] = m_new;
        pr[lane] = round_prob<TKV>(e0);
        pr[lane + 32] = round_prob<TKV>(e1);
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V: lanes on consecutive head dims of one row.
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      if (idx < group * kHeadDim) {
        const int r = idx / kHeadDim;
        const int d = idx % kHeadDim;
        const float* pr = p_s + r * kTile;
        float a = acc[j] * alpha_s[r];
#pragma unroll 16
        for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], v_s[t * kHeadDim + d], a);
        acc[j] = a;
      }
    }
  }

#pragma unroll
  for (int slot = 0; slot < kRowsPerWarp; ++slot) {
    const int r = warp + slot * kWarps;
    if (r < group && lane == 0) sum_s[r] = row_sum[slot];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    if (idx < group * kHeadDim) {
      const int r = idx / kHeadDim;
      store(out + r * p.o_sh + idx % kHeadDim, acc[j] / sum_s[r]);
    }
  }
}

template <typename TQ, typename TKV, typename TS>
int launch(const Params& p, int batch, int kv_heads, cudaStream_t stream) {
  const dim3 grid(kv_heads, batch);
  decode_attention_kernel<TQ, TKV, TS><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = float32, 1 = bfloat16
// (dense: q's type), 2 = int8.  scale_dtype: 0 / 1 for the int8 cache's
// scales, -1 for a dense cache.
// strides: q (batch, head), k, v, k_scale, v_scale (batch, token, kv head)
// each, out (batch, head), mask batch -- 17 element strides in that order.
// K/V rows must be 16-byte aligned (the kernel moves 16 bytes per access).
// Returns 0, a cudaError_t from the launch, or -1 for arguments the kernel
// does not take.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const int32_t* mask, void* out, int q_dtype,
    int kv_dtype, int scale_dtype, int batch, int seq, int heads, int kv_heads,
    int head_dim, const long long* strides, float scale, int device, void* stream) {
  if (head_dim != kHeadDim || batch < 1 || seq < 1 || kv_heads < 1) return -1;
  if (heads % kv_heads != 0 || heads / kv_heads > kMaxGroup) return -1;
  if (batch > 65535) return -1;
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.mask = mask;
  p.out = out;
  p.seq = seq;
  p.group = heads / kv_heads;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sb = strides[2];
  p.k_st = strides[3];
  p.k_sh = strides[4];
  p.v_sb = strides[5];
  p.v_st = strides[6];
  p.v_sh = strides[7];
  p.ks_sb = strides[8];
  p.ks_st = strides[9];
  p.ks_sh = strides[10];
  p.vs_sb = strides[11];
  p.vs_st = strides[12];
  p.vs_sh = strides[13];
  p.o_sb = strides[14];
  p.o_sh = strides[15];
  p.m_sb = strides[16];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float, float>(p, batch, kv_heads, s);
  if (q_dtype == 1 && kv_dtype == 1) return launch<bf16, bf16, float>(p, batch, kv_heads, s);
  if (quant && q_dtype == 0 && scale_dtype == 0)
    return launch<float, int8_t, float>(p, batch, kv_heads, s);
  if (quant && q_dtype == 0 && scale_dtype == 1)
    return launch<float, int8_t, bf16>(p, batch, kv_heads, s);
  if (quant && q_dtype == 1 && scale_dtype == 0)
    return launch<bf16, int8_t, float>(p, batch, kv_heads, s);
  if (quant && q_dtype == 1 && scale_dtype == 1)
    return launch<bf16, int8_t, bf16>(p, batch, kv_heads, s);
  return -1;
}

extern "C" const char* decode_attention_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
