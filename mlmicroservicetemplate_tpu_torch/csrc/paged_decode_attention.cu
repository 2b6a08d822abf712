// One decode step's attention over a block-paged KV pool, for Hopper
// (sm_90a).  Logical key position p of batch row b lives at
// pool[table[b, p / BS], p % BS]; out[b, h] = softmax(q[b, h] . K^T * scale,
// invalid keys at -1e30) . V over the row's T * BS logical positions, where
// query head h reads KV head h / R (R = H / KVH, grouped-query attention).
// The pools are dense (bf16 or f32, q's type) or int8 with one scale per
// (block, token, KV head) in scale pools of their own, dequantized here.
//
// Replaces the Pallas TPU kernel mlmicroservicetemplate_tpu/ops/
// paged_attention.py (paged_decode_attention; bodies _paged_kernel_v and
// _fold_block, and the tuning variants of the same function).  That kernel
// runs a sequential grid (row, block) whose index maps DMA each table-named
// block into VMEM and carry m, l and acc in scratch across the block axis.
// Here one CTA takes one (KV head, batch row) and walks the row's table
// itself, 64 logical keys (four 16-token blocks at the default block size)
// per tile: each tile row is loaded through the table into shared memory
// as f32 (dequantized there for int8), and the R query heads of the group
// are served from that one load with an f32 online softmax.  The gather of
// the plain version (a dense [B, T * BS] copy of the pool, expanded to H
// heads) never exists.
//
// What bounds it: bytes.  The function reads each row's K and V blocks once
// (plus scales, q, the table and key_valid) and writes the output: at the
// serving shape (B=16, T=36 blocks of 16, KVH=4, D=64, bf16) ~9.4 MB,
// ~2.8 us at 3.35 TB/s, against ~75 MFLOP (0.08 us of bf16 tensor-core
// time).  This first version is plain, like the contiguous decode kernel
// it follows: scalar f32 FMAs, single-buffered 16-byte loads, B x KVH CTAs
// and no split of the table across CTAs, so a serial tile loop, not bytes,
// sets its time; splitting the table (flash-decoding) and prefetching the
// next tile's blocks are later work.
//
// Numerics follow paged_attention_ref: table entries outside [0, NB) (the
// freed-slot sentinel) clamp to NB - 1 before any load; scores and softmax
// in f32; invalid keys score -1e30, so a row with no valid key comes out as
// the uniform average of its gathered values; keys past T * BS inside the
// last tile get -inf and weigh exactly 0; probabilities stay f32 for every
// pool type (K = k8 * k_scale, V = v8 * v_scale in f32 for int8); the output
// is acc / max(l, 1e-20) in q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;       // logical keys per tile
constexpr int kMaxGroup = 16;   // query heads per KV head
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kMaxGroup / kWarps;
constexpr int kAccPerThread = kMaxGroup * kHeadDim / kThreads;
constexpr int kLdk = kHeadDim + 1;  // padded row of the f32 key tile
constexpr float kInvalid = -1e30f;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;          // [B, H, D]
  const void* k;          // [NB, BS, KVH, D]
  const void* v;
  const void* k_scale;    // [NB, BS, KVH, 1] or null (dense pools)
  const void* v_scale;
  const int32_t* table;   // [B, T], stride 1 along T
  const int32_t* valid;   // [B, T * BS], stride 1 along keys
  void* out;              // [B, H, D]
  int num_blocks;         // NB
  int block_size;         // BS
  int n_keys;             // T * BS
  int group;              // R
  // Element strides; the head_dim stride is 1.
  long long q_sb, q_sh;
  long long k_sn, k_st, k_sh;
  long long v_sn, v_st, v_sh;
  long long ks_sn, ks_st, ks_sh;
  long long vs_sn, vs_st, vs_sh;
  long long o_sb, o_sh;
  long long tbl_sb, val_sb;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// Loads tile rows [0, 64) into f32 shared rows of `ld`: row r is token
// off_s[r] of pool block blk_s[r] (src + blk * sn + off * st), times its
// scale when `scale` is given; rows with keep_s[r] < 0 (past the row's
// keys) are zero.  16 bytes per access.
template <typename TKV, typename TS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const TKV* src, long long sn,
                                          long long st, const TS* scale, long long s_sn,
                                          long long s_st, const int* blk_s, const int* off_s,
                                          const int8_t* keep_s) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  constexpr int kPerRow = kHeadDim / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* o = dst + r * ld + c;
    if (keep_s[r] >= 0) {
      const long long blk = blk_s[r];
      const long long off = off_s[r];
      const uint4 raw = *reinterpret_cast<const uint4*>(src + blk * sn + off * st + c);
      const TKV* x = reinterpret_cast<const TKV*>(&raw);
      if (scale != nullptr) {
        const float s = to_f32(scale[blk * s_sn + off * s_st]);
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
paged_decode_attention_kernel(const Params p) {
  __shared__ float q_s[kMaxGroup * kHeadDim];  // the group's queries
  __shared__ float k_s[kTile * kLdk];          // [key][d]
  __shared__ float v_s[kTile * kHeadDim];      // [key][d]
  __shared__ float p_s[kMaxGroup * kTile];     // [row][key] scores, then probs
  __shared__ float alpha_s[kMaxGroup];         // this tile's rescale per row
  __shared__ float sum_s[kMaxGroup];
  __shared__ int blk_s[kTile];                 // pool block of each tile key
  __shared__ int off_s[kTile];                 // its token within the block
  // per key of a tile: 1 valid, 0 invalid (-1e30), -1 past the row's keys
  __shared__ int8_t keep_s[kTile];

  const int g = blockIdx.x;  // KV head
  const int b = blockIdx.y;
  const int group = p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb + g * group * p.q_sh;
  const TKV* k = static_cast<const TKV*>(p.k) + g * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + g * p.v_sh;
  const TS* ks = p.k_scale == nullptr ? nullptr : static_cast<const TS*>(p.k_scale) + g * p.ks_sh;
  const TS* vs = p.v_scale == nullptr ? nullptr : static_cast<const TS*>(p.v_scale) + g * p.vs_sh;
  const int32_t* table = p.table + b * p.tbl_sb;
  const int32_t* valid = p.valid + b * p.val_sb;
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

  const int n_tiles = (p.n_keys + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    __syncthreads();  // the previous tile's reads of every shared array are done
    if (threadIdx.x < kTile) {
      const int t = t0 + threadIdx.x;
      int blk = 0;
      int off = 0;
      int8_t keep = -1;
      if (t < p.n_keys) {
        blk = min(max(table[t / p.block_size], 0), p.num_blocks - 1);
        off = t % p.block_size;
        keep = valid[t] != 0 ? 1 : 0;
      }
      blk_s[threadIdx.x] = blk;
      off_s[threadIdx.x] = off;
      keep_s[threadIdx.x] = keep;
    }
    __syncthreads();
    load_tile<TKV, TS>(k_s, kLdk, k, p.k_sn, p.k_st, ks, p.ks_sn, p.ks_st, blk_s, off_s,
                       keep_s);
    load_tile<TKV, TS>(v_s, kHeadDim, v, p.v_sn, p.v_st, vs, p.vs_sn, p.vs_st, blk_s, off_s,
                       keep_s);
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
      p_s[i] = keep > 0 ? s * p.scale : (keep == 0 ? kInvalid : -INFINITY);
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
        pr[lane] = e0;
        pr[lane + 32] = e1;
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
      store(out + r * p.o_sh + idx % kHeadDim, acc[j] / fmaxf(sum_s[r], 1e-20f));
    }
  }
}

template <typename TQ, typename TKV, typename TS>
int launch(const Params& p, int batch, int kv_heads, cudaStream_t stream) {
  const dim3 grid(kv_heads, batch);
  paged_decode_attention_kernel<TQ, TKV, TS><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  kv_dtype: 0 = float32, 1 = bfloat16
// (dense pools: q's type), 2 = int8.  scale_dtype: 0 / 1 for the int8
// pools' scales, -1 for dense pools.
// strides: q (batch, head); k, v, k_scale, v_scale (block, token, kv head)
// each; out (batch, head); table batch; key_valid batch -- 18 element
// strides in that order.  Pool rows must be 16-byte aligned (the kernel
// moves 16 bytes per access).  Returns 0, a cudaError_t from the launch, or
// -1 for arguments the kernel does not take.
extern "C" int paged_decode_attention_forward(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const int32_t* table, const int32_t* key_valid, void* out, int q_dtype, int kv_dtype,
    int scale_dtype, int batch, int num_blocks, int block_size, int table_width, int heads,
    int kv_heads, int head_dim, const long long* strides, float scale, int device,
    void* stream) {
  if (head_dim != kHeadDim || batch < 1 || kv_heads < 1) return -1;
  if (num_blocks < 1 || block_size < 1 || table_width < 1) return -1;
  if (heads % kv_heads != 0 || heads / kv_heads > kMaxGroup) return -1;
  if (batch > 65535) return -1;
  const long long n_keys = static_cast<long long>(table_width) * block_size;
  if (n_keys > (1LL << 30)) return -1;
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
  p.table = table;
  p.valid = key_valid;
  p.out = out;
  p.num_blocks = num_blocks;
  p.block_size = block_size;
  p.n_keys = static_cast<int>(n_keys);
  p.group = heads / kv_heads;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sn = strides[2];
  p.k_st = strides[3];
  p.k_sh = strides[4];
  p.v_sn = strides[5];
  p.v_st = strides[6];
  p.v_sh = strides[7];
  p.ks_sn = strides[8];
  p.ks_st = strides[9];
  p.ks_sh = strides[10];
  p.vs_sn = strides[11];
  p.vs_st = strides[12];
  p.vs_sh = strides[13];
  p.o_sb = strides[14];
  p.o_sh = strides[15];
  p.tbl_sb = strides[16];
  p.val_sb = strides[17];
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

extern "C" const char* paged_decode_attention_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
