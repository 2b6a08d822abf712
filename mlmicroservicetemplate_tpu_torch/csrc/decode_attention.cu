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
// many query heads read it.  Here each CTA serves the R query heads of one
// (KV head, batch row) from one read of its share of the slab: the
// materialized GQA repeat of the plain path is not paid.
//
// What bounds it: bytes.  The function reads K and V once, plus their
// scales, q and the mask, and writes the output: at TinyLlama's serving
// shape (B=8, T=576, KVH=4, D=64, bf16) ~4.7 MB, ~1.4 us at 3.35 TB/s,
// against ~38 MFLOP.  The kernel is the shared decode core
// (csrc/decode_sm90.cuh, whose header has the design): the keys split across
// CTAs so the grid fills the card, tiles with no valid key are never
// loaded, the rest stream through a cp.async pipeline in their stored type,
// and the dense bf16 cache runs on mma.sync; a combine kernel merges the
// splits.
//
// Numerics follow the TPU kernel: scores and softmax in f32; once a row has
// a valid key every masked key weighs exactly 0 (as -1e9 does), and a row
// whose keys are all masked comes out as the plain mean of V over its T
// positions (the reference's uniform softmax).  Dense cache: probabilities
// are rounded to V's type before the PV product, f32 accumulation.  int8
// cache: K = k8 * k_scale and V = v8 * v_scale in f32, probabilities stay
// f32.  The output is in q's type.

#include "decode_sm90.cuh"

// One call, as the wrapper (ops/attention.py) makes it.
// ptrs: q, k, v, k_scale, v_scale, mask, out, ws, stream -- 9 addresses, 0
// for an absent scale (dense cache) and for `ws` at one split.
// plan (built once per call signature): q dtype (0 = float32, 1 =
// bfloat16), kv dtype (0 / 1 dense in q's type, 2 = int8), scale dtype (0 /
// 1 for the int8 cache's scales, -1 dense), batch, cache length T, heads,
// KV heads, head_dim, splits, tiles per split, device, then 17 element
// strides: q (batch, head), k, v, k_scale, v_scale (batch, token, kv head)
// each, out (batch, head), mask batch.  splits x tiles per split 64-key
// tiles cover the T keys (split_plan picks them from B, KVH and T); `ws`
// holds B * KVH * splits * R * (D + 2) floats.  K/V rows must be 16-byte
// aligned (the kernel moves 16 bytes per access); the mask is int32 with
// unit stride along T.  Returns 0, a cudaError_t from a launch, or -1 for
// arguments the kernel does not take.
extern "C" int decode_attention_run(const unsigned long long* ptrs, const long long* plan,
                                    float scale) {
  using namespace decode_sm90;
  const int batch = static_cast<int>(plan[3]), seq = static_cast<int>(plan[4]);
  const int heads = static_cast<int>(plan[5]), kv_heads = static_cast<int>(plan[6]);
  const int device = static_cast<int>(plan[10]);
  if (plan[7] != kHeadDim || batch < 1 || batch > 65535 || kv_heads < 1) return -1;
  if (heads % kv_heads != 0 || heads / kv_heads > kMaxGroup) return -1;
  Params p{};
  p.splits = static_cast<int>(plan[8]);
  p.split_tiles = static_cast<int>(plan[9]);
  p.ws = reinterpret_cast<float*>(ptrs[7]);
  if (!valid_split(seq, p.splits, p.split_tiles, p.ws != nullptr)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.q = reinterpret_cast<const void*>(ptrs[0]);
  p.k = reinterpret_cast<const void*>(ptrs[1]);
  p.v = reinterpret_cast<const void*>(ptrs[2]);
  p.k_scale = reinterpret_cast<const void*>(ptrs[3]);
  p.v_scale = reinterpret_cast<const void*>(ptrs[4]);
  p.keep = reinterpret_cast<const int32_t*>(ptrs[5]);
  p.table = nullptr;
  p.out = reinterpret_cast<void*>(ptrs[6]);
  p.n_keys = seq;
  p.group = heads / kv_heads;
  p.block_size = 1;
  p.num_blocks = 1;
  const long long* st = plan + 11;
  p.q_sb = st[0];
  p.q_sh = st[1];
  p.k_sb = st[2];
  p.k_st = st[3];
  p.k_sh = st[4];
  p.v_sb = st[5];
  p.v_st = st[6];
  p.v_sh = st[7];
  p.ks_sb = st[8];
  p.ks_st = st[9];
  p.ks_sh = st[10];
  p.vs_sb = st[11];
  p.vs_st = st[12];
  p.vs_sh = st[13];
  p.o_sb = st[14];
  p.o_sh = st[15];
  p.keep_sb = st[16];
  p.tbl_sb = 0;
  p.scale_log2 = scale * 1.4426950408889634f;
  return dispatch<false>(p, static_cast<int>(plan[0]), static_cast<int>(plan[1]),
                         static_cast<int>(plan[2]), batch, kv_heads, device,
                         reinterpret_cast<cudaStream_t>(ptrs[8]));
}

extern "C" const char* decode_attention_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
