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
// Here each CTA walks its share of a row's table itself, 64 logical keys
// (four 16-token blocks at the default block size) a tile, loading each key
// through the table; the R query heads of the group are served from that
// one load.  The gather of the plain version (a dense [B, T * BS] copy of
// the pool, expanded to H heads) never exists.
//
// What bounds it: bytes.  The function reads each row's K and V blocks once
// (plus scales, q, the table and key_valid) and writes the output: at the
// serving shape (B=16, T=36 blocks of 16, KVH=4, D=64, bf16) ~9.4 MB,
// ~2.8 us at 3.35 TB/s, against ~75 MFLOP.  The kernel is the shared decode
// core (csrc/decode_sm90.cuh, whose header has the design), as K2's is: the
// table splits across CTAs in whole blocks, so the grid fills the card;
// each CTA loads its table slice first, never loads a tile with no valid
// key, streams the rest through a cp.async pipeline, and the dense bf16
// pool runs on mma.sync; a combine kernel merges the splits.
//
// Numerics follow paged_attention_ref: table entries outside [0, NB) (the
// freed-slot sentinel) clamp to NB - 1 before any load; scores and softmax
// in f32; once a row has a valid key every invalid key weighs exactly 0 (as
// -1e30 does), and a row with no valid key comes out as the plain mean of
// its T * BS gathered values (sentinels clamped); probabilities stay f32
// for the f32 and int8 pools (K = k8 * k_scale, V = v8 * v_scale in f32)
// and are rounded to bf16 for the PV product of a bf16 pool, with f32
// accumulation; the output is acc / max(l, 1e-20) in q's type.

#include "decode_sm90.cuh"

// One call, as the wrapper (ops/paged_attention.py) makes it.
// ptrs: q, k, v, k_scale, v_scale, table, key_valid, out, ws, stream -- 10
// addresses, 0 for an absent scale (dense pools) and for `ws` at one split.
// plan (built once per call signature): q dtype (0 = float32, 1 =
// bfloat16), kv dtype (0 / 1 dense in q's type, 2 = int8), scale dtype (0 /
// 1 for the int8 pools' scales, -1 dense), batch, blocks NB, block size
// BS, table width T, heads, KV heads, head_dim, splits, tiles per split,
// device, then 18 element strides: q (batch, head); k, v, k_scale, v_scale
// (block, token, kv head) each; out (batch, head); table batch; key_valid
// batch.  splits x tiles per split 64-key tiles cover the T * BS keys
// (split_plan); `ws` holds B * KVH * splits * R * (D + 2) floats.  Pool
// rows must be 16-byte aligned (the kernel moves 16 bytes per access);
// table and key_valid are int32 with unit stride along their last axis.
// Returns 0, a cudaError_t from a launch, or -1 for arguments the kernel
// does not take.
extern "C" int paged_decode_attention_run(const unsigned long long* ptrs, const long long* plan,
                                          float scale) {
  using namespace decode_sm90;
  const int batch = static_cast<int>(plan[3]), num_blocks = static_cast<int>(plan[4]);
  const int block_size = static_cast<int>(plan[5]), table_width = static_cast<int>(plan[6]);
  const int heads = static_cast<int>(plan[7]), kv_heads = static_cast<int>(plan[8]);
  const int device = static_cast<int>(plan[12]);
  if (plan[9] != kHeadDim || batch < 1 || batch > 65535 || kv_heads < 1) return -1;
  if (num_blocks < 1 || block_size < 1 || table_width < 1) return -1;
  if (heads % kv_heads != 0 || heads / kv_heads > kMaxGroup) return -1;
  const long long n_keys = static_cast<long long>(table_width) * block_size;
  if (n_keys > (1LL << 30)) return -1;
  Params p{};
  p.splits = static_cast<int>(plan[10]);
  p.split_tiles = static_cast<int>(plan[11]);
  p.ws = reinterpret_cast<float*>(ptrs[8]);
  if (!valid_split(static_cast<int>(n_keys), p.splits, p.split_tiles, p.ws != nullptr)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.q = reinterpret_cast<const void*>(ptrs[0]);
  p.k = reinterpret_cast<const void*>(ptrs[1]);
  p.v = reinterpret_cast<const void*>(ptrs[2]);
  p.k_scale = reinterpret_cast<const void*>(ptrs[3]);
  p.v_scale = reinterpret_cast<const void*>(ptrs[4]);
  p.table = reinterpret_cast<const int32_t*>(ptrs[5]);
  p.keep = reinterpret_cast<const int32_t*>(ptrs[6]);
  p.out = reinterpret_cast<void*>(ptrs[7]);
  p.n_keys = static_cast<int>(n_keys);
  p.group = heads / kv_heads;
  p.block_size = block_size;
  p.num_blocks = num_blocks;
  const long long* st = plan + 13;
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
  p.tbl_sb = st[16];
  p.keep_sb = st[17];
  p.scale_log2 = scale * 1.4426950408889634f;
  return dispatch<true>(p, static_cast<int>(plan[0]), static_cast<int>(plan[1]),
                        static_cast<int>(plan[2]), batch, kv_heads, device,
                        reinterpret_cast<cudaStream_t>(ptrs[9]));
}

extern "C" const char* paged_decode_attention_error_string(int code) {
  if (code == -1) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
