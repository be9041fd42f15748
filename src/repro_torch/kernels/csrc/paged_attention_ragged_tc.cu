// Per-token flat-stream paged attention for Hopper (sm_90a), bf16 q with
// bf16 or int8 pools: the tensor-core redesign of
// paged_attention_ragged.cu, which keeps float32 inputs.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_ragged (body _ragged_attn_kernel), the attention read of
// the paged engine's tiled=False step: one flat stream of T query tokens
// from many lanes, where token t attends over its own lane's blocks
// (token_tables[t], the lane's block-table row repeated per token) up to
// its absolute position token_pos[t].
//
// What bounds it on the H100: bytes, more of them than the work needs,
// since every token reads its lane's K/V blocks up to its own position (a
// segment of n tokens re-reads the lane's context n times; the segment-
// tiled kernel reads it once a tile).  The read stays per token, as the
// TPU kernel has it, so it remains the honest per-token baseline: one CTA
// per (token, 16 of its G query heads, kv head), launched in stream order
// so that a lane's tokens run together and find its blocks in L2, through
// the split sweep of paged_attention_split.cuh (warps on their own key
// tiles, cp.async rings, mma.sync m16n8k16).  Few tokens (fewer CTAs than
// two waves) cut their key ranges into splits merged by a second kernel.
// Padding tokens (an all-zero table row, position 0) read the null
// block's first key and write finite values.

#include "paged_attention_split.cuh"

using namespace paged_split;

namespace {

// work item i = (token i / groups, query heads 16 (i % groups) .. of its
// G); q and out (T, Hkv, G, D)
struct TokenItems {
  const int* token_tables;
  const int* token_pos;
  int Hkv, G, groups, max_blocks, D;

  __device__ int rows(int i) const {
    const int n = G - 16 * (i % groups);
    return n < 16 ? n : 16;
  }
  __device__ int slots(int i) const { return rows(i); }
  __device__ int pos(int i, int) const { return token_pos[i / groups]; }
  __device__ long long off(int i, int h, int r) const {
    const long long t = i / groups;
    return ((t * Hkv + h) * G + 16 * (i % groups) + r) * D;
  }
  __device__ const int* table(int i) const {
    return token_tables + static_cast<long long>(i / groups) * max_blocks;
  }
};

}  // namespace

extern "C" {

// q and out (T, Hkv, G, D) bf16; token_tables (T, max_blocks) and
// token_pos (T,) int32; acc and ml the split scratch (float32 (n_splits,
// T * groups, Hkv, R, D) and (..., R, 2), R = min(16, G); unused when
// n_splits is 1).  pool_dtype 1 bf16, 2 int8 (with float32 scales).
// Returns cudaGetLastError() after the launches (0 = success).
int paged_attention_ragged_tc_launch(const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale,
                                     const void* token_tables,
                                     const void* token_pos, void* out,
                                     void* acc, void* ml, int pool_dtype,
                                     int D, int T, int Hkv, int G, int bs,
                                     int max_blocks, int window,
                                     int split_blocks, int n_splits,
                                     float scale, void* stream) {
  if (T <= 0) return 0;
  const int groups = (G + kRows - 1) / kRows;
  const TokenItems items{static_cast<const int*>(token_tables),
                         static_cast<const int*>(token_pos), Hkv, G, groups,
                         max_blocks, D};
  const Launch L{static_cast<const __nv_bfloat16*>(q),
                 static_cast<__nv_bfloat16*>(out), static_cast<float*>(acc),
                 static_cast<float2*>(ml), T * groups, max_blocks,
                 split_blocks, G < kRows ? G : kRows};
  const int bs_shift = __builtin_ctz(static_cast<unsigned>(bs));
  const Pools p{k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale), Hkv, bs_shift, window,
                scale * kLog2e};
  return dispatch(pool_dtype, D, items, L, p, n_splits,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
