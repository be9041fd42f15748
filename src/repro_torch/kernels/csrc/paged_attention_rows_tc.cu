// Rectangular (per-lane chunk) paged attention for Hopper (sm_90a), bf16
// q with bf16 or int8 pools: the tensor-core redesign of
// paged_attention_rows.cu, which keeps float32 inputs.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// _paged_attention_rows (body _paged_attn_kernel), behind paged_attention
// (decode, C = 1) and paged_attention_chunk: the attention read of the
// paged engine's ragged=False step.  Lane b carries a chunk of C query
// tokens, token c at absolute position q_starts[b] + c, and attends
// causally over its blocks (block_tables[b]); ctx_lens[b] = q_starts[b] +
// q_lens[b] is its valid KV length after the chunk.
//
// What bounds it on the H100: bytes (each needed K/V block read once a
// kv head), which the FMA kernel missed by 20x: one warp of eight worked
// on a decode row, loads and compute alternated, the dot products ran out
// of shared memory, and one CTA swept a whole lane.  Here the work is the
// shared split sweep of paged_attention_split.cuh: one CTA per (lane, 16
// of its C x G rows, kv head, key split), its warps on their own key
// tiles through cp.async rings, q . k^T and p . v on the tensor cores
// (mma.sync m16n8k16), and the splits merged by a second kernel when the
// wrapper cut the key ranges (fewer CTAs than two waves).  Chunk rows at
// or past ctx_lens are written as zeros; a lane with ctx = 0 touches no
// block.

#include "paged_attention_split.cuh"

using namespace paged_split;

namespace {

// work item i = (lane i / groups, rows 16 (i % groups) .. of its C x G
// rows, row r = token r / G, query head r % G); q and out (B, C, Hkv, G, D).
// Without q_starts (decode) lane b's one token sits at ctx_lens[b] - 1.
struct RowsItems {
  const int* tables;
  const int* ctx_lens;
  const int* q_starts;
  int C, Hkv, G, groups, max_blocks, D;

  __device__ int start(int b) const {
    return q_starts != nullptr ? q_starts[b] : ctx_lens[b] - 1;
  }
  __device__ int rows(int i) const {
    const int b = i / groups;
    int tokens = ctx_lens[b] - start(b);
    if (tokens > C) tokens = C;
    const int n = tokens * G - 16 * (i % groups);
    return n < 16 ? n : 16;
  }
  __device__ int slots(int i) const {
    const int n = C * G - 16 * (i % groups);
    return n < 16 ? n : 16;
  }
  __device__ int pos(int i, int r) const {
    return start(i / groups) + (16 * (i % groups) + r) / G;
  }
  __device__ long long off(int i, int h, int r) const {
    const int row = 16 * (i % groups) + r;
    const long long tok = static_cast<long long>(i / groups) * C + row / G;
    return ((tok * Hkv + h) * G + row % G) * D;
  }
  __device__ const int* table(int i) const {
    return tables + static_cast<long long>(i / groups) * max_blocks;
  }
};

}  // namespace

extern "C" {

// q and out (B, C, Hkv, G, D) bf16; block_tables (B, max_blocks),
// ctx_lens and q_starts (B,) int32 (q_starts null: decode, C = 1 at
// ctx_lens - 1); every row of out is written.  acc and ml are the split
// scratch, float32 (n_splits, B * groups, Hkv, R, D) and (..., R, 2), R =
// min(16, C * G), unused when n_splits is 1.  pool_dtype 1 bf16, 2 int8
// (with float32 scales).  Returns cudaGetLastError() after the launches
// (0 = success).
int paged_attention_rows_tc_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* ctx_lens, const void* q_starts,
                                   void* out, void* acc, void* ml,
                                   int pool_dtype, int D, int B, int C,
                                   int Hkv, int G, int bs, int max_blocks,
                                   int window, int split_blocks, int n_splits,
                                   float scale, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const int groups = (C * G + kRows - 1) / kRows;
  const RowsItems items{static_cast<const int*>(tables),
                        static_cast<const int*>(ctx_lens),
                        static_cast<const int*>(q_starts),
                        C, Hkv, G, groups, max_blocks, D};
  const Launch L{static_cast<const __nv_bfloat16*>(q),
                 static_cast<__nv_bfloat16*>(out), static_cast<float*>(acc),
                 static_cast<float2*>(ml), B * groups, max_blocks,
                 split_blocks, C * G < kRows ? C * G : kRows};
  const int bs_shift = __builtin_ctz(static_cast<unsigned>(bs));
  const Pools p{k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale), Hkv, bs_shift, window,
                scale * kLog2e};
  return dispatch(pool_dtype, D, items, L, p, n_splits,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
