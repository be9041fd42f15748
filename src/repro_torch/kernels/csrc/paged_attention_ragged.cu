// Per-token flat-stream paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_ragged (body _ragged_attn_kernel), the attention read of
// the paged engine's tiled=False step: one flat stream of T query tokens
// from many lanes, where token t attends over its own lane's blocks
// (token_tables[t], the lane's block-table row repeated per token) up to
// its absolute position token_pos[t].
//
// What the function needs is bytes, and more of them than the work
// needs: every token reads its lane's K/V blocks up to its own position,
// so a segment of n tokens re-reads the lane's context n times (the
// segment-tiled kernel, paged_attention_tiled.cu, reads it once per
// tile).  That is the baseline's nature, kept as the TPU kernel has it.
// What bounds this FMA kernel on the H100 is not those bytes but shared-
// memory traffic and the serial sweep of paged_attention_common.cuh (one
// warp of eight works on a token's G rows; PERF.md).  It stays for
// float32 inputs; bf16 q with bf16 or int8 pools runs the tensor-core
// split sweep, paged_attention_ragged_tc.cu.
//
// Schedule: one thread block per (token, kv head) with the token's G query
// heads as its rows, sweeping blocks j with j * bs <= token_pos[t] (and,
// with a sliding window, not wholly before it) through the shared sweep of
// paged_attention_common.cuh.  Padding tokens (an all-zero table row,
// position 0) read the null block's first key and write finite values.

#include "paged_attention_common.cuh"

using namespace paged_attention;

namespace {

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const QT* __restrict__ q,
                              const KT* __restrict__ k_pool,
                              const KT* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ token_tables,
                              const int* __restrict__ token_pos,
                              QT* __restrict__ out, int Hkv, int G, int bs,
                              int max_blocks, int window, float scale) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const size_t base = (static_cast<size_t>(t) * Hkv + h) * G * D;
  attend_rows<QT, KT, D>(q + base, out + base, static_cast<size_t>(G) * D, 1,
                         G, token_pos[t],
                         token_tables + static_cast<size_t>(t) * max_blocks,
                         max_blocks, k_pool, v_pool, k_scale, v_scale, Hkv,
                         h, bs, window, scale);
}

struct Launcher {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *token_tables,
      *token_pos;
  void* out;
  int T, Hkv, G, bs, max_blocks, window;
  float scale;
  cudaStream_t stream;

  template <typename QT, typename KT, int D>
  cudaError_t run() const {
    auto kernel = ragged_paged_attention_kernel<QT, KT, D>;
    const size_t smem = smem_floats(G, D, bs) * sizeof(float);
    static PerDevice<size_t> granted;
    const cudaError_t e = allow_smem(kernel, smem, granted);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(T, Hkv), kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
        static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale),
        static_cast<const int*>(token_tables),
        static_cast<const int*>(token_pos), static_cast<QT*>(out), Hkv, G,
        bs, max_blocks, window, scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes for `rows` q rows.
size_t paged_attention_ragged_smem_bytes(int rows, int D, int bs) {
  return smem_floats(rows, D, bs) * sizeof(float);
}

// dtype codes as in paged_attention_tiled_launch.  q and out are
// (T, Hkv, G, D); token_tables (T, max_blocks) and token_pos (T,) int32.
// Returns cudaGetLastError() after the launch (0 = success).
int paged_attention_ragged_launch(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale,
                                  const void* token_tables,
                                  const void* token_pos, void* out,
                                  int q_dtype, int pool_dtype, int D, int T,
                                  int Hkv, int G, int bs, int max_blocks,
                                  int window, float scale, void* stream) {
  if (T <= 0) return 0;
  const Launcher launcher{q, k_pool, v_pool, k_scale, v_scale, token_tables,
                          token_pos, out, T, Hkv, G, bs, max_blocks, window,
                          scale, static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, pool_dtype, D, launcher);
}

}  // extern "C"
