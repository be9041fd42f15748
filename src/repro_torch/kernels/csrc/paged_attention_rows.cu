// Rectangular (per-lane chunk) paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// _paged_attention_rows (body _paged_attn_kernel), behind paged_attention
// (decode, C = 1) and paged_attention_chunk: the attention read of the
// paged engine's ragged=False step.  Lane b carries a chunk of C query
// tokens, token c at absolute position q_starts[b] + c, and attends
// causally over its blocks (block_tables[b]); ctx_lens[b] = q_starts[b] +
// q_lens[b] is its valid KV length after the chunk.
//
// What the function needs is bytes: each row group reads its lane's K/V
// blocks up to its deepest real position once, as the tiled kernel does
// for a tile.  What bounds this FMA kernel on the H100 is shared-memory
// traffic and the serial sweep of paged_attention_common.cuh (PERF.md).
// It stays for float32 inputs; bf16 q with bf16 or int8 pools runs the
// tensor-core split sweep, paged_attention_rows_tc.cu.
//
// Schedule: one thread block per (lane, kv head, row group).  The TPU
// kernel keeps all R = C * G rows of a lane in one VMEM tile; on this card
// q and the float32 accumulator of R rows of D floats outgrow the 227 KB
// of shared memory a block may have once C * G * D is large (starcoder2,
// G 9 and D 128, with a 32-token chunk), so the rows are split into groups
// of `group_tokens` chunk tokens (group_tokens * G rows, about 32) that
// sweep the lane's blocks independently.  Chunk rows at or past ctx_lens
// (padding of a lane whose q_len is short of C, paused and empty lanes)
// are not computed and stay as the wrapper's zeros: the TPU kernel fills
// them with finite garbage the caller ignores.  A lane with ctx = 0
// touches no block.

#include "paged_attention_common.cuh"

using namespace paged_attention;

namespace {

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
rows_paged_attention_kernel(const QT* __restrict__ q,
                            const KT* __restrict__ k_pool,
                            const KT* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tables,
                            const int* __restrict__ ctx_lens,
                            const int* __restrict__ q_starts,
                            QT* __restrict__ out, int C, int Hkv, int G,
                            int group_tokens, int bs, int max_blocks,
                            int window, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tok0 = blockIdx.z * group_tokens;
  const int pos0 = q_starts[b] + tok0;
  int ntok = C - tok0;
  if (ntok > group_tokens) ntok = group_tokens;
  if (ntok > ctx_lens[b] - pos0) ntok = ctx_lens[b] - pos0;  // real rows
  if (ntok <= 0) return;
  // q and out are (B, C, Hkv, G, D): token c of lane b is a (Hkv, G, D) slab
  const size_t tok_stride = static_cast<size_t>(Hkv) * G * D;
  const size_t base = (static_cast<size_t>(b) * C + tok0) * tok_stride +
                      static_cast<size_t>(h) * G * D;
  attend_rows<QT, KT, D>(q + base, out + base, tok_stride, ntok, G, pos0,
                         tables + static_cast<size_t>(b) * max_blocks,
                         max_blocks, k_pool, v_pool, k_scale, v_scale, Hkv,
                         h, bs, window, scale);
}

struct Launcher {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *ctx_lens,
      *q_starts;
  void* out;
  int B, C, Hkv, G, group_tokens, bs, max_blocks, window;
  float scale;
  cudaStream_t stream;

  template <typename QT, typename KT, int D>
  cudaError_t run() const {
    auto kernel = rows_paged_attention_kernel<QT, KT, D>;
    const size_t smem = smem_floats(group_tokens * G, D, bs) * sizeof(float);
    static PerDevice<size_t> granted;
    const cudaError_t e = allow_smem(kernel, smem, granted);
    if (e != cudaSuccess) return e;
    const int groups = (C + group_tokens - 1) / group_tokens;
    kernel<<<dim3(B, Hkv, groups), kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
        static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(tables),
        static_cast<const int*>(ctx_lens), static_cast<const int*>(q_starts),
        static_cast<QT*>(out), C, Hkv, G, group_tokens, bs, max_blocks,
        window, scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes for `rows` q rows.
size_t paged_attention_rows_smem_bytes(int rows, int D, int bs) {
  return smem_floats(rows, D, bs) * sizeof(float);
}

// dtype codes as in paged_attention_tiled_launch.  q and out are
// (B, C, Hkv, G, D); block_tables (B, max_blocks), ctx_lens and q_starts
// (B,) int32.  Returns cudaGetLastError() after the launch (0 = success).
int paged_attention_rows_launch(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* ctx_lens, const void* q_starts,
                                void* out, int q_dtype, int pool_dtype, int D,
                                int B, int C, int Hkv, int G,
                                int group_tokens, int bs, int max_blocks,
                                int window, float scale, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const Launcher launcher{q, k_pool, v_pool, k_scale, v_scale, tables,
                          ctx_lens, q_starts, out, B, C, Hkv, G,
                          group_tokens, bs, max_blocks, window, scale,
                          static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, pool_dtype, D, launcher);
}

}  // extern "C"
