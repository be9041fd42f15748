// Segment-tiled flat-stream paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_ragged_tiled (body _tiled_ragged_attn_kernel): one flat
// stream of T query tokens (mixed prefill chunks, decodes and speculative
// draft segments from many lanes) attends over a paged KV pool through the
// segment-tile metadata built by serving/batch.py::build_tile_map.
//
// What the function needs is bytes: each tile reads its lane's K/V blocks
// up to the tile's deepest causal position, about
//   sum_tiles ceil((maxpos + 1) / bs) * bs * D * 2 * sizeof(pool elem)
// per kv head, against ~4 * rows * keys * D FLOPs, a few FLOPs per byte at
// serving shapes.  What bounds this FMA kernel on the H100 is shared-memory
// traffic and the serial sweep of paged_attention_common.cuh (one block
// sweeps a lane's blocks for a whole tile, loads and compute alternating;
// PERF.md).  It stays for float32 inputs; bf16 q with bf16 or int8 pools
// runs the tensor-core split sweep, paged_attention_tiled_tc.cu.
//
// Schedule: one thread block per (tile, kv head).  The block reads its own
// tile_meta column and block-table row from global memory (no scalar
// prefetch on this card) and sweeps its lane's blocks for the tile's rows.
// Differences from the TPU kernel, none of which changes a real row's
// value:
//   * inert tiles (lo == hi) return at once, and rows outside [lo, hi) are
//     never computed: every real row is owned by exactly one tile, so the
//     block writes its rows straight into the (T, Hkv, G, D) output and the
//     TPU's (n_tiles, Hkv, tile * G, D) slab and row_tile gather go away;
//   * with a sliding window, blocks wholly before the window of the tile's
//     first row are skipped.

#include "paged_attention_common.cuh"

using namespace paged_attention;

namespace {

// rows of tile_meta (ref.TILE_*); the window row is not read: a tile's
// rows are [lo, hi) of the stream, loaded directly
constexpr int kTileLo = 1, kTileHi = 2, kTilePos0 = 3, kTileLane = 4;

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
tiled_paged_attention_kernel(const QT* __restrict__ q,
                             const KT* __restrict__ k_pool,
                             const KT* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ meta,
                             QT* __restrict__ out, int n_tiles, int Hkv,
                             int G, int bs, int max_blocks, int window,
                             float scale) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int lo = meta[kTileLo * n_tiles + t];
  const int hi = meta[kTileHi * n_tiles + t];
  if (lo >= hi) return;  // inert capacity-padding tile
  const int pos0 = meta[kTilePos0 * n_tiles + t];
  const int lane_id = meta[kTileLane * n_tiles + t];
  const size_t base = (static_cast<size_t>(lo) * Hkv + h) * G * D;
  attend_rows<QT, KT, D>(q + base, out + base,
                         static_cast<size_t>(Hkv) * G * D, hi - lo, G, pos0,
                         tables + static_cast<size_t>(lane_id) * max_blocks,
                         max_blocks, k_pool, v_pool, k_scale, v_scale, Hkv,
                         h, bs, window, scale);
}

struct Launcher {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *meta;
  void* out;
  int n_tiles, Hkv, G, bs, max_blocks, tile, window;
  float scale;
  cudaStream_t stream;

  template <typename QT, typename KT, int D>
  cudaError_t run() const {
    auto kernel = tiled_paged_attention_kernel<QT, KT, D>;
    const size_t smem = smem_floats(tile * G, D, bs) * sizeof(float);
    static PerDevice<size_t> granted;
    const cudaError_t e = allow_smem(kernel, smem, granted);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(n_tiles, Hkv), kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
        static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(tables),
        static_cast<const int*>(meta), static_cast<QT*>(out), n_tiles, Hkv,
        G, bs, max_blocks, window, scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes for `rows` q rows.
size_t paged_attention_tiled_smem_bytes(int rows, int D, int bs) {
  return smem_floats(rows, D, bs) * sizeof(float);
}

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only; int8 pools come
// with float32 k_scale/v_scale, else those are null).  q and out share
// q_dtype.  Returns cudaGetLastError() after the launch (0 = success).
int paged_attention_tiled_launch(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* meta, void* out, int q_dtype,
                                 int pool_dtype, int D, int n_tiles, int Hkv,
                                 int G, int bs, int max_blocks, int tile,
                                 int window, float scale, void* stream) {
  if (n_tiles <= 0) return 0;
  const Launcher launcher{q, k_pool, v_pool, k_scale, v_scale, tables, meta,
                          out, n_tiles, Hkv, G, bs, max_blocks, tile, window,
                          scale, static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, pool_dtype, D, launcher);
}

}  // extern "C"
