// Segment-tiled flat-stream paged attention for Hopper (sm_90a), bf16 q
// with bf16 or int8 pools: the tensor-core redesign of
// paged_attention_tiled.cu, which keeps float32 inputs.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_ragged_tiled (body _tiled_ragged_attn_kernel), the
// attention read of the paged engine's default step: one flat stream of T
// query tokens (prefill chunks, decodes and speculative draft segments of
// many lanes, back to back) cut by serving/batch.py::build_tile_map into
// tiles, each the rows [lo, hi) of one lane's segment inside one window of
// `tile` rows, at positions pos0, pos0 + 1, ...
//
// What bounds it on the H100: bytes (each needed K/V block read once a
// kv head), which the FMA kernel missed by 20x for the reasons the split
// sweep of paged_attention_split.cuh answers: one CTA swept a whole lane
// for a tile, loads and compute alternated, and the dot products ran out
// of shared memory.  Here a tile's tile x G rows are cut into work items
// of 16 rows (one m16 tile); a CTA attends one item of one kv head over
// one key split, its warps on their own 16-key tiles through cp.async
// rings, q . k^T and p . v on the tensor cores (mma.sync m16n8k16), and
// the splits merged by a second kernel when the wrapper cut the key
// ranges (fewer CTAs than two waves).  Rows of a tile's item span at most
// 16 / G + 2 positions, so its key range is the lane's blocks up to the
// item's last position (from the window of its first on).
//
// Inert capacity tiles (lo == hi) have no rows and return at once; rows of
// the stream that no tile covers (padding) are not written here (the
// wrapper hands over a zeroed output).  A tile owns exactly its rows, so
// every real row is written once, straight into (T, Hkv, G, D).

#include "paged_attention_split.cuh"

using namespace paged_split;

namespace {

// rows of tile_meta (ref.TILE_*); the window row is not read: a tile's
// rows are [lo, hi) of the stream, loaded directly
constexpr int kTileLo = 1, kTileHi = 2, kTilePos0 = 3, kTileLane = 4;

// work item i = (tile i / groups, rows 16 (i % groups) .. of its
// (hi - lo) x G rows, row r = token lo + r / G, query head r % G, at
// position pos0 + r / G); q and out (T, Hkv, G, D)
struct TiledItems {
  const int* tables;
  const int* meta;
  int n_tiles, Hkv, G, groups, max_blocks, D;

  __device__ int field(int row, int i) const {
    return meta[row * n_tiles + i / groups];
  }
  __device__ int rows(int i) const {
    const int n = (field(kTileHi, i) - field(kTileLo, i)) * G -
                  16 * (i % groups);
    return n < 0 ? 0 : (n < 16 ? n : 16);
  }
  __device__ int slots(int i) const { return rows(i); }
  __device__ int pos(int i, int r) const {
    return field(kTilePos0, i) + (16 * (i % groups) + r) / G;
  }
  __device__ long long off(int i, int h, int r) const {
    const int row = 16 * (i % groups) + r;
    const long long tok = field(kTileLo, i) + row / G;
    return ((tok * Hkv + h) * G + row % G) * D;
  }
  __device__ const int* table(int i) const {
    return tables + static_cast<long long>(field(kTileLane, i)) * max_blocks;
  }
};

}  // namespace

extern "C" {

// q and out (T, Hkv, G, D) bf16 (out's rows outside every tile are left
// as they are); block_tables (n_lanes, max_blocks) and tile_meta (5,
// n_tiles) int32.  acc and ml are the split scratch, float32 (n_splits,
// n_tiles * groups, Hkv, R, D) and (..., R, 2), R = min(16, tile * G),
// unused when n_splits is 1.  pool_dtype 1 bf16, 2 int8 (with float32
// scales).  Returns cudaGetLastError() after the launches (0 = success).
int paged_attention_tiled_tc_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scale,
                                    const void* v_scale, const void* tables,
                                    const void* meta, void* out, void* acc,
                                    void* ml, int pool_dtype, int D,
                                    int n_tiles, int Hkv, int G, int tile,
                                    int bs, int max_blocks, int window,
                                    int split_blocks, int n_splits,
                                    float scale, void* stream) {
  if (n_tiles <= 0) return 0;
  const int groups = (tile * G + kRows - 1) / kRows;
  const TiledItems items{static_cast<const int*>(tables),
                         static_cast<const int*>(meta), n_tiles, Hkv, G,
                         groups, max_blocks, D};
  const Launch L{static_cast<const __nv_bfloat16*>(q),
                 static_cast<__nv_bfloat16*>(out), static_cast<float*>(acc),
                 static_cast<float2*>(ml), n_tiles * groups, max_blocks,
                 split_blocks, tile * G < kRows ? tile * G : kRows};
  const int bs_shift = __builtin_ctz(static_cast<unsigned>(bs));
  const Pools p{k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale), Hkv, bs_shift, window,
                scale * kLog2e};
  return dispatch(pool_dtype, D, items, L, p, n_splits,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
