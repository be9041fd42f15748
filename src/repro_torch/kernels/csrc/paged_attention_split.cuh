// Split-key tensor-core paged attention for Hopper (sm_90a): the tile sweep
// shared by the bf16 segment-tiled read (paged_attention_tiled_tc.cu, B1),
// the bf16 per-token read (paged_attention_ragged_tc.cu, B2) and the bf16
// rectangular read (paged_attention_rows_tc.cu, B3).
//
// A thread block (CTA) attends up to 16 q rows of one kv head (one m16
// tensor-core tile) over one key range of one block-table row.  The old
// FMA sweep (paged_attention_common.cuh) loses to its bytes for four
// reasons, each answered here:
//   * one warp of eight computed a decode row while the rest waited: here
//     every warp sweeps its own 16-key tiles of the range (tile i goes to
//     warp i % W) with its own running max m, sum l and accumulator, and
//     the warps merge once, through shared memory, at the end;
//   * loads and compute alternated behind two __syncthreads a tile: here
//     each warp owns a ring of kStages K/V tiles filled by cp.async (16
//     bytes a thread), so tile i + 1 is in flight while tile i computes,
//     and the block-table entries of the next tile are read one issue
//     ahead; no __syncthreads runs inside the sweep;
//   * the dot products were scalar FMAs on shared-memory floats: here
//     q . k^T and p . v are mma.sync.m16n8k16 bf16 products (HMMA) that
//     accumulate in float32, fed by ldmatrix from tiles kept in a 16-byte
//     XOR swizzle (chunk c of row r at c ^ (r % 8): conflict-free);
//   * one CTA swept a whole lane: the wrappers cut each key range into
//     splits of whole blocks when the CTAs would not fill two waves, and a
//     combine kernel merges the splits' float32 partials (m, l, acc) in a
//     fixed order (no atomics: the same bits every run).
//
// One tile design serves every regime: a decode row at G 1 leaves 15 of
// the 16 rows of its m16 tile dead, but at serving shapes a row does 1
// FLOP per pool byte, so even a 1/16-used tensor-core tile is far above
// what the bytes need, and the shared-memory traffic per key is the
// tile's (once per warp), not once per row.
//
// Numerics copy the plain version's choices: scores and m, l, acc in
// float32 (the product q . k in float32 from the tensor cores, times
// 1/sqrt(D) after it, in base 2 for exp2), masked scores -1e30, the
// denominator max(l, 1e-30), the softmax weights rounded to bf16 before
// p . v.  int8 pools dequantize exactly to bf16 (|x| <= 127); a key's
// k_scale multiplies its score after the product and its v_scale folds
// into p before p is rounded.  A split (or warp) in which a row sees no
// key keeps m = -1e30, so the merge's exp2(m - M) gives it weight 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "per_device.cuh"

namespace paged_split {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 16;   // q rows of a CTA: one m16 tile
constexpr int kTile = 16;   // keys of a warp tile: two n8 tiles, one k16 step
constexpr int kStages = 2;  // K/V tiles in flight per warp

template <int D>
struct Shape {
  // D 256 keeps two warps a CTA so three CTAs fit an SM (73 KB each)
  static constexpr int kWarps = D >= 256 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kChunks = D / 8;             // 16-byte chunks a row
  static constexpr int kRowBytes = D * 2;           // one bf16 row
  static constexpr int kTileBytes = kTile * D * 2;  // one bf16 K or V tile
  static constexpr int kMergeStride = D + 8;        // floats a merge row
};

// ---------------------------------------------------------------------------
// shared memory of a CTA
// ---------------------------------------------------------------------------
// the ring of one warp: bf16 pools stage straight into the swizzled tiles;
// int8 pools stage raw bytes and their scales, then convert into one bf16
// K and V tile pair
template <typename KT, int D>
struct Ring;

template <int D>
struct Ring<__nv_bfloat16, D> {
  static constexpr int kStageBytes = 2 * Shape<D>::kTileBytes;
  static constexpr int kBytes = kStages * kStageBytes;
};

template <int D>
struct Ring<int8_t, D> {
  static constexpr int kRawBytes = kTile * D;            // one int8 tile
  static constexpr int kStageBytes = 2 * kRawBytes + 2 * kTile * 4;
  static constexpr int kBytes =
      kStages * kStageBytes + 2 * Shape<D>::kTileBytes;  // + the bf16 pair
};

template <typename KT, int D>
struct Smem {
  using S = Shape<D>;
  static constexpr int kQ = 0;                                  // q tile
  static constexpr int kPos = kQ + kRows * S::kRowBytes;        // int[16]
  static constexpr int kOff = kPos + kRows * 4;                 // ll[16]
  static constexpr int kMl = kOff + kRows * 8;                  // f2[W][16]
  static constexpr int kRing = (kMl + S::kWarps * kRows * 8 + 127) / 128 * 128;
  static constexpr int kMergeBytes = S::kWarps * kRows * S::kMergeStride * 4;
  static constexpr int kRingBytes = S::kWarps * Ring<KT, D>::kBytes;
  static constexpr int kBytes =
      kRing + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
};

// ---------------------------------------------------------------------------
// device primitives (mma_common.cuh)
// ---------------------------------------------------------------------------
using mma16::cp_async16;
using mma16::cp_async4;
using mma16::cp_async_commit;
using mma16::cp_async_wait;
using mma16::ldsm_x4;
using mma16::ldsm_x4_trans;
using mma16::mma16816;
using mma16::pack_bf16;
using mma16::smem_addr;

// byte offset of 16-byte chunk c of row r in a swizzled tile of D columns
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return mma16::swz<Shape<D>::kChunks>(r, c);
}

// two int8 bytes, each in the low byte of a 16-bit half of t, -> a bf16
// pair, exactly: byte b is (b & 127) - 128 [b & 128], so it is the bf16
// 128 + (b & 127) (bits 0x4300 | (b & 127)) less the bf16 128 or 256
// (bits 0x4300 | (b & 128)); the difference is an integer in [-128, 127],
// exact in bf16
__device__ __forceinline__ uint32_t int8x2_to_bf16(uint32_t t) {
  const uint32_t a = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t b = (t & 0x00800080u) | 0x43004300u;
  using bf2 = __nv_bfloat162;
  const bf2 d = __hsub2(*reinterpret_cast<const bf2*>(&a),
                        *reinterpret_cast<const bf2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// four int8 (one 32-bit word) -> two bf16 pairs (bytes 0, 1 and 2, 3)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  lo = int8x2_to_bf16(__byte_perm(w, 0u, 0x4140));
  hi = int8x2_to_bf16(__byte_perm(w, 0u, 0x4342));
}

// ---------------------------------------------------------------------------
// the key range of a CTA
// ---------------------------------------------------------------------------
// Keys [lo, hi] that rows at positions minpos..maxpos need (the causal
// bound, the window, the table's end); empty when hi < lo
__device__ __forceinline__ void needed_keys(int minpos, int maxpos,
                                            int window, int max_blocks,
                                            int bs, int& lo, int& hi) {
  lo = 0;
  if (window > 0 && minpos - window + 1 > 0) lo = minpos - window + 1;
  hi = maxpos;
  if (hi > max_blocks * bs - 1) hi = max_blocks * bs - 1;
}

// Splits of whole blocks: the needed blocks lo / bs .. hi / bs cut into
// runs of split_blocks, in order; at least one split (an empty range
// still writes its rows).  Split s covers keys [k_lo, k_hi].
__device__ __forceinline__ int num_splits(int lo, int hi, int bs,
                                          int split_blocks) {
  if (hi < lo) return 1;
  const int blocks = hi / bs - lo / bs + 1;
  return (blocks + split_blocks - 1) / split_blocks;
}

__device__ __forceinline__ void split_keys(int lo, int hi, int bs,
                                           int split_blocks, int s,
                                           int& k_lo, int& k_hi) {
  const int j0 = lo / bs + s * split_blocks;
  k_lo = j0 * bs > lo ? j0 * bs : lo;
  k_hi = (j0 + split_blocks) * bs - 1 < hi ? (j0 + split_blocks) * bs - 1
                                           : hi;
}

// ---------------------------------------------------------------------------
// the pools
// ---------------------------------------------------------------------------
struct Pools {
  const void* k;          // (num_blocks, bs, Hkv, D) bf16 or int8
  const void* v;
  const float* k_scale;   // (num_blocks, bs, Hkv) for int8, else null
  const float* v_scale;
  int Hkv, bs_shift, window;
  float scale_log2;       // log2(e) / sqrt(D)
};

// Issue the cp.async copies of one 16-key tile into ``stage``: key kk
// of the tile is pool row ``row`` of lane kk of ``rows`` (-1: past the
// range, zero-filled)
template <typename KT, int D>
__device__ __forceinline__ void issue_tile(const Pools& p, uint8_t* stage,
                                           int rows, int lane) {
  using S = Shape<D>;
  if constexpr (sizeof(KT) == 2) {
    // K then V: 2 x 16 keys x D / 8 chunks, 32 lanes a pass
    constexpr int kPerTensor = kTile * S::kChunks;
#pragma unroll
    for (int i = 0; i < 2 * kPerTensor / 32; ++i) {
      const int idx = lane + 32 * i;
      const int which = idx / kPerTensor;
      const int key = (idx % kPerTensor) / S::kChunks;
      const int c = idx % S::kChunks;
      const int row = __shfl_sync(0xffffffffu, rows, key);
      const __nv_bfloat16* base =
          static_cast<const __nv_bfloat16*>(which ? p.v : p.k);
      const __nv_bfloat16* src =
          base + static_cast<long long>(row < 0 ? 0 : row) * D + c * 8;
      cp_async16(stage + which * S::kTileBytes + swz<D>(key, c), src,
                 row < 0 ? 0 : 16);
    }
  } else {
    // raw int8 K then V (16 keys x D bytes, row-major), then the scales
    constexpr int kCh = D / 16;  // 16-byte int8 chunks a row
    constexpr int kPerTensor = kTile * kCh;
#pragma unroll
    for (int i = 0; i < 2 * kPerTensor / 32; ++i) {
      const int idx = lane + 32 * i;
      const int which = idx / kPerTensor;
      const int key = (idx % kPerTensor) / kCh;
      const int c = idx % kCh;
      const int row = __shfl_sync(0xffffffffu, rows, key);
      const int8_t* base = static_cast<const int8_t*>(which ? p.v : p.k);
      const int8_t* src =
          base + static_cast<long long>(row < 0 ? 0 : row) * D + c * 16;
      cp_async16(stage + which * Ring<int8_t, D>::kRawBytes + key * D +
                     c * 16,
                 src, row < 0 ? 0 : 16);
    }
    const int row = __shfl_sync(0xffffffffu, rows, lane & 15);
    const float* sc = lane < 16 ? p.k_scale : p.v_scale;
    cp_async4(stage + 2 * Ring<int8_t, D>::kRawBytes + (lane >> 4) * 64 +
                  (lane & 15) * 4,
              sc + (row < 0 ? 0 : row), row < 0 ? 0 : 4);
  }
}

// int8 stage -> the warp's bf16 K/V tile pair (swizzled), exactly
template <int D>
__device__ __forceinline__ void convert_tile(const uint8_t* stage,
                                             uint8_t* tiles, int lane) {
  constexpr int kCh = D / 16;
  constexpr int kPerTensor = kTile * kCh;
#pragma unroll
  for (int i = 0; i < 2 * kPerTensor / 32; ++i) {
    const int idx = lane + 32 * i;
    const int which = idx / kPerTensor;
    const int key = (idx % kPerTensor) / kCh;
    const int c = idx % kCh;
    const uint4 w = *reinterpret_cast<const uint4*>(
        stage + which * Ring<int8_t, D>::kRawBytes + key * D + c * 16);
    uint4 a, b;
    int8x4_to_bf16(w.x, a.x, a.y);
    int8x4_to_bf16(w.y, a.z, a.w);
    int8x4_to_bf16(w.z, b.x, b.y);
    int8x4_to_bf16(w.w, b.z, b.w);
    uint8_t* t = tiles + which * Shape<D>::kTileBytes;
    *reinterpret_cast<uint4*>(t + swz<D>(key, 2 * c)) = a;
    *reinterpret_cast<uint4*>(t + swz<D>(key, 2 * c + 1)) = b;
  }
}

// ---------------------------------------------------------------------------
// the sweep
// ---------------------------------------------------------------------------
// A warp's online-softmax state for the 16 rows: this thread holds rows
// g = lane / 4 and g + 8, and of each n8 tile nt of the accumulator the
// columns 8 nt + 2 (lane % 4) + {0, 1} (the mma C layout)
template <int D>
struct WarpAcc {
  float o[D / 8][4];
  float m[2], l[2];
};

// Sweep keys [k_lo, k_hi] of the block-table row ``table`` for the 16 q
// rows in ``q_s`` (bf16, swizzled), at positions ``pos_s`` (-1: a dead
// row, every key masked).  Warp w takes tiles w, w + W, ... of the range
// through its ring at ``ring``; the result is this warp's acc, each row's
// l summed over its 4 threads.  Needs no __syncthreads.
template <typename KT, int D>
__device__ __forceinline__ void sweep(const uint8_t* q_s, const int* pos_s,
                                      uint8_t* ring,
                                      const int* __restrict__ table,
                                      int k_lo, int k_hi, int h,
                                      const Pools& p, WarpAcc<D>& acc) {
  using S = Shape<D>;
  using R = Ring<KT, D>;
  constexpr bool kInt8 = sizeof(KT) == 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bs = 1 << p.bs_shift;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kTile + 1 : 0;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + S::kWarps - 1) / S::kWarps : 0;
  const int pos_a = pos_s[g];
  const int pos_b = pos_s[g + 8];

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.o[n][e] = 0.f;
  acc.m[0] = acc.m[1] = kNegInf;
  acc.l[0] = acc.l[1] = 0.f;

  // pool row of key `lane` (lanes 0-15) of this warp's it-th tile
  auto key_row = [&](int it) -> int {
    if (lane >= kTile || it >= my_tiles) return -1;
    const int kpos = k_lo + (warp + S::kWarps * it) * kTile + lane;
    if (kpos > k_hi) return -1;
    const int blk = table[kpos >> p.bs_shift];
    return ((blk << p.bs_shift) + (kpos & (bs - 1))) * p.Hkv + h;
  };

  // prologue: stages 0 .. kStages - 2 in flight, the next table rows read
  int next_rows = key_row(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_tiles) {
      issue_tile<KT, D>(p, ring + s * R::kStageBytes, next_rows, lane);
      next_rows = key_row(s + 1);
    }
    cp_async_commit();
  }

  const int mi = lane >> 3;  // ldmatrix: which 8x8 matrix this lane points at
  const int ri = lane & 7;   // and which of its rows
  const uint32_t q_base = smem_addr(q_s);

  for (int it = 0; it < my_tiles; ++it) {
    // keep kStages - 1 tiles in flight: issue tile it + kStages - 1 into
    // the stage tile it - 1 left (the __syncwarp below freed it)
    const int ahead = it + kStages - 1;
    if (ahead < my_tiles) {
      issue_tile<KT, D>(p, ring + (ahead % kStages) * R::kStageBytes,
                        next_rows, lane);
      next_rows = key_row(ahead + 1);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();

    const uint8_t* stage = ring + (it % kStages) * R::kStageBytes;
    const uint8_t* kt;
    const float* ks = nullptr;
    const float* vs = nullptr;
    if constexpr (kInt8) {
      uint8_t* tiles = ring + kStages * R::kStageBytes;
      convert_tile<D>(stage, tiles, lane);
      __syncwarp();
      kt = tiles;
      ks = reinterpret_cast<const float*>(stage + 2 * R::kRawBytes);
      vs = ks + kTile;
    } else {
      kt = stage;
    }
    const uint32_t k_base = smem_addr(kt);
    const uint32_t v_base = k_base + S::kTileBytes;

    // s = q . k^T: 16 rows x 16 keys, D / 16 k steps
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      // q: matrices (rows 0-7 | 8-15) x (chunk 2kk | 2kk + 1)
      ldsm_x4(q_base + swz<D>((mi & 1) * 8 + ri, 2 * kk + (mi >> 1)), a);
      // k: matrices (keys 0-7 | 8-15) x (chunk 2kk | 2kk + 1)
      ldsm_x4(k_base + swz<D>((mi >> 1) * 8 + ri, 2 * kk + (mi & 1)), b);
      mma16816(s[0], a, b[0], b[1]);
      mma16816(s[1], a, b[2], b[3]);
    }

    // scale, mask, online softmax (base 2) for rows g (e 0, 1), g + 8 (2, 3)
    const int k0 = k_lo + (warp + S::kWarps * it) * kTile;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        const int kpos = k0 + key;
        const int qp = e < 2 ? pos_a : pos_b;
        float x = s[j][e] * p.scale_log2;
        if constexpr (kInt8) x *= ks[key];
        const bool ok = kpos <= k_hi && kpos <= qp &&
                        (p.window <= 0 || qp - kpos < p.window);
        s[j][e] = ok ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(acc.m[r], mx[r]);
      corr[r] = exp2f(acc.m[r] - m_new);
      acc.m[r] = m_new;
      acc.l[r] *= corr[r];
    }
    float pw[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[j][e] - acc.m[e >> 1]);
        acc.l[e >> 1] += pe;
        pw[j][e] = pe;
        if constexpr (kInt8) pw[j][e] *= vs[8 * j + 2 * t + (e & 1)];
      }
    // the mma C layout of s is the A layout of p for p . v (keys as k)
    uint32_t pa[4];
    pa[0] = pack_bf16(pw[0][0], pw[0][1]);
    pa[1] = pack_bf16(pw[0][2], pw[0][3]);
    pa[2] = pack_bf16(pw[1][0], pw[1][1]);
    pa[3] = pack_bf16(pw[1][2], pw[1][3]);
    // rescale only when some row's max moved (a factor of 1 is exact)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc.o[n][0] *= corr[0];
        acc.o[n][1] *= corr[0];
        acc.o[n][2] *= corr[1];
        acc.o[n][3] *= corr[1];
      }
    }
    // o += p . v: v transposed by ldmatrix, matrices (keys 0-7 | 8-15) x
    // (chunk 2cp | 2cp + 1) -> n8 tiles 2cp and 2cp + 1
#pragma unroll
    for (int cp = 0; cp < D / 16; ++cp) {
      uint32_t b[4];
      ldsm_x4_trans(v_base + swz<D>((mi & 1) * 8 + ri, 2 * cp + (mi >> 1)),
                    b);
      mma16816(acc.o[2 * cp], pa, b[0], b[1]);
      mma16816(acc.o[2 * cp + 1], pa, b[2], b[3]);
    }
    __syncwarp();  // every lane is done with this stage before it refills
  }
  cp_async_wait<0>();
  // the row sums over the quad's columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc.l[r] += __shfl_xor_sync(0xffffffffu, acc.l[r], 1);
    acc.l[r] += __shfl_xor_sync(0xffffffffu, acc.l[r], 2);
  }
}

// Merge the warps' states through shared memory in a fixed order.  After
// it, row r's float32 sum of exp2(m_w - M) acc_w is at merge + r * stride
// summed over w by `merged`, and ml[w = 0][r] holds (M, L) of row r.
// Needs every warp of the CTA; the ring may be reused (it is overwritten).
template <typename KT, int D>
__device__ __forceinline__ void merge_warps(const WarpAcc<D>& acc,
                                            uint8_t* smem) {
  using S = Shape<D>;
  using L = Smem<KT, D>;
  float2* ml = reinterpret_cast<float2*>(smem + L::kMl);
  float* mo = reinterpret_cast<float*>(smem + L::kRing);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  __syncthreads();  // every warp is out of its ring
  if (t == 0) {
    ml[warp * kRows + g] = make_float2(acc.m[0], acc.l[0]);
    ml[warp * kRows + g + 8] = make_float2(acc.m[1], acc.l[1]);
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) M = fmaxf(M, ml[w * kRows + row].x);
    f[r] = exp2f(acc.m[r] - M);
  }
  float* mine = mo + warp * kRows * S::kMergeStride;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(mine + g * S::kMergeStride + c) =
        make_float2(acc.o[n][0] * f[0], acc.o[n][1] * f[0]);
    *reinterpret_cast<float2*>(mine + (g + 8) * S::kMergeStride + c) =
        make_float2(acc.o[n][2] * f[1], acc.o[n][3] * f[1]);
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = threadIdx.x;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) M = fmaxf(M, ml[w * kRows + row].x);
    float Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) {
      const float2 x = ml[w * kRows + row];
      Lsum += x.y * exp2f(x.x - M);
    }
    ml[S::kWarps * 0 + row] = make_float2(M, Lsum);  // warp 0's slot
  }
  __syncthreads();
}

// 8 consecutive merged columns of row `row` starting at d (summed over the
// warps in order)
template <typename KT, int D>
__device__ __forceinline__ void merged8(const uint8_t* smem, int row, int d,
                                        float (&o)[8]) {
  using S = Shape<D>;
  const float* mo = reinterpret_cast<const float*>(smem + Smem<KT, D>::kRing);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
#pragma unroll
  for (int w = 0; w < S::kWarps; ++w) {
    const float* src = mo + (w * kRows + row) * S::kMergeStride + d;
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    o[0] += a.x; o[1] += a.y; o[2] += a.z; o[3] += a.w;
    o[4] += b.x; o[5] += b.y; o[6] += b.z; o[7] += b.w;
  }
}

__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* dst,
                                             const float (&o)[8],
                                             float inv) {
  uint4 u;
  u.x = pack_bf16(o[0] * inv, o[1] * inv);
  u.y = pack_bf16(o[2] * inv, o[3] * inv);
  u.z = pack_bf16(o[4] * inv, o[5] * inv);
  u.w = pack_bf16(o[6] * inv, o[7] * inv);
  *reinterpret_cast<uint4*>(dst) = u;
}

// ---------------------------------------------------------------------------
// the kernels, generic over how a work item finds its rows
// ---------------------------------------------------------------------------
// Items (the B1, B2 and B3 sources each define one) answer, for work item i:
//   rows(i): its real q rows, a prefix of 0..15;
//   slots(i): the output rows it owns (rows past rows(i) are padding,
//     which split 0 writes as zeros);
//   pos(i, r): row r's absolute position;
//   off(i, h, r): row r's element offset in q and out for kv head h;
//   table(i): its block-table row.
// Scratch of a split launch: acc (n_splits, n_items, Hkv, R, D) and ml
// (n_splits, n_items, Hkv, R) float2 (m, l), R = the wrapper's rows an
// item at most; only real rows of items with more than one split are
// written and read.
struct Launch {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* acc;
  float2* ml;
  int n_items, max_blocks, split_blocks, R;
};

template <typename Items>
__device__ __forceinline__ void item_range(const Items& it, const Launch& L,
                                           const Pools& p, int item, int n,
                                           int& lo, int& hi) {
  needed_keys(it.pos(item, 0), it.pos(item, n - 1), p.window, L.max_blocks,
              1 << p.bs_shift, lo, hi);
}

// One CTA: (item blockIdx.x, kv head blockIdx.y, split blockIdx.z)
template <typename KT, int D, typename Items>
__global__ void __launch_bounds__(Shape<D>::kThreads)
split_attention_kernel(Items items, Launch L, Pools p) {
  using S = Shape<D>;
  using M = Smem<KT, D>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int item = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n = items.rows(item);
  if (split == 0) {  // padding rows: zeros
    const int r0 = n > 0 ? n : 0;
    const int pad = items.slots(item) - r0;
    for (int idx = threadIdx.x; idx < pad * S::kChunks; idx += S::kThreads)
      *reinterpret_cast<uint4*>(L.out + items.off(item, h, r0 + idx /
                                S::kChunks) + (idx % S::kChunks) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (n <= 0) return;
  int lo, hi;
  item_range(items, L, p, item, n, lo, hi);
  const int bs = 1 << p.bs_shift;
  const int n_splits = num_splits(lo, hi, bs, L.split_blocks);
  if (split >= n_splits) return;
  int k_lo = lo, k_hi = hi;
  if (hi >= lo) split_keys(lo, hi, bs, L.split_blocks, split, k_lo, k_hi);

  int* pos_s = reinterpret_cast<int*>(smem + M::kPos);
  long long* off_s = reinterpret_cast<long long*>(smem + M::kOff);
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    pos_s[r] = r < n ? items.pos(item, r) : -1;
    off_s[r] = r < n ? items.off(item, h, r) : -1;
  }
  __syncthreads();
  // q rows (bf16, swizzled); dead rows zero
  for (int idx = threadIdx.x; idx < kRows * S::kChunks; idx += S::kThreads) {
    const int r = idx / S::kChunks;
    const int c = idx % S::kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      v = *reinterpret_cast<const uint4*>(L.q + off_s[r] + c * 8);
    *reinterpret_cast<uint4*>(smem + M::kQ + swz<D>(r, c)) = v;
  }
  __syncthreads();

  WarpAcc<D> acc;
  sweep<KT, D>(smem + M::kQ, pos_s, smem + M::kRing +
                   (threadIdx.x >> 5) * Ring<KT, D>::kBytes,
               items.table(item), k_lo, k_hi, h, p, acc);
  merge_warps<KT, D>(acc, smem);

  const float2* ml = reinterpret_cast<const float2*>(smem + M::kMl);
  for (int idx = threadIdx.x; idx < n * S::kChunks; idx += S::kThreads) {
    const int r = idx / S::kChunks;
    const int d = (idx % S::kChunks) * 8;
    float o[8];
    merged8<KT, D>(smem, r, d, o);
    const float2 ML = ml[r];
    if (n_splits == 1) {
      store_bf16x8(L.out + off_s[r] + d, o, 1.f / fmaxf(ML.y, 1e-30f));
    } else {
      const long long row =
          ((static_cast<long long>(split) * L.n_items + item) * p.Hkv + h) *
              L.R + r;
      float* dst = L.acc + row * D + d;
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(o[4], o[5], o[6], o[7]);
      if (d == 0) L.ml[row] = ML;
    }
  }
}

// Merge the splits of every (item, kv head) that has more than one, in
// split order: M = max m_s, out = sum exp2(m_s - M) acc_s / max(sum
// exp2(m_s - M) l_s, 1e-30).  One CTA of 128 threads an (item, head).
template <int D, typename Items>
__global__ void __launch_bounds__(128)
split_combine_kernel(Items items, Launch L, Pools p) {
  const int item = blockIdx.x;
  const int h = blockIdx.y;
  const int n = items.rows(item);
  if (n <= 0) return;
  int lo, hi;
  item_range(items, L, p, item, n, lo, hi);
  const int n_splits = num_splits(lo, hi, 1 << p.bs_shift, L.split_blocks);
  if (n_splits <= 1) return;
  const long long split_stride =
      static_cast<long long>(L.n_items) * p.Hkv * L.R;
  const long long base = (static_cast<long long>(item) * p.Hkv + h) * L.R;
  for (int idx = threadIdx.x; idx < n * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8);
    const int d = (idx % (D / 8)) * 8;
    float M = kNegInf;
    for (int s = 0; s < n_splits; ++s)
      M = fmaxf(M, L.ml[s * split_stride + base + r].x);
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const long long row = s * split_stride + base + r;
      const float2 x = L.ml[row];
      const float w = exp2f(x.x - M);
      l += x.y * w;
      const float4 a = *reinterpret_cast<const float4*>(L.acc + row * D + d);
      const float4 b =
          *reinterpret_cast<const float4*>(L.acc + row * D + d + 4);
      o[0] += w * a.x; o[1] += w * a.y; o[2] += w * a.z; o[3] += w * a.w;
      o[4] += w * b.x; o[5] += w * b.y; o[6] += w * b.z; o[7] += w * b.w;
    }
    store_bf16x8(L.out + items.off(item, h, r) + d, o, 1.f / fmaxf(l, 1e-30f));
  }
}

// Launch the split kernel (and, with more than one split, the combine)
// for pool type KT and head dim D; `granted` records the shared-memory
// opt-in so far, one value a device.
template <typename KT, int D, typename Items>
cudaError_t launch_split(const Items& items, const Launch& L, const Pools& p,
                         int n_splits, cudaStream_t stream) {
  using S = Shape<D>;
  auto kernel = split_attention_kernel<KT, D, Items>;
  const size_t smem = Smem<KT, D>::kBytes;
  static PerDevice<size_t> record;
  size_t& granted = record.here();
  if (smem > 48 * 1024 && smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  kernel<<<dim3(L.n_items, p.Hkv, n_splits), S::kThreads, smem, stream>>>(
      items, L, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits <= 1) return e;
  split_combine_kernel<D, Items><<<dim3(L.n_items, p.Hkv), 128, 0, stream>>>(
      items, L, p);
  return cudaGetLastError();
}

// pool dtype code (1 bfloat16, 2 int8) and head dim -> launch_split
template <typename Items>
cudaError_t dispatch(int pool_dtype, int D, const Items& items,
                     const Launch& L, const Pools& p, int n_splits,
                     cudaStream_t stream) {
#define PAGED_SPLIT_CASE(KT, DIM) \
  return launch_split<KT, DIM, Items>(items, L, p, n_splits, stream)
  if (pool_dtype == 1) {
    switch (D) {
      case 64: PAGED_SPLIT_CASE(__nv_bfloat16, 64);
      case 128: PAGED_SPLIT_CASE(__nv_bfloat16, 128);
      case 256: PAGED_SPLIT_CASE(__nv_bfloat16, 256);
      default: return cudaErrorInvalidValue;
    }
  }
  if (pool_dtype == 2) {
    switch (D) {
      case 64: PAGED_SPLIT_CASE(int8_t, 64);
      case 128: PAGED_SPLIT_CASE(int8_t, 128);
      case 256: PAGED_SPLIT_CASE(int8_t, 256);
      default: return cudaErrorInvalidValue;
    }
  }
#undef PAGED_SPLIT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace paged_split
