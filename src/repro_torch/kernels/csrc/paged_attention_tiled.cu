// Segment-tiled flat-stream paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_ragged_tiled (body _tiled_ragged_attn_kernel): one flat
// stream of T query tokens (mixed prefill chunks, decodes and speculative
// draft segments from many lanes) attends over a paged KV pool through the
// segment-tile metadata built by serving/batch.py::build_tile_map.
//
// What bounds it on the H100: bytes.  Each tile reads its lane's K/V blocks
// up to the tile's deepest causal position, about
//   sum_tiles ceil((maxpos + 1) / bs) * bs * D * 2 * sizeof(pool elem)
// per kv head, against ~4 * rows * keys * D FLOPs, so at serving shapes
// the arithmetic intensity is a few FLOPs per byte, far below the ~295 at
// which the tensor cores would bind.  The design therefore reads every KV
// block of a tile exactly once into shared memory and keeps scores, the
// online softmax state and the accumulator on chip; nothing but q, the
// pools, the tables and the output ever touches device memory.
//
// Schedule: one thread block per (tile, kv head).  The block reads its own
// tile_meta column and block-table row from global memory (no scalar
// prefetch on this card), loads the tile's q rows (tile * G at most) into
// shared memory in float32 pre-scaled by 1/sqrt(D), and sweeps the lane's
// blocks j in [first, maxpos / bs], loading each (bs x D) K and V block into
// shared memory (int8 blocks are dequantized there by their per-(block,
// slot, head) scales).  Each warp owns a set of q rows; for a row, lanes
// split into (key, d-part) pairs to form the scores, reduce with shuffles,
// and update the row's running max m, sum l (float32) and its D-wide
// accumulator.  Differences from the TPU kernel, none of which changes a
// real row's value:
//   * inert tiles (lo == hi) return at once, and rows outside [lo, hi) are
//     never computed: every real row is owned by exactly one tile, so the
//     block writes its rows straight into the (T, Hkv, G, D) output and the
//     TPU's (n_tiles, Hkv, tile * G, D) slab and row_tile gather go away;
//   * with a sliding window, blocks wholly before the window of the tile's
//     first row are skipped (their masked scores contribute exactly 0).
// As on the TPU, masked scores are -1e30 (not -inf) and the denominator is
// max(l, 1e-30), and the softmax weights are rounded to the pool's dtype
// before the PV product (a no-op for float32 and dequantized int8 pools).
//
// A plain first version: FMA on CUDA cores, no cp.async/TMA pipelining and
// no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// rows of tile_meta (ref.TILE_*); the window row is not read: a tile's
// rows are [lo, hi) of the stream, loaded directly
constexpr int kTileLo = 1, kTileHi = 2, kTilePos0 = 3, kTileLane = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 8 consecutive elements -> float32 (16-byte aligned for float/bf16, 8 for
// int8; the wrapper checks base alignment and every offset is a multiple
// of D >= 64 elements)
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// a bfloat16 is the high half of a float32: widen by shifting the bits,
// which keeps the 16-byte load in registers
__device__ __forceinline__ void widen2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  widen2(u.x, o);
  widen2(u.y, o + 2);
  widen2(u.z, o + 4);
  widen2(u.w, o + 6);
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = static_cast<float>(static_cast<int8_t>((u.x >> (8 * i)) & 0xff));
    o[4 + i] = static_cast<float>(static_cast<int8_t>((u.y >> (8 * i)) & 0xff));
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// softmax weights in the V operand's dtype, as the TPU kernel's
// p.astype(v.dtype): bf16 pools round, f32 and dequantized int8 do not
template <typename KT>
__device__ __forceinline__ float round_like_v(float x) { return x; }
template <>
__device__ __forceinline__ float round_like_v<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// shared memory: q rows and accumulators (tile * G rows of D floats), the
// per-row running max and sum, one K block padded to a bank-conflict-free
// stride and one V block
__host__ __device__ inline int key_chunk(int bs) { return bs < 32 ? bs : 32; }

__host__ __device__ inline size_t smem_floats(int tile, int G, int D, int bs) {
  const int rows = tile * G;
  const int parts = 32 / key_chunk(bs);
  return 2 * static_cast<size_t>(rows) * D + 2 * rows +
         static_cast<size_t>(bs) * (D + parts) + static_cast<size_t>(bs) * D;
}

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
                             int G, int bs, int max_blocks, int tile,
                             int window, float scale) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int lo = meta[kTileLo * n_tiles + t];
  const int hi = meta[kTileHi * n_tiles + t];
  if (lo >= hi) return;  // inert capacity-padding tile
  const int pos0 = meta[kTilePos0 * n_tiles + t];
  const int lane_id = meta[kTileLane * n_tiles + t];
  const int maxpos = pos0 + hi - 1 - lo;  // deepest causal bound in the tile
  const int nrows = (hi - lo) * G;

  const int kc = key_chunk(bs);   // keys per warp pass
  const int parts = 32 / kc;      // lanes sharing one key, split over D
  const int kstride = D + parts;  // K row stride: (key, part) -> distinct banks
  const int rows_cap = tile * G;

  extern __shared__ float smem[];
  float* q_s = smem;                          // rows_cap x D
  float* acc_s = q_s + rows_cap * D;          // rows_cap x D
  float* m_s = acc_s + rows_cap * D;          // rows_cap
  float* l_s = m_s + rows_cap;                // rows_cap
  float* k_s = l_s + rows_cap;                // bs x kstride
  float* v_s = k_s + bs * kstride;            // bs x D

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int kVec = D / 8;

  for (int idx = tid; idx < nrows * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 8;
    const int tok = lo + r / G;
    const int g = r % G;
    float v8[8];
    load8(q + ((static_cast<size_t>(tok) * Hkv + h) * G + g) * D + c, v8);
#pragma unroll
    for (int i = 0; i < 8; ++i) q_s[r * D + c + i] = v8[i] * scale;
  }
  for (int idx = tid; idx < nrows * D; idx += kThreads) acc_s[idx] = 0.f;
  for (int r = tid; r < nrows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  int j_first = 0;
  if (window > 0) {
    const int first_key = pos0 - window + 1;  // oldest key row lo can see
    if (first_key > 0) j_first = first_key / bs;
  }
  int j_last = maxpos / bs;
  if (j_last > max_blocks - 1) j_last = max_blocks - 1;
  const int* table = tables + static_cast<size_t>(lane_id) * max_blocks;
  const int key = lane % kc;
  const int part = lane / kc;

  for (int j = j_first; j <= j_last; ++j) {
    const size_t blk = static_cast<size_t>(table[j]);
    __syncthreads();  // the previous block's compute is done with k_s/v_s
    for (int idx = tid; idx < bs * kVec; idx += kThreads) {
      const int s = idx / kVec;
      const int c = (idx % kVec) * 8;
      const size_t row = (blk * bs + s) * Hkv + h;
      float k8[8], v8[8];
      load8(k_pool + row * D + c, k8);
      load8(v_pool + row * D + c, v8);
      float ksc = 1.f, vsc = 1.f;
      if (k_scale != nullptr) {
        ksc = k_scale[row];
        vsc = v_scale[row];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        k_s[s * kstride + c + i] = k8[i] * ksc;
        v_s[s * D + c + i] = v8[i] * vsc;
      }
    }
    __syncthreads();

    for (int r = warp; r < nrows; r += kWarps) {
      const int qpos = pos0 + r / G;
      float m_prev = m_s[r];
      float l_prev = l_s[r];
      float acc[D / 32];
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] = acc_s[r * D + lane + 32 * i];
      const float* qr = q_s + r * D;
      for (int k0 = 0; k0 < bs; k0 += kc) {
        const float* kr = k_s + (k0 + key) * kstride;
        float dot = 0.f;
        for (int d = part; d < D; d += parts) dot = fmaf(qr[d], kr[d], dot);
        for (int off = kc; off < 32; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int kpos = j * bs + k0 + key;
        bool valid = kpos <= qpos;
        if (window > 0) valid = valid && (qpos - kpos) < window;
        const float s = valid ? dot : kNegInf;
        float cmax = s;
        for (int off = 1; off < kc; off <<= 1)
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
        const float m_new = fmaxf(m_prev, cmax);
        const float corr = expf(m_prev - m_new);
        const float p = expf(s - m_new);
        float psum = p;
        for (int off = 1; off < kc; off <<= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l_prev = l_prev * corr + psum;
        const float pv = round_like_v<KT>(p);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc[i] *= corr;
        for (int jj = 0; jj < kc; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, pv, jj);
          const float* vr = v_s + (k0 + jj) * D + lane;
#pragma unroll
          for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(pj, vr[32 * i], acc[i]);
        }
        m_prev = m_new;
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc_s[r * D + lane + 32 * i] = acc[i];
      if (lane == 0) {
        m_s[r] = m_prev;
        l_s[r] = l_prev;
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int tok = lo + r / G;
    const int g = r % G;
    const float denom = fmaxf(l_s[r], 1e-30f);
    out[((static_cast<size_t>(tok) * Hkv + h) * G + g) * D + d] =
        from_f32<QT>(acc_s[idx] / denom);
  }
}

template <typename QT, typename KT, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* meta, void* out,
                   int n_tiles, int Hkv, int G, int bs, int max_blocks,
                   int tile, int window, float scale, cudaStream_t stream) {
  auto kernel = tiled_paged_attention_kernel<QT, KT, D>;
  const size_t smem = smem_floats(tile, G, D, bs) * sizeof(float);
  static size_t configured = 0;  // largest opt-in granted so far
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(n_tiles, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(meta), static_cast<QT*>(out), n_tiles, Hkv, G,
      bs, max_blocks, tile, window, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool,
                       const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* tables,
                       const void* meta, void* out, int n_tiles, int Hkv,
                       int G, int bs, int max_blocks, int tile, int window,
                       float scale, cudaStream_t stream) {
#define REPRO_PA_LAUNCH(DIM)                                                  \
  return launch<QT, KT, DIM>(q, k_pool, v_pool, k_scale, v_scale, tables,   \
                             meta, out, n_tiles, Hkv, G, bs, max_blocks,    \
                             tile, window, scale, stream)
  switch (D) {
    case 64: REPRO_PA_LAUNCH(64);
    case 128: REPRO_PA_LAUNCH(128);
    case 256: REPRO_PA_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PA_LAUNCH
}

template <typename QT>
cudaError_t dispatch_pool(int pool_dtype, int D, const void* q,
                          const void* k_pool, const void* v_pool,
                          const void* k_scale, const void* v_scale,
                          const void* tables, const void* meta, void* out,
                          int n_tiles, int Hkv, int G, int bs, int max_blocks,
                          int tile, int window, float scale,
                          cudaStream_t stream) {
  switch (pool_dtype) {
    case 0:
      return dispatch_d<QT, float>(D, q, k_pool, v_pool, k_scale, v_scale,
                                   tables, meta, out, n_tiles, Hkv, G, bs,
                                   max_blocks, tile, window, scale, stream);
    case 1:
      return dispatch_d<QT, __nv_bfloat16>(D, q, k_pool, v_pool, k_scale,
                                           v_scale, tables, meta, out,
                                           n_tiles, Hkv, G, bs, max_blocks,
                                           tile, window, scale, stream);
    case 2:
      return dispatch_d<QT, int8_t>(D, q, k_pool, v_pool, k_scale, v_scale,
                                    tables, meta, out, n_tiles, Hkv, G, bs,
                                    max_blocks, tile, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at these shapes.
size_t paged_attention_tiled_smem_bytes(int tile, int G, int D, int bs) {
  return smem_floats(tile, G, D, bs) * sizeof(float);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return dispatch_pool<float>(pool_dtype, D, q, k_pool, v_pool, k_scale,
                                  v_scale, tables, meta, out, n_tiles, Hkv,
                                  G, bs, max_blocks, tile, window, scale, s);
    case 1:
      return dispatch_pool<__nv_bfloat16>(pool_dtype, D, q, k_pool, v_pool,
                                          k_scale, v_scale, tables, meta, out,
                                          n_tiles, Hkv, G, bs, max_blocks,
                                          tile, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
