// Shared pieces of the port's paged-attention kernels for Hopper (sm_90a):
// the pool loaders, the online-softmax sweep of one thread block's q rows
// over one lane's KV blocks, and the dtype/head-dim dispatch.
//
// The three kernels (paged_attention_tiled.cu, paged_attention_ragged.cu,
// paged_attention_rows.cu) differ only in how a thread block finds its q
// rows, their positions and its lane's block-table row; the sweep below is
// the same for all of them, so their numerics are the same too:
//   * q is read once into shared memory in float32, pre-scaled by
//     1/sqrt(D);
//   * the lane's logical blocks j in [j_first, j_last] are swept in tiles
//     of up to 32 keys, each K and V tile loaded once into shared memory
//     (int8 pools dequantized there by their per-(block, slot, head)
//     scales);
//   * every warp owns a set of q rows; for a row, lanes split into
//     (key, d-part) pairs to form the scores, reduce with shuffles and
//     update the row's running max m, sum l and D-wide accumulator, all in
//     float32;
//   * masked scores are -1e30 (not -inf), the denominator is
//     max(l, 1e-30), and the softmax weights are rounded to the pool's
//     dtype before the PV product, as the TPU kernels do;
//   * with a sliding window, blocks wholly before the window of the first
//     row are skipped (their masked scores contribute exactly 0).
//
// What the function needs is bytes: at serving shapes a row does ~4 *
// keys * D FLOPs per ~2 * keys * D pool elements, far below the ~295
// FLOPs per byte at which the tensor cores would bind.  What bounds this
// sweep on the H100 is not those bytes (int8 pools halve them and not the
// time; PERF.md): it is shared-memory traffic and the serial sweep, one
// warp of eight on a decode row, scalar FMAs on shared-memory floats, each
// tile loaded then computed behind two __syncthreads, one block per lane.
// It stays for float32 inputs and for the segment-tiled read (B1); bf16
// q with bf16 or int8 pools goes to the tensor-core split sweep of
// paged_attention_split.cuh (paged_attention_ragged_tc.cu,
// paged_attention_rows_tc.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace paged_attention {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 8 consecutive elements -> float32 (16-byte aligned for float/bf16, 8 for
// int8; the wrappers check base alignment and every offset is a multiple
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

// softmax weights in the V operand's dtype, as the TPU kernels'
// p.astype(v.dtype): bf16 pools round, f32 and dequantized int8 do not
template <typename KT>
__device__ __forceinline__ float round_like_v(float x) { return x; }
template <>
__device__ __forceinline__ float round_like_v<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// keys per K/V tile in shared memory (and per warp pass)
__host__ __device__ inline int key_chunk(int bs) { return bs < 32 ? bs : 32; }

// shared memory of a block attending `rows` q rows: q and accumulators
// (rows x D floats each), the per-row running max and sum, one K tile
// padded to a bank-conflict-free stride and one V tile
__host__ __device__ inline size_t smem_floats(int rows, int D, int bs) {
  const int kc = key_chunk(bs);
  const int parts = 32 / kc;
  return 2 * static_cast<size_t>(rows) * D + 2 * static_cast<size_t>(rows) +
         static_cast<size_t>(kc) * (D + parts) + static_cast<size_t>(kc) * D;
}

// One thread block attends `ntok` consecutive query tokens of one lane and
// one kv head h, G rows each: row r is token r / G (position pos0 + r / G)
// and query head r % G of the kv head.  q row r lies at
// q + (r / G) * tok_stride + (r % G) * D, its output at the same offset
// from out.  `table` is the lane's block-table row (max_blocks entries);
// pools are (num_blocks, bs, Hkv, D), scales (num_blocks, bs, Hkv) or null.
// Uses smem_floats(ntok * G, D, bs) floats of dynamic shared memory.
template <typename QT, typename KT, int D>
__device__ __forceinline__ void attend_rows(
    const QT* __restrict__ q, QT* __restrict__ out, size_t tok_stride,
    int ntok, int G, int pos0, const int* __restrict__ table, int max_blocks,
    const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int Hkv, int h, int bs, int window, float scale) {
  const int nrows = ntok * G;
  const int kc = key_chunk(bs);   // keys per tile and per warp pass
  const int parts = 32 / kc;      // lanes sharing one key, split over D
  const int kstride = D + parts;  // K row stride: (key, part) -> distinct banks

  extern __shared__ float smem[];
  float* q_s = smem;                          // nrows x D
  float* acc_s = q_s + nrows * D;             // nrows x D
  float* m_s = acc_s + nrows * D;             // nrows
  float* l_s = m_s + nrows;                   // nrows
  float* k_s = l_s + nrows;                   // kc x kstride
  float* v_s = k_s + kc * kstride;            // kc x D

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int kVec = D / 8;

  for (int idx = tid; idx < nrows * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 8;
    float v8[8];
    load8(q + (r / G) * tok_stride + (r % G) * D + c, v8);
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
    const int first_key = pos0 - window + 1;  // oldest key row 0 can see
    if (first_key > 0) j_first = first_key / bs;
  }
  const int maxpos = pos0 + ntok - 1;  // deepest causal bound of the rows
  int j_last = maxpos >= 0 ? maxpos / bs : -1;
  if (j_last > max_blocks - 1) j_last = max_blocks - 1;
  const int key = lane % kc;
  const int part = lane / kc;

  for (int j = j_first; j <= j_last; ++j) {
    const size_t blk = static_cast<size_t>(table[j]);
    for (int k0 = 0; k0 < bs; k0 += kc) {
      __syncthreads();  // the previous tile's compute is done with k_s/v_s
      for (int idx = tid; idx < kc * kVec; idx += kThreads) {
        const int s = idx / kVec;
        const int c = (idx % kVec) * 8;
        const size_t row = (blk * bs + k0 + s) * Hkv + h;
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
        const float m_prev = m_s[r];
        const float* qr = q_s + r * D;
        const float* kr = k_s + key * kstride;
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
        const float pv = round_like_v<KT>(p);
        float acc[D / 32];
#pragma unroll
        for (int i = 0; i < D / 32; ++i)
          acc[i] = acc_s[r * D + lane + 32 * i] * corr;
        for (int jj = 0; jj < kc; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, pv, jj);
          const float* vr = v_s + jj * D + lane;
#pragma unroll
          for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(pj, vr[32 * i], acc[i]);
        }
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc_s[r * D + lane + 32 * i] = acc[i];
        __syncwarp();  // every lane has read m_s[r] before lane 0 writes it
        if (lane == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * corr + psum;
        }
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const float denom = fmaxf(l_s[r], 1e-30f);
    out[(r / G) * tok_stride + (r % G) * D + d] =
        from_f32<QT>(acc_s[idx] / denom);
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory; `record`
// is the caller's static record of the largest opt-in so far for that
// kernel, one value a device (the opt-in acts on the current device).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes,
                              PerDevice<size_t>& record) {
  size_t& granted = record.here();
  if (bytes <= 48 * 1024 || bytes <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) granted = bytes;
  return e;
}

// Calls launcher.template run<QT, KT, D>() for the runtime dtype codes
// (0 float32, 1 bfloat16, 2 int8; int8 for pools only) and head dim.
template <typename QT, typename KT, typename L>
cudaError_t dispatch_dim(int D, const L& launcher) {
  switch (D) {
    case 64: return launcher.template run<QT, KT, 64>();
    case 128: return launcher.template run<QT, KT, 128>();
    case 256: return launcher.template run<QT, KT, 256>();
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename L>
cudaError_t dispatch_pool(int pool_dtype, int D, const L& launcher) {
  switch (pool_dtype) {
    case 0: return dispatch_dim<QT, float>(D, launcher);
    case 1: return dispatch_dim<QT, __nv_bfloat16>(D, launcher);
    case 2: return dispatch_dim<QT, int8_t>(D, launcher);
    default: return cudaErrorInvalidValue;
  }
}

template <typename L>
cudaError_t dispatch(int q_dtype, int pool_dtype, int D, const L& launcher) {
  switch (q_dtype) {
    case 0: return dispatch_pool<float>(pool_dtype, D, launcher);
    case 1: return dispatch_pool<__nv_bfloat16>(pool_dtype, D, launcher);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged_attention
