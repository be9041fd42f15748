// Shared pieces of the port's flash-attention kernels for Hopper (sm_90a):
// the tile geometry, the loaders that bring rows of q, k, v or do into
// shared memory as float32, and the (64 x 32) score tile that every kernel
// forms from two such tiles.
//
// flash_attention_fwd.cu (B6 and B6f) and flash_attention_bwd.cu (B6b: dq
// and dk/dv) all work on logical (B, H, S, D) tensors given by their
// element strides over (b, h, s), with d contiguous, so the model's
// (B, S, H, D) activations are read in place through transposed views.
// These are the float32 kernels (float32 FMAs on the CUDA cores); bfloat16
// inputs run the tensor-core kernels of flash_attention_{fwd,bwd}_wgmma.cu.
//
// Geometry: a block of 256 threads.  A q tile has kBQ = 64 rows and a kv
// tile kBKV = 32 keys.  For a score tile, thread t = 16 * ty + tx owns
// query rows ty + 16 i (i < 4) and keys tx + 16 c (c < 2); a row's 32
// scores sit in the 16 lanes of one half-warp, so row reductions are four
// shuffles.  For a D-wide accumulator tile, the same thread owns the same
// four rows and columns 4 tx + 64 jj .. + 3 (jj < D / 64), then, where
// D % 64 is not 0 (zamba2's D = 80), columns 64 (D / 64) + tx + 16 e
// (e < (D % 64) / 16), read and written one float at a time.  Tiles live in
// shared memory as float32 rows of D + 4 floats: the padding staggers the
// rows across banks, so the 16-byte reads of eight consecutive lanes of
// different rows never collide.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace flash_attention {

constexpr int kBQ = 64;          // q rows per tile
constexpr int kBKV = 32;         // keys per tile
constexpr int kThreads = 256;
constexpr int kPad = 4;          // floats of padding per shared row
constexpr int kLDP = kBKV + 1;   // row stride of a (kBQ x kBKV) p/ds tile
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;   // opt-in shared memory, H100

// element strides of a logical (B, H, S, D) tensor; d has stride 1
struct Layout {
  long long b, h, s;
};

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Rows row0 .. row0 + R - 1 of one (b, h) slice (``src`` points at its row
// 0, ``rs`` is the row stride) into ``dst`` (R rows of D + kPad floats),
// times ``mul``; rows at or past S are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int row0, int S,
                                          float mul) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    float v[8];
    if (row0 + r < S) {
      load8(src + static_cast<long long>(row0 + r) * rs + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= mul;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float* d = dst + r * (D + kPad) + c;
    store4(d, v);
    store4(d + 4, v + 4);
  }
}

// acc[i][c] += <a row ty + 16 i, b row tx + 16 c> over D, for a (kBQ x D)
// tile ``a`` and a (kBKV x D) tile ``b`` in shared memory
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float (&acc)[4][2]) {
  constexpr int LD = D + kPad;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      y[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc[i][c] = fmaf(x[i].x, y[c].x, acc[i][c]);
        acc[i][c] = fmaf(x[i].y, y[c].y, acc[i][c]);
        acc[i][c] = fmaf(x[i].z, y[c].z, acc[i][c]);
        acc[i][c] = fmaf(x[i].w, y[c].w, acc[i][c]);
      }
  }
}

// acc[i][4 jj + e] += sum_c w[(ty + 16 i) * ws + c * cs] *
// m[c][4 tx + 64 jj + e] over the nc rows of ``m`` (a tile of D + kPad
// floats a row): the thread's NR output rows ty + 16 i, each a weighted
// sum of the rows of ``m``.  With (ws, cs) = (kLDP, 1) the weights are the
// rows of a (kBQ x kBKV) p/ds tile; with (1, kLDP), its columns.
template <int D, int NR>
__device__ __forceinline__ void weighted_rows(const float* w, int ws, int cs,
                                              const float* m, int nc,
                                              float (&acc)[NR][D / 16]) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + kPad;
  constexpr int kMain = D / 64, kTail = (D % 64) / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int c = 0; c < nc; ++c) {
    float p[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) p[i] = w[(ty + 16 * i) * ws + c * cs];
#pragma unroll
    for (int jj = 0; jj < kMain; ++jj) {
      const float4 y =
          *reinterpret_cast<const float4*>(m + c * LD + 4 * tx + 64 * jj);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        acc[i][4 * jj + 0] = fmaf(p[i], y.x, acc[i][4 * jj + 0]);
        acc[i][4 * jj + 1] = fmaf(p[i], y.y, acc[i][4 * jj + 1]);
        acc[i][4 * jj + 2] = fmaf(p[i], y.z, acc[i][4 * jj + 2]);
        acc[i][4 * jj + 3] = fmaf(p[i], y.w, acc[i][4 * jj + 3]);
      }
    }
#pragma unroll
    for (int e = 0; e < kTail; ++e) {
      const float y = m[c * LD + 64 * kMain + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        acc[i][4 * kMain + e] = fmaf(p[i], y, acc[i][4 * kMain + e]);
    }
  }
}

// Write the thread's NR accumulator rows (rows row0 + ty + 16 i, its
// columns as above) divided by div[i] into ``dst`` (row stride ``rs``),
// skipping rows at or past S.
template <typename T, int D, int NR>
__device__ __forceinline__ void store_rows(T* dst, long long rs, int row0,
                                           int S,
                                           const float (&acc)[NR][D / 16],
                                           const float (&div)[NR]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
    T* out = dst + static_cast<long long>(row) * rs;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * jj + e] / div[i];
      store4(out + 4 * tx + 64 * jj, v);
    }
#pragma unroll
    for (int e = 0; e < (D % 64) / 16; ++e)
      store1(out + 64 * (D / 64) + tx + 16 * e,
             acc[i][4 * (D / 64) + e] / div[i]);
  }
}

// is key ``key`` visible to query ``row`` (causal, sliding window, inside
// the sequence)?
__device__ __forceinline__ bool visible(int row, int key, int S, int causal,
                                        int window) {
  bool ok = key < S && row < S;
  if (causal) ok = ok && key <= row;
  if (window) ok = ok && (row - key) < window;
  return ok;
}

// the per-device opt-in record (per_device.cuh): one flag a device
using PerDevice = ::PerDevice<bool>;

// Opt the kernel into ``smem`` bytes of dynamic shared memory, once per
// kernel and device (a static PerDevice per template instantiation of the
// caller, its flag for the current device).
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace flash_attention
