// Shared pieces of the port's chunked-scan kernels for Hopper (sm_90a):
// B5, the Mamba2 SSD scan (ssm_scan.cu in float32, ssm_scan_tc.cu in
// bf16), and B4, the chunkwise mLSTM (mlstm_scan.cu in float32,
// mlstm_scan_tc.cu in bf16).  All read logical (B, heads, L, width)
// tensors given by their element strides over (b, head, position), with
// the last axis contiguous, so the models' (B, L, heads, width)
// activations are read in place through transposed views.  The float32
// kernels compute in float32 throughout; the bf16 ones run their products
// on the tensor cores (bf16 operands, float32 sums) and round their
// intermediates where the models' plain versions round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace scan {

constexpr int kThreads = 256;            // 16 x 16 threads a block
constexpr size_t kSmemLimit = 232448;    // opt-in shared memory, H100

// element strides of a logical (B, heads, L, width) tensor; width has
// stride 1
struct Layout {
  long long b, h, l;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Opt ``kernel`` into the largest dynamic shared memory once a device (a
// static PerDevice per template instantiation of the caller holds the
// flags; the opt-in acts on the current device).
template <typename K>
__host__ cudaError_t allow_smem(K kernel, PerDevice<bool>& record) {
  bool& done = record.here();
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemLimit));
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace scan
