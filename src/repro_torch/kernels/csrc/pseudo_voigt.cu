// Separable pseudo-Voigt Bragg-peak fit for Hopper (sm_90a): the paper's
// "A" (analyse) operation, which labels Bragg-peak patches for BraggNN.
//
// Replaces the TPU kernel repro/kernels/pseudo_voigt.py::pseudo_voigt_fit
// (body _pv_kernel, _fit_block).  For every patch (ph, pw) it forms the row
// marginal (sum over columns: the y profile) and the column marginal (the
// x profile) and fits A * pV(x - x0; gamma) + bg to each by n_iter
// Gauss-Newton steps, each a regularised closed-form 3x3 solve.  Output
// (Np, 6) float32: (y0, x0, gy, gx, Ay, Ax).  The arithmetic is
// kernels/ref.py::pv_fit_1d, term for term: the same clamps, the same
// determinant rule (|det| < 1e-20 becomes +1e-20), true division and expf.
//
// What bounds it on the H100: bytes.  The patch is read once (121 floats
// at 11 x 11) and six floats are written; the fit is ~7 k float operations
// a patch, all in registers, which at 67 TFLOP/s stays under the byte
// time.  The TPU kernel vectorises a 256-patch VMEM block across lanes; here
// each thread owns one patch, so the math needs no cross-thread traffic.
//
// Schedule: a block of up to 128 threads, one patch each, first stages its
// patches (contiguous in memory) into shared memory with coalesced 16-byte
// loads: 62 KB at 11 x 11, over the 48 KB default, so the launch opts in
// to more dynamic shared memory.  Larger patches take 64 or 32 threads a
// block so the stage fits 227 KB.  Thread t then reads its own patch at a
// stride of ph * pw floats (odd at 11 x 11, so free of bank conflicts),
// sums its two marginals into registers and runs both fits there.  The
// marginal arrays have the compile-time size kMaxN and every loop over
// them is unrolled with a guard on the runtime length, so they stay in
// registers.  Threads past the last patch (the ragged tail) only help
// with the stage.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;           // largest ph and pw the kernel takes
constexpr int kMaxThreads = 128;    // patches (threads) per block
constexpr size_t kSmemLimit = 232448;
constexpr float kEta = 0.5f;        // fixed Lorentzian fraction
// sigma = C * gamma with C = 1 / sqrt(2 ln 2); the reference forms C * C
// in double before it meets a float32 tensor, so C2 is rounded once
constexpr double kCd = 0.84932180028801907;
constexpr float kC = static_cast<float>(kCd);
constexpr float kC2 = static_cast<float>(kCd * kCd);

// jnp.clip / torch.clamp: a NaN stays NaN, as in the reference
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__device__ __forceinline__ float at_least(float v, float lo) {
  return v < lo ? lo : v;
}

// Gauss-Newton fit of y[0:n] (overwritten with y - min y); returns
// (x0, gamma, A) as kernels/ref.py::pv_fit_1d does.
__device__ __forceinline__ void fit_1d(float (&y)[kMaxN], const int n,
                                       const int n_iter, float& x0_out,
                                       float& gamma_out, float& A_out) {
  float bg = y[0];
#pragma unroll
  for (int i = 1; i < kMaxN; ++i)
    if (i < n) bg = y[i] < bg ? y[i] : bg;
  float total = 0.f, sx = 0.f, peak = y[0] - bg;
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < n) {
      y[i] = y[i] - bg;
      total += y[i];
      sx += y[i] * static_cast<float>(i);
      peak = y[i] > peak ? y[i] : peak;
    }
  }
  total = at_least(total, 1e-12f);
  float x0 = sx / total;
  float sv = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    if (i < n) {
      const float d = static_cast<float>(i) - x0;
      sv += y[i] * (d * d);
    }
  }
  float gamma = sqrtf(at_least(sv / total, 0.25f));
  float A = at_least(peak, 1e-12f);

  for (int it = 0; it < n_iter; ++it) {
    const float g2 = gamma * gamma;
    const float sig = kC * gamma;
    const float two_sig2 = 2.0f * sig * sig;
    const float sig2 = sig * sig;
    const float g3 = g2 * gamma;
    const float c2g3 = kC2 * (gamma * gamma * gamma);
    float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a12 = 0.f, a22 = 0.f;
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxN; ++i) {
      if (i < n) {
        const float u = static_cast<float>(i) - x0;
        const float uu = u * u;
        const float lor = g2 / (uu + g2);
        const float gau = expf(-uu / two_sig2);
        const float d_lor_dx0 = 2.0f * u * lor * lor / g2;
        const float d_gau_dx0 = gau * u / sig2;
        const float d_lor_dg = 2.0f * u * u * lor * lor / g3;
        const float d_gau_dg = gau * u * u / c2g3;
        const float p = kEta * lor + (1.0f - kEta) * gau;
        const float j1 = A * (kEta * d_lor_dx0 + (1.0f - kEta) * d_gau_dx0);
        const float j2 = A * (kEta * d_lor_dg + (1.0f - kEta) * d_gau_dg);
        const float r = y[i] - A * p;
        a00 += p * p;
        a01 += p * j1;
        a02 += p * j2;
        a11 += j1 * j1;
        a12 += j1 * j2;
        a22 += j2 * j2;
        b0 += p * r;
        b1 += j1 * r;
        b2 += j2 * r;
      }
    }
    const float lam = 1e-6f * (a00 + a11 + a22) + 1e-12f;
    a00 = a00 + lam;
    a11 = a11 + lam;
    a22 = a22 + lam;
    float det = (a00 * (a11 * a22 - a12 * a12) - a01 * (a01 * a22 - a12 * a02) +
                 a02 * (a01 * a12 - a11 * a02));
    if (fabsf(det) < 1e-20f) det = 1e-20f;
    const float i00 = a11 * a22 - a12 * a12;
    const float i01 = a02 * a12 - a01 * a22;
    const float i02 = a01 * a12 - a02 * a11;
    const float i11 = a00 * a22 - a02 * a02;
    const float i12 = a02 * a01 - a00 * a12;
    const float i22 = a00 * a11 - a01 * a01;
    const float dA = (i00 * b0 + i01 * b1 + i02 * b2) / det;
    const float dx0 = (i01 * b0 + i11 * b1 + i12 * b2) / det;
    const float dg = (i02 * b0 + i12 * b1 + i22 * b2) / det;
    A = at_least(A + dA, 1e-12f);
    x0 = clampf(x0 + dx0, 0.0f, static_cast<float>(n) - 1.0f);
    gamma = clampf(gamma + dg, 0.3f, static_cast<float>(n));
  }
  x0_out = x0;
  gamma_out = gamma;
  A_out = A;
}

__global__ void __launch_bounds__(kMaxThreads)
pseudo_voigt_kernel(const float* __restrict__ patches,
                    float* __restrict__ out, int Np, int ph, int pw,
                    int n_iter) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int per = ph * pw;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long left = Np - first;
  const int count = left < blockDim.x ? static_cast<int>(left) : blockDim.x;
  // the block's patches are contiguous; blockDim.x is a multiple of 4, so
  // with a 16-byte aligned base (the wrapper checks it) so is src
  const float* src = patches + first * per;
  const int total = count * per;
  const int n4 = total / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) stage4[i] = src4[i];
  for (int i = 4 * n4 + threadIdx.x; i < total; i += blockDim.x)
    stage[i] = src[i];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= count) return;

  const float* mine = stage + static_cast<size_t>(threadIdx.x) * per;
  float m[kMaxN];
  float res[6];
  // row marginal: the y profile
#pragma unroll
  for (int r = 0; r < kMaxN; ++r) {
    if (r < ph) {
      float s = 0.f;
      for (int c = 0; c < pw; ++c) s += mine[r * pw + c];
      m[r] = s;
    }
  }
  fit_1d(m, ph, n_iter, res[0], res[2], res[4]);
  // column marginal: the x profile
#pragma unroll
  for (int c = 0; c < kMaxN; ++c) m[c] = 0.f;
  for (int r = 0; r < ph; ++r) {
#pragma unroll
    for (int c = 0; c < kMaxN; ++c)
      if (c < pw) m[c] += mine[r * pw + c];
  }
  fit_1d(m, pw, n_iter, res[1], res[3], res[5]);
  float* dst = out + (first + threadIdx.x) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) dst[k] = res[k];
}

}  // namespace

extern "C" {

// Threads (patches) per block for (ph, pw) patches: 128, halved while the
// staged patches would not fit the opt-in shared memory (32 always fits).
int pseudo_voigt_threads(int ph, int pw) {
  int threads = kMaxThreads;
  while (threads > 32 &&
         static_cast<size_t>(threads) * ph * pw * sizeof(float) > kSmemLimit)
    threads /= 2;
  return threads;
}

// patches (Np, ph, pw) float32, contiguous, 16-byte aligned; out (Np, 6)
// float32.  1 <= ph, pw <= 32.  Returns cudaGetLastError() after the
// launch (0 = success).
int pseudo_voigt_launch(const void* patches, void* out, int Np, int ph,
                        int pw, int n_iter, void* stream) {
  if (ph < 1 || pw < 1 || ph > kMaxN || pw > kMaxN || n_iter < 0)
    return cudaErrorInvalidValue;
  if (Np <= 0) return 0;
  const int threads = pseudo_voigt_threads(ph, pw);
  const size_t smem = static_cast<size_t>(threads) * ph * pw * sizeof(float);
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        pseudo_voigt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  const int blocks = (Np + threads - 1) / threads;
  pseudo_voigt_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(patches), static_cast<float*>(out), Np, ph,
      pw, n_iter);
  return cudaGetLastError();
}

}  // extern "C"
