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
// What bounds it on the H100: the fit.  The patch is read once (121 floats
// at 11 x 11) and six floats are written (0.12 ms at 800,000 patches), but
// each 1-D fit runs n_iter Gauss-Newton steps of ~6 true divisions and an
// expf a point, serial chains that only many threads in flight can hide.
//
// Schedule (redesigned for occupancy): a block of 256 threads takes 128
// patches, in two phases.
//   * Marginals.  The block stages its patches, a few at a time, into a
//     16 KB shared tile with coalesced 16-byte loads (a sub-tile of
//     ~4,096 floats, reused), and reduces each to its row and column
//     marginals, one thread a (patch, row) and a (patch, column), summing
//     in the plain version's order; the 128 x (ph + pw) marginals stay in
//     shared memory (rows of an odd stride: conflict-free reads).
//   * Fits.  Thread t fits one profile: the row marginal of patch t for
//     t < 128, the column marginal of patch t - 128 else (warp-uniform),
//     so 1.6 M independent fits at 800,000 peaks.  The fit is a template
//     on the profile length: 11 x 11 (the paper's patches) has its own
//     instantiation, 11 registers of profile and loops unrolled without
//     guards; a 32-slot instantiation with guarded loops takes the other
//     shapes.  The six results of a patch meet in shared memory and leave
//     in one coalesced store.  Threads past the last patch (the ragged
//     tail) only help with the stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;           // largest ph and pw the kernel takes
constexpr int kThreads = 256;       // one a profile: two a patch
constexpr int kTile = kThreads / 2; // patches a block
constexpr int kPaper = 11;          // the paper's patch side
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
// (x0, gamma, A) as kernels/ref.py::pv_fit_1d does.  kExact: n == N, so
// no loop needs a guard.
template <int N, bool kExact>
__device__ __forceinline__ void fit_1d(float (&y)[N], const int n,
                                       const int n_iter, float& x0_out,
                                       float& gamma_out, float& A_out) {
  float bg = y[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (kExact || i < n) bg = y[i] < bg ? y[i] : bg;
  float total = 0.f, sx = 0.f, peak = y[0] - bg;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kExact || i < n) {
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
  for (int i = 0; i < N; ++i) {
    if (kExact || i < n) {
      const float d = static_cast<float>(i) - x0;
      sv += y[i] * (d * d);
    }
  }
  float gamma = sqrtf(at_least(sv / total, 0.25f));
  float A = at_least(peak, 1e-12f);
  const float nf = static_cast<float>(kExact ? N : n);

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
    for (int i = 0; i < N; ++i) {
      if (kExact || i < n) {
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
    x0 = clampf(x0 + dx0, 0.0f, nf - 1.0f);
    gamma = clampf(gamma + dg, 0.3f, nf);
  }
  x0_out = x0;
  gamma_out = gamma;
  A_out = A;
}

// N: profile slots (kPaper with kExact for 11 x 11 patches, else kMaxN);
// kStage: floats of the shared sub-tile the patches are staged through;
// ``sub`` patches (sub * ph * pw <= kStage) are staged at a time.  The
// 11 x 11 instantiation keeps to 48 registers a thread: five blocks, 40
// warps, a SM.
template <int N, bool kExact, int kStage>
__global__ void __launch_bounds__(kThreads, kExact ? 5 : 1)
pseudo_voigt_kernel(const float* __restrict__ patches,
                    float* __restrict__ out, int Np, int ph, int pw,
                    int n_iter, int sub) {
  __shared__ __align__(16) float stage[kStage];
  __shared__ float marg[kTile * ((2 * N) | 1)];
  __shared__ float res[kTile * 6];
  if (kExact) ph = pw = N;
  const int per = ph * pw, nm = ph + pw, ld = nm | 1;
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = Np - first;
  const int count = left < kTile ? static_cast<int>(left) : kTile;

  // marginals, sub patches at a time: row sums (the y profile) then
  // column sums (the x profile), each in index order as the plain version
  for (int k0 = 0; k0 < count; k0 += sub) {
    const int ks = count - k0 < sub ? count - k0 : sub;
    const float* src = patches + (first + k0) * per;
    const int total = ks * per;
    // the sub-tile is contiguous; copy it 16 bytes at a time from the
    // first 16-byte aligned float on (the base is 16-byte aligned)
    const int head = static_cast<int>(
        (16 - reinterpret_cast<uintptr_t>(src) % 16) % 16 / 4);
    const int lead = head < total ? head : total;
    const int n4 = (total - lead) / 4;
    const float4* src4 = reinterpret_cast<const float4*>(src + lead);
    for (int i = tid; i < lead; i += kThreads) stage[i] = src[i];
    for (int i = tid; i < n4; i += kThreads) {
      const float4 v = src4[i];
      float* d = stage + lead + 4 * i;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
    for (int i = lead + 4 * n4 + tid; i < total; i += kThreads)
      stage[i] = src[i];
    __syncthreads();
    for (int task = tid; task < ks * nm; task += kThreads) {
      float s = 0.f;
      int k, slot;
      if (task < ks * ph) {
        k = task / ph;
        const int r = task - k * ph;
        const float* row = stage + k * per + r * pw;
#pragma unroll
        for (int c = 0; c < N; ++c)
          if (kExact || c < pw) s += row[c];
        slot = r;
      } else {
        const int t = task - ks * ph;
        k = t / pw;
        const int c = t - k * pw;
        const float* col = stage + k * per + c;
#pragma unroll
        for (int r = 0; r < N; ++r)
          if (kExact || r < ph) s += col[r * pw];
        slot = ph + c;
      }
      marg[(k0 + k) * ld + slot] = s;
    }
    __syncthreads();
  }

  // one profile a thread
  const int axis = tid / kTile, k = tid - axis * kTile;
  if (k < count) {
    const int n = axis ? pw : ph;
    const float* m = marg + k * ld + (axis ? ph : 0);
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = (kExact || i < n) ? m[i] : 0.f;
    float x0, gamma, A;
    fit_1d<N, kExact>(y, n, n_iter, x0, gamma, A);
    res[k * 6 + axis] = x0;
    res[k * 6 + 2 + axis] = gamma;
    res[k * 6 + 4 + axis] = A;
  }
  __syncthreads();
  float* dst = out + first * 6;
  for (int i = tid; i < count * 6; i += kThreads) dst[i] = res[i];
}

}  // namespace

extern "C" {

// patches (Np, ph, pw) float32, contiguous, 16-byte aligned; out (Np, 6)
// float32.  1 <= ph, pw <= 32.  Returns cudaGetLastError() after the
// launch (0 = success).
int pseudo_voigt_launch(const void* patches, void* out, int Np, int ph,
                        int pw, int n_iter, void* stream) {
  if (ph < 1 || pw < 1 || ph > kMaxN || pw > kMaxN || n_iter < 0)
    return cudaErrorInvalidValue;
  if (Np <= 0) return 0;
  const int blocks = (Np + kTile - 1) / kTile;
  const float* p = static_cast<const float*>(patches);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ph == kPaper && pw == kPaper) {
    constexpr int kStage = 4096;
    const int sub = kStage / (kPaper * kPaper);
    pseudo_voigt_kernel<kPaper, true, kStage>
        <<<blocks, kThreads, 0, st>>>(p, o, Np, ph, pw, n_iter, sub);
  } else {
    constexpr int kStage = 2048;     // shared memory stays under 48 KB
    const int sub = kStage / (ph * pw);
    pseudo_voigt_kernel<kMaxN, false, kStage>
        <<<blocks, kThreads, 0, st>>>(p, o, Np, ph, pw, n_iter, sub);
  }
  return cudaGetLastError();
}

}  // extern "C"
