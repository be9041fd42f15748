// Flash-attention backward for Hopper (sm_90a): B6b, as two kernels, dq
// and dk/dv, for float32 inputs (bfloat16 runs the tensor-core kernels of
// flash_attention_bwd_wgmma.cu).
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py::_flash_bwd:
// _dq_kernel and _dkv_kernel.  Inputs are the forward's q (B, H, S, D),
// k/v (B, Hkv, S, D), the output's gradient do (like q), the forward's
// logsumexp lse (B, H, S) float32 and delta = sum(do * o) (B, H, S)
// float32, which the wrapper forms as the reference does outside its
// kernels.  The arithmetic is _flash_bwd's, all in float32: s = (q . k) *
// scale, p = exp(s - lse) inside the causal/window mask and 0 outside,
// dp = do . v, ds = p * (dp - delta) * scale; dq = ds k, dk = ds^T q and
// dv = p^T do, dk and dv summed over the G query heads of their kv head.
//
// Schedules (the TPU's sequential grid axes become loops inside a block):
//   * dq: one block per (q tile of 64 rows, head, batch); q, do, lse and
//     delta of the tile stay on chip while the block loops over the
//     in-band kv tiles of 32 keys, forms p and ds for the (64 x 32) tile
//     and accumulates ds k into a float32 (64 x D) accumulator;
//   * dk/dv: one block per (kv tile of 32 keys, kv head, batch); k and v
//     of the tile stay on chip while the block loops over the G query
//     heads of the kv head and, for each, over the in-band q tiles, and
//     accumulates p^T do and ds^T q into two float32 (32 x D)
//     accumulators.  The order of the sums is fixed (heads, then q tiles,
//     as the TPU grid (B, Hkv, nkv, G, nq)), so no atomics are needed and
//     the result is deterministic.
//
// What bounds them on the H100: operations.  dq does 3 and dk/dv 4 D-long
// dot products per visible (query, key) pair, 6 and 8 x D FLOPs, against
// one read of their inputs.  As in the forward, this first version runs
// float32 FMAs on the CUDA cores with register-blocked tiles; at D = 256
// dq takes 208 KB and dk/dv 217 KB of shared memory, one block an SM.

#include "flash_attention_common.cuh"

namespace flash_attention {
namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  Layout q_st, k_st, v_st, do_st, dq_st, dk_st, dv_st;
  int H, Hkv, S;
  float scale;
  int causal, window;
};

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (static_cast<size_t>(2 * kBQ + 2 * kBKV) * (D + kPad) + kBQ * kLDP);
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (static_cast<size_t>(2 * kBQ + 2 * kBKV) * (D + kPad) +
          2 * kBQ * kLDP + 2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + kPad;
  float* Qs = smem;                    // kBQ x LD
  float* dOs = Qs + kBQ * LD;          // kBQ x LD
  float* Ks = dOs + kBQ * LD;          // kBKV x LD
  float* Vs = Ks + kBKV * LD;          // kBKV x LD
  float* dSs = Vs + kBKV * LD;         // kBQ x kLDP

  const int b = blockIdx.z, h = blockIdx.y;
  const int kh = h / (a.H / a.Hkv);
  const int S = a.S;
  const int q_lo = blockIdx.x * kBQ;
  const int q_hi = min(q_lo + kBQ, S) - 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_st.b + kh * a.k_st.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_st.b + kh * a.v_st.h;
  load_rows<T, D, kBQ>(
      Qs, static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h,
      a.q_st.s, q_lo, S, 1.f);
  load_rows<T, D, kBQ>(
      dOs, static_cast<const T*>(a.dout) + b * a.do_st.b + h * a.do_st.h,
      a.do_st.s, q_lo, S, 1.f);
  const long long bh = (static_cast<long long>(b) * a.H + h) * S;
  float lse[4], delta[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty + 16 * i;
    lse[i] = row < S ? a.lse[bh + row] : 0.f;
    delta[i] = row < S ? a.delta[bh + row] : 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  int j_first = 0, j_last = (S - 1) / kBKV;
  if (a.causal) j_last = min(j_last, q_hi / kBKV);
  if (a.window) j_first = max(0, q_lo - a.window + 1) / kBKV;

  for (int j = j_first; j <= j_last; ++j) {
    const int k_lo = j * kBKV;
    __syncthreads();
    load_rows<T, D, kBKV>(Ks, kp, a.k_st.s, k_lo, S, 1.f);
    load_rows<T, D, kBKV>(Vs, vp, a.v_st.s, k_lo, S, 1.f);
    __syncthreads();
    float s[4][2] = {}, dp[4][2] = {};
    dot_tile<D>(Qs, Ks, s);
    dot_tile<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p =
            visible(row, k_lo + tx + 16 * c, S, a.causal, a.window)
                ? expf(s[i][c] * a.scale - lse[i])
                : 0.f;
        dSs[(ty + 16 * i) * kLDP + tx + 16 * c] =
            p * (dp[i][c] - delta[i]) * a.scale;
      }
    }
    __syncthreads();
    weighted_rows<D, 4>(dSs, kLDP, 1, Ks, kBKV, acc);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D, 4>(static_cast<T*>(a.dq) + b * a.dq_st.b + h * a.dq_st.h,
                      a.dq_st.s, q_lo, S, acc, one);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + kPad;
  float* Ks = smem;                    // kBKV x LD
  float* Vs = Ks + kBKV * LD;          // kBKV x LD
  float* Qs = Vs + kBKV * LD;          // kBQ x LD
  float* dOs = Qs + kBQ * LD;          // kBQ x LD
  float* Ps = dOs + kBQ * LD;          // kBQ x kLDP
  float* dSs = Ps + kBQ * kLDP;        // kBQ x kLDP
  float* Ls = dSs + kBQ * kLDP;        // kBQ: lse of the q tile's rows
  float* Ds = Ls + kBQ;                // kBQ: delta

  const int b = blockIdx.z, kh = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int S = a.S;
  const int k_lo = blockIdx.x * kBKV;
  const int k_hi = min(k_lo + kBKV, S) - 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D, kBKV>(
      Ks, static_cast<const T*>(a.k) + b * a.k_st.b + kh * a.k_st.h,
      a.k_st.s, k_lo, S, 1.f);
  load_rows<T, D, kBKV>(
      Vs, static_cast<const T*>(a.v) + b * a.v_st.b + kh * a.v_st.h,
      a.v_st.s, k_lo, S, 1.f);
  float dk[2][D / 16], dv[2][D / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) dk[i][e] = dv[i][e] = 0.f;

  // the q tiles in band: rows at or after k_lo (causal), before
  // k_hi + window (sliding window)
  const int i_first = a.causal ? k_lo / kBQ : 0;
  int i_last = (S - 1) / kBQ;
  if (a.window) i_last = min(i_last, (k_hi + a.window - 1) / kBQ);

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
    const T* dop =
        static_cast<const T*>(a.dout) + b * a.do_st.b + h * a.do_st.h;
    const long long bh = (static_cast<long long>(b) * a.H + h) * S;
    for (int i = i_first; i <= i_last; ++i) {
      const int q_lo = i * kBQ;
      __syncthreads();                 // the last q tile's reads are done
      load_rows<T, D, kBQ>(Qs, qp, a.q_st.s, q_lo, S, 1.f);
      load_rows<T, D, kBQ>(dOs, dop, a.do_st.s, q_lo, S, 1.f);
      for (int t = threadIdx.x; t < kBQ; t += kThreads) {
        const bool in = q_lo + t < S;
        Ls[t] = in ? a.lse[bh + q_lo + t] : 0.f;
        Ds[t] = in ? a.delta[bh + q_lo + t] : 0.f;
      }
      __syncthreads();
      float s[4][2] = {}, dp[4][2] = {};
      dot_tile<D>(Qs, Ks, s);
      dot_tile<D>(dOs, Vs, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lr = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p =
              visible(q_lo + lr, k_lo + tx + 16 * c, S, a.causal, a.window)
                  ? expf(s[r][c] * a.scale - Ls[lr])
                  : 0.f;
          Ps[lr * kLDP + tx + 16 * c] = p;
          dSs[lr * kLDP + tx + 16 * c] = p * (dp[r][c] - Ds[lr]) * a.scale;
        }
      }
      __syncthreads();
      // key ty + 16 i of the tile: dv += sum over rows of p * do, dk +=
      // sum over rows of ds * q (the columns of the p and ds tiles)
      weighted_rows<D, 2>(Ps, 1, kLDP, dOs, kBQ, dv);
      weighted_rows<D, 2>(dSs, 1, kLDP, Qs, kBQ, dk);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, D, 2>(static_cast<T*>(a.dk) + b * a.dk_st.b + kh * a.dk_st.h,
                      a.dk_st.s, k_lo, S, dk, one);
  store_rows<T, D, 2>(static_cast<T*>(a.dv) + b * a.dv_st.b + kh * a.dv_st.h,
                      a.dv_st.s, k_lo, S, dv, one);
}

template <typename T, int D>
cudaError_t launch(const BwdArgs& a, int B, bool dkv, cudaStream_t stream) {
  static_assert(dq_smem<D>() <= kSmemLimit && dkv_smem<D>() <= kSmemLimit,
                "tiles exceed shared memory");
  if (dkv) {
    static PerDevice granted;
    const cudaError_t e = allow_smem(dkv_kernel<T, D>, dkv_smem<D>(),
                                     granted.here());
    if (e != cudaSuccess) return e;
    const dim3 grid((a.S + kBKV - 1) / kBKV, a.Hkv, B);
    dkv_kernel<T, D><<<grid, kThreads, dkv_smem<D>(), stream>>>(a);
  } else {
    static PerDevice granted;
    const cudaError_t e = allow_smem(dq_kernel<T, D>, dq_smem<D>(),
                                     granted.here());
    if (e != cudaSuccess) return e;
    const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
    dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdArgs& a, int B, int D, bool dkv,
                     cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, dkv, stream);
    case 80: return launch<T, 80>(a, B, dkv, stream);
    case 128: return launch<T, 128>(a, B, dkv, stream);
    case 256: return launch<T, 256>(a, B, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, const long long* strides, int B, int H, int Hkv,
               int S, int D, int dtype, int causal, int window, float scale,
               void* stream, bool dkv) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  Layout* st[7] = {&a.q_st, &a.k_st, &a.v_st, &a.do_st, &a.dq_st, &a.dk_st,
                   &a.dv_st};
  for (int t = 0; t < 7; ++t)
    *st[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  a.H = H; a.Hkv = Hkv; a.S = S;
  a.scale = scale; a.causal = causal; a.window = window;
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, B, D, dkv, st_);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash_attention

extern "C" {

// Both entry points take the same arguments: q, k, v, do (like q), lse
// and delta (contiguous (B, H, S) float32), and the outputs dq (like q),
// dk and dv (like k, v), all float32 (dtype 0), d contiguous, 16-byte
// aligned; ``strides`` holds the (b, h, s) element strides of q, k, v, do,
// dq, dk and dv, 21 values.  D in {64, 80, 128, 256}.
// The dq launch writes only dq, the dk/dv launch only dk and dv.  Each
// returns cudaGetLastError() after its launch.
int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv,
                              const long long* strides, int B, int H,
                              int Hkv, int S, int D, int dtype, int causal,
                              int window, float scale, void* stream) {
  return flash_attention::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv,
                                     strides, B, H, Hkv, S, D, dtype, causal,
                                     window, scale, stream, false);
}

int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, const long long* strides, int B,
                               int H, int Hkv, int S, int D, int dtype,
                               int causal, int window, float scale,
                               void* stream) {
  return flash_attention::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv,
                                     strides, B, H, Hkv, S, D, dtype, causal,
                                     window, scale, stream, true);
}

}  // extern "C"
