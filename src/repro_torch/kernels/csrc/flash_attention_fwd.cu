// Flash-attention forward for Hopper (sm_90a): B6 and, behind the ``lse``
// flag, B6f, for float32 inputs (bfloat16, the models' type, runs the
// tensor-core kernel of flash_attention_fwd_wgmma.cu).
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::
// flash_attention (body _attn_kernel) and _flash_fwd_lse (body
// _attn_fwd_lse_kernel).  For q (B, H, S, D) and k/v (B, Hkv, S, D), query
// head h reads kv head h / (H / Hkv); causal, with an optional sliding
// window; o (B, H, S, D) and, for B6f, the logsumexp of every query's
// masked scores, lse (B, H, S) = m + log(max(l, 1e-30)), all float32.
// The arithmetic is the TPU kernel's: q is scaled by 1/sqrt(D) before
// QK^T, masked scores are -1e30, the online softmax keeps the running max
// m, sum l and accumulator, and o = acc / max(l, 1e-30) (the TPU kernel's
// rounding of the weights to the input type before PV is the identity in
// float32).
//
// Schedule: one block per (q tile of 64 rows, head, batch) loops over the
// kv tiles of 32 keys that the causal and window bounds leave in band
// (the TPU's sequential kv grid axis becomes this loop; tiles wholly
// outside the band are never read).  The q tile stays in shared memory for
// the whole loop; each K and V tile is loaded once into shared memory, in
// float32; scores, weights and the online-softmax state stay on chip.
// Rows and keys past S are masked here, so nothing is padded.
//
// What bounds it on the H100: operations.  A (64-row, 32-key) tile pair
// does 2 x 64 x 32 x D multiply-adds against (64 + 64) x D loaded values,
// and at S = 4096 the causal band is 137 GFLOP per layer of gemma-7b
// against 134 MB of q, k, v and o.  This first version does them as
// float32 FMAs on the CUDA cores (no mma.sync, no wgmma, no TMA
// pipelining): each thread owns a 4 x 2 score block and a 4 x D/16 slice
// of the accumulator, so every 16-byte shared-memory read feeds 4 or 8
// FMAs.  At D = 256 a block takes 141 KB of shared memory, one block an SM.

#include "flash_attention_common.cuh"

namespace flash_attention {
namespace {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;           // null: B6 (no logsumexp)
  Layout q_st, k_st, v_st, o_st;
  int H, Hkv, S;
  float scale;
  int causal, window;
};

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBKV) * (D + kPad) + kBQ * kLDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + kPad;
  float* Qs = smem;                    // kBQ x LD, scaled q
  float* Ks = Qs + kBQ * LD;           // kBKV x LD
  float* Vs = Ks + kBKV * LD;          // kBKV x LD
  float* Ps = Vs + kBKV * LD;          // kBQ x kLDP, weights in T

  const int b = blockIdx.z, h = blockIdx.y;
  const int kh = h / (a.H / a.Hkv);
  const int S = a.S;
  const int q_lo = blockIdx.x * kBQ;
  const int q_hi = min(q_lo + kBQ, S) - 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_st.b + kh * a.k_st.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_st.b + kh * a.v_st.h;

  load_rows<T, D, kBQ>(Qs, qp, a.q_st.s, q_lo, S, a.scale);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  // the kv tiles in band: keys at or before q_hi (causal), and after
  // q_lo - window (sliding window)
  int j_first = 0, j_last = (S - 1) / kBKV;
  if (a.causal) j_last = min(j_last, q_hi / kBKV);
  if (a.window) j_first = max(0, q_lo - a.window + 1) / kBKV;

  for (int j = j_first; j <= j_last; ++j) {
    const int k_lo = j * kBKV;
    __syncthreads();                   // the last tile's reads are done
    load_rows<T, D, kBKV>(Ks, kp, a.k_st.s, k_lo, S, 1.f);
    load_rows<T, D, kBKV>(Vs, vp, a.v_st.s, k_lo, S, 1.f);
    __syncthreads();

    float s[4][2] = {};
    dot_tile<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // (a row past S sees no key; it stays finite and is never written)
        if (!visible(row, k_lo + tx + 16 * c, S, a.causal, a.window))
          s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(s[i][c] - m_new);
        psum += p;
        Ps[(ty + 16 * i) * kLDP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[i][e] *= corr;
    }
    __syncthreads();
    weighted_rows<D, 4>(Ps, kLDP, 1, Vs, kBKV, acc);
  }

  float denom[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) denom[i] = fmaxf(l[i], 1e-30f);
  T* op = static_cast<T*>(a.o) + b * a.o_st.b + h * a.o_st.h;
  store_rows<T, D, 4>(op, a.o_st.s, q_lo, S, acc, denom);
  if (a.lse != nullptr && tx == 0) {
    float* lp = a.lse + (static_cast<long long>(b) * a.H + h) * S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + ty + 16 * i;
      if (row < S) lp[row] = m[i] + logf(denom[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  static PerDevice granted;
  const size_t smem = fwd_smem<D>();
  static_assert(fwd_smem<D>() <= kSmemLimit, "tiles exceed shared memory");
  cudaError_t e = allow_smem(fwd_kernel<T, D>, smem, granted.here());
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FwdArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 80>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace flash_attention

extern "C" {

// q (B, H, S, D), k/v (B, Hkv, S, D), o like q, all float32 (dtype 0), d
// contiguous, 16-byte aligned; ``strides`` holds the (b, h, s) element
// strides of q, k, v and o, 12 values.  ``lse`` is null (B6) or a
// contiguous (B, H, S) float32 output (B6f).  D in {64, 80, 128, 256}.
// Returns cudaGetLastError() after the launch.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, void* lse, const long long* strides,
                               int B, int H, int Hkv, int S, int D,
                               int dtype, int causal, int window,
                               float scale, void* stream) {
  using namespace flash_attention;
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = static_cast<float*>(lse);
  a.q_st = {strides[0], strides[1], strides[2]};
  a.k_st = {strides[3], strides[4], strides[5]};
  a.v_st = {strides[6], strides[7], strides[8]};
  a.o_st = {strides[9], strides[10], strides[11]};
  a.H = H; a.Hkv = Hkv; a.S = S;
  a.scale = scale; a.causal = causal; a.window = window;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, B, D, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
