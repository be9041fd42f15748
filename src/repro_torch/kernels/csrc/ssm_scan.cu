// Mamba2 SSD chunked scan for Hopper (sm_90a): B5 for float32 inputs
// (bf16 runs the tensor-core kernel, ssm_scan_tc.cu).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssd_scan (body
// _ssd_kernel).  For xdt (B, H, L, P) (inputs already multiplied by dt),
// dA (B, H, L) float32 (dt * A, negative) and the maps Bm, Cm (B, G, L, N),
// head h reading group h / (H / G), it computes y (B, H, L, P) in xdt's
// type.  Per chunk of Q positions, in float32, as the TPU kernel:
//
//   cum   = inclusive cumsum(dA)                          (Q,)
//   W     = (C B^T) o exp(cum_i - cum_j), j <= i only     (Q, Q)
//   y     = exp(cum_i) (C S^T)_i + (W xdt)_i              (Q, P)
//   S     = exp(cum_last) S + xdt^T (B o exp(cum_last - cum))   (P, N)
//
// exp(cum_i - cum_j) is formed only for j <= i, where it is at most 1: for
// j > i it would overflow, and a masked inf times 0 is NaN.
//
// Schedule: one block per (head, batch); the TPU grid's sequential chunk
// axis becomes a loop inside the block, and the (P x N) float32 state
// stays in shared memory across chunks (16 KB at P = N = 64).  Each
// chunk's xdt, B and C are loaded into shared memory as float32, the
// (Q x Q) weights W are formed there, and every product is a register
// tile per thread: thread (tx, ty) of the 16 x 16 grid owns rows ty + 16 r
// and columns tx + 16 c of each output, so each shared-memory read feeds
// several FMAs, and rows are padded to an odd stride against bank
// conflicts.
//
// What bounds it on the H100: at zamba2-2.7b's shapes (H 80, P 64, N 64,
// Q 128, L 4096) a call does ~16 GFLOP.  This kernel does its products as
// float32 FMAs on the CUDA cores (no mma, no pipelining), so operations
// bound it; and with B = 1 only 80 of the 132 SMs have a block.

#include "scan_common.cuh"

namespace ssd {
namespace {

using scan::kThreads;
using scan::Layout;
using scan::to_f32;

constexpr int kR = 8;          // rows (or columns) per thread: 16 x 8 = 128
constexpr int kMaxQ = 16 * kR;

struct Args {
  const void* xdt;
  const float* dA;
  const void* Bm;
  const void* Cm;
  void* y;
  Layout x_st, a_st, b_st, c_st, y_st;
  int H, G, L, P, N, Q;
};

size_t smem_bytes(int Q, int P, int N) {
  const size_t f = static_cast<size_t>(Q) * P + 2 * Q * (N + 1) +
                   Q * (Q + 1) + P * (N + 1) + 2 * Q;
  return f * sizeof(float);
}

// RP: columns (rows) per thread over P and N, 16 x RP >= max(P, N)
template <typename T, int RP>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Q = a.Q, P = a.P, N = a.N;
  const int LDN = N + 1, LDW = Q + 1;
  float* Xs = sm;                  // Q x P    xdt of the chunk
  float* Bs = Xs + Q * P;          // Q x LDN  B
  float* Cs = Bs + Q * LDN;        // Q x LDN  C
  float* Ws = Cs + Q * LDN;        // Q x LDW  W
  float* St = Ws + Q * LDW;        // P x LDN  the carried state
  float* cum = St + P * LDN;       // Q
  float* dec = cum + Q;            // Q        exp(cum_last - cum_j)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const T* xp = static_cast<const T*>(a.xdt) + b * a.x_st.b + h * a.x_st.h;
  const float* ap = a.dA + b * a.a_st.b + h * a.a_st.h;
  const T* bp = static_cast<const T*>(a.Bm) + b * a.b_st.b + g * a.b_st.h;
  const T* cp = static_cast<const T*>(a.Cm) + b * a.c_st.b + g * a.c_st.h;
  T* yp = static_cast<T*>(a.y) + b * a.y_st.b + h * a.y_st.h;

  for (int i = t; i < P * LDN; i += kThreads) St[i] = 0.f;

  for (int c0 = 0; c0 < a.L; c0 += Q) {
    __syncthreads();               // the last chunk is done with the tiles
    for (int i = t; i < Q * P; i += kThreads) {
      const int r = i / P, col = i % P;
      Xs[i] = to_f32(xp[static_cast<long long>(c0 + r) * a.x_st.l + col]);
    }
    for (int i = t; i < Q * N; i += kThreads) {
      const int r = i / N, col = i % N;
      const long long row = c0 + r;
      Bs[r * LDN + col] = to_f32(bp[row * a.b_st.l + col]);
      Cs[r * LDN + col] = to_f32(cp[row * a.c_st.l + col]);
    }
    if (t < Q) cum[t] = ap[static_cast<long long>(c0 + t) * a.a_st.l];
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += cum[i];
        cum[i] = s;
      }
    }
    __syncthreads();
    if (t < Q) dec[t] = expf(cum[Q - 1] - cum[t]);

    // W = (C B^T) o exp(cum_i - cum_j) for j <= i, 0 above the diagonal
    {
      float acc[kR][kR] = {};
      for (int n = 0; n < N; ++n) {
        float cv[kR], bv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          cv[r] = i < Q ? Cs[i * LDN + n] : 0.f;
          bv[r] = (tx + 16 * r) < Q ? Bs[(tx + 16 * r) * LDN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kR; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int j = tx + 16 * c;
          if (j >= Q) continue;
          Ws[i * LDW + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = exp(cum_i) (C S^T)_i + (W xdt)_i
    {
      float acc[kR][RP] = {};
      for (int n = 0; n < N; ++n) {
        float cv[kR], sv[RP];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          cv[r] = i < Q ? Cs[i * LDN + n] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < RP; ++c) {
          const int p = tx + 16 * c;
          sv[c] = p < P ? St[p * LDN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r;
        const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < RP; ++c) acc[r][c] *= e;
      }
      for (int j = 0; j < Q; ++j) {
        float wv[kR], xv[RP];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          wv[r] = i < Q ? Ws[i * LDW + j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < RP; ++c) {
          const int p = tx + 16 * c;
          xv[c] = p < P ? Xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r;
        if (i >= Q) continue;
        T* row = yp + static_cast<long long>(c0 + i) * a.y_st.l;
#pragma unroll
        for (int c = 0; c < RP; ++c) {
          const int p = tx + 16 * c;
          if (p < P) row[p] = scan::from_f32<T>(acc[r][c]);
        }
      }
    }
    __syncthreads();               // every read of the state is done

    // S = exp(cum_last) S + sum_j xdt_j^T (B_j exp(cum_last - cum_j))
    {
      float acc[RP][RP] = {};
      for (int j = 0; j < Q; ++j) {
        float xv[RP], bv[RP];
        const float d = dec[j];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const int p = ty + 16 * r;
          xv[r] = p < P ? Xs[j * P + p] : 0.f;
          const int n = tx + 16 * r;
          bv[r] = n < N ? Bs[j * LDN + n] * d : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
      }
      const float total = expf(cum[Q - 1]);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int p = ty + 16 * r;
        if (p >= P) continue;
#pragma unroll
        for (int c = 0; c < RP; ++c) {
          const int n = tx + 16 * c;
          if (n < N) St[p * LDN + n] = total * St[p * LDN + n] + acc[r][c];
        }
      }
    }
  }
}

template <typename T, int RP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static PerDevice<bool> granted;
  const cudaError_t e = scan::allow_smem(ssd_kernel<T, RP>, granted);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, B);
  ssd_kernel<T, RP><<<grid, kThreads, smem_bytes(a.Q, a.P, a.N), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const Args& a, int B, cudaStream_t stream) {
  if (a.P <= 64 && a.N <= 64) return launch<T, 4>(a, B, stream);
  return launch<T, 8>(a, B, stream);
}

}  // namespace
}  // namespace ssd

extern "C" {

// Shared memory the kernel needs for a chunk of Q positions, P and N.
size_t ssm_scan_smem_bytes(int Q, int P, int N) {
  return ssd::smem_bytes(Q, P, N);
}

// xdt (B, H, L, P) and y like it, float32 (dtype 0; bf16 inputs run
// ssm_scan_tc.cu); dA (B, H, L) float32; Bm, Cm (B, G, L, N) float32.
// ``strides`` holds the (b, head, l) element strides of xdt, dA, Bm, Cm
// and y, 15 values; the last axes are contiguous.  1 <= chunk <= 128,
// L % chunk == 0, P, N <= 128, H % G == 0, and the shared memory of
// ssm_scan_smem_bytes within the card's opt-in limit.  Returns
// cudaGetLastError() after the launch (0 = success).
int ssm_scan_launch(const void* xdt, const void* dA, const void* Bm,
                    const void* Cm, void* y, const long long* strides, int B,
                    int H, int G, int L, int P, int N, int chunk, int dtype,
                    void* stream) {
  using namespace ssd;
  if (B <= 0 || L <= 0) return 0;
  if (G <= 0 || H % G != 0 || chunk < 1 || chunk > kMaxQ || L % chunk != 0 ||
      P < 1 || P > 128 || N < 1 || N > 128 ||
      smem_bytes(chunk, P, N) > scan::kSmemLimit)
    return cudaErrorInvalidValue;
  Args a;
  a.xdt = xdt; a.dA = static_cast<const float*>(dA);
  a.Bm = Bm; a.Cm = Cm; a.y = y;
  a.x_st = {strides[0], strides[1], strides[2]};
  a.a_st = {strides[3], strides[4], strides[5]};
  a.b_st = {strides[6], strides[7], strides[8]};
  a.c_st = {strides[9], strides[10], strides[11]};
  a.y_st = {strides[12], strides[13], strides[14]};
  a.H = H; a.G = G; a.L = L; a.P = P; a.N = N; a.Q = chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_p<float>(a, B, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
