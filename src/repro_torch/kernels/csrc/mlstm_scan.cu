// Chunkwise stabilized mLSTM for Hopper (sm_90a): B4 for float32 inputs
// (bf16 runs the tensor-core kernel, mlstm_scan_tc.cu).
//
// Replaces the TPU kernel repro/kernels/mlstm_scan.py::mlstm_scan (body
// _mlstm_kernel).  For q, k, v (B, H, L, hd) and the gates log_i, log_f
// (B, H, L) float32 it computes h (B, H, L, hd) in q's type.  Per chunk of
// Q positions, in float32, as the TPU kernel (q scaled by 1/sqrt(hd)):
//
//   b      = cumsum(log_f),  bQ = b[Q-1]
//   w_ij   = (b_i - b_j) + log_i_j            for j <= i
//   m_pos  = max(max_j<=i w_ij, b_i + m_prev)
//   S      = (q k^T) o exp(w - m_pos), 0 above the diagonal
//   h      = (S v + e^(b + m_prev - m_pos) q C)
//            / max(|rowsum S + e^(b + m_prev - m_pos) q n|, e^(-m_pos))
//   m_new  = max(bQ + m_prev, max_j (bQ - b_j + log_i_j))
//   C, n   = e^(bQ + m_prev - m_new) (C, n)
//            + (k o e^(bQ - b + log_i - m_new))^T (v, 1)
//
// with the TPU kernel's finite NEG = -1e30 for the first chunk's m_prev.
//
// The matrix memory C is hd x hd float32 per (batch, head): at
// xlstm-1.3b's hd = 1024 that is 4 MB, which no SM holds (the TPU keeps it
// in VMEM), and B x H = 4 (batch, head) pairs would fill 4 of 132 SMs.  So
// C is split by its value columns: a block owns C[:, e0:e0+32] (128 KB in
// shared memory) and the normalizer n, and loops over the chunks (the TPU
// grid's sequential axis); 32 column tiles x 4 heads make 128 blocks.
// What does not depend on e is shared instead of being redone by every
// tile: a first kernel forms the raw scores q k^T of every chunk (one
// block per (chunk, head, batch), Q x Q float32 each, into a scratch that
// the L2 holds), and each column block re-reads them, applies the gates
// (cheap: Q^2 exponentials a chunk) and keeps its own copy of n and the
// stabilizers (hd and Q values).  The two kernels are launched together
// as one B4 call.
//
// What bounds it on the H100: at B 1, L 4096, H 4, hd 1024 a call moves
// ~268 MB (q, k, v, h in float32) and does ~77 GFLOP, dominated by q C and
// the C update (2 x L hd^2 multiply-adds a head), so operations bound it:
// ~1.15 ms at the float32 FMA rate.  This kernel does every product as
// float32 FMAs on the CUDA cores with register tiles per thread (no mma,
// no TMA pipelining), fed from shared memory, which sets its pace.

#include "scan_common.cuh"

namespace mlstm {
namespace {

using scan::kThreads;
using scan::Layout;
using scan::to_f32;

constexpr int kR = 8;            // rows per thread: 16 x 8 = 128
constexpr int kMaxQ = 16 * kR;
constexpr int kE = 32;           // value columns of C per block
constexpr int kTD = 32;          // d per tile in the score kernel
constexpr int kT = 64;           // d (or key) per tile in the scan kernel
constexpr int kLDT = kT + 1;
constexpr float kNeg = -1e30f;   // the TPU kernel's finite NEG

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* li;
  const float* lf;
  void* h;
  float* s;                      // (B, H, nc, Q, Q) raw scores
  Layout q_st, k_st, v_st, li_st, lf_st, h_st;
  int H, L, hd, Q;
  float scale;
};

size_t scan_smem_bytes(int Q, int hd) {
  const size_t f = static_cast<size_t>(hd) * kE + hd + Q * kLDT + Q * kE +
                   7 * Q + 1;
  return f * sizeof(float);
}

// s[b, h, c] = (q_c * scale) k_c^T, Q x Q for chunk c
template <typename T>
__global__ void __launch_bounds__(kThreads) scores_kernel(Args a) {
  __shared__ float Qs[kMaxQ][kTD + 1];
  __shared__ float Ks[kMaxQ][kTD + 1];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, hd = a.hd, c0 = c * Q;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_st.b + h * a.k_st.h;

  float acc[kR][kR] = {};
  for (int d0 = 0; d0 < hd; d0 += kTD) {
    __syncthreads();
    for (int i = t; i < Q * kTD; i += kThreads) {
      const int r = i / kTD, dd = i % kTD, d = d0 + dd;
      const long long row = c0 + r;
      const bool in = d < hd;
      Qs[r][dd] = in ? to_f32(qp[row * a.q_st.l + d]) * a.scale : 0.f;
      Ks[r][dd] = in ? to_f32(kp[row * a.k_st.l + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kTD; ++dd) {
      float qv[kR], kv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        qv[r] = (ty + 16 * r) < Q ? Qs[ty + 16 * r][dd] : 0.f;
        kv[r] = (tx + 16 * r) < Q ? Ks[tx + 16 * r][dd] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int cc = 0; cc < kR; ++cc)
          acc[r][cc] = fmaf(qv[r], kv[cc], acc[r][cc]);
    }
  }
  const int nc = a.L / Q;
  float* sp = a.s + ((static_cast<long long>(b) * a.H + h) * nc + c) * Q * Q;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = ty + 16 * r;
    if (i >= Q) continue;
#pragma unroll
    for (int cc = 0; cc < kR; ++cc) {
      const int j = tx + 16 * cc;
      if (j < Q) sp[i * Q + j] = acc[r][cc];
    }
  }
}

// one block per (column tile of kE, head, batch): C[:, e0:e0+kE] and n
// carried across the chunks in shared memory
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) scan_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Q = a.Q, hd = a.hd, nc = a.L / Q;
  float* Cs = sm;                  // hd x kE  C[:, e0:e0+kE]
  float* ns = Cs + hd * kE;        // hd       n
  float* Tt = ns + hd;             // Q x kLDT gated scores / q / k tile
  float* Vt = Tt + Q * kLDT;       // Q x kE   v[:, e0:e0+kE] of the chunk
  float* bq = Vt + Q * kE;         // Q        cumsum(log f)
  float* li = bq + Q;              // Q        log i
  float* mp = li + Q;              // Q        m_pos
  float* iw = mp + Q;              // Q        inter weight
  float* ks = iw + Q;              // Q        upd_w, then the k scales
  float* dn = ks + Q;              // Q        row sums of S
  float* qn = dn + Q;              // Q        q . n_prev
  float* mn = qn + Q;              // 1        m_new

  const int e0 = blockIdx.x * kE, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_st.b + h * a.k_st.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_st.b + h * a.v_st.h;
  const float* lip = a.li + b * a.li_st.b + h * a.li_st.h;
  const float* lfp = a.lf + b * a.lf_st.b + h * a.lf_st.h;
  T* hp = static_cast<T*>(a.h) + b * a.h_st.b + h * a.h_st.h;

  for (int i = t; i < hd * kE; i += kThreads) Cs[i] = 0.f;
  for (int i = t; i < hd; i += kThreads) ns[i] = 0.f;
  float m_prev = kNeg;

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    __syncthreads();               // the last chunk is done with the tiles
    if (t < Q) {
      li[t] = lip[static_cast<long long>(c0 + t) * a.li_st.l];
      bq[t] = lfp[static_cast<long long>(c0 + t) * a.lf_st.l];
    }
    for (int i = t; i < Q * kE; i += kThreads) {
      const int r = i / kE, e = e0 + i % kE;
      Vt[i] = e < hd ? to_f32(vp[static_cast<long long>(c0 + r) * a.v_st.l +
                                 e])
                     : 0.f;
    }
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += bq[i];
        bq[i] = s;
      }
    }
    __syncthreads();
    const float bQ = bq[Q - 1];
    if (t < Q) {
      const float bi = bq[t];
      float wmax = kNeg;
      for (int j = 0; j <= t; ++j) wmax = fmaxf(wmax, (bi - bq[j]) + li[j]);
      const float m_pos = fmaxf(wmax, bi + m_prev);
      mp[t] = m_pos;
      iw[t] = expf(bi + m_prev - m_pos);
      ks[t] = (bQ - bi) + li[t];
      dn[t] = 0.f;
      qn[t] = 0.f;
    }
    __syncthreads();
    if (t == 0) {
      float m = bQ + m_prev;
      for (int j = 0; j < Q; ++j) m = fmaxf(m, ks[j]);
      mn[0] = m;
    }
    __syncthreads();
    const float m_new = mn[0];
    if (t < Q) ks[t] = expf(ks[t] - m_new);

    // intra-chunk: S v over key tiles, and the row sums of S
    float acc[kR][2] = {}, acc2[kR][2] = {};
    const float* sp =
        a.s + ((static_cast<long long>(b) * a.H + h) * nc + c) * Q * Q;
    for (int j0 = 0; j0 < Q; j0 += kT) {
      for (int i = t; i < Q * kT; i += kThreads) {
        const int r = i / kT, j = j0 + i % kT;
        float v = 0.f;
        if (j <= r)       // never formed above the diagonal
          v = sp[r * Q + j] * expf(((bq[r] - bq[j]) + li[j]) - mp[r]);
        Tt[r * kLDT + (i % kT)] = v;
      }
      __syncthreads();
      const int jn = min(kT, Q - j0);
      if (t < Q) {
        float s = dn[t];
        for (int jj = 0; jj < jn; ++jj) s += Tt[t * kLDT + jj];
        dn[t] = s;
      }
      for (int jj = 0; jj < jn; ++jj) {
        float sv[kR], vv[2];
#pragma unroll
        for (int r = 0; r < kR; ++r)
          sv[r] = (ty + 16 * r) < Q ? Tt[(ty + 16 * r) * kLDT + jj] : 0.f;
        vv[0] = Vt[(j0 + jj) * kE + tx];
        vv[1] = Vt[(j0 + jj) * kE + tx + 16];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          acc[r][0] = fmaf(sv[r], vv[0], acc[r][0]);
          acc[r][1] = fmaf(sv[r], vv[1], acc[r][1]);
        }
      }
      __syncthreads();
    }

    // inter-chunk: q C and q . n over d tiles
    for (int d0 = 0; d0 < hd; d0 += kT) {
      for (int i = t; i < Q * kT; i += kThreads) {
        const int r = i / kT, d = d0 + i % kT;
        Tt[r * kLDT + (i % kT)] =
            d < hd ? to_f32(qp[static_cast<long long>(c0 + r) * a.q_st.l + d]) *
                         a.scale
                   : 0.f;
      }
      __syncthreads();
      const int dn_ = min(kT, hd - d0);
      if (t < Q) {
        float s = qn[t];
        for (int dd = 0; dd < dn_; ++dd) s += Tt[t * kLDT + dd] * ns[d0 + dd];
        qn[t] = s;
      }
      for (int dd = 0; dd < dn_; ++dd) {
        float qv[kR], cv[2];
#pragma unroll
        for (int r = 0; r < kR; ++r)
          qv[r] = (ty + 16 * r) < Q ? Tt[(ty + 16 * r) * kLDT + dd] : 0.f;
        cv[0] = Cs[(d0 + dd) * kE + tx];
        cv[1] = Cs[(d0 + dd) * kE + tx + 16];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          acc2[r][0] = fmaf(qv[r], cv[0], acc2[r][0]);
          acc2[r][1] = fmaf(qv[r], cv[1], acc2[r][1]);
        }
      }
      __syncthreads();
    }

    // h = (S v + iw q C) / max(|rowsum S + iw q n|, exp(-m_pos))
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
      const float w = iw[i];
      const float denom = fmaxf(fabsf(dn[i] + w * qn[i]), expf(-mp[i]));
      T* row = hp + static_cast<long long>(c0 + i) * a.h_st.l;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int e = e0 + tx + 16 * cc;
        if (e < hd)
          row[e] = scan::from_f32<T>((acc[r][cc] + w * acc2[r][cc]) / denom);
      }
    }

    // state update: C, n = decay (C, n) + k_scaled^T (v, 1)
    const float decay = expf(bQ + m_prev - m_new);
    for (int d0 = 0; d0 < hd; d0 += kT) {
      for (int i = t; i < Q * kT; i += kThreads) {
        const int r = i / kT, d = d0 + i % kT;
        Tt[r * kLDT + (i % kT)] =
            d < hd ? to_f32(kp[static_cast<long long>(c0 + r) * a.k_st.l + d]) *
                         ks[r]
                   : 0.f;
      }
      __syncthreads();
      const int dn_ = min(kT, hd - d0);
      if (t < dn_) {
        float s = 0.f;
        for (int j = 0; j < Q; ++j) s += Tt[j * kLDT + t];
        ns[d0 + t] = decay * ns[d0 + t] + s;
      }
      float u[kT / 16][2] = {};
      for (int j = 0; j < Q; ++j) {
        float kv[kT / 16], vv[2];
#pragma unroll
        for (int r = 0; r < kT / 16; ++r) kv[r] = Tt[j * kLDT + ty + 16 * r];
        vv[0] = Vt[j * kE + tx];
        vv[1] = Vt[j * kE + tx + 16];
#pragma unroll
        for (int r = 0; r < kT / 16; ++r) {
          u[r][0] = fmaf(kv[r], vv[0], u[r][0]);
          u[r][1] = fmaf(kv[r], vv[1], u[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kT / 16; ++r) {
        const int dd = ty + 16 * r;
        if (dd >= dn_) continue;
        float* crow = Cs + (d0 + dd) * kE;
        crow[tx] = decay * crow[tx] + u[r][0];
        crow[tx + 16] = decay * crow[tx + 16] + u[r][1];
      }
      __syncthreads();
    }
    m_prev = m_new;
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int nc = a.L / a.Q;
  scores_kernel<T><<<dim3(nc, a.H, B), kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static PerDevice<bool> granted;
  e = scan::allow_smem(scan_kernel<T>, granted);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.hd + kE - 1) / kE, a.H, B);
  scan_kernel<T><<<grid, kThreads, scan_smem_bytes(a.Q, a.hd), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mlstm

extern "C" {

// Shared memory the scan kernel needs for a chunk of Q positions and hd.
size_t mlstm_scan_smem_bytes(int Q, int hd) {
  return mlstm::scan_smem_bytes(Q, hd);
}

// q, k, v (B, H, L, hd) and h like them, float32 (dtype 0; bf16 inputs
// run mlstm_scan_tc.cu); log_i, log_f (B, H, L) float32; ``scores`` a float32
// scratch of B * H * L * chunk values.  ``strides`` holds the (b, head, l)
// element strides of q, k, v, log_i, log_f and h, 18 values; the last axes
// are contiguous.  1 <= chunk <= 128, L % chunk == 0, and the scan
// kernel's shared memory (mlstm_scan_smem_bytes) within the card's opt-in
// limit.  Launches the score kernel, then the scan kernel; returns
// cudaGetLastError() after them (0 = success).
int mlstm_scan_launch(const void* q, const void* k, const void* v,
                      const void* log_i, const void* log_f, void* h,
                      void* scores, const long long* strides, int B, int H,
                      int L, int hd, int chunk, int dtype, float scale,
                      void* stream) {
  using namespace mlstm;
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || hd < 1 || chunk < 1 || chunk > kMaxQ || L % chunk != 0 ||
      scan_smem_bytes(chunk, hd) > scan::kSmemLimit)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.li = static_cast<const float*>(log_i);
  a.lf = static_cast<const float*>(log_f);
  a.h = h; a.s = static_cast<float*>(scores);
  a.q_st = {strides[0], strides[1], strides[2]};
  a.k_st = {strides[3], strides[4], strides[5]};
  a.v_st = {strides[6], strides[7], strides[8]};
  a.li_st = {strides[9], strides[10], strides[11]};
  a.lf_st = {strides[12], strides[13], strides[14]};
  a.h_st = {strides[15], strides[16], strides[17]};
  a.H = H; a.L = L; a.hd = hd; a.Q = chunk; a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
