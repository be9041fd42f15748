// Chunkwise stabilized mLSTM for Hopper (sm_90a), bf16 q/k/v, on the
// tensor cores: the redesign of B4 (mlstm_scan.cu keeps float32 inputs).
//
// Replaces the TPU kernel repro/kernels/mlstm_scan.py::mlstm_scan (body
// _mlstm_kernel): for q, k, v (B, H, L, hd) bf16 and the gates log_i,
// log_f (B, H, L) float32 it computes h (B, H, L, hd) bf16, chunk by chunk
// of Q positions, from the zero state (the recurrence of mlstm_scan.cu's
// header note, with q scaled by 1/sqrt(hd)).
//
// What bounds it on the H100.  At xlstm-1.3b's shapes (H 4, hd 1024, Q
// 128, L 4096) the products q C and the C update are 2 L hd^2
// multiply-adds a head, 97 % of the ~77 GFLOP, so operations bound it at
// the tensor cores' rate (~0.07 ms of bf16 work; the bytes, ~134 MB, take
// ~0.04 ms).  The FMA kernel ran them as float32 FMAs fed from shared
// memory (10 floats loaded for 16 FMAs) at 1 % of that.  Here every
// product runs on the tensor cores, in three kernels:
//   * gates, one warp per (chunk, head): the chunk's cumsum of log f and
//     its stabilizer terms by warp scans (no thread walks a chunk);
//   * scores, one CTA per (chunk, head): the stabilizer's recurrence over
//     the chunk terms (a max and an add each), q k^T (mma.sync m16n8k16
//     from ldmatrix, mma_common.cuh), the gates, and the gated scores S
//     rounded to bf16 (where the plain version rounds them before S v)
//     with their float32 row sums; it also writes q * scale rounded to
//     bf16 (the plain version's rounding) and k, padded to a multiple of
//     64 columns, for the scan's TMA loads;
//   * scan, one CTA per (32 value columns, head) of two warpgroups: the
//     value-column split of mlstm_scan.cu.  The CTA carries C[:, e0:e0+32]
//     over all chunks in float32 registers (a warpgroup owns every other
//     64-row slab; 128 registers a thread) and n in shared memory: the
//     state never goes to device memory.  Per chunk, on wgmma
//     (hopper_common.cuh): S v, and q (C, n) with C rounded to bf16 as the
//     plain version rounds it and n as a bf16 hi + lo pair (extra columns
//     of C's bf16 copy), each warpgroup 64 q rows; then the update k^T
//     (ks o v, ks) of each k slab, k^T read transposed straight from the
//     TMA tile, ks o v and ks as bf16 hi + lo pairs stacked in one 80-wide
//     B tile (one m64n80 product a 16-key step; ks = exp(upd_w - m_new)
//     multiplies v rather than k: the same product, 32x fewer values to
//     split), so the float32 state takes no bf16 rounding a chunk.  Each
//     slab's products accumulate from zero and are added to the state in
//     float32 registers, C = decay C + upd (the tensor cores' float32
//     accumulation truncates; a long sum stays out of it).  q and k stream
//     through a 4-stage ring of 64-column slabs, each one TMA load issued
//     by one thread, with a full and an empty mbarrier a stage: warps run
//     apart and meet three times a chunk.
// What bounds the scan now (PERF.md): its products are thin.  With the
// state in registers a CTA owns only 32 value columns, so every wgmma is
// 64 x 40 or 64 x 80 and reads its whole A tile from shared memory for
// little work: the tensor cores run at a fraction of their rate, paced by
// shared-memory operand reads; the slab loads are not the limit.
//
#include "hopper_common.cuh"
#include "mma_common.cuh"
#include "scan_common.cuh"

namespace mlstm_tc {
namespace {

using namespace mma16;
using scan::Layout;

constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxQ = 128;
constexpr int kSlab = 64;        // d columns a slab: 128-byte rows, 8 chunks
constexpr int kMaxSlabs = 16;    // hd <= 1024
constexpr int kE = 32;           // value columns a scan CTA owns
constexpr int kStages = 4;       // slabs in the ring
constexpr float kNeg = -1e30f;   // the TPU kernel's finite NEG

constexpr int kN = 40;           // B rows of q (C, n): 32 + n hi, n lo + 6
// scan kernel shared memory, bytes, from a 1024-byte aligned base; every
// wgmma operand tile is K-major or MN-major in the 128-byte swizzle
// (hopper_common.cuh): 64-column chunks of R rows x 128 bytes
constexpr int kStageBytes = kMaxQ * kSlab * 2;      // 16 KB: one slab
constexpr int kRing = 0;
constexpr int kStile = kRing + kStages * kStageBytes;   // S, 2 chunks
constexpr int kVraw = kStile + kMaxQ * kMaxQ * 2;   // v[:, e0:e0+32], rows
constexpr int kVt = kVraw + kMaxQ * kE * 2;         // v^T, 32 x Qp
constexpr int kVtBytes = 2 * kE * 128;
// (ks o v, ks)^T as bf16 hi (rows 0-32) over lo (rows 40-72): 2 chunks
constexpr int kVhl = kVt + kVtBytes;
constexpr int kVhlChunk = 2 * kN * 128;
constexpr int kStats = kVhl + 2 * kVhlChunk;        // 2 x Qp float4
constexpr int kCbt = kStats + 2 * kMaxQ * 16;       // (C, n hi, n lo)^T bf16
constexpr int kCbtChunk = kN * 128;                 // a 64-row slab of C

size_t scan_smem_bytes(int HDp) {
  return static_cast<size_t>(kCbt) + static_cast<size_t>(HDp / kSlab) *
         kCbtChunk + static_cast<size_t>(HDp) * 4 + 2 * kStages * 8 +
         1024;   // n in float32, the ring's barriers, 1024-byte alignment
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* li;
  const float* lf;
  __nv_bfloat16* h;
  Layout q_st, k_st, v_st, li_st, lf_st, h_st;
  // workspace
  __nv_bfloat16* qs;   // (B, H, L, HDp) bf16(q * scale), zero past hd
  __nv_bfloat16* kp;   // (B, H, L, HDp) k, zero past hd
  __nv_bfloat16* S;    // (B, H, nc, Qp, Qp) gated scores
  float* bcum;         // (B, H, L) cumsum of log f within its chunk
  float* cbq;          // (B, H, nc) the chunk's total, bQ
  float* cumax;        // (B, H, nc) max_j (bQ - b_j) + log_i_j
  float4* stats;       // (B, H, nc, Qp): iw, ks, exp(-m_pos), rowsum S
  float* decay;        // (B, H, nc) exp(bQ + m_prev - m_new)
  int H, L, hd, HDp, Q, Qp, nc;
  float scale;
  int vec;             // q, k, v, h rows 16-byte aligned and hd % 8 == 0
};

__device__ __forceinline__ const __nv_bfloat16* row_of(
    const __nv_bfloat16* base, const Layout& st, int b, int h, long long l) {
  return base + b * st.b + h * st.h + l * st.l;
}

// 8 bf16 of a row from column d on, zero past hd (and for a dead row)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int d,
                                       int hd, bool live, bool vec) {
  if (!live || d >= hd) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return *reinterpret_cast<const uint4*>(row + d);
  uint16_t x[8];
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = d + i < hd ? r[d + i] : 0;
  return make_uint4(x[0] | (uint32_t(x[1]) << 16), x[2] | (uint32_t(x[3]) << 16),
                    x[4] | (uint32_t(x[5]) << 16), x[6] | (uint32_t(x[7]) << 16));
}

// 16 bytes of a bf16 row into shared memory: cp.async when the rows are
// aligned, else a synchronous copy (visible after the next __syncthreads)
__device__ __forceinline__ void copy8(void* dst, const __nv_bfloat16* row,
                                      int d, int hd, bool live, bool vec) {
  if (vec) {
    const bool in = live && d < hd;
    cp_async16(dst, in ? row + d : row, in ? 16 : 0);
  } else {
    *reinterpret_cast<uint4*>(dst) = load8(row, d, hd, live, false);
  }
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// (x rounded to bf16, the rest rounded to bf16) as two bf16 bit patterns
__device__ __forceinline__ void split2(float x, uint16_t& hi, uint16_t& lo) {
  const __nv_bfloat16 a = __float2bfloat16_rn(x);
  const __nv_bfloat16 b = __float2bfloat16_rn(x - __bfloat162float(a));
  hi = *reinterpret_cast<const uint16_t*>(&a);
  lo = *reinterpret_cast<const uint16_t*>(&b);
}

// ---------------------------------------------------------------------------
// 1. gates: one warp per (chunk, head, batch)
// ---------------------------------------------------------------------------
// b = cumsum(log f) over the chunk (warp scan), bQ = b[Q-1] and
// max_j (bQ - b_j) + log_i_j; the stabilizer's recurrence over chunks,
// m_new = max(bQ + m_prev, that max), needs nothing else
__global__ void __launch_bounds__(32) gates_kernel(Args a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* lip = a.li + b * a.li_st.b + h * a.li_st.h;
  const float* lfp = a.lf + b * a.lf_st.b + h * a.lf_st.h;
  const int Q = a.Q, c0 = c * Q;
  const int P = (Q + 31) / 32;   // consecutive positions a lane (<= 4)
  float x[4], li[4];
  float run = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = lane * P + r;
    const bool in = r < P && p < Q;
    const long long l = c0 + p;
    x[r] = in ? lfp[l * a.lf_st.l] : 0.f;
    li[r] = in ? lip[l * a.li_st.l] : 0.f;
    run += x[r];
    x[r] = run;                  // inclusive within the lane
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  // bQ exactly as stored at position Q - 1
  const int lq = (Q - 1) / P, rq = (Q - 1) % P;
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r == rq) mine = excl + x[r];
  const float bQ = __shfl_sync(0xffffffffu, mine, lq);
  float umax = kNeg;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = lane * P + r;
    if (r < P && p < Q) {
      const float bp = excl + x[r];
      a.bcum[bh * a.L + c0 + p] = bp;
      umax = fmaxf(umax, (bQ - bp) + li[r]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    umax = fmaxf(umax, __shfl_xor_sync(0xffffffffu, umax, o));
  if (lane == 0) {
    a.cbq[bh * a.nc + c] = bQ;
    a.cumax[bh * a.nc + c] = umax;
  }
}

// ---------------------------------------------------------------------------
// 2. scores: one CTA per (chunk, head, batch)
// ---------------------------------------------------------------------------
// shared memory: q and k slabs (Qp x 64 bf16, swizzled), b, log i, m_pos,
// and the row stats iw, ks, exp(-m_pos)
constexpr int kScQ = 0;
constexpr int kScK = kScQ + kMaxQ * kSlab * 2;
constexpr int kScF = kScK + kMaxQ * kSlab * 2;
constexpr int kScoresSmem = kScF + 6 * kMaxQ * 4;

__global__ void __launch_bounds__(kThreads) scores_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t sm[];
  float* bs = reinterpret_cast<float*>(sm + kScF);
  float* lis = bs + kMaxQ;
  float* mps = lis + kMaxQ;
  float* iws = mps + kMaxQ;
  float* kss = iws + kMaxQ;
  float* emps = kss + kMaxQ;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, Qp = a.Qp, nc = a.nc, c0 = c * Q;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const bool vec = a.vec != 0;

  // the stabilizer before and after this chunk: the recurrence over the
  // chunks' terms, the same operations in every CTA
  float m_prev = kNeg;
#pragma unroll 8
  for (int cc = 0; cc < c; ++cc)
    m_prev = fmaxf(a.cbq[bh * nc + cc] + m_prev, a.cumax[bh * nc + cc]);
  const float bQ = a.cbq[bh * nc + c];
  const float m_new = fmaxf(bQ + m_prev, a.cumax[bh * nc + c]);
  if (tid < kMaxQ) {
    const bool in = tid < Q;
    bs[tid] = in ? a.bcum[bh * a.L + c0 + tid] : 0.f;
    lis[tid] = in ? a.li[b * a.li_st.b + h * a.li_st.h +
                         static_cast<long long>(c0 + tid) * a.li_st.l]
                  : 0.f;
  }
  __syncthreads();
  if (tid < kMaxQ) {
    float mp = 0.f, iw = 0.f, ks = 0.f, emp = 1.f;
    if (tid < Q) {
      const float bi = bs[tid];
      float wmax = kNeg;
      for (int j = 0; j <= tid; ++j) wmax = fmaxf(wmax, (bi - bs[j]) + lis[j]);
      mp = fmaxf(wmax, bi + m_prev);
      iw = expf((bi + m_prev) - mp);
      ks = expf(((bQ - bi) + lis[tid]) - m_new);
      emp = expf(-mp);
    }
    mps[tid] = mp;
    iws[tid] = iw;
    kss[tid] = ks;
    emps[tid] = emp;
  }
  if (tid == 0) a.decay[bh * nc + c] = expf((bQ + m_prev) - m_new);

  // raw = (q * scale) k^T over slabs of 64 d; q * scale rounded to bf16 and
  // k are also written out, padded to HDp, for the scan's TMA loads.  Loads of slab s + 1 are in flight in
  // registers while slab s computes.
  const __nv_bfloat16* qrow0 = row_of(a.q, a.q_st, b, h, c0);
  const __nv_bfloat16* krow0 = row_of(a.k, a.k_st, b, h, c0);
  __nv_bfloat16* qs_out = a.qs + (bh * a.L + c0) * a.HDp;
  __nv_bfloat16* kp_out = a.kp + (bh * a.L + c0) * a.HDp;
  const int n_slabs = a.HDp / kSlab;
  constexpr int kPer = kMaxQ * 8 / kThreads;   // 16-byte chunks a thread
  uint4 qv[kPer], kv[kPer];
  auto fetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx >> 3, d = s * kSlab + (idx & 7) * 8;
      const bool live = r < Q;
      qv[i] = load8(qrow0 + static_cast<long long>(r) * a.q_st.l, d, a.hd,
                    live, vec);
      kv[i] = load8(krow0 + static_cast<long long>(r) * a.k_st.l, d, a.hd,
                    live, vec);
    }
  };
  float acc[kMaxQ / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxQ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int mi = lane >> 3, ri = lane & 7;
  fetch(0);
  for (int s = 0; s < n_slabs; ++s) {
    __syncthreads();             // the last slab's products are done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx >> 3, ch = idx & 7;
      if (r >= Qp) continue;
      uint4 w = qv[i];
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        u[j] = pack_bf16(bf_lo(u[j]) * a.scale, bf_hi(u[j]) * a.scale);
      *reinterpret_cast<uint4*>(sm + kScQ + swz<8>(r, ch)) = w;
      *reinterpret_cast<uint4*>(sm + kScK + swz<8>(r, ch)) = kv[i];
      if (r < Q) {
        const long long o = static_cast<long long>(r) * a.HDp + s * kSlab + ch * 8;
        *reinterpret_cast<uint4*>(qs_out + o) = w;
        *reinterpret_cast<uint4*>(kp_out + o) = kv[i];
      }
    }
    __syncthreads();
    if (s + 1 < n_slabs) fetch(s + 1);
    if (16 * warp < Qp) {
      const uint32_t qb = smem_addr(sm + kScQ);
      const uint32_t kb = smem_addr(sm + kScK);
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        uint32_t fa[4];
        ldsm_x4(qb + swz<8>(16 * warp + (mi & 1) * 8 + ri, 2 * kk + (mi >> 1)),
                fa);
#pragma unroll
        for (int jb = 0; jb < kMaxQ / 16; ++jb) {
          if (jb > warp) break;  // above the diagonal: never needed
          uint32_t fb[4];
          ldsm_x4(kb + swz<8>(16 * jb + (mi >> 1) * 8 + ri, 2 * kk + (mi & 1)),
                  fb);
          mma16816(acc[2 * jb], fa, fb[0], fb[1]);
          mma16816(acc[2 * jb + 1], fa, fb[2], fb[3]);
        }
      }
    }
  }

  // gates: S = raw o exp((b_i - b_j) + log_i_j - m_pos_i) for j <= i < Q,
  // its float32 row sums, and S rounded to bf16
  if (16 * warp >= Qp) return;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 16 * warp + g, i1 = i0 + 8;
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kMaxQ / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i0 : i1;
      const int j = 8 * n + 2 * t + (e & 1);
      float sv = 0.f;
      if (j <= i && i < Q)
        sv = acc[n][e] * expf(((bs[i] - bs[j]) + lis[j]) - mps[i]);
      den[e >> 1] += sv;
      acc[n][e] = sv;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
  }
  __nv_bfloat16* sp = a.S + (bh * nc + c) * Qp * Qp;
#pragma unroll
  for (int n = 0; n < kMaxQ / 8; ++n) {
    if (8 * n >= Qp) break;
    const int j = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(sp + static_cast<long long>(i0) * Qp + j) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(sp + static_cast<long long>(i1) * Qp + j) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  if (t == 0) {
    float4* st = a.stats + (bh * nc + c) * Qp;
    st[i0] = make_float4(iws[i0], kss[i0], emps[i0], den[0]);
    st[i1] = make_float4(iws[i1], kss[i1], emps[i1], den[1]);
  }
}

// ---------------------------------------------------------------------------
// 3. the scan: one CTA per (32 value columns, head, batch)
// ---------------------------------------------------------------------------
// TMA maps of the q and k copies the scores kernel wrote, boxes of 64
// columns x Qp rows in the 128-byte swizzle
struct ScanMaps {
  CUtensorMap q, k;
  hopper::TileCoord q_at, k_at;
};

// byte offset of element (row, col) of a K-major operand tile of `rows`
// rows in 64-column chunks (chunk col / 64 at (col / 64) * rows * 128)
__device__ __forceinline__ int kmajor(int row, int col, int rows) {
  return (col >> 6) * rows * 128 + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void st_u16(uint8_t* base, int off, uint16_t x) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(smem_addr(base) + off),
               "h"(x) : "memory");
}

__device__ __forceinline__ void st_bf16(uint8_t* base, int off, float x) {
  const __nv_bfloat16 v = __float2bfloat16_rn(x);
  st_u16(base, off, *reinterpret_cast<const uint16_t*>(&v));
}

// Two warpgroups.  Phase h: warpgroup w takes q rows 64 w .. 64 w + 63 of
// the chunk: S v (m64n32) once, then q (C, n hi, n lo) (m64n40) over the
// q slabs.  Phase update: the k slabs alternate between the warpgroups;
// the owner of slab s forms k^T (ks o v, ks) (m64n40, k^T read MN-major
// straight from the slab, hi and lo into one fresh accumulator) and adds
// it to its registers' C rows 64 s.. in float32.
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(const __grid_constant__ Args a,
                const __grid_constant__ ScanMaps maps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = hopper::align1024(smem_raw);
  const int e0 = blockIdx.x * kE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp in it
  const int g = lane >> 2, t = lane & 3;
  const int Q = a.Q, Qp = a.Qp, nc = a.nc, hd = a.hd, HDp = a.HDp;
  const int nS = HDp / kSlab;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const bool vec = a.vec != 0;
  uint8_t* const Cbt = sm + kCbt;
  float* const Nf = reinterpret_cast<float*>(Cbt + nS * kCbtChunk);
  uint64_t* const full = reinterpret_cast<uint64_t*>(Nf + HDp);
  uint64_t* const empty = full + kStages;

  // zero state; the B tiles' unused rows (v^T hi/lo 33-39, C^T 34-39)
  // stay zero
  for (int i = tid; i < (kStats - kVt) / 16; i += kThreads)
    reinterpret_cast<uint4*>(sm + kVt)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < nS * kCbtChunk / 16; i += kThreads)
    reinterpret_cast<uint4*>(Cbt)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < HDp; i += kThreads) Nf[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kThreads / 32);   // one arrival a warp
    }
    hopper::fence_barrier_init();
    hopper::prefetch_map(&maps.q);
    hopper::prefetch_map(&maps.k);
  }

  // the slab stream, in order: per chunk its nS q slabs, then its nS k
  // slabs; thread 0 issues each with one TMA load into its ring stage,
  // once every warp has released the slab that stage held
  const int per_chunk = 2 * nS;
  int p_c = 0, p_u = 0, p_n = 0;   // thread 0: the next slab to issue
  auto produce = [&]() {
    if (p_c >= nc) return;
    const int st = p_n % kStages;
    if (p_n >= kStages)
      hopper::mbar_wait(&empty[st], ((p_n / kStages) - 1) & 1);
    uint64_t* bar = &full[st];
    hopper::mbar_expect_tx(bar, Qp * kSlab * 2);
    if (p_u < nS)
      hopper::tma_load_tile(sm + kRing + st * kStageBytes, &maps.q, maps.q_at,
                            bar, p_u * kSlab, p_c * Q, h, b);
    else
      hopper::tma_load_tile(sm + kRing + st * kStageBytes, &maps.k, maps.k_at,
                            bar, (p_u - nS) * kSlab, p_c * Q, h, b);
    ++p_n;
    if (++p_u == per_chunk) {
      p_u = 0;
      ++p_c;
    }
  };
  // the copies of chunk cc's gated scores (K-major, 2 chunks), v[:,
  // e0:e0+32] (rows) and row stats
  auto issue_extras = [&](int cc) {
    if (cc >= nc) return;
    const __nv_bfloat16* sp = a.S + (bh * nc + cc) * Qp * Qp;
    for (int idx = tid; idx < Qp * (Qp / 8); idx += kThreads) {
      const int r = idx / (Qp / 8), ch = idx % (Qp / 8);
      cp_async16(sm + kStile + kmajor(r, ch * 8, Qp),
                 sp + static_cast<long long>(r) * Qp + ch * 8, 16);
    }
    for (int idx = tid; idx < Qp * 4; idx += kThreads) {
      const int r = idx >> 2, ch = idx & 3;
      copy8(sm + kVraw + r * 64 + ch * 16,
            row_of(a.v, a.v_st, b, h, static_cast<long long>(cc) * Q + r),
            e0 + ch * 8, hd, r < Q, vec);
    }
    const float4* st = a.stats + (bh * nc + cc) * Qp;
    for (int r = tid; r < Qp; r += kThreads)
      cp_async16(sm + kStats + ((cc & 1) * kMaxQ + r) * 16, st + r, 16);
    cp_async_commit();
  };

  // C rows 64 s + 16 wq + g (+ 8) of the slabs this warpgroup owns (s % 2
  // == wg), columns 8 j + 2 t (+ 1): the m64n32 accumulator layout
  float C[kMaxSlabs / 2][16];
#pragma unroll
  for (int s = 0; s < kMaxSlabs / 2; ++s)
#pragma unroll
    for (int e = 0; e < 16; ++e) C[s][e] = 0.f;

  issue_extras(0);
  __syncthreads();               // the barriers are initialised
  if (tid == 0)
    for (int s = 0; s < kStages - 1; ++s) produce();
  // Slab gs: a warp waits until it has landed, reads it, and releases
  // its stage (one arrival a warp); thread 0 then issues slab gs + 3 into
  // the stage slab gs - 1 held.  Warps meet three times a chunk: at its
  // start (the chunk's scores, v and stats have landed; the last update's
  // C and n are written), after the B tiles are built, and between the
  // phases (every q C has read C and every S v the scores and v; the next
  // chunk's copies may start).
  int gs = 0;
  auto slab_wait = [&]() {
    hopper::mbar_wait(&full[gs % kStages], (gs / kStages) & 1);
  };
  auto slab_done = [&]() {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[gs % kStages]);
    if (tid == 0) produce();
    ++gs;
  };
  const uint8_t* const ring = sm + kRing;
  const int row0 = 64 * wg;      // phase h: this warpgroup's q rows
  const bool rows_live = row0 < Qp;

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const float4* stats =
        reinterpret_cast<const float4*>(sm + kStats) + (c & 1) * kMaxQ;
    const float decay = a.decay[bh * nc + c];
    cp_async_wait<0>();
    hopper::fence_proxy_async();   // the scores copy, the last C update
    __syncthreads();

    // the chunk's B tiles: v^T, and (ks o v, ks)^T as bf16 hi + lo
    for (int idx = tid; idx < Qp * 4; idx += kThreads) {
      const int j = idx % Qp, ch = idx / Qp;
      const float ks = stats[j].y;
      const uint4 w = *reinterpret_cast<const uint4*>(sm + kVraw + j * 64 +
                                                      ch * 16);
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
      for (int q2 = 0; q2 < 4; ++q2) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = ch * 8 + 2 * q2 + half;
          const float x = half ? bf_hi(u[q2]) : bf_lo(u[q2]);
          st_u16(sm + kVt, kmajor(e, j, kE),
                 static_cast<uint16_t>(half ? u[q2] >> 16 : u[q2] & 0xffffu));
          uint16_t hi, lo;
          split2(ks * x, hi, lo);
          st_u16(sm + kVhl, kmajor(e, j, 2 * kN), hi);
          st_u16(sm + kVhl, kmajor(kN + e, j, 2 * kN), lo);
        }
      }
      if (ch == 0) {
        uint16_t hi, lo;
        split2(ks, hi, lo);
        st_u16(sm + kVhl, kmajor(kE, j, 2 * kN), hi);
        st_u16(sm + kVhl, kmajor(kN + kE, j, 2 * kN), lo);
      }
    }
    hopper::fence_proxy_async();
    __syncthreads();

    // phase h: S v, then q (C, n hi, n lo) over the q slabs
    float acc_sv[16], acc_h[20];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc_sv[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 20; ++e) acc_h[e] = 0.f;
    if (rows_live) {
      hopper::fence_regs(acc_sv);
      hopper::wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < kMaxQ / 16; ++kj) {
        if (16 * kj >= Qp) break;
        hopper::wgmma_ss<32>(
            acc_sv,
            hopper::desc_k_major(sm + kStile + (kj >> 2) * Qp * 128 +
                                 row0 * 128 + (kj & 3) * 32),
            hopper::desc_k_major(sm + kVt + (kj >> 2) * kE * 128 +
                                 (kj & 3) * 32),
            kj > 0);
      }
      hopper::wgmma_commit();
    }
    for (int s = 0; s < nS; ++s) {
      slab_wait();
      if (rows_live) {
        const uint8_t* qs = ring + (gs % kStages) * kStageBytes + row0 * 128;
        hopper::fence_regs(acc_h);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlab / 16; ++kk)
          hopper::wgmma_ss<40>(
              acc_h, hopper::desc_k_major(qs + kk * 32),
              hopper::desc_k_major(Cbt + s * kCbtChunk + kk * 32),
              s > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc_h);
        hopper::fence_regs(acc_sv);
      }
      slab_done();
    }
    __syncthreads();
    issue_extras(c + 1);

    // h = (S v + iw q C) / max(|rowsum S + iw q n|, exp(-m_pos))
    if (rows_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 16 * wq + g + 8 * r;
        const float qn = __shfl_sync(0xffffffffu,
                                     acc_h[16 + 2 * r] + acc_h[17 + 2 * r],
                                     lane & ~3);
        const float4 st = stats[i];
        const float inv = 1.f / fmaxf(fabsf(st.w + st.x * qn), st.z);
        if (i >= Q) continue;
        __nv_bfloat16* row = a.h + b * a.h_st.b + h * a.h_st.h +
                             static_cast<long long>(c0 + i) * a.h_st.l;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + 8 * j + 2 * t;
          const float x0 =
              (acc_sv[4 * j + 2 * r] + st.x * acc_h[4 * j + 2 * r]) * inv;
          const float x1 = (acc_sv[4 * j + 2 * r + 1] +
                            st.x * acc_h[4 * j + 2 * r + 1]) * inv;
          if (vec) {
            if (e < hd)
              *reinterpret_cast<uint32_t*>(row + e) = pack_bf16(x0, x1);
          } else {
            if (e < hd) row[e] = __float2bfloat16_rn(x0);
            if (e + 1 < hd) row[e + 1] = __float2bfloat16_rn(x1);
          }
        }
      }
    }

    // phase update: C, n = decay (C, n) + k^T (ks o v, ks), the k slabs
    // alternating between the warpgroups
#pragma unroll
    for (int s = 0; s < kMaxSlabs; ++s) {
      if (s >= nS) break;
      slab_wait();
      if ((s & 1) == wg) {
        const uint8_t* ks = ring + (gs % kStages) * kStageBytes;
        float acc[40];   // columns 0-39 the hi products, 40-79 the lo
#pragma unroll
        for (int e = 0; e < 40; ++e) acc[e] = 0.f;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kj = 0; kj < kMaxQ / 16; ++kj) {
          if (16 * kj >= Qp) break;
          hopper::wgmma_ss_mn_a80(
              acc, hopper::desc_mn_major(ks + kj * 2048, Qp * 128),
              hopper::desc_k_major(sm + kVhl + (kj >> 2) * kVhlChunk +
                                   (kj & 3) * 32),
              kj > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        // the state in float32, and its bf16 copy (transposed, the next
        // chunk's B tile) for q C
        const int d0 = 16 * wq + g;          // within the slab
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& cv = C[s >> 1][4 * j + e];
            cv = decay * cv + (acc[4 * j + e] + acc[4 * (j + 5) + e]);
            st_bf16(Cbt + s * kCbtChunk,
                    kmajor(8 * j + 2 * t + (e & 1), d0 + 8 * (e >> 1), kN), cv);
          }
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int d = s * kSlab + d0 + 8 * r;
            const float n_new =
                decay * Nf[d] + (acc[16 + 2 * r] + acc[36 + 2 * r]);
            Nf[d] = n_new;
            uint16_t hi, lo;
            split2(n_new, hi, lo);
            st_u16(Cbt + s * kCbtChunk, kmajor(kE, d0 + 8 * r, kN), hi);
            st_u16(Cbt + s * kCbtChunk, kmajor(kE + 1, d0 + 8 * r, kN), lo);
          }
        }
      }
      slab_done();
    }
  }
  cp_async_wait<0>();
}

}  // namespace
}  // namespace mlstm_tc

extern "C" {

// Bytes of the workspace a call needs (one buffer, carved as Args lists).
size_t mlstm_scan_tc_workspace_bytes(int B, int H, int L, int hd, int chunk) {
  const long long Qp = (chunk + 15) / 16 * 16;
  const long long HDp = (hd + 63) / 64 * 64;
  const long long bh = static_cast<long long>(B) * H, nc = L / chunk;
  auto up = [](long long x) { return (x + 255) / 256 * 256; };
  return 2 * up(bh * L * HDp * 2) + up(bh * nc * Qp * Qp * 2) + up(bh * L * 4) +
         2 * up(bh * nc * 4) + up(bh * nc * Qp * 16) + up(bh * nc * 4);
}

// q, k, v (B, H, L, hd) bf16 and h like them; log_i, log_f (B, H, L)
// float32; ``strides`` the (b, head, l) element strides of q, k, v, log_i,
// log_f and h, 18 values, the last axes contiguous; ``workspace`` of
// mlstm_scan_tc_workspace_bytes, 256-byte aligned.  1 <= chunk <= 128,
// L % chunk == 0, hd <= 1024.  ``vec``: every row of q, k, v and h
// 16-byte aligned and hd % 8 == 0 (else element-wise copies).  Launches
// the gates, scores and scan kernels; returns cudaGetLastError() after
// them (0 = success).
int mlstm_scan_tc_launch(const void* q, const void* k, const void* v,
                         const void* log_i, const void* log_f, void* h,
                         void* workspace, const long long* strides, int B,
                         int H, int L, int hd, int chunk, int vec,
                         float scale, void* stream) {
  using namespace mlstm_tc;
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || hd < 1 || hd > kMaxSlabs * kSlab || chunk < 1 ||
      chunk > kMaxQ || L % chunk != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.li = static_cast<const float*>(log_i);
  a.lf = static_cast<const float*>(log_f);
  a.h = static_cast<__nv_bfloat16*>(h);
  a.q_st = {strides[0], strides[1], strides[2]};
  a.k_st = {strides[3], strides[4], strides[5]};
  a.v_st = {strides[6], strides[7], strides[8]};
  a.li_st = {strides[9], strides[10], strides[11]};
  a.lf_st = {strides[12], strides[13], strides[14]};
  a.h_st = {strides[15], strides[16], strides[17]};
  a.H = H; a.L = L; a.hd = hd; a.Q = chunk; a.nc = L / chunk;
  a.Qp = (chunk + 15) / 16 * 16;
  a.HDp = (hd + kSlab - 1) / kSlab * kSlab;
  a.scale = scale;
  a.vec = vec;
  const long long bh = static_cast<long long>(B) * H;
  auto up = [](long long x) { return (x + 255) / 256 * 256; };
  uint8_t* w = static_cast<uint8_t*>(workspace);
  a.qs = reinterpret_cast<__nv_bfloat16*>(w);
  w += up(bh * L * a.HDp * 2);
  a.kp = reinterpret_cast<__nv_bfloat16*>(w);
  w += up(bh * L * a.HDp * 2);
  a.S = reinterpret_cast<__nv_bfloat16*>(w);
  w += up(bh * a.nc * a.Qp * a.Qp * 2);
  a.bcum = reinterpret_cast<float*>(w);
  w += up(bh * L * 4);
  a.cbq = reinterpret_cast<float*>(w);
  w += up(bh * a.nc * 4);
  a.cumax = reinterpret_cast<float*>(w);
  w += up(bh * a.nc * 4);
  a.stats = reinterpret_cast<float4*>(w);
  w += up(bh * a.nc * a.Qp * 16);
  a.decay = reinterpret_cast<float*>(w);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gates_kernel<<<dim3(a.nc, H, B), 32, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static PerDevice<bool> scores_granted, scan_granted;
  e = scan::allow_smem(scores_kernel, scores_granted);
  if (e != cudaSuccess) return e;
  scores_kernel<<<dim3(a.nc, H, B), kThreads, kScoresSmem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ScanMaps maps;
  const long long sh = static_cast<long long>(L) * a.HDp;
  if (!hopper::map_bhsd(&maps.q, &maps.q_at, a.qs, B, H, L, a.HDp, H * sh, sh,
                        a.HDp, a.Qp) ||
      !hopper::map_bhsd(&maps.k, &maps.k_at, a.kp, B, H, L, a.HDp, H * sh, sh,
                        a.HDp, a.Qp))
    return cudaErrorInvalidValue;
  e = scan::allow_smem(scan_kernel, scan_granted);
  if (e != cudaSuccess) return e;
  scan_kernel<<<dim3((hd + kE - 1) / kE, H, B), kThreads,
                scan_smem_bytes(a.HDp), st>>>(a, maps);
  return cudaGetLastError();
}

}  // extern "C"
