// Mamba2 SSD chunked scan for Hopper (sm_90a), bf16, on the tensor cores:
// the redesign of B5 (ssm_scan.cu keeps float32 inputs).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssd_scan (body
// _ssd_kernel).  For xdt (B, H, L, P) bf16 (inputs already multiplied by
// dt), dA (B, H, L) float32 (dt * A, negative) and the maps Bm, Cm
// (B, G, L, N) bf16, head h reading group h / (H / G), it computes y
// (B, H, L, P) bf16, chunk by chunk of Q positions (the recurrence of
// ssm_scan.cu's header note):
//
//   cum   = inclusive cumsum(dA)                          (Q,)
//   W     = (C B^T) o exp(cum_i - cum_j), j <= i only     (Q, Q)
//   y     = exp(cum_i) (C S^T)_i + (W xdt)_i              (Q, P)
//   S     = exp(cum_last) S + xdt^T (B o exp(cum_last - cum))   (P, N)
//
// What bounds it on the H100.  At zamba2-2.7b's shapes (H 80, P = N = 64,
// one group, Q 128, L 4096) a call moves ~86 MB and does ~16 GFLOP, so
// bytes would bound it (0.026 ms) once the products run on the tensor
// cores.  The FMA kernel ran them as float32 FMAs on 80 SMs.  Here:
//   * Grid (32-column slab of P, head, batch): 160 CTAs at zamba2's shape,
//     up to two resident a SM (~112 KB of shared memory each).  Each CTA
//     walks the chunks in order and recomputes the chunk's C B^T and W,
//     which do not depend on p.
//   * All four products run on mma.sync m16n8k16, bf16 in and float32 out
//     (mma_common.cuh), operands through ldmatrix from row-padded tiles
//     (an odd number of 16-byte chunks a row: conflict-free).  Warp w owns
//     q rows 16w..16w+15: C's A fragments stay in registers for C S^T and
//     C B^T; W = (C B^T) o decay is formed in the accumulator registers one
//     16-key block at a time, rounded to bf16 and fed straight back as the
//     A fragment of W xdt (xdt through ldmatrix.trans), only j <= i blocks.
//     Row tile r has r + 1 key blocks and the busiest warp sets the pace,
//     so warps pair up: warp w < 4 also takes blocks 4..7-w of row tile
//     7-w and hands that partial sum to warp 7-w in shared memory (a named
//     barrier a pair): at most 5 blocks a warp, not 8.
//   * The state S (32 x N a CTA) stays in float32 registers: warp w owns
//     p rows 16 (w % 2).. and the 16-column blocks n with n / 16 % 4 == w / 2
//     as accumulator fragments.  Its update xdt^T (B o decay) takes xdt^T
//     and B through ldmatrix.trans; each chunk's update goes to a fresh
//     accumulator added to the decayed S in float32 (the tensor cores'
//     float32 accumulation truncates).  C S^T needs every p row of S in
//     every warp, so the owners also write S rounded to bf16 (where the
//     plain version rounds it) to a double-buffered 32 x N shared tile.
//   * A 2-stage cp.async ring (16-byte copies, zero-fill past the edge)
//     loads chunk c + 1's C, B and xdt slab while chunk c computes.  Warp
//     7 reads chunk c + 1's dA into registers and scans it (a shuffle
//     scan) while it waits for its partner's W sum, into the other of two
//     scan buffers: one barrier a chunk.
// What holds it now (PERF.md): the chunks' serial chain.  Most of a
// chunk is one warp's dependent mma.sync, ldmatrix and exp steps, key
// block after key block, with only 8 warps a SM to hide them; and at
// zamba2's 160 CTAs, 28 SMs run two CTAs, which take longer than a lone
// one (chip_smoke.py times both).
// Rounding follows the plain path models/ssm.py::ssd_chunked: W, the decay
// exp(cum_last - cum_j), B o decay and S are rounded to bf16 before their
// products; the products and exp(cum_i) stay in float32, y is rounded once.
// exp(cum_i - cum_j) is formed only for j <= i (a masked inf times 0 is
// NaN), by the special-function unit (__expf, within ~2^-21 of expf: far
// inside the bf16 rounding of W that follows).

#include "mma_common.cuh"
#include "scan_common.cuh"

namespace ssd_tc {
namespace {

using namespace mma16;
using scan::Layout;

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kHalf = kWarps / 2;
constexpr int kScanWarp = kWarps - 1;   // scans each next chunk's dA
constexpr int kMaxQ = 16 * kWarps;   // a row tile of 16 a warp
constexpr int kSlab = 32;        // p columns a CTA owns
constexpr int kLdx = kSlab + 8;  // xdt tile row: 80 bytes, 5 chunks

struct Args {
  const __nv_bfloat16* xdt;
  const float* dA;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  __nv_bfloat16* y;
  Layout x_st, a_st, b_st, c_st, y_st;
  int H, G, L, P, N, Q, Qp, Np;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// bytes of one ring stage: C and B (Qp x (Np + 8)) and the xdt slab (Qp
// x kLdx), all bf16
__host__ __device__ inline int stage_bytes(int Qp, int Np) {
  return 2 * Qp * (Np + 8) * 2 + Qp * kLdx * 2;
}

// floats of one chunk's scan: cum, exp(cum), the decays, exp(cum_last)
constexpr int kScan = 3 * kMaxQ + 4;

// floats of the partial sums warps hand over: kHalf tiles of 16 x kSlab
constexpr int kXchg = kHalf * 16 * kSlab;

size_t smem_bytes(int Q, int N) {
  const int Qp = round16(Q), Np = round16(N);
  // two stages, two bf16 copies of S (kSlab x (Np + 8)), two scans, the
  // handed-over partial sums
  return static_cast<size_t>(2 * stage_bytes(Qp, Np) +
                             2 * kSlab * (Np + 8) * 2 +
                             (2 * kScan + kXchg) * 4);
}

// named barriers: warps w and kWarps - 1 - w meet on barrier 1 + w
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 8 bf16 (16 bytes) of a row from src into shared dst: a cp.async when all
// 8 lie inside the row (``left`` >= 8 elements remain), zeros when none do,
// else element by element with zeros past the edge
__device__ __forceinline__ void copy8(uint8_t* dst, const __nv_bfloat16* src,
                                      int left) {
  if (left >= 8) {
    cp_async16(dst, src, 16);
  } else if (left <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = e < left ? src[e] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// a bf16 pair (low half first) times (d0, d1), rounded back to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float d0,
                                               float d1) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(b) * d0, __high2float(b) * d1);
}

// One warp: the inclusive cumsum of a chunk's dA (lane l holds positions
// 4l..4l+3, zero past Q) by a shuffle scan, and what the chunk needs of it
// into ``buf``: cum, exp(cum), the decays exp(cum_last - cum_j) rounded to
// bf16 (as the plain version rounds them), exp(cum_last).
__device__ __forceinline__ void chunk_scan(const float (&dv)[4], int lane,
                                           int Q, float* buf) {
  float* cum = buf;
  float* ecum = buf + kMaxQ;
  float* dec = ecum + kMaxQ;
  float v[4] = {dv[0], dv[1], dv[2], dv[3]};
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float run = v[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  float ex = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) ex = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cum[4 * lane + e] = ex + v[e];
    ecum[4 * lane + e] = expf(ex + v[e]);
  }
  __syncwarp();
  const float last = cum[Q - 1];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dec[4 * lane + e] = __bfloat162float(
        __float2bfloat16_rn(expf(last - cum[4 * lane + e])));
  if (lane == 0) dec[kMaxQ] = expf(last);
}

// KN: the most 16-wide steps over N (Np <= 16 KN)
template <int KN>
__global__ void __launch_bounds__(kThreads, KN <= 4 ? 2 : 1)
    ssd_tc_kernel(Args a) {
  constexpr int kOwn = KN / 4;        // 16-column blocks of S a warp owns
  constexpr int kNch = 2 * KN;        // 16-byte chunks a C or B row, at most
  constexpr int kRows = kThreads / kNch;          // C, B rows a pass
  constexpr int kXch = kSlab / 8;                 // chunks an xdt slab row
  constexpr int kXRows = kThreads / kXch;         // xdt rows a pass
  extern __shared__ __align__(128) uint8_t sm[];
  const int slab = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, Qp = a.Qp, Np = a.Np, kn = Np / 16, ldn = Np + 8;
  const int p0 = slab * kSlab;
  const int tileC = Qp * ldn * 2;
  const int stage = stage_bytes(Qp, Np);
  __nv_bfloat16* Sb = reinterpret_cast<__nv_bfloat16*>(sm + 2 * stage);
  const int sb_elems = kSlab * ldn;
  float* scans = reinterpret_cast<float*>(sm + 2 * stage + 2 * sb_elems * 2);
  float* xchg = scans + 2 * kScan;

  const __nv_bfloat16* xp = a.xdt + b * a.x_st.b + h * a.x_st.h;
  const float* ap = a.dA + b * a.a_st.b + h * a.a_st.h;
  const __nv_bfloat16* bp = a.Bm + b * a.b_st.b + grp * a.b_st.h;
  const __nv_bfloat16* cp = a.Cm + b * a.c_st.b + grp * a.c_st.h;
  __nv_bfloat16* yp = a.y + b * a.y_st.b + h * a.y_st.h;

  // chunk c's C, B and xdt slab into stage s, each thread the same 16-byte
  // column chunk of rows kRows (kXRows) apart every chunk; rows past Q and
  // columns past N (P) are zero
  const int lch = (tid % kNch) * 8, lr = tid / kNch;
  const int xch = (tid % kXch) * 8, xr = tid / kXch;
  auto load = [&](int c, int s) {
    uint8_t* st = sm + s * stage;
    const long long c0 = static_cast<long long>(c) * Q;
    if (lch < Np) {
#pragma unroll
      for (int k = 0; k < kMaxQ / kRows; ++k) {
        const int r = lr + k * kRows;
        if (r >= Qp) break;
        const bool live = r < Q;
        const long long row = c0 + (live ? r : 0);
        const int off = (r * ldn + lch) * 2;
        copy8(st + off, cp + row * a.c_st.l + lch, live ? a.N - lch : 0);
        copy8(st + tileC + off, bp + row * a.b_st.l + lch,
              live ? a.N - lch : 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxQ / kXRows; ++k) {
      const int r = xr + k * kXRows;
      if (r >= Qp) break;
      const bool live = r < Q;
      const long long row = c0 + (live ? r : 0);
      copy8(st + 2 * tileC + (r * kLdx + xch) * 2,
            xp + row * a.x_st.l + p0 + xch, live ? a.P - p0 - xch : 0);
    }
  };
  // chunk c's dA, positions 4 lane.. (one warp), into registers
  auto load_dA = [&](int c, float (&dv)[4]) {
    const long long c0 = static_cast<long long>(c) * Q;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = 4 * lane + e;
      dv[e] = idx < Q ? ap[(c0 + idx) * a.a_st.l] : 0.f;
    }
  };

  for (int i = tid; i < sb_elems / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(Sb)[i] = 0u;     // S = 0 before chunk 0
  float dv[4];
  if (warp == kScanWarp) {
    load_dA(0, dv);
    chunk_scan(dv, lane, Q, scans);
  }

  const int mi = lane >> 3, ri = lane & 7, gq = lane >> 2, tq = lane & 3;
  const bool rows_live = 16 * warp < Qp;
  const int i0 = 16 * warp + gq, i1 = i0 + 8;
  const int pt = warp & 1, nq = warp >> 1;       // the warp's piece of S
  float S[kOwn][2][4];
#pragma unroll
  for (int u = 0; u < kOwn; ++u)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[u][t][e] = 0.f;

  const int nc = a.L / Q;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int s = c & 1;
    cp_async_wait<0>();
    __syncthreads();   // chunk c and its scan are in; chunk c - 1 is done
    if (c + 1 < nc) load(c + 1, s ^ 1);
    cp_async_commit();
    if (warp == kScanWarp && c + 1 < nc) load_dA(c + 1, dv);
    const uint8_t* st = sm + s * stage;
    const uint32_t cbase = smem_addr(st), bbase = cbase + tileC,
                   xbase = bbase + tileC;
    const uint32_t sbase = smem_addr(Sb + s * sb_elems);   // S before c
    const float* cum = scans + s * kScan;
    const float* ecum = cum + kMaxQ;
    const float* dec = ecum + kMaxQ;
    // the next chunk's scan, into the other buffer (last read in c - 1)
    auto scan_next = [&]() {
      if (warp == kScanWarp && c + 1 < nc)
        chunk_scan(dv, lane, Q, scans + (s ^ 1) * kScan);
    };

    uint32_t ca[KN][4];
    float yo[4][4], yd[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) yo[t][e] = yd[t][e] = 0.f;
    // C's A fragments of the 16 rows from row0
    auto load_ca = [&](int row0) {
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk >= kn) break;
        ldsm_x4(cbase + ((row0 + (mi & 1) * 8 + ri) * ldn +
                         (2 * kk + (mi >> 1)) * 8) * 2, ca[kk]);
      }
    };
    // acc += W xdt over the key blocks kb0..kb1 for the 16 rows from row0
    // (their C fragments in ca): W = (C B^T) o exp(cum_i - cum_j) for
    // j <= i < Q, rounded to bf16 in the registers and fed back as the A
    // fragment of W xdt
    auto w_xdt = [&](int row0, int kb0, int kb1, float (&acc)[4][4]) {
      const int r0 = row0 + gq, r1 = r0 + 8;
      const float cr0 = cum[r0], cr1 = cum[r1];
      const bool m0 = r0 < Q, m1 = r1 < Q;
      for (int kb = kb0; kb <= kb1; ++kb) {
        float cb[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[t][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          if (kk >= kn) break;
          uint32_t r[4];
          ldsm_x4(bbase + ((16 * kb + (mi >> 1) * 8 + ri) * ldn +
                           (2 * kk + (mi & 1)) * 8) * 2, r);
          mma16816(cb[0], ca[kk], r[0], r[1]);
          mma16816(cb[1], ca[kk], r[2], r[3]);
        }
        uint32_t wa[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * kb + 8 * t + 2 * tq;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float w00 = m0 && j <= r0 ? cb[t][0] * __expf(cr0 - cj0) : 0.f;
          const float w01 = m0 && j < r0 ? cb[t][1] * __expf(cr0 - cj1) : 0.f;
          const float w10 = m1 && j <= r1 ? cb[t][2] * __expf(cr1 - cj0) : 0.f;
          const float w11 = m1 && j < r1 ? cb[t][3] * __expf(cr1 - cj1) : 0.f;
          wa[2 * t] = pack_bf16(w00, w01);
          wa[2 * t + 1] = pack_bf16(w10, w11);
        }
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t r[4];
          ldsm_x4_trans(xbase + ((16 * kb + (mi & 1) * 8 + ri) * kLdx +
                                 (2 * pp + (mi >> 1)) * 8) * 2, r);
          mma16816(acc[2 * pp], wa, r[0], r[1]);
          mma16816(acc[2 * pp + 1], wa, r[2], r[3]);
        }
      }
    };

    if (rows_live) {
      // C's A fragments (rows 16 warp..) and C S^T
      load_ca(16 * warp);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk >= kn) break;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t r[4];
          ldsm_x4(sbase + ((pp * 16 + (mi >> 1) * 8 + ri) * ldn +
                           (2 * kk + (mi & 1)) * 8) * 2, r);
          mma16816(yo[2 * pp], ca[kk], r[0], r[1]);
          mma16816(yo[2 * pp + 1], ca[kk], r[2], r[3]);
        }
      }
      // W xdt: row tile r has the key blocks 0..r (W is 0 above the
      // diagonal).  Warp w takes blocks 0..min(w, 3) of its own rows; warp
      // w < 4 then takes blocks 4..7-w of row tile 7-w and hands that
      // partial sum to warp 7-w in shared memory: at most 5 blocks a warp
      // (the last warp's 8 set the pace otherwise)
      w_xdt(16 * warp, 0, min(warp, kHalf - 1), yd);
      scan_next();           // while it waits for its partner
      if (warp >= kHalf) {
        bar_sync(1 + (kWarps - 1 - warp), 64);     // the partner's sum
        const float* part = xchg + (kWarps - 1 - warp) * 16 * kSlab;
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) yd[t][e] += part[(t * 4 + e) * 32 + lane];
      }
      // y = exp(cum_i) (C S^T) + W xdt, rounded once
      const long long c0 = static_cast<long long>(c) * Q;
      const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int p = p0 + 8 * t + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? i1 : i0;
          if (i >= Q || p >= a.P) continue;
          const float e = half ? e1 : e0;
          const float v0 = e * yo[t][2 * half] + yd[t][2 * half];
          const float v1 = e * yo[t][2 * half + 1] + yd[t][2 * half + 1];
          __nv_bfloat16* dst = yp + (c0 + i) * a.y_st.l + p;
          if (p + 1 < a.P)
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
          else
            *dst = __float2bfloat16_rn(v0);
        }
      }
    }
    if (!rows_live) scan_next();
    const int R = kWarps - 1 - warp;    // the row tile this warp helps
    if (warp < kHalf && 16 * R < Qp) {
      load_ca(16 * R);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) yd[t][e] = 0.f;
      w_xdt(16 * R, kHalf, R, yd);
      float* part = xchg + warp * 16 * kSlab;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(t * 4 + e) * 32 + lane] = yd[t][e];
      bar_arrive(1 + warp, 64);
    }

    // the state: S = exp(cum_last) S + xdt^T (B o decay), on this warp's
    // piece, then its bf16 copy for chunk c + 1's C S^T
    float up[kOwn][2][4];
#pragma unroll
    for (int u = 0; u < kOwn; ++u)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) up[u][t][e] = 0.f;
    for (int kb = 0; kb < Qp / 16; ++kb) {
      uint32_t xa[4];
      ldsm_x4_trans(xbase + ((16 * kb + (mi >> 1) * 8 + ri) * kLdx +
                             (2 * pt + (mi & 1)) * 8) * 2, xa);
      const int j = 16 * kb + 2 * tq;
      const float d0 = dec[j], d1 = dec[j + 1], d2 = dec[j + 8],
                  d3 = dec[j + 9];
#pragma unroll
      for (int u = 0; u < kOwn; ++u) {
        const int nb = nq + 4 * u;
        if (nb >= kn) break;
        uint32_t r[4];
        ldsm_x4_trans(bbase + ((16 * kb + (mi & 1) * 8 + ri) * ldn +
                               (2 * nb + (mi >> 1)) * 8) * 2, r);
        mma16816(up[u][0], xa, scale_pair(r[0], d0, d1),
                 scale_pair(r[1], d2, d3));
        mma16816(up[u][1], xa, scale_pair(r[2], d0, d1),
                 scale_pair(r[3], d2, d3));
      }
    }
    const float total = dec[kMaxQ];
    __nv_bfloat16* sn = Sb + (s ^ 1) * sb_elems;
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int nb = nq + 4 * u;
      if (nb >= kn) break;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[u][t][e] = total * S[u][t][e] + up[u][t][e];
        const int n = 16 * nb + 8 * t + 2 * tq, pr = 16 * pt + gq;
        *reinterpret_cast<uint32_t*>(sn + pr * ldn + n) =
            pack_bf16(S[u][t][0], S[u][t][1]);
        *reinterpret_cast<uint32_t*>(sn + (pr + 8) * ldn + n) =
            pack_bf16(S[u][t][2], S[u][t][3]);
      }
    }
    // the next chunk's scan, into the other buffer (last read in c - 1)
  }
  cp_async_wait<0>();
}

template <int KN>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static PerDevice<bool> granted;
  if (!granted.here()) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_kernel<KN>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = scan::allow_smem(ssd_tc_kernel<KN>, granted);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.P + kSlab - 1) / kSlab, a.H, B);
  ssd_tc_kernel<KN><<<grid, kThreads, smem_bytes(a.Q, a.N), stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0;
}

}  // namespace
}  // namespace ssd_tc

extern "C" {

// xdt (B, H, L, P) and y like it, bfloat16; dA (B, H, L) float32; Bm, Cm
// (B, G, L, N) bfloat16.  ``strides`` holds the (b, head, l) element
// strides of xdt, dA, Bm, Cm and y, 15 values; the last axes are
// contiguous, and every row of xdt, Bm, Cm and y starts on 16 bytes (the
// base pointers 16-byte aligned, their strides multiples of 8; a stride of
// a size-1 axis may be passed as 0).  1 <= chunk <= 128, L % chunk == 0,
// 1 <= P, N <= 128, H % G == 0.  Returns cudaGetLastError() after the
// launch (0 = success).
int ssm_scan_tc_launch(const void* xdt, const void* dA, const void* Bm,
                       const void* Cm, void* y, const long long* strides,
                       int B, int H, int G, int L, int P, int N, int chunk,
                       void* stream) {
  using namespace ssd_tc;
  if (B <= 0 || L <= 0) return 0;
  if (G <= 0 || H % G != 0 || chunk < 1 || chunk > kMaxQ || L % chunk != 0 ||
      P < 1 || P > 128 || N < 1 || N > 128 ||
      smem_bytes(chunk, N) > scan::kSmemLimit)
    return cudaErrorInvalidValue;
  if (!aligned16(xdt, strides) || !aligned16(Bm, strides + 6) ||
      !aligned16(Cm, strides + 9) || !aligned16(y, strides + 12))
    return cudaErrorMisalignedAddress;
  Args a;
  a.xdt = static_cast<const __nv_bfloat16*>(xdt);
  a.dA = static_cast<const float*>(dA);
  a.Bm = static_cast<const __nv_bfloat16*>(Bm);
  a.Cm = static_cast<const __nv_bfloat16*>(Cm);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.x_st = {strides[0], strides[1], strides[2]};
  a.a_st = {strides[3], strides[4], strides[5]};
  a.b_st = {strides[6], strides[7], strides[8]};
  a.c_st = {strides[9], strides[10], strides[11]};
  a.y_st = {strides[12], strides[13], strides[14]};
  a.H = H; a.G = G; a.L = L; a.P = P; a.N = N; a.Q = chunk;
  a.Qp = round16(chunk);
  a.Np = round16(N);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.Np <= 64) return launch<4>(a, B, st);
  return launch<8>(a, B, st);
}

}  // extern "C"
