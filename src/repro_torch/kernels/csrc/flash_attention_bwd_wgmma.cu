// Flash-attention backward on Hopper's tensor cores (sm_90a), bfloat16:
// B6b, as two kernels, dq and dk/dv.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py::
// _flash_bwd, _dq_kernel (:316) and _dkv_kernel (:337), for bf16 inputs;
// float32 inputs keep the FMA kernels of flash_attention_bwd.cu.  Inputs
// are the forward's q (B, H, S, D), k/v (B, Hkv, S, D), the output's
// gradient do (like q), the logsumexp lse and delta = sum(do * o), both
// (B, H, S) float32.  The arithmetic is _flash_bwd's: s = (q . k) * scale,
// p = exp(s - lse) inside the causal/window mask and 0 outside, dp = do .
// v, ds = p * (dp - delta) * scale, all in float32; dq = ds k, dk = ds^T q
// and dv = p^T do, dk and dv summed over the G query heads of their kv
// head; outputs in bf16.
//
// Products.  s and dp are one bf16 wgmma each, exact in their float32
// products.  p and ds are float32 and the reference keeps them so; one
// rounding to bf16 (FlashAttention-2/3's choice) moves dq, dk and dv by
// ~2e-3 of their scale, 100x the port's gates.  So each of dv = p^T do,
// dq = ds k and dk = ds^T q takes a split: x = t0 + t1 + t2 with t0 =
// bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1), one wgmma per term
// into the tile's accumulator (see rs_add), which leaves ~2^-27 of x:
// float32's rounding.  Two terms (2^-18 of x) moved dk by 2.2e-6 at S 128 on an
// H100, over the card test's 1e-6.  The dq kernel does 5 products per
// (q, kv) tile pair (s, dp, ds k three times), dk/dv 8.
//
// What bounds them on the H100: operations (6 D and 8 D FLOPs per visible
// pair for the function, 10 D and 16 D as split; 0.21 and 0.28 ms at
// gemma-7b's training shape at the bf16 peak).  The design:
//   * both kernels: three warpgroups, a producer whose one thread streams
//     tiles by TMA through a 2-stage ring (mbarriers carry the bytes) and
//     two consumer warpgroups (setmaxnreg 24 / 240), as in the forward;
//   * dq: one block per (128-row q tile, head, batch), longest band first;
//     q and do stay in shared memory, k and v tiles stream; each consumer
//     warpgroup owns 64 rows of dq in registers;
//   * dk/dv: one block per (kv tile, kv head, batch); k and v stay, q and
//     do tiles of the G heads of the kv head stream (each thread reads the
//     lse and delta of its q columns from global memory), heads then q
//     tiles in band, a fixed order: no atomics, the result is
//     deterministic.  The block computes s^T = k q^T and dp^T = v do^T, so
//     p^T and ds^T come out of the accumulator already in the A-fragment
//     layout of dv += p^T do and dk += ds^T q (no transpose, no shared
//     memory round trip);
//   * D 256 in dk/dv: two (64 x 256) float32 accumulators would take 256
//     registers a thread, so the two consumer warpgroups share one 64-key
//     tile and split D, each owning 128 columns of dk and dv (wgmma N 128;
//     each recomputes s^T and dp^T).  At D <= 128
//     each owns 64 keys of a 128-key tile with all D columns;
//   * tiles: dq takes 32-key tiles at D 256 (q 64 KB + do 64 KB + 2 x
//     (k + v) 2 x 16 KB = 192 KB), 64-key tiles below; dk/dv streams
//     32-row q tiles, which keeps the split fragments in registers;
//   * rows and keys past S come in as zeros from TMA and are masked.

#include "hopper_common.cuh"

namespace flash_wgmma_bwd {
namespace {

using namespace hopper;

constexpr int kThreads = 384;
constexpr int kStages = 2;
constexpr int kTerms = 3;          // bf16 terms of p and ds in their products
constexpr size_t kSmemLimit = 232448;

template <int D>
struct Dq {
  static constexpr int kChunks = (D + 63) / 64;
  static constexpr int kBM = 128;                    // q rows a block
  static constexpr int kBN = D == 256 ? 32 : 64;     // keys a kv tile
  static constexpr int kNC = D == 256 ? 128 : D;     // columns an rs_add
  static constexpr int kQBytes = kBM * kChunks * 128;
  static constexpr int kKVBytes = kBN * kChunks * 128;
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 64;
  static_assert(kSmem <= kSmemLimit, "tiles exceed shared memory");
};

template <int D>
struct Dkv {
  static constexpr int kChunks = (D + 63) / 64;
  static constexpr bool kSplit = D == 256;           // warpgroups split D
  static constexpr int kBN = kSplit ? 64 : 128;      // keys a block
  static constexpr int kBM = 32;                     // q rows a tile
  static constexpr int kN = kSplit ? D / 2 : D;      // columns a warpgroup
  static constexpr int kNC = kN > 80 ? 64 : kN;      // columns an rs_add
  static constexpr int kKVBytes = kBN * kChunks * 128;
  static constexpr int kQBytes = kBM * kChunks * 128;
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr size_t kSmem =
      1024 + 2 * kKVBytes + kStages * kStageBytes + 64;
  static_assert(kSmem <= kSmemLimit, "tiles exceed shared memory");
  static_assert(!kSplit || kN % 64 == 0, "a split must fall on a chunk");
};

struct BwdParams {
  CUtensorMap q_map, k_map, v_map, do_map;
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int H, Hkv, S, n_tiles;
  float scale;
  int causal, window;
  TileCoord q_at, k_at, v_at, do_at;
};

__device__ __forceinline__ bool visible(int row, int key, int S, int causal,
                                        int window) {
  bool ok = key < S && row < S;
  if (causal) ok = ok && key <= row;
  if (window) ok = ok && row - key < window;
  return ok;
}

__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// The A fragments of k step kk of a float32 accumulator x (columns
// 16 kk .. 16 kk + 15, see hopper_common.cuh), split into kTerms bf16
// terms: f[t] is term t's fragment
template <int R>
__device__ __forceinline__ void split_frag(const float (&x)[R], int kk,
                                           uint32_t (&f)[kTerms][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t t[kTerms];
    split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], t);
#pragma unroll
    for (int i = 0; i < kTerms; ++i) f[i][r] = t[i];
  }
}

// acc[columns g NC .. g NC + NC - 1] += sum over k steps kk and terms t
// of f[kk][t] . b[rows 16 kk .., the group's columns], b an MN-major tile
// of ``chunk_bytes`` a 64-column chunk.  The products accumulate in a
// fresh wgmma accumulator, added to acc with float32 adds: the tensor
// cores' accumulation rounds toward zero, so a sum carried across
// thousands of wgmmas (dk at G 9, S 8192) drifts by ~1e-3 of itself,
// while this carries only the KS x kTerms of one tile.
template <int NC, int KS, int R>
__device__ __forceinline__ void rs_add(float (&acc)[R], int g,
                                       const uint32_t (&f)[KS][kTerms][4],
                                       const uint8_t* b, uint32_t chunk_bytes) {
  static_assert(NC % 64 == 0 || NC == R * 2, "groups fall on chunks");
  float t[NC / 2];
  const uint8_t* bg = b + (g * NC / 64) * chunk_bytes;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
      wgmma_rs<NC>(t, f[kk][i], desc_mn_major(bg + kk * 2048, chunk_bytes),
                   kk > 0 || i > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[g * NC / 2 + i] += t[i];
}

// s = a . b^T and s2 = a2 . b2^T (64 x N each, float32) over D columns
// of K-major tiles (a chunk of a 64-column chunk's bytes apart in a and
// a2, b_chunk in b and b2).  Each 64-column chunk is one wgmma chain into
// a fresh accumulator, the chunks added in float32, for the reason of
// rs_add: at D 256 one chain of 16 truncating steps moved dq by 2e-6.
template <int N, int D>
__device__ __forceinline__ void ss_pair(float (&s)[N / 2], float (&s2)[N / 2],
                                        const uint8_t* a, const uint8_t* a2,
                                        uint32_t a_chunk, const uint8_t* b,
                                        const uint8_t* b2, uint32_t b_chunk) {
#pragma unroll
  for (int c = 0; c < (D + 63) / 64; ++c) {
    constexpr int kSteps = D / 16;
    float t[N / 2], t2[N / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 4 * c; kk < kSteps && kk < 4 * c + 4; ++kk) {
      const uint32_t ao = c * a_chunk + (kk % 4) * 32;
      const uint32_t bo = c * b_chunk + (kk % 4) * 32;
      if (c == 0) {
        wgmma_ss<N>(s, desc_k_major(a + ao), desc_k_major(b + bo), kk > 0);
        wgmma_ss<N>(s2, desc_k_major(a2 + ao), desc_k_major(b2 + bo), kk > 0);
      } else {
        wgmma_ss<N>(t, desc_k_major(a + ao), desc_k_major(b + bo), kk > 4 * c);
        wgmma_ss<N>(t2, desc_k_major(a2 + ao), desc_k_major(b2 + bo),
                    kk > 4 * c);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (c == 0) {
      fence_regs(s);
      fence_regs(s2);
    } else {
      fence_regs(t);
      fence_regs(t2);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        s[i] += t[i];
        s2[i] += t2[i];
      }
    }
  }
}

// the thread's bf16 pair of columns (col, col + 1) of row ``row``
__device__ __forceinline__ void store_pair(__nv_bfloat16* row_ptr, int col,
                                           float x0, float x1) {
  *reinterpret_cast<uint32_t*>(row_ptr + col) = pack_bf16(x0, x1);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ BwdParams p) {
  using C = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + C::kQBytes;
  uint8_t* Ks = dOs + C::kQBytes;
  uint8_t* Vs = Ks + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * C::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q_lo = (p.n_tiles - 1 - blockIdx.z) * C::kBM;
  const int q_hi = min(q_lo + C::kBM, p.S) - 1;
  const int kh = h / (p.H / p.Hkv);
  int j_first = 0, j_last = (p.S - 1) / C::kBN;
  if (p.causal) j_last = min(j_last, q_hi / C::kBN);
  if (p.window) j_first = max(0, q_lo - p.window + 1) / C::kBN;
  const int n_iter = j_last - j_first + 1;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  init_barriers(q_full, full, empty);

  if (wg == 0) {
    regs_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_tile(Qs + c * C::kBM * 128, &p.q_map, p.q_at, q_full, 64 * c,
                      q_lo, h, b);
        tma_load_tile(dOs + c * C::kBM * 128, &p.do_map, p.do_at, q_full,
                      64 * c, q_lo, h, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        const int k_lo = (j_first + it) * C::kBN;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_tile(Ks + st * C::kKVBytes + c * C::kBN * 128, &p.k_map,
                        p.k_at, &full[st], 64 * c, k_lo, kh, b);
          tma_load_tile(Vs + st * C::kKVBytes + c * C::kBN * 128, &p.v_map,
                        p.v_at, &full[st], 64 * c, k_lo, kh, b);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int w = wg - 1, warp = tid / 32, lane = tid % 32;
    const int qw_lo = q_lo + 64 * w;
    const int r0 = qw_lo + 16 * warp + lane / 4;      // and r0 + 8
    const int cq = 2 * (lane % 4);
    const long long bh = (static_cast<long long>(b) * p.H + h) * p.S;
    float lse[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      lse[i] = row < p.S ? p.lse[bh + row] : 0.f;
      delta[i] = row < p.S ? p.delta[bh + row] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint8_t* Qw = Qs + w * 64 * 128;
    const uint8_t* dOw = dOs + w * 64 * 128;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages;
      const int k_lo = (j_first + it) * C::kBN;
      const uint8_t* Kt = Ks + st * C::kKVBytes;
      const uint8_t* Vt = Vs + st * C::kKVBytes;
      mbar_wait(&full[st], (it / kStages) & 1);

      float s[C::kBN / 2], dp[C::kBN / 2];
      ss_pair<C::kBN, D>(s, dp, Qw, dOw, C::kBM * 128, Kt, Vt, C::kBN * 128);

      const bool edge = k_lo + C::kBN > p.S || qw_lo + 64 > p.S ||
                        (p.causal && k_lo + C::kBN - 1 > qw_lo) ||
                        (p.window && k_lo <= qw_lo + 63 - p.window);
      uint32_t ds_t[C::kBN / 16][kTerms][4];
#pragma unroll
      for (int j = 0; j < C::kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pe = expf(s[4 * j + e] * p.scale - lse[i]);
          if (edge && !visible(r0 + 8 * i, k_lo + 8 * j + cq + (e & 1), p.S,
                               p.causal, p.window))
            pe = 0.f;
          dp[4 * j + e] = pe * (dp[4 * j + e] - delta[i]) * p.scale;
        }
#pragma unroll
      for (int kk = 0; kk < C::kBN / 16; ++kk) split_frag(dp, kk, ds_t[kk]);

#pragma unroll
      for (int g = 0; g < D / C::kNC; ++g)
        rs_add<C::kNC>(dq, g, ds_t, Kt, C::kBN * 128);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= p.S) continue;
      __nv_bfloat16* out = p.dq + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(out, 8 * j + cq, dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ BwdParams p) {
  using C = Dkv<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + C::kKVBytes;
  uint8_t* stages = Vs + C::kKVBytes;      // per stage: q, do
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(stages + kStages * C::kStageBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int k_lo = blockIdx.z * C::kBN;    // the earliest keys see most
  const int k_hi = min(k_lo + C::kBN, p.S) - 1;
  const int nq = (p.S + C::kBM - 1) / C::kBM;
  // the q tiles in band: rows at or after k_lo (causal), before
  // k_hi + window (sliding window)
  const int i_first = p.causal ? k_lo / C::kBM : 0;
  int i_last = nq - 1;
  if (p.window) i_last = min(i_last, (k_hi + p.window - 1) / C::kBM);
  const int n_q = i_last - i_first + 1;
  const int n_iter = G * n_q;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  init_barriers(kv_full, full, empty);

  if (wg == 0) {
    regs_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_tile(Ks + c * C::kBN * 128, &p.k_map, p.k_at, kv_full,
                      64 * c, k_lo, kh, b);
        tma_load_tile(Vs + c * C::kBN * 128, &p.v_map, p.v_at, kv_full,
                      64 * c, k_lo, kh, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        const int h = kh * G + it / n_q;
        const int q_lo = (i_first + it % n_q) * C::kBM;
        uint8_t* Qt = stages + st * C::kStageBytes;
        uint8_t* dOt = Qt + C::kQBytes;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::kStageBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_tile(Qt + c * C::kBM * 128, &p.q_map, p.q_at, &full[st],
                        64 * c, q_lo, h, b);
          tma_load_tile(dOt + c * C::kBM * 128, &p.do_map, p.do_at,
                        &full[st], 64 * c, q_lo, h, b);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int w = wg - 1, warp = tid / 32, lane = tid % 32;
    const int kw_lo = k_lo + (C::kSplit ? 0 : 64 * w);
    const int kr0 = kw_lo + 16 * warp + lane / 4;     // and kr0 + 8
    const int cq = 2 * (lane % 4);
    const int col0 = C::kSplit ? w * C::kN : 0;       // dk, dv columns
    const int chunk0 = col0 / 64;
    const uint8_t* Kw = Ks + (C::kSplit ? 0 : w * 64 * 128);
    const uint8_t* Vw = Vs + (C::kSplit ? 0 : w * 64 * 128);
    float dk[C::kN / 2], dv[C::kN / 2];
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages;
      const int q_lo = (i_first + it % n_q) * C::kBM;
      const uint8_t* Qt = stages + st * C::kStageBytes;
      const uint8_t* dOt = Qt + C::kQBytes;
      const long long bh =
          (static_cast<long long>(b) * p.H + kh * G + it / n_q) * p.S;
      mbar_wait(&full[st], (it / kStages) & 1);

      // s^T (keys x q rows) = k q^T, dp^T = v do^T
      // lse and delta of the thread's q columns (rows past S read as 0:
      // they are masked)
      float lse[C::kBM / 8][2], delta[C::kBM / 8][2];
#pragma unroll
      for (int j = 0; j < C::kBM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q_lo + 8 * j + cq + e;
          lse[j][e] = q < p.S ? __ldg(p.lse + bh + q) : 0.f;
          delta[j][e] = q < p.S ? __ldg(p.delta + bh + q) : 0.f;
        }
      float s[C::kBM / 2], dp[C::kBM / 2];
      ss_pair<C::kBM, D>(s, dp, Kw, Vw, C::kBN * 128, Qt, dOt, C::kBM * 128);

      const bool edge = q_lo + C::kBM > p.S || kw_lo + 64 > p.S ||
                        (p.causal && q_lo < kw_lo + 63) ||
                        (p.window && q_lo + C::kBM - 1 - kw_lo >= p.window);
      uint32_t p_t[C::kBM / 16][kTerms][4], ds_t[C::kBM / 16][kTerms][4];
#pragma unroll
      for (int j = 0; j < C::kBM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + cq + (e & 1);       // q row in the tile
          float pe = expf(s[4 * j + e] * p.scale - lse[j][e & 1]);
          if (edge && !visible(q_lo + qc, kr0 + 8 * (e >> 1), p.S, p.causal,
                               p.window))
            pe = 0.f;
          s[4 * j + e] = pe;
          dp[4 * j + e] = pe * (dp[4 * j + e] - delta[j][e & 1]) * p.scale;
        }
#pragma unroll
      for (int kk = 0; kk < C::kBM / 16; ++kk) {
        split_frag(s, kk, p_t[kk]);
        split_frag(dp, kk, ds_t[kk]);
      }

      const int off = chunk0 * C::kBM * 128;
#pragma unroll
      for (int g = 0; g < C::kN / C::kNC; ++g) {
        rs_add<C::kNC>(dv, g, p_t, dOt + off, C::kBM * 128);
        rs_add<C::kNC>(dk, g, ds_t, Qt + off, C::kBM * 128);
      }
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = kr0 + 8 * i;
      if (row >= p.S) continue;
      __nv_bfloat16* ko = p.dk + b * p.dk_sb + kh * p.dk_sh + row * p.dk_ss;
      __nv_bfloat16* vo = p.dv + b * p.dv_sb + kh * p.dv_sh + row * p.dv_ss;
#pragma unroll
      for (int j = 0; j < C::kN / 8; ++j) {
        const int col = col0 + 8 * j + cq;
        store_pair(ko, col, dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
        store_pair(vo, col, dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) done = true;
  return e;
}

// strides: (b, h, s) of q, k, v, do, dq, dk, dv
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, const long long* st, int B,
                   int H, int Hkv, int S, int causal, int window, float scale,
                   bool dkv, cudaStream_t stream) {
  const int q_rows = dkv ? Dkv<D>::kBM : Dq<D>::kBM;
  const int kv_rows = dkv ? Dkv<D>::kBN : Dq<D>::kBN;
  BwdParams p;
  if (!map_bhsd(&p.q_map, &p.q_at, q, B, H, S, D, st[0], st[1], st[2],
                q_rows) ||
      !map_bhsd(&p.k_map, &p.k_at, k, B, Hkv, S, D, st[3], st[4], st[5],
                kv_rows) ||
      !map_bhsd(&p.v_map, &p.v_at, v, B, Hkv, S, D, st[6], st[7], st[8],
                kv_rows) ||
      !map_bhsd(&p.do_map, &p.do_at, dout, B, H, S, D, st[9], st[10],
                st[11], q_rows))
    return cudaErrorInvalidValue;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dq_sb = st[12]; p.dq_sh = st[13]; p.dq_ss = st[14];
  p.dk_sb = st[15]; p.dk_sh = st[16]; p.dk_ss = st[17];
  p.dv_sb = st[18]; p.dv_sh = st[19]; p.dv_ss = st[20];
  p.H = H; p.Hkv = Hkv; p.S = S;
  p.scale = scale; p.causal = causal; p.window = window;
  cudaError_t e;
  if (dkv) {
    static hopper::PerDevice granted;
    e = allow_smem(dkv_kernel<D>, Dkv<D>::kSmem, granted.here());
    if (e != cudaSuccess) return e;
    p.n_tiles = (S + Dkv<D>::kBN - 1) / Dkv<D>::kBN;
    dkv_kernel<D><<<dim3(Hkv, B, p.n_tiles), kThreads, Dkv<D>::kSmem,
                    stream>>>(p);
  } else {
    static hopper::PerDevice granted;
    e = allow_smem(dq_kernel<D>, Dq<D>::kSmem, granted.here());
    if (e != cudaSuccess) return e;
    p.n_tiles = (S + Dq<D>::kBM - 1) / Dq<D>::kBM;
    dq_kernel<D><<<dim3(H, B, p.n_tiles), kThreads, Dq<D>::kSmem, stream>>>(
        p);
  }
  return cudaGetLastError();
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, const long long* strides, int B, int H, int Hkv,
               int S, int D, int dtype, int causal, int window, float scale,
               void* stream, bool dkv) {
  if (B <= 0 || S <= 0) return 0;
  if (dtype != 1 || Hkv <= 0 || H % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv,
                               strides, B, H, Hkv, S, causal, window, scale,
                               dkv, st);
    case 80: return launch<80>(q, k, v, dout, lse, delta, dq, dk, dv,
                               strides, B, H, Hkv, S, causal, window, scale,
                               dkv, st);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv,
                                 strides, B, H, Hkv, S, causal, window,
                                 scale, dkv, st);
    case 256: return launch<256>(q, k, v, dout, lse, delta, dq, dk, dv,
                                 strides, B, H, Hkv, S, causal, window,
                                 scale, dkv, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace flash_wgmma_bwd

extern "C" {

// Same arguments as flash_attention_dq_launch and
// flash_attention_dkv_launch (flash_attention_bwd.cu), bfloat16 (dtype 1),
// strides of multiples of 8 elements and 16-byte aligned tensors (TMA);
// D in {64, 80, 128, 256}.  The dq launch writes only dq, the dk/dv
// launch only dk and dv.  Each returns cudaErrorInvalidValue for what it
// does not take, else cudaGetLastError() after its launch.
int flash_attention_dq_wgmma_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv,
                                    const long long* strides, int B, int H,
                                    int Hkv, int S, int D, int dtype,
                                    int causal, int window, float scale,
                                    void* stream) {
  return flash_wgmma_bwd::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv,
                                     strides, B, H, Hkv, S, D, dtype, causal,
                                     window, scale, stream, false);
}

int flash_attention_dkv_wgmma_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv,
                                     const long long* strides, int B, int H,
                                     int Hkv, int S, int D, int dtype,
                                     int causal, int window, float scale,
                                     void* stream) {
  return flash_wgmma_bwd::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv,
                                     strides, B, H, Hkv, S, D, dtype, causal,
                                     window, scale, stream, true);
}

}  // extern "C"
