// Flash-attention forward on Hopper's tensor cores (sm_90a), bfloat16: B6
// and, behind the ``lse`` pointer, B6f.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::
// flash_attention (body _attn_kernel, :118) and _flash_fwd_lse (body
// _attn_fwd_lse_kernel, :276) for bf16 inputs; float32 inputs keep the
// FMA kernel of flash_attention_fwd.cu.  For q (B, H, S, D) and k/v
// (B, Hkv, S, D), query head h reads kv head h / (H / Hkv); causal, with
// an optional sliding window; o (B, H, S, D) bf16 and, for B6f, lse
// (B, H, S) float32 = m + log(max(l, 1e-30)).  The arithmetic is the TPU
// kernel's: s = (q . k) in float32 (products of bf16 values are exact),
// times 1/sqrt(D) after the product; masked scores are -1e30; the online
// softmax keeps m, l and the accumulator in float32; the weights are
// rounded to bf16 before P V (l sums them unrounded); o = acc /
// max(l, 1e-30).
//
// What bounds it on the H100: operations.  At gemma-7b's training shape
// (S 4096, 16 heads of 256, causal) a call is 137 GFLOP against 134 MB,
// 0.14 ms at the bf16 tensor-core peak.  The design, FlashAttention-3's
// shape (hopper_common.cuh has the pieces):
//   * one block per (128-row q tile, head, batch), three warpgroups: a
//     producer whose one thread keeps a 2-stage ring of K and V tiles in
//     flight by TMA (mbarriers carry the transaction bytes), and two
//     consumer warpgroups of 64 q rows each; setmaxnreg moves registers
//     from the producer (24) to the consumers (240);
//   * S = Q K^T is one chain of SS wgmma (m64 x kBN x 16) from the
//     swizzled tiles; P is rounded to bf16 in registers and O += P V is
//     a chain of RS wgmma (m64 x D x 16) with V read MN-major, so no
//     score or weight touches shared memory;
//   * kv tiles wholly outside the causal or window band are never loaded;
//     the mask is applied only on tiles that straddle its edge or S;
//   * q tiles are launched longest band first (the grid's slowest axis
//     walks them from the last), so the causal tail does not idle SMs;
//   * the (B, S, H, D) activations are read in place through the tensor
//     maps (4 dims, byte strides from the view); rows and keys past S
//     come in as zeros and are masked, so nothing is padded.
// Tiles: D 256 takes 64-key kv tiles (Q 64 KB + 2 x (K + V) 2 x 32 KB =
// 192 KB of shared memory; consumers hold O 128 + S 32 + P 16 registers);
// D <= 128 takes 128-key tiles.  D 80 is loaded as two 64-column boxes,
// the 48 columns past 80 zero-filled by TMA: Q K^T runs 5 k-steps of 16
// (none wasted), P V is one m64n80 wgmma, so the fill costs shared memory
// and TMA bandwidth only.

#include "hopper_common.cuh"

namespace flash_wgmma {
namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 384;
constexpr int kStages = 2;
constexpr size_t kSmemLimit = 232448;

template <int D>
struct Fwd {
  static constexpr int kChunks = (D + 63) / 64;
  static constexpr int kBM = 128;                    // q rows a block
  static constexpr int kBN = D == 256 ? 64 : 128;    // keys a kv tile
  static constexpr int kQBytes = kBM * kChunks * 128;
  static constexpr int kKVBytes = kBN * kChunks * 128;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 64;
  static_assert(kSmem <= kSmemLimit, "tiles exceed shared memory");
};

struct FwdParams {
  CUtensorMap q_map, k_map, v_map;
  __nv_bfloat16* o;
  float* lse;                 // null: B6 (no logsumexp)
  long long o_sb, o_sh, o_ss;
  int H, Hkv, S, n_qtiles;
  float scale;
  int causal, window;
  TileCoord q_at, k_at, v_at;
};

__device__ __forceinline__ bool visible(int row, int key, int S, int causal,
                                        int window) {
  bool ok = key < S;
  if (causal) ok = ok && key <= row;
  if (window) ok = ok && row - key < window;
  return ok;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ FwdParams p) {
  using C = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + C::kQBytes;
  uint8_t* Vs = Ks + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * C::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q_lo = (p.n_qtiles - 1 - blockIdx.z) * C::kBM;
  const int q_hi = min(q_lo + C::kBM, p.S) - 1;
  const int kh = h / (p.H / p.Hkv);
  // the kv tiles in band: keys at or before q_hi (causal), after
  // q_lo - window (sliding window)
  int j_first = 0, j_last = (p.S - 1) / C::kBN;
  if (p.causal) j_last = min(j_last, q_hi / C::kBN);
  if (p.window) j_first = max(0, q_lo - p.window + 1) / C::kBN;
  const int n_tiles = j_last - j_first + 1;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    regs_dealloc<24>();
    if (tid == 0) {
      prefetch_map(&p.q_map);
      prefetch_map(&p.k_map);
      prefetch_map(&p.v_map);
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_tile(Qs + c * C::kBM * 128, &p.q_map, p.q_at, q_full, 64 * c,
                      q_lo, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int k_lo = (j_first + it) * C::kBN;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::kKVBytes);
        uint8_t* kt = Ks + st * C::kKVBytes;
        uint8_t* vt = Vs + st * C::kKVBytes;
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_tile(kt + c * C::kBN * 128, &p.k_map, p.k_at, &full[st],
                        64 * c, k_lo, kh, b);
          tma_load_tile(vt + c * C::kBN * 128, &p.v_map, p.v_at, &full[st],
                        64 * c, k_lo, kh, b);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int w = wg - 1, warp = tid / 32, lane = tid % 32;
    const int qw_lo = q_lo + 64 * w;
    const int r0 = qw_lo + 16 * warp + lane / 4;      // and r0 + 8
    const int cq = 2 * (lane % 4);                    // column in an n8 block
    const uint8_t* Qw = Qs + w * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int k_lo = (j_first + it) * C::kBN;
      const uint8_t* Kt = Ks + st * C::kKVBytes;
      const uint8_t* Vt = Vs + st * C::kKVBytes;
      mbar_wait(&full[st], (it / kStages) & 1);

      float s[C::kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::kBN>(
            s, desc_k_major(Qw + (kk / 4) * C::kBM * 128 + (kk % 4) * 32),
            desc_k_major(Kt + (kk / 4) * C::kBN * 128 + (kk % 4) * 32),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const bool edge = k_lo + C::kBN > p.S ||
                        (p.causal && k_lo + C::kBN - 1 > qw_lo) ||
                        (p.window && k_lo <= qw_lo + 63 - p.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < C::kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * p.scale;
          if (edge && !visible(r0 + 8 * (e >> 1), k_lo + 8 * j + cq + (e & 1),
                               p.S, p.causal, p.window))
            x = kNegInf;
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        corr[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
      uint32_t pa[C::kBN / 16][4];
#pragma unroll
      for (int j = 0; j < C::kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(s[4 * j + e] - m[e >> 1]);
          psum[e >> 1] += pe;
          s[4 * j + e] = pe;
        }
#pragma unroll
      for (int kk = 0; kk < C::kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kBN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], desc_mn_major(Vt + kk * 2048, C::kBN * 128),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    float denom[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      denom[i] = fmaxf(l[i], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= p.S) continue;
      __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j + cq) =
            pack_bf16(o[4 * j + 2 * i] / denom[i],
                      o[4 * j + 2 * i + 1] / denom[i]);
      if (p.lse != nullptr && lane % 4 == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
            m[i] + logf(denom[i]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* st, int B, int H, int Hkv,
                   int S, int window, int causal, float scale,
                   cudaStream_t stream) {
  using C = Fwd<D>;
  FwdParams p;
  if (!map_bhsd(&p.q_map, &p.q_at, q, B, H, S, D, st[0], st[1], st[2],
                C::kBM) ||
      !map_bhsd(&p.k_map, &p.k_at, k, B, Hkv, S, D, st[3], st[4], st[5],
                C::kBN) ||
      !map_bhsd(&p.v_map, &p.v_at, v, B, Hkv, S, D, st[6], st[7], st[8],
                C::kBN))
    return cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_ss = st[11];
  p.H = H; p.Hkv = Hkv; p.S = S;
  p.n_qtiles = (S + C::kBM - 1) / C::kBM;
  p.scale = scale; p.causal = causal; p.window = window;
  static hopper::PerDevice granted;
  if (!granted.here()) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmem));
    if (e != cudaSuccess) return e;
    granted.here() = true;
  }
  const dim3 grid(H, B, p.n_qtiles);
  fwd_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One warpgroup's wgmma on its own, for testing the descriptors, swizzle
// and register layouts above: c (64 x N float32) = a (64 x K) . b with a
// (64 x K bf16, row-major) and b either K-major (N x K, row-major: the
// SS form, as k in q . k^T) or MN-major (K x N, row-major: the RS form
// with a in registers, as v in p . v).  K = 64: four k-steps, so the
// 32-byte advance along a swizzled row is exercised.
// ---------------------------------------------------------------------------
struct CheckParams {
  CUtensorMap a_map, b_map;
  float* c;
  const __nv_bfloat16* a;
};

template <int N, bool kRS>
__global__ void __launch_bounds__(128, 1)
    wgmma_check_kernel(const __grid_constant__ CheckParams p) {
  constexpr int K = 64;
  constexpr int kBRows = kRS ? K : N;          // rows of b's tile
  constexpr int kBChunks = kRS ? (N + 63) / 64 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align1024(smem_raw);
  uint8_t* Bs = As + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + kBRows * kBChunks * 128);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (64 + kBRows * kBChunks) * 128);
    tma_load_4d(As, &p.a_map, bar, 0, 0, 0, 0);
    for (int c = 0; c < kBChunks; ++c)
      tma_load_4d(Bs + c * kBRows * 128, &p.b_map, bar, 64 * c, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const int r = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  if constexpr (kRS) {
    uint32_t a[K / 16][4];
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(p.a);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      a[kk][0] = a32[(r * K + 16 * kk + cq) / 2];
      a[kk][1] = a32[((r + 8) * K + 16 * kk + cq) / 2];
      a[kk][2] = a32[(r * K + 16 * kk + cq + 8) / 2];
      a[kk][3] = a32[((r + 8) * K + 16 * kk + cq + 8) / 2];
    }
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_rs<N>(d, a[kk], desc_mn_major(Bs + kk * 2048, kBRows * 128), 1);
  } else {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_ss<N>(d, desc_k_major(As + kk * 32), desc_k_major(Bs + kk * 32),
                  kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p.c[(r + 8 * (e >> 1)) * N + 8 * j + cq + (e & 1)] = d[4 * j + e];
}

template <int N, bool kRS>
cudaError_t launch_check(const void* a, const void* b, float* c,
                         cudaStream_t stream) {
  constexpr int K = 64;
  CheckParams p;
  // a: 64 rows of K; b: N rows of K (SS) or K rows of N (RS)
  const long long b_rows = kRS ? K : N, b_cols = kRS ? N : K;
  TileCoord at;                 // one head: (d, s, 0, 0)
  if (!map_bhsd(&p.a_map, &at, a, 1, 1, 64, K, 64 * K, 64 * K, K, 64) ||
      !map_bhsd(&p.b_map, &at, b, 1, 1, b_rows, b_cols, b_rows * b_cols,
                b_rows * b_cols, b_cols, b_rows))
    return cudaErrorInvalidValue;
  p.c = c;
  p.a = static_cast<const __nv_bfloat16*>(a);
  const size_t smem = 1024 + 64 * 128 + (kRS ? K * ((N + 63) / 64) : N) * 128
                      + 64;
  const cudaError_t e = cudaFuncSetAttribute(
      wgmma_check_kernel<N, kRS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  wgmma_check_kernel<N, kRS><<<1, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_wgmma

extern "C" {

// Same arguments as flash_attention_fwd_launch (flash_attention_fwd.cu):
// q (B, H, S, D), k/v (B, Hkv, S, D), o like q, bfloat16 (dtype 1), d
// contiguous, 16-byte aligned, strides of multiples of 8 elements (TMA's
// 16 bytes); ``strides`` holds the (b, h, s) element strides of q, k, v
// and o; ``lse`` null (B6) or a contiguous (B, H, S) float32 output
// (B6f).  D in {64, 80, 128, 256}.  Returns cudaErrorInvalidValue for
// what it does not take, else cudaGetLastError() after the launch.
int flash_attention_fwd_wgmma_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const long long* strides, int B, int H,
                                     int Hkv, int S, int D, int dtype,
                                     int causal, int window, float scale,
                                     void* stream) {
  using namespace flash_wgmma;
  if (B <= 0 || S <= 0) return 0;
  if (dtype != 1 || Hkv <= 0 || H % Hkv != 0 || window < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, lse, strides, B, H, Hkv, S,
                               window, causal, scale, st);
    case 80: return launch<80>(q, k, v, o, lse, strides, B, H, Hkv, S,
                               window, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, lse, strides, B, H, Hkv, S,
                                 window, causal, scale, st);
    case 256: return launch<256>(q, k, v, o, lse, strides, B, H, Hkv, S,
                                 window, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// c (64 x n float32, contiguous) = a (64 x 64 bf16, contiguous) . b: with
// ``rs`` 0, b is (n x 64) and the product is a . b^T by SS wgmma (n in
// {32, 64, 128}); with ``rs`` 1, b is (64 x n) and the product is a . b
// by RS wgmma (n in {64, 80, 128, 256}).  Tests the building blocks of
// hopper_common.cuh on the card.
int flash_attention_wgmma_check(const void* a, const void* b, void* c, int n,
                                int rs, void* stream) {
  using namespace flash_wgmma;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  if (!rs) {
    switch (n) {
      case 32: return launch_check<32, false>(a, b, out, st);
      case 64: return launch_check<64, false>(a, b, out, st);
      case 128: return launch_check<128, false>(a, b, out, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (n) {
    case 64: return launch_check<64, true>(a, b, out, st);
    case 80: return launch_check<80, true>(a, b, out, st);
    case 128: return launch_check<128, true>(a, b, out, st);
    case 256: return launch_check<256, true>(a, b, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
