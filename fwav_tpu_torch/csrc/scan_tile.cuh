// The shared core of K1 (search_scan.cu) and K3 (topc_scan.cu) on Hopper:
// every (range, domain) pair screened on the tensor cores with a bounded
// error, and the few that can matter confirmed in exact float32, so that
// the kernels pick bit for bit what their plain versions (ops/kernels.py)
// pick.
//
// For range m and domain d, with N taps,
//     num_o = sum_j r_c[m, j] * bankT[j, d]
//     num_m = sum_j r_c[m, N-1-j] * bankT[j, d].
//
// What bounds the scans on this card: the CUDA-core screen, which no
// multiply-add absorbs (below: 4 operations per pair for balanced and
// affine, 9 for damped, on 16,896 lanes); the numerators, 2N products per
// pair as three BF16 products each, take the tensor cores about 0.4x (4
// taps, balanced) of that time. So the design spends its care on the
// screen:
//   * numerators with mma.sync m16n8k16 BF16 (wgmma is not needed: the
//     tensor work is under the screen's bound, and the mma.sync
//     fragments keep the fold and the screen in the registers of the
//     thread that owns them), at 16-bit accuracy by splitting r = r_hi +
//     r_lo and b = b_hi + b_lo: per 4 taps A = [r_hi | r_lo | r_hi | 0]
//     and B = [b_hi ; b_hi ; b_lo ; 0] give hi.hi + lo.hi + hi.lo in one
//     MMA per 64 pairs (half the time, at the published peaks, of the
//     split-TF32 pair of m16n8k8 MMAs it replaced);
//   * fragment layout: A rows 0-7 hold eight ranges' taps and rows 8-15
//     the same ranges reversed, so a thread's accumulators hold num_o (c0,
//     c1) and num_m (c2, c3) of one range and two domains;
//   * each warp holds MT m16 tiles (8*MT ranges) and reuses each B fragment
//     across them;
//   * the screen: from these numerators a pair's screened value x differs
//     from what the plain version's float32 score implies by less than a
//     margin f[d] * R[m] (split_tile: about 8x the worst error of either
//     sum), so a pair with x + margin <= S[m] cannot be picked, S being the
//     range's threshold (the best so far for K1, the list's tail for K3,
//     shared by the four lanes that hold the range). Balanced and affine
//     screen in the square root of the score: B is prescaled by sqrt(w),
//     so x = max(|num_o'|, |num_m'|) and S = sqrt(threshold), 4 operations
//     per pair; damped screens the score itself (fold, clip branch). Each
//     thread marks the rest in a bit mask; no keep in the hot loop;
//   * the confirm: after each staged tile a thread walks its marked pairs
//     in increasing domain order and scores each with the plain version's
//     float32 arithmetic (products and sums rounded one by one, in its
//     order), then the policy keeps it on a strict >, which is the lowest
//     index rule; the four lanes of a quad merge at the end by (score
//     descending, index ascending). The picks are the plain versions',
//     ties included, whatever the tiling;
//   * bank tiles (taps, w, thresh, valid) are staged with cp.async into a
//     double buffer, so tile k+1 loads while tile k is scored; the split
//     and the margins are computed once per staged tile, the split into the
//     B fragments' layout (one conflict-free 8-byte load per lane);
//   * a tile whose domains are all valid takes the unmasked screen, a
//     mixed one (the valid prefix's end, the bank's ragged end) a masked
//     one: an invalid domain is never marked, so it never wins and never
//     enters a list.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace fwav {

constexpr int kRangesPerBlock = 128;  // 32 * MT threads hold 8 * MT ranges
constexpr int kTileD = 128;           // domains per staged tile
constexpr int kN8 = kTileD / 8;       // n8 MMA tiles per staged tile (2 bits each)
// The numerators' error is under 2^-16 |r| |b'| for the split sums and
// 2^-20 for the plain float32 sums (N <= 16); the margins take 2^-13.
constexpr float kMarginSqrt = 0x1p-13f;  // of |r| |b'| (balanced, affine)
constexpr float kMarginClip = 0x1p-12f;  // of the clip branch's 2 max(c, t w) |r| |b|
constexpr float kMarginFloor = 0x1p-100f;

template <int N>
struct Taps {
  static constexpr int kChunks = (N + 3) / 4;  // k16 MMAs: 4 taps each
};

// m16 tiles per warp (MT) for N taps and a list of C (1 for K1): 4 up to
// 8 taps and C = 4, else 2, so that ptxas reports no spill.
template <int N, int C>
struct Warp {
  static constexpr int kMT = (N <= 8 && C <= 4) ? 4 : 2;
  static constexpr int kThreads = 32 * kRangesPerBlock / (8 * kMT);
  // blocks per SM for __launch_bounds__: lets ptxas use up to 255 (MT 4)
  // or 128 (MT 2) registers, so that it never spills to stay under a cap
  static constexpr int kMinBlocks = 2;
};

struct ScanArgs {
  const float* r_c;     // (M, N)
  const float* bankT;   // (N, D)
  const float* w;       // (D,)
  const int8_t* valid;  // (D,)
  const float* thresh;  // (D,), damped only
  float c;              // |s_clip|
  int M, D;
};

// One staged tile: the raw copy (double-buffered, filled by cp.async), the
// B fragments, margins and validity of the tile being screened, and the
// block's ranges for the confirm.
template <int N>
struct Stage {
  float raw_b[2][N][kTileD];
  float raw_w[2][kTileD];
  float raw_t[2][kTileD];
  uint32_t raw_v[2][kTileD / 4 + 1];  // the aligned words that hold the bytes
  uint2 frag[kN8][Taps<N>::kChunks][32];
  float ct[kTileD];  // c * t
  float f[kTileD];   // margin factor
  uint8_t v[kTileD];
  float r[kRangesPerBlock * N];
};

// hi and lo of two values, each pair packed low element first.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

// Per thread and m16 tile: the A fragments and R = |r| of its range. Lane
// (g, t) holds, for taps 4q + 2(t&1) and the next, in rows g (the range)
// and g+8 (its reverse): columns 2t, 2t+1 = hi (t < 2) or lo (t >= 2),
// columns 2t+8, 2t+9 = hi (t < 2) or 0. Ranges past M and taps past N are
// zero. Also copies the block's ranges into the stage for the confirm.
template <int N, int MT>
__device__ __forceinline__ void load_ranges(Stage<N>& sm, const ScanArgs& a, int m0,
                                            uint32_t (&A)[MT][Taps<N>::kChunks][4],
                                            float (&R)[MT]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t block0 = (size_t)blockIdx.x * kRangesPerBlock * N;
  for (int e = threadIdx.x; e < kRangesPerBlock * N; e += blockDim.x)
    sm.r[e] = block0 + e < (size_t)a.M * N ? a.r_c[block0 + e] : 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = m0 + 8 * mt + g;
    const bool live = m < a.M;
    const float* r = a.r_c + (size_t)m * N;
    float r2 = 0.f;
    bool zero = true;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float x = live ? r[j] : 0.f;
      r2 = fmaf(x, x, r2);
      zero = zero && x == 0.f;
    }
    R[mt] = zero ? 0.f : fmaxf(sqrtf(r2), 0x1p-100f);  // 0 only for a zero range
#pragma unroll
    for (int q = 0; q < Taps<N>::kChunks; ++q) {
      const int j = 4 * q + 2 * (t & 1);
      const auto tap = [&](int i) { return live && i < N ? r[i] : 0.f; };
      const auto rev = [&](int i) { return live && i < N ? r[N - 1 - i] : 0.f; };
      uint32_t hi, lo, hr, lr;
      split2(tap(j), tap(j + 1), hi, lo);
      split2(rev(j), rev(j + 1), hr, lr);
      A[mt][q][0] = t < 2 ? hi : lo;
      A[mt][q][1] = t < 2 ? hr : lr;
      A[mt][q][2] = t < 2 ? hi : 0u;
      A[mt][q][3] = t < 2 ? hr : 0u;
    }
  }
}

// Start the copy of domains [t0, t0 + nt) into raw buffer `buf`.
template <int N, bool kClip>
__device__ __forceinline__ void issue_tile(Stage<N>& sm, int buf, const ScanArgs& a,
                                           int t0, int nt) {
  for (int e = threadIdx.x; e < N * kTileD; e += blockDim.x) {
    const int j = e / kTileD, k = e % kTileD;
    if (k < nt) cp_async4(&sm.raw_b[buf][j][k], a.bankT + (size_t)j * a.D + t0 + k);
  }
  for (int k = threadIdx.x; k < nt; k += blockDim.x) {
    cp_async4(&sm.raw_w[buf][k], a.w + t0 + k);
    if (kClip) cp_async4(&sm.raw_t[buf][k], a.thresh + t0 + k);
  }
  // valid is bytes: copy the aligned words that hold them (every such
  // word lies inside the allocation's mapped granule)
  const uintptr_t p0 = reinterpret_cast<uintptr_t>(a.valid + t0);
  const uintptr_t base = p0 & ~uintptr_t(3);
  const int words = static_cast<int>((p0 - base + nt + 3) / 4);
  for (int k = threadIdx.x; k < words; k += blockDim.x)
    cp_async4(&sm.raw_v[buf][k], reinterpret_cast<const void*>(base + 4 * k));
  asm volatile("cp.async.commit_group;");
}

// Balanced and affine prescale a domain's taps by sqrt(w), so that
// x^2 = max(num_o'^2, num_m'^2) is its score; w <= 0 gives 0, an upper
// bound of a score that cannot be positive.
template <bool kClip>
__device__ __forceinline__ float prescale(float w) {
  return kClip ? 1.f : (w > 0.f ? sqrtf(w) : 0.f);
}

// Wait for raw buffer `buf`; split it into the B fragments; per domain the
// validity (past nt counts as invalid), c*t and the margin factor f:
//     balanced/affine: f = 2^-13 |b'|, b' = b sqrt(w)  (x and S in sqrt)
//     damped:          f = 2^-12 2 max(c, t w) |b|, the Lipschitz bound of
//                      the score in num times the numerators' error.
// f has a tiny floor, so that a margin is zero only for a zero range,
// whose screened value is exact. Returns whether every domain of the tile
// is valid; ends with a block barrier.
template <int N, bool kClip>
__device__ __forceinline__ bool split_tile(Stage<N>& sm, int buf, const ScanArgs& a,
                                           int t0, int nt) {
  constexpr int kChunks = Taps<N>::kChunks;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  // consecutive threads write consecutive fragment slots; lane (g, t)
  // holds b0 = hi of taps j, j+1 and b1 = lo of them (t < 2) or 0
  for (int e = threadIdx.x; e < kN8 * kChunks * 32; e += blockDim.x) {
    const int lane = e & 31, q = (e >> 5) % kChunks, n = (e >> 5) / kChunks;
    const int t = lane & 3, k = 8 * n + (lane >> 2), j = 4 * q + 2 * (t & 1);
    const bool in = k < nt;
    const float s = in ? prescale<kClip>(sm.raw_w[buf][k]) : 0.f;
    const float x0 = in && j < N ? sm.raw_b[buf][j][k] * s : 0.f;
    const float x1 = in && j + 1 < N ? sm.raw_b[buf][j + 1][k] * s : 0.f;
    uint32_t hi, lo;
    split2(x0, x1, hi, lo);
    sm.frag[n][q][lane] = make_uint2(hi, t < 2 ? lo : 0u);
  }
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(a.valid + t0) & 3);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(sm.raw_v[buf]) + shift;
  int all = 1;
  for (int k = threadIdx.x; k < kTileD; k += blockDim.x) {
    const bool v = k < nt && vb[k] != 0;
    sm.v[k] = v;
    all &= v;
    if (v) {
      float b2 = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) b2 = fmaf(sm.raw_b[buf][j][k], sm.raw_b[buf][j][k], b2);
      const float w = sm.raw_w[buf][k];
      float f;
      if (kClip) {
        const float t = sm.raw_t[buf][k];
        sm.ct[k] = a.c * t;
        f = kMarginClip * 2.f * fmaxf(a.c, t * fabsf(w)) * sqrtf(b2);
      } else {
        f = kMarginSqrt * prescale<kClip>(w) * sqrtf(b2);
      }
      sm.f[k] = fmaxf(f, kMarginFloor);
    }
  }
  return __syncthreads_count(all) == static_cast<int>(blockDim.x);
}

// The screened value of a pair from its tensor-core numerators: damped,
// the plain K3's score (the orientations fold before the clip branch);
// otherwise the larger |num'|.
template <bool kClip>
__device__ __forceinline__ float screen(float no, float nm, float w, float t, float ct,
                                        float c2) {
  const float x = fmaxf(fabsf(no), fabsf(nm));
  if (kClip) return x > t ? fmaf(c2, x, -ct) : x * x * w;
  return x;
}

// Insert x into a descending list of K values if it beats the last.
template <int K>
__device__ __forceinline__ void insert_bound(float (&lb)[K], float x) {
  if (!(x > lb[K - 1])) return;
#pragma unroll
  for (int q = K - 1; q >= 1; --q) {
    const bool up = x > lb[q - 1];
    lb[q] = up ? lb[q - 1] : fmaxf(lb[q], x);
  }
  lb[0] = fmaxf(lb[0], x);
}

// Screen one staged tile: for each n8 tile, the MMAs of all MT m16 tiles,
// then for each range and each of the thread's two domains the bit 2n+col
// of mask[mt] where x + margin exceeds S[mt]. With kFirst (the first
// tile, before any threshold exists) S is instead the K-th largest
// x - margin so far of the thread's pairs of the range (K = 1 for K1's
// best, C for K3's list), a lower bound of what a pick must reach.
template <int N, int MT, bool kClip, bool kMasked, bool kFirst, int K>
__device__ __forceinline__ void screen_tile(const Stage<N>& sm, int buf,
                                            const uint32_t (&A)[MT][Taps<N>::kChunks][4],
                                            const float (&R)[MT], float (&S)[MT],
                                            float (&LB)[MT][K], float c2,
                                            uint32_t (&mask)[MT]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mask[mt] = 0u;
  // K1 keeps no list: at up to 4 taps the whole tile unrolled fits its
  // registers
#pragma unroll(K == 1 && Taps<N>::kChunks == 1 ? kN8 : 2)
  for (int n = 0; n < kN8; ++n) {
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
#pragma unroll
    for (int q = 0; q < Taps<N>::kChunks; ++q) {
      const uint2 b = sm.frag[n][q][lane];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt], A[mt][q], b);
    }
    const int k = 8 * n + 2 * t;
    const float2 f = *reinterpret_cast<const float2*>(&sm.f[k]);
    float2 w = make_float2(0.f, 0.f), th = w, ct = w;
    if (kClip) {
      w = *reinterpret_cast<const float2*>(&sm.raw_w[buf][k]);
      th = *reinterpret_cast<const float2*>(&sm.raw_t[buf][k]);
      ct = *reinterpret_cast<const float2*>(&sm.ct[k]);
    }
    bool v0 = true, v1 = true;
    if (kMasked) {
      v0 = sm.v[k] != 0;
      v1 = sm.v[k + 1] != 0;
    }
    const uint32_t bit0 = 1u << (2 * n), bit1 = bit0 << 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float x0 = screen<kClip>(acc[mt][0], acc[mt][2], w.x, th.x, ct.x, c2);
      const float x1 = screen<kClip>(acc[mt][1], acc[mt][3], w.y, th.y, ct.y, c2);
      if (kFirst) {
        if (v0 && fmaf(f.x, R[mt], x0) > LB[mt][K - 1]) mask[mt] |= bit0;
        if (v0) insert_bound<K>(LB[mt], fmaf(-f.x, R[mt], x0));
        if (v1 && fmaf(f.y, R[mt], x1) > LB[mt][K - 1]) mask[mt] |= bit1;
        if (v1) insert_bound<K>(LB[mt], fmaf(-f.y, R[mt], x1));
      } else {
        if (v0 && fmaf(f.x, R[mt], x0) > S[mt]) mask[mt] |= bit0;
        if (v1 && fmaf(f.y, R[mt], x1) > S[mt]) mask[mt] |= bit1;
      }
    }
  }
}

// Confirm the marked pairs of one staged tile in increasing domain order:
// the plain version's float32 numerators (rounded product by product,
// summed tap by tap), scored and kept by the policy.
template <int N, int MT, class Keep>
__device__ __forceinline__ void confirm_tile(const Stage<N>& sm, int buf, int m0_local,
                                             int t0, uint32_t (&mask)[MT], Keep& keep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* r = &sm.r[(m0_local + 8 * mt + g) * N];
    while (mask[mt]) {
      const int bit = __ffs(mask[mt]) - 1;
      mask[mt] &= mask[mt] - 1;
      const int k = 8 * (bit >> 1) + 2 * t + (bit & 1);
      float no = __fmul_rn(r[0], sm.raw_b[buf][0][k]);
      float nm = __fmul_rn(r[N - 1], sm.raw_b[buf][0][k]);
#pragma unroll
      for (int j = 1; j < N; ++j) {
        const float b = sm.raw_b[buf][j][k];
        no = __fadd_rn(no, __fmul_rn(r[j], b));
        nm = __fadd_rn(nm, __fmul_rn(r[N - 1 - j], b));
      }
      keep.keep(mt, keep.exact(no, nm, sm.raw_w[buf][k], sm.raw_t[buf][k]), t0 + k);
    }
  }
}

// The threshold of the screen from a range's pick threshold T: damped T
// itself; balanced/affine sqrt(T), or -1 (mark every pair) while T <= 0;
// a zero range, whose scores are all zero, marks nothing once it has one.
template <bool kClip>
__device__ __forceinline__ float screen_threshold(float T, float R) {
  if (kClip || T == -CUDART_INF_F) return kClip ? T : -1.f;
  if (R == 0.f) return CUDART_INF_F;
  return T > 0.f ? sqrtf(T) : -1.f;
}

// The j-th largest (1 <= j <= 4) of x over the four lanes of a quad.
__device__ __forceinline__ float quad_rank(float x, int j) {
  const float y = __shfl_xor_sync(0xffffffffu, x, 1);
  const float a = fmaxf(x, y), b = fminf(x, y);
  const float c = __shfl_xor_sync(0xffffffffu, a, 2);
  const float d = __shfl_xor_sync(0xffffffffu, b, 2);
  if (j == 1) return fmaxf(a, c);
  if (j == 4) return fminf(b, d);
  const float hi = fminf(a, c), lo = fmaxf(b, d);
  return j == 2 ? fmaxf(hi, lo) : fminf(hi, lo);
}

// A lower bound, shared by the four lanes of a quad, of the K-th best
// exact score of their range: the lanes' lists are sorted and disjoint,
// so if j lanes have entry k >= v they hold j (k+1) entries >= v, and the
// ceil(K/(k+1))-th largest entry k of the quad is a bound.
template <int K, class Keep>
__device__ __forceinline__ float quad_threshold(const Keep& keep, int mt) {
  float T = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (K + k) / (k + 1);
    // a quad has 4 lanes; of the k with one j the first gives the best bound
    if (j <= 4 && (k == 0 || j < (K + k - 1) / k))
      T = fmaxf(T, quad_rank(keep.entry(mt, k), j));
  }
  return T;
}

// The domain sweep of one block over [d0, d1) for the ranges of this warp.
// After each staged tile the four lanes of a quad share a threshold
// (quad_threshold); a zero range keeps its own, as its margins are zero
// and its ties must fall to the lower index.
template <int N, int MT, bool kClip, class Keep>
__device__ __forceinline__ void scan(Stage<N>& sm, const ScanArgs& a, int d0, int d1,
                                     Keep& keep) {
  const int warp = threadIdx.x >> 5;
  const int m0_local = warp * 8 * MT;
  uint32_t A[MT][Taps<N>::kChunks][4];
  float R[MT], S[MT], LB[MT][Keep::kRank];
  uint32_t mask[MT];
  load_ranges<N, MT>(sm, a, blockIdx.x * kRangesPerBlock + m0_local, A, R);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    S[mt] = kClip ? -CUDART_INF_F : -1.f;
#pragma unroll
    for (int q = 0; q < Keep::kRank; ++q) LB[mt][q] = S[mt];
  }
  const float c2 = 2.f * a.c;
  if (d0 < d1) issue_tile<N, kClip>(sm, 0, a, d0, min(kTileD, d1 - d0));
  int buf = 0;
  for (int t0 = d0; t0 < d1; t0 += kTileD, buf ^= 1) {
    const bool all = split_tile<N, kClip>(sm, buf, a, t0, min(kTileD, d1 - t0));
    const int t1 = t0 + kTileD;
    if (t1 < d1) issue_tile<N, kClip>(sm, buf ^ 1, a, t1, min(kTileD, d1 - t1));
    if (t0 == d0)
      screen_tile<N, MT, kClip, true, true>(sm, buf, A, R, S, LB, c2, mask);
    else if (all)
      screen_tile<N, MT, kClip, false, false>(sm, buf, A, R, S, LB, c2, mask);
    else
      screen_tile<N, MT, kClip, true, false>(sm, buf, A, R, S, LB, c2, mask);
    confirm_tile<N, MT>(sm, buf, m0_local, t0, mask, keep);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float shared = quad_threshold<Keep::kRank>(keep, mt);
      S[mt] = screen_threshold<kClip>(R[mt] > 0.f ? shared : keep.entry(mt, Keep::kRank - 1),
                                      R[mt]);
    }
  }
}

// (score, idx) a beats (score, idx) b: higher score, or equal and lower idx.
__device__ __forceinline__ bool beats(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

}  // namespace fwav
