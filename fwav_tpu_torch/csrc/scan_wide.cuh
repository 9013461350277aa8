// The wide scan of K1 (search_scan.cu) and K3 (topc_scan.cu): range sizes N
// of 17 to 255 taps (tiles from 4352 samples, N = tile_size / 256), with N
// a runtime value.
//
// The design is scan_tile.cuh's: every (range, domain) pair screened on the
// tensor cores (mma.sync m16n8k16 BF16, its 3-term split and fragment
// layout: A rows 8-15 are the reversed ranges, so the fold stays in one
// thread) within a proven margin, and the pairs that can be picked
// confirmed in exact float32, in the plain version's order (products and
// sums rounded one by one, tap by tap), kept by the same policies
// (ArgmaxKeep, TopcKeep; strict >, the lower index on ties). The kernels
// therefore pick bit for bit what search_scan_ref and topc_scan_ref pick.
// What differs from scan_tile.cuh, which keeps a thread's A fragments in
// registers and takes N as a template (N <= 16):
//   * the taps are walked in 4-tap chunks, one MMA each, Q = ceil(N / 4)
//     of them at run time (5 to 64);
//   * A's fragments are made once per block into shared memory, in the
//     fragment layout (8 bytes a lane and chunk: the two registers that
//     differ; the other two are copies or zero); each warp splits the B
//     fragments it needs from the raw tile inside its MMA loop, so that the
//     split's arithmetic overlaps the MMAs and no fragment buffer or
//     barrier stands between them (the raw tile is swizzled, so that a
//     quad's two tap pairs read different banks);
//   * a block is 32 ranges (16 for a list of 8) and 4 warps, each warp the
//     MT m16 tiles of all of them x its NT n8 tiles of every staged tile:
//     per chunk it reads each A fragment once for its NT n8 tiles and each
//     raw tap pair once for its MT m16 tiles; a range's results merge over
//     the quad, then over the 4 warps through shared memory, by (score
//     descending, index ascending);
//   * the confirm's threshold is the block's: after each tile a warp
//     leaves its quads' K best scores in shared memory and the next tile
//     screens against the K-th best of all four; a tile's own pairs also
//     bound it (the K-th largest x - margin), which matters most in a
//     block's first tile, where no threshold exists yet;
//   * shared memory grows with N: A's fragments 32 Q R bytes, the
//     double-buffered raw tile 32 Q TD (its taps zero-padded to 4Q), the
//     ranges for the confirm 4 N R;
//     three chunk-count classes (WideShape) shrink the staged tile width TD
//     with N, 128 domains up to 64 taps, 64 up to 128, 32 above, so that
//     a block stays under 227 KB and two share an SM up to about 100 taps;
//   * a warp's marks of a tile are queued in shared memory and dealt out
//     over its lanes for the confirm (wide_confirm);
//   * the margin grows with N (wide_margin, derived below), damped takes
//     the score's local slope, not its largest, and every margin has an
//     absolute term for scores that fall into the subnormals.
//
// What bounds it here: the numerators on the tensor cores (12 N flop a
// pair at the BF16 rate: 7,168 x 28,672 ranges x domains at N = 64, the
// exact branch of a 10 s file at tile 16384, take 0.16 ms at the peak),
// the split's arithmetic that feeds them (a tap pair's split per lane, n8
// tile and chunk, shared by MT MMAs), and shared memory's 128 bytes a
// clock per SM for the fragments and taps (4 bytes a lane per MMA at MT =
// NT = 4); the screen's 4 (balanced, affine) or 17 (damped, its margin
// per pair) operations a pair on the CUDA cores are well under them from
// N = 17 on. The confirm
// costs 4N operations a marked pair (about 1,000 at N 255), one tap after
// another, so the screen's thresholds matter.
//
// The margin for any N (the numerators' error, against the product
// |r| |x| of the range's and the prescaled bank row's norms; u = 2^-24,
// Q = ceil(N / 4), P = sum_j |r_j| |x_j| <= |r| |x| by Cauchy-Schwarz):
//   (1) the split: r = hi + lo + e with |lo| <= 2^-8 |r|, |e| <= 2^-16 |r|
//       (bf16 rounds to nearest), the same for x; hi.hi + lo.hi + hi.lo
//       drops lo.lo and the residuals: per tap at most 3.01 2^-16 |r_j||x_j|,
//       at most 771 u P over the taps, at any N;
//   (2) the MMAs: BF16 products are exact in float32; each MMA adds its 12
//       nonzero products to the accumulator in an order and with an
//       alignment nobody specifies. Taking each addend to lose up to one
//       unit of the largest addend's last place (truncation) and the result
//       rounded once more, an MMA errs by at most 14 2^-23 (|c| + sum |p|),
//       and |c| + sum |p| <= 1.012 P, so Q chunks err by at most 29 Q u P;
//   (3) the plain version's own float32 sum, product by product and tap by
//       tap: at most N u P (gamma_N);
//   (4) the scale by sqrt(w), the score's roundings, the threshold's
//       square root and the norms' float32 sums: under 29 u P and a
//       relative (N + 2) u of the margin itself.
// So E(N) <= (29 Q + N + 800) u |r| |x|, and the margin is twice that, never
// under scan_tile.cuh's 2^-13:
//     wide_margin(N) = max(2^-13, (58 Q + 2 N + 1600) 2^-24)
// It is 2^-13 up to N = 24 (the narrow kernels' margin covers the bound
// there twice over), 2^-12.6 at N = 64 and 2^-11.5 at N = 255. Balanced
// and affine screen in the square root of the score, where it is the
// margin itself (with |x| = sqrt(w) |b|). Damped screens the score: a pair
// whose screened |num| is a, and whose numerators are within d =
// wide_margin(N) |r| |b| (twice their error) of the exact ones, takes the
// score's steepest slope within d of a times d: 2c on the clip branch,
// 2 |w| (a + d) on the square one (clip_margin). scan_tile.cuh's
// kMarginClip takes 2 max(c, t |w|) for every pair instead, which on the
// square branch, a below t, can be many times the slope there.
//
// (1)-(4) hold while nothing falls under float32's normal range, 2^-126.
// Tiny ranges break that (|r| |x| sqrt(w) under about 2^-63: num^2 w is a
// subnormal of a few bits, or 0, and many scores tie), and the first
// tile's bound LB, whose K pairs may lie later, must not drop a pair that
// wins such a tie. So every margin gets an absolute term A, and the norms
// are bounded from above:
//   (5) a rounding into the subnormals errs by at most 2^-150 absolute,
//       whatever the scale of its operands; a tensor core that flushed
//       every subnormal product, sum and accumulator would lose at most
//       13 Q 2^-126 < 2^-116 of a numerator. So a numerator is within
//       E(N) + 2^-112 of the plain one; num^2 w, rounded twice, within
//       2^-150 (w + 1) of its real value; the clip branch's c (2a - t)
//       and the screen's fmaf(c2, x, -c t) and x x w within 2^-150 per
//       rounding, scaled by |w| where a square is rounded before it.
//       In the square root (balanced, affine), with sqrt(a + b) <=
//       sqrt(a) + sqrt(b): A = 2^-74 sqrt(w + 1), nearly twice 2^-75
//       sqrt(w + 1) + 2^-112 sqrt(w). Damped, the screen and the exact
//       score each on either branch: A = 2^-110 max(c, t |w|) + 2^-147
//       (|w| + 2), twice the Lipschitz bound 2 max(c, t |w|) times 2^-112
//       and four times 2^-150 (|w| + 1) + 2^-149. Where x is large, A
//       rounds away in x + A: then it is under 2^-25 |x|, inside the slack
//       of a margin that is twice E(N) and at least 2^-13 |x|;
//   (6) the norms' sums of squares lose at most 2^-150 a tap where they
//       fall into the subnormals, so |r| <= sqrt(r2) + sqrt(N) 2^-75 <
//       sqrt(r2) + 2^-71, and the same for |x|: both norms take 2^-71 on
//       top (a zero range keeps Rn = 0);
//   (7) damped, where the screened a and the exact one lie on either side
//       of t, the two branches differ by the jump J = |c t - t^2 w| on top
//       of the Lipschitz bound (and K1's fold of the gains, which may
//       differ from the gain of the fold where t w > c, by at most J): A
//       takes 2 J, J computed in double and bounded from above. The
//       callers' t = c denom and w = 1 / (denom + eps) make J at most
//       c^2 eps, far under the margin except on near-silent domains.
// A pair's margin is then f Rn + A, with f and A per domain, and each
// bound is strict against a real score, so LB drops no pair that ties.
// tests/test_torch_kernels.py holds an emulation of the split numerators,
// summed in float32 in two orders, under this formula at N 17-255, and of
// the scores on ranges whose squares underflow, under f Rn + A.

#pragma once

#include "scan_tile.cuh"

#ifdef FWAV_COUNT_MARKS
// Measurement only, in a build with -DFWAV_COUNT_MARKS (scripts/
// count_wide_marks.py): the pairs the confirm scores, one counter per
// source, which fwav_wide_marks_<source>() reads and resets.
static __device__ unsigned long long g_wide_marks;
#define FWAV_WIDE_MARKS_READER(stem)                                        \
  extern "C" unsigned long long fwav_wide_marks_##stem() {                  \
    unsigned long long v = 0, zero = 0;                                     \
    cudaMemcpyFromSymbol(&v, g_wide_marks, sizeof(v));                      \
    cudaMemcpyToSymbol(g_wide_marks, &zero, sizeof(zero));                  \
    return v;                                                               \
  }
#else
#define FWAV_WIDE_MARKS_READER(stem)
#endif

namespace fwav {

constexpr int kWideMinN = 17;
constexpr int kWideMaxN = 255;

// The margin of the wide screen, of |r| |x| (see above).
__host__ __device__ __forceinline__ float wide_margin(int N) {
  const int Q = (N + 3) / 4;
  return fmaxf(0x1p-13f, (58.f * Q + 2.f * N + 1600.f) * 0x1p-24f);
}

// The chunk-count class of N: 0 up to 16 chunks (N <= 64), 1 up to 32
// (N <= 128), 2 up to 64.
__host__ __device__ constexpr int wide_class(int N) { return N <= 64 ? 0 : N <= 128 ? 1 : 2; }

// A block's shape in class kCls for a keep list of C (1 for K1): 4 warps
// over a staged tile's domains, each of MT m16 tiles (R = 8 MT ranges, the
// same for all) x NT n8 tiles (TD = 32 NT domains). A list of 8 takes MT 2,
// so that ptxas reports no spill. A thread's marks of a tile, 2 MT NT
// bits, fit one word.
template <int kCls, int C>
struct WideShape {
  static constexpr int kK = C;
  static constexpr int kMT = C > 4 ? 2 : 4;
  static constexpr int kNT = kCls == 0 ? 4 : kCls == 1 ? 2 : 1;
  static constexpr int kDG = 4;
  static constexpr int kRanges = 8 * kMT;
  static constexpr int kTileD = 8 * kNT * kDG;
  static constexpr int kThreads = 32 * kDG;
};

// The dynamic shared memory of a block of Shape at N taps, and its regions.
// The raw tile is swizzled: tap j of domain k sits at column
// k ^ wide_swizzle(j), so that the lanes that read taps 4q and 4q + 2 of
// one domain (the two halves of a quad) hit different banks.
template <class Shape>
struct WideSmem {
  static constexpr int R = Shape::kRanges, TD = Shape::kTileD, DG = Shape::kDG;
  static constexpr int K = Shape::kK;
  static constexpr int kQueue = 256;  // a warp's confirm queue, in slots
  uint2* fa;          // [R/8][Q][32] A fragments of the block's m16 tiles
  float* raw_b;       // [2][4Q][TD] the raw tiles (cp.async, double-buffered;
                      // rows past N zero)
  float* rr;          // [R][N] the block's ranges, for the confirm
  float* raw_w;       // [2][TD]
  float* raw_t;       // [2][TD]
  float* ct;          // [TD] c * t
  float* f;           // [TD] margin factor
  float* ab;          // [TD] the margin's absolute term
  float* sc;          // [TD] the scale of the screened values, sqrt(w)
  float* lbt;         // [DG][R][K] each warp's K largest x - margin of a first tile
  float* thr;         // [2][DG][R][K] each warp's K best scores after a tile
  uint32_t* cq;       // [DG][kQueue] each warp's confirm queue (wide_confirm)
  uint32_t* raw_v;    // [2][TD/4 + 1] the aligned words that hold valid
  uint8_t* v;         // [TD]
  int N, Q;

  __host__ __device__ static size_t bytes(int N) {
    const size_t Q = (N + 3) / 4;
    return sizeof(uint2) * 32 * Q * (R / 8) +
           sizeof(float) * ((size_t)8 * Q * TD + (size_t)R * N + 8 * TD + 3 * DG * R * K) +
           sizeof(uint32_t) * (DG * kQueue + 2 * (TD / 4 + 1)) + TD;
  }
  __device__ WideSmem(void* base, int n) : N(n), Q((n + 3) / 4) {
    fa = static_cast<uint2*>(base);
    raw_b = reinterpret_cast<float*>(fa + (size_t)R / 8 * Q * 32);
    rr = raw_b + (size_t)8 * Q * TD;
    raw_w = rr + (size_t)R * N;
    raw_t = raw_w + 2 * TD;
    ct = raw_t + 2 * TD;
    f = ct + TD;
    ab = f + TD;
    sc = ab + TD;
    lbt = sc + TD;
    thr = lbt + DG * R * K;
    cq = reinterpret_cast<uint32_t*>(thr + 2 * DG * R * K);
    raw_v = cq + DG * kQueue;
    v = reinterpret_cast<uint8_t*>(raw_v + 2 * (TD / 4 + 1));
  }
};

template <class Shape>
inline size_t wide_smem_bytes(int N) {
  return WideSmem<Shape>::bytes(N);
}

// The column XOR of tap j in the raw tile: bit 3 from bit 1 of j.
__device__ __forceinline__ int wide_swizzle(int j) { return (j & 2) << 2; }

// file_args for a runtime N.
__device__ __forceinline__ ScanArgs wide_file_args(ScanArgs a, int b, int N) {
  a.r_c += (size_t)b * a.M * N;
  a.bankT += (size_t)b * N * a.D;
  a.w += (size_t)b * a.D;
  a.valid += (size_t)b * a.D;
  if (a.thresh != nullptr) a.thresh += (size_t)b * a.D;
  return a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

// Start the copy of domains [t0, t0 + nt) into raw buffer `buf`: 16-byte
// copies where a row's four domains are whole and aligned, 4-byte ones
// elsewhere (the swizzle moves groups of four whole).
template <class Shape, bool kClip>
__device__ __forceinline__ void wide_issue(const WideSmem<Shape>& s, int buf, const ScanArgs& a,
                                           int t0, int nt) {
  constexpr int TD = Shape::kTileD, kQuads = TD / 4;
  float* dst = s.raw_b + (size_t)buf * 4 * s.Q * TD;
  for (int e = threadIdx.x; e < s.N * kQuads; e += blockDim.x) {
    const int j = e / kQuads, k = 4 * (e - j * kQuads);
    if (k >= nt) continue;
    const float* src = a.bankT + (size_t)j * a.D + t0 + k;
    float* d = dst + j * TD + (k ^ wide_swizzle(j));
    if (k + 4 <= nt && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(d, src);
    } else {
      for (int i = 0; i < 4 && k + i < nt; ++i) cp_async4(d + i, src + i);
    }
  }
  for (int k = threadIdx.x; k < nt; k += blockDim.x) {
    cp_async4(&s.raw_w[buf * TD + k], a.w + t0 + k);
    if (kClip) cp_async4(&s.raw_t[buf * TD + k], a.thresh + t0 + k);
  }
  // valid is bytes: copy the aligned words that hold them (every such
  // word lies inside the allocation's mapped granule)
  const uintptr_t p0 = reinterpret_cast<uintptr_t>(a.valid + t0);
  const uintptr_t base = p0 & ~uintptr_t(3);
  const int words = static_cast<int>((p0 - base + nt + 3) / 4);
  for (int k = threadIdx.x; k < words; k += blockDim.x)
    cp_async4(&s.raw_v[buf * (TD / 4 + 1) + k], reinterpret_cast<const void*>(base + 4 * k));
  asm volatile("cp.async.commit_group;");
}

// The block's ranges into shared memory, then their A fragments: lane
// (g, t) of m16 tile i and chunk q holds, for taps j = 4q + 2(t&1) and
// j + 1, in rows g (range 8i + g) and g + 8 (its reverse), hi (t < 2) or
// lo (t >= 2); load_ranges' registers 2 and 3 are these (t < 2) or zero.
// Ranges past M and taps past N are zero. A warp makes whole m16 tiles,
// chunk by chunk. Ends with a block barrier.
template <class Shape>
__device__ __forceinline__ void wide_ranges(const WideSmem<Shape>& s, const ScanArgs& a, int m0) {
  constexpr int R = Shape::kRanges;
  const int N = s.N, Q = s.Q;
  const size_t first = (size_t)m0 * N, end = (size_t)a.M * N;
  for (int e = threadIdx.x; e < R * N; e += blockDim.x)
    s.rr[e] = first + e < end ? a.r_c[first + e] : 0.f;
  constexpr int TD = Shape::kTileD;
  for (int e = threadIdx.x; e < 2 * (4 * Q - N) * TD; e += blockDim.x) {
    const int b = e / ((4 * Q - N) * TD), i = e - b * (4 * Q - N) * TD;
    s.raw_b[(size_t)(b * 4 * Q + N) * TD + i] = 0.f;  // taps past N
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = warp; i < R / 8; i += blockDim.x >> 5) {
    const float* r = s.rr + (8 * i + g) * N;
    for (int q = 0; q < Q; ++q) {
      const int j = 4 * q + 2 * (t & 1);
      const float x0 = j < N ? r[j] : 0.f, x1 = j + 1 < N ? r[j + 1] : 0.f;
      const float y0 = j < N ? r[N - 1 - j] : 0.f, y1 = j + 1 < N ? r[N - 2 - j] : 0.f;
      uint32_t hi, lo, hr, lr;
      split2(x0, x1, hi, lo);
      split2(y0, y1, hr, lr);
      s.fa[(i * Q + q) * 32 + lane] = make_uint2(t < 2 ? hi : lo, t < 2 ? hr : lr);
    }
  }
  __syncthreads();
}

// Wait for raw buffer `buf`; zero its columns past nt (a tile's ragged
// end), so that the screen splits every column unguarded; per domain
// (kP = threads / TD consecutive lanes, 1, 2 or 4, share its norm) the
// validity (past nt counts as invalid), c*t, the scale of its screened
// values, the margin factor f and the absolute term A (parts (5), (6)
// above). Returns whether every domain of the tile is valid; ends with a
// block barrier.
template <class Shape, bool kClip>
__device__ __forceinline__ bool wide_stage(const WideSmem<Shape>& s, int buf, const ScanArgs& a,
                                           int t0, int nt, float margin) {
  constexpr int TD = Shape::kTileD, kP = Shape::kThreads / TD;
  const int N = s.N;
  float* rb = s.raw_b + (size_t)buf * 4 * s.Q * TD;
  const float* rw = s.raw_w + buf * TD;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int e = threadIdx.x; e < N * (TD - nt); e += blockDim.x) {
    const int j = e / (TD - nt), k = nt + e - j * (TD - nt);
    rb[j * TD + (k ^ wide_swizzle(j))] = 0.f;
  }
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(a.valid + t0) & 3);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(s.raw_v + buf * (TD / 4 + 1)) + shift;
  const int k = threadIdx.x / kP, p = threadIdx.x % kP;
  const bool v = k < nt && vb[k] != 0;
  float b2 = 0.f;
  if (v) {
#pragma unroll 4
    for (int j = p; j < N; j += kP) {
      const float b = rb[j * TD + (k ^ wide_swizzle(j))];
      b2 = fmaf(b, b, b2);
    }
  }
#pragma unroll
  for (int off = 1; off < kP; off <<= 1) b2 += __shfl_xor_sync(0xffffffffu, b2, off);
  if (p == 0) {
    s.v[k] = v;
    s.sc[k] = k < nt ? prescale<kClip>(rw[k]) : 0.f;  // 1 for damped
    if (v) {
      const float w = rw[k], bn = sqrtf(b2) + 0x1p-71f;
      float f, ab;
      if (kClip) {
        const float th = s.raw_t[buf * TD + k], lip = 2.f * fmaxf(a.c, th * fabsf(w));
        s.ct[k] = a.c * th;
        f = margin * bn;  // d of a pair is f Rn; clip_margin takes its slope
        // the branches' jump at t, |c t - t^2 w|, from above, in double
        const double td = th, ctd = (double)a.c * td, ttw = td * td * w;
        const float jump = static_cast<float>(fabs(ctd - ttw) + 0x1p-50 * (ctd + fabs(ttw)));
        ab = fmaf(0x1p-111f, lip, fmaf(0x1p-147f, fabsf(w) + 2.f, 2.f * jump));
      } else {
        f = margin * prescale<kClip>(w) * bn;
        ab = 0x1p-74f * sqrtf(fmaxf(w, 0.f) + 1.f);
      }
      s.f[k] = fmaxf(f, kMarginFloor);
      s.ab[k] = ab;
    }
  }
  return __syncthreads_count(v) == static_cast<int>(blockDim.x);
}

// The K largest of a quad's values, from each lane's sorted K largest of
// its own (disjoint) values: every lane ends with the quad's list.
template <int K>
__device__ __forceinline__ void quad_topk(float (&l)[K]) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    float o[K];
#pragma unroll
    for (int q = 0; q < K; ++q) o[q] = __shfl_xor_sync(0xffffffffu, l[q], off);
#pragma unroll
    for (int q = 0; q < K; ++q) insert_bound<K>(l, o[q]);
  }
}

// The K-th largest of the DG warps' lists of K for a range (`lists` at its
// first warp's, `stride` floats apart).
template <int DG, int K>
__device__ __forceinline__ float kth_of_lists(const float* lists, int stride) {
  float l[K];
#pragma unroll
  for (int q = 0; q < K; ++q) l[q] = lists[q];
#pragma unroll 1
  for (int w = 1; w < DG; ++w)
#pragma unroll
    for (int q = 0; q < K; ++q) insert_bound<K>(l, lists[w * stride + q]);
  return l[K - 1];
}

// The margin of a damped pair whose screened |num| is a, within d (twice
// the numerators' error bound, f Rn) of the exact one: the score's
// steepest slope within d of a, 2c on the clip branch and 2 |w| (a + d) on
// the square one, times d, and the absolute term A (parts (5)-(7)).
__device__ __forceinline__ float clip_margin(float a, float d, float w, float t, float c2,
                                             float ab) {
  const float slope = fmaxf(a + d > t ? c2 : 0.f, a - d <= t ? 2.f * fabsf(w) * (a + d) : 0.f);
  return fmaf(slope, d, ab);
}

// The screen of one staged tile by warp dg: per chunk the B fragments of
// its NT n8 tiles (from nt0), split from the raw tile as split_tile does
// (lane (g, t) holds b0 = hi of taps j, j+1 of domain 8n + g and b1 = lo of
// them, t < 2, or 0), then the MMAs of its MT m16 tiles x NT n8 tiles. The
// bank rows are not prescaled: balanced and affine scale the screened
// value max(|num_o|, |num_m|) by sqrt(w) instead (one product a pair; the
// same bound, scan_tile.cuh's prescale error moving after the sum).
// Then per range two bounds that a pick must reach, and bit
// 2 NT mt + 2 nt + col of mask for each valid pair that can reach both
// (a pair's margin is f Rn + A):
//   * LB, the K-th largest x - margin of the range's pairs in the warp's
//     part of the tile (each thread's K largest, merged over the quad; in
//     a block's first tile, over the DG warps too through shared memory):
//     K pairs score at least LB, so a pair with x + margin < LB scores
//     strictly less than K others and cannot be picked, even where the K
//     lie later in the tile (the margins hold at any scale: part (5));
//   * S, screen_threshold of the K-th best confirmed score of the tiles
//     before (the warps' quad lists after the last confirm, merged the
//     same way): mark where x + margin > S, as a later pair loses a tie.
//     A zero range's scores all tie, so its ties must fall to the lower
//     index: in the first tile it marks the first K valid pairs of the
//     thread, and later all of them until the thread's own list is full,
//     then none.
template <class Shape, bool kClip, class Keep>
__device__ __forceinline__ void wide_screen(const WideSmem<Shape>& s, int buf, int dg, bool masked,
                                            bool first_tile,
                                            const float (&Rn)[Shape::kMT], const Keep& keep,
                                            float c2, uint32_t& mask) {
  constexpr int MT = Shape::kMT, NT = Shape::kNT, R = Shape::kRanges, TD = Shape::kTileD;
  constexpr int DG = Shape::kDG, K = Keep::kRank;
  static_assert(2 * MT * NT <= 32, "a thread's marks fit one word");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, Q = s.Q, N = s.N;
  mask = 0u;
  const int nt0 = dg * NT, h2 = 2 * (t & 1);
  const uint32_t upper = t < 2 ? 0xffffffffu : 0u;  // A's registers 2, 3; B's lo
  const float* rb = s.raw_b + (size_t)buf * 4 * Q * TD;
  int col[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    col[nt] = (8 * (nt0 + nt) + g) ^ (4 * h2);  // the swizzle of taps 4q + h2, + 1
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const uint2* fa = s.fa + lane;
#pragma unroll 2
  for (int q = 0; q < Q; ++q) {
    const float* rj = rb + (4 * q + h2) * TD;
    uint2 B[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t hi, lo;
      split2(rj[col[nt]], rj[TD + col[nt]], hi, lo);
      B[nt] = make_uint2(hi, lo & upper);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint2 A = fa[(mt * Q + q) * 32];
      const uint32_t a4[4] = {A.x, A.y, A.x & upper, A.y & upper};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a4, B[nt]);
    }
  }
  const float* rw = s.raw_w + buf * TD;
  const float* rt = s.raw_t + buf * TD;
  // the screened values in place of the numerators (-inf where invalid),
  // and each pair's margin in place of num_m
  float lb[MT][K];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < K; ++q) lb[mt][q] = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int k = 8 * (nt0 + nt) + 2 * t;
    const float2 f = *reinterpret_cast<const float2*>(&s.f[k]);
    const float2 ab = *reinterpret_cast<const float2*>(&s.ab[k]);
    float2 w = make_float2(0.f, 0.f), th = w, ct = w, sc = w;
    if (kClip) {
      w = *reinterpret_cast<const float2*>(&rw[k]);
      th = *reinterpret_cast<const float2*>(&rt[k]);
      ct = *reinterpret_cast<const float2*>(&s.ct[k]);
    } else {
      sc = *reinterpret_cast<const float2*>(&s.sc[k]);
    }
    const bool v0 = !masked || s.v[k] != 0, v1 = !masked || s.v[k + 1] != 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float x0 = screen<kClip>(acc[mt][nt][0], acc[mt][nt][2], w.x, th.x, ct.x, c2);
      float x1 = screen<kClip>(acc[mt][nt][1], acc[mt][nt][3], w.y, th.y, ct.y, c2);
      float m0, m1;
      if (kClip) {
        m0 = clip_margin(fmaxf(fabsf(acc[mt][nt][0]), fabsf(acc[mt][nt][2])), f.x * Rn[mt],
                         w.x, th.x, c2, ab.x);
        m1 = clip_margin(fmaxf(fabsf(acc[mt][nt][1]), fabsf(acc[mt][nt][3])), f.y * Rn[mt],
                         w.y, th.y, c2, ab.y);
      } else {
        x0 *= sc.x;
        x1 *= sc.y;
        m0 = fmaf(f.x, Rn[mt], ab.x);
        m1 = fmaf(f.y, Rn[mt], ab.y);
      }
      acc[mt][nt][0] = v0 ? x0 : -CUDART_INF_F;
      acc[mt][nt][1] = v1 ? x1 : -CUDART_INF_F;
      acc[mt][nt][2] = m0;
      acc[mt][nt][3] = m1;
      if (v0) insert_bound<K>(lb[mt], x0 - m0);
      if (v1) insert_bound<K>(lb[mt], x1 - m1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) quad_topk<K>(lb[mt]);
  if (first_tile) {
    if (t == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < K; ++q) s.lbt[(dg * R + 8 * mt + g) * K + q] = lb[mt][q];
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = 8 * mt + g;
    float LB = lb[mt][K - 1], S = -CUDART_INF_F;
    if (first_tile) {
      LB = kth_of_lists<DG, K>(s.lbt + row * K, R * K);
    } else {
      const float T = kth_of_lists<DG, K>(s.thr + ((buf ^ 1) * DG * R + row) * K, R * K);
      // a zero range: nothing later enters a full list (its margin is A)
      S = Rn[mt] > 0.f ? screen_threshold<kClip>(T, Rn[mt])
          : keep.entry(mt, K - 1) == -CUDART_INF_F ? -CUDART_INF_F : CUDART_INF_F;
    }
    const bool zero_first = first_tile && Rn[mt] == 0.f;
    int first = 0;  // a zero range's valid pairs so far (first tile)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int col2 = 0; col2 < 2; ++col2) {
        const float x = acc[mt][nt][col2];
        if (x == -CUDART_INF_F) continue;  // invalid
        const float hi = x + acc[mt][nt][2 + col2];
        const bool mark = zero_first ? first++ < K : hi >= LB && hi > S;
        if (mark) mask |= 1u << (2 * NT * mt + 2 * nt + col2);
      }
    }
  }
}

// Confirm the marked pairs of one staged tile by warp dg: the plain
// version's float32 numerators (rounded product by product, summed tap by
// tap), scored by the policy, and kept by their owners, each range's in
// increasing domain order. A lane's marks are its own pairs, and they lie
// unevenly over the lanes, so the warp queues them in shared memory,
// kQueue at a time, and deals them out over its 32 lanes: it takes
// ceil(marks / 32) pair-times, not its busiest lane's count. Each lane
// then keeps its own marks' scores in order (a lane's slots follow its
// bits, and the windows go in order).
template <class Shape, class Keep>
__device__ __forceinline__ void wide_confirm(const WideSmem<Shape>& s, int buf, int dg, int t0,
                                             uint32_t mask, Keep& keep) {
  constexpr int TD = Shape::kTileD, NT = Shape::kNT;
  const int lane = threadIdx.x & 31, N = s.N, nt0 = dg * NT;
  const float* rb = s.raw_b + (size_t)buf * 4 * s.Q * TD;
  const float* rw = s.raw_w + buf * TD;
  const float* rt = s.raw_t + buf * TD;
  uint32_t* q = s.cq + dg * WideSmem<Shape>::kQueue;
  // the lane's first slot: the marks of the lanes before it
  const int own = __popc(mask);
  int end = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, end, off);
    if (lane >= off) end += y;
  }
  const int total = __shfl_sync(0xffffffffu, end, 31);
  if (total == 0) return;
  // a mark's m16 tile and domain, from its owner lane and bit
  const auto domain_of = [&](int owner, int bit, int& mt) {
    mt = bit / (2 * NT);
    const int b = bit - 2 * NT * mt;
    return 8 * (nt0 + (b >> 1)) + 2 * (owner & 3) + (b & 1);
  };
  constexpr int kQ = WideSmem<Shape>::kQueue;
  const int first = end - own;
  for (int w0 = 0; w0 < total; w0 += kQ) {
    int slot = first;
    for (uint32_t m = mask; m; m &= m - 1, ++slot)
      if (slot >= w0 && slot < w0 + kQ) q[slot - w0] = lane << 5 | (__ffs(m) - 1);
    __syncwarp();
    const int n = min(kQ, total - w0);
    for (int i = lane; i < n; i += 32) {
      const int owner = q[i] >> 5;
      int mt;
      const int k = domain_of(owner, q[i] & 31, mt);
      const float* r = s.rr + (8 * mt + (owner >> 2)) * N;
#ifdef FWAV_COUNT_MARKS
      atomicAdd(&g_wide_marks, 1ull);
#endif
      float no = __fmul_rn(r[0], rb[k]);
      float nm = __fmul_rn(r[N - 1], rb[k]);
#pragma unroll 16
      for (int j = 1; j < N; ++j) {
        const float x = rb[j * TD + (k ^ wide_swizzle(j))];
        no = __fadd_rn(no, __fmul_rn(r[j], x));
        nm = __fadd_rn(nm, __fmul_rn(r[N - 1 - j], x));
      }
      q[i] = __float_as_uint(keep.exact(no, nm, rw[k], rt[k]));
    }
    __syncwarp();
    slot = first;
    for (uint32_t m = mask; m; m &= m - 1, ++slot) {
      if (slot < w0 || slot >= w0 + kQ) continue;
      int mt;
      const int k = domain_of(lane, __ffs(m) - 1, mt);
      const float score = __uint_as_float(q[slot - w0]);
#pragma unroll
      for (int i = 0; i < Shape::kMT; ++i)  // static indices: the lists stay in registers
        if (i == mt) keep.keep(i, score, t0 + k);
    }
    __syncwarp();  // the queue is free for the next window
  }
}

// The domain sweep of one block over [d0, d1) for its R ranges; warp dg's
// keep holds them over its slice of every tile's domains. After each tile's
// confirm a warp leaves its quads' K best scores (quad_topk of the
// threads' lists) in shared memory for the next tile's screen, double-
// buffered by the tile's parity. `smem` holds wide_smem_bytes<Shape>(N).
template <class Shape, bool kClip, class Keep>
__device__ __forceinline__ void wide_scan(void* smem, const ScanArgs& a, int N, int d0, int d1,
                                          Keep& keep) {
  constexpr int MT = Shape::kMT, NT = Shape::kNT, R = Shape::kRanges, TD = Shape::kTileD;
  constexpr int DG = Shape::kDG, K = Keep::kRank;
  static_assert(K == Shape::kK, "the block's lists are the keep's");
  const WideSmem<Shape> s(smem, N);
  const int dg = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  if (d0 < d1) wide_issue<Shape, kClip>(s, 0, a, d0, min(TD, d1 - d0));
  wide_ranges(s, a, blockIdx.x * R);
  float Rn[MT];
  uint32_t mask;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* r = s.rr + (8 * mt + g) * N;
    float r2 = 0.f;
    bool zero = true;
    for (int j = 0; j < N; ++j) {
      r2 = fmaf(r[j], r[j], r2);
      zero = zero && r[j] == 0.f;
    }
    Rn[mt] = zero ? 0.f : sqrtf(r2) + 0x1p-71f;  // 0 only for a zero range; part (6)
  }
  const float c2 = 2.f * a.c, margin = wide_margin(N);
  int buf = 0;
  for (int t0 = d0; t0 < d1; t0 += TD, buf ^= 1) {
    const int nt_in = min(TD, d1 - t0);
    const bool all = wide_stage<Shape, kClip>(s, buf, a, t0, nt_in, margin);
    const int t1 = t0 + TD;
    if (t1 < d1) wide_issue<Shape, kClip>(s, buf ^ 1, a, t1, min(TD, d1 - t1));
    wide_screen<Shape, kClip>(s, buf, dg, !all, t0 == d0, Rn, keep, c2, mask);
    wide_confirm<Shape>(s, buf, dg, t0, mask, keep);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float l[K];
#pragma unroll
      for (int q = 0; q < K; ++q) l[q] = keep.entry(mt, q);
      quad_topk<K>(l);
      if ((lane & 3) == 0)
#pragma unroll
        for (int q = 0; q < K; ++q) s.thr[((buf * DG + dg) * R + 8 * mt + g) * K + q] = l[q];
    }
  }
  __syncthreads();  // the buffer is free for the caller's merge
}

}  // namespace fwav
