// K4: the staged window refine around coarse lobes, on Hopper.
//
// It has no Pallas counterpart. It replaces XLA's fusion of
// refine_from_lobes (fwav_tpu/ops/search.py:470), which the JAX package
// compiles into its encode core in three places: the staged single-shot
// refine (fwav_tpu/models/encode.py:290-347), the whole-file global pass's
// lax.map with its lobe merge (:660-760, the merge at :738-744), and
// coarse_refine_search (fwav_tpu/ops/search.py:440). The port ran the same
// function as eager torch ops: some 30,000 launches for the 100 s pass.
//
// For file b, range m and its C coarse lobes L (rows of the stride-
// subsampled bank, -1 for none), with W = max(2, stride + stride/4) and
// n_valid the file's valid bank rows, last = max(n_valid - 1, 0):
//   the window of L starts at s = clamp(L*stride - W/2, 0, max(n_valid - W, 0));
//   staged (C == 1 and stride >= 32): rows min(s + 16k, last), k <= W/16,
//     are scored and the first best is the centre; then rows
//     clamp(centre - 8 + 4j, 0, last), j < 5, the same way; (8 alone, k <=
//     W/8, for W < 64); then the dense window of st + 2 rows (st the last
//     step) from clamp(centre - (st + 2)/2, 0, max(n_valid - st - 2, 0));
//   dense (otherwise): all C*W rows s_c + t, in (lobe, position) order.
// A row scores -inf where its lobe is -1 or it is at or past n_valid (a
// range with no lobe still carries a centre through the stages: the first
// of all -inf samples); it is read at min(row, D - 1). A row's score is
// ops/search.py _window_gains: the row's mean (its taps summed left to
// right, then a true division by N), its centred energy + 1e-12, the
// numerators of the centred range and of its reverse, the balanced, affine
// or damped weight (and clip threshold), each orientation's gain, and the
// larger (the mirror only where strictly larger). The output is the first
// best row of the last stage, clamped to D - 1, and its score.
// per_lobe (the global pass): each lobe column is refined alone as a
// one-lobe window (so the descent runs at stride >= 32), and a later column
// takes the range only with a strictly higher score: the earlier lobe wins
// ties; row 0 and -inf where no column scores.
//
// Every operation is an explicit round-to-nearest intrinsic in the plain
// version's order (no FMA contraction), so the kernel computes bit for bit
// what ops/kernels.py staged_refine_ref computes on the card.
//
// What bounds it: the CUDA-core operations of the scored rows, ~8N + 20 a
// row (a correctly rounded division counted as one), over the bytes: the
// bank, ranges and lobes are read once in principle, but a scored row is N
// taps at an address that follows from the data (the descent's samples 16
// rows apart, neighbouring ranges with unrelated lobes), so a warp's load
// touches up to 32 sectors. The first design is the simple one: one thread
// walks one (file, range), every lobe and stage of it, in one loop over
// rows (one inlined copy of the row's score), with the range's centred
// taps in registers (N <= 16; wider ranges, N at run time, read them again
// through the read-only path) and the bank rows read through the read-only
// path, 16 bytes at a time where N is a multiple of 4. Measured on an H100
// (PERF.md): 21-38% of the bound up to 16 taps (1.18 ms for the 100 s
// pass), 1.3% at 32 taps, where a 10 s file's 14,336 ranges fill 112
// blocks and each thread's loads wait on one another. A stack of files is
// one launch, the file the slowest grid axis, n_valid read from device
// memory, one int32 per file: a launch captured in a CUDA graph serves
// every length of its shape bucket.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
// Blocks an SM must hold (__launch_bounds__): with the thread count alone
// ptxas kept the wide kernels (N at run time) at 40 registers and spilled
// around the division's slow path; 8 blocks cap them at 64, unspilled
// (-Xptxas -v on an H100's toolkit: 43-64 registers, no spill).
constexpr int kMinBlocks = 8;

enum Objective { kBalanced = 0, kAffine = 1, kDamped = 2 };

// The centred range of one thread. N > 0: its taps in registers. N == 0
// (17-255 taps, n at run time): the row is read again through the
// read-only path and centred on each use, to the same float each time.
template <int N>
struct Range {
  float rc[N];
  __device__ __forceinline__ Range(const float* __restrict__ r, int) {
#pragma unroll
    for (int j = 0; j < N; ++j) rc[j] = __ldg(r + j);
    float s = rc[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s = __fadd_rn(s, rc[j]);
    const float mean = __fdiv_rn(s, static_cast<float>(N));
#pragma unroll
    for (int j = 0; j < N; ++j) rc[j] = __fsub_rn(rc[j], mean);
  }
  __device__ __forceinline__ int n() const { return N; }
  __device__ __forceinline__ float at(int j) const { return rc[j]; }
};

template <>
struct Range<0> {
  const float* __restrict__ r;
  int len;
  float mean;
  __device__ __forceinline__ Range(const float* __restrict__ row, int n) : r(row), len(n) {
    float s = __ldg(r);
    for (int j = 1; j < n; ++j) s = __fadd_rn(s, __ldg(r + j));
    mean = __fdiv_rn(s, static_cast<float>(n));
  }
  __device__ __forceinline__ int n() const { return len; }
  __device__ __forceinline__ float at(int j) const { return __fsub_rn(__ldg(r + j), mean); }
};

// The taps of one bank row: in registers for N > 0 (16-byte loads where
// `vec`: N a multiple of 4 and the bank 16-byte aligned), else read again.
template <int N>
struct Row {
  float t[N];
  __device__ __forceinline__ Row(const float* __restrict__ p, bool vec) {
    if constexpr (N % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(p + j));
          t[j] = x.x, t[j + 1] = x.y, t[j + 2] = x.z, t[j + 3] = x.w;
        }
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = __ldg(p + j);
  }
  __device__ __forceinline__ float at(int j) const { return t[j]; }
};

template <>
struct Row<0> {
  const float* __restrict__ p;
  __device__ __forceinline__ Row(const float* __restrict__ row, bool) : p(row) {}
  __device__ __forceinline__ float at(int j) const { return __ldg(p + j); }
};

// What a row's score reads: the thread's range (held by value: a
// reference would give it an address, and so a stack frame), its file's
// bank, |s_clip| and whether the rows take 16-byte loads.
template <int N>
struct Ctx {
  Range<N> range;
  const float* __restrict__ bank;  // the file's (D, n) rows
  float c;
  bool vec;
};

// ops/search.py _window_gains of one bank row (row < D) for the range.
template <int N, int OBJ>
__device__ __forceinline__ float row_gain(const Ctx<N>& x, long long row) {
  const Range<N>& R = x.range;
  const int n = R.n();
  const Row<N> t(x.bank + row * n, x.vec);
  float s = t.at(0);
#pragma unroll
  for (int j = 1; j < (N > 0 ? N : n); ++j) s = __fadd_rn(s, t.at(j));
  const float mean = __fdiv_rn(s, static_cast<float>(n));
  float d = __fsub_rn(t.at(0), mean);
  float den = __fmul_rn(d, d);
  float no = __fmul_rn(d, R.at(0));
  float nm = __fmul_rn(d, R.at(n - 1));
#pragma unroll
  for (int j = 1; j < (N > 0 ? N : n); ++j) {
    d = __fsub_rn(t.at(j), mean);
    den = __fadd_rn(den, __fmul_rn(d, d));
    no = __fadd_rn(no, __fmul_rn(d, R.at(j)));
    nm = __fadd_rn(nm, __fmul_rn(d, R.at(n - 1 - j)));
  }
  den = __fadd_rn(den, 1e-12f);
  const float w =
      OBJ == kBalanced
          ? __fdiv_rn(__fsub_rn(__fsub_rn(den, 1e-12f),
                                __fmul_rn(__fmul_rn(static_cast<float>(n), mean), mean)),
                      __fmul_rn(den, den))
          : __fdiv_rn(1.f, den);
  float so = __fmul_rn(__fmul_rn(no, no), w);
  float sm = __fmul_rn(__fmul_rn(nm, nm), w);
  if (OBJ == kDamped) {
    const float th = __fmul_rn(x.c, __fsub_rn(den, 1e-12f));
    const float ao = fabsf(no), am = fabsf(nm);
    if (ao > th) so = __fmul_rn(x.c, __fsub_rn(__fmul_rn(2.f, ao), th));
    if (am > th) sm = __fmul_rn(x.c, __fsub_rn(__fmul_rn(2.f, am), th));
  }
  return sm > so ? sm : so;
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int N, int OBJ>
__global__ void __launch_bounds__(kThreads, kMinBlocks) staged_refine_kernel(
    const float* __restrict__ ranges, int M, int n, const float* __restrict__ bank,
    long long D, const int* __restrict__ lobes, int C, long long lobe_stride_b,
    long long lobe_stride_m, long long lobe_stride_c, const int* __restrict__ n_valid_of,
    int stride, int W, int per_lobe, float c, bool vec, int* __restrict__ out_idx,
    float* __restrict__ out_score) {
  const int file = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const long long fm = static_cast<long long>(file) * M + m;  // the range's row in the stack
  const long long nv = n_valid_of[file];
  const Ctx<N> x{Range<N>(ranges + fm * n, n), bank + static_cast<long long>(file) * D * n,
                 c, vec};
  const int* my = lobes + file * lobe_stride_b + m * lobe_stride_m;
  const long long last = nv - 1 > 0 ? nv - 1 : 0;
  const long long w_hi = nv - W > 0 ? nv - W : 0;  // the last window start
  constexpr long long kNone = 0x7fffffffffffffffLL;
  // A pass refines one lobe column (per_lobe) or all C of them; it is the
  // descent (stride >= 32, one lobe: its samples, the finer samples where
  // W >= 64, the dense final window) or dense (one stage per lobe). Every
  // stage walks rows first + step*k, k < count, clamped to [lo, hi], with
  // one call site of row_gain (one inlined copy, few registers).
  const bool descent = stride >= 32 && (per_lobe || C == 1);
  const int st0 = W >= 64 ? 16 : 8;
  const int stages = descent ? (W >= 64 ? 3 : 2) : (per_lobe ? 1 : C);
  float best = -CUDART_INF_F;
  long long row = 0;
  for (int pass = 0; pass < (per_lobe ? C : 1); ++pass) {
    float b = -CUDART_INF_F;
    long long brow = 0;  // the pass's pick: the first best, or the first row
    for (int g = 0; g < stages; ++g) {
      const int L = my[(descent ? pass : pass + g) * lobe_stride_c];
      const bool ok = L >= 0;
      const long long start = clampll(static_cast<long long>(L) * stride - W / 2, 0, w_hi);
      long long first = start, lo = -1, hi = kNone;
      int step = 1, count = W;
      if (descent) {
        if (g == 0) {  // samples from the window's start, clipped to last
          step = st0, count = W / st0 + 1, hi = last;
        } else if (g == 1 && W >= 64) {  // centre +/- 8 at step 4, clipped to [0, last]
          first = brow - st0 / 2, step = 4, count = st0 / 4 + 1, lo = 0, hi = last;
        } else {  // the dense final window of st + 2 rows around the centre
          count = (W >= 64 ? 4 : st0) + 2;
          const long long hi2 = nv - count > 0 ? nv - count : 0;
          first = clampll(brow - count / 2, 0, hi2);
        }
        b = -CUDART_INF_F;  // each stage keeps its own first best
        brow = clampll(first, lo, hi);
      } else if (g == 0) {
        brow = start;  // an all -inf window picks its first row
      }
      for (int k = 0; ok && k < count; ++k) {
        const long long r = clampll(first + static_cast<long long>(step) * k, lo, hi);
        if (r >= nv) continue;
        const float s = row_gain<N, OBJ>(x, r < D - 1 ? r : D - 1);
        if (s > b) b = s, brow = r;
      }
    }
    const long long pick = brow < D - 1 ? brow : D - 1;
    if (!per_lobe || b > best) best = b, row = pick;  // strict: the earlier lobe wins ties
  }
  out_idx[fm] = static_cast<int>(row);
  out_score[fm] = best;
}

}  // namespace

#define FWAV_EACH_N(CASE)                                                  \
  CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11)        \
  CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

extern "C" {

// A stack of B files: ranges (B, M, N) float32 contiguous (raw, not
// centred); bank (B, D, N) float32 contiguous; lobes int32, lobe `slot` of
// range m of file b at lobes[b * lobe_stride_b + m * lobe_stride_m + slot *
// lobe_stride_c], C >= 1 slots; n_valid (B,) int32 on the device; objective
// 0 balanced, 1 affine, 2 damped; per_lobe 0 or 1 (see above). Writes idx
// (B, M) int32 and score (B, M) float32. Returns cudaGetLastError() after
// the launch.
int fwav_staged_refine(const float* ranges, int B, int M, int N, const float* bank,
                       long long D, const int* lobes, int C, long long lobe_stride_b,
                       long long lobe_stride_m, long long lobe_stride_c,
                       const int* n_valid, int stride, int objective, int per_lobe,
                       float s_clip, int* idx, float* score, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || M < 1 || N < 4 || N > 255 || D < 1 || D > (1LL << 31) ||
      C < 1 || stride < 1 || stride > (1 << 24) || objective < 0 || objective > 2 ||
      (per_lobe != 0 && per_lobe != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = stride + stride / 4 > 2 ? stride + stride / 4 : 2;
  const bool vec = N % 4 == 0 && reinterpret_cast<size_t>(bank) % 16 == 0;
  const float c = s_clip < 0.f ? -s_clip : s_clip;
  const dim3 blocks((M + kThreads - 1) / kThreads, B);
  const int n_key = N <= 16 ? N : 0;
  switch (n_key * 4 + objective) {
#define FWAV_CASE_OBJ(K, OBJ)                                                       \
  case K * 4 + OBJ:                                                                 \
    staged_refine_kernel<K, OBJ><<<blocks, kThreads, 0, st>>>(                      \
        ranges, M, N, bank, D, lobes, C, lobe_stride_b, lobe_stride_m, lobe_stride_c, \
        n_valid, stride, W, per_lobe, c, vec, idx, score);                          \
    break;
#define FWAV_CASE(K) \
  FWAV_CASE_OBJ(K, kBalanced) FWAV_CASE_OBJ(K, kAffine) FWAV_CASE_OBJ(K, kDamped)
    FWAV_EACH_N(FWAV_CASE)
    FWAV_CASE(0)
#undef FWAV_CASE
#undef FWAV_CASE_OBJ
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
