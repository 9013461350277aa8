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
// version's order (no FMA contraction), so the kernels compute bit for bit
// what ops/kernels.py staged_refine_ref computes on the card.
//
// The design, measured against a first one (a thread a range) on an H100
// (PERF.md section 6): the work splits in two kernels, and a range's rows
// go to lanes, not a thread over ranges.
//
// The table (staged_stats_kernel, one thread a bank row of the stack):
// what a row's score needs of the row alone, in the plain version's
// order: [mean, w, th, 0], the mean, the weight w (balanced (den - eps -
// N mean^2) / den^2, affine and damped 1 / den: the two divisions) and the
// damped threshold c (den - eps), 16 bytes a row. (A table of the rows'
// centred taps scored dense windows of up to 16 taps a few percent faster
// on an H100, at a second copy of the bank in memory: not kept.)
// The scoring then does per (range, row) the centring, the two
// numerators, the gains, the clip and the fold: no division. It pays where
// a bank row is scored many times from a row read once into a warp: dense
// windows (160 scored rows a bank row at 60 s damped) and every range over
// 16 taps. A descent of up to 16 taps reads each sample as a scattered
// sector that holds the whole row anyway, and a table there adds a second
// scattered read a row (the pass 1.9 ms from a table against 1.17 in
// place): there the kernel computes the row's terms in place (no table
// given), and ops/kernels.py makes none (staged_uses_table).
//
// The scoring kernels walk a range's rows with lanes: a group of G lanes
// scores one pass of one range, lane j the rows k = j + G*i of each stage
// in the plain version's order; each lane keeps its first best and the
// group reduces (score, key) by shuffles, a higher score winning and on
// equal scores the lower key (the row's position in the plain version's
// order), which is the sequential first best. G, the fastest of 1, 4, 8
// and 16 measured on an H100 at each shape, is 4 (N < 8) or 8 for a
// dense window of up to 16 taps (the warp's 32 / G ranges read their rows
// side by side), 1 for such a descent (a thread a pass: its 3 stages have
// 11 + 5 + 6 rows at W = 160), and 32 for ranges over 16 taps. With
// per_lobe the columns of a range go to groups side by side in one warp
// (4 threads, each a column's descent, in the global pass), merged by
// (score, column). Up to 16 taps (staged_refine_kernel<N>) a lane holds
// the centred range in registers and reads its row with 16-byte loads.
// From 17 to 255 taps (staged_refine_kernel_wide, N at run time) a warp
// takes one range: its centred taps in shared memory, and each round's 32
// rows copied there by cp.async, every row's taps by consecutive lanes,
// double-buffered over the rounds of a stage and the lobes of a pass, read
// back with an odd row stride (N | 1 floats: no bank conflict).
//
// What bounds it: the rows' bytes more than their arithmetic. A scored
// row is read from L2 or HBM as whole sectors (no two ranges share a
// window, and no tensor core would see reuse: the numerators stay on the
// CUDA cores in the plain version's order); the descent's samples are
// scattered sectors of a bank larger than L2 in the 100 s pass, and the
// dense windows re-read 4 x 160 rows per range. Measured on an H100: the
// descent within a few percent of the first design, dense windows 1.25-2.0x
// faster, 32 taps 2.5x (balanced) and 9.3x (damped).
//
// A stack of files is one launch, the file the slowest grid axis, n_valid
// read from device memory, one int32 per file: a launch captured in a CUDA
// graph serves every length of its shape bucket.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
// Blocks an SM must hold (__launch_bounds__): with the thread count alone
// ptxas kept some kernels at 40 registers and spilled around a division's
// slow path (-Xptxas -v on an H100's toolkit); 8 blocks let them have 64,
// unspilled. The 4-tap descent without a table waits on scattered loads
// and runs faster the more warps an SM holds (measured on an H100, PERF.md
// section 6): 10 blocks, 48 registers.
constexpr int kMinBlocks = 8;
constexpr int kDescentBlocks = 10;
constexpr int kNoKey = 0x7fffffff;  // a lane's key while it has no pick
constexpr long long kNoClamp = 0x7fffffffffffffffLL;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kEps = 1e-12f;

enum Objective { kBalanced = 0, kAffine = 1, kDamped = 2 };

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// --- the table ----------------------------------------------------------------

// One thread a bank row of the stack (rows = B * D): _window_gains' terms
// of the row alone, in its order.
__global__ void __launch_bounds__(kThreads) staged_stats_kernel(
    const float* __restrict__ bank, long long rows, int n, int objective, float c,
    float4* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const float* __restrict__ p = bank + row * n;
  float s = __ldg(p);
  for (int j = 1; j < n; ++j) s = __fadd_rn(s, __ldg(p + j));
  const float mean = __fdiv_rn(s, static_cast<float>(n));
  float d = __fsub_rn(__ldg(p), mean);
  float den = __fmul_rn(d, d);
  for (int j = 1; j < n; ++j) {
    d = __fsub_rn(__ldg(p + j), mean);
    den = __fadd_rn(den, __fmul_rn(d, d));
  }
  den = __fadd_rn(den, kEps);
  const float w =
      objective == kBalanced
          ? __fdiv_rn(__fsub_rn(__fsub_rn(den, kEps),
                                __fmul_rn(__fmul_rn(static_cast<float>(n), mean), mean)),
                      __fmul_rn(den, den))
          : __fdiv_rn(1.f, den);
  const float th = objective == kDamped ? __fmul_rn(c, __fsub_rn(den, kEps)) : 0.f;
  out[row] = make_float4(mean, w, th, 0.f);
}

// --- the scoring ----------------------------------------------------------------

struct Args {
  const float* ranges;  // (B, M, n), raw
  const float* bank;    // (B, D, n)
  const float4* table;  // (B, D) [mean, w, th, 0], or none (N <= 16)
  const int* lobes;
  const int* n_valid;   // (B,)
  int* out_idx;
  float* out_score;
  long long D, lobe_sb, lobe_sm, lobe_sc;
  int M, n, C, stride, W, per_lobe;
  int G;   // lanes of a group: one pass of one range
  int GR;  // groups of a range (per_lobe: its columns side by side)
  float c;
  bool vec;  // the bank takes 16-byte loads (n a multiple of 4, aligned)
};

// One file's rows: n_valid, the last valid row, the last window start.
struct Geo {
  long long nv, last, w_hi, D;
  int stride, W;
  __device__ __forceinline__ long long start(int L) const {
    return clampll(static_cast<long long>(L) * stride - W / 2, 0, w_hi);
  }
};

// A lane's first best so far: score s at key k (kNoKey: none) and its row v.
struct Pick {
  float s;
  int k, v;
};

__device__ __forceinline__ void keep_better(Pick& p, float s, int k, int v) {
  if (s > p.s || (s == p.s && k < p.k)) p.s = s, p.k = k, p.v = v;
}

// The best pick of the lanes lane ^ o, o = hi/2, ..., lo (powers of 2):
// the higher score, on equal scores the lower key; every lane gets it.
__device__ __forceinline__ Pick reduce(Pick p, int lo, int hi) {
  for (int o = hi >> 1; o >= lo; o >>= 1) {
    const float s = __shfl_xor_sync(kAll, p.s, o);
    const int k = __shfl_xor_sync(kAll, p.k, o);
    const int v = __shfl_xor_sync(kAll, p.v, o);
    keep_better(p, s, k, v);
  }
  return p;
}

// One orientation-folded gain from the two numerators (row_gain's tail).
template <int OBJ>
__device__ __forceinline__ float fold(float no, float nm, float w, float th, float c) {
  float so = __fmul_rn(__fmul_rn(no, no), w);
  float sm = __fmul_rn(__fmul_rn(nm, nm), w);
  if (OBJ == kDamped) {
    const float ao = fabsf(no), am = fabsf(nm);
    if (ao > th) so = __fmul_rn(c, __fsub_rn(__fmul_rn(2.f, ao), th));
    if (am > th) sm = __fmul_rn(c, __fsub_rn(__fmul_rn(2.f, am), th));
  }
  return sm > so ? sm : so;
}

// One scan of a pass: a descent stage's samples, rows clamp(first + step*k,
// lo, hi) for k < count (g0 = 0, g1 = 1), or (dense) the windows of lobes
// g0 .. g1 - 1, rows start(L_g) + k for k < count = W. The key of a row is
// (g - g0) * count + k. ok: the pass's lobe is live (the descent's; a dense
// scan reads each lobe's).
struct Stage {
  long long first, lo, hi;
  int step, count, g0, g1;
  bool dense, ok;
};

// The row of key k of stage s (k = 0 where no row scored: the plain
// version's argmax of all -inf).
__device__ __forceinline__ long long stage_row(const Stage& s, int k, const Geo& geo,
                                               const int* my, long long lobe_sc) {
  if (k == kNoKey) k = 0;
  long long first = s.first;
  if (s.dense) {
    const int g = s.g0 + k / s.count;
    k -= (g - s.g0) * s.count;
    first = geo.start(s.ok ? __ldg(my + g * lobe_sc) : -1);
  }
  return clampll(first + static_cast<long long>(s.step) * k, s.lo, s.hi);
}

// The walk of one range, shared by both scoring kernels: its passes (the
// lobe columns with per_lobe, each its descent or dense window; else one
// pass over all lobes), each a sequence of stages scanned by `scan` (the
// lane's first best of a stage), reduced over the group, and the passes
// merged with a strict > (the earlier column wins ties), then over the
// groups of the range. Every lane of the warp runs the same trip counts,
// so the shuffles always see the full warp. Returns (score, row) in every
// lane of the range.
template <class Scan>
__device__ __forceinline__ Pick walk(const Args& a, const Geo& geo, const int* my, bool live,
                                     int grp, Scan& scan) {
  const bool descent = a.stride >= 32 && (a.per_lobe || a.C == 1);
  const int passes = a.per_lobe ? a.C : 1;
  const int st0 = a.W >= 64 ? 16 : 8;
  const int stages = descent ? (a.W >= 64 ? 3 : 2) : 1;
  Pick best{-CUDART_INF_F, kNoKey, 0};
  for (int it = 0, col = grp; it < (passes + a.GR - 1) / a.GR; ++it, col += a.GR) {
    const bool col_ok = live && col < passes;
    const int L = col_ok && descent ? __ldg(my + col * a.lobe_sc) : -1;
    Stage s{geo.start(L), -1, geo.last, st0, a.W / st0 + 1, 0, 1, false, L >= 0};
    if (!descent) {  // the dense windows of the pass's lobes
      s = Stage{0, -1, kNoClamp, 1, a.W, a.per_lobe ? col : 0, a.per_lobe ? col + 1 : a.C,
                true, col_ok};
    }
    Pick p{};
    long long brow = 0;
    for (int g = 0; g < stages; ++g) {
      if (g == 1 && a.W >= 64) {  // centre +/- 8 at step 4, clipped to [0, last]
        s.first = brow - st0 / 2, s.step = 4, s.count = st0 / 4 + 1, s.lo = 0;
      } else if (g > 0) {  // the dense final window of st + 2 rows around the centre
        s.count = (a.W >= 64 ? 4 : st0) + 2;
        s.first = clampll(brow - s.count / 2, 0, geo.nv - s.count > 0 ? geo.nv - s.count : 0);
        s.step = 1, s.lo = -1, s.hi = kNoClamp;
      }
      p = reduce(scan(s), 1, a.G);
      brow = stage_row(s, p.k, geo, my, a.lobe_sc);
    }
    const int pick = static_cast<int>(brow < geo.D - 1 ? brow : geo.D - 1);
    if (col_ok && (!a.per_lobe || p.s > best.s)) best = Pick{p.s, col, pick};
  }
  return reduce(best, a.G, a.G * a.GR);
}

// Up to 16 taps: a group of G lanes a range's pass, the centred range in
// registers, each lane's row read by its own loads; TABLE: the row's
// terms from the table, else computed as the row is scored.
template <int N, int OBJ, bool TABLE>
struct Narrow {
  float rc[N];
  const float* bank;    // the file's
  const float4* table;  // the file's
  const int* my;       // the range's lobes
  Geo geo;
  long long lobe_sc;
  float c;
  int G, gl;
  bool vec;

  // ops/search.py _window_gains of bank row `row` < D against the range.
  __device__ __forceinline__ float gain(long long row) const {
    float d[N], w, th;
    const float* p = bank + row * N;
    bool loaded = false;
    if constexpr (N % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(p + j));
          d[j] = x.x, d[j + 1] = x.y, d[j + 2] = x.z, d[j + 3] = x.w;
        }
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int j = 0; j < N; ++j) d[j] = __ldg(p + j);
    }
    if constexpr (TABLE) {
      const float4 st = __ldg(table + row);
#pragma unroll
      for (int j = 0; j < N; ++j) d[j] = __fsub_rn(d[j], st.x);
      w = st.y, th = st.z;
    } else {  // staged_stats_kernel's terms, in registers
      float s = d[0];
#pragma unroll
      for (int j = 1; j < N; ++j) s = __fadd_rn(s, d[j]);
      const float mean = __fdiv_rn(s, static_cast<float>(N));
#pragma unroll
      for (int j = 0; j < N; ++j) d[j] = __fsub_rn(d[j], mean);
      float den = __fmul_rn(d[0], d[0]);
#pragma unroll
      for (int j = 1; j < N; ++j) den = __fadd_rn(den, __fmul_rn(d[j], d[j]));
      den = __fadd_rn(den, kEps);
      w = OBJ == kBalanced
              ? __fdiv_rn(__fsub_rn(__fsub_rn(den, kEps),
                                    __fmul_rn(__fmul_rn(static_cast<float>(N), mean), mean)),
                          __fmul_rn(den, den))
              : __fdiv_rn(1.f, den);
      th = OBJ == kDamped ? __fmul_rn(c, __fsub_rn(den, kEps)) : 0.f;
    }
    float no = __fmul_rn(d[0], rc[0]);
    float nm = __fmul_rn(d[0], rc[N - 1]);
#pragma unroll
    for (int j = 1; j < N; ++j) {
      no = __fadd_rn(no, __fmul_rn(d[j], rc[j]));
      nm = __fadd_rn(nm, __fmul_rn(d[j], rc[N - 1 - j]));
    }
    return fold<OBJ>(no, nm, w, th, c);
  }

  // The lane's first best of stage s: keys k = gl + G*i of each lobe.
  __device__ __forceinline__ Pick operator()(const Stage& s) const {
    Pick p{-CUDART_INF_F, kNoKey, 0};
    for (int g = s.g0; g < s.g1; ++g) {
      long long first = s.first;
      bool ok = s.ok;
      if (s.dense) {
        const int L = ok ? __ldg(my + g * lobe_sc) : -1;
        first = geo.start(L), ok = L >= 0;
      }
      const int base = (g - s.g0) * s.count;
      for (int k = gl; ok && k < s.count; k += G) {  // lanes may part: no shuffle in here
        const long long r = clampll(first + static_cast<long long>(s.step) * k, s.lo, s.hi);
        if (r < geo.nv) {
          const float v = gain(r < geo.D - 1 ? r : geo.D - 1);
          if (v > p.s) p.s = v, p.k = base + k;
        }
      }
    }
    return p;
  }
};

template <int N, int OBJ, bool TABLE>
__global__ void __launch_bounds__(kThreads, !TABLE && N == 4 ? kDescentBlocks : kMinBlocks)
    staged_refine_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int lanes = a.G * a.GR;  // lanes of a range
  const int m = (blockIdx.x * kThreads + threadIdx.x) / lanes;
  const int file = blockIdx.y;
  const bool live = m < a.M;
  const long long fm = static_cast<long long>(file) * a.M + (live ? m : a.M - 1);
  Narrow<N, OBJ, TABLE> x;
  {  // the centred range, as refine_from_lobes centres it
    const float* r = a.ranges + fm * N;
#pragma unroll
    for (int j = 0; j < N; ++j) x.rc[j] = __ldg(r + j);
    float s = x.rc[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s = __fadd_rn(s, x.rc[j]);
    const float mean = __fdiv_rn(s, static_cast<float>(N));
#pragma unroll
    for (int j = 0; j < N; ++j) x.rc[j] = __fsub_rn(x.rc[j], mean);
  }
  const long long nv = __ldg(a.n_valid + file);
  x.geo = Geo{nv, nv - 1 > 0 ? nv - 1 : 0, nv - a.W > 0 ? nv - a.W : 0, a.D, a.stride, a.W};
  x.bank = a.bank + static_cast<long long>(file) * a.D * N;
  x.table = a.table + static_cast<long long>(file) * a.D;
  x.my = a.lobes + file * a.lobe_sb + (live ? m : 0) * a.lobe_sm;
  x.lobe_sc = a.lobe_sc, x.c = a.c, x.G = a.G, x.gl = lane & (a.G - 1), x.vec = a.vec;
  const Pick best = walk(a, x.geo, x.my, live, (lane & (lanes - 1)) / a.G, x);
  if (live && (lane & (lanes - 1)) == 0) a.out_idx[fm] = best.v, a.out_score[fm] = best.s;
}

// --- 17 to 255 taps: a warp a range, its rows staged in shared memory --------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Floats of shared memory a warp takes: two rounds of 32 rows at the odd
// stride n | 1, then the centred range.
__host__ __device__ constexpr int wide_floats(int n) { return 2 * 32 * (n | 1) + n; }

template <int OBJ>
struct Wide {
  float* buf;           // the warp's two rounds of rows
  const float* rc;      // the warp's centred range (shared memory)
  const float* bank;    // the file's
  const float4* table;  // the file's
  const int* my;
  Geo geo;
  long long lobe_sc;
  float c;
  int n, S, lane;

  // What a lane scores in a round: its row (-1: none), key and table terms.
  struct Slot {
    long long row;
    int key;
    float mean, w, th;
  };

  // Round i of lobe g of stage s: the lane's row, its table terms, and the
  // round's rows copied into buffer b, each row's taps by consecutive lanes.
  __device__ __forceinline__ Slot issue(const Stage& s, int g, long long first, bool ok, int i,
                                        int b) const {
    const int k = lane + 32 * i;
    const long long r = clampll(first + static_cast<long long>(s.step) * k, s.lo, s.hi);
    Slot slot{-1, (g - s.g0) * s.count + k, 0.f, 0.f, 0.f};
    if (ok && k < s.count && r < geo.nv) {
      slot.row = r < geo.D - 1 ? r : geo.D - 1;
      const float4 st = __ldg(table + slot.row);
      slot.mean = st.x, slot.w = st.y, slot.th = st.z;
    }
    float* dst = buf + b * 32 * S;
    for (int j = 0; j < 32; ++j) {
      const long long rj = __shfl_sync(kAll, slot.row, j);
      if (rj >= 0) {
        for (int e = lane; e < n; e += 32) cp_async4(dst + j * S + e, bank + rj * n + e);
      }
    }
    cp_async_commit();
    return slot;
  }

  __device__ __forceinline__ float gain(const float* t, const Slot& x) const {
    float d = __fsub_rn(t[0], x.mean);
    float no = __fmul_rn(d, rc[0]);
    float nm = __fmul_rn(d, rc[n - 1]);
    for (int j = 1; j < n; ++j) {
      d = __fsub_rn(t[j], x.mean);
      no = __fadd_rn(no, __fmul_rn(d, rc[j]));
      nm = __fadd_rn(nm, __fmul_rn(d, rc[n - 1 - j]));
    }
    return fold<OBJ>(no, nm, x.w, x.th, c);
  }

  // The lane's first best of stage s: its rounds (32 rows each) in order
  // over the lobes, the next round's copy in flight while one is scored.
  __device__ __forceinline__ Pick operator()(const Stage& s) const {
    Pick p{-CUDART_INF_F, kNoKey, 0};
    const int rounds = (s.count + 31) / 32;
    const int total = (s.g1 - s.g0) * rounds;
    int g = s.g0, i = 0;
    long long first = s.first;
    bool ok = s.ok;
    auto lobe = [&] {  // a dense scan's window start and liveness at lobe g
      if (s.dense) {
        const int L = s.ok ? __ldg(my + g * lobe_sc) : -1;
        first = geo.start(L), ok = L >= 0;
      }
    };
    lobe();
    Slot cur = issue(s, g, first, ok, i, 0);
    for (int t = 0; t < total; ++t) {
      Slot next{-1, kNoKey, 0.f, 0.f, 0.f};
      if (t + 1 < total) {
        if (++i == rounds) i = 0, ++g, lobe();
        next = issue(s, g, first, ok, i, (t + 1) & 1);
      } else {
        cp_async_commit();  // an empty group: wait_group 1 then waits for round t
      }
      cp_async_wait_one();
      __syncwarp();
      if (cur.row >= 0) {
        const float v = gain(buf + (t & 1) * 32 * S + lane * S, cur);
        if (v > p.s) p.s = v, p.k = cur.key;
      }
      __syncwarp();  // the buffer is refilled by the next round's issue
      cur = next;
    }
    return p;
  }
};

template <int OBJ>
__global__ void __launch_bounds__(kThreads) staged_refine_kernel_wide(const Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * (blockDim.x >> 5) + warp;
  const int file = blockIdx.y;
  if (m >= a.M) return;  // a whole warp: no other warp waits on it
  const int n = a.n;
  const long long fm = static_cast<long long>(file) * a.M + m;
  float* sm = smem + warp * wide_floats(n);
  float* rc = sm + 2 * 32 * (n | 1);
  {  // the centred range, every lane summing the same taps in order
    for (int e = lane; e < n; e += 32) rc[e] = __ldg(a.ranges + fm * n + e);
    __syncwarp();
    float s = rc[0];
    for (int j = 1; j < n; ++j) s = __fadd_rn(s, rc[j]);
    const float mean = __fdiv_rn(s, static_cast<float>(n));
    __syncwarp();
    for (int e = lane; e < n; e += 32) rc[e] = __fsub_rn(rc[e], mean);
    __syncwarp();
  }
  const long long nv = __ldg(a.n_valid + file);
  Wide<OBJ> x;
  x.geo = Geo{nv, nv - 1 > 0 ? nv - 1 : 0, nv - a.W > 0 ? nv - a.W : 0, a.D, a.stride, a.W};
  x.buf = sm, x.rc = rc, x.n = n, x.S = n | 1, x.lane = lane;
  x.table = a.table + static_cast<long long>(file) * a.D;
  x.bank = a.bank + static_cast<long long>(file) * a.D * n;
  x.my = a.lobes + file * a.lobe_sb + m * a.lobe_sm;
  x.lobe_sc = a.lobe_sc, x.c = a.c;
  const Pick best = walk(a, x.geo, x.my, true, 0, x);
  if (lane == 0) a.out_idx[fm] = best.v, a.out_score[fm] = best.s;
}

template <int N, int OBJ, bool TABLE>
int launch(const Args& a, int B, cudaStream_t st) {
  if constexpr (N == 0) {
    const size_t per_warp = wide_floats(a.n) * sizeof(float);
    int warps = static_cast<int>((48 << 10) / per_warp);
    warps = warps < 1 ? 1 : (warps > kThreads / 32 ? kThreads / 32 : warps);
    const size_t bytes = warps * per_warp;
    if (bytes > (48 << 10)) {
      const cudaError_t e = cudaFuncSetAttribute(staged_refine_kernel_wide<OBJ>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 blocks((a.M + warps - 1) / warps, B);
    staged_refine_kernel_wide<OBJ><<<blocks, warps * 32, bytes, st>>>(a);
  } else {
    const int per_block = kThreads / (a.G * a.GR);  // ranges
    const dim3 blocks((a.M + per_block - 1) / per_block, B);
    staged_refine_kernel<N, OBJ, TABLE><<<blocks, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wide kernel always reads a table (the caller checks it is given).
template <int N, int OBJ>
int launch_t(const Args& a, int B, cudaStream_t st) {
  if constexpr (N > 0) {
    if (a.table == nullptr) return launch<N, OBJ, false>(a, B, st);
  }
  return launch<N, OBJ, true>(a, B, st);
}

template <int N>
int launch_n(const Args& a, int B, int objective, cudaStream_t st) {
  if (objective == kBalanced) return launch_t<N, kBalanced>(a, B, st);
  if (objective == kAffine) return launch_t<N, kAffine>(a, B, st);
  return launch_t<N, kDamped>(a, B, st);
}

}  // namespace

extern "C" {

// The table of a stack's bank (B * D = rows rows of N float32 taps,
// contiguous): out (rows, 4) float32 [mean, w, th, 0], 16-byte aligned; th
// is 0 but for objective 2 (damped). Returns cudaGetLastError() after the
// launch.
int fwav_staged_stats(const float* bank, long long rows, int N, int objective, float s_clip,
                      float* out, void* stream) {
  if (rows < 1 || (rows + kThreads - 1) / kThreads > 0x7fffffffLL || N < 4 || N > 255 ||
      objective < 0 || objective > 2 || reinterpret_cast<size_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float c = s_clip < 0.f ? -s_clip : s_clip;
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  staged_stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bank, rows, N, objective, c, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// A stack of B files: ranges (B, M, N) float32 contiguous (raw, not
// centred); bank (B, D, N) float32 contiguous; table its fwav_staged_stats
// output for the same objective and s_clip (16-byte aligned), or, up to 16
// taps, null: each row's terms computed as it is scored; lobes int32, lobe
// `slot` of range m of file b at
// lobes[b * lobe_stride_b + m * lobe_stride_m + slot * lobe_stride_c],
// C >= 1 slots; n_valid (B,) int32 on the device; objective 0 balanced,
// 1 affine, 2 damped; per_lobe 0 or 1 (see above). Writes idx (B, M) int32
// and score (B, M) float32. Returns cudaGetLastError() after the launch.
int fwav_staged_refine(const float* ranges, int B, int M, int N, const float* bank,
                       long long D, const float* table, const int* lobes, int C, long long lobe_stride_b, long long lobe_stride_m,
                       long long lobe_stride_c, const int* n_valid, int stride, int objective,
                       int per_lobe, float s_clip, int* idx, float* score, void* stream) {
  if (B < 1 || B > 65535 || M < 1 || N < 4 || N > 255 || D < 1 || D > (1LL << 31) || C < 1 ||
      stride < 1 || stride > (1 << 24) || objective < 0 || objective > 2 ||
      (per_lobe != 0 && per_lobe != 1) || (table == nullptr && N > 16) ||
      reinterpret_cast<size_t>(table) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{ranges, bank, reinterpret_cast<const float4*>(table), lobes, n_valid, idx, score, D, lobe_stride_b, lobe_stride_m,
         lobe_stride_c, M, N, C, stride, 0, per_lobe, 32, 1, s_clip < 0.f ? -s_clip : s_clip,
         N % 4 == 0 && reinterpret_cast<size_t>(bank) % 16 == 0};
  a.W = stride + stride / 4 > 2 ? stride + stride / 4 : 2;
  const bool descent = stride >= 32 && (per_lobe || C == 1);
  if (N <= 16) {
    // a thread a descent (its stages have W/16 + 1, 5 and 6 rows); a dense
    // window 4 or 8 lanes; per_lobe puts up to 32 / G columns of a range
    // side by side
    a.G = descent ? 1 : (N < 8 ? 4 : 8);
    while (per_lobe && a.GR * 2 <= C && a.G * a.GR * 2 <= 32) a.GR *= 2;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N <= 16 ? N : 0) {
#define FWAV_CASE(K) \
  case K:            \
    return launch_n<K>(a, B, objective, st);
    FWAV_CASE(4) FWAV_CASE(5) FWAV_CASE(6) FWAV_CASE(7) FWAV_CASE(8) FWAV_CASE(9)
    FWAV_CASE(10) FWAV_CASE(11) FWAV_CASE(12) FWAV_CASE(13) FWAV_CASE(14) FWAV_CASE(15)
    FWAV_CASE(16) FWAV_CASE(0)
#undef FWAV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
