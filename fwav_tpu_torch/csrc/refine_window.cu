// K2: the dense window refine of the coarse lobes, on Hopper.
//
// Replaces the Pallas TPU kernel `_refine_kernel` in
// fwav_tpu/ops/pallas_search.py, called through refine_window_pallas, and
// the per-lobe merge around it in fwav_tpu/models/encode.py. For each range
// m and each of its C coarse lobes L (-1 = none), in lobe order, it scores
// every position
//     p = L*stride - W/2 + t,  t < W = stride + stride/4,
// of the box-mean sequence: tap j of position p is means[p + j*block_len]
// (means_ext holds a stride-wide zero lead, so means_ext[q + stride] =
// means[q]). It centers the taps and scores both orientations of the
// centered range with the balanced, affine or damped gain. Positions
// outside [0, n_valid), and every position of a lobe of -1, score -inf.
// The first maximum in (lobe, position) order wins, so the earlier lobe
// wins ties; the output is its score and its position clipped to
// [0, n_valid - 1] (a range without any finite score returns -inf and
// position 0 of its first lobe's window, clipped).
//
// Two kernels. `window_stats` walks the index space of means_ext once and
// writes what depends on the position q alone: the balanced weight, or for
// affine and damped the taps' centered energy denom (one float a position,
// so that a pair reads no more than it must: denom + eps and the damped
// clip threshold c*denom are one operation each from it). `refine_window`
// then needs, per (range, position) pair, only the N taps, the table
// entry, the two numerators, the fold and one multiply (balanced) or
// division (affine; damped under its clip threshold), and walks all lobes
// of a range in one launch with one running (score, position), the range
// read and centered once.
//
// What bounds it here (measured on an H100, PERF.md): the loads, not the
// arithmetic. The taps and the table, ~0.5-1.6 M positions of 4 bytes
// each, stay in the 50 MB L2, but the windows of one range's taps do not
// overlap (W < block_len) and neighbouring ranges have unrelated lobes, so
// every pair reads N + 1 floats with no reuse: 20 bytes at N = 4, 367 MB
// for 114,688 ranges, which the card delivers at ~8 TB/s. With the ranges
// reordered by lobe the same launch is a quarter to a third faster (the
// windows then come from L1); what is left is L1's load path and ~25
// instructions a pair, ~9x the card's bound for the function.
//
// What the design does about it: the statistics come from the table, not
// from 40-160 recomputations per position; a group of kG = 8 lanes shares
// a range, each lane scoring kV = 4 neighbouring positions per step from
// one 16-byte load per tap and table row (the window starts on a 16-byte
// boundary when stride, block_len and the sequence length allow it;
// otherwise the same loop reads float by float); windows wholly inside the
// sequence and [0, n_valid), nearly all, take a loop without bounds checks
// or masks; the objective and N are template parameters, C is a loop. Each
// lane keeps its own first maximum, then a shuffle argmax over the group
// on (score, then the smaller lobe-major key). The arithmetic uses
// explicit round-to-nearest intrinsics in the TPU kernel's order, so both
// kernels compute bit for bit what the plain PyTorch versions
// (ops/kernels.py refine_window_ref, window_stats_ref) compute.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;        // neighbouring positions a lane scores per step
constexpr int kG = 8;        // lanes that share a range

enum Objective { kBalanced = 0, kAffine = 1, kDamped = 2 };

// --- per-position statistics ----------------------------------------------

template <int N>
__global__ void __launch_bounds__(kThreads) window_stats_kernel(
    const float* __restrict__ means, int L, int block_len, int objective,
    float inv_n, float* __restrict__ out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= L) return;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int qj = q + j * block_len;
    v[j] = qj < L ? means[qj] : 0.f;
  }
  float mean = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) mean = __fadd_rn(mean, v[j]);
  mean = __fmul_rn(mean, inv_n);
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float d = __fsub_rn(v[j], mean);
    denom = __fadd_rn(denom, __fmul_rn(d, d));
  }
  if (objective == kBalanced) {
    const float denom_eps = __fadd_rn(denom, 1e-12f);
    out[q] = __fdiv_rn(
        __fsub_rn(denom, __fmul_rn(__fmul_rn(static_cast<float>(N), mean), mean)),
        __fmul_rn(denom_eps, denom_eps));
  } else {
    out[q] = denom;
  }
}

// --- scoring ----------------------------------------------------------------

// kV neighbouring floats at p[q .. q + kV). CHECKED: zeros from index L on.
// `vec`: q is a multiple of kV, p is aligned to kV floats and L is a
// multiple of kV, so one 16-byte load is wholly inside or wholly outside.
template <bool CHECKED>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int q,
                                         int L, bool vec, float (&v)[kV]) {
  if (vec) {
    const float4 x = !CHECKED || q < L
                         ? __ldg(reinterpret_cast<const float4*>(p + q))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < kV; ++k)
      v[k] = !CHECKED || q + k < L ? __ldg(p + q + k) : 0.f;
  }
}

// One lobe's window for one lane: positions t = tb .. tb + kV - 1 for
// tb = t0, t0 + kG*kV, ... below t_hi, scored in increasing t into the lane's
// running first maximum (best, best_key = key0 + t). EDGE: the window
// leaves [0, n_valid) or its taps leave the sequence, so loads are checked
// and positions outside [t_lo, t_hi) are masked; otherwise t_lo = 0,
// t_hi = W, a multiple of kV, and every load is inside.
template <int N, int OBJ, bool EDGE>
__device__ __forceinline__ void score_window(
    const float* __restrict__ means, const float* __restrict__ stats, int L,
    const float (&rc)[N], int q0, int t0, int t_lo, int t_hi, int block_len,
    float c, bool vec, int key0, float& best, int& best_key) {
  for (int tb = t0; tb < t_hi; tb += kG * kV) {
    if (EDGE && tb + kV <= t_lo) continue;
    float no[kV], nm[kV], v[kV];
    load_run<EDGE>(means, q0 + tb, L, vec, v);
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      no[k] = __fmul_rn(rc[0], v[k]);
      nm[k] = __fmul_rn(rc[N - 1], v[k]);
    }
#pragma unroll
    for (int j = 1; j < N; ++j) {
      load_run<EDGE>(means, q0 + tb + j * block_len, L, vec, v);
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        no[k] = __fadd_rn(no[k], __fmul_rn(rc[j], v[k]));
        nm[k] = __fadd_rn(nm[k], __fmul_rn(rc[N - 1 - j], v[k]));
      }
    }
    load_run<EDGE>(stats, q0 + tb, L, vec, v);  // the weight, or denom
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      float score;
      if (OBJ == kDamped) {
        const float a = fmaxf(fabsf(no[k]), fabsf(nm[k]));
        const float th = __fmul_rn(c, v[k]);
        score = a > th ? __fmul_rn(c, __fsub_rn(__fmul_rn(2.f, a), th))
                       : __fdiv_rn(__fmul_rn(a, a), __fadd_rn(v[k], 1e-12f));
      } else {
        const float f = fmaxf(__fmul_rn(no[k], no[k]), __fmul_rn(nm[k], nm[k]));
        score = OBJ == kBalanced ? __fmul_rn(f, v[k])
                                 : __fdiv_rn(f, __fadd_rn(v[k], 1e-12f));
      }
      const int t = tb + k;
      if ((!EDGE || (t >= t_lo && t < t_hi)) && score > best) {
        best = score;
        best_key = key0 + t;
      }
    }
  }
}

template <int N, int OBJ>
__global__ void __launch_bounds__(kThreads) refine_window_kernel(
    const float* __restrict__ means, const float* __restrict__ stats, int L,
    const int* __restrict__ lobes, int C, int lobe_stride_m, int lobe_stride_c,
    const float* __restrict__ ranges, int M, int n_valid, int stride,
    int block_len, int W, float c, bool vec, float* __restrict__ out_score,
    int* __restrict__ out_idx) {
  const int m = (blockIdx.x * kThreads + threadIdx.x) / kG;
  const int g = threadIdx.x % kG;
  const bool active = m < M;  // every lane stays for the shuffles
  const int mm = active ? m : M - 1;

  float rc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) rc[j] = ranges[(size_t)mm * N + j];
  float rs = rc[0];
#pragma unroll
  for (int j = 1; j < N; ++j) rs = __fadd_rn(rs, rc[j]);
  const float r_mean = __fdiv_rn(rs, static_cast<float>(N));
#pragma unroll
  for (int j = 0; j < N; ++j) rc[j] = __fsub_rn(rc[j], r_mean);

  const int half = W / 2;
  const int reach = W + (N - 1) * block_len;  // indices a window's taps span
  const int* my_lobes = lobes + (size_t)mm * lobe_stride_m;
  float best = -CUDART_INF_F;
  int best_key = 0;  // lobe slot * W + t
  for (int slot = 0; slot < (active ? C : 0); ++slot) {
    const int lobe = my_lobes[(size_t)slot * lobe_stride_c];
    if (lobe < 0) continue;  // uniform across the group
    const int p0 = lobe * stride - half;  // position of t = 0
    const int q0 = p0 + stride;           // its index in means_ext
    if (W % kV == 0 && p0 >= 0 && p0 + W <= n_valid && q0 + reach <= L) {
      score_window<N, OBJ, false>(means, stats, L, rc, q0, g * kV, 0, W,
                                  block_len, c, vec, slot * W, best, best_key);
    } else {  // positions inside [0, n_valid) only
      score_window<N, OBJ, true>(means, stats, L, rc, q0, g * kV, max(0, -p0),
                                 min(W, n_valid - p0), block_len, c, vec,
                                 slot * W, best, best_key);
    }
  }
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_key, off);
    if (os > best || (os == best && ok < best_key)) {
      best = os;
      best_key = ok;
    }
  }
  if (active && g == 0) {
    const int slot = best_key / W;
    const int lobe = max(my_lobes[(size_t)slot * lobe_stride_c], 0);
    out_score[m] = best;
    out_idx[m] = min(max(lobe * stride - half + (best_key - slot * W), 0),
                     max(n_valid - 1, 0));
  }
}

}  // namespace

#define FWAV_EACH_N(CASE)                                                  \
  CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11)        \
  CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

extern "C" {

// means_ext (L,) float32, contiguous, on the device of `stream`; objective
// 0 balanced, 1 affine, 2 damped; inv_n the float32 the plain version
// multiplies the tap sum by. Writes stats (L,) float32. Returns
// cudaGetLastError() after the launch.
int fwav_window_stats(const float* means_ext, int L, int N, int block_len,
                      int objective, float inv_n, float* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (L + kThreads - 1) / kThreads;
  switch (N) {
#define FWAV_CASE(K)                                                       \
  case K:                                                                  \
    window_stats_kernel<K><<<blocks, kThreads, 0, st>>>(                   \
        means_ext, L, block_len, objective, inv_n, stats);                 \
    break;
    FWAV_EACH_N(FWAV_CASE)
#undef FWAV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// means_ext (L,) and its stats as fwav_window_stats wrote them for the same
// N, block_len and objective; lobes int32, lobe `slot` of range m at
// lobes[m * lobe_stride_m + slot * lobe_stride_c], C >= 1 slots; ranges
// (M, N) float32 contiguous. Writes score (M,) float32 and idx (M,) int32.
// Returns cudaGetLastError() after the launch.
int fwav_refine_window(const float* means_ext, const float* stats, int L,
                       const int* lobes, int C, int lobe_stride_m,
                       int lobe_stride_c, const float* ranges, int M, int N,
                       int n_valid, int stride, int block_len, int objective,
                       float s_clip, float* score, int* idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || objective < 0 || objective > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads: every window and every tap starts on a multiple of kV
  const int W = stride + stride / 4;
  const bool vec =
      stride % kV == 0 && (W / 2) % kV == 0 && block_len % kV == 0 &&
      L % kV == 0 && reinterpret_cast<size_t>(means_ext) % (4 * kV) == 0 &&
      reinterpret_cast<size_t>(stats) % (4 * kV) == 0;
  constexpr int per_block = kThreads / kG;
  const int blocks = (M + per_block - 1) / per_block;
  switch (N * 4 + objective) {
#define FWAV_CASE_OBJ(K, OBJ)                                              \
  case K * 4 + OBJ:                                                        \
    refine_window_kernel<K, OBJ><<<blocks, kThreads, 0, st>>>(             \
        means_ext, stats, L, lobes, C, lobe_stride_m, lobe_stride_c,       \
        ranges, M, n_valid, stride, block_len, W, s_clip, vec, score,      \
        idx);                                                              \
    break;
#define FWAV_CASE(K)                                                       \
  FWAV_CASE_OBJ(K, kBalanced) FWAV_CASE_OBJ(K, kAffine) FWAV_CASE_OBJ(K, kDamped)
    FWAV_EACH_N(FWAV_CASE)
#undef FWAV_CASE
#undef FWAV_CASE_OBJ
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
