// K2: the dense window refine of the coarse lobes, on Hopper.
//
// Replaces the Pallas TPU kernel `_refine_kernel` in
// fwav_tpu/ops/pallas_search.py, called through refine_window_pallas. For
// each range m with coarse lobe L (-1 = none) it scores every position
//     p = L*stride - W/2 + t,  t < W = stride + stride/4,
// of the box-mean sequence: tap j of position p is means[p + j*block_len]
// (means_ext holds a stride-wide zero lead, so means_ext[q + stride] =
// means[q]). It centers the taps and scores both orientations of the
// centered range with the balanced, affine or damped gain. Positions
// outside [0, n_valid), and every position of a range without a lobe,
// score -inf. The first maximum wins; the output is its score and the
// position clipped to [0, n_valid - 1].
//
// What bounds it here: each range reads N*W floats of one contiguous
// ~1,024-float slice of the sequence, ~1.8 MB for 10 s of audio, which
// stays in the 50 MB L2; the work is ~40 float32 operations per position.
// The TPU kernel copied each slice into VMEM under a 9 MB cap; the card
// needs no copy. The design: one warp per range, each lane scoring
// positions t = lane, lane + 32, ... straight from global memory
// (neighbouring lanes read neighbouring addresses), keeping its own first
// maximum, then a shuffle argmax on (score, then smaller t).
// The arithmetic uses explicit round-to-nearest intrinsics in the TPU
// kernel's order, so the kernel computes bit for bit what the plain
// PyTorch version (ops/kernels.py refine_window_ref) computes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Objective { kBalanced = 0, kAffine = 1, kDamped = 2 };

template <int N>
__global__ void __launch_bounds__(kThreads) refine_window_kernel(
    const float* __restrict__ means, int L, const int* __restrict__ lobes,
    const float* __restrict__ ranges, int M, int n_valid, int stride,
    int block_len, int W, int objective, float c, float inv_n,
    float* __restrict__ out_score, int* __restrict__ out_idx) {
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;  // uniform across the warp

  const int lobe = lobes[m];
  const int lb = max(lobe, 0);
  float r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = ranges[(size_t)m * N + j];
  float rs = r[0];
#pragma unroll
  for (int j = 1; j < N; ++j) rs = __fadd_rn(rs, r[j]);
  const float r_mean = __fdiv_rn(rs, static_cast<float>(N));
  float rc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) rc[j] = __fsub_rn(r[j], r_mean);

  const int half = W / 2;
  const int p0 = lb * stride - half;  // position of t = 0
  const int q0 = p0 + stride;         // its index in means_ext
  float best = -CUDART_INF_F;
  int best_t = 0;
  for (int t = lane; t < W; t += 32) {
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int q = q0 + t + j * block_len;
      v[j] = q < L ? means[q] : 0.f;
    }
    float mean = v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) mean = __fadd_rn(mean, v[j]);
    mean = __fmul_rn(mean, inv_n);
    float no = __fmul_rn(rc[0], v[0]);
    float nm = __fmul_rn(rc[N - 1], v[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) {
      no = __fadd_rn(no, __fmul_rn(rc[j], v[j]));
      nm = __fadd_rn(nm, __fmul_rn(rc[N - 1 - j], v[j]));
    }
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float d = __fsub_rn(v[j], mean);
      denom = __fadd_rn(denom, __fmul_rn(d, d));
    }
    const float denom_eps = __fadd_rn(denom, 1e-12f);
    float score;
    if (objective == kBalanced) {
      const float wgt = __fdiv_rn(
          __fsub_rn(denom, __fmul_rn(__fmul_rn(static_cast<float>(N), mean), mean)),
          __fmul_rn(denom_eps, denom_eps));
      score = __fmul_rn(fmaxf(__fmul_rn(no, no), __fmul_rn(nm, nm)), wgt);
    } else if (objective == kDamped) {
      const float a = fmaxf(fabsf(no), fabsf(nm));
      const float th = __fmul_rn(c, denom);
      score = a > th ? __fmul_rn(c, __fsub_rn(__fmul_rn(2.f, a), th))
                     : __fdiv_rn(__fmul_rn(a, a), denom_eps);
    } else {
      score = __fdiv_rn(fmaxf(__fmul_rn(no, no), __fmul_rn(nm, nm)), denom_eps);
    }
    const int p = p0 + t;
    if (lobe < 0 || p < 0 || p >= n_valid) score = -CUDART_INF_F;
    if (score > best) {
      best = score;
      best_t = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, best, off);
    const int ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    if (os > best || (os == best && ot < best_t)) {
      best = os;
      best_t = ot;
    }
  }
  if (lane == 0) {
    out_score[m] = best;
    out_idx[m] = min(max(p0 + best_t, 0), max(n_valid - 1, 0));
  }
}

template <int N>
void launch_refine(const float* means, int L, const int* lobes,
                   const float* ranges, int M, int n_valid, int stride,
                   int block_len, int objective, float c, float* score,
                   int* idx, cudaStream_t stream) {
  const int W = stride + stride / 4;
  const float inv_n = 1.0f / static_cast<float>(N);
  refine_window_kernel<N><<<(M + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      means, L, lobes, ranges, M, n_valid, stride, block_len, W, objective, c,
      inv_n, score, idx);
}

}  // namespace

extern "C" {

// means_ext (L,), lobes (M,) int32, ranges (M, N) float32, contiguous, on
// the device of `stream`; objective 0 balanced, 1 affine, 2 damped.
// Writes score (M,) float32 and idx (M,) int32. Returns
// cudaGetLastError() after the launch.
int fwav_refine_window(const float* means_ext, int L, const int* lobes,
                       const float* ranges, int M, int N, int n_valid,
                       int stride, int block_len, int objective, float s_clip,
                       float* score, int* idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
#define FWAV_CASE(K)                                                      \
  case K:                                                                 \
    launch_refine<K>(means_ext, L, lobes, ranges, M, n_valid, stride,     \
                     block_len, objective, s_clip, score, idx, st);       \
    break;
    FWAV_CASE(4) FWAV_CASE(5) FWAV_CASE(6) FWAV_CASE(7) FWAV_CASE(8)
    FWAV_CASE(9) FWAV_CASE(10) FWAV_CASE(11) FWAV_CASE(12) FWAV_CASE(13)
    FWAV_CASE(14) FWAV_CASE(15) FWAV_CASE(16)
#undef FWAV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
