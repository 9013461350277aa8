// K1: the fused matched-filter search scan, on Hopper.
//
// Replaces the Pallas TPU kernel `_search_kernel` (with_sym=False) in
// fwav_tpu/ops/pallas_search.py, called through exact_search_scan_pallas.
// For every range m and every domain d it scores both orientations of the
// centered range against the bank row,
//     num_o = sum_j r_c[m, j] * bankT[j, d]
//     num_m = sum_j r_c[m, N-1-j] * bankT[j, d]
//     s     = num^2 * w[d], or c*(2|num| - t[d]) where |num| > t[d] (damped)
// folds the two with max, scores invalid domains -inf, and keeps the
// running argmax over d. The lowest index wins ties, as in the TPU kernel
// (first max inside a block, earlier block on ties across blocks).
//
// What bounds it here: with N = 4 taps each pair is ~20 float32 operations
// and there is nothing for the tensor cores to do (K = 4), so the kernel
// runs on the CUDA cores. The main path's coarse scan is 114,688 ranges x
// 3,584 domains. The design:
//   * one thread per range, its N taps in registers; the thread sweeps the
//     domains in increasing order and takes a new best only on a strict >,
//     which is exactly the lowest-index rule with no cross-thread reduction;
//   * a block stages tiles of bankT, w, valid and thresh in shared memory;
//     every thread of the block reads the same word, so reads broadcast;
//   * when the ranges alone cannot fill the card (the exact branch: few
//     ranges, a large bank), blockIdx.y splits the domains and a second
//     pass merges the partial bests in split order, keeping the rule.
// The arithmetic uses explicit round-to-nearest intrinsics, so no
// multiply-add is contracted: the kernel computes bit for bit what the
// plain PyTorch version (ops/kernels.py search_scan_ref) computes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileD = 256;

template <int N>
__global__ void __launch_bounds__(kThreads) search_scan_kernel(
    const float* __restrict__ r_c, const float* __restrict__ bankT,
    const float* __restrict__ w, const int8_t* __restrict__ valid,
    const float* __restrict__ thresh, float c, int M, int D, int d_per_split,
    float* __restrict__ out_score, int* __restrict__ out_idx) {
  __shared__ float s_bank[N][kTileD];
  __shared__ float s_w[kTileD];
  __shared__ float s_t[kTileD];
  __shared__ int8_t s_v[kTileD];

  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  const int d0 = blockIdx.y * d_per_split;
  const int d1 = min(D, d0 + d_per_split);
  const bool clip = thresh != nullptr;

  float r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = live ? r_c[(size_t)m * N + j] : 0.f;

  float best = -CUDART_INF_F;
  int best_i = 0;
  for (int t0 = d0; t0 < d1; t0 += kTileD) {
    const int nt = min(kTileD, d1 - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < nt; k += kThreads) {
#pragma unroll
      for (int j = 0; j < N; ++j) s_bank[j][k] = bankT[(size_t)j * D + t0 + k];
      s_w[k] = w[t0 + k];
      s_v[k] = valid[t0 + k];
      if (clip) s_t[k] = thresh[t0 + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < nt; ++k) {
      float no = __fmul_rn(r[0], s_bank[0][k]);
      float nm = __fmul_rn(r[N - 1], s_bank[0][k]);
#pragma unroll
      for (int j = 1; j < N; ++j) {
        no = __fadd_rn(no, __fmul_rn(r[j], s_bank[j][k]));
        nm = __fadd_rn(nm, __fmul_rn(r[N - 1 - j], s_bank[j][k]));
      }
      const float wk = s_w[k];
      float so = __fmul_rn(__fmul_rn(no, no), wk);
      float sm = __fmul_rn(__fmul_rn(nm, nm), wk);
      if (clip) {
        const float t = s_t[k];
        const float ao = fabsf(no);
        const float am = fabsf(nm);
        if (ao > t) so = __fmul_rn(c, __fsub_rn(__fmul_rn(2.f, ao), t));
        if (am > t) sm = __fmul_rn(c, __fsub_rn(__fmul_rn(2.f, am), t));
      }
      float sc = fmaxf(so, sm);
      if (!s_v[k]) sc = -CUDART_INF_F;
      if (sc > best) {
        best = sc;
        best_i = t0 + k;
      }
    }
  }
  if (live) {
    out_score[(size_t)blockIdx.y * M + m] = best;
    out_idx[(size_t)blockIdx.y * M + m] = best_i;
  }
}

// Partial bests of the domain splits, in split order: a later split wins
// only on a strict >, so the lowest domain index still wins ties.
__global__ void merge_splits_kernel(const float* __restrict__ part_score,
                                    const int* __restrict__ part_idx, int M,
                                    int n_split, float* __restrict__ score,
                                    int* __restrict__ idx) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float best = part_score[m];
  int best_i = part_idx[m];
  for (int s = 1; s < n_split; ++s) {
    const float v = part_score[(size_t)s * M + m];
    if (v > best) {
      best = v;
      best_i = part_idx[(size_t)s * M + m];
    }
  }
  score[m] = best;
  idx[m] = best_i;
}

template <int N>
void launch_scan(const float* r_c, const float* bankT, const float* w,
                 const int8_t* valid, const float* thresh, float c, int M,
                 int D, int n_split, int d_per_split, float* out_score,
                 int* out_idx, cudaStream_t stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, n_split);
  search_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      r_c, bankT, w, valid, thresh, c, M, D, d_per_split, out_score, out_idx);
}

}  // namespace

extern "C" {

const char* fwav_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r_c (M, N), bankT (N, D), w (D,), valid (D,), thresh (D,) or null:
// float32 / int8, contiguous, on the device of `stream`. With n_split > 1
// the partial bests go to part_score/part_idx (n_split, M) and a merge
// pass writes score/idx (M,); with n_split == 1 the scan writes them
// directly. Returns cudaGetLastError() after the launches.
int fwav_search_scan(const float* r_c, const float* bankT, const float* w,
                     const int8_t* valid, const float* thresh, float s_clip,
                     int M, int N, int D, int n_split, int d_per_split,
                     float* part_score, int* part_idx, float* score, int* idx,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s_out = n_split > 1 ? part_score : score;
  int* i_out = n_split > 1 ? part_idx : idx;
  switch (N) {
#define FWAV_CASE(K)                                                        \
  case K:                                                                   \
    launch_scan<K>(r_c, bankT, w, valid, thresh, s_clip, M, D, n_split,     \
                   d_per_split, s_out, i_out, st);                          \
    break;
    FWAV_CASE(4) FWAV_CASE(5) FWAV_CASE(6) FWAV_CASE(7) FWAV_CASE(8)
    FWAV_CASE(9) FWAV_CASE(10) FWAV_CASE(11) FWAV_CASE(12) FWAV_CASE(13)
    FWAV_CASE(14) FWAV_CASE(15) FWAV_CASE(16)
#undef FWAV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_split > 1) {
    merge_splits_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        part_score, part_idx, M, n_split, score, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
