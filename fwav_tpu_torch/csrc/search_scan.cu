// K1: the fused matched-filter search scan, on Hopper.
//
// Replaces the Pallas TPU kernel `_search_kernel` (with_sym=False) in
// fwav_tpu/ops/pallas_search.py, called through exact_search_scan_pallas.
// For every range m and every domain d it scores both orientations of the
// centered range against the bank row (the numerators of scan_tile.cuh),
//     s = num^2 * w[d], or c*(2|num| - t[d]) where |num| > t[d] (damped)
// folds the two with max (after the clip branch), scores invalid domains
// -inf, and keeps the running argmax over d. The lowest index wins ties, as
// in the TPU kernel (first max inside a block, earlier block on ties
// across blocks).
//
// What bounds it here: the CUDA-core screen, 4 operations per pair for
// balanced and affine and 9 for damped (scan_tile.cuh), so 114,688 ranges
// x 3,584 domains take at least 0.049 ms (balanced). The design is scan_tile.cuh's (a tensor-core screen, then an
// exact float32 confirm of the few pairs that can win); this file adds
// the policy:
//   * the confirm scores a pair as the plain version does (products and
//     sums rounded one by one, the clip branch per orientation, then the
//     fold), so the kernel picks bit for bit what search_scan_ref picks;
//   * a running (best, idx) per range and thread, updated on a strict >,
//     then a quad merge by (score descending, index ascending);
//   * when the ranges alone cannot fill the card (the exact branch: few
//     ranges, a large bank), blockIdx.y splits the domains and a second
//     pass merges the partial bests in split order, keeping the rule.
// Fragment layout: A rows 0-7 = 8 ranges, rows 8-15 = the same reversed,
// so c0, c1 = num_o and c2, c3 = num_m of range g for domains 2t, 2t+1.

#include "scan_tile.cuh"

namespace {

using fwav::ScanArgs;

template <int MT, bool kClip>
struct ArgmaxKeep {
  static constexpr int kRank = 1;  // a pick must reach the best

  float best[MT];
  int best_i[MT];
  float c;

  // search_scan_ref's score of one orientation: num^2 w, or c (2|num| - t)
  // where |num| > t
  __device__ __forceinline__ float gain(float num, float w, float t) const {
    const float a = fabsf(num);
    if (kClip && a > t) return __fmul_rn(__fsub_rn(__fmul_rn(2.f, a), t), c);
    return __fmul_rn(__fmul_rn(num, num), w);
  }
  __device__ __forceinline__ float exact(float no, float nm, float w, float t) const {
    return fmaxf(gain(no, w, t), gain(nm, w, t));
  }
  __device__ __forceinline__ void keep(int mt, float s, int d) {
    if (s > best[mt]) {
      best[mt] = s;
      best_i[mt] = d;
    }
  }
  __device__ __forceinline__ float entry(int mt, int) const { return best[mt]; }
};

template <int N, bool kClip>
__global__ void __launch_bounds__(fwav::Warp<N, 1>::kThreads,
                                  fwav::Warp<N, 1>::kMinBlocks)
    search_scan_kernel(ScanArgs a, int d_per_split, float* __restrict__ out_score,
                       int* __restrict__ out_idx) {
  constexpr int MT = fwav::Warp<N, 1>::kMT;
  __shared__ fwav::Stage<N> sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * fwav::kRangesPerBlock + warp * 8 * MT;
  const int d0 = blockIdx.y * d_per_split;
  const int d1 = min(a.D, d0 + d_per_split);

  ArgmaxKeep<MT, kClip> keep;
  keep.c = a.c;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    keep.best[mt] = -CUDART_INF_F;
    keep.best_i[mt] = 0;
  }
  fwav::scan<N, MT, kClip>(sm, a, d0, d1, keep);

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float s = keep.best[mt];
    int i = keep.best_i[mt];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (fwav::beats(os, oi, s, i)) {
        s = os;
        i = oi;
      }
    }
    const int m = m0 + 8 * mt + (lane >> 2);
    if ((lane & 3) == 0 && m < a.M) {
      out_score[(size_t)blockIdx.y * a.M + m] = s;
      out_idx[(size_t)blockIdx.y * a.M + m] = i;
    }
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
void launch_scan(const ScanArgs& a, int n_split, int d_per_split, float* out_score,
                 int* out_idx, cudaStream_t stream) {
  const dim3 grid((a.M + fwav::kRangesPerBlock - 1) / fwav::kRangesPerBlock, n_split);
  const int threads = fwav::Warp<N, 1>::kThreads;
  if (a.thresh != nullptr)
    search_scan_kernel<N, true><<<grid, threads, 0, stream>>>(a, d_per_split, out_score,
                                                              out_idx);
  else
    search_scan_kernel<N, false><<<grid, threads, 0, stream>>>(a, d_per_split, out_score,
                                                               out_idx);
}

}  // namespace

extern "C" {

const char* fwav_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r_c (M, N), bankT (N, D), w (D,), valid (D,), thresh (D,) or null:
// float32 / int8, contiguous, on the device of `stream`. d_per_split is a
// multiple of 128 (the staged tile). With n_split > 1 the partial bests go
// to part_score/part_idx (n_split, M) and a merge pass writes score/idx
// (M,); with n_split == 1 the scan writes them directly. Returns
// cudaGetLastError() after the launches.
int fwav_search_scan(const float* r_c, const float* bankT, const float* w,
                     const int8_t* valid, const float* thresh, float s_clip,
                     int M, int N, int D, int n_split, int d_per_split,
                     float* part_score, int* part_idx, float* score, int* idx,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_per_split % fwav::kTileD != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{r_c, bankT, w, valid, thresh, s_clip, M, D};
  float* s_out = n_split > 1 ? part_score : score;
  int* i_out = n_split > 1 ? part_idx : idx;
  switch (N) {
#define FWAV_CASE(K)                                              \
  case K:                                                         \
    launch_scan<K>(a, n_split, d_per_split, s_out, i_out, st);    \
    break;
    FWAV_CASE(4) FWAV_CASE(5) FWAV_CASE(6) FWAV_CASE(7) FWAV_CASE(8)
    FWAV_CASE(9) FWAV_CASE(10) FWAV_CASE(11) FWAV_CASE(12) FWAV_CASE(13)
    FWAV_CASE(14) FWAV_CASE(15) FWAV_CASE(16)
#undef FWAV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_split > 1) {
    merge_splits_kernel<<<(M + 255) / 256, 256, 0, st>>>(part_score, part_idx, M,
                                                         n_split, score, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
