// K3: the top-C coarse lobe scan, on Hopper.
//
// Replaces the Pallas TPU kernel `_topc_kernel` in
// fwav_tpu/ops/pallas_search.py, called through topc_search_scan_pallas:
// the damped profile's coarse scan, which keeps C lobes per range for the
// window refine (K2) to visit one column at a time. For every range m and
// every domain d of the stride-subsampled bank it takes the numerators of
// scan_tile.cuh and scores the pair
//     balanced/affine: max(num_o^2 w[d], num_m^2 w[d])  (per orientation:
//                      balanced weights can be negative)
//     damped:          a = max(|num_o|, |num_m|);  c*(2a - t[d]) where
//                      a > t[d], else a^2 w[d]  (the orientations fold
//                      BEFORE the clip branch, unlike K1)
// Invalid domains never enter the list. The output is each range's C best
// domains, sorted by score, the lower domain index first on equal scores
// (the order of the TPU kernel's oracle, gain_topk_scan; the TPU kernel
// itself can order exact ties by its domain blocks), and -1 where fewer
// than C domains have a finite score.
//
// What bounds it here: as K1, the CUDA-core screen, 4 operations per pair
// for balanced and affine and 9 for damped (scan_tile.cuh): 114,688 ranges
// x 3,584 domains take at least 0.049 ms (balanced), 0.110 ms (damped).
// The design is scan_tile.cuh's (a tensor-core screen
// against the list's tail, then an exact float32 confirm of the few pairs
// that can enter); this file adds the policy:
//   * the confirm scores a pair as the plain version does (products and
//     sums rounded one by one, the fold, then the clip branch), so the
//     kernel lists bit for bit what topc_scan_ref lists;
//   * per range and thread a sorted (score, idx) list of C in registers (C
//     a template: 2, 4 or 8, the first C' entries of a top-C list being the
//     top-C' list); a confirmed candidate enters only when it beats the
//     list's tail by a strict >, and bubbles up from the tail with strict
//     > compares, which is the lowest-index rule since a thread confirms
//     its domains in increasing order;
//   * at the end the four lanes of a quad, whose lists hold disjoint
//     domains, merge by (score descending, index ascending);
//   * the output is (C, M) per file: each lobe column is contiguous for K2;
//   * blockIdx.z is the file of a stack (scan_tile.cuh).
// Fragment layout: A rows 0-7 = 8 ranges, rows 8-15 = the same reversed,
// so c0, c1 = num_o and c2, c3 = num_m of range g for domains 2t, 2t+1.
// Range sizes of 17 to 255 taps take topc_scan_wide_kernel instead
// (topc_wide.cuh, built in one source per block-shape class, on
// scan_wide.cuh: the same tensor-core screen against the list's tail and
// exact confirm at a runtime tap count, with A's fragments in shared
// memory; the same lists, sorted insertion and quad merge, then a merge
// over the warps that share a range).

#include "scan_tile.cuh"
#include "topc_keep.cuh"
#include "topc_wide.cuh"

namespace {

template <int N, int C, bool kClip>
__global__ void __launch_bounds__(fwav::Warp<N, C>::kThreads,
                                  fwav::Warp<N, C>::kMinBlocks)
    topc_scan_kernel(ScanArgs stack, int c_out, int* __restrict__ out_idx) {
  constexpr int MT = fwav::Warp<N, C>::kMT;
  __shared__ fwav::Stage<N> sm;
  const ScanArgs a = fwav::file_args<N>(stack, blockIdx.z);
  out_idx += (size_t)blockIdx.z * c_out * a.M;  // (B, c_out, M)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * fwav::kRangesPerBlock + warp * 8 * MT;

  TopcKeep<MT, C, kClip> keep;
  keep.c = a.c;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      keep.bs[mt][q] = -CUDART_INF_F;
      keep.bi[mt][q] = 0;
    }
  }
  fwav::scan<N, MT, kClip>(sm, a, 0, a.D, keep);

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      float os[C];
      int oi[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        os[q] = __shfl_xor_sync(0xffffffffu, keep.bs[mt][q], off);
        oi[q] = __shfl_xor_sync(0xffffffffu, keep.bi[mt][q], off);
      }
#pragma unroll
      for (int q = 0; q < C; ++q) insert<C>(keep.bs[mt], keep.bi[mt], os[q], oi[q], Beats());
    }
    const int m = m0 + 8 * mt + (lane >> 2);
    if ((lane & 3) == 0 && m < a.M) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (q < c_out)
          out_idx[(size_t)q * a.M + m] = isfinite(keep.bs[mt][q]) ? keep.bi[mt][q] : -1;
      }
    }
  }
}

template <int N, int C>
void launch_topc(const ScanArgs& a, int B, int c_out, int* out_idx, cudaStream_t stream) {
  const dim3 grid((a.M + fwav::kRangesPerBlock - 1) / fwav::kRangesPerBlock, 1, B);
  const int threads = fwav::Warp<N, C>::kThreads;
  if (a.thresh != nullptr)
    topc_scan_kernel<N, C, true><<<grid, threads, 0, stream>>>(a, c_out, out_idx);
  else
    topc_scan_kernel<N, C, false><<<grid, threads, 0, stream>>>(a, c_out, out_idx);
}

template <int N>
int launch_topc_c(const ScanArgs& a, int B, int C, int* out_idx, cudaStream_t stream) {
  if (C <= 2)
    launch_topc<N, 2>(a, B, C, out_idx, stream);
  else if (C <= 4)
    launch_topc<N, 4>(a, B, C, out_idx, stream);
  else if (C <= 8)
    launch_topc<N, 8>(a, B, C, out_idx, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// A stack of B files: r_c (B, M, N), bankT (B, N, D), w (B, D), valid
// (B, D), thresh (B, D) or null: float32 / int8, contiguous, on the device
// of `stream`; 4 <= N <= 255 (17 and up: the wide kernel); 1 <= C <= 8.
// Writes out_idx (B, C, M) int32. Returns
// cudaGetLastError() after the launch.
int fwav_topc_scan(const float* r_c, const float* bankT, const float* w,
                   const int8_t* valid, const float* thresh, float s_clip,
                   int B, int M, int N, int D, int C, int* out_idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{r_c, bankT, w, valid, thresh, s_clip, M, D};
  int code;
  switch (N) {
#define FWAV_CASE(K)                               \
  case K:                                          \
    code = launch_topc_c<K>(a, B, C, out_idx, st); \
    break;
    FWAV_CASE(4) FWAV_CASE(5) FWAV_CASE(6) FWAV_CASE(7) FWAV_CASE(8)
    FWAV_CASE(9) FWAV_CASE(10) FWAV_CASE(11) FWAV_CASE(12) FWAV_CASE(13)
    FWAV_CASE(14) FWAV_CASE(15) FWAV_CASE(16)
#undef FWAV_CASE
    default:
      if (N < fwav::kWideMinN || N > fwav::kWideMaxN || C > 8)
        return static_cast<int>(cudaErrorInvalidValue);
      code = fwav::wide_class(N) == 0   ? fwav::topc_wide_n64(a, B, N, C, out_idx, st)
             : fwav::wide_class(N) == 1 ? fwav::topc_wide_n128(a, B, N, C, out_idx, st)
                                        : fwav::topc_wide_n255(a, B, N, C, out_idx, st);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
