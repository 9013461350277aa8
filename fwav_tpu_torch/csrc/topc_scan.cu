// K3: the top-C coarse lobe scan, on Hopper.
//
// Replaces the Pallas TPU kernel `_topc_kernel` in
// fwav_tpu/ops/pallas_search.py, called through topc_search_scan_pallas:
// the damped profile's coarse scan, which keeps C lobes per range for the
// window refine (K2) to visit one column at a time. For every range m and
// every domain d of the stride-subsampled bank it computes
//     num_o = sum_j r_c[m, j] * bankT[j, d]
//     num_m = sum_j r_c[m, N-1-j] * bankT[j, d]
// and scores the pair
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
// What bounds it here: as K1, ~25 float32 operations per pair with K = 4
// taps, nothing for the tensor cores. The main path's scan is 114,688
// ranges x 3,584 domains with C = 4. The design:
//   * one thread per range, its N taps and its sorted (score, idx) list in
//     registers (C is a template, so the list is never spilled to local
//     memory); the thread sweeps the domains in increasing order and
//     inserts a candidate only when it beats the list's tail by a strict >,
//     then bubbles it up from the tail with strict > compares. That gives
//     exactly the stable global order with no cross-thread reduction; most
//     candidates fail the tail compare, so the list costs one compare per
//     pair;
//   * a block stages tiles of bankT, w, valid and thresh in shared memory,
//     read as broadcasts, as in K1;
//   * C is rounded up to 2, 4 or 8 for the instantiation: the first C
//     entries of a top-C' list are the top-C list, so only the first C
//     columns are written;
//   * the output is (C, M): each lobe column is contiguous for K2.
// The arithmetic uses explicit round-to-nearest intrinsics, so no
// multiply-add is contracted: the kernel computes bit for bit what the
// plain PyTorch version (ops/kernels.py topc_scan_ref) computes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileD = 256;

template <int N, int C>
__global__ void __launch_bounds__(kThreads) topc_scan_kernel(
    const float* __restrict__ r_c, const float* __restrict__ bankT,
    const float* __restrict__ w, const int8_t* __restrict__ valid,
    const float* __restrict__ thresh, float c, int M, int D, int c_out,
    int* __restrict__ out_idx) {
  __shared__ float s_bank[N][kTileD];
  __shared__ float s_w[kTileD];
  __shared__ float s_t[kTileD];
  __shared__ int8_t s_v[kTileD];

  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  const bool clip = thresh != nullptr;

  float r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = live ? r_c[(size_t)m * N + j] : 0.f;

  float bs[C];
  int bi[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    bs[k] = -CUDART_INF_F;
    bi[k] = 0;
  }
  for (int t0 = 0; t0 < D; t0 += kTileD) {
    const int nt = min(kTileD, D - t0);
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
      float sc;
      if (clip) {
        const float a = fmaxf(fabsf(no), fabsf(nm));
        const float t = s_t[k];
        sc = a > t ? __fmul_rn(c, __fsub_rn(__fmul_rn(2.f, a), t))
                   : __fmul_rn(__fmul_rn(a, a), wk);
      } else {
        sc = fmaxf(__fmul_rn(__fmul_rn(no, no), wk),
                   __fmul_rn(__fmul_rn(nm, nm), wk));
      }
      if (!s_v[k] || !(sc > bs[C - 1])) continue;
      // bubble up from the tail with a strict >: the candidate settles
      // behind every entry of an equal or higher score (all of lower
      // index), and the entries it passes shift down one place in order
      bool placed = false;
#pragma unroll
      for (int q = C - 1; q >= 1; --q) {
        if (!placed) {
          if (sc > bs[q - 1]) {
            bs[q] = bs[q - 1];
            bi[q] = bi[q - 1];
          } else {
            bs[q] = sc;
            bi[q] = t0 + k;
            placed = true;
          }
        }
      }
      if (!placed) {
        bs[0] = sc;
        bi[0] = t0 + k;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (q < c_out) out_idx[(size_t)q * M + m] = isfinite(bs[q]) ? bi[q] : -1;
    }
  }
}

template <int N>
int launch_topc(const float* r_c, const float* bankT, const float* w,
                const int8_t* valid, const float* thresh, float c, int M,
                int D, int C, int* out_idx, cudaStream_t stream) {
  const dim3 grid((M + kThreads - 1) / kThreads);
  if (C <= 2) {
    topc_scan_kernel<N, 2><<<grid, kThreads, 0, stream>>>(
        r_c, bankT, w, valid, thresh, c, M, D, C, out_idx);
  } else if (C <= 4) {
    topc_scan_kernel<N, 4><<<grid, kThreads, 0, stream>>>(
        r_c, bankT, w, valid, thresh, c, M, D, C, out_idx);
  } else if (C <= 8) {
    topc_scan_kernel<N, 8><<<grid, kThreads, 0, stream>>>(
        r_c, bankT, w, valid, thresh, c, M, D, C, out_idx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// r_c (M, N), bankT (N, D), w (D,), valid (D,), thresh (D,) or null:
// float32 / int8, contiguous, on the device of `stream`; 1 <= C <= 8.
// Writes out_idx (C, M) int32. Returns cudaGetLastError() after the launch.
int fwav_topc_scan(const float* r_c, const float* bankT, const float* w,
                   const int8_t* valid, const float* thresh, float s_clip,
                   int M, int N, int D, int C, int* out_idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  int code;
  switch (N) {
#define FWAV_CASE(K)                                                        \
  case K:                                                                   \
    code = launch_topc<K>(r_c, bankT, w, valid, thresh, s_clip, M, D, C,    \
                          out_idx, st);                                     \
    break;
    FWAV_CASE(4) FWAV_CASE(5) FWAV_CASE(6) FWAV_CASE(7) FWAV_CASE(8)
    FWAV_CASE(9) FWAV_CASE(10) FWAV_CASE(11) FWAV_CASE(12) FWAV_CASE(13)
    FWAV_CASE(14) FWAV_CASE(15) FWAV_CASE(16)
#undef FWAV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
