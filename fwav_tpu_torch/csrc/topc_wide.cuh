// K3's wide kernel (range sizes of 17 to 255 taps; scan_wide.cuh), one
// block-shape class per source (topc_wide_n64.cu, topc_wide_n128.cu,
// topc_wide_n255.cu), so that nvcc builds the classes in parallel;
// topc_scan.cu's fwav_topc_scan calls their entry points.

#pragma once

#include "scan_wide.cuh"
#include "topc_keep.cuh"

namespace fwav {

// K3 at N of 17 to 255 taps in the block shape of classes 0, 1 and 2
// (wide_class), C of 1 to 8: as fwav_topc_scan's wide branch.
int topc_wide_n64(const ScanArgs& a, int B, int N, int C, int* out_idx, cudaStream_t stream);
int topc_wide_n128(const ScanArgs& a, int B, int N, int C, int* out_idx, cudaStream_t stream);
int topc_wide_n255(const ScanArgs& a, int B, int N, int C, int* out_idx, cudaStream_t stream);

}  // namespace fwav

namespace {

// The wide scan (N of 17 to 255, a runtime value; scan_wide.cuh) in block
// shape class kCls: each thread's sorted list of its ranges over its slice
// of every tile, merged over the quad as topc_scan_kernel does, then the
// other kDG - 1 warps' lists of a range inserted into the first's through
// shared memory by (score descending, index ascending). Output as
// topc_scan_kernel's, with WideShape::kRanges ranges a block.
template <int kCls, int C, bool kClip>
__global__ void __launch_bounds__(fwav::WideShape<kCls, C>::kThreads, 1)
    topc_scan_wide_kernel(ScanArgs stack, int N, int c_out, int* __restrict__ out_idx) {
  using Shape = fwav::WideShape<kCls, C>;
  constexpr int MT = Shape::kMT, R = Shape::kRanges, DG = Shape::kDG;
  extern __shared__ float4 wide_smem[];
  const ScanArgs a = fwav::wide_file_args(stack, blockIdx.z, N);
  out_idx += (size_t)blockIdx.z * c_out * a.M;  // (B, c_out, M)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

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
  fwav::wide_scan<Shape, kClip>(wide_smem, a, N, 0, a.D, keep);

  // [DG][R][C] partial lists in the scan's buffer (wide_scan ends with a
  // barrier)
  float* part_s = reinterpret_cast<float*>(wide_smem);
  int* part_i = reinterpret_cast<int*>(part_s + DG * R * C);
  const int dg = warp;  // the warp's slice of every tile's domains
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
    if ((lane & 3) == 0) {
      const int row = 8 * mt + (lane >> 2);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        part_s[(dg * R + row) * C + q] = keep.bs[mt][q];
        part_i[(dg * R + row) * C + q] = keep.bi[mt][q];
      }
    }
  }
  __syncthreads();
  for (int row = threadIdx.x; row < R; row += blockDim.x) {
    float bs[C];
    int bi[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      bs[q] = part_s[row * C + q];
      bi[q] = part_i[row * C + q];
    }
    for (int w = 1; w < DG; ++w) {
#pragma unroll
      for (int q = 0; q < C; ++q)
        insert<C>(bs, bi, part_s[(w * R + row) * C + q], part_i[(w * R + row) * C + q],
                  Beats());
    }
    const int m = blockIdx.x * R + row;
    if (m < a.M) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (q < c_out) out_idx[(size_t)q * a.M + m] = isfinite(bs[q]) ? bi[q] : -1;
      }
    }
  }
}

template <int kCls, int C, bool kClip>
int launch_wide(const ScanArgs& a, int B, int N, int c_out, int* out_idx,
                cudaStream_t stream) {
  using Shape = fwav::WideShape<kCls, C>;
  const dim3 grid((a.M + Shape::kRanges - 1) / Shape::kRanges, 1, B);
  const size_t smem = fwav::wide_smem_bytes<Shape>(N);
  const cudaError_t e = cudaFuncSetAttribute(topc_scan_wide_kernel<kCls, C, kClip>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  topc_scan_wide_kernel<kCls, C, kClip><<<grid, Shape::kThreads, smem, stream>>>(
      a, N, c_out, out_idx);
  return 0;
}

template <int kCls, int C>
int launch_wide_clip(const ScanArgs& a, int B, int N, int c_out, int* out_idx,
                     cudaStream_t stream) {
  return a.thresh != nullptr ? launch_wide<kCls, C, true>(a, B, N, c_out, out_idx, stream)
                             : launch_wide<kCls, C, false>(a, B, N, c_out, out_idx, stream);
}

// C of 1 to 4 takes the list of 4 (its first C entries are the top-C list).
template <int kCls>
int launch_wide_c(const ScanArgs& a, int B, int N, int C, int* out_idx, cudaStream_t stream) {
  return C <= 4 ? launch_wide_clip<kCls, 4>(a, B, N, C, out_idx, stream)
                : launch_wide_clip<kCls, 8>(a, B, N, C, out_idx, stream);
}

}  // namespace
