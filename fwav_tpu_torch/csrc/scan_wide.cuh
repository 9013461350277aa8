// The wide scan of K1 (search_scan.cu) and K3 (topc_scan.cu): range sizes N
// of 17 to 255 taps (tiles from 4352 samples, N = tile_size / 256), with N
// a runtime value.
//
// The tensor-core path of scan_tile.cuh keeps a thread's ranges in
// registers as MMA fragments and is instantiated for N up to 16; 255 taps
// fit no thread's registers. These scans are rarer (a tile of 4352 or more
// gives a bank 16-64 times smaller than the default's), so this path is
// the plain one: every (range, domain) pair is scored in exact float32, in
// the order of scan_tile.cuh's confirm (products and sums rounded one by
// one, tap by tap), and kept by the same policies (ArgmaxKeep, TopcKeep)
// with the same lowest-index rule. The kernels therefore pick bit for bit
// what search_scan_ref and topc_scan_ref pick.
//
// What bounds it here: the CUDA cores, 4N operations per pair (two
// products and two sums a tap, for both orientations, none of them fused,
// so that the rounding is the plain version's): at the exact branch of a
// 10 s file at tile 16384 (7,168 ranges x 28,672 domains, N = 64) at least
// 1.6 ms. What the design does about it: a block holds 32 ranges (one a
// lane) in shared memory, rows padded to an odd stride so that the 32
// lanes read 32 banks; a staged tile of 32 domains (taps, w, t, valid)
// sits beside them; each of the 4 warps scores 8 domains of the tile for
// its 32 ranges, the taps read as two 16-byte loads that every lane of the
// warp shares, so a tap costs 2 scalar and 2 vector loads for 32 exact
// operations. A thread meets its domains in increasing order, so a strict
// > keeps the lowest index; at the end the 4 warps' results for a range
// merge by (score descending, index ascending).

#pragma once

#include "scan_tile.cuh"

namespace fwav {

constexpr int kWideLanes = 32;  // ranges per block, one per lane
constexpr int kWideWarps = 4;   // each scores a slice of every staged tile
constexpr int kWidePer = 8;     // domains per thread and tile
constexpr int kWideTileD = kWideWarps * kWidePer;  // domains per staged tile
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideMinN = 17;
constexpr int kWideMaxN = 255;

// A range's row in shared memory: N padded to an odd count of floats.
__host__ __device__ constexpr int wide_row(int N) { return N | 1; }

// Dynamic shared memory of a wide block: the ranges (kWideLanes rows), the
// tile's taps (N, kWideTileD), then w, t and valid of the tile.
__host__ __device__ constexpr size_t wide_smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)kWideLanes * wide_row(N) + (size_t)N * kWideTileD + 3 * kWideTileD);
}

// file_args for a runtime N.
__device__ __forceinline__ ScanArgs wide_file_args(ScanArgs a, int b, int N) {
  a.r_c += (size_t)b * a.M * N;
  a.bankT += (size_t)b * N * a.D;
  a.w += (size_t)b * a.D;
  a.valid += (size_t)b * a.D;
  if (a.thresh != nullptr) a.thresh += (size_t)b * a.D;
  return a;
}

// The sweep of one block over domains [d0, d1) for its 32 ranges: every
// valid pair scored by keep.exact and offered to keep.keep(0, ...) in
// increasing domain order per thread. `smem` holds wide_smem_bytes(N).
template <bool kClip, class Keep>
__device__ __forceinline__ void wide_scan(float* smem, const ScanArgs& a, int N, int d0,
                                          int d1, Keep& keep) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = wide_row(N);
  float* r = smem;                    // [kWideLanes][row]
  float* b = r + kWideLanes * row;    // [N][kWideTileD], 16-byte aligned (32 rows)
  float* w = b + N * kWideTileD;      // [kWideTileD]
  float* t = w + kWideTileD;          // [kWideTileD]
  int* v = reinterpret_cast<int*>(t + kWideTileD);
  const int m0 = blockIdx.x * kWideLanes;
  for (int e = threadIdx.x; e < kWideLanes * N; e += blockDim.x) {
    const int i = e / N, j = e - i * N;
    r[i * row + j] = m0 + i < a.M ? a.r_c[(size_t)(m0 + i) * N + j] : 0.f;
  }
  const float* rr = r + lane * row;
  const int k0 = warp * kWidePer;
  for (int t0 = d0; t0 < d1; t0 += kWideTileD) {
    const int nt = min(kWideTileD, d1 - t0);
    __syncthreads();  // the ranges are written; the previous tile is read
    for (int e = threadIdx.x; e < N * kWideTileD; e += blockDim.x) {
      const int j = e / kWideTileD, k = e - j * kWideTileD;
      b[e] = k < nt ? a.bankT[(size_t)j * a.D + t0 + k] : 0.f;
    }
    for (int k = threadIdx.x; k < kWideTileD; k += blockDim.x) {
      const bool in = k < nt;
      w[k] = in ? a.w[t0 + k] : 0.f;
      t[k] = in && kClip ? a.thresh[t0 + k] : 0.f;
      v[k] = in && a.valid[t0 + k] != 0;
    }
    __syncthreads();
    float no[kWidePer], nm[kWidePer];
    {
      const float x = rr[0], y = rr[N - 1];
#pragma unroll
      for (int q = 0; q < kWidePer; ++q) {
        no[q] = __fmul_rn(x, b[k0 + q]);
        nm[q] = __fmul_rn(y, b[k0 + q]);
      }
    }
    for (int j = 1; j < N; ++j) {
      const float x = rr[j], y = rr[N - 1 - j];
      const float4 lo = *reinterpret_cast<const float4*>(&b[j * kWideTileD + k0]);
      const float4 hi = *reinterpret_cast<const float4*>(&b[j * kWideTileD + k0 + 4]);
      const float bq[kWidePer] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = 0; q < kWidePer; ++q) {
        no[q] = __fadd_rn(no[q], __fmul_rn(x, bq[q]));
        nm[q] = __fadd_rn(nm[q], __fmul_rn(y, bq[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < kWidePer; ++q) {
      const int k = k0 + q;
      if (v[k]) keep.keep(0, keep.exact(no[q], nm[q], w[k], t[k]), t0 + k);
    }
  }
}

}  // namespace fwav
