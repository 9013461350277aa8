// K3's keep policy (topc_scan.cu, and its wide kernels in topc_wide.cuh):
// per range and thread a sorted (score, idx) list of C, the exact score of
// topc_scan_ref, and the sorted insertion with its two orders.

#pragma once

#include "scan_tile.cuh"

namespace {

using fwav::ScanArgs;

// Insert (s, i) into the sorted list if it beats the tail in the order
// `Better`; unrolled, so the list stays in registers.
template <int C, class Better>
__device__ __forceinline__ void insert(float (&bs)[C], int (&bi)[C], float s, int i,
                                       Better better) {
  if (!better(s, i, bs[C - 1], bi[C - 1])) return;
  bool placed = false;
#pragma unroll
  for (int q = C - 1; q >= 1; --q) {
    if (!placed) {
      if (better(s, i, bs[q - 1], bi[q - 1])) {
        bs[q] = bs[q - 1];
        bi[q] = bi[q - 1];
      } else {
        bs[q] = s;
        bi[q] = i;
        placed = true;
      }
    }
  }
  if (!placed) {
    bs[0] = s;
    bi[0] = i;
  }
}

struct Greater {  // in-thread order: later domains have higher indices
  __device__ __forceinline__ bool operator()(float sa, int, float sb, int) const {
    return sa > sb;
  }
};

struct Beats {
  __device__ __forceinline__ bool operator()(float sa, int ia, float sb, int ib) const {
    return fwav::beats(sa, ia, sb, ib);
  }
};

template <int MT, int C, bool kClip>
struct TopcKeep {
  static constexpr int kRank = C;  // a pick must reach the C-th best

  float bs[MT][C];
  int bi[MT][C];
  float c;

  // topc_scan_ref's score: damped a = max(|num_o|, |num_m|), c (2a - t)
  // where a > t, else a^2 w; otherwise max(num_o^2 w, num_m^2 w)
  __device__ __forceinline__ float exact(float no, float nm, float w, float t) const {
    if (kClip) {
      const float a = fmaxf(fabsf(no), fabsf(nm));
      return a > t ? __fmul_rn(__fsub_rn(__fmul_rn(2.f, a), t), c)
                   : __fmul_rn(__fmul_rn(a, a), w);
    }
    return fmaxf(__fmul_rn(__fmul_rn(no, no), w), __fmul_rn(__fmul_rn(nm, nm), w));
  }
  __device__ __forceinline__ void keep(int mt, float s, int d) {
    if (s > bs[mt][C - 1]) insert<C>(bs[mt], bi[mt], s, d, Greater());
  }
  __device__ __forceinline__ float entry(int mt, int k) const { return bs[mt][k]; }
};

}  // namespace
