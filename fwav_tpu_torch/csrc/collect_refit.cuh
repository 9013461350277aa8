// The exact affine refit of one range against its selected bank row, in
// the arithmetic of the host's native refit (native/fwavio.cpp refit_one),
// for the card (csrc/collect_refit.cu) and for a host build of this header
// alone (tests/test_torch_kernels.py, g++ -ffp-contract=off).
//
// The rule is ops/affine.py refit_host's: means, then the centred sums
// num_o, num_m (the range mirrored), denom and rcss in index order; the
// mirror wins only where |num_m| > |num_o| + 1e-5 sqrt(rcss) sqrt(denom);
// s = num / (denom + 1e-12), o = mean(r) - s mean(t), err the residual's
// norm at the unclipped s, then s clipped to +-clip.
//
// Its bits depend on how the host compiler built refit_one: g++ -O3
// -march=native on a host with FMA (every H100 host) contracts a product
// into the sum that takes it (one FMA), and where it vectorizes the
// generic range size it rounds the products of whole 8- and 4-wide blocks
// before adding them lane by lane. Each float operation here is explicit
// (__fmaf_rn, __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn on the
// card), so nvcc's own contraction decides nothing, and `mode` names the
// host build to follow:
//   kFused   every product fused into its sum, the tie bound's
//            1e-5 sqrt(rcss) * sqrt(denom) into |num_o| +, the residual's
//            s * tc into rc -, and s * mean(t) into mean(r) - (g++ 12 and
//            13 at -march=native for range sizes 4, 8 and 16);
//   kVector8 as kFused, but in the four sums and the residual's square sum
//            the products of the first vector_head(n) terms are rounded
//            first (the same builds for every other range size, whose
//            loops g++ vectorizes 8 and then 4 lanes wide).
// models/refit.py picks, per card and range size, the mode whose records
// equal the native refit's on a fixed set of inputs, and raises where
// neither does.

#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define FWAV_HD __host__ __device__ __forceinline__
#else
#define FWAV_HD inline
#endif

namespace fwav_refit {

enum Mode : int { kFused = 0, kVector8 = 1 };
constexpr int kModes = 2;

FWAV_HD float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
FWAV_HD float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
FWAV_HD float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
FWAV_HD float quot(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
FWAV_HD float fmadd(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}
FWAV_HD float mag(float a) {
#ifdef __CUDA_ARCH__
  return fabsf(a);
#else
  return std::fabs(a);
#endif
}
FWAV_HD float root(float a) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(a);
#else
  return std::sqrt(a);
#endif
}

// Terms of an n-long loop that g++'s vectorized body takes: whole blocks
// of 8, then one of 4 where 4 or more remain.
FWAV_HD int vector_head(int n) { return n / 8 * 8 + (n % 8 >= 4 ? 4 : 0); }

struct Fit {
  float s, o, err;
  bool sym;
};

// r(j), t(j): the range's and the bank row's j-th value; N the range size
// where it is fixed (4, 8, 16), 0 for n_rt.
template <int N, class R, class T>
FWAV_HD Fit refit(const R& r, const T& t, int n_rt, float clip, int mode) {
  const int n = N > 0 ? N : n_rt;
  const int head = mode == kVector8 ? vector_head(n) : 0;
  const float invn = quot(1.0f, static_cast<float>(n));
  float rsum = 0.f, tsum = 0.f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    rsum = add(rsum, r(j));
    tsum = add(tsum, t(j));
  }
  const float rm = mul(rsum, invn), tm = mul(tsum, invn);
  float num_o = 0.f, num_m = 0.f, denom = 0.f, rcss = 0.f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float rc = sub(r(j), rm);
    const float tc = sub(t(j), tm);
    const float rcm = sub(r(n - 1 - j), rm);
    if (j < head) {
      num_o = add(num_o, mul(rc, tc));
      num_m = add(num_m, mul(rcm, tc));
      denom = add(denom, mul(tc, tc));
      rcss = add(rcss, mul(rc, rc));
    } else {
      num_o = fmadd(rc, tc, num_o);
      num_m = fmadd(rcm, tc, num_m);
      denom = fmadd(tc, tc, denom);
      rcss = fmadd(rc, rc, rcss);
    }
  }
  const float tol_r = mul(1e-5f, root(rcss)), sd = root(denom);
  const float bound = fmadd(tol_r, sd, mag(num_o));
  const bool sym = mag(num_m) > bound;
  const float s = quot(sym ? num_m : num_o, add(denom, 1e-12f));
  float e2 = 0.f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float rc = sub(sym ? r(n - 1 - j) : r(j), rm);
    const float tc = sub(t(j), tm);
    const float v = fmadd(-s, tc, rc);
    e2 = j < head ? add(e2, mul(v, v)) : fmadd(v, v, e2);
  }
  Fit f;
  f.s = s > clip ? clip : (s < -clip ? -clip : s);
  f.o = fmadd(-s, tm, rm);
  f.err = root(e2);
  f.sym = sym;
  return f;
}

FWAV_HD void put_word(uint8_t* out, uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = static_cast<uint8_t>(w >> (8 * k));
}

FWAV_HD uint32_t bits(float f) {
  union {
    float f;
    uint32_t u;
  } v{f};
  return v.u;
}

// The 17-byte MATCH record (io/container.py MATCH_DTYPE: idx i32, s f32,
// o f32, sym u8, err f32, little-endian, packed) at out, byte by byte: a
// record is not word-aligned.
FWAV_HD void put_record(uint8_t* out, int32_t idx, float s, float o, uint8_t sym, float err) {
  put_word(out, static_cast<uint32_t>(idx));
  put_word(out + 4, bits(s));
  put_word(out + 8, bits(o));
  out[12] = sym;
  put_word(out + 13, bits(err));
}

}  // namespace fwav_refit
