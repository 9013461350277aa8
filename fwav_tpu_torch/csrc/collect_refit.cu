// The host refit on Hopper: a stack's 3-byte codes to packed MATCH records.
//
// It replaces no TPU kernel: the JAX package ships each range's selected
// bank row to the host as a 3-byte code and refits s, o, err and the
// orientation there (fwav_tpu/models/encode.py collect_idx_matches, the
// native fwav_collect of native/fwavio.cpp), and so did the port: one host
// thread gathering the rows the card already held, 3.4 ms for a 10 s file
// and 37 ms for a 94 s one on an H100 machine's host (PERF.md section 6).
// Where the stack's samples reach the card as int16, its bank is built
// there (csrc/bank_means.cu), so every input of that pass is on the card
// when the program ends: this kernel makes the records there, and
// models/refit.py copies them back in place of the codes.
//
// For file b of the stack, range i < n_ranges[b] (one thread a range):
// code c = codes[b, i] (3 bytes, little-endian); 0xFFFFFF gives the
// sentinel record (-1, 1, 0, 0, 0); c < n_domains[b] the refit of
// collect_refit.cuh against bank[b, c] with the range's samples as float32
// (exact for int16), the last range's tail reflected as numpy's
// pad(mode="reflect") makes it (sample len + k is sample len - 2 - k); a
// code at or past n_domains[b] counts as bad and gives a sentinel (the
// host raises). A file's records start at rec0[b], its range count
// rounded up to 16 ahead of it, so that each block's 128 records are
// 2,176 bytes at a 16-byte boundary: a block builds them in shared memory
// and stores them as 16-byte words. The ranges from n_ranges[b] to the
// next multiple of 16 hold sentinels. After the records, two int32 a file:
// its live records and its bad codes.
//
// What bounds it: ~44 bytes a range (3 of code, 8 of samples, 16 of bank
// row, 17 of record), 4.8 MB for a 10 s file at range size 4: ~1.5 us at
// 3.35 TB/s; the row gathers are random 16-byte reads.

#include <cuda_runtime.h>

#include <cstdint>

#include "collect_refit.cuh"

namespace {

constexpr int kThreads = 128;  // ranges a block
constexpr int kRecord = 17;    // bytes a MATCH record
constexpr int kAlign = 16;     // records a file's run is rounded up to
// Most files a launch takes (their counts ride in the launch's parameters);
// a packed stack holds at most 16 (models/encode.py PACK_B_MAX).
constexpr int kMaxFiles = 64;
constexpr uint32_t kSentinel = 0xFFFFFFu;

struct Files {
  long long len[kMaxFiles];
  long long rec0[kMaxFiles];
  int n_ranges[kMaxFiles];
  int n_domains[kMaxFiles];
};

template <int N>
__global__ void __launch_bounds__(kThreads) collect_refit_kernel(
    const uint8_t* __restrict__ codes, long long rb, const int16_t* __restrict__ x,
    long long nb, const float* __restrict__ bank, long long D, int n, float clip, int mode,
    const Files files, uint8_t* __restrict__ out, int* __restrict__ flags) {
  __shared__ __align__(16) uint8_t staged[kThreads * kRecord];
  const int b = blockIdx.y;
  const long long R = files.n_ranges[b];
  const long long run = (R + kAlign - 1) / kAlign * kAlign;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads;
  if (i0 >= run) return;
  const long long i = i0 + threadIdx.x;
  int32_t idx = -1;
  float s = 1.f, o = 0.f, err = 0.f;
  uint8_t sym = 0;
  int live = 0, bad = 0;
  if (i < R) {
    const uint8_t* cp = codes + (b * rb + i) * 3;
    const uint32_t c = cp[0] | (static_cast<uint32_t>(cp[1]) << 8) |
                       (static_cast<uint32_t>(cp[2]) << 16);
    if (c != kSentinel && c >= static_cast<uint32_t>(files.n_domains[b])) {
      bad = 1;
    } else if (c != kSentinel) {
      live = 1;
      const long long len = files.len[b];
      const int16_t* __restrict__ xb = x + b * nb;
      const float* __restrict__ row = bank + (b * D + c) * n;
      // sample p of the reflect-padded file
      auto sample = [&](long long p) {
        return static_cast<float>(__ldg(xb + (p < len ? p : 2 * (len - 1) - p)));
      };
      fwav_refit::Fit f;
      if constexpr (N > 0) {
        float rr[N], tt[N];
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row + j));
          tt[j] = v.x;
          tt[j + 1] = v.y;
          tt[j + 2] = v.z;
          tt[j + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) rr[j] = sample(i * N + j);
        f = fwav_refit::refit<N>([&](int j) { return rr[j]; }, [&](int j) { return tt[j]; },
                                 N, clip, mode);
      } else {
        f = fwav_refit::refit<0>([&](int j) { return sample(i * n + j); },
                                 [&](int j) { return __ldg(row + j); }, n, clip, mode);
      }
      idx = static_cast<int32_t>(c);
      s = f.s;
      o = f.o;
      err = f.err;
      sym = f.sym;
    }
  }
  fwav_refit::put_record(staged + threadIdx.x * kRecord, idx, s, o, sym, err);
  const int lives = __syncthreads_count(live);  // also: every record is staged
  const int bads = __syncthreads_count(bad);
  if (threadIdx.x == 0) {
    if (lives) atomicAdd(flags + 2 * b, lives);
    if (bads) atomicAdd(flags + 2 * b + 1, bads);
  }
  const long long count = run - i0 < kThreads ? run - i0 : kThreads;  // a multiple of 16
  uint4* dst = reinterpret_cast<uint4*>(out + (files.rec0[b] + i0) * kRecord);
  const uint4* src = reinterpret_cast<const uint4*>(staged);
  for (int k = threadIdx.x; k < count * kRecord / 16; k += kThreads) dst[k] = src[k];
}

template <int N>
cudaError_t launch(const dim3& grid, cudaStream_t stream, const uint8_t* codes, long long rb,
                   const int16_t* x, long long nb, const float* bank, long long D, int n,
                   float clip, int mode, const Files& files, uint8_t* out, int* flags) {
  collect_refit_kernel<N><<<grid, kThreads, 0, stream>>>(codes, rb, x, nb, bank, D, n, clip,
                                                         mode, files, out, flags);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A stack of B files: codes (B, rb, 3) uint8 contiguous; x (B, nb) int16
// contiguous; bank (B, D, n) float32 contiguous, 16-byte aligned for n 4,
// 8 and 16; per file (host arrays) its sample count len[b] (>= n, <= nb),
// n_ranges[b] = ceil(len[b] / n) (<= rb) and n_domains[b] (<= D); mode one
// of collect_refit.cuh's. out: 16-byte aligned, out_bytes = 17 * total + 8
// * B with total the sum of the n_ranges rounded up to 16 each; file b's
// records from 17 * (the earlier files' rounded counts). Zeroes the flags
// and launches once on `stream`. Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue on arguments out of these bounds.
int fwav_collect_refit(const uint8_t* codes, int B, long long rb, const int16_t* x,
                       long long nb, const float* bank, long long D, int n, float s_clip,
                       int mode, const long long* len, const int* n_ranges,
                       const int* n_domains, uint8_t* out, long long out_bytes,
                       void* stream) {
  if (B < 1 || B > kMaxFiles || n < 1 || mode < 0 || mode >= fwav_refit::kModes || rb < 1 ||
      nb < 1 || D < 1 || reinterpret_cast<size_t>(out) % 16 != 0 ||
      ((n == 4 || n == 8 || n == 16) && reinterpret_cast<size_t>(bank) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Files files{};
  long long total = 0, most = 0;
  for (int b = 0; b < B; ++b) {
    if (len[b] < n || len[b] > nb || n_ranges[b] != (len[b] + n - 1) / n ||
        n_ranges[b] > rb || n_domains[b] < 0 || n_domains[b] > D)
      return static_cast<int>(cudaErrorInvalidValue);
    files.len[b] = len[b];
    files.n_ranges[b] = n_ranges[b];
    files.n_domains[b] = n_domains[b];
    files.rec0[b] = total;
    const long long run = (n_ranges[b] + kAlign - 1) / kAlign * kAlign;
    total += run;
    most = run > most ? run : most;
  }
  if (out_bytes != total * kRecord + 8LL * B) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* flags = reinterpret_cast<int*>(out + total * kRecord);
  cudaError_t e = cudaMemsetAsync(flags, 0, 8 * B, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((most + kThreads - 1) / kThreads), B);
  const float clip = s_clip < 0 ? -s_clip : s_clip;
  switch (n) {
    case 4:
      e = launch<4>(grid, st, codes, rb, x, nb, bank, D, n, clip, mode, files, out, flags);
      break;
    case 8:
      e = launch<8>(grid, st, codes, rb, x, nb, bank, D, n, clip, mode, files, out, flags);
      break;
    case 16:
      e = launch<16>(grid, st, codes, rb, x, nb, bank, D, n, clip, mode, files, out, flags);
      break;
    default:
      e = launch<0>(grid, st, codes, rb, x, nb, bank, D, n, clip, mode, files, out, flags);
  }
  return static_cast<int>(e);
}

}  // extern "C"
