// The serialized bank of integer-valued files, on Hopper.
//
// It replaces no TPU kernel: the JAX package builds this bank on the host
// (fwav_tpu/ops/domains.py build_domains_host), and so did the port
// (ops/domains.py), numpy over float64 cumulative sums, while the card ran
// the encode program: 184.5 ms of host time for a 94 s file on an H100
// machine's host (PERF.md section 6). Where the stack's samples go to the
// card as int16 (models/encode.py _as_i16_or_f32: every sample a whole
// number within +-32767), this kernel builds the same bank there from the
// samples the program already holds, and models/refit.py copies its rows
// back into pinned host memory.
//
// For file b of the stack, with bl = tile_size / range_size, row i < n_b
// (n_b the file's domain count), column j < range_size:
//   bank[b, i, j] = S * (1.0 / bl), S = x[b, i*step + j*bl] + ... +
//   x[b, i*step + j*bl + bl - 1] as an exact integer,
// the product taken in float64 and rounded to float32 to nearest. The host
// build computes cs[a] - cs[b] of float64 prefix sums of the same whole
// numbers, each exact below 2^53, so the same S whatever the order of the
// sums; then the same float64 product and the same rounding: the same bits
// (the one exception, a -0.0 first mean where a float signal begins with
// -0.0 samples, is the caller's: int16 has no sign of zero). Rows from n_b
// on are not written.
//
// What bounds it: its output, 4 * range_size bytes a row against 2 bytes
// a sample read (a 70 s file at tile 1024: 49.4 MB out, 6.2 MB in, ~17 us
// at 3.35 TB/s). The design: a block takes R consecutive rows of one file
// (a contiguous run of R * range_size floats of the row-major bank); it
// stages the samples those rows read, the run [r0 * step, (r0 + R - 1) *
// step + range_size * bl), through a shared-memory prefix scan of 32-bit
// integers (exact as differences: every block sum is below 2^31 in
// magnitude, so the scan may wrap), so that each block sum is two
// shared-memory reads; and it writes its rows as 16-byte stores, lane by
// lane over consecutive addresses. Where the run does not fit in shared
// memory (range_size * bl samples over ~23,000: tiles past 23,552), the
// columns go in passes, each staging its own columns' run, and the rows
// are written a float at a time. The scan takes 4 samples a thread a
// round: a warp's shuffles, then the block's 8 warp totals. Measured on an
// H100 (PERF.md section 6): 0.048 ms at 94 s, 46% of that bound; the copy
// of its rows to the host takes 1.2 ms.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4 * kThreads;  // samples a block scans a round
constexpr unsigned kAll = 0xffffffffu;
// Most files a launch takes (their domain counts ride in the launch's
// parameters); a packed stack holds at most 16 (models/encode.py PACK_B_MAX).
constexpr int kMaxFiles = 64;
// Shared memory a block may take for its prefix sums: 96 KB of words, and
// so at most kMaxStaged samples staged a pass (4 words ahead of the run,
// the run rounded up to whole rounds).
constexpr int kMaxWords = 24576;
constexpr int kMaxStaged = kMaxWords - kChunk;
// Floats a block writes (16 KB): 1,024 rows at 4 taps.
constexpr int kRowFloats = 4096;

struct Files {
  int n_domains[kMaxFiles];
};

// q[3] = 0 and q[4 + s] = x[p0] + ... + x[p0 + s] (mod 2^32) over a pass's
// staged run from p0, so the block sum at run offset p is
// q[3 + p + bl] - q[3 + p].
__global__ void __launch_bounds__(kThreads) bank_means_kernel(
    const int16_t* __restrict__ x, long long nb, const Files files, long long D, int n,
    int bl, int step, int R, int G, double inv, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t q[];
  __shared__ uint32_t warp_sum[kWarps];
  const int b = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const long long nd = files.n_domains[b];
  if (r0 >= nd) return;
  const int rows = static_cast<int>(nd - r0 < R ? nd - r0 : R);
  const int16_t* __restrict__ xb = x + b * nb;
  float* __restrict__ ob = out + (b * D + r0) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) q[3] = 0u;
  for (int j0 = 0; j0 < n; j0 += G) {
    const int g = n - j0 < G ? n - j0 : G;
    const long long p0 = r0 * step + static_cast<long long>(j0) * bl;
    const int S = (rows - 1) * step + g * bl;  // samples this pass stages
    uint32_t carry = 0u;
    for (int base = 0; base < S; base += kChunk) {
      const int s0 = base + 4 * threadIdx.x;
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long p = p0 + s0 + i;
        v[i] = s0 + i < S && p < nb ? static_cast<uint32_t>(static_cast<int>(__ldg(xb + p)))
                                    : 0u;
      }
      v[1] += v[0];
      v[2] += v[1];
      v[3] += v[2];
      uint32_t incl = v[3];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += t;
      }
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      uint32_t start = carry + incl - v[3], total = carry;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t t = warp_sum[w];
        total += t;
        if (w < warp) start += t;
      }
      reinterpret_cast<uint4*>(q + 4 + base)[threadIdx.x] =
          make_uint4(start + v[0], start + v[1], start + v[2], start + v[3]);
      carry = total;
      __syncthreads();  // warp_sum is rewritten next round; q is whole after the last
    }
    const int E = rows * g;  // this pass's outputs, row-major over (row, column)
    for (int e0 = 4 * threadIdx.x; e0 < E; e0 += kChunk) {
      float r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[i] = 0.f;
        const int e = e0 + i;
        if (e < E) {
          const int k = e / g, p = k * step + (e - k * g) * bl;
          const int sum = static_cast<int>(q[3 + p + bl] - q[3 + p]);
          r[i] = __double2float_rn(__dmul_rn(__int2double_rn(sum), inv));
        }
      }
      if (g == n && e0 + 3 < E) {  // the rows' run itself, 16-byte aligned
        *reinterpret_cast<float4*>(ob + e0) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = e0 + i;
          if (e < E) {
            const int k = e / g;
            ob[static_cast<long long>(k) * n + j0 + (e - k * g)] = r[i];
          }
        }
      }
    }
    __syncthreads();  // the next pass rewrites q
  }
}

}  // namespace

extern "C" {

// A stack of B files: x (B, nb) int16 contiguous; n_domains B host ints,
// each in [0, D], the file's rows reading samples below nb; out (B, D, n)
// float32 contiguous, 16-byte aligned, D a multiple of 4; bl =
// tile_size / n block length, step the domain step. Writes rows i <
// n_domains[b] of each file. Returns cudaGetLastError() after the launch
// (cudaSuccess with nothing launched where every count is 0).
int fwav_bank_means(const int16_t* x, int B, long long nb, const int* n_domains, long long D,
                    int n, int bl, int step, float* out, void* stream) {
  if (B < 1 || B > kMaxFiles || n < 1 || bl < 1 || bl > 16384 || step < 1 ||
      3LL * step + bl > kMaxStaged || D < 4 || D % 4 != 0 || nb < 1 ||
      reinterpret_cast<size_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Files files{};
  long long most = 0;
  for (int b = 0; b < B; ++b) {
    const long long nd = n_domains[b];
    if (nd < 0 || nd > D || (nd > 0 && (nd - 1) * step + static_cast<long long>(n) * bl > nb))
      return static_cast<int>(cudaErrorInvalidValue);
    files.n_domains[b] = static_cast<int>(nd);
    most = nd > most ? nd : most;
  }
  if (most == 0) return static_cast<int>(cudaSuccess);
  // R rows a block (a multiple of 4, so every block's run starts 16-byte
  // aligned), G columns a pass: all of them where the run fits
  int R = kRowFloats / n / 4 * 4;
  if (R < 4) R = 4;
  const int fit = ((kMaxStaged - bl) / step + 1) / 4 * 4;
  if (R > fit) R = fit;
  const long long rest = kMaxStaged - static_cast<long long>(R - 1) * step;
  const int G = rest >= static_cast<long long>(n) * bl ? n : static_cast<int>(rest / bl);
  const int staged = (R - 1) * step + G * bl;
  const size_t smem = (4 + (staged + kChunk - 1) / kChunk * kChunk) * sizeof(uint32_t);
  if (smem > (48 << 10)) {
    const cudaError_t e = cudaFuncSetAttribute(
        bank_means_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((most + R - 1) / R), B);
  bank_means_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, nb, files, D, n, bl, step, R, G, 1.0 / bl, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
