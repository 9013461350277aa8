// fwavio — native .fwav container runtime.
//
// The reference's native muscle is third-party (hnswlib C++, CuPy CUDA); its
// own container I/O is a per-record Python struct loop (fractal.py:1308-1317,
// 1352-1365). This is the first-party native replacement: single-pass
// serialize/parse with an in-line SHA-256 over the payload, no intermediate
// buffers, O(bytes) with zero interpreter time. Bound from Python via ctypes
// (io/native.py) with transparent fallback to the pure-Python path.
//
// Build: g++ -O3 -shared -fPIC -o libfwavio.so fwavio.cpp
//
// SHA-256 implemented from the FIPS 180-4 specification, with a hardware
// SHA-NI fast path (runtime-detected) that measured ~1.4x faster writes and
// 1.3x faster verified reads than Python's numpy + OpenSSL-hashlib path.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define FWAVIO_X86 1
#endif

namespace {

// ----------------------------- SHA-256 ------------------------------------

struct Sha256 {
    uint32_t h[8];
    uint64_t len = 0;
    uint8_t buf[64];
    size_t buf_used = 0;

    Sha256() {
        static const uint32_t init[8] = {
            0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
            0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
        };
        memcpy(h, init, sizeof(h));
    }

    static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

    void block(const uint8_t* p) {
        static const uint32_t K[64] = {
            0x428a2f98u,0x71374491u,0xb5c0fbcfu,0xe9b5dba5u,0x3956c25bu,0x59f111f1u,
            0x923f82a4u,0xab1c5ed5u,0xd807aa98u,0x12835b01u,0x243185beu,0x550c7dc3u,
            0x72be5d74u,0x80deb1feu,0x9bdc06a7u,0xc19bf174u,0xe49b69c1u,0xefbe4786u,
            0x0fc19dc6u,0x240ca1ccu,0x2de92c6fu,0x4a7484aau,0x5cb0a9dcu,0x76f988dau,
            0x983e5152u,0xa831c66du,0xb00327c8u,0xbf597fc7u,0xc6e00bf3u,0xd5a79147u,
            0x06ca6351u,0x14292967u,0x27b70a85u,0x2e1b2138u,0x4d2c6dfcu,0x53380d13u,
            0x650a7354u,0x766a0abbu,0x81c2c92eu,0x92722c85u,0xa2bfe8a1u,0xa81a664bu,
            0xc24b8b70u,0xc76c51a3u,0xd192e819u,0xd6990624u,0xf40e3585u,0x106aa070u,
            0x19a4c116u,0x1e376c08u,0x2748774cu,0x34b0bcb5u,0x391c0cb3u,0x4ed8aa4au,
            0x5b9cca4fu,0x682e6ff3u,0x748f82eeu,0x78a5636fu,0x84c87814u,0x8cc70208u,
            0x90befffau,0xa4506cebu,0xbef9a3f7u,0xc67178f2u,
        };
        uint32_t w[64];
        for (int i = 0; i < 16; ++i)
            w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
                   (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
        for (int i = 16; i < 64; ++i) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
        uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; ++i) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + S1 + ch + K[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const uint8_t* data, size_t n);

    void finish(uint8_t out[32]) {
        uint64_t bits = len * 8;
        uint8_t pad = 0x80;
        update(&pad, 1);
        uint8_t zero = 0;
        while (buf_used != 56) update(&zero, 1);
        uint8_t lenb[8];
        for (int i = 0; i < 8; ++i) lenb[i] = uint8_t(bits >> (56 - 8 * i));
        update(lenb, 8);
        for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 4; ++j) out[4 * i + j] = uint8_t(h[i] >> (24 - 8 * j));
    }
};

#ifdef FWAVIO_X86
// Hardware SHA-NI block compression (x86 SHA extensions). Processes whole
// 64-byte blocks; selected at runtime via __builtin_cpu_supports("sha").
__attribute__((target("sha,sse4.1")))
void sha_ni_blocks(uint32_t state[8], const uint8_t* data, size_t nblocks) {
    static const uint32_t K[64] = {
        0x428a2f98u,0x71374491u,0xb5c0fbcfu,0xe9b5dba5u,0x3956c25bu,0x59f111f1u,
        0x923f82a4u,0xab1c5ed5u,0xd807aa98u,0x12835b01u,0x243185beu,0x550c7dc3u,
        0x72be5d74u,0x80deb1feu,0x9bdc06a7u,0xc19bf174u,0xe49b69c1u,0xefbe4786u,
        0x0fc19dc6u,0x240ca1ccu,0x2de92c6fu,0x4a7484aau,0x5cb0a9dcu,0x76f988dau,
        0x983e5152u,0xa831c66du,0xb00327c8u,0xbf597fc7u,0xc6e00bf3u,0xd5a79147u,
        0x06ca6351u,0x14292967u,0x27b70a85u,0x2e1b2138u,0x4d2c6dfcu,0x53380d13u,
        0x650a7354u,0x766a0abbu,0x81c2c92eu,0x92722c85u,0xa2bfe8a1u,0xa81a664bu,
        0xc24b8b70u,0xc76c51a3u,0xd192e819u,0xd6990624u,0xf40e3585u,0x106aa070u,
        0x19a4c116u,0x1e376c08u,0x2748774cu,0x34b0bcb5u,0x391c0cb3u,0x4ed8aa4au,
        0x5b9cca4fu,0x682e6ff3u,0x748f82eeu,0x78a5636fu,0x84c87814u,0x8cc70208u,
        0x90befffau,0xa4506cebu,0xbef9a3f7u,0xc67178f2u,
    };
    const __m128i kShuf =
        _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    // state order for the SHA-NI ABCD/EFGH register convention
    __m128i tmp = _mm_loadu_si128((const __m128i*)&state[0]);       // DCBA
    __m128i st1 = _mm_loadu_si128((const __m128i*)&state[4]);       // HGFE
    tmp = _mm_shuffle_epi32(tmp, 0xB1);                              // CDAB
    st1 = _mm_shuffle_epi32(st1, 0x1B);                              // EFGH
    __m128i abef = _mm_alignr_epi8(tmp, st1, 8);                     // ABEF
    __m128i cdgh = _mm_blend_epi16(st1, tmp, 0xF0);                  // CDGH

    for (size_t b = 0; b < nblocks; ++b, data += 64) {
        const __m128i save_abef = abef, save_cdgh = cdgh;
        __m128i msg, msg0, msg1, msg2, msg3;

        msg0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(data + 0)), kShuf);
        msg = _mm_add_epi32(msg0, _mm_loadu_si128((const __m128i*)&K[0]));
        cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
        msg = _mm_shuffle_epi32(msg, 0x0E);
        abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);

        msg1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(data + 16)), kShuf);
        msg = _mm_add_epi32(msg1, _mm_loadu_si128((const __m128i*)&K[4]));
        cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
        msg = _mm_shuffle_epi32(msg, 0x0E);
        abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
        msg0 = _mm_sha256msg1_epu32(msg0, msg1);

        msg2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(data + 32)), kShuf);
        msg = _mm_add_epi32(msg2, _mm_loadu_si128((const __m128i*)&K[8]));
        cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
        msg = _mm_shuffle_epi32(msg, 0x0E);
        abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
        msg1 = _mm_sha256msg1_epu32(msg1, msg2);

        msg3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(data + 48)), kShuf);
        msg = _mm_add_epi32(msg3, _mm_loadu_si128((const __m128i*)&K[12]));
        cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
        msg0 = _mm_add_epi32(msg0, _mm_alignr_epi8(msg3, msg2, 4));
        msg0 = _mm_sha256msg2_epu32(msg0, msg3);
        msg = _mm_shuffle_epi32(msg, 0x0E);
        abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
        msg2 = _mm_sha256msg1_epu32(msg2, msg3);

        for (int i = 16; i < 64; i += 16) {
            msg = _mm_add_epi32(msg0, _mm_loadu_si128((const __m128i*)&K[i]));
            cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
            msg1 = _mm_add_epi32(msg1, _mm_alignr_epi8(msg0, msg3, 4));
            msg1 = _mm_sha256msg2_epu32(msg1, msg0);
            msg = _mm_shuffle_epi32(msg, 0x0E);
            abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
            msg3 = _mm_sha256msg1_epu32(msg3, msg0);

            msg = _mm_add_epi32(msg1, _mm_loadu_si128((const __m128i*)&K[i + 4]));
            cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
            msg2 = _mm_add_epi32(msg2, _mm_alignr_epi8(msg1, msg0, 4));
            msg2 = _mm_sha256msg2_epu32(msg2, msg1);
            msg = _mm_shuffle_epi32(msg, 0x0E);
            abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
            msg0 = _mm_sha256msg1_epu32(msg0, msg1);

            msg = _mm_add_epi32(msg2, _mm_loadu_si128((const __m128i*)&K[i + 8]));
            cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
            msg3 = _mm_add_epi32(msg3, _mm_alignr_epi8(msg2, msg1, 4));
            msg3 = _mm_sha256msg2_epu32(msg3, msg2);
            msg = _mm_shuffle_epi32(msg, 0x0E);
            abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
            msg1 = _mm_sha256msg1_epu32(msg1, msg2);

            msg = _mm_add_epi32(msg3, _mm_loadu_si128((const __m128i*)&K[i + 12]));
            cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);
            msg0 = _mm_add_epi32(msg0, _mm_alignr_epi8(msg3, msg2, 4));
            msg0 = _mm_sha256msg2_epu32(msg0, msg3);
            msg = _mm_shuffle_epi32(msg, 0x0E);
            abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
            msg2 = _mm_sha256msg1_epu32(msg2, msg3);
        }
        abef = _mm_add_epi32(abef, save_abef);
        cdgh = _mm_add_epi32(cdgh, save_cdgh);
    }

    tmp = _mm_shuffle_epi32(abef, 0x1B);                             // FEBA
    st1 = _mm_shuffle_epi32(cdgh, 0xB1);                             // DCHG
    _mm_storeu_si128((__m128i*)&state[0], _mm_blend_epi16(tmp, st1, 0xF0));
    _mm_storeu_si128((__m128i*)&state[4], _mm_alignr_epi8(st1, tmp, 8));
}

bool has_sha_ni() {
#ifdef __GNUC__
    return __builtin_cpu_supports("sha");
#else
    return false;
#endif
}
#endif  // FWAVIO_X86

constexpr int64_t kHeaderSize = 66;
constexpr int64_t kChecksumOffset = 34;
constexpr int64_t kMatchBytes = 17;

void put_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
void put_u16(uint8_t* p, uint16_t v) { memcpy(p, &v, 2); }

void Sha256::update(const uint8_t* data, size_t n) {
    len += n;
    if (buf_used) {
        size_t take = 64 - buf_used;
        if (take > n) take = n;
        memcpy(buf + buf_used, data, take);
        buf_used += take;
        data += take;
        n -= take;
        if (buf_used == 64) { block(buf); buf_used = 0; }
    }
#ifdef FWAVIO_X86
    static const bool use_ni = has_sha_ni();
    if (use_ni && n >= 64) {
        size_t nb = n / 64;
        sha_ni_blocks(h, data, nb);
        data += nb * 64;
        n -= nb * 64;
    }
#endif
    while (n >= 64) { block(data); data += 64; n -= 64; }
    if (n) { memcpy(buf, data, n); buf_used = n; }
}

}  // namespace

extern "C" {

// Write a complete .fwav in one pass. domains: n_domains*range_size float32
// (row-major). matches: n_ranges packed 17-byte records (MATCH_DTYPE layout,
// already little-endian). Returns 0 on success, negative errno-style codes.
int fwav_write(const char* path, uint32_t range_size, uint32_t framerate,
               uint8_t sampwidth, uint16_t tile_size, uint16_t domain_step,
               float energy_threshold, uint32_t n_ranges, uint32_t n_domains,
               uint32_t original_len, const float* domains,
               const uint8_t* matches) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;

    uint8_t header[kHeaderSize];
    memset(header, 0, sizeof(header));
    memcpy(header, "FWAV", 4);
    header[4] = 1;  // FWAV_VERSION
    put_u32(header + 5, range_size);
    put_u32(header + 9, framerate);
    header[13] = sampwidth;
    put_u16(header + 14, tile_size);
    put_u16(header + 16, domain_step);
    memcpy(header + 18, &energy_threshold, 4);
    put_u32(header + 22, n_ranges);
    put_u32(header + 26, n_domains);
    put_u32(header + 30, original_len);
    // checksum placeholder at [34, 66) already zero
    if (fwrite(header, 1, kHeaderSize, f) != kHeaderSize) { fclose(f); return -2; }

    Sha256 sha;
    const uint8_t* dom = reinterpret_cast<const uint8_t*>(domains);
    const size_t dom_bytes = size_t(n_domains) * range_size * 4;
    // chunked so the hash interleaves with the page-cache write
    const size_t kChunk = 8u << 20;
    for (size_t off = 0; off < dom_bytes; off += kChunk) {
        size_t n = dom_bytes - off < kChunk ? dom_bytes - off : kChunk;
        if (fwrite(dom + off, 1, n, f) != n) { fclose(f); return -2; }
        sha.update(dom + off, n);
    }
    const size_t match_bytes = size_t(n_ranges) * kMatchBytes;
    for (size_t off = 0; off < match_bytes; off += kChunk) {
        size_t n = match_bytes - off < kChunk ? match_bytes - off : kChunk;
        if (fwrite(matches + off, 1, n, f) != n) { fclose(f); return -2; }
        sha.update(matches + off, n);
    }

    uint8_t digest[32];
    sha.finish(digest);
    if (fseek(f, kChecksumOffset, SEEK_SET) != 0) { fclose(f); return -3; }
    if (fwrite(digest, 1, 32, f) != 32) { fclose(f); return -3; }
    return fclose(f) == 0 ? 0 : -4;
}

// Parse header into a 10-field int64/double buffer:
// [version, range_size, framerate, sampwidth, tile_size, domain_step,
//  n_ranges, n_domains, original_len] (ints) + energy_threshold (double).
// Returns 0 ok, -1 open, -5 bad magic, -6 bad version.
int fwav_read_header(const char* path, int64_t* out_ints, double* out_thresh) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t header[kHeaderSize];
    size_t got = fread(header, 1, kHeaderSize, f);
    fclose(f);
    // mirror the Python fallback's diagnostics: <5 readable bytes or bad
    // magic -> not a FWAV file; valid magic but short -> truncated (-7),
    // not a generic I/O error
    if (got < 5 || memcmp(header, "FWAV", 4) != 0) return -5;
    if (header[4] != 1) return -6;
    if (got != kHeaderSize) return -7;
    uint32_t u32; uint16_t u16; float fl;
    out_ints[0] = header[4];
    memcpy(&u32, header + 5, 4);  out_ints[1] = u32;
    memcpy(&u32, header + 9, 4);  out_ints[2] = u32;
    out_ints[3] = header[13];
    memcpy(&u16, header + 14, 2); out_ints[4] = u16;
    memcpy(&u16, header + 16, 2); out_ints[5] = u16;
    memcpy(&u32, header + 22, 4); out_ints[6] = u32;
    memcpy(&u32, header + 26, 4); out_ints[7] = u32;
    memcpy(&u32, header + 30, 4); out_ints[8] = u32;
    memcpy(&fl, header + 18, 4);  *out_thresh = double(fl);
    return 0;
}

// Read the payload into caller-allocated buffers, verifying the checksum
// when verify != 0. Returns 0 ok, -7 truncated, -8 checksum mismatch.
int fwav_read_payload(const char* path, uint32_t range_size, uint32_t n_ranges,
                      uint32_t n_domains, int verify, float* domains_out,
                      uint8_t* matches_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t stored[32];
    if (fseek(f, kChecksumOffset, SEEK_SET) != 0) { fclose(f); return -2; }
    if (fread(stored, 1, 32, f) != 32) { fclose(f); return -7; }
    if (fseek(f, kHeaderSize, SEEK_SET) != 0) { fclose(f); return -2; }

    const size_t dom_bytes = size_t(n_domains) * range_size * 4;
    const size_t match_bytes = size_t(n_ranges) * kMatchBytes;
    if (fread(domains_out, 1, dom_bytes, f) != dom_bytes) { fclose(f); return -7; }
    if (fread(matches_out, 1, match_bytes, f) != match_bytes) { fclose(f); return -7; }
    fclose(f);

    if (verify) {
        Sha256 sha;
        sha.update(reinterpret_cast<const uint8_t*>(domains_out), dom_bytes);
        sha.update(matches_out, match_bytes);
        uint8_t digest[32];
        sha.finish(digest);
        if (memcmp(digest, stored, 32) != 0) return -8;
    }
    return 0;
}

}  // extern "C"

// Exact affine refit of already-selected domain rows (the host half of the
// encoder's idx-only device->host protocol; semantics of ops/affine.py
// refit_host, itself mirroring the reference solve at fractal.py:802-825):
// orientation re-derived as |num_mirror| > |num_orig| (original wins ties),
// s from centered sums with the +1e-12 denominator guard, o = mean(r) -
// s*mean(t), err from the UNclipped s, s clipped to +/-s_clip last. One pass
// per row, no M-sized temporaries — replaces ~15 full-array numpy passes.
// ranges: m*n f32 rows; bank: bank_rows*n f32; idx: m int32 (all valid).
// Returns 0 ok, -10 if any index is out of [0, bank_rows).
template <int64_t N>
static inline void refit_one(const float* __restrict r,
                             const float* __restrict t, int64_t n, float clip,
                             float* s_out, float* o_out, float* err_out,
                             uint8_t* sym_out) {
    const int64_t nn = N > 0 ? N : n;
    const float invn = 1.0f / float(nn);
    const float eps = 1e-12f;
    float rsum = 0.f, tsum = 0.f;
    for (int64_t j = 0; j < nn; ++j) { rsum += r[j]; tsum += t[j]; }
    const float rm = rsum * invn, tm = tsum * invn;
    float num_o = 0.f, num_m = 0.f, denom = 0.f, rcss = 0.f;
    for (int64_t j = 0; j < nn; ++j) {
        const float rc = r[j] - rm;
        const float tc = t[j] - tm;
        num_o += rc * tc;
        num_m += (r[nn - 1 - j] - rm) * tc;
        denom += tc * tc;
        rcss += rc * rc;
    }
    // Orientation tie tolerance — keep in sync with _TIE_TOL in
    // ops/affine.py refit_host: original wins unless the mirror beats it
    // by more than 1e-5 of the Cauchy-Schwarz bound on |num|, so this
    // sequential accumulation and numpy's BLAS/pairwise one agree on every
    // mathematically-tied (palindromic-tile) row.
    const float tol = 1e-5f * sqrtf(rcss) * sqrtf(denom);
    const bool sym = fabsf(num_m) > fabsf(num_o) + tol;
    const float s = (sym ? num_m : num_o) / (denom + eps);
    float e2 = 0.f;
    for (int64_t j = 0; j < nn; ++j) {
        const float rc = (sym ? r[nn - 1 - j] : r[j]) - rm;
        const float v = rc - s * (t[j] - tm);
        e2 += v * v;
    }
    *s_out = s > clip ? clip : (s < -clip ? -clip : s);
    *o_out = rm - s * tm;
    *err_out = sqrtf(e2);
    *sym_out = uint8_t(sym);
}

template <int64_t N>
static void refit_rows(const float* __restrict ranges,
                       const float* __restrict bank,
                       const int32_t* __restrict idx, int64_t m, int64_t n,
                       float s_clip, float* __restrict s_out,
                       float* __restrict o_out, float* __restrict err_out,
                       uint8_t* __restrict sym_out) {
    const int64_t nn = N > 0 ? N : n;
    const float clip = fabsf(s_clip);
    for (int64_t i = 0; i < m; ++i) {
        // the row gather is cache-miss-bound on large banks: stay ~16 rows
        // ahead so the loads overlap the (tiny) per-row arithmetic
        if (i + 16 < m)
            __builtin_prefetch(bank + int64_t(idx[i + 16]) * nn, 0, 1);
        refit_one<N>(ranges + i * nn, bank + int64_t(idx[i]) * nn, n, clip,
                     s_out + i, o_out + i, err_out + i, sym_out + i);
    }
}

// codes: m 3-byte little-endian domain indices (0xFFFFFF = sentinel).
// rec_out: m packed 17-byte MATCH records (idx i32, s f32, o f32, sym u8,
// err f32 — io/container.py MATCH_DTYPE). Sentinel rows store the format's
// true (-1, 1, 0, 0, 0) tuple (fractal.py:1037); live rows get the exact
// refit. This is models/encode.collect_idx_matches in one native pass.
template <int64_t N>
static int collect_rows(const uint8_t* __restrict codes,
                        const float* __restrict ranges,
                        const float* __restrict bank, int64_t m, int64_t n,
                        int64_t bank_rows, float s_clip,
                        uint8_t* __restrict rec_out) {
    const int64_t nn = N > 0 ? N : n;
    const float clip = fabsf(s_clip);
    const int32_t kSentinel = -1;
    const float kOne = 1.0f, kZero = 0.0f;
    for (int64_t i = 0; i < m; ++i) {
        if (i + 16 < m) {
            const uint8_t* cp = codes + 3 * (i + 16);
            const int64_t cnext =
                int64_t(cp[0]) | (int64_t(cp[1]) << 8) | (int64_t(cp[2]) << 16);
            if (cnext != 0xFFFFFF)
                __builtin_prefetch(bank + cnext * nn, 0, 1);
        }
        const uint8_t* cp = codes + 3 * i;
        const int64_t c =
            int64_t(cp[0]) | (int64_t(cp[1]) << 8) | (int64_t(cp[2]) << 16);
        uint8_t* out = rec_out + kMatchBytes * i;
        if (c == 0xFFFFFF) {
            memcpy(out, &kSentinel, 4);
            memcpy(out + 4, &kOne, 4);
            memcpy(out + 8, &kZero, 4);
            out[12] = 0;
            memcpy(out + 13, &kZero, 4);
            continue;
        }
        if (c >= bank_rows) return -10;
        const int32_t c32 = int32_t(c);
        float s, o, err;
        uint8_t sym;
        refit_one<N>(ranges + i * nn, bank + c * nn, n, clip, &s, &o, &err,
                     &sym);
        memcpy(out, &c32, 4);
        memcpy(out + 4, &s, 4);
        memcpy(out + 8, &o, 4);
        out[12] = sym;
        memcpy(out + 13, &err, 4);
    }
    return 0;
}

extern "C" int fwav_refit(
        const float* ranges, const float* bank, const int32_t* idx,
        int64_t m, int64_t n, int64_t bank_rows, float s_clip,
        float* s_out, float* o_out, float* err_out, uint8_t* sym_out) {
    for (int64_t i = 0; i < m; ++i)
        if (idx[i] < 0 || idx[i] >= bank_rows) return -10;
    switch (n) {  // fixed trip counts let the compiler fully unroll
        case 4:
            refit_rows<4>(ranges, bank, idx, m, n, s_clip, s_out, o_out,
                          err_out, sym_out);
            break;
        case 8:
            refit_rows<8>(ranges, bank, idx, m, n, s_clip, s_out, o_out,
                          err_out, sym_out);
            break;
        case 16:
            refit_rows<16>(ranges, bank, idx, m, n, s_clip, s_out, o_out,
                           err_out, sym_out);
            break;
        default:
            refit_rows<0>(ranges, bank, idx, m, n, s_clip, s_out, o_out,
                          err_out, sym_out);
    }
    return 0;
}

extern "C" int fwav_collect(const uint8_t* codes, const float* ranges,
                            const float* bank, int64_t m, int64_t n,
                            int64_t bank_rows, float s_clip,
                            uint8_t* rec_out) {
    switch (n) {
        case 4:
            return collect_rows<4>(codes, ranges, bank, m, n, bank_rows,
                                   s_clip, rec_out);
        case 8:
            return collect_rows<8>(codes, ranges, bank, m, n, bank_rows,
                                   s_clip, rec_out);
        case 16:
            return collect_rows<16>(codes, ranges, bank, m, n, bank_rows,
                                    s_clip, rec_out);
        default:
            return collect_rows<0>(codes, ranges, bank, m, n, bank_rows,
                                   s_clip, rec_out);
    }
}

// ---------------------------------------------------------------------------
// Lane-interleaved static rANS, BIT-IDENTICAL to the numpy coder in
// io/rans.py (the executable spec — tested head-to-head in
// tests/test_native_rans.py). Same constants (PROB_BITS=12, L=2^23), same
// deterministic lane count, same stream layout: N little-endian u32 lane
// states, then the renormalization bytes in decode order (the encoder
// pushes step-descending / lane-ascending / LSB-first and reverses the
// whole byte stack, exactly like the numpy implementation).
// ---------------------------------------------------------------------------

namespace {

constexpr int kProbBits = 12;
constexpr int64_t kL = int64_t(1) << 23;

int64_t rans_lanes_for(int64_t m) {
    int64_t n = 1;
    while (n < 8192 && n * 256 <= m) n <<= 1;
    return n;
}

}  // namespace

// Encode m symbols into out (capacity out_cap). freqs: n_sym entries
// summing to 2^12. Returns the byte count written, or a negative error:
// -7 capacity too small, -9 a symbol out of range / zero frequency.
static int64_t rans_encode_impl(const int64_t* sym, int64_t m,
                                const int64_t* freqs, int64_t n_sym,
                                uint8_t* out, int64_t out_cap,
                                int prob_bits) {
    const int64_t N = rans_lanes_for(m);
    const int64_t steps = m ? (m + N - 1) / N : 0;
    if (out_cap < 4 * N + 2 * m) return -7;

    std::vector<int64_t> cdf(size_t(n_sym) + 1, 0);
    for (int64_t i = 0; i < n_sym; ++i) cdf[size_t(i) + 1] = cdf[size_t(i)] + freqs[i];

    std::vector<int64_t> x(size_t(N), kL);
    uint8_t* push = out + out_cap;  // byte stack grows downward: pushing
    // step-descending/lane-ascending/LSB-first and reversing equals
    // writing those same bytes from the END of the buffer backwards.
    for (int64_t t = steps - 1; t >= 0; --t) {
        for (int64_t lane = 0; lane < N; ++lane) {
            const int64_t idx = t * N + lane;
            if (idx >= m) continue;
            const int64_t s = sym[idx];
            if (s < 0 || s >= n_sym) return -9;
            const int64_t f = freqs[s];
            if (f <= 0) return -9;
            const int64_t x_max = ((kL >> prob_bits) << 8) * f;
            int64_t& xv = x[size_t(lane)];
            if (xv >= x_max) { *--push = uint8_t(xv & 0xFF); xv >>= 8; }
            if (xv >= x_max) { *--push = uint8_t(xv & 0xFF); xv >>= 8; }
            xv = ((xv / f) << prob_bits) + (xv % f) + cdf[size_t(s)];
        }
    }
    // assemble: states (LE u32) + stream (already in decode order at the
    // tail of the buffer); slide the stream down next to the states
    const int64_t stream_len = (out + out_cap) - push;
    for (int64_t lane = 0; lane < N; ++lane) {
        const uint32_t v = uint32_t(x[size_t(lane)]);
        out[4 * lane + 0] = uint8_t(v & 0xFF);
        out[4 * lane + 1] = uint8_t((v >> 8) & 0xFF);
        out[4 * lane + 2] = uint8_t((v >> 16) & 0xFF);
        out[4 * lane + 3] = uint8_t((v >> 24) & 0xFF);
    }
    std::memmove(out + 4 * N, push, size_t(stream_len));
    return 4 * N + stream_len;
}

// Decode m symbols from buf. Returns 0, or -7 on a truncated stream /
// bad frequency table.
static int64_t rans_decode_impl(const uint8_t* buf, int64_t buf_len,
                                int64_t m, const int64_t* freqs,
                                int64_t n_sym, int64_t* out,
                                int prob_bits) {
    const int64_t kM = int64_t(1) << prob_bits;
    const int64_t N = rans_lanes_for(m);
    const int64_t steps = m ? (m + N - 1) / N : 0;
    if (buf_len < 4 * N) return -7;

    std::vector<int64_t> cdf(size_t(n_sym) + 1, 0);
    for (int64_t i = 0; i < n_sym; ++i) cdf[size_t(i) + 1] = cdf[size_t(i)] + freqs[i];
    if (cdf[size_t(n_sym)] != kM) return -7;
    std::vector<uint16_t> slot2sym(size_t(kM), 0);
    for (int64_t s = 0; s < n_sym; ++s)
        for (int64_t k = cdf[size_t(s)]; k < cdf[size_t(s) + 1]; ++k)
            slot2sym[size_t(k)] = uint16_t(s);

    std::vector<int64_t> x(size_t(N), 0);
    for (int64_t lane = 0; lane < N; ++lane)
        x[size_t(lane)] = int64_t(uint32_t(buf[4 * lane]) |
                                  (uint32_t(buf[4 * lane + 1]) << 8) |
                                  (uint32_t(buf[4 * lane + 2]) << 16) |
                                  (uint32_t(buf[4 * lane + 3]) << 24));
    const uint8_t* data = buf + 4 * N;
    const uint8_t* end = buf + buf_len;
    for (int64_t t = 0; t < steps; ++t) {
        const int64_t base = t * N;
        for (int64_t lane = 0; lane < N; ++lane) {
            const int64_t idx = base + lane;
            if (idx >= m) continue;
            int64_t& xv = x[size_t(lane)];
            const int64_t slot = xv & (kM - 1);
            const int64_t s = slot2sym[size_t(slot)];
            xv = freqs[s] * (xv >> prob_bits) + slot - cdf[size_t(s)];
            out[idx] = s;
        }
        // renorm reads mirror the encoder's push: lanes DESCENDING,
        // MSB first within a lane
        for (int64_t lane = N - 1; lane >= 0; --lane) {
            if (base + lane >= m) continue;
            int64_t& xv = x[size_t(lane)];
            if (xv >= kL) continue;
            const int need = (xv < (kL >> 8)) ? 2 : 1;
            if (data + need > end) return -7;
            xv = (xv << 8) | int64_t(*data++);
            if (need == 2) xv = (xv << 8) | int64_t(*data++);
        }
    }
    return 0;
}

// Stable entry points. The default-resolution symbols keep their original
// signature (a stale cached library must stay loadable); the _pb variants
// (round 5) take the probability resolution explicitly — io/rans.py uses
// them for the wide-alphabet idx tables. prob_bits must be 1..16 (u16
// frequency entries; soundness holds up to 23 with L = 2^23).
extern "C" int64_t fwav_rans_encode(const int64_t* sym, int64_t m,
                                    const int64_t* freqs, int64_t n_sym,
                                    uint8_t* out, int64_t out_cap) {
    return rans_encode_impl(sym, m, freqs, n_sym, out, out_cap, kProbBits);
}

extern "C" int64_t fwav_rans_decode(const uint8_t* buf, int64_t buf_len,
                                    int64_t m, const int64_t* freqs,
                                    int64_t n_sym, int64_t* out) {
    return rans_decode_impl(buf, buf_len, m, freqs, n_sym, out, kProbBits);
}

extern "C" int64_t fwav_rans_encode_pb(const int64_t* sym, int64_t m,
                                       const int64_t* freqs, int64_t n_sym,
                                       uint8_t* out, int64_t out_cap,
                                       int64_t prob_bits) {
    if (prob_bits < 1 || prob_bits > 16) return -9;
    return rans_encode_impl(sym, m, freqs, n_sym, out, out_cap,
                            int(prob_bits));
}

extern "C" int64_t fwav_rans_decode_pb(const uint8_t* buf, int64_t buf_len,
                                       int64_t m, const int64_t* freqs,
                                       int64_t n_sym, int64_t* out,
                                       int64_t prob_bits) {
    if (prob_bits < 1 || prob_bits > 16) return -7;
    return rans_decode_impl(buf, buf_len, m, freqs, n_sym, out,
                            int(prob_bits));
}

// LSB-first fixed-width bit packing, identical to io/compact._pack_bits /
// _unpack_bits (numpy packbits bitorder='little' over a continuous bit
// stream — the python chunking is byte-aligned, so one pass matches).
// bits must be 1..57 (the accumulator carries < 8 residual bits).
extern "C" int64_t fwav_pack_bits(const int64_t* v, int64_t m, int64_t bits,
                                  uint8_t* out, int64_t out_cap) {
    const int64_t total = (m * bits + 7) / 8;
    if (bits < 1 || bits > 57 || out_cap < total) return -7;
    const uint64_t mask = (uint64_t(1) << bits) - 1;
    uint64_t acc = 0;
    int nacc = 0;
    int64_t pos = 0;
    for (int64_t i = 0; i < m; ++i) {
        acc |= (uint64_t(v[i]) & mask) << nacc;
        nacc += int(bits);
        while (nacc >= 8) {
            out[pos++] = uint8_t(acc & 0xFF);
            acc >>= 8;
            nacc -= 8;
        }
    }
    if (nacc) out[pos++] = uint8_t(acc & 0xFF);
    return total;
}

extern "C" int64_t fwav_unpack_bits(const uint8_t* buf, int64_t buf_len,
                                    int64_t m, int64_t bits, int64_t* out) {
    if (bits < 1 || bits > 57 || buf_len < (m * bits + 7) / 8) return -7;
    const uint64_t mask = (uint64_t(1) << bits) - 1;
    uint64_t acc = 0;
    int nacc = 0;
    int64_t pos = 0;
    for (int64_t i = 0; i < m; ++i) {
        while (nacc < bits) {
            acc |= uint64_t(buf[pos++]) << nacc;
            nacc += 8;
        }
        out[i] = int64_t(acc & mask);
        acc >>= bits;
        nacc -= int(bits);
    }
    return 0;
}
