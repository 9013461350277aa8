// prep — the entry's int16 probe in one pass (models/encode.py
// _as_i16_or_f32).
//
// A file ships to the device as int16 only when every float32 sample is
// finite, |x| <= 32767 and whole (-0.0 counts as 0), so that the device's
// cast back to float32 is exact. fwav_prep_i16 reads each sample once: it
// decides that and writes the int16 values into the caller's padded row,
// zeros after the signal. Its numpy spec is models/encode.py _i16_spec.
//
// The block loop is written to vectorise: the test works on the sample's
// bits, so that no branch and no out-of-range conversion is in it. A sample
// out of range, inf or NaN is replaced by +0 before the cast and flagged.
// After the first block with a flagged sample no more int16 is written.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfwavprep.so prep.cpp
// (io/native.py _load_prep, at first use).

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kBlock = 4096;
constexpr uint32_t kAbsMask = 0x7FFFFFFFu;
constexpr uint32_t kMaxBits = 0x46FFFE00u;  // the bits of 32767.0f

// The int16 values of s[0, len) into d; nonzero where one sample is not
// int16-exact (d is then not the samples).
inline uint32_t cast_block(const float* __restrict s, int16_t* __restrict d, int64_t len) {
    uint32_t bad = 0;
    for (int64_t i = 0; i < len; ++i) {
        uint32_t bits;
        std::memcpy(&bits, s + i, sizeof bits);
        const uint32_t out = (bits & kAbsMask) > kMaxBits;  // |x| > 32767, inf or NaN
        const uint32_t kept = bits & (out - 1u);            // x, or +0 where out
        float c;
        std::memcpy(&c, &kept, sizeof c);
        const int32_t q = static_cast<int32_t>(c);
        bad |= out | static_cast<uint32_t>(static_cast<float>(q) != c);
        d[i] = static_cast<int16_t>(q);
    }
    return bad;
}

}  // namespace

// 1 when all n samples of src are int16-exact: dst[0, n) holds them and
// dst[n, nb) zeros. 0 when one is not (dst is then not the samples), -1 on
// bad sizes.
extern "C" int fwav_prep_i16(const float* src, int64_t n, int16_t* dst, int64_t nb) {
    if (n < 0 || nb < n) return -1;
    for (int64_t a = 0; a < n; a += kBlock) {
        const int64_t len = n - a < kBlock ? n - a : kBlock;
        if (cast_block(src + a, dst + a, len)) return 0;
    }
    std::memset(dst + n, 0, static_cast<size_t>(nb - n) * sizeof(int16_t));
    return 1;
}
