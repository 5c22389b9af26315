// Shared SSE2 bitplane/exception emit for the wire encoders.
//
// Single source for the hot-loop machinery dctpack.cpp and wirepack.cpp
// have in common (a fix here reaches both libraries; the build cache keys
// on csrc/*.h content too, so editing this header rebuilds them):
//
// * kRev — byte bit-reversal LUT: pmovmskb emits lane i at bit i, the
//   wire's np.packbits layout wants value t at bit 7-t.
// * exception_mask16 — one compare per 16 zigzag values: lanes with
//   zz > limit-1 (zigzag values fit 14 bits, so the SIGNED int16 compare
//   is valid — callers must keep that invariant).
// * record_exceptions16 — the rare slow path: appends flagged lanes to
//   the unified PFOR exception list in ascending position order, clipping
//   writes at `cap` while returning the TRUE running count.
// * emit_bitplanes16 — bitplanes of 16 int16 values as 2 wire bytes per
//   plane via pand+pcmpeqb+pmovmskb (+ hi-byte planes for b > 8).

#pragma once

#include <cstdint>

#if defined(__SSE2__)
#include <emmintrin.h>

namespace accvlab_simd {

struct BitRev {
    uint8_t t[256];
    constexpr BitRev() : t() {
        for (int i = 0; i < 256; ++i) {
            int r = 0;
            for (int k = 0; k < 8; ++k) r |= ((i >> k) & 1) << (7 - k);
            t[i] = static_cast<uint8_t>(r);
        }
    }
};
inline constexpr BitRev kRev{};

// 16-bit mask: bit t set iff lane t's zigzag exceeds limit-1 (lanes 0-7
// from zlo, 8-15 from zhi; packs_epi16 preserves that order).
inline int exception_mask16(__m128i zlo, __m128i zhi, __m128i vlim) {
    return _mm_movemask_epi8(_mm_packs_epi16(_mm_cmpgt_epi16(zlo, vlim),
                                             _mm_cmpgt_epi16(zhi, vlim)));
}

inline int64_t record_exceptions16(__m128i zlo, __m128i zhi, int em,
                                   int64_t pos_base, int32_t* excp,
                                   int16_t* excv, int64_t cap, int64_t ne) {
    alignas(16) uint16_t zbuf[16];
    _mm_store_si128(reinterpret_cast<__m128i*>(zbuf), zlo);
    _mm_store_si128(reinterpret_cast<__m128i*>(zbuf + 8), zhi);
    for (int t = 0; t < 16; ++t) {
        if (!((em >> t) & 1)) continue;
        if (ne < cap) {
            excp[ne] = static_cast<int32_t>(pos_base + t);
            excv[ne] = static_cast<int16_t>(zbuf[t]);
        }
        ne++;
    }
    return ne;
}

// o: first wire byte of this 16-value group in plane 0; plane k is at
// o[k * plane_stride] (np.packbits big-bit-order within each byte).
inline void emit_bitplanes16(__m128i zlo, __m128i zhi, int b, uint8_t* o,
                             int64_t plane_stride) {
    const __m128i v255 = _mm_set1_epi16(0xFF);
    const __m128i lo8 = _mm_packus_epi16(_mm_and_si128(zlo, v255),
                                         _mm_and_si128(zhi, v255));
    const int kb = b < 8 ? b : 8;
    for (int k = 0; k < kb; ++k) {
        const __m128i bit = _mm_set1_epi8(static_cast<char>(1 << k));
        const int m =
            _mm_movemask_epi8(_mm_cmpeq_epi8(_mm_and_si128(lo8, bit), bit));
        o[k * plane_stride] = kRev.t[m & 0xFF];
        o[k * plane_stride + 1] = kRev.t[(m >> 8) & 0xFF];
    }
    if (b > 8) {
        const __m128i hi8 = _mm_packus_epi16(_mm_srli_epi16(zlo, 8),
                                             _mm_srli_epi16(zhi, 8));
        for (int k = 8; k < b; ++k) {
            const __m128i bit = _mm_set1_epi8(static_cast<char>(1 << (k - 8)));
            const int m = _mm_movemask_epi8(
                _mm_cmpeq_epi8(_mm_and_si128(hi8, bit), bit));
            o[k * plane_stride] = kRev.t[m & 0xFF];
            o[k * plane_stride + 1] = kRev.t[(m >> 8) & 0xFF];
        }
    }
}

}  // namespace accvlab_simd

#endif  // __SSE2__
