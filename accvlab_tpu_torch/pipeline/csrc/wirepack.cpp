// Native wire-compression encoder (hot half of WirePlanePacker).
//
// The Python step chooses the predictor mode and base width from value
// histograms, then bitplane-packs the residuals; both passes stream over
// every decoded image inside the producer thread, so they compete with
// JPEG decode for the host budget. This engine does each pass in ONE
// cache-friendly sweep with no intermediate arrays (the numpy path
// materializes both predictors' zigzag residual planes):
//
//   accvlab_wire_analyze  — residual + zigzag + 1024-bin histogram for BOTH
//                           predictors in a single pass.
//   accvlab_wire_pack     — recompute the chosen predictor's residuals and
//                           emit bitplanes (np.packbits big-bit-order) and
//                           the PFOR exception list in a single pass.
//
// Hot-loop design (same techniques as dctpack.cpp, measured there at
// x2.8): rows y >= 1 with i >= C vectorize 16 pixels per SSE2 iteration —
// both predictors' residuals from four unaligned loads (row, up, row-C,
// up-C; on row 0 the vertical-mode residual EQUALS the plane-mode one, so
// the scalar head is row 0 and the first ceil(C/8) byte-groups only),
// zigzag as psllw^psraw, bitplane emit as pand+pcmpeqb+pmovmskb plus a
// byte-reverse LUT, exception detection as one vector compare with an
// order-preserving scalar slow path. The 1024-bin histograms (4 KB,
// L1-resident) are updated scalar from a 16-value stack buffer.
//
// Layout contract (mirrors wire_compression.py): plane is C-contiguous
// uint8 (H, Wr); C = trailing group stride (elements per step along the
// horizontal axis 1); mode 1 = vertical predictor (row 0 horizontally
// differenced), mode 2 = 2-D plane predictor (second difference).
// ctypes releases the GIL for the duration of each call.

#include <cstdint>

#include "simd_bitplane.h"

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

inline uint16_t zig(int v) {
    // unsigned arithmetic: a signed left shift of a negative value is UB
    // before C++20; this form is well-defined and bit-identical
    const uint32_t u = static_cast<uint32_t>(v);
    const uint32_t sign = static_cast<uint32_t>(v >> 31);  // 0 or ~0
    return static_cast<uint16_t>((u << 1) ^ sign);
}

// residuals of both modes at (row y via pointers, col i)
inline void residuals_at(const uint8_t* row, const uint8_t* up, int64_t i,
                         int64_t C, bool first_row, int* r1, int* r2) {
    const int rv = first_row ? static_cast<int>(row[i])
                             : static_cast<int>(row[i]) - static_cast<int>(up[i]);
    if (i >= C) {
        const int rvl = first_row
                            ? static_cast<int>(row[i - C])
                            : static_cast<int>(row[i - C]) -
                                  static_cast<int>(up[i - C]);
        *r2 = rv - rvl;
        *r1 = first_row ? rv - rvl /* row 0 h-differenced */ : rv;
    } else {
        *r2 = rv;
        *r1 = rv;
    }
}

#if defined(__SSE2__)

// both predictors' zigzag residuals for 16 pixels at row y >= 1, i >= C
inline void residuals16(const uint8_t* row, const uint8_t* up, int64_t i,
                        int64_t C, __m128i* z1lo, __m128i* z1hi,
                        __m128i* z2lo, __m128i* z2hi) {
    const __m128i zero = _mm_setzero_si128();
    const __m128i v8 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(row + i));
    const __m128i u8 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(up + i));
    const __m128i vl8 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(row + i - C));
    const __m128i ul8 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(up + i - C));
    // widen to int16 (lo/hi 8 lanes each) and form rv = row - up
    const __m128i rv_lo = _mm_sub_epi16(_mm_unpacklo_epi8(v8, zero),
                                        _mm_unpacklo_epi8(u8, zero));
    const __m128i rv_hi = _mm_sub_epi16(_mm_unpackhi_epi8(v8, zero),
                                        _mm_unpackhi_epi8(u8, zero));
    const __m128i rvl_lo = _mm_sub_epi16(_mm_unpacklo_epi8(vl8, zero),
                                         _mm_unpacklo_epi8(ul8, zero));
    const __m128i rvl_hi = _mm_sub_epi16(_mm_unpackhi_epi8(vl8, zero),
                                         _mm_unpackhi_epi8(ul8, zero));
    const __m128i r2_lo = _mm_sub_epi16(rv_lo, rvl_lo);
    const __m128i r2_hi = _mm_sub_epi16(rv_hi, rvl_hi);
    // zigzag: (r << 1) ^ (r >> 15), int16 lanes
    *z1lo = _mm_xor_si128(_mm_slli_epi16(rv_lo, 1), _mm_srai_epi16(rv_lo, 15));
    *z1hi = _mm_xor_si128(_mm_slli_epi16(rv_hi, 1), _mm_srai_epi16(rv_hi, 15));
    *z2lo = _mm_xor_si128(_mm_slli_epi16(r2_lo, 1), _mm_srai_epi16(r2_lo, 15));
    *z2hi = _mm_xor_si128(_mm_slli_epi16(r2_hi, 1), _mm_srai_epi16(r2_hi, 15));
}

#endif  // __SSE2__

// scalar 8-pixel group: histogram update (analyze) is done by the caller;
// this packs bitplanes + exceptions for pack()
inline int64_t pack8_scalar(const uint8_t* row, const uint8_t* up, bool first,
                            int64_t C, int mode, int b, int64_t y, int64_t j,
                            int64_t wr, uint8_t* bp, int64_t plane_stride,
                            uint32_t limit, int32_t* excp, int16_t* excv,
                            int64_t cap, int64_t ne) {
    uint16_t z[8];
    for (int t = 0; t < 8; ++t) {
        const int64_t i = j * 8 + t;
        int r1, r2;
        residuals_at(row, up, i, C, first, &r1, &r2);
        const uint16_t zv = zig(mode == 1 ? r1 : r2);
        z[t] = zv;
        if (zv >= limit) {
            if (ne < cap) {
                excp[ne] = static_cast<int32_t>(y * wr + i);
                excv[ne] = static_cast<int16_t>(zv);
            }
            ne++;
        }
    }
    uint8_t* out = bp + y * (wr / 8) + j;
    for (int k = 0; k < b; ++k) {
        uint8_t byte = 0;
        for (int t = 0; t < 8; ++t)
            byte |= static_cast<uint8_t>((z[t] >> k) & 1) << (7 - t);
        out[static_cast<int64_t>(k) * plane_stride] = byte;
    }
    return ne;
}

}  // namespace

extern "C" {

// hist1/hist2: 1024 uint32 bins, zeroed by the caller.
void accvlab_wire_analyze(const uint8_t* p, int64_t h, int64_t wr, int64_t C,
                          uint32_t* hist1, uint32_t* hist2) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = p + y * wr;
        const uint8_t* up = row - wr;
        const bool first = (y == 0);
        int64_t i = 0;
#if defined(__SSE2__)
        if (!first) {
            // scalar head until all 16 lanes have i >= C
            for (; i < C && i < wr; ++i) {
                int r1, r2;
                residuals_at(row, up, i, C, first, &r1, &r2);
                hist1[zig(r1)]++;
                hist2[zig(r2)]++;
            }
            alignas(16) uint16_t z1[16], z2[16];
            for (; i + 16 <= wr; i += 16) {
                __m128i z1lo, z1hi, z2lo, z2hi;
                residuals16(row, up, i, C, &z1lo, &z1hi, &z2lo, &z2hi);
                _mm_store_si128(reinterpret_cast<__m128i*>(z1), z1lo);
                _mm_store_si128(reinterpret_cast<__m128i*>(z1 + 8), z1hi);
                _mm_store_si128(reinterpret_cast<__m128i*>(z2), z2lo);
                _mm_store_si128(reinterpret_cast<__m128i*>(z2 + 8), z2hi);
                for (int t = 0; t < 16; ++t) hist1[z1[t]]++;
                for (int t = 0; t < 16; ++t) hist2[z2[t]]++;
            }
        }
#endif
        for (; i < wr; ++i) {
            int r1, r2;
            residuals_at(row, up, i, C, first, &r1, &r2);
            hist1[zig(r1)]++;
            hist2[zig(r2)]++;
        }
    }
}

// bp: (b, h, wr/8) uint8 out; excp/excv: capacity `cap`, PRE-FILLED with
// the padding sentinel by the caller. Returns the true exception count
// (may exceed cap only if the caller sized cap wrong — entries beyond cap
// are dropped here and the caller must treat ne > cap as an error).
int64_t accvlab_wire_pack(const uint8_t* p, int64_t h, int64_t wr, int64_t C,
                          int mode, int b, uint8_t* bp, int32_t* excp,
                          int16_t* excv, int64_t cap) {
    const int64_t wb = wr / 8;
    const int64_t plane_stride = h * wb;
    const uint32_t limit = 1u << b;
    int64_t ne = 0;
#if defined(__SSE2__)
    const __m128i vlim = _mm_set1_epi16(static_cast<int16_t>(limit - 1));
#endif
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = p + y * wr;
        const uint8_t* up = row - wr;
        const bool first = (y == 0);
        int64_t j = 0;
#if defined(__SSE2__)
        if (!first && b <= 14) {
            // scalar byte-groups until all 16 lanes have i >= C
            while (j < wb && j * 8 < C)
                ne = pack8_scalar(row, up, first, C, mode, b, y, j++, wr, bp,
                                  plane_stride, limit, excp, excv, cap, ne);
            uint8_t* out = bp + y * wb;
            for (; j + 2 <= wb; j += 2) {
                const int64_t i = j * 8;
                __m128i z1lo, z1hi, z2lo, z2hi;
                residuals16(row, up, i, C, &z1lo, &z1hi, &z2lo, &z2hi);
                const __m128i zlo = (mode == 1) ? z1lo : z2lo;
                const __m128i zhi = (mode == 1) ? z1hi : z2hi;
                // exceptions: zz > limit-1 (zigzag <= 1020 < 2^15, so the
                // signed compare is valid); rare scalar slow path keeps
                // ascending order within the 16-lane window
                const int em = accvlab_simd::exception_mask16(zlo, zhi, vlim);
                if (__builtin_expect(em != 0, 0))
                    ne = accvlab_simd::record_exceptions16(
                        zlo, zhi, em, y * wr + i, excp, excv, cap, ne);
                accvlab_simd::emit_bitplanes16(zlo, zhi, b, out + j,
                                               plane_stride);
            }
        }
#endif
        for (; j < wb; ++j)
            ne = pack8_scalar(row, up, first, C, mode, b, y, j, wr, bp,
                              plane_stride, limit, excp, excv, cap, ne);
    }
    return ne;
}

}  // extern "C"
