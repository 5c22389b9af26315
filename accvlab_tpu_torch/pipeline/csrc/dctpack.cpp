// Native DCT-wire band encoder (hot half of DCTWirePacker).
//
// Sibling of wirepack.cpp (the pixel-wire encoder): the Python step picks
// per-group bit widths and the DC band's spatial predictor from value
// histograms, then bitplane-packs each band group with a unified
// patched-exception list. Both passes stream over every image's
// coefficient bands inside the producer thread, so they compete with the
// JPEG entropy decode for the host budget; this engine does each pass in
// ONE cache-friendly sweep with no intermediate arrays (the numpy path
// materializes the zigzag band array plus the DC residual variants).
//
// Hot-loop design (measured on the bench content, 48 imgs/batch, 1 core):
// * analyze counts BIT LENGTHS (16 bins, register/L1-resident) instead of
//   filling 16384-bin value histograms — the fits summary only needs
//   count(zigzag < 2^b), which is count(bit_length <= b), and the 64 KB
//   histogram of the old design evicted the entire L1 every group.
//   4 interleaved count arrays break the store-to-load dependency chain.
// * pack_group extracts bitplanes 16 values at a time with SSE2
//   (zigzag = psllw^psraw, bit test = pand+pcmpeqb, emit = pmovmskb +
//   byte-reverse LUT for np.packbits' big bit order); exceptions are
//   detected with one vector compare per 16 values and handled on a
//   rare scalar path that preserves ascending position order.
// Both backends (and the numpy path) produce byte-identical wire fields
// (tested: tests/test_dct_wire.py native-vs-numpy equality).
//
// Layout contract (mirrors processing_steps/dct_wire.py): bands is
// C-contiguous int16 (NB, BH, BWP), zigzag band order; group 0 is always
// the DC band alone (diagonal 0 has exactly one band); DC predictor
// modes: 0 none, 1 vertical (row 0 horizontally differenced), 2 plane
// (2-D second difference). Zigzag values fit 14 bits (|residual| <= 8188)
// -> 15-entry fits tables. ctypes releases the GIL for each call.

#include <cstdint>

#include "simd_bitplane.h"

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

inline uint16_t zig(int v) {
    // unsigned arithmetic: a signed left shift of a negative value is UB
    // before C++20; this form is well-defined and bit-identical.
    // Defense in depth: ajd_read_dct clamps coefficients to +-2047, which
    // bounds every residual's zigzag under 2^14; clamp here anyway so a
    // caller bug can corrupt the wire but never memory (bit-length index
    // and bitplane width both stay in range).
    if (v > 8191) v = 8191;
    if (v < -8191) v = -8191;
    const uint32_t u = static_cast<uint32_t>(v);
    const uint32_t sign = static_cast<uint32_t>(v >> 31);  // 0 or ~0
    return static_cast<uint16_t>((u << 1) ^ sign);
}

// bit_length(zv): 0 for 0, floor(log2(zv))+1 otherwise; zv < 2^b iff
// bit_length(zv) <= b. The 2*zv+1 form needs no zero special-case.
inline int bit_len(uint16_t zv) {
    return 31 - __builtin_clz((static_cast<uint32_t>(zv) << 1) | 1u);
}

inline int dc_residual(const int16_t* dc, int64_t bwp, int64_t y, int64_t x,
                       int mode) {
    const int v = dc[y * bwp + x];
    if (mode == 0) return v;
    const int rv = y ? v - dc[(y - 1) * bwp + x] : v;
    if (mode == 1)
        return y == 0 ? (x ? v - static_cast<int>(dc[x - 1]) : v) : rv;
    // mode 2: horizontal difference of the vertical residuals
    if (x == 0) return rv;
    const int vl = dc[y * bwp + x - 1];
    const int rvl = y ? vl - dc[(y - 1) * bwp + x - 1] : vl;
    return rv - rvl;
}

// Collapse bit-length counts to the 15-entry "fits" summary the width
// optimizer consumes: fits[b] = count(zigzag < 2^b) = count(bit_len <= b).
inline void emit_fits_from_lengths(const uint32_t cnt[][16], int ways,
                                   uint32_t* fits) {
    uint32_t acc = 0;
    for (int b = 0; b <= 14; ++b) {
        for (int w = 0; w < ways; ++w) acc += cnt[w][b];
        fits[b] = acc;
    }
}

// Scalar 8-value packer (DC band, non-16-multiple row tails, non-SSE2
// builds) — the original loop, kept bit-identical.
inline int64_t pack8_scalar(const int16_t* src, const int16_t* row,
                            bool is_dc, int dc_mode, int64_t bwp, int64_t y,
                            int64_t j, int b, uint8_t* out,
                            int64_t plane_stride, uint32_t limit,
                            int64_t pos_base, int32_t* excp, int16_t* excv,
                            int64_t cap, int64_t ne) {
    uint16_t z[8];
    for (int t = 0; t < 8; ++t) {
        const int64_t x = j * 8 + t;
        const int v = is_dc ? dc_residual(src, bwp, y, x, dc_mode)
                            : static_cast<int>(row[x]);
        const uint16_t zv = zig(v);
        z[t] = zv;
        if (zv >= limit) {
            if (ne < cap) {
                excp[ne] = static_cast<int32_t>(pos_base + x);
                excv[ne] = static_cast<int16_t>(zv);
            }
            ne++;
        }
    }
    for (int k = 0; k < b; ++k) {
        uint8_t byte = 0;
        for (int t = 0; t < 8; ++t)
            byte |= static_cast<uint8_t>((z[t] >> k) & 1) << (7 - t);
        out[static_cast<int64_t>(k) * plane_stride + j] = byte;
    }
    return ne;
}

}  // namespace

extern "C" {

// AC analyze: per-group width summaries. fits: ngroups x 15 uint32 out
// (row 0 — the DC band — is SKIPPED here, see accvlab_dct_dc_analyze).
// bounds: ngroups+1 band indices.
void accvlab_dct_analyze(const int16_t* bands, int64_t bh, int64_t bwp,
                         const int64_t* bounds, int64_t ngroups,
                         uint32_t* fits) {
    const int64_t plane = bh * bwp;
    for (int64_t g = 1; g < ngroups; ++g) {
        uint32_t cnt[4][16] = {};
        const int16_t* p = bands + bounds[g] * plane;
        const int64_t n = (bounds[g + 1] - bounds[g]) * plane;
        int64_t i = 0;
        for (; i + 4 <= n; i += 4) {
            cnt[0][bit_len(zig(p[i]))]++;
            cnt[1][bit_len(zig(p[i + 1]))]++;
            cnt[2][bit_len(zig(p[i + 2]))]++;
            cnt[3][bit_len(zig(p[i + 3]))]++;
        }
        for (; i < n; ++i) cnt[0][bit_len(zig(p[i]))]++;
        emit_fits_from_lengths(cnt, 4, fits + g * 15);
    }
}

// DC analyze: all three predictor variants in one sweep. fits3: 3 x 15
// uint32 out.
void accvlab_dct_dc_analyze(const int16_t* dc, int64_t bh, int64_t bwp,
                            uint32_t* fits3) {
    uint32_t cnt[3][16] = {};
    for (int64_t y = 0; y < bh; ++y) {
        for (int64_t x = 0; x < bwp; ++x) {
            cnt[0][bit_len(zig(dc_residual(dc, bwp, y, x, 0)))]++;
            cnt[1][bit_len(zig(dc_residual(dc, bwp, y, x, 1)))]++;
            cnt[2][bit_len(zig(dc_residual(dc, bwp, y, x, 2)))]++;
        }
    }
    for (int mode = 0; mode < 3; ++mode) {
        const uint32_t(*one)[16] = &cnt[mode];
        emit_fits_from_lengths(one, 1, fits3 + mode * 15);
    }
}

// Pack one group: bands_g points at the group's first band plane
// ((nb, bh, bwp) int16); if dc_mode >= 0, band 0 IS the DC band and is
// residual-coded with that predictor. bp out: (b, nb*bh, bwp/8) uint8
// (np.packbits big-bit-order). Exceptions (zigzag >= 2^b) append to the
// caller's unified excp/excv starting at index `ne`, positions offset by
// `pos_offset` (the group's base in the concatenated band space); writes
// are clipped at `cap` but the TRUE running count is returned — the
// caller must treat a result > cap as a sizing bug.
int64_t accvlab_dct_pack_group(const int16_t* bands_g, int64_t nb, int64_t bh,
                               int64_t bwp, int dc_mode, int b, uint8_t* bp,
                               int32_t* excp, int16_t* excv, int64_t cap,
                               int64_t pos_offset, int64_t ne) {
    const int64_t wb = bwp / 8;
    const int64_t plane_stride = nb * bh * wb;
    const uint32_t limit = 1u << b;
#if defined(__SSE2__)
    const __m128i vlim = _mm_set1_epi16(static_cast<int16_t>(limit - 1));
#endif
    for (int64_t band = 0; band < nb; ++band) {
        const int16_t* src = bands_g + band * bh * bwp;
        const bool is_dc = (dc_mode >= 0 && band == 0);
        for (int64_t y = 0; y < bh; ++y) {
            const int16_t* row = src + y * bwp;
            const int64_t pos_base = pos_offset + (band * bh + y) * bwp;
            uint8_t* out = bp + (band * bh + y) * wb;
            int64_t j = 0;
#if defined(__SSE2__)
            if (!is_dc) {
                // 16 values -> 2 wire bytes per plane. Coefficients are
                // pre-clamped (|v| <= 2047 from ajd_read_dct), so the
                // unclamped vector zigzag (v<<1)^(v>>15) is exact; zigzag
                // values are < 2^14, hence non-negative as int16 and the
                // signed compares below are valid.
                for (; (j + 2) * 8 <= bwp; j += 2) {
                    const int16_t* px = row + j * 8;
                    __m128i v0 = _mm_loadu_si128(
                        reinterpret_cast<const __m128i*>(px));
                    __m128i v1 = _mm_loadu_si128(
                        reinterpret_cast<const __m128i*>(px + 8));
                    __m128i z0 = _mm_xor_si128(_mm_slli_epi16(v0, 1),
                                               _mm_srai_epi16(v0, 15));
                    __m128i z1 = _mm_xor_si128(_mm_slli_epi16(v1, 1),
                                               _mm_srai_epi16(v1, 15));
                    // exceptions: zz > limit-1 (rare; scalar slow path
                    // keeps ascending order within the 16-lane window)
                    const int em = accvlab_simd::exception_mask16(z0, z1, vlim);
                    if (__builtin_expect(em != 0, 0))
                        ne = accvlab_simd::record_exceptions16(
                            z0, z1, em, pos_base + j * 8, excp, excv, cap, ne);
                    accvlab_simd::emit_bitplanes16(z0, z1, b, out + j,
                                                   plane_stride);
                }
            }
#endif
            for (; j < wb; ++j)
                ne = pack8_scalar(src, row, is_dc, dc_mode, bwp, y, j, b, out,
                                  plane_stride, limit, pos_base, excp, excv,
                                  cap, ne);
        }
    }
    return ne;
}

}  // extern "C"
