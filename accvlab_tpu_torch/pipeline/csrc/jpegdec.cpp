// Native JPEG -> YCbCr 4:2:0 wire-format decoder (libjpeg-turbo).
//
// The host-side hot path of the image pipeline: decode a JPEG directly to
// the TPU wire layout (planar Y at target size + interleaved 2x2-subsampled
// CbCr), with the decode running at the best M/8 DCT scale (libjpeg supports
// any M in 1..8; PIL's draft mode only exposes powers of two, so a
// 1024->704 resize decodes at FULL size under PIL but at 6/8 here — ~44%
// fewer IDCT ops) and the final resample done channel-planar so chroma is
// resized at HALF resolution instead of being resized full-size and then
// subsampled.
//
// Reference analog: the NVJPEG/NVDEC hardware decode feeding the DALI fused
// decoder+resize (`processing_steps/image_decoder.py:28`); on TPU hosts the
// decode is CPU-side and this file is its optimized form.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libaccvlab_jpeg.so jpegdec.cpp -ljpeg

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <jpeglib.h>

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
    auto* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
    char buf[JMSG_LENGTH_MAX];
    (*cinfo->err->format_message)(cinfo, buf);
    set_error(buf);
    longjmp(mgr->jump, 1);
}

void on_emit(j_common_ptr, int) {}  // silence warnings (corrupt-tail etc.)

// Separable bilinear resize of one uint8 plane with stride `src_stride`
// (pixel stride `pix`, so interleaved channels resize without a split copy).
// Standard align-corners-false sampling, float accumulation (the host cost
// is dominated by the IDCT, not this).
void resize_plane(const uint8_t* src, int sh, int sw, int src_stride, int pix,
                  uint8_t* dst, int th, int tw, int dst_stride, int dst_pix) {
    if (sh == th && sw == tw) {
        for (int y = 0; y < th; ++y)
            for (int x = 0; x < tw; ++x)
                dst[y * dst_stride + x * dst_pix] = src[y * src_stride + x * pix];
        return;
    }
    std::vector<int> x0(tw), x1(tw);
    std::vector<float> xw(tw);
    float sx = static_cast<float>(sw) / tw;
    for (int x = 0; x < tw; ++x) {
        float c = (x + 0.5f) * sx - 0.5f;
        if (c < 0) c = 0;
        int i = static_cast<int>(c);
        if (i > sw - 2) i = sw - 2 < 0 ? 0 : sw - 2;
        x0[x] = i;
        x1[x] = i + 1 < sw ? i + 1 : sw - 1;
        xw[x] = c - i;
    }
    float sy = static_cast<float>(sh) / th;
    for (int y = 0; y < th; ++y) {
        float c = (y + 0.5f) * sy - 0.5f;
        if (c < 0) c = 0;
        int yi = static_cast<int>(c);
        if (yi > sh - 2) yi = sh - 2 < 0 ? 0 : sh - 2;
        int y1 = yi + 1 < sh ? yi + 1 : sh - 1;
        float wy = c - yi;
        const uint8_t* r0 = src + yi * src_stride;
        const uint8_t* r1 = src + y1 * src_stride;
        for (int x = 0; x < tw; ++x) {
            float a = r0[x0[x] * pix] * (1.0f - xw[x]) + r0[x1[x] * pix] * xw[x];
            float b = r1[x0[x] * pix] * (1.0f - xw[x]) + r1[x1[x] * pix] * xw[x];
            float v = a * (1.0f - wy) + b * wy;
            dst[y * dst_stride + x * dst_pix] = static_cast<uint8_t>(v + 0.5f);
        }
    }
}

// Best M/8 DCT scale whose scaled size covers the target on both axes
// (libjpeg computes scaled dims as ceil(dim*M/8), jdiv_round_up).
void select_scale(jpeg_decompress_struct* dinfo, int target_h, int target_w) {
    int m = 8;
    for (int cand = 1; cand <= 8; ++cand) {
        long sh = (static_cast<long>(dinfo->image_height) * cand + 7) / 8;
        long sw = (static_cast<long>(dinfo->image_width) * cand + 7) / 8;
        if (sh >= target_h && sw >= target_w) {
            m = cand;
            break;
        }
    }
    dinfo->scale_num = m;
    dinfo->scale_denom = 8;
}

// Drain all scanlines into dst (row stride `stride`), 8 rows per call.
void read_all_scanlines(jpeg_decompress_struct* dinfo, uint8_t* dst,
                        size_t stride) {
    while (dinfo->output_scanline < dinfo->output_height) {
        uint8_t* rows[8];
        int n = 0;
        for (; n < 8 && dinfo->output_scanline + n < dinfo->output_height; ++n)
            rows[n] = dst + (dinfo->output_scanline + n) * stride;
        jpeg_read_scanlines(dinfo, rows, n);
    }
}

}  // namespace

extern "C" {

const char* ajd_last_error() { return g_error.c_str(); }

// Header probe: source dimensions without decoding. Returns 0 on success.
int ajd_probe(const uint8_t* data, uint64_t size, int32_t* h, int32_t* w) {
    jpeg_decompress_struct dinfo;
    ErrorMgr err;
    dinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    err.pub.emit_message = on_emit;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&dinfo);
        return -1;
    }
    jpeg_create_decompress(&dinfo);
    jpeg_mem_src(&dinfo, data, size);
    jpeg_read_header(&dinfo, TRUE);
    *h = dinfo.image_height;
    *w = dinfo.image_width;
    jpeg_destroy_decompress(&dinfo);
    return 0;
}

// Decode to the YUV 4:2:0 wire layout at exactly (target_h, target_w)
// (both even): out_y is target_h*target_w bytes, out_cbcr is
// (target_h/2)*(target_w/2)*2 bytes, channel order Cb, Cr.
// Grayscale JPEGs produce neutral chroma (128). Returns 0 on success.
int ajd_decode_yuv420(const uint8_t* data, uint64_t size, int32_t target_h,
                      int32_t target_w, uint8_t* out_y, uint8_t* out_cbcr) {
    if (target_h <= 0 || target_w <= 0 || (target_h | target_w) & 1) {
        set_error("target dimensions must be positive and even");
        return -2;
    }
    jpeg_decompress_struct dinfo;
    ErrorMgr err;
    dinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    err.pub.emit_message = on_emit;
    std::vector<uint8_t> decoded;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&dinfo);
        return -1;
    }
    jpeg_create_decompress(&dinfo);
    jpeg_mem_src(&dinfo, data, size);
    jpeg_read_header(&dinfo, TRUE);

    bool gray = dinfo.jpeg_color_space == JCS_GRAYSCALE;
    // libjpeg decodes JPEG's native YCbCr without any color conversion;
    // chroma upsampling uses cheap replication (we re-subsample anyway)
    dinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_YCbCr;
    dinfo.do_fancy_upsampling = FALSE;
    dinfo.dct_method = JDCT_ISLOW;  // the quality baseline (turbo SIMD anyway)

    select_scale(&dinfo, target_h, target_w);

    jpeg_start_decompress(&dinfo);
    int sh = dinfo.output_height;
    int sw = dinfo.output_width;
    int ch = dinfo.output_components;  // 3 (YCbCr) or 1 (gray)
    size_t stride = static_cast<size_t>(sw) * ch;
    decoded.resize(stride * sh);
    read_all_scanlines(&dinfo, decoded.data(), stride);
    jpeg_finish_decompress(&dinfo);
    jpeg_destroy_decompress(&dinfo);

    int hh = target_h / 2, hw = target_w / 2;
    // Y: full-resolution resize
    resize_plane(decoded.data(), sh, sw, static_cast<int>(stride), ch, out_y,
                 target_h, target_w, target_w, 1);
    if (gray) {
        std::memset(out_cbcr, 128, static_cast<size_t>(hh) * hw * 2);
        return 0;
    }
    // Cb/Cr: resize straight to HALF target resolution (skips the full-res
    // chroma resize + 2x2 subsample entirely; the bilinear kernel averages
    // the same support)
    resize_plane(decoded.data() + 1, sh, sw, static_cast<int>(stride), ch,
                 out_cbcr, hh, hw, hw * 2, 2);
    resize_plane(decoded.data() + 2, sh, sw, static_cast<int>(stride), ch,
                 out_cbcr + 1, hh, hw, hw * 2, 2);
    return 0;
}

// Decode to interleaved uint8 RGB (or BGR) at exactly (target_h, target_w):
// out is target_h*target_w*3 bytes. Same M/8 DCT-scaled decode as the YUV
// path — the RGB-wire analog for pipelines not using the 4:2:0 wire (PIL
// draft only exposes power-of-two scales). libjpeg handles YCbCr->RGB and
// grayscale->RGB; CMYK sources fail (-1) and the caller falls back to PIL.
// Returns 0 on success.
int ajd_decode_rgb(const uint8_t* data, uint64_t size, int32_t target_h,
                   int32_t target_w, int32_t as_bgr, uint8_t* out) {
    if (target_h <= 0 || target_w <= 0) {
        set_error("target dimensions must be positive");
        return -2;
    }
    jpeg_decompress_struct dinfo;
    ErrorMgr err;
    dinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    err.pub.emit_message = on_emit;
    std::vector<uint8_t> decoded;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&dinfo);
        return -1;
    }
    jpeg_create_decompress(&dinfo);
    jpeg_mem_src(&dinfo, data, size);
    jpeg_read_header(&dinfo, TRUE);

    dinfo.out_color_space = JCS_RGB;
    dinfo.dct_method = JDCT_ISLOW;

    select_scale(&dinfo, target_h, target_w);

    jpeg_start_decompress(&dinfo);
    int sh = dinfo.output_height;
    int sw = dinfo.output_width;
    int ch = dinfo.output_components;  // 3 after JCS_RGB conversion
    if (ch != 3) {
        jpeg_destroy_decompress(&dinfo);
        set_error("unexpected component count for RGB output");
        return -3;
    }
    size_t stride = static_cast<size_t>(sw) * ch;
    if (sh == target_h && sw == target_w) {
        // exact-size decode (no resize / native-size use): scanlines land
        // directly in the caller's buffer — no intermediate, no copies
        read_all_scanlines(&dinfo, out, stride);
        jpeg_finish_decompress(&dinfo);
        jpeg_destroy_decompress(&dinfo);
        if (as_bgr) {
            size_t px = static_cast<size_t>(target_h) * target_w;
            for (size_t i = 0; i < px; ++i) {
                uint8_t t = out[i * 3];
                out[i * 3] = out[i * 3 + 2];
                out[i * 3 + 2] = t;
            }
        }
        return 0;
    }
    decoded.resize(stride * sh);
    read_all_scanlines(&dinfo, decoded.data(), stride);
    jpeg_finish_decompress(&dinfo);
    jpeg_destroy_decompress(&dinfo);

    for (int c = 0; c < 3; ++c) {
        int oc = as_bgr ? 2 - c : c;
        resize_plane(decoded.data() + c, sh, sw, static_cast<int>(stride), ch,
                     out + oc, target_h, target_w, target_w * 3, 3);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Coefficient-domain ("DCT wire") entry points.
//
// The TPU-first split of JPEG decode: the host runs ONLY the entropy
// (Huffman/arithmetic) half and ships the quantized DCT coefficients; the
// device runs dequantize + scaled IDCT (8x8-block matmuls — MXU-native) +
// resize + color conversion inside the fused preprocess program. Quantized
// coefficients are the file's actual information content, so they compress
// far better than any pixel-domain wire (most AC values are zero), and the
// host saves the IDCT+upsample+resize work entirely.
//
// Layout contract (see processing_steps/dct_wire.py): per component, the
// m x m top-left (natural-order) coefficient subset of every block —
// exactly the subset libjpeg's own M/8 scaled decode uses.

// Header-only probe for the coefficient read. out_info (8 int32):
//   [0] src_h  [1] src_w  [2] ncomp (1 or 3)
//   [3] bh_y   [4] bw_y   (luma block grid, = libjpeg {height,width}_in_blocks)
//   [5] bh_c   [6] bw_c   (chroma block grid; 4:2:0 dims even for grayscale)
//   [7] progressive flag (informational)
// Requires grayscale or YCbCr 4:2:0 (the JPEG default); returns -3 for
// other samplings/colorspaces (caller falls back to the pixel wire).
int ajd_dct_info(const uint8_t* data, uint64_t size, int32_t* out_info) {
    jpeg_decompress_struct dinfo;
    ErrorMgr err;
    dinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    err.pub.emit_message = on_emit;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&dinfo);
        return -1;
    }
    jpeg_create_decompress(&dinfo);
    jpeg_mem_src(&dinfo, data, size);
    jpeg_read_header(&dinfo, TRUE);
    long h = dinfo.image_height, w = dinfo.image_width;
    bool gray = dinfo.jpeg_color_space == JCS_GRAYSCALE && dinfo.num_components == 1;
    bool ycbcr420 =
        dinfo.jpeg_color_space == JCS_YCbCr && dinfo.num_components == 3 &&
        dinfo.comp_info[0].h_samp_factor == 2 && dinfo.comp_info[0].v_samp_factor == 2 &&
        dinfo.comp_info[1].h_samp_factor == 1 && dinfo.comp_info[1].v_samp_factor == 1 &&
        dinfo.comp_info[2].h_samp_factor == 1 && dinfo.comp_info[2].v_samp_factor == 1 &&
        dinfo.comp_info[1].quant_tbl_no == dinfo.comp_info[2].quant_tbl_no;
    if (!gray && !ycbcr420) {
        jpeg_destroy_decompress(&dinfo);
        set_error("DCT wire supports grayscale or YCbCr 4:2:0 JPEGs only");
        return -3;
    }
    out_info[0] = static_cast<int32_t>(h);
    out_info[1] = static_cast<int32_t>(w);
    out_info[2] = gray ? 1 : 3;
    // libjpeg (jdinput.c): blocks = ceil(dim * samp / (max_samp * 8)).
    // Grayscale: max_samp = 1; synthesize the 4:2:0 chroma grid a real
    // 4:2:0 file of this size would have (the caller zero-fills it).
    int max_h = gray ? 1 : 2, max_v = gray ? 1 : 2;
    int yh = gray ? 1 : 2, yv = gray ? 1 : 2;
    out_info[3] = static_cast<int32_t>((h * yv + max_v * 8 - 1) / (max_v * 8));
    out_info[4] = static_cast<int32_t>((w * yh + max_h * 8 - 1) / (max_h * 8));
    out_info[5] = static_cast<int32_t>((h + 2 * 8 - 1) / (2 * 8));
    out_info[6] = static_cast<int32_t>((w + 2 * 8 - 1) / (2 * 8));
    out_info[7] = dinfo.progressive_mode ? 1 : 0;
    jpeg_destroy_decompress(&dinfo);
    return 0;
}

// Entropy-decode only: fill the m x m coefficient subset of every block.
// out_y: (bh_y, bw_y, m, m) int16; out_cb/out_cr: (bh_c, bw_c, m, m) int16
// (untouched for grayscale — caller pre-zeros; all-zero blocks IDCT to the
// neutral 128 after the +128 level shift, exactly neutral chroma).
// out_quant: (2, m, m) uint16 — luma table then chroma table (luma copied
// for grayscale). Natural order everywhere (libjpeg stores both blocks and
// quantval in natural order after marker/entropy decode). Returns 0 on
// success; grid dims must match ajd_dct_info's (-4 if libjpeg disagrees).
int ajd_read_dct(const uint8_t* data, uint64_t size, int32_t m,
                 int32_t bh_y, int32_t bw_y, int32_t bh_c, int32_t bw_c,
                 int16_t* out_y, int16_t* out_cb, int16_t* out_cr,
                 uint16_t* out_quant) {
    if (m < 1 || m > 8) {
        set_error("m must be in 1..8");
        return -2;
    }
    jpeg_decompress_struct dinfo;
    ErrorMgr err;
    dinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    err.pub.emit_message = on_emit;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&dinfo);
        return -1;
    }
    jpeg_create_decompress(&dinfo);
    jpeg_mem_src(&dinfo, data, size);
    jpeg_read_header(&dinfo, TRUE);
    bool gray = dinfo.jpeg_color_space == JCS_GRAYSCALE && dinfo.num_components == 1;
    jvirt_barray_ptr* coef = jpeg_read_coefficients(&dinfo);
    if (coef == nullptr) {
        jpeg_destroy_decompress(&dinfo);
        set_error("jpeg_read_coefficients failed");
        return -1;
    }
    const int32_t exp_bh[3] = {bh_y, bh_c, bh_c};
    const int32_t exp_bw[3] = {bw_y, bw_c, bw_c};
    int16_t* outs[3] = {out_y, out_cb, out_cr};
    int ncomp = gray ? 1 : 3;
    for (int ci = 0; ci < ncomp; ++ci) {
        jpeg_component_info* comp = &dinfo.comp_info[ci];
        if (static_cast<int32_t>(comp->height_in_blocks) != exp_bh[ci] ||
            static_cast<int32_t>(comp->width_in_blocks) != exp_bw[ci]) {
            jpeg_destroy_decompress(&dinfo);
            set_error("block grid mismatch vs ajd_dct_info");
            return -4;
        }
        int16_t* dst = outs[ci];
        const size_t block_out = static_cast<size_t>(m) * m;
        for (JDIMENSION row = 0; row < comp->height_in_blocks; ++row) {
            JBLOCKARRAY rows = (*dinfo.mem->access_virt_barray)(
                reinterpret_cast<j_common_ptr>(&dinfo), coef[ci], row, 1, FALSE);
            for (JDIMENSION col = 0; col < comp->width_in_blocks; ++col) {
                const JCOEF* blk = rows[0][col];
                int16_t* o = dst +
                    (static_cast<size_t>(row) * comp->width_in_blocks + col) * block_out;
                for (int r = 0; r < m; ++r)
                    for (int c = 0; c < m; ++c) {
                        // clamp to the legal 8-bit-baseline coefficient
                        // range: corrupt/adversarial streams can decode
                        // larger values (libjpeg accepts DC categories up
                        // to 15 and never clamps the DC accumulator), and
                        // downstream band encoders size their histograms
                        // for |coef| <= 2047
                        int v = blk[r * 8 + c];
                        if (v > 2047) v = 2047;
                        if (v < -2047) v = -2047;
                        o[r * m + c] = static_cast<int16_t>(v);
                    }
            }
        }
        // quant table subset, natural order (luma -> slot 0, chroma -> 1)
        if (ci < 2) {
            JQUANT_TBL* qt = dinfo.quant_tbl_ptrs[comp->quant_tbl_no];
            if (qt == nullptr) qt = comp->quant_table;
            if (qt == nullptr) {
                jpeg_destroy_decompress(&dinfo);
                set_error("missing quantization table");
                return -5;
            }
            uint16_t* q = out_quant + static_cast<size_t>(ci) * m * m;
            for (int r = 0; r < m; ++r)
                for (int c = 0; c < m; ++c)
                    q[r * m + c] = static_cast<uint16_t>(qt->quantval[r * 8 + c]);
        }
    }
    if (gray) {
        // chroma shares the luma table (its coefficient grids are all-zero)
        std::memcpy(out_quant + static_cast<size_t>(m) * m, out_quant,
                    static_cast<size_t>(m) * m * sizeof(uint16_t));
    }
    jpeg_finish_decompress(&dinfo);
    jpeg_destroy_decompress(&dinfo);
    return 0;
}

}  // extern "C"
