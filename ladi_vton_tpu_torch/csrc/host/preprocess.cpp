// Host-side C++ of the port's data layer, bound with ctypes
// (ladi_vton_tpu_torch/data/native.py) and built at first use with the
// host compiler.  No dependencies beyond the C++ standard library.
//
// * keypoint_heatmaps, draw_polyline, box_dilate: the inner loops of the
//   garment-agnostic composition, the same code as the JAX package's
//   native/preprocess.cpp, so the two give the same maps.  Their numpy
//   versions are data/raster.py.
// * png_unfilter: undoes PNG's five row filters.  Sub, Average and Paeth
//   depend on the pixel just decoded to their left, which numpy cannot
//   vectorise.
// * jpeg_encode_blocks: the entropy-coded segment of a baseline JPEG
//   from quantised blocks in zigzag order (data/imageio.py does the
//   colour conversion, DCT and quantisation).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Gaussian heatmaps: one (H, W) float32 map per keypoint,
// exp(-d^2/sigma^2), max-normalised; a zero map when neither coordinate
// is positive (reference posemap.py:6-34).
void keypoint_heatmaps(const float* kpoints, int n_points, int height,
                       int width, float sigma, float* out) {
    const float inv_s2 = 1.0f / (sigma * sigma);
    for (int p = 0; p < n_points; ++p) {
        float x = kpoints[2 * p];
        float y = kpoints[2 * p + 1];
        float* map = out + (size_t)p * height * width;
        if (!(x > 0.0f || y > 0.0f)) {
            std::memset(map, 0, sizeof(float) * height * width);
            continue;
        }
        float maxv = 0.0f;
        for (int i = 0; i < height; ++i) {
            float dy = (float)i - y;
            float dy2 = dy * dy;
            float* row = map + (size_t)i * width;
            for (int j = 0; j < width; ++j) {
                float dx = (float)j - x;
                float v = std::exp(-(dx * dx + dy2) * inv_s2);
                row[j] = v;
                maxv = std::max(maxv, v);
            }
        }
        const float norm = 1.0f / (maxv + 1.1920929e-07f);
        for (size_t i = 0; i < (size_t)height * width; ++i) map[i] *= norm;
    }
}

// Thick polyline with PIL semantics: flat-capped segment rectangles and
// round disks at interior joints (joint='curve'); coordinates truncated
// to uint16 as the reference casts them.  Writes 1.0 into covered pixels.
void draw_polyline(const float* points, int n_points, int height,
                   int width, float line_width, float* out) {
    if (n_points < 2) return;
    const float r = line_width * 0.5f;
    const float r2 = r * r;
    for (int s = 0; s + 1 < n_points; ++s) {
        float x0 = (float)(uint16_t)points[2 * s];
        float y0 = (float)(uint16_t)points[2 * s + 1];
        float x1 = (float)(uint16_t)points[2 * s + 2];
        float y1 = (float)(uint16_t)points[2 * s + 3];
        float dx = x1 - x0, dy = y1 - y0;
        float len2 = dx * dx + dy * dy;
        if (len2 == 0.0f) continue;
        int jy0 = std::max(0, (int)std::floor(std::min(y0, y1) - r));
        int jy1 = std::min(height - 1, (int)std::ceil(std::max(y0, y1) + r));
        int jx0 = std::max(0, (int)std::floor(std::min(x0, x1) - r));
        int jx1 = std::min(width - 1, (int)std::ceil(std::max(x0, x1) + r));
        for (int i = jy0; i <= jy1; ++i) {
            float* row = out + (size_t)i * width;
            for (int j = jx0; j <= jx1; ++j) {
                float t = ((j - x0) * dx + (i - y0) * dy) / len2;
                if (t < 0.0f || t > 1.0f) continue;  // flat caps
                float px = x0 + t * dx, py = y0 + t * dy;
                float ddx = j - px, ddy = i - py;
                if (ddx * ddx + ddy * ddy <= r2) row[j] = 1.0f;
            }
        }
    }
    for (int p = 1; p + 1 < n_points; ++p) {  // round interior joints
        float cx = (float)(uint16_t)points[2 * p];
        float cy = (float)(uint16_t)points[2 * p + 1];
        int jy0 = std::max(0, (int)std::floor(cy - r));
        int jy1 = std::min(height - 1, (int)std::ceil(cy + r));
        int jx0 = std::max(0, (int)std::floor(cx - r));
        int jx1 = std::min(width - 1, (int)std::ceil(cx + r));
        for (int i = jy0; i <= jy1; ++i) {
            float* row = out + (size_t)i * width;
            for (int j = jx0; j <= jx1; ++j) {
                float ddx = j - cx, ddy = i - cy;
                if (ddx * ddx + ddy * ddy <= r2) row[j] = 1.0f;
            }
        }
    }
}

// Binary dilation with a k x k box applied `iterations` times, which is
// one (it*(k-1)+1) box dilation (cv2.dilate at reference
// dresscode.py:350): a separable max filter, rows then columns.
void box_dilate(const float* in, int height, int width, int kernel,
                int iterations, float* out) {
    int eff = iterations * (kernel - 1) + 1;
    int half = (eff - 1) / 2;
    int hi_pad = eff - 1 - half;
    float* tmp = new float[(size_t)height * width];
    for (int i = 0; i < height; ++i) {
        const float* row = in + (size_t)i * width;
        float* trow = tmp + (size_t)i * width;
        for (int j = 0; j < width; ++j) {
            int a = std::max(0, j - half);
            int b = std::min(width - 1, j + hi_pad);
            float m = 0.0f;
            for (int t = a; t <= b; ++t) m = std::max(m, row[t]);
            trow[j] = m;
        }
    }
    for (int j = 0; j < width; ++j) {
        for (int i = 0; i < height; ++i) {
            int a = std::max(0, i - half);
            int b = std::min(height - 1, i + hi_pad);
            float m = 0.0f;
            for (int t = a; t <= b; ++t)
                m = std::max(m, tmp[(size_t)t * width + j]);
            out[(size_t)i * width + j] = m;
        }
    }
    delete[] tmp;
}

// PNG un-filtering (PNG specification, section 9): `in` holds `height`
// rows of one filter-type byte and `row_bytes` filtered bytes; `bpp` is
// the bytes per complete pixel (at least 1).  Writes the raw rows to
// `out` (height * row_bytes).  Returns 0, or -(row + 1) for a row with
// an unknown filter type.
int png_unfilter(const uint8_t* in, int height, int row_bytes, int bpp,
                 uint8_t* out) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* src = in + (size_t)y * (row_bytes + 1);
        uint8_t ftype = src[0];
        ++src;
        uint8_t* dst = out + (size_t)y * row_bytes;
        const uint8_t* up = y ? dst - row_bytes : nullptr;
        switch (ftype) {
        case 0:
            std::memcpy(dst, src, row_bytes);
            break;
        case 1:
            for (int i = 0; i < row_bytes; ++i)
                dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
            break;
        case 2:
            for (int i = 0; i < row_bytes; ++i)
                dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (int i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? dst[i - bpp] : 0;
                int b = up ? up[i] : 0;
                dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? dst[i - bpp] : 0;
                int b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                int p = a + b - c;
                int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                dst[i] = (uint8_t)(src[i] + pred);
            }
            break;
        default:
            return -(y + 1);
        }
    }
    return 0;
}

namespace {

struct BitWriter {
    uint8_t* out;
    long cap;
    long n = 0;
    uint32_t acc = 0;  // pending bits, right-aligned
    int bits = 0;
    bool overflow = false;

    void byte(uint8_t b) {
        if (n + 2 > cap) {
            overflow = true;
            return;
        }
        out[n++] = b;
        if (b == 0xFF) out[n++] = 0x00;  // byte stuffing
    }
    void put(uint32_t code, int size) {
        if (size == 0) return;
        acc = (acc << size) | (code & ((1u << size) - 1));
        bits += size;
        while (bits >= 8) {
            bits -= 8;
            byte((uint8_t)(acc >> bits));
        }
        acc &= (1u << bits) - 1;
    }
    void flush() {  // pad the last byte with one-bits
        if (bits > 0) put((1u << (8 - bits)) - 1, 8 - bits);
    }
};

inline int category(int v) {
    int a = v < 0 ? -v : v;
    int n = 0;
    while (a) {
        ++n;
        a >>= 1;
    }
    return n;
}

inline uint32_t magnitude_bits(int v, int size) {
    return (uint32_t)(v < 0 ? v + (1 << size) - 1 : v);
}

}  // namespace

// The entropy-coded segment of a baseline sequential JPEG scan (ITU T.81
// F.1.2): `blocks` holds `nblocks` blocks of 64 quantised coefficients in
// zigzag order, in the scan's order; `comp[b]` is block b's component
// (0..2), `table[c]` the Huffman table of component c (0 or 1).  DC is
// coded as the difference to the component's previous block.  `dc_code`,
// `dc_size` ([2][16]) and `ac_code`, `ac_size` ([2][256]) are the
// Huffman codes by symbol.  Writes byte-stuffed bytes, padded with
// one-bits, to `out`; returns their count, or -1 if `cap` is too small.
long jpeg_encode_blocks(const int16_t* blocks, long nblocks,
                        const uint8_t* comp, const uint8_t* table,
                        const uint16_t* dc_code, const uint8_t* dc_size,
                        const uint16_t* ac_code, const uint8_t* ac_size,
                        uint8_t* out, long cap) {
    BitWriter w{out, cap};
    int pred[3] = {0, 0, 0};
    for (long b = 0; b < nblocks; ++b) {
        const int16_t* k = blocks + b * 64;
        int c = comp[b];
        int t = table[c];
        int diff = k[0] - pred[c];
        pred[c] = k[0];
        int s = category(diff);
        w.put(dc_code[t * 16 + s], dc_size[t * 16 + s]);
        w.put(magnitude_bits(diff, s), s);
        int run = 0;
        for (int i = 1; i < 64; ++i) {
            int v = k[i];
            if (v == 0) {
                ++run;
                continue;
            }
            while (run > 15) {  // ZRL
                w.put(ac_code[t * 256 + 0xF0], ac_size[t * 256 + 0xF0]);
                run -= 16;
            }
            int sz = category(v);
            int sym = (run << 4) | sz;
            w.put(ac_code[t * 256 + sym], ac_size[t * 256 + sym]);
            w.put(magnitude_bits(v, sz), sz);
            run = 0;
        }
        if (run > 0) w.put(ac_code[t * 256], ac_size[t * 256]);  // EOB
        if (w.overflow) return -1;
    }
    w.flush();
    return w.overflow ? -1 : w.n;
}

}  // extern "C"
