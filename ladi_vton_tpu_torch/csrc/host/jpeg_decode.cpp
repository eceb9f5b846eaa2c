// Baseline JPEG decoder of the port's data layer, bound with ctypes
// (ladi_vton_tpu_torch/data/native.py) and built with preprocess.cpp.
//
// It gives the pixels PIL gives (libjpeg-turbo with PIL's defaults):
//
// * sequential Huffman JPEG at 8 bits (SOF0, SOF1), 1 or 3 components,
//   interleaved or one scan per component, restart intervals, tables
//   defined anywhere before the scan that uses them (quantisation tables
//   latched at a component's first scan, as libjpeg does);
// * jidctint.c's "islow" integer IDCT with its range-limit table;
// * jdsample.c's fancy upsampling for components at half the width
//   (h2v1_fancy_upsample) or half the width and height
//   (h2v2_fancy_upsample), with their alternating rounding biases and
//   edge rows repeated as jdmainct.c repeats them; plain replication
//   where the downsampled width is 2 or less, as libjpeg-turbo falls back;
// * jdcolor.c's fixed-point YCbCr -> RGB.
//
// Anything else (progressive or lossless frames, arithmetic coding,
// 12-bit samples, Adobe or RGB-labelled colour, other sampling ratios)
// returns kUnsupported, so the caller can read the file's decoded
// sidecar instead; a damaged file returns kMalformed.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kUnsupported = 1, kMalformed = 2 };

// natural index of the k-th coefficient in zigzag order, then 16 extra
// entries so a damaged run length cannot index past the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
    bool defined = false;
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
    uint8_t look_sym[1 << kLookBits];

    // jdhuff.c jpeg_make_d_derived_tbl
    bool build(const uint8_t* bits, const uint8_t* symbols, int count) {
        int huffsize[257], huffcode[257];
        int p = 0;
        for (int l = 1; l <= 16; ++l)
            for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
        huffsize[p] = 0;
        int code = 0, si = huffsize[0];
        p = 0;
        while (huffsize[p]) {
            while (huffsize[p] == si) huffcode[p++] = code++;
            if (code >= (1 << si)) return false;
            code <<= 1;
            ++si;
        }
        p = 0;
        for (int l = 1; l <= 16; ++l) {
            if (bits[l - 1]) {
                valoffset[l] = p - huffcode[p];
                p += bits[l - 1];
                maxcode[l] = huffcode[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        maxcode[17] = 0x7FFFFFFF;
        std::memcpy(vals, symbols, count);
        std::memset(look_len, 0, sizeof(look_len));
        p = 0;
        for (int l = 1; l <= kLookBits; ++l) {
            for (int i = 0; i < bits[l - 1]; ++i, ++p) {
                int look = huffcode[p] << (kLookBits - l);
                for (int c = 0; c < (1 << (kLookBits - l)); ++c) {
                    look_len[look + c] = (uint8_t)l;
                    look_sym[look + c] = symbols[p];
                }
            }
        }
        defined = true;
        return true;
    }
};

// The entropy-coded segment, with byte stuffing undone; at a marker it
// stops and feeds zeros, as libjpeg does.
struct BitReader {
    const uint8_t* data;
    long size;
    long pos;
    uint64_t buf = 0;
    int count = 0;
    bool at_marker = false;

    void fill() {
        while (count <= 56) {
            int byte = 0;
            if (!at_marker && pos < size) {
                byte = data[pos];
                if (byte == 0xFF) {
                    long q = pos + 1;
                    while (q < size && data[q] == 0xFF) ++q;
                    if (q < size && data[q] == 0x00) {
                        pos = q + 1;
                    } else {
                        at_marker = true;
                        byte = 0;
                    }
                } else {
                    ++pos;
                }
            }
            buf |= (uint64_t)byte << (56 - count);
            count += 8;
        }
    }
    int get(int n) {
        if (n == 0) return 0;
        fill();
        int v = (int)(buf >> (64 - n));
        buf <<= n;
        count -= n;
        return v;
    }
    int decode(const Huffman& h) {
        fill();
        int look = (int)(buf >> (64 - kLookBits));
        int len = h.look_len[look];
        if (len) {
            buf <<= len;
            count -= len;
            return h.look_sym[look];
        }
        for (int l = kLookBits + 1; l <= 16; ++l) {
            int32_t code = (int32_t)(buf >> (64 - l));
            if (code <= h.maxcode[l]) {
                buf <<= l;
                count -= l;
                return h.vals[(h.valoffset[l] + code) & 0xFF];
            }
        }
        buf <<= 16;  // damaged: libjpeg warns and returns 0
        count -= 16;
        return 0;
    }
    // jdhuff.c HUFF_EXTEND of the next s bits
    int receive_extend(int s) {
        if (s == 0) return 0;
        int v = get(s);
        if (v < (1 << (s - 1))) v += (int)((~0u) << s) + 1;
        return v;
    }
    // the next marker at or after pos: skips what is left of the segment
    long next_marker() const {
        long q = pos;
        while (q + 1 < size) {
            if (data[q] == 0xFF && data[q + 1] != 0x00 && data[q + 1] != 0xFF)
                return q;
            ++q;
        }
        return size;
    }
    void restart_at(long p) {
        pos = p;
        buf = 0;
        count = 0;
        at_marker = false;
    }
};

struct Component {
    int id, h, v, tq;
    int quant[64];        // natural order, latched at the first scan
    bool latched = false;
    int bw = 0, bh = 0;   // blocks allocated (whole MCUs)
    int dw = 0, dh = 0;   // downsampled size in samples
    std::vector<int16_t> coef;
};

struct Decoder {
    const uint8_t* data;
    long size;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int mcux = 0, mcuy = 0;
    int restart_interval = 0;
    bool frame = false, jfif = false, adobe = false, scanned = false;
    int quant[4][64] = {};
    bool quant_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    Component comp[3];

    int u16(long p) const { return (data[p] << 8) | data[p + 1]; }

    int parse_dqt(long p, long end) {
        while (p < end) {
            int pq = data[p] >> 4, tq = data[p] & 15;
            ++p;
            if (tq > 3 || pq > 1) return kMalformed;
            if (p + 64 * (pq + 1) > end) return kMalformed;
            for (int k = 0; k < 64; ++k) {
                int q = pq ? u16(p + 2 * k) : data[p + k];
                quant[tq][kNatural[k]] = q;
            }
            p += 64 * (pq + 1);
            quant_defined[tq] = true;
        }
        return kOk;
    }

    int parse_dht(long p, long end) {
        while (p < end) {
            if (p + 17 > end) return kMalformed;
            int tc = data[p] >> 4, th = data[p] & 15;
            const uint8_t* bits = data + p + 1;
            int count = 0;
            for (int i = 0; i < 16; ++i) count += bits[i];
            if (tc > 1 || th > 3 || count > 256 || p + 17 + count > end)
                return kMalformed;
            Huffman& h = tc ? ac[th] : dc[th];
            if (!h.build(bits, data + p + 17, count)) return kMalformed;
            p += 17 + count;
        }
        return kOk;
    }

    int parse_sof(long p, long end) {
        if (frame) return kMalformed;
        if (end - p < 6) return kMalformed;
        if (data[p] != 8) return kUnsupported;  // 12-bit samples
        height = u16(p + 1);
        width = u16(p + 3);
        ncomp = data[p + 5];
        if (height == 0) return kUnsupported;  // height from a DNL marker
        if (width == 0) return kMalformed;
        if (ncomp != 1 && ncomp != 3) return kUnsupported;
        if (end - p < 6 + 3 * ncomp) return kMalformed;
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            k.id = data[p + 6 + 3 * c];
            k.h = data[p + 7 + 3 * c] >> 4;
            k.v = data[p + 7 + 3 * c] & 15;
            k.tq = data[p + 8 + 3 * c];
            if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
                return kMalformed;
            if (k.h > hmax) hmax = k.h;
            if (k.v > vmax) vmax = k.v;
        }
        if (ncomp == 1) {  // one component: its own sampling is the frame's
            hmax = comp[0].h;
            vmax = comp[0].v;
        }
        for (int c = 0; c < ncomp; ++c) {
            int rh = hmax / comp[c].h, rv = vmax / comp[c].v;
            bool whole = hmax % comp[c].h == 0 && vmax % comp[c].v == 0;
            if (!whole || !((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                            (rh == 2 && rv == 2)))
                return kUnsupported;
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            k.bw = mcux * k.h;
            k.bh = mcuy * k.v;
            k.dw = (int)(((long)width * k.h + hmax - 1) / hmax);
            k.dh = (int)(((long)height * k.v + vmax - 1) / vmax);
        }
        frame = true;
        return kOk;
    }

    bool rgb_labelled() const {
        // jdapimin.c default_decompress_parms: without JFIF or Adobe
        // markers, component IDs 'R', 'G', 'B' mean RGB
        return ncomp == 3 && !jfif && comp[0].id == 82 && comp[1].id == 71 &&
               comp[2].id == 66;
    }

    // Headers up to the first scan: size, channels, whether supported.
    int header() {
        if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return kMalformed;
        long p = 2;
        for (;;) {
            while (p < size && data[p] != 0xFF) ++p;  // garbage: skip
            while (p < size && data[p] == 0xFF) ++p;
            if (p >= size) return kMalformed;
            int marker = data[p++];
            if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) ||
                marker == 0x01)
                continue;
            if (marker == 0xD9) return kMalformed;  // no scan
            if (p + 2 > size) return kMalformed;
            int len = u16(p);
            if (len < 2 || p + len > size) return kMalformed;
            long body = p + 2, end = p + len;
            p = end;
            int err = kOk;
            if (marker == 0xC0 || marker == 0xC1) {
                err = parse_sof(body, end);
            } else if ((marker >= 0xC2 && marker <= 0xCF) && marker != 0xC4 &&
                       marker != 0xC8 && marker != 0xCC) {
                return kUnsupported;  // progressive, lossless, hierarchical,
                                      // arithmetic frames
            } else if (marker == 0xCC) {
                return kUnsupported;  // arithmetic conditioning tables
            } else if (marker == 0xE0) {
                if (end - body >= 5 && std::memcmp(data + body, "JFIF\0", 5) == 0)
                    jfif = true;
            } else if (marker == 0xEE) {
                if (end - body >= 5 && std::memcmp(data + body, "Adobe", 5) == 0)
                    adobe = true;
            } else if (marker == 0xDA) {
                if (!frame) return kMalformed;
                if (adobe || rgb_labelled()) return kUnsupported;
                return kOk;
            }
            if (err) return err;
        }
    }

    int decode_block(BitReader& br, int16_t* blk, int& pred,
                     const Huffman& hd, const Huffman& ha) {
        int s = br.decode(hd);
        if (s > 16) return kMalformed;
        pred += br.receive_extend(s);
        blk[0] = (int16_t)pred;
        for (int k = 1; k < 64; ++k) {
            int rs = br.decode(ha);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                int v = br.receive_extend(s);
                blk[kNatural[k]] = (int16_t)v;
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        return kOk;
    }

    // One scan: the SOS body at [p, end), entropy data from end.
    int scan(long p, long end, long* resume) {
        int ns = data[p];
        if (ns < 1 || ns > ncomp || end - p < 1 + 2 * ns + 3) return kMalformed;
        int idx[3], td[3], ta[3];
        for (int i = 0; i < ns; ++i) {
            int cid = data[p + 1 + 2 * i];
            idx[i] = -1;
            for (int c = 0; c < ncomp; ++c)
                if (comp[c].id == cid) idx[i] = c;
            if (idx[i] < 0) return kMalformed;
            td[i] = data[p + 2 + 2 * i] >> 4;
            ta[i] = data[p + 2 + 2 * i] & 15;
            if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined ||
                !ac[ta[i]].defined)
                return kMalformed;
        }
        int blocks_in_mcu = 0;
        for (int i = 0; i < ns; ++i) {
            Component& k = comp[idx[i]];
            if (!k.latched) {  // jdinput.c latch_quant_tables
                if (!quant_defined[k.tq]) return kMalformed;
                std::memcpy(k.quant, quant[k.tq], sizeof(k.quant));
                k.latched = true;
            }
            if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
            blocks_in_mcu += k.h * k.v;
        }
        if (ns > 1 && blocks_in_mcu > 10) return kMalformed;
        int cols, rows;
        if (ns == 1) {  // non-interleaved: one block an MCU, in raster order
            Component& k = comp[idx[0]];
            cols = (k.dw + 7) / 8;
            rows = (k.dh + 7) / 8;
        } else {
            cols = mcux;
            rows = mcuy;
        }
        BitReader br{data, size, end};
        int pred[3] = {0, 0, 0};
        long total = (long)cols * rows;
        int to_go = restart_interval;
        for (long m = 0; m < total; ++m) {
            if (restart_interval) {
                if (to_go == 0) {  // jdhuff.c process_restart
                    long q = br.next_marker();
                    if (q + 1 < size && data[q + 1] >= 0xD0 &&
                        data[q + 1] <= 0xD7)
                        q += 2;
                    br.restart_at(q);
                    pred[0] = pred[1] = pred[2] = 0;
                    to_go = restart_interval;
                }
                --to_go;
            }
            int mx = (int)(m % cols), my = (int)(m / cols);
            for (int i = 0; i < ns; ++i) {
                Component& k = comp[idx[i]];
                int nh = ns == 1 ? 1 : k.h, nv = ns == 1 ? 1 : k.v;
                for (int y = 0; y < nv; ++y) {
                    for (int x = 0; x < nh; ++x) {
                        int bx = mx * nh + x, by = my * nv + y;
                        int16_t* blk =
                            k.coef.data() + ((size_t)by * k.bw + bx) * 64;
                        int err = decode_block(br, blk, pred[i], dc[td[i]],
                                               ac[ta[i]]);
                        if (err) return err;
                    }
                }
            }
        }
        *resume = br.next_marker();
        scanned = true;
        return kOk;
    }

    int decode_all() {
        int err = header();
        if (err) return err;
        // parse again from the start, now decoding each scan
        jfif = adobe = frame = false;
        long p = 2;
        for (;;) {
            while (p < size && data[p] != 0xFF) ++p;
            while (p < size && data[p] == 0xFF) ++p;
            if (p >= size) break;  // no EOI: libjpeg warns and ends
            int marker = data[p++];
            if (marker == 0xD9) break;
            if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) ||
                marker == 0x01)
                continue;
            if (p + 2 > size) break;
            int len = u16(p);
            if (len < 2 || p + len > size) return kMalformed;
            long body = p + 2, end = p + len;
            p = end;
            if (marker == 0xC0 || marker == 0xC1) {
                err = parse_sof(body, end);
            } else if (marker == 0xC4) {
                err = parse_dht(body, end);
            } else if (marker == 0xDB) {
                err = parse_dqt(body, end);
            } else if (marker == 0xDD) {
                if (end - body < 2) return kMalformed;
                restart_interval = u16(body);
            } else if (marker == 0xE0) {
                if (end - body >= 5 && std::memcmp(data + body, "JFIF\0", 5) == 0)
                    jfif = true;
            } else if (marker == 0xDA) {
                if (!frame) return kMalformed;
                err = scan(body, end, &p);
            } else if ((marker >= 0xC2 && marker <= 0xCF) && marker != 0xC8) {
                return kUnsupported;
            }
            if (err) return err;
        }
        return scanned ? kOk : kMalformed;
    }
};

// jidctint.c jpeg_idct_islow, for 8-bit samples
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + ((int64_t)1 << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range limit: x & 1023 read as a signed 10-bit
// value, plus 128, clamped to 0..255
inline uint8_t idct_limit(int64_t x) {
    int v = (int)(x & 1023);
    if (v >= 512) v -= 1024;
    v += 128;
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const int* qp = q + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
            ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
            for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
            continue;
        }
        int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
        int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = kConstBits - kPass1Bits;
        ws[0 * 8 + c] = (int)descale(tmp10 + tmp3, sh);
        ws[7 * 8 + c] = (int)descale(tmp10 - tmp3, sh);
        ws[1 * 8 + c] = (int)descale(tmp11 + tmp2, sh);
        ws[6 * 8 + c] = (int)descale(tmp11 - tmp2, sh);
        ws[2 * 8 + c] = (int)descale(tmp12 + tmp1, sh);
        ws[5 * 8 + c] = (int)descale(tmp12 - tmp1, sh);
        ws[3 * 8 + c] = (int)descale(tmp13 + tmp0, sh);
        ws[4 * 8 + c] = (int)descale(tmp13 - tmp0, sh);
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + r * 8;
        uint8_t* o = out + (size_t)r * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
            w[6] == 0 && w[7] == 0) {
            uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
            for (int c = 0; c < 8; ++c) o[c] = dc;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
        int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = idct_limit(descale(tmp10 + tmp3, sh));
        o[7] = idct_limit(descale(tmp10 - tmp3, sh));
        o[1] = idct_limit(descale(tmp11 + tmp2, sh));
        o[6] = idct_limit(descale(tmp11 - tmp2, sh));
        o[2] = idct_limit(descale(tmp12 + tmp1, sh));
        o[5] = idct_limit(descale(tmp12 - tmp1, sh));
        o[3] = idct_limit(descale(tmp13 + tmp0, sh));
        o[4] = idct_limit(descale(tmp13 - tmp0, sh));
    }
}

// A component's samples (bw*8 wide) upsampled to one row of the output
// width (jdsample.c): `row` is the output row, `out` width samples.
void upsample_row(const Component& k, const uint8_t* plane, int hmax,
                  int vmax, int row, int width, uint8_t* out) {
    const int stride = k.bw * 8;
    const int rh = hmax / k.h, rv = vmax / k.v;
    if (rh == 1 && rv == 1) {
        std::memcpy(out, plane + (size_t)row * stride, width);
        return;
    }
    const bool fancy = k.dw > 2;
    if (rv == 1) {  // h2v1
        const uint8_t* in = plane + (size_t)row * stride;
        for (int x = 0; x < width; ++x) {
            int j = x >> 1;
            if (!fancy) {
                out[x] = in[j];
            } else if (x & 1) {
                out[x] = j == k.dw - 1 ? in[j]
                                       : (uint8_t)((in[j] * 3 + in[j + 1] + 2) >> 2);
            } else {
                out[x] = j == 0 ? in[0]
                                : (uint8_t)((in[j] * 3 + in[j - 1] + 1) >> 2);
            }
        }
        return;
    }
    // h2v2: the nearer input row, and the row above (even output rows) or
    // below (odd ones), repeated at the edges (jdmainct.c)
    const int r = row >> 1;
    if (!fancy) {
        const uint8_t* in = plane + (size_t)r * stride;
        for (int x = 0; x < width; ++x) out[x] = in[x >> 1];
        return;
    }
    int r1 = (row & 1) ? r + 1 : r - 1;
    if (r1 < 0) r1 = 0;
    if (r1 > k.dh - 1) r1 = k.dh - 1;
    const uint8_t* in0 = plane + (size_t)r * stride;
    const uint8_t* in1 = plane + (size_t)r1 * stride;
    auto colsum = [&](int j) { return in0[j] * 3 + in1[j]; };
    for (int x = 0; x < width; ++x) {
        int j = x >> 1;
        int s = colsum(j);
        if (x & 1) {
            out[x] = j == k.dw - 1 ? (uint8_t)((s * 4 + 7) >> 4)
                                   : (uint8_t)((s * 3 + colsum(j + 1) + 7) >> 4);
        } else {
            out[x] = j == 0 ? (uint8_t)((s * 4 + 8) >> 4)
                            : (uint8_t)((s * 3 + colsum(j - 1) + 8) >> 4);
        }
    }
}

inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// Size and channels of a JPEG: dims = {height, width, channels}.
// Returns 0, 1 (a JPEG this decoder does not read) or 2 (damaged).
int jpeg_decode_header(const uint8_t* data, long size, int* dims) {
    Decoder d{data, size};
    int err = d.header();
    if (err) return err;
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.ncomp;
    return kOk;
}

// Decodes into out (height * width * channels bytes, row-major).
int jpeg_decode(const uint8_t* data, long size, uint8_t* out, long out_size) {
    Decoder d{data, size};
    int err = d.decode_all();
    if (err) return err;
    const int H = d.height, W = d.width, n = d.ncomp;
    if (out_size != (long)H * W * n) return kMalformed;
    std::vector<uint8_t> planes[3];
    for (int c = 0; c < n; ++c) {
        Component& k = d.comp[c];
        if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
        if (!k.latched) {
            std::memcpy(k.quant, d.quant[k.tq], sizeof(k.quant));
        }
        const int stride = k.bw * 8;
        planes[c].assign((size_t)stride * k.bh * 8, 0);
        for (int by = 0; by < k.bh; ++by)
            for (int bx = 0; bx < k.bw; ++bx)
                idct_islow(k.coef.data() + ((size_t)by * k.bw + bx) * 64,
                           k.quant,
                           planes[c].data() + (size_t)by * 8 * stride + bx * 8,
                           stride);
    }
    if (n == 1) {
        for (int y = 0; y < H; ++y)
            upsample_row(d.comp[0], planes[0].data(), d.hmax, d.vmax, y, W,
                         out + (size_t)y * W);
        return kOk;
    }
    // jdcolor.c build_ycc_rgb_table and ycc_rgb_convert
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t one_half = (int64_t)1 << 15;
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (int)((91881 * x + one_half) >> 16);
        cb_b[i] = (int)((116130 * x + one_half) >> 16);
        cr_g[i] = -46802 * x;
        cb_g[i] = -22554 * x + one_half;
    }
    std::vector<uint8_t> rows(3 * (size_t)W);
    for (int y = 0; y < H; ++y) {
        for (int c = 0; c < 3; ++c)
            upsample_row(d.comp[c], planes[c].data(), d.hmax, d.vmax, y, W,
                         rows.data() + (size_t)c * W);
        const uint8_t* Y = rows.data();
        const uint8_t* Cb = Y + W;
        const uint8_t* Cr = Cb + W;
        uint8_t* o = out + (size_t)y * W * 3;
        for (int x = 0; x < W; ++x) {
            int yy = Y[x], cb = Cb[x], cr = Cr[x];
            o[3 * x] = clamp255(yy + cr_r[cr]);
            o[3 * x + 1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
            o[3 * x + 2] = clamp255(yy + cb_b[cb]);
        }
    }
    return kOk;
}

}  // extern "C"
