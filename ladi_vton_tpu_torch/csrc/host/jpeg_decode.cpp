// JPEG decoder of the port's data layer, bound with ctypes
// (ladi_vton_tpu_torch/data/native.py) and built with preprocess.cpp.
//
// It gives the pixels np.asarray(PIL.Image.open(path)) gives (PIL on
// libjpeg-turbo 3.1, with PIL's defaults), following libjpeg's integer
// arithmetic file by file:
//
// * frames at 8 bits with 1, 3 or 4 components: sequential Huffman (SOF0,
//   SOF1; jdhuff.c), progressive Huffman (SOF2; jdphuff.c: DC first and
//   refinement, AC first with end-of-band runs, AC refinement), and
//   arithmetic coding, sequential (SOF9) and progressive (SOF10)
//   (jdarith.c: the QM decoder and its statistics bins, conditioned by a
//   DAC segment or its defaults); interleaved or one scan per component,
//   restart intervals (which reset the predictors, the end-of-band run
//   and the statistics), tables defined anywhere before the scan that
//   uses them (quantisation tables latched at a component's first scan);
//   a scan script that libjpeg only warns about decodes on, one that it
//   rejects (jdphuff.c start_pass_phuff_decoder) is damaged;
// * lossless Huffman frames (SOF3) at 8 bits (jdlhuff.c, jddiffct.c,
//   jdlossls.c of libjpeg-turbo 3.1): predictors 1-7 from each scan's Ss,
//   a first row (of a scan, a restart interval, or after an MCU row met
//   out of data) predicted from the left and its first sample from
//   2^(P-Pt-1), a first column from above, differences of categories 0-16
//   (16: 32768, no bits) undifferenced to 16 bits, each sample the low
//   byte of its value shifted left by the point transform Pt (Al);
//   restart intervals of whole MCU rows only (jddiffct.c), interleaved or
//   one scan per component, up to 10 samples an MCU; every component must
//   have been scanned (jmemmgr.c refuses to read a whole-image buffer no
//   scan wrote).  Subsampled components are replicated, never
//   upsampled fancily (jdsample.c: the lossless DCT size is 1);
// * the "islow" integer IDCT after the last scan, as libjpeg-turbo's x86
//   SIMD code computes it on 16-bit lanes (jidctint.c's result wherever
//   nothing overflows), and libjpeg-turbo's block smoothing where a
//   progressive file leaves any of the coefficients 1..9 inexact
//   (jdcoefct.c smoothing_ok and decompress_smooth_data, >= 2.1);
// * every integral sampling ratio as jdsample.c jinit_upsampler picks its
//   method: fancy h2v1, h1v2 (4:4:0) and h2v2 upsampling with their
//   alternating rounding biases and edge rows repeated as jdmainct.c
//   repeats them, plain replication where the downsampled width is 2 or
//   less (h2v1, h2v2) and for every other integral ratio (int_upsample,
//   for example 4:1:1);
// * colour as jdapimin.c default_decompress_parms settles it: YCbCr ->
//   RGB in jdcolor.c's fixed point; RGB without transform under an Adobe
//   marker with transform 0, or component ids 'R', 'G', 'B' without JFIF
//   (any three components without a marker in a lossless frame); four
//   components as CMYK, or YCCK under Adobe transform 2
//   (ycck_cmyk_convert), each byte then inverted as PIL's "CMYK;I" raw
//   mode inverts every CMYK JPEG.  A lossless frame in YCbCr or YCCK
//   returns kLosslessColor: libjpeg-turbo converts no colour in lossless
//   mode (jdcolor.c), so PIL cannot read it either;
// * a scan's components as jdmarker.c get_sos finds them: scan component
//   i matches only a frame component at position i or later, so a scan
//   listing them out of the frame's order is damaged;
// * damaged data as libjpeg meets it through PIL: a segment that runs
//   into a marker reads zeros, and a Huffman segment leaves its remaining
//   MCUs alone once a read took them; a bad Huffman code reads 17 bits
//   and gives 0; a restart marker out of its order is resynchronised
//   (jdmarker.c jpeg_resync_to_restart); smoothing takes the progression
//   before the last scan past the last iMCU row decoded whole
//   (last_good_iMCU_row); markers are read after the scans as
//   jdmarker.c reads them.  A file that ends where libjpeg would wait for
//   more is damaged, as PIL reports it truncated, except after the scan
//   of a single-scan sequential image, which PIL has already put out.
//
// It returns kUnsupported, so the caller can read the file's decoded
// sidecar instead, for: lossless arithmetic frames (SOF11, which libjpeg
// cannot decode); 12-bit samples (lossless ones too) and a height left to
// a DNL marker (PIL refuses both when it opens the file); hierarchical
// frames (SOF5-7, SOF13-15) and the reserved SOF8 (libjpeg refuses them);
// 2 or more than 4 components (PIL refuses them); non-integral sampling
// ratios (libjpeg refuses them).  A damaged file returns kMalformed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kUnsupported = 1, kMalformed = 2, kLosslessColor = 4 };
// internal: the file ends inside a marker segment, where libjpeg waits
constexpr int kTruncated = 3;

// natural index of the k-th coefficient in zigzag order, then 16 extra
// entries so a damaged run length cannot index past the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;
constexpr int kMaxBlocksInMcu = 10;  // libjpeg's D_MAX_BLOCKS_IN_MCU

struct Huffman {
    bool valid = false;  // defined, its codes fitting
    bool dc_ok = false;  // every symbol <= 15: usable as a DC table
    bool lossless_ok = false;  // every symbol <= 16: a lossless table
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
        dc_ok = lossless_ok = true;
        for (int i = 0; i < count; ++i) {
            if (symbols[i] > 15) dc_ok = false;
            if (symbols[i] > 16) lossless_ok = false;
        }
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
        return true;
    }
};

// the next marker at or after p: skips what is left of a segment
long next_marker(const uint8_t* data, long size, long p) {
    while (p + 1 < size) {
        if (data[p] == 0xFF && data[p + 1] != 0x00 && data[p + 1] != 0xFF)
            return p;
        ++p;
    }
    return size;
}

// jdmarker.c read_restart_marker with jpeg_resync_to_restart, for the
// marker at q (size: none) where restart number `want` is due: where the
// next segment begins, and *pending when the marker stays unread, which
// leaves that segment empty.
long resync(const uint8_t* data, long size, long q, int want,
            bool* pending) {
    for (;;) {
        if (q + 1 >= size) {
            *pending = true;
            return size;
        }
        const int m = data[q + 1];
        const auto rst = [&](int n) { return m == 0xD0 + (n & 7); };
        int action;
        if (rst(want))
            action = 1;  // the expected restart: swallowed
        else if (m < 0xC0)
            action = 2;  // not a marker: scan on
        else if (m < 0xD0 || m > 0xD7 || rst(want + 1) || rst(want + 2))
            action = 3;  // another marker, or a restart still to come
        else if (rst(want - 1) || rst(want - 2))
            action = 2;  // a restart already past: scan on
        else
            action = 1;  // too far away: taken as the expected one
        *pending = action == 3;
        if (action == 1) return q + 2;
        if (action == 3) return q;
        q = next_marker(data, size, q + 2);
    }
}

// A Huffman-coded segment, with byte stuffing undone, read as jdhuff.c
// reads it: the buffer is filled to 57 bits or more only when a read
// needs more bits than it holds (CHECK_BIT_BUFFER, HUFF_DECODE's 8-bit
// lookahead, then one bit at a time), so the reader stands where
// libjpeg's stands.  At a marker it feeds zeros, as libjpeg does.  A read
// that takes any of those zeros is out of data (jpeg_fill_bit_buffer sets
// insufficient_data), after which libjpeg leaves the segment's remaining
// MCUs alone; the zeros come last, so a read has taken one exactly when
// fewer bits are left in buf than zeros were fed, which out_of_data()
// asks between MCUs.  A fill that runs into the end of the file sets
// `eof`: libjpeg waits there for more, and PIL reports the file
// truncated.
struct BitReader {
    const uint8_t* data;
    long size;
    long pos;
    uint64_t buf = 0;
    int count = 0;  // bits in buf
    int fed = 0;    // zero bits fed since the segment began
    bool at_marker = false;
    bool eof = false;
    bool insufficient = false;  // out of data before the last restart()

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
                        at_marker = q < size;
                        eof |= q >= size;
                        byte = 0;
                        fed += 8;
                    }
                } else {
                    ++pos;
                }
            } else {
                eof |= !at_marker;
                fed += 8;
            }
            buf |= (uint64_t)byte << (56 - count);
            count += 8;
        }
    }
    bool out_of_data() const { return insufficient || fed > count; }
    void consume(int n) {
        buf <<= n;
        count -= n;
    }
    int get(int n) {
        if (n == 0) return 0;
        if (count < n) fill();
        int v = (int)(buf >> (64 - n));
        consume(n);
        return v;
    }
    int decode(const Huffman& h) {
        if (count < 8) fill();
        int look = (int)(buf >> (64 - kLookBits));
        int len = h.look_len[look];
        if ((len == 0 || len > 8) && count < 9) {  // libjpeg's slow path
            fill();
            look = (int)(buf >> (64 - kLookBits));
            len = h.look_len[look];
        }
        if (len) {
            consume(len);
            return h.look_sym[look];
        }
        for (int l = kLookBits + 1; l <= 16; ++l) {
            if (count < l) fill();
            int32_t code = (int32_t)(buf >> (64 - l));
            if (code <= h.maxcode[l]) {
                consume(l);
                return h.vals[(h.valoffset[l] + code) & 0xFF];
            }
        }
        if (count < 17) fill();
        consume(17);  // damaged: libjpeg reads to its sentinel, returns 0
        return 0;
    }
    // jdhuff.c HUFF_EXTEND of the next s bits
    int receive_extend(int s) {
        if (s == 0) return 0;
        int v = get(s);
        if (v < (1 << (s - 1))) v += (int)((~0u) << s) + 1;
        return v;
    }
    long resume() const { return next_marker(data, size, pos); }
    // jdhuff.c / jdphuff.c process_restart for restart number `want`:
    // past the marker, the out-of-data flag cleared, unless the marker
    // stays unread
    void restart(int want) {
        bool pending;
        pos = resync(data, size, resume(), want, &pending);
        insufficient = pending && out_of_data();
        buf = 0;
        count = fed = 0;
        at_marker = pending && pos < size;
    }
};

// jaricom.c jpeg_aritab (ITU T.81 Table D.2): Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS, and entry 113 the fixed 0.5
// estimate of T.851
#define V(qe, lps, mps, sw) \
    (((int64_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// jdarith.c's arithmetic decoder: reads to a marker, then zeros (legal in
// arithmetic coding); ct == -1 marks a damaged segment, whose remaining
// MCUs are left alone until the next restart.  A read at the end of the
// file sets `eof`: jdarith.c cannot wait for more (JERR_CANT_SUSPEND).
struct ArithReader {
    const uint8_t* data;
    long size;
    long pos;
    long marker = -1;  // the marker the decoder ran into, or -1
    bool eof = false;
    int64_t c = 0, a = 0;
    int ct = -16;  // force reading 2 initial bytes to fill C

    int byte() {
        if (marker >= 0) return 0;
        if (pos >= size) {
            eof = true;
            marker = size;
            return 0;
        }
        int d = data[pos++];
        if (d != 0xFF) return d;
        while (pos < size && data[pos] == 0xFF) ++pos;
        if (pos >= size) {
            eof = true;
            marker = size;
            return 0;
        }
        if (data[pos] == 0x00) {
            ++pos;
            return 0xFF;  // stuffed zero
        }
        marker = pos - 1;
        return 0;
    }
    // jdarith.c arith_decode: one decision in the statistics bin *st
    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                c = (c << 8) | byte();
                if ((ct += 8) < 0)
                    if (++ct == 0) a = 0x8000;  // got 2 initial bytes
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = kAriTab[sv & 0x7F];
        int nl = (int)(qe & 0xFF);
        qe >>= 8;
        int nm = (int)(qe & 0xFF);
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
    long resume() const {
        return marker >= 0 ? marker : next_marker(data, size, pos);
    }
    // jdarith.c process_restart for restart number `want`, with the
    // statistics reset by the caller
    void restart(int want) {
        bool pending;
        pos = resync(data, size, resume(), want, &pending);
        eof |= pos >= size;
        marker = pending ? pos : -1;
        c = a = 0;
        ct = -16;
    }
};

struct Component {
    int id, h, v, tq;
    int quant[64];        // natural order, latched at the first scan
    bool latched = false;
    int bw = 0, bh = 0;   // blocks allocated (whole MCUs)
    int dw = 0, dh = 0;   // downsampled size in samples
    int coef_bits[64];    // progressive: the Al each coefficient is at
    int prev_bits[10];    // coef_bits 1..9 before the component's last scan
    std::vector<int16_t> coef;
    std::vector<uint8_t> samples;  // lossless: dh rows of dw samples
};

enum Color { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

// One scan's parameters and the MCU loop's state.
struct Scan {
    int ns = 0;
    int idx[4], td[4], ta[4];
    int ss = 0, se = 63, ah = 0, al = 0;
    int pred[4] = {0, 0, 0, 0};
    int dc_context[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    int next_rst = 0;  // the restart number due next
};

struct Decoder {
    const uint8_t* data;
    long size;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int mcux = 0, mcuy = 0;
    int restart_interval = 0;
    int scans = 0;      // SOS segments so far (input_scan_number)
    int last_good = 0;  // jdcoefct.c last_good_iMCU_row
    bool frame = false, progressive = false, arithmetic = false;
    bool lossless = false;
    bool jfif = false, adobe = false, scanned = false, color_set = false;
    int adobe_transform = 0;
    Color color = kGray;
    int quant[4][64] = {};
    bool quant_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    uint8_t dc_l[16], dc_u[16], ac_k[16];  // arithmetic conditioning
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin[1] = {113};
    Component comp[4];

    Decoder(const uint8_t* d, long n) : data(d), size(n) {
        for (int t = 0; t < 16; ++t) {  // jdmarker.c get_soi's defaults
            dc_l[t] = 0;
            dc_u[t] = 1;
            ac_k[t] = 5;
        }
    }

    int u16(long p) const { return (data[p] << 8) | data[p + 1]; }

    // The table segments are read as jdmarker.c reads them, from their
    // stated end, which may lie past the file's (kTruncated when a read
    // gets there first).
    // get_dqt: any precision but 0 is 16-bit
    int parse_dqt(long p, long end) {
        while (p < end) {
            if (p >= size) return kTruncated;
            int pq = data[p] >> 4 ? 1 : 0, tq = data[p] & 15;
            ++p;
            if (tq > 3) return kMalformed;
            if (p + 64 * (pq + 1) > size) return kTruncated;
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

    // get_dht: a table whose codes do not fit is refused only by a scan
    // that uses it (jdhuff.c jpeg_make_d_derived_tbl)
    int parse_dht(long p, long end) {
        while (end - p > 16) {
            if (p + 17 > size) return kTruncated;
            int tc = data[p] >> 4, th = data[p] & 15;
            const uint8_t* bits = data + p + 1;
            int count = 0;
            for (int i = 0; i < 16; ++i) count += bits[i];
            if (count > 256 || p + 17 + count > end) return kMalformed;
            if (p + 17 + count > size) return kTruncated;
            if (tc > 1 || th > 3) return kMalformed;
            Huffman& h = tc ? ac[th] : dc[th];
            h.valid = h.build(bits, data + p + 17, count);
            p += 17 + count;
        }
        return p == end ? kOk : kMalformed;
    }

    // jdmarker.c get_dac
    int parse_dac(long p, long end) {
        if ((end - p) % 2) return kMalformed;
        for (; p < end; p += 2) {
            int index = data[p], val = data[p + 1];
            if (index >= 32) return kMalformed;
            if (index >= 16) {
                ac_k[index - 16] = (uint8_t)val;
            } else {
                dc_l[index] = (uint8_t)(val & 15);
                dc_u[index] = (uint8_t)(val >> 4);
                if (dc_l[index] > dc_u[index]) return kMalformed;
            }
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
        if (ncomp != 1 && ncomp != 3 && ncomp != 4) return kUnsupported;
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
            for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
        }
        if (ncomp == 1) {  // one component: its own sampling is the frame's
            hmax = comp[0].h;
            vmax = comp[0].v;
        }
        for (int c = 0; c < ncomp; ++c)  // jdsample.c: integral ratios only
            if (hmax % comp[c].h || vmax % comp[c].v) return kUnsupported;
        // an MCU's data unit: an 8x8 block, or one sample in lossless
        const int unit = lossless ? 1 : 8;
        mcux = (width + unit * hmax - 1) / (unit * hmax);
        mcuy = (height + unit * vmax - 1) / (unit * vmax);
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

    // jdapimin.c default_decompress_parms, at the first scan
    void settle_color() {
        color_set = true;
        int c0 = comp[0].id, c1 = comp[1].id, c2 = comp[2].id;
        if (ncomp == 1) {
            color = kGray;
        } else if (ncomp == 3) {
            if (jfif)
                color = kYCbCr;
            else if (adobe)
                color = adobe_transform == 0 ? kRGB : kYCbCr;
            else  // libjpeg-turbo >= 3.0 takes a lossless frame for RGB
                color = lossless || (c0 == 82 && c1 == 71 && c2 == 66)
                            ? kRGB
                            : kYCbCr;
        } else {
            color = adobe && adobe_transform != 0 ? kYCCK : kCMYK;
        }
    }

    // The markers from SOI: with `decode`, every scan is decoded to the
    // end of the file; without, it stops at the first scan (the header).
    int run(bool decode) {
        if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return kMalformed;
        long p = 2;
        // A single-scan sequential image is out once its scan is decoded;
        // PIL then takes a file that ends before its EOI.  Otherwise
        // libjpeg waits for the rest, and PIL reports the file truncated.
        bool out = false;
        for (;;) {
            // jdmarker.c next_marker: garbage, fill bytes and FF 00 skipped
            p = next_marker(data, size, p) + 1;
            if (p >= size) return out ? kOk : kMalformed;
            int marker = data[p++];
            if (marker == 0xD9) break;
            if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01)
                continue;  // RSTn, TEM: no segment
            // jdmarker.c read_markers: a second SOI, or a reserved marker
            if (marker == 0xD8 || marker < 0xC0 || marker == 0xDE ||
                marker == 0xDF || (marker >= 0xF0 && marker <= 0xFD))
                return kMalformed;
            if (p + 2 > size) return out ? kOk : kMalformed;
            int len = u16(p);
            if (len < 2) return kMalformed;
            long body = p + 2, end = p + len;
            p = end;
            int err = end > size && marker != 0xC4 && marker != 0xDB
                          ? kTruncated
                          : kOk;
            if (!err) switch (marker) {
                case 0xC0: case 0xC1:  // sequential Huffman
                    err = parse_sof(body, end);
                    break;
                case 0xC2:  // progressive Huffman
                    progressive = true;
                    err = parse_sof(body, end);
                    break;
                case 0xC9:  // sequential arithmetic
                    arithmetic = true;
                    err = parse_sof(body, end);
                    break;
                case 0xCA:  // progressive arithmetic
                    progressive = arithmetic = true;
                    err = parse_sof(body, end);
                    break;
                case 0xC3:  // lossless Huffman
                    lossless = true;
                    err = parse_sof(body, end);
                    break;
                case 0xC5: case 0xC6: case 0xC7: case 0xC8:
                case 0xCB: case 0xCD: case 0xCE: case 0xCF:
                    // hierarchical, JPG, lossless arithmetic
                    return kUnsupported;
                case 0xC4:
                    err = parse_dht(body, end);
                    break;
                case 0xCC:
                    err = parse_dac(body, end);
                    break;
                case 0xDB:
                    err = parse_dqt(body, end);
                    break;
                case 0xDD:
                    if (end - body < 2) return kMalformed;
                    restart_interval = u16(body);
                    break;
                case 0xE0:  // jdmarker.c examine_app0
                    if (end - body >= 14 &&
                        std::memcmp(data + body, "JFIF\0", 5) == 0)
                        jfif = true;
                    break;
                case 0xEE:  // jdmarker.c examine_app14
                    if (end - body >= 12 &&
                        std::memcmp(data + body, "Adobe", 5) == 0) {
                        adobe = true;
                        adobe_transform = data[body + 11];
                    }
                    break;
                case 0xDA:
                    // jdinput.c consume_markers: EOI expected after it
                    if (!frame || out) return kMalformed;
                    if (!color_set) settle_color();
                    // jdcolor.c converts no colour in lossless mode
                    if (lossless && (color == kYCbCr || color == kYCCK))
                        return kLosslessColor;
                    if (!decode) return kOk;
                    err = scan(body, end, &p);
                    out = !progressive && scans == 1 && data[body] == ncomp;
                    break;
                default:
                    break;
            }
            if (err == kTruncated) return out ? kOk : kMalformed;
            if (err) return err;
        }
        return decode && scanned ? kOk : kMalformed;
    }

    // ------------------------------------------------ Huffman MCU decoders

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

    // jdphuff.c decode_mcu_DC_first
    int dc_first(BitReader& br, Scan& sc, int16_t* blk, int slot) {
        int s = br.decode(dc[sc.td[slot]]);
        if (s) s = br.receive_extend(s);
        int64_t v = (int64_t)sc.pred[slot] + s;
        if (v > INT32_MAX || v < INT32_MIN) return kMalformed;
        sc.pred[slot] = (int)v;
        blk[0] = (int16_t)((uint32_t)v << sc.al);
        return kOk;
    }

    // jdphuff.c decode_mcu_AC_first
    void ac_first(BitReader& br, Scan& sc, int16_t* blk) {
        if (sc.eobrun > 0) {
            --sc.eobrun;
            return;
        }
        const Huffman& h = ac[sc.ta[0]];
        for (int k = sc.ss; k <= sc.se; ++k) {
            int rs = br.decode(h);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                int v = br.receive_extend(s);
                blk[kNatural[k]] = (int16_t)((uint32_t)v << sc.al);
            } else if (r == 15) {
                k += 15;
            } else {
                sc.eobrun = 1u << r;
                if (r) sc.eobrun += br.get(r);
                --sc.eobrun;
                break;
            }
        }
    }

    // jdphuff.c decode_mcu_AC_refine
    void ac_refine(BitReader& br, Scan& sc, int16_t* blk) {
        const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
        const Huffman& h = ac[sc.ta[0]];
        int k = sc.ss;
        auto correct = [&](int16_t& coef) {
            if (br.get(1) && (coef & p1) == 0)
                coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
        };
        if (sc.eobrun == 0) {
            for (; k <= sc.se; ++k) {
                int rs = br.decode(h);
                int r = rs >> 4, s = rs & 15;
                if (s) {  // a new coefficient of size 1 (other sizes: warned)
                    s = br.get(1) ? p1 : m1;
                } else if (r != 15) {
                    sc.eobrun = 1u << r;
                    if (r) sc.eobrun += br.get(r);
                    break;
                }
                do {
                    int16_t& coef = blk[kNatural[k]];
                    if (coef != 0) {
                        correct(coef);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= sc.se);
                if (s) blk[kNatural[k]] = (int16_t)s;
            }
        }
        if (sc.eobrun > 0) {
            for (; k <= sc.se; ++k) {
                int16_t& coef = blk[kNatural[k]];
                if (coef != 0) correct(coef);
            }
            --sc.eobrun;
        }
    }

    // --------------------------------------------- arithmetic MCU decoders

    // jdarith.c: a DC difference (Figures F.19, F.21-F.24) in table t,
    // with its conditioning category
    int arith_dc_diff(ArithReader& ar, Scan& sc, int slot, int t) {
        uint8_t* st = dc_stats[t] + sc.dc_context[slot];
        if (ar.decode(st) == 0) {
            sc.dc_context[slot] = 0;
            return 0;
        }
        int sign = ar.decode(st + 1);
        st += 2 + sign;
        int m = ar.decode(st);
        if (m != 0) {
            st = dc_stats[t] + 20;  // X1
            while (ar.decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ar.ct = -1;  // magnitude overflow
                    return 0;
                }
                st += 1;
            }
        }
        if (m < (int)((1L << dc_l[t]) >> 1))
            sc.dc_context[slot] = 0;
        else if (m > (int)((1L << dc_u[t]) >> 1))
            sc.dc_context[slot] = 12 + sign * 4;
        else
            sc.dc_context[slot] = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
            if (ar.decode(st)) v |= m;
        v += 1;
        return sign ? -v : v;
    }

    // jdarith.c: the AC coefficients of a band (Figure F.20); false on a
    // damaged segment
    bool arith_ac(ArithReader& ar, int16_t* blk, int t, int ss, int se,
                  int al) {
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = ac_stats[t] + 3 * (k - 1);
            if (ar.decode(st)) break;  // EOB
            while (ar.decode(st + 1) == 0) {
                st += 3;
                if (++k > se) {
                    ar.ct = -1;  // spectral overflow
                    return false;
                }
            }
            int sign = ar.decode(fixed_bin);
            st += 2;
            int m = ar.decode(st);
            if (m != 0 && ar.decode(st)) {
                m <<= 1;
                st = ac_stats[t] + (k <= ac_k[t] ? 189 : 217);
                while (ar.decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        ar.ct = -1;  // magnitude overflow
                        return false;
                    }
                    st += 1;
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1)
                if (ar.decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            blk[kNatural[k]] = (int16_t)((uint32_t)v << al);
        }
        return true;
    }

    // jdarith.c decode_mcu_AC_refine
    void arith_ac_refine(ArithReader& ar, Scan& sc, int16_t* blk) {
        const int t = sc.ta[0];
        const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
        int kex = sc.se;
        for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
        for (int k = sc.ss; k <= sc.se; ++k) {
            uint8_t* st = ac_stats[t] + 3 * (k - 1);
            if (k > kex && ar.decode(st)) break;  // EOB
            for (;;) {
                int16_t& coef = blk[kNatural[k]];
                if (coef) {  // previously nonzero: a correction bit
                    if (ar.decode(st + 2))
                        coef = (int16_t)(coef < 0 ? coef + m1 : coef + p1);
                    break;
                }
                if (ar.decode(st + 1)) {  // newly nonzero
                    coef = (int16_t)(ar.decode(fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > sc.se) {
                    ar.ct = -1;  // spectral overflow
                    return;
                }
            }
        }
    }

    // jdarith.c start_pass / process_restart: fresh statistics for the
    // scan's tables
    void arith_reset(Scan& sc) {
        for (int i = 0; i < sc.ns; ++i) {
            if (!progressive || (sc.ss == 0 && sc.ah == 0)) {
                std::memset(dc_stats[sc.td[i]], 0, 64);
                sc.pred[i] = 0;
                sc.dc_context[i] = 0;
            }
            if (!progressive || sc.ss)
                std::memset(ac_stats[sc.ta[i]], 0, 256);
        }
    }

    // ----------------------------------------------------------- one scan

    // jdphuff.c start_pass_phuff_decoder (and jdarith.c start_pass): a
    // bad script is damaged; the progression's status per coefficient
    // (with jdphuff.c's prev_coef_bits, libjpeg-turbo >= 2.1)
    bool start_progressive(Scan& sc) {
        bool bad;
        if (sc.ss == 0)
            bad = sc.se != 0;
        else
            bad = sc.ss > sc.se || sc.se > 63 || sc.ns != 1;
        if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
        if (sc.al > 13) bad = true;
        if (bad) return false;
        for (int i = 0; i < sc.ns; ++i) {
            Component& k = comp[sc.idx[i]];
            for (int j = 1; j <= 9; ++j)
                k.prev_bits[j] = scans > 1 ? k.coef_bits[j] : 0;
            for (int j = sc.ss; j <= sc.se; ++j) k.coef_bits[j] = sc.al;
        }
        return true;
    }

    // The SOS body at [p, end), entropy data from end.
    int scan(long p, long end, long* resume) {
        Scan sc;
        sc.ns = data[p];
        if (sc.ns < 1 || sc.ns > 4 || sc.ns > ncomp ||
            end - p < 1 + 2 * sc.ns + 3)
            return kMalformed;
        for (int i = 0; i < sc.ns; ++i) {
            // jdmarker.c get_sos takes the first frame component c with
            // the id whose slot cur_comp_info[c] is still empty: the scan
            // fills slots 0..i-1 before its component i, so c >= i, and a
            // scan listing components out of the frame's order is refused
            int cid = data[p + 1 + 2 * i];
            sc.idx[i] = -1;
            for (int c = i; c < ncomp && sc.idx[i] < 0; ++c)
                if (comp[c].id == cid) sc.idx[i] = c;
            if (sc.idx[i] < 0) return kMalformed;
            sc.td[i] = data[p + 2 + 2 * i] >> 4;
            sc.ta[i] = data[p + 2 + 2 * i] & 15;
        }
        long q = p + 1 + 2 * sc.ns;
        sc.ss = data[q];
        sc.se = data[q + 1];
        sc.ah = data[q + 2] >> 4;
        sc.al = data[q + 2] & 15;
        ++scans;
        if (lossless) return lossless_scan(sc, end, resume);
        if (progressive && !start_progressive(sc)) return kMalformed;
        const bool dc_scan = !progressive || sc.ss == 0;
        const bool ac_scan = !progressive || sc.ss > 0;
        if (!arithmetic) {  // the Huffman tables the scan decodes with
            for (int i = 0; i < sc.ns; ++i) {
                if (dc_scan && sc.ah == 0 &&
                    (sc.td[i] > 3 || !dc[sc.td[i]].valid ||
                     !dc[sc.td[i]].dc_ok))
                    return kMalformed;
                if (ac_scan && (sc.ta[i] > 3 || !ac[sc.ta[i]].valid))
                    return kMalformed;
            }
        }
        int blocks_in_mcu = 0;
        for (int i = 0; i < sc.ns; ++i) {
            Component& k = comp[sc.idx[i]];
            if (!k.latched) {  // jdinput.c latch_quant_tables
                if (!quant_defined[k.tq]) return kMalformed;
                std::memcpy(k.quant, quant[k.tq], sizeof(k.quant));
                k.latched = true;
            }
            if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
            blocks_in_mcu += k.h * k.v;
        }
        if (sc.ns > 1 && blocks_in_mcu > kMaxBlocksInMcu) return kMalformed;
        int cols, rows;
        if (sc.ns == 1) {  // non-interleaved: one block an MCU, in raster order
            Component& k = comp[sc.idx[0]];
            cols = (k.dw + 7) / 8;
            rows = (k.dh + 7) / 8;
        } else {
            cols = mcux;
            rows = mcuy;
        }
        BitReader br{data, size, end};
        ArithReader ar{data, size, end};
        if (arithmetic) arith_reset(sc);
        int16_t* blk[kMaxBlocksInMcu];
        int slot[kMaxBlocksInMcu];
        const long total = (long)cols * rows;
        // block rows an iMCU row: one MCU row interleaved, v alone
        const int imcu_rows = sc.ns == 1 ? comp[sc.idx[0]].v : 1;
        int to_go = restart_interval;
        for (long m = 0; m < total; ++m) {
            int mx = (int)(m % cols), my = (int)(m / cols), n = 0;
            // jdcoefct.c consume_data, before each MCU (jdarith.c never
            // runs out of data)
            if (progressive && (arithmetic || !br.out_of_data()))
                last_good = my / imcu_rows;
            if (restart_interval) {
                if (to_go == 0) {
                    if (arithmetic) {
                        ar.restart(sc.next_rst);
                        arith_reset(sc);
                    } else {
                        br.restart(sc.next_rst);
                        for (int i = 0; i < sc.ns; ++i) sc.pred[i] = 0;
                        sc.eobrun = 0;
                    }
                    sc.next_rst = (sc.next_rst + 1) & 7;
                    to_go = restart_interval;
                }
                --to_go;
            }
            for (int i = 0; i < sc.ns; ++i) {
                Component& k = comp[sc.idx[i]];
                int nh = sc.ns == 1 ? 1 : k.h, nv = sc.ns == 1 ? 1 : k.v;
                for (int y = 0; y < nv; ++y)
                    for (int x = 0; x < nh; ++x) {
                        int bx = mx * nh + x, by = my * nv + y;
                        blk[n] = k.coef.data() + ((size_t)by * k.bw + bx) * 64;
                        slot[n++] = i;
                    }
            }
            int err = arithmetic    ? arith_mcu(ar, sc, blk, slot, n)
                      : progressive ? huffman_mcu(br, sc, blk, slot, n)
                                    : sequential_mcu(br, sc, blk, slot, n);
            if (err) return err;
        }
        if (br.eof || ar.eof) return kMalformed;  // PIL: truncated
        *resume = arithmetic ? ar.resume() : br.resume();
        scanned = true;
        return kOk;
    }

    // ------------------------------------------- lossless (SOF3) scans

    // The rows of a component in its last iMCU row (last_row_height).
    static int last_rows(const Component& k) {
        return k.dh % k.v ? k.dh % k.v : k.v;
    }

    // A lossless scan (jdlhuff.c decode_mcus, jddiffct.c decompress_data,
    // jdlossls.c): the differences of one iMCU row are decoded MCU row by
    // MCU row, then each component's rows are undifferenced and scaled by
    // the point transform into its samples.  A restart, or an MCU row met
    // out of data (whose differences are zeros), resets the predictor of
    // the next row undifferenced, the iMCU row's first: libjpeg
    // undifferences after decoding the whole iMCU row.
    int lossless_scan(Scan& sc, long end, long* resume) {
        // jdlossls.c start_pass_lossless
        if (sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah != 0 || sc.al >= 8)
            return kMalformed;
        const bool interleaved = sc.ns > 1;
        int blocks_in_mcu = 0, nh[4], nv[4];
        for (int i = 0; i < sc.ns; ++i) {
            if (sc.td[i] > 3 || !dc[sc.td[i]].valid ||
                !dc[sc.td[i]].lossless_ok)
                return kMalformed;
            const Component& k = comp[sc.idx[i]];
            nh[i] = interleaved ? k.h : 1;
            nv[i] = interleaved ? k.v : 1;
            blocks_in_mcu += k.h * k.v;
        }
        if (interleaved && blocks_in_mcu > kMaxBlocksInMcu) return kMalformed;
        const int per_row = interleaved ? mcux : comp[sc.idx[0]].dw;
        // jddiffct.c start_input_pass: restarts at whole MCU rows only
        if (restart_interval % per_row) return kMalformed;
        const int restart_rows = restart_interval / per_row;
        std::vector<int> diff[4], prev[4], cur[4];
        for (int i = 0; i < sc.ns; ++i) {
            Component& k = comp[sc.idx[i]];
            diff[i].assign((size_t)k.v * per_row * nh[i], 0);
            prev[i].assign(k.dw, 0);
            cur[i].assign(k.dw, 0);
            if (k.samples.empty()) k.samples.assign((size_t)k.dw * k.dh, 0);
        }
        const int imcu_rows = (height + vmax - 1) / vmax;
        const int initial = 1 << (8 - sc.al - 1);
        BitReader br{data, size, end};
        bool first = true;
        int to_go = restart_rows;
        for (int r = 0; r < imcu_rows; ++r) {
            const bool last = r == imcu_rows - 1;
            const Component& k0 = comp[sc.idx[0]];
            const int mcu_rows =
                interleaved ? 1 : (last ? last_rows(k0) : k0.v);
            for (int y = 0; y < mcu_rows; ++y) {
                if (restart_interval) {
                    if (to_go == 0) {
                        br.restart(sc.next_rst);
                        sc.next_rst = (sc.next_rst + 1) & 7;
                        first = true;
                        to_go = restart_rows;
                    }
                    --to_go;
                }
                if (br.out_of_data()) {  // zeros, the predictor reset
                    for (int i = 0; i < sc.ns; ++i) {
                        const size_t w = (size_t)per_row * nh[i];
                        std::fill(diff[i].begin() + y * w,
                                  diff[i].begin() + (y + nv[i]) * w, 0);
                    }
                    first = true;
                    continue;
                }
                for (int m = 0; m < per_row; ++m)
                    for (int i = 0; i < sc.ns; ++i) {
                        const Huffman& h = dc[sc.td[i]];
                        const size_t w = (size_t)per_row * nh[i];
                        int* d = diff[i].data() + y * w + (size_t)m * nh[i];
                        for (int yy = 0; yy < nv[i]; ++yy)
                            for (int xx = 0; xx < nh[i]; ++xx) {
                                const int s = br.decode(h);
                                d[yy * w + xx] =
                                    s == 16 ? 32768 : br.receive_extend(s);
                            }
                    }
            }
            for (int i = 0; i < sc.ns; ++i) {
                Component& k = comp[sc.idx[i]];
                const size_t w = (size_t)per_row * nh[i];
                const int rows = last ? last_rows(k) : k.v;
                for (int y = 0; y < rows; ++y) {
                    undifference(diff[i].data() + y * w, prev[i].data(),
                                 cur[i].data(), k.dw, sc.ss, first && y == 0,
                                 initial);
                    uint8_t* o =
                        k.samples.data() + (size_t)(r * k.v + y) * k.dw;
                    for (int x = 0; x < k.dw; ++x)
                        o[x] = (uint8_t)(cur[i][x] << sc.al);
                    std::swap(prev[i], cur[i]);
                }
            }
            first = false;
        }
        if (br.eof) return kMalformed;  // PIL: truncated
        *resume = br.resume();
        scanned = true;
        return kOk;
    }

    // jdlossls.c's undifferencers: one row from its differences and the
    // row above by predictor psv (Table H.1), the first sample from the one
    // above; or a first row, each sample from the one before it and the
    // first from `initial`.  Values wrap to 16 bits.
    static void undifference(const int* diff, const int* above, int* row,
                             int width, int psv, bool first, int initial) {
        if (first) {
            int ra = (diff[0] + initial) & 0xFFFF;
            row[0] = ra;
            for (int x = 1; x < width; ++x)
                row[x] = ra = (diff[x] + ra) & 0xFFFF;
            return;
        }
        int rb = above[0], ra = (diff[0] + rb) & 0xFFFF;
        row[0] = ra;
        for (int x = 1; x < width; ++x) {
            const int rc = rb;
            rb = above[x];
            int p;
            switch (psv) {
                case 1: p = ra; break;
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
            }
            row[x] = ra = (diff[x] + p) & 0xFFFF;
        }
    }

    // jdhuff.c decode_mcu
    int sequential_mcu(BitReader& br, Scan& sc, int16_t** blk, int* slot,
                       int n) {
        if (br.out_of_data()) return kOk;  // MCU left alone
        for (int b = 0; b < n; ++b) {
            const int i = slot[b];
            int err = decode_block(br, blk[b], sc.pred[i], dc[sc.td[i]],
                                   ac[sc.ta[i]]);
            if (err) return err;
        }
        return kOk;
    }

    // jdphuff.c's decode_mcu_* by the scan's kind
    int huffman_mcu(BitReader& br, Scan& sc, int16_t** blk, int* slot,
                    int n) {
        if (sc.ss == 0 && sc.ah != 0) {  // DC refinement
            for (int b = 0; b < n; ++b)
                if (br.get(1)) blk[b][0] |= (int16_t)(1 << sc.al);
            return kOk;
        }
        if (br.out_of_data()) return kOk;  // MCU left alone
        for (int b = 0; b < n; ++b) {
            int err = kOk;
            if (sc.ss == 0)
                err = dc_first(br, sc, blk[b], slot[b]);
            else if (sc.ah == 0)
                ac_first(br, sc, blk[b]);
            else
                ac_refine(br, sc, blk[b]);
            if (err) return err;
        }
        return kOk;
    }

    int arith_mcu(ArithReader& ar, Scan& sc, int16_t** blk, int* slot,
                  int n) {
        if (progressive && sc.ss == 0 && sc.ah != 0) {  // DC refinement
            for (int b = 0; b < n; ++b)
                if (ar.decode(fixed_bin)) blk[b][0] |= (int16_t)(1 << sc.al);
            return kOk;
        }
        if (ar.ct == -1) return kOk;  // damaged segment: MCU left alone
        for (int b = 0; b < n; ++b) {
            int i = slot[b];
            if (!progressive || sc.ss == 0) {
                int diff = arith_dc_diff(ar, sc, i, sc.td[i]);
                if (ar.ct == -1) return kOk;
                sc.pred[i] = (sc.pred[i] + diff) & 0xFFFF;
                blk[b][0] = (int16_t)((uint32_t)sc.pred[i] << sc.al);
                if (!progressive &&
                    !arith_ac(ar, blk[b], sc.ta[i], 1, 63, 0))
                    return kOk;
            } else if (sc.ah == 0) {
                if (!arith_ac(ar, blk[b], sc.ta[i], sc.ss, sc.se, sc.al))
                    return kOk;
            } else {
                arith_ac_refine(ar, sc, blk[b]);
            }
        }
        return kOk;
    }

    // jdcoefct.c smoothing_ok (libjpeg-turbo >= 2.1): whether libjpeg
    // smooths the blocks of this progressive file
    bool smoothing_needed() const {
        if (!progressive) return false;
        bool useful = false;
        for (int c = 0; c < ncomp; ++c) {
            const Component& k = comp[c];
            if (!k.latched) return false;
            for (int i = 0; i <= 9; ++i)
                if (k.quant[kNatural[i]] == 0) return false;
            if (k.coef_bits[0] < 0) return false;
            for (int i = 1; i <= 9; ++i)
                if (k.coef_bits[i] != 0) useful = true;
        }
        return useful;
    }
};

// jidctint.c jpeg_idct_islow as libjpeg-turbo's x86 SIMD code
// (jidctint-avx2.asm, jidctint-sse2.asm) computes it, which is what PIL
// runs there: the same arithmetic on 16-bit lanes.  The dequantised
// coefficients and the sums in0 +- in4, in7 + in3 and in5 + in1 wrap to
// 16 bits; products and their sums are 32-bit and wrap; each pass's
// outputs saturate to 16 bits and the samples to 0..255, where
// jidctint.c's range-limit table wraps.  A block whose rows 1..7 are all
// zero takes the first pass's shortcut, whose shift wraps to 16 bits.
// On the coefficients of a valid file this is jidctint.c's result; a
// damaged file's can overflow, and then PIL's pixels are these.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int32_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t add32(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
inline int32_t sub32(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
inline int32_t sat16(int32_t x) {
    return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}
inline uint8_t sample(int32_t x) {
    return (uint8_t)((x < -128 ? -128 : (x > 127 ? 127 : x)) + 128);
}

// One 8-point pass: the 16-bit values in[0], in[s], ... in[7s] to
// out[0], out[os], ..., descaled by n bits and saturated to 16 bits.
// The constants are jidctint.c's FIX_* folded as the SIMD code folds them.
inline void idct_pass(const int32_t* in, int s, int32_t* out, int os,
                      int n) {
    const int32_t i0 = in[0], i1 = in[s], i2 = in[2 * s], i3 = in[3 * s];
    const int32_t i4 = in[4 * s], i5 = in[5 * s], i6 = in[6 * s];
    const int32_t i7 = in[7 * s];
    const int32_t tmp3 = i2 * 10703 + i6 * 4433;
    const int32_t tmp2 = i2 * 4433 + i6 * -10704;
    const int32_t tmp0 = wrap16(i0 + i4) * (1 << kConstBits);
    const int32_t tmp1 = wrap16(i0 - i4) * (1 << kConstBits);
    const int32_t r = 1 << (n - 1);
    const int32_t t10 = add32(add32(tmp0, tmp3), r);
    const int32_t t13 = add32(sub32(tmp0, tmp3), r);
    const int32_t t11 = add32(add32(tmp1, tmp2), r);
    const int32_t t12 = add32(sub32(tmp1, tmp2), r);
    const int32_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
    const int32_t z3p = z3 * -6436 + z4 * 9633;
    const int32_t z4p = z3 * 9633 + z4 * 6437;
    const int32_t o0 = add32(i7 * -4927 + i1 * -7373, z3p);
    const int32_t o3 = add32(i7 * -7373 + i1 * 4926, z4p);
    const int32_t o1 = add32(i5 * -4176 + i3 * -20995, z4p);
    const int32_t o2 = add32(i5 * -20995 + i3 * 4177, z3p);
    out[0] = sat16(add32(t10, o3) >> n);
    out[7 * os] = sat16(sub32(t10, o3) >> n);
    out[os] = sat16(add32(t11, o2) >> n);
    out[6 * os] = sat16(sub32(t11, o2) >> n);
    out[2 * os] = sat16(add32(t12, o1) >> n);
    out[5 * os] = sat16(sub32(t12, o1) >> n);
    out[3 * os] = sat16(add32(t13, o0) >> n);
    out[4 * os] = sat16(sub32(t13, o0) >> n);
}

void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
    int32_t deq[64], ws[64], row[8];
    int32_t ac_rows = 0;
    for (int i = 0; i < 64; ++i) deq[i] = wrap16(in[i] * q[i]);
    for (int i = 8; i < 64; ++i) ac_rows |= in[i];
    if (!ac_rows) {  // the SIMD code's shortcut, its shift wrapping
        for (int c = 0; c < 8; ++c) {
            const int32_t dc = wrap16(deq[c] * (1 << kPass1Bits));
            for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
        }
    } else {
        for (int c = 0; c < 8; ++c) {
            const int32_t* v = deq + c;
            if (v[8] | v[16] | v[24] | v[32] | v[40] | v[48] | v[56]) {
                idct_pass(v, 8, ws + c, 8, kConstBits - kPass1Bits);
            } else {  // what the pass gives a column of its DC alone
                const int32_t dc = sat16(v[0] * (1 << kPass1Bits));
                for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
            }
        }
    }
    for (int r = 0; r < 8; ++r) {
        const int32_t* w = ws + r * 8;
        uint8_t* o = out + (size_t)r * stride;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
            // what the pass gives a row of its DC alone
            std::memset(o, sample((w[0] + 16) >> 5), 8);
            continue;
        }
        idct_pass(w, 1, row, 1, kConstBits + kPass1Bits + 3);
        for (int c = 0; c < 8; ++c) o[c] = sample(row[c]);
    }
}

// decompress_smooth_data's estimate of a coefficient with quantiser q from
// a weighted DC sum num, clamped below 2^al (the bits still unknown)
int16_t smooth_estimate(int64_t q, int64_t num, int al) {
    const bool neg = num < 0;
    int pred = (int)(((q << 7) + (neg ? -num : num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return (int16_t)(neg ? -pred : pred);
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo >= 2.1): the IDCT of
// each of a component's blocks in the image after its coefficients 1..9
// that are still zero and not known exact (coef_bits) are estimated from
// the DC values of the 5x5 blocks around it, and, where none of those AC
// coefficients was coded at all, its DC too.  The rows around a block are
// libjpeg's: it walks `total` iMCU rows and repeats edge rows by its own
// count of them.
void smooth_idct(const Component& k, int total, int last_good, bool first,
                 uint8_t* plane) {
    // iMCU rows past the last one decoded whole take the progression as
    // it was before the component's last scan (-1s after a file's first)
    int prev[10];
    for (int i = 1; i <= 9; ++i) prev[i] = first ? -1 : k.prev_bits[i];
    const int* qv = k.quant;
    const int64_t q00 = qv[0];
    const int wib = (k.dw + 7) / 8, hib = (k.dh + 7) / 8, last = wib - 1;
    const int stride = k.bw * 8;
    auto dc_at = [&](int row, int col) {
        return (int)k.coef[((size_t)row * k.bw + col) * 64];
    };
    for (int r = 0; r < total; ++r) {
        const int* cb = r > last_good ? prev : k.coef_bits;
        bool change_dc = true;
        for (int i = 1; i <= 9; ++i)
            if (cb[i] != -1) change_dc = false;
        int block_rows = k.v;
        if (r == total - 1) {
            block_rows = hib % k.v;
            if (block_rows == 0) block_rows = k.v;
        }
        const int image_block_rows = block_rows * total;
        for (int b = 0; b < block_rows; ++b) {
            const int ibr = r * block_rows + b, row = r * k.v + b;
            int rows[5];
            rows[2] = row;
            rows[1] = ibr > 0 ? row - 1 : row;
            rows[0] = ibr > 1 ? row - 2 : rows[1];
            rows[3] = ibr < image_block_rows - 1 ? row + 1 : row;
            rows[4] = ibr < image_block_rows - 2 ? row + 2 : rows[3];
            for (int col = 0; col <= last; ++col) {
                // DC01..DC25: rows[0..4] by columns col - 2 .. col + 2,
                // the edge columns repeated
                int d[26];
                for (int i = 0; i < 25; ++i) {
                    int cc = col + i % 5 - 2;
                    cc = cc < 0 ? 0 : (cc > last ? last : cc);
                    d[i + 1] = dc_at(rows[i / 5], cc);
                }
                int16_t ws[64];
                std::memcpy(ws, k.coef.data() + ((size_t)row * k.bw + col) * 64,
                            sizeof(ws));
                // (coefficient index, natural position, weighted DC sum)
                auto apply = [&](int i, int pos, int64_t sum) {
                    if (cb[i] != 0 && ws[pos] == 0)
                        ws[pos] = smooth_estimate(qv[pos], q00 * sum, cb[i]);
                };
                if (change_dc) {
                    apply(1, 1, -d[1] - d[2] + d[4] + d[5] - 3 * d[6] +
                                    13 * d[7] - 13 * d[9] + 3 * d[10] -
                                    3 * d[11] + 38 * d[12] - 38 * d[14] +
                                    3 * d[15] - 3 * d[16] + 13 * d[17] -
                                    13 * d[19] + 3 * d[20] - d[21] - d[22] +
                                    d[24] + d[25]);
                    apply(2, 8, -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] -
                                    d[5] - d[6] + 13 * d[7] + 38 * d[8] +
                                    13 * d[9] - d[10] + d[16] - 13 * d[17] -
                                    38 * d[18] - 13 * d[19] + d[20] + d[21] +
                                    3 * d[22] + 3 * d[23] + 3 * d[24] + d[25]);
                    apply(3, 16, d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] -
                                     5 * d[12] - 14 * d[13] - 5 * d[14] +
                                     2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]);
                    apply(4, 9, -d[1] + d[5] + 9 * d[7] - 9 * d[9] -
                                    9 * d[17] + 9 * d[19] + d[21] - d[25]);
                    apply(5, 2, 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] +
                                    7 * d[12] - 14 * d[13] + 7 * d[14] +
                                    d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]);
                    apply(6, 3, d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] -
                                    d[19]);
                    apply(7, 10, d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] -
                                     d[19]);
                    apply(8, 17, d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] -
                                     d[19]);
                    apply(9, 24, d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] -
                                     d[19]);
                    ws[0] = smooth_estimate(
                        q00,
                        q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] -
                               2 * d[5] - 6 * d[6] + 6 * d[7] + 42 * d[8] +
                               6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] +
                               152 * d[13] + 42 * d[14] - 8 * d[15] -
                               6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
                               6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] -
                               6 * d[24] - 2 * d[25]),
                        0);
                } else {
                    apply(1, 1, -7 * d[11] + 50 * d[12] - 50 * d[14] +
                                    7 * d[15]);
                    apply(2, 8, -7 * d[3] + 50 * d[8] - 50 * d[18] +
                                    7 * d[23]);
                    apply(3, 16, -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] -
                                     d[23]);
                    apply(4, 9, d[10] + d[16] - 10 * d[17] + 10 * d[19] -
                                    d[2] - d[20] + d[22] - d[24] + d[4] -
                                    d[6] + 10 * d[7] - 10 * d[9]);
                    apply(5, 2, -d[11] + 13 * d[12] - 24 * d[13] +
                                    13 * d[14] - d[15]);
                }
                idct_islow(ws, qv, plane + (size_t)row * 8 * stride + col * 8,
                           stride);
            }
        }
    }
}

// A component's samples (rows `stride` apart) upsampled to one row of the
// output width, by the method jdsample.c jinit_upsampler picks: `row` is
// the output row, `out` width samples.  A lossless frame is never
// upsampled fancily (its DCT scaled size is 1, jdsample.c's do_fancy).
void upsample_row(const Component& k, const uint8_t* plane, int stride,
                  bool fancy_ok, int hmax, int vmax, int row, int width,
                  uint8_t* out) {
    const int rh = hmax / k.h, rv = vmax / k.v;
    if (rh == 1 && rv == 1) {
        std::memcpy(out, plane + (size_t)row * stride, width);
        return;
    }
    // the row above (even output rows) or below (odd ones) the nearer
    // input row, repeated at the edges (jdmainct.c)
    auto other_row = [&](int r) {
        int r1 = (row & 1) ? r + 1 : r - 1;
        return r1 < 0 ? 0 : (r1 > k.dh - 1 ? k.dh - 1 : r1);
    };
    if (rh == 1 && rv == 2 && fancy_ok) {  // h1v2_fancy_upsample
        const int r = row >> 1, bias = (row & 1) ? 2 : 1;
        const uint8_t* in0 = plane + (size_t)r * stride;
        const uint8_t* in1 = plane + (size_t)other_row(r) * stride;
        for (int x = 0; x < width; ++x)
            out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
        return;
    }
    const bool fancy =
        fancy_ok && (rh == 2 && (rv == 1 || rv == 2)) && k.dw > 2;
    if (!fancy) {  // h2v1_upsample, h2v2_upsample, int_upsample
        const uint8_t* in = plane + (size_t)(row / rv) * stride;
        for (int x = 0; x < width; ++x) out[x] = in[x / rh];
        return;
    }
    if (rv == 1) {  // h2v1_fancy_upsample
        const uint8_t* in = plane + (size_t)row * stride;
        for (int x = 0; x < width; ++x) {
            int j = x >> 1;
            if (x & 1) {
                out[x] = j == k.dw - 1 ? in[j]
                                       : (uint8_t)((in[j] * 3 + in[j + 1] + 2) >> 2);
            } else {
                out[x] = j == 0 ? in[0]
                                : (uint8_t)((in[j] * 3 + in[j - 1] + 1) >> 2);
            }
        }
        return;
    }
    // h2v2_fancy_upsample
    const int r = row >> 1;
    const uint8_t* in0 = plane + (size_t)r * stride;
    const uint8_t* in1 = plane + (size_t)other_row(r) * stride;
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
    int err = d.run(false);
    if (err) return err;
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.ncomp;
    return kOk;
}

// Decodes into out (height * width * channels bytes, row-major).
int jpeg_decode(const uint8_t* data, long size, uint8_t* out, long out_size) {
    Decoder d{data, size};
    int err = d.run(true);
    if (err) return err;
    const bool smooth = d.smoothing_needed();
    const int H = d.height, W = d.width, n = d.ncomp;
    if (out_size != (long)H * W * n) return kMalformed;
    std::vector<uint8_t> planes[4];
    const uint8_t* plane[4];
    int stride[4];
    for (int c = 0; c < n; ++c) {
        Component& k = d.comp[c];
        if (d.lossless) {
            // a component no scan wrote: libjpeg's whole-image buffer is
            // not zeroed, and reading it is an error (jmemmgr.c
            // access_virt_sarray)
            if (k.samples.empty()) return kMalformed;
            plane[c] = k.samples.data();
            stride[c] = k.dw;
            continue;
        }
        if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
        if (!k.latched) {
            std::memcpy(k.quant, d.quant[k.tq], sizeof(k.quant));
        }
        const int stride_c = k.bw * 8;
        planes[c].assign((size_t)stride_c * k.bh * 8, 0);
        for (int by = 0; by < k.bh; ++by)
            for (int bx = 0; bx < k.bw; ++bx)
                idct_islow(
                    k.coef.data() + ((size_t)by * k.bw + bx) * 64, k.quant,
                    planes[c].data() + (size_t)by * 8 * stride_c + bx * 8,
                    stride_c);
        if (smooth)  // the image's blocks again; the padding keeps the above
            smooth_idct(k, d.mcuy, d.last_good, d.scans == 1,
                        planes[c].data());
        plane[c] = planes[c].data();
        stride[c] = stride_c;
    }
    if (n == 1) {
        for (int y = 0; y < H; ++y)
            upsample_row(d.comp[0], plane[0], stride[0], !d.lossless, d.hmax,
                         d.vmax, y, W, out + (size_t)y * W);
        return kOk;
    }
    // jdcolor.c build_ycc_rgb_table (ycc_rgb_convert, ycck_cmyk_convert)
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
    std::vector<uint8_t> rows((size_t)n * W);
    for (int y = 0; y < H; ++y) {
        for (int c = 0; c < n; ++c)
            upsample_row(d.comp[c], plane[c], stride[c], !d.lossless, d.hmax,
                         d.vmax, y, W, rows.data() + (size_t)c * W);
        const uint8_t* c0 = rows.data();
        const uint8_t* c1 = c0 + W;
        const uint8_t* c2 = c1 + W;
        const uint8_t* c3 = c2 + W;
        uint8_t* o = out + (size_t)y * W * n;
        switch (d.color) {
            case kYCbCr:
                for (int x = 0; x < W; ++x) {
                    int yy = c0[x], cb = c1[x], cr = c2[x];
                    o[3 * x] = clamp255(yy + cr_r[cr]);
                    o[3 * x + 1] =
                        clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
                    o[3 * x + 2] = clamp255(yy + cb_b[cb]);
                }
                break;
            case kRGB:
                for (int x = 0; x < W; ++x) {
                    o[3 * x] = c0[x];
                    o[3 * x + 1] = c1[x];
                    o[3 * x + 2] = c2[x];
                }
                break;
            case kCMYK:  // null_convert, then PIL's "CMYK;I" inversion
                for (int x = 0; x < W; ++x) {
                    o[4 * x] = (uint8_t)(255 - c0[x]);
                    o[4 * x + 1] = (uint8_t)(255 - c1[x]);
                    o[4 * x + 2] = (uint8_t)(255 - c2[x]);
                    o[4 * x + 3] = (uint8_t)(255 - c3[x]);
                }
                break;
            default:  // kYCCK: ycck_cmyk_convert, then "CMYK;I"
                for (int x = 0; x < W; ++x) {
                    int yy = c0[x], cb = c1[x], cr = c2[x];
                    int rgb[3] = {yy + cr_r[cr],
                                  yy + (int)((cb_g[cb] + cr_g[cr]) >> 16),
                                  yy + cb_b[cb]};
                    for (int i = 0; i < 3; ++i)
                        o[4 * x + i] = (uint8_t)(255 - clamp255(255 - rgb[i]));
                    o[4 * x + 3] = (uint8_t)(255 - c3[x]);
                }
                break;
        }
    }
    return kOk;
}

}  // extern "C"
