"""A JPEG writer for the tests of the port's decoder, in numpy and Python.

It writes what PIL cannot: the same quantised coefficients as a baseline
file, a progressive file under any scan script, an arithmetic-coded file
(sequential or progressive), a lossless file (SOF3: any predictor and
point transform, restarts, interleaved or one scan per component, or
differences given outright), at any sampling factors, with JFIF, Adobe
or no colour marker and any component ids.  A test holds each such file
twice: PIL's decode of it equals PIL's decode of the same coefficients
written as a baseline file (which checks this writer), and the port's
decoder equals PIL.

The entropy coders follow libjpeg's encoders: ``jchuff.c`` (sequential
Huffman and ``jpeg_gen_optimal_table``), ``jcphuff.c`` (progressive
Huffman: end-of-band runs, buffered correction bits), ``jcarith.c``
(the QM coder, its statistics bins and conditioning) and ``jclhuff.c``
with ``jcdiffct.c`` (lossless differences, Huffman tables fitted to
them).  It imports no PIL,
so ``chip_smoke.py`` can make its timing files on a machine without it.

    frame = coefficients(rgb, sampling=((2, 2), (1, 1), (1, 1)))
    data = write(frame, "progressive", script=simple_progression(3))
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Sequence

import numpy as np

# natural index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# ITU T.81 Annex K.3: (code counts by length 1..16, symbols)
STD_DC = [((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
          ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12)))]
STD_AC = [((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa"))]

SOF = {"baseline": 0xC0, "progressive": 0xC2, "arithmetic": 0xC9,
       "arithmetic_progressive": 0xCA}


# ---------------------------------------------------------- coefficients


@dataclasses.dataclass
class Frame:
    """A frame's quantised coefficients: ``coef[c]`` is (rows, cols, 64)
    in zigzag order over whole MCUs; ``quant[t]`` a table in zigzag order;
    ``comps[c]`` = (h, v, table)."""

    height: int
    width: int
    comps: list
    coef: list
    quant: dict

    @property
    def hmax(self) -> int:
        return max(h for h, _, _ in self.comps)

    @property
    def vmax(self) -> int:
        return max(v for _, v, _ in self.comps)

    def mcus(self) -> tuple:
        """(MCU rows, MCU columns) of an interleaved scan."""
        return (-(-self.height // (8 * self.vmax)),
                -(-self.width // (8 * self.hmax)))

    def blocks(self, c: int) -> tuple:
        """(rows, cols) of component c's blocks in a scan of its own."""
        h, v, _ = self.comps[c]
        dh = -(-self.height * v // self.vmax)
        dw = -(-self.width * h // self.hmax)
        return -(-dh // 8), -(-dw // 8)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's table for a quality, in zigzag order."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)[ZIGZAG]


def _dct() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    return np.where(u == 0, np.sqrt(0.5), 1.0) / 2.0 * np.cos(
        (2 * x + 1) * u * np.pi / 16)


DCT = _dct()


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's ``rgb_ycc_convert``."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + half - 1) >> 16
    return np.stack([y, cb, cr], axis=-1).astype(np.uint8)


def coefficients(planes: np.ndarray, sampling: Sequence[tuple],
                 quality: int = 90,
                 tables: Optional[Sequence[int]] = None) -> Frame:
    """The frame of (H, W) or (H, W, C) uint8 component planes (already
    in the file's colour space), each downsampled by box averaging to its
    (h, v) factors, DCT'd and quantised; component 0 takes the luma
    table, the others the chroma table, unless ``tables`` says."""
    planes = np.asarray(planes)
    if planes.ndim == 2:
        planes = planes[..., None]
    height, width, n = planes.shape
    if tables is None:
        tables = [0] + [1] * (n - 1)
    comps = [(h, v, t) for (h, v), t in zip(sampling, tables)]
    quant = {0: quant_table(LUMA_QT, quality),
             1: quant_table(CHROMA_QT, quality)}
    frame = Frame(height, width, comps, [], quant)
    rows, cols = frame.mcus()
    hmax, vmax = frame.hmax, frame.vmax
    ph, pw = rows * 8 * vmax, cols * 8 * hmax
    for c, (h, v, t) in enumerate(comps):
        full = np.pad(planes[..., c].astype(np.float64),
                      ((0, ph - height), (0, pw - width)), mode="edge")
        fy, fx = vmax // v, hmax // h
        small = full.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        bh, bw = small.shape[0] // 8, small.shape[1] // 8
        blocks = (small - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = (DCT @ blocks @ DCT.T).reshape(bh, bw, 64)[..., ZIGZAG]
        q = quant[t]
        out = np.sign(coef) * np.floor(np.abs(coef) / q + 0.5)
        frame.coef.append(np.clip(out, -1023, 1023).astype(np.int32))
    return frame


# ----------------------------------------------------------- scan scripts


def simple_progression(ncomps: int) -> list:
    """libjpeg's ``jpeg_simple_progression`` (PIL's ``progressive=True``)
    for YCbCr or other colour: scans of (components, Ss, Se, Ah, Al)."""
    every = tuple(range(ncomps))
    dc = [(every, 0, 0, 0, 1)] if ncomps <= 4 else [
        ((c,), 0, 0, 0, 1) for c in every]
    dc_final = [(s[0], 0, 0, 1, 0) for s in dc]
    if ncomps == 3:
        return (dc + [((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                      ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                      ((0,), 1, 63, 2, 1)] + dc_final
                + [((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                   ((0,), 1, 63, 1, 0)])
    return (dc + [((c,), 1, 5, 0, 2) for c in every]
            + [((c,), 6, 63, 0, 2) for c in every]
            + [((c,), 1, 63, 2, 1) for c in every] + dc_final
            + [((c,), 1, 63, 1, 0) for c in every])


def spectral_selection(ncomps: int) -> list:
    """Every coefficient in one pass (Ah = Al = 0), in bands."""
    return ([(tuple(range(ncomps)), 0, 0, 0, 0)]
            + [((c,), lo, hi, 0, 0) for c in range(ncomps)
               for lo, hi in ((1, 2), (3, 9), (10, 40), (41, 63))])


def separate_dc(ncomps: int) -> list:
    """A DC scan per component, then successive approximation."""
    return ([((c,), 0, 0, 0, 1) for c in range(ncomps)]
            + [((c,), 1, 63, 0, 1) for c in reversed(range(ncomps))]
            + [((c,), 0, 0, 1, 0) for c in range(ncomps)]
            + [((c,), 1, 63, 1, 0) for c in range(ncomps)])


def many_approximations(ncomps: int) -> list:
    """DC in three bits' steps, AC from Al = 3 down to 0."""
    every = tuple(range(ncomps))
    scans = [(every, 0, 0, 0, 2), (every, 0, 0, 2, 1)]
    for c in range(ncomps):
        scans += [((c,), 1, 9, 0, 3), ((c,), 10, 63, 0, 3)]
    scans.append((every, 0, 0, 1, 0))
    for al in (2, 1, 0):
        scans += [((c,), 1, 63, al + 1, al) for c in range(ncomps)]
    return scans


def stops_early(ncomps: int) -> list:
    """libjpeg's script without its last bit of AC: coefficients stay
    inexact, so libjpeg smooths the blocks."""
    return [s for s in simple_progression(ncomps)
            if not (s[1] > 0 and s[3] == 1 and s[4] == 0)]


def random_progression(rng, ncomps: int) -> list:
    """A valid script of random length: the DC (interleaved or per
    component) at a random Al, then random DC refinements, and AC bands
    first coded at a random Al or refined by a bit; it may stop anywhere,
    so coefficients stay inexact or uncoded."""
    bits = [[-1] * 64 for _ in range(ncomps)]
    al = int(rng.integers(0, 3))
    every = tuple(range(ncomps))
    scans = ([(every, 0, 0, 0, al)] if rng.random() < 0.5
             else [((c,), 0, 0, 0, al) for c in every])
    for b in bits:
        b[0] = al
    for _ in range(int(rng.integers(0, 12))):
        c = int(rng.integers(ncomps))
        b = bits[c]
        if rng.random() < 0.2 and b[0] > 0:
            scans.append(((c,), 0, 0, b[0], b[0] - 1))
            b[0] -= 1
            continue
        ss = int(rng.integers(1, 64))
        se = int(rng.integers(ss, min(64, ss + 20)))
        state = set(b[ss:se + 1])
        if state == {-1}:
            al = int(rng.integers(0, 4))
            scans.append(((c,), ss, se, 0, al))
        elif len(state) == 1 and min(state) > 0:
            al = min(state) - 1
            scans.append(((c,), ss, se, al + 1, al))
        else:
            continue
        b[ss:se + 1] = [al] * (se - ss + 1)
    return scans


# --------------------------------------------------------------- Huffman


def optimal_table(freq: Sequence[int]) -> tuple:
    """jchuff.c ``jpeg_gen_optimal_table``: (counts by length, symbols)."""
    freq = list(freq) + [0] * (257 - len(freq))
    freq[256] = 1
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1, v = -1, 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        c2, v = -1, 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for size in codesize:
        if size:
            bits[size] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = bytes(s for size in range(1, 33) for s in range(256)
                    if codesize[s] == size)
    return tuple(bits[1:17]), symbols


def huffman_codes(spec) -> dict:
    """symbol -> (code, length) of a (counts, symbols) table."""
    counts, symbols = spec
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class BitWriter:
    """Bits MSB first, 0xFF stuffed with 0x00, padded with ones."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int) -> tuple:
    """(category, bits) of a coefficient or difference."""
    a = -v if v < 0 else v
    size = a.bit_length()
    return size, (v if v >= 0 else v - 1) & ((1 << size) - 1)


class HuffmanScan:
    """One scan as a list of tokens (Huffman symbols by table, raw bits,
    restart markers), so that tables can be fitted to it before coding:
    jchuff.c's sequential MCUs and jcphuff.c's four progressive ones."""

    def __init__(self):
        self.tokens = []
        self.eobrun = 0
        self.be = []            # buffered correction bits (jcphuff.c BE)

    def sym(self, table: tuple, symbol: int) -> None:
        self.tokens.append((0, table, symbol))

    def bits(self, value: int, n: int) -> None:
        if n:
            self.tokens.append((1, value, n))

    def emit_eobrun(self, table: tuple) -> None:
        if self.eobrun > 0:
            nbits = self.eobrun.bit_length() - 1
            self.sym(table, nbits << 4)
            self.bits(self.eobrun, nbits)
            self.eobrun = 0
            for b in self.be:
                self.bits(b, 1)
            self.be = []

    def sequential(self, block, pred: int, dc: tuple, ac: tuple) -> None:
        size, bits = _magnitude(int(block[0]) - pred)
        self.sym(dc, size)
        self.bits(bits, size)
        run = 0
        last = np.flatnonzero(block[1:])
        end = last[-1] + 1 if last.size else 0
        for k in range(1, end + 1):
            v = int(block[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                self.sym(ac, 0xF0)
                run -= 16
            size, bits = _magnitude(v)
            self.sym(ac, (run << 4) | size)
            self.bits(bits, size)
            run = 0
        if end < 63:
            self.sym(ac, 0x00)

    def dc_first(self, value: int, pred: int, dc: tuple) -> None:
        size, bits = _magnitude(value - pred)
        self.sym(dc, size)
        self.bits(bits, size)

    def ac_first(self, block, ss: int, se: int, al: int, ac: tuple) -> None:
        run = 0
        for k in range(ss, se + 1):
            v = int(block[k])
            a = (-v if v < 0 else v) >> al
            if a == 0:
                run += 1
                continue
            self.emit_eobrun(ac)
            while run > 15:
                self.sym(ac, 0xF0)
                run -= 16
            size = a.bit_length()
            self.sym(ac, (run << 4) | size)
            self.bits(a if v >= 0 else ~a, size)
            run = 0
        if run > 0:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun(ac)

    def ac_refine(self, block, ss: int, se: int, al: int, ac: tuple) -> None:
        absval = [abs(int(block[k])) >> al for k in range(ss, se + 1)]
        eob = -1
        for i, a in enumerate(absval):
            if a == 1:
                eob = i
        run, br = 0, []
        for i, a in enumerate(absval):
            if a == 0:
                run += 1
                continue
            while run > 15 and i <= eob:
                self.emit_eobrun(ac)
                self.sym(ac, 0xF0)
                run -= 16
                for b in br:
                    self.bits(b, 1)
                br = []
            if a > 1:
                br.append(a & 1)
                continue
            self.emit_eobrun(ac)
            self.sym(ac, (run << 4) | 1)
            self.bits(0 if block[ss + i] < 0 else 1, 1)
            for b in br:
                self.bits(b, 1)
            br = []
            run = 0
        if run > 0 or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 1000 - 64 + 1:
                self.emit_eobrun(ac)

    def tables_used(self) -> dict:
        freq = {}
        for t in self.tokens:
            if t[0] == 0:
                freq.setdefault(t[1], [0] * 257)[t[2]] += 1
        return freq

    def code(self, specs: dict) -> bytes:
        codes = {key: huffman_codes(spec) for key, spec in specs.items()}
        w = BitWriter()
        for t in self.tokens:
            if t[0] == 0:
                w.put(*codes[t[1]][t[2]])
            elif t[0] == 1:
                w.put(t[1], t[2])
            else:
                w.flush()
                w.out += bytes([0xFF, 0xD0 + t[1]])
        w.flush()
        return bytes(w.out)


# ------------------------------------------------------------ arithmetic

# ITU T.81 Table D.2 (jaricom.c): (Qe, Next_Index_LPS, Next_Index_MPS,
# Switch_MPS), then the fixed 0.5 estimate of T.851 as entry 113
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
FIXED = 113


class ArithEncoder:
    """jcarith.c's QM coder: ``encode(bins, index, bit)`` codes one
    decision in the statistics bin ``bins[index]``; ``finish`` flushes."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc = 0, 0x10000, 0, 0
        self.ct, self.buffer = 11, -1

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, bins, i: int, val: int) -> None:
        sv = bins[i]
        qe, nl, nm, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        self.zc = 0


class ArithScan:
    """jcarith.c's MCU coders over one scan's statistics."""

    def __init__(self, dc_lu: dict, ac_k: dict):
        self.e = ArithEncoder()
        self.dc_lu, self.ac_k = dc_lu, ac_k
        self.dc_stats, self.ac_stats = {}, {}
        self.fixed = bytearray([FIXED])

    def reset_stats(self, dc_tables, ac_tables) -> None:
        for t in dc_tables:
            self.dc_stats[t] = bytearray(64)
        for t in ac_tables:
            self.ac_stats[t] = bytearray(256)

    def dc(self, value: int, state: list, tbl: int) -> None:
        """Figure F.4 (DC difference), with the conditioning of F.1.4.4.1;
        ``state`` = [last value, context]."""
        enc = self.e.encode
        st = self.dc_stats[tbl]
        s0 = state[1]
        v = value - state[0]
        if v == 0:
            enc(st, s0, 0)
            state[1] = 0
            return
        state[0] = value
        enc(st, s0, 1)
        if v > 0:
            enc(st, s0 + 1, 0)
            i = s0 + 2
            state[1] = 4
        else:
            v = -v
            enc(st, s0 + 1, 1)
            i = s0 + 3
            state[1] = 8
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v
            i = 20
            v2 >>= 1
            while v2:
                enc(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        enc(st, i, 0)
        lo, hi = self.dc_lu.get(tbl, (0, 1))
        if m < (1 << lo) >> 1:
            state[1] = 0
        elif m > (1 << hi) >> 1:
            state[1] += 8
        i += 14
        while True:
            m >>= 1
            if not m:
                break
            enc(st, i, 1 if m & v else 0)

    def _ac_value(self, st, k: int, v: int, tbl: int) -> None:
        """A nonzero AC value v at band index k, from its S0 decision on."""
        enc = self.e.encode
        base = 3 * (k - 1)
        enc(st, base + 1, 1)
        if v > 0:
            enc(self.fixed, 0, 0)
        else:
            v = -v
            enc(self.fixed, 0, 1)
        i = base + 2
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc(st, i, 1)
                m <<= 1
                i = 189 if k <= self.ac_k.get(tbl, 5) else 217
                v2 >>= 1
                while v2:
                    enc(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        enc(st, i, 0)
        i += 14
        while True:
            m >>= 1
            if not m:
                break
            enc(st, i, 1 if m & v else 0)

    def ac(self, block, ss: int, se: int, al: int, tbl: int) -> None:
        """Figure F.5 / G.1.3.2: the band ss..se after the point
        transform al."""
        enc = self.e.encode
        st = self.ac_stats[tbl]
        vals = [int(block[k]) for k in range(se + 1)]
        tv = [(v >> al) if v >= 0 else -((-v) >> al) for v in vals]
        ke = se
        while ke >= ss and tv[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            enc(st, 3 * (k - 1), 0)
            while tv[k] == 0:
                enc(st, 3 * (k - 1) + 1, 0)
                k += 1
            self._ac_value(st, k, tv[k], tbl)
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)

    def ac_refine(self, block, ss: int, se: int, ah: int, al: int,
                  tbl: int) -> None:
        """Figure G.10."""
        enc = self.e.encode
        st = self.ac_stats[tbl]
        absval = [abs(int(block[k])) for k in range(se + 1)]
        ke = se
        while ke > 0 and (absval[ke] >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (absval[kex] >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            base = 3 * (k - 1)
            if k > kex:
                enc(st, base, 0)
            while True:
                v = absval[k] >> al
                if v:
                    if v >> 1:
                        enc(st, base + 2, v & 1)
                    else:
                        enc(st, base + 1, 1)
                        enc(self.fixed, 0, 1 if block[k] < 0 else 0)
                    break
                enc(st, base + 1, 0)
                base += 3
                k += 1
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)


# ----------------------------------------------------------------- files


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    return _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                    + bytes([transform]))


def entropy_spans(data: bytes) -> list:
    """[start, end) of each scan's entropy-coded data in a file: from
    the end of its SOS segment to the next marker that is not a restart
    (RSTn markers inside are part of the span)."""
    spans, p = [], 0
    while (q := data.find(b"\xff\xda", p)) >= 0:
        start = q + 2 + struct.unpack(">H", data[q + 2:q + 4])[0]
        end = start
        while end + 1 < len(data) and not (
                data[end] == 0xFF and data[end + 1] not in (0, 0xFF)
                and not 0xD0 <= data[end + 1] <= 0xD7):
            end += 1
        spans.append((start, end))
        p = end
    return spans


def _scan_mcus(frame: Frame, comps: tuple):
    """Each MCU of a scan as [(slot, component, block row, block col)]."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = frame.blocks(c)
        for by in range(rows):
            for bx in range(cols):
                yield [(0, c, by, bx)]
        return
    rows, cols = frame.mcus()
    for my in range(rows):
        for mx in range(cols):
            yield [(slot, c, my * v + y, mx * h + x)
                   for slot, c in enumerate(comps)
                   for h, v, _ in [frame.comps[c]]
                   for y in range(v) for x in range(h)]


def _dc_table(c: int) -> int:
    return 0 if c == 0 else 1


def write(frame: Frame, mode: str = "baseline", *,
          script: Optional[list] = None, restart: int = 0,
          markers: bytes = JFIF,
          ids: Optional[Sequence[int]] = None, precision: int = 8,
          sof: Optional[int] = None, dac: Optional[dict] = None,
          height: Optional[int] = None) -> bytes:
    """The frame as a JPEG file.

    ``mode`` is ``baseline`` (sequential Huffman), ``progressive``,
    ``arithmetic`` (SOF9) or ``arithmetic_progressive`` (SOF10);
    ``script`` the scans as (components, Ss, Se, Ah, Al) (sequential
    modes: one interleaved scan unless given, each scan 0..63); a
    progressive Huffman file fits its tables to each scan, a sequential
    one uses the standard tables.  ``markers`` come
    right after SOI; ``ids`` are the component ids (1, 2, ... by
    default); ``precision``, ``sof`` and ``height`` override the frame
    header (for files the decoder must refuse); ``dac`` maps ("dc", t) to
    (L, U) and ("ac", t) to K for a DAC segment (arithmetic modes)."""
    n = len(frame.comps)
    ids = list(ids) if ids is not None else list(range(1, n + 1))
    progressive = mode in ("progressive", "arithmetic_progressive")
    arithmetic = mode.startswith("arithmetic")
    if script is None:
        script = (simple_progression(n) if progressive
                  else [(tuple(range(n)), 0, 63, 0, 0)])
    out = [b"\xff\xd8", markers]
    for t, table in sorted(frame.quant.items()):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            np.asarray(table, np.uint8).tolist())))
    body = struct.pack(">BHHB", precision,
                       frame.height if height is None else height,
                       frame.width, n)
    for c, (h, v, t) in enumerate(frame.comps):
        body += bytes([ids[c], (h << 4) | v, t])
    out.append(_segment(sof if sof is not None else SOF[mode], body))
    dc_lu, ac_k = {}, {}
    if arithmetic and dac:
        payload = b""
        for (kind, t), val in sorted(dac.items()):
            if kind == "dc":
                dc_lu[t] = val
                payload += bytes([t, val[0] | (val[1] << 4)])
            else:
                ac_k[t] = val
                payload += bytes([0x10 | t, val])
        out.append(_segment(0xCC, payload))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    if not arithmetic and not progressive:
        for t in (0, 1):
            for cls, spec in ((0, STD_DC[t]), (1, STD_AC[t])):
                out.append(_segment(0xC4, bytes([(cls << 4) | t])
                                    + bytes(spec[0]) + spec[1]))
    for comps, ss, se, ah, al in script:
        if arithmetic:
            data = _arith_scan(frame, comps, ss, se, ah, al, restart,
                               progressive, dc_lu, ac_k)
        else:
            scan = _huffman_scan(frame, comps, ss, se, ah, al, restart,
                                 progressive)
            if progressive:
                specs = {key: optimal_table(freq) for key, freq in
                         sorted(scan.tables_used().items())}
                for (cls, t), spec in specs.items():
                    out.append(_segment(0xC4, bytes([(cls << 4) | t])
                                        + bytes(spec[0]) + spec[1]))
            else:
                specs = {(0, t): STD_DC[t] for t in (0, 1)}
                specs.update({(1, t): STD_AC[t] for t in (0, 1)})
            data = scan.code(specs)
        sel = b"".join(bytes([ids[c], (_dc_table(c) << 4) | _dc_table(c)])
                       for c in comps)
        out.append(_segment(0xDA, bytes([len(comps)]) + sel
                            + bytes([ss, se, (ah << 4) | al])))
        out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)


def _huffman_scan(frame, comps, ss, se, ah, al, restart,
                  progressive) -> HuffmanScan:
    scan = HuffmanScan()
    ac_table = (1, _dc_table(comps[0]))
    preds = [0] * len(comps)
    for m, mcu in enumerate(_scan_mcus(frame, comps)):
        if restart and m and m % restart == 0:
            if progressive and ss > 0:
                scan.emit_eobrun(ac_table)
            scan.tokens.append((2, (m // restart - 1) % 8))
            preds = [0] * len(comps)
        for slot, c, by, bx in mcu:
            block = frame.coef[c][by, bx]
            dc, ac = (0, _dc_table(c)), (1, _dc_table(c))
            if not progressive:
                scan.sequential(block, preds[slot], dc, ac)
                preds[slot] = int(block[0])
            elif ss == 0 and ah == 0:
                value = int(block[0]) >> al
                scan.dc_first(value, preds[slot], dc)
                preds[slot] = value
            elif ss == 0:
                scan.bits((int(block[0]) >> al) & 1, 1)
            elif ah == 0:
                scan.ac_first(block, ss, se, al, ac)
            else:
                scan.ac_refine(block, ss, se, al, ac)
    if progressive and ss > 0:
        scan.emit_eobrun(ac_table)
    return scan


def _arith_scan(frame, comps, ss, se, ah, al, restart, progressive,
                dc_lu, ac_k) -> bytes:
    scan = ArithScan(dc_lu, ac_k)
    tables = [_dc_table(c) for c in comps]
    dc_used = not progressive or (ss == 0 and ah == 0)
    ac_used = not progressive or ss > 0

    def reset():
        scan.reset_stats(tables if dc_used else (),
                         tables if ac_used else ())
        return [[0, 0] for _ in comps]

    states = reset()
    out = bytearray()
    for m, mcu in enumerate(_scan_mcus(frame, comps)):
        if restart and m and m % restart == 0:
            scan.e.finish()
            out += scan.e.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            scan.e.out = bytearray()
            scan.e.reset()
            states = reset()
        for slot, c, by, bx in mcu:
            block = frame.coef[c][by, bx]
            t = tables[slot]
            if not progressive:
                scan.dc(int(block[0]), states[slot], t)
                scan.ac(block, 1, 63, 0, t)
            elif ss == 0 and ah == 0:
                scan.dc(int(block[0]) >> al, states[slot], t)
            elif ss == 0:
                scan.e.encode(scan.fixed, 0, (int(block[0]) >> al) & 1)
            elif ah == 0:
                scan.ac(block, ss, se, al, t)
            else:
                scan.ac_refine(block, ss, se, ah, al, t)
    scan.e.finish()
    return bytes(out + scan.e.out)


# -------------------------------------------------------------- lossless


@dataclasses.dataclass
class LosslessFrame:
    """A lossless (SOF3) frame: ``samples[c]`` is component c's (rows,
    cols) plane of 8-bit samples, before the point transform;
    ``comps[c]`` = (h, v)."""

    height: int
    width: int
    comps: list
    samples: list

    @property
    def hmax(self) -> int:
        return max(h for h, _ in self.comps)

    @property
    def vmax(self) -> int:
        return max(v for _, v in self.comps)

    def mcus(self) -> tuple:
        """(MCU rows, MCU columns) of an interleaved scan, whose MCU
        holds h x v samples of each component."""
        return -(-self.height // self.vmax), -(-self.width // self.hmax)


def lossless_frame(planes: np.ndarray,
                   sampling: Optional[Sequence[tuple]] = None
                   ) -> LosslessFrame:
    """The frame of (H, W) or (H, W, C) uint8 planes (already in the
    file's colour space), each downsampled by box means (rounded down) to
    its (h, v) factors."""
    planes = np.asarray(planes)
    if planes.ndim == 2:
        planes = planes[..., None]
    height, width, n = planes.shape
    sampling = list(sampling or [(1, 1)] * n)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    samples = []
    for c, (h, v) in enumerate(sampling):
        fy, fx = vmax // v, hmax // h
        rows, cols = -(-height * v // vmax), -(-width * h // hmax)
        full = np.pad(planes[..., c].astype(np.int64),
                      ((0, rows * fy - height), (0, cols * fx - width)),
                      mode="edge")
        samples.append(full.reshape(rows, fy, cols, fx).sum(axis=(1, 3))
                       // (fy * fx))
    return LosslessFrame(height, width, sampling, samples)


def _predict(psv: int, ra, rb, rc):
    """jdlossls.c's predictors 1-7 (Table H.1), shifts arithmetic."""
    return {1: lambda: ra, 2: lambda: rb, 3: lambda: rc,
            4: lambda: ra + rb - rc, 5: lambda: ra + ((rb - rc) >> 1),
            6: lambda: rb + ((ra - rc) >> 1),
            7: lambda: (ra + rb) >> 1}[psv]()


def lossless_differences(x: np.ndarray, psv: int, initial: int,
                         first: np.ndarray) -> np.ndarray:
    """The differences of samples x (rows, cols) from their predictions:
    a row where ``first`` is set predicts from its left neighbour and its
    first sample from ``initial`` (a scan's or restart interval's first
    row), every other row's first sample from the one above it."""
    x = np.asarray(x, np.int64)
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = _predict(psv, ra, rb, rc)
    pred[:, 0] = rb[:, 0]
    pred[first] = ra[first]
    pred[first, 0] = initial
    return x - pred


def _first_rows(rows: int, v: int, interleaved: bool,
                restart_rows: int) -> np.ndarray:
    """Which of a component's sample rows libjpeg undifferences as a
    first row: the first of each iMCU row (v rows) that a scan's start or
    a restart precedes.  A restart is processed before an MCU row
    (interleaved: an iMCU row; otherwise one sample row), but the
    predictor is reset for the next row undifferenced, after the whole
    iMCU row is decoded (jddiffct.c decompress_data)."""
    first = np.zeros(rows, bool)
    for i in range(-(-rows // v)):
        mcu_rows = [i] if interleaved else range(i * v, min(rows, i * v + v))
        first[i * v] = i == 0 or any(
            restart_rows and j and j % restart_rows == 0 for j in mcu_rows)
    return first


def _categories(d: np.ndarray) -> tuple:
    """(category, extra bits) of lossless differences taken modulo 2^16:
    category 16 is the difference 32768, with no extra bits."""
    d = ((np.asarray(d, np.int64) + 32768) & 0xFFFF) - 32768
    a = np.abs(d)
    _, e = np.frexp(a.astype(np.float64))
    s = np.where(a == 0, 0, e).astype(np.int64)
    s[d == -32768] = 16
    bits = np.where(d >= 0, d, d - 1) & ((1 << s) - 1)
    bits[s == 16] = 0
    return s, bits


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes MSB first, padded with ones, 0xFF stuffed with 0x00."""
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int64)
    chunks = []
    for lo in range(0, len(values), 1 << 18):
        v, n = values[lo:lo + (1 << 18)], lengths[lo:lo + (1 << 18)]
        idx = np.repeat(np.arange(len(v)), n)
        pos = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        chunks.append(((v[idx] >> (n[idx] - 1 - pos)) & 1).astype(np.uint8))
    bits = np.concatenate(chunks + [np.ones(0, np.uint8)])
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    out = np.packbits(bits)
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def lossless(frame: LosslessFrame, *, psv: int = 1, pt: int = 0,
             scans: Optional[Sequence[tuple]] = None, restart: int = 0,
             markers: bytes = JFIF, ids: Optional[Sequence[int]] = None,
             tables: Optional[Sequence[int]] = None,
             differences: Optional[dict] = None, sof: int = 0xC3,
             precision: int = 8, height: Optional[int] = None) -> bytes:
    """The frame as a lossless Huffman-coded JPEG (SOF3), as
    libjpeg-turbo's jclhuff.c and jcdiffct.c code one.

    ``psv`` is the predictor (the scans' Ss), ``pt`` the point transform
    (Al): samples are coded shifted right by it.  ``scans`` lists each
    scan's components (one interleaved scan of all by default);
    ``restart`` is the restart interval in MCUs, which libjpeg needs to
    be a whole number of MCU rows.  Each scan gets Huffman tables fitted
    to it (``tables``: each component's, 0 for the first and 1 for the
    others by default).  ``differences`` maps a component to the
    differences its scan codes instead of its samples', over the scan's
    whole MCUs ((MCU rows * v, MCU columns * h) interleaved, its samples'
    shape alone), any of -32767..32768.  ``markers``, ``ids``, ``sof``,
    ``precision`` and ``height`` as in ``write``."""
    n = len(frame.comps)
    ids = list(ids) if ids is not None else list(range(1, n + 1))
    tables = list(tables) if tables is not None else [
        _dc_table(c) for c in range(n)]
    scans = list(scans) if scans is not None else [tuple(range(n))]
    initial = 1 << (precision - pt - 1)
    out = [b"\xff\xd8", markers]
    body = struct.pack(">BHHB", precision,
                       frame.height if height is None else height,
                       frame.width, n)
    for c, (h, v) in enumerate(frame.comps):
        body += bytes([ids[c], (h << 4) | v, 0])
    out.append(_segment(sof, body))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    for comps in scans:
        interleaved = len(comps) > 1
        mcu_rows, mcu_cols = frame.mcus()
        cells, cell_tables = [], []
        for c in comps:
            h, v = frame.comps[c] if interleaved else (1, 1)
            x = frame.samples[c] >> pt
            rows, cols = x.shape
            if not interleaved:
                mcu_rows, mcu_cols = rows, cols
            per_row = mcu_cols
            rr = restart // per_row if restart else 0
            if differences is not None and c in differences:
                d = np.asarray(differences[c], np.int64)
            else:
                d = np.zeros((mcu_rows * v, mcu_cols * h), np.int64)
                first = _first_rows(rows, frame.comps[c][1], interleaved, rr)
                d[:rows, :cols] = lossless_differences(x, psv, initial, first)
            # MCU order: each MCU's v rows of h samples
            cells.append(d.reshape(mcu_rows, v, mcu_cols, h).transpose(
                0, 2, 1, 3).reshape(mcu_rows, mcu_cols, v * h))
            cell_tables.append(np.full(v * h, tables[c]))
        mcus = np.concatenate(cells, axis=2).reshape(mcu_rows * mcu_cols, -1)
        tbl = np.broadcast_to(np.concatenate(cell_tables), mcus.shape)
        s, bits = _categories(mcus)
        specs = {}
        for t in sorted(set(tables[c] for c in comps)):
            specs[t] = optimal_table(np.bincount(s[tbl == t], minlength=17))
            counts, symbols = specs[t]
            out.append(_segment(0xC4, bytes([t]) + bytes(counts) + symbols))
        code = np.zeros((4, 17), np.int64)
        size = np.zeros((4, 17), np.int64)
        for t, spec in specs.items():
            for sym, (cd, ln) in huffman_codes(spec).items():
                code[t, sym], size[t, sym] = cd, ln
        values = (code[tbl, s] << s) | bits
        lengths = size[tbl, s] + np.where(s == 16, 0, s)
        every = restart or len(mcus)
        segments = [_pack_bits(values[m:m + every].ravel(),
                               lengths[m:m + every].ravel())
                    for m in range(0, len(mcus), every)]
        data = b"".join(seg + (bytes([0xFF, 0xD0 + i % 8])
                               if i < len(segments) - 1 else b"")
                        for i, seg in enumerate(segments))
        sel = b"".join(bytes([ids[c], tables[c] << 4]) for c in comps)
        out.append(_segment(0xDA, bytes([len(comps)]) + sel
                            + bytes([psv, 0, pt])))
        out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)
