"""Image files for the port's data layer, without PIL.

* ``open_image`` sniffs a file's content, as ``PIL.Image.open`` does, and
  never trusts its extension:

  - a PNG is decoded here, to the mode and the array
    ``np.asarray(PIL.Image.open(path))`` gives: every legal (colour type,
    bit depth) pair, Adam7-interlaced or not, any of the five row filters
    (un-filtered by the host C++, ``data/native.py``, pass by pass when
    interlaced).  Grey at 1 bit is PIL's ``1`` (a bool array); at 2 and 4
    bits ``L``, the samples scaled by 85 and 17; at 16 bits ``I;16``
    (uint16).  RGB and RGBA at 16 bits keep each sample's high byte, and
    grey+alpha at 16 bits becomes ``RGBA`` (the grey's high byte thrice,
    then the alpha's).  A palette image at 1, 2, 4 or 8 bits is ``P``:
    its indices as its pixels and its palette beside them.  ``tRNS`` and
    the other ancillary chunks change no pixel.  An illegal pair raises.
  - a JPEG is decoded here by the host C++ (``csrc/host/jpeg_decode.cpp``)
    to the pixels PIL gives: sequential or progressive, Huffman or
    arithmetic-coded, or lossless Huffman-coded (SOF3: any predictor,
    point transform and restart interval), 8 bits, every integral
    sampling ratio, one component (L), three (RGB, from YCbCr or stored
    as RGB) or four (CMYK, from CMYK or YCCK, inverted as PIL inverts
    them), with libjpeg's integer IDCT, block smoothing, fancy
    upsampling and fixed-point colour.  A lossless YCbCr or YCCK frame
    raises, as PIL raises on it.
  - a JPEG the decoder refuses (lossless arithmetic SOF11, 12-bit
    samples, a height left to a DNL marker or hierarchical frames, none
    of which PIL decodes either) is read from its decoded sidecar
    ``<file>.png`` (for example ``000000_0.jpg.png``), a lossless PNG of
    its pixels as ``tools/decode_images.py`` writes one where PIL is
    installed.  Such a JPEG without one raises, naming the tool: no
    silent fallback.
* ``write_png`` writes L, LA, P, RGB or RGBA, choosing each row's filter
  by the smallest sum of absolute signed bytes (libpng's heuristic).
* ``write_jpeg`` writes a baseline JPEG of an RGB image as PIL saves one
  with ``quality=95``: libjpeg's standard quantisation tables scaled for
  the quality, 4:2:0 chroma (Y 2x2, Cb and Cr 1x1), the standard Huffman
  tables, a JFIF header.  Colour conversion and 2x2 chroma averaging are
  libjpeg's fixed-point formulas; the DCT is exact (float64) where
  libjpeg's is integer, so the coefficients may differ by one level of
  quantisation.  The decoded pixels are held to PIL's own file by PSNR
  (``tests/test_torch_port_imageio.py``).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ladi_vton_tpu_torch.data import native, resample

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8\xff"
DECODE_TOOL = "tools/decode_images.py"
SIDECAR_SUFFIX = ".png"
# a decoded JPEG's mode by its channels, as PIL names it
JPEG_MODES = {(): "L", (3,): "RGB", (4,): "CMYK"}

# PNG colour type -> (mode, channels) at 8 bits per sample, as written
PNG_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
                   6: ("RGBA", 4)}
MODE_COLOR_TYPE = {mode: (ct, ch) for ct, (mode, ch) in
                   PNG_COLOR_TYPES.items()}
# the legal bit depths of each colour type, and PIL's mode where it is
# not the 8-bit one
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}
PNG_MODES = {(0, 1): "1", (0, 16): "I;16", (4, 16): "RGBA"}
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


@dataclasses.dataclass
class Image:
    """Decoded pixels: (H, W) for 1 (bool), L, I;16 (uint16) and P,
    (H, W, C) uint8 otherwise; ``palette`` (n, 3) uint8 for P."""

    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None

    def palette_rgb(self) -> np.ndarray:
        """The palette over all 256 indices: PIL's entries past a short
        ``PLTE`` are black."""
        full = np.zeros((256, 3), np.uint8)
        full[:len(self.palette)] = self.palette[:256]
        return full

    def resize(self, out_hw: tuple[int, int], method: str) -> "Image":
        """PIL's ``resize`` rules: P and 1 resize only with NEAREST; LA
        and RGBA would need premultiplied alpha, which no path uses."""
        if self.mode in ("P", "1"):
            method = resample.NEAREST
        elif self.mode in ("LA", "RGBA") and method != resample.NEAREST:
            raise NotImplementedError(f"resizing {self.mode} with {method}")
        return dataclasses.replace(
            self, pixels=resample.resize(self.pixels, out_hw, method))

    def convert_l(self) -> "Image":
        """PIL's ``convert("L")``."""
        if self.mode == "L":
            return self
        if self.mode == "1":
            px = self.pixels.astype(np.uint8) * 255
        elif self.mode == "I;16":  # clamped, not shifted
            px = np.minimum(self.pixels, 255).astype(np.uint8)
        elif self.mode == "LA":
            px = self.pixels[..., 0]
        elif self.mode in ("RGB", "RGBA"):
            px = resample.convert_l(self.pixels)
        elif self.mode == "P":
            px = resample.convert_l(self.palette_rgb())[self.pixels]
        elif self.mode == "CMYK":  # PIL goes through RGB
            px = resample.convert_l(resample.cmyk_to_rgb(self.pixels))
        else:
            raise ValueError(f"cannot convert {self.mode} to L")
        return Image(np.ascontiguousarray(px), "L")


# ------------------------------------------------------------------- reading


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG: bad CRC in chunk {ctype!r}")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError("PNG: truncated file (no IEND)")


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """(rows, row bytes) un-filtered bytes -> (rows, width, channels)
    samples: below 8 bits MSB first, 16 bits big-endian."""
    n = rows.shape[0]
    if depth == 8:
        return rows.reshape(n, width, channels)
    if depth == 16:
        return rows.view(">u2").reshape(n, width, channels)
    per = 8 // depth
    shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(n, -1)[:, :width * channels].reshape(
        n, width, channels)


def _pil_pixels(s: np.ndarray, color_type: int, depth: int) -> np.ndarray:
    """(H, W, C) samples -> the array ``np.asarray`` of PIL's image."""
    if color_type in (0, 3):
        s = s[..., 0]
        if color_type == 3 or depth == 8:
            return s.astype(np.uint8, copy=False)
        if depth == 16:
            return s.astype(np.uint16)
        if depth == 1:
            return s.astype(bool)
        return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16:
        s = s >> 8
        if color_type == 4:  # PIL reads LA;16B as RGBA
            s = s[..., [0, 0, 0, 1]]
    return s.astype(np.uint8, copy=False)


def decode_png(data: bytes) -> Image:
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color_type, _, _, interlace = header
    if (depth not in PNG_DEPTHS.get(color_type, ()) or interlace > 1
            or width == 0 or height == 0):
        raise ValueError(f"PNG: unsupported format (bit depth {depth}, "
                         f"colour type {color_type}, interlace "
                         f"{interlace}): not a legal PNG")
    mode, channels = PNG_COLOR_TYPES[color_type]
    mode = PNG_MODES.get((color_type, depth), mode)
    if mode == "P" and palette is None:
        raise ValueError("PNG: a palette image without PLTE")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    bits = channels * depth
    bpp = max(1, bits // 8)
    parts, pos = [], 0
    for r0, c0, dr, dc in ADAM7 if interlace else ((0, 0, 1, 1),):
        rows = -(-(height - r0) // dr) if height > r0 else 0
        cols = -(-(width - c0) // dc) if width > c0 else 0
        if rows == 0 or cols == 0:
            continue  # an empty pass holds no bytes
        row_bytes = -(-cols * bits // 8)
        size = rows * (row_bytes + 1)
        part = native.png_unfilter(raw[pos:pos + size], rows, row_bytes, bpp)
        parts.append((r0, c0, dr, dc, _unpack(part, cols, channels, depth)))
        pos += size
    if pos != raw.size:
        raise ValueError(f"PNG: {raw.size} bytes of image data, expected "
                         f"{pos}")
    samples = parts[0][4]
    if interlace:  # the passes' pixels into place
        samples = np.empty((height, width, channels), samples.dtype)
        for r0, c0, dr, dc, part in parts:
            samples[r0::dr, c0::dc] = part
    return Image(_pil_pixels(samples, color_type, depth), mode,
                 palette if mode == "P" else None)


def sidecar_path(path) -> Path:
    """Where ``tools/decode_images.py`` puts a JPEG's decoded pixels."""
    return Path(str(path) + SIDECAR_SUFFIX)


def open_image(path) -> Image:
    """The decoded image at ``path``, by its content (see the module)."""
    path = Path(path)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(JPEG_SOI):
        pixels = native.jpeg_decode(data)
        if pixels is not None:
            return Image(pixels, JPEG_MODES[pixels.shape[2:]])
        side = sidecar_path(path)
        if not side.exists():
            raise FileNotFoundError(
                f"{path} is a JPEG the port's decoder does not read "
                f"(lossless arithmetic, 12-bit, a height left to DNL, or "
                f"hierarchical) and has no decoded sidecar {side.name}: "
                f"run "
                f"`python {DECODE_TOOL} <dataset root>` once where PIL is "
                f"installed")
        return decode_png(side.read_bytes())
    raise ValueError(f"{path}: neither PNG nor JPEG content")


# ------------------------------------------------------------------- writing


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + row bytes): each row with the filter of the least sum of
    absolute signed bytes, prefixed by its type."""
    x = raw.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                      x - paeth]) & 0xFF                        # (5, H, R)
    signed = np.where(cands > 127, 256 - cands, cands)
    best = signed.sum(axis=2).argmin(axis=0)                    # (H,)
    rows = cands[best, np.arange(raw.shape[0])].astype(np.uint8)
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(pixels: np.ndarray, mode: Optional[str] = None,
               palette: Optional[np.ndarray] = None) -> bytes:
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8:
        raise TypeError(f"PNG: uint8 pixels expected, got {pixels.dtype}")
    if mode is None:
        mode = {2: "L"}.get(pixels.ndim) or {
            2: "LA", 3: "RGB", 4: "RGBA"}[pixels.shape[2]]
    color_type, channels = MODE_COLOR_TYPE[mode]
    h, w = pixels.shape[:2]
    if pixels.size != h * w * channels:
        raise ValueError(f"PNG: {pixels.shape} is not a {mode} image")
    rows = _filter_rows(pixels.reshape(h, w * channels), channels)
    out = [PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, color_type, 0, 0, 0))]
    if mode == "P":
        if palette is None:
            raise ValueError("PNG: a P image needs its palette")
        out.append(_chunk(b"PLTE", np.ascontiguousarray(
            palette, np.uint8).tobytes()))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path, pixels: np.ndarray, mode: Optional[str] = None,
              palette: Optional[np.ndarray] = None) -> None:
    Path(path).write_bytes(encode_png(pixels, mode, palette))


# ---------------------------------------------------------------------- JPEG

# ITU T.81 Annex K.1, in natural (row-major) order
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# natural index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
# ITU T.81 Annex K.3: (code counts by length 1..16, symbols)
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_add_quant_table`` with ``force_baseline``."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def huffman_codes(spec, size: int) -> tuple[np.ndarray, np.ndarray]:
    """(codes, code lengths) by symbol (ITU T.81 Annex C)."""
    counts, symbols = spec
    codes = np.zeros(size, np.uint16)
    lengths = np.zeros(size, np.uint8)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = code
            lengths[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.where(u == 0, np.sqrt(0.5), 1.0) / 2.0
    return c * np.cos((2 * x + 1) * u * np.pi / 16)


DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _quantize(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Level shift, DCT, quantisation (half away from zero), zigzag:
    (H/8, W/8, 64) int16."""
    coef = DCT @ (_blocks(plane.astype(np.float64)) - 128.0) @ DCT.T
    coef = coef.reshape(coef.shape[:2] + (64,))[..., ZIGZAG]
    q = table[ZIGZAG].astype(np.float64)
    out = np.sign(coef) * np.floor(np.abs(coef) / q + 0.5)
    return np.clip(out, -1023, 1023).astype(np.int16)


def _ycbcr(rgb: np.ndarray):
    """libjpeg's ``rgb_ycc_convert`` (16-bit fixed point)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + half - 1) >> 16
    return y, cb, cr


def _downsample_2x2(plane: np.ndarray) -> np.ndarray:
    """libjpeg's ``h2v2_downsample``: 2x2 sums with the bias 1, 2, 1, 2
    along each row, shifted right by 2."""
    s = (plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2]
         + plane[1::2, 1::2])
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias[None, :]) >> 2


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"JPEG: an (H, W, 3) uint8 image expected, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    # replicate the edges to whole 16x16 MCUs; decoders crop them
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    padded = np.pad(rgb, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    y, cb, cr = _ycbcr(padded)
    qy = quant_table(STD_LUMA_QT, quality)
    qc = quant_table(STD_CHROMA_QT, quality)
    by = _quantize(y, qy)                                 # (ph/8, pw/8, 64)
    bcb = _quantize(_downsample_2x2(cb), qc)              # (ph/16, pw/16, 64)
    bcr = _quantize(_downsample_2x2(cr), qc)
    my, mx = ph // 16, pw // 16
    # interleaved MCUs: Y00 Y01 Y10 Y11 Cb Cr
    luma = by.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    mcus = np.concatenate([luma, bcb[:, :, None], bcr[:, :, None]], axis=2)
    blocks = mcus.reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), my * mx)
    dc = [huffman_codes(s, 16) for s in (DC_LUMA, DC_CHROMA)]
    ac = [huffman_codes(s, 256) for s in (AC_LUMA, AC_CHROMA)]
    scan = native.jpeg_encode_blocks(
        blocks, comp, np.array([0, 1, 1], np.uint8),
        (np.stack([d[0] for d in dc]), np.stack([d[1] for d in dc])),
        (np.stack([a[0] for a in ac]), np.stack([a[1] for a in ac])))

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid, table in ((0, qy), (1, qc)):
        out.append(_segment(0xDB, bytes([tid]) + bytes(
            table[ZIGZAG].astype(np.uint8).tolist())))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, spec in ((0x00, DC_LUMA), (0x10, AC_LUMA), (0x01, DC_CHROMA),
                         (0x11, AC_CHROMA)):
        counts, symbols = spec
        out.append(_segment(0xC4, bytes([cls_id]) + bytes(counts)
                            + bytes(symbols)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                     0])))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, rgb: np.ndarray, quality: int = 95) -> None:
    Path(path).write_bytes(encode_jpeg(rgb, quality))


def jpeg_markers(data: bytes) -> list[int]:
    """The marker codes of a JPEG file up to its scan (SOS), then EOI if
    the file ends with it: enough to check a file's structure."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("JPEG: no SOI")
    markers, pos = [0xD8], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        markers.append(marker)
        pos += 2 + length
        if marker == 0xDA:
            break
    if data.endswith(b"\xff\xd9"):
        markers.append(0xD9)
    return markers
