"""Image files for the port's data layer, without PIL.

* ``open_image`` sniffs a file's content, as ``PIL.Image.open`` does, and
  never trusts its extension:

  - a PNG is decoded here: 8-bit L, LA, P, RGB or RGBA, not interlaced,
    any of the five row filters (un-filtered by the host C++,
    ``data/native.py``).  A P image keeps its palette indices as its
    pixels, as ``np.asarray(PIL.Image.open(path))`` gives them, and its
    palette beside them.  Anything else raises.
  - a baseline JPEG (sequential Huffman, 8 bits, 1 or 3 components,
    luma sampled 1x1, 2x1 or 2x2) is decoded here by the host C++
    (``csrc/host/jpeg_decode.cpp``), to the pixels PIL gives: libjpeg's
    integer IDCT, fancy upsampling and fixed-point YCbCr -> RGB.
  - any other JPEG (progressive, arithmetic-coded, 12-bit, Adobe/CMYK) is
    read from its decoded sidecar ``<file>.png`` (for example
    ``000000_0.jpg.png``), which holds the pixels PIL decodes from it,
    written losslessly by ``tools/decode_images.py`` where PIL is
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

# PNG colour type -> (mode, channels), 8 bits per sample
PNG_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
                   6: ("RGBA", 4)}
MODE_COLOR_TYPE = {mode: (ct, ch) for ct, (mode, ch) in
                   PNG_COLOR_TYPES.items()}


@dataclasses.dataclass
class Image:
    """Decoded pixels: (H, W) for L and P, (H, W, C) otherwise; ``palette``
    (n, 3) uint8 for P."""

    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None

    def resize(self, out_hw: tuple[int, int], method: str) -> "Image":
        """PIL's ``resize`` rules: P resizes only with NEAREST; LA and
        RGBA would need premultiplied alpha, which no path uses."""
        if self.mode == "P":
            method = resample.NEAREST
        elif self.mode in ("LA", "RGBA") and method != resample.NEAREST:
            raise NotImplementedError(f"resizing {self.mode} with {method}")
        return dataclasses.replace(
            self, pixels=resample.resize(self.pixels, out_hw, method))

    def convert_l(self) -> "Image":
        """PIL's ``convert("L")``."""
        if self.mode == "L":
            return self
        if self.mode == "LA":
            px = self.pixels[..., 0]
        elif self.mode in ("RGB", "RGBA"):
            px = resample.convert_l(self.pixels)
        elif self.mode == "P":
            px = resample.convert_l(self.palette)[self.pixels]
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
    if depth != 8 or color_type not in PNG_COLOR_TYPES or interlace:
        raise ValueError(f"PNG: unsupported format (bit depth {depth}, "
                         f"colour type {color_type}, interlace "
                         f"{interlace}); the reader takes 8-bit L, LA, P, "
                         f"RGB and RGBA, not interlaced")
    mode, channels = PNG_COLOR_TYPES[color_type]
    if mode == "P" and palette is None:
        raise ValueError("PNG: a palette image without PLTE")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = native.png_unfilter(raw, height, width * channels, channels)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return Image(rows.reshape(shape), mode, palette if mode == "P" else None)


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
            return Image(pixels, "L" if pixels.ndim == 2 else "RGB")
        side = sidecar_path(path)
        if not side.exists():
            raise FileNotFoundError(
                f"{path} is a JPEG the port's decoder does not read "
                f"(progressive, arithmetic-coded, 12-bit or Adobe/CMYK) and "
                f"has no decoded sidecar {side.name}: run "
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
