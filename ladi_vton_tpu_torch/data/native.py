"""ctypes binding of the data layer's host C++ (``csrc/host/*.cpp``:
``preprocess.cpp`` and the JPEG decoder ``jpeg_decode.cpp``).

The library is compiled at first use with the host C++ compiler (``$CXX``,
else ``g++`` or ``c++``) into ``build/host/<hash>/`` at the repository
root (git-ignored), keyed, as ``ops._build`` keys the kernels, by a hash
of the sources, the flags and the compiler, so an edited source rebuilds
and an unchanged one loads at once.  A failed build raises: there is no
numpy fallback on the path (``data/raster.py`` holds the numpy versions
the tests compare with).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

HOST_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
SOURCES = (HOST_CSRC / "preprocess.cpp", HOST_CSRC / "jpeg_decode.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIB_NAME = "libladi_host.so"


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler (g++ or c++, or $CXX) found: "
                       "it is needed to build "
                       "ladi_vton_tpu_torch/csrc/host/*.cpp")


def build() -> Path:
    """Compile the library unless the hashed build exists; its path."""
    cxx = _compiler()
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader (a
    # worker process) never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                           *(str(s) for s in SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {HOST_CSRC} with {cxx} failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    c_int, c_long, c_float = ctypes.c_int, ctypes.c_long, ctypes.c_float
    lib.keypoint_heatmaps.argtypes = [f32p, c_int, c_int, c_int, c_float,
                                      f32p]
    lib.draw_polyline.argtypes = [f32p, c_int, c_int, c_int, c_float, f32p]
    lib.box_dilate.argtypes = [f32p, c_int, c_int, c_int, c_int, f32p]
    lib.png_unfilter.argtypes = [u8p, c_int, c_int, c_int, u8p]
    lib.png_unfilter.restype = c_int
    lib.jpeg_encode_blocks.argtypes = [i16p, c_long, u8p, u8p, u16p, u8p,
                                       u16p, u8p, u8p, c_long]
    lib.jpeg_encode_blocks.restype = c_long
    lib.jpeg_decode_header.argtypes = [ctypes.c_char_p, c_long,
                                       ctypes.POINTER(c_int)]
    lib.jpeg_decode_header.restype = c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, c_long, u8p, c_long]
    lib.jpeg_decode.restype = c_int
    for name in ("keypoint_heatmaps", "draw_polyline", "box_dilate"):
        getattr(lib, name).restype = None
    return lib


def pose_heatmaps(keypoints: np.ndarray, shape: tuple[int, int],
                  sigma: float = 9.0) -> np.ndarray:
    """(N, H, W) gaussian heatmaps of (N, >=2) xy keypoints."""
    h, w = shape
    kp = np.ascontiguousarray(keypoints[:, :2], np.float32)
    out = np.empty((kp.shape[0], h, w), np.float32)
    library().keypoint_heatmaps(kp, kp.shape[0], h, w, float(sigma), out)
    return out


def draw_polyline(h: int, w: int, points: np.ndarray, width: float,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    if out is None:
        out = np.zeros((h, w), np.float32)
    pts = np.ascontiguousarray(points[:, :2], np.float32)
    library().draw_polyline(pts, pts.shape[0], h, w, float(width), out)
    return out


def box_dilate(mask: np.ndarray, kernel: int = 5,
               iterations: int = 5) -> np.ndarray:
    out = np.empty(mask.shape, np.float32)
    library().box_dilate(np.ascontiguousarray(mask, np.float32),
                         mask.shape[0], mask.shape[1], kernel, iterations,
                         out)
    return out


def png_unfilter(filtered: np.ndarray, height: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """Raw (height, row_bytes) bytes of PNG's filtered scanlines."""
    data = np.ascontiguousarray(filtered, np.uint8)
    if data.size != height * (row_bytes + 1):
        raise ValueError(f"PNG: {data.size} bytes of image data, expected "
                         f"{height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    err = library().png_unfilter(data, height, row_bytes, bpp, out)
    if err:
        raise ValueError(f"PNG: row {-err - 1} has an unknown filter type")
    return out


def jpeg_encode_blocks(blocks: np.ndarray, comp: np.ndarray,
                       table: np.ndarray, dc: tuple, ac: tuple) -> bytes:
    """The byte-stuffed entropy-coded segment of (n, 64) zigzag blocks;
    ``dc`` and ``ac`` are (codes, sizes) arrays of shape (2, 16) and
    (2, 256)."""
    blocks = np.ascontiguousarray(blocks, np.int16)
    cap = blocks.shape[0] * 64 * 8 + 1024
    out = np.empty(cap, np.uint8)
    n = library().jpeg_encode_blocks(
        blocks, blocks.shape[0], np.ascontiguousarray(comp, np.uint8),
        np.ascontiguousarray(table, np.uint8),
        np.ascontiguousarray(dc[0], np.uint16),
        np.ascontiguousarray(dc[1], np.uint8),
        np.ascontiguousarray(ac[0], np.uint16),
        np.ascontiguousarray(ac[1], np.uint8), out, cap)
    if n < 0:
        raise RuntimeError("JPEG: the entropy-coded segment overflowed")
    return out[:n].tobytes()


JPEG_UNSUPPORTED, JPEG_MALFORMED, JPEG_LOSSLESS_COLOR = 1, 2, 4


def jpeg_decode(data: bytes) -> Optional[np.ndarray]:
    """PIL's pixels of a JPEG, sequential or progressive (smoothed as
    libjpeg smooths it), Huffman or arithmetic-coded, or lossless
    Huffman-coded: (H, W) uint8 for one component, (H, W, 3) RGB for
    three, (H, W, 4) CMYK for four (PIL's inverted bytes); None for a
    JPEG the decoder refuses (``csrc/host/jpeg_decode.cpp`` lists what
    it reads and what it refuses).  A damaged file raises, and so does a
    lossless one whose colour libjpeg would have to convert."""
    lib = library()
    dims = (ctypes.c_int * 3)()
    err = lib.jpeg_decode_header(data, len(data), dims)
    if err == 0:
        h, w, c = dims
        out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
        err = lib.jpeg_decode(data, len(data), out, out.size)
        if err == 0:
            return out
    if err == JPEG_UNSUPPORTED:
        return None
    if err == JPEG_LOSSLESS_COLOR:
        raise ValueError("JPEG: a lossless frame in YCbCr or YCCK colour, "
                         "which libjpeg does not convert (PIL refuses it "
                         "too)")
    raise ValueError("JPEG: damaged or truncated file")
