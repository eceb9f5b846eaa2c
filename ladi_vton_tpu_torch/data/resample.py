"""PIL-exact resampling and pixel operations on numpy images.

The port cannot import PIL, and the datasets must give the pixels the
JAX package's datasets get from it, so this module computes what
Pillow's C code computes, integer for integer:

* ``resize`` with ``BILINEAR`` or ``BICUBIC`` is ``Resample.c``: two
  passes, horizontal first, each rounded to uint8.  A pass scales the
  filter's support by ``max(in / out, 1)``; output pixel x reads the
  window ``[int(c - support + 0.5), int(c + support + 0.5))`` around
  ``c = (x + 0.5) * in / out``, clamped to the image; its weights are
  normalised to sum 1, then stored in fixed point with 22 fractional bits
  (rounded half away from zero); each sum starts at ``1 << 21`` and is
  shifted right by 22 and clipped to 0..255.  Bicubic uses a = -0.5.  A
  pass whose size does not change is skipped, as in PIL.
* ``resize`` of a 16-bit (uint16, PIL's ``I;16``) image with ``BILINEAR``
  or ``BICUBIC`` is ``Resample.c``'s 16bpc passes: the same windows and
  normalised weights, kept in float64; each sum starts at 0.0, adds pixel
  times weight in tap order, and is rounded half away from zero to an
  int; the low byte is ``CLIP8(n % 256)`` and the high byte
  ``CLIP8(n >> 8)`` (C's remainder and arithmetic shift), so a negative
  sum gives 0 and one above 65535 keeps its low byte under a high byte
  of 255.
* ``resize`` with ``NEAREST`` is ``Geometry.c ImagingScaleAffine``:
  source pixel ``int(xo)``, where ``xo`` starts at ``in / out / 2`` and
  grows by ``in / out`` per output pixel, summed in float64 in that
  order.  A uint16 image (``I;16``, a "special" type to PIL) takes
  ``ImagingGenericTransform`` instead: source pixel ``int((x + 0.5) *
  (in / out))``, each computed afresh.
* ``invert`` is ``255 - x``; ``convert_l`` is ITU-R 601-2 luma in
  Pillow's fixed point, ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``;
  ``cmyk_to_rgb`` is ``Convert.c cmyk2rgb``, ``from_l`` its ``l2rgb``,
  ``l2rgba`` and ``l2cmyk``; ``composite`` is ``Image.composite``'s
  blend, ``t = a m + b (255 - m) + 128`` then ``(t + (t >> 8)) >> 8``.

Images are (H, W) or (H, W, C) uint8 arrays, or (H, W) uint16 ones;
the channels of one pixel are resampled independently, as PIL does for
L, P and RGB images.  ``NEAREST`` takes any dtype (a ``bool`` image is
PIL's 1-bit ``1``).  PIL resizes P and 1 images only with NEAREST,
whatever the filter asked for (``imageio.Image.resize`` applies that
rule).
"""

from __future__ import annotations

import math

import numpy as np

NEAREST, BILINEAR, BICUBIC = "nearest", "bilinear", "bicubic"
PRECISION_BITS = 32 - 8 - 2
SUPPORT = {BILINEAR: 1.0, BICUBIC: 2.0}


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    # Resample.c bicubic_filter with a = -0.5, in its operation order
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


FILTERS = {BILINEAR: _bilinear, BICUBIC: _bicubic}


def weights(in_size: int, out_size: int, method: str):
    """(first source index (out,), normalised float64 weights (out,
    ksize)) of one pass, as ``precompute_coeffs`` computes them; the
    weights past a window's end are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT[method] * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = FILTERS[method](
        (taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
        * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):  # summed in tap order, as the C loop does
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total == 0.0, 1.0, total)[:, None], w)
    return xmin, w


def coefficients(in_size: int, out_size: int, method: str):
    """(first source index (out,), fixed-point weights (out, ksize)) of
    one pass, as ``precompute_coeffs`` and ``normalize_coeffs_8bpc``
    compute them."""
    xmin, w = weights(in_size, out_size, method)
    fixed = w * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5))
    return xmin, fixed.astype(np.int64)


def _pass(img: np.ndarray, axis: int, out_size: int, method: str):
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of (H, W, C).
    The sums fit int32, as in PIL (|sum| < 255 * 1.25 * 2^22)."""
    in_size = img.shape[axis]
    xmin, kk = coefficients(in_size, out_size, method)
    kk = kk.astype(np.int32)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        acc += np.take(img, idx, axis=axis) * kk[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass16(img: np.ndarray, axis: int, out_size: int, method: str):
    """One 16-bit pass (``ImagingResampleHorizontal_16bpc`` and its
    vertical twin) along ``axis`` of (H, W) uint16."""
    in_size = img.shape[axis]
    xmin, kk = weights(in_size, out_size, method)
    shape = [1, 1]
    shape[axis] = out_size
    ss = np.zeros(img.shape[:axis] + (out_size,) + img.shape[axis + 1:])
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        ss = ss + np.take(img, idx, axis=axis) * kk[:, k].reshape(shape)
    n = np.where(ss >= 0.0, ss + 0.5, ss - 0.5).astype(np.int64)
    low = np.clip(np.fmod(n, 256), 0, 255)
    high = np.clip(n >> 8, 0, 255)
    return (high * 256 + low).astype(np.uint16)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = float(in_size) / out_size
    xo = np.add.accumulate(np.concatenate(
        [[0.0 + step * 0.5], np.full(out_size - 1, step)]))
    return np.clip(xo.astype(np.int64), 0, in_size - 1)


def _nearest_index_16(in_size: int, out_size: int) -> np.ndarray:
    step = float(in_size) / out_size
    xo = (np.arange(out_size, dtype=np.float64) + 0.5) * step
    return np.clip(xo.astype(np.int64), 0, in_size - 1)


def resize(img: np.ndarray, out_hw: tuple[int, int],
           method: str = BICUBIC) -> np.ndarray:
    """``img`` (H, W) or (H, W, C) uint8, or (H, W) uint16, resized to
    ``out_hw`` = (height, width), as PIL's ``Image.resize((width,
    height), method)``; NEAREST takes any dtype."""
    oh, ow = out_hw
    h, w = img.shape[:2]
    if (h, w) == (oh, ow):
        return img.copy()
    if method == NEAREST:
        index = _nearest_index_16 if img.dtype == np.uint16 else \
            _nearest_index
        return img[index(h, oh)][:, index(w, ow)]
    if method not in FILTERS:
        raise ValueError(f"unknown resampling method {method!r}")
    if img.dtype == np.uint16 and img.ndim == 2:
        out = img
        if w != ow:
            out = _pass16(out, 1, ow, method)
        if h != oh:
            out = _pass16(out, 0, oh, method)
        return out
    if img.dtype != np.uint8:
        raise TypeError(f"resize with {method} takes uint8 images or "
                        f"(H, W) uint16 ones, got {img.dtype} {img.shape}")
    out = img if img.ndim == 3 else img[..., None]
    if w != ow:
        out = _pass(out, 1, ow, method)
    if h != oh:
        out = _pass(out, 0, oh, method)
    return out if img.ndim == 3 else out[..., 0]


def invert(img: np.ndarray) -> np.ndarray:
    """``ImageOps.invert`` of an L or RGB image."""
    return (255 - img.astype(np.int16)).astype(np.uint8)


def convert_l(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3+) uint8 -> (H, W) luma, as PIL's ``convert("L")``."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(H, W, 4) CMYK -> (H, W, 3) RGB, as PIL's ``convert("RGB")``:
    ``nk - c nk / 255`` (rounded as PIL's MULDIV255) with ``nk = 255 - k``."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def from_l(l: np.ndarray, mode: str) -> np.ndarray:
    """An L image's pixels in ``mode`` (L, RGB, RGBA or CMYK), as PIL's
    ``convert`` from L gives them."""
    if mode == "L":
        return l
    if mode == "RGB":
        return np.repeat(l[..., None], 3, axis=2)
    zero = np.zeros_like(l)
    if mode == "RGBA":
        return np.stack([l, l, l, zero + 255], axis=2)
    if mode == "CMYK":
        return np.stack([zero, zero, zero, 255 - l], axis=2)
    raise ValueError(f"cannot convert L to {mode}")


def composite(a: np.ndarray, b: np.ndarray, mask: np.ndarray,
              mode: str | None = None) -> np.ndarray:
    """``Image.composite(a, b, mask)``: ``a`` where the L ``mask`` is 255,
    ``b`` where it is 0, blended between.  The result has ``b``'s
    ``mode`` (L or RGB if not given, by its channels), and an L ``a`` is
    converted to it first (``from_l``), as PIL's ``paste`` converts."""
    if mode is None:
        mode = "L" if b.ndim == 2 else {3: "RGB"}[b.shape[2]]
    if a.ndim == 2 and mode != "L":
        a = from_l(a, mode)
    if a.shape != b.shape:
        raise ValueError(f"composite of {a.shape} over {b.shape} ({mode})")
    m = mask.astype(np.int32)
    if b.ndim == 3:
        m = m[..., None]
    t = a.astype(np.int32) * m + b.astype(np.int32) * (255 - m) + 128
    return ((t + (t >> 8)) >> 8).astype(np.uint8)
