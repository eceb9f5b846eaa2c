"""PIL-exact resampling and pixel operations on uint8 numpy images.

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
* ``resize`` with ``NEAREST`` is ``Geometry.c ImagingScaleAffine``:
  source pixel ``int(xo)``, where ``xo`` starts at ``in / out / 2`` and
  grows by ``in / out`` per output pixel, summed in float64 in that
  order.
* ``invert`` is ``255 - x``; ``convert_l`` is ITU-R 601-2 luma in
  Pillow's fixed point, ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``;
  ``composite`` is ``Image.composite``'s blend, ``t = a m + b (255 - m) +
  128`` then ``(t + (t >> 8)) >> 8``.

Images are (H, W) or (H, W, C) uint8 arrays; the channels of one pixel
are resampled independently, as PIL does for L, P and RGB images.  PIL
resizes a P image only with NEAREST, whatever the filter asked for
(``imageio.Image.resize`` applies that rule).
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


def coefficients(in_size: int, out_size: int, method: str):
    """(first source index (out,), fixed-point weights (out, ksize)) of
    one pass, as ``precompute_coeffs`` and ``normalize_coeffs_8bpc``
    compute them."""
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


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = float(in_size) / out_size
    xo = np.add.accumulate(np.concatenate(
        [[0.0 + step * 0.5], np.full(out_size - 1, step)]))
    return np.clip(xo.astype(np.int64), 0, in_size - 1)


def resize(img: np.ndarray, out_hw: tuple[int, int],
           method: str = BICUBIC) -> np.ndarray:
    """``img`` (H, W) or (H, W, C) uint8 resized to ``out_hw`` = (height,
    width), as PIL's ``Image.resize((width, height), method)``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, got {img.dtype}")
    oh, ow = out_hw
    h, w = img.shape[:2]
    if (h, w) == (oh, ow):
        return img.copy()
    if method == NEAREST:
        return img[_nearest_index(h, oh)][:, _nearest_index(w, ow)]
    if method not in FILTERS:
        raise ValueError(f"unknown resampling method {method!r}")
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


def composite(a: np.ndarray, b: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``Image.composite(a, b, mask)``: ``a`` where the L ``mask`` is 255,
    ``b`` where it is 0, blended between.  An L ``a`` or ``b`` pasted with
    an RGB one is repeated across the channels first, as PIL converts L to
    RGB."""
    channels = max(x.shape[2] if x.ndim == 3 else 1 for x in (a, b))

    def widen(x):
        x = x.astype(np.int32)
        if channels > 1 and x.ndim == 2:
            x = np.repeat(x[..., None], channels, axis=2)
        return x

    a, b = widen(a), widen(b)
    m = mask.astype(np.int32)
    if a.ndim == 3:
        m = m[..., None]
    t = a * m + b * (255 - m) + 128
    return ((t + (t >> 8)) >> 8).astype(np.uint8)
