"""A PNG writer for the tests of the port's PNG reader, in numpy.

It writes what PIL cannot: every legal (colour type, bit depth) pair of
the PNG specification (grey at 1, 2, 4, 8 and 16 bits, palette at 1, 2,
4 and 8, RGB, grey+alpha and RGBA at 8 and 16), Adam7-interlaced or not,
with ``PLTE`` and ``tRNS`` where the type allows them, and any of the five
row filters per row.  Samples are packed as the specification packs them:
below 8 bits MSB first, each row padded to a byte; 16 bits big-endian.
It imports no PIL, so ``chip_smoke.py`` can write its timing file on a
machine without it.

    data = encode(samples, color_type=3, depth=4, interlace=True,
                  palette=palette, rng=np.random.default_rng(0))
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, legal bit depths)
COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
               3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
LEGAL = [(ct, d) for ct, (_, depths) in COLOR_TYPES.items() for d in depths]
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(rows, cols * channels) samples -> (rows, row bytes) uint8."""
    s = np.asarray(samples, np.int64)
    rows = s.shape[0]
    if depth == 16:
        return np.stack([s >> 8, s & 0xFF], axis=-1).reshape(
            rows, -1).astype(np.uint8)
    if depth == 8:
        return s.astype(np.uint8)
    per = 8 // depth
    cols = s.shape[1]
    padded = np.zeros((rows, -(-cols // per) * per), np.int64)
    padded[:, :cols] = s
    shifts = (8 - depth) - depth * np.arange(per)
    return (padded.reshape(rows, -1, per) << shifts).sum(axis=2).astype(
        np.uint8)


def filter_rows(raw: np.ndarray, bpp: int,
                types: Optional[np.ndarray] = None) -> bytes:
    """Each row of raw (rows, row bytes) filtered by its type (0 None, 1
    Sub, 2 Up, 3 Average, 4 Paeth), prefixed by it; without ``types``,
    the type of the least sum of absolute signed bytes (libpng's
    heuristic)."""
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
                      x - paeth]) & 0xFF
    if types is None:
        signed = np.where(cands > 127, 256 - cands, cands)
        types = signed.sum(axis=2).argmin(axis=0)
    rows = cands[types, np.arange(raw.shape[0])].astype(np.uint8)
    return np.concatenate([types.astype(np.uint8)[:, None], rows],
                          axis=1).tobytes()


def encode(samples: np.ndarray, color_type: int, depth: int, *,
           interlace: bool = False, palette: Optional[np.ndarray] = None,
           trns: Optional[bytes] = None, filters: Optional[int] = None,
           rng=None, level: int = 6) -> bytes:
    """A PNG of ``samples`` ((H, W) or (H, W, channels) ints below
    2^depth: palette indices for colour type 3).  ``palette`` (n, 3)
    uint8 is written as ``PLTE`` (required for type 3), ``trns`` as the
    raw ``tRNS`` body.  Each row (of each Adam7 pass) takes the filter
    ``filters``, or one drawn from ``rng``, else the one of the least sum
    of absolute signed bytes."""
    channels, depths = COLOR_TYPES[color_type]
    if depth not in depths:
        raise ValueError(f"colour type {color_type} at {depth} bits")
    s = np.asarray(samples, np.int64)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    if c != channels or s.min(initial=0) < 0 or s.max(initial=0) >> depth:
        raise ValueError(f"samples {s.shape} do not fit colour type "
                         f"{color_type} at {depth} bits")
    bpp = max(1, channels * depth // 8)
    passes = ([(s[r0::dr, c0::dc]) for r0, c0, dr, dc in ADAM7]
              if interlace else [s])
    raw = []
    for sub in passes:
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue  # an empty pass has no rows, not even filter bytes
        rows = pack_rows(sub.reshape(sub.shape[0], -1), depth)
        types = None
        if filters is not None:
            types = np.full(rows.shape[0], filters)
        elif rng is not None:
            types = rng.integers(0, 5, rows.shape[0])
        # the Up, Average and Paeth filters of a pass's first row see zeros
        raw.append(filter_rows(rows, bpp, types))
    out = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))]
    if palette is not None:
        out.append(chunk(b"PLTE", np.ascontiguousarray(
            palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(chunk(b"tRNS", trns))
    out.append(chunk(b"IDAT", zlib.compress(b"".join(raw), level)))
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def draw(rng, h: int, w: int, color_type: int, depth: int,
         smooth: bool = False) -> np.ndarray:
    """Random samples of a colour type and depth ((H, W) or (H, W, C));
    ``smooth`` gives slowly varying content, as photographs and masks
    have, so that every filter type finds use."""
    channels = COLOR_TYPES[color_type][0]
    top = (1 << depth) - 1
    if not smooth:
        out = rng.integers(0, top + 1, (h, w, channels))
    else:
        steps = rng.integers(-2, 3, (h, w, channels)) * max(1, top // 64)
        out = np.clip(np.cumsum(steps, axis=1) + top // 2, 0, top)
    return out[..., 0] if channels == 1 else out
