"""Deterministic numpy rasterizers for mask/pose geometry.

The port's copy of ``ladi_vton_tpu/data/raster.py``.  The data path runs
the C++ versions of ``pose_heatmaps`` and ``draw_polyline``
(``data/native.py``); these are what the tests hold the C++ against,
and ``pose_keypoint_rects``, which the path runs as it is.

The reference rasterizes with PIL ImageDraw (rectangles for pose
points, ellipses for the neck, 45px round-joint lines for arms —
reference: src/dataset/dresscode.py:255-322) and computes gaussian
keypoint heatmaps (src/utils/posemap.py:6-34).  These are vectorized
numpy re-implementations with the same pixel semantics:

* rect/ellipse use PIL's inclusive integer bounding boxes,
* thick polylines are capsule unions (segment distance <= w/2), which
  matches PIL's ``joint='curve'`` round joints,
* coordinates are truncated via uint16 like the reference's
  ``.astype(np.uint16)`` casts.

All functions return float32 {0,1} masks of shape (H, W).
"""

from __future__ import annotations

import numpy as np


def _grid(h: int, w: int):
    ys, xs = np.mgrid[0:h, 0:w]
    return xs.astype(np.float32), ys.astype(np.float32)


def draw_rectangle(h: int, w: int, x0: float, y0: float, x1: float,
                   y1: float, out: np.ndarray | None = None) -> np.ndarray:
    """Filled rectangle with PIL's inclusive-integer-box semantics."""
    if out is None:
        out = np.zeros((h, w), np.float32)
    xi0, yi0 = int(np.floor(x0)), int(np.floor(y0))
    xi1, yi1 = int(np.floor(x1)), int(np.floor(y1))
    xi0, xi1 = max(xi0, 0), min(xi1, w - 1)
    yi0, yi1 = max(yi0, 0), min(yi1, h - 1)
    if xi1 >= xi0 and yi1 >= yi0:
        out[yi0:yi1 + 1, xi0:xi1 + 1] = 1.0
    return out


def draw_ellipse(h: int, w: int, x0: float, y0: float, x1: float,
                 y1: float, out: np.ndarray | None = None) -> np.ndarray:
    """Filled ellipse inscribed in the (inclusive) box, PIL-style."""
    if out is None:
        out = np.zeros((h, w), np.float32)
    cx = (x0 + x1) / 2.0
    cy = (y0 + y1) / 2.0
    rx = max((x1 - x0) / 2.0, 1e-6)
    ry = max((y1 - y0) / 2.0, 1e-6)
    xs, ys = _grid(h, w)
    inside = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1.0
    out[inside] = 1.0
    return out


def draw_polyline(h: int, w: int, points: np.ndarray, width: float,
                  out: np.ndarray | None = None) -> np.ndarray:
    """Thick polyline with PIL semantics: flat-capped segment
    rectangles + round disks at *interior* joints (``joint='curve'``).

    ``points``: (N, 2) xy, truncated to uint16 like the reference casts
    (dresscode.py:301-322).
    """
    if out is None:
        out = np.zeros((h, w), np.float32)
    pts = points.astype(np.uint16).astype(np.float32)
    if len(pts) < 2:
        return out
    xs, ys = _grid(h, w)
    r = width / 2.0
    covered = np.zeros((h, w), bool)
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        dx, dy = x1 - x0, y1 - y0
        seg_len_sq = dx * dx + dy * dy
        if seg_len_sq == 0:
            continue
        t = ((xs - x0) * dx + (ys - y0) * dy) / seg_len_sq
        px = x0 + t * dx
        py = y0 + t * dy
        dist_sq = (xs - px) ** 2 + (ys - py) ** 2
        covered |= (t >= 0.0) & (t <= 1.0) & (dist_sq <= r * r)
    # round joints at interior vertices only (flat end caps like PIL)
    for (jx, jy) in pts[1:-1]:
        covered |= (xs - jx) ** 2 + (ys - jy) ** 2 <= r * r
    out[covered] = 1.0
    return out


def keypoint_heatmap(kpoint: np.ndarray, shape: tuple[int, int],
                     sigma: float = 9.0) -> np.ndarray:
    """Gaussian heatmap around one xy keypoint, max-normalized.

    Matches reference src/utils/posemap.py:6-34: zero map when neither
    coordinate is positive; exp(-d^2 / sigma^2) normalized by its max.
    """
    h, w = shape
    if not np.any(kpoint > 0):
        return np.zeros((h, w), np.float32)
    x, y = float(kpoint[0]), float(kpoint[1])
    xs, ys = _grid(h, w)
    heat = np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (sigma ** 2))
    heat = heat / (heat.max() + np.finfo(np.float32).eps)
    return heat.astype(np.float32)


def pose_keypoint_rects(keypoints: np.ndarray, shape: tuple[int, int],
                        radius: float) -> np.ndarray:
    """Per-keypoint filled squares, (N, H, W). Keypoints with either
    coordinate <= 1 are skipped (reference dresscode.py:264)."""
    h, w = shape
    n = keypoints.shape[0]
    maps = np.zeros((n, h, w), np.float32)
    for i, (x, y) in enumerate(keypoints[:, :2]):
        if x > 1 and y > 1:
            draw_rectangle(h, w, x - radius, y - radius, x + radius,
                           y + radius, out=maps[i])
    return maps


def pose_heatmaps(keypoints: np.ndarray, shape: tuple[int, int],
                  sigma: float = 9.0) -> np.ndarray:
    """Stack of gaussian heatmaps, (N, H, W) — the model's pose_map."""
    return np.stack([
        keypoint_heatmap(kp[:2], shape, sigma) for kp in keypoints
    ]).astype(np.float32)
