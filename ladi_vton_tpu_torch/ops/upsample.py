"""Nearest 2x upsampling then a 3x3 convolution, as four low-resolution
phase convolutions.

Counterpart of ``ladi_vton_tpu/ops/upsample.py``, in the port's layout:
NCHW tensors (channels-last memory) and the weight of an ``nn.Conv2d``
(O, C, 3, 3).  Nearest upsampling repeats each pixel twice along each
axis, so output pixel (2i + a, 2j + b) of the 3x3 convolution sees only
a 2x2 window of the low-resolution input, with the taps that land on
the same source pixel summed:

  rows, phase a = 0: source rows (i - 1, i), weights (W[0], W[1] + W[2])
  rows, phase a = 1: source rows (i, i + 1), weights (W[0] + W[1], W[2])

and the same over columns.  The four 2x2 phase kernels, stacked along
the output channels, run as one convolution at low resolution: 16 C O
multiply-adds per input pixel against the 36 C O of the 3x3 at high
resolution, and the upsampled input is never written; the phases
interleave into the output.  The result equals ``F.interpolate(x,
scale_factor=2, mode="nearest")`` then the convolution up to the
re-association of sums.  ``models.layers.Upsample2D`` keeps the
interpolate-then-convolve form: which one the card runs faster at each
site is measured by ``chip_smoke.py`` phase 2, and the routing is left
to that measurement.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _fold(w: torch.Tensor, dim: int) -> tuple:
    """The two phase kernels of a 3-tap axis ``dim`` of ``w``."""
    t0, t1, t2 = w.unbind(dim)
    return (torch.stack([t0, t1 + t2], dim),
            torch.stack([t0 + t1, t2], dim))


def phase_kernels(weight: torch.Tensor) -> torch.Tensor:
    """The four (O, C, 2, 2) phase kernels of ``weight``, stacked along O
    in the order (a, b) = (0, 0), (0, 1), (1, 0), (1, 1)."""
    return torch.cat([k for rows in _fold(weight, 2)
                      for k in _fold(rows, 3)])


def nearest_up2_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        folded: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``conv3x3(pad=1)(nearest_upsample_2x(x))``: x (B, C, H, W), weight
    (O, C, 3, 3), bias (O,) or None; returns (B, O, 2H, 2W) in
    channels-last memory.  ``folded``: ``phase_kernels(weight)``, for a
    caller that keeps it between calls.

    One convolution with padding 1 computes the four phases at once
    (4 O output channels, (H + 1) x (W + 1) positions): its position
    (r, s) reads source rows r - 1, r and columns s - 1, s, so phase
    (a, b)'s pixel (i, j) is its position (i + a, j + b)."""
    B, _, H, W = x.shape
    O = weight.shape[0]
    if folded is None:
        folded = phase_kernels(weight)
    y = F.conv2d(x, folded, None if bias is None else bias.repeat(4),
                 padding=1).permute(0, 2, 3, 1)
    out = y.new_empty((B, H, 2, W, 2, O))
    for p in range(4):
        a, b = divmod(p, 2)
        out[:, :, a, :, b] = y[:, a:a + H, b:b + W, p * O:(p + 1) * O]
    return out.view(B, 2 * H, 2 * W, O).permute(0, 3, 1, 2)
