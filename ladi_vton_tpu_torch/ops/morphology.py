"""Box dilation and erosion of masks as a max-pool.

Counterpart of ``ladi_vton_tpu/ops/morphology.py``, on tensors of shape
(H, W), HWC or NHWC.  ``iterations`` dilations by a ``kernel_size``
square equal one dilation by a square of ``iterations * (k - 1) + 1``,
which is taken as a max over that window, padded as the JAX op pads it:
``(half, eff - 1 - half)`` with ``half = (eff - 1) // 2``, with -inf for
floating masks and the dtype's minimum for integer ones.  A box max is
separable, so each spatial axis is one window max (``unfold`` then
``amax``), exact in every dtype.

The port's data layer dilates with its host C++ ``box_dilate``
(``data/native.py``), as the JAX data layer does; this op is for masks
already on a device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the (H, W) axes of each supported rank of shape
_SPATIAL = {2: (0, 1), 3: (0, 1), 4: (1, 2)}


def _fill(dtype: torch.dtype) -> float:
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def dilate(mask: torch.Tensor, kernel_size: int = 5,
           iterations: int = 1) -> torch.Tensor:
    """Dilation of an (H, W), HWC or NHWC mask by an all-ones square
    ``kernel_size`` kernel applied ``iterations`` times (cv2.dilate's
    box), as one max over the equivalent larger window."""
    if iterations <= 0:
        return mask
    if mask.ndim not in _SPATIAL:
        raise ValueError(f"unsupported mask ndim {mask.ndim}")
    eff = iterations * (kernel_size - 1) + 1
    half = (eff - 1) // 2
    out = mask
    for axis in _SPATIAL[mask.ndim]:
        # F.pad lists (before, after) pairs from the last axis backwards
        pads = [0, 0] * (mask.ndim - 1 - axis) + [half, eff - 1 - half]
        padded = F.pad(out, pads, value=_fill(mask.dtype))
        out = padded.unfold(axis, eff, 1).amax(-1)
    return out


def erode(mask: torch.Tensor, kernel_size: int = 5,
          iterations: int = 1) -> torch.Tensor:
    """Erosion, the dual of ``dilate``: ``-dilate(-mask)`` for floating
    masks, ``max - dilate(max - mask)`` for integer ones."""
    if iterations <= 0:
        return mask
    if mask.dtype.is_floating_point:
        return -dilate(-mask, kernel_size, iterations)
    top = mask.max()
    return top - dilate(top - mask, kernel_size, iterations)
