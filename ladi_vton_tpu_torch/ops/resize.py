"""Image resizing with the JAX package's (torch-compatible) semantics.

Counterpart of ``ladi_vton_tpu/ops/resize.py``, on NCHW tensors:
``resize_bilinear`` is bilinear without antialiasing, computed in fp32,
and ``resize_nearest`` takes the floor of the source index with no
half-pixel shift.

``resize_bilinear`` follows the JAX op step for step rather than calling
``F.interpolate``: the source position of each output row and column is
computed on the host in float64, then each axis is two gathers and a
lerp in fp32.  ``F.interpolate`` computes the positions in fp32, which
at 512x384 -> 224x224 moves them by up to 3e-5 pixels and the output by
up to 7e-5 (``tests/test_torch_port_condition.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def _axis(in_size: int, out_size: int, align_corners: bool, device):
    """(lo, hi, weight) source indices and weights of one axis."""
    out = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = out * ((in_size - 1) / max(out_size - 1, 1))
    else:
        src = (out + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(w).to(device))


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *,
                    align_corners: bool = False) -> torch.Tensor:
    H, W = x.shape[-2:]
    OH, OW = out_hw
    if (H, W) == (OH, OW):
        return x
    acc = x.float()
    if H != OH:
        lo, hi, w = _axis(H, OH, align_corners, x.device)
        w = w[:, None]
        acc = acc.index_select(-2, lo) * (1.0 - w) + acc.index_select(
            -2, hi) * w
    if W != OW:
        lo, hi, w = _axis(W, OW, align_corners, x.device)
        acc = acc.index_select(-1, lo) * (1.0 - w) + acc.index_select(
            -1, hi) * w
    return acc.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    H, W = x.shape[-2:]
    OH, OW = out_hw
    if (H, W) == (OH, OW):
        return x
    iy = np.minimum(np.floor(np.arange(OH) * (H / OH)), H - 1)
    ix = np.minimum(np.floor(np.arange(OW) * (W / OW)), W - 1)
    iy = torch.as_tensor(iy.astype(np.int64), device=x.device)
    ix = torch.as_tensor(ix.astype(np.int64), device=x.device)
    return x.index_select(-2, iy).index_select(-1, ix)
