"""Image resizing with the JAX package's (torch-compatible) semantics.

Counterpart of ``ladi_vton_tpu/ops/resize.py``, on NCHW tensors:
``resize_bilinear`` is bilinear without antialiasing, computed in fp32,
and ``resize_nearest`` takes the floor of the source index with no
half-pixel shift.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *,
                    align_corners: bool = False) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    out = F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear",
                        align_corners=align_corners, antialias=False)
    return out.to(x.dtype)


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
