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

The index and weight tables of each (in size, out size, align_corners,
device) are built once and kept on the device (``_tables``): a copy from
host memory synchronises, and a CUDA graph cannot capture it, so the
first call at a size must come before any capture (the sampler's
warm-up makes it).
"""

from __future__ import annotations

import numpy as np
import torch


_tables: dict = {}


def device_cached(key: tuple, make):
    """``_tables[key]``, made by ``make()`` on the first call; refuses to
    make it while the current stream is being captured.  ``key`` ends
    with the device."""
    tables = _tables.get(key)
    if tables is None:
        device = key[-1]
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"tables {key} are not on the device yet, and a "
                f"copy from the host cannot be captured; run the call once "
                f"before capturing it")
        tables = _tables[key] = make()
    return tables


def _axis(in_size: int, out_size: int, align_corners: bool, device):
    """(lo, hi, weight) source indices and weights of one axis."""
    device = torch.device(device)
    return device_cached(
        ("bilinear", in_size, out_size, align_corners, device),
        lambda: _make_axis(in_size, out_size, align_corners, device))


def _make_axis(in_size: int, out_size: int, align_corners: bool, device):
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
    iy = _nearest(H, OH, x.device)
    ix = _nearest(W, OW, x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def _nearest(in_size: int, out_size: int, device) -> torch.Tensor:
    """Source indices of one axis: floor(i * in / out), clipped."""
    def make():
        idx = np.minimum(np.floor(np.arange(out_size) * (in_size / out_size)),
                         in_size - 1)
        return torch.as_tensor(idx.astype(np.int64), device=device)

    device = torch.device(device)
    return device_cached(("nearest", in_size, out_size, device), make)
