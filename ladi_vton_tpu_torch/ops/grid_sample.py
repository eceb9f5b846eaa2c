"""Bilinear grid sampling (the TPS warp apply), NHWC at its edges.

Counterpart of ``ladi_vton_tpu/ops/grid_sample.py``, which re-implements
``F.grid_sample`` for JAX as four gathers and a weighted sum; it is plain
XLA code and no Pallas kernel, so here ``F.grid_sample`` computes it, in
fp32.  ``grid[..., 0]`` is x over the width and ``grid[..., 1]`` y over
the height, both in [-1, 1].

The two clamp in different places for ``padding_mode="border"``: the JAX
op clamps the four corner indices, torch clamps the coordinate.  Outside
the image both give the edge pixel, since two corners clamped to the same
index take weights that sum to one; the tests hold them equal with grids
reaching past [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor, *,
                padding_mode: str = "border",
                align_corners: bool = False) -> torch.Tensor:
    """Sample ``image`` (B, H, W, C) at ``grid`` (B, Hg, Wg, 2).

    Returns (B, Hg, Wg, C) in the image's dtype; ``padding_mode`` is
    "border" or "zeros"."""
    if image.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2:
        raise ValueError(f"bad shapes: image {tuple(image.shape)}, grid "
                         f"{tuple(grid.shape)}")
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    out = F.grid_sample(image.permute(0, 3, 1, 2).float(), grid.float(),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1).to(image.dtype)
