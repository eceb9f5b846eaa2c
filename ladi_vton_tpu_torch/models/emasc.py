"""EMASC: Enhanced Mask-Aware Skip Connection adapters.

Counterpart of ``ladi_vton_tpu/models/emasc.py``.  Per-scale adapters map
VAE-encoder features of the masked person into decoder injection
features: ``linear`` is one 3x3 conv, ``nonlinear`` conv-SiLU-conv.  Keys
are the reference module's: ``conv.<i>.*`` for the linear kind and
``conv.<i>.0.*`` / ``conv.<i>.2.*`` for the nonlinear one (the JAX
package's export writes ``conv.<i>.0.*`` for both; ``core.checkpoint
emasc_key_map`` renames them).  ``mask_features`` multiplies each feature
by (1 - mask) at its own resolution.  Tensors are NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ladi_vton_tpu_torch.ops.resize import resize_bilinear


def emasc_channels(vae_config) -> tuple:
    """(in_channels, out_channels) of the EMASC for a VAE architecture, as
    the JAX package's ``emasc_channels`` derives them: the five encoder
    taps (conv_in's output and the inputs of down blocks 0..2: b0, b0, b0,
    b1, b2) and the decoder's injection points (b0, b1, b2, b3, b3); for
    the SD-2 VAE the reference's plan."""
    b = tuple(vae_config.block_out_channels)
    return (b[0], b[0], b[0], b[1], b[2]), (b[0], b[1], b[2], b[3], b[3])


class EMASC(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (128, 128, 128, 256, 512),
                 out_channels: Sequence[int] = (128, 256, 512, 512, 512),
                 kernel_size: int = 3, kind: str = "nonlinear"):
        super().__init__()
        k, pad = kernel_size, kernel_size // 2
        if kind == "linear":
            def stage(i, o):
                return nn.Conv2d(i, o, k, padding=pad)
        elif kind == "nonlinear":
            def stage(i, o):
                return nn.Sequential(nn.Conv2d(i, i, k, padding=pad),
                                     nn.SiLU(),
                                     nn.Conv2d(i, o, k, padding=pad))
        else:
            raise NotImplementedError(f"EMASC kind {kind!r}")
        self.kind = kind
        self.conv = nn.ModuleList([stage(i, o) for i, o in
                                   zip(in_channels, out_channels)])

    def forward(self, features: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        if len(features) != len(self.conv):
            raise ValueError(f"expected {len(self.conv)} features, "
                             f"got {len(features)}")
        dtype = next(self.parameters()).dtype
        return [stage(f.to(dtype).contiguous(
            memory_format=torch.channels_last))
            for stage, f in zip(self.conv, features)]


def mask_features(features: Sequence[torch.Tensor],
                  mask: torch.Tensor) -> list[torch.Tensor]:
    """Multiply each NCHW feature by (1 - mask) resized to its resolution.

    ``mask`` is (B, 1, H, W) with 1 = region to inpaint.
    """
    out = []
    for feat in features:
        m = resize_bilinear(mask.to(feat.dtype), tuple(feat.shape[2:]))
        out.append(feat * (1.0 - m))
    return out
