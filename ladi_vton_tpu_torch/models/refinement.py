"""Refinement UNet for the warped garment.

Counterpart of ``ladi_vton_tpu/models/refinement.py`` (the reference's
``UNet`` of ``unet_parts``): a 4-down/4-up UNet with bilinear
upsampling that refines the grid-sampled cloth from masked person (3),
pose (18) and warped cloth (3) to 3 channels.  NCHW; BatchNorm in eval
mode with eps 1e-5.  Module names follow the reference
(``inc.double_conv.N``, ``downK.maxpool_conv.1.double_conv.N``,
``upK.conv.double_conv.N``, ``outc.conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ladi_vton_tpu_torch.ops.resize import resize_bilinear


class DoubleConv(nn.Module):
    """(conv3x3 without bias -> BN -> ReLU) x 2."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1, bias=False),
            nn.BatchNorm2d(mid), nn.ReLU(),
            nn.Conv2d(mid, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Bilinear 2x (align_corners=True), pad to the skip, concatenate
    [skip, up], DoubleConv whose mid width is half the concatenated
    input's."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, in_channels // 2)

    def forward(self, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        H, W = h.shape[-2:]
        h = resize_bilinear(h, (2 * H, 2 * W), align_corners=True)
        dh = skip.shape[-2] - h.shape[-2]
        dw = skip.shape[-1] - h.shape[-1]
        if dh or dw:
            h = F.pad(h, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([skip, h], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNetVanilla(nn.Module):
    """The 4-level bilinear UNet (``bilinear=True`` as the reference
    trainer builds it)."""

    def __init__(self, in_channels: int = 24, out_channels: int = 3):
        super().__init__()
        self.inc = DoubleConv(in_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 512)
        self.up1 = Up(1024, 256)
        self.up2 = Up(512, 128)
        self.up3 = Up(256, 64)
        self.up4 = Up(128, 64)
        self.outc = OutConv(64, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        h = self.down4(x4)
        h = self.up1(h, x4)
        h = self.up2(h, x3)
        h = self.up3(h, x2)
        return self.outc(self.up4(h, x1))
