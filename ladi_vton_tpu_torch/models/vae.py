"""EMASC-aware KL autoencoder (SD-2 VAE with feature taps and injection).

Counterpart of ``ladi_vton_tpu/models/vae.py``: the encoder also returns
its six intermediate features (input, post-conv_in, and the input of
every down block), and the decoder adds externally supplied features
(the EMASC outputs) before each up block, plus the ``int_layers`` 1/0
cases around conv_out.  Tensors are NCHW in channels-last memory; names
are diffusers' ``AutoencoderKL`` keys of the reference's fork (VAE
attention as ``query``/``key``/``value``/``proj_attn``).  Tiled encode
and decode are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ladi_vton_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    VAEAttention,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, eps=1e-6)
            for i in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels, out_channels, padding=0)]
            if add_downsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for down in self.downsamplers:
            x = down(x)
        return x


class UpDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, eps=1e-6)
            for i in range(num_layers)])
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels, out_channels)] if add_upsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for up in self.upsamplers:
            x = up(x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, eps=1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    """VAE encoder that also returns the features EMASC taps:
    [input, post-conv_in, input of down block 0..3]."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        ch = tuple(config.block_out_channels)
        n = len(ch)
        self.conv_in = nn.Conv2d(config.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock(ch[max(i - 1, 0)], ch[i],
                             config.layers_per_block, i < n - 1)
            for i in range(n)])
        self.mid_block = MidBlock(ch[-1])
        self.conv_norm_out = GroupNorm(ch[-1], config.norm_num_groups, 1e-6,
                                       act="silu")
        self.conv_out = nn.Conv2d(ch[-1], 2 * config.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor):
        feats = [x]
        h = self.conv_in(x)
        feats.append(h)
        for block in self.down_blocks:
            feats.append(h)
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h)), feats


class Decoder(nn.Module):
    """VAE decoder with additive EMASC feature injection (features come
    ordered by encoder index and are consumed reversed)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        rev = tuple(reversed(config.block_out_channels))
        n = len(rev)
        self.conv_in = nn.Conv2d(config.latent_channels, rev[0], 3,
                                 padding=1)
        self.mid_block = MidBlock(rev[0])
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock(rev[max(i - 1, 0)], rev[i],
                           config.layers_per_block + 1, i < n - 1)
            for i in range(n)])
        self.conv_norm_out = GroupNorm(rev[-1], config.norm_num_groups, 1e-6,
                                       act="silu")
        self.conv_out = nn.Conv2d(rev[-1], config.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor,
                intermediate_features: Optional[Sequence[torch.Tensor]] = None,
                int_layers: Optional[Sequence[int]] = None) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        feats_rev = (list(reversed(list(intermediate_features)))
                     if intermediate_features is not None else None)
        for i, block in enumerate(self.up_blocks):
            if feats_rev is not None and i < len(feats_rev):
                h = h + feats_rev[i].to(h.dtype)
            h = block(h.contiguous(memory_format=torch.channels_last))
        h = self.conv_norm_out(h)
        if feats_rev is not None and int_layers and 1 in int_layers:
            idx = len(int_layers) - 1 - list(int_layers).index(1)
            h = h + feats_rev[idx].to(h.dtype)
        h = self.conv_out(h.contiguous(memory_format=torch.channels_last))
        if feats_rev is not None and int_layers and 0 in int_layers:
            idx = len(int_layers) - 1 - list(int_layers).index(0)
            h = h + feats_rev[idx].to(h.dtype)
        return h


class AutoencoderKL(nn.Module):
    """KL VAE with quant/post-quant 1x1 convs and EMASC-aware decode."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.quant_conv.weight.dtype).contiguous(
            memory_format=torch.channels_last)

    def encode(self, x: torch.Tensor):
        """Returns (moments (B, 2*latent, h, w), intermediate features)."""
        h, feats = self.encoder(self._in(x))
        return self.quant_conv(h), feats

    def decode(self, z: torch.Tensor,
               intermediate_features: Optional[Sequence[torch.Tensor]] = None,
               int_layers: Optional[Sequence[int]] = None) -> torch.Tensor:
        z = self.post_quant_conv(self._in(z))
        return self.decoder(z, intermediate_features, int_layers)


class DiagonalGaussian:
    """Diagonal gaussian over NCHW moments (mean/logvar on channels)."""

    def __init__(self, moments: torch.Tensor):
        mean, logvar = moments.chunk(2, dim=1)
        self.mean = mean
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * noise; ``noise`` (NCHW) or drawn from
        ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device,
                                dtype=torch.float32)
        return self.mean + self.std * noise.to(self.mean.dtype)
