"""Cross-attention-conditioned 2D UNet (SD-2- and SD-1.5-inpainting).

Counterpart of ``ladi_vton_tpu/models/unet_condition.py``: the denoiser
with LaDI-VTON's 31-channel input (4 noisy latent + 1 mask + 4
masked-image latent + 18 pose + 4 warped-cloth latent).  Blocks, channel
plan and heads follow the JAX module: SD-2 has C / head_dim heads (5,
10, 20 and 20 in the mid block) and linear projections; SD-1.5
(``sd15_unet_config``: ``head_dim <= 0``) has eight heads of C / 8 at
every width (head dims 40, 80, 160), a 768-wide context and 1x1-conv
projections.  Names are diffusers' ``UNet2DConditionModel`` keys.  Inputs and activations are NCHW in channels-last memory.
``precompute_context_kv`` computes the cross-attention K/V projections
of a context once, and ``forward(..., context_kv=...)`` takes them in
place of projecting the context at every call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ladi_vton_tpu_torch.models.layers import (
    BasicTransformerBlock,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 31
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    head_dim: int = 64  # <= 0: eight heads at every width (SD-1.5)
    cross_attention_dim: int = 1024
    use_linear_projection: bool = True
    norm_eps: float = 1e-5
    # which blocks carry cross-attention transformers (SD-2 pattern)
    down_block_has_attn: Sequence[bool] = (True, True, True, False)

    @property
    def up_block_has_attn(self) -> Sequence[bool]:
        return tuple(reversed(self.down_block_has_attn))


def sd2_unet_config(in_channels: int = 31) -> UNetConfig:
    """LaDI-VTON's extended SD-2 UNet (31 inputs with warped cloth)."""
    return UNetConfig(in_channels=in_channels)


def sd15_unet_config(in_channels: int = 31) -> UNetConfig:
    """SD-1.5-inpainting variant (cross_attention_dim 768, conv proj)."""
    return UNetConfig(
        in_channels=in_channels,
        cross_attention_dim=768,
        use_linear_projection=False,
        head_dim=-1,  # SD-1.5 uses 8 heads at every width
    )


class CrossAttnDownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb: int,
                 num_layers: int, heads: int, head_dim: int, ctx: int,
                 has_attn: bool, add_downsample: bool, eps: float,
                 linear: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb, eps=eps)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2D(heads, head_dim, out_channels, ctx, linear=linear)
            for _ in range(num_layers)] if has_attn else [])
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels, out_channels, padding=1)]
            if add_downsample else [])

    def forward(self, x, temb, context, kv_iter=None):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if len(self.attentions):
                x = self.attentions[i](x, context, kv_iter)
            skips.append(x)
        for down in self.downsamplers:
            x = down(x)
            skips.append(x)
        return x, skips


class CrossAttnUpBlock(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 temb: int, heads: int, head_dim: int, ctx: int,
                 has_attn: bool, add_upsample: bool, eps: float,
                 linear: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(c, out_channels, temb, eps=eps)
            for c in in_channels])
        self.attentions = nn.ModuleList([
            Transformer2D(heads, head_dim, out_channels, ctx, linear=linear)
            for _ in in_channels] if has_attn else [])
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels, out_channels)] if add_upsample else [])

    def forward(self, x, skips, temb, context, kv_iter=None):
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips.pop().to(x.dtype)], dim=1).contiguous(
                memory_format=torch.channels_last)
            x = resnet(x, temb)
            if len(self.attentions):
                x = self.attentions[i](x, context, kv_iter)
        for up in self.upsamplers:
            x = up(x)
        return x


class UNetMidBlockCrossAttn(nn.Module):
    def __init__(self, channels: int, temb: int, heads: int, head_dim: int,
                 ctx: int, eps: float, linear: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb, eps=eps)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(heads, head_dim, channels, ctx, linear=linear)])

    def forward(self, x, temb, context, kv_iter=None):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context, kv_iter)
        return self.resnets[1](x, temb)


class UNet2DCondition(nn.Module):
    """The denoiser: (sample NCHW, timesteps, encoder_hidden_states) -> eps
    as fp32 NCHW."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch = tuple(cfg.block_out_channels)
        n = len(ch)
        temb = ch[0] * 4
        eps = cfg.norm_eps
        ctx = cfg.cross_attention_dim
        lin = cfg.use_linear_projection

        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        # the skip stack's channels, in the order the down path pushes them
        skip_ch = [ch[0]]
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, out in enumerate(ch):
            self.down_blocks.append(CrossAttnDownBlock(
                prev, out, temb, cfg.layers_per_block, *self._heads(out),
                ctx, cfg.down_block_has_attn[i], i < n - 1, eps, lin))
            skip_ch += [out] * cfg.layers_per_block + ([out] if i < n - 1
                                                       else [])
            prev = out

        self.mid_block = UNetMidBlockCrossAttn(ch[-1], temb,
                                               *self._heads(ch[-1]), ctx,
                                               eps, lin)

        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(reversed(ch)):
            ins = []
            for _ in range(cfg.layers_per_block + 1):
                ins.append(prev + skip_ch.pop())
                prev = out
            self.up_blocks.append(CrossAttnUpBlock(
                ins, out, temb, *self._heads(out), ctx,
                cfg.up_block_has_attn[i], i < n - 1, eps, lin))

        self.conv_norm_out = GroupNorm(ch[0], 32, eps, act="silu")
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        self.gradient_checkpointing = False

    def _heads(self, channels: int) -> tuple[int, int]:
        """(heads, head dim) of a level ``channels`` wide."""
        if self.config.head_dim > 0:
            return channels // self.config.head_dim, self.config.head_dim
        return 8, channels // 8  # SD-1.5 style: fixed 8 heads

    def _run(self, block, *args):
        """``block(*args)``, checkpointed where the forward records
        gradients and ``gradient_checkpointing`` is set.  The blocks draw
        nothing (no dropout), so the recompute needs no generator state:
        ``preserve_rng_state=False``, which also keeps a CUDA graph's
        capture from reading the device generator."""
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return block(*args)

    def precompute_context_kv(self, encoder_hidden_states: torch.Tensor
                              ) -> list[tuple]:
        """Every cross-attention's (to_k, to_v) projection of the context,
        in call order, for hoisting out of the denoise loop: the same
        products the forward computes inline (the JAX package's
        ``precompute_context_kv``)."""
        context = encoder_hidden_states.to(self.conv_in.weight.dtype)
        return [m.attn2.project_kv(context) for m in self.modules()
                if isinstance(m, BasicTransformerBlock)]

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                context_kv: Optional[Sequence[tuple]] = None
                ) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        if (context_kv is not None and self.gradient_checkpointing
                and torch.is_grad_enabled()):
            raise ValueError("context_kv cannot be replayed by a "
                             "checkpointed forward")
        kv_iter = iter(context_kv) if context_kv is not None else None
        t_feat = timestep_embedding(timesteps,
                                    self.config.block_out_channels[0])
        temb = self.time_embedding(t_feat.to(dtype))
        context = encoder_hidden_states.to(dtype)
        h = self.conv_in(
            sample.to(dtype).contiguous(memory_format=torch.channels_last))
        skips = [h]
        for block in self.down_blocks:
            h, block_skips = self._run(block, h, temb, context, kv_iter)
            skips.extend(block_skips)
        h = self._run(self.mid_block, h, temb, context, kv_iter)
        for block in self.up_blocks:
            # the block pops its skips from a list of its own, so that a
            # checkpointed replay finds them again
            n = len(block.resnets)
            mine = skips[-n:]
            del skips[-n:]
            h = self._run(
                lambda h, *s, block=block: block(h, list(s), temb, context,
                                                 kv_iter), h, *mine)
        if kv_iter is not None and next(kv_iter, None) is not None:
            raise ValueError("context_kv has more entries than the UNet has "
                             "cross-attentions")
        h = self.conv_out(self.conv_norm_out(h))
        return h.float()
