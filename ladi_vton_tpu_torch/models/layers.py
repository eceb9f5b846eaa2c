"""Shared building blocks of the diffusion towers, as ``nn.Module``s.

Counterpart of ``ladi_vton_tpu/models/layers.py``.  Activations are NCHW
tensors kept in ``torch.channels_last`` memory format, so cuDNN runs the
convolutions NHWC and the GroupNorm, attention and GEGLU kernels read
(B, H*W, C) rows as views.  Module and parameter names are the
reference/diffusers state-dict keys (``to_out.0``, ``ff.net.0.proj``,
``ff.net.2``, ``downsamplers.0.conv``, ...), so a converted or released
state dict loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ladi_vton_tpu_torch.ops.attention import dot_product_attention
from ladi_vton_tpu_torch.ops.geglu import geglu
from ladi_vton_tpu_torch.ops.group_norm import group_norm
from ladi_vton_tpu_torch.ops import layer_norm as ln


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep features in diffusers' SD convention
    (flip_sin_to_cos, no frequency shift, max period 10000)."""
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 MLP over sinusoidal features."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class GroupNorm(nn.Module):
    """GroupNorm over channels with fp32 statistics, optionally + SiLU
    (``ops.group_norm``: kernel K2 on CUDA)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5, act: str = "none"):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:  # the kernel reads (B, H*W, C) rows
            x = x.contiguous(memory_format=torch.channels_last)
        return group_norm(x, self.weight, self.bias,
                          num_groups=self.num_groups, eps=self.eps,
                          act=self.act)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics
    (``ops.layer_norm``: kernel K5 on CUDA).  Weight and bias are checked
    for the kernel on the first call on the card, and again only when
    their storage, dtype or device changes (``ops.layer_norm.prepare``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self._prepared = (None, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if x.is_cpu:
            return ln.layer_norm_ref(x, w, b, eps=self.eps)
        key = (w.data_ptr(), b.data_ptr(), w.dtype, b.dtype, w.device,
               b.device, self.eps)
        seen, prepared = self._prepared
        if key != seen:
            prepared = ln.prepare(w, b, self.eps)
            self._prepared = (key, prepared)
        return ln.launch(x, prepared)

    def __getstate__(self):
        # a copy or a pickle checks its own parameters again
        state = super().__getstate__()
        state["_prepared"] = (None, None)
        return state


class ResnetBlock2D(nn.Module):
    """norm-silu-conv x2 with optional time embedding and 1x1 shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 conv.  ``padding=0`` applies the asymmetric (0,1,0,1) pad
    of the VAE encoder; ``padding=1`` is the UNet form."""

    def __init__(self, channels: int, out_channels: int, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2,
                              padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1)).contiguous(
                memory_format=torch.channels_last)
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv (the JAX package computes the same
    math as four phase convolutions, a TPU layout trick)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(up.contiguous(memory_format=torch.channels_last))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels-last) -> (B, H*W, C) view."""
    B, C = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(B, -1, C)


def _unrows(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, H*W, C) -> NCHW view in channels-last memory."""
    B, C, H, W = like.shape
    return h.reshape(B, H, W, -1).permute(0, 3, 1, 2)


class VAEAttention(nn.Module):
    """Single-head self-attention block of the VAE mid block."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, eps)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _rows(self.group_norm(x))
        q = self.query(h)[:, :, None, :]
        k = self.key(h)[:, :, None, :]
        v = self.value(h)[:, :, None, :]
        out = dot_product_attention(q, k, v)[:, :, 0, :]
        return x + _unrows(self.proj_attn(out), x)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim),
                                     nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        B, Sq, _ = x.shape
        Sk = context.shape[1]
        H, D = self.heads, self.dim_head
        q = self.to_q(x).view(B, Sq, H, D)
        k = self.to_k(context).view(B, Sk, H, D)
        v = self.to_v(context).view(B, Sk, H, D)
        out = dot_product_attention(q, k, v).reshape(B, Sq, H * D)
        return self.to_out[0](out)


class GEGLUProj(nn.Module):
    """Holds ``proj`` (dim -> 2 * inner) under diffusers' ``ff.net.0``."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward dim -> 2*4*dim (gated gelu) -> dim
    (``ops.geglu``: kernel K4 on CUDA)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLUProj(dim, inner), nn.Dropout(0.0),
                                  nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        return geglu(x, proj.weight, proj.bias, out.weight, out.bias)


class BasicTransformerBlock(nn.Module):
    """LN->self-attn, LN->cross-attn, LN->GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer with linear projections (SD-2):
    GN -> proj_in -> blocks -> proj_out + skip."""

    def __init__(self, heads: int, dim_head: int, in_channels: int,
                 context_dim: int, depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(in_channels, 32, 1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim)
            for _ in range(depth)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(_rows(self.norm(x)))
        for block in self.transformer_blocks:
            h = block(h, context)
        return x + _unrows(self.proj_out(h), x)
