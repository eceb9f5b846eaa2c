"""CLIP text and vision towers as ``nn.Module``s.

Counterpart of ``ladi_vton_tpu/models/clip.py``: the SD-2 text encoder
(1024 hidden, 23 layers, 16 heads, exact gelu) with the ``embed`` /
``forward_embeds`` split that pseudo-token injection needs
(``diffusion.text``), and the ViT-H/14 vision encoder (1280 hidden, 32
layers, 16 heads, patch 14 at 224) returning ``last_hidden_state``.

Module and parameter names are transformers' state-dict keys
(``text_model.encoder.layers.N.self_attn.q_proj``, ``mlp.fc1``, ...), so
a state dict converted from the JAX towers (``core.checkpoint``
``clip_text_key_map`` / ``clip_vision_key_map``) loads with
``load_state_dict(strict=True)``.  Like the JAX vision tower, the vision
tower has no ``post_layernorm``: the try-on path reads the last hidden
state, and the inversion adapter brings its own post-norm.

Every LayerNorm goes through ``ops.layer_norm`` (kernel K5 on CUDA).
Attention stays the plain ``attention_ref`` (causal for text), as the
JAX towers route ``impl="xla"``.  The vision tower takes NCHW pixels,
CLIP-normalised, (B, 3, 224, 224).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ladi_vton_tpu_torch.models.layers import LayerNorm
from ladi_vton_tpu_torch.ops.attention import attention_ref


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    intermediate_size: int = 5120
    image_size: int = 224
    patch_size: int = 14
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5


def sd2_text_config() -> CLIPTextConfig:
    return CLIPTextConfig()


def sd15_text_config() -> CLIPTextConfig:
    return CLIPTextConfig(hidden_size=768, num_hidden_layers=12,
                          num_attention_heads=12, intermediate_size=3072,
                          hidden_act="quick_gelu")


def vit_h_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig()


def vit_l_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(hidden_size=1024, num_hidden_layers=24,
                            intermediate_size=4096, hidden_act="quick_gelu")


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)  # exact erf
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown activation {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, causal: bool):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, C = x.shape
        shape = (B, S, self.num_heads, C // self.num_heads)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        out = attention_ref(q, k, v, causal=self.causal)
        return self.out_proj(out.reshape(B, S, C))


class CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(activation(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-norm block: LN -> attention, LN -> MLP, both residual."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, hidden_act: str, causal: bool,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden_size, layer_norm_eps)
        self.self_attn = CLIPAttention(hidden_size, num_heads, causal)
        self.layer_norm2 = LayerNorm(hidden_size, layer_norm_eps)
        self.mlp = CLIPMLP(hidden_size, intermediate_size, hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


def encoder_layer(config, causal: bool) -> CLIPEncoderLayer:
    return CLIPEncoderLayer(config.hidden_size, config.num_attention_heads,
                            config.intermediate_size, config.hidden_act,
                            causal, config.layer_norm_eps)


class CLIPEncoder(nn.Module):
    def __init__(self, config, causal: bool):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer(config, causal)
                                     for _ in range(config.num_hidden_layers)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h)
        return h


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(config)
        self.encoder = CLIPEncoder(config, causal=True)
        self.final_layer_norm = LayerNorm(config.hidden_size,
                                          config.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings only (no positions): the PTE splice point."""
        return self.text_model.embeddings.token_embedding(input_ids)

    def forward_embeds(self, inputs_embeds: torch.Tensor,
                       input_ids: torch.Tensor):
        """Positions, causal encoder and final LN over given embeddings.

        Returns (last_hidden_state, pooled_output), pooled at the first
        position of the largest id (the end-of-text token)."""
        tm = self.text_model
        S = inputs_embeds.shape[1]
        positions = torch.arange(S, device=inputs_embeds.device)
        h = inputs_embeds + tm.embeddings.position_embedding(positions)[None]
        h = tm.final_layer_norm(tm.encoder(h))
        eot = torch.argmax(input_ids, dim=-1)
        pooled = h[torch.arange(h.shape[0], device=h.device), eot]
        return h, pooled

    def forward(self, input_ids: torch.Tensor):
        return self.forward_embeds(self.embed(input_ids), input_ids)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        C = config.hidden_size
        self.class_embedding = nn.Parameter(torch.randn(C) * 0.02)
        self.patch_embedding = nn.Conv2d(3, C, config.patch_size,
                                         stride=config.patch_size, bias=False)
        num_pos = (config.image_size // config.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(num_pos, C)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        dtype = self.patch_embedding.weight.dtype
        patches = self.patch_embedding(pixel_values.to(dtype))
        patches = patches.flatten(2).transpose(1, 2)       # (B, P, C)
        B, _, C = patches.shape
        cls = self.class_embedding.to(dtype).expand(B, 1, C)
        h = torch.cat([cls, patches], dim=1)
        return h + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(config)
        self.pre_layrnorm = LayerNorm(config.hidden_size,
                                      config.layer_norm_eps)
        self.encoder = CLIPEncoder(config, causal=False)


class CLIPVisionModel(nn.Module):
    """Vision transformer; returns last_hidden_state (B, 1 + P, hidden)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        h = vm.pre_layrnorm(vm.embeddings(pixel_values))
        return vm.encoder(h)
