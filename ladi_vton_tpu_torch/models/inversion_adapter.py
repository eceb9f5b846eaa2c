"""Inversion adapter: CLIP vision features -> pseudo-word token embeddings.

Counterpart of ``ladi_vton_tpu/models/inversion_adapter.py``: N CLIP
encoder layers over the ViT-H/14 ``last_hidden_state``, the CLS token,
``post_layernorm``, then Linear-GELU-Dropout twice and a last Linear to
``num_vstar`` embeddings of the text width (SD-2: 1280 -> 5120 -> 5120 ->
16 x 1024).  Names follow the reference module (``encoder_layers.N``,
``post_layernorm``, ``layers.{0,3,6}``).  Dropout is off at inference.

The CLS slice ``x[:, 0, :]`` has a row stride; the LayerNorm kernel reads
it in place through that stride (``ops.layer_norm``).
"""

from __future__ import annotations

import torch
from torch import nn

from ladi_vton_tpu_torch.models.clip import CLIPVisionConfig, encoder_layer
from ladi_vton_tpu_torch.models.layers import LayerNorm


class InversionAdapter(nn.Module):
    def __init__(self, input_dim: int = 1280, hidden_dim: int = 5120,
                 output_dim: int = 1024 * 16, num_encoder_layers: int = 1,
                 dropout: float = 0.5,
                 vision_config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.encoder_layers = nn.ModuleList([
            encoder_layer(vision_config, causal=False)
            for _ in range(num_encoder_layers)])
        self.post_layernorm = LayerNorm(vision_config.hidden_size,
                                        vision_config.layer_norm_eps)
        self.layers = nn.Sequential(
            nn.Linear(input_dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
            nn.Linear(hidden_dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
            nn.Linear(hidden_dim, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.encoder_layers:
            x = layer(x)
        return self.layers(self.post_layernorm(x[:, 0, :]))
