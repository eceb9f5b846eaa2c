"""LayerNorm over the last axis with fp32 statistics (plain only).

Counterpart of ``ladi_vton_tpu/ops/layer_norm.py layer_norm_xla``.  The
Pallas LayerNorm kernel is off the try-on path (the JAX transformer
blocks run ``ln_impl="xla"``), so the port has no kernel for it yet.
"""

from __future__ import annotations

import torch


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps)
    out = out * weight.float() + bias.float()
    return out.to(x.dtype)
