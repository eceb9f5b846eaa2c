"""Scaled dot-product attention: the plain reference and the dispatch.

PyTorch counterpart of ``ladi_vton_tpu/ops/attention.py``.  All shapes
are (B, S, H, D): batch, sequence, heads, head_dim.

``attention_ref`` is the plain version of ``xla_attention``: fp32
logits, the scale applied in fp32, a causal mask of -1e9, softmax in
fp32, and the probabilities cast to v's dtype before the second product.
``dot_product_attention`` sends a CPU tensor to ``attention_ref`` and a
CUDA non-causal call to the hand-written flash kernel
(``ops.flash_attention``); causal attention (the CLIP text tower, off the
try-on path) stays plain.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention: einsum + softmax in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~keep, -1e9)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch: plain on a CPU tensor or when causal, flash kernel else."""
    if q.device.type == "cpu" or causal:
        return attention_ref(q, k, v, causal=causal, scale=scale)
    from ladi_vton_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, scale=scale)
