"""LayerNorm over the last axis: the plain version and the wrapper of K5.

Counterpart of ``ladi_vton_tpu/ops/layer_norm.py``.  ``layer_norm_ref``
follows ``layer_norm_xla`` step for step: fp32 mean, the centred variance,
``rsqrt(var + eps)``, the affine in fp32, one cast back.  ``layer_norm``
runs it for a CPU tensor and otherwise launches the hand-written Hopper
kernel ``csrc/layer_norm.cu`` (see its header), the counterpart of
``layer_norm_pallas``.

On CUDA the input is bf16 with a contiguous last axis.  The rows may
have a stride: a 2-D input such as the adapter's CLS slice ``x[:, 0, :]``
is read in place through its row stride, with no copy; any other input
must be contiguous.  Weight and bias are bf16, as the towers hold them
on the card, and are read as they are.  The output is a new contiguous
tensor of the input's shape.
"""

from __future__ import annotations

import torch

from ladi_vton_tpu_torch.ops import _build

MAX_CHANNELS = 1280


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps)
    out = out * weight.float() + bias.float()
    return out.to(x.dtype)


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(rows view, row stride in elements) of x, without a copy."""
    if x.stride(-1) != 1:
        raise ValueError("layer_norm: the last axis must be contiguous")
    if x.dim() == 2:
        return x, x.stride(0)
    if not x.is_contiguous():
        raise ValueError("layer_norm: an input of more than two dims must "
                         "be contiguous")
    return x.view(-1, x.shape[-1]), x.shape[-1]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Dispatch: plain on a CPU tensor, the Hopper kernel on CUDA."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, eps=eps)
    C = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"layer_norm: the kernel takes bf16, got {x.dtype}")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.device != x.device or p.shape != (C,) or not p.is_contiguous()
                or p.dtype != torch.bfloat16 or p.data_ptr() % 16):
            raise ValueError(f"layer_norm: {name} must be a contiguous, "
                             f"16-byte aligned ({C},) bf16 tensor on "
                             f"{x.device}")
    xr, stride = _rows(x)
    if C % 8 or C > MAX_CHANNELS or stride % 8 or x.data_ptr() % 16:
        raise ValueError(f"layer_norm: unsupported C={C} (C % 8 == 0, C <= "
                         f"{MAX_CHANNELS}, 16-byte aligned rows)")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _build.check(_build.library().ladi_layer_norm_fwd(
        xr.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        xr.shape[0], C, stride, float(eps), _build.stream_ptr(x)),
        "layer_norm")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
