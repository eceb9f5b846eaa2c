"""GEGLU feed-forward: the plain version and the wrapper of kernel K4.

Counterpart of ``ladi_vton_tpu/ops/geglu.py``:
``x @ W1 + b1 -> split(h, g) -> h * gelu(g) -> @ W2 + b2``.  Weights are
in PyTorch's Linear layout, as diffusers stores them: ``w1`` (2I, C)
from ``ff.net.0.proj`` with the h rows first and the g rows second,
``w2`` (C, I) from ``ff.net.2``.

``geglu_ref`` follows ``geglu_xla``: the first product and b1 in x's
dtype, the exact-erf gate in fp32 cast back to x's dtype, the second
product and b2 in x's dtype.  ``geglu`` runs it for a CPU tensor and
otherwise launches the two hand-written Hopper kernels of
``csrc/geglu.cu`` (see its header).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ladi_vton_tpu_torch.ops import _build


def geglu_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain GEGLU with the exact-erf gelu."""
    dt = x.dtype
    proj = F.linear(x, w1.to(dt)) + b1.to(dt)
    h, gate = proj.chunk(2, dim=-1)
    g32 = gate.float()
    a = h * (0.5 * g32 * (1.0 + torch.erf(g32 * (1.0 / math.sqrt(2.0))))
             ).to(dt)
    return F.linear(a, w2.to(dt)) + b2.to(dt)


def geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Dispatch over (..., C): plain on a CPU tensor, kernels on CUDA."""
    if x.device.type == "cpu":
        return geglu_ref(x, w1, b1, w2, b2)
    C = x.shape[-1]
    I2 = w1.shape[0]
    inner = I2 // 2
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if (t.device != x.device or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"geglu: {name} must be contiguous, 16-byte "
                             f"aligned bf16 on {x.device}")
    if (w1.shape != (I2, C) or w2.shape != (C, inner) or b1.shape != (I2,)
            or b2.shape != (C,) or C % 64 or inner % 64):
        raise ValueError(f"geglu: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)} (C and I "
                         f"must be multiples of 64)")
    xf = x.reshape(-1, C)
    M = xf.shape[0]
    b1f = b1.to(dtype=torch.float32).contiguous()
    b2f = b2.to(dtype=torch.float32).contiguous()
    a = torch.empty((M, inner), dtype=x.dtype, device=x.device)
    y = torch.empty((M, C), dtype=x.dtype, device=x.device)
    lib = _build.library()
    stream = _build.stream_ptr(x)
    _build.check(lib.ladi_geglu_proj(xf.data_ptr(), w1.data_ptr(),
                                     b1f.data_ptr(), a.data_ptr(), M, C,
                                     inner, stream), "geglu proj")
    _build.check(lib.ladi_geglu_out(a.data_ptr(), w2.data_ptr(),
                                    b2f.data_ptr(), y.data_ptr(), M, inner, C,
                                    stream), "geglu out")
    geglu.launches += 1
    return y.reshape(x.shape)


geglu.launches = 0
