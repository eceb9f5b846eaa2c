"""The towers' dtype and device from the CLIs' flags.

``default_policy`` is the counterpart of ``ladi_vton_tpu/core/dtypes.py
default_policy``, as the one dtype the port needs: the CLIs load the
diffusion and CLIP towers in it (TPS and refinement stay fp32).  ``no``
is fp32; ``bf16`` and ``fp16`` are bf16, as in the JAX package (fp16
buys nothing bf16 does not and loses range).  ``resolve_device`` is the
mains' and the metrics' ``--device``: CUDA unless the caller asks for
the CPU, and no fallback where there is no card.
"""

from __future__ import annotations

import torch


def default_policy(mixed_precision: str = "bf16") -> torch.dtype:
    if mixed_precision in ("no", "fp32", None):
        return torch.float32
    if mixed_precision in ("bf16", "fp16", "bfloat16", "float16"):
        return torch.bfloat16
    raise ValueError(f"unknown mixed_precision: {mixed_precision!r}")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA where there is no card
    raises, before any work."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available; pass "
                           f"--device cpu to run on the CPU")
    return device
