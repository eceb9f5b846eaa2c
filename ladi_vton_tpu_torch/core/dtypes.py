"""The towers' dtype from the reference's ``--mixed_precision`` flag.

Counterpart of ``ladi_vton_tpu/core/dtypes.py default_policy``, as the
one dtype the port needs: the CLIs load the diffusion and CLIP towers in
it (TPS and refinement stay fp32).  ``no`` is fp32; ``bf16`` and ``fp16``
are bf16, as in the JAX package (fp16 buys nothing bf16 does not and
loses range).
"""

from __future__ import annotations

import torch


def default_policy(mixed_precision: str = "bf16") -> torch.dtype:
    if mixed_precision in ("no", "fp32", None):
        return torch.float32
    if mixed_precision in ("bf16", "fp16", "bfloat16", "float16"):
        return torch.bfloat16
    raise ValueError(f"unknown mixed_precision: {mixed_precision!r}")
