"""Flash attention (forward, non-causal): the wrapper of kernel K1.

Counterpart of ``ladi_vton_tpu/ops/flash_attention.py``.  On a CUDA
tensor it launches the hand-written Hopper kernel
``csrc/flash_attention.cu`` (see its header for the design); on a CPU
tensor it runs the plain ``attention_ref``.  Nothing falls back: a CUDA
call the kernel cannot take raises.

The kernel reads q, k and v through TMA tensor maps over their (batch,
head, seq) strides, so the (B, S, H, D) views that come straight out of
the projections need no copy; the head dimension must be contiguous and
the base and strides 16-byte aligned.  The output is a new contiguous
(B, S, H, D) tensor.  ``flash_tiling`` picks the kernel's tiling from
the head dimension.
"""

from __future__ import annotations

from typing import Optional

import torch

from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops.attention import attention_ref

SUPPORTED_HEAD_DIMS = (64, 512)


def flash_tiling(head_dim: int) -> tuple[int, int]:
    """(q rows, K/V rows) per block of the kernel compiled for head_dim.

    D = 64: 128 q rows (two consumer warpgroups of 64) against 128-row
    K/V tiles.  D = 512: 64 q rows, the two consumers splitting D, and
    32-row K/V tiles so that Q (64 KB), a two-stage K/V ring (128 KB) and
    the partial-score exchange (32 KB) fit in 227 KB of shared memory.
    """
    if head_dim == 64:
        return 128, 128
    if head_dim == 512:
        return 64, 32
    raise ValueError(f"flash_attention: unsupported head dim {head_dim} "
                     f"(head dim in {SUPPORTED_HEAD_DIMS})")


def _check(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    if t.device != ref.device or t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: {name} must be bf16 on "
                         f"{ref.device}, got {t.dtype} on {t.device}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be (B, S, H, D) "
                         f"with a contiguous head dim, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                         f"with strides in multiples of 8 elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention over (B, S, H, D) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale=scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if (k.shape != (B, Sk, H, D) or v.shape != k.shape
            or D not in SUPPORTED_HEAD_DIMS):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (head dim in "
                         f"{SUPPORTED_HEAD_DIMS})")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = []
    for t in (q, k, v, out):
        sb, ss, sh, _ = t.stride()
        strides += [sb, sh, ss]
    block_q, block_k = flash_tiling(D)
    lib = _build.library()
    err = lib.ladi_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq,
        Sk, D, *strides, float(scale), block_q, block_k,
        _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
