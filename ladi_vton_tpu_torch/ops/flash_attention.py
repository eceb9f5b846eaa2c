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
the head dimension, one of ``SUPPORTED_HEAD_DIMS``; any other raises.

Where a gradient is wanted (or autocast is on), the call goes through
``FlashAttention``, a ``torch.autograd.Function`` (``ops._autograd``):
its forward is the kernel's launch, and its backward recomputes
``attention_ref`` and differentiates it, the design of the JAX
package's ``custom_vjp`` (``_flash_bwd``).  The recompute is that
design, not a fallback: the forward on the card is always the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops._autograd import recompute_grads, through_function
from ladi_vton_tpu_torch.ops.attention import attention_ref

# the head dims the JAX package's UNet and VAE configurations reach: the
# SD-2 UNet's 64, the SD-1.5 UNet's eight heads at widths 320, 640 and
# 1280 (40, 80, 160), the VAE mid block's single head (512)
SUPPORTED_HEAD_DIMS = (40, 64, 80, 160, 512)


def flash_tiling(head_dim: int) -> tuple[int, int]:
    """(q rows, K/V rows) per block of the kernel compiled for head_dim.

    D = 40, 64, 80, 160: 128 q rows (two consumer warpgroups of 64), D
    padded to 64-column panels, against 128-row K/V tiles (64-row at
    D = 160, whose three panels make O 96 fp32 registers a thread).
    D = 512: 64 q rows, the two consumers splitting D, and 32-row K/V
    tiles so that Q (64 KB), a two-stage K/V ring (128 KB) and the
    partial-score exchange (32 KB) fit in 227 KB of shared memory.
    """
    if head_dim in (40, 64, 80):
        return 128, 128
    if head_dim == 160:
        return 128, 64
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """The kernel on CUDA tensors (checked here); counts the launch."""
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


class FlashAttention(torch.autograd.Function):
    """K1 with a gradient: the kernel forward, the gradients of q, k and v
    from a recompute of ``attention_ref`` (JAX ``_flash_bwd``)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        def ref(q, k, v):
            return attention_ref(q, k, v, scale=ctx.scale)

        return (*recompute_grads(ref, ctx.saved_tensors,
                                 ctx.needs_input_grad[:3], grad_out), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention over (B, S, H, D) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale=scale)
    if through_function(q, k, v):
        return FlashAttention.apply(q, k, v, float(scale))
    return _launch(q, k, v, scale)


flash_attention.launches = 0
