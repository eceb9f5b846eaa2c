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
(B, S, H, D) tensor.  ``flash_plan`` picks the kernel's tiling from the
head dimension, one of ``SUPPORTED_HEAD_DIMS`` (any other raises), the
sequence lengths and the SMs the items are spread over; the wrapper
passes its ``block_q`` and ``block_k``, and the kernel takes only the
tilings it was compiled for.

Where a gradient is wanted (or autocast is on), the call goes through
``FlashAttention``, a ``torch.autograd.Function`` (``ops._autograd``):
its forward is the kernel's launch, and its backward recomputes
``attention_ref`` and differentiates it, the design of the JAX
package's ``custom_vjp`` (``_flash_bwd``).  The recompute is that
design, not a fallback: the forward on the card is always the kernel.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops._autograd import recompute_grads, through_function
from ladi_vton_tpu_torch.ops.attention import attention_ref

# the head dims the JAX package's UNet and VAE configurations reach: the
# SD-2 UNet's 64, the SD-1.5 UNet's eight heads at widths 320, 640 and
# 1280 (40, 80, 160), the VAE mid block's single head (512)
SUPPORTED_HEAD_DIMS = (40, 64, 80, 160, 512)

# shared memory a block may use on the H100 (227 KB), and the registers a
# consumer thread keeps beside its accumulators (addresses, row
# statistics, loop state) of those setmaxnreg gives it
SMEM_LIMIT = 232448
ACC_REG_RESERVE = 40
# H100 SXM
DEFAULT_SMS = 132


@dataclass(frozen=True)
class FlashPlan:
    """K1's tiling of one call (``csrc/flash_attention.cu``).

    ``panels`` are the column widths in which q, k and v reach shared
    memory, ``swizzles`` each panel's swizzle span in bytes (a TMA box's
    inner bytes); ``pv_widths`` the wgmma N of the P V products a consumer
    issues per 16 keys; ``block_q`` the q rows of a work item and
    ``block_k`` the K/V rows of a tile (the S tile's N); ``split`` whether
    the two consumers share an item's K/V tiles (and merge in shared
    memory) instead of taking 64 q rows each; ``kv_stages`` and
    ``q_stages`` the rings' depths; ``smem`` the bytes of dynamic shared
    memory; ``consumer_regs`` the registers setmaxnreg gives a consumer
    thread (232 beside one other consumer, 160 beside two), of which
    ``acc_regs`` hold S, O and the packed P.
    """

    head_dim: int
    panels: tuple
    swizzles: tuple
    pv_widths: tuple
    block_q: int
    block_k: int
    split: bool
    kv_stages: int
    q_stages: int
    smem: int
    consumer_regs: int
    acc_regs: int


def _up1024(n: int) -> int:
    return -(-n // 1024) * 1024


def _small_plan(d: int, block_k: int, block_q: int) -> FlashPlan:
    """The plan of ``flash_fwd_small_kernel<d, block_k, block_q>``: the
    mirror of ``Cols`` and ``Fit`` in the kernel's source (a CPU test
    compiles those and holds the two alike)."""
    split = block_q == 64
    consumers = 2 if split else block_q // 64
    last = 64 if d == 40 else d % 64
    panels = (64,) * ((d + 63) // 64 - 1) + (last,)
    row = 2 * sum(panels)  # bytes of a row in shared memory
    # short items (one 80-row tile) fetch more items ahead
    q_stages = ((2 if block_k == 80 else 1) if d == 160
                else 4 if block_k == 80 else 2)
    q_item = (1 if split else consumers) * 64 * row
    kv_tile = _up1024(block_k * row)
    exchange = 128 * (d // 2 + 4) * 4 if split else 0
    fixed = q_stages * q_item + exchange + 128 + 1024
    kv_stages = min(4, (SMEM_LIMIT - fixed) // (2 * kv_tile))
    pv = (40,) if d == 40 else (64 * (len(panels) - 1), last)
    return FlashPlan(
        head_dim=d, panels=panels, swizzles=tuple(2 * w for w in panels),
        pv_widths=pv, block_q=block_q, block_k=block_k, split=split,
        kv_stages=kv_stages, q_stages=q_stages,
        smem=fixed + 2 * kv_stages * kv_tile,
        consumer_regs=160 if consumers == 3 else 232,
        acc_regs=block_k // 2 + d // 2 + block_k // 4)


@functools.lru_cache(maxsize=None)
def flash_plan(head_dim: int, sq: int, sk: int, batch_heads: int = 1,
               sms: int = DEFAULT_SMS) -> FlashPlan:
    """K1's tiling for q and k of (batch * heads = ``batch_heads``, sq or
    sk, head_dim), its items spread over ``sms`` SMs.

    D = 64: one 64-wide panel, 128 q rows (two consumers of 64) against
    128-row K/V tiles in a three-stage ring.  D = 512: eight panels, 64 q
    rows, the two consumers splitting D, 32-row K/V tiles in two stages so
    that Q (64 KB), the ring (128 KB) and the partial-score exchange
    (32 KB) fit.  D = 40, 80, 160: 64-wide panels and a narrow last one
    (16 columns at 80, 32 at 160), P V at N = D; K/V tiles of 128 rows,
    or 80 where sk <= 80 (the 77-token context takes one n80 S tile).
    Items of 128 q rows, two consumers of 64; at D = 40 against 128-row
    tiles, 192 rows and three consumers, so that each K/V row TMA fetches
    serves more q rows (its 80-byte rows, not the products, pace D = 40).
    When those items would leave SMs idle, items of 64 q rows whose K/V
    tiles two consumers share (64-row tiles at D = 160) take their place:
    the split form is chosen where its rounds of items over the SMs,
    times the keys a consumer covers an item, are fewer (the eight heads
    at S = 768, and D = 160 at S <= 192, the 77-token context too).
    Memoised: the wrapper asks for a plan at every launch.
    """
    if head_dim == 64:
        return FlashPlan(64, (64,), (128,), (64,), 128, 128, False, 3, 2,
                         2 * 2 * 64 * 128 + 3 * 2 * 128 * 128 + 128 + 1024,
                         232, 128 // 2 + 64 // 2 + 128 // 4)
    if head_dim == 512:
        return FlashPlan(512, (64,) * 8, (128,) * 8, (256,), 64, 32, False,
                         2, 1,
                         64 * 1024 + 2 * 2 * 32 * 1024 + 4 * 128 * 16 * 4
                         + 64 + 1024,
                         232, 16 + 128 + 8)
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported head dim {head_dim} "
                         f"(head dim in {SUPPORTED_HEAD_DIMS})")
    if sk <= 80:
        pair = _small_plan(head_dim, 80, 128)
    else:
        pair = _small_plan(head_dim, 128, 192 if head_dim == 40 else 128)
    split = _small_plan(head_dim, 64 if head_dim == 160 else 128, 64)

    def cost(p: FlashPlan) -> int:
        items = math.ceil(sq / p.block_q) * batch_heads
        tiles = math.ceil(sk / p.block_k)
        mine = math.ceil(tiles / 2) if p.split else tiles
        return math.ceil(items / sms) * mine * p.block_k

    return split if cost(split) < cost(pair) else pair


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
    plan = flash_plan(D, Sq, Sk, B * H, _build.sm_count(q.device))
    lib = _build.library()
    err = lib.ladi_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq,
        Sk, D, *strides, float(scale), plan.block_q, plan.block_k,
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
