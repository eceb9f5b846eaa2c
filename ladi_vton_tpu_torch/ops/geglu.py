"""GEGLU feed-forward: the plain version and the wrapper of kernel K4.

Counterpart of ``ladi_vton_tpu/ops/geglu.py``:
``x @ W1 + b1 -> split(h, g) -> h * gelu(g) -> @ W2 + b2``.  Weights are
in PyTorch's Linear layout, as diffusers stores them: ``w1`` (2I, C)
from ``ff.net.0.proj`` with the h rows first and the g rows second,
``w2`` (C, I) from ``ff.net.2``.

``geglu_ref`` follows ``geglu_xla``: the first product and b1 in x's
dtype, the exact-erf gate in fp32 cast back to x's dtype, the second
product and b2 in x's dtype.  ``geglu`` runs it for a CPU tensor and
otherwise launches the hand-written Hopper kernels of ``csrc/geglu.cu``
(see its header); the biases go to them as they are stored, bf16 or
fp32, and ``geglu_proj_tiling`` and ``geglu_out_tiling`` pick the tile
widths and the second product's contraction split.

Where a gradient is wanted (or autocast is on), the call goes through
``GEGLU``, a ``torch.autograd.Function`` (``ops._autograd``): its
forward is the kernels' launch, and its backward recomputes
``geglu_ref`` and differentiates it for x, w1, b1, w2 and b2, the
design of the JAX package's ``custom_vjp`` (``_geglu_bwd``).  The
recompute is that design, not a fallback: the forward on the card is
always the kernels.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops._autograd import recompute_grads, through_function


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


# the contraction per ring stage of the kernels
BLOCK_K = 64


@functools.lru_cache(maxsize=None)
def geglu_proj_tiling(rows: int, C: int, inner: int, sms: int = 132) -> int:
    """Accumulator width of the first product.

    256: h and g of 128 columns of a for a 128-row tile that both
    consumers share (64 rows each), taken when those tiles give every SM
    one and the contraction is at least 10 steps deep (C >= 640): that
    mode does not overlap the gate with the products, which costs most
    where the contraction is short.  Else 128: 64 columns for a 64-row
    tile, the consumers taking tiles in turn, one's gate overlapping the
    other's products; small row counts still fill the card.  On 132 SMs:
    128 at 12288 x 320 and 192 x 1280, 256 at 3072 x 640 and 768 x 1280
    (``chip_smoke.py --sweep-geglu``).
    """
    if (inner % 128 == 0 and C >= 10 * BLOCK_K
            and -(-rows // 128) * (inner // 128) >= sms):
        return 256
    return 128


@functools.lru_cache(maxsize=None)
def geglu_out_tiling(rows: int, C: int, inner: int,
                     sms: int = 132) -> tuple[int, int]:
    """(tile width, contraction splits) of the second product.

    Consumers take 64-row tiles of y, 256, 160, 128 or 64 columns wide
    (a width that divides C).  Where a width's tiles would keep fewer
    than half the SMs busy, the contraction over I may be split into
    parts of at least 4 steps (a divisor of I / 64) whose fp32 partials a
    second pass adds; the partials' traffic makes a split dear elsewhere.
    The choice minimises a cost model: waves of tiles over the SMs x
    steps per tile x (width + 32), the 32 standing for a step's fixed
    cost; ties go to fewer splits, then the wider tile.  On 132 SMs: 160
    and no split at 12288 x 320, 128 and none at 3072 x 640, 256 and 2 at
    768 x 1280, 256 and 8 at 192 x 1280.
    """
    m_tiles = -(-rows // 64)
    steps = inner // BLOCK_K
    best = None
    for bn in (256, 160, 128, 64):
        if C % bn:
            continue
        for split in range(1, steps + 1):
            if steps % split or (split > 1 and (
                    steps // split < 4 or 2 * m_tiles * (C // bn) >= sms)):
                continue
            tiles = m_tiles * (C // bn) * split
            cost = -(-tiles // sms) * (steps // split) * (bn + 32)
            key = (cost, split, -bn)
            if best is None or key < best[0]:
                best = (key, bn, split)
    return best[1], best[2]


def _launch(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The kernels on CUDA tensors (checked here); counts the launch."""
    C = x.shape[-1]
    I2 = w1.shape[0]
    inner = I2 // 2
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if (t.device != x.device or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"geglu: {name} must be contiguous, 16-byte "
                             f"aligned bf16 on {x.device}")
    for name, t in (("b1", b1), ("b2", b2)):
        if (t.device != x.device or not t.is_contiguous()
                or t.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"geglu: {name} must be a contiguous bf16 or "
                             f"fp32 vector on {x.device}")
    if (w1.shape != (I2, C) or w2.shape != (C, inner) or b1.shape != (I2,)
            or b2.shape != (C,) or C % 64 or inner % 64):
        raise ValueError(f"geglu: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)} (C and I "
                         f"must be multiples of 64)")
    xf = x.reshape(-1, C)
    M = xf.shape[0]
    sms = _build.sm_count(x.device)
    proj_bn = geglu_proj_tiling(M, C, inner, sms)
    bn, splits = geglu_out_tiling(M, C, inner, sms)
    a = torch.empty((M, inner), dtype=x.dtype, device=x.device)
    y = torch.empty((M, C), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, M, C), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = _build.library()
    stream = _build.stream_ptr(x)
    _build.check(lib.ladi_geglu_proj(
        xf.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        int(b1.dtype == torch.float32), a.data_ptr(), M, C, inner, proj_bn,
        stream), "geglu proj")
    _build.check(lib.ladi_geglu_out(
        a.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        int(b2.dtype == torch.float32), y.data_ptr(),
        None if partial is None else partial.data_ptr(), M, inner, C, bn,
        splits, stream), "geglu out")
    geglu.launches += 1
    return y.reshape(x.shape)


class GEGLU(torch.autograd.Function):
    """K4 with a gradient: the kernels' forward, the gradients of x, w1,
    b1, w2 and b2 from a recompute of ``geglu_ref`` (JAX ``_geglu_bwd``).
    """

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        return recompute_grads(geglu_ref, ctx.saved_tensors,
                               ctx.needs_input_grad, grad_out)


def geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Dispatch over (..., C): plain on a CPU tensor, kernels on CUDA."""
    if x.device.type == "cpu":
        return geglu_ref(x, w1, b1, w2, b2)
    if through_function(x, w1, b1, w2, b2):
        return GEGLU.apply(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)


geglu.launches = 0
