"""LayerNorm over the last axis: the plain version and the wrapper of K5.

Counterpart of ``ladi_vton_tpu/ops/layer_norm.py``.  ``layer_norm_ref``
follows ``layer_norm_xla`` step for step: fp32 mean, the centred variance,
``rsqrt(var + eps)``, the affine in fp32, one cast back.  ``layer_norm``
runs it for a CPU tensor and otherwise launches the hand-written Hopper
kernel ``csrc/layer_norm.cu`` (see its header), the counterpart of
``layer_norm_pallas``, as ``layer_norm_plan`` lays it out.

On CUDA the input is bf16 with a contiguous last axis.  The rows may
have a stride: a 2-D input such as the adapter's CLS slice ``x[:, 0, :]``
is read in place through its row stride, with no copy; any other input
must be contiguous.  Weight and bias are bf16, as the towers hold them
on the card, and are read as they are.  The output is a new contiguous
tensor of the input's shape.

Weight and bias are checked by ``prepare``, which also builds the C
arguments that do not change between calls; ``layer_norm`` prepares on
every call, the ``LayerNorm`` module of ``models/layers.py`` once for as
long as its parameters stay where they are (``launch`` then checks only
what depends on x).

Where a gradient is wanted (or autocast is on), the call goes through
``LayerNormFn``, a ``torch.autograd.Function`` (``ops._autograd``) that
takes weight and bias as tensor inputs, so their gradients reach them:
its forward is the kernel's launch, and its backward recomputes
``layer_norm_ref`` and differentiates it for x, weight and bias, the
design of the JAX package's ``custom_vjp`` (``_ln_pallas_bwd``).  The
recompute is that design, not a fallback: the forward on the card is
always the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops._autograd import recompute_grads, through_function

MAX_CHANNELS = 1280
# the most 16-byte vectors a lane holds (the kernel's V)
MAX_VECTORS = 5
# warps the kernel's launch bound keeps resident on an SM (kMaxWarps x
# kMinBlocks in csrc/layer_norm.cu)
WARPS_PER_SM = 16
# warps a CTA in every plan: on an H100 within 6% of the fastest warp
# count at each of the path's shapes, within 2% at all but 12288 x 320
# (chip_smoke.py --sweep-layer-norm)
WARPS = 2

def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps)
    out = out * weight.float() + bias.float()
    return out.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerNormPlan:
    """How the kernel covers (rows, C).

    ``lanes`` (L) lanes share a row, each holding ``vectors`` (V) 16-byte
    vectors of it, so a warp holds 32 / L rows at once: a row group.
    ``grid`` CTAs of ``warps`` warps; warp k of the grid handles row
    groups k, k + grid * warps, ...; in a group, lane l takes row
    group * (32 / L) + l // L and its vectors l % L + i * L, i < V.
    """

    lanes: int
    vectors: int
    warps: int
    grid: int
    groups: int

    @property
    def rows_per_warp(self) -> int:
        return 32 // self.lanes

    @property
    def code(self) -> int:
        """lanes, vectors and warps as the C entry point takes them."""
        return self.lanes | self.vectors << 8 | self.warps << 16


def lanes_and_vectors(C: int) -> tuple[int, int]:
    """(L, V) for C channels: the fewest lanes a row (a power of two that
    divides 32) with at most ``MAX_VECTORS`` vectors a lane, which at the
    path's widths leaves no lane idle (320: 8 x 5, 640: 16 x 5, 1024:
    32 x 4, 1280: 32 x 5)."""
    nvec = C // 8
    lanes = 1
    while -(-nvec // lanes) > MAX_VECTORS:
        lanes *= 2
    return lanes, -(-nvec // lanes)


def grid_for(groups: int, warps: int, sms: int) -> int:
    """CTAs of ``warps`` warps for ``groups`` row groups: one per
    ``warps`` groups, at most one resident wave."""
    return max(1, min(-(-groups // warps), sms * (WARPS_PER_SM // warps)))


@functools.lru_cache(maxsize=None)
def layer_norm_plan(rows: int, C: int, row_stride: int,
                    sms: int = 132) -> LayerNormPlan:
    """The kernel's layout for ``rows`` rows of C channels read at a
    stride of ``row_stride`` elements, on a card of ``sms`` SMs.

    Lanes and vectors from ``lanes_and_vectors``; CTAs of ``WARPS``
    warps, one per two row groups up to one resident wave, so a small
    call spreads its rows over as many SMs as it has row groups to
    share.  On 132 SMs: 12288 x 320 runs 1056 CTAs (one wave; a warp
    takes one or two row groups of four rows), 154 x 1024 77 CTAs.

    Raises ValueError for what the kernel does not take: C not a multiple
    of 8 or above ``MAX_CHANNELS``, a row stride not a multiple of 8
    (16 bytes).
    """
    if C <= 0 or C % 8 or C > MAX_CHANNELS or row_stride % 8:
        raise ValueError(f"layer_norm: unsupported C={C} or row stride "
                         f"{row_stride} (C % 8 == 0, C <= {MAX_CHANNELS}, "
                         f"16-byte aligned rows)")
    lanes, vectors = lanes_and_vectors(C)
    groups = -(-rows // (32 // lanes))
    return LayerNormPlan(lanes, vectors, WARPS, grid_for(groups, WARPS, sms),
                         groups)


class _Args(ctypes.Structure):
    # LadiLnParams in csrc/layer_norm.cu
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("C", ctypes.c_int), ("eps", ctypes.c_float),
                ("pdl", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class Prepared:
    """Weight and bias checked for the kernel, with the C arguments that
    stay the same between calls (``args``, passed by address)."""

    C: int
    device: int  # weight.get_device()
    sms: int
    args: _Args
    address: int


def prepare(weight: torch.Tensor, bias: torch.Tensor, eps: float, *,
            pdl: bool = True) -> Prepared:
    """Check weight and bias once: contiguous, 16-byte aligned, 1-D bf16
    of one shape, on one device that is not the CPU.  ``pdl`` launches
    with programmatic stream serialization (the kernel's default)."""
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dim() != 1 or not p.is_contiguous() or p.dtype != torch.bfloat16
                or p.data_ptr() % 16 or p.is_cpu):
            raise ValueError(f"layer_norm: {name} must be a contiguous, "
                             f"16-byte aligned 1-D bf16 tensor on the card")
    if weight.shape != bias.shape or weight.device != bias.device:
        raise ValueError(f"layer_norm: weight {tuple(weight.shape)} on "
                         f"{weight.device} and bias {tuple(bias.shape)} on "
                         f"{bias.device} differ")
    C = weight.shape[0]
    layer_norm_plan(1, C, C)  # raises for a C the kernel does not take
    args = _Args(weight.data_ptr(), bias.data_ptr(), C, eps, int(pdl))
    sms = _build.sm_count(weight.device) if weight.is_cuda else 0
    return Prepared(C, weight.get_device(), sms, args,
                    ctypes.addressof(args))


def launch(x: torch.Tensor, p: Prepared) -> torch.Tensor:
    """The kernel on x, with weight and bias prepared (``prepare``)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"layer_norm: the kernel takes bf16, got {x.dtype}")
    C = x.shape[-1]
    if C != p.C or x.get_device() != p.device:
        raise ValueError(f"layer_norm: x of {C} channels on {x.device} does "
                         f"not match weight and bias ({p.C} channels)")
    if x.dim() == 2 and x.stride(1) == 1:
        rows, stride = x.shape[0], x.stride(0)
    elif x.is_contiguous():
        rows, stride = x.numel() // C, C
    else:
        raise ValueError("layer_norm: the input must be contiguous, or 2-D "
                         "with a contiguous last axis")
    if x.data_ptr() % 16 or not x.is_cuda:
        raise ValueError("layer_norm: x must be a 16-byte aligned CUDA "
                         "tensor")
    plan = layer_norm_plan(rows, C, stride, p.sms)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if rows:
        _build.check(_build.library().ladi_layer_norm_fwd(
            x.data_ptr(), out.data_ptr(), rows, stride, p.address, plan.code,
            plan.grid, _build.stream_ptr(x)), "layer_norm")
        layer_norm.launches += 1
    return out


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float, prepared: Optional[Prepared] = None) -> torch.Tensor:
    """The kernel, with weight and bias as ``prepared`` (the ``LayerNorm``
    module's, made from these same tensors) or prepared for this call."""
    return launch(x, prepared or prepare(weight, bias, eps))


class LayerNormFn(torch.autograd.Function):
    """K5 with a gradient: the kernel's forward, the gradients of x,
    weight and bias from a recompute of ``layer_norm_ref`` (JAX
    ``_ln_pallas_bwd``)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, weight, bias, eps: float,
                prepared: Optional[Prepared] = None):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _launch(x, weight, bias, eps, prepared)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        def ref(x, weight, bias):
            return layer_norm_ref(x, weight, bias, eps=ctx.eps)

        return (*recompute_grads(ref, ctx.saved_tensors,
                                 ctx.needs_input_grad[:3], grad_out),
                None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Dispatch: plain on a CPU tensor, the Hopper kernel otherwise."""
    if x.is_cpu:
        return layer_norm_ref(x, weight, bias, eps=eps)
    if through_function(x, weight, bias):
        return LayerNormFn.apply(x, weight, bias, float(eps))
    return _launch(x, weight, bias, eps)


layer_norm.launches = 0
