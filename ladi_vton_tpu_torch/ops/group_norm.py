"""GroupNorm (+ optional SiLU): the plain version and the wrapper of K2.

Counterpart of ``ladi_vton_tpu/ops/group_norm.py``.  ``group_norm_ref``
follows ``group_norm_xla`` step for step: per-channel fp32 sum and sum
of squares, combined per group, single-pass variance E[x^2] - mean^2,
then one per-channel affine and SiLU.  ``group_norm`` runs it for a CPU
tensor and otherwise launches the hand-written Hopper kernel of
``csrc/group_norm.cu`` (see its header), which replaces both the one-pass
and the two-pass Pallas kernels: one cluster-resident launch where a
thread-block cluster holds the slab, a two-launch split form where none
does, as ``group_norm_plan`` decides.  Weight and bias go to the kernel as
stored, bf16 or fp32.

Inputs are (B, N, C) rows, or 4-D NCHW tensors that the kernel reads as
(B, H*W, C) rows: on CUDA they must be in ``torch.channels_last`` memory
format, which the towers keep.  The output has the input's layout.

Where a gradient is wanted (or autocast is on), the call goes through
``GroupNormFn``, a ``torch.autograd.Function`` (``ops._autograd``) for
both forms: its forward is the kernel's launch, and its backward
recomputes ``group_norm_ref`` and differentiates it for x, weight and
bias, the design of the JAX package's ``custom_vjp``
(``_gn_pallas_bwd``).  The recompute is that design, not a fallback:
the forward on the card is always the kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops._autograd import recompute_grads, through_function

MAX_CHANNELS = 4096
# the most dynamic shared memory a block may take on sm_90 (227 KB)
SMEM_LIMIT = 232448
# the largest portable cluster
MAX_CLUSTER = 8
# the split form's statistics launch runs in clusters of this many chunks
SPLIT_CLUSTER = 4
# the vector counts (channels per range / 8) the cluster-form kernel is
# instantiated for (``cluster_kernel`` in csrc/group_norm.cu, whose cases
# test_torch_port_ops.py holds against this list): those the try-on path's
# plans take; other channel counts take the split form
CLUSTER_VECTORS = (1, 2, 10, 15, 30)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) view of a (B, N, C) or NCHW tensor (no copy if
    channels-last)."""
    if x.dim() == 4:
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])
    return x


def _unrows(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 4:
        B, C, H, W = like.shape
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return out


def group_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   *, num_groups: int = 32, eps: float = 1e-6,
                   act: str = "none") -> torch.Tensor:
    """Plain GroupNorm[+SiLU] with the oracle's formula."""
    xr = _rows(x)
    B, N, C = xr.shape
    cg = C // num_groups
    xf = xr.float()
    ch_sum = xf.sum(dim=1)                      # (B, C)
    ch_sq = (xf * xf).sum(dim=1)                # (B, C)
    count = N * cg
    g_mean = ch_sum.reshape(B, num_groups, cg).sum(-1) / count   # (B, G)
    g_sq = ch_sq.reshape(B, num_groups, cg).sum(-1) / count
    g_var = g_sq - g_mean * g_mean
    g_rstd = torch.rsqrt(g_var + eps)
    mean_c = g_mean.repeat_interleave(cg, dim=1)    # (B, C)
    rstd_c = g_rstd.repeat_interleave(cg, dim=1)
    a = rstd_c * weight.float()[None, :]
    b = bias.float()[None, :] - mean_c * a
    out = xf * a[:, None, :] + b[:, None, :]
    if act == "silu":
        out = out * torch.sigmoid(out)
    return _unrows(out.to(x.dtype), x)


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How the kernel covers a (B, N, C) call.

    ``form`` "cluster": one launch of B * (C / channels) clusters of
    ``cluster`` CTAs; a cluster owns one batch element's range of
    ``channels`` channels (whole groups) and CTA r of it rows
    [r * rows, (r + 1) * rows).  ``form`` "split": a statistics launch of
    ``ctas`` CTAs (``ctas / B`` chunks of ``rows`` rows per batch
    element, in clusters of ``cluster``) over all C channels, then an
    apply launch over the same chunks.
    """

    form: str
    cluster: int
    channels: int
    rows: int
    threads: int
    smem: int
    ctas: int

    @property
    def launches(self) -> int:
        return 1 if self.form == "cluster" else 2


def cluster_smem(rows: int, channels: int, groups: int, threads: int,
                 cluster: int) -> int:
    """Dynamic shared memory of a cluster-form CTA (``gn_cluster_kernel``):
    its rows in bf16, its barrier, weight and bias (room for fp32), then
    in fp32 every cluster CTA's partials, group stats and the per-warp
    partials."""
    return (rows * channels * 2 + 16 + 8 * channels
            + 4 * (cluster * 2 * channels + 2 * groups
                   + threads // 32 * 2 * channels))


def split_smem(C: int, groups: int, threads: int) -> int:
    """Dynamic shared memory of a split-form statistics CTA
    (``gn_split_stats_kernel``)."""
    return 4 * (4 * C + 2 * groups + 16 * threads + max(threads, 2 * C))


def cluster_wave(sms: int, cluster: int, threads: int, smem: int) -> int:
    """CTAs of a cluster launch that the card runs at once.  An SM holds
    228 KB of shared memory (1 KB of it reserved per block), 2048 threads
    and 64K registers (the kernel is bounded to 64 a thread).  Clusters
    live inside one GPC, so clusters of 4 and 8 leave about one SM in 16
    unused: on an H100 SXM (132 SMs) cudaOccupancyMaxActiveClusters gives
    30 clusters of 4 and 15 of 8 at one CTA per SM."""
    per_sm = min(2048 // threads, 65536 // (64 * threads),
                 233472 // (smem + 1024))
    usable = sms if cluster <= 2 else sms * 15 // 16
    return usable // cluster * cluster * per_sm


@functools.lru_cache(maxsize=None)
def group_norm_plan(B: int, N: int, C: int, sms: int = 132,
                    groups: int = 32) -> GroupNormPlan:
    """Pick the kernel's form and shape for a (B, N, C) call on a card
    of ``sms`` SMs.

    Cluster form wherever the whole tensor fits the shared memory of one
    wave of clusters (``cluster_wave``) of at most ``MAX_CLUSTER`` CTAs:
    each CTA holds its rows once, and nothing is read twice.  A channel
    range is a multiple of lcm(8, C / groups) that divides C (16-byte
    vectors of whole groups), of 8 x one of ``CLUSTER_VECTORS`` channels
    (a warp's lanes cover whole vector columns); up to 8 warps a CTA, no
    more than its rows need.  Among the ranges and cluster sizes that fit,
    the least bytes per SM win (a CTA's bytes x CTAs per SM), weighted by
    1.2 where rows are not whole 32-byte sectors (a range not a multiple
    of 16 channels) and by 1.3 where a CTA is too large for two on an SM;
    then the smaller cluster (a cheaper exchange), then the wider range.
    The weights, and 8 warps rather than 16, come from timing the kernel
    under other plans on an H100 while designing it (a 40-channel range's
    80-byte rows cost about a fifth more than 80 channels' 160);
    ``chip_smoke.py --sweep-group-norm`` times every instantiated plan
    that fits, and the pick is within 4% of the fastest at each of its
    shapes.  On 132 SMs (4, 3072, 320) takes 4 ranges of 80 channels in
    clusters of 8: 128 CTAs of 61 KB of rows.

    Split form otherwise (the VAE's large slabs; (4, 3072, 960), whose
    32 ranges of 737 KB no wave of clusters holds): four statistics CTAs
    of up to 512 threads per SM (``SPLIT_CLUSTER`` chunks of each batch
    element per SM), so every SM streams the same share.
    """
    cg = C // groups
    granule = math.lcm(8, cg)
    best = None
    for channels in range(granule, min(C, 256) + 1, granule):
        if C % channels or channels // 8 not in CLUSTER_VECTORS:
            continue
        V = channels // 8
        for cluster in (1, 2, 4, MAX_CLUSTER):
            rows = -(-N // cluster)
            warps = min(8, -(-rows // (32 // V)))
            threads = 32 * warps
            smem = cluster_smem(rows, channels, channels // cg, threads,
                                cluster)
            ctas = B * (C // channels) * cluster
            if (smem > SMEM_LIMIT
                    or ctas > cluster_wave(sms, cluster, threads, smem)):
                continue
            # bytes per SM, weighted by what the H100 measurements cost
            cost = (-(-ctas // sms) * rows * channels
                    * (1.2 if channels % 16 else 1.0)
                    * (1.3 if 2 * smem > SMEM_LIMIT else 1.0))
            key = (cost, cluster, -channels)
            if best is None or key < best[0]:
                best = (key, GroupNormPlan("cluster", cluster, channels, rows,
                                           threads, smem, ctas))
    if best is not None:
        return best[1]
    TC = C // 8
    threads = TC * max(1, 512 // TC)
    # at least 64 rows a chunk: a CTA's fixed costs stay small against its
    # reads
    chunks = SPLIT_CLUSTER * max(1, min(-(-sms // B),
                                        N // (64 * SPLIT_CLUSTER)))
    return GroupNormPlan("split", SPLIT_CLUSTER, C, -(-N // chunks), threads,
                         split_smem(C, groups, threads), B * chunks)


@functools.lru_cache(maxsize=None)
def _check_placeable(device: torch.device, plan: GroupNormPlan) -> None:
    """Raise unless the card can hold one cluster of the plan's kernel."""
    split, cluster = plan.form == "split", plan.cluster
    threads, smem = plan.threads, plan.smem
    with torch.cuda.device(device):
        n = _build.library().ladi_group_norm_max_clusters(
            int(split), plan.channels, cluster, threads, smem)
    if n < 1:
        raise RuntimeError(
            f"group_norm: a cluster of {cluster} CTAs of {threads} threads "
            f"and {smem} bytes of shared memory cannot be placed on "
            f"{device} (cudaOccupancyMaxActiveClusters: {n})")


_counters: dict = {}


def _split_counters(device: torch.device, stream: int,
                    B: int) -> torch.Tensor:
    """Per-batch-element arrival counters of the split form: zero, and
    left zero by the kernel.  One set per stream: launches on one stream
    run one after another, so no two running launches share counters."""
    t = _counters.get((device, stream))
    if t is None or t.numel() < B:
        t = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
        _counters[(device, stream)] = t
    return t


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float, act: str) -> torch.Tensor:
    """The kernel on CUDA tensors (checked here); counts the launch."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"group_norm: the kernel takes bf16, got {x.dtype}")
    if x.dim() == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("group_norm: a 4-D input must be channels_last")
    elif x.dim() != 3 or not x.is_contiguous():
        raise ValueError("group_norm: expected contiguous (B, N, C) rows or "
                         "a channels_last NCHW tensor")
    xr = _rows(x)
    B, N, C = xr.shape
    if (C % 8 or C % num_groups or C > MAX_CHANNELS
            or x.data_ptr() % 16):
        raise ValueError(f"group_norm: unsupported C={C} with "
                         f"{num_groups} groups (C % 8 == 0, C <= "
                         f"{MAX_CHANNELS}, 16-byte aligned)")
    if (weight.dtype not in (torch.bfloat16, torch.float32)
            or bias.dtype != weight.dtype or weight.shape != (C,)
            or bias.shape != (C,) or not weight.is_contiguous()
            or not bias.is_contiguous() or weight.device != x.device
            or bias.device != x.device or weight.data_ptr() % 16
            or bias.data_ptr() % 16):
        raise ValueError(f"group_norm: weight and bias must be contiguous, "
                         f"16-byte aligned vectors of {C}, both bf16 or both "
                         f"fp32, on {x.device}")
    plan = group_norm_plan(B, N, C, _build.sm_count(x.device), num_groups)
    split = plan.form == "split"
    _check_placeable(x.device, plan)
    out = torch.empty_like(xr)
    lib = _build.library()
    stream = _build.stream_ptr(x)
    w_f32 = int(weight.dtype == torch.float32)
    silu = int(act == "silu")
    if split:
        chunks = plan.ctas // B
        ws = torch.empty((B, chunks // plan.cluster, 2, C),
                         dtype=torch.float32, device=x.device)
        coeffs = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
        _build.check(lib.ladi_group_norm_split(
            xr.data_ptr(), weight.data_ptr(), bias.data_ptr(), w_f32,
            ws.data_ptr(), _split_counters(x.device, stream, B).data_ptr(),
            coeffs.data_ptr(), out.data_ptr(), B, N, C, num_groups,
            float(eps), silu, chunks, plan.rows, plan.threads, plan.smem,
            stream), "group_norm split")
    else:
        _build.check(lib.ladi_group_norm_cluster(
            xr.data_ptr(), weight.data_ptr(), bias.data_ptr(), w_f32,
            out.data_ptr(), B, N, C, num_groups, float(eps), silu,
            plan.cluster, plan.channels, plan.rows, plan.threads, plan.smem,
            stream), "group_norm cluster")
    group_norm.launches += 1
    group_norm.forms[plan.form] += 1
    return _unrows(out, x)


class GroupNormFn(torch.autograd.Function):
    """K2/K3 with a gradient: the kernel's forward, the gradients of x,
    weight and bias from a recompute of ``group_norm_ref`` (JAX
    ``_gn_pallas_bwd``)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, weight, bias, num_groups: int, eps: float,
                act: str):
        ctx.save_for_backward(x, weight, bias)
        ctx.options = dict(num_groups=num_groups, eps=eps, act=act)
        return _launch(x, weight, bias, num_groups, eps, act)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        def ref(x, weight, bias):
            return group_norm_ref(x, weight, bias, **ctx.options)

        return (*recompute_grads(ref, ctx.saved_tensors,
                                 ctx.needs_input_grad[:3], grad_out),
                None, None, None)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-6,
               act: str = "none") -> torch.Tensor:
    """Dispatch: plain on a CPU tensor, the Hopper kernel on CUDA."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm: unknown act {act!r}")
    if x.device.type == "cpu":
        return group_norm_ref(x, weight, bias, num_groups=num_groups,
                              eps=eps, act=act)
    if through_function(x, weight, bias):
        return GroupNormFn.apply(x, weight, bias, num_groups, float(eps),
                                 act)
    return _launch(x, weight, bias, num_groups, eps, act)


group_norm.launches = 0
# calls by the form that ran them: "cluster" one launch, "split" two
group_norm.forms = {"cluster": 0, "split": 0}
