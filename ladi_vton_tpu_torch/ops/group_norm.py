"""GroupNorm (+ optional SiLU): the plain version and the wrapper of K2.

Counterpart of ``ladi_vton_tpu/ops/group_norm.py``.  ``group_norm_ref``
follows ``group_norm_xla`` step for step: per-channel fp32 sum and sum
of squares, combined per group, single-pass variance E[x^2] - mean^2,
then one per-channel affine and SiLU.  ``group_norm`` runs it for a CPU
tensor and otherwise launches the hand-written Hopper kernels in
``csrc/group_norm.cu`` (statistics, finalize, apply; see its header),
which replace both the one-pass and the two-pass Pallas kernels.

Inputs are (B, N, C) rows, or 4-D NCHW tensors that the kernel reads as
(B, H*W, C) rows: on CUDA they must be in ``torch.channels_last`` memory
format, which the towers keep.  The output has the input's layout.
"""

from __future__ import annotations

import torch

from ladi_vton_tpu_torch.ops import _build

MAX_CHANNELS = 4096


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


def _stats_chunks(B: int, N: int) -> int:
    """Row chunks per batch element for the statistics pass: about 64
    rows each, capped so B * chunks stays near 1024 blocks."""
    return max(1, min((N + 63) // 64, max(1, 1024 // B)))


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-6,
               act: str = "none") -> torch.Tensor:
    """Dispatch: plain on a CPU tensor, the Hopper kernel on CUDA."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm: unknown act {act!r}")
    if x.device.type == "cpu":
        return group_norm_ref(x, weight, bias, num_groups=num_groups,
                              eps=eps, act=act)
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
    chunks = _stats_chunks(B, N)
    ws = torch.empty((B, chunks, 2, C), dtype=torch.float32, device=x.device)
    coeffs = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    w32 = weight.to(device=x.device, dtype=torch.float32).contiguous()
    b32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(xr)
    lib = _build.library()
    stream = _build.stream_ptr(x)
    _build.check(lib.ladi_group_norm_stats(xr.data_ptr(), ws.data_ptr(), B, N,
                                           C, chunks, stream),
                 "group_norm stats")
    _build.check(lib.ladi_group_norm_finalize(
        ws.data_ptr(), w32.data_ptr(), b32.data_ptr(), coeffs.data_ptr(), B,
        N, C, num_groups, chunks, float(eps), stream), "group_norm finalize")
    _build.check(lib.ladi_group_norm_apply(
        xr.data_ptr(), coeffs.data_ptr(), out.data_ptr(), B, N, C,
        int(act == "silu"), stream), "group_norm apply")
    group_norm.launches += 1
    return _unrows(out, x)


group_norm.launches = 0
