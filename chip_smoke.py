#!/usr/bin/env python3
"""Drive the PyTorch port's try-on path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep-geglu       # K4's device time per tiling
    python3 chip_smoke.py --sweep-group-norm  # K2's device time per plan
    python3 chip_smoke.py --sweep-layer-norm  # K5's device time per plan

Phases, each printing its numbers before the last line:

1. the card's name and power limit (``nvidia-smi``), then the build of
   the hand-written kernels under ``ladi_vton_tpu_torch/csrc`` into the
   git-ignored ``build/`` directory (one ``nvcc`` per source, in
   parallel), with its seconds;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: the kernel in bf16, the plain version
   in fp32 on the same bf16 inputs (TF32 off), max abs error against a
   stated limit; the kernel's, the plain version's (on the bf16 inputs)
   and one PyTorch library call's times from CUDA events over
   back-to-back calls (host launch cost included), the kernel's and the
   library call's device times from a CUDA graph of ten calls, and the
   bound: the least time the card could take for the call, with its
   share of the kernel's device time.  K2 runs at every form and cluster
   size of its plan, with bf16 parameters as the towers hold them (one
   row fp32), and K5 at every plan of the path plus a ragged row count
   and a width off the path; each of their rows checks that two calls are
   bitwise equal and counts the kernels one call runs (torch.profiler).
   K5 is also timed without its programmatic launch, and as the path
   runs it, behind a residual add, against the add then ``F.layer_norm``;
3. integration at full width: one level-0 ``Transformer2D`` (C=320,
   64x48, batch 4) and one VAE ``MidBlock`` (512 at 64x48) through the
   kernels on the card and through the plain versions on the CPU, same
   weights, relative L2 error against a stated limit; the whole sampler
   at full SD-2 width on a small 128x128 input (2 DDIM steps, CFG 7.5);
   the conditioner at full width and 2 layers per CLIP tower on a
   256x192 image (TPS at 256x192), on the card against the CPU;
4. the main path: a ``TryOnService`` at full SD-2 width (31-channel UNet,
   SD-2 VAE, EMASC) with seeded random bf16 weights, 512x384, DDIM-50,
   CFG 7.5, batch_size 2, answering three requests of 1, 2 and 2 images;
   each output is checked for shape, finiteness and range, and each
   kernel's launch counter must have risen during the requests; a census
   of the GroupNorm and LayerNorm calls of one 2-image request lists their
   shapes and K2's and K5's plan for each, and fails if phase 2 missed
   one of those plans;
5. raw requests: a ``ConditionService`` at full width (ViT-H/14 vision,
   SD-2 text, the SD-2 inversion adapter in bf16; TPS at 256x192 and the
   refinement at 512x384 in fp32; ``num_vstar`` 16) in front of the
   phase-4 service turns cloth, pose, masked person and category into
   the try-on inputs, for requests of 1 and 2 images; conditioning and
   total seconds and peak memory per request, every output checked, and
   K5 launched in both stages, K2's calls and kernel launches per
   request logged, and K5's census of each request checked as in phase
   4.  A deterministic word tokenizer stands in for the CLIP BPE
   tokenizer, whose vocabulary files the repository does not hold.

Phases 2 and 3 compare with TF32 off for matmuls and cuDNN; phases 4
and 5 serve with PyTorch's defaults (cuDNN TF32 allowed, matmul TF32
off), which the port leaves as they are: with cuDNN TF32 off, cuDNN runs
the fp32 refinement through FFT convolutions that take ~60x longer and
a ~20 GiB workspace (``tools/profile_raw_request.py``).

The line before the last is ``{"kernels": [...]}``, with the launches
of phase 5, the first (hottest) shape's times and, under ``shapes``,
every shape's; the last is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero without that line; it also
refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ladi_vton_tpu_torch.diffusion.schedulers import DDIMScheduler
from ladi_vton_tpu_torch.models.clip import (
    CLIPTextModel,
    CLIPVisionModel,
    sd2_text_config,
    vit_h_vision_config,
)
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.layers import (
    GroupNorm,
    LayerNorm,
    Transformer2D,
)
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.models.tps import ConvNetTPS
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    sd2_unet_config,
)
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, MidBlock, VAEConfig
from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops import layer_norm as ln
from ladi_vton_tpu_torch.ops.attention import attention_ref
from ladi_vton_tpu_torch.ops.flash_attention import flash_attention
from ladi_vton_tpu_torch.ops.geglu import (
    BLOCK_K,
    geglu,
    geglu_out_tiling,
    geglu_proj_tiling,
    geglu_ref,
)
from ladi_vton_tpu_torch.ops.group_norm import (
    CLUSTER_VECTORS,
    SMEM_LIMIT,
    GroupNormPlan,
    cluster_smem,
    group_norm,
    group_norm_plan,
    group_norm_ref,
)
from ladi_vton_tpu_torch.ops.layer_norm import (
    LayerNormPlan,
    grid_for,
    layer_norm,
    layer_norm_plan,
    layer_norm_ref,
)
from ladi_vton_tpu_torch.pipelines.condition import Conditioner
from ladi_vton_tpu_torch.pipelines.serving import ConditionService, TryOnService
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline

BF16 = torch.bfloat16

# kernel-vs-plain limits on max abs error, for unit-scale outputs: the
# kernels round their outputs (and GEGLU its intermediate) to bf16, whose
# half ulp is 1.6e-2 at |y| in [4, 8)
ATTN_LIMIT = 2e-2
GN_LIMIT = 3e-2
GEGLU_LIMIT = 5e-2
LN_LIMIT = 3e-2
# relative L2 error of a full-width block, bf16 on the card against fp32
# on the CPU: a few bf16 roundings (2^-9 relative each) per layer
BLOCK_LIMIT = 2e-2
# the sampler end to end, bf16 against fp32: CFG 7.5 scales the
# difference of two bf16-rounded UNet outputs, and a DDIM step at
# t = 981 divides by sqrt(alpha) = 0.07
LATENT_LIMIT = 1e-1
IMAGE_MEAN_LIMIT = 2e-2
# the conditioner, card against CPU: the warped cloth is fp32 on both
# (TF32 off) and rounded once to bf16 at the end (2^-9 relative); the
# embeddings pass 2 bf16 CLIP layers, the adapter's layer and MLP, 2 text
# layers: a few bf16 roundings each
WARPED_LIMIT = 1e-2
EMBEDS_LIMIT = 5e-2
NUM_VSTAR = 16
# K4's rows x C -> 2I -> C at the UNet's three widths and its mid block,
# batch 2B = 4
GEGLU_SHAPES = [(4 * 3072, 320), (4 * 768, 640), (4 * 192, 1280),
                (4 * 48, 1280)]


# the least time the card could take for a call: the larger of its bytes
# (each input read once, each output written once) over the memory rate
# and its operations over the peak rate for their type (NVIDIA H100 SXM
# data sheet, dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, rate: float, moved: int) -> dict:
    ops_ms = flops / rate * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def capture_stream() -> torch.cuda.Stream:
    return torch.cuda.Stream()


def graph_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call: `calls` calls captured in a CUDA
    graph and replayed twice, so no host launch cost is timed.  One
    capture stream serves every graph, and `fn` runs once on it before
    the capture, so lazily made state (cuBLAS keeps a workspace per
    stream) is made once and outside the graph."""
    stream = capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()  # hand the graph's memory back before the next phase
    return start.elapsed_time(end) / (2 * calls)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


class Gen:
    """Seeded random tensors on the card."""

    def __init__(self, seed: int):
        self.g = torch.Generator("cuda").manual_seed(seed)

    def normal(self, *shape, scale=1.0, dtype=BF16):
        x = torch.randn(shape, generator=self.g, device="cuda")
        return (x * scale).to(dtype)


def check_attention(gen: Gen) -> dict:
    # (B, Sq, Sk, H, D): UNet self-attention at the three levels at batch
    # 2B = 8 and at the path's batch 4 (service batch 2 with CFG),
    # cross-attention (Sk = 77), the mid block (S = 48) and the VAE's
    # single-head mid block (D = 512)
    shapes = [(8, 3072, 3072, 5, 64), (4, 3072, 3072, 5, 64),
              (8, 768, 768, 10, 64), (4, 768, 768, 10, 64),
              (8, 192, 192, 20, 64), (4, 192, 192, 20, 64),
              (8, 3072, 77, 5, 64), (8, 48, 48, 20, 64),
              (4, 3072, 3072, 1, 512)]
    rows = []
    for B, Sq, Sk, H, D in shapes:
        q = gen.normal(B, Sq, H, D)
        k = gen.normal(B, Sk, H, D)
        v = gen.normal(B, Sk, H, D)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention_ref(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        t = timings(lambda: flash_attention(q, k, v),
                    lambda: attention_ref(q, k, v),
                    lambda: F.scaled_dot_product_attention(qh, kh, vh), 10, 3)
        b = bound(4.0 * B * H * Sq * Sk * D, BF16_TENSOR_FLOPS,
                  nbytes(q, k, v, out))
        r = row(f"B={B} Sq={Sq} Sk={Sk} H={H} D={D}", err, t, b)
        log(f"K1 flash_attention {r['shape']}: max_abs_err {err:.3e} (limit "
            f"{ATTN_LIMIT}) {describe(r, 'F.scaled_dot_product_attention')}")
        if not err <= ATTN_LIMIT:
            raise AssertionError(f"flash_attention disagrees: {err}")
        rows.append(r)
    return summarize(rows)


# K2's phase-2 shapes (B, N, C, silu, eps, weight and bias dtype): every
# kernel instantiation that group_norm_plan gives the path on an H100, that
# is every form and, in the cluster form, every cluster size and vector
# count V = channels / 8 (the census of phase 4 lists the path's calls and
# checks they are covered): the UNet's level-0 resnet (clusters of 8, V =
# 10) and its Transformer2D norm with fp32 parameters, the widest level-0
# concat (no wave of clusters holds it: split form), levels 1-3 (clusters
# of 4, 2 and 1, V = 10), the concats of 960 and 1920 channels (clusters
# of 8 and 4 at V = 30, of 2 at V = 15), the VAE encoder at 128x96
# (clusters of 2, V = 1) and at 64x48 (clusters of 1, V = 2), the VAE mid
# block of one image (clusters of 4, V = 2), the decoder at 128x96
# (clusters of 2 holding 192 KB of rows each), at 256x192 and the encoder
# and decoder at 512x384 (split form)
GN_SHAPES = [(4, 3072, 320, True, 1e-5, BF16),
             (4, 3072, 320, False, 1e-6, torch.float32),
             (4, 3072, 960, True, 1e-5, BF16), (4, 768, 640, True, 1e-5, BF16),
             (4, 192, 1280, True, 1e-5, BF16), (4, 48, 2560, True, 1e-5, BF16),
             (4, 768, 960, True, 1e-5, BF16), (4, 192, 1920, True, 1e-5, BF16),
             (4, 768, 1920, True, 1e-5, BF16),
             (4, 12288, 256, True, 1e-6, BF16),
             (4, 3072, 512, True, 1e-6, BF16),
             (1, 3072, 512, False, 1e-6, BF16),
             (2, 12288, 512, True, 1e-6, BF16),
             (2, 49152, 512, True, 1e-6, BF16),
             (4, 196608, 128, True, 1e-6, BF16),
             (2, 196608, 256, True, 1e-6, BF16)]


def device_kernels(fn) -> list:
    """Names of the device kernels, copies and memsets one call of fn
    runs, from torch.profiler.  Now and then a trace comes back with no
    device activity at all, not even the call's own kernels: it is taken
    again, up to three times in all."""
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() for _ in range(e.count)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def gn_plan(B: int, N: int, C: int) -> GroupNormPlan:
    return group_norm_plan(B, N, C, _build.sm_count(torch.device("cuda", 0)))


def plan_kernel(p: GroupNormPlan) -> tuple:
    """The kernel instantiation a plan runs: the split form, or the
    cluster form at a cluster size and vector count."""
    if p.form == "split":
        return ("split", p.cluster)
    return ("cluster", p.cluster, p.channels // 8)


def describe_plan(p: GroupNormPlan) -> str:
    if p.form == "cluster":
        return (f"one launch, {p.ctas} CTAs in clusters of {p.cluster}, "
                f"{p.channels} channels x {p.rows} rows a CTA")
    return (f"split form, two launches, {p.ctas} statistics CTAs of "
            f"{p.rows} rows in clusters of {p.cluster}")


def check_group_norm(gen: Gen) -> dict:
    rows = []
    for B, N, C, silu, eps, wdt in GN_SHAPES:
        act = "silu" if silu else "none"
        x = gen.normal(B, N, C)
        w = gen.normal(C, scale=0.1, dtype=wdt) + 1.0
        b = gen.normal(C, scale=0.1, dtype=wdt)
        out = group_norm(x, w, b, eps=eps, act=act)
        again = group_norm(x, w, b, eps=eps, act=act)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"group_norm {(B, N, C)} is not "
                                 f"deterministic")
        ref = group_norm_ref(x.float(), w, b, eps=eps, act=act)
        err = (out.float() - ref).abs().max().item()
        plan = gn_plan(B, N, C)
        names = [re.sub(r"^.*?\b(gn_\w+(<\d+>)?)\(.*$", r"\1", n)
                 for n in device_kernels(
                     lambda: group_norm(x, w, b, eps=eps, act=act))]
        if (len(names) != plan.launches
                or not all(n.startswith("gn_") for n in names)):
            raise AssertionError(f"group_norm {(B, N, C)} ran {names}, "
                                 f"expected {plan.launches} K2 kernels")
        # the library pair takes (B, C, N) and weights in x's dtype
        xt, wl, bl = x.transpose(1, 2).contiguous(), w.to(BF16), b.to(BF16)

        def library():
            y = F.group_norm(xt, 32, wl, bl, eps)
            return F.silu(y) if silu else y

        t = timings(lambda: group_norm(x, w, b, eps=eps, act=act),
                    lambda: group_norm_ref(x, w, b, eps=eps, act=act),
                    library, 20, 5)
        # statistics (sum, square), the affine and, with SiLU, its four
        per_elem = 4 + (4 if silu else 0)
        bd = bound(float(per_elem * x.numel()), FP32_FLOPS,
                   nbytes(x, w, b, out))
        wname = "bf16" if wdt == BF16 else "fp32"
        r = row(f"B={B} N={N} C={C} act={act} eps={eps} weights={wname}",
                err, t, bd)
        r["kernels_per_call"] = len(names)
        log(f"K2 group_norm {r['shape']} ({describe_plan(plan)}; "
            f"{len(names)} kernel(s) a call: {sorted(set(names))}; two calls "
            f"bitwise equal): max_abs_err {err:.3e} (limit {GN_LIMIT}) "
            f"{describe(r, 'F.group_norm' + (' then F.silu' if silu else ''))}")
        if not err <= GN_LIMIT:
            raise AssertionError(f"group_norm disagrees: {err}")
        rows.append(r)
    return summarize(rows)


class Census:
    """While open, records every call of the modules of type ``kind``
    under the given roots: ``key(module, input)`` -> calls."""

    kind: type

    def __init__(self, *roots: torch.nn.Module):
        self.modules = [m for root in roots for m in root.modules()
                        if isinstance(m, self.kind)]
        self.calls: dict = {}

    def key(self, module, x: torch.Tensor) -> tuple:
        raise NotImplementedError

    def hook(self, module, args, output) -> None:
        key = self.key(module, args[0])
        self.calls[key] = self.calls.get(key, 0) + 1

    def __enter__(self) -> "Census":
        self.handles = [m.register_forward_hook(self.hook)
                        for m in self.modules]
        return self

    def __exit__(self, *exc) -> None:
        for h in self.handles:
            h.remove()


class GroupNormCensus(Census):
    """(B, N, C, act, eps, weight dtype) -> calls of the GroupNorms."""

    kind = GroupNorm

    def key(self, module, x: torch.Tensor) -> tuple:
        B, N, C = ((x.shape[0], x.shape[2] * x.shape[3], x.shape[1])
                   if x.dim() == 4 else tuple(x.shape))
        return (B, N, C, module.act, module.eps,
                str(module.weight.dtype).replace("torch.", ""))

    def kernels(self) -> int:
        """Kernel launches of the recorded calls."""
        return sum(n * gn_plan(*k[:3]).launches
                   for k, n in self.calls.items())


class LayerNormCensus(Census):
    """(rows, C, row stride) -> calls of the LayerNorms."""

    kind = LayerNorm

    def key(self, module, x: torch.Tensor) -> tuple:
        C = x.shape[-1]
        return (x.numel() // C, C, x.stride(0) if x.dim() == 2 else C)


def check_geglu(gen: Gen) -> dict:
    # the UNet's biases are bf16, and each shape also runs fp32 biases
    rows = []
    for M, C in GEGLU_SHAPES:
        inner = 4 * C
        x = gen.normal(M, C)
        w1 = gen.normal(2 * inner, C, scale=C ** -0.5)
        b1 = gen.normal(2 * inner, scale=0.1)
        w2 = gen.normal(C, inner, scale=inner ** -0.5)
        b2 = gen.normal(C, scale=0.1)
        b1f = gen.normal(2 * inner, scale=0.1, dtype=torch.float32)
        b2f = gen.normal(C, scale=0.1, dtype=torch.float32)
        errs = []
        for bias1, bias2 in ((b1, b2), (b1f, b2f)):
            out = geglu(x, w1, bias1, w2, bias2)
            torch.cuda.synchronize()
            ref = geglu_ref(x.float(), w1.float(), bias1.float(), w2.float(),
                            bias2.float())
            errs.append((out.float() - ref).abs().max().item())
        err = max(errs)
        def library():
            h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), w2, b2)

        t = timings(lambda: geglu(x, w1, b1, w2, b2),
                    lambda: geglu_ref(x, w1, b1, w2, b2), library, 20, 20)
        b = bound(2.0 * M * C * 2 * inner + 2.0 * M * inner * C,
                  BF16_TENSOR_FLOPS, nbytes(x, w1, b1, w2, b2, out))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        r = row(f"rows={M} C={C} I={inner}", err, t, b)
        log(f"K4 geglu {r['shape']} (first product width "
            f"{geglu_proj_tiling(M, C, inner, sms)}, second width and splits "
            f"{geglu_out_tiling(M, C, inner, sms)}): max_abs_err bf16 "
            f"biases {errs[0]:.3e}, fp32 biases {errs[1]:.3e} (limit "
            f"{GEGLU_LIMIT}) {describe(r, 'F.linear, gate, F.linear')}")
        if not err <= GEGLU_LIMIT:
            raise AssertionError(f"geglu disagrees: {errs}")
        rows.append(r)
    return summarize(rows)


# K5's phase-2 shapes (rows, C, read through the CLS stride): every plan
# (lanes, vectors, warps) that layer_norm_plan gives the path on an H100
# (the census of phases 4 and 5 lists the path's calls and checks they are
# covered): the UNet's three levels and mid block (batch 2B = 4), CLIP
# text (2 x 77 tokens), CLIP vision and the adapter (2 x 257) and the
# adapter's CLS rows, read in place through their row stride; then a
# ragged row count (the last row group holds one row) and a width off the
# path (1000 channels: 125 vectors over 32 x 4 lanes, three masked)
LN_SHAPES = [(4 * 3072, 320, False), (4 * 768, 640, False),
             (4 * 192, 1280, False), (4 * 48, 1280, False),
             (2 * 77, 1024, False), (2 * 257, 1280, False), (2, 1280, True),
             (4 * 3072 + 5, 320, False), (77, 1000, False)]
# the path's (residual add, K5) pairs, timed as ten pairs in one graph
LN_PAIR_SHAPES = [(4 * 3072, 320), (2 * 257, 1280)]


def ln_plan(rows: int, C: int, stride: int) -> LayerNormPlan:
    return layer_norm_plan(rows, C, stride,
                           _build.sm_count(torch.device("cuda", 0)))


def ln_input(gen: Gen, rows: int, C: int, cls: bool) -> torch.Tensor:
    if cls:  # x[:, 0, :] of (rows, 257, C)
        return (gen.normal(rows, 257, C, scale=2.0) + 0.5)[:, 0, :]
    return gen.normal(rows, C, scale=2.0) + 0.5


def ln_plan_key(p: LayerNormPlan) -> tuple:
    """What a plan runs: the kernel instantiation (lanes, vectors) and its
    CTA size in warps."""
    return (p.lanes, p.vectors, p.warps)


def describe_ln_plan(p: LayerNormPlan) -> str:
    return (f"{p.lanes} lanes x {p.vectors} vectors a row, {p.grid} CTAs of "
            f"{p.warps} warps, {p.groups} row groups of {p.rows_per_warp}")


def check_layer_norm(gen: Gen) -> dict:
    rows = []
    for M, C, cls in LN_SHAPES:
        x = ln_input(gen, M, C, cls)
        w = gen.normal(C, scale=0.1) + 1.0
        b = gen.normal(C, scale=0.1)
        out = layer_norm(x, w, b)
        again = layer_norm(x, w, b)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"layer_norm {(M, C)} is not deterministic")
        ref = layer_norm_ref(x.float(), w.float(), b.float())
        err = (out.float() - ref).abs().max().item()
        plan = ln_plan(M, C, x.stride(0))
        names = [re.sub(r"^.*?\b(ln_kernel<\d+, \d+>)\(.*$", r"\1", n)
                 for n in device_kernels(lambda: layer_norm(x, w, b))]
        if names != [f"ln_kernel<{plan.lanes}, {plan.vectors}>"]:
            raise AssertionError(f"layer_norm {(M, C)} ran {names}, expected "
                                 f"one ln_kernel<{plan.lanes}, "
                                 f"{plan.vectors}>")
        # timed as the LayerNorm module calls it: weight and bias prepared
        prepared = ln.prepare(w, b, 1e-5)
        t = timings(lambda: ln.launch(x, prepared),
                    lambda: layer_norm_ref(x, w, b),
                    lambda: F.layer_norm(x, (C,), w, b, 1e-5), 20, 20)
        # sum, centre, square-and-add, scale, affine
        bd = bound(7.0 * x.numel(), FP32_FLOPS, nbytes(x, w, b, out))
        r = row(f"rows={M} C={C} row stride {x.stride(0)}", err, t, bd)
        r["plan"] = describe_ln_plan(plan)
        log(f"K5 layer_norm {r['shape']} ({r['plan']}; one kernel a call; "
            f"two calls bitwise equal): max_abs_err {err:.3e} (limit "
            f"{LN_LIMIT}) {describe(r, 'F.layer_norm')}")
        if not err <= LN_LIMIT:
            raise AssertionError(f"layer_norm disagrees: {err}")
        rows.append(r)
    result = summarize(rows)
    result["pairs"] = layer_norm_pairs(gen)
    return result


def layer_norm_pairs(gen: Gen) -> list:
    """Device ms of the pair the path runs, a residual add then the
    LayerNorm of its sum, from a CUDA graph of 100 pairs: with K5 launched
    programmatically (as the path does), with K5 in plain stream order,
    and with F.layer_norm; the add alone beside them."""
    pairs = []
    for M, C in LN_PAIR_SHAPES:
        a, r = gen.normal(M, C), gen.normal(M, C)
        w = gen.normal(C, scale=0.1) + 1.0
        b = gen.normal(C, scale=0.1)
        prepared = ln.prepare(w, b, 1e-5)
        serial = ln.prepare(w, b, 1e-5, pdl=False)
        t = {"shape": f"rows={M} C={C}",
             "add_ms": graph_ms(lambda: a + r, 100),
             "add_k5_ms": graph_ms(lambda: ln.launch(a + r, prepared), 100),
             "add_k5_serial_ms": graph_ms(lambda: ln.launch(a + r, serial),
                                          100),
             "add_library_ms": graph_ms(
                 lambda: F.layer_norm(a + r, (C,), w, b, 1e-5), 100)}
        log(f"K5 pair (residual add, LayerNorm) {t['shape']}, device ms per "
            f"pair in a graph of 100: add then K5 {t['add_k5_ms']:.4f} "
            f"(without programmatic launch {t['add_k5_serial_ms']:.4f}), add "
            f"then F.layer_norm {t['add_library_ms']:.4f}, add alone "
            f"{t['add_ms']:.4f}")
        pairs.append(t)
    return pairs


def timings(kernel, plain, library, iters: int, plain_iters: int) -> dict:
    """CUDA-event ms per call over back-to-back calls (host launch cost
    included) of the kernel, its plain version and the library call, and
    the device ms per call of the kernel and the library from a CUDA
    graph."""
    return {"ms": cuda_ms(kernel, iters),
            "plain_ms": cuda_ms(plain, plain_iters),
            "library_ms": cuda_ms(library, iters),
            "device_ms": graph_ms(kernel),
            "library_device_ms": graph_ms(library)}


def row(shape: str, err: float, t: dict, b: dict) -> dict:
    """One shape's numbers; the bound's share is of the device time."""
    return {"shape": shape, "err": err, **t, **b,
            "bound_share": b["bound_ms"] / t["device_ms"]}


def describe(r: dict, library: str) -> str:
    return (f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}) plain "
            f"{r['plain_ms']:.4f} ms library ({library}) "
            f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})"
            f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bound_share']:.1%} of the kernel's device time)")


def summarize(rows: list) -> dict:
    """Worst error over the shapes; times and bound at the first
    (hottest) shape; every shape's numbers under ``shapes``."""
    first = rows[0]
    return {"max_abs_err": max(r["err"] for r in rows), "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "shapes": rows}


def seeded(factory, seed: int, device: str, dtype=torch.float32):
    torch.manual_seed(seed)
    with torch.device(device):
        module = factory()
    return module.to(device=device, dtype=dtype).eval()


def cpu_copy(module: torch.nn.Module, factory) -> torch.nn.Module:
    """fp32 CPU twin with the card module's (bf16-rounded) weights."""
    twin = factory().eval()
    twin.load_state_dict({k: v.float().cpu()
                          for k, v in module.state_dict().items()})
    return twin


@torch.no_grad()
def check_blocks(gen: Gen) -> None:
    def tfm():
        return Transformer2D(5, 64, 320, 1024)

    block = seeded(tfm, 1, "cuda", BF16)
    x = gen.normal(4, 320, 64, 48).contiguous(
        memory_format=torch.channels_last)
    ctx = gen.normal(4, 77, 1024)
    out = block(x, ctx)
    torch.cuda.synchronize()
    ref = cpu_copy(block, tfm)(x.float().cpu(), ctx.float().cpu())
    err = rel_l2(out, ref)
    log(f"integration Transformer2D C=320 64x48 B=4: rel_l2 {err:.3e} "
        f"(limit {BLOCK_LIMIT})")
    if not err <= BLOCK_LIMIT:
        raise AssertionError(f"Transformer2D disagrees: {err}")

    def mid():
        return MidBlock(512)

    block = seeded(mid, 2, "cuda", BF16)
    x = gen.normal(1, 512, 64, 48).contiguous(
        memory_format=torch.channels_last)
    out = block(x)
    torch.cuda.synchronize()
    ref = cpu_copy(block, mid)(x.float().cpu())
    err = rel_l2(out, ref)
    log(f"integration VAE MidBlock C=512 64x48 B=1: rel_l2 {err:.3e} "
        f"(limit {BLOCK_LIMIT})")
    if not err <= BLOCK_LIMIT:
        raise AssertionError(f"MidBlock disagrees: {err}")


def full_width_pipeline() -> TryOnPipeline:
    """SD-2-width towers with seeded random bf16 weights on the card."""
    return TryOnPipeline(
        unet=seeded(lambda: UNet2DCondition(sd2_unet_config(31)), 10, "cuda",
                    BF16),
        vae=seeded(lambda: AutoencoderKL(VAEConfig()), 11, "cuda", BF16),
        emasc=seeded(EMASC, 12, "cuda", BF16),
        scheduler=DDIMScheduler())


def request(rng: np.random.Generator, n: int, h: int, w: int) -> dict:
    mask = np.zeros((n, h, w, 1), np.float32)
    mask[:, h // 8: h - h // 16, w // 6: w - w // 6] = 1.0
    f = np.float32
    return dict(
        image=rng.uniform(-1, 1, (n, h, w, 3)).astype(f),
        inpaint_mask=mask,
        pose_map=rng.uniform(0, 1, (n, h, w, 18)).astype(f),
        warped_cloth=rng.uniform(-1, 1, (n, h, w, 3)).astype(f),
        prompt_embeds=rng.standard_normal((n, 77, 1024)).astype(f),
        negative_prompt_embeds=rng.standard_normal((n, 77, 1024)).astype(f),
    )


@torch.no_grad()
def check_small_sample(pipe: TryOnPipeline) -> None:
    """The sampler at full width on a 128x128 input: card vs CPU."""
    cpu_pipe = TryOnPipeline(
        unet=cpu_copy(pipe.unet, lambda: UNet2DCondition(sd2_unet_config(31))),
        vae=cpu_copy(pipe.vae, lambda: AutoencoderKL(VAEConfig())),
        emasc=cpu_copy(pipe.emasc, EMASC), scheduler=DDIMScheduler())
    req = request(np.random.default_rng(5), 1, 128, 128)
    args = dict(image=req["image"], mask_image=req["inpaint_mask"],
                pose_map=req["pose_map"], warped_cloth=req["warped_cloth"],
                prompt_embeds=req["prompt_embeds"],
                negative_prompt_embeds=req["negative_prompt_embeds"])
    noise = {k: torch.from_numpy(np.random.default_rng(6 + i)
                                 .standard_normal((1, 16, 16, 4))
                                 .astype(np.float32))
             for i, k in enumerate(("latents", "masked", "cloth"))}
    results = []
    for p in (pipe, cpu_pipe):
        t = {k: torch.from_numpy(v) for k, v in args.items()}
        prepared = p.prepare(image=t["image"], mask_image=t["mask_image"],
                             pose_map=t["pose_map"],
                             warped_cloth=t["warped_cloth"], noise=noise)
        inter = prepared.pop("intermediate")
        lat = p.denoise(prepared, prompt_embeds=t["prompt_embeds"],
                        negative_prompt_embeds=t["negative_prompt_embeds"],
                        num_inference_steps=2, guidance_scale=7.5)
        results.append((lat.float().cpu(), p.decode(lat, inter).cpu()))
    (lat_gpu, img_gpu), (lat_cpu, img_cpu) = results
    lat_err = rel_l2(lat_gpu, lat_cpu)
    img_err = float((img_gpu - img_cpu).abs().mean())
    log(f"integration sampler SD-2 width 128x128 DDIM-2 CFG 7.5: latents "
        f"rel_l2 {lat_err:.3e} (limit {LATENT_LIMIT}), image mean abs "
        f"{img_err:.3e} (limit {IMAGE_MEAN_LIMIT})")
    if not (torch.isfinite(img_gpu).all() and lat_err <= LATENT_LIMIT
            and img_err <= IMAGE_MEAN_LIMIT):
        raise AssertionError("the sampler disagrees with the CPU")


class WordTokenizer:
    """A deterministic stand-in for the CLIP BPE tokenizer: start id
    49406, one id per word (``$`` is 259, every other word a hash in
    [1, 49405] that skips 259), end id 49407, padding 0, 77 ids."""

    def __call__(self, texts) -> np.ndarray:
        ids = np.zeros((len(texts), 77), np.int64)
        for i, text in enumerate(texts):
            words = [259 if w == "$" else self.word_id(w)
                     for w in text.split()][:75]
            ids[i, :len(words) + 2] = [49406, *words, 49407]
        return ids

    @staticmethod
    def word_id(word: str) -> int:
        i = 1 + zlib.crc32(word.encode()) % 49404
        return i + 1 if i >= 259 else i


def conditioner(device: str, image_size: tuple, clip_layers=None
                ) -> Conditioner:
    """The conditioning towers at full width with seeded random weights:
    TPS and refinement in fp32, the CLIP towers and the adapter in bf16;
    ``clip_layers`` cuts the depth of both CLIP towers."""
    vcfg, tcfg = vit_h_vision_config(), sd2_text_config()
    if clip_layers is not None:
        vcfg = dataclasses.replace(vcfg, num_hidden_layers=clip_layers)
        tcfg = dataclasses.replace(tcfg, num_hidden_layers=clip_layers)

    def tps():
        module = ConvNetTPS(256, 192, 21)
        # the regression starts at the identity warp (zero weights); a
        # small random weight lets the features move the grid
        torch.nn.init.normal_(module.loc_net.regression.linear.weight,
                              std=1e-3)
        return module

    empty_ids = torch.from_numpy(WordTokenizer()([""])[0])
    return Conditioner(
        tps=seeded(tps, 20, device),
        refinement=seeded(UNetVanilla, 21, device),
        vision=seeded(lambda: CLIPVisionModel(vcfg), 22, device, BF16),
        adapter=seeded(lambda: InversionAdapter(num_encoder_layers=1),
                       23, device, BF16),
        text_model=seeded(lambda: CLIPTextModel(tcfg), 24, device, BF16),
        num_vstar=NUM_VSTAR, empty_ids=empty_ids, image_size=image_size,
        tps_size=(256, 192))


def cpu_conditioner(cond: Conditioner) -> Conditioner:
    """fp32 CPU twin of a conditioner, with its (bf16-rounded) weights."""
    vcfg = cond.vision.config
    tcfg = cond.text_model.config
    return dataclasses.replace(
        cond, tps=cpu_copy(cond.tps, lambda: ConvNetTPS(256, 192, 21)),
        refinement=cpu_copy(cond.refinement, UNetVanilla),
        vision=cpu_copy(cond.vision, lambda: CLIPVisionModel(vcfg)),
        adapter=cpu_copy(cond.adapter,
                         lambda: InversionAdapter(num_encoder_layers=1)),
        text_model=cpu_copy(cond.text_model, lambda: CLIPTextModel(tcfg)))


def raw_request(rng: np.random.Generator, n: int, h: int, w: int) -> dict:
    """What a user sends: person image and inpainting mask, masked
    person, pose, in-shop cloth, category."""
    req = request(rng, n, h, w)
    f = np.float32
    return dict(
        image=req["image"], inpaint_mask=req["inpaint_mask"],
        pose_map=req["pose_map"],
        im_mask=req["image"] * (1.0 - req["inpaint_mask"]),
        cloth=rng.uniform(-1, 1, (n, h, w, 3)).astype(f),
        categories=[("dresses", "upper_body", "lower_body")[i % 3]
                    for i in range(n)])


@torch.no_grad()
def check_conditioner() -> None:
    h, w = 256, 192
    cond = conditioner("cuda", (h, w), clip_layers=2)
    raw = raw_request(np.random.default_rng(7), 1, h, w)
    results = []
    for c, device in ((cond, "cuda"), (cpu_conditioner(cond), "cpu")):
        service = ConditionService(c, WordTokenizer(), batch_size=1,
                                   num_vstar=NUM_VSTAR, device=device)
        results.append([torch.from_numpy(a) for a in service.run(
            cloth=raw["cloth"], pose_map=raw["pose_map"],
            im_mask=raw["im_mask"], categories=raw["categories"])])
    errs = [rel_l2(a, b) for a, b in zip(*results)]
    log(f"integration conditioner full width, 2 CLIP layers, 256x192, TPS "
        f"256x192: warped cloth rel_l2 {errs[0]:.3e} (limit {WARPED_LIMIT}), "
        f"prompt embeds {errs[1]:.3e}, negative embeds {errs[2]:.3e} "
        f"(limit {EMBEDS_LIMIT})")
    if not (all(torch.isfinite(t).all() for t in results[0])
            and errs[0] <= WARPED_LIMIT and errs[1] <= EMBEDS_LIMIT
            and errs[2] <= EMBEDS_LIMIT):
        raise AssertionError("the conditioner disagrees with the CPU")


def check_census(census: GroupNormCensus) -> None:
    """Log the GroupNorm calls of one 2-image request with K2's plan for
    each, and fail unless phase 2 checked every kernel instantiation
    among them (``plan_kernel``)."""
    covered = {plan_kernel(gn_plan(*shape[:3])) for shape in GN_SHAPES}
    for (B, N, C, act, eps, wdt), n in sorted(census.calls.items()):
        p = gn_plan(B, N, C)
        log(f"K2 census: {n:4d} x (B={B}, N={N}, C={C}) act={act} "
            f"eps={eps} weights={wdt}: {describe_plan(p)}")
        if plan_kernel(p) not in covered:
            raise AssertionError(f"phase 2 does not check K2's plan for "
                                 f"{(B, N, C)}: {p}")
    log(f"K2 census of one 2-image request: {sum(census.calls.values())} "
        f"calls, {census.kernels()} kernel launches")


def check_layer_norm_census(census: LayerNormCensus, what: str) -> None:
    """Log the LayerNorm calls of ``what`` with K5's plan for each, and
    fail unless phase 2 checked every plan among them (``ln_plan_key``)."""
    covered = {ln_plan_key(ln_plan(M, C, 257 * C if cls else C))
               for M, C, cls in LN_SHAPES}
    for (rows, C, stride), n in sorted(census.calls.items()):
        p = ln_plan(rows, C, stride)
        log(f"K5 census: {n:4d} x (rows={rows}, C={C}, row stride "
            f"{stride}): {describe_ln_plan(p)}")
        if ln_plan_key(p) not in covered:
            raise AssertionError(f"phase 2 does not check K5's plan for "
                                 f"{(rows, C, stride)}: {p}")
    log(f"K5 census of {what}: {sum(census.calls.values())} calls")


def serve_raw_requests(service: TryOnService, wrappers: dict) -> dict:
    """Phase 5: ConditionService -> TryOnService at full width; returns
    the kernels' launches over the two requests."""
    h, w = service.height, service.width
    cond = ConditionService(conditioner("cuda", (h, w)), WordTokenizer(),
                            batch_size=service.batch_size,
                            num_vstar=NUM_VSTAR)
    rng = np.random.default_rng(1)

    def answer(raw: dict):
        t0 = time.perf_counter()
        warped, embeds, negative = cond.run(
            cloth=raw["cloth"], pose_map=raw["pose_map"],
            im_mask=raw["im_mask"], categories=raw["categories"])
        torch.cuda.synchronize()
        t_cond = time.perf_counter() - t0
        ln_cond = layer_norm.launches
        out = service.generate(
            image=raw["image"], inpaint_mask=raw["inpaint_mask"],
            pose_map=raw["pose_map"], warped_cloth=warped,
            prompt_embeds=embeds, negative_prompt_embeds=negative)
        torch.cuda.synchronize()
        return (warped, embeds, negative, out, t_cond,
                time.perf_counter() - t0, ln_cond)

    t0 = time.perf_counter()
    answer(raw_request(rng, 2, h, w))
    log(f"phase 5: warmup raw request (2 images) "
        f"{time.perf_counter() - t0:.3f} s")
    for wrapper in wrappers.values():
        wrapper.launches = 0
    for n in (1, 2):
        raw = raw_request(rng, n, h, w)
        torch.cuda.reset_peak_memory_stats()
        ln_before = layer_norm.launches
        gn_before = group_norm.launches
        c = cond.conditioner
        with GroupNormCensus(service.pipe.unet, service.pipe.vae,
                             service.pipe.emasc) as census, LayerNormCensus(
                service.pipe.unet, c.vision, c.adapter,
                c.text_model) as ln_census:
            warped, embeds, negative, out, t_cond, total, ln_cond = answer(
                raw)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ok = (warped.shape == (n, h, w, 3) and np.isfinite(warped).all()
              and warped.min() >= -1.0 and warped.max() <= 1.0
              and embeds.shape == negative.shape == (n, 77, 1024)
              and np.isfinite(embeds).all() and np.isfinite(negative).all()
              and out.shape == (n, h, w, 3) and np.isfinite(out).all()
              and out.min() >= 0.0 and out.max() <= 1.0)
        log(f"raw request of {n} image(s) ({', '.join(raw['categories'])}) "
            f"at {h}x{w}: conditioning {t_cond:.3f} s, total {total:.3f} s "
            f"(DDIM-{service.num_inference_steps}, CFG "
            f"{service.guidance_scale}, batch {service.batch_size}), peak device "
            f"memory {peak:.2f} GiB, warped cloth in [{warped.min():.4f}, "
            f"{warped.max():.4f}], prompt embeds std {embeds.std():.4f}, "
            f"output in [{out.min():.4f}, {out.max():.4f}] std "
            f"{out.std():.4f}; K5 launches: conditioning "
            f"{ln_cond - ln_before}, try-on {layer_norm.launches - ln_cond}; "
            f"K2 calls {group_norm.launches - gn_before}, K2 kernel launches "
            f"{census.kernels()}")
        if not ok:
            raise AssertionError(f"raw request of {n}: bad output")
        if not (ln_cond > ln_before and layer_norm.launches > ln_cond):
            raise AssertionError("K5 was not launched in both stages")
        check_layer_norm_census(ln_census, f"a raw request of {n} image(s)")
    return {name: wrapper.launches for name, wrapper in wrappers.items()}


def sweep_geglu_tilings() -> None:
    """``--sweep-geglu``: K4's device time per tiling at the UNet's four
    GEGLU shapes: the first product at each accumulator width, the
    second at each tile width and contraction split the kernels take,
    device microseconds per call from a CUDA graph of 20 calls, with what
    ``ops/geglu.py`` picks marked.  Every tiling's output is checked
    against the first one's: the first product's bit for bit, the
    second's within 2e-2 (the splits add fp32 partials in another
    order).  The measurement behind ``geglu_proj_tiling`` and
    ``geglu_out_tiling``."""
    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = Gen(0)
    for M, C in GEGLU_SHAPES:
        inner = 4 * C
        x = gen.normal(M, C)
        w1 = gen.normal(2 * inner, C, scale=C ** -0.5)
        b1 = gen.normal(2 * inner, scale=0.1)
        w2 = gen.normal(C, inner, scale=inner ** -0.5)
        b2 = gen.normal(C, scale=0.1)
        a = torch.empty(M, inner, dtype=torch.bfloat16, device="cuda")
        y = torch.empty(M, C, dtype=torch.bfloat16, device="cuda")
        picked_proj = geglu_proj_tiling(M, C, inner, sms)
        picked_out = geglu_out_tiling(M, C, inner, sms)
        first, cells = None, []
        for bn in (128, 256):
            def proj(bn=bn):
                _build.check(lib.ladi_geglu_proj(
                    x.data_ptr(), w1.data_ptr(), b1.data_ptr(), 0,
                    a.data_ptr(), M, C, inner, bn, _build.stream_ptr(x)),
                    "geglu proj")

            proj()
            torch.cuda.synchronize()
            if first is None:
                first = a.clone()
            elif not torch.equal(a, first):
                raise AssertionError(f"first product width {bn} disagrees")
            mark = "*" if bn == picked_proj else ""
            cells.append(f"proj {bn}{mark} "
                         f"{graph_ms(proj, 20) * 1e3:.2f}")
        steps = inner // BLOCK_K
        first = None
        for bn in (256, 160, 128, 64):
            if C % bn:
                continue
            for split in (1, 2, 4, 5, 8, 10):
                if steps % split or (split > 1 and steps // split < 4):
                    continue
                partial = torch.empty(split, M, C, dtype=torch.float32,
                                      device="cuda")

                def out(bn=bn, split=split, partial=partial):
                    _build.check(lib.ladi_geglu_out(
                        a.data_ptr(), w2.data_ptr(), b2.data_ptr(), 0,
                        y.data_ptr(), partial.data_ptr(), M, inner, C, bn,
                        split, _build.stream_ptr(x)), "geglu out")

                out()
                torch.cuda.synchronize()
                if first is None:
                    first = y.float()
                elif not (y.float() - first).abs().max().item() <= 2e-2:
                    raise AssertionError(f"width {bn} split {split} "
                                         f"disagrees")
                mark = "*" if (bn, split) == picked_out else ""
                cells.append(f"out {bn}/{split}{mark} "
                             f"{graph_ms(out, 20) * 1e3:.2f}")
        print(f"K4 rows={M} C={C} I={inner}, device us per call (* = "
              f"picked): " + ", ".join(cells), flush=True)


def sweep_group_norm_plans() -> None:
    """``--sweep-group-norm``: K2's cluster form under every channel range,
    cluster size and thread count of which one wave fits the card
    (``cudaOccupancyMaxActiveClusters``), at the UNet's shapes and the
    VAE's largest cluster-form one, device microseconds per call from a
    CUDA graph of 20 calls, fastest first, with ``group_norm_plan``'s pick
    marked.  Every plan's output is checked against ``group_norm_ref``
    within ``GN_LIMIT``.  The measurement behind the plan's weights."""
    lib = _build.library()
    sms = _build.sm_count(torch.device("cuda", 0))
    gen = Gen(0)
    for B, N, C in ((4, 3072, 320), (4, 3072, 640), (4, 768, 640),
                    (4, 768, 1920), (4, 192, 1280), (4, 48, 2560),
                    (2, 12288, 512)):
        pick = group_norm_plan(B, N, C, sms)
        x = gen.normal(B, N, C)
        w = gen.normal(C, scale=0.1) + 1.0
        b = gen.normal(C, scale=0.1)
        ref = group_norm_ref(x.float(), w, b, eps=1e-5, act="silu")
        out = torch.empty_like(x)
        cells = []
        for channels in range(8, min(C, 256) + 1, 8):
            cg, V = C // 32, channels // 8
            if C % channels or channels % cg or V not in CLUSTER_VECTORS:
                continue
            for cluster in (1, 2, 4, 8):
                rows = -(-N // cluster)
                for most in (4, 8, 16):
                    threads = 32 * min(most, -(-rows // (32 // V)))
                    smem = cluster_smem(rows, channels, channels // cg,
                                        threads, cluster)
                    if smem > SMEM_LIMIT:
                        continue
                    fit = lib.ladi_group_norm_max_clusters(
                        0, channels, cluster, threads, smem)
                    if fit < 1 or B * (C // channels) > fit:
                        continue

                    def call(cluster=cluster, channels=channels, rows=rows,
                             threads=threads, smem=smem):
                        _build.check(lib.ladi_group_norm_cluster(
                            x.data_ptr(), w.data_ptr(), b.data_ptr(), 0,
                            out.data_ptr(), B, N, C, 32, 1e-5, 1, cluster,
                            channels, rows, threads, smem,
                            _build.stream_ptr(x)), "group_norm cluster")

                    call()
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs().max().item()
                    if not err <= GN_LIMIT:
                        raise AssertionError(
                            f"group_norm {(B, N, C)}, {channels} channels x "
                            f"{cluster} x {threads} threads: error {err}")
                    mark = "*" if (channels, cluster, threads) == (
                        pick.channels, pick.cluster, pick.threads) else ""
                    cells.append((graph_ms(call, 20) * 1e3,
                                  f"{mark}{channels} ch x {cluster} x "
                                  f"{threads} thr"))
        cells.sort()
        print(f"K2 B={B} N={N} C={C}, device us per call (* = picked, "
              f"{describe_plan(pick)}): "
              + ", ".join(f"{name} {us:.2f}" for us, name in cells),
              flush=True)


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds per call of fn over back-to-back calls (the
    device keeps up at the shapes timed), after a warm-up."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def sweep_layer_norm_plans() -> None:
    """``--sweep-layer-norm``: K5 at the path's seven shapes, device
    microseconds per call from a CUDA graph of 100 calls: under every
    warp count a CTA (the plan's lanes and vectors, ``grid_for``'s grid;
    ``layer_norm_plan``'s pick marked), each output checked against
    ``layer_norm_ref`` within ``LN_LIMIT``; then the pick as the module
    runs it, with and without programmatic launch, in the order on, off,
    off, on; and the path's (residual add, K5) pairs the same way, three
    times over.  Then the host time of one call at 154 x 1024, part by part:
    what the wrapper and the module cost beside ``F.layer_norm`` and
    ``torch.nn.LayerNorm``."""
    lib = _build.library()
    sms = _build.sm_count(torch.device("cuda", 0))
    gen = Gen(0)
    for M, C, cls in LN_SHAPES[:7]:
        x = ln_input(gen, M, C, cls)
        stride = x.stride(0)
        w = gen.normal(C, scale=0.1) + 1.0
        b = gen.normal(C, scale=0.1)
        ref = layer_norm_ref(x.float(), w.float(), b.float())
        out = torch.empty(M, C, dtype=BF16, device="cuda")
        pick = ln_plan(M, C, stride)
        prepared = ln.prepare(w, b, 1e-5)
        serial = ln.prepare(w, b, 1e-5, pdl=False)
        cells = []
        for warps in (1, 2, 4, 8):
            plan = dataclasses.replace(
                pick, warps=warps, grid=grid_for(pick.groups, warps, sms))

            def call(plan=plan):
                _build.check(lib.ladi_layer_norm_fwd(
                    x.data_ptr(), out.data_ptr(), M, stride, prepared.address,
                    plan.code, plan.grid, _build.stream_ptr(x)), "layer_norm")

            out.zero_()
            call()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not err <= LN_LIMIT:
                raise AssertionError(f"layer_norm {(M, C)} at {warps} warps: "
                                     f"error {err}")
            mark = "*" if warps == pick.warps else ""
            cells.append(f"{mark}{warps} warps x {plan.grid} "
                         f"{graph_ms(call, 100) * 1e3:.3f}")
        abba = [graph_ms(lambda p=p: ln.launch(x, p), 100) * 1e3
                for p in (prepared, serial, serial, prepared)]
        log(f"K5 rows={M} C={C} row stride {stride}, device us per call (* = "
            f"picked: {describe_ln_plan(pick)}): " + ", ".join(cells)
            + f"; the pick with and without programmatic launch (on, off, "
            f"off, on): " + " ".join(f"{us:.3f}" for us in abba))
    for M, C in LN_PAIR_SHAPES:
        a, r = gen.normal(M, C), gen.normal(M, C)
        w = gen.normal(C, scale=0.1) + 1.0
        b = gen.normal(C, scale=0.1)
        prepared = ln.prepare(w, b, 1e-5)
        serial = ln.prepare(w, b, 1e-5, pdl=False)
        abba = [graph_ms(lambda p=p: ln.launch(a + r, p), 100) * 1e3
                for p in (prepared, serial, serial, prepared) * 3]
        log(f"K5 pair (residual add, LayerNorm) rows={M} C={C}, device us "
            f"per pair in graphs of 100, with and without programmatic launch "
            f"(on, off, off, on, three times): "
            + " ".join(f"{us:.3f}" for us in abba))

    M, C = 2 * 77, 1024
    x = gen.normal(M, C)
    w = gen.normal(C, scale=0.1) + 1.0
    b = gen.normal(C, scale=0.1)
    prepared = ln.prepare(w, b, 1e-5)
    module = LayerNorm(C).to(device="cuda", dtype=BF16)
    library = torch.nn.LayerNorm(C).to(device="cuda", dtype=BF16)
    plan = ln_plan(M, C, C)
    out = torch.empty_like(x)
    fn = lib.ladi_layer_norm_fwd
    key = (w.data_ptr(), b.data_ptr(), w.dtype, b.dtype, w.device, b.device,
           1e-5)
    parts = {
        "F.layer_norm": lambda: F.layer_norm(x, (C,), w, b, 1e-5),
        "torch.nn.LayerNorm module": lambda: library(x),
        "LayerNorm module (the path)": lambda: module(x),
        "layer_norm(x, w, b) (checks weight and bias)":
            lambda: layer_norm(x, w, b),
        "ops.layer_norm.launch (prepared)": lambda: ln.launch(x, prepared),
        "  the module's key of its parameters":
            lambda: key == (w.data_ptr(), b.data_ptr(), w.dtype, b.dtype,
                            w.device, b.device, 1e-5),
        "  torch.empty_like": lambda: torch.empty_like(
            x, memory_format=torch.contiguous_format),
        "  layer_norm_plan (cached)": lambda: layer_norm_plan(M, C, C, sms),
        "  _build.stream_ptr": lambda: _build.stream_ptr(x),
        "  the ctypes call (launch included)": lambda: fn(
            x.data_ptr(), out.data_ptr(), M, C, prepared.address, plan.code,
            plan.grid, _build.stream_ptr(x)),
    }
    log(f"K5 host us per call at rows={M} C={C}: " + ", ".join(
        f"{name} {host_us(f):.2f}" for name, f in parts.items()))


KERNELS = (
    ("flash_attention", flash_attention, check_attention,
     "ladi_vton_tpu_torch/csrc/flash_attention.cu",
     "ladi_vton_tpu/ops/flash_attention.py:99"),
    ("group_norm", group_norm, check_group_norm,
     "ladi_vton_tpu_torch/csrc/group_norm.cu",
     "ladi_vton_tpu/ops/group_norm.py:154"),
    ("geglu", geglu, check_geglu, "ladi_vton_tpu_torch/csrc/geglu.cu",
     "ladi_vton_tpu/ops/geglu.py:72"),
    ("layer_norm", layer_norm, check_layer_norm,
     "ladi_vton_tpu_torch/csrc/layer_norm.cu",
     "ladi_vton_tpu/ops/layer_norm.py:66"),
)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep-geglu", action="store_true",
                        help="time every GEGLU tiling instead of the "
                        "phases, and exit")
    parser.add_argument("--sweep-group-norm", action="store_true",
                        help="time every GroupNorm cluster-form plan "
                        "instead of the phases, and exit")
    parser.add_argument("--sweep-layer-norm", action="store_true",
                        help="time every LayerNorm warp count and the "
                        "wrapper's host cost instead of the phases, and "
                        "exit")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script measures "
                 "the port on an NVIDIA GPU and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    build_dir, build_s = _build.build()
    _build.library()
    if args.sweep_geglu:
        sweep_geglu_tilings()
        return
    if args.sweep_group_norm:
        sweep_group_norm_plans()
        return
    if args.sweep_layer_norm:
        sweep_layer_norm_plans()
        return
    log(f"phase 1: kernels built from ladi_vton_tpu_torch/csrc in "
        f"{build_s:.2f} s, one nvcc per source in parallel (0 = already "
        f"built for these sources); ptxas report in "
        f"{build_dir / 'nvcc.log'}")

    gen = Gen(0)
    results = {}
    for name, _, check, _, _ in KERNELS:
        results[name] = check(gen)
    log("phase 2: every kernel agrees with its plain version")

    check_blocks(gen)
    pipe = full_width_pipeline()
    check_small_sample(pipe)
    check_conditioner()
    log("phase 3: full-width blocks, the sampler and the conditioner agree "
        "with the CPU")

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    service = TryOnService(pipe, batch_size=2, height=512, width=384,
                           num_inference_steps=50, guidance_scale=7.5,
                           context_dim=1024, seed=0)
    t0 = time.perf_counter()
    service.warmup()
    torch.cuda.synchronize()
    log(f"phase 4: warmup request (2 images) {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    wrappers = {name: wrapper for name, wrapper, _, _, _ in KERNELS}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    census = GroupNormCensus(pipe.unet, pipe.vae, pipe.emasc)
    ln_census = LayerNormCensus(pipe.unet)
    for i, n in enumerate((1, 2, 2)):
        req = request(rng, n, 512, 384)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if i == 1:
            with census, ln_census:
                out = service.generate(**req)
        else:
            out = service.generate(**req)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ok = (out.shape == (n, 512, 384, 3) and np.isfinite(out).all()
              and out.min() >= 0.0 and out.max() <= 1.0)
        log(f"request of {n} image(s) at 512x384, DDIM-50, CFG 7.5, batch 2: "
            f"{dt:.3f} s, peak device memory {peak:.2f} GiB, output "
            f"{out.shape} in [{out.min():.4f}, {out.max():.4f}] std "
            f"{out.std():.4f}")
        if not ok:
            raise AssertionError(f"request of {n}: bad output")
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    log(f"launches during the three requests: {launches}")
    check_census(census)
    check_layer_norm_census(ln_census, "one 2-image request")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")

    launches = serve_raw_requests(service, wrappers)
    log(f"launches during the two raw requests: {launches}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the raw-request "
                             f"path: {missing}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         **results[name]}
        for name, _, _, source, replaces in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
