#!/usr/bin/env python3
"""Drive the PyTorch port's try-on path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep-geglu       # K4's device time per tiling
    python3 chip_smoke.py --sweep-group-norm  # K2's device time per plan
    python3 chip_smoke.py --sweep-layer-norm  # K5's device time per plan
    python3 chip_smoke.py --training-only     # phase 2's gradients, phase 10
    python3 chip_smoke.py --distributed-only  # phase 2's TP rows, phase 11

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
   runs it, behind a residual add, against the add then ``F.layer_norm``.
   Then each kernel's gradient at the trainers' shapes (batch 1 at
   512x384): the wrapper with inputs that need a gradient runs its
   autograd Function (the kernel's forward, the plain version's recompute
   as the backward), every input must get a finite gradient, each within
   a stated relative L2 of fp32 autograd of the plain version on the same
   bf16 inputs, and the forward plus backward is timed against the
   library's (SDPA, ``F.group_norm`` then SiLU, ``F.linear``-gelu-
   ``F.linear``, ``F.layer_norm``).  Last, K1 and K4 at the shapes a
   tensor-parallel UNet (model 2, batch 4) gives them: K1 on half the
   heads of levels 1 and 2 and the mid block, K4 at half the inner
   width of each level, each row as above;
3. integration at full width: one level-0 ``Transformer2D`` (C=320,
   64x48, batch 4) and one VAE ``MidBlock`` (512 at 64x48) through the
   kernels on the card and through the plain versions on the CPU, same
   weights, relative L2 error against a stated limit; the whole sampler
   at full SD-2 width on a small 128x128 input (CFG 7.5) under each
   scheduler (DDIM, PNDM and LMS 2 steps, DPM-Solver++ 3), and with the
   cross-attention K/V hoisted, which must equal the inline form; a
   tiled decode (16x16 latent, tiles of 8); the conditioner at full
   width and 2 layers per CLIP tower on a 256x192 image (TPS at
   256x192), on the card against the CPU;
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
   4.  The port's CLIP BPE tokenizer reads a synthetic vocabulary
   (``synthetic_tokenizer``): the SD-2 one is not in the repository;
6. the zoo path: phase 4's and 5's modules written as the reference's
   files (the four ``.pth`` releases; an SD-2 directory with ``vae/``
   as ``.safetensors`` and ``text_encoder/``; a CLIP vision directory),
   loaded back through ``ladi_vton_tpu_torch.hub.zoo`` onto the card
   and checked tensor for tensor, a 9-channel UNet release widened by
   the zoo's conv_in surgery, then phase 5's 2-image raw request served
   from the loaded modules under DDIM-50 (bitwise equal to phase 5's
   answer) and under DPM-Solver++-20, PNDM-50 and LMS-50 (shape,
   finiteness, range; seconds and peak memory logged), with every
   kernel's launch counter rising; last, the VAE's encode and decode at
   512x384 untiled and tiled with the JAX defaults, timed, and the
   tiled calls under the K2 census;
7. the CLIs: a DressCode (one category) and a VITON-HD test split of 2
   pairs each, written at the datasets' 1024x768 by the port's PNG writer
   under the datasets' file names (``data/synthetic.py``), with the
   warped-cloth and CLIP-feature caches; ``cli.inference.main`` over each
   (DDIM-50, CFG 7.5, batch 2, 512x384, PNG output) and ``cli.eval.main``
   over each (DPM-Solver++-20, the cached warped cloths and CLIP
   features), from phase 6's reference-layout files (the ``*_vitonhd``
   releases linked under the ``*_dresscode`` names); every saved image
   must equal, bit for bit, what the zoo-loaded ``Conditioner`` and
   ``TryOnPipeline`` give when called directly on the same batch with the
   same seed, and a last ``inference`` run with the default JPEG output
   must write files whose markers parse.  Each run logs the main's wall
   seconds and images per second (host clock), the loader's seconds per
   batch and the launch counts of every kernel (K2's by form), each of
   which must be above zero;
8. serving: ``make_http_server`` over a ``MicroBatcher`` around phase
   6's zoo-loaded modules (batch 4, DDIM-50, CFG 7.5), on a free port: a
   2-image raw request through /condition and /tryon with the port's
   ``TryOnClient``, then three concurrent /tryon requests of 1, 1 and 2
   images started 1 s apart (one group of 4 in that order), and a
   malformed payload (400); every answer bitwise equal to the services
   called directly (a fresh service of the same seed), /healthz counting
   2 batches, 4 requests and 6 samples, every kernel launched, the
   seconds of each request against the direct calls.  Then ``python -m
   ladi_vton_tpu_torch.cli.serve --enable_condition --port 0`` as a
   process from phase 6's files: its answer to the raw request bitwise
   equal to the in-process one (the same seed, request 0), and SIGINT
   ends it with exit code 0;
9. the metrics: seeded metric weights written from the port's
   ``InceptionV3`` and ``LPIPS``; Inception (pool3, logits; 4 at
   299x299), LPIPS and SSIM on the card (fp32, TF32 off) against the CPU;
   then on the card ``cli.generate_fid_stats`` over phase 7's trees,
   ``cli.val_metrics`` over phase 7's PNG and JPEG runs (the JPEGs read by
   the port's decoder, within a stated PSNR of the pixels written),
   ``cli.inference --compute_metrics`` (its JSON equal to
   ``val_metrics``' over its folder) and
   ``cli.compute_cloth_clip_features`` over the VITON-HD test split (each
   feature equal to the zoo-loaded tower called directly, K5 launched),
   each main's seconds logged;
10. training: the VTO loss and its UNet gradient at full SD-2 width on one
   128x128 image, on the card (bf16 autocast, fp32 parameters, the kernels'
   Functions) against the CPU (fp32), same weights and draws (loss within
   a stated relative limit, each part of the UNet's gradient to a stated
   cosine similarity); the VTO step alone at 512x384, batch 1, timed with
   and without gradient checkpointing (seconds, peak memory, launches a
   step); then the four trainers at 512x384 from 1024x768
   synthetic train splits of both datasets (``data/synthetic.py``) and
   phase 6's files (the stock UNet written under ``sd2/unet``, a seeded
   torchvision-layout VGG19): ``train_vto`` two steps, resumed for two
   more with ``--gradient_checkpointing`` and ``--async_checkpointing``;
   ``train_emasc``
   (DressCode, every category; three steps with an asynchronous
   checkpoint each, so that keeping two deletes the first),
   ``train_inversion_adapter`` and
   ``train_tps`` (one epoch of each phase, then the extraction).  Every
   update must see a finite gradient on every trained parameter and its
   first move them, the losses be finite, each kernel the step runs be
   launched, the GroupNorm and LayerNorm census of ``train_vto`` and
   ``train_emasc`` be covered by phase 2; ``train_vto``'s checkpoints are
   resumed and each trainer keeps its last two, the ``.pth`` exports load
   back through the zoo, and
   ``cli.eval`` reads the warped cloths ``train_tps`` extracted with the
   trained exports.  Each run logs its step seconds, peak memory and
   launches;
11. distribution, after this process lets go of the card (it holds a
   fraction of a GiB when the ranks start) and of phase 10's checkpoints:
   ranks as processes with torchrun's variables (``parallel.launch``),
   two sharing the card over gloo (NCCL refuses two ranks on one
   device), each killed with the others on a failure or a timeout.
   (a) the full-width VTO step (512x384, fp32 UNet and AdamW, frozen
   bf16 towers) over two ranks at a global batch of 2 against this
   process's step at batch 2 on the same batch and draws: the loss and
   each UNet part's reduced gradient within stated limits, and the same
   step with the gradient ``all_reduce`` left out (a planted fault)
   outside the gradient's limit; then under ZeRO-1, its updates bitwise
   the unsharded ones and each rank holding half of the AdamW state;
   step seconds and peak memory a rank.
   (b) one rank over NCCL: the step over its group of one bitwise the
   step without a group.  (c) data 1 x model 2: the tensor-parallel UNet
   forward (batch 4, 64x48 latents) against the unsharded one, each of
   the two also against an fp32 CPU forward of the same weights, and the
   forward with ``reduce_from_model`` left out (a planted fault) outside
   the limit; K1's and K4's calls counted and their shard shapes held to
   phase 2's tensor-parallel rows; one tensor-parallel step's loss and
   its gradient, gathered to the reference layout, by UNet part against
   (a)'s.  (d) the mains over two ranks: ``train_vto
   --shard_optimizer_states`` two steps, then from ``checkpoint-1``
   alone, resumed, its ``unet_2.pth`` bitwise the first run's, and the
   peak memory of each run, its checkpoints included, below (a)'s
   unsharded step's;
   ``train_vto --tensor_parallel 2``, its gathered ``unet_2.pth``
   loaded through the zoo; ``cli.inference`` over phase 7's VITON-HD
   split against phase 7's images.  (e) ``dryrun_multichip(2)`` on the
   card, every kernel launched in its tensor-parallel step.

Phases 2 and 3 compare with TF32 off for matmuls and cuDNN; phases 4
and 5 serve with PyTorch's defaults (cuDNN TF32 allowed, matmul TF32
off), which the port leaves as they are: with cuDNN TF32 off, cuDNN runs
the fp32 refinement through FFT convolutions that take ~60x longer and
a ~20 GiB workspace (``tools/profile_raw_request.py``).

The line before the last is ``{"kernels": [...]}``, with the launches
of phase 5 (phase 6's as ``zoo_launches``, phase 7's five CLI runs' as
``mains_launches``, phase 8's served requests as ``serve_launches``,
phase 9's metric mains as ``metrics_launches``, phase 10's training
runs as ``train_launches``, phase 11's ranks summed as
``dist_launches``), the first (hottest) shape's times and, under
``shapes``, every shape's, under ``tp_shapes`` K1's and K4's
tensor-parallel rows, and under ``grad`` the gradient rows; the last
is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero without that line; it also refuses to run without
CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import pathlib
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from ladi_vton_tpu_torch.cli import compute_cloth_clip_features as clip_main
from ladi_vton_tpu_torch.cli import eval as eval_cli
from ladi_vton_tpu_torch.cli import generate_fid_stats as stats_main
from ladi_vton_tpu_torch.cli import inference as inference_cli
from ladi_vton_tpu_torch.cli import train_emasc as train_emasc_cli
from ladi_vton_tpu_torch.cli import (
    train_inversion_adapter as train_adapter_cli,
)
from ladi_vton_tpu_torch.cli import train_tps as train_tps_cli
from ladi_vton_tpu_torch.cli import train_vto as train_vto_cli
from ladi_vton_tpu_torch.cli import val_metrics as val_main
from ladi_vton_tpu_torch.client import TryOnClient
from ladi_vton_tpu_torch.core.rng import batch_generator
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
    imageio,
    native,
    synthetic,
)
from ladi_vton_tpu_torch.data.features import ClothFeatureCache
from ladi_vton_tpu_torch.diffusion.schedulers import (
    DDIMScheduler,
    make_scheduler,
)
from ladi_vton_tpu_torch.diffusion.text import encode_text_word_embedding
from ladi_vton_tpu_torch.hub import zoo
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
from ladi_vton_tpu_torch.models.vgg import VGG19Features
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
from ladi_vton_tpu_torch.metrics.compute import (
    MetricModels,
    _gt_image_paths,
    _load_batch,
)
from ladi_vton_tpu_torch.metrics.fid import StatsCache, frechet_distance
from ladi_vton_tpu_torch.metrics.inception import InceptionV3
from ladi_vton_tpu_torch.metrics.lpips import LPIPS
from ladi_vton_tpu_torch.pipelines.condition import Conditioner, clip_pixels
from ladi_vton_tpu_torch.pipelines.serving import (
    ConditionService,
    MicroBatcher,
    TryOnService,
    category_prompts,
    make_http_server,
)
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.train import steps as steps_mod
from ladi_vton_tpu_torch.train.steps import (
    VTOStepConfig,
    make_optimizer,
    make_vto_loss,
    make_vto_train_step,
    precision,
    vto_draws,
)
from ladi_vton_tpu_torch.utils.tokenizer import (
    CLIPTokenizer,
    _bytes_to_unicode,
)

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
# the whole VAE decoder, bf16 against fp32: a few bf16 roundings in each
# of its ~30 layers
DECODE_LIMIT = 5e-2
NUM_VSTAR = 16
# phase 3's small sampler: (scheduler, steps) on the card and the CPU
SMALL_SAMPLES = (("ddim", 2), ("pndm", 2), ("lms", 2), ("dpm", 3))
# phase 6's raw requests through the zoo-loaded modules
ZOO_REQUESTS = (("ddim", 50), ("dpm", 20), ("pndm", 50), ("lms", 50))
# K4's rows x C -> 2I -> C at the UNet's three widths and its mid block,
# batch 2B = 4
GEGLU_SHAPES = [(4 * 3072, 320), (4 * 768, 640), (4 * 192, 1280),
                (4 * 48, 1280)]
# the shapes a tensor-parallel UNet at model 2 gives the kernels at batch
# 4 (phase 11's forward): K1 (B, Sq, Sk, H, D) on half the heads where
# they divide (levels 1 and 2 and the mid block, self- and
# cross-attention; level 0's 5 heads stay whole), K4 (rows, C, I / 2) at
# the three widths and the mid block
ATTN_TP_SHAPES = [(4, 768, 768, 5, 64), (4, 768, 77, 5, 64),
                  (4, 192, 192, 10, 64), (4, 192, 77, 10, 64),
                  (4, 48, 48, 10, 64), (4, 48, 77, 10, 64)]
GEGLU_TP_SHAPES = [(M, C, 2 * C) for M, C in GEGLU_SHAPES]


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


def save_safetensors(tensors: dict, path) -> None:
    """Write CPU-copyable tensors as a ``.safetensors`` file: the JSON
    header's length (8 bytes, little-endian), the header (padded to 8
    bytes), then each tensor's raw bytes."""
    names = {dtype: name for name, dtype in zoo.SAFETENSORS_DTYPES.items()}
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        f.writelines(chunks)


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


def attention_row(gen: Gen, B: int, Sq: int, Sk: int, H: int,
                  D: int) -> dict:
    """K1 at one shape against its plain version: error, times, bound."""
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
    return r


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
    return summarize([attention_row(gen, *shape) for shape in shapes])


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
# and decoder at 512x384 (split form), and the encoder's second block on
# the tiled encode's partial 128x384 tile (clusters of 8, V = 2)
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
             (2, 196608, 256, True, 1e-6, BF16),
             (2, 12288, 128, True, 1e-6, BF16),
             # the trainers' batches of 1 and 2 (phase 10): the concats of
             # 960 and 1920 channels in clusters of 8 at V = 15, the VAE
             # encoder's 128-channel blocks of one image in clusters of 8
             # at V = 1
             (1, 3072, 960, True, 1e-5, BF16),
             (1, 49152, 128, True, 1e-6, BF16)]


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


def geglu_row(gen: Gen, M: int, C: int, inner: int) -> dict:
    """K4 at rows x C -> 2 inner -> C against its plain version, with bf16
    and with fp32 biases: error, times, bound."""
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
    return r


def check_geglu(gen: Gen) -> dict:
    # the UNet's biases are bf16, and each shape also runs fp32 biases
    return summarize([geglu_row(gen, M, C, 4 * C) for M, C in GEGLU_SHAPES])


def check_tensor_parallel_rows(gen: Gen, results: dict) -> dict:
    """Phase 2's rows at the shapes a tensor-parallel UNet (model 2) gives
    K1 and K4 (``ATTN_TP_SHAPES``, ``GEGLU_TP_SHAPES``), under each
    kernel's ``tp_shapes``; returns the shapes checked, for phase 11's
    census."""
    log("phase 2: K1 on each model rank's heads and K4 on its slice of the "
        "inner width (tensor parallelism at model 2)")
    attn = [attention_row(gen, *shape) for shape in ATTN_TP_SHAPES]
    ff = [geglu_row(gen, M, C, inner) for M, C, inner in GEGLU_TP_SHAPES]
    for name, rows in (("flash_attention", attn), ("geglu", ff)):
        entry = results.setdefault(name, {})
        entry["tp_shapes"] = rows
        entry["max_abs_err"] = max([entry.get("max_abs_err", 0.0)]
                                   + [r["err"] for r in rows])
    return {"flash_attention": [list(s) for s in ATTN_TP_SHAPES],
            "geglu": [list(s) for s in GEGLU_TP_SHAPES]}


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


# phase 2's gradient rows, at the trainers' shapes (batch 1 at 512x384):
# each wrapper with inputs that need a gradient takes its autograd Function
# (the kernel's forward, the plain version's recompute as the backward);
# its gradients on bf16 inputs against fp32 autograd of the plain version
# on the same values: relative L2 of each input's gradient, limit below
# (bf16 outputs and gradients, whose half ulp is 2e-3 relative, summed
# over thousands of rows for the weights)
GRAD_LIMIT = 3e-2


def grad_row(gen: Gen, what: str, function, plain, library,
             inputs: list, lib_inputs: list = None) -> dict:
    """One gradient row: errors, every input's gradient finite, and the
    CUDA-event ms of the Function's forward plus backward against the
    library's (on its own layout of the same inputs)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = function(*leaves)
    g = gen.normal(*out.shape)
    out.backward(g)
    refs = [t.detach().float().requires_grad_(True) for t in inputs]
    plain(*refs).backward(g.float())
    torch.cuda.synchronize()
    errs = []
    for t, r in zip(leaves, refs):
        if t.grad is None or not torch.isfinite(t.grad).all():
            raise AssertionError(f"{what}: an input got no finite gradient")
        errs.append(rel_l2(t.grad.float(), r.grad))
    lib_leaves = [t.detach().clone().requires_grad_(True)
                  for t in (lib_inputs or inputs)]

    def fwd_bwd(fn, args):
        # the library's output has its own layout: the cotangent's values,
        # reshaped to it, time the same work
        def run():
            for t in args:
                t.grad = None
            y = fn(*args)
            y.backward(g.reshape(y.shape))
        return run

    return {"shape": what, "grad_rel_l2": max(errs),
            "fwd_bwd_ms": cuda_ms(fwd_bwd(function, leaves), 10),
            "library_fwd_bwd_ms": cuda_ms(fwd_bwd(library, lib_leaves), 10)}


def check_gradients(gen: Gen) -> dict:
    """Phase 2's gradient rows of every kernel, by kernel name."""
    rows = {"flash_attention": [], "group_norm": [], "geglu": [],
            "layer_norm": []}
    # (B, Sq, Sk, H, D): the UNet's level-0 and level-1 self-attention,
    # its cross-attention, the VAE mid block (EMASC trains through it)
    for B, Sq, Sk, H, D in ((1, 3072, 3072, 5, 64), (1, 768, 768, 10, 64),
                            (1, 3072, 77, 5, 64), (1, 3072, 3072, 1, 512)):
        q, k, v = (gen.normal(B, S, H, D) for S in (Sq, Sk, Sk))
        rows["flash_attention"].append(grad_row(
            gen, f"B={B} Sq={Sq} Sk={Sk} H={H} D={D}", flash_attention,
            attention_ref,
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
            [q, k, v], [t.transpose(1, 2) for t in (q, k, v)]))
    # (B, N, C, eps): the level-0 resnet, a 960-channel concat, the VAE
    # decoder's 512x384 block (split form)
    for B, N, C, eps in ((1, 3072, 320, 1e-5), (1, 3072, 960, 1e-5),
                         (1, 196608, 128, 1e-6)):
        x = gen.normal(B, N, C)
        w = gen.normal(C, scale=0.1) + 1.0
        b = gen.normal(C, scale=0.1)

        def library(xt, w, b, eps=eps):
            return F.silu(F.group_norm(xt, 32, w, b, eps))

        rows["group_norm"].append(grad_row(
            gen, f"B={B} N={N} C={C} act=silu",
            lambda x, w, b, eps=eps: group_norm(x, w, b, eps=eps,
                                                act="silu"),
            lambda x, w, b, eps=eps: group_norm_ref(x, w, b, eps=eps,
                                                    act="silu"),
            library, [x, w, b], [x.transpose(1, 2).contiguous(), w, b]))
    for M, C in ((3072, 320), (768, 640)):
        inner = 4 * C
        args = [gen.normal(M, C), gen.normal(2 * inner, C, scale=C ** -0.5),
                gen.normal(2 * inner, scale=0.1),
                gen.normal(C, inner, scale=inner ** -0.5),
                gen.normal(C, scale=0.1)]

        def library(x, w1, b1, w2, b2):
            h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), w2, b2)

        rows["geglu"].append(grad_row(gen, f"rows={M} C={C} I={inner}",
                                      geglu, geglu_ref, library, args))
    for M, C in ((3072, 320), (77, 1024)):
        args = [gen.normal(M, C, scale=2.0) + 0.5,
                gen.normal(C, scale=0.1) + 1.0, gen.normal(C, scale=0.1)]
        rows["layer_norm"].append(grad_row(
            gen, f"rows={M} C={C}", layer_norm, layer_norm_ref,
            lambda x, w, b, C=C: F.layer_norm(x, (C,), w, b, 1e-5), args))
    for name, rs in rows.items():
        for r in rs:
            log(f"{name} gradient {r['shape']} (kernel forward, recompute "
                f"backward): grad_rel_l2 {r['grad_rel_l2']:.3e} (limit "
                f"{GRAD_LIMIT}), every input a finite gradient; forward + "
                f"backward {r['fwd_bwd_ms']:.4f} ms, library forward + "
                f"backward {r['library_fwd_bwd_ms']:.4f} ms (CUDA events, "
                f"back to back)")
            if not r["grad_rel_l2"] <= GRAD_LIMIT:
                raise AssertionError(f"{name} gradient disagrees: {r}")
    return {name: {"fwd_bwd_ms": rs[0]["fwd_bwd_ms"],
                   "library_fwd_bwd_ms": rs[0]["library_fwd_bwd_ms"],
                   "grad_rel_l2": max(r["grad_rel_l2"] for r in rs),
                   "shapes": rs} for name, rs in rows.items()}


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
    """The sampler at full width on a 128x128 input, card vs CPU, under
    each scheduler (a few steps: PNDM's plan of 2 runs the UNet 3 times,
    DPM-Solver++ at 3 steps takes one second-order step), then DDIM with
    the cross-attention K/V hoisted against the inline form on the card.
    Both devices prepare once; the schedulers share the prepared
    inputs."""
    cpu_pipe = TryOnPipeline(
        unet=cpu_copy(pipe.unet, lambda: UNet2DCondition(sd2_unet_config(31))),
        vae=cpu_copy(pipe.vae, lambda: AutoencoderKL(VAEConfig())),
        emasc=cpu_copy(pipe.emasc, EMASC), scheduler=DDIMScheduler())
    req = request(np.random.default_rng(5), 1, 128, 128)
    t = {k: torch.from_numpy(req[k]) for k in (
        "image", "inpaint_mask", "pose_map", "warped_cloth", "prompt_embeds",
        "negative_prompt_embeds")}
    noise = {k: torch.from_numpy(np.random.default_rng(6 + i)
                                 .standard_normal((1, 16, 16, 4))
                                 .astype(np.float32))
             for i, k in enumerate(("latents", "masked", "cloth"))}
    prepared = {}
    for p in (pipe, cpu_pipe):
        prepared[p] = p.prepare(image=t["image"], mask_image=t["inpaint_mask"],
                                pose_map=t["pose_map"],
                                warped_cloth=t["warped_cloth"], noise=noise)

    def denoise(p: TryOnPipeline, steps: int, **change) -> torch.Tensor:
        inputs = {k: v for k, v in prepared[p].items() if k != "intermediate"}
        return dataclasses.replace(p, **change).denoise(
            inputs, prompt_embeds=t["prompt_embeds"],
            negative_prompt_embeds=t["negative_prompt_embeds"],
            num_inference_steps=steps, guidance_scale=7.5)

    for name, steps in SMALL_SAMPLES:
        lats, images = [], []
        for p in (pipe, cpu_pipe):
            lat = denoise(p, steps, scheduler=make_scheduler(name))
            lats.append(lat.float().cpu())
            images.append(p.decode(lat, prepared[p]["intermediate"]).cpu())
        lat_err = rel_l2(*lats)
        img_err = float((images[0] - images[1]).abs().mean())
        log(f"integration sampler SD-2 width 128x128 {name}-{steps} CFG 7.5: "
            f"latents rel_l2 {lat_err:.3e} (limit {LATENT_LIMIT}), image mean "
            f"abs {img_err:.3e} (limit {IMAGE_MEAN_LIMIT})")
        if not (torch.isfinite(images[0]).all() and lat_err <= LATENT_LIMIT
                and img_err <= IMAGE_MEAN_LIMIT):
            raise AssertionError(f"the sampler under {name} disagrees with "
                                 f"the CPU")
        if name == "ddim":
            inline = lats[0]
    hoisted = denoise(pipe, 2, hoist_context_kv=True).float().cpu()
    diff = float((hoisted - inline).abs().max())
    log(f"integration sampler ddim-2 with the cross-attention K/V hoisted: "
        f"max abs difference from the inline form {diff:.3e} (limit 0: the "
        f"same products of the same inputs)")
    if diff != 0.0:
        raise AssertionError("the hoisted K/V sampler disagrees with the "
                             "inline one")


@torch.no_grad()
def check_tiled_decode(vae: AutoencoderKL) -> None:
    """``tiled_decode`` at full VAE width on a 16x16 latent with tiles of
    8 (stride 6: tiles of 8, 8 and 4 latent pixels a side, blended over
    16 pixels), the card's bf16 VAE against its fp32 twin on the CPU."""
    z = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 4, 16, 16)).astype(np.float32))
    out = vae.tiled_decode(z.cuda(), tile=8).cpu()
    ref = cpu_copy(vae, lambda: AutoencoderKL(VAEConfig())).tiled_decode(
        z, tile=8)
    err = rel_l2(out, ref)
    log(f"integration tiled decode SD-2 VAE width, 16x16 latent, tile 8: "
        f"rel_l2 {err:.3e} (limit {DECODE_LIMIT})")
    if not (out.shape == (1, 3, 128, 128) and torch.isfinite(out).all()
            and err <= DECODE_LIMIT):
        raise AssertionError("the tiled decode disagrees with the CPU")


def synthetic_tokenizer(root: pathlib.Path) -> CLIPTokenizer:
    """Write a CLIP BPE vocabulary made as the repository's tests make
    one (every byte symbol alone and at a word's end, so ``$</w>`` is id
    259; one merge, ``t o</w>``; the specials 49406 and 49407: every id
    inside the text tower's 49408) into ``root``, and load it with the
    port's tokenizer.  The SD-2 vocabulary is not in the repository."""
    symbols = list(_bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols)}
    for s in symbols:
        vocab[s + "</w>"] = len(vocab)
    vocab["to</w>"] = len(vocab)
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\nt o</w>\n")
    tokenizer = CLIPTokenizer.from_dir(root)
    if tokenizer.encode(" $ ") != [259]:
        raise AssertionError("the synthetic vocabulary lost '$' -> 259")
    return tokenizer


def conditioner(device: str, image_size: tuple, tokenizer,
                clip_layers=None) -> Conditioner:
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

    empty_ids = torch.from_numpy(tokenizer([""])[0].astype(np.int64))
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
def check_conditioner(tokenizer) -> None:
    h, w = 256, 192
    cond = conditioner("cuda", (h, w), tokenizer, clip_layers=2)
    raw = raw_request(np.random.default_rng(7), 1, h, w)
    results = []
    for c, device in ((cond, "cuda"), (cpu_conditioner(cond), "cpu")):
        service = ConditionService(c, tokenizer, batch_size=1,
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


def check_census(census: GroupNormCensus,
                 what: str = "one 2-image request") -> None:
    """Log the GroupNorm calls of ``what`` with K2's plan for each, and
    fail unless phase 2 checked every kernel instantiation among them
    (``plan_kernel``)."""
    covered = {plan_kernel(gn_plan(*shape[:3])) for shape in GN_SHAPES}
    for (B, N, C, act, eps, wdt), n in sorted(census.calls.items()):
        p = gn_plan(B, N, C)
        log(f"K2 census: {n:4d} x (B={B}, N={N}, C={C}) act={act} "
            f"eps={eps} weights={wdt}: {describe_plan(p)}")
        if plan_kernel(p) not in covered:
            raise AssertionError(f"phase 2 does not check K2's plan for "
                                 f"{(B, N, C)}: {p}")
    log(f"K2 census of {what}: {sum(census.calls.values())} calls, "
        f"{census.kernels()} kernel launches")


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


def answer(cond: ConditionService, service: TryOnService, raw: dict,
           seed: int) -> dict:
    """One raw request through both services, the try-on's draws from a
    generator seeded with ``seed``: the outputs, the conditioning and
    total seconds (host clock, synchronised) and the K5 launch count
    between the stages."""
    t0 = time.perf_counter()
    warped, embeds, negative = cond.run(
        cloth=raw["cloth"], pose_map=raw["pose_map"], im_mask=raw["im_mask"],
        categories=raw["categories"])
    torch.cuda.synchronize()
    t_cond = time.perf_counter() - t0
    ln_cond = layer_norm.launches
    out = service.generate(
        image=raw["image"], inpaint_mask=raw["inpaint_mask"],
        pose_map=raw["pose_map"], warped_cloth=warped, prompt_embeds=embeds,
        negative_prompt_embeds=negative,
        generator=torch.Generator(service.pipe.device).manual_seed(seed))
    torch.cuda.synchronize()
    return {"warped": warped, "embeds": embeds, "negative": negative,
            "out": out, "t_cond": t_cond,
            "total": time.perf_counter() - t0, "ln_cond": ln_cond}


def check_raw_output(r: dict, n: int, h: int, w: int, what: str) -> None:
    warped, embeds, negative, out = (r[k] for k in (
        "warped", "embeds", "negative", "out"))
    if not (warped.shape == (n, h, w, 3) and np.isfinite(warped).all()
            and warped.min() >= -1.0 and warped.max() <= 1.0
            and embeds.shape == negative.shape == (n, 77, 1024)
            and np.isfinite(embeds).all() and np.isfinite(negative).all()
            and out.shape == (n, h, w, 3) and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 1.0):
        raise AssertionError(f"{what}: bad output")


def serve_raw_requests(service: TryOnService, wrappers: dict,
                       tokenizer) -> tuple:
    """Phase 5: ConditionService -> TryOnService at full width; returns
    the kernels' launches over the two requests, the conditioner, and the
    2-image request (its inputs, seed and outputs) for phase 6."""
    h, w = service.height, service.width
    cond = ConditionService(conditioner("cuda", (h, w), tokenizer), tokenizer,
                            batch_size=service.batch_size,
                            num_vstar=NUM_VSTAR)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    answer(cond, service, raw_request(rng, 2, h, w), seed=100)
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
            r = answer(cond, service, raw, seed=100 + n)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"raw request of {n} image(s) ({', '.join(raw['categories'])}) "
            f"at {h}x{w}: conditioning {r['t_cond']:.3f} s, total "
            f"{r['total']:.3f} s (DDIM-{service.num_inference_steps}, CFG "
            f"{service.guidance_scale}, batch {service.batch_size}), peak "
            f"device memory {peak:.2f} GiB, warped cloth in "
            f"[{r['warped'].min():.4f}, {r['warped'].max():.4f}], prompt "
            f"embeds std {r['embeds'].std():.4f}, output in "
            f"[{r['out'].min():.4f}, {r['out'].max():.4f}] std "
            f"{r['out'].std():.4f}; K5 launches: conditioning "
            f"{r['ln_cond'] - ln_before}, try-on "
            f"{layer_norm.launches - r['ln_cond']}; K2 calls "
            f"{group_norm.launches - gn_before}, K2 kernel launches "
            f"{census.kernels()}")
        check_raw_output(r, n, h, w, f"raw request of {n}")
        if not (r["ln_cond"] > ln_before
                and layer_norm.launches > r["ln_cond"]):
            raise AssertionError("K5 was not launched in both stages")
        check_layer_norm_census(ln_census, f"a raw request of {n} image(s)")
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    return launches, cond.conditioner, {"raw": raw, "seed": 100 + n, **r}


def module_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def write_checkpoints(root: pathlib.Path, pipe: TryOnPipeline,
                      cond: Conditioner) -> None:
    """Phase 6, step 1: the seeded full-width modules of phases 4 and 5
    as the reference's files, in the dtype each holds: the four releases
    under ``ladi/`` (the UNet 31 channels wide, as the released file is),
    an SD-2 directory (``vae/`` as ``.safetensors``, ``text_encoder/``
    as ``.bin``) and a CLIP vision directory (``.safetensors``), each
    with its ``config.json``.  The tokenizer files are already under
    ``sd2/tokenizer``."""
    ladi, sd2, clip = root / "ladi", root / "sd2", root / "clip_vision"
    for d in (ladi, sd2 / "vae", sd2 / "text_encoder", clip):
        d.mkdir(parents=True, exist_ok=True)
    torch.save(module_state(pipe.unet), ladi / "unet_vitonhd.pth")
    torch.save(module_state(pipe.emasc), ladi / "emasc_vitonhd.pth")
    torch.save(module_state(cond.adapter),
               ladi / "inversion_adapter_vitonhd.pth")
    torch.save({"tps": module_state(cond.tps),
                "refinement": module_state(cond.refinement)},
               ladi / "warping_vitonhd.pth")
    save_safetensors(module_state(pipe.vae),
                     sd2 / "vae" / "diffusion_pytorch_model.safetensors")
    (sd2 / "vae" / "config.json").write_text(json.dumps(
        {"_class_name": "AutoencoderKL",
         **dataclasses.asdict(pipe.vae.config)}))
    torch.save(module_state(cond.text_model),
               sd2 / "text_encoder" / "pytorch_model.bin")
    (sd2 / "text_encoder" / "config.json").write_text(json.dumps(
        {"architectures": ["CLIPTextModel"],
         **dataclasses.asdict(cond.text_model.config)}))
    save_safetensors(module_state(cond.vision), clip / "model.safetensors")
    (clip / "config.json").write_text(json.dumps(
        {"architectures": ["CLIPVisionModelWithProjection"],
         "vision_config": dataclasses.asdict(cond.vision.config)}))


def check_same_state(ours: torch.nn.Module, ref: torch.nn.Module,
                     what: str) -> None:
    a, b = ours.state_dict(), ref.state_dict()
    if list(a) != list(b) or not all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in b):
        raise AssertionError(f"the zoo's {what} differs from the module "
                             f"written")


@torch.no_grad()
def check_conv_in_surgery(root: pathlib.Path, unet: UNet2DCondition) -> None:
    """Phase 6: the UNet release cut back to the stock 9 input channels,
    through the zoo: channels 0-8 as written, 9-30 zero, the rest
    equal."""
    stock = root / "stock"
    stock.mkdir()
    state = module_state(unet)
    torch.save({**state, "conv_in.weight": state["conv_in.weight"][:, :9]
                .clone()}, stock / "unet_vitonhd.pth")
    widened = zoo.extended_unet(checkpoint_dir=stock, dtype=BF16,
                                device=unet.conv_in.weight.device)
    (stock / "unet_vitonhd.pth").unlink()
    ours, ref = widened.state_dict(), unet.state_dict()
    w, w_ref = ours.pop("conv_in.weight"), ref.pop("conv_in.weight")
    ok = (w.shape == w_ref.shape and torch.equal(w[:, :9], w_ref[:, :9])
          and not w[:, 9:].any() and list(ours) == list(ref)
          and all(torch.equal(ours[k], ref[k]) for k in ref))
    log(f"phase 6: a 9-channel UNet release widened by the zoo to "
        f"{w.shape[1]} input channels: channels 0-8 as written, 9-"
        f"{w.shape[1] - 1} zero, every other tensor equal: {ok}")
    if not ok:
        raise AssertionError("the conv_in surgery is wrong")


@torch.no_grad()
def tiled_vae(vae: AutoencoderKL) -> None:
    """Phase 6: encode and decode at 512x384, batch 2, untiled and tiled
    with the JAX defaults (tile 512 for the encode, 64 latent pixels for
    the decode, overlap 0.25): seconds (host clock, synchronised, after a
    warm-up call) and peak device memory above what was allocated before
    the call; then both tiled calls under the K2 census."""
    rng = np.random.default_rng(11)
    dev = vae.quant_conv.weight.device
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 512, 384)).astype(
        np.float32)).to(dev)
    z = torch.from_numpy(rng.standard_normal((2, 4, 64, 48)).astype(
        np.float32)).to(dev)
    calls = (
        ("encode", lambda: vae.encode(x)[0], (2, 8, 64, 48)),
        ("tiled encode (tile 512, overlap 0.25)",
         lambda: vae.tiled_encode(x, tile=512, overlap=0.25), (2, 8, 64, 48)),
        ("decode", lambda: vae.decode(z), (2, 3, 512, 384)),
        ("tiled decode (tile 64, overlap 0.25)",
         lambda: vae.tiled_decode(z, tile=64, overlap=0.25),
         (2, 3, 512, 384)))
    for name, fn, shape in calls:
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log(f"VAE {name} at 512x384, batch 2, bf16: {dt:.4f} s, peak device "
            f"memory above the resident {base / 2 ** 30:.2f} GiB: "
            f"{peak:.3f} GiB, output {tuple(out.shape)} {out.dtype}")
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise AssertionError(f"VAE {name}: bad output")
    with GroupNormCensus(vae) as census:
        vae.tiled_encode(x, tile=512, overlap=0.25)
        vae.tiled_decode(z, tile=64, overlap=0.25)
    check_census(census, "the tiled encode and decode")


@torch.no_grad()
def zoo_path(root: pathlib.Path, pipe: TryOnPipeline, cond: Conditioner,
             record: dict, wrappers: dict) -> dict:
    """Phase 6: write the checkpoints, load them through the port's zoo,
    and serve phase 5's 2-image raw request from the loaded modules under
    DDIM-50 (bitwise equal to phase 5's answer) and under the other
    schedulers; then the conv_in surgery and the tiled VAE.  Returns the
    kernels' launches over the four requests, and the loaded pipeline and
    conditioner."""
    t0 = time.perf_counter()
    write_checkpoints(root, pipe, cond)
    free = shutil.disk_usage(root).free / 2 ** 30
    log(f"phase 6: reference-layout checkpoints written in "
        f"{time.perf_counter() - t0:.2f} s ({free:.1f} GiB free there)")
    ladi, sd2 = root / "ladi", str(root / "sd2")
    t0 = time.perf_counter()
    tokenizer = CLIPTokenizer.from_dir(root / "sd2" / "tokenizer")
    on = dict(dtype=BF16, device=pipe.device)
    zpipe = TryOnPipeline(
        unet=zoo.extended_unet(checkpoint_dir=ladi, **on),
        vae=zoo.sd2_vae(sd2, **on), scheduler=make_scheduler("ddim"),
        emasc=zoo.emasc(checkpoint_dir=ladi, **on))
    tps, refinement = zoo.warping_module(checkpoint_dir=ladi,
                                         device=pipe.device)
    zcond = dataclasses.replace(
        cond, tps=tps, refinement=refinement,
        vision=zoo.clip_vit_h_vision(str(root / "clip_vision"), **on),
        adapter=zoo.inversion_adapter(checkpoint_dir=ladi, **on),
        text_model=zoo.sd2_text_encoder(sd2, **on),
        empty_ids=torch.from_numpy(tokenizer([""])[0].astype(np.int64)))
    torch.cuda.synchronize()
    log(f"phase 6: every module loaded through ladi_vton_tpu_torch.hub.zoo "
        f"onto the card in {time.perf_counter() - t0:.2f} s")
    for what, ours, ref in (
            ("UNet", zpipe.unet, pipe.unet), ("VAE", zpipe.vae, pipe.vae),
            ("EMASC", zpipe.emasc, pipe.emasc), ("TPS", tps, cond.tps),
            ("refinement", refinement, cond.refinement),
            ("vision tower", zcond.vision, cond.vision),
            ("adapter", zcond.adapter, cond.adapter),
            ("text encoder", zcond.text_model, cond.text_model)):
        check_same_state(ours, ref, what)
    check_conv_in_surgery(root, pipe.unet)

    h, w = 512, 384
    csvc = ConditionService(zcond, tokenizer, batch_size=2,
                            num_vstar=NUM_VSTAR, device=pipe.device)
    for wrapper in wrappers.values():
        wrapper.launches = 0
    for name, steps in ZOO_REQUESTS:
        service = TryOnService(
            dataclasses.replace(zpipe, scheduler=make_scheduler(name)),
            batch_size=2, height=h, width=w, num_inference_steps=steps,
            guidance_scale=7.5, context_dim=1024, seed=0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = answer(csvc, service, record["raw"], record["seed"])
        peak = torch.cuda.max_memory_allocated()
        log(f"zoo raw request of 2 images at {h}x{w}, {name}-{steps}, CFG "
            f"7.5, batch 2: conditioning {r['t_cond']:.3f} s, total "
            f"{r['total']:.3f} s, peak device memory {peak / 2 ** 30:.2f} GiB "
            f"({(peak - base) / 2 ** 30:.2f} GiB above the resident weights), "
            f"output in [{r['out'].min():.4f}, {r['out'].max():.4f}] std "
            f"{r['out'].std():.4f}")
        check_raw_output(r, 2, h, w, f"zoo raw request under {name}")
        if name == "ddim":
            same = all(np.array_equal(r[k], record[k])
                       for k in ("warped", "embeds", "negative", "out"))
            log(f"zoo raw request under ddim-50: warped cloth, embeddings "
                f"and image bitwise equal to phase 5's: {same}")
            if not same:
                raise AssertionError("the zoo-loaded modules answer phase "
                                     "5's request differently")
    launches = {n: wrapper.launches for n, wrapper in wrappers.items()}
    tiled_vae(zpipe.vae)
    return launches, zpipe, zcond


# phase 7: the source size of both datasets, the model's size, and the
# settings of each CLI run
SOURCE_SIZE = (1024, 768)
RELEASES = ("unet", "emasc", "inversion_adapter", "warping")


def reset_counts(wrappers: dict) -> None:
    for wrapper in wrappers.values():
        wrapper.launches = 0
    group_norm.forms.update(cluster=0, split=0)


def main_counts(wrappers: dict) -> dict:
    """The kernels' launch counts since ``reset_counts``, K2's by form."""
    counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
    counts.update({f"group_norm_{form}": n
                   for form, n in group_norm.forms.items()})
    return counts


def write_datasets(root: pathlib.Path) -> dict:
    """Phase 7, step 1: a DressCode (one category, 2 pairs) and a VITON-HD
    (2 pairs) test split at the datasets' 1024x768, with the warped-cloth
    and CLIP-feature caches, written with the port's PNG writer under the
    datasets' file names."""
    return {
        "dresscode": synthetic.write_dresscode(
            root / "dc" / "dresscode", category="upper_body", n_pairs=2,
            size=SOURCE_SIZE, seed=70),
        "vitonhd": synthetic.write_vitonhd(
            root / "vh" / "vitonhd", n_pairs=2, size=SOURCE_SIZE, seed=71),
    }


def main_runs(work: pathlib.Path, roots: dict, out: pathlib.Path,
              device: str = "cuda") -> list:
    """(label, main, argv, direct-path kind or None) of phase 7's runs."""
    ladi, sd2 = work / "ladi", work / "sd2"
    runs = []
    for dataset in ("dresscode", "vitonhd"):
        data = [f"--{dataset}_dataroot", str(roots[dataset])]
        if dataset == "dresscode":
            data += ["--category", "upper_body"]
        common = ["--dataset", dataset, *data, "--test_order", "paired",
                  "--batch_size", "2", "--num_workers", "2", "--seed", "7",
                  "--device", device]
        runs.append((f"inference {dataset}", inference_cli.main, common + [
            "--output_dir", str(out / f"inference_{dataset}"),
            "--checkpoint_dir", str(ladi), "--sd2_model_dir", str(sd2),
            "--clip_vision_dir", str(work / "clip_vision"),
            "--tokenizer_dir", str(sd2 / "tokenizer"),
            "--num_inference_steps", "50", "--guidance_scale", "7.5",
            "--use_png"], "inference"))
        runs.append((f"eval {dataset}", eval_cli.main, common + [
            "--output_dir", str(out / f"eval_{dataset}"), "--save_name",
            "run", "--unet_dir", str(ladi),
            "--unet_name", f"unet_{dataset}.pth", "--emasc_dir", str(ladi),
            "--emasc_name", f"emasc_{dataset}.pth",
            "--inversion_adapter_dir", str(ladi),
            "--inversion_adapter_name", f"inversion_adapter_{dataset}.pth",
            "--sd2_model_dir", str(sd2), "--scheduler", "dpm",
            "--num_inference_steps", "20", "--use_clip_cloth_features",
            "--use_png"], "eval"))
    dresscode = runs[0]
    runs.append(("inference dresscode, JPEG output", inference_cli.main,
                  [a.replace("inference_dresscode", "inference_jpeg")
                   for a in dresscode[2] if a != "--use_png"], None))
    return runs


def to_device(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)


@torch.no_grad()
def direct_images(kind: str, argv: list, pipe: TryOnPipeline,
                  cond: Conditioner, tokenizer) -> list:
    """What the port's Conditioner and TryOnPipeline, called directly,
    give for each batch of a main's run: (batch, uint8 images)."""
    args = (inference_cli if kind == "inference" else eval_cli).parse_args(
        argv)
    keys = ["image", "pose_map", "inpaint_mask", "im_mask", "category",
            "im_name", "cloth"]
    if kind == "eval":
        keys += ["warped_cloth", "clip_cloth_features"]
    size = (args.height, args.width)
    if args.dataset == "dresscode":
        dataset = DressCodeDataset(args.dresscode_dataroot, phase="test",
                                   order=args.test_order, outputlist=keys,
                                   category=(args.category,), size=size)
    else:
        dataset = VitonHDDataset(args.vitonhd_dataroot, phase="test",
                                 order=args.test_order, outputlist=keys,
                                 size=size)
    pipe = dataclasses.replace(pipe, scheduler=make_scheduler(args.scheduler))
    dev = pipe.device
    empty = cond.empty_ids.to(dev)
    out = []
    loader = BatchLoader(dataset, args.batch_size, num_workers=0,
                         pad_last=True)
    for step, b in enumerate(loader):
        ids = to_device(np.asarray(tokenizer(category_prompts(
            b["category"], NUM_VSTAR))), dev, torch.long)
        if kind == "inference":
            warped, ehs, neg = cond(to_device(b["pose_map"], dev),
                                    to_device(b["cloth"], dev),
                                    to_device(b["im_mask"], dev), ids)
        else:
            ptes = cond.adapter(to_device(b["clip_cloth_features"], dev,
                                          cond.dtype))
            ehs, _ = encode_text_word_embedding(cond.text_model, ids, ptes,
                                                NUM_VSTAR)
            neg, _ = cond.text_model(empty.expand_as(ids))
            warped = to_device(b["warped_cloth"], dev)
        images = pipe.sample(
            image=to_device(b["image"], dev),
            mask_image=to_device(b["inpaint_mask"], dev),
            pose_map=to_device(b["pose_map"], dev), warped_cloth=warped,
            prompt_embeds=ehs, negative_prompt_embeds=neg,
            generator=batch_generator(args.seed, step, dev),
            num_inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale)
        u8 = torch.round(images.float().clamp(0.0, 1.0) * 255.0)
        out.append((b, u8.to(torch.uint8).cpu().numpy()))
    return out


def check_saved(save_dir: pathlib.Path, direct: list, label: str) -> int:
    """Every image a main saved equals the direct path's, bit for bit;
    returns how many were compared."""
    compared = 0
    for batch, images in direct:
        for img, name, cat in zip(images, batch["im_name"],
                                  batch["category"]):
            saved = imageio.open_image(
                save_dir / cat / name.replace(".jpg", ".png")).pixels
            if not np.array_equal(saved, img):
                raise AssertionError(
                    f"{label}: {cat}/{name} differs from the direct path "
                    f"(max abs difference "
                    f"{np.abs(saved.astype(int) - img).max()})")
            compared += 1
    files = list(save_dir.rglob("*.png"))
    if len(files) != len({(c, n) for b, _ in direct
                          for c, n in zip(b["category"], b["im_name"])}):
        raise AssertionError(f"{label}: {len(files)} files saved")
    return compared


def check_jpegs(save_dir: pathlib.Path, label: str) -> int:
    files = sorted(save_dir.rglob("*.jpg"))
    for path in files:
        markers = imageio.jpeg_markers(path.read_bytes())
        if not (markers[0] == 0xD8 and markers[-1] == 0xD9
                and {0xDB, 0xC0} <= set(markers)):
            raise AssertionError(f"{label}: {path.name} markers {markers}")
    if not files:
        raise AssertionError(f"{label}: no JPEG written")
    return len(files)


def mains_path(work: pathlib.Path, pipe: TryOnPipeline, cond: Conditioner,
               wrappers: dict, smi: str) -> tuple:
    """Phase 7: the CLIs over DressCode and VITON-HD trees at 1024x768,
    from phase 6's reference-layout checkpoints; every saved image held
    bitwise to the direct path.  Returns the kernels' launches summed
    over the mains, and the trees' roots."""
    t0 = time.perf_counter()
    roots = write_datasets(work / "data")
    ladi = work / "ladi"
    for name in RELEASES:
        for suffix in (".pth", ".config.json"):
            src = ladi / f"{name}_vitonhd{suffix}"
            link = ladi / f"{name}_dresscode{suffix}"
            if src.exists() and not link.exists():
                os.symlink(src, link)
    log(f"phase 7: DressCode and VITON-HD test splits written at "
        f"{SOURCE_SIZE[0]}x{SOURCE_SIZE[1]} in "
        f"{time.perf_counter() - t0:.2f} s")
    tokenizer = CLIPTokenizer.from_dir(work / "sd2" / "tokenizer")
    out = work / "out"
    total = {}
    for label, main_fn, argv, kind in main_runs(work, roots, out):
        torch.cuda.synchronize()
        reset_counts(wrappers)
        t_main = time.perf_counter()
        stats = main_fn(argv)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t_main
        counts = main_counts(wrappers)
        log(f"phase 7 {label}: main {t_main:.3f} s wall with the weights' "
            f"load ({stats['images'] / t_main:.4f} images/s), its batch "
            f"loop {stats['seconds']:.3f} s ({stats['images']} images in "
            f"{stats['batches']} batches, {stats['images_per_second']:.4f} "
            f"images/s), loader {stats['loader_seconds_per_batch']:.3f} s "
            f"per batch, host clock; launches {counts} [{smi}]")
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: "
                                 f"{missing}")
        for name in wrappers:
            total[name] = total.get(name, 0) + counts[name]
        save = pathlib.Path(argv[argv.index("--output_dir") + 1])
        if kind == "eval":
            save = save / "run"
        save = save / "paired"
        if kind is None:
            log(f"phase 7 {label}: {check_jpegs(save, label)} JPEG files, "
                f"markers SOI, DQT, SOF0, DHT, SOS, EOI")
            continue
        n = check_saved(save, direct_images(kind, argv, pipe, cond,
                                            tokenizer), label)
        log(f"phase 7 {label}: {n} saved images bitwise equal to the "
            f"direct Conditioner/TryOnPipeline path")
    log(f"phase 7: the CLIs ({time.perf_counter() - t0:.1f} s)")
    return total, roots


# phase 8: the in-process server's batch, the batcher's delay and the
# spacing of its three concurrent requests (far enough apart to arrive in
# order, well inside the delay, so they form one group of 4 in that
# order), the services' seed, and the limits on waiting
SERVE_BATCH = 4
SERVE_DELAY_MS = 5000.0
SERVE_SPACING_S = 1.0
SERVE_SEED = 21
SERVE_TIMEOUT_S = 300.0
SERVE_START_TIMEOUT_S = 300.0
SERVE_EXIT_TIMEOUT_S = 60.0
REPO = pathlib.Path(__file__).resolve().parent


def served_request(rng: np.random.Generator, n: int, h: int,
                   w: int) -> dict:
    """A /tryon request as a client sends one: pose heatmaps zero but for
    a blob per keypoint, so the ``.npz`` body compresses as a real one."""
    req = request(rng, n, h, w)
    pose = np.zeros((n, h, w, 18), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        for k in range(18):
            y, x = rng.integers(0, h), rng.integers(0, w)
            blob = np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 81.0)
            pose[i, ..., k] = np.where(blob > 1e-3, blob, 0.0)
    req["pose_map"] = pose
    return req


def start_server(service, cond, delay_ms: float):
    batcher = MicroBatcher(service, max_delay_ms=delay_ms)
    server = make_http_server(batcher, port=0, condition_service=cond)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    return batcher, server, thread, f"http://{host}:{port}"


def tryon_arrays(raw: dict, cond_out: tuple) -> dict:
    warped, embeds, negative = cond_out
    return dict(image=raw["image"], inpaint_mask=raw["inpaint_mask"],
                pose_map=raw["pose_map"], warped_cloth=warped,
                prompt_embeds=embeds, negative_prompt_embeds=negative)


def client_raw(client: TryOnClient, raw: dict) -> dict:
    """A raw request through /condition then /tryon, host clock."""
    t0 = time.perf_counter()
    c = client.condition(cloth=raw["cloth"], pose_map=raw["pose_map"],
                         im_mask=raw["im_mask"], categories=raw["categories"])
    t_cond = time.perf_counter() - t0
    cond_out = (c["warped_cloth"], c["prompt_embeds"],
                c["negative_prompt_embeds"])
    out = client.tryon(**tryon_arrays(raw, cond_out))
    return {"cond": cond_out, "out": out, "t_cond": t_cond,
            "total": time.perf_counter() - t0}


def direct_raw(cond: ConditionService, service: TryOnService,
               raw: dict) -> dict:
    """The same raw request through the services called directly."""
    t0 = time.perf_counter()
    cond_out = cond.run(cloth=raw["cloth"], pose_map=raw["pose_map"],
                        im_mask=raw["im_mask"], categories=raw["categories"])
    torch.cuda.synchronize()
    t_cond = time.perf_counter() - t0
    out = service.generate(**tryon_arrays(raw, cond_out))
    torch.cuda.synchronize()
    return {"cond": cond_out, "out": out, "t_cond": t_cond,
            "total": time.perf_counter() - t0}


def npz_seconds(arrays: dict) -> tuple:
    """Host seconds and megabytes of one compressed ``.npz`` body, the wire
    format both clients and servers write."""
    buf = io.BytesIO()
    t0 = time.perf_counter()
    np.savez_compressed(buf, **arrays)
    return time.perf_counter() - t0, len(buf.getvalue()) / 2 ** 20


def bitwise(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def same_answer(a: dict, b: dict) -> bool:
    return all(bitwise(x, y) for x, y in zip(a["cond"] + (a["out"],),
                                             b["cond"] + (b["out"],)))


def post_status(url: str, body: bytes) -> int:
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body, method="POST"), timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def serve_concurrently(client: TryOnClient, group: list) -> tuple:
    """The group's /tryon requests, each from its own thread, started
    SERVE_SPACING_S apart: (answers, seconds of each, errors)."""
    answers, seconds, errors = [None] * len(group), [0.0] * len(group), []

    def send(i):
        try:
            t0 = time.perf_counter()
            answers[i] = client.tryon(**group[i])
            seconds[i] = time.perf_counter() - t0
        except Exception as e:
            errors.append(e)

    threads = []
    for i in range(len(group)):
        if i:
            time.sleep(SERVE_SPACING_S)
        threads.append(threading.Thread(target=send, args=(i,)))
        threads[-1].start()
    for t in threads:
        t.join(SERVE_TIMEOUT_S)
    return answers, seconds, errors


def serving_path(work: pathlib.Path, pipe: TryOnPipeline, cond: Conditioner,
                 wrappers: dict, smi: str) -> tuple:
    """Phase 8, in process: ``make_http_server`` over a ``MicroBatcher``
    around phase 6's zoo-loaded modules (batch 4, DDIM-50), answering a
    2-image raw request through the port's client and a group of three
    concurrent requests, each held bitwise to the services called
    directly.  Returns the kernels' launches over the served requests,
    and the raw request and its answer for the ``cli.serve`` process."""
    h, w = cond.image_size
    tokenizer = CLIPTokenizer.from_dir(work / "sd2" / "tokenizer")

    def services():
        return (TryOnService(pipe, batch_size=SERVE_BATCH, height=h, width=w,
                             num_inference_steps=50, guidance_scale=7.5,
                             context_dim=pipe.unet.config.cross_attention_dim,
                             seed=SERVE_SEED),
                ConditionService(cond, tokenizer, batch_size=SERVE_BATCH,
                                 num_vstar=NUM_VSTAR, device=pipe.device))

    rng = np.random.default_rng(80)
    raw = raw_request(rng, 2, h, w)
    group = [served_request(rng, n, h, w) for n in (1, 1, 2)]
    service, csvc = services()
    torch.cuda.synchronize()
    reset_counts(wrappers)
    batcher, server, thread, url = start_server(service, csvc,
                                                SERVE_DELAY_MS)
    try:
        client = TryOnClient(url, timeout_s=SERVE_TIMEOUT_S)
        served = client_raw(client, raw)
        t0 = time.perf_counter()
        answers, seconds, errors = serve_concurrently(client, group)
        t_group = time.perf_counter() - t0
        if errors or any(a is None for a in answers):
            raise AssertionError(f"concurrent requests failed: {errors}")
        bad = post_status(url + "/tryon", b"not an npz")
        health = client.healthz()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(SERVE_TIMEOUT_S)
    torch.cuda.synchronize()
    launches = main_counts(wrappers)
    log(f"phase 8: launches over the served requests {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched serving: {missing}")
    if bad != 400:
        raise AssertionError(f"a malformed payload answered {bad}, not 400")
    counts = {k: health[k] for k in ("batches_done", "requests_done",
                                     "samples_done", "errors")}
    log(f"phase 8: /healthz after the requests {counts}; a malformed "
        f"payload answered {bad}")
    if counts != {"batches_done": 2, "requests_done": 4, "samples_done": 6,
                  "errors": 0}:
        raise AssertionError(f"/healthz counts {counts}")

    # the services called directly: a fresh TryOnService of the same seed
    # draws for request 0 (the raw request), then request 1 (the group)
    ref_service, _ = services()
    direct = direct_raw(csvc, ref_service, raw)
    same = same_answer(served, direct)
    log(f"phase 8: raw request of 2 images over HTTP (/condition "
        f"{served['t_cond']:.3f} s, with /tryon {served['total']:.3f} s, "
        f"batch {SERVE_BATCH} after the batcher's {SERVE_DELAY_MS:.0f} ms "
        f"wait for a fuller group) against the services called directly "
        f"(conditioning {direct['t_cond']:.3f} s, total "
        f"{direct['total']:.3f} s): bitwise equal {same} [{smi}]")
    if not same:
        raise AssertionError("the served raw request differs from the "
                             "services called directly")
    bodies = {
        "/condition request": {k: raw[k] for k in ("cloth", "pose_map",
                                                   "im_mask")},
        "/condition answer": dict(zip(("warped_cloth", "prompt_embeds",
                                       "negative_prompt_embeds"),
                                      direct["cond"])),
        "/tryon request": tryon_arrays(raw, direct["cond"]),
        "/tryon answer": {"images": direct["out"]},
        "a 2-image request of the group": group[2]}
    log("phase 8: .npz bodies encoded on this host: " + ", ".join(
        f"{k} {t:.3f} s for {mb:.1f} MiB" for k, (t, mb) in
        ((k, npz_seconds(v)) for k, v in bodies.items())))
    stacked = {k: np.concatenate([g[k] for g in group]) for k in group[0]}
    t0 = time.perf_counter()
    out = ref_service.generate(**stacked)
    torch.cuda.synchronize()
    t_direct = time.perf_counter() - t0
    offsets = np.cumsum([0] + [g["image"].shape[0] for g in group])
    same = all(bitwise(a, out[offsets[i]:offsets[i + 1]])
               for i, a in enumerate(answers))
    log(f"phase 8: three concurrent /tryon requests of 1, 1 and 2 images, "
        f"started {SERVE_SPACING_S:.1f} s apart: "
        f"{', '.join(f'{s:.3f}' for s in seconds)} s each, "
        f"{t_group:.3f} s in all, as one batch of 4; the group called "
        f"directly {t_direct:.3f} s; bitwise equal {same} [{smi}]")
    if not same:
        raise AssertionError("the group's answers differ from one direct "
                             "generate of the group")
    return launches, raw, served


def serve_process(work: pathlib.Path, raw: dict, served: dict,
                  smi: str) -> None:
    """Phase 8, as a process: ``python -m ladi_vton_tpu_torch.cli.serve``
    on the card from phase 6's reference-layout files; the raw request's
    answer must equal the in-process one (the same seed, request 0), and
    SIGINT must end it with exit code 0."""
    argv = [sys.executable, "-m", "ladi_vton_tpu_torch.cli.serve",
            "--dataset", "vitonhd", "--checkpoint_dir", str(work / "ladi"),
            "--sd2_model_dir", str(work / "sd2"), "--enable_condition",
            "--clip_vision_dir", str(work / "clip_vision"),
            "--batch_size", str(SERVE_BATCH), "--seed", str(SERVE_SEED),
            "--num_inference_steps", "50", "--guidance_scale", "7.5",
            "--max_delay_ms", "5", "--no_warmup", "--port", "0"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    torch.cuda.empty_cache()
    errors = work / "serve.stderr"
    t0 = time.perf_counter()
    with open(errors, "w") as err:
        proc = subprocess.Popen(argv, cwd=REPO, env=env, stderr=err,
                                stdout=subprocess.PIPE, text=True)
    lines: list = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stdout.readline, "")),
        daemon=True)
    reader.start()
    try:
        url = None
        while url is None and time.perf_counter() - t0 < \
                SERVE_START_TIMEOUT_S and proc.poll() is None:
            url = next((ln.split()[3] for ln in list(lines)
                        if ln.startswith("serving try-on on ")), None)
            time.sleep(0.1)
        if url is None:
            raise AssertionError(
                f"cli.serve did not come up (exit {proc.poll()}): "
                f"{''.join(lines)}{errors.read_text()[-4000:]}")
        t_up = time.perf_counter() - t0
        client = TryOnClient(url, timeout_s=SERVE_TIMEOUT_S)
        if not client.healthz()["condition"]:
            raise AssertionError("cli.serve mounted no /condition")
        answer = client_raw(client, raw)
        same = same_answer(answer, served)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=SERVE_EXIT_TIMEOUT_S)
        t_exit = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=SERVE_EXIT_TIMEOUT_S)
    log(f"phase 8: cli.serve up in {t_up:.1f} s (interpreter, weights "
        f"from the files, no warmup); its raw request of 2 images "
        f"(/condition {answer['t_cond']:.3f} s, with /tryon "
        f"{answer['total']:.3f} s, its first request) bitwise equal to "
        f"the in-process answer: {same}; SIGINT -> exit {code} in "
        f"{t_exit:.2f} s [{smi}]")
    if not same:
        raise AssertionError("cli.serve answers the raw request differently "
                             "from the in-process server")
    if code != 0:
        raise AssertionError(f"cli.serve exited {code} on SIGINT: "
                             f"{errors.read_text()[-4000:]}")


# phase 9: the card (TF32 off) against the CPU, max |card - CPU| over the
# largest |CPU| value, for each metric tower; the PSNR of the decoder's
# read of the port's quality-95 JPEGs against the pixels written: 4:2:0
# chroma costs noise-like images (the random-weight outputs) some 25 dB,
# while wrong tables, shifted blocks or swapped channels fall well below
# 20
METRIC_TOWER_LIMIT = 1e-3
JPEG_PSNR_LIMIT = 20.0


def write_metric_weights(root: pathlib.Path, seed: int = 90) -> pathlib.Path:
    """Seeded random metric weights from the port's own modules, in the
    files the metrics read (``inception.pth``: pytorch-fid's names,
    ``lpips_alex.pth``: the lpips package's).  Convolutions get He
    initialisation, so the features neither vanish nor blow up through
    the towers' depth."""
    torch.manual_seed(seed)
    inception, lpips = InceptionV3(), LPIPS()
    for module in (inception, lpips.net):
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
    for lin in lpips.lins:
        lin.model[1].weight.data.normal_().abs_().mul_(0.1)
    root.mkdir(parents=True, exist_ok=True)
    torch.save(inception.state_dict(), root / "inception.pth")
    torch.save(lpips.state_dict(), root / "lpips_alex.pth")
    return root


def rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_metric_towers(weights: pathlib.Path, smi: str) -> None:
    """Inception (pool3, logits; 4 at 299x299), LPIPS and SSIM (2 at
    512x384) on the card with TF32 off against the CPU, same inputs."""
    rng = np.random.default_rng(91)
    x = rng.uniform(-1, 1, (4, 299, 299, 3)).astype(np.float32)
    a = rng.uniform(0, 1, (2, 512, 384, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    card, cpu = MetricModels(weights, "cuda"), MetricModels(weights, "cpu")
    first, warm = {}, {}
    for name, fn in (
            ("Inception 4 x 299x299", lambda: card.inception_features(x)),
            ("LPIPS 2 x 512x384", lambda: card.lpips_distance(a, b)),
            ("SSIM 2 x 512x384", lambda: card.ssim(a, b))):
        for times in (first, warm):  # the first call starts cuDNN up
            t0 = time.perf_counter()
            fn()  # each returns host numbers: synchronised
            times[name] = time.perf_counter() - t0
    pool, logits = card.inception_features(x)
    pool_cpu, logits_cpu = cpu.inception_features(x)
    errors = {
        "inception pool3": rel_max(pool, pool_cpu),
        "inception logits": rel_max(logits, logits_cpu),
        "lpips": rel_max(card.lpips_distance(a, b),
                         cpu.lpips_distance(a, b)),
        "ssim": rel_max(card.ssim(a, b), cpu.ssim(a, b)),
    }
    log(f"phase 9: metric towers on the card (fp32, TF32 off) against the "
        f"CPU, max relative error (limit {METRIC_TOWER_LIMIT:g}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errors.items())
        + "; on the card, first and warm calls: " + ", ".join(
            f"{k} {first[k] * 1e3:.1f} and {warm[k] * 1e3:.1f} ms"
            for k in warm) + f"; pool3 std {pool.std():.4f} [{smi}]")
    worst = max(errors.values())
    if not worst <= METRIC_TOWER_LIMIT:
        raise AssertionError(f"a metric tower disagrees with the CPU: "
                             f"{errors}")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(
        10 * np.log10(255.0 ** 2 / mse))


def timed(label: str, fn, argv: list, smi: str):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(argv)
    torch.cuda.synchronize()
    log(f"phase 9 {label}: {time.perf_counter() - t0:.3f} s [{smi}]")
    return result


def check_jpeg_reads(jpeg_dir: pathlib.Path, png_dir: pathlib.Path) -> None:
    """The decoder reads the port's own JPEGs (no sidecar) close to the
    pixels written: the PNG run wrote the same images losslessly."""
    values = []
    for path in sorted(jpeg_dir.rglob("*.jpg")):
        data = path.read_bytes()
        pixels = native.jpeg_decode(data)
        if pixels is None or imageio.sidecar_path(path).exists():
            raise AssertionError(f"{path.name}: not read by the decoder")
        written = imageio.open_image(png_dir / path.parent.name
                                     / path.with_suffix(".png").name).pixels
        values.append(psnr(pixels, written))
    log(f"phase 9: the decoder's read of {len(values)} quality-95 JPEGs of "
        f"the port's writer against the pixels written: PSNR "
        f"{', '.join(f'{v:.2f}' for v in values)} dB (limit "
        f"{JPEG_PSNR_LIMIT:g})")
    if not values or min(values) < JPEG_PSNR_LIMIT:
        raise AssertionError(f"JPEG PSNR {values}")


def check_clip_features(target: pathlib.Path, root: pathlib.Path,
                        vision) -> int:
    """Every stored feature equals the zoo-loaded tower called directly on
    the same batch, rounded to float16 as the main rounds it."""
    cache = ClothFeatureCache(target, "test")
    dataset = VitonHDDataset(str(root), phase="test", order="paired",
                             outputlist=("cloth", "c_name"))
    n = 0
    for b in BatchLoader(dataset, 2, num_workers=0, pad_last=True):
        cloth = to_device(b["cloth"], next(vision.parameters()).device)
        with torch.no_grad():
            out = vision(clip_pixels(cloth, BF16)).float().cpu().numpy()
        for name, feat in zip(b["c_name"], out):
            if not np.array_equal(cache.get(name),
                                  feat.astype(np.float16).astype(
                                      np.float32)):
                raise AssertionError(f"CLIP feature of {name} differs from "
                                     f"the tower called directly")
            n += 1
    return n


def metrics_path(work: pathlib.Path, roots: dict, cond: Conditioner,
                 wrappers: dict, smi: str) -> dict:
    """Phase 9: the metric towers against the CPU, then the metric mains
    over phase 7's trees and outputs on the card: ``generate_fid_stats``,
    ``val_metrics`` over the PNG and the JPEG run (the JPEGs through the
    decoder), ``inference --compute_metrics`` (its JSON equal to
    ``val_metrics``' over its folder) and ``compute_cloth_clip_features``
    (each feature equal to the tower called directly).  Returns the
    kernels' launches over the mains."""
    weights = write_metric_weights(work / "metric_weights")
    os.environ["LADI_VTON_METRIC_WEIGHTS"] = str(weights)
    check_metric_towers(weights, smi)
    out, dc, vh = work / "out", roots["dresscode"], roots["vitonhd"]
    reset_counts(wrappers)
    written = timed("generate_fid_stats", stats_main.main, [
        "--dresscode_dataroot", str(dc), "--vitonhd_dataroot", str(vh),
        "--weights_dir", str(weights)], smi)
    if written != ["dresscode_upper_body", "vitonhd_all"]:
        raise AssertionError(f"generate_fid_stats wrote {written}")

    def val_argv(folder: pathlib.Path) -> list:
        return ["--gen_folder", str(folder), "--dataset", "dresscode",
                "--dresscode_dataroot", str(dc), "--test_order", "paired",
                "--category", "upper_body", "--workers", "2"]

    png_dir = out / "inference_dresscode" / "paired"
    jpeg_dir = out / "inference_jpeg" / "paired"
    m_png = timed("val_metrics over the PNG run", val_main.main,
                  val_argv(png_dir), smi)
    m_jpeg = timed("val_metrics over the JPEG run (the decoder)",
                   val_main.main, val_argv(jpeg_dir), smi)
    log(f"phase 9: metrics of the PNG run {m_png}; of the JPEG run {m_jpeg}")
    gt = _gt_image_paths(str(dc), "dresscode", "upper_body", "paired")
    paths = sorted(map(str, (png_dir / "upper_body").glob("*.png")))
    t0 = time.perf_counter()
    _load_batch(paths + [gt[n] for n in sorted(gt)], (512, 384))
    log(f"phase 9: reading and resizing the run's {len(paths)} images and "
        f"their {len(gt)} ground truths (1024x768) on the host, one "
        f"thread: {time.perf_counter() - t0:.3f} s")
    mu, sigma, _ = StatsCache(dc.parent / "fid_stats").load(
        "dresscode_upper_body")
    t0 = time.perf_counter()
    frechet_distance(mu, sigma, mu, sigma)
    log(f"phase 9: one frechet_distance of 2048-d stats on the host (scipy "
        f"sqrtm, the eps branch when the first root is not finite): "
        f"{time.perf_counter() - t0:.3f} s [{smi}]")
    check_jpeg_reads(jpeg_dir, png_dir)

    dresscode_run = main_runs(work, roots, out)[0]
    argv = [a.replace("inference_dresscode", "inference_metrics")
            for a in dresscode_run[2]] + ["--compute_metrics"]
    timed("inference --compute_metrics (DDIM-50, 2 images)",
          inference_cli.main, argv, smi)
    metrics_dir = out / "inference_metrics" / "paired"
    written = json.loads((metrics_dir / "metrics_paired_upper_body.json")
                         .read_text())
    again = timed("val_metrics over its folder", val_main.main,
                  val_argv(metrics_dir), smi)
    same = json.dumps(written, sort_keys=True) == json.dumps(
        again, sort_keys=True)
    log(f"phase 9: inference --compute_metrics wrote {written}; "
        f"val_metrics over the same folder equal: {same}; equal to the PNG "
        f"run's (the same images): {m_png == written}")
    if not same:
        raise AssertionError("inference --compute_metrics and val_metrics "
                             "disagree over one folder")

    ln_before = layer_norm.launches
    target = timed("compute_cloth_clip_features (VITON-HD test split)",
                   clip_main.main, [
                       "--dataset", "vitonhd", "--vitonhd_dataroot",
                       str(vh), "--phase", "test", "--batch_size", "2",
                       "--num_workers", "2", "--clip_vision_dir",
                       str(work / "clip_vision"), "--cache_root",
                       str(work / "clip_cache")], smi)
    ln_clip = layer_norm.launches - ln_before
    launches = main_counts(wrappers)
    n = check_clip_features(target, vh, cond.vision)
    log(f"phase 9: {n} CLIP cloth features equal to the zoo-loaded tower "
        f"called directly; K5 launches in the main {ln_clip}")
    if ln_clip == 0:
        raise AssertionError("compute_cloth_clip_features launched no K5")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched in phase 9: {missing}")
    return launches


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


# phase 10: training.  The card-vs-CPU step at full SD-2 width on a small
# input: the loss within TRAIN_LOSS_LIMIT relative, each tower part's
# gradient at least TRAIN_GRAD_COS cosine similarity (bf16 compute with
# fp32 parameters against fp32; the gradient's bf16 rounding and the
# kernels' bf16 outputs)
TRAIN_STEP_SIZE = (128, 128)
TRAIN_LOSS_LIMIT = 3e-2
TRAIN_GRAD_COS = 0.98
TRAIN_SIZE = (512, 384)
# the kernels each main's step runs: the EMASC step runs the VAE (GroupNorm,
# its mid block's attention) and no transformer; TPS and the refinement
# run none
TRAIN_KERNELS = {"vto": ("flash_attention", "group_norm", "geglu",
                         "layer_norm"),
                 "inversion_adapter": ("flash_attention", "group_norm",
                                       "geglu", "layer_norm"),
                 "emasc": ("flash_attention", "group_norm"), "tps": ()}


class GlobalCensus(Census):
    """A census of every module of ``kind`` that runs while open, built
    inside the mains (a global forward hook)."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        def hook(module, args, output):
            if isinstance(module, self.kind):
                self.hook(module, args, output)
        self.handles = [
            torch.nn.modules.module.register_module_forward_hook(hook)]
        return self


class GlobalGroupNormCensus(GlobalCensus, GroupNormCensus):
    pass


class GlobalLayerNormCensus(GlobalCensus, LayerNormCensus):
    pass


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def train_batch(rng: np.random.Generator, tokenizer, h: int, w: int) -> dict:
    mask = np.zeros((1, h, w, 1), np.float32)
    mask[:, h // 8: h - h // 16, w // 6: w - w // 6] = 1.0
    image = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    ids = tokenizer(category_prompts(["upper_body"], NUM_VSTAR))
    return {"image": torch.from_numpy(image),
            "im_mask": torch.from_numpy(image * (1 - mask)),
            "inpaint_mask": torch.from_numpy(mask),
            "pose_map": torch.from_numpy(
                rng.uniform(0, 1, (1, h, w, 18)).astype(np.float32)),
            "warped_cloth": torch.from_numpy(
                rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)),
            "input_ids": torch.from_numpy(np.asarray(ids).astype(np.int64)),
            "clip_cloth_features": torch.from_numpy(rng.standard_normal(
                (1, 257, 1280)).astype(np.float32))}


def check_train_step(zpipe: TryOnPipeline, zcond: Conditioner, tokenizer,
                     wrappers: dict, smi: str) -> None:
    """Phase 10, step 1: the VTO loss and its gradients at full SD-2 width
    (31-channel UNet trained in fp32, the VAE, text encoder and adapter
    frozen) on one 128x128 image (the UNet's three downsamples need a
    latent side divisible by 8), on the card (bf16 autocast, the kernels'
    Functions) against the CPU (fp32), with the same weights and draws."""
    h, w = TRAIN_STEP_SIZE
    batch = train_batch(np.random.default_rng(100), tokenizer, h, w)
    draws = vto_draws(batch, torch.Generator().manual_seed(101))
    config = VTOStepConfig(num_vstar=NUM_VSTAR)
    empty = torch.from_numpy(tokenizer([""])[0].astype(np.int64))
    unet = UNet2DCondition(sd2_unet_config(31)).to("cuda")
    unet.load_state_dict(zpipe.unet.state_dict())
    tcfg = zcond.text_model.config
    cpu = {"unet": cpu_copy(unet, lambda: UNet2DCondition(
               sd2_unet_config(31))),
           "vae": cpu_copy(zpipe.vae, lambda: AutoencoderKL(VAEConfig())),
           "text_model": cpu_copy(zcond.text_model,
                                  lambda: CLIPTextModel(tcfg)),
           "inversion_adapter": cpu_copy(
               zcond.adapter, lambda: InversionAdapter(num_encoder_layers=1))}
    card = {"unet": unet, "vae": zpipe.vae, "text_model": zcond.text_model,
            "inversion_adapter": zcond.adapter}
    results = {}
    for where, towers in (("cuda", card), ("cpu", cpu)):
        for name, m in towers.items():
            m.requires_grad_(name == "unet")
        loss_fn = make_vto_loss(config=config, empty_prompt_ids=empty.to(
            where), **towers)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        with precision(torch.device(where), BF16 if where == "cuda"
                       else torch.float32):
            loss, _ = loss_fn({k: v.to(where) for k, v in batch.items()},
                              {k: v.to(where) for k, v in draws.items()})
        loss.backward()
        if where == "cuda":
            torch.cuda.synchronize()
            counts = main_counts(wrappers)
            missing = [k for k in TRAIN_KERNELS["vto"] if not counts[k]]
            if missing:
                raise AssertionError(f"the card's step never launched "
                                     f"{missing}")
        results[where] = (float(loss), {
            k: p.grad.detach().float().cpu()
            for k, p in towers["unet"].named_parameters()},
            time.perf_counter() - t0)
        towers["unet"].requires_grad_(False)
    (l_card, g_card, t_card), (l_cpu, g_cpu, t_cpu) = (results["cuda"],
                                                       results["cpu"])
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    parts = {}
    for part in ("conv_in", "time_embedding", "down_blocks", "mid_block",
                 "up_blocks", "conv_norm_out", "conv_out"):
        keys = [k for k in g_cpu if k.startswith(part + ".")]
        parts[part] = cosine(torch.cat([g_card[k].flatten() for k in keys]),
                             torch.cat([g_cpu[k].flatten() for k in keys]))
    finite = all(torch.isfinite(g).all() for g in g_card.values())
    log(f"phase 10: the VTO step at full SD-2 width on one {h}x{w} image, "
        f"card (bf16 autocast, fp32 parameters) {t_card:.2f} s against CPU "
        f"(fp32) {t_cpu:.2f} s: loss {l_card:.6f} vs {l_cpu:.6f}, relative "
        f"error {rel:.3e} (limit {TRAIN_LOSS_LIMIT}); UNet gradient cosine "
        f"by part {({k: round(v, 5) for k, v in parts.items()})} (limit "
        f"{TRAIN_GRAD_COS}); card gradients finite: {finite}; launches "
        f"{counts}")
    if not (rel <= TRAIN_LOSS_LIMIT and finite
            and min(parts.values()) >= TRAIN_GRAD_COS):
        raise AssertionError("the card's training step disagrees with the "
                             "CPU's")
    del cpu
    unet.requires_grad_(True)
    time_train_steps(unet, card, config, empty.to("cuda"), tokenizer,
                     wrappers, smi)
    del unet, card
    torch.cuda.empty_cache()


def time_train_steps(unet: UNet2DCondition, towers: dict, config,
                     empty: torch.Tensor, tokenizer, wrappers: dict,
                     smi: str) -> None:
    """Phase 10: the VTO train step alone (loss, backward, clip, AdamW) at
    512x384, batch 1, from batches already on the card, without and with
    gradient checkpointing: seconds per step (CUDA-synchronised host
    clock, steps 2-4 of four), peak device memory over the steps, and
    each kernel's launches per step.  The mains' own step seconds also
    hold their data loading."""
    h, w = TRAIN_SIZE
    rng = np.random.default_rng(102)
    for ckpt in (False, True):
        unet.gradient_checkpointing = ckpt
        opt = make_optimizer(list(unet.parameters()), 1e-5, warmup_steps=0)
        step = make_vto_train_step(
            optimizer=opt, config=config,
            autocast=lambda: precision(torch.device("cuda"), BF16),
            empty_prompt_ids=empty, **towers)
        batches = []
        for i in range(4):
            b = train_batch(rng, tokenizer, h, w)
            batches.append(({k: v.to("cuda") for k, v in b.items()}, {
                k: v.to("cuda") for k, v in vto_draws(
                    b, torch.Generator().manual_seed(i)).items()}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i, (batch, draws) in enumerate(batches):
            if i == 1:
                reset_counts(wrappers)
            t0 = time.perf_counter()
            loss = step(batch, draws)["loss"]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not torch.isfinite(loss):
                raise AssertionError("a timed train step's loss is not "
                                     "finite")
        counts = {k: v / 3 for k, v in main_counts(wrappers).items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"phase 10: the VTO train step alone at {h}x{w}, batch 1, "
            f"gradient checkpointing {ckpt}: {np.mean(times[1:]):.3f} s a "
            f"step (steps {[round(t, 3) for t in times]}, the first with "
            f"its warm-up), peak device memory {peak:.2f} GiB over the "
            f"steps, launches a step {counts} [{smi}]")
        del opt, step, batches
        unet.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    unet.gradient_checkpointing = False


def write_train_data(root: pathlib.Path) -> dict:
    """Phase 10: DressCode (every category) and VITON-HD, each with a test
    split of one pair and a train split of two pairs a category, at the
    datasets' 1024x768, with captions, warped cloths and CLIP features."""
    return {
        "dresscode": synthetic.write_dresscode(
            root / "dc" / "dresscode", n_pairs=1, train_pairs=2,
            size=SOURCE_SIZE, seed=80, categories=("dresses", "upper_body",
                                                   "lower_body")),
        "vitonhd": synthetic.write_vitonhd(
            root / "vh" / "vitonhd", n_pairs=1, train_pairs=2,
            size=SOURCE_SIZE, seed=81),
    }


def write_stock_unet(sd2: pathlib.Path, unet: UNet2DCondition) -> None:
    """The SD-2-inpainting UNet the trainers start from: phase 6's release
    cut to its stock 9 input channels, under ``sd2/unet``."""
    (sd2 / "unet").mkdir(parents=True, exist_ok=True)
    state = module_state(unet)
    state["conv_in.weight"] = state["conv_in.weight"][:, :9].clone()
    torch.save(state, sd2 / "unet" / "diffusion_pytorch_model.bin")
    (sd2 / "unet" / "config.json").write_text(json.dumps(
        {"_class_name": "UNet2DConditionModel",
         **dataclasses.asdict(dataclasses.replace(unet.config,
                                                  in_channels=9))}))


class GradientWatch:
    """Wraps ``train.steps.Optimizer.step`` while open: before every update
    every trained parameter must hold a finite gradient, and the first
    update of each optimizer must move every parameter whose gradient is
    not exactly zero (``zero_grads`` counts those that are)."""

    def __init__(self):
        self.updates = 0
        self.zero_grads = 0
        self.seen = set()

    def __enter__(self):
        original = self.original = steps_mod.Optimizer.step
        watch = self

        def step(opt):
            bad = [p for p in opt.params
                   if p.grad is None or not torch.isfinite(p.grad).all()]
            if bad:
                raise AssertionError(f"{len(bad)} of {len(opt.params)} "
                                     f"trained parameters without a finite "
                                     f"gradient")
            first = id(opt) not in watch.seen
            watch.seen.add(id(opt))
            # host copies: the watch adds nothing to the peak device memory
            before = ([p.detach().to("cpu", copy=True) for p in opt.params]
                      if first else None)
            norm = original(opt)
            watch.updates += 1
            if first:
                zero = [bool(not p.grad.any()) for p in opt.params]
                still = sum(torch.equal(b, p.detach().cpu()) and not z
                            for b, p, z in zip(before, opt.params, zero))
                watch.zero_grads += sum(zero)
                if still:
                    raise AssertionError(f"{still} of {len(before)} "
                                         f"parameters did not move")
            return norm

        steps_mod.Optimizer.step = step
        return self

    def __exit__(self, *exc):
        steps_mod.Optimizer.step = self.original


def metric_lines(path: pathlib.Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def train_runs(work: pathlib.Path, roots: dict, out: pathlib.Path) -> list:
    """(label, kind, main, argv) of phase 10's runs."""
    sd2, ladi = work / "sd2", work / "ladi"
    size = ["--height", str(TRAIN_SIZE[0]), "--width", str(TRAIN_SIZE[1])]

    def common(dataset: str, name: str, steps_: int, every: int) -> list:
        return ["--dataset", dataset, f"--{dataset}_dataroot",
                str(roots[dataset]), "--output_dir", str(out / name),
                "--sd2_model_dir", str(sd2), "--train_batch_size", "1",
                "--test_batch_size", "1", "--num_workers", "2",
                "--num_workers_test", "2", "--max_train_steps", str(steps_),
                "--checkpointing_steps", str(every), "--lr_warmup_steps",
                "0", "--report_to", "none", "--test_order", "paired",
                "--seed", "9", "--device", "cuda", *size]

    vto = ["--clip_vision_dir", str(work / "clip_vision"),
           "--inversion_adapter_dir", str(ladi), "--tokenizer_dir",
           str(sd2 / "tokenizer")]
    return [
        ("train_vto", "vto", train_vto_cli.main,
         common("vitonhd", "vto", 2, 2) + vto),
        ("train_vto resumed --gradient_checkpointing", "vto",
         train_vto_cli.main, common("vitonhd", "vto", 4, 10) + vto
         + ["--resume_from_checkpoint", "latest",
            "--gradient_checkpointing", "--async_checkpointing"]),
        ("train_emasc", "emasc", train_emasc_cli.main,
         common("dresscode", "emasc", 3, 1)
         + ["--vgg_weights", str(work / "vgg19.pth"),
            "--async_checkpointing"]),
        ("train_inversion_adapter", "inversion_adapter",
         train_adapter_cli.main, common("vitonhd", "adapter", 2, 2)
         + ["--clip_vision_dir", str(work / "clip_vision"),
            "--tokenizer_dir", str(sd2 / "tokenizer")]),
        ("train_tps", "tps", train_tps_cli.main,
         ["--dataset", "vitonhd", "--vitonhd_dataroot",
          str(roots["vitonhd"]), "--checkpoints_dir", str(out / "tps"),
          "--exp_name", "warp", "-b", "2", "-j", "2", "--epochs_tps", "1",
          "--epochs_refinement", "1", "--vgg_weights",
          str(work / "vgg19.pth"), "--device", "cuda", *size]),
    ]


def training_path(work: pathlib.Path, zpipe: TryOnPipeline,
                  zcond: Conditioner, tokenizer, wrappers: dict,
                  smi: str) -> dict:
    """Phase 10: the card-vs-CPU step, then the four trainers at full width
    (512x384 from 1024x768) from phase 6's reference-layout files; every
    check of the docstring.  Returns the kernels' launches summed over the
    mains."""
    t_phase = time.perf_counter()
    check_train_step(zpipe, zcond, tokenizer, wrappers, smi)
    t0 = time.perf_counter()
    roots = write_train_data(work / "train_data")
    write_stock_unet(work / "sd2", zpipe.unet)
    torch.manual_seed(90)
    torch.save(VGG19Features().state_dict(), work / "vgg19.pth")
    free = shutil.disk_usage(work).free / 2 ** 30
    log(f"phase 10: train splits, the stock UNet and a VGG19 written in "
        f"{time.perf_counter() - t0:.1f} s; {free:.1f} GiB free on disk")
    out = work / "train"
    # phase 9 scored its runs; here the validation images are written and
    # their scoring skipped (no metric weights, a FileNotFoundError the
    # trainers tolerate): FID over one or three images says nothing
    os.environ.pop("LADI_VTON_METRIC_WEIGHTS", None)
    total = {name: 0 for name in wrappers}
    gn_census, ln_census = GlobalGroupNormCensus(), GlobalLayerNormCensus()
    for label, kind, main_fn, argv in train_runs(work, roots, out):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        census = (gn_census, ln_census) if label in (
            "train_vto", "train_emasc") else ()
        jsonl = (out / "tps" / "warp" / "metrics.jsonl" if kind == "tps"
                 else pathlib.Path(argv[argv.index("--output_dir") + 1])
                 / "metrics.jsonl")
        before = len(metric_lines(jsonl)) if jsonl.exists() else 0
        t0 = time.perf_counter()
        with GradientWatch() as watch, contextlib.ExitStack() as stack:
            for c in census:
                stack.enter_context(c)
            result = main_fn(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = main_counts(wrappers)
        for name in wrappers:
            total[name] += counts[name]
        lines = metric_lines(jsonl)[before:]
        if kind == "tps":
            losses = [x["train/loss"] for x in lines]
            per_step = ""
        else:
            losses = [x["loss"] for x in lines]
            per_step = (f", step seconds "
                        f"{[round(1 / x['steps_per_sec'], 3) for x in lines]}"
                        f" (host clock, each with its batch's loading; the "
                        f"first of a run includes its warm-up)")
        log(f"phase 10 {label}: {seconds:.1f} s wall, result {result}, "
            f"{watch.updates} update(s) ({watch.zero_grads} parameter(s) "
            f"with an exactly zero gradient), losses {losses}{per_step}, "
            f"peak device memory {peak:.2f} GiB, launches {counts}, "
            f"{({k: round(v / max(len(lines), 1), 1) for k, v in counts.items()})} "
            f"a logged step [{smi}]")
        if not all(np.isfinite(losses)) or not watch.updates:
            raise AssertionError(f"{label}: no finite training")
        missing = [k for k in TRAIN_KERNELS[kind] if not counts[k]]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: "
                                 f"{missing}")
    check_census(gn_census, "the train_vto and train_emasc runs")
    check_layer_norm_census(ln_census, "the train_vto and train_emasc runs")
    check_train_outputs(out, roots, work)
    log(f"phase 10: training ({time.perf_counter() - t_phase:.1f} s)")
    return total


def training_only(work: pathlib.Path, smi: str) -> None:
    """``--training-only``: phase 10 over phase 6's files written from
    freshly seeded full-width modules."""
    tokenizer = synthetic_tokenizer(work / "sd2" / "tokenizer")
    pipe = full_width_pipeline()
    cond = conditioner("cuda", (512, 384), tokenizer)
    write_checkpoints(work, pipe, cond)
    wrappers = {name: wrapper for name, wrapper, _, _, _ in KERNELS}
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    log(f"launches during phase 10's training runs: "
        f"{training_path(work, pipe, cond, tokenizer, wrappers, smi)}")


def check_train_outputs(out: pathlib.Path, roots: dict,
                        work: pathlib.Path) -> None:
    """Checkpoints kept and resumed, the exports loaded back through the
    zoo, and ``cli.eval`` over the warped cloths ``train_tps`` extracted,
    with the trained exports."""
    kept = sorted(p.name for p in (out / "vto").glob("checkpoint-*"))
    lines = metric_lines(out / "vto" / "metrics.jsonl")
    kept_emasc = sorted(p.name for p in (out / "emasc").glob("checkpoint-*"))
    if kept_emasc != ["checkpoint-2", "checkpoint-3"]:
        raise AssertionError(f"train_emasc kept {kept_emasc}")
    if kept != ["checkpoint-2", "checkpoint-4"] or [
            x["step"] for x in lines] != [1, 2, 3, 4]:
        raise AssertionError(f"train_vto's checkpoints {kept} or steps "
                             f"{[x['step'] for x in lines]}")
    on = dict(device="cuda", dtype=BF16)
    zoo.extended_unet(checkpoint=str(out / "vto" / "unet_2.pth"), **on)
    zoo.emasc(checkpoint=str(out / "emasc" / "emasc_3.pth"), **on)
    zoo.inversion_adapter(checkpoint=str(
        out / "adapter" / "inversion_adapter_2.pth"), **on)
    zoo.warping_module(checkpoint=str(out / "tps" / "warp"
                                      / "warping_vitonhd.pth"),
                       device="cuda")
    log("phase 10: checkpoints 2 and 4 of train_vto kept, steps 1-4 over "
        "two runs (the second resumed from latest, asynchronous, with "
        "gradient checkpointing); train_emasc's checkpoints 1, 2 and 3 "
        "written asynchronously and 2 and 3 kept (keep 2); the unet, emasc, "
        "inversion_adapter and warping exports loaded back through the zoo")
    cache = roots["vitonhd"].parent / "cache"
    warped = sorted(p.name for p in (cache / "warped_cloths" / "vitonhd"
                                     / "upper_body").iterdir())
    save = out / "eval"
    stats = eval_cli.main([
        "--dataset", "vitonhd", "--vitonhd_dataroot", str(roots["vitonhd"]),
        "--output_dir", str(save), "--save_name", "trained",
        "--test_order", "paired", "--unet_dir", str(out / "vto"),
        "--emasc_dir", str(out / "emasc"), "--inversion_adapter_dir",
        str(out / "adapter"), "--sd2_model_dir", str(work / "sd2"),
        "--clip_vision_dir", str(work / "clip_vision"), "--batch_size", "1",
        "--num_workers", "2", "--scheduler", "dpm", "--num_inference_steps",
        "5", "--use_png", "--device", "cuda"])
    images = list((save / "trained" / "paired").rglob("*.png"))
    if not images or stats["images"] != len(images):
        raise AssertionError(f"cli.eval after training wrote {images}")
    log(f"phase 10: train_tps extracted {len(warped)} warped cloths "
        f"(train and test, paired) under {cache}; cli.eval read them with "
        f"the trained unet, emasc and adapter exports and saved "
        f"{len(images)} image(s)")


# phase 11: distribution on the card.  Two ranks share the one card over
# gloo (NCCL takes one rank a card), one rank runs over NCCL; every rank
# is a process of ``parallel.launch`` with torchrun's variables, killed
# with the others where one fails or the phase's time runs out.  Limits:
# the two-rank data-parallel step's loss within DIST_LOSS_LIMIT relative
# of the one process's at the same global batch, its reduced gradient at
# least DIST_GRAD_COS cosine similarity by UNet part (batch 1 a rank
# against batch 2: cuBLAS and cuDNN pick other algorithms, in bf16; the
# bf16 step's gradient itself agrees with fp32 autograd only to 0.99895
# by part in phase 10's card-against-CPU check); the
# tensor-parallel forward (bf16) within TP_FORWARD_LIMIT relative L2 of
# the unsharded UNet's, BLOCK_LIMIT's allowance for a few bf16 roundings
# a layer (each of the two bf16 forwards is about 1e-2 from an fp32
# forward of the same weights, and the two round differently; in fp32 on
# the CPU the tensor-parallel UNet holds to the JAX UNet at rtol 2e-3,
# atol 2e-4, tests/test_torch_port_tp.py), its step's loss within
# DIST_LOSS_LIMIT and its gathered gradient within DIST_GRAD_COS by
# part.  Each limit is held against a planted fault in the same run:
# the two-rank step with its gradient all_reduce left out must fall
# below DIST_GRAD_COS, and the tensor-parallel forward with its partial
# sums left unreduced above TP_FORWARD_LIMIT; both forwards are also
# read against an fp32 CPU forward of the same weights, which shows how
# much of their difference each one's bf16 rounding makes.  The two-rank
# inference images within DIST_IMAGE_LIMIT mean absolute difference of
# the one process's ([0, 1] pixels; bf16 sampling over DDIM-50 with CFG
# 7.5 at another batch per call, as IMAGE_MEAN_LIMIT for bf16 against
# fp32)
DIST_LOSS_LIMIT = 1e-3
DIST_GRAD_COS = 0.998
TP_FORWARD_LIMIT = BLOCK_LIMIT
DIST_IMAGE_LIMIT = IMAGE_MEAN_LIMIT
DIST_TIMEOUT_S = 600
DIST_BATCH = 2
TP_FORWARD = (4, 64, 48)  # batch, latent height and width
UNET_PARTS = ("conv_in", "time_embedding", "down_blocks", "mid_block",
              "up_blocks", "conv_norm_out", "conv_out")
DIST_SEEDS = {"unet": 10, "vae": 11, "adapter": 23, "text": 24}


def dist_towers(device) -> dict:
    """The full-width VTO step's towers from their seeds, alike in every
    process on the card: the 31-channel UNet in fp32, the VAE, the SD-2
    text encoder and the adapter frozen in bf16."""
    towers = {
        "unet": seeded(lambda: UNet2DCondition(sd2_unet_config(31)),
                       DIST_SEEDS["unet"], device),
        "vae": seeded(lambda: AutoencoderKL(VAEConfig()), DIST_SEEDS["vae"],
                      device, BF16),
        "text_model": seeded(lambda: CLIPTextModel(sd2_text_config()),
                             DIST_SEEDS["text"], device, BF16),
        "inversion_adapter": seeded(
            lambda: InversionAdapter(num_encoder_layers=1),
            DIST_SEEDS["adapter"], device, BF16)}
    for name, module in towers.items():
        module.requires_grad_(name == "unet")
    return towers


def dist_step(towers: dict, inputs: dict, device, mesh=None,
              zero: bool = False):
    """(optimizer, step) of the VTO train step over ``mesh``: AdamW 1e-5,
    clip 1.0, bf16 autocast."""
    opt = make_optimizer(list(towers["unet"].parameters()), 1e-5,
                         warmup_steps=0, mesh=mesh,
                         shard_optimizer_states=zero)
    loss = make_vto_loss(config=VTOStepConfig(num_vstar=NUM_VSTAR),
                         empty_prompt_ids=inputs["empty"].to(device),
                         **towers)
    return opt, steps_mod.build_train_step(
        loss, opt, autocast=lambda: precision(torch.device(device), BF16),
        mesh=mesh)


def on_card(tree: dict, device) -> dict:
    return {k: v.to(device) for k, v in tree.items()}


def unet_grads(unet: torch.nn.Module) -> dict:
    return {k: p.grad for k, p in unet.named_parameters()}


def grads_by_part(grads: dict) -> dict:
    """A UNet's gradient (name -> tensor), one flat bf16 host vector a
    part, in name order."""
    return {part: torch.cat([grads[k].detach().flatten().to("cpu", BF16)
                             for k in sorted(grads)
                             if k.startswith(part + ".")])
            for part in UNET_PARTS}


def cosines(grads: dict, ref: dict) -> dict:
    """The cosine similarity of a UNet's gradient to ``ref`` by part."""
    ours = grads_by_part(grads)
    return {part: cosine(ours[part].float(), ref[part].float())
            for part in UNET_PARTS}


@contextlib.contextmanager
def planted(module, name: str, fault):
    """``module.<name>`` replaced by ``fault`` inside the block: a planted
    fault, which a check's limit must tell from the sound run."""
    real = getattr(module, name)
    setattr(module, name, fault)
    try:
        yield
    finally:
        setattr(module, name, real)


def host_params(module: torch.nn.Module) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


def same_params(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def rank_setup(deterministic: bool = True,
               cudnn_tf32: bool = False) -> torch.device:
    """A rank's card and the settings of phase 11's comparisons: matmul
    TF32 off, cuDNN's as asked (the mains run with PyTorch's default, on);
    deterministic cuDNN where a check is bitwise."""
    from ladi_vton_tpu_torch.core import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False
    return distributed.local_device("cuda")


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def dist_reference(work: pathlib.Path, tokenizer) -> dict:
    """Phase 11a, in this process: the one-process VTO step at full width,
    512x384, global batch 2; its inputs, loss and gradient by part are
    written under ``work`` for the ranks, and the card is released."""
    h, w = TRAIN_SIZE
    rng = np.random.default_rng(111)
    rows = [train_batch(rng, tokenizer, h, w) for _ in range(DIST_BATCH)]
    batch = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    inputs = {"batch": batch,
              "draws": vto_draws(batch, torch.Generator().manual_seed(112)),
              "empty": torch.from_numpy(
                  tokenizer([""])[0].astype(np.int64))}
    torch.save(inputs, work / "inputs.pt")
    torch.cuda.reset_peak_memory_stats()
    towers = dist_towers("cuda")
    _, step = dist_step(towers, inputs, "cuda")
    t0 = time.perf_counter()
    loss = float(step(on_card(batch, "cuda"),
                      on_card(inputs["draws"], "cuda"))["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.save({"loss": loss,
                "grads": grads_by_part(unet_grads(towers["unet"]))},
               work / "reference.pt")
    log(f"phase 11a: the one-process VTO step at {h}x{w}, batch "
        f"{DIST_BATCH}: loss {loss:.6f}, {seconds:.3f} s (with its "
        f"warm-up), peak device memory {peak_gib():.2f} GiB")
    del towers, step
    torch.cuda.empty_cache()
    return {"loss": loss}


def dp_rank(work: str) -> dict:
    """Phase 11a on each of two ranks: two data-parallel steps (one row of
    the global batch a rank), then the same two under ZeRO-1 from the same
    state; the first step's loss and the cosine of its reduced gradient by
    part against the one process's, whether ZeRO-1's updates are bitwise
    the unsharded ones, the AdamW elements held, each step's seconds, peak
    memory and the second step's launches; then a planted fault, the first
    step with the gradient ``all_reduce`` left out, and its cosines."""
    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh, shard_batch

    dev = rank_setup()
    work = pathlib.Path(work)
    inputs = torch.load(work / "inputs.pt", weights_only=True)
    mesh = make_mesh(MeshSpec())
    rows = mesh.rows(DIST_BATCH)
    batch = on_card(shard_batch(mesh, inputs["batch"]), dev)
    draws = on_card({k: v[rows] for k, v in inputs["draws"].items()}, dev)
    wrappers = {name: fn for name, fn, _, _, _ in KERNELS}
    ref = torch.load(work / "reference.pt", weights_only=True)["grads"]
    out = {}
    for zero in (False, True):
        torch.cuda.reset_peak_memory_stats()
        towers = dist_towers(dev)
        opt, step = dist_step(towers, inputs, dev, mesh, zero)
        tag = "zero1" if zero else "dp"
        seconds, losses = [], []
        for i in range(2):
            reset_counts(wrappers)
            t0 = time.perf_counter()
            losses.append(float(step(batch, draws)["loss"]))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if i == 0 and not zero:
                out["cosine"] = cosines(unet_grads(towers["unet"]), ref)
        out[tag] = {"loss": losses[0], "seconds": seconds,
                    "peak_gib": peak_gib(), "launches": main_counts(wrappers),
                    "adam_numel": opt.local_state_numel()}
        if zero:
            out["zero1_bitwise"] = same_params(updated,
                                               host_params(towers["unet"]))
        else:
            updated = host_params(towers["unet"])
        del towers, opt, step
        torch.cuda.empty_cache()
    towers = dist_towers(dev)
    _, step = dist_step(towers, inputs, dev, mesh)
    with planted(steps_mod, "reduce_gradients", lambda params, mesh: None):
        step(batch, draws)
    out["fault_cosine"] = cosines(unet_grads(towers["unet"]), ref)
    return out


def nccl_rank(work: str) -> dict:
    """Phase 11b on one rank over NCCL: the step without a mesh, then over
    the NCCL group of one rank (its ``all_reduce`` runs), from the same
    state; whether the losses and the updated UNets are bitwise equal."""
    import torch.distributed as dist

    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh

    dev = rank_setup()
    inputs = torch.load(pathlib.Path(work) / "inputs.pt", weights_only=True)
    batch = on_card(inputs["batch"], dev)
    draws = on_card(inputs["draws"], dev)
    results = []
    for mesh in (None, make_mesh(MeshSpec())):
        towers = dist_towers(dev)
        _, step = dist_step(towers, inputs, dev, mesh)
        loss = float(step(batch, draws)["loss"])
        results.append((loss, host_params(towers["unet"])))
        del towers, step
        torch.cuda.empty_cache()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "loss": results[1][0],
            "bitwise": results[0][0] == results[1][0]
            and same_params(results[0][1], results[1][1])}


def tp_inputs() -> tuple:
    """Phase 11c's UNet forward inputs, bf16 on the host: latents, steps
    and text context."""
    B, lh, lw = TP_FORWARD
    g = torch.Generator().manual_seed(113)
    x = torch.randn((B, 31, lh, lw), generator=g).to(BF16)
    ctx = torch.randn((B, 77, 1024), generator=g).to(BF16)
    return x, torch.tensor([981, 500, 250, 1]), ctx


def tp_reference(work: pathlib.Path) -> None:
    """Phase 11c's fp32 reference, in this process: the bf16 UNet the
    ranks seed, its weights in an fp32 CPU twin, whose forward on
    ``tp_inputs`` is written under ``work``."""
    def factory():
        return UNet2DCondition(sd2_unet_config(31))

    t0 = time.perf_counter()
    unet = seeded(factory, DIST_SEEDS["unet"], "cuda", BF16)
    twin = cpu_copy(unet, factory)
    del unet
    torch.cuda.empty_cache()
    x, t, ctx = tp_inputs()
    with torch.no_grad():
        torch.save(twin(x.float(), t, ctx.float()), work / "tp_fp32.pt")
    log(f"phase 11c: the fp32 CPU twin of the bf16 UNet and its forward "
        f"(batch {TP_FORWARD[0]}, {TP_FORWARD[1]}x{TP_FORWARD[2]} latents) "
        f"in {time.perf_counter() - t0:.1f} s")


def tp_rank(work: str) -> dict:
    """Phase 11c on each of two ranks at data 1 x model 2: the full-width
    UNet's forward (bf16, batch 4, 64x48 latents) unsharded and tensor
    parallel, with the K1 and K4 calls of the parallel one counted and
    their shapes recorded, each against the fp32 CPU forward; the
    parallel one with its partial sums left unreduced (a planted fault);
    then one tensor-parallel VTO step (fp32 parameters) on the global
    batch, its loss and its gradient gathered to the reference layout."""
    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh
    from ladi_vton_tpu_torch.parallel import tp

    dev = rank_setup(deterministic=False)
    work = pathlib.Path(work)
    mesh = make_mesh(MeshSpec(data=1, model=2))
    x, t, ctx = (v.to(dev) for v in tp_inputs())
    unet = seeded(lambda: UNet2DCondition(sd2_unet_config(31)),
                  DIST_SEEDS["unet"], dev, BF16)
    with torch.no_grad():
        full = unet(x, t, ctx)
    tp.unet_tp(unet, mesh)
    shapes = {"flash_attention": set(), "geglu": set()}

    def attn_hook(module, args, kwargs):
        q = args[0]
        context = args[1] if len(args) > 1 else kwargs.get("context")
        sk = q.shape[1] if context is None else context.shape[1]
        shapes["flash_attention"].add(
            (q.shape[0], q.shape[1], sk, module.heads, module.dim_head))

    def ff_hook(module, args):
        x_in = args[0]
        shapes["geglu"].add((x_in.numel() // x_in.shape[-1],
                             x_in.shape[-1], module.inner_local))

    hooks = [m.register_forward_pre_hook(attn_hook, with_kwargs=True)
             for m in unet.modules() if isinstance(m, tp.TPCrossAttention)]
    hooks += [m.register_forward_pre_hook(ff_hook) for m in unet.modules()
              if isinstance(m, tp.TPFeedForwardGEGLU)]
    wrappers = {name: fn for name, fn, _, _, _ in KERNELS}
    reset_counts(wrappers)
    with torch.no_grad():
        sharded = unet(x, t, ctx)
    torch.cuda.synchronize()
    launches = main_counts(wrappers)
    for h in hooks:
        h.remove()
    with planted(tp, "reduce_from_model", lambda y, mesh: y.float()), \
            torch.no_grad():
        unreduced = unet(x, t, ctx)
    fp32 = torch.load(work / "tp_fp32.pt", weights_only=True)
    q = unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1.to_q
    out = {"forward_rel_l2": rel_l2(sharded.float(), full.float()),
           "full_vs_fp32": rel_l2(full.float(), fp32),
           "tp_vs_fp32": rel_l2(sharded.float(), fp32),
           "fault_rel_l2": rel_l2(unreduced.float(), full.float()),
           "forward_launches": launches,
           "shapes": {k: sorted(v) for k, v in shapes.items()},
           "to_q": tuple(q.weight.shape)}
    del unet, full, sharded, unreduced
    torch.cuda.empty_cache()

    inputs = torch.load(work / "inputs.pt", weights_only=True)
    torch.cuda.reset_peak_memory_stats()
    towers = dist_towers(dev)
    tp.unet_tp(towers["unet"], mesh)
    _, step = dist_step(towers, inputs, dev, mesh)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    out["loss"] = float(step(on_card(inputs["batch"], dev),
                             on_card(inputs["draws"], dev))["loss"])
    torch.cuda.synchronize()
    out.update(step_seconds=time.perf_counter() - t0, peak_gib=peak_gib(),
               step_launches=main_counts(wrappers))
    grads = tp.gather_unet_state(towers["unet"], mesh,
                                 unet_grads(towers["unet"]))
    out["cosine"] = cosines(grads, torch.load(
        work / "reference.pt", weights_only=True)["grads"])
    return out


def run_main(module: str, argv: list) -> dict:
    """A CLI main on a rank (phase 11d), with cuDNN deterministic so that
    a resumed run can be held bitwise to an uninterrupted one; its result,
    kernel launches and peak memory."""
    import importlib

    rank_setup(cudnn_tf32=True)
    wrappers = {name: fn for name, fn, _, _, _ in KERNELS}
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    result = importlib.import_module(module).main(argv)
    torch.cuda.synchronize()
    return {"result": result, "launches": main_counts(wrappers),
            "peak_gib": peak_gib()}


def ranks(target: str, n: int, args: tuple, label: str, out: pathlib.Path,
          backend: str = "gloo") -> tuple:
    """``chip_smoke.<target>(*args)`` on ``n`` ranks; (results, seconds).
    Each rank's output is kept under ``out/<label>``."""
    from ladi_vton_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    results = spawn(f"chip_smoke:{target}", n, args, timeout=DIST_TIMEOUT_S,
                    backend=backend, log_dir=out / label.replace(" ", "_"))
    return results, time.perf_counter() - t0


def add_launches(total: dict, counts: dict) -> None:
    for name in total:
        total[name] += counts.get(name, 0)


def mean_abs_png(a: pathlib.Path, b: pathlib.Path) -> tuple:
    """The PNGs under two directories: (relative paths of a, of b, the
    mean absolute difference of the pixels over [0, 1])."""
    files_a = sorted(p.relative_to(a) for p in a.rglob("*.png"))
    files_b = sorted(p.relative_to(b) for p in b.rglob("*.png"))
    diffs = [np.abs(imageio.open_image(a / f).pixels.astype(np.float64)
                    - imageio.open_image(b / f).pixels) / 255.0
             for f in files_a if f in files_b]
    return files_a, files_b, float(np.mean([d.mean() for d in diffs]))


def inference_argv(work: pathlib.Path, roots: dict,
                   out: pathlib.Path) -> list:
    """Phase 7's ``cli.inference`` run over the VITON-HD split (batch 2,
    DDIM-50, CFG 7.5, PNG output) into ``out``."""
    sd2 = work / "sd2"
    return ["--dataset", "vitonhd", "--vitonhd_dataroot",
            str(roots["vitonhd"]), "--test_order", "paired",
            "--batch_size", "2", "--num_workers", "2", "--seed", "7",
            "--device", "cuda", "--output_dir", str(out),
            "--checkpoint_dir", str(work / "ladi"),
            "--sd2_model_dir", str(sd2),
            "--clip_vision_dir", str(work / "clip_vision"),
            "--tokenizer_dir", str(sd2 / "tokenizer"),
            "--num_inference_steps", "50", "--guidance_scale", "7.5",
            "--use_png"]


def distributed_only(work: pathlib.Path, checked: dict, smi: str) -> dict:
    """``--distributed-only``: the files phase 11 reads, written from
    freshly seeded full-width modules (phase 6's releases and SD-2 and
    CLIP directories, the stock UNet, phase 7's test splits and phase
    10's train splits), the one-process inference run over the VITON-HD
    split as a process, then phase 11."""
    tokenizer = synthetic_tokenizer(work / "sd2" / "tokenizer")
    pipe = full_width_pipeline()
    cond = conditioner("cuda", (512, 384), tokenizer)
    write_checkpoints(work, pipe, cond)
    write_stock_unet(work / "sd2", pipe.unet)
    del pipe, cond
    torch.cuda.empty_cache()
    roots = write_datasets(work)
    train_roots = write_train_data(work / "train_data")
    single = work / "out" / "inference_vitonhd"
    (r,), seconds = ranks("run_main", 1, (
        "ladi_vton_tpu_torch.cli.inference",
        inference_argv(work, roots, single)), "inference single",
        work / "out")
    log(f"phase 11: the one-process inference over the VITON-HD split, "
        f"{r['result']['images']} images in {seconds:.1f} s wall")
    return distributed_path(work, roots, train_roots, single / "paired",
                            tokenizer, checked, smi)


def dist_mains(work: pathlib.Path, roots: dict, train_roots: dict,
               single_inference: pathlib.Path, out: pathlib.Path,
               total: dict, smi: str, dp_peak: float) -> None:
    """Phase 11d: the mains as two ranks with torchrun's variables.
    ``cli.train_vto --shard_optimizer_states`` two steps with a checkpoint
    each, then again from ``checkpoint-1`` alone, resumed: the second
    ``unet_2.pth`` bitwise the first's, and each run's peak memory a rank,
    its checkpoints included, below ``dp_peak`` (phase 11a's unsharded
    step's); ``cli.train_vto --tensor_parallel
    2`` two steps, its gathered ``unet_2.pth`` loaded through the zoo;
    ``cli.inference`` over phase 7's VITON-HD split against the one
    process's images (``single_inference``)."""
    sd2 = work / "sd2"
    vto = ["--dataset", "vitonhd", "--vitonhd_dataroot",
           str(train_roots["vitonhd"]), "--sd2_model_dir", str(sd2),
           "--train_batch_size", str(DIST_BATCH), "--test_batch_size", "1",
           "--num_workers", "2", "--num_workers_test", "2",
           "--max_train_steps", "2", "--lr_warmup_steps", "0",
           "--report_to", "none", "--test_order", "paired", "--seed", "9",
           "--device", "cuda", "--dist_backend", "gloo",
           "--height", str(TRAIN_SIZE[0]), "--width", str(TRAIN_SIZE[1]),
           "--clip_vision_dir", str(work / "clip_vision"),
           "--inversion_adapter_dir", str(work / "ladi"),
           "--tokenizer_dir", str(sd2 / "tokenizer")]
    runs = out / "mains"
    full, part, tp_out = (runs / "zero1", runs / "zero1_resumed",
                          runs / "tp")
    module = "ladi_vton_tpu_torch.cli.train_vto"

    def run(label: str, argv: list) -> list:
        results, seconds = ranks("run_main", 2, (module, argv), label, runs)
        for r in results:
            add_launches(total, r["launches"])
        lines = metric_lines(pathlib.Path(argv[argv.index("--output_dir")
                                               + 1]) / "metrics.jsonl")
        log(f"phase 11d {label}: {seconds:.1f} s wall for two ranks on one "
            f"card, step {[r['result'] for r in results]}, losses "
            f"{[x['loss'] for x in lines]}, step seconds "
            f"{[round(1 / x['steps_per_sec'], 3) for x in lines]} (host "
            f"clock, each with its batch's loading), peak device memory over "
            f"the run, its checkpoints included, "
            f"{[round(r['peak_gib'], 2) for r in results]} GiB a rank, "
            f"launches {[r['launches'] for r in results]} [{smi}]")
        if any(r["result"] != 2 for r in results):
            raise AssertionError(f"{label}: the ranks ended at "
                                 f"{[r['result'] for r in results]}")
        if "--shard_optimizer_states" in argv and any(
                r["peak_gib"] >= dp_peak for r in results):
            raise AssertionError(f"{label}: a rank's peak is not below the "
                                 f"unsharded step's {dp_peak:.2f} GiB")
        return lines

    zero = vto + ["--checkpointing_steps", "1", "--shard_optimizer_states"]
    lines = run("train_vto --shard_optimizer_states",
                zero + ["--output_dir", str(full)])
    # the first run's checkpoint-1 alone, moved (each is 10.5 GB)
    part.mkdir(parents=True)
    shutil.move(str(full / "checkpoint-1"), part / "checkpoint-1")
    shutil.rmtree(full / "checkpoint-2")
    resumed = run("train_vto --shard_optimizer_states resumed",
                  zero + ["--output_dir", str(part),
                          "--resume_from_checkpoint", "latest"])
    a = torch.load(full / "unet_2.pth", weights_only=True)
    b = torch.load(part / "unet_2.pth", weights_only=True)
    if not same_params(a, b) or resumed[-1]["loss"] != lines[-1]["loss"]:
        raise AssertionError("the resumed ZeRO-1 run differs from the "
                             "uninterrupted one")
    del a, b
    shutil.rmtree(full)
    shutil.rmtree(part)
    run("train_vto --tensor_parallel 2", vto + [
        "--output_dir", str(tp_out), "--checkpointing_steps", "2",
        "--tensor_parallel", "2"])
    unet = zoo.extended_unet(checkpoint=str(tp_out / "unet_2.pth"),
                             device="cuda", dtype=BF16)
    q = unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1.to_q
    log(f"phase 11d: the resumed ZeRO-1 run's unet_2.pth is bitwise the "
        f"uninterrupted run's, its step-2 loss {resumed[-1]['loss']}; the "
        f"tensor-parallel run's gathered unet_2.pth loads through the zoo "
        f"(to_q {tuple(q.weight.shape)}, "
        f"{sum(p.numel() for p in unet.parameters())} parameters)")
    del unet
    torch.cuda.empty_cache()
    shutil.rmtree(tp_out)

    two = runs / "inference"
    results, seconds = ranks("run_main", 2, (
        "ladi_vton_tpu_torch.cli.inference",
        inference_argv(work, roots, two) + ["--dist_backend", "gloo"]),
        "inference", runs)
    for r in results:
        add_launches(total, r["launches"])
    ours, ref, diff = mean_abs_png(two / "paired", single_inference)
    log(f"phase 11d inference over two ranks (data 2, batch 2, DDIM-50): "
        f"{seconds:.1f} s wall, {[r['result']['images'] for r in results]} "
        f"images, {len(ours)} files; mean absolute difference from the one "
        f"process's images {diff:.3e} (limit {DIST_IMAGE_LIMIT}); launches "
        f"{[r['launches'] for r in results]} [{smi}]")
    if ours != ref or not len(ours) or not diff <= DIST_IMAGE_LIMIT:
        raise AssertionError("the two-rank inference differs from the one "
                             "process's")


def distributed_path(work: pathlib.Path, roots: dict, train_roots: dict,
                     single_inference: pathlib.Path, tokenizer,
                     checked: dict, smi: str) -> dict:
    """Phase 11: the data-parallel, ZeRO-1, NCCL and tensor-parallel steps,
    the mains over ranks and the dry run, with the files of phases 6, 7
    and 10 under ``work``; every check of the comment above.  Returns the
    kernels' launches summed over every rank of the phase."""
    t_phase = time.perf_counter()
    out = work / "dist"
    out.mkdir()
    log(f"phase 11: this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card "
        f"before the ranks start; two ranks share the one card over gloo "
        f"(NCCL refuses two ranks on one device) and one rank runs over "
        f"NCCL, without gradient checkpointing")
    total = {name: 0 for name, _, _, _, _ in KERNELS}
    ref = dist_reference(out, tokenizer)

    results, seconds = ranks("dp_rank", 2, (str(out),), "dp", out)
    for r in results:
        for tag in ("dp", "zero1"):
            add_launches(total, r[tag]["launches"])
        log(f"phase 11a rank {results.index(r)}: data-parallel steps "
            f"{[round(x, 3) for x in r['dp']['seconds']]} s (the first with "
            f"its warm-up), first loss "
            f"{r['dp']['loss']:.6f} against {ref['loss']:.6f}, gradient "
            f"cosine by part "
            f"{({k: round(v, 6) for k, v in r['cosine'].items()})}, peak "
            f"device memory {r['dp']['peak_gib']:.2f} GiB, AdamW "
            f"elements {r['dp']['adam_numel']}; ZeRO-1 steps "
            f"{[round(x, 3) for x in r['zero1']['seconds']]} s, peak "
            f"{r['zero1']['peak_gib']:.2f} GiB, AdamW elements "
            f"{r['zero1']['adam_numel']}, updates bitwise the unsharded "
            f"ones: {r['zero1_bitwise']}; launches of a step "
            f"{r['dp']['launches']}; planted fault, no gradient all_reduce: "
            f"cosine by part "
            f"{({k: round(v, 6) for k, v in r['fault_cosine'].items()})} "
            f"(limit {DIST_GRAD_COS}) [{smi}]")
        rel = abs(r["dp"]["loss"] - ref["loss"]) / abs(ref["loss"])
        half = r["zero1"]["adam_numel"] / r["dp"]["adam_numel"]
        if not (rel <= DIST_LOSS_LIMIT and r["zero1_bitwise"]
                and min(r["cosine"].values()) >= DIST_GRAD_COS
                and 0.3 < half < 0.7):
            raise AssertionError(f"phase 11a: rank {results.index(r)} "
                                 f"disagrees (loss {rel:.3e} relative, ZeRO "
                                 f"state share {half:.3f})")
        if min(r["fault_cosine"].values()) >= DIST_GRAD_COS:
            raise AssertionError("phase 11a: the gradient limit does not "
                                 "tell a step without its all_reduce")
    dp_peak = max(r["dp"]["peak_gib"] for r in results)
    log(f"phase 11a: two ranks in {seconds:.1f} s wall")

    (r,), seconds = ranks("nccl_rank", 1, (str(out),), "nccl", out,
                          backend="nccl")
    log(f"phase 11b: one rank over {r['backend']} (world {r['world']}): "
        f"loss {r['loss']:.6f}, the step and its update bitwise the one "
        f"without a process group: {r['bitwise']} ({seconds:.1f} s wall)")
    if r["backend"] != "nccl" or not r["bitwise"]:
        raise AssertionError("phase 11b: the NCCL step differs")

    tp_reference(out)
    results, seconds = ranks("tp_rank", 2, (str(out),), "tp", out)
    for i, r in enumerate(results):
        add_launches(total, r["forward_launches"])
        add_launches(total, r["step_launches"])
        rel = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        missing = {name: [s for s in r["shapes"][name]
                          if list(s) not in checked[name]]
                   for name in r["shapes"]}
        log(f"phase 11c rank {i}: the tensor-parallel UNet forward (batch "
            f"{TP_FORWARD[0]}, {TP_FORWARD[1]}x{TP_FORWARD[2]} latents, "
            f"bf16) against the unsharded one: relative L2 "
            f"{r['forward_rel_l2']:.3e} (limit {TP_FORWARD_LIMIT}); "
            f"against the fp32 CPU forward, the unsharded "
            f"{r['full_vs_fp32']:.3e} and the tensor-parallel "
            f"{r['tp_vs_fp32']:.3e}; planted fault, the partial sums "
            f"unreduced: {r['fault_rel_l2']:.3e}; its "
            f"launches {r['forward_launches']}, K1 at "
            f"{r['shapes']['flash_attention']}, K4 at "
            f"{r['shapes']['geglu']}; to_q {r['to_q']}; the "
            f"tensor-parallel step {r['step_seconds']:.3f} s (with its "
            f"warm-up), loss {r['loss']:.6f} ({rel:.3e} relative, limit "
            f"{DIST_LOSS_LIMIT}), gathered gradient cosine by part "
            f"{({k: round(v, 6) for k, v in r['cosine'].items()})}, peak "
            f"{r['peak_gib']:.2f} GiB, launches {r['step_launches']} "
            f"[{smi}]")
        if any(missing.values()):
            raise AssertionError(f"phase 2 does not check the shard shapes "
                                 f"{missing}")
        if not (r["forward_rel_l2"] <= TP_FORWARD_LIMIT
                and rel <= DIST_LOSS_LIMIT
                and min(r["cosine"].values()) >= DIST_GRAD_COS
                and r["forward_launches"]["flash_attention"]
                and r["forward_launches"]["geglu"]):
            raise AssertionError(f"phase 11c: rank {i} disagrees")
        if r["fault_rel_l2"] <= TP_FORWARD_LIMIT:
            raise AssertionError("phase 11c: the forward's limit does not "
                                 "tell unreduced partial sums")
    log(f"phase 11c: two ranks in {seconds:.1f} s wall")

    dist_mains(work, roots, train_roots, single_inference, out, total, smi,
               dp_peak)

    from ladi_vton_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    results = dryrun_multichip(2, "cuda", timeout=DIST_TIMEOUT_S,
                               log_dir=out / "dryrun")
    for r in results:
        for counts in r["launches"].values():
            add_launches(total, counts)
    log(f"phase 11e: dryrun_multichip(2) on the card in "
        f"{time.perf_counter() - t0:.1f} s: losses "
        f"{[(r['loss1'], r['loss2'], r['loss4']) for r in results]}, "
        f"launches by phase {[r['launches'] for r in results]}")
    missing = [name for name in ("flash_attention", "group_norm", "geglu",
                                 "layer_norm")
               if not all(r["launches"]["4"][name] for r in results)]
    if missing:
        raise AssertionError(f"the dry run's TP step never launched "
                             f"{missing}")
    missing = [name for name, n in total.items() if not n]
    if missing:
        raise AssertionError(f"kernels never launched in phase 11: {missing}")
    log(f"phase 11: distribution ({time.perf_counter() - t_phase:.1f} s)")
    return total


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
    parser.add_argument("--training-only", action="store_true",
                        help="phase 2's gradient rows and phase 10 alone "
                        "(its files written from freshly seeded modules), "
                        "then exit without the result lines")
    parser.add_argument("--distributed-only", action="store_true",
                        help="phase 2's tensor-parallel rows and phase 11 "
                        "alone (its files written from freshly seeded "
                        "modules), then exit without the result lines")
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
    if args.training_only:
        check_gradients(gen)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            training_only(pathlib.Path(work), smi)
        return
    if args.distributed_only:
        checked = check_tensor_parallel_rows(gen, {})
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            log(f"launches during phase 11: "
                f"{distributed_only(pathlib.Path(work), checked, smi)}")
        return
    results = {}
    for name, _, check, _, _ in KERNELS:
        results[name] = check(gen)
    for name, grad in check_gradients(gen).items():
        results[name]["grad"] = grad
    checked = check_tensor_parallel_rows(gen, results)
    log("phase 2: every kernel agrees with its plain version, and so do "
        "its gradients")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        counts = run_phases(pathlib.Path(work), gen, smi, checked)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces,
         **{key: by_kernel[name] for key, by_kernel in counts.items()},
         **results[name]}
        for name, _, _, source, replaces in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_phases(work: pathlib.Path, gen: Gen, smi: str, checked: dict) -> dict:
    """Phases 3 to 11, with the files they write under ``work``; returns
    the kernels' launches on phase 5's (``launches``), 6's, 7's, 8's, 9's,
    10's and 11's paths, by phase.  ``checked``: the tensor-parallel
    shapes phase 2 checked."""
    t0 = time.perf_counter()
    tokenizer = synthetic_tokenizer(work / "sd2" / "tokenizer")
    check_blocks(gen)
    pipe = full_width_pipeline()
    check_small_sample(pipe)
    check_tiled_decode(pipe.vae)
    check_conditioner(tokenizer)
    log(f"phase 3: full-width blocks, the sampler under each scheduler and "
        f"with hoisted K/V, the tiled decode and the conditioner agree with "
        f"the CPU ({time.perf_counter() - t0:.1f} s)")

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

    launches, cond, record = serve_raw_requests(service, wrappers,
                                                tokenizer)
    log(f"launches during the two raw requests: {launches}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the raw-request "
                             f"path: {missing}")

    t0 = time.perf_counter()
    zoo_launches, zpipe, zcond = zoo_path(work, pipe, cond, record, wrappers)
    log(f"launches during phase 6's four raw requests: {zoo_launches}")
    missing = [name for name, count in zoo_launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the zoo path: "
                             f"{missing}")
    log(f"phase 6: the zoo path ({time.perf_counter() - t0:.1f} s)")

    mains_launches, roots = mains_path(work, zpipe, zcond, wrappers, smi)
    log(f"launches during phase 7's five CLI runs: {mains_launches}")

    t0 = time.perf_counter()
    serve_launches, raw, served = serving_path(work, zpipe, zcond, wrappers,
                                               smi)
    serve_process(work, raw, served, smi)
    log(f"phase 8: serving ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    metrics_launches = metrics_path(work, roots, zcond, wrappers, smi)
    log(f"launches during phase 9's metric mains: {metrics_launches}")
    log(f"phase 9: the metrics ({time.perf_counter() - t0:.1f} s)")

    train_launches = training_path(work, zpipe, zcond, tokenizer, wrappers,
                                   smi)
    log(f"launches during phase 10's training runs: {train_launches}")

    # phase 11's ranks need the card: this process lets go of its modules,
    # and of phase 10's checkpoints on disk
    del pipe, service, cond, record, zpipe, zcond, raw, served
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work / "train", ignore_errors=True)
    dist_launches = distributed_path(
        work, roots, {"vitonhd": work / "train_data" / "vh" / "vitonhd"},
        work / "out" / "inference_vitonhd" / "paired", tokenizer, checked,
        smi)
    log(f"launches during phase 11: {dist_launches}")
    return {"launches": launches, "zoo_launches": zoo_launches,
            "mains_launches": mains_launches,
            "serve_launches": serve_launches,
            "metrics_launches": metrics_launches,
            "train_launches": train_launches,
            "dist_launches": dist_launches}


if __name__ == "__main__":
    main()
