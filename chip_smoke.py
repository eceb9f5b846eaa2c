#!/usr/bin/env python3
"""Drive the PyTorch port's try-on path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep-geglu       # K4's device time per tiling
    python3 chip_smoke.py --sweep-group-norm  # K2's device time per plan
    python3 chip_smoke.py --sweep-layer-norm  # K5's device time per plan
    python3 chip_smoke.py --training-only     # phase 2's gradients, phase 10
    python3 chip_smoke.py --distributed-only  # phase 2's TP rows, phase 11
    python3 chip_smoke.py --graphs-only       # phases 12, 13 and 14
    python3 chip_smoke.py --jpeg-only         # phase 7's JPEG decoder
    python3 chip_smoke.py --sd15-only         # phase 2's SD-1.5 K1 rows, 15
    python3 chip_smoke.py --k1-only           # phase 2's K1 rows alone
    python3 chip_smoke.py --sweep-k1          # K1's device time per tiling

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
   ``F.linear``, ``F.layer_norm``); K1's gradient rows include the SD-1.5
   trainers' shapes (eight heads of 40, 80 and 160,
   ``ATTN_SD15_GRAD_SHAPES``).  K1 also runs at the SD-1.5 UNet's
   shapes (``ATTN_SD15_SHAPES``) and at their edges
   (``ATTN_SD15_EDGE_SHAPES``: ragged Sq and Sk, a ragged cross-attention,
   q, k and v as strided views of one fused tensor), each K1 row printing
   the exponentials' floor beside its bound, and a call at D = 96 must
   raise.
   Last, K1 and K4 at the shapes a tensor-parallel UNet (model 2, batch
   4) gives them: K1 on half the heads of the SD-2 UNet's levels 1 and 2
   and its mid block, and on four of the SD-1.5 UNet's eight heads at
   every level (``ATTN_SD15_TP_SHAPES``), K4 at half the inner width of
   each level, each row as above.  Then an A/B of
   ``Upsample2D``'s two forms at the path's 1280- and 512-channel sites
   (``UPSAMPLE_SITES``): the phase form of ``ops/upsample.py`` against
   interpolate then the 3x3 convolution, device times from CUDA graphs
   and the forms' difference in bf16 (``Upsample2D`` keeps the second);
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
   of the GroupNorm and LayerNorm calls of the service's warm-up (a
   2-image request that captures the sampler's graphs: its prepare, one
   UNet step and its decode, each run eagerly and then captured, so each
   call twice) lists their shapes and K2's and K5's plan for each, and
   fails if phase 2 missed one of those plans;
5. raw requests: a ``ConditionService`` at full width (ViT-H/14 vision,
   SD-2 text, the SD-2 inversion adapter in bf16; TPS at 256x192 and the
   refinement at 512x384 in fp32; ``num_vstar`` 16) in front of the
   phase-4 service turns cloth, pose, masked person and category into
   the try-on inputs, for requests of 1 and 2 images; conditioning and
   total seconds and peak memory per request, every output checked, and
   K5 launched in both stages, K2's calls and kernel launches per
   request logged.  The conditioning replays ``Conditioner.jit()``'s
   graph and the try-on phase 4's graphs, which call no hook: K5's
   census of the conditioning is taken over the warm-up request, which
   captures the conditioning's graph, and checked as in phase 4.  The
   port's CLIP BPE tokenizer reads a synthetic vocabulary
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
7. first the JPEG decoder on the host (``csrc/host/jpeg_decode.cpp``,
   built by this machine's compiler): each committed fixture
   (``tests/fixtures/jpeg``: progressive, smoothed, arithmetic-coded,
   4:4:0, 4:1:1, CMYK, YCCK, Adobe-RGB, RGB-labelled) bitwise against
   PIL's pixels
   beside it; a VITON-HD item whose person and cloth are the progressive
   fixtures, read with no sidecar; a 1024x768 image's coefficients
   written baseline, progressive and arithmetic-coded
   (``tools/bench_jpeg_decode.py``), decoded bitwise alike, each decode
   timed, and a VITON-HD item's load from each kind of person and cloth
   timed (host clock).  Then the CLIs: a DressCode (one category) and a
   VITON-HD test split of 2 pairs each, written at the datasets'
   1024x768 by the port's PNG writer under the datasets' file names
   (``data/synthetic.py``), with the warped-cloth and CLIP-feature
   caches; ``cli.inference.main`` over each
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
   ``cli.inference --compute_metrics`` (its images byte for byte the PNG
   run's, its JSON equal to ``val_metrics``' over them) and
   ``cli.compute_cloth_clip_features`` over the VITON-HD test split (each
   feature equal to the zoo-loaded tower called directly, K5 launched),
   each main's seconds logged;
10. training: the VTO loss and its UNet gradient at full SD-2 width on one
   128x128 image, on the card (bf16 autocast, fp32 parameters, the kernels'
   Functions) against the CPU (fp32), same weights and draws (loss within
   a stated relative limit, each part of the UNet's gradient to a stated
   cosine similarity) (phase 14 times the step alone, graphed and
   eager); then the four trainers at 512x384 from 1024x768
   synthetic train splits of both datasets (``data/synthetic.py``) and
   phase 6's files (the stock UNet written under ``sd2/unet``, a seeded
   torchvision-layout VGG19): ``train_vto`` two steps, resumed for two
   more with ``--gradient_checkpointing`` and ``--async_checkpointing``;
   ``train_emasc``
   (DressCode, every category; three steps with an asynchronous
   checkpoint each, so that keeping two deletes the first),
   ``train_inversion_adapter`` and
   ``train_tps`` (batch 1, one epoch of each phase, then the
   extraction), each replaying its step programs.  Every step must leave
   a finite gradient on every trained parameter, and each step program's
   first replayed step move them (``GradientWatch``: what the host sees
   of a replay), the losses be finite, each kernel the step runs be
   launched, the GroupNorm and LayerNorm census of ``train_vto`` and
   ``train_emasc`` be covered by phase 2; ``train_vto``'s checkpoints are
   resumed and each trainer keeps its last two, the ``.pth`` exports load
   back through the zoo, and
   ``cli.eval`` reads the warped cloths ``train_tps`` extracted with the
   trained exports.  Each run logs its step seconds, peak memory and
   launches;
11. distribution, most of it after this process lets go of the card (it
   holds a fraction of a GiB when those ranks start) and of phase 10's
   checkpoints: ranks as processes with torchrun's variables
   (``parallel.launch``), two sharing the card over gloo (NCCL refuses
   two ranks on one device), each killed with the others on a failure
   or a timeout.
   (a) the full-width VTO step (512x384, fp32 UNet and AdamW, frozen
   bf16 towers) over two ranks at a global batch of 2 against this
   process's step at batch 2 on the same batch and draws: the loss and
   each UNet part's reduced gradient within stated limits, and the same
   step with the gradient ``all_reduce`` left out (a planted fault)
   outside the gradient's limit; then under ZeRO-1, its updates bitwise
   the unsharded ones and each rank holding half of the AdamW state.
   Each form runs three steps graphed (the real step, then the capture
   of its two stages, the gradients' and the update's, with the
   collectives eager between and after them; then replays), which must
   be bitwise the same steps through ``run_eager`` and launch the same
   kernels; step, warm-up and capture seconds, peak memory and the
   graphs' pool a rank.  The data-parallel step again with the dry
   run's tiny towers over two batch shapes (A, B, A), graphed bitwise
   ``run_eager``, and with a planted revert (the first shape's replay
   averaging the second capture's gradients) outside that equality; two
   ranks of their own run it after (f).
   (b) one rank over NCCL: three steps of the staged program over its
   group of one bitwise three graphed steps without a group; their
   replays beside the same program's stages run eagerly.  (c) data 1 x
   model 2: the tensor-parallel UNet
   forward (batch 4, 64x48 latents) against the unsharded one, each of
   the two also against an fp32 CPU forward of the same weights, and the
   forward with ``reduce_from_model`` left out (a planted fault) outside
   the limit; K1's and K4's calls counted and their shard shapes held to
   phase 2's tensor-parallel rows; then, in the same ranks, the same for
   the eight-head SD-1.5 UNet (a 768-wide context), whose every attention
   holds four heads a rank, held to its own fp32 CPU forward; for each
   of the two UNets, the tensor-parallel denoise step (DDIM-50, 512x384,
   batch 2, the UNet at 4 under CFG 7.5) as pieces
   (``pipelines.graphs.Graph``: one graph more than the step has
   ``all_reduce``s over the model axis, which run eagerly between them),
   captured once and replayed over three fresh inputs, each bitwise the
   eager step on the same inputs with its launches and its
   ``all_reduce``s, one cut at each of the eager step's ``all_reduce``s,
   on a buffer of its shape, and a replay with one cut's ``all_reduce``
   skipped (a planted fault) outside that equality; capture, replay and
   eager seconds; one tensor-parallel step's loss and
   its gradient, gathered to the reference layout, by UNet part against
   (a)'s; the step runs eagerly and says why.  (d) the mains over two
   ranks: ``train_vto --shard_optimizer_states`` two steps (the second
   replays the first's graphs, as its log says), the peak memory of each
   rank, its consolidated checkpoint included, below (a)'s unsharded
   step's (the resume of a ZeRO-1 checkpoint into the sharded optimizer
   runs on the card in (e)'s phase 2);
   ``train_vto --tensor_parallel 2`` one step, eager as its log says,
   its gathered ``unet_1.pth``
   loaded through the zoo; ``cli.inference`` over phase 7's VITON-HD
   split against phase 7's images.  (e) ``dryrun_multichip(2)`` on the
   card, every kernel launched in its tensor-parallel step.  (f)
   ``cli.serve`` over two ranks from phase 6's files, at data 2 and at
   ``--tensor_parallel 2`` (DDIM-10, CFG 7.5, batch 2): phase 8's 2-image
   raw request over HTTP within phase 11d's image limit of the one
   process's answer to the same flags, a planted missing gather (the
   follower's rows replaced by rank 0's) outside it, K1, K2, K4 and K5
   launched on each rank, and SIGINT to rank 0 ending both ranks with
   exit 0; at model 2 the start line names the graphed sampler with its
   step in pieces, and each rank logs its step captured as pieces.
   (d)'s ``cli.inference``, (e), (f) and (a)'s second batch shape, ranks
   alone, start before phase 10 and run beside its mains
   (``ServedLane``); after phase 10 and the one-process references, the
   rest runs in stages of jobs that fit on the card together
   (``DIST_STAGES``): (a) beside (b) and, once (a)'s ranks have ended
   their data-parallel form and (b) has ended, the tensor-parallel
   ``train_vto``; then the ZeRO-1 one beside
   (c) (each trainer writes a 10.5 GB checkpoint);
12. the sampler as CUDA graphs (``TryOnPipeline.jit_sample``; run right
   after phase 3, on phase 4's full-width modules at 512x384 and CFG
   7.5): each mode (``split=False``; ``split=True`` with ``"scan"`` and
   with ``"host"``) under DDIM-20 at batch 2, ``"host"`` under DDIM-10
   at batch 8, and ``"host"`` under dpm-10, pndm-10 and lms-10 and
   DDIM-10 with ``cloth_cond_rate`` 0.5 at batch 2, two requests each
   with their own inputs and draws: every graphed
   image bitwise equal to the eager ``sample``; the capture seconds,
   each request's seconds and peak memory graphed and eager, the memory
   the graphs hold; two planted faults that must break the equality (a
   replay over stale static inputs; a ``"host"`` step captured with the
   cloth gate as a Python bool); and one request of the callers' sampler
   (``split=True``, ``"host"``) under torch.profiler, graphed and eager:
   the busy share, the kernels, and K1, K2 (each form), K4 and K5 by
   name, on the one trace, equal to the launch counters;
13. the conditioning as CUDA graphs (``Conditioner.jit()``, run right
   after phase 12, on phase 5's full-width conditioning towers):
   ``ConditionService`` at batch 2 and 8, two requests each (the first
   captures) whose rows mix a ``$`` run, a prompt without ``$`` and a
   run cut by the 77 tokens; every output bitwise equal to the eager
   ``Conditioner`` on the same padded inputs; capture seconds, request
   seconds and peak memory graphed and eager, the memory the graph
   holds; a replay over the first request's static inputs must not give
   the second request's outputs (a planted fault); the boolean-mask
   splice the port had must fail to capture, in a process of its own
   that runs beside the phase, where the static splice captures (a
   planted fault); and at batch 2
   one request under torch.profiler, graphed and eager, K5's kernels by
   name equal to the launch counters on the one trace.  Then the
   drivers' programs (the VAE reconstruction, the try-on driver on the
   vision tower and on noun chunks, the adapter's validation with a
   9-channel SD-2 UNet under bf16 autocast; DDIM-5, batches of 2 and 1
   image) graphed against their bodies called eagerly: every image
   bitwise equal, and each program's capture seconds;
14. the train steps as CUDA graphs (``pipelines.graphs.TrainProgram``,
   run right after phase 13, on freshly seeded full-width trained towers
   beside phase 4's and 5's frozen ones, cuDNN deterministic): the VTO
   step at 512x384 (batch 1 with gradient checkpointing off and on,
   batch 2 with gradient accumulation 2), EMASC, the inversion adapter
   (the stock 9-channel UNet frozen), TPS at 256x192 and the refinement
   (batch 2), each graphed against its eager body from a copy of the
   same modules over three steps, under a warm-up schedule whose learning
   rate changes at every step (TPS and the refinement: their constant
   Adam): after every step the metrics, parameters, BatchNorm
   statistics, AdamW moments and step counters, count and learning rate
   bitwise equal; the seconds graphed and eager, the warm-up's and the
   capture's, the peaks and the graph's pool; for VTO batch 1 and each
   other kind one more step under torch.profiler, graphed and eager: the
   busy share and each kernel's launches a step, equal to the
   profiler's count on one trace.  Two planted faults on the EMASC step
   must land off the eager trajectory (the learning rate baked into the
   capture; the capture's call updating twice); the capturable AdamW
   must stay within a stated limit of the non-capturable one on one
   gradient sequence; and the TPS evaluation (warped, refined) and extraction
   and the three metric towers (TF32 off) must replay bitwise their
   eager bodies, with each graph's pool and the FFT kernels a replay
   runs.  First, one graph of K2 at its phase-2 shapes replayed 1000 times
   in one trace, its kernel records counted against the launches, with
   the replays right after the trace starts and after a margin (where a
   trace loses records; a profile check that disagrees is taken again,
   up to three traces);
15. the SD-1.5 family (run right after phase 5): ``sd15_unet_config``'s
   31-channel UNet (1x1-conv projections, eight heads at every width, a
   768-wide context) with seeded bf16 weights beside phase 4's VAE and
   EMASC, the SD-1.5 text tower (12 x 768, quick_gelu) and an inversion
   adapter to 16 x 768 beside phase 5's vision tower, TPS and refinement:
   a ``Transformer2D`` at each level at 512x384 (B=2) and one UNet step
   at 256x192 (batch 1) on the card against the CPU, the step with its
   hoisted context K/V bitwise the inline one, the text tower against the
   CPU;
   one graphed DDIM-50, CFG 7.5 request of 2 images (its capture and a
   replay) bitwise its eager body, K1's calls by shape; then a raw
   2-image request through ``ConditionService`` and
   ``TryOnService(context_dim=768)`` with its seconds, peak memory and
   every kernel launched; last, the eight-head VTO step at 512x384,
   batch 1 (the SD-1.5 UNet trained in fp32, the VAE, text tower and
   adapter frozen in bf16) as a ``TrainProgram`` against its eager body
   over phase 14's three steps and schedule, as phase 14's VTO step:
   bitwise after every step, its launches a step confirmed by the
   profiler on one trace, every kernel launched.

Phases 4, 5, 6, 7, 8, 11 and 15 sample through ``jit_sample``
(``TryOnService``, the mains, ``split=True`` with ``"host"``), and
phases 5 to 10 condition, encode prompts, run the vision tower, the VAE
reconstruction and the adapter's validation through the other programs
of ``pipelines.graphs`` (``ConditionService``, the mains, the trainers'
validation): on the card their graphs replay, and a replay adds what
the launch counters rose by during the capture; phases 7, 9 and 10 log
each program's capture seconds.  A replay runs no Python and so no
forward hook: phase 4's censuses of the try-on, and phase 5's of the
conditioning, are taken over the capture (its warm-up run and the
capture itself).

Phases 2, 3 and 12 compare with TF32 off for matmuls and cuDNN; phase
13 and phases 4 on serve with PyTorch's defaults (cuDNN TF32 allowed,
matmul TF32 off), which the port leaves as they are: with cuDNN TF32 off, cuDNN runs
the fp32 refinement through FFT convolutions that take ~60x longer and
a ~20 GiB workspace (``tools/profile_raw_request.py``).

The line before the last is ``{"kernels": [...]}``, with the launches
of phase 5 (phase 15's raw request as ``sd15_launches`` and a replay of
its train step as ``sd15_train_launches``, phase 6's as
``zoo_launches``, phase 7's five CLI runs' as
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
import importlib.util
import io
import json
import logging
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ladi_vton_tpu_torch.cli import compute_cloth_clip_features as clip_main
from ladi_vton_tpu_torch.cli import eval as eval_cli
from ladi_vton_tpu_torch.cli import generate_fid_stats as stats_main
from ladi_vton_tpu_torch.cli import inference as inference_cli
from ladi_vton_tpu_torch.cli import serve as serve_cli
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
from ladi_vton_tpu_torch.data.dresscode import _to_float as dresscode_to_float
from ladi_vton_tpu_torch.data.features import ClothFeatureCache
from ladi_vton_tpu_torch.diffusion.schedulers import (
    DDIMScheduler,
    make_scheduler,
)
from ladi_vton_tpu_torch.diffusion.text import (
    VSTAR_TOKEN_ID,
    encode_text_word_embedding,
    splice_word_embeddings,
)
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models.clip import (
    CLIPTextModel,
    CLIPVisionModel,
    sd2_text_config,
    sd15_text_config,
    vit_h_vision_config,
)
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.layers import (
    CrossAttention,
    GroupNorm,
    LayerNorm,
    Transformer2D,
)
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.models.tps import ConvNetTPS
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    sd2_unet_config,
    sd15_unet_config,
)
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, MidBlock, VAEConfig
from ladi_vton_tpu_torch.models.vgg import VGG19Features
from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.ops import layer_norm as ln
from ladi_vton_tpu_torch.ops.attention import attention_ref
from ladi_vton_tpu_torch.ops.flash_attention import flash_attention, flash_plan
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
from ladi_vton_tpu_torch.ops.upsample import (
    nearest_up2_conv3x3,
    phase_kernels,
)
from ladi_vton_tpu_torch.metrics.compute import (
    MetricModels,
    _gt_image_paths,
    _load_batch,
)
from ladi_vton_tpu_torch.metrics.inception import InceptionV3, strict_fp32
from ladi_vton_tpu_torch.metrics.lpips import LPIPS
from ladi_vton_tpu_torch.metrics.ssim import ssim as ssim_fn
from ladi_vton_tpu_torch.pipelines import drivers, graphs, inpaint
from ladi_vton_tpu_torch.pipelines.condition import Conditioner, clip_pixels
from ladi_vton_tpu_torch.pipelines.serving import (
    ConditionService,
    MicroBatcher,
    TryOnService,
    category_prompts,
    make_http_server,
)
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.parallel.launch import spawn
from ladi_vton_tpu_torch.train import steps as steps_mod
from ladi_vton_tpu_torch.train.steps import (
    VTOStepConfig,
    emasc_draws,
    make_emasc_train_step,
    make_optimizer,
    make_vto_loss,
    make_vto_train_step,
    precision,
    vto_draws,
)
from ladi_vton_tpu_torch.train.tps_steps import (
    TPS_SIZE,
    adapter_draws,
    eval_batch,
    extraction_pixels,
    make_inversion_adapter_train_step,
    make_refinement_train_step,
    make_tps_train_step,
    tps_optimizer,
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


_LOG_LOCK = threading.Lock()
_START = time.perf_counter()


def log(msg: str) -> None:
    """One line to stdout, after the seconds since the process started,
    whole even while phase 11's lanes log too."""
    with _LOG_LOCK:
        sys.stdout.write(f"[{time.perf_counter() - _START:7.1f} s] {msg}\n")
        sys.stdout.flush()


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


# the special-function units' exponentials a second (16 a clock on each of
# the 132 SMs: the CUDA programming guide's throughput table for compute
# capability 9.0): K1's floor if every score's exp2 ran there
SFU_EXP2_PER_S = 3.9e12


def attention_row(gen: Gen, B: int, Sq: int, Sk: int, H: int,
                  D: int, fused: bool = False) -> dict:
    """K1 at one shape against its plain version: error, times, bound.
    ``fused``: q, k and v are strided views of one (B, S, 3, H, D) tensor,
    as a fused projection gives them (self-attention)."""
    if fused:
        qkv = gen.normal(B, Sq, 3, H, D)
        q, k, v = qkv.unbind(2)
    else:
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
    shape = f"B={B} Sq={Sq} Sk={Sk} H={H} D={D}" + (" fused" if fused else "")
    r = row(shape, err, t, b)
    # printed beside the bound, not a measured number: kept out of the row
    exp_floor_ms = B * H * Sq * Sk / SFU_EXP2_PER_S * 1e3
    plan = flash_plan(D, Sq, Sk, B * H, _build.sm_count(q.device))
    log(f"K1 flash_attention {r['shape']}: max_abs_err {err:.3e} (limit "
        f"{ATTN_LIMIT}) {describe(r, 'F.scaled_dot_product_attention')}; "
        f"exp floor {exp_floor_ms:.4f} ms; plan block_q "
        f"{plan.block_q} block_k {plan.block_k} split {plan.split}")
    if not err <= ATTN_LIMIT:
        raise AssertionError(f"flash_attention disagrees: {err}")
    return r


# K1 at the SD-1.5 UNet's shapes at the path's batch 4: eight heads at
# every level, self- and cross-attention (Sk = 77) at each level and in
# the mid block (S = 48)
ATTN_SD15_SHAPES = [(4, 3072, 3072, 8, 40), (4, 3072, 77, 8, 40),
                    (4, 768, 768, 8, 80), (4, 768, 77, 8, 80),
                    (4, 192, 192, 8, 160), (4, 192, 77, 8, 160),
                    (4, 48, 48, 8, 160), (4, 48, 77, 8, 160)]
# the same at model 2 (phase 11c's eight-head forward): four heads a rank
ATTN_SD15_TP_SHAPES = [(B, Sq, Sk, H // 2, D)
                       for B, Sq, Sk, H, D in ATTN_SD15_SHAPES]
# K1's edges at each SD-1.5 head dim: Sq and Sk multiples of no tile, in
# 128-row items (B = 2) and in the split form (B = 1, an odd number of K/V
# tiles), a ragged cross-attention (Sk = 77), and q, k, v as strided views
# of one fused (B, S, 3, H, D) tensor; (B, Sq, Sk, H, D, fused)
ATTN_SD15_EDGE_SHAPES = [
    row for D in (40, 80, 160)
    for row in ((2, 1000, 300, 8, D, False), (1, 1000, 300, 8, D, False),
                (2, 1000, 77, 8, D, False),
                (2, {40: 3072, 80: 768, 160: 192}[D], None, 8, D, True))]
# K1's gradient rows at the SD-1.5 trainers' batch-1 shapes at 512x384:
# level-0 self- and cross-attention, the self-attention of levels 1 and 2
ATTN_SD15_GRAD_SHAPES = [(1, 3072, 3072, 8, 40), (1, 3072, 77, 8, 40),
                         (1, 768, 768, 8, 80), (1, 192, 192, 8, 160)]


def sd15_edge_rows(gen: Gen) -> list:
    """``ATTN_SD15_EDGE_SHAPES`` against the plain version (a fused row is
    self-attention: Sk = Sq)."""
    return [attention_row(gen, B, Sq, Sk or Sq, H, D, fused=fused)
            for B, Sq, Sk, H, D, fused in ATTN_SD15_EDGE_SHAPES]


def check_attention(gen: Gen) -> dict:
    # (B, Sq, Sk, H, D): UNet self-attention at the three levels at batch
    # 2B = 8 and at the path's batch 4 (service batch 2 with CFG),
    # cross-attention (Sk = 77), the mid block (S = 48) and the VAE's
    # single-head mid block (D = 512); then the SD-1.5 UNet's shapes
    shapes = [(8, 3072, 3072, 5, 64), (4, 3072, 3072, 5, 64),
              (8, 768, 768, 10, 64), (4, 768, 768, 10, 64),
              (8, 192, 192, 20, 64), (4, 192, 192, 20, 64),
              (8, 3072, 77, 5, 64), (8, 48, 48, 20, 64),
              (4, 3072, 3072, 1, 512)] + ATTN_SD15_SHAPES
    rows = [attention_row(gen, *shape) for shape in shapes]
    rows += sd15_edge_rows(gen)
    # a head dim no configuration reaches raises on the card: nothing
    # falls back to the plain version or SDPA
    q = gen.normal(1, 128, 2, 96)
    try:
        flash_attention(q, q, q)
    except ValueError as e:
        log(f"K1 at D=96 raises on the card: {e}")
    else:
        raise AssertionError("flash_attention took D=96")
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
        "inner width (tensor parallelism at model 2), the SD-2 UNet's and "
        "the SD-1.5 UNet's four heads a rank")
    attn_shapes = ATTN_TP_SHAPES + ATTN_SD15_TP_SHAPES
    attn = [attention_row(gen, *shape) for shape in attn_shapes]
    ff = [geglu_row(gen, M, C, inner) for M, C, inner in GEGLU_TP_SHAPES]
    for name, rows in (("flash_attention", attn), ("geglu", ff)):
        entry = results.setdefault(name, {})
        entry["tp_shapes"] = rows
        entry["max_abs_err"] = max([entry.get("max_abs_err", 0.0)]
                                   + [r["err"] for r in rows])
    return {"flash_attention": [list(s) for s in attn_shapes],
            "geglu": [list(s) for s in GEGLU_TP_SHAPES]}


# phase 2's A/B of Upsample2D's two forms at the path's C >= 512 sites for
# 512x384 images (64x48 latents): the UNet's up path at 1280 channels from
# 8x6 and 16x12 at phase 4's CFG batch of 4, the VAE decoder at 512
# channels from 64x48 and 128x96 at batch 2 (B, C, H, W).  Each form is
# held to the plain form in fp32 on the same bf16 inputs at GEGLU_LIMIT:
# the phase form rounds its folded weights to bf16 before the products,
# as K4 rounds its intermediate; cuDNN's bf16 convolution itself lands
# about two half-ulps from fp32 at these outputs (|y| up to ~6)
UPSAMPLE_SITES = [("UNet up path", (4, 1280, 8, 6)),
                  ("UNet up path", (4, 1280, 16, 12)),
                  ("VAE decoder", (2, 512, 64, 48)),
                  ("VAE decoder", (2, 512, 128, 96))]
UPSAMPLE_LIMIT = GEGLU_LIMIT


def check_upsample(gen: Gen) -> list:
    """Phase 2's A/B rows: ``ops.upsample.nearest_up2_conv3x3`` (four
    phase convolutions at low resolution, folded once as a module would
    keep them, and folded in the call) against ``Upsample2D``'s
    interpolate then 3x3 convolution, at each of ``UPSAMPLE_SITES`` in
    bf16: device ms of each from a CUDA graph, the max abs difference
    between the two forms, and each form's from fp32 (the plain form in
    fp32 on the same bf16 inputs, TF32 off) against ``UPSAMPLE_LIMIT``.
    The routing stays as it is."""
    log("phase 2: Upsample2D's phase form against interpolate + conv (A/B; "
        "Upsample2D runs interpolate + conv)")
    rows = []
    for site, (B, C, H, W) in UPSAMPLE_SITES:
        x = gen.normal(B, C, H, W).contiguous(
            memory_format=torch.channels_last)
        weight = gen.normal(C, C, 3, 3, scale=(9 * C) ** -0.5)
        bias = gen.normal(C, scale=0.1)
        folded = phase_kernels(weight)

        def plain(x=x, weight=weight, bias=bias):
            up = F.interpolate(x, scale_factor=2.0, mode="nearest")
            return F.conv2d(up.contiguous(memory_format=torch.channels_last),
                            weight, bias, padding=1)

        phase = nearest_up2_conv3x3(x, weight, bias, folded=folded)
        conv = plain()
        ref = plain(x.float(), weight.float(), bias.float())
        r = {"site": site, "shape": [B, C, H, W],
             "diff": (phase.float() - conv.float()).abs().max().item(),
             "phase_err": (phase.float() - ref).abs().max().item(),
             "conv_err": (conv.float() - ref).abs().max().item(),
             "phase_device_ms": graph_ms(lambda: nearest_up2_conv3x3(
                 x, weight, bias, folded=folded)),
             "phase_fold_device_ms": graph_ms(lambda: nearest_up2_conv3x3(
                 x, weight, bias)),
             "conv_device_ms": graph_ms(plain)}
        log(f"phase 2 upsample {site} {tuple(x.shape)} -> "
            f"{tuple(phase.shape)}: phase form device "
            f"{r['phase_device_ms']:.4f} ms ({r['phase_fold_device_ms']:.4f} "
            f"folding in the call), interpolate + conv "
            f"{r['conv_device_ms']:.4f} ms; max abs difference of the forms "
            f"{r['diff']:.3e}; from fp32 (limit {UPSAMPLE_LIMIT}): phase "
            f"{r['phase_err']:.3e}, interpolate + conv {r['conv_err']:.3e}")
        if not max(r["phase_err"], r["conv_err"]) <= UPSAMPLE_LIMIT:
            raise AssertionError(f"an upsample form disagrees with fp32: "
                                 f"{r}")
        rows.append(r)
    return rows


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


def attention_grad_rows(gen: Gen, shapes) -> list:
    """K1's gradient rows at (B, Sq, Sk, H, D) ``shapes``, against SDPA's
    forward plus backward on the (B, H, S, D) views of the same inputs."""
    rows = []
    for B, Sq, Sk, H, D in shapes:
        q, k, v = (gen.normal(B, S, H, D) for S in (Sq, Sk, Sk))
        rows.append(grad_row(
            gen, f"B={B} Sq={Sq} Sk={Sk} H={H} D={D}", flash_attention,
            attention_ref,
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
            [q, k, v], [t.transpose(1, 2) for t in (q, k, v)]))
    return rows


def check_grad_rows(rows: dict) -> None:
    """Log each gradient row; raise on one outside ``GRAD_LIMIT``."""
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


def check_gradients(gen: Gen) -> dict:
    """Phase 2's gradient rows of every kernel, by kernel name."""
    rows = {"group_norm": [], "geglu": [], "layer_norm": []}
    # (B, Sq, Sk, H, D): the UNet's level-0 and level-1 self-attention,
    # its cross-attention, the VAE mid block (EMASC trains through it),
    # then the SD-1.5 UNet's eight heads of 40, 80 and 160
    rows["flash_attention"] = attention_grad_rows(
        gen, [(1, 3072, 3072, 5, 64), (1, 768, 768, 10, 64),
              (1, 3072, 77, 5, 64), (1, 3072, 3072, 1, 512)]
        + ATTN_SD15_GRAD_SHAPES)
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
    check_grad_rows(rows)
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


# torch.nn.init's functions that the layers' reset_parameters call
_INIT_FNS = ("uniform_", "normal_", "trunc_normal_", "constant_", "ones_",
             "zeros_", "xavier_uniform_", "xavier_normal_",
             "kaiming_uniform_", "kaiming_normal_")


@contextlib.contextmanager
def no_init():
    """Modules built inside skip their random initialisation, for a module
    whose every parameter and persistent buffer is loaded right after (a
    full-width UNet's initialisation takes about ten seconds of the host).
    It patches ``torch.nn.init`` for the whole process: nothing else may
    build a module meanwhile."""
    saved = {name: getattr(torch.nn.init, name) for name in _INIT_FNS}
    for name in _INIT_FNS:
        setattr(torch.nn.init, name, lambda tensor, *_, **__: tensor)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.nn.init, name, fn)


def cpu_copy(module: torch.nn.Module, factory) -> torch.nn.Module:
    """fp32 CPU twin with the card module's (bf16-rounded) weights."""
    with no_init():
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


def request(rng: np.random.Generator, n: int, h: int, w: int,
            ctx: int = 1024) -> dict:
    mask = np.zeros((n, h, w, 1), np.float32)
    mask[:, h // 8: h - h // 16, w // 6: w - w // 6] = 1.0
    f = np.float32
    return dict(
        image=rng.uniform(-1, 1, (n, h, w, 3)).astype(f),
        inpaint_mask=mask,
        pose_map=rng.uniform(0, 1, (n, h, w, 18)).astype(f),
        warped_cloth=rng.uniform(-1, 1, (n, h, w, 3)).astype(f),
        prompt_embeds=rng.standard_normal((n, 77, ctx)).astype(f),
        negative_prompt_embeds=rng.standard_normal((n, 77, ctx)).astype(f),
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


def check_raw_output(r: dict, n: int, h: int, w: int, what: str,
                     ctx: int = 1024) -> None:
    warped, embeds, negative, out = (r[k] for k in (
        "warped", "embeds", "negative", "out"))
    if not (warped.shape == (n, h, w, 3) and np.isfinite(warped).all()
            and warped.min() >= -1.0 and warped.max() <= 1.0
            and embeds.shape == negative.shape == (n, 77, ctx)
            and np.isfinite(embeds).all() and np.isfinite(negative).all()
            and out.shape == (n, h, w, 3) and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 1.0):
        raise AssertionError(f"{what}: bad output")


def serve_raw_requests(service: TryOnService, wrappers: dict, tokenizer,
                       towers: Conditioner) -> tuple:
    """Phase 5: ConditionService -> TryOnService at full width, around the
    conditioning ``towers``; returns the kernels' launches over the two
    requests, the conditioner, and the 2-image request (its inputs, seed
    and outputs) for phase 6."""
    h, w = service.height, service.width
    cond = ConditionService(towers, tokenizer, batch_size=service.batch_size,
                            num_vstar=NUM_VSTAR)
    rng = np.random.default_rng(1)
    c = cond.conditioner
    t0 = time.perf_counter()
    # the census over the capture of the conditioning's graph (its warm-up
    # run and the capture call each layer once): a replay calls no hook,
    # and the try-on replays phase 4's graphs (phase 4's census)
    with LayerNormCensus(c.vision, c.adapter, c.text_model) as ln_census:
        answer(cond, service, raw_request(rng, 2, h, w), seed=100)
    log(f"phase 5: warmup raw request (2 images) "
        f"{time.perf_counter() - t0:.3f} s, the capture of the "
        f"conditioning's graph "
        f"{sum(cond.program.capture_seconds.values()):.3f} s of it")
    check_layer_norm_census(
        ln_census, "the conditioning's capture (each call twice)")
    for wrapper in wrappers.values():
        wrapper.launches = 0
    for n in (1, 2):
        raw = raw_request(rng, n, h, w)
        torch.cuda.reset_peak_memory_stats()
        ln_before = layer_norm.launches
        gn_before = graphs.counts()
        r = answer(cond, service, raw, seed=100 + n)
        gn = {k: v - gn_before[k] for k, v in graphs.counts().items()}
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
            f"{gn['group_norm']}, K2 kernel launches "
            f"{gn['group_norm.cluster'] + 2 * gn['group_norm.split']}")
        check_raw_output(r, n, h, w, f"raw request of {n}")
        if not (r["ln_cond"] > ln_before
                and layer_norm.launches > r["ln_cond"]):
            raise AssertionError("K5 was not launched in both stages")
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
            f"{r['total']:.3f} s (the capture of the sampler's graphs "
            f"{sum(service.sampler.capture_seconds.values()):.3f} s of it), "
            f"peak device memory {peak / 2 ** 30:.2f} GiB "
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


# phase 7's JPEG and PNG checks: the committed fixtures
# (tools/make_jpeg_fixtures.py and tools/make_png_fixtures.py write them
# where PIL is installed, each beside PIL's pixels), the decodes timed per
# kind, and a VITON-HD item's loads timed
JPEG_FIXTURES = pathlib.Path(__file__).resolve().parent / "tests" / \
    "fixtures" / "jpeg"
PNG_FIXTURES = JPEG_FIXTURES.parent / "png"
# the keys of the lossless item beside JPEG_ITEM_KEYS: its parse map's
LOSSLESS_ITEM_KEYS = ("parse_array", "im_head", "shape")
JPEG_DECODE_REPS = 20
JPEG_ITEM_REPS = 5
JPEG_ITEM_KEYS = ("c_name", "im_name", "image", "cloth", "pose_map",
                  "inpaint_mask", "im_mask", "warped_cloth", "category")


def same_item(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        bitwise(a[k], b[k]) if isinstance(b[k], np.ndarray)
        else a[k] == b[k] for k in b)


def jpeg_path(work: pathlib.Path, smi: str) -> None:
    """Phase 7's JPEG and PNG readers, on the host: every committed JPEG
    fixture (lossless ones among them) decoded by the library this
    machine's compiler built, and every committed PNG fixture (interlaced,
    1, 4 and 16 bits), bitwise against PIL's pixels beside it; a lossless
    YCbCr JPEG refused as PIL refuses it; a VITON-HD item whose person
    and cloth are the progressive fixtures, and one whose person is the
    lossless fixture and label map the 4-bit palette fixture, read with
    no sidecar present, the latter bitwise equal to the item read from
    8-bit PNGs of the same pixels; the decode of a 1024x768 image's
    coefficients written baseline, progressive and arithmetic-coded
    (``tools/bench_jpeg_decode.py``), all three bitwise equal, timed; the
    decode of the same image as a lossless JPEG and as an interlaced PNG,
    each its pixels, timed; and a 1024x768 VITON-HD item's load with
    baseline, progressive and arithmetic person and cloth, timed, the
    items bitwise equal."""
    t0 = time.perf_counter()
    # loaded from its file, as it loads the tests' writer: sys.path stays
    spec = importlib.util.spec_from_file_location(
        "bench_jpeg_decode", REPO / "tools" / "bench_jpeg_decode.py")
    bench_jpeg_decode = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = bench_jpeg_decode
    spec.loader.exec_module(bench_jpeg_decode)
    manifest = json.loads((JPEG_FIXTURES / "fixtures.json").read_text())
    for kind, entry in manifest.items():
        got = imageio.open_image(JPEG_FIXTURES / f"{kind}.jpg")
        want = imageio.decode_png((JPEG_FIXTURES / f"{kind}.png").read_bytes())
        if got.mode != entry["mode"] or not np.array_equal(got.pixels,
                                                           want.pixels):
            raise AssertionError(f"JPEG fixture {kind} ({entry['what']}): "
                                 f"the port's decode is not PIL's pixels")
    log(f"phase 7 JPEG: {len(manifest)} committed fixtures decode bitwise "
        f"to PIL's pixels with {native.build()}: {', '.join(manifest)}")
    png_manifest = json.loads((PNG_FIXTURES / "fixtures.json").read_text())
    for kind, entry in png_manifest.items():
        got = imageio.open_image(PNG_FIXTURES / f"{kind}.png")
        want = np.load(PNG_FIXTURES / f"{kind}.npy")
        if (got.mode != entry["mode"] or got.pixels.dtype != want.dtype
                or not np.array_equal(got.pixels, want)):
            raise AssertionError(f"PNG fixture {kind} ({entry['what']}): "
                                 f"the port's decode is not PIL's array")
    log(f"phase 7 PNG: {len(png_manifest)} committed fixtures decode "
        f"bitwise to PIL's arrays and modes: {', '.join(png_manifest)}")

    root = synthetic.write_vitonhd(work / "jpeg_item" / "vitonhd",
                                   n_pairs=1, size=(128, 96), seed=72)
    for sub, kind in (("image", "progressive_person"),
                      ("cloth", "progressive_cloth")):
        shutil.copyfile(JPEG_FIXTURES / f"{kind}.jpg",
                        root / "test" / sub / "000000_00.jpg")
    if list(root.parent.rglob("*.jpg.png")):
        raise AssertionError("a sidecar in the progressive item's tree")
    item = VitonHDDataset(str(root), phase="test", size=(128, 96),
                          outputlist=JPEG_ITEM_KEYS)[0]
    for key, kind in (("image", "progressive_person"),
                      ("cloth", "progressive_cloth")):
        px = imageio.decode_png((JPEG_FIXTURES / f"{kind}.png").read_bytes())
        if not np.array_equal(item[key], dresscode_to_float(px)):
            raise AssertionError(f"the progressive item's {key} is not the "
                                 f"fixture's pixels")
    log("phase 7 JPEG: a VITON-HD item with the progressive person and "
        "cloth fixtures, no sidecar, read through VitonHDDataset, its image "
        "and cloth the fixtures' pixels")
    lossless_item(work, bench_jpeg_decode._writer("jpeg"))


    t_write = time.perf_counter()
    files = bench_jpeg_decode.timing_files()
    lossless = bench_jpeg_decode.lossless_file()
    interlaced = bench_jpeg_decode.interlaced_png()
    t_write = time.perf_counter() - t_write
    decoded = {kind: native.jpeg_decode(data) for kind, data in files.items()}
    if any(px is None or not np.array_equal(px, decoded["baseline"])
           for px in decoded.values()):
        raise AssertionError("the 1024x768 progressive or arithmetic decode "
                             "is not the baseline decode of the same "
                             "coefficients")
    for kind, data in files.items():
        t = bench_jpeg_decode.summary(bench_jpeg_decode.decode_ms(
            native.jpeg_decode, data, JPEG_DECODE_REPS))
        log(f"phase 7 JPEG decode 1024x768 q{bench_jpeg_decode.QUALITY} "
            f"4:2:0 {kind} ({len(data)} bytes): median "
            f"{t['median_ms']:.3f} ms, min {t['min_ms']:.3f}, max "
            f"{t['max_ms']:.3f} over {t['reps']} decodes, host clock "
            f"[{smi}]")
    source = bench_jpeg_decode.timing_image()
    for what, data, decode in (
            ("lossless JPEG (predictor 1, Adobe RGB)", lossless,
             native.jpeg_decode),
            ("Adam7-interlaced 8-bit RGB PNG", interlaced,
             lambda b: imageio.decode_png(b).pixels)):
        if not np.array_equal(decode(data), source):
            raise AssertionError(f"the 1024x768 {what} does not decode to "
                                 f"its pixels")
        t = bench_jpeg_decode.summary(bench_jpeg_decode.decode_ms(
            decode, data, JPEG_DECODE_REPS))
        log(f"phase 7 decode 1024x768 {what} ({len(data)} bytes): median "
            f"{t['median_ms']:.3f} ms, min {t['min_ms']:.3f}, max "
            f"{t['max_ms']:.3f} over {t['reps']} decodes, host clock "
            f"[{smi}]")

    root = synthetic.write_vitonhd(work / "jpeg_load" / "vitonhd",
                                   n_pairs=1, size=SOURCE_SIZE, seed=73)
    items = {}
    for kind, data in files.items():  # the person and the cloth alike
        for sub in ("image", "cloth"):
            (root / "test" / sub / "000000_00.jpg").write_bytes(data)
        ds = VitonHDDataset(str(root), phase="test", size=(512, 384),
                            outputlist=JPEG_ITEM_KEYS)
        items[kind] = ds[0]
        ms = []
        for _ in range(JPEG_ITEM_REPS):
            t_item = time.perf_counter()
            ds[0]
            ms.append((time.perf_counter() - t_item) * 1e3)
        t = bench_jpeg_decode.summary(ms)
        log(f"phase 7 JPEG: one VITON-HD item at 512x384 from {kind} "
            f"1024x768 person and cloth: median {t['median_ms']:.3f} ms, "
            f"min {t['min_ms']:.3f}, max {t['max_ms']:.3f} over "
            f"{t['reps']} loads, host clock [{smi}]")
    if not all(same_item(it, items["baseline"]) for it in items.values()):
        raise AssertionError("the VITON-HD items differ by the JPEGs' kind")
    log(f"phase 7 JPEG: the decoder's checks ({time.perf_counter() - t0:.1f}"
        f" s, {t_write:.1f} s of it writing the timing files)")


def lossless_item(work: pathlib.Path, jpeg_writer) -> None:
    """Phase 7: a VITON-HD item whose person is the lossless JPEG fixture
    and whose label map is the 4-bit palette PNG fixture, read through
    ``VitonHDDataset`` with no sidecar: its image and parse map are the
    fixtures' pixels, and every key equals the item read from the same
    pixels written as 8-bit PNGs.  A lossless YCbCr JPEG, which PIL
    refuses, raises: ``jpeg_writer`` (``tests/torch_port_jpeg.py``)
    writes it."""
    ycc = jpeg_writer.lossless(jpeg_writer.lossless_frame(
        np.zeros((8, 8, 3), np.uint8)))  # JFIF: YCbCr
    try:
        native.jpeg_decode(ycc)
    except ValueError as e:
        if "lossless frame in YCbCr" not in str(e):
            raise
    else:
        raise AssertionError("a lossless YCbCr JPEG decoded; PIL refuses "
                             "it")

    person = JPEG_FIXTURES / "lossless_person.jpg"
    label_map = PNG_FIXTURES / "palette_4bit_label_map.png"
    keys = JPEG_ITEM_KEYS + LOSSLESS_ITEM_KEYS
    items = {}
    for how in ("fixtures", "8-bit PNGs"):
        root = synthetic.write_vitonhd(work / "lossless_item" / how
                                       / "vitonhd", n_pairs=1,
                                       size=(128, 96), seed=74)
        image = root / "test" / "image" / "000000_00.jpg"
        parse = root / "test" / "image-parse-v3" / "000000_00.png"
        if how == "fixtures":
            shutil.copyfile(person, image)
            shutil.copyfile(label_map, parse)
        else:
            labels = imageio.open_image(label_map)
            imageio.write_png(image, imageio.open_image(person).pixels)
            imageio.write_png(parse, labels.pixels, "P", labels.palette)
        if list(root.parent.rglob("*.jpg.png")):
            raise AssertionError("a sidecar in the lossless item's tree")
        items[how] = VitonHDDataset(str(root), phase="test", size=(128, 96),
                                    outputlist=keys)[0]
    item = items["fixtures"]
    px = imageio.decode_png((JPEG_FIXTURES / "lossless_person.png")
                            .read_bytes())
    if not (np.array_equal(item["image"], dresscode_to_float(px))
            and np.array_equal(item["parse_array"], np.load(
                PNG_FIXTURES / "palette_4bit_label_map.npy"))):
        raise AssertionError("the lossless item's image or parse map is "
                             "not the fixtures' pixels")
    if not same_item(item, items["8-bit PNGs"]):
        raise AssertionError("the lossless item differs from the item of "
                             "the same pixels as 8-bit PNGs")
    log("phase 7 JPEG: a VITON-HD item with the lossless person and the "
        "4-bit palette label map fixtures, no sidecar, read through "
        "VitonHDDataset: its image and parse map the fixtures' pixels, "
        "every key equal to the item of 8-bit PNGs of the same pixels; a "
        "lossless YCbCr JPEG refused as PIL refuses it")


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
        with ProgramLog() as programs:
            stats = main_fn(argv)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t_main
        counts = main_counts(wrappers)
        log(f"phase 7 {label}: main {t_main:.3f} s wall with the weights' "
            f"load ({stats['images'] / t_main:.4f} images/s), its batch "
            f"loop {stats['seconds']:.3f} s ({stats['images']} images in "
            f"{stats['batches']} batches, {stats['images_per_second']:.4f} "
            f"images/s), loader {stats['loader_seconds_per_batch']:.3f} s "
            f"per batch, host clock; launches {counts}; programs captured "
            f"(seconds, host clock) {programs.seconds} [{smi}]")
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
    decoder), ``inference --compute_metrics`` (its images the PNG run's,
    its JSON equal to ``val_metrics``' over them) and
    ``compute_cloth_clip_features``
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
    check_jpeg_reads(jpeg_dir, png_dir)

    dresscode_run = main_runs(work, roots, out)[0]
    argv = [a.replace("inference_dresscode", "inference_metrics")
            for a in dresscode_run[2]] + ["--compute_metrics"]
    timed("inference --compute_metrics (DDIM-50, 2 images)",
          inference_cli.main, argv, smi)
    metrics_dir = out / "inference_metrics" / "paired"
    written = json.loads((metrics_dir / "metrics_paired_upper_body.json")
                         .read_text())
    # its folder holds the PNG run's images, byte for byte (the same argv
    # and seed), so val_metrics over it is the PNG run's m_png
    ours = sorted((metrics_dir / "upper_body").glob("*.png"))
    images_same = [p.name for p in ours] == [pathlib.Path(p).name
                                             for p in paths] and all(
        p.read_bytes() == (png_dir / "upper_body" / p.name).read_bytes()
        for p in ours)
    same = json.dumps(written, sort_keys=True) == json.dumps(
        m_png, sort_keys=True)
    log(f"phase 9: inference --compute_metrics wrote {written}; its images "
        f"byte for byte the PNG run's: {images_same}; equal to val_metrics "
        f"over the PNG run: {same}")
    if not (images_same and same):
        raise AssertionError("inference --compute_metrics and val_metrics "
                             "disagree over the same images")

    ln_before = layer_norm.launches
    with ProgramLog() as programs:
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
        f"called directly; K5 launches in the main {ln_clip}; programs "
        f"captured (seconds, host clock) {programs.seconds}")
    if ln_clip == 0:
        raise AssertionError("compute_cloth_clip_features launched no K5")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched in phase 9: {missing}")
    return launches


def log_nvcc(build_dir: pathlib.Path, source: str) -> None:
    """The compiler's report (``-Xptxas -v``: registers, spills, warnings)
    for one source, from the build's ``nvcc.log``."""
    text = (build_dir / "nvcc.log").read_text()
    part = [chunk for chunk in re.split(r"\n(?=\S*nvcc )", text)
            if source in chunk.splitlines()[0]]
    for line in (part[-1] if part else "").splitlines()[1:]:
        if "bytes stack" in line or "Used" in line or "warning" in line \
                or "entry function" in line:
            log(f"nvcc {source}: {line.strip()}")


# the SD-1.5 rows the sweep times (B, Sq, Sk, H, D)
K1_SWEEP_SHAPES = [(4, 3072, 3072, 8, 40), (4, 3072, 77, 8, 40),
                   (4, 768, 768, 8, 80), (4, 768, 77, 8, 80),
                   (4, 192, 192, 8, 160), (4, 192, 77, 8, 160),
                   (4, 48, 48, 8, 160), (4, 768, 768, 4, 80)]


def k1_tilings(D: int) -> list:
    """(block_q, block_k) of every D = 40, 80, 160 kernel compiled: the
    BQ-row items against 128-row tiles, 128-row items against 80-row
    tiles, the split form."""
    return [(192 if D == 40 else 128, 128), (128, 80),
            (64, 64 if D == 160 else 128)]


def k1_launch(fn, q, k, v, out, block_q: int, block_k: int) -> None:
    """``ladi_flash_attention_fwd`` with the given tiling (the wrapper's
    call with another plan)."""
    B, Sq, H, D = q.shape
    strides = []
    for t in (q, k, v, out):
        sb, ss, sh, _ = t.stride()
        strides += [sb, sh, ss]
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, Sq, k.shape[1], D, *strides, D ** -0.5, block_q,
                    block_k, _build.stream_ptr(q)), "flash_attention")


def sweep_k1(gen_seed: int) -> None:
    """``--sweep-k1``: K1's device time at ``K1_SWEEP_SHAPES`` under every
    tiling the source compiles (``k1_tilings``, the plan's marked; a CUDA
    graph of 20 calls), each output against the plain version within
    ``ATTN_LIMIT``, beside SDPA's.  The measurement behind
    ``flash_plan``; ``tools/sweep_k1_measures.py`` times the softmax's
    measures."""
    built = _build.library()
    gen = Gen(gen_seed)
    for B, Sq, Sk, H, D in K1_SWEEP_SHAPES:
        q, k, v = (gen.normal(B, S, H, D) for S in (Sq, Sk, Sk))
        ref = attention_ref(q.float(), k.float(), v.float())
        plan = flash_plan(D, Sq, Sk, B * H, _build.sm_count(q.device))
        out = torch.empty_like(q)
        cells = []
        for block_q, block_k in k1_tilings(D):
            def call(block_q=block_q, block_k=block_k):
                k1_launch(built.ladi_flash_attention_fwd, q, k, v, out,
                          block_q, block_k)

            call()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not err <= ATTN_LIMIT:
                raise AssertionError(f"K1 {block_q}x{block_k} disagrees: "
                                     f"{err}")
            mark = "*" if (block_q, block_k) == (plan.block_q,
                                                 plan.block_k) else ""
            cells.append(f"{block_q}x{block_k}{mark} "
                         f"{graph_ms(call, 20):.4f} ms")
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                        20)
        log(f"sweep-k1 B={B} Sq={Sq} Sk={Sk} H={H} D={D}: tilings (block_q "
            f"x block_k, * the plan's) " + ", ".join(cells)
            + f"; SDPA {sdpa:.4f} ms")


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
    with no_init():
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
    del cpu, unet, card
    torch.cuda.empty_cache()


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
    """Wraps ``pipelines.graphs.TrainProgram.__call__`` while open and
    counts each program's steps (``updates``).  After every step it reads
    the trained parameters' gradients (on the card the graph's own, which
    each replay writes): every one present and finite.  Around each
    program's first replayed step (a call of a signature it has captured;
    eagerly, its first step) it also holds the parameters before and
    after it: every parameter whose gradient is not exactly zero moved
    (``zero_grads`` counts those that are).  ``unchecked`` lists the
    programs that never reached such a step."""

    def __init__(self):
        self.updates = 0
        self.zero_grads = 0
        self.programs = {}

    def __enter__(self):
        original = self.original = graphs.TrainProgram.__call__
        watch = self

        def call(program, *args):
            opt = program.optimizer
            checked = watch.programs.setdefault(id(program), [program,
                                                              False])
            check = not checked[1] and (
                not program.graphed
                or graphs._signature(args) in program.sets)
            # host copies: the watch adds nothing to the peak device memory
            before = ([p.detach().to("cpu", copy=True) for p in opt.params]
                      if check else None)
            out = original(program, *args)
            watch.updates += 1
            grads = [p.grad for p in opt.params]
            if any(g is None for g in grads) or not bool(torch.stack(
                    [torch.isfinite(g).all() for g in grads]).all()):
                bad = sum(g is None or not bool(torch.isfinite(g).all())
                          for g in grads)
                raise AssertionError(f"step {watch.updates}: {bad} of "
                                     f"{len(grads)} trained parameters "
                                     f"without a finite gradient")
            if check:
                checked[1] = True
                zero = [bool(not g.any()) for g in grads]
                still = sum(torch.equal(b, p.detach().cpu()) and not z
                            for b, p, z in zip(before, opt.params, zero))
                watch.zero_grads += sum(zero)
                if still:
                    raise AssertionError(f"{still} of {len(before)} "
                                         f"parameters did not move")
            return out

        graphs.TrainProgram.__call__ = call
        return self

    def __exit__(self, *exc):
        graphs.TrainProgram.__call__ = self.original

    @property
    def unchecked(self) -> list:
        return [program_name(p) for p, done in self.programs.values()
                if not done]


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
          "--exp_name", "warp", "-b", "1", "-j", "2", "--epochs_tps", "1",
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
        with GradientWatch() as watch, contextlib.ExitStack() as stack, \
                ProgramLog() as programs:
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
            f"{watch.updates} update(s) of {len(watch.programs)} train "
            f"program(s), every gradient finite, each first replayed step "
            f"moving its parameters "
            f"({watch.zero_grads} parameter(s) with an exactly zero "
            f"gradient), losses {losses}{per_step}, "
            f"peak device memory {peak:.2f} GiB, launches {counts}, "
            f"{({k: round(v / max(len(lines), 1), 1) for k, v in counts.items()})} "
            f"a logged step; validation programs captured (seconds, host "
            f"clock) {programs.seconds} [{smi}]")
        if not all(np.isfinite(losses)) or not watch.updates:
            raise AssertionError(f"{label}: no finite training")
        if watch.unchecked:
            raise AssertionError(f"{label}: no replayed step of "
                                 f"{watch.unchecked} to check")
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
# phase 11a's and 11b's steps a run: the first eager, then captured; the
# others replays
DIST_STEPS = 3
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


def run_steps(step, batch: dict, draws: dict, wrappers: dict,
              eager: bool = False, first=None) -> dict:
    """``DIST_STEPS`` calls of a train program on the same rows (through
    ``run_eager`` where ``eager``), ``first()`` after the first: each
    step's loss, seconds (host clock, synchronised) and launches."""
    call = step.run_eager if eager else step
    out = {"losses": [], "seconds": [], "launches": []}
    for i in range(DIST_STEPS):
        reset_counts(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["losses"].append(call(batch, draws)["loss"])
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["launches"].append(main_counts(wrappers))
        if i == 0 and first is not None:
            first()
    return out


def graphed_run(step, batch: dict, draws: dict, wrappers: dict,
                first=None) -> dict:
    """``run_steps`` of a graphed program: with how it ran (graphed,
    staged, ``eager_reason``), its warm-up's and capture's seconds and
    its graphs' pool."""
    r = run_steps(step, batch, draws, wrappers, first=first)
    (captured,) = step.sets.values()
    r.update(graphed=step.graphed, staged=step.seams is not None,
             eager_reason=step.eager_reason,
             warmup_s=captured.warmup_seconds,
             capture_s=captured.capture_seconds,
             pool_gib=pool_gib(captured.pool))
    return r


def release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def reset_unet(towers: dict, start: dict) -> dict:
    """``towers`` with the UNet's parameters back at ``start`` (its host
    copy) and no gradients: the seeded state, without building the towers
    again."""
    unet = towers["unet"]
    unet.load_state_dict(start)
    for p in unet.parameters():
        p.grad = None
    return towers


def same_losses(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# phase 11a's check of each signature's gradient mean: the data-parallel
# step of the dry run's tiny towers over global batches of these rows
# (shapes A, B, A: two rows a rank, one, two), graphed and through
# run_eager; the third replays A's capture after B's.  At full width a second signature's pool holds
# another 3.46 GB of gradients a rank, which 11a's stage (58.6 GiB of
# peaks beside 11b and the tensor-parallel trainer) cannot spare; two
# ranks of its own run it last in ``ServedLane``, beside phase 10
SIGNATURE_ROWS = (4, 2, 4)


def signature_steps(mesh, dev) -> dict:
    """The data-parallel step's ``SIGNATURE_ROWS`` steps graphed (the
    third replays the first shape's capture after the second shape's)
    and through ``run_eager``, from the same seeded towers: whether the
    losses and the UNet are bitwise the same, and the same with a planted
    revert (``.grad`` left where the last capture pointed it, so the
    first shape's replay averages the second's gradients)."""
    from ladi_vton_tpu_torch.core.mesh import shard_batch
    from ladi_vton_tpu_torch.parallel import dryrun

    def run(kind: str) -> dict:
        unet, adapter, vae, text = dryrun._towers(dev, BF16)
        step = dryrun._step_fn(mesh, unet, adapter, vae, text, dev, BF16)[2]
        call = step.run_eager if kind == "eager" else step
        losses = []
        for i, n in enumerate(SIGNATURE_ROWS):
            batch = dryrun._batch(n, dev)
            losses.append(call(shard_batch(mesh, batch),
                               dryrun._draws(mesh, batch, i, dev))["loss"])
        return {"losses": losses, "unet": host_params(unet),
                "signatures": len(step.sets)}

    eager, graphed = run("eager"), run("graphed")
    with planted(graphs, "_point_grads", lambda params, grads: None):
        stale = run("graphed")
    return {"signatures": graphed["signatures"],
            "bitwise": same_losses(graphed["losses"], eager["losses"])
            and same_params(graphed["unet"], eager["unet"]),
            "stale_bitwise": same_losses(stale["losses"], eager["losses"])
            and same_params(stale["unet"], eager["unet"])}


def signature_rank() -> dict:
    """``signature_steps`` on each of two ranks at data 2."""
    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh

    dev = rank_setup()
    with bitwise_training():
        return signature_steps(make_mesh(MeshSpec()), dev)


def signature_job(out: pathlib.Path, smi: str) -> None:
    """Phase 11a's second batch shape: ``signature_rank`` on two ranks,
    each checked."""
    results, seconds = ranks("signature_rank", 2, (), "signatures", out)
    for i, r in enumerate(results):
        check_signatures(i, r, smi)
    log(f"phase 11a's second batch shape: two ranks in {seconds:.1f} s "
        f"wall")


def dp_rank(work: str) -> dict:
    """Phase 11a on each of two ranks (one row of the global batch a
    rank), under ``bitwise_training``: for each form, data-parallel then
    ZeRO-1, ``DIST_STEPS`` steps of the program (``graphed_run``: the
    first the real step, then the capture of its two stages; the others
    replays), then the same steps through ``run_eager`` from the same
    state.  The first step's loss and the cosine of its reduced gradient
    by part against the one process's; whether each form's losses and
    parameters are bitwise its eager run's, and ZeRO-1's the unsharded
    ones; the AdamW elements held; each step's seconds and launches, the
    peak and the graphs' pool (``DP_FORM_DONE`` touched once the
    data-parallel form has ended); then a planted fault, the first step
    with the gradient ``all_reduce`` left out (the staged program's
    stages run eagerly, as its first call runs them, without the
    capture), and its cosines.  The fault's step takes the ZeRO-1
    optimizer, whose peak (12.95 GiB a rank, not the unsharded 17.4) is
    what the tensor-parallel trainer's stage allows for beside it; the
    gradients it leaves do not depend on the optimizer."""
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
    towers = dist_towers(dev)
    start = host_params(towers["unet"])
    out = {}

    def first() -> None:
        out["cosine"] = cosines(unet_grads(towers["unet"]), ref)


    with bitwise_training():
        for zero in (False, True):
            release()
            torch.cuda.reset_peak_memory_stats()
            opt, step = dist_step(reset_unet(towers, start), inputs, dev,
                                  mesh, zero)
            r = graphed_run(step, batch, draws, wrappers,
                            None if zero else first)
            r.update(peak_gib=peak_gib(), adam_numel=opt.local_state_numel())
            params = host_params(towers["unet"])
            del opt, step
            release()
            torch.cuda.reset_peak_memory_stats()
            step = dist_step(reset_unet(towers, start), inputs, dev, mesh,
                             zero)[1]
            eager = run_steps(step, batch, draws, wrappers, eager=True)
            r.update(eager_seconds=eager["seconds"],
                     eager_launches=eager["launches"],
                     eager_peak_gib=peak_gib(),
                     bitwise_eager=same_losses(r["losses"], eager["losses"])
                     and same_params(params, host_params(towers["unet"])))
            del step
            if zero:
                out["zero1_bitwise"] = (
                    same_params(updated, params)
                    and same_losses(out["dp"]["losses"], r["losses"]))
            else:
                updated = params
                release()
                (work / f"{DP_FORM_DONE}.{mesh.data_index}").touch()
            out["zero1" if zero else "dp"] = r
        del updated, params
        release()
        step = dist_step(reset_unet(towers, start), inputs, dev, mesh,
                         zero=True)[1]
        with planted(steps_mod, "reduce_gradients",
                     lambda params, mesh: None):
            step.run_eager(batch, draws)
        out["fault_cosine"] = cosines(unet_grads(towers["unet"]), ref)
    for tag in ("dp", "zero1"):
        out[tag]["losses"] = [float(x) for x in out[tag]["losses"]]
    return out


def nccl_rank(work: str) -> dict:
    """Phase 11b on one rank over NCCL, under ``bitwise_training``:
    ``DIST_STEPS`` graphed steps without a mesh, then as many of the
    staged program over the NCCL group of one rank (its ``all_reduce``
    and the metrics' mean run) from the same state, then, its graphs
    dropped, as many of that program's stages run eagerly over the same
    group; whether the two graphed runs' losses and updated UNets are
    bitwise equal, each run's step seconds, warm-up and capture seconds,
    peak memory and the graphs' pool."""
    import torch.distributed as dist

    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh

    dev = rank_setup()
    inputs = torch.load(pathlib.Path(work) / "inputs.pt", weights_only=True)
    batch = on_card(inputs["batch"], dev)
    draws = on_card(inputs["draws"], dev)
    wrappers = {name: fn for name, fn, _, _, _ in KERNELS}
    towers = dist_towers(dev)
    start = host_params(towers["unet"])
    runs, params = {}, {}
    with bitwise_training():
        for label, mesh in (("single", None), ("nccl", make_mesh(MeshSpec()))):
            torch.cuda.reset_peak_memory_stats()
            step = dist_step(reset_unet(towers, start), inputs, dev, mesh)[1]
            r = graphed_run(step, batch, draws, wrappers)
            r["peak_gib"] = peak_gib()
            params[label] = host_params(towers["unet"])
            if mesh is not None:
                step.sets.clear()
                release()
                r["eager_seconds"] = run_steps(step, batch, draws, wrappers,
                                               eager=True)["seconds"]
            del step
            release()
            runs[label] = r
    bitwise = (same_params(params["single"], params["nccl"])
               and same_losses(runs["single"]["losses"],
                               runs["nccl"]["losses"]))
    for r in runs.values():
        r["losses"] = [float(x) for x in r["losses"]]
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "runs": runs, "bitwise": bitwise}


# phase 11c's two UNets: name -> (factory, seed, context width); the
# eight-head SD-1.5 UNet splits every attention into four heads a rank
TP_UNETS = {"sd2": (lambda: UNet2DCondition(sd2_unet_config(31)),
                    DIST_SEEDS["unet"], 1024),
            "sd15": (lambda: UNet2DCondition(sd15_unet_config(31)),
                     30, 768)}  # phase 15's seed


def tp_inputs(ctx_width: int) -> tuple:
    """Phase 11c's UNet forward inputs, bf16 on the host: latents, steps
    and a text context ``ctx_width`` wide."""
    B, lh, lw = TP_FORWARD
    g = torch.Generator().manual_seed(113)
    x = torch.randn((B, 31, lh, lw), generator=g).to(BF16)
    ctx = torch.randn((B, 77, ctx_width), generator=g).to(BF16)
    return x, torch.tensor([981, 500, 250, 1]), ctx


def tp_twins() -> dict:
    """Phase 11c's fp32 reference UNets, in this process: each bf16 UNet
    the ranks seed (``TP_UNETS``), its weights in an fp32 CPU twin."""
    twins = {}
    for name, (factory, seed, _) in TP_UNETS.items():
        unet = seeded(factory, seed, "cuda", BF16)
        twins[name] = cpu_copy(unet, factory)
        del unet
    torch.cuda.empty_cache()
    return twins


def tp_reference(twins: dict, work: pathlib.Path) -> None:
    """Each twin's forward on ``tp_inputs``, on the host, written under
    ``work`` for phase 11c's ranks."""
    for name, twin in twins.items():
        t0 = time.perf_counter()
        x, t, ctx = tp_inputs(TP_UNETS[name][2])
        with torch.no_grad():
            torch.save(twin(x.float(), t, ctx.float()),
                       work / f"tp_fp32_{name}.pt")
        log(f"phase 11c: the {name} fp32 CPU twin's forward (batch "
            f"{TP_FORWARD[0]}, {TP_FORWARD[1]}x{TP_FORWARD[2]} latents) in "
            f"{time.perf_counter() - t0:.1f} s")


def tp_forward(name: str, mesh, dev, work: pathlib.Path) -> dict:
    """One of ``TP_UNETS`` at full width on this rank (bf16, batch 4,
    64x48 latents): its forward unsharded and tensor parallel, with the K1
    and K4 calls of the parallel one counted and their shapes recorded,
    each against the fp32 CPU forward; the parallel one with its partial
    sums left unreduced (a planted fault).  The UNet is freed after."""
    from ladi_vton_tpu_torch.parallel import tp

    factory, seed, ctx_width = TP_UNETS[name]
    x, t, ctx = (v.to(dev) for v in tp_inputs(ctx_width))
    unet = seeded(factory, seed, dev, BF16)
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
    wrappers = {k: fn for k, fn, _, _, _ in KERNELS}
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
    fp32 = torch.load(work / f"tp_fp32_{name}.pt", weights_only=True)
    q = unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1.to_q
    out = {"forward_rel_l2": rel_l2(sharded.float(), full.float()),
           "full_vs_fp32": rel_l2(full.float(), fp32),
           "tp_vs_fp32": rel_l2(sharded.float(), fp32),
           "fault_rel_l2": rel_l2(unreduced.float(), full.float()),
           "fault_vs_fp32": rel_l2(unreduced.float(), fp32),
           "forward_launches": launches,
           "shapes": {k: sorted(v) for k, v in shapes.items()},
           "to_q": tuple(q.weight.shape)}
    del full, sharded, unreduced
    torch.cuda.empty_cache()
    out["pieces"] = tp_step_pieces(name, unet, dev)
    del unet
    torch.cuda.empty_cache()
    return out


# phase 11c's tensor-parallel denoise step as pieces: a DDIM-50 step at
# 512x384 and batch 2 (the UNet at batch 4 under CFG 7.5), captured once
# (its warm-up eager), then replayed over fresh inputs; the planted fault
# skips the all_reduce of cut TP_STEP_SKIP in one replay
TP_STEP = (2, 64, 48)  # batch, latent height and width
TP_STEP_REPLAYS = 3
TP_STEP_SKIP = 5


def tp_step_inputs(plan, g: torch.Generator, ctx_width: int) -> tuple:
    """Fresh inputs of one denoise step (``SamplerPlan.step``'s
    arguments) on the card, the same on every rank of ``g``'s seed: the
    loop's latents and state, a step index and its timestep, the CFG
    inputs of a prepared batch."""
    B, lh, lw = TP_STEP
    dev = plan.device

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    prepared = {"latents": randn(B, 4, lh, lw),
                "mask_lat": (randn(B, 1, lh, lw) > 0).float(),
                "masked_latents": randn(B, 4, lh, lw),
                "pose_lat": randn(B, 18, lh, lw).clamp(0, 1),
                "cloth_latents": randn(B, 4, lh, lw)}
    latents, state, inputs = plan.pipe.loop_inputs(
        prepared, prompt_embeds=randn(B, 77, ctx_width).to(BF16),
        negative_prompt_embeds=randn(B, 77, ctx_width).to(BF16),
        guidance_scale=plan.guidance_scale)
    i = int(torch.randint(len(plan.timesteps), (), generator=g,
                          device=dev))
    return latents, state, plan.steps[i].clone(), plan.timesteps[i].clone(), \
        inputs


@contextlib.contextmanager
def all_reduces(calls: list, skip: int = -1):
    """``torch.distributed.all_reduce`` recording each call's tensor
    shape in ``calls``; call number ``skip`` (from 0) is not run."""
    real = torch.distributed.all_reduce

    def call(t, *args, **kw):
        calls.append(tuple(t.shape))
        if len(calls) - 1 != skip:
            return real(t, *args, **kw)

    torch.distributed.all_reduce = call
    try:
        yield
    finally:
        torch.distributed.all_reduce = real


def tp_step_pieces(name: str, unet, dev) -> dict:
    """Phase 11c's check of the tensor-parallel denoise step as pieces
    (``pipelines.graphs.Graph`` through a ``Program`` of
    ``SamplerPlan.step``), on this rank's tensor-parallel ``unet``: the
    eager step on ``TP_STEP_REPLAYS + 1`` fresh inputs (its
    ``all_reduce``s recorded, its launches counted, timed), then the
    program's first call (the capture, timed) and a replay on each of the
    others, each bitwise the eager step, each with the eager step's
    launches and ``all_reduce``s; last, one replay with the all_reduce of
    cut ``TP_STEP_SKIP`` skipped (a planted fault)."""
    wrappers = {k: fn for k, fn, _, _, _ in KERNELS}
    plan = graphs.SamplerPlan(
        TryOnPipeline(unet=unet, vae=None, scheduler=make_scheduler("ddim")),
        split=True, denoise_mode="host", num_inference_steps=50,
        guidance_scale=7.5)
    g = torch.Generator(dev).manual_seed(117)
    xs = [tp_step_inputs(plan, g, TP_UNETS[name][2])
          for _ in range(TP_STEP_REPLAYS + 1)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"eager_s": [], "replay_s": [], "replay_calls": [],
           "replay_launches": [], "bitwise": []}
    try:
        eager = []
        for i, x in enumerate(xs):
            calls: list = []
            reset_counts(wrappers)
            with all_reduces(calls), torch.no_grad():
                result, seconds = synced(lambda: plan.step(*x))
            eager.append(result)
            out["eager_s"].append(seconds)
            if i == 0:
                out.update(eager_calls=calls,
                           eager_launches=main_counts(wrappers))
        program = graphs.Program(plan.step, device=dev)
        first = program(*xs[0])
        (key,) = program.sets
        graph = program.sets[key].graph
        out.update(capture_s=program.capture_seconds[key],
                   pieces=len(graph.pieces),
                   cut_shapes=[tuple(t.shape) for t, _ in graph.cuts],
                   bitwise=[same_tree(first, eager[0])])
        for x, ref in zip(xs[1:], eager[1:]):
            calls = []
            reset_counts(wrappers)
            with all_reduces(calls):
                result, seconds = synced(lambda: program(*x))
            out["replay_s"].append(seconds)
            out["replay_calls"].append(calls)
            out["replay_launches"].append(main_counts(wrappers))
            out["bitwise"].append(same_tree(result, ref))
        with all_reduces([], skip=TP_STEP_SKIP):
            skipped = program(*xs[1])
        out["skipped_bitwise"] = same_tree(skipped, eager[1])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del program, graph, eager, first, result, skipped
    torch.cuda.empty_cache()
    return out


def synced(fn) -> tuple:
    """(``fn()``, its host seconds between two synchronisations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_tree(a, b) -> bool:
    """Two outputs of the step (tensor trees) bit for bit."""
    xs, ys = graphs._leaves(a), graphs._leaves(b)
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


def tp_rank(work: str) -> dict:
    """Phase 11c on each of two ranks at data 1 x model 2: ``tp_forward``
    of the SD-2 UNet, then of the eight-head SD-1.5 UNet (under
    ``"sd15"``); then one tensor-parallel VTO step (fp32 parameters) on
    the global batch, its loss and its gradient gathered to the reference
    layout."""
    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh
    from ladi_vton_tpu_torch.parallel import tp

    dev = rank_setup(deterministic=False)
    work = pathlib.Path(work)
    mesh = make_mesh(MeshSpec(data=1, model=2))
    out = tp_forward("sd2", mesh, dev, work)
    out["sd15"] = tp_forward("sd15", mesh, dev, work)

    wrappers = {name: fn for name, fn, _, _, _ in KERNELS}
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
               step_launches=main_counts(wrappers),
               eager_reason=step.eager_reason)
    grads = tp.gather_unet_state(towers["unet"], mesh,
                                 unet_grads(towers["unet"]))
    out["cosine"] = cosines(grads, torch.load(
        work / "reference.pt", weights_only=True)["grads"])
    return out


def run_main(module: str, argv: list) -> dict:
    """A CLI main on a rank (phase 11d), with cuDNN deterministic as in
    phase 11's other ranks; its result, kernel launches and peak memory."""
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
    served = ServedLane(work, roots, single / "paired", smi).start()
    return distributed_path(work, train_roots, tokenizer, checked, served,
                            smi)


# what phase 11d's trainers must log about their step
TRAIN_STEP_LOG = {"zero1": "graphed on cuda:0: two graphs a batch shape",
                  "tp": "runs eagerly on cuda:0: a mesh of 1 x 2 ranks"}


def step_log_line(path: pathlib.Path) -> str:
    """A rank's line on how its train step runs (``TrainProgram``), or
    "" where it logged none."""
    for line in path.read_text(errors="replace").splitlines():
        if "the train step " in line:
            return line.split(" - ")[-1]
    return ""


def staged_only(work: pathlib.Path, smi: str) -> None:
    """``--staged-only``: phase 11a's one-process reference, then 11a and
    11b."""
    t0 = time.perf_counter()
    tokenizer = synthetic_tokenizer(work / "tokenizer")
    out = work / "dist"
    out.mkdir()
    ref = dist_reference(out, tokenizer)
    launches = dp_steps(out, ref, {}, smi)
    add_launches(launches, nccl_step(out, smi))
    log(f"phases 11a and 11b: launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")


def tp_pieces_rank() -> dict:
    """``--tp-pieces-only`` on each of two ranks at data 1 x model 2:
    ``tp_step_pieces`` of each of ``TP_UNETS``, seeded as
    ``tp_forward`` seeds them; then ``signature_steps`` at data 2."""
    from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh
    from ladi_vton_tpu_torch.parallel import tp

    dev = rank_setup(deterministic=False)
    mesh = make_mesh(MeshSpec(data=1, model=2))
    out = {}
    for name, (factory, seed, _) in TP_UNETS.items():
        unet = tp.unet_tp(seeded(factory, seed, dev, BF16), mesh)
        out[name] = tp_step_pieces(name, unet, dev)
        del unet
        torch.cuda.empty_cache()
    with bitwise_training():
        out["signatures"] = signature_steps(make_mesh(MeshSpec()), dev)
    return out


def tp_pieces_only(work: pathlib.Path, smi: str) -> None:
    """``--tp-pieces-only``: phase 11c's denoise steps as pieces and the
    second batch shape of phase 11a's tiny towers, alone."""
    results, seconds = ranks("tp_pieces_rank", 2, (), "tp_pieces", work)
    for i, r in enumerate(results):
        for name in TP_UNETS:
            check_tp_pieces(i, name, r[name], smi)
        check_signatures(i, r["signatures"], smi)
    log(f"phase 11c's pieces and 11a's second batch shape: two ranks in "
        f"{seconds:.1f} s wall")


def dist_mains(work: pathlib.Path, train_roots: dict, out: pathlib.Path,
               smi: str, which: str) -> tuple:
    """Phase 11d's trainer runs, two ranks with torchrun's variables; (the
    launches summed over the ranks, each rank's peak GiB).  ``which``
    "zero1": ``cli.train_vto --shard_optimizer_states``, two steps (the
    first the real step and the capture of its two stages, the second a
    replay), its consolidated checkpoint written at the end (phase 11
    holds each rank's peak, the checkpoint included, below phase 11a's
    unsharded step's); "tp": ``cli.train_vto --tensor_parallel 2``, one
    step, eager, its gathered ``unet_1.pth`` loaded through the zoo.
    Each rank's log must say how its step ran: graphed in two stages, or
    eagerly and why (``TRAIN_STEP_LOG``)."""
    sd2 = work / "sd2"
    vto = ["--dataset", "vitonhd", "--vitonhd_dataroot",
           str(train_roots["vitonhd"]), "--sd2_model_dir", str(sd2),
           "--train_batch_size", str(DIST_BATCH), "--test_batch_size", "1",
           "--num_workers", "2", "--num_workers_test", "2",
           "--lr_warmup_steps", "0",
           "--report_to", "none", "--test_order", "paired", "--seed", "9",
           "--device", "cuda", "--dist_backend", "gloo",
           "--height", str(TRAIN_SIZE[0]), "--width", str(TRAIN_SIZE[1]),
           "--clip_vision_dir", str(work / "clip_vision"),
           "--inversion_adapter_dir", str(work / "ladi"),
           "--tokenizer_dir", str(sd2 / "tokenizer")]
    runs = out / "mains"
    target = runs / which
    if which == "zero1":
        label, flags, n = ("train_vto --shard_optimizer_states",
                           ["--shard_optimizer_states"], 2)
    else:
        label, flags, n = ("train_vto --tensor_parallel 2",
                           ["--tensor_parallel", "2"], 1)
    argv = vto + flags + ["--max_train_steps", str(n),
                          "--checkpointing_steps", str(n),
                          "--output_dir", str(target)]
    results, seconds = ranks("run_main", 2,
                             ("ladi_vton_tpu_torch.cli.train_vto", argv),
                             label, runs)
    said = [step_log_line(runs / label.replace(" ", "_") / f"rank{i}.err")
            for i in range(2)]
    launches = {name: 0 for name, _, _, _, _ in KERNELS}
    for r in results:
        add_launches(launches, r["launches"])
    lines = metric_lines(target / "metrics.jsonl")
    log(f"phase 11d {label}: {seconds:.1f} s wall for two ranks on one "
        f"card, step {[r['result'] for r in results]}, losses "
        f"{[x['loss'] for x in lines]}, step seconds "
        f"{[round(1 / x['steps_per_sec'], 3) for x in lines]} (host "
        f"clock, each with its batch's loading), peak device memory over "
        f"the run, its checkpoint included, "
        f"{[round(r['peak_gib'], 2) for r in results]} GiB a rank, "
        f"launches {[r['launches'] for r in results]}; each rank's log: "
        f"{said} [{smi}]")
    if any(r["result"] != n for r in results):
        raise AssertionError(f"{label}: the ranks ended at "
                             f"{[r['result'] for r in results]}")
    expected = TRAIN_STEP_LOG[which]
    if not all(line and expected in line for line in said):
        raise AssertionError(f"{label}: a rank's log does not say "
                             f"{expected!r}: {said}")
    if which == "tp":
        unet = zoo.extended_unet(checkpoint=str(target / "unet_1.pth"),
                                 device="cuda", dtype=BF16)
        q = unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1.to_q
        log(f"phase 11d: the tensor-parallel run's gathered unet_1.pth "
            f"loads through the zoo (to_q {tuple(q.weight.shape)}, "
            f"{sum(p.numel() for p in unet.parameters())} parameters)")
        del unet
        torch.cuda.empty_cache()
    shutil.rmtree(target)
    return launches, [r["peak_gib"] for r in results]


def dist_inference(work: pathlib.Path, roots: dict,
                   single_inference: pathlib.Path, out: pathlib.Path,
                   smi: str) -> dict:
    """Phase 11d's ``cli.inference`` as two ranks over phase 7's VITON-HD
    split, against the one process's images (``single_inference``); the
    launches summed over the ranks."""
    runs = out / "mains"
    two = runs / "inference"
    results, seconds = ranks("run_main", 2, (
        "ladi_vton_tpu_torch.cli.inference",
        inference_argv(work, roots, two) + ["--dist_backend", "gloo"]),
        "inference", runs)
    launches = {name: 0 for name, _, _, _, _ in KERNELS}
    for r in results:
        add_launches(launches, r["launches"])
    ours, ref, diff = mean_abs_png(two / "paired", single_inference)
    log(f"phase 11d inference over two ranks (data 2, batch 2, DDIM-50): "
        f"{seconds:.1f} s wall, {[r['result']['images'] for r in results]} "
        f"images, {len(ours)} files; mean absolute difference from the one "
        f"process's images {diff:.3e} (limit {DIST_IMAGE_LIMIT}); peak "
        f"device memory {[round(r['peak_gib'], 2) for r in results]} GiB a "
        f"rank; launches {[r['launches'] for r in results]} [{smi}]")
    if ours != ref or not len(ours) or not diff <= DIST_IMAGE_LIMIT:
        raise AssertionError("the two-rank inference differs from the one "
                             "process's")
    return launches


# phase 11f: cli.serve over two ranks sharing the card over gloo, at data 2
# and at --tensor_parallel 2, from phase 6's files, answering phase 8's
# 2-image raw request at batch 2; each answer against the one-process
# answer of the same flags (the services cli.serve builds, called in this
# process: phase 8 holds the two bitwise equal) by phase 11d's inference
# limit, a mean absolute error of DIST_IMAGE_LIMIT
SERVE_DIST_BATCH = 2
# DDIM steps of its requests: the tensor-parallel sampler's collectives
# go through the host under gloo, about a second a CFG step, beside
# phase 11's other ranks on the same host
SERVE_DIST_STEPS = 10
SERVE_DIST_KERNELS = ("flash_attention", "group_norm", "geglu", "layer_norm")


class LogLines(logging.Handler):
    """The messages logged to it, in ``lines``."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list = []

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())


def serve_rank(argv: list) -> dict:
    """Phase 11f on one rank: ``cli.serve``'s main in the ranks' process
    group (rank 0 serves until SIGINT, the other rank follows it); the
    kernels' launches and the peak memory over the rank's run, and what
    ``pipelines.graphs`` logged (how the sampler was captured)."""
    wrappers = {name: fn for name, fn, _, _, _ in KERNELS}
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    logger = logging.getLogger(graphs.__name__)
    lines = LogLines()
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    try:
        serve_cli.main(argv)
    finally:
        logger.removeHandler(lines)
    torch.cuda.synchronize()
    return {"launches": main_counts(wrappers), "peak_gib": peak_gib(),
            "graph_log": lines.lines}


def serve_dist_argv(work: pathlib.Path, *flags: str) -> list:
    return ["--dataset", "vitonhd", "--checkpoint_dir", str(work / "ladi"),
            "--sd2_model_dir", str(work / "sd2"), "--enable_condition",
            "--clip_vision_dir", str(work / "clip_vision"),
            "--batch_size", str(SERVE_DIST_BATCH), "--seed", str(SERVE_SEED),
            "--num_inference_steps", str(SERVE_DIST_STEPS),
            "--guidance_scale", "7.5",
            "--max_delay_ms", "5", "--no_warmup", "--port", "0",
            "--device", "cuda", *flags]


def serve_reference(work: pathlib.Path, raw: dict, smi: str) -> dict:
    """The one-process answer to ``raw``: request 0 of the services
    ``cli.serve`` builds from the same flags, called in this process under
    cli.serve's cuDNN setting (TF32 allowed, PyTorch's default)."""
    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        service, cond = serve_cli.build_services(
            serve_cli.parse_args(serve_dist_argv(work)),
            torch.device("cuda"))
        ref = direct_raw(cond, service, raw)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del service, cond
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11f: the one-process answer to the raw request, "
        f"{time.perf_counter() - t0:.1f} s with the weights' load (the "
        f"request {ref['total']:.3f} s) [{smi}]")
    return ref


def served_url(started) -> str:
    """Rank 0's address once it serves; raises where a rank failed first
    or the start outlasts ``SERVE_START_TIMEOUT_S``."""
    deadline = time.perf_counter() + SERVE_START_TIMEOUT_S
    while time.perf_counter() < deadline and started.failure() is None:
        for line in started.output(0).splitlines():
            if line.startswith("serving try-on on "):
                return line.split()[3]
        time.sleep(0.1)
    raise AssertionError(
        f"cli.serve's rank 0 did not serve ({started.failure()}): "
        f"{(started.logs / 'rank0.err').read_text()[-4000:]}")


def serve_over_ranks(work: pathlib.Path, out: pathlib.Path, raw: dict,
                     ref: dict, label: str, smi: str) -> dict:
    """Phase 11f at one layout (``label`` "data 2" or "model 2"):
    ``cli.serve`` as two ranks sharing the card over gloo (DDIM-10, CFG
    7.5, 512x384, batch 2), answering phase 8's 2-image raw request over
    HTTP: the image within a mean absolute error of ``DIST_IMAGE_LIMIT``
    of ``ref``, the one-process answer of the same flags, and at data 2
    the same answer with the follower's rows replaced by rank 0's (a
    planted fault: what a missing gather would serve) outside it; every
    kernel of ``SERVE_DIST_KERNELS`` launched on each rank; SIGINT to
    rank 0 ending both ranks with exit 0.  Returns the launches summed
    over the ranks."""
    flags = [] if label == "data 2" else ["--tensor_parallel", "2"]
    argv = serve_dist_argv(work, "--dist_backend", "gloo", *flags)
    t0 = time.perf_counter()
    with spawn("chip_smoke:serve_rank", 2, (argv,), timeout=DIST_TIMEOUT_S,
               log_dir=out / "serve" / label.replace(" ", "_"),
               wait=False) as started:
        url = served_url(started)
        t_up = time.perf_counter() - t0
        start_line = next(line for line in started.output(0).splitlines()
                          if line.startswith("serving try-on on "))
        answer = client_raw(TryOnClient(url, timeout_s=SERVE_TIMEOUT_S), raw)
        t1 = time.perf_counter()
        started.procs[0].send_signal(signal.SIGINT)
        results = started.results()  # raises unless every rank exits 0
        codes = [p.returncode for p in started.procs]
        t_exit = time.perf_counter() - t1
    err = float(np.abs(answer["out"] - ref["out"]).mean())
    cond_err = max(float(np.abs(a - b).max())
                   for a, b in zip(answer["cond"], ref["cond"]))
    fault = ""
    if label == "data 2":
        per = SERVE_DIST_BATCH // 2  # rank 0's rows, then rank 1's
        planted = answer["out"].copy()
        planted[per:2 * per] = answer["out"][:per]
        fault_err = float(np.abs(planted - ref["out"]).mean())
        fault = (f"; planted fault, the follower's rows replaced by rank "
                 f"0's: {fault_err:.3e}")
    launches = {name: 0 for name, _, _, _, _ in KERNELS}
    for r in results:
        add_launches(launches, r["launches"])
    # at model 2 each rank's sampler captures its step in pieces, and
    # logs how many; at data 2 it is one graph a stage, and logs nothing
    pieces = [[line for line in r["graph_log"] if "the step as " in line]
              for r in results]
    log(f"phase 11f at {label}: rank 0's start line {start_line!r}; the "
        f"sampler's capture by rank {pieces}")
    kind = ("its denoise step in pieces" if label == "model 2"
            else "CUDA-graphed sampler)")
    if kind not in start_line or any(bool(p) != (label == "model 2")
                                     for p in pieces):
        raise AssertionError(f"phase 11f: the {label} ranks do not sample "
                             f"as the graphed sampler of their mesh")
    log(f"phase 11f cli.serve over two ranks at {label} (batch "
        f"{SERVE_DIST_BATCH}, DDIM-{SERVE_DIST_STEPS}, CFG 7.5): up in "
        f"{t_up:.1f} s; "
        f"the raw request of 2 images over HTTP (/condition "
        f"{answer['t_cond']:.3f} s, with /tryon {answer['total']:.3f} s) "
        f"against one process ({ref['total']:.3f} s direct): mean "
        f"absolute error {err:.3e} (limit {DIST_IMAGE_LIMIT}){fault}; "
        f"conditioning max abs {cond_err:.3e}; SIGINT -> exits {codes} "
        f"in {t_exit:.2f} s; peak device memory "
        f"{[round(r['peak_gib'], 2) for r in results]} GiB a rank; launches "
        f"by rank {[r['launches'] for r in results]} [{smi}]")
    if not err <= DIST_IMAGE_LIMIT:
        raise AssertionError(f"phase 11f: {label} serves another answer "
                             f"than one process")
    if label == "data 2" and fault_err <= DIST_IMAGE_LIMIT:
        raise AssertionError("phase 11f: the limit does not tell a "
                             "missing gather")
    missing = [(i, name) for i, r in enumerate(results)
               for name in SERVE_DIST_KERNELS if not r["launches"][name]]
    if missing:
        raise AssertionError(f"phase 11f: kernels never launched on a "
                             f"rank: {missing}")
    return launches


# the card this process leaves to ServedLane's ranks while they run beside
# it: their largest peak (11d's inference, 5.5 GiB a rank) twice and a
# margin for the ranks' CUDA contexts
SERVED_ROOM_GIB = 16.0


class ServedLane:
    """Phase 11's 11d inference, 11e, 11f and 11a's second batch shape
    (``signature_job``), one after another in a thread: ranks alone
    (this process only reads their files and answers), which hold at
    most 11 GiB of the card and write little, so they run beside phase
    10's mains.  ``start`` first takes 11f's
    one-process answer in this process, so it is called where no launch
    count is open, then caps this process's caching allocator to leave
    ``SERVED_ROOM_GIB`` free (the cache would grow to fill the card: the
    allocator frees cached blocks at the cap instead); ``result`` waits
    for the lane, lifts the cap and gives the ranks' launches."""

    def __init__(self, work: pathlib.Path, roots: dict,
                 single_inference: pathlib.Path, smi: str):
        self.work, self.roots, self.smi = work, roots, smi
        self.single_inference = single_inference
        self.out = work / "dist"
        self.pool = ThreadPoolExecutor(1)
        self.future = None

    def start(self) -> "ServedLane":
        self.out.mkdir()
        raw = raw_request(np.random.default_rng(80), 2, 512, 384)
        ref = serve_reference(self.work, raw, self.smi)
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        torch.cuda.set_per_process_memory_fraction(
            (total - SERVED_ROOM_GIB) / total)
        log("phase 11: 11d's inference, 11e and 11f start, ranks beside "
            "this process")
        self.future = self.pool.submit(self._run, raw, ref)
        return self

    def _run(self, raw: dict, ref: dict) -> dict:
        work, out, smi = self.work, self.out, self.smi
        total = {name: 0 for name, _, _, _, _ in KERNELS}
        for job in (lambda: dist_inference(work, self.roots,
                                           self.single_inference, out, smi),
                    lambda: dist_dryrun(out),
                    lambda: serve_over_ranks(work, out, raw, ref, "data 2",
                                             smi),
                    lambda: serve_over_ranks(work, out, raw, ref, "model 2",
                                             smi),
                    lambda: signature_job(out, smi) or {}):
            add_launches(total, job())
        return total

    def result(self) -> dict:
        try:
            return self.future.result()
        finally:
            self.pool.shutdown()
            torch.cuda.set_per_process_memory_fraction(1.0)


# phase 11's stages after phase 10, the jobs of each at once on the card:
# each stage's peaks (phase 11's logs, allocated, summed over the jobs'
# ranks) stay within the 58.4 GiB that 11c and the ZeRO-1 trainer held
# when they first shared the card; 11a beside the ZeRO-1 trainer (62.8
# GiB) ran it out of memory.  The two trainers, each writing a 10.5 GB
# checkpoint, run in different stages.  In the first, the tensor-parallel
# trainer starts once 11a's ranks have ended their data-parallel form
# (``DP_FORM_DONE``) and 11b has ended: beside 11a's ZeRO-1 form and its
# planted fault, 12.95 GiB a rank, its 16.36 GiB a rank sum to 58.6 GiB.
# (The fault's step once took the unsharded optimizer, 17.4 GiB a rank,
# and met the trainer's step: the card ran out of memory.)
DIST_STAGES = (("dp", "nccl", "tp_main"), ("zero1", "tp"))
# 11a's ranks each touch ``<out>/dp_form_done.<rank>`` once their
# data-parallel form has ended and released the card
DP_FORM_DONE = "dp_form_done"


def distributed_path(work: pathlib.Path, train_roots: dict, tokenizer,
                     checked: dict, served: ServedLane, smi: str) -> dict:
    """Phase 11: the data-parallel, ZeRO-1, NCCL and tensor-parallel steps
    and the trainers over ranks, with the files of phases 6 and 10 under
    ``work``, after ``served`` (started before, see ``ServedLane``);
    every check of the comment above.  Returns the kernels' launches
    summed over every rank of the phase.

    The one-process reference comes first, in this process, then
    ``DIST_STAGES``; 11c's job runs the fp32 twins' forwards on the host
    before its ranks."""
    t_phase = time.perf_counter()
    out = served.out
    total = served.result()  # its ranks leave the card to the stages
    log(f"phase 11: this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card "
        f"before 11a's reference; two ranks share the one card over gloo "
        f"(NCCL refuses two ranks on one device) and one rank runs over "
        f"NCCL, without gradient checkpointing; stages {DIST_STAGES}")
    ref = dist_reference(out, tokenizer)
    twins = tp_twins()
    peaks = {}

    def trainer(which: str):
        def job() -> dict:
            launches, peaks[which] = dist_mains(work, train_roots, out, smi,
                                                which)
            return launches
        return job

    def tp_job() -> dict:
        tp_reference(twins, out)  # the fp32 twins' forwards, for the ranks
        return tp_steps(out, ref, checked, smi)

    def after_dp_form() -> dict:
        """The tensor-parallel trainer, once 11a's ranks have ended their
        data-parallel form and 11b has ended."""
        marks = [out / f"{DP_FORM_DONE}.{i}" for i in range(2)]
        while not all(m.exists() for m in marks):
            if futures["dp"].done():
                futures["dp"].result()  # raises where 11a failed
                break
            time.sleep(1.0)
        futures["nccl"].result()
        log("phase 11d: the tensor-parallel trainer starts beside 11a's "
            "ZeRO-1 form")
        return trainer("tp")()

    jobs = {"dp": lambda: dp_steps(out, ref, peaks, smi),
            "nccl": lambda: nccl_step(out, smi), "tp": tp_job,
            "zero1": trainer("zero1"), "tp_main": after_dp_form}
    with ThreadPoolExecutor(max(map(len, DIST_STAGES))) as pool:
        for stage in DIST_STAGES:
            futures = {}
            for name in stage:
                futures[name] = pool.submit(jobs[name])
            for f in futures.values():
                add_launches(total, f.result() or {})
    if any(p >= peaks["dp"] for p in peaks["zero1"]):
        raise AssertionError(f"phase 11d: a ZeRO-1 rank's peak "
                             f"{peaks['zero1']} GiB is not below the "
                             f"unsharded step's {peaks['dp']:.2f} GiB")
    log(f"phase 11d: the ZeRO-1 ranks' peaks "
        f"{[round(p, 2) for p in peaks['zero1']]} GiB, checkpoint included, "
        f"below the unsharded step's {peaks['dp']:.2f} GiB")
    missing = [name for name, n in total.items() if not n]
    if missing:
        raise AssertionError(f"kernels never launched in phase 11: {missing}")
    log(f"phase 11: distribution after phase 10 "
        f"({time.perf_counter() - t_phase:.1f} s)")
    return total


def rounded(xs: list, digits: int = 3) -> list:
    return [round(x, digits) for x in xs]


def replay_mean(seconds: list) -> float:
    """The mean of a run's steps after the first (its warm-up and
    capture)."""
    return float(np.mean(seconds[1:]))


def dp_steps(out: pathlib.Path, ref: dict, peaks: dict, smi: str) -> dict:
    """Phase 11a over two ranks against this process's step (``ref``);
    the unsharded step's peak under ``peaks["dp"]``; the launches of the
    ranks' steps."""
    results, seconds = ranks("dp_rank", 2, (str(out),), "dp", out)
    total = {name: 0 for name, _, _, _, _ in KERNELS}
    for i, r in enumerate(results):
        for tag in ("dp", "zero1"):
            f = r[tag]
            for counts in f["launches"] + f["eager_launches"]:
                add_launches(total, counts)
            log(f"phase 11a rank {i}, {tag}: {DIST_STEPS} steps graphed "
                f"{rounded(f['seconds'])} s (the first the real step, "
                f"{f['warmup_s']:.3f} s, and the capture of its two "
                f"stages, {f['capture_s']:.3f} s; replays "
                f"{replay_mean(f['seconds']):.3f} s), through run_eager "
                f"{rounded(f['eager_seconds'])} s; losses "
                f"{[round(x, 6) for x in f['losses']]}, losses and "
                f"parameters bitwise the eager run's: {f['bitwise_eager']}; "
                f"peak device memory graphed {f['peak_gib']:.2f} GiB (the "
                f"graphs' pool {f['pool_gib']:.2f} GiB, gradients "
                f"included), eager {f['eager_peak_gib']:.2f} GiB; AdamW "
                f"elements {f['adam_numel']}; launches of a replay "
                f"{f['launches'][-1]}; staged {f['staged']}, graphed "
                f"{f['graphed']} [{smi}]")
        log(f"phase 11a rank {i}: first loss {r['dp']['losses'][0]:.6f} "
            f"against {ref['loss']:.6f}, gradient cosine by part "
            f"{({k: round(v, 6) for k, v in r['cosine'].items()})}; "
            f"ZeRO-1's losses and updates bitwise the unsharded ones: "
            f"{r['zero1_bitwise']}; planted fault, no gradient all_reduce: "
            f"cosine by part "
            f"{({k: round(v, 6) for k, v in r['fault_cosine'].items()})} "
            f"(limit {DIST_GRAD_COS}) [{smi}]")
        rel = abs(r["dp"]["losses"][0] - ref["loss"]) / abs(ref["loss"])
        half = r["zero1"]["adam_numel"] / r["dp"]["adam_numel"]
        if not (rel <= DIST_LOSS_LIMIT and r["zero1_bitwise"]
                and min(r["cosine"].values()) >= DIST_GRAD_COS
                and 0.3 < half < 0.7):
            raise AssertionError(f"phase 11a: rank {i} disagrees (loss "
                                 f"{rel:.3e} relative, ZeRO state share "
                                 f"{half:.3f})")
        if min(r["fault_cosine"].values()) >= DIST_GRAD_COS:
            raise AssertionError("phase 11a: the gradient limit does not "
                                 "tell a step without its all_reduce")

        for tag in ("dp", "zero1"):
            f = r[tag]
            if not (f["graphed"] and f["staged"]
                    and f["eager_reason"] is None):
                raise AssertionError(f"phase 11a: rank {i}'s {tag} step is "
                                     f"not graphed in two stages "
                                     f"({f['eager_reason']})")
            if not f["bitwise_eager"]:
                raise AssertionError(f"phase 11a: rank {i}'s graphed {tag} "
                                     f"steps differ from their eager run")
            launches = f["launches"] + f["eager_launches"]
            if any(x != launches[0] for x in launches):
                raise AssertionError(f"phase 11a: rank {i}'s {tag} steps "
                                     f"launch other kernels graphed and "
                                     f"eager: {launches}")
    peaks["dp"] = max(r["dp"]["peak_gib"] for r in results)
    log(f"phase 11a: two ranks in {seconds:.1f} s wall")
    return total


def nccl_step(out: pathlib.Path, smi: str) -> dict:
    """Phase 11b: one rank over NCCL, its staged step's graphs bitwise
    the step without a process group; the launches of its steps."""
    (r,), seconds = ranks("nccl_rank", 1, (str(out),), "nccl", out,
                          backend="nccl")
    total = {name: 0 for name, _, _, _, _ in KERNELS}
    single, nccl = r["runs"]["single"], r["runs"]["nccl"]
    for f in (single, nccl):
        for counts in f["launches"]:
            add_launches(total, counts)
    log(f"phase 11b: one rank over {r['backend']} (world {r['world']}), "
        f"batch {DIST_BATCH}, {DIST_STEPS} steps each: without a process "
        f"group graphed {rounded(single['seconds'], 4)} s (replays "
        f"{replay_mean(single['seconds']):.4f} s; warm-up "
        f"{single['warmup_s']:.3f}, capture {single['capture_s']:.3f} s; "
        f"peak {single['peak_gib']:.2f} GiB, pool {single['pool_gib']:.2f} "
        f"GiB); over the group in two stages "
        f"{rounded(nccl['seconds'], 4)} s (replays "
        f"{replay_mean(nccl['seconds']):.4f} s; warm-up "
        f"{nccl['warmup_s']:.3f}, capture {nccl['capture_s']:.3f} s; peak "
        f"{nccl['peak_gib']:.2f} GiB, pool {nccl['pool_gib']:.2f} GiB), "
        f"its stages run eagerly {rounded(nccl['eager_seconds'], 4)} s "
        f"(after the first {replay_mean(nccl['eager_seconds']):.4f} s); "
        f"losses {[round(x, 6) for x in nccl['losses']]}, the two graphed "
        f"runs bitwise equal: {r['bitwise']}; staged {nccl['staged']}, "
        f"graphed {nccl['graphed']} ({seconds:.1f} s wall) [{smi}]")
    if r["backend"] != "nccl" or not r["bitwise"]:
        raise AssertionError("phase 11b: the NCCL step differs")
    if not (nccl["graphed"] and nccl["staged"] and single["graphed"]
            and not single["staged"]):
        raise AssertionError("phase 11b: the steps did not run as graphs")
    return total


def tp_steps(out: pathlib.Path, ref: dict, checked: dict, smi: str) -> dict:
    """Phase 11c (the tensor-parallel forwards and step over two ranks),
    against phase 11a's one-process ``ref`` and the fp32 twins' forwards
    (written before this is called); ``checked``: the tensor-parallel
    shapes phase 2 checked.  Returns the launches of the ranks."""
    results, seconds = ranks("tp_rank", 2, (str(out),), "tp", out)
    total = {name: 0 for name, _, _, _, _ in KERNELS}
    for i, r in enumerate(results):
        for name, f in (("sd2", r), ("sd15", r["sd15"])):
            check_tp_forward(i, name, f, checked, smi)
            check_tp_pieces(i, name, f["pieces"], smi)
            add_launches(total, f["forward_launches"])
        add_launches(total, r["step_launches"])
        rel = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        log(f"phase 11c rank {i}: the tensor-parallel step "
            f"{r['step_seconds']:.3f} s (with its warm-up), loss "
            f"{r['loss']:.6f} ({rel:.3e} relative, limit "
            f"{DIST_LOSS_LIMIT}), gathered gradient cosine by part "
            f"{({k: round(v, 6) for k, v in r['cosine'].items()})}, peak "
            f"{r['peak_gib']:.2f} GiB, launches {r['step_launches']}; run "
            f"eagerly: {r['eager_reason']} [{smi}]")
        if not (rel <= DIST_LOSS_LIMIT
                and min(r["cosine"].values()) >= DIST_GRAD_COS):
            raise AssertionError(f"phase 11c: rank {i}'s step disagrees")
        if not r["eager_reason"]:
            raise AssertionError(f"phase 11c: rank {i}'s tensor-parallel "
                                 f"step did not run eagerly")
    log(f"phase 11c: two ranks in {seconds:.1f} s wall")
    return total


def check_signatures(i: int, sig: dict, smi: str) -> None:
    """Rank ``i``'s ``signature_steps``: each form over two batch shapes
    bitwise its eager run, the planted revert not."""
    log(f"phase 11a's second batch shape, rank {i}: the dry run's tiny "
        f"towers over global batches of {SIGNATURE_ROWS} rows, graphed "
        f"against run_eager: {sig} [{smi}]")
    if not (sig["signatures"] == 2 and sig["bitwise"]):
        raise AssertionError(f"phase 11a: rank {i}'s steps over two batch "
                             f"shapes differ from their eager run")
    if sig["stale_bitwise"]:
        raise AssertionError("phase 11a: a reduce of the last capture's "
                             "gradients goes unseen")


def check_tp_pieces(i: int, name: str, r: dict, smi: str) -> None:
    """Rank ``i``'s denoise step of one of ``TP_UNETS`` as pieces
    (``tp_step_pieces``): one cut at each ``all_reduce`` of the eager
    step, on a buffer of its shape; every replay bitwise the eager step,
    with its launches and its ``all_reduce``s; the planted skipped cut
    outside that equality."""
    cuts = len(r["eager_calls"])
    replays = sum(r["replay_s"]) / len(r["replay_s"])
    eager = sum(r["eager_s"][1:]) / len(r["eager_s"][1:])
    log(f"phase 11c rank {i}: the {name} tensor-parallel denoise step "
        f"(DDIM-50, batch {TP_STEP[0]}, {TP_STEP[1] * 8}x{TP_STEP[2] * 8}, "
        f"CFG 7.5) as {r['pieces']} graphs with {len(r['cut_shapes'])} "
        f"cuts ({cuts} all_reduces over the model axis an eager step), "
        f"captured in {r['capture_s']:.3f} s with its warm-up; a replay "
        f"{replays:.4f} s against an eager step {eager:.4f} s (means of "
        f"{len(r['replay_s'])}; eager {rounded(r['eager_s'], 4)}, replays "
        f"{rounded(r['replay_s'], 4)}); bitwise the eager step "
        f"{r['bitwise']}; launches a replay {r['replay_launches'][0]}, an "
        f"eager step {r['eager_launches']}; planted fault, cut "
        f"{TP_STEP_SKIP}'s all_reduce skipped: bitwise "
        f"{r['skipped_bitwise']} [{smi}]")
    if not (cuts and r["cut_shapes"] == r["eager_calls"]
            and r["pieces"] == cuts + 1):
        raise AssertionError(f"phase 11c: rank {i}'s {name} step is not "
                             f"cut at each all_reduce of the eager step")
    if not (all(r["bitwise"]) and len(r["bitwise"]) == TP_STEP_REPLAYS + 1
            and all(c == r["eager_calls"] for c in r["replay_calls"])
            and all(n == r["eager_launches"]
                    for n in r["replay_launches"])):
        raise AssertionError(f"phase 11c: rank {i}'s {name} pieces are not "
                             f"the eager step")
    if r["skipped_bitwise"]:
        raise AssertionError("phase 11c: a skipped cut leaves the step "
                             "unchanged")


def check_tp_forward(i: int, name: str, r: dict, checked: dict,
                     smi: str) -> None:
    """Rank ``i``'s tensor-parallel forward of one of ``TP_UNETS``: within
    ``TP_FORWARD_LIMIT`` of the unsharded one (SD-2) or of the fp32 CPU
    forward (SD-1.5), its planted fault outside that limit, K1 and K4
    launched at shapes phase 2 checked."""
    missing = {k: [s for s in r["shapes"][k] if list(s) not in checked[k]]
               for k in r["shapes"]}
    log(f"phase 11c rank {i}: the {name} tensor-parallel UNet forward "
        f"(batch {TP_FORWARD[0]}, {TP_FORWARD[1]}x{TP_FORWARD[2]} latents, "
        f"bf16) against the unsharded one: relative L2 "
        f"{r['forward_rel_l2']:.3e} (limit {TP_FORWARD_LIMIT}); against "
        f"the fp32 CPU forward, the unsharded {r['full_vs_fp32']:.3e} and "
        f"the tensor-parallel {r['tp_vs_fp32']:.3e}; planted fault, the "
        f"partial sums unreduced: {r['fault_rel_l2']:.3e} from the "
        f"unsharded, {r['fault_vs_fp32']:.3e} from the fp32; its launches "
        f"{r['forward_launches']}, K1 at {r['shapes']['flash_attention']}, "
        f"K4 at {r['shapes']['geglu']}; to_q {r['to_q']} [{smi}]")
    if any(missing.values()):
        raise AssertionError(f"phase 2 does not check the {name} shard "
                             f"shapes {missing}")
    if name == "sd15" and not (
            r["shapes"]["flash_attention"]
            and all(s[3] == 4 for s in r["shapes"]["flash_attention"])):
        raise AssertionError("phase 11c: the eight-head UNet's K1 calls are "
                             "not on four heads a rank")
    # the SD-2 forward is held to the unsharded one, the eight-head one to
    # the fp32 CPU forward (every comparison is logged above)
    err, fault = ((r["forward_rel_l2"], r["fault_rel_l2"]) if name == "sd2"
                  else (r["tp_vs_fp32"], r["fault_vs_fp32"]))
    if not (err <= TP_FORWARD_LIMIT
            and r["forward_launches"]["flash_attention"]
            and r["forward_launches"]["geglu"]):
        raise AssertionError(f"phase 11c: rank {i}'s {name} forward "
                             f"disagrees")
    if fault <= TP_FORWARD_LIMIT:
        raise AssertionError(f"phase 11c: the {name} forward's limit does "
                             f"not tell unreduced partial sums")


def dist_dryrun(out: pathlib.Path) -> dict:
    """Phase 11e: ``dryrun_multichip(2)`` on the card, its
    tensor-parallel step launching K1, K2, K4 and K5 on each rank; the
    launches summed over its ranks and phases."""
    from ladi_vton_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    results = dryrun_multichip(2, "cuda", timeout=DIST_TIMEOUT_S,
                               log_dir=out / "dryrun")
    total = {name: 0 for name, _, _, _, _ in KERNELS}
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


# phase 12: the sampler as CUDA graphs (``TryOnPipeline.jit_sample``),
# at phase 4's full width (31-channel SD-2 UNet, SD-2 VAE, EMASC, bf16;
# 512x384, CFG 7.5).  Each group (scheduler, steps, batch,
# cloth_cond_rate) makes two requests A and B with their own inputs and
# generators, samples both eagerly, then through each of its modes
# ((split, denoise mode)); each graphed image must equal the eager one
# bit for bit
GRAPH_MODES = ((False, "scan"), (True, "scan"), (True, "host"))
GRAPH_GROUPS = (
    ("ddim", 20, 2, 1.0, GRAPH_MODES),
    # batch 8 in the callers' mode only (every mode is checked at batch
    # 2), every group at 20 steps or 10: the check is the graphs' bits,
    # which the loop's length does not change (phase 15 graphs a DDIM-50
    # request at batch 2)
    ("ddim", 10, 8, 1.0, ((True, "host"),)),
    ("dpm", 10, 2, 1.0, ((True, "host"),)),
    ("pndm", 10, 2, 1.0, ((True, "host"),)),
    ("lms", 10, 2, 1.0, ((True, "host"),)),
    # the cloth gate closes at step 5 of 10, inside the loop
    ("ddim", 10, 2, 0.5, ((True, "host"),)),
)
# the case profiled and planted with a stale replay: the callers' sampler
# (``parallel.sharding.make_sampler``)
PROFILED = ("ddim", 2, True, "host")
REQUEST_KEYS = ("image", "inpaint_mask", "pose_map", "warped_cloth",
                "prompt_embeds", "negative_prompt_embeds")
SAMPLE_KEYS = ("image", "mask_image", "pose_map", "warped_cloth",
               "prompt_embeds", "negative_prompt_embeds")
OUR_KERNELS = {"K1": ("flash_fwd",), "K2": ("gn_cluster", "gn_split"),
               "K4": ("geglu_",), "K5": ("ln_kernel",)}


class FixedGatePipeline(TryOnPipeline):
    """Phase 12's planted fault: the cloth gate evaluated once, as a
    Python bool, when the step is captured (its step input then holds 0:
    the gate stays open at every replay), not as a ``torch.where`` on the
    step index."""

    def denoise_one_step(self, latents, state, step_i, t, *,
                         cloth_gate_from: float, **inputs):
        closed = 0 >= cloth_gate_from
        return super().denoise_one_step(
            latents, state, step_i, t, **inputs,
            cloth_gate_from=-float("inf") if closed else float("inf"))


def mode_label(split: bool, mode: str) -> str:
    return f"split=True {mode}" if split else "split=False"


def graph_request(rng: np.random.Generator, n: int,
                  ctx: int = 1024) -> list:
    r = request(rng, n, 512, 384, ctx)
    return [torch.from_numpy(r[k]).cuda() for k in REQUEST_KEYS]


def eager_request(spipe: TryOnPipeline, x: list, seed: int,
                  kw: dict) -> torch.Tensor:
    return spipe.sample(**dict(zip(SAMPLE_KEYS, x)), **kw,
                        generator=torch.Generator("cuda").manual_seed(seed))


def run_timed(fn) -> tuple:
    """(result, host seconds after a synchronise, peak GiB allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


# host seconds the profiler stays open before and after the profiled
# call: the trace keeps only the device events that lie inside its start
# and stop on the host clock, and without the margin it lost the first or
# last split-form GroupNorm launches of a request (VAE encode, VAE
# decode); at 0.1 s an eager request's trace still lost 7 of its 74 once
PROFILE_MARGIN_S = 0.5


def profiled_request(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its host wall seconds,
    device kernel milliseconds, the busy share, the kernels it ran and
    those of K1, K2, K4 and K5 by their names."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = sum(e.self_device_time_total for e in events) / 1e3
    ours = {k: sum(e.count for e in events if any(
        n in e.key for n in names)) for k, names in OUR_KERNELS.items()}
    by_name = {e.key[:60]: e.count for e in events if any(
        n in e.key for names in OUR_KERNELS.values() for n in names)}
    return {"wall_s": wall, "device_ms": ms, "busy": ms / (wall * 1e3),
            "kernels": sum(e.count for e in events), "ours": ours,
            "by_name": by_name}


def launches_of(fn) -> dict:
    """The wrappers' counters' rise over one call of ``fn``."""
    before = graphs.counts()
    fn()
    torch.cuda.synchronize()
    after = graphs.counts()
    return {k: after[k] - before[k] for k in after}


def confirmed_profile(fn, launched: dict, what: str) -> dict:
    """``profiled_request(fn)``, whose kernel names must confirm the
    launch counters' rise over one call (``launched``), on one trace: one
    K1 and one K5 kernel a launch, K2's cluster form one and its split
    form two (stats, apply), K4 two or three (the split-K reduction).  A
    trace can lose records (``cupti_graph_records``), so one that
    disagrees is logged and taken again, up to three in all."""
    k2 = {"cluster": launched["group_norm.cluster"],
          "split": 2 * launched["group_norm.split"]}
    for trace in range(1, 4):
        prof = profiled_request(fn)
        k = prof["ours"]
        split = sum(n for name, n in prof["by_name"].items()
                    if "gn_split" in name)
        ok = (k["K1"] == launched["flash_attention"]
              and k["K5"] == launched["layer_norm"]
              and k["K2"] == k2["cluster"] + k2["split"]
              and split == k2["split"]
              and 2 * launched["geglu"] <= k["K4"] <= 3 * launched["geglu"])
        log(f"{what}: trace {trace}, the profiler's kernels by name {k} "
            f"(K2's split form {split}) against the counters {launched}: "
            f"{'agree' if ok else 'DISAGREE'}")
        if ok:
            return prof
        log(f"{what}: trace {trace}, the kernels of K1, K2, K4 and K5 by "
            f"name: {prof['by_name']}")
    raise AssertionError(f"{what}: the profiler does not confirm the launch "
                         f"counters on any of three traces")


def graph_case(spipe: TryOnPipeline, kw: dict, split: bool, mode: str,
               reqs: list, refs: list, label: str, smi: str,
               profiled: bool) -> dict:
    """One mode of one group: a sampler, requests A (its capture) and B,
    each held bitwise to the eager image; the numbers; on the profiled
    case, the profile, the launches and the stale replay."""
    sampler = spipe.jit_sample(split=split, denoise_mode=mode, **kw)
    outs, seconds, peaks = [], [], []
    for i in (0, 1):
        out, dt, peak = run_timed(lambda: sampler(
            *reqs[i], generator=torch.Generator("cuda").manual_seed(
                1200 + i)))
        outs.append(out)
        seconds.append(dt)
        peaks.append(peak)
    same = [torch.equal(o, ref) for o, ref in zip(outs, refs)]
    capture = sum(sampler.capture_seconds.values())
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    r = {"capture_s": capture, "request_s": seconds[1],
         "capture_request_s": seconds[0],
         "peak_capture_gib": peaks[0], "peak_replay_gib": peaks[1],
         "same": same}
    if profiled:
        # the last request loaded B's inputs: replay as if for A without
        # loading A's
        stale = next(iter(sampler.sets.values())).run().clone()
        r["stale_equal_b"] = torch.equal(stale, refs[1])
        r["stale_equal_a"] = torch.equal(stale, refs[0])
        gen = torch.Generator("cuda")
        r["launched"] = launches_of(lambda: sampler(
            *reqs[1], generator=gen.manual_seed(1201)))
        r["profile"] = confirmed_profile(lambda: sampler(
            *reqs[1], generator=gen.manual_seed(1201)), r["launched"],
            f"phase 12 {label}, graphed")
    del sampler
    gc.collect()
    torch.cuda.empty_cache()
    r["held_gib"] = (held - torch.cuda.memory_reserved()) / 2 ** 30
    log(f"phase 12 {label}: capture {capture:.3f} s; requests graphed "
        f"A (with its capture) {seconds[0]:.3f} s, B {seconds[1]:.3f} s; "
        f"peak allocated {peaks[0]:.2f} GiB over the capture, "
        f"{peaks[1]:.2f} GiB over a replay; the graphs hold "
        f"{r['held_gib']:.2f} GiB; bitwise equal to the eager sample: A "
        f"{same[0]}, B {same[1]} [{smi}]")
    if not all(same):
        raise AssertionError(f"phase 12 {label}: graphed != eager")
    return r


@torch.no_grad()
def graphs_path(pipe: TryOnPipeline, smi: str) -> dict:
    """Phase 12: every group of ``GRAPH_GROUPS``, the two planted faults,
    and the profiled request graphed against eager.  Returns the
    numbers by case label."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    results = {}
    for name, steps, batch, rate, modes in GRAPH_GROUPS:
        spipe = dataclasses.replace(pipe, scheduler=make_scheduler(name))
        kw = dict(num_inference_steps=steps, guidance_scale=7.5,
                  cloth_cond_rate=rate)
        group = f"{name}-{steps} batch {batch} cloth_cond_rate {rate}"
        reqs = [graph_request(rng, batch) for _ in range(2)]
        refs, eager_s, eager_peak = [], [], []
        for i in range(2):
            out, dt, peak = run_timed(lambda: eager_request(
                spipe, reqs[i], 1200 + i, kw))
            refs.append(out)
            eager_s.append(dt)
            eager_peak.append(peak)
        log(f"phase 12 {group}: eager requests A {eager_s[0]:.3f} s, B "
            f"{eager_s[1]:.3f} s, peak allocated {max(eager_peak):.2f} GiB "
            f"[{smi}]")
        for split, mode in modes:
            label = f"{group} {mode_label(split, mode)}"
            profiled = (name, batch, split, mode) == PROFILED and rate == 1.0
            r = graph_case(spipe, kw, split, mode, reqs, refs, label, smi,
                           profiled)
            r.update(eager_s=eager_s[1], eager_peak_gib=max(eager_peak))
            results[label] = r
            if profiled:
                stale = (not r["stale_equal_a"]) and r["stale_equal_b"]
                log(f"phase 12 planted fault, a replay whose static inputs "
                    f"were not refreshed (A's request, B's inputs): equal "
                    f"to A's eager image {r['stale_equal_a']}, to B's "
                    f"{r['stale_equal_b']}: "
                    f"{'detected' if stale else 'MISSED'}")
                if not stale:
                    raise AssertionError("the stale replay was not detected")
                launched = launches_of(lambda: eager_request(
                    spipe, reqs[1], 1201, kw))
                prof = confirmed_profile(lambda: eager_request(
                    spipe, reqs[1], 1201, kw), launched,
                    f"phase 12 {label}, eager")
                g = r["profile"]
                log(f"phase 12 {label}: one request under torch.profiler: "
                    f"graphed {g['wall_s']:.3f} s wall, {g['device_ms']:.2f} "
                    f"ms of kernels, busy {g['busy']:.4f}, {g['kernels']} "
                    f"kernels; eager {prof['wall_s']:.3f} s, "
                    f"{prof['device_ms']:.2f} ms, busy {prof['busy']:.4f}, "
                    f"{prof['kernels']} kernels; launches a request graphed "
                    f"{r['launched']}, eager {launched} [{smi}]")
                if launched != r["launched"] or g["ours"] != prof["ours"]:
                    raise AssertionError("a graphed request launches other "
                                         "kernels than the eager one")
                r["eager_profile"] = prof
        if rate != 1.0:
            fixed = FixedGatePipeline(**{
                f.name: getattr(spipe, f.name)
                for f in dataclasses.fields(spipe)})
            sampler = fixed.jit_sample(split=True, denoise_mode="host", **kw)
            out = sampler(*reqs[0], generator=torch.Generator(
                "cuda").manual_seed(1200))
            planted = not torch.equal(out, refs[0])
            log(f"phase 12 planted fault, the {group} step graph captured "
                f"with the cloth gate as a Python bool: max |graphed - "
                f"eager| {float((out - refs[0]).abs().max()):.4e}: "
                f"{'detected' if planted else 'MISSED'}")
            if not planted:
                raise AssertionError("the fixed cloth gate was not detected")
            del sampler
        del refs, reqs
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 12: the sampler as CUDA graphs "
        f"({time.perf_counter() - t0:.1f} s)")
    return results


# phase 13: the conditioning as CUDA graphs (``Conditioner.jit()``
# through ``ConditionService``) at phase 5's full width, at these batch
# sizes; the prompts' ``$`` runs by garment (``MixedRuns``), and the
# pseudo-words of the cut run that S = 77 keeps
CONDITION_BATCHES = (2, 8)
CUT_KEEP = 7
GARMENTS = ("upper_body", "lower_body", "dresses")


class MixedRuns:
    """Phase 13's tokenizer: the synthetic tokenizer's ids, then by the
    prompt's garment: an upper body garment keeps its ``$`` run, a lower
    body garment loses it (no ``$``), and a dress has its run moved to
    the end of the 77 tokens, where S cuts it after ``CUT_KEEP``
    pseudo-words."""

    def __init__(self, tokenizer: CLIPTokenizer):
        self.tokenizer = tokenizer

    def __call__(self, prompts) -> np.ndarray:
        ids = np.array(self.tokenizer(prompts))
        plain = self.tokenizer.encode(" s ")[0]  # any id but '$'
        for row, prompt in zip(ids, prompts):
            if "upper body" not in prompt:
                row[row == VSTAR_TOKEN_ID] = plain
            if "dress" in prompt:
                row[-CUT_KEEP:] = VSTAR_TOKEN_ID
        return ids


def eager_condition(svc: ConditionService, raw: dict) -> tuple:
    """``svc.run`` with the eager ``Conditioner`` in place of its
    program: the same tokens, padding and fetch."""
    n = raw["cloth"].shape[0]
    ids = np.asarray(svc.tokenizer(svc.prompts(raw["categories"])))
    out = svc.conditioner(*(svc._pad(raw[k], np.float32) for k in (
        "pose_map", "cloth", "im_mask")), svc._pad(ids, np.int64))
    return tuple(t[:n].float().cpu().numpy() for t in out)


def index_write_splice(input_embeds, input_ids, word_embeddings,
                       num_vstar):
    """The splice as the port wrote it before ``Conditioner.jit()``: a
    boolean-mask index write, whose ``nonzero`` waits for the device."""
    B, S, D = input_embeds.shape
    ptes = word_embeddings.reshape(B, num_vstar, D).to(input_embeds.dtype)
    is_vstar = input_ids == VSTAR_TOKEN_ID
    has_vstar = is_vstar.any(dim=1)
    first = is_vstar.int().argmax(dim=1)
    targets = first[:, None] + torch.arange(num_vstar,
                                            device=input_ids.device)
    keep = has_vstar[:, None] & (targets < S)
    rows = torch.arange(B, device=input_ids.device)[:, None].expand_as(
        targets)
    out = input_embeds.clone()
    out[rows[keep], targets[keep]] = ptes[keep]
    return out


def planted_splice_capture() -> None:
    """Phase 13's second planted fault, run as a process of its own (a
    failed capture may leave the CUDA context unusable): the static
    splice captured in a program, then the boolean-mask splice, whose
    capture must fail.  Prints one JSON line."""
    gen = torch.Generator("cuda").manual_seed(13)
    B, S, D = 8, 77, 1024
    embeds = torch.randn(B, S, D, generator=gen, device="cuda").to(BF16)
    words = torch.randn(B, NUM_VSTAR * D, generator=gen,
                        device="cuda").to(BF16)
    ids = torch.randint(0, VSTAR_TOKEN_ID, (B, S), generator=gen,
                        device="cuda")
    ids[::2, 40:40 + NUM_VSTAR] = VSTAR_TOKEN_ID
    ids[1::4, S - CUT_KEEP:] = VSTAR_TOKEN_ID
    result = {}
    for name, splice in (("static", splice_word_embeddings),
                         ("index_write", index_write_splice)):
        program = graphs.Program(
            lambda e, i, w, splice=splice: splice(e, i, w, NUM_VSTAR),
            device="cuda")
        try:
            out = program(embeds, ids, words)
            same = torch.equal(out, splice(embeds, ids, words, NUM_VSTAR))
            result[name] = f"captured, bitwise equal to the eager: {same}"
        except Exception as e:  # the fault under test: report it
            result[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    print(json.dumps(result), flush=True)


def start_splice_capture() -> tuple:
    """``planted_splice_capture`` in a child process, started now and
    read by ``check_splice_capture``: (the process, its start time)."""
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.planted_splice_capture()"],
        cwd=pathlib.Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def check_splice_capture(started: tuple, smi: str) -> None:
    """Wait for ``start_splice_capture``'s process and fail unless the
    boolean-mask splice was refused and the static one captured."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [line for line in stdout.splitlines() if line.startswith("{")]
    if proc.returncode or not lines:
        raise AssertionError(f"the splice capture process failed "
                             f"({proc.returncode}): {stderr[-2000:]}")
    result = json.loads(lines[-1])
    caught = (result["static"].endswith("True")
              and result["index_write"].startswith("refused"))
    log(f"phase 13 planted fault, the boolean-mask splice captured in a "
        f"program (a process of its own, run beside the phase, "
        f"{time.perf_counter() - t0:.1f} s): "
        f"{result['index_write']}; the static splice "
        f"{result['static']}: {'detected' if caught else 'MISSED'} [{smi}]")
    if not caught:
        raise AssertionError("the boolean-mask splice was not refused, or "
                             "the static splice did not capture")


def condition_args(raw: dict) -> dict:
    """A raw request's arguments of ``ConditionService.run``."""
    return {k: raw[k] for k in ("cloth", "pose_map", "im_mask",
                                "categories")}


def same_outputs(a: tuple, b: tuple) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@torch.no_grad()
def condition_graphs_path(towers: Conditioner, tokenizer: CLIPTokenizer,
                          smi: str) -> dict:
    """Phase 13: ``ConditionService``'s graphed conditioning against the
    eager ``Conditioner``, its numbers, the two planted faults (the second
    in a process of its own, beside the rest) and the profiled request.
    Returns the numbers by batch size."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # room on the card for the child's context
    splice = start_splice_capture()
    try:
        results = condition_graphs(towers, tokenizer, smi)
        check_splice_capture(splice, smi)
    finally:
        if splice[0].poll() is None:  # a check above failed first
            splice[0].kill()
            splice[0].wait()
    log(f"phase 13: the conditioning as CUDA graphs "
        f"({time.perf_counter() - t_phase:.1f} s)")
    return results


def condition_graphs(towers: Conditioner, tokenizer: CLIPTokenizer,
                     smi: str) -> dict:
    """Phase 13 but its second planted fault."""
    h, w = towers.image_size
    rng = np.random.default_rng(13)
    results = {}
    for b in CONDITION_BATCHES:
        svc = ConditionService(towers, MixedRuns(tokenizer), batch_size=b,
                               num_vstar=NUM_VSTAR)
        reqs = []
        for i in range(2):
            raw = raw_request(rng, b, h, w)
            raw["categories"] = [GARMENTS[(j + i) % 3] for j in range(b)]
            reqs.append(raw)
        refs, eager_s, eager_peak = [], [], []
        for raw in reqs:
            out, dt, peak = run_timed(lambda: eager_condition(svc, raw))
            refs.append(out)
            eager_s.append(dt)
            eager_peak.append(peak)
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        outs, seconds, peaks = [], [], []
        for i, raw in enumerate(reqs):
            out, dt, peak = run_timed(
                lambda: svc.run(**condition_args(raw)))
            outs.append(out)
            seconds.append(dt)
            peaks.append(peak)
            if i == 0:
                # a replay over A's static inputs, as if for B
                stale = tuple(t[:b].float().cpu().numpy() for t in next(
                    iter(svc.program.sets.values())).run())
        same = [same_outputs(o, r) for o, r in zip(outs, refs)]
        planted = same_outputs(stale, refs[0]) and not same_outputs(
            stale, refs[1])
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - held
        capture = sum(svc.program.capture_seconds.values())
        r = {"capture_s": capture, "capture_request_s": seconds[0],
             "request_s": seconds[1], "eager_s": eager_s[1],
             "peak_capture_gib": peaks[0], "peak_replay_gib": peaks[1],
             "eager_peak_gib": max(eager_peak),
             "held_gib": held / 2 ** 30, "same": same}
        log(f"phase 13 batch {b}: capture {capture:.3f} s; requests graphed "
            f"A (with its capture) {seconds[0]:.3f} s, B {seconds[1]:.3f} s; "
            f"eager A {eager_s[0]:.3f} s, B {eager_s[1]:.3f} s; peak "
            f"allocated {peaks[0]:.2f} GiB over the capture, {peaks[1]:.2f} "
            f"GiB over a replay, {max(eager_peak):.2f} GiB eager; the graph "
            f"holds {r['held_gib']:.2f} GiB; bitwise equal to the eager "
            f"Conditioner: A {same[0]}, B {same[1]} [{smi}]")
        log(f"phase 13 planted fault, a replay over A's static inputs as if "
            f"for B: equal to A's eager outputs and not to B's: "
            f"{'detected' if planted else 'MISSED'}")
        if not all(same):
            raise AssertionError(f"phase 13 batch {b}: graphed != eager")
        if not planted:
            raise AssertionError("the stale replay was not detected")
        if b == CONDITION_BATCHES[0]:
            args = condition_args(reqs[1])
            launched = launches_of(lambda: svc.run(**args))
            g = confirmed_profile(lambda: svc.run(**args), launched,
                                  f"phase 13 batch {b}, graphed")
            eager_launched = launches_of(lambda: eager_condition(svc,
                                                                 reqs[1]))
            e = confirmed_profile(lambda: eager_condition(svc, reqs[1]),
                                  eager_launched,
                                  f"phase 13 batch {b}, eager")
            log(f"phase 13 batch {b}: one request under torch.profiler: "
                f"graphed {g['wall_s']:.4f} s wall, {g['device_ms']:.2f} ms "
                f"of kernels, busy {g['busy']:.4f}, {g['kernels']} kernels; "
                f"eager {e['wall_s']:.4f} s, {e['device_ms']:.2f} ms, busy "
                f"{e['busy']:.4f}, {e['kernels']} kernels; launches a "
                f"request graphed {launched}, eager {eager_launched} [{smi}]")
            if launched != eager_launched or g["ours"] != e["ours"]:
                raise AssertionError("a graphed conditioning launches other "
                                     "kernels than the eager one")
            if not launched["layer_norm"]:
                raise AssertionError("the conditioning launched no K5")
            r.update(launched=launched, profile=g, eager_profile=e)
        results[b] = r
        del svc
        gc.collect()
        torch.cuda.empty_cache()
    return results


class ProgramLog:
    """While open, the capture seconds of every ``pipelines.graphs``
    program that captures (the mains build theirs inside), by program:
    ``seconds``."""

    def __enter__(self) -> "ProgramLog":
        self.seconds: dict = {}
        self.replay = replay = graphs.Program.replay

        def logged(program, args):
            before = set(program.capture_seconds)
            out = replay(program, args)
            for key, sec in program.capture_seconds.items():
                if key not in before:
                    self.seconds.setdefault(program_name(program),
                                            []).append(round(sec, 3))
            return out

        graphs.Program.replay = logged
        return self

    def __exit__(self, *exc) -> None:
        graphs.Program.replay = self.replay


def program_name(program: graphs.Program) -> str:
    if isinstance(program, graphs.LoopProgram):
        return type(program.plan).__name__
    body = program.body
    return getattr(body, "__qualname__", type(body).__name__).replace(
        ".<locals>.<lambda>", "").replace(".<locals>.", ".")


# phase 13's drivers' programs against their eager bodies: the sampler's
# steps, and the batches (two, then one image: a second signature)
DRIVER_STEPS = 5
DRIVER_BATCHES = (2, 1)


@contextlib.contextmanager
def collected_batches():
    """The drivers' ``run_batches`` returning each batch's images, unsaved
    (``drivers`` and ``inpaint``)."""
    def collect(loader, step_fn, *args, **kwargs):
        return [step_fn(i, b).clone() for i, b in enumerate(loader)]

    saved = drivers.run_batches, inpaint.run_batches
    drivers.run_batches = inpaint.run_batches = collect
    try:
        yield
    finally:
        drivers.run_batches, inpaint.run_batches = saved


@contextlib.contextmanager
def eager_programs():
    """Every ``pipelines.graphs`` program calls its body eagerly on the
    card, as it does on the CPU."""
    def eager(program, *args):
        with torch.no_grad():
            return program.body(*args)

    saved = graphs.Program.__call__
    graphs.Program.__call__ = eager
    try:
        yield
    finally:
        graphs.Program.__call__ = saved


def driver_batch(rng: np.random.Generator, n: int, start: int) -> dict:
    """A test batch as the datasets give it, at 512x384."""
    r = raw_request(rng, n, 512, 384)
    return {"image": r["image"], "inpaint_mask": r["inpaint_mask"],
            "pose_map": r["pose_map"], "im_mask": r["im_mask"],
            "cloth": r["cloth"], "warped_cloth": r["cloth"][::-1].copy(),
            "category": r["categories"],
            "captions": [f"a shirt with {c} stripes" for c in range(n)],
            "im_name": [f"{start + i:06d}_0.jpg" for i in range(n)]}


def driver_programs(pipe: TryOnPipeline, towers: Conditioner, tokenizer,
                    smi: str) -> dict:
    """Phase 13's second part: each driver whose batches run through
    ``pipelines.graphs`` programs (the VAE reconstruction, the try-on
    driver on the vision tower and on noun chunks, the adapter's
    validation under bf16 autocast, as its trainer runs it) over two
    batches, graphed and with every program's body called eagerly: every
    image bitwise equal.  Returns each driver's capture seconds."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(14)
    loader = [driver_batch(rng, n, 10 * i)
              for i, n in enumerate(DRIVER_BATCHES)]
    text, adapter, vision = (towers.text_model, towers.adapter,
                             towers.vision)
    ipipe = inpaint.InpaintPipeline(
        unet=seeded(lambda: UNet2DCondition(sd2_unet_config(9)), 25,
                    "cuda", BF16),
        vae=pipe.vae, scheduler=DDIMScheduler())
    tryon = dict(num_vstar=NUM_VSTAR, seed=3,
                 num_inference_steps=DRIVER_STEPS)

    def adapter_validation():
        with precision(torch.device("cuda"), BF16):
            return inpaint.generate_images_inversion_adapter(
                ipipe, text, tokenizer, adapter, vision, loader, "unused",
                **tryon)

    runs = {
        "the VAE reconstruction": lambda: drivers.extract_save_vae_images(
            pipe.vae, pipe.emasc, loader, "unused", seed=3),
        "the try-on driver, the adapter on the vision tower":
            lambda: drivers.generate_images_from_tryon_pipe(
                pipe, text, tokenizer, loader, "unused",
                inversion_adapter=adapter, vision=vision, **tryon),
        "the try-on driver, noun chunks":
            lambda: drivers.generate_images_from_tryon_pipe(
                pipe, text, tokenizer, loader, "unused",
                text_usage="noun_chunks", **tryon),
        "the adapter's validation, bf16 autocast": adapter_validation,
    }
    results = {}
    for label, run in runs.items():
        with collected_batches(), torch.no_grad():
            with ProgramLog() as programs:
                t = time.perf_counter()
                graphed = run()
                torch.cuda.synchronize()
                t_graphed = time.perf_counter() - t
            with eager_programs():
                t = time.perf_counter()
                eager = run()
                torch.cuda.synchronize()
                t_eager = time.perf_counter() - t
        same = [torch.equal(a, b) for a, b in zip(graphed, eager)]
        ok = (len(same) == len(DRIVER_BATCHES) and all(same)
              and all(torch.isfinite(a).all() for a in graphed))
        log(f"phase 13 {label}: {len(graphed)} batches graphed "
            f"{t_graphed:.3f} s with the captures, eager {t_eager:.3f} s; "
            f"programs captured (seconds, host clock) {programs.seconds}; "
            f"images bitwise equal to the eager bodies': {same} [{smi}]")
        if not ok:
            raise AssertionError(f"phase 13 {label}: graphed != eager")
        results[label] = programs.seconds
    log(f"phase 13: the drivers' programs ({time.perf_counter() - t0:.1f} "
        f"s)")
    return results


# phase 14: the train steps as CUDA graphs (``pipelines.graphs.
# TrainProgram``, the JAX ``shard_step``'s ``jax.jit``) at full width,
# 512x384 (TPS at 256x192).  Each step kind's program against its eager
# body (``TrainProgram.run_eager``: the same capturable optimizer, batches
# and draws) over TRAIN_GRAPH_STEPS steps, from two copies of the same
# seeded modules: after every step the metrics, every trained parameter
# and buffer (BatchNorm's running statistics), the AdamW moments and step
# counters, ``count`` and the learning rate written must be
# ``torch.equal``.  The diffusion steps train under a warm-up schedule
# (TRAIN_GRAPH_LR), whose learning rate changes at every step; TPS and the
# refinement under their constant Adam(0.5, 0.99).  cuDNN deterministic,
# as phase 11's bitwise checks need, and PyTorch's deterministic
# algorithms (the resize's backward, an ``index_add``).  Two planted faults must land off the
# eager trajectory: a learning rate written inside the captured body (the
# capture bakes in its step's value) and not before the replays, and a
# first call that replays its capture once more (its update applied
# twice).  Then the TPS evaluation and the extraction (``train_tps``'s
# programs) and the metric towers (``MetricModels``' programs, TF32 off)
# against their eager bodies, bitwise.  Last, the capturable optimizer
# against the non-capturable one (AdamW's bias correction in fp32 on the
# device against float64 on the host) on one gradient sequence, each
# element within the bound below; and a card optimizer resumed from a
# CPU optimizer's state, graphed against eager (``resume_host_state``)
TRAIN_GRAPH_STEPS = 3
TRAIN_GRAPH_LR = dict(lr=1e-4, warmup_steps=10)
# (label, batch, gradient accumulation, gradient checkpointing)
VTO_GRAPH_CASES = (("VTO batch 1", 1, 1, False),
                   ("VTO batch 1, gradient checkpointing", 1, 1, True),
                   ("VTO batch 2, accumulation 2", 2, 2, False))
TPS_GRAPH_BATCH = 2
METRIC_GRAPH_BATCH = 8
# the two bias corrections differ by fp32 rounding (1 - 0.999^t loses
# about ten bits to cancellation at t = 1), so an element's update may
# differ by ~3e-5 of itself; where the sum with the parameter, or the
# weight decay's product, rounds the other way, the parameters differ in
# their last bit, up to twice a step: each
# element within CAPTURABLE_ULPS units in its last place or
# CAPTURABLE_LIMIT of its own update, whichever is larger
CAPTURABLE_ULPS = 2 * TRAIN_GRAPH_STEPS
CAPTURABLE_LIMIT = 1e-4


def tps_module() -> ConvNetTPS:
    """Phase 5's TPS (its regression off the identity warp)."""
    module = ConvNetTPS(256, 192, 21)
    torch.nn.init.normal_(module.loc_net.regression.linear.weight, std=1e-3)
    return module


def same_train_state(a: dict, b: dict) -> bool:
    """Whether two copies of a step's state are bitwise equal: every
    trained module's parameters and buffers, the AdamW state of every
    parameter, ``count`` and the learning rate written."""
    for name, module in a["modules"].items():
        sa, sb = module.state_dict(), b["modules"][name].state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k])
                                             for k in sa):
            return False
    oa, ob = a["optimizer"], b["optimizer"]
    if oa.count != ob.count or not torch.equal(oa.lr, ob.lr):
        return False
    for pa, pb in zip(oa.params, ob.params):
        ea, eb = oa.adamw.state.get(pa, {}), ob.adamw.state.get(pb, {})
        if ea.keys() != eb.keys() or not all(torch.equal(ea[k], eb[k])
                                             for k in ea):
            return False
    return True


def max_param_diff(a: dict, b: dict) -> float:
    return max((pa.detach() - pb.detach()).abs().max().item()
               for pa, pb in zip(a["optimizer"].params,
                                 b["optimizer"].params))


def pool_gib(pool) -> float:
    """The device memory a graph pool holds (the allocator's segments of
    that pool), GiB."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool)) / 2 ** 30


class BakedLrProgram(graphs.TrainProgram):
    """Phase 14's first planted fault: the learning rate is written inside
    the body, so the capture records its step's value, and is not written
    before a replay, which replays that value."""

    def __init__(self, program: graphs.TrainProgram):
        opt, body = program.optimizer, program.body

        def baked(*args):
            opt.write_lr()
            return body(*args)

        super().__init__(baked, optimizer=opt, device=program.device,
                         modules=program.modules)

    def __call__(self, *args):
        with torch.enable_grad():
            out = graphs._map(torch.clone, self.replay(args))
        self.optimizer.advance()
        return out


class DoubleUpdateProgram(graphs.TrainProgram):
    """Phase 14's second planted fault: the call that captures a
    signature also replays it once, so that call's update applies
    twice."""

    def __init__(self, program: graphs.TrainProgram):
        super().__init__(program.body, optimizer=program.optimizer,
                         device=program.device, modules=program.modules)

    def replay(self, args):
        fresh = graphs._signature(args) not in self.sets
        out = super().replay(args)
        if fresh:
            out = self.sets[graphs._signature(args)].run()
        return out


def trajectories(label: str, make, inputs: list, smi: str,
                 planted=None, profile: bool = False,
                 phase: str = "phase 14") -> dict:
    """Two copies of a step (``make()`` -> modules, optimizer, step
    program), the first run eagerly (its body), the second graphed (or
    wrapped in ``planted``), over ``inputs`` (one (batch, draws) a step):
    whether each step's results were bitwise equal, the seconds, the
    capture's, the peaks above the resident state, the pool; with
    ``profile``, each one's launches and profile of one more step, the
    graphed trace confirming the launch counters."""
    eager, graphed = make(), make()
    if planted is not None:
        graphed["step"] = planted(graphed["step"])
    program = graphed["step"]
    same, seconds, peaks, lrs = [], {"eager": [], "graphed": []}, {
        "eager": [], "graphed": []}, []
    for args in inputs:
        for kind, run in (("eager", lambda: eager["step"].run_eager(*args)),
                          ("graphed", lambda: program(*args))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            seconds[kind].append(time.perf_counter() - t0)
            peaks[kind].append((torch.cuda.max_memory_allocated() - before)
                               / 2 ** 30)
            if kind == "eager":
                ref = out
        same.append(ref.keys() == out.keys()
                    and all(torch.equal(ref[k], out[k]) for k in ref)
                    and same_train_state(eager, graphed))
        lrs.append(float(graphed["optimizer"].lr))
    (step,) = program.sets.values()
    r = {"same": same, "eager_s": seconds["eager"],
         "graphed_s": seconds["graphed"], "lrs": lrs,
         "warmup_s": step.warmup_seconds,
         "capture_s": step.capture_seconds,
         "peak_eager_gib": max(peaks["eager"]),
         "peak_capture_gib": peaks["graphed"][0],
         "peak_replay_gib": max(peaks["graphed"][1:]),
         "pool_gib": pool_gib(step.pool),
         "state_gib": sum(p.numel() * 4 * 3 for p in
                          graphed["optimizer"].params) / 2 ** 30,
         "max_param_diff": max_param_diff(eager, graphed)}
    if profile:
        args = inputs[-1]
        r["launched"] = launches_of(lambda: program(*args))
        r["eager_launched"] = launches_of(
            lambda: eager["step"].run_eager(*args))
        r["profile"] = confirmed_profile(lambda: program(*args),
                                         r["launched"],
                                         f"{phase} {label}, graphed")
        # the eager step's busy share; its trace has lost a split-form
        # GroupNorm launch at a window's edge (as phase 12's did before
        # PROFILE_MARGIN_S), so only the graphed trace confirms the
        # counters, which the eager ones must equal
        r["eager_profile"] = profiled_request(
            lambda: eager["step"].run_eager(*args))
        if r["launched"] != r["eager_launched"]:
            raise AssertionError(f"{phase} {label}: a replay launches "
                                 f"other kernels than the eager step")
    del eager, graphed, program, step
    gc.collect()
    torch.cuda.empty_cache()
    mean = lambda xs: float(np.mean(xs[1:]))  # noqa: E731
    log(f"{phase} {label}: steps graphed {mean(r['graphed_s']):.4f} s "
        f"(2-{len(inputs)}; the first, eager then captured, "
        f"{r['graphed_s'][0]:.3f} s: warm-up {r['warmup_s']:.3f} s, "
        f"capture {r['capture_s']:.3f} s), eager {mean(r['eager_s']):.4f} "
        f"s; peak allocated above the resident state: eager "
        f"{r['peak_eager_gib']:.2f} GiB, capture "
        f"{r['peak_capture_gib']:.2f}, replay {r['peak_replay_gib']:.2f}; "
        f"the graph's pool {r['pool_gib']:.2f} GiB, gradients included "
        f"(parameters and AdamW moments {r['state_gib']:.2f} GiB); lr "
        f"written "
        f"{[f'{x:.3g}' for x in lrs]}; bitwise equal to the eager body "
        f"after each step: {same}"
        + (f"; launches a step {r['launched']}; one step under "
           f"torch.profiler: graphed {r['profile']['wall_s']:.4f} s wall, "
           f"{r['profile']['device_ms']:.2f} ms of kernels, busy "
           f"{r['profile']['busy']:.4f}, {r['profile']['kernels']} "
           f"kernels; eager {r['eager_profile']['wall_s']:.4f} s, "
           f"{r['eager_profile']['device_ms']:.2f} ms, busy "
           f"{r['eager_profile']['busy']:.4f}, "
           f"{r['eager_profile']['kernels']} kernels" if profile else "")
        + f" [{smi}]")
    return r


def on_cuda(tree: dict) -> dict:
    return {k: v.to("cuda") for k, v in tree.items()}


def train_graph_inputs(tokenizer, n: int, batch: int, seed: int,
                       draws=None, keys=None) -> list:
    """``n`` steps' (batch, draws) at 512x384 on the card."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = [train_batch(rng, tokenizer, *TRAIN_SIZE)
                for _ in range(batch)]
        b = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
        if keys is not None:
            b = {k: b[k] for k in keys}
        d = (draws(b, torch.Generator().manual_seed(seed + i))
             if draws is not None else None)
        out.append((on_cuda(b), on_cuda(d) if d is not None else None))
    return out


def warp_inputs(n: int, size: tuple, seed: int) -> list:
    """``n`` steps' TPS or refinement batches (TPS_GRAPH_BATCH images)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    B, (h, w) = TPS_GRAPH_BATCH, size
    return [(on_cuda({k: torch.from_numpy(rng.uniform(
        -1 if k != "pose" else 0, 1, (B, h, w, 18 if k == "pose" else 3)
    ).astype(f)) for k in ("cloth", "im_cloth", "im_mask", "pose")}),)
        for _ in range(n)]


def step_makers(pipe: TryOnPipeline, towers: Conditioner,
                tokenizer) -> dict:
    """Phase 14's step kinds: label -> (make, inputs, profiled)."""
    cuda = torch.device("cuda")
    autocast = lambda: precision(cuda, BF16)  # noqa: E731
    vae, text, adapter = pipe.vae, towers.text_model, towers.adapter
    for m in (vae, text, adapter):
        m.requires_grad_(False)
    empty = torch.from_numpy(tokenizer([""])[0].astype(np.int64)).cuda()
    vgg = seeded(VGG19Features, 14, "cuda").requires_grad_(False)
    unet9 = seeded(lambda: UNet2DCondition(sd2_unet_config(9)), 25, "cuda",
                   BF16).requires_grad_(False)
    tps_frozen = seeded(tps_module, 20, "cuda").requires_grad_(False)
    makers = {}

    def vto(A: int, ckpt: bool):
        def make():
            unet = seeded(lambda: UNet2DCondition(sd2_unet_config(31)), 10,
                          "cuda")
            unet.gradient_checkpointing = ckpt
            opt = make_optimizer(list(unet.parameters()), **TRAIN_GRAPH_LR)
            return {"modules": {"unet": unet}, "optimizer": opt,
                    "step": make_vto_train_step(
                        optimizer=opt, config=VTOStepConfig(
                            num_vstar=NUM_VSTAR,
                            gradient_accumulation_steps=A),
                        autocast=autocast, unet=unet, vae=vae,
                        text_model=text, inversion_adapter=adapter,
                        empty_prompt_ids=empty)}
        return make

    for i, (label, batch, A, ckpt) in enumerate(VTO_GRAPH_CASES):
        makers[label] = (vto(A, ckpt), train_graph_inputs(
            tokenizer, TRAIN_GRAPH_STEPS, batch, 1400 + 10 * i, vto_draws),
            i == 0)

    def emasc_make():
        emasc = seeded(EMASC, 12, "cuda")
        opt = make_optimizer(list(emasc.parameters()), **TRAIN_GRAPH_LR)
        return {"modules": {"emasc": emasc}, "optimizer": opt,
                "step": make_emasc_train_step(
                    optimizer=opt, autocast=autocast, vae=vae, emasc=emasc,
                    vgg=vgg)}

    makers["EMASC"] = (emasc_make, train_graph_inputs(
        tokenizer, TRAIN_GRAPH_STEPS, 1, 1440, emasc_draws,
        ("image", "im_mask", "inpaint_mask")), True)

    def adapter_make():
        trained = seeded(lambda: InversionAdapter(num_encoder_layers=1), 23,
                         "cuda")
        opt = make_optimizer(list(trained.parameters()), **TRAIN_GRAPH_LR)
        return {"modules": {"adapter": trained}, "optimizer": opt,
                "step": make_inversion_adapter_train_step(
                    optimizer=opt, autocast=autocast, unet9=unet9, vae=vae,
                    text_model=text, inversion_adapter=trained,
                    num_vstar=NUM_VSTAR)}

    adapter_inputs = train_graph_inputs(
        tokenizer, TRAIN_GRAPH_STEPS, 1, 1450, adapter_draws,
        ("image", "im_mask", "inpaint_mask", "input_ids",
         "clip_cloth_features"))
    for b, _ in adapter_inputs:
        b["clip_cloth_features"] = b["clip_cloth_features"].to(BF16)
    makers["the adapter"] = (adapter_make, adapter_inputs, True)

    def tps_make():
        module = seeded(tps_module, 20, "cuda")
        opt = tps_optimizer(module.parameters())
        return {"modules": {"tps": module}, "optimizer": opt,
                "step": make_tps_train_step(tps=module, optimizer=opt)}

    makers["TPS 256x192"] = (tps_make, warp_inputs(
        TRAIN_GRAPH_STEPS, TPS_SIZE, 1460), True)

    def refinement_make():
        module = seeded(UNetVanilla, 21, "cuda")
        opt = tps_optimizer(module.parameters())
        return {"modules": {"refinement": module}, "optimizer": opt,
                "step": make_refinement_train_step(
                    optimizer=opt, tps=tps_frozen, refinement=module,
                    vgg=vgg)}

    makers["the refinement"] = (refinement_make, warp_inputs(
        TRAIN_GRAPH_STEPS, TRAIN_SIZE, 1470), True)
    return makers


def planted_train_faults(makers: dict, smi: str) -> None:
    """Phase 14's two planted faults on the EMASC step (warm-up
    schedule): each must land off the eager trajectory."""
    make, inputs, _ = makers["EMASC"]
    for name, planted in (("the learning rate baked into the capture",
                           BakedLrProgram),
                          ("the capture's call updating twice",
                           DoubleUpdateProgram)):
        r = trajectories(f"EMASC, planted fault: {name}", make, inputs,
                         smi, planted=planted)
        off = [i + 1 for i, s in enumerate(r["same"]) if not s]
        log(f"phase 14 planted fault, {name}: off the eager trajectory at "
            f"steps {off}, the parameters {r['max_param_diff']:.3e} apart "
            f"after step {len(inputs)}: "
            f"{'detected' if off else 'MISSED'}")
        if not off:
            raise AssertionError(f"phase 14: the planted fault ({name}) "
                                 f"stayed on the eager trajectory")


def capturable_drift(smi: str) -> float:
    """The capturable AdamW (``train.steps.Optimizer`` on the card)
    against the non-capturable one (``lr`` a float, the bias correction on
    the host in float64) on the same parameters and gradient sequence,
    under TRAIN_GRAPH_LR's warm-up: their largest parameter difference
    after TRAIN_GRAPH_STEPS updates, each element's against the larger of
    CAPTURABLE_ULPS units in its last place and CAPTURABLE_LIMIT of its
    update (the worst ratio is returned).  The gradients span nine
    decades, so that some elements sit where eps dominates the
    denominator."""
    gen = torch.Generator("cuda").manual_seed(1495)
    shapes = [(1024, 1024), (4096,), (320, 320, 3, 3)]
    base = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    grads = [[torch.randn(s, generator=gen, device="cuda") * 10.0 ** -k
              for s, k in zip(shapes, (0, 4, 8))]
             for _ in range(TRAIN_GRAPH_STEPS)]
    runs = {}
    for capturable in (True, False):
        params = [torch.nn.Parameter(b.clone()) for b in base]
        opt = make_optimizer(params, **TRAIN_GRAPH_LR)
        if not capturable:
            opt.adamw = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=1e-2)
            opt.lr, opt.capturable = None, False
        for g in grads:
            opt.zero_grad()
            for p, x in zip(params, g):
                p.grad = x.clone()
            opt.step()
        runs[capturable] = params
    inf = torch.tensor(float("inf"), device="cuda")
    diff = worst = 0.0
    for a, b, b0 in zip(runs[True], runs[False], base):
        a, b = a.detach(), b.detach()
        ulp = torch.nextafter(b.abs(), inf) - b.abs()
        bound = torch.maximum(CAPTURABLE_ULPS * ulp,
                              CAPTURABLE_LIMIT * (b - b0).abs())
        diff = max(diff, (a - b).abs().max().item())
        worst = max(worst, ((a - b).abs() / bound).max().item())
    log(f"phase 14: the capturable AdamW against the non-capturable one, "
        f"{TRAIN_GRAPH_STEPS} updates of the same gradients under the "
        f"warm-up: parameters at most {diff:.3e} apart; the worst element "
        f"at {worst:.3f} of its bound ({CAPTURABLE_ULPS} units in its last "
        f"place or {CAPTURABLE_LIMIT:g} of its update) [{smi}]")
    if not worst <= 1.0:
        raise AssertionError(f"the capturable optimizer drifts past its "
                             f"bound ({worst:.3f}) from the non-capturable "
                             f"one")
    return worst


def resume_host_state(smi: str) -> None:
    """A card optimizer resumed from the state dict of a non-capturable
    one: an optimizer on the CPU, as ``--device cpu`` writes it (and as
    the trainers wrote it before AdamW was capturable: ``capturable``
    False, the step counters on the host).  The load must move the
    counters to the card, and the step program after it (graphed, and
    its eager body from a second load) run TRAIN_GRAPH_STEPS updates
    from the loaded moments, bitwise equal after each."""
    gen = torch.Generator().manual_seed(1496)
    shapes = [(256, 256), (4096,)]
    host = [torch.nn.Parameter(torch.randn(s, generator=gen))
            for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(2 + TRAIN_GRAPH_STEPS)]
    opt = make_optimizer(host, **TRAIN_GRAPH_LR)
    for g in grads[:2]:
        opt.zero_grad()
        for p, x in zip(host, g):
            p.grad = x.clone()
        opt.step()
    saved = opt.state_dict()
    if any(group["capturable"] for group in saved["adamw"]["param_groups"]):
        raise AssertionError("phase 14: the CPU optimizer saved a "
                             "capturable state")
    runs = []
    for graphed in (False, True):
        params = [torch.nn.Parameter(p.detach().cuda()) for p in host]
        card = make_optimizer(params, **TRAIN_GRAPH_LR)
        card.load_state_dict(saved)
        where = {(e["step"].device.type, e["step"].dtype, float(e["step"]))
                 for e in card.adamw.state.values()}
        if where != {("cuda", torch.float32, 2.0)}:
            raise AssertionError(f"phase 14: the loaded step counters are "
                                 f"{where}, not 2.0 in fp32 on the card")

        def body(*gs, card=card, params=params):
            card.zero_grad()
            for p, g in zip(params, gs):
                p.grad = g.clone()
            return {"norm": card.update()}

        program = graphs.TrainProgram(body, optimizer=card, device="cuda")
        run = program if graphed else program.run_eager
        trail = []
        for g in grads[2:]:
            out = run(*[x.cuda() for x in g])
            trail.append([out["norm"]] + [p.detach().clone()
                                          for p in params]
                         + [e[k].clone() for e in card.adamw.state.values()
                            for k in ("exp_avg", "exp_avg_sq", "step")])
        runs.append((trail, card.count))
    (eager, n_eager), (graph, n_graph) = runs
    same = [all(torch.equal(a, b) for a, b in zip(x, y))
            for x, y in zip(eager, graph)]
    moved = max((a - b.cuda()).abs().max().item()
                for a, b in zip(graph[-1][1:1 + len(host)], host))
    log(f"phase 14: a card optimizer resumed from a CPU optimizer's state "
        f"(step counters on the host, capturable False): counters moved to "
        f"the card, {TRAIN_GRAPH_STEPS} steps graphed bitwise their eager "
        f"body after each: {same}, count {n_graph}, parameters moved "
        f"{moved:.3e} [{smi}]")
    if not all(same) or n_graph != n_eager or n_graph != 2 + \
            TRAIN_GRAPH_STEPS or not moved > 0:
        raise AssertionError("phase 14: the resumed optimizer's steps are "
                             "off")


def kernel_names(fn) -> dict:
    """The kernels one call of ``fn`` runs, by name, under the profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def inference_program(label: str, program: graphs.Program, eager, args,
                      smi: str) -> dict:
    """A program's capture and a replay against its body called eagerly,
    bitwise; the seconds, the pool, FFT kernels in a replay."""
    with torch.no_grad():
        want = eager(*args)
    got, seconds = [], []
    for _ in range(2):
        out, dt, _ = run_timed(lambda: program(*args))
        got.append(out)
        seconds.append(dt)
    _, eager_s, _ = run_timed(lambda: eager(*args))
    flat = graphs._leaves
    same = [all(torch.equal(a, b) for a, b in zip(flat(g), flat(want)))
            for g in got]
    (captured,) = program.sets.values()
    pool = pool_gib(captured.graph.pool)
    fft = sum(n for k, n in kernel_names(lambda: program(*args)).items()
              if "fft" in k.lower())
    log(f"phase 14 {label}: capture call {seconds[0]:.3f} s (capture "
        f"{sum(program.capture_seconds.values()):.3f} s), replay "
        f"{seconds[1]:.4f} s, eager {eager_s:.4f} s; the graph's pool "
        f"{pool:.2f} GiB; FFT kernels in a replay {fft}; bitwise equal to "
        f"the eager body: {same} [{smi}]")
    if not all(same):
        raise AssertionError(f"phase 14 {label}: graphed != eager")
    return {"capture_s": seconds[0], "replay_s": seconds[1],
            "eager_s": eager_s, "pool_gib": pool, "fft_kernels": fft}


def inference_programs(work: pathlib.Path, smi: str) -> dict:
    """The TPS evaluation (warped, refined) and the extraction, as
    ``train_tps`` builds them, and the metric towers of ``MetricModels``
    (TF32 off) against their eager bodies."""
    tps_m = seeded(tps_module, 20, "cuda")
    ref_m = seeded(UNetVanilla, 21, "cuda")
    vgg = seeded(VGG19Features, 14, "cuda")
    (batch,), = warp_inputs(1, TRAIN_SIZE, 1480)
    h, w = TRAIN_SIZE
    results = {}
    for refined in (False, True):
        body = functools.partial(eval_batch, tps_m, ref_m, vgg,
                                 refined=refined, height=h, width=w)
        results[f"eval refined={refined}"] = inference_program(
            f"the TPS evaluation, refined {refined} (batch "
            f"{TPS_GRAPH_BATCH})", graphs.Program(
                body, device="cuda", modules=(tps_m, ref_m, vgg)), body,
            (batch,), smi)
    body = functools.partial(extraction_pixels, tps_m, ref_m, height=h,
                             width=w)
    args = tuple(batch[k] for k in ("cloth", "im_mask", "pose"))
    results["extraction"] = inference_program(
        f"the extraction (batch {TPS_GRAPH_BATCH})", graphs.Program(
            body, device="cuda", modules=(tps_m, ref_m)), body, args, smi)
    del tps_m, ref_m, vgg
    models = MetricModels(write_metric_weights(work / "metrics14", seed=92),
                          "cuda")
    rng = np.random.default_rng(1490)
    x = torch.from_numpy(rng.uniform(-1, 1, (
        METRIC_GRAPH_BATCH, 299, 299, 3)).astype(np.float32))
    a = rng.uniform(0, 1, (METRIC_GRAPH_BATCH, *TRAIN_SIZE, 3)).astype(
        np.float32)
    b = torch.from_numpy(np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
                         .astype(np.float32))
    a = torch.from_numpy(a)
    inception, lpips = models.inception(), models.lpips()
    towers = {
        "inception": ((x,), lambda t: inception(t.cuda())),
        "lpips": ((a, b), lambda s, t: lpips(s.cuda(), t.cuda(),
                                             normalize=True)),
        "ssim": ((a, b), lambda s, t: ssim_fn(s.cuda(), t.cuda())),
    }
    # the programs as MetricModels builds them, each called once there
    models.inception_features(x.numpy())
    models.lpips_distance(a.numpy(), b.numpy())
    models.ssim(a.numpy(), b.numpy())
    with strict_fp32():
        for name, (args, eager) in towers.items():
            program = models._programs[name]
            program.sets.clear()  # captured again below, timed
            gc.collect()
            torch.cuda.empty_cache()
            results[name] = inference_program(
                f"the metric tower {name} (batch {METRIC_GRAPH_BATCH}, TF32 "
                f"off)", program, eager, args, smi)
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return results


# phase 14's open question (a graphed EMASC step's trace once held 26
# split-form stats kernels against 27 launches): whether CUPTI drops
# records of a graph's kernel nodes.  One CUDA graph of K2 at each of its
# phase-2 shapes (both forms), replayed this many times inside one trace,
# its kernel records (by form, in device time order) laid against the
# replays' launch sequence, which ``group_norm_plan`` gives: the replays
# start at once after the profiler starts and, in a second trace, after
# PROFILE_MARGIN_S of host sleep (and as long after the last)
CUPTI_REPLAYS = 1000
K2_FORMS = (("gn_cluster", "cluster"), ("gn_split_stats", "stats"),
            ("gn_split_apply", "apply"))


def lost_records(records: list, sequence: list, replays: int) -> list:
    """The replay index of each launch of ``replays`` x ``sequence`` (by
    form) that ``records`` (by form, in device time order) lacks: a
    record is matched to the next launch of its form."""
    lost, i = [], 0
    for r in range(replays):
        for form in sequence:
            if i < len(records) and records[i] == form:
                i += 1
            else:
                lost.append(r)
    return lost


@torch.no_grad()
def cupti_graph_records(smi: str) -> dict:
    gen = Gen(14)
    calls, sequence = [], []
    for B, N, C, silu, eps, wdt in GN_SHAPES:
        calls.append((gen.normal(B, N, C),
                      gen.normal(C, scale=0.1, dtype=wdt) + 1.0,
                      gen.normal(C, scale=0.1, dtype=wdt), eps,
                      "silu" if silu else "none"))
        sequence += (["stats", "apply"] if gn_plan(B, N, C).form == "split"
                     else ["cluster"])

    def body():
        for x, w, b, eps, act in calls:
            group_norm(x, w, b, eps=eps, act=act)

    launched = launches_of(body)
    if len(sequence) != (launched["group_norm.cluster"]
                         + 2 * launched["group_norm.split"]):
        raise AssertionError("K2's plans disagree with its launch counters")
    stream = capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        body()
    graph.replay()
    torch.cuda.synchronize()
    lost = {}
    for margin in (0.0, PROFILE_MARGIN_S):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(CUPTI_REPLAYS):
                graph.replay()
            torch.cuda.synchronize()
            time.sleep(margin)
        events = sorted((e.time_range.start, form) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        for key, form in K2_FORMS if key in e.name)
        where = lost_records([form for _, form in events], sequence,
                             CUPTI_REPLAYS)
        lost[margin] = where
        log(f"phase 14: CUPTI over {CUPTI_REPLAYS} replays of one graph of "
            f"{len(sequence)} K2 kernels ({len(calls)} calls, both forms), "
            f"{margin} s of margin: {len(events)} records of "
            f"{CUPTI_REPLAYS * len(sequence)}, the replays short of a record "
            f"{where or 'none'} [{smi}]")
    graph.reset()
    return {"replays": CUPTI_REPLAYS, "sequence": sequence, "lost": lost}


@contextlib.contextmanager
def bitwise_training():
    """The settings under which a graphed train step must equal its eager
    body bit for bit: cuDNN deterministic, and ``index_add`` (the backward
    of the resize in the EMASC step's VGG loss and the refinement's
    upsampling) adding in a fixed order; other operations without a
    deterministic form only warn, and nothing fills new memory."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def train_graphs_path(pipe: TryOnPipeline, towers: Conditioner, tokenizer,
                      work: pathlib.Path, smi: str) -> dict:
    """Phase 14: every step kind graphed against its eager body, the
    planted faults, the capturable optimizer's drift, and the inference
    programs.  Returns the numbers by label."""
    t0 = time.perf_counter()
    cupti = cupti_graph_records(smi)
    with bitwise_training():
        makers = step_makers(pipe, towers, tokenizer)
        results = {}
        for label, (make, inputs, profiled) in makers.items():
            r = trajectories(label, make, inputs, smi, profile=profiled)
            if not all(r["same"]):
                raise AssertionError(f"phase 14 {label}: graphed != eager")
            results[label] = r
        planted_train_faults(makers, smi)
        results["capturable_drift"] = capturable_drift(smi)
        resume_host_state(smi)
        del makers
        gc.collect()
        torch.cuda.empty_cache()
        results["inference"] = inference_programs(work, smi)
        results["cupti"] = cupti
    log(f"phase 14: the train steps, the TPS evaluation and extraction and "
        f"the metric towers as CUDA graphs ({time.perf_counter() - t0:.1f} "
        f"s)")
    return results


# phase 15: the SD-1.5 family of the extended UNet (``sd15_unet_config``:
# 1x1-conv projections, eight heads at every width, so K1 at head dims 40,
# 80 and 160, and a 768-wide context from the quick_gelu ViT-L/14 text
# tower) at full width with seeded bf16 weights, beside phase 4's VAE and
# EMASC and phase 5's vision tower, TPS and refinement.  The levels' (C,
# latent height, width) of a 512x384 image: levels 0-2 and the mid block
SD15_CTX = 768
SD15_LEVELS = ((320, 64, 48), (640, 32, 24), (1280, 16, 12), (1280, 8, 6))
SD15_SEEDS = {"unet": 30, "adapter": 33, "text": 34, "blocks": 40}


class AttentionCensus(Census):
    """(B, Sq, Sk, H, D) -> calls of the attentions."""

    kind = CrossAttention

    def hook(self, module, args, output) -> None:
        x = args[0]
        context = args[1] if len(args) > 1 and args[1] is not None else x
        key = (x.shape[0], x.shape[1], context.shape[1], module.heads,
               module.dim_head)
        self.calls[key] = self.calls.get(key, 0) + 1


def sd15_unet() -> UNet2DCondition:
    return UNet2DCondition(sd15_unet_config(31))


def sd15_pipeline(pipe: TryOnPipeline) -> TryOnPipeline:
    """The SD-1.5 UNet, seeded, in bf16 beside ``pipe``'s VAE and EMASC."""
    return dataclasses.replace(pipe, unet=seeded(
        sd15_unet, SD15_SEEDS["unet"], "cuda", BF16))


def sd15_conditioner(towers: Conditioner) -> Conditioner:
    """``towers`` with the SD-1.5 text tower (12 x 768, quick_gelu) and an
    inversion adapter to ``NUM_VSTAR`` x 768, seeded, in bf16."""
    return dataclasses.replace(
        towers,
        adapter=seeded(lambda: InversionAdapter(
            num_encoder_layers=1, output_dim=SD15_CTX * NUM_VSTAR),
            SD15_SEEDS["adapter"], "cuda", BF16),
        text_model=seeded(lambda: CLIPTextModel(sd15_text_config()),
                          SD15_SEEDS["text"], "cuda", BF16))


@torch.no_grad()
def check_sd15_blocks(gen: Gen, spipe: TryOnPipeline, text, tokenizer) -> None:
    """The SD-1.5 ``Transformer2D`` at each level at 512x384, one UNet step
    at 256x192 (batch 1; as phase 3's small sampler, the CPU's cost) with
    the hoisted K/V bitwise the inline form, and the text tower, each on
    the card against its fp32 CPU twin."""
    for i, (C, h, w) in enumerate(SD15_LEVELS):
        def tfm(C=C):
            return Transformer2D(8, C // 8, C, SD15_CTX, linear=False)

        block = seeded(tfm, SD15_SEEDS["blocks"] + i, "cuda", BF16)
        x = gen.normal(2, C, h, w).contiguous(
            memory_format=torch.channels_last)
        ctx = gen.normal(2, 77, SD15_CTX)
        out = block(x, ctx)
        torch.cuda.synchronize()
        err = rel_l2(out, cpu_copy(block, tfm)(x.float().cpu(),
                                               ctx.float().cpu()))
        log(f"phase 15: SD-1.5 Transformer2D C={C} {h}x{w} B=2 (8 heads of "
            f"{C // 8}, 1x1-conv projections): rel_l2 {err:.3e} (limit "
            f"{BLOCK_LIMIT})")
        if not err <= BLOCK_LIMIT:
            raise AssertionError(f"the SD-1.5 Transformer2D C={C} disagrees")
    unet = spipe.unet
    x = gen.normal(1, 31, 32, 24, dtype=torch.float32)
    t = torch.tensor([981], device="cuda")
    ctx = gen.normal(1, 77, SD15_CTX, dtype=torch.float32)
    out = unet(x, t, ctx)
    kv = unet.precompute_context_kv(ctx)
    hoisted = unet(x, t, ctx, context_kv=kv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = cpu_copy(unet, sd15_unet)(x.cpu(), t.cpu(), ctx.cpu())
    t_cpu = time.perf_counter() - t0
    err = rel_l2(out, ref)
    same = torch.equal(hoisted, out)
    log(f"phase 15: one SD-1.5 UNet step at 32x24 latents, batch 1, on the "
        f"card (bf16) against the CPU (fp32, {t_cpu:.1f} s): rel_l2 "
        f"{err:.3e} (limit {BLOCK_LIMIT}); {len(kv)} hoisted context K/V "
        f"pairs, the step with them bitwise the inline one: {same}")
    if not (err <= BLOCK_LIMIT and same and len(kv) == 16
            and torch.isfinite(out).all()):
        raise AssertionError("the SD-1.5 UNet step disagrees")
    ids = torch.from_numpy(tokenizer(["a photo of a red dress $ $ $",
                                      ""]).astype(np.int64))
    emb = text(ids.cuda())[0]
    err = rel_l2(emb, cpu_copy(text, lambda: CLIPTextModel(
        sd15_text_config()))(ids)[0])
    log(f"phase 15: the SD-1.5 text tower (12 x 768, quick_gelu) on the "
        f"card against the CPU: rel_l2 {err:.3e} (limit {EMBEDS_LIMIT})")
    if not err <= EMBEDS_LIMIT:
        raise AssertionError("the SD-1.5 text tower disagrees")


@torch.no_grad()
def sd15_graphed_request(spipe: TryOnPipeline, smi: str) -> dict:
    """One 2-image DDIM-50, CFG 7.5 request at 512x384 through the callers'
    sampler (``split=True``, ``"host"``): its capture and a replay, each
    bitwise its eager body; K1's calls by shape (a census over the eager
    request) and the launches of a replay."""
    kw = dict(num_inference_steps=50, guidance_scale=7.5)
    reqs = graph_request(np.random.default_rng(15), 2, SD15_CTX)
    with AttentionCensus(spipe.unet) as census:
        ref, eager_s, eager_peak = run_timed(
            lambda: eager_request(spipe, reqs, 1500, kw))
    sampler = spipe.jit_sample(split=True, denoise_mode="host", **kw)
    outs, seconds, peaks = [], [], []
    for _ in range(2):
        out, dt, peak = run_timed(lambda: sampler(
            *reqs, generator=torch.Generator("cuda").manual_seed(1500)))
        outs.append(out)
        seconds.append(dt)
        peaks.append(peak)
    same = [torch.equal(o, ref) for o in outs]
    launched = launches_of(lambda: sampler(
        *reqs, generator=torch.Generator("cuda").manual_seed(1500)))
    log(f"phase 15: a graphed SD-1.5 DDIM-50 request, CFG 7.5, 2 images at "
        f"512x384: eager {eager_s:.3f} s (peak {eager_peak:.2f} GiB); graphed "
        f"with its capture {seconds[0]:.3f} s (capture "
        f"{sum(sampler.capture_seconds.values()):.3f} s, peak "
        f"{peaks[0]:.2f} GiB), replayed {seconds[1]:.3f} s (peak "
        f"{peaks[1]:.2f} GiB); bitwise equal to the eager sample: "
        f"{same}; launches a graphed request {launched}; the UNet's K1 "
        f"calls (B, Sq, Sk, H, D) in the eager request {census.calls} "
        f"[{smi}]")
    if not all(same):
        raise AssertionError("the graphed SD-1.5 request != its eager body")
    del sampler
    return {"eager_s": eager_s, "graphed_s": seconds[1],
            "launched": launched, "calls": census.calls}


@torch.no_grad()
def sd15_raw_request(spipe: TryOnPipeline, scond: Conditioner, tokenizer,
                     wrappers: dict, smi: str) -> dict:
    """A raw 2-image request through ``ConditionService`` (the SD-1.5
    text tower, an adapter to 16 x 768) then ``TryOnService(context_dim=
    768)``, after a warm-up request that captures both services' graphs;
    returns the kernels' launches over the request."""
    h, w = 512, 384
    cond = ConditionService(scond, tokenizer, batch_size=2,
                            num_vstar=NUM_VSTAR)
    service = TryOnService(spipe, batch_size=2, height=h, width=w,
                           num_inference_steps=50, guidance_scale=7.5,
                           context_dim=SD15_CTX, seed=0)
    rng = np.random.default_rng(150)
    t0 = time.perf_counter()
    answer(cond, service, raw_request(rng, 2, h, w), seed=150)
    log(f"phase 15: warm-up raw request (2 images) "
        f"{time.perf_counter() - t0:.3f} s, the captures of the "
        f"conditioning's and the sampler's graphs of it")
    raw = raw_request(rng, 2, h, w)
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    r = answer(cond, service, raw, seed=151)
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 15: raw SD-1.5 request of 2 images ({', '.join(raw['categories'])}"
        f") at {h}x{w}: conditioning {r['t_cond']:.3f} s, total "
        f"{r['total']:.3f} s (DDIM-50, CFG 7.5, batch 2), peak device "
        f"memory {peak:.2f} GiB, prompt embeds {r['embeds'].shape} std "
        f"{r['embeds'].std():.4f}, output in [{r['out'].min():.4f}, "
        f"{r['out'].max():.4f}] std {r['out'].std():.4f}; launches "
        f"{launches} [{smi}]")
    check_raw_output(r, 2, h, w, "the raw SD-1.5 request", ctx=SD15_CTX)
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the SD-1.5 path: "
                             f"{missing}")
    return launches


def sd15_train_step(vae: AutoencoderKL, scond: Conditioner, tokenizer,
                    smi: str) -> dict:
    """The eight-head VTO step at 512x384, batch 1 (the 31-channel SD-1.5
    UNet trained in fp32 from phase 15's seed; ``vae``, the SD-1.5 text
    tower and the adapter to 16 x 768 frozen in bf16) as a
    ``TrainProgram`` against its eager body over ``TRAIN_GRAPH_STEPS``
    steps, as phase 14's VTO batch 1 (``trajectories``): bitwise after
    every step, the launches of a replay confirmed by the profiler.
    Returns its numbers."""
    cuda = torch.device("cuda")
    text, adapter = scond.text_model, scond.adapter
    for m in (vae, text, adapter):
        m.requires_grad_(False)
    empty = torch.from_numpy(tokenizer([""])[0].astype(np.int64)).cuda()

    def make():
        unet = seeded(sd15_unet, SD15_SEEDS["unet"], "cuda")
        opt = make_optimizer(list(unet.parameters()), **TRAIN_GRAPH_LR)
        return {"modules": {"unet": unet}, "optimizer": opt,
                "step": make_vto_train_step(
                    optimizer=opt,
                    config=VTOStepConfig(num_vstar=NUM_VSTAR),
                    autocast=lambda: precision(cuda, BF16), unet=unet,
                    vae=vae, text_model=text, inversion_adapter=adapter,
                    empty_prompt_ids=empty)}

    inputs = train_graph_inputs(tokenizer, TRAIN_GRAPH_STEPS, 1, 1510,
                                vto_draws)
    with bitwise_training():
        r = trajectories("the SD-1.5 VTO step, eight heads, batch 1", make,
                         inputs, smi, profile=True, phase="phase 15")
    if not all(r["same"]):
        raise AssertionError("phase 15: the graphed SD-1.5 VTO step != its "
                             "eager body")
    return r


def sd15_path(gen: Gen, pipe: TryOnPipeline, towers: Conditioner,
              tokenizer, wrappers: dict, smi: str) -> dict:
    """Phase 15; returns the kernels' launches over its raw request
    (``sd15_launches``) and over one replay of its graphed train step
    (``sd15_train_launches``)."""
    t0 = time.perf_counter()
    spipe = sd15_pipeline(pipe)
    scond = sd15_conditioner(towers)
    check_sd15_blocks(gen, spipe, scond.text_model, tokenizer)
    sd15_graphed_request(spipe, smi)
    launches = sd15_raw_request(spipe, scond, tokenizer, wrappers, smi)
    del spipe
    gc.collect()
    torch.cuda.empty_cache()
    train = sd15_train_step(pipe.vae, scond, tokenizer, smi)
    del scond
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15: the SD-1.5 family at full width "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"sd15_launches": launches,
            "sd15_train_launches": {name: train["launched"][name]
                                    for name in wrappers}}


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
    parser.add_argument("--graphs-only", action="store_true",
                        help="phases 12, 13 and 14 alone (the sampler, the "
                        "conditioning and the train steps as CUDA graphs, "
                        "from freshly seeded modules), then exit without "
                        "the result lines")
    parser.add_argument("--distributed-only", action="store_true",
                        help="phase 2's tensor-parallel rows and phase 11 "
                        "alone (its files written from freshly seeded "
                        "modules), then exit without the result lines")
    parser.add_argument("--staged-only", action="store_true",
                        help="phases 11a and 11b alone (the data-parallel "
                        "and ZeRO-1 steps over two ranks and the NCCL "
                        "rank, graphed in two stages), then exit without "
                        "the result lines")
    parser.add_argument("--tp-pieces-only", action="store_true",
                        help="phase 11c's tensor-parallel denoise steps as "
                        "pieces and 11a's tiny towers over two batch "
                        "shapes alone (two ranks, from freshly seeded "
                        "modules), then exit without the result lines")
    parser.add_argument("--sd15-only", action="store_true",
                        help="phase 2's SD-1.5 K1 rows, K1's SD-1.5 "
                        "gradient rows and phase 15 alone (the SD-1.5 "
                        "family at full width, from freshly seeded "
                        "modules), then exit without the result lines")
    parser.add_argument("--k1-only", action="store_true",
                        help="phase 2's K1 rows (the SD-1.5 edges and the "
                        "tensor-parallel shapes too) and K1's SD-1.5 "
                        "gradient rows alone, then exit without the result "
                        "lines")
    parser.add_argument("--sweep-k1", action="store_true",
                        help="time K1 at the SD-1.5 rows under every "
                        "tiling its source compiles, then exit")
    parser.add_argument("--jpeg-only", action="store_true",
                        help="phase 7's JPEG decoder checks alone (no "
                        "kernel build), then exit without the result lines")
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
    print(smi, flush=True)  # as nvidia-smi gives it, on a line alone
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    if args.jpeg_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            jpeg_path(pathlib.Path(work), smi)
        return
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
    if args.sweep_k1:
        sweep_k1(gen_seed=0)
        return
    log(f"phase 1: kernels built from ladi_vton_tpu_torch/csrc in "
        f"{build_s:.2f} s, one nvcc per source in parallel (0 = already "
        f"built for these sources); ptxas report in "
        f"{build_dir / 'nvcc.log'}")

    gen = Gen(0)
    if args.graphs_only:
        pipe = full_width_pipeline()
        graphs_path(pipe, smi)
        torch.backends.cudnn.allow_tf32 = True  # as in run_phases
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            tokenizer = synthetic_tokenizer(pathlib.Path(work))
            towers = conditioner("cuda", (512, 384), tokenizer)
            condition_graphs_path(towers, tokenizer, smi)
            driver_programs(pipe, towers, tokenizer, smi)
            train_graphs_path(pipe, towers, tokenizer, pathlib.Path(work),
                              smi)
        return
    if args.k1_only:
        log_nvcc(build_dir, "flash_attention.cu")
        check_attention(gen)
        for shape in ATTN_TP_SHAPES + ATTN_SD15_TP_SHAPES:
            attention_row(gen, *shape)
        check_grad_rows({"flash_attention": attention_grad_rows(
            gen, ATTN_SD15_GRAD_SHAPES)})
        return
    if args.sd15_only:
        for shape in ATTN_SD15_SHAPES:
            attention_row(gen, *shape)
        sd15_edge_rows(gen)
        check_grad_rows({"flash_attention": attention_grad_rows(
            gen, ATTN_SD15_GRAD_SHAPES)})
        pipe = full_width_pipeline()
        torch.backends.cudnn.allow_tf32 = True  # as in run_phases
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            tokenizer = synthetic_tokenizer(pathlib.Path(work))
            towers = conditioner("cuda", (512, 384), tokenizer)
            wrappers = {name: wrapper for name, wrapper, _, _, _ in KERNELS}
            log(f"launches during phase 15: "
                f"{sd15_path(gen, pipe, towers, tokenizer, wrappers, smi)}")
        return
    if args.training_only:
        check_gradients(gen)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            training_only(pathlib.Path(work), smi)
        return
    if args.staged_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            staged_only(pathlib.Path(work), smi)
        return
    if args.tp_pieces_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            tp_pieces_only(pathlib.Path(work), smi)
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
    check_upsample(gen)
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
    """Phases 3 to 14, with the files they write under ``work``; returns
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
    graphs_path(pipe, smi)

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    towers = conditioner("cuda", (512, 384), tokenizer)
    condition_graphs_path(towers, tokenizer, smi)
    driver_programs(pipe, towers, tokenizer, smi)
    train_graphs_path(pipe, towers, tokenizer, work, smi)
    service = TryOnService(pipe, batch_size=2, height=512, width=384,
                           num_inference_steps=50, guidance_scale=7.5,
                           context_dim=1024, seed=0)
    # the census over the capture: a replay calls no forward hook
    census = GroupNormCensus(pipe.unet, pipe.vae, pipe.emasc)
    ln_census = LayerNormCensus(pipe.unet)
    t0 = time.perf_counter()
    with census, ln_census:
        service.warmup()
    torch.cuda.synchronize()
    log(f"phase 4: warmup request (2 images) {time.perf_counter() - t0:.3f} "
        f"s, the capture of the sampler's graphs "
        f"{sum(service.sampler.capture_seconds.values()):.3f} s of it "
        f"[{smi}]")
    rng = np.random.default_rng(0)
    wrappers = {name: wrapper for name, wrapper, _, _, _ in KERNELS}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    for n in (1, 2, 2):
        req = request(rng, n, 512, 384)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
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
    what = "the capture of a 2-image request (each call twice)"
    check_census(census, what)
    check_layer_norm_census(ln_census, what)
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")

    launches, cond, record = serve_raw_requests(service, wrappers,
                                                tokenizer, towers)
    log(f"launches during the two raw requests: {launches}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the raw-request "
                             f"path: {missing}")

    sd15 = sd15_path(gen, pipe, towers, tokenizer, wrappers, smi)
    log(f"launches during phase 15's raw SD-1.5 request: "
        f"{sd15['sd15_launches']}; in a replay of its graphed train step: "
        f"{sd15['sd15_train_launches']}")
    missing = [name for name, n in sd15["sd15_train_launches"].items()
               if not n]
    if missing:
        raise AssertionError(f"kernels never launched in phase 15's train "
                             f"step: {missing}")

    t0 = time.perf_counter()
    zoo_launches, zpipe, zcond = zoo_path(work, pipe, cond, record, wrappers)
    log(f"launches during phase 6's four raw requests: {zoo_launches}")
    missing = [name for name, count in zoo_launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the zoo path: "
                             f"{missing}")
    log(f"phase 6: the zoo path ({time.perf_counter() - t0:.1f} s)")

    jpeg_path(work, smi)
    mains_launches, roots = mains_path(work, zpipe, zcond, wrappers, smi)
    log(f"launches during phase 7's five CLI runs: {mains_launches}")

    t0 = time.perf_counter()
    serve_launches, raw, served_http = serving_path(work, zpipe, zcond,
                                                    wrappers, smi)
    serve_process(work, raw, served_http, smi)
    log(f"phase 8: serving ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    metrics_launches = metrics_path(work, roots, zcond, wrappers, smi)
    log(f"launches during phase 9's metric mains: {metrics_launches}")
    log(f"phase 9: the metrics ({time.perf_counter() - t0:.1f} s)")

    # phase 11's lane of ranks alone runs beside phase 10's mains, from
    # phase 6's and 7's files (its one-process answer taken here, between
    # the phases' launch counts)
    served = ServedLane(work, roots, work / "out" / "inference_vitonhd"
                        / "paired", smi).start()
    train_launches = training_path(work, zpipe, zcond, tokenizer, wrappers,
                                   smi)
    log(f"launches during phase 10's training runs: {train_launches}")

    # phase 11's other ranks need the card: this process lets go of its
    # modules, and of phase 10's checkpoints on disk
    del pipe, service, cond, towers, record, zpipe, zcond, raw, served_http
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work / "train", ignore_errors=True)
    dist_launches = distributed_path(
        work, {"vitonhd": work / "train_data" / "vh" / "vitonhd"}, tokenizer,
        checked, served, smi)
    log(f"launches during phase 11: {dist_launches}")
    return {"launches": launches, **sd15,
            "zoo_launches": zoo_launches,
            "mains_launches": mains_launches,
            "serve_launches": serve_launches,
            "metrics_launches": metrics_launches,
            "train_launches": train_launches,
            "dist_launches": dist_launches}


if __name__ == "__main__":
    main()
