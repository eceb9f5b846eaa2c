"""End-to-end try-on inference CLI of the port (hub-weights path).

    python -m ladi_vton_tpu_torch.cli.inference --dataset dresscode \\
        --dresscode_dataroot <root> --test_order paired --output_dir <dir> \\
        --checkpoint_dir <dir of the .pth releases> --sd2_model_dir <dir> \\
        --clip_vision_dir <dir>

Counterpart of ``ladi_vton_tpu/cli/inference.py``, with every flag of
it (the reference's src/inference.py flags, plus the offline weight
routing ``--checkpoint_dir``, ``--sd2_model_dir``, ``--clip_vision_dir``,
``--tokenizer_dir``) and ``--device``.  Per batch of the test split:
the conditioning stage (``pipelines.condition.Conditioner.jit()``: TPS
warp at 256x192, grid sample and refinement at full size, CLIP ViT-H
features, inversion adapter, pseudo-word text encoding; one program for
the run, its CUDA graph captured at the first batch and replayed after),
then the try-on
(``TryOnPipeline.jit_sample(split=True, denoise_mode="host")``, built
once for the run through ``parallel.sharding.make_sampler``, its CUDA
graphs captured at the first batch and replayed after; DDIM-50 and CFG
7.5 by default), then the per-category save (``pipelines.drivers``).
Weights load through the port's zoo; the last batch is padded to the
batch size.

The run is on ``--device`` (``cuda`` by default; asking for it where
there is no card raises).  ``--allow_tf32`` sets cuBLAS's TF32 switch, as
the reference does; cuDNN's stays on, PyTorch's default.  The flash
attention kernel is the default on the card, so
``--enable_xformers_memory_efficient_attention`` changes nothing.

Over ranks (``python -m torch.distributed.run --nproc_per_node N -m
ladi_vton_tpu_torch.cli.inference ...``) the ranks form a data x model
mesh (``core.mesh``, ``model`` = ``--tensor_parallel``): ``--batch_size``
is rounded up to a multiple of ``data``, each data rank conditions,
samples and saves its rows of every batch with its rows of the global
batch's noise, and model rank 0 writes; ``--tensor_parallel N`` splits
the UNet's attentions and feed-forwards over ``model``
(``parallel.tp``), and the sampler's denoise step is then captured in
pieces, with the ``all_reduce``s over ``model`` run eagerly between
them (``pipelines.graphs.Graph``).  ``--dist_backend`` is NCCL on
the card and gloo on the CPU.  ``--compute_metrics`` scores the saved
images once the saver has flushed (``metrics.compute.compute_metrics``
on ``--device``, weights from ``$LADI_VTON_METRIC_WEIGHTS``) and writes
``metrics_<order>_<category>.json`` into the save directory, as the JAX
main does.  A batch's noise comes from a generator seeded with
``request_seed(--seed, batch index)``, not the JAX ``fold_in`` stream.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ladi_vton_tpu_torch.core import distributed
from ladi_vton_tpu_torch.core.dtypes import default_policy, resolve_device
from ladi_vton_tpu_torch.core.mesh import MeshSpec, make_mesh
from ladi_vton_tpu_torch.core.rng import set_seed
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
)
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.pipelines.condition import Conditioner
from ladi_vton_tpu_torch.parallel.sharding import (
    local_batch,
    make_sampler,
    sample_draws,
)
from ladi_vton_tpu_torch.parallel.tp import unet_tp
from ladi_vton_tpu_torch.pipelines.drivers import run_batches
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer

SCHEDULERS = ["ddim", "pndm", "lms", "dpm"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Full inference script")
    parser.add_argument("--pretrained_model_name_or_path", type=str,
                        default="stabilityai/stable-diffusion-2-inpainting",
                        help="Kept for flag parity; weights load from "
                             "--sd2_model_dir.")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--allow_tf32", action="store_true",
                        help="Allow TF32 in cuBLAS matmuls.")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=["no", "fp16", "bf16"])
    parser.add_argument("--enable_xformers_memory_efficient_attention",
                        action="store_true",
                        help="Accepted; the flash attention kernel is the "
                             "default on the card.")
    parser.add_argument("--dresscode_dataroot", type=str)
    parser.add_argument("--vitonhd_dataroot", type=str)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--num_vstar", default=16, type=int)
    parser.add_argument("--test_order", type=str, required=True,
                        choices=["unpaired", "paired"])
    parser.add_argument("--dataset", type=str, required=True,
                        choices=["dresscode", "vitonhd"])
    parser.add_argument("--category", type=str, default="all",
                        choices=["all", "lower_body", "upper_body",
                                 "dresses"])
    parser.add_argument("--use_png", default=False, action="store_true")
    parser.add_argument("--num_inference_steps", default=50, type=int)
    parser.add_argument("--scheduler", type=str, default="ddim",
                        choices=SCHEDULERS,
                        help="Sampler; 'dpm' (DPM-Solver++ 2M) pairs with "
                             "--num_inference_steps 20.")
    parser.add_argument("--guidance_scale", default=7.5, type=float)
    parser.add_argument("--compute_metrics", default=False,
                        action="store_true",
                        help="Score the saved images (FID, KID, IS, SSIM, "
                             "LPIPS) and write metrics_<order>_<category>"
                             ".json beside them.")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="Directory with {unet,emasc,inversion_adapter,"
                             "warping}_<dataset>.pth")
    parser.add_argument("--sd2_model_dir", type=str, required=False,
                        help="Local SD-2-inpainting model directory "
                             "(vae/, text_encoder/, tokenizer/)")
    parser.add_argument("--clip_vision_dir", type=str, required=False,
                        help="Local CLIP-ViT-H-14 model directory")
    parser.add_argument("--tokenizer_dir", type=str, default=None,
                        help="Directory with vocab.json + merges.txt "
                             "(defaults to <sd2_model_dir>/tokenizer)")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="Ranks of the model axis the UNet's "
                             "attentions and feed-forwards split over.")
    parser.add_argument("--height", type=int, default=512,
                        help="Generation height (the reference fixes "
                             "512; must be divisible by 64)")
    parser.add_argument("--width", type=int, default=384,
                        help="Generation width (reference fixes 384)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Where the models run: cuda (default) or cpu.")
    add_dist_flag(parser)
    return parser.parse_args(argv)


def add_dist_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dist_backend", type=str, default=None,
                        choices=list(distributed.BACKENDS),
                        help="Process-group backend over ranks: nccl on "
                             "cuda and gloo on cpu by default; gloo lets "
                             "ranks share cards.")


def check_args(args) -> torch.device:
    """Refuse what the port cannot do, before any work; the device."""
    if args.dataset == "vitonhd" and args.vitonhd_dataroot is None:
        raise ValueError("VitonHD dataroot must be provided")
    if args.dataset == "dresscode" and args.dresscode_dataroot is None:
        raise ValueError("DressCode dataroot must be provided")
    device = resolve_device(args.device)
    if args.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
    return device


def setup_mesh(args, device: torch.device) -> tuple:
    """Join the ranks' process group where the launcher started several,
    lay them out as the data x model mesh and round ``--batch_size`` up to
    a multiple of ``data`` (the JAX main's rule); (device, mesh)."""
    distributed.initialize(backend=args.dist_backend, device=device)
    device = distributed.local_device(device)
    mesh = make_mesh(MeshSpec(model=args.tensor_parallel))
    args.batch_size = -(-args.batch_size // mesh.data) * mesh.data
    return device, mesh


def finish(args, save_dir: str, device: torch.device) -> None:
    """After every rank has saved: ``--compute_metrics`` on rank 0."""
    distributed.barrier()
    if args.compute_metrics and distributed.is_main_process():
        score_saved(args, save_dir, device)
    distributed.barrier()


def tokenizer_dir(args) -> Path:
    return Path(args.tokenizer_dir or Path(args.sd2_model_dir) / "tokenizer")


def score_saved(args, save_dir: str, device: torch.device) -> None:
    """``--compute_metrics``: the JAX mains' metrics JSON of the saved
    images (cli/inference.py:237-248 there)."""
    from ladi_vton_tpu_torch.cli.val_metrics import write_metrics
    from ladi_vton_tpu_torch.metrics.compute import compute_metrics

    metrics = compute_metrics(save_dir, args.test_order, args.dataset,
                              args.category, ["all"],
                              args.dresscode_dataroot,
                              args.vitonhd_dataroot, device=device)
    write_metrics(metrics, save_dir, args.test_order, args.category)


def make_loader(dataset, args) -> BatchLoader:
    return BatchLoader(dataset, args.batch_size,
                       num_workers=args.num_workers, pad_last=True)


def main(argv=None) -> dict:
    """Run the CLI; returns ``drivers.run_batches``' numbers."""
    args = parse_args(argv)
    device, mesh = setup_mesh(args, check_args(args))
    dtype = default_policy(args.mixed_precision or "bf16")
    set_seed(args.seed)
    size = (args.height, args.width)
    on = dict(dtype=dtype, device=device)
    ckpt = dict(checkpoint_dir=args.checkpoint_dir)

    # --- towers, through the port's zoo
    tps, refinement = zoo.warping_module(args.dataset, device=device, **ckpt)
    tokenizer = CLIPTokenizer.from_dir(tokenizer_dir(args))
    empty_ids = torch.from_numpy(
        np.asarray(tokenizer([""]))[0].astype(np.int64))
    # the conditioning program, captured at the first batch, as the JAX
    # main jits ``build_condition_fn``
    condition = Conditioner(
        tps=tps, refinement=refinement,
        vision=zoo.clip_vit_h_vision(args.clip_vision_dir, **on),
        adapter=zoo.inversion_adapter(args.dataset, **ckpt, **on),
        text_model=zoo.sd2_text_encoder(args.sd2_model_dir, **on),
        num_vstar=args.num_vstar, empty_ids=empty_ids.to(device),
        image_size=size).jit()
    pipe = TryOnPipeline(
        unet=unet_tp(zoo.extended_unet(args.dataset, **ckpt, **on), mesh),
        vae=zoo.sd2_vae(args.sd2_model_dir, **on),
        emasc=zoo.emasc(args.dataset, **ckpt, **on),
        scheduler=make_scheduler(args.scheduler))

    # --- dataset
    categories = ([args.category] if args.category != "all"
                  else ["dresses", "upper_body", "lower_body"])
    outputlist = ["image", "pose_map", "inpaint_mask", "im_mask",
                  "category", "im_name", "cloth"]
    if args.dataset == "dresscode":
        dataset = DressCodeDataset(args.dresscode_dataroot, phase="test",
                                   order=args.test_order, radius=5,
                                   outputlist=outputlist,
                                   category=categories, size=size)
    else:
        dataset = VitonHDDataset(args.vitonhd_dataroot, phase="test",
                                 order=args.test_order, radius=5,
                                 outputlist=outputlist, size=size)

    def to(x, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    sampler = make_sampler(pipe, mesh,
                           num_inference_steps=args.num_inference_steps,
                           guidance_scale=args.guidance_scale)

    def step_fn(step: int, batch: dict) -> torch.Tensor:
        batch, total = local_batch(mesh, batch)
        input_ids = to(np.asarray(tokenizer(category_prompts(
            batch["category"], args.num_vstar))), torch.long)
        pose_map = to(batch["pose_map"])
        warped, ehs, neg = condition(pose_map, to(batch["cloth"]),
                                     to(batch["im_mask"]), input_ids)
        return sampler(
            to(batch["image"]), to(batch["inpaint_mask"]), pose_map, warped,
            ehs, neg,
            noise=sample_draws(mesh, args.seed, step, device, total, *size))

    save_dir = os.path.join(args.output_dir, args.test_order)
    stats = run_batches(make_loader(dataset, args), step_fn, save_dir,
                        use_png=args.use_png, what="inference", mesh=mesh)
    finish(args, save_dir, device)
    return stats


if __name__ == "__main__":
    main()
