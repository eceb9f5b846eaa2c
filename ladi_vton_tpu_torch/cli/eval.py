"""Evaluation CLI of the port: try-on generation with local checkpoints.

    python -m ladi_vton_tpu_torch.cli.eval --dataset vitonhd \\
        --vitonhd_dataroot <root> --test_order paired --output_dir <dir> \\
        --save_name <name> --unet_dir <dir> --emasc_dir <dir> \\
        --inversion_adapter_dir <dir> --sd2_model_dir <dir> \\
        --use_clip_cloth_features

Counterpart of ``ladi_vton_tpu/cli/eval.py``, with every flag of it (the
reference's src/eval.py flags) and ``--device``.  Checkpoints resolve by
name, ``latest`` being the highest ``<prefix>_<step>.pth``; EMASC may be
absent (``--emasc_type none``) and its padding must be ``kernel // 2``;
the warped cloths come from the dataset's cache (``--cloth_input_type
warped``), the cloth's CLIP features from the feature cache with
``--use_clip_cloth_features`` (else from the vision tower), and the
batches run through ``pipelines.drivers.generate_images_from_tryon_pipe``.
``--device``, ``--allow_tf32``, ``--compute_metrics``,
``--tensor_parallel``, ``--dist_backend`` and the ranks' mesh behave as
in ``cli.inference``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ladi_vton_tpu_torch.cli.inference import (
    SCHEDULERS,
    add_dist_flag,
    check_args,
    finish,
    make_loader,
    setup_mesh,
    tokenizer_dir,
)
from ladi_vton_tpu_torch.core.dtypes import default_policy
from ladi_vton_tpu_torch.core.rng import set_seed
from ladi_vton_tpu_torch.data import DressCodeDataset, VitonHDDataset
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.parallel.tp import unet_tp
from ladi_vton_tpu_torch.pipelines.drivers import (
    generate_images_from_tryon_pipe,
)
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Eval with local checkpoints")
    p.add_argument("--dataset", type=str, required=True,
                   choices=["dresscode", "vitonhd"])
    p.add_argument("--dresscode_dataroot", type=str)
    p.add_argument("--vitonhd_dataroot", type=str)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--save_name", type=str, required=True)
    p.add_argument("--test_order", type=str, required=True,
                   choices=["unpaired", "paired"])
    p.add_argument("--unet_dir", required=True, type=str)
    p.add_argument("--unet_name", type=str, default="latest")
    p.add_argument("--inversion_adapter_dir", type=str, default=None)
    p.add_argument("--inversion_adapter_name", type=str, default="latest")
    p.add_argument("--emasc_dir", type=str, default=None)
    p.add_argument("--emasc_name", type=str, default="latest")
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="stabilityai/stable-diffusion-2-inpainting")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--allow_tf32", action="store_true",
                   help="Allow TF32 in cuBLAS matmuls.")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"])
    p.add_argument("--enable_xformers_memory_efficient_attention",
                   action="store_true",
                   help="Accepted; the flash attention kernel is the "
                        "default on the card.")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--category", type=str, default="all",
                   choices=["all", "lower_body", "upper_body", "dresses"])
    p.add_argument("--emasc_type", type=str, default="nonlinear",
                   choices=["none", "linear", "nonlinear"])
    p.add_argument("--emasc_kernel", type=int, default=3)
    p.add_argument("--emasc_padding", type=int, default=1)
    p.add_argument("--text_usage", type=str, default="inversion_adapter",
                   choices=["none", "noun_chunks", "inversion_adapter"])
    p.add_argument("--cloth_input_type", type=str,
                   choices=["warped", "none"], default="warped")
    p.add_argument("--num_vstar", default=16, type=int)
    p.add_argument("--num_encoder_layers", default=1, type=int)
    p.add_argument("--use_png", default=False, action="store_true")
    p.add_argument("--num_inference_steps", default=50, type=int)
    p.add_argument("--scheduler", type=str, default="ddim",
                   choices=SCHEDULERS,
                   help="Sampler; 'dpm' (DPM-Solver++ 2M) pairs with "
                        "--num_inference_steps 20.")
    p.add_argument("--guidance_scale", default=7.5, type=float)
    p.add_argument("--use_clip_cloth_features", action="store_true")
    p.add_argument("--compute_metrics", default=False, action="store_true",
                   help="Score the saved images and write metrics_<order>_"
                        "<category>.json beside them.")
    p.add_argument("--sd2_model_dir", type=str, required=False)
    p.add_argument("--clip_vision_dir", type=str, required=False)
    p.add_argument("--tokenizer_dir", type=str, default=None)
    p.add_argument("--caption_file", type=str, default=None)
    p.add_argument("--height", type=int, default=512,
                   help="Generation height (the reference fixes 512)")
    p.add_argument("--width", type=int, default=384,
                   help="Generation width (reference fixes 384)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="Ranks of the model axis the UNet's attentions and "
                        "feed-forwards split over.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the models run: cuda (default) or cpu.")
    add_dist_flag(p)
    return p.parse_args(argv)


def _latest_pth(directory: str, prefix: str, name: str) -> str:
    """Resolve 'latest' to the highest-step ``{prefix}_{step}.pth``
    (reference src/eval.py checkpoint-name resolution)."""
    if name != "latest":
        return str(Path(directory) / name)
    candidates = sorted(
        Path(directory).glob(f"{prefix}_*.pth"),
        key=lambda p: int(p.stem.split("_")[-1])
        if p.stem.split("_")[-1].isdigit() else -1)
    if not candidates:
        raise FileNotFoundError(f"no {prefix}_*.pth under {directory}")
    return str(candidates[-1])


def build_dataset(args, phase: str, order: str, outputlist, size=(512, 384)):
    """The JAX package's ``cli/train_vto.py build_dataset``."""
    if args.dataset == "dresscode":
        return DressCodeDataset(args.dresscode_dataroot, phase=phase,
                                order=order, outputlist=outputlist,
                                caption_file=args.caption_file, size=size)
    return VitonHDDataset(args.vitonhd_dataroot, phase=phase, order=order,
                          outputlist=outputlist,
                          caption_file=args.caption_file, size=size)


def main(argv=None) -> dict:
    """Run the CLI; returns ``drivers.run_batches``' numbers."""
    args = parse_args(argv)
    device, mesh = setup_mesh(args, check_args(args))
    if args.emasc_type != "none" and args.emasc_dir and (
            args.emasc_padding != args.emasc_kernel // 2):
        raise ValueError(
            "the port derives EMASC padding as kernel//2 (shape-"
            f"preserving); got kernel={args.emasc_kernel} "
            f"padding={args.emasc_padding}")
    set_seed(args.seed)
    on = dict(dtype=default_policy(args.mixed_precision), device=device)
    unet = zoo.extended_unet(
        args.dataset,
        checkpoint=_latest_pth(args.unet_dir, "unet", args.unet_name), **on)
    unet_tp(unet, mesh)
    text_model = zoo.sd2_text_encoder(args.sd2_model_dir, **on)
    tokenizer = CLIPTokenizer.from_dir(tokenizer_dir(args))

    emasc = None
    if args.emasc_type != "none" and args.emasc_dir:
        emasc = zoo.emasc(
            args.dataset,
            checkpoint=_latest_pth(args.emasc_dir, "emasc", args.emasc_name),
            kind=args.emasc_type, kernel_size=args.emasc_kernel, **on)

    adapter = vision = None
    if args.text_usage == "inversion_adapter":
        adapter = zoo.inversion_adapter(
            args.dataset,
            checkpoint=_latest_pth(args.inversion_adapter_dir,
                                   "inversion_adapter",
                                   args.inversion_adapter_name),
            num_encoder_layers=args.num_encoder_layers,
            num_vstar=args.num_vstar, **on)
        if not args.use_clip_cloth_features:
            vision = zoo.clip_vit_h_vision(args.clip_vision_dir, **on)

    pipe = TryOnPipeline(unet=unet, vae=zoo.sd2_vae(args.sd2_model_dir, **on),
                         emasc=emasc,
                         scheduler=make_scheduler(args.scheduler))

    outputlist = ["image", "pose_map", "inpaint_mask", "im_mask",
                  "category", "im_name", "cloth"]
    if args.cloth_input_type == "warped":
        outputlist.append("warped_cloth")
    if args.text_usage == "noun_chunks":
        outputlist.append("captions")
    if args.use_clip_cloth_features:
        outputlist.append("clip_cloth_features")
    size = (args.height, args.width)
    if args.dataset == "dresscode":
        cats = (("dresses", "upper_body", "lower_body")
                if args.category == "all" else (args.category,))
        dataset = DressCodeDataset(
            args.dresscode_dataroot, phase="test", order=args.test_order,
            outputlist=tuple(outputlist), category=cats,
            caption_file=args.caption_file, size=size)
    else:
        dataset = build_dataset(args, "test", args.test_order,
                                tuple(outputlist), size=size)

    save_dir = os.path.join(args.output_dir, args.save_name, args.test_order)
    stats = generate_images_from_tryon_pipe(
        pipe, text_model, tokenizer, make_loader(dataset, args), save_dir,
        inversion_adapter=adapter, vision=vision,
        text_usage=args.text_usage, num_vstar=args.num_vstar,
        seed=args.seed, num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, use_png=args.use_png,
        cloth_input_type=args.cloth_input_type, mesh=mesh)
    finish(args, save_dir, device)
    return stats


if __name__ == "__main__":
    main()
