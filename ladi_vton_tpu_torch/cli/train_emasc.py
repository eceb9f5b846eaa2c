"""Training CLI of the EMASC adapters (VAE frozen), on the port.

    python -m ladi_vton_tpu_torch.cli.train_emasc --dataset vitonhd \\
        --vitonhd_dataroot <root> --output_dir <dir> --sd2_model_dir <dir> \\
        --vgg_weights <torchvision vgg19 .pth>

Counterpart of ``ladi_vton_tpu/cli/train_emasc.py``, with every flag of
it and ``--device`` (as in ``cli.train_vto``).  The loss
is L1(recon, image) + ``--vgg_weight`` * VGG (``train.steps
make_emasc_loss``); the VGG19 features load from ``--vgg_weights``, a
torchvision state dict (random ones, seeded, without it: a smoke run
only).  EMASC trains in fp32 under bf16 autocast; its channel plan comes
from the loaded VAE, and its padding must be ``kernel // 2``.  At each
checkpoint boundary: ``emasc_{step}.pth`` in the reference layout (with
its sidecar), then the VAE + EMASC reconstructions of the test split
(``drivers.extract_save_vae_images``) and their metrics where the metric
weights are present.  Checkpoints and resume as in ``cli.train_vto``, and
so is training over ranks: data parallelism, ``--train_batch_size`` the
global batch; rank 0 exports and validates.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

from ladi_vton_tpu_torch.cli.train_vto import (
    add_common_flags,
    build_dataset,
    check_train_args,
    setup_mesh,
    checkpoint_state,
    resume,
    score,
    test_loader,
    to_device,
    train_loader,
    trainable_params,
)
from ladi_vton_tpu_torch.core.checkpoint import (
    CheckpointManager,
    export_module,
)
from ladi_vton_tpu_torch.core.dtypes import default_policy
from ladi_vton_tpu_torch.core.rng import set_seed
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models.emasc import EMASC, emasc_channels
from ladi_vton_tpu_torch.models.vgg import VGG19Features, load_vgg19
from ladi_vton_tpu_torch.core import distributed
from ladi_vton_tpu_torch.train.runner import (
    LoopConfig,
    make_trackers,
    run_checkpoint_validation,
    setup_logging,
    train_loop,
)
from ladi_vton_tpu_torch.train.steps import (
    emasc_draws,
    make_emasc_train_step,
    make_optimizer,
    precision,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EMASC training script.")
    add_common_flags(p, max_train_steps=40001, checkpointing_steps=10000)
    p.add_argument("--emasc_type", type=str, default="nonlinear",
                   choices=["linear", "nonlinear"])
    p.add_argument("--emasc_kernel", type=int, default=3)
    p.add_argument("--emasc_padding", type=int, default=1)
    p.add_argument("--vgg_weight", type=float, default=0.5)
    p.add_argument("--vgg_weights", type=str, default=None,
                   help="torchvision vgg19 .pth for the perceptual loss")
    return p.parse_args(argv)


def vgg_tower(path, seed: int, device, logger) -> VGG19Features:
    """The loss's VGG19: from a torchvision ``.pth``, else seeded random
    weights (smoke runs only); fp32, frozen."""
    if path:
        return load_vgg19(path, device)
    logger.info("no --vgg_weights given: the perceptual loss uses random "
                "VGG features (smoke runs only)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        vgg = VGG19Features()
    return vgg.to(device).eval().requires_grad_(False)


def main(argv=None) -> int:
    """Run the CLI; returns the last step trained."""
    args = parse_args(argv)
    device, mesh = setup_mesh(args, check_train_args(args))
    if args.emasc_padding != args.emasc_kernel // 2:
        raise ValueError(
            "the port derives EMASC padding as kernel//2 (shape-"
            f"preserving); got kernel={args.emasc_kernel} "
            f"padding={args.emasc_padding}")
    dtype = default_policy(args.mixed_precision)
    set_seed(args.seed)
    logger = setup_logging(args.output_dir)

    vae = zoo.sd2_vae(args.sd2_model_dir, dtype=dtype,
                      device=device).requires_grad_(False)
    in_ch, out_ch = emasc_channels(vae.config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        emasc = EMASC(in_ch, out_ch, kernel_size=args.emasc_kernel,
                      kind=args.emasc_type)
    emasc = emasc.to(device).eval()
    vgg = vgg_tower(args.vgg_weights, 0, device, logger)

    outputlist = ("image", "im_mask", "inpaint_mask", "im_name", "category")
    size = (args.height, args.width)
    loader = train_loader(args, build_dataset(args, "train", "paired",
                                              outputlist, size))
    modules = {"emasc": emasc}
    optimizer = make_optimizer(
        trainable_params(modules), args.learning_rate,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_eps=args.adam_epsilon, weight_decay=args.adam_weight_decay,
        max_grad_norm=args.max_grad_norm, warmup_steps=args.lr_warmup_steps,
        lr_scheduler=args.lr_scheduler, total_steps=args.max_train_steps,
        mesh=mesh)
    step_fn = make_emasc_train_step(
        optimizer=optimizer,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        mesh=mesh,
        autocast=lambda: precision(device, dtype), vae=vae, emasc=emasc,
        vgg=vgg, vgg_weight=args.vgg_weight)

    ckpt = CheckpointManager(args.output_dir, keep=2,
                             async_save=args.async_checkpointing)
    start_step = resume(ckpt, args.resume_from_checkpoint, modules,
                        optimizer, logger)
    trackers = make_trackers(args.report_to, "LaDI_VTON_Emasc",
                             args.output_dir, vars(args))

    def to_batch(raw: dict) -> dict:
        return {k: to_device(raw[k], device)
                for k in ("image", "im_mask", "inpaint_mask")}

    def on_checkpoint(step: int) -> None:
        if not distributed.is_main_process():
            return
        export_module(emasc, Path(args.output_dir) / f"emasc_{step}.pth",
                      {"in_channels": list(in_ch),
                       "out_channels": list(out_ch)})
        run_checkpoint_validation(lambda: validate(step), step, logger)

    def validate(step: int) -> None:
        from ladi_vton_tpu_torch.pipelines.drivers import (
            extract_save_vae_images,
        )

        test = build_dataset(args, "test", args.test_order, outputlist, size)
        save_dir = os.path.join(args.output_dir, f"imgs_step_{step}",
                                args.test_order)
        with precision(device, dtype):
            extract_save_vae_images(vae, emasc, test_loader(args, test),
                                    save_dir, seed=args.seed)
        score(args, save_dir, device, trackers, step, logger)

    final = train_loop(
        step_fn=step_fn, loader=loader, to_batch=to_batch, device=device,
        draws_fn=emasc_draws, ckpt_manager=ckpt,
        state_fn=lambda step: checkpoint_state(step, modules, optimizer),
        loop=LoopConfig(max_train_steps=args.max_train_steps,
                        checkpointing_steps=args.checkpointing_steps,
                        seed=args.seed),
        logger=logger, trackers=trackers, start_step=start_step,
        on_checkpoint=on_checkpoint, mesh=mesh)
    trackers.finish()
    logger.info(f"done at step {final}")
    return final


if __name__ == "__main__":
    main()
