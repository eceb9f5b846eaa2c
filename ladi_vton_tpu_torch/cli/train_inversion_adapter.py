"""Training CLI of the inversion adapter, on the port.

    python -m ladi_vton_tpu_torch.cli.train_inversion_adapter \\
        --dataset vitonhd --vitonhd_dataroot <root> --output_dir <dir> \\
        --sd2_model_dir <dir> --clip_vision_dir <dir>

Counterpart of ``ladi_vton_tpu/cli/train_inversion_adapter.py``, with
every flag of it and ``--device`` (as in ``cli.train_vto``).  The stock
9-channel SD-2-inpainting UNet, the VAE and the text encoder are frozen
in the ``--mixed_precision`` dtype; only the adapter trains (fp32, bf16
autocast), its gradient flowing back through the text encoder and the
UNet (checkpointed with ``--gradient_checkpointing``).  The prompt is the
category's with ``--num_vstar`` ``$`` tokens; the cloth's CLIP features
come from the feature cache (``--use_clip_cloth_features``) or the
vision tower.  As in the JAX step, the adapter runs without its dropout.
At each checkpoint boundary: ``inversion_adapter_{step}.pth`` in the
reference layout (with its sidecar), then validation images through the
plain inpainting pipeline (``pipelines.inpaint``) and their metrics where
the metric weights are present.  Checkpoints and resume as in
``cli.train_vto``, and so is training over ranks: data parallelism,
``--train_batch_size`` the global batch; rank 0 exports and validates.
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
    new_adapter,
    resume,
    score,
    test_loader,
    to_device,
    token_ids,
    train_loader,
    trainable_params,
)
from ladi_vton_tpu_torch.core.checkpoint import (
    CheckpointManager,
    export_module,
)
from ladi_vton_tpu_torch.core.dtypes import default_policy
from ladi_vton_tpu_torch.core.rng import set_seed
from ladi_vton_tpu_torch.diffusion.schedulers import DDIMScheduler
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.pipelines.condition import vision_program
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.core import distributed
from ladi_vton_tpu_torch.train.runner import (
    LoopConfig,
    make_trackers,
    run_checkpoint_validation,
    setup_logging,
    train_loop,
)
from ladi_vton_tpu_torch.train.steps import make_optimizer, precision
from ladi_vton_tpu_torch.train.tps_steps import (
    adapter_draws,
    make_inversion_adapter_train_step,
)
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Inversion adapter training script.")
    add_common_flags(p, max_train_steps=200001, checkpointing_steps=50000)
    p.add_argument("--enable_xformers_memory_efficient_attention",
                   action="store_true",
                   help="Accepted; the flash attention kernel is the "
                        "default on the card.")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--num_vstar", default=16, type=int)
    p.add_argument("--num_encoder_layers", default=1, type=int)
    p.add_argument("--use_clip_cloth_features", action="store_true")
    p.add_argument("--adapter_dropout", type=float, default=0.5)
    p.add_argument("--clip_vision_dir", type=str, required=False)
    p.add_argument("--tokenizer_dir", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the CLI; returns the last step trained."""
    args = parse_args(argv)
    device, mesh = setup_mesh(args, check_train_args(args))
    dtype = default_policy(args.mixed_precision)
    set_seed(args.seed)
    logger = setup_logging(args.output_dir)
    on = dict(dtype=dtype, device=device)
    autocast = lambda: precision(device, dtype)  # noqa: E731

    vae = zoo.sd2_vae(args.sd2_model_dir, **on).requires_grad_(False)
    text_model = zoo.sd2_text_encoder(args.sd2_model_dir,
                                      **on).requires_grad_(False)
    tokenizer = CLIPTokenizer.from_dir(
        args.tokenizer_dir or Path(args.sd2_model_dir) / "tokenizer")
    unet9 = zoo.sd2_unet(args.sd2_model_dir, in_channels=9,
                         **on).requires_grad_(False)
    unet9.gradient_checkpointing = args.gradient_checkpointing
    vision_cfg = zoo.clip_vision_config(args.clip_vision_dir)
    adapter = new_adapter(
        args, vision_cfg,
        text_model.text_model.final_layer_norm.weight.shape[0]).to(
            device).eval()
    vision = None
    if not args.use_clip_cloth_features:
        vision = zoo.clip_vit_h_vision(args.clip_vision_dir,
                                       **on).requires_grad_(False)

    outputlist = ["image", "im_mask", "inpaint_mask", "category",
                  "im_name", "cloth"]
    if args.use_clip_cloth_features:
        outputlist.append("clip_cloth_features")
    size = (args.height, args.width)
    loader = train_loader(args, build_dataset(args, "train", "paired",
                                              outputlist, size))
    modules = {"adapter": adapter}
    optimizer = make_optimizer(
        trainable_params(modules), args.learning_rate,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_eps=args.adam_epsilon, weight_decay=args.adam_weight_decay,
        max_grad_norm=args.max_grad_norm, warmup_steps=args.lr_warmup_steps,
        lr_scheduler=args.lr_scheduler, total_steps=args.max_train_steps,
        mesh=mesh)
    step_fn = make_inversion_adapter_train_step(
        optimizer=optimizer,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        mesh=mesh,
        autocast=autocast, unet9=unet9, vae=vae, text_model=text_model,
        inversion_adapter=adapter, num_vstar=args.num_vstar)

    ckpt = CheckpointManager(args.output_dir, keep=2,
                             async_save=args.async_checkpointing)
    start_step = resume(ckpt, args.resume_from_checkpoint, modules,
                        optimizer, logger)
    trackers = make_trackers(args.report_to, "LaDI_VTON_inversion_adapter",
                             args.output_dir, vars(args))

    # the vision tower as a program (the JAX main's jitted apply)
    vision_feats = (vision_program(vision, dtype) if vision is not None
                    else None)

    def to_batch(raw: dict) -> dict:
        batch = {k: to_device(raw[k], device)
                 for k in ("image", "im_mask", "inpaint_mask")}
        batch["input_ids"] = token_ids(
            tokenizer, category_prompts(raw["category"], args.num_vstar),
            device)
        if args.use_clip_cloth_features:
            feats = to_device(raw["clip_cloth_features"], device)
        else:
            with autocast():
                feats = vision_feats(to_device(raw["cloth"], device))
        batch["clip_cloth_features"] = feats.to(dtype)
        return batch

    def on_checkpoint(step: int) -> None:
        if not distributed.is_main_process():
            return
        export_module(adapter, Path(args.output_dir)
                      / f"inversion_adapter_{step}.pth", adapter.config)
        run_checkpoint_validation(lambda: validate(step), step, logger)

    def validate(step: int) -> None:
        from ladi_vton_tpu_torch.pipelines.inpaint import (
            InpaintPipeline,
            generate_images_inversion_adapter,
        )

        test = build_dataset(args, "test", args.test_order, outputlist, size)
        save_dir = os.path.join(args.output_dir, f"imgs_step_{step}",
                                args.test_order)
        pipe = InpaintPipeline(unet=unet9, vae=vae,
                               scheduler=DDIMScheduler())
        with autocast():
            generate_images_inversion_adapter(
                pipe, text_model, tokenizer, adapter, vision,
                test_loader(args, test), save_dir, num_vstar=args.num_vstar,
                seed=args.seed)
        score(args, save_dir, device, trackers, step, logger)

    final = train_loop(
        step_fn=step_fn, loader=loader, to_batch=to_batch, device=device,
        draws_fn=adapter_draws, ckpt_manager=ckpt,
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
