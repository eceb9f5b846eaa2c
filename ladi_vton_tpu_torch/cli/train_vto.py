"""Training CLI of the extended 31-channel UNet (and, optionally, the
inversion adapter), on the port.

    python -m ladi_vton_tpu_torch.cli.train_vto --dataset vitonhd \\
        --vitonhd_dataroot <root> --output_dir <dir> --sd2_model_dir <dir> \\
        --clip_vision_dir <dir> --inversion_adapter_dir <dir>

Counterpart of ``ladi_vton_tpu/cli/train_vto.py``, with every flag of it
and ``--device`` (``cuda`` by default; asking for it where there is no
card raises).  The UNet is the SD-2-inpainting one with its conv_in
widened to 31 channels (27 without cloth) by the zoo;
the VAE, the text encoder and the vision tower are frozen, in the
``--mixed_precision`` dtype; the trained towers keep fp32 parameters and
the step runs under bf16 autocast (``train.steps``).  ``--mixed_precision
no`` is fp32 on the CPU and refused on the card, whose kernels take bf16
only.  ``--gradient_checkpointing`` checkpoints the UNet's blocks.
Checkpoints (``checkpoint-{step}/``, the port's format, last two kept)
every ``--checkpointing_steps`` and at the end; at each boundary the
``unet_{step}.pth`` (and ``inversion_adapter_{step}.pth``) exports in the
reference layout with ``.config.json`` sidecars, then validation images
through ``TryOnPipeline`` (DDIM) and their metrics where the metric
weights are present.  ``--resume_from_checkpoint latest`` (or a step)
continues where the run stopped, with the same batches and draws.

Over ranks (``python -m torch.distributed.run --nproc_per_node N -m
ladi_vton_tpu_torch.cli.train_vto ...``) the ranks form a data x model
mesh (``core.mesh``; ``model`` = ``--tensor_parallel``, ``data`` the
rest): ``--train_batch_size`` is the global batch and must divide by
``data``; each rank trains on its rows and the gradients are averaged
over ``data`` (``train.steps``).  ``--shard_optimizer_states`` shards the
AdamW state over ``data`` (ZeRO-1); ``--tensor_parallel N`` splits the
UNet's attentions and feed-forwards over ``model`` (``parallel.tp``); the
two are mutually exclusive, as in the JAX main.  Rank 0 writes the
checkpoints (consolidated), the exports (the reference layout, gathered
under tensor parallelism), the logs and the validation images, which the
first model group samples.  ``--dist_backend`` is NCCL on the card and
gloo on the CPU; gloo also lets more ranks than cards share them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.core.checkpoint import (
    CheckpointManager,
    export_module,
    rng_state,
    set_rng_state,
)
from ladi_vton_tpu_torch.core import distributed
from ladi_vton_tpu_torch.core.dtypes import default_policy, resolve_device
from ladi_vton_tpu_torch.core.mesh import Mesh, MeshSpec, make_mesh
from ladi_vton_tpu_torch.core.rng import set_seed
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
)
from ladi_vton_tpu_torch.diffusion.schedulers import DDIMScheduler
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.pipelines.condition import vision_program
from ladi_vton_tpu_torch.pipelines.drivers import _to as to_device
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.parallel import tp as tensor_parallel
from ladi_vton_tpu_torch.train.runner import (
    LoopConfig,
    make_trackers,
    run_checkpoint_validation,
    setup_logging,
    train_loop,
)
from ladi_vton_tpu_torch.train.steps import (
    VTOStepConfig,
    make_optimizer,
    make_vto_train_step,
    precision,
    vto_draws,
)
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer

BF16_KERNELS = ("K1 flash attention, K2/K3 GroupNorm, K4 GEGLU and K5 "
                "LayerNorm")


def add_common_flags(p: argparse.ArgumentParser, *, max_train_steps: int,
                     checkpointing_steps: int) -> None:
    """The flags the three diffusion trainers share, with the JAX mains'
    defaults, and the port's ``--device``."""
    p.add_argument("--dataset", type=str, required=True,
                   choices=["dresscode", "vitonhd"])
    p.add_argument("--dresscode_dataroot", type=str)
    p.add_argument("--vitonhd_dataroot", type=str)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="stabilityai/stable-diffusion-2-inpainting",
                   help="Kept for flag parity; weights load from "
                        "--sd2_model_dir.")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--test_batch_size", type=int, default=16)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=max_train_steps)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--lr_scheduler", type=str,
                   default="constant_with_warmup")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--allow_tf32", action="store_true")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-08)
    p.add_argument("--max_grad_norm", default=1.0, type=float)
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"])
    p.add_argument("--report_to", type=str, default="wandb")
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--checkpointing_steps", type=int,
                   default=checkpointing_steps)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--async_checkpointing", action="store_true",
                   help="write checkpoints on a background thread")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--num_workers_test", type=int, default=8)
    p.add_argument("--test_order", type=str, default="unpaired",
                   choices=["unpaired", "paired"])
    p.add_argument("--sd2_model_dir", type=str, required=False)
    p.add_argument("--caption_file", type=str, default=None)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--device", type=str, default="cuda",
                   help="Where training runs: cuda (default) or cpu.")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=list(distributed.BACKENDS),
                   help="Process-group backend over ranks: nccl on cuda "
                        "and gloo on cpu by default; gloo lets ranks share "
                        "cards.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="VTO training script.")
    add_common_flags(p, max_train_steps=200001, checkpointing_steps=50000)
    p.add_argument("--inversion_adapter_dir", type=str, default=None)
    p.add_argument("--inversion_adapter_name", type=str, default="latest")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--enable_xformers_memory_efficient_attention",
                   action="store_true",
                   help="Accepted; the flash attention kernel is the "
                        "default on the card.")
    p.add_argument("--uncond_fraction", type=float, default=0.2)
    p.add_argument("--text_usage", type=str, default="inversion_adapter",
                   choices=["none", "noun_chunks", "inversion_adapter"])
    p.add_argument("--cloth_input_type", type=str,
                   choices=["warped", "none"], default="warped")
    p.add_argument("--num_vstar", default=16, type=int)
    p.add_argument("--num_encoder_layers", default=1, type=int)
    p.add_argument("--train_inversion_adapter", action="store_true")
    p.add_argument("--use_clip_cloth_features", action="store_true")
    p.add_argument("--clip_vision_dir", type=str, required=False)
    p.add_argument("--tokenizer_dir", type=str, default=None)
    p.add_argument("--shard_optimizer_states", action="store_true",
                   help="ZeRO-1: shard the AdamW state over the data axis.")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="Ranks of the model axis the UNet's attentions and "
                        "feed-forwards split over.")
    return p.parse_args(argv)


def check_train_args(args) -> torch.device:
    """Refuse what the port cannot do, before any work; the device."""
    if args.dataset == "vitonhd" and args.vitonhd_dataroot is None:
        raise ValueError("VitonHD dataroot must be provided")
    if args.dataset == "dresscode" and args.dresscode_dataroot is None:
        raise ValueError("DressCode dataroot must be provided")
    if (getattr(args, "tensor_parallel", 1) > 1
            and getattr(args, "shard_optimizer_states", False)):
        raise ValueError(
            "--shard_optimizer_states (ZeRO-1 over the data axis) and "
            "--tensor_parallel are mutually exclusive: under TP the "
            "Adam moments already shard over the model axis with their "
            "parameters (parallel/tp.py)")
    device = resolve_device(args.device)
    if (device.type == "cuda"
            and default_policy(args.mixed_precision) == torch.float32):
        raise ValueError(
            f"--mixed_precision {args.mixed_precision} on {device}: the "
            f"port's kernels ({BF16_KERNELS}) take bf16 only; train with "
            f"--mixed_precision bf16 on the card, or fp32 on --device cpu")
    if args.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
    return device


def setup_mesh(args, device: torch.device) -> tuple:
    """Join the ranks' process group where the launcher started several
    (``core.distributed``), and lay them out as the data x model mesh;
    (this rank's device, the mesh).  The global batch must divide by
    ``data``."""
    distributed.initialize(backend=args.dist_backend, device=device)
    device = distributed.local_device(device)
    mesh = make_mesh(MeshSpec(model=getattr(args, "tensor_parallel", 1)))
    if args.train_batch_size % mesh.data:
        raise ValueError(f"--train_batch_size {args.train_batch_size} does "
                         f"not divide over the data axis of {mesh.data}")
    return device, mesh


def validation_mesh(mesh: Mesh) -> Optional[Mesh]:
    """The mesh a checkpoint's validation samples over: the first model
    group's (a tensor-parallel UNet needs every rank of its group), one
    data rank; None on the ranks that do not take part."""
    if mesh.data_index != 0:
        return None
    return dataclasses.replace(mesh, data=1, data_index=0, data_group=None,
                               data_ranks=(mesh.model_ranks[0],))


def build_dataset(args, phase: str, order: str, outputlist, size):
    """The JAX main's ``build_dataset``: every DressCode category."""
    if args.dataset == "dresscode":
        return DressCodeDataset(args.dresscode_dataroot, phase=phase,
                                order=order, outputlist=tuple(outputlist),
                                caption_file=args.caption_file, size=size)
    return VitonHDDataset(args.vitonhd_dataroot, phase=phase, order=order,
                          outputlist=tuple(outputlist),
                          caption_file=args.caption_file, size=size)


def train_loader(args, dataset) -> BatchLoader:
    return BatchLoader(dataset, args.train_batch_size, shuffle=True,
                       num_workers=args.num_workers, drop_last=True,
                       seed=args.seed)


def test_loader(args, dataset) -> BatchLoader:
    return BatchLoader(dataset, args.test_batch_size,
                       num_workers=args.num_workers_test, pad_last=True)


def token_ids(tokenizer, prompts, device) -> torch.Tensor:
    return to_device(np.asarray(tokenizer(prompts)), device, torch.long)


def trained_names(modules: dict) -> list:
    """``module.parameter`` of each trained parameter, in the optimizer's
    order."""
    return [f"{name}.{n}" for name, m in modules.items()
            for n, p in m.named_parameters() if p.requires_grad]


def checkpoint_state(step: int, modules: dict, optimizer,
                     mesh: Optional[Mesh] = None) -> Optional[dict]:
    """What a trainer's ``checkpoint-{step}`` holds: the whole state (the
    UNet and its AdamW moments gathered under tensor parallelism, ZeRO-1's
    state consolidated).  Collective over ranks; None off the main
    process."""
    opt = optimizer.state_dict()
    trainable = {k: m.state_dict() for k, m in modules.items()}
    if mesh is not None and mesh.model > 1:
        unet = modules["unet"]
        trainable["unet"] = tensor_parallel.gather_unet_state(unet, mesh)
        opt["adamw"] = tensor_parallel.gather_optimizer_state(
            opt["adamw"], tensor_parallel.param_specs(
                unet, trained_names(modules), mesh), mesh)
    if not distributed.is_main_process():
        return None
    return {"step": step, "trainable": trainable, "optimizer": opt,
            "rng": rng_state()}


def resume(ckpt: CheckpointManager, which, modules: dict, optimizer,
           logger, mesh: Optional[Mesh] = None) -> int:
    """Load ``--resume_from_checkpoint`` (``latest``, a step or
    ``checkpoint-<step>``) into the modules and the optimizer, on every
    rank (a tensor-parallel UNet and its moments take their slices); the
    step to start from (0 where there is no checkpoint, as the reference
    falls back)."""
    if not which:
        return 0
    step = which if which == "latest" else int(str(which).split("-")[-1])
    try:
        state = ckpt.restore(step)
    except FileNotFoundError:
        logger.info("no checkpoint found; training from scratch")
        return 0
    opt = state["optimizer"]
    for name, module in modules.items():
        if name == "unet" and mesh is not None and mesh.model > 1:
            tensor_parallel.load_full_state(module, state["trainable"][name],
                                            mesh)
            opt = dict(opt, adamw=tensor_parallel.shard_optimizer_state(
                opt["adamw"], tensor_parallel.param_specs(
                    module, trained_names(modules), mesh), mesh))
        else:
            module.load_state_dict(state["trainable"][name])
    optimizer.load_state_dict(opt)
    set_rng_state(state["rng"])
    logger.info(f"resumed from step {state['step']}")
    return int(state["step"])


def trainable_params(modules: dict) -> list:
    return [p for m in modules.values() for p in m.parameters()]


def new_adapter(args, vision_cfg, text_width: int) -> InversionAdapter:
    """A freshly initialised adapter (the JAX main's ``adapter.init``),
    seeded from ``seed`` without touching the global generator."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        return InversionAdapter(
            input_dim=vision_cfg.hidden_size,
            hidden_dim=vision_cfg.hidden_size * 4,
            output_dim=text_width * args.num_vstar,
            num_encoder_layers=args.num_encoder_layers,
            dropout=getattr(args, "adapter_dropout", 0.5),
            vision_config=vision_cfg)


def score(args, save_dir: str, device, trackers, step: int, logger) -> None:
    """The validation images' metrics, where the metric weights are."""
    from ladi_vton_tpu_torch.metrics.compute import compute_metrics

    try:
        metrics = compute_metrics(save_dir, args.test_order, args.dataset,
                                  "all", ["all"], args.dresscode_dataroot,
                                  args.vitonhd_dataroot, device=device)
    except FileNotFoundError as e:
        logger.info(f"metric weights unavailable: {e}")
        return
    trackers.log({f"val/{k}": v for k, v in metrics.items()}, step)
    logger.info(f"validation metrics at {step}: {metrics}")


def main(argv=None) -> int:
    """Run the CLI; returns the last step trained."""
    args = parse_args(argv)
    device, mesh = setup_mesh(args, check_train_args(args))
    dtype = default_policy(args.mixed_precision)
    set_seed(args.seed)
    logger = setup_logging(args.output_dir)
    on = dict(dtype=dtype, device=device)
    autocast = lambda: precision(device, dtype)  # noqa: E731

    # frozen towers
    vae = zoo.sd2_vae(args.sd2_model_dir, **on).requires_grad_(False)
    text_model = zoo.sd2_text_encoder(args.sd2_model_dir,
                                      **on).requires_grad_(False)
    tokenizer = CLIPTokenizer.from_dir(
        args.tokenizer_dir or Path(args.sd2_model_dir) / "tokenizer")
    # the trained UNet: SD-2-inpainting weights and the conv_in surgery
    in_ch = 31 if args.cloth_input_type == "warped" else 27
    unet = zoo.sd2_unet(args.sd2_model_dir, in_channels=in_ch,
                        dtype=torch.float32, device=device)
    unet.gradient_checkpointing = args.gradient_checkpointing
    tensor_parallel.unet_tp(unet, mesh)

    adapter = vision = None
    if args.text_usage == "inversion_adapter":
        vision_cfg = zoo.clip_vision_config(args.clip_vision_dir)
        adapter_on = dict(on, dtype=torch.float32
                          if args.train_inversion_adapter else dtype)
        if args.inversion_adapter_dir:
            name = (args.inversion_adapter_name
                    if args.inversion_adapter_name != "latest"
                    else f"inversion_adapter_{args.dataset}.pth")
            adapter = zoo.inversion_adapter(
                args.dataset,
                checkpoint=str(Path(args.inversion_adapter_dir) / name),
                num_vstar=args.num_vstar,
                num_encoder_layers=args.num_encoder_layers, **adapter_on)
        else:
            adapter = new_adapter(
                args, vision_cfg,
                text_model.text_model.final_layer_norm.weight.shape[0]).to(
                    **adapter_on).eval()
        adapter.requires_grad_(args.train_inversion_adapter)
        if not args.use_clip_cloth_features:
            vision = zoo.clip_vit_h_vision(args.clip_vision_dir,
                                           **on).requires_grad_(False)

    outputlist = ["image", "pose_map", "inpaint_mask", "im_mask",
                  "category", "im_name", "cloth"]
    if args.cloth_input_type == "warped":
        outputlist.append("warped_cloth")
    if args.text_usage == "noun_chunks":
        outputlist.append("captions")
    if args.use_clip_cloth_features:
        outputlist.append("clip_cloth_features")
    size = (args.height, args.width)
    loader = train_loader(args, build_dataset(args, "train", "paired",
                                              outputlist, size))

    config = VTOStepConfig(
        uncond_fraction=args.uncond_fraction, num_vstar=args.num_vstar,
        text_usage=args.text_usage, cloth_input_type=args.cloth_input_type,
        train_inversion_adapter=args.train_inversion_adapter,
        gradient_accumulation_steps=args.gradient_accumulation_steps)
    empty_ids = token_ids(tokenizer, [""], device)[0]
    modules = {"unet": unet}
    if args.train_inversion_adapter:
        modules["adapter"] = adapter
    optimizer = make_optimizer(
        trainable_params(modules), args.learning_rate,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_eps=args.adam_epsilon, weight_decay=args.adam_weight_decay,
        max_grad_norm=args.max_grad_norm, warmup_steps=args.lr_warmup_steps,
        lr_scheduler=args.lr_scheduler, total_steps=args.max_train_steps,
        mesh=mesh, shard_optimizer_states=args.shard_optimizer_states)
    step_fn = make_vto_train_step(
        optimizer=optimizer, config=config, autocast=autocast, mesh=mesh,
        unet=unet, vae=vae, text_model=text_model, inversion_adapter=adapter,
        empty_prompt_ids=empty_ids)

    ckpt = CheckpointManager(args.output_dir, keep=2,
                             async_save=args.async_checkpointing)
    start_step = resume(ckpt, args.resume_from_checkpoint, modules,
                        optimizer, logger, mesh)
    trackers = make_trackers(args.report_to, "LaDI_VTON_vto",
                             args.output_dir, vars(args))

    def prompts(raw: dict) -> list:
        if args.text_usage == "noun_chunks":
            return list(raw["captions"])
        if args.text_usage == "none":
            return [""] * len(raw["category"])
        return category_prompts(raw["category"], args.num_vstar)

    # the vision tower as a program (the JAX main's jitted apply)
    vision_feats = (vision_program(vision, dtype) if vision is not None
                    else None)

    def to_batch(raw: dict) -> dict:
        batch = {k: to_device(raw[k], device) for k in (
            "image", "im_mask", "inpaint_mask", "pose_map")}
        batch["input_ids"] = token_ids(tokenizer, prompts(raw), device)
        if args.cloth_input_type == "warped":
            batch["warped_cloth"] = to_device(raw["warped_cloth"], device)
        if args.text_usage == "inversion_adapter":
            if args.use_clip_cloth_features:
                feats = to_device(raw["clip_cloth_features"], device)
            else:
                with autocast():
                    feats = vision_feats(to_device(raw["cloth"], device))
            batch["clip_cloth_features"] = feats.to(dtype)
        return batch

    def on_checkpoint(step: int) -> None:
        out = Path(args.output_dir)
        unet_state = tensor_parallel.gather_unet_state(unet, mesh)
        if distributed.is_main_process():
            export_module(unet, out / f"unet_{step}.pth",
                          dataclasses.asdict(unet.config), state=unet_state)
            if args.train_inversion_adapter:
                export_module(adapter, out / f"inversion_adapter_{step}.pth",
                              adapter.config)
        del unet_state
        vmesh = validation_mesh(mesh)
        if vmesh is not None:
            run_checkpoint_validation(lambda: validate(step, vmesh), step,
                                      logger)

    def validate(step: int, vmesh: Mesh) -> None:
        from ladi_vton_tpu_torch.pipelines.drivers import (
            generate_images_from_tryon_pipe,
        )
        from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline

        test = build_dataset(args, "test", args.test_order, outputlist, size)
        save_dir = os.path.join(args.output_dir, f"imgs_step_{step}",
                                args.test_order)
        pipe = TryOnPipeline(unet=unet, vae=vae, emasc=None,
                             scheduler=DDIMScheduler())
        with autocast():
            generate_images_from_tryon_pipe(
                pipe, text_model, tokenizer, test_loader(args, test),
                save_dir, inversion_adapter=adapter, vision=vision,
                text_usage=args.text_usage, num_vstar=args.num_vstar,
                seed=args.seed, cloth_input_type=args.cloth_input_type,
                mesh=vmesh)
        if distributed.is_main_process():
            score(args, save_dir, device, trackers, step, logger)

    final = train_loop(
        step_fn=step_fn, loader=loader, to_batch=to_batch, device=device,
        draws_fn=vto_draws, ckpt_manager=ckpt,
        state_fn=lambda step: checkpoint_state(step, modules, optimizer,
                                               mesh),
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
