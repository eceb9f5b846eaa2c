"""Training CLI of the warping stage (TPS, then the refinement) and the
extraction of warped cloths, on the port.

    python -m ladi_vton_tpu_torch.cli.train_tps --dataset vitonhd \\
        --vitonhd_dataroot <root> --checkpoints_dir <dir> --exp_name <name>

Counterpart of ``ladi_vton_tpu/cli/train_tps.py``, with every flag of it
and ``--device`` (``cuda`` by default; asking for it where there is no
card raises).  Both towers run in fp32, as the reference runs them:

* phase A, ``--epochs_tps`` epochs of TPS at 256x192 (L1 +
  ``--const_weight`` * the grid regularisers, Adam(0.5, 0.99));
* phase B, ``--epochs_refinement`` epochs of the refinement at
  ``--height`` x ``--width`` (``--l1_weight`` * L1 + ``--vgg_weight`` *
  VGG, the VGG19 from ``--vgg_weights`` or seeded random weights);
* after every epoch, the L1 and VGG losses of the warped (phase A) or
  refined (phase B) cloth on the paired and the unpaired test split, a
  panel of image | cloth | target | warped logged through the trackers,
  then a checkpoint of both towers and optimizers
  (``<checkpoints_dir>/<exp_name>/checkpoint-{epoch}``, the last two
  kept) and ``warping_<dataset>.pth``, the reference's
  ``{"tps", "refinement"}`` bundle that both packages' zoos load;
* a run resumes at the epoch after its latest checkpoint (each epoch
  reading the batches it would have read); ``--only_extraction`` skips
  training and needs a checkpoint;
* last, the extraction: the refined warped cloths of the train and test
  splits (paired) and of the test split (unpaired), as JPEGs under
  ``<save_path>/warped_cloths{,_unpaired}/<dataset>/<category>/`` (by
  default ``<dataroot>/../cache``), where ``cli.eval``, ``cli.train_vto``
  and the datasets read them.

``--dense`` takes the 2-channel dense UV map for the 18-channel pose.
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path

import numpy as np
import torch

from ladi_vton_tpu_torch.cli.train_emasc import vgg_tower
from ladi_vton_tpu_torch.cli.train_vto import to_device
from ladi_vton_tpu_torch.core.checkpoint import (
    CheckpointManager,
    rng_state,
    save_atomic,
    set_rng_state,
)
from ladi_vton_tpu_torch.core.dtypes import resolve_device
from ladi_vton_tpu_torch.core.rng import set_seed
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
    imageio,
)
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.models.tps import ConvNetTPS
from ladi_vton_tpu_torch.pipelines.graphs import Program
from ladi_vton_tpu_torch.train.runner import Trackers, setup_logging
from ladi_vton_tpu_torch.train.tps_steps import (
    TPS_SIZE,
    eval_batch,
    extraction_pixels,
    make_refinement_train_step,
    make_tps_train_step,
    tps_optimizer,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True,
                   choices=["dresscode", "vitonhd"])
    p.add_argument("--dresscode_dataroot", type=str)
    p.add_argument("--vitonhd_dataroot", type=str)
    p.add_argument("--checkpoints_dir", type=str, required=True)
    p.add_argument("--exp_name", type=str, required=True)
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--const_weight", type=float, default=0.01)
    p.add_argument("--l1_weight", type=float, default=1.0)
    p.add_argument("--vgg_weight", type=float, default=0.25)
    p.add_argument("--epochs_tps", type=int, default=50)
    p.add_argument("--epochs_refinement", type=int, default=50)
    p.add_argument("--wandb_log", default=False, action="store_true",
                   help="use wandb to log the training")
    p.add_argument("--wandb_project", type=str, default="LaDI_VTON_tps")
    p.add_argument("--wandb_entity", type=str, default=None)
    p.add_argument("--dense", action="store_true",
                   help="use dense UV pose instead of keypoint heatmaps")
    p.add_argument("--only_extraction", action="store_true")
    p.add_argument("--save_path", type=str, default=None,
                   help="where to write the warped cloth caches (default: "
                        "a 'cache' dir next to the dataroot)")
    p.add_argument("--vgg_weights", type=str, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--report_to", type=str, default=None,
                   help="extra tracker backend (tensorboard); wandb is "
                        "controlled by --wandb_log like the reference")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where training runs: cuda (default) or cpu.")
    return p.parse_args(argv)


def pose_key(args) -> str:
    return "dense_uv" if args.dense else "pose_map"


def build(args, phase: str, order: str, size):
    outputlist = ("c_name", "im_name", "cloth", "image", "im_cloth",
                  "im_mask", "category", pose_key(args))
    if args.dataset == "dresscode":
        return DressCodeDataset(args.dresscode_dataroot, phase=phase,
                                order=order, outputlist=outputlist, size=size)
    return VitonHDDataset(args.vitonhd_dataroot, phase=phase, order=order,
                          outputlist=outputlist, size=size)


def main(argv=None) -> dict:
    """Run the CLI; returns the epochs trained and the warped cloths
    written ({"epochs": n, "extracted": n})."""
    args = parse_args(argv)
    if args.dataset == "vitonhd" and args.vitonhd_dataroot is None:
        raise ValueError("VitonHD dataroot must be provided")
    if args.dataset == "dresscode" and args.dresscode_dataroot is None:
        raise ValueError("DressCode dataroot must be provided")
    device = resolve_device(args.device)
    set_seed(args.seed)
    out_dir = Path(args.checkpoints_dir) / args.exp_name
    logger = setup_logging(out_dir)
    agn_ch = 3 + (2 if args.dense else 18)  # masked person + pose

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        tps = ConvNetTPS(*TPS_SIZE, input_nc_b=agn_ch)
        refinement = UNetVanilla(in_channels=agn_ch + 3, out_channels=3)
    tps, refinement = tps.to(device), refinement.to(device)
    vgg = vgg_tower(args.vgg_weights, 0, device, logger)
    opt_tps = tps_optimizer(tps.parameters(), args.lr)
    opt_ref = tps_optimizer(refinement.parameters(), args.lr)

    ckpt = CheckpointManager(out_dir, keep=2)
    # resume continues at the stored epoch: checkpoint-{e} holds the
    # state after epoch e - 1
    start_epoch = 0
    try:
        state = ckpt.restore("latest")
        tps.load_state_dict(state["tps"])
        refinement.load_state_dict(state["refinement"])
        opt_tps.load_state_dict(state["opt_tps"])
        opt_ref.load_state_dict(state["opt_refinement"])
        set_rng_state(state["rng"])
        start_epoch = int(state["epoch"])
        logger.info(f"resumed warping checkpoint at epoch {start_epoch}")
    except FileNotFoundError:
        if args.only_extraction:
            raise SystemExit(
                "No checkpoint found; before extracting warped cloth "
                "images, please train the model first.")

    report_to = "wandb" if args.wandb_log else args.report_to
    trackers = Trackers(report_to, args.wandb_project, out_dir, vars(args),
                        entity=args.wandb_entity)
    size = (args.height, args.width)

    def arrays(raw: dict) -> dict:
        pose = raw[pose_key(args)]
        if args.dense and pose.shape[-1] != 2:
            pose = np.transpose(pose, (0, 2, 3, 1))  # CHW -> HWC
        return {"cloth": to_device(raw["cloth"], device),
                "im_cloth": to_device(raw["im_cloth"], device),
                "im_mask": to_device(raw["im_mask"], device),
                "pose": to_device(pose, device)}

    # the per-epoch evaluation and the extraction as programs (the JAX
    # main's jitted ``_eval_batch_*`` and ``extract_fn``), one each; the
    # graphs read the towers' parameters and statistics in place
    programs = {}

    def program(name: str, body) -> Program:
        if name not in programs:
            programs[name] = Program(body, device=device,
                                     modules=(tps, refinement, vgg))
        tps.eval()
        refinement.eval()
        return programs[name]

    def eval_epoch(dataset, use_refinement: bool):
        """Mean L1 and VGG losses of the warped (or refined) cloth over a
        test split, summed on the device and read once, and the last
        batch's panel in [0, 1]."""
        run = program(f"eval_{use_refinement}", functools.partial(
            eval_batch, tps, refinement, vgg, refined=use_refinement,
            height=args.height, width=args.width))
        sums, n, last = None, 0, None
        for raw in BatchLoader(dataset, args.batch_size,
                               num_workers=args.workers):
            b = arrays(raw)
            warped, l1, perc = run(b)
            pair = torch.stack([l1, perc]).double()
            sums = pair if sums is None else sums + pair
            n += 1
            last = raw["image"], b, warped
        if not n:  # an empty test split: no NaN means
            return 0.0, 0.0, None
        l1, perc = (sums / n).tolist()
        image, b, warped = last
        # image | cloth | target | warped along the width
        visual = np.concatenate(
            [image] + [b[k].cpu().numpy() for k in ("cloth", "im_cloth")]
            + [warped.cpu().numpy()], axis=2)
        return l1, perc, (visual + 1.0) / 2.0

    def eval_and_log(epoch: int, phase: str, train_metrics: dict,
                     use_refinement: bool) -> None:
        l1_p, vgg_p, vis_p = eval_epoch(build(args, "test", "paired", size),
                                        use_refinement)
        l1_u, vgg_u, vis_u = eval_epoch(
            build(args, "test", "unpaired", size), use_refinement)
        metrics = {**{f"train/{k}": v for k, v in train_metrics.items()},
                   "eval/eval_loss_paired": l1_p,
                   "eval/eval_vgg_loss_paired": vgg_p,
                   "eval/eval_loss_unpaired": l1_u,
                   "eval/eval_vgg_loss_unpaired": vgg_u}
        logger.info(f"{phase} epoch {epoch}: {metrics}")
        trackers.log(metrics, epoch)
        for tag, vis in (("images_paired", vis_p),
                         ("images_unpaired", vis_u)):
            if vis is not None:
                trackers.log_images(tag, vis[:8], epoch, output_dir=out_dir)

    def save(epoch: int) -> None:
        ckpt.save(epoch, {
            "epoch": epoch, "tps": tps.state_dict(),
            "refinement": refinement.state_dict(),
            "opt_tps": opt_tps.state_dict(),
            "opt_refinement": opt_ref.state_dict(), "rng": rng_state()})
        save_atomic({"tps": _cpu(tps.state_dict()),
                     "refinement": _cpu(refinement.state_dict())},
                    out_dir / f"warping_{args.dataset}.pth")

    def run_epochs(first: int, last: int, offset: int, train_size, step_fn,
                   phase: str, keys: tuple, use_refinement: bool) -> None:
        loader = BatchLoader(build(args, "train", "paired", train_size),
                             args.batch_size, shuffle=True,
                             num_workers=args.workers, drop_last=True,
                             seed=args.seed)
        for epoch in range(first, last):
            loader.start_at(epoch - offset)
            sums = {k: [] for k in ("loss",) + keys}
            for raw in loader:
                metrics = step_fn(arrays(raw))
                for k in sums:
                    sums[k].append(float(metrics[k]))
            means = {k: float(np.mean(v)) if v else 0.0
                     for k, v in sums.items()}
            eval_and_log(epoch, phase, {
                "loss": means["loss"], "l1_loss": means["l1"],
                "const_loss": means.get("const", 0.0),
                "vgg_loss": means.get("vgg", 0.0)}, use_refinement)
            save(epoch + 1)

    total = args.epochs_tps + args.epochs_refinement
    epochs = 0
    if not args.only_extraction:
        if start_epoch < args.epochs_tps:
            run_epochs(start_epoch, args.epochs_tps, 0, TPS_SIZE,
                       make_tps_train_step(tps=tps, optimizer=opt_tps,
                                           const_weight=args.const_weight),
                       "tps", ("l1", "const"), False)
            epochs += args.epochs_tps - start_epoch
            start_epoch = args.epochs_tps
        if start_epoch < total:
            tps.requires_grad_(False)
            run_epochs(start_epoch, total, args.epochs_tps, size,
                       make_refinement_train_step(
                           optimizer=opt_ref, tps=tps, refinement=refinement,
                           vgg=vgg, l1_weight=args.l1_weight,
                           vgg_weight=args.vgg_weight, height=args.height,
                           width=args.width),
                       "refinement", ("l1", "vgg"), True)
            epochs += total - start_epoch

    # ---------------- extraction
    cache_root = (Path(args.save_path) if args.save_path else Path(
        args.dresscode_dataroot or args.vitonhd_dataroot).parent / "cache")
    extracted = 0

    def extract(dataset, sub: str) -> int:
        pixels_of = program("extract", functools.partial(
            extraction_pixels, tps, refinement, height=args.height,
            width=args.width))
        seen = set()
        root = cache_root / sub / args.dataset
        for raw in BatchLoader(dataset, args.batch_size,
                               num_workers=args.workers, pad_last=True):
            b = arrays(raw)
            pixels = pixels_of(b["cloth"], b["im_mask"],
                               b["pose"]).cpu().numpy()
            for img, cat, iname, cname in zip(
                    pixels, raw["category"], raw["im_name"], raw["c_name"]):
                name = iname.replace(".jpg", "") + "_" + cname
                if (cat, name) in seen:  # pad_last repeats
                    continue
                seen.add((cat, name))
                (root / cat).mkdir(parents=True, exist_ok=True)
                imageio.write_jpeg(root / cat / name, img, quality=95)
        return len(seen)

    extracted += extract(build(args, "train", "paired", size),
                         "warped_cloths")
    extracted += extract(build(args, "test", "paired", size), "warped_cloths")
    extracted += extract(build(args, "test", "unpaired", size),
                         "warped_cloths_unpaired")
    trackers.finish()
    logger.info("extraction complete")
    return {"epochs": epochs, "extracted": extracted}


def _cpu(state: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


if __name__ == "__main__":
    main()
