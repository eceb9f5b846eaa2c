"""Compute the metrics of a folder of generated images (the port's main).

    python -m ladi_vton_tpu_torch.cli.val_metrics --gen_folder <dir> \\
        --dataset dresscode --dresscode_dataroot <root> --test_order paired

Counterpart of ``ladi_vton_tpu/cli/val_metrics.py`` (reference
src/utils/val_metrics.py:228-264), with its flags and ``--device``
(``cuda`` by default; raises where there is no card).  FID/KID/IS/SSIM/
LPIPS of the generated images against the dataset's ground truth
(``metrics.compute.compute_metrics``), printed and written to
``<gen_folder>/metrics_<order>_<category>.json``.
"""

from __future__ import annotations

import argparse
import json
import os

from ladi_vton_tpu_torch.metrics.compute import METRICS, compute_metrics


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Compute the metrics for the generated images")
    p.add_argument("--gen_folder", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True,
                   choices=["dresscode", "vitonhd"])
    p.add_argument("--dresscode_dataroot", type=str)
    p.add_argument("--vitonhd_dataroot", type=str)
    p.add_argument("--test_order", type=str, required=True,
                   choices=["unpaired", "paired"])
    p.add_argument("--category", type=str, default="all",
                   choices=["all", "dresses", "lower_body", "upper_body"])
    p.add_argument("--metrics", type=str, nargs="+", default=["all"],
                   choices=["all", *METRICS])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--weights_dir", type=str, default=None,
                   help="dir with inception.pth / lpips_alex.pth")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the towers run: cuda (default) or cpu.")
    return p.parse_args(argv)


def write_metrics(metrics: dict, folder: str, order: str,
                  category: str) -> str:
    out = os.path.join(folder, f"metrics_{order}_{category}.json")
    with open(out, "w+") as f:
        json.dump(metrics, f, indent=4)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    metrics = compute_metrics(
        args.gen_folder, args.test_order, args.dataset, args.category,
        args.metrics, args.dresscode_dataroot, args.vitonhd_dataroot,
        generated_size=(args.height, args.width),
        batch_size=args.batch_size, workers=args.workers,
        weights_dir=args.weights_dir, device=args.device)
    print(json.dumps(metrics, indent=2))
    write_metrics(metrics, args.gen_folder, args.test_order, args.category)
    return metrics


if __name__ == "__main__":
    main()
