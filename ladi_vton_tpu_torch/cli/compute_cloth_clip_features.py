"""Precompute the CLIP features of every in-shop garment (the port's main).

    python -m ladi_vton_tpu_torch.cli.compute_cloth_clip_features \\
        --dataset vitonhd --vitonhd_dataroot <root> --phase test \\
        --clip_vision_dir <dir>

Counterpart of ``ladi_vton_tpu/cli/compute_cloth_clip_features.py``
(reference src/utils/compute_cloth_clip_features.py:143-166), with its
flags, ``--mixed_precision`` and ``--device`` (``cuda`` by default;
raises where there is no card).  Each cloth of the split, resized to
224x224 and CLIP-normalised (``pipelines.condition.clip_pixels``), goes
through the ViT-H/14 vision tower from the port's zoo, as one program for
the run (``pipelines.condition.vision_program``, the JAX main's jitted
``run``: its CUDA graph captured at the first batch and replayed); every
last_hidden_state is kept once per cloth name, rounded to float16 as the
JAX main rounds it, and written as ``data.features.ClothFeatureCache``'s
``.npz`` under ``<cache_root>/clip_cloth_embeddings/<dataset>``.  The
tower runs in bf16 by default, as the conditioning stage runs it (K5,
the LayerNorm kernel, takes bf16 on the card); ``--mixed_precision no``
runs it in fp32 on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ladi_vton_tpu_torch.core.dtypes import default_policy, resolve_device
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
)
from ladi_vton_tpu_torch.data.features import ClothFeatureCache
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.pipelines.condition import vision_program


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Precompute CLIP cloth features")
    p.add_argument("--dataset", type=str, required=True,
                   choices=["dresscode", "vitonhd"])
    p.add_argument("--dresscode_dataroot", type=str)
    p.add_argument("--vitonhd_dataroot", type=str)
    p.add_argument("--phase", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--clip_vision_dir", type=str, required=True)
    p.add_argument("--cache_root", type=str, default=None)
    # the reference's flag, accepted for parity: the tower loads from
    # --clip_vision_dir
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="laion/CLIP-ViT-H-14-laion2B-s32B-b79K")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the tower runs: cuda (default) or cpu.")
    return p.parse_args(argv)


def main(argv=None) -> Path:
    """Run the CLI; returns the cache directory written."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = default_policy(args.mixed_precision)
    if args.dataset == "dresscode":
        dataroot = args.dresscode_dataroot
        dataset = DressCodeDataset(dataroot, phase=args.phase,
                                   order="paired",
                                   outputlist=("cloth", "c_name"))
    else:
        dataroot = args.vitonhd_dataroot
        dataset = VitonHDDataset(dataroot, phase=args.phase, order="paired",
                                 outputlist=("cloth", "c_name"))
    run = vision_program(zoo.clip_vit_h_vision(
        args.clip_vision_dir, dtype=dtype, device=device), dtype)

    loader = BatchLoader(dataset, args.batch_size,
                         num_workers=args.num_workers, pad_last=True)
    names: list[str] = []
    feats: list[np.ndarray] = []
    seen: set[str] = set()
    for batch in loader:
        cloth = torch.from_numpy(np.ascontiguousarray(batch["cloth"]))
        out = run(cloth.to(device, torch.float32)).float().cpu().numpy()
        for name, feat in zip(batch["c_name"], out):
            if name in seen:
                continue
            seen.add(name)
            names.append(name)
            feats.append(feat.astype(np.float16))

    cache_root = Path(args.cache_root or Path(dataroot).parent / "cache")
    target = cache_root / "clip_cloth_embeddings" / args.dataset
    ClothFeatureCache.write(target, args.phase, names,
                            np.stack(feats).astype(np.float32))
    print(f"wrote {len(names)} features to {target}")
    return target


if __name__ == "__main__":
    main()
