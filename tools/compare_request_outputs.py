#!/usr/bin/env python3
"""Save, or compare, the images of ``chip_smoke.py`` phase 4's requests.

    python3 tools/compare_request_outputs.py OUT.npz [--against REF.npz]

Builds the full-width try-on service of phase 4 (seeded random bf16
weights, 512x384, DDIM-50, CFG 7.5, batch 2) with the tree it runs from,
answers the warm-up and the three requests of phase 4, and saves the
three images to ``OUT.npz``.  With ``--against``, it also prints whether
each image is bitwise equal to the one saved under the same name by
another tree, and the largest difference.  Run it from two checkouts in
one call (parent, change, change, parent) to tell whether a change moves
the path's outputs; the card's name and power limit lead the output.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path.cwd()))

import chip_smoke  # noqa: E402
from ladi_vton_tpu_torch.ops import _build  # noqa: E402
from ladi_vton_tpu_torch.pipelines.serving import TryOnService  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out", type=pathlib.Path)
    parser.add_argument("--against", type=pathlib.Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_request_outputs: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # as phase 4 serves
    with torch.no_grad():
        service = TryOnService(chip_smoke.full_width_pipeline(),
                               batch_size=2, height=512, width=384,
                               num_inference_steps=50, guidance_scale=7.5,
                               context_dim=1024, seed=0)
        service.warmup()
        rng = np.random.default_rng(0)
        images = {f"request_{i}": service.generate(
            **chip_smoke.request(rng, n, 512, 384))
            for i, n in enumerate((1, 2, 2))}
    np.savez(args.out, **images)
    if args.against is not None:
        with np.load(args.against) as ref:
            for name, image in images.items():
                diff = float(np.abs(image - ref[name]).max())
                print(f"{name}: bitwise equal to {args.against}: "
                      f"{np.array_equal(image, ref[name])}, max abs "
                      f"difference {diff:.3e}", flush=True)


if __name__ == "__main__":
    main()
