"""Build the FID/KID ground-truth statistic caches (the port's main).

    python -m ladi_vton_tpu_torch.cli.generate_fid_stats \\
        --dresscode_dataroot <root> --vitonhd_dataroot <root>

Counterpart of ``ladi_vton_tpu/cli/generate_fid_stats.py`` (reference
src/utils/generate_fid_stats.py:9-40, clean-fid ``make_custom_stats``),
with its flags and ``--device`` (``cuda`` by default; raises where there
is no card).  For every dataset and category test split, the Inception
pool3 Gaussian stats and raw features of the GT images, in
``metrics.fid.StatsCache``'s files (``<stats_root>/<dataset>_<category>
_clean_stats.npz``, by default beside the dataset root), which either
package reads.  An existing cache is kept.  A DressCode category without
a test split (no ``<category>/test_pairs_paired.txt``; ``all`` needs all
three) is skipped with a line saying so, where the JAX main raises: a
tree of one category still gets that category's cache.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ladi_vton_tpu_torch.metrics.compute import (
    MetricModels,
    _gt_image_paths,
    _load_batch_u8,
)
from ladi_vton_tpu_torch.metrics.fid import StatsCache, gaussian_stats
from ladi_vton_tpu_torch.metrics.inception import clean_resize_to_299


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate FID stats caches")
    p.add_argument("--dresscode_dataroot", type=str)
    p.add_argument("--vitonhd_dataroot", type=str)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--stats_root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="Where Inception runs: cuda (default) or cpu.")
    return p.parse_args(argv)


def has_test_split(root: str, dataset: str, category: str) -> bool:
    if dataset != "dresscode":
        return True
    cats = (("dresses", "upper_body", "lower_body") if category == "all"
            else (category,))
    return all((Path(root) / c / "test_pairs_paired.txt").exists()
               for c in cats)


def main(argv=None) -> list:
    """Run the CLI; returns the names of the caches written."""
    args = parse_args(argv)
    models = MetricModels(args.weights_dir, args.device)
    jobs = []
    if args.dresscode_dataroot:
        for cat in ("all", "dresses", "upper_body", "lower_body"):
            jobs.append(("dresscode", args.dresscode_dataroot, cat))
    if args.vitonhd_dataroot:
        jobs.append(("vitonhd", args.vitonhd_dataroot, "all"))

    written = []
    for dataset, root, category in jobs:
        cache = StatsCache(args.stats_root
                           or Path(root).parent / "fid_stats")
        name = f"{dataset}_{category}"
        if cache.exists(name):
            print(f"{name}: exists, skipping")
            continue
        if not has_test_split(root, dataset, category):
            print(f"{name}: no test split under {root}, skipping")
            continue
        paths = _gt_image_paths(root, dataset, category, "paired")
        keys = sorted(paths)
        feats = []
        for start in range(0, len(keys), args.batch_size):
            chunk = [paths[k] for k in keys[start:start + args.batch_size]]
            f, _ = models.inception_features(
                clean_resize_to_299(_load_batch_u8(chunk)))
            feats.append(f)
        feats = np.concatenate(feats)
        mu, sigma = gaussian_stats(feats)
        cache.save(name, mu, sigma, feats)
        written.append(name)
        print(f"{name}: saved stats for {len(keys)} images")
    return written


if __name__ == "__main__":
    main()
