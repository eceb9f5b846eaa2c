"""The metric orchestrator (the reference's val_metrics), in the port.

Counterpart of ``ladi_vton_tpu/metrics/compute.py``, with a ``device``
argument (``cuda`` by default; asking for it where there is no card
raises).  Given a folder of generated images and the dataset's ground
truth, it computes ssim / lpips / fid / kid / is with the reference's
conventions (src/utils/val_metrics.py:105-225): generated and GT images
matched by file name, the generated ones (and the GT ones for SSIM and
LPIPS) loaded with a BILINEAR resize to the generated size, FID and KID
against a per-dataset stats cache (``metrics.fid.StatsCache``, built
from the raw GT images on first use, readable by either package), and
category-scoped or ``all``.  Images are read by the port's
``data/imageio.py`` (PNG, JPEG, sidecars) and resized by
``data/resample.py``, as PIL would.

The towers run in fp32 with TF32 off for cuDNN and cuBLAS, in a scope
around the metric calls (``inception.strict_fp32``), whatever the
process's settings; those are restored afterwards.  Each tower (Inception,
LPIPS, SSIM) is a ``pipelines.graphs.Program`` of ``MetricModels``, the
JAX package's jitted metric functions: on the card a CUDA graph for each
batch shape, captured and replayed under that scope; on the CPU the tower
itself.

Weights: FID/KID/IS need ``inception.pth`` (pytorch-fid's layout) and
LPIPS ``lpips_alex.pth`` (the lpips package's), from ``weights_dir`` or
``$LADI_VTON_METRIC_WEIGHTS``; a missing file raises.  SSIM needs none.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.core.dtypes import resolve_device
from ladi_vton_tpu_torch.data import imageio, resample
from ladi_vton_tpu_torch.metrics.fid import (
    StatsCache,
    frechet_distance,
    gaussian_stats,
    inception_score,
    kid_mmd2,
)
from ladi_vton_tpu_torch.metrics.inception import (
    InceptionV3,
    clean_resize_to_299,
    strict_fp32,
)
from ladi_vton_tpu_torch.metrics.lpips import LPIPS, lpips_state
from ladi_vton_tpu_torch.metrics.ssim import ssim as ssim_fn
from ladi_vton_tpu_torch.pipelines.graphs import Program

METRICS = ("ssim_score", "lpips_score", "fid_score", "kid_score",
           "is_score")


def _gt_image_paths(gt_root: str, dataset: str, category: str,
                    order: str) -> dict[str, str]:
    """name -> GT person-image path for the test split."""
    paths: dict[str, str] = {}
    if dataset == "dresscode":
        cats = (["dresses", "upper_body", "lower_body"]
                if category == "all" else [category])
        for c in cats:
            pairs = Path(gt_root) / c / f"test_pairs_{order}.txt"
            with open(pairs) as f:
                for line in f:
                    im_name = line.split()[0]
                    paths[im_name] = str(Path(gt_root) / c / "images"
                                         / im_name)
    else:
        with open(Path(gt_root) / "test_pairs.txt") as f:
            for line in f:
                im_name = line.split()[0]
                paths[im_name] = str(Path(gt_root) / "test" / "image"
                                     / im_name)
    return paths


def _gen_image_paths(gen_folder: str, category: str) -> dict[str, str]:
    gen = Path(gen_folder)
    out: dict[str, str] = {}
    roots = ([gen / c for c in
              ("dresses", "upper_body", "lower_body") if (gen / c).exists()]
             if category == "all" else [gen / category])
    if not any(r.exists() for r in roots):
        roots = [gen]
    for root in roots:
        if not root.exists():
            continue
        for p in sorted(root.iterdir()):
            if p.suffix.lower() in (".jpg", ".png", ".jpeg"):
                out[p.stem + ".jpg"] = str(p)
    return out


def rgb_pixels(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's ``Image.open(path).convert("RGB")``."""
    img = imageio.open_image(path)
    px = img.pixels
    if img.mode == "RGB":
        return px
    if img.mode == "RGBA":
        return np.ascontiguousarray(px[..., :3])
    if img.mode == "P":
        return img.palette_rgb()[px]
    if img.mode == "CMYK":
        return resample.cmyk_to_rgb(px)
    if img.mode == "LA":
        px = px[..., 0]
    elif img.mode in ("1", "I;16"):  # 0/255, and clamped at 255
        px = img.convert_l().pixels
    return np.repeat(px[..., None], 3, axis=2)


def _map(pool, fn, items) -> list:
    if pool is not None and len(items) > 1:
        return list(pool.map(fn, items))
    return [fn(x) for x in items]


def _load_batch(paths: List[str], size: tuple[int, int],
                pool=None) -> np.ndarray:
    """Decode and BILINEAR-resize a batch to ``size``, float32 in [0, 1];
    ``pool`` (a thread pool) decodes in parallel, as the reference's
    DataLoader workers do (val_metrics.py --workers)."""
    def load(p):
        px = resample.resize(rgb_pixels(p), size, resample.BILINEAR)
        return px.astype(np.float32) / 255.0

    return np.stack(_map(pool, load, paths))


def _load_batch_u8(paths: List[str], pool=None) -> np.ndarray:
    return np.stack(_map(pool, rgb_pixels, paths))


def _load_state(path: Path) -> dict:
    return torch.load(str(path), map_location="cpu", weights_only=True)


class MetricModels:
    """The metric towers, loaded on first use onto ``device`` in fp32."""

    def __init__(self, weights_dir: Optional[str] = None, device="cuda"):
        self.weights_dir = Path(
            weights_dir
            or os.environ.get("LADI_VTON_METRIC_WEIGHTS", "weights"))
        self.device = resolve_device(device)
        self._inception = None
        self._lpips = None
        self._programs: dict = {}

    def inception(self) -> InceptionV3:
        if self._inception is None:
            path = self.weights_dir / "inception.pth"
            if not path.exists():
                raise FileNotFoundError(
                    f"Inception weights not found at {path}. FID/KID/IS "
                    "need the pytorch-fid inception checkpoint; place it "
                    "there or set LADI_VTON_METRIC_WEIGHTS.")
            model = InceptionV3()
            model.load_state_dict(_load_state(path), strict=True)
            self._inception = model.eval().to(self.device)
        return self._inception

    def lpips(self) -> LPIPS:
        if self._lpips is None:
            path = self.weights_dir / "lpips_alex.pth"
            if not path.exists():
                raise FileNotFoundError(
                    f"LPIPS-Alex weights not found at {path}; place the "
                    "lpips alexnet checkpoint there or set "
                    "LADI_VTON_METRIC_WEIGHTS.")
            model = LPIPS()
            model.load_state_dict(lpips_state(_load_state(path)),
                                  strict=True)
            self._lpips = model.eval().to(self.device)
        return self._lpips

    def program(self, name: str, make_body) -> Program:
        """The tower ``name`` as a program (the JAX package's jitted
        metric functions), built once from ``make_body()``; the graphs
        are captured, and replayed, with TF32 off."""
        if name not in self._programs:
            body, modules = make_body()
            self._programs[name] = Program(body, device=self.device,
                                           modules=modules)
        return self._programs[name]

    def inception_features(self, inc_in: np.ndarray):
        """(pool3, logits) as float32 numpy of a clean-resized batch."""
        run = self.program("inception", lambda: (self.inception(),
                                                 (self.inception(),)))
        with strict_fp32():
            feats, logits = run(torch.from_numpy(inc_in))
        return feats.cpu().numpy(), logits.cpu().numpy()

    def lpips_distance(self, a: np.ndarray, b: np.ndarray) -> float:
        def make():
            tower = self.lpips()
            return (lambda x, y: tower(x, y, normalize=True)), (tower,)

        with strict_fp32():
            d = self.program("lpips", make)(torch.from_numpy(a),
                                            torch.from_numpy(b))
        return float(d)

    def ssim(self, a: np.ndarray, b: np.ndarray) -> float:
        with strict_fp32():
            d = self.program("ssim", lambda: (ssim_fn, ()))(
                torch.from_numpy(a), torch.from_numpy(b))
        return float(d)


def compute_metrics(
    gen_folder: str,
    test_order: str,
    dataset: str,
    category: str,
    metrics2compute: List[str],
    dresscode_dataroot: Optional[str],
    vitonhd_dataroot: Optional[str],
    generated_size: tuple[int, int] = (512, 384),
    batch_size: int = 32,
    workers: int = 8,
    weights_dir: Optional[str] = None,
    stats_root: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    assert test_order in ("paired", "unpaired")
    assert dataset in ("dresscode", "vitonhd")
    assert category in ("all", "dresses", "lower_body", "upper_body")
    if metrics2compute == ["all"]:
        metrics2compute = list(METRICS)
    for m in metrics2compute:
        assert m in METRICS, f"Unsupported metric {m}"

    gt_root = (dresscode_dataroot if dataset == "dresscode"
               else vitonhd_dataroot)
    gen_paths = _gen_image_paths(gen_folder, category)
    gt_paths = _gt_image_paths(gt_root, dataset, category, test_order)
    names = sorted(gen_paths)
    missing = [n for n in names if n not in gt_paths]
    assert not missing, f"generated images without GT: {missing[:5]}"

    models = MetricModels(weights_dir, device)
    need_inception = {"fid_score", "kid_score", "is_score"} & set(
        metrics2compute)
    need_lpips = "lpips_score" in metrics2compute

    results: Dict[str, float] = {}
    ssim_vals: list[float] = []
    lpips_vals: list[float] = []
    gen_feats: list[np.ndarray] = []
    gen_logits: list[np.ndarray] = []

    pool = ThreadPoolExecutor(workers) if workers > 1 else None
    try:
        for start in range(0, len(names), batch_size):
            chunk = names[start:start + batch_size]
            gen_batch = _load_batch([gen_paths[n] for n in chunk],
                                    generated_size, pool)
            if "ssim_score" in metrics2compute or need_lpips:
                gt_batch = _load_batch([gt_paths[n] for n in chunk],
                                       generated_size, pool)
            if "ssim_score" in metrics2compute:
                ssim_vals.append(models.ssim(gen_batch, gt_batch))
            if need_lpips:
                lpips_vals.append(models.lpips_distance(gen_batch, gt_batch))
            if need_inception:
                u8 = (gen_batch * 255).round().astype(np.uint8)
                feats, logits = models.inception_features(
                    clean_resize_to_299(u8))
                gen_feats.append(feats)
                gen_logits.append(logits)

        if "ssim_score" in metrics2compute:
            results["ssim_score"] = float(np.mean(ssim_vals))
        if need_lpips:
            results["lpips_score"] = float(np.mean(lpips_vals))

        if need_inception:
            gen_feats_all = np.concatenate(gen_feats)
            stats_name = f"{dataset}_{category}"
            cache = StatsCache(stats_root
                               or Path(gt_root).parent / "fid_stats")
            if ({"fid_score", "kid_score"} & set(metrics2compute)
                    and not cache.exists(stats_name)):
                # GT stats from the raw GT images (clean-fid
                # make_custom_stats)
                gt_names = sorted(gt_paths)
                feats = [models.inception_features(clean_resize_to_299(
                    _load_batch_u8([gt_paths[n] for n in
                                    gt_names[s:s + batch_size]], pool)))[0]
                    for s in range(0, len(gt_names), batch_size)]
                feats = np.concatenate(feats)
                mu, sigma = gaussian_stats(feats)
                cache.save(stats_name, mu, sigma, feats)
            if "fid_score" in metrics2compute:
                mu_gt, sigma_gt, _ = cache.load(stats_name)
                mu_g, sigma_g = gaussian_stats(gen_feats_all)
                results["fid_score"] = frechet_distance(mu_g, sigma_g, mu_gt,
                                                        sigma_gt)
            if "kid_score" in metrics2compute:
                _, _, gt_feats = cache.load(stats_name)
                if gt_feats is None:
                    raise ValueError(
                        "stats cache has no raw features; rebuild it to "
                        "compute KID")
                results["kid_score"] = kid_mmd2(gen_feats_all,
                                                gt_feats) * 1000
            if "is_score" in metrics2compute:
                is_mean, _ = inception_score(np.concatenate(gen_logits))
                results["is_score"] = is_mean
    finally:
        if pool is not None:
            pool.shutdown()
    return results


def folder_features(models: MetricModels, folder: str,
                    batch_size: int = 32) -> np.ndarray:
    """pool3 features of every image of a plain folder, by name order."""
    paths = sorted(p for p in Path(folder).iterdir()
                   if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    return np.concatenate([
        models.inception_features(clean_resize_to_299(_load_batch_u8(
            [str(p) for p in paths[s:s + batch_size]])))[0]
        for s in range(0, len(paths), batch_size)])


def fid_between_folders(folder_a: str, folder_b: str, *,
                        batch_size: int = 32,
                        weights_dir: Optional[str] = None,
                        device="cuda") -> float:
    """FID between two plain image folders: the clean-fid
    ``compute_fid(a, b, mode='clean')`` surface."""
    models = MetricModels(weights_dir, device)
    mu_a, s_a = gaussian_stats(folder_features(models, folder_a, batch_size))
    mu_b, s_b = gaussian_stats(folder_features(models, folder_b, batch_size))
    return frechet_distance(mu_a, s_a, mu_b, s_b)
