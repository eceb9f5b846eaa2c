"""Synthetic DressCode and VITON-HD test splits, in the datasets' layouts.

For drives of the data layer and the CLIs without the datasets: every
file the test split's ``outputlist`` reads, with seeded random content
(smooth images, blocky parse maps in each dataset's label vocabulary,
keypoints inside the image with one arm joint missing on odd items),
plus the cache the eval path reads beside the root
(``<root>/../cache``): warped cloths for both orders and a CLIP
cloth-feature cache.

Images go through ``write_image(path, rgb)`` under the datasets' ``.jpg``
names; the default writes PNG content (the port sniffs content, as PIL
does), and a caller with PIL can write JPEGs and then decode them with
``tools/decode_images.py``.  Label maps and masks go through
``write_png(path, pixels, mode, palette)``, the port's PNG writer by
default.  Sizes are (height, width); the datasets' native size is
1024x768.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ladi_vton_tpu_torch.data import imageio, resample
from ladi_vton_tpu_torch.data.features import ClothFeatureCache

DRESSCODE_LABELS = 18
VITONHD_LABELS = 20


def _png_image(path, rgb) -> None:
    imageio.write_png(path, rgb, "RGB")


def _smooth(rng, hw, channels: int = 3) -> np.ndarray:
    """A smooth random uint8 image with a little noise."""
    h, w = hw
    coarse = rng.integers(0, 256, (max(h // 32, 2), max(w // 32, 2),
                                   channels), dtype=np.uint8)
    img = resample.resize(coarse, (h, w), resample.BICUBIC).astype(np.int16)
    img += rng.integers(-6, 7, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _blocky_labels(rng, hw, n_labels: int) -> np.ndarray:
    h, w = hw
    coarse = rng.integers(0, n_labels, (16, 12), dtype=np.uint8)
    return resample.resize(coarse, (h, w), resample.NEAREST)


def _palette(n: int) -> np.ndarray:
    i = np.arange(256)
    return np.stack([(i * 37) % 256, (i * 91) % 256, (i * 53) % 256],
                    axis=1).astype(np.uint8)[:max(n, 1)]


def _keypoints(rng, n: int, width: float, height: float,
               missing: Optional[int]) -> np.ndarray:
    pts = rng.uniform([0.2 * width, 0.1 * height],
                      [0.8 * width, 0.9 * height], size=(n, 2))
    if missing is not None:
        pts[missing] = 0.0
    return pts


def write_dresscode(root, *, category: str = "upper_body", n_pairs: int = 2,
                    size: tuple = (1024, 768), seed: int = 0,
                    clip_shape: tuple = (257, 1280),
                    write_image: Optional[Callable] = None,
                    write_png: Optional[Callable] = None) -> Path:
    """A DressCode test split of one category under ``root``; returns it."""
    root = Path(root)
    image, png = write_image or _png_image, write_png or imageio.write_png
    rng = np.random.default_rng(seed)
    croot = root / category
    for sub in ("images", "masks", "label_maps", "keypoints", "skeletons",
                "dense"):
        (croot / sub).mkdir(parents=True, exist_ok=True)
    cache = root.parent / "cache"
    pairs, cloths = [], []
    for i in range(n_pairs):
        im, c = f"{i:06d}_0.jpg", f"{i:06d}_1.jpg"
        pairs.append((im, c))
        cloths.append(c)
        image(croot / "images" / im, _smooth(rng, size))
        image(croot / "images" / c, _smooth(rng, size))
        mask = (_smooth(rng, size, 1)[..., 0] > 128).astype(np.uint8) * 255
        png(croot / "masks" / c.replace(".jpg", ".png"), mask, "L")
        png(croot / "label_maps" / im.replace("_0.jpg", "_4.png"),
            _blocky_labels(rng, size, DRESSCODE_LABELS), "P",
            _palette(DRESSCODE_LABELS))
        kps = _keypoints(rng, 18, 384, 512, 4 if i % 2 else None)
        kps = np.concatenate([kps, np.ones((18, 1)),
                              np.arange(18)[:, None]], axis=1)
        (croot / "keypoints" / im.replace("_0.jpg", "_2.json")).write_text(
            json.dumps({"keypoints": kps.tolist()}))
        image(croot / "skeletons" / im.replace("_0", "_5"),
              _smooth(rng, size))
        png(croot / "dense" / im.replace("_0.jpg", "_5.png"),
            _blocky_labels(rng, size, 25), "L")
        np.savez(croot / "dense" / im.replace("_0.jpg", "_5_uv.npz"),
                 uv=rng.uniform(0, 1, (2,) + tuple(size)).astype(np.float32))
    unpaired = [(pairs[i][0], pairs[(i + 1) % n_pairs][1])
                for i in range(n_pairs)]
    for name, lines in (("test_pairs_paired.txt", pairs),
                        ("test_pairs_unpaired.txt", unpaired)):
        (croot / name).write_text("".join(f"{a} {b}\n" for a, b in lines))
    half = (size[0] // 2, size[1] // 2)
    for sub, lines in (("warped_cloths", pairs),
                       ("warped_cloths_unpaired", unpaired)):
        d = cache / sub / "dresscode" / category
        d.mkdir(parents=True, exist_ok=True)
        for im, c in lines:
            image(d / f"{im[:-4]}_{c}", _smooth(rng, half))
    ClothFeatureCache.write(
        cache / "clip_cloth_embeddings" / "dresscode", "test", cloths,
        rng.standard_normal((n_pairs,) + tuple(clip_shape)).astype(
            np.float32))
    return root


def write_vitonhd(root, *, n_pairs: int = 2, size: tuple = (1024, 768),
                  seed: int = 0, clip_shape: tuple = (257, 1280),
                  write_image: Optional[Callable] = None,
                  write_png: Optional[Callable] = None) -> Path:
    """A VITON-HD test split under ``root``; returns it."""
    root = Path(root)
    image, png = write_image or _png_image, write_png or imageio.write_png
    rng = np.random.default_rng(seed)
    test = root / "test"
    for sub in ("image", "cloth", "image-parse-v3", "openpose_json",
                "openpose_img"):
        (test / sub).mkdir(parents=True, exist_ok=True)
    cache = root.parent / "cache"
    names = [f"{i:06d}_00.jpg" for i in range(n_pairs)]
    for i, im in enumerate(names):
        image(test / "image" / im, _smooth(rng, size))
        image(test / "cloth" / im, _smooth(rng, size))
        png(test / "image-parse-v3" / im.replace(".jpg", ".png"),
            _blocky_labels(rng, size, VITONHD_LABELS), "P",
            _palette(VITONHD_LABELS))
        body25 = _keypoints(rng, 25, 768, 1024, 7 if i % 2 else None)
        pose = np.concatenate([body25, np.ones((25, 1))], axis=1)
        (test / "openpose_json" / im.replace(".jpg", "_keypoints.json")
         ).write_text(json.dumps(
             {"people": [{"pose_keypoints_2d": pose.ravel().tolist()}]}))
        image(test / "openpose_img" / im.replace(".jpg", "_rendered.png"),
              _smooth(rng, size))
    pairs = [(im, names[(i + 1) % n_pairs]) for i, im in enumerate(names)]
    (root / "test_pairs.txt").write_text(
        "".join(f"{a} {b}\n" for a, b in pairs))
    half = (size[0] // 2, size[1] // 2)
    for sub, lines in (("warped_cloths", [(a, a) for a in names]),
                       ("warped_cloths_unpaired", pairs)):
        d = cache / sub / "vitonhd" / "upper_body"
        d.mkdir(parents=True, exist_ok=True)
        for im, c in lines:
            image(d / f"{im[:-4]}_{c}", _smooth(rng, half))
    ClothFeatureCache.write(
        cache / "clip_cloth_embeddings" / "vitonhd", "test", names,
        rng.standard_normal((n_pairs,) + tuple(clip_shape)).astype(
            np.float32))
    return root
