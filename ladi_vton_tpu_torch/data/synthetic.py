"""Synthetic DressCode and VITON-HD test splits, in the datasets' layouts.

For drives of the data layer and the CLIs without the datasets: every
file the test split's ``outputlist`` reads, with seeded random content
(smooth images, blocky parse maps in each dataset's label vocabulary,
keypoints inside the image with one arm joint missing on odd items),
plus the cache the eval path reads beside the root
(``<root>/../cache``): warped cloths for both orders and a CLIP
cloth-feature cache.  On request, a train split too (the train pair
lists, the train split's warped cloths and CLIP features, and a
noun-chunk captions JSON), for the trainers.

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


def _dresscode_item(rng, croot, im, c, size, image, png, i) -> None:
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
    image(croot / "skeletons" / im.replace("_0", "_5"), _smooth(rng, size))
    png(croot / "dense" / im.replace("_0.jpg", "_5.png"),
        _blocky_labels(rng, size, 25), "L")
    np.savez(croot / "dense" / im.replace("_0.jpg", "_5_uv.npz"),
             uv=rng.uniform(0, 1, (2,) + tuple(size)).astype(np.float32))


# noun chunks of the captions file, by item
CHUNKS = (("red shirt", "cotton"), ("blue dress",), ("denim", "jeans"),
          ("striped top", "collar"))


def _write_captions(path: Path, names) -> None:
    """The noun-chunk captions JSON (``--caption_file``): each garment's
    chunks under its name's number."""
    path.write_text(json.dumps({
        n.split("_")[0]: list(CHUNKS[i % len(CHUNKS)])
        for i, n in enumerate(names)}))


def write_dresscode(root, *, category: str = "upper_body", n_pairs: int = 2,
                    size: tuple = (1024, 768), seed: int = 0,
                    clip_shape: tuple = (257, 1280),
                    write_image: Optional[Callable] = None,
                    write_png: Optional[Callable] = None,
                    categories: Optional[tuple] = None,
                    train_pairs: int = 0) -> Path:
    """A DressCode test split of ``category`` (or of each of
    ``categories``) under ``root``; returns it.  With ``train_pairs``,
    also a train split of that many pairs a category (``train_pairs.txt``,
    their warped cloths and CLIP features), and ``root/captions.json``
    with noun chunks for every garment.  Item numbers are unique across
    categories (category k numbers from k * 1000, its train items from
    500)."""
    root = Path(root)
    image, png = write_image or _png_image, write_png or imageio.write_png
    rng = np.random.default_rng(seed)
    cache = root.parent / "cache"
    features = {"test": [], "train": []}
    half = (size[0] // 2, size[1] // 2)
    for k, cat in enumerate(categories or (category,)):
        croot = root / cat
        for sub in ("images", "masks", "label_maps", "keypoints",
                    "skeletons", "dense"):
            (croot / sub).mkdir(parents=True, exist_ok=True)
        pairs = []
        for i in range(n_pairs):
            im, c = f"{k * 1000 + i:06d}_0.jpg", f"{k * 1000 + i:06d}_1.jpg"
            pairs.append((im, c))
            _dresscode_item(rng, croot, im, c, size, image, png, i)
        unpaired = [(pairs[i][0], pairs[(i + 1) % n_pairs][1])
                    for i in range(n_pairs)]
        for name, lines in (("test_pairs_paired.txt", pairs),
                            ("test_pairs_unpaired.txt", unpaired)):
            (croot / name).write_text("".join(f"{a} {b}\n"
                                              for a, b in lines))
        for sub, lines in (("warped_cloths", pairs),
                           ("warped_cloths_unpaired", unpaired)):
            d = cache / sub / "dresscode" / cat
            d.mkdir(parents=True, exist_ok=True)
            for im, c in lines:
                image(d / f"{im[:-4]}_{c}", _smooth(rng, half))
        features["test"] += [c for _, c in pairs]
        train = [(f"{k * 1000 + 500 + i:06d}_0.jpg",
                  f"{k * 1000 + 500 + i:06d}_1.jpg")
                 for i in range(train_pairs)]
        if train:
            for i, (im, c) in enumerate(train):
                _dresscode_item(rng, croot, im, c, size, image, png, i)
                image(cache / "warped_cloths" / "dresscode" / cat
                      / f"{im[:-4]}_{c}", _smooth(rng, half))
            (croot / "train_pairs.txt").write_text(
                "".join(f"{a} {b}\n" for a, b in train))
            features["train"] += [c for _, c in train]
    for phase, names in features.items():
        if names:
            ClothFeatureCache.write(
                cache / "clip_cloth_embeddings" / "dresscode", phase, names,
                rng.standard_normal((len(names),) + tuple(clip_shape)
                                    ).astype(np.float32))
    if train_pairs:
        _write_captions(root / "captions.json",
                        features["test"] + features["train"])
    return root


def write_vitonhd(root, *, n_pairs: int = 2, size: tuple = (1024, 768),
                  seed: int = 0, clip_shape: tuple = (257, 1280),
                  write_image: Optional[Callable] = None,
                  write_png: Optional[Callable] = None,
                  train_pairs: int = 0) -> Path:
    """A VITON-HD test split under ``root``; returns it.  With
    ``train_pairs``, also a train split of that many pairs (``train/``,
    ``train_pairs.txt``, their warped cloths and CLIP features, numbered
    from 500) and ``root/captions.json``."""
    root = Path(root)
    image, png = write_image or _png_image, write_png or imageio.write_png
    rng = np.random.default_rng(seed)
    cache = root.parent / "cache"
    half = (size[0] // 2, size[1] // 2)
    splits = {"test": [f"{i:06d}_00.jpg" for i in range(n_pairs)],
              "train": [f"{500 + i:06d}_00.jpg" for i in range(train_pairs)]}
    for phase, names in splits.items():
        if not names:
            continue
        split = root / phase
        for sub in ("image", "cloth", "image-parse-v3", "openpose_json",
                    "openpose_img"):
            (split / sub).mkdir(parents=True, exist_ok=True)
        for i, im in enumerate(names):
            image(split / "image" / im, _smooth(rng, size))
            image(split / "cloth" / im, _smooth(rng, size))
            png(split / "image-parse-v3" / im.replace(".jpg", ".png"),
                _blocky_labels(rng, size, VITONHD_LABELS), "P",
                _palette(VITONHD_LABELS))
            body25 = _keypoints(rng, 25, 768, 1024, 7 if i % 2 else None)
            pose = np.concatenate([body25, np.ones((25, 1))], axis=1)
            (split / "openpose_json" / im.replace(".jpg", "_keypoints.json")
             ).write_text(json.dumps(
                 {"people": [{"pose_keypoints_2d": pose.ravel().tolist()}]}))
            image(split / "openpose_img" / im.replace(".jpg", "_rendered.png"),
                  _smooth(rng, size))
        pairs = [(im, names[(i + 1) % len(names)])
                 for i, im in enumerate(names)]
        (root / f"{phase}_pairs.txt").write_text(
            "".join(f"{a} {b}\n" for a, b in pairs))
        lines = {"warped_cloths": [(a, a) for a in names]}
        if phase == "test":
            lines["warped_cloths_unpaired"] = pairs
        for sub, sub_lines in lines.items():
            d = cache / sub / "vitonhd" / "upper_body"
            d.mkdir(parents=True, exist_ok=True)
            for im, c in sub_lines:
                image(d / f"{im[:-4]}_{c}", _smooth(rng, half))
        ClothFeatureCache.write(
            cache / "clip_cloth_embeddings" / "vitonhd", phase, names,
            rng.standard_normal((len(names),) + tuple(clip_shape)).astype(
                np.float32))
    if train_pairs:
        _write_captions(root / "captions.json",
                        splits["test"] + splits["train"])
    return root
