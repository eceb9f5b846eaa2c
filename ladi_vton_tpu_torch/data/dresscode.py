"""DressCode dataset: indexing, IO, and agnostic preprocessing.

Same data contract as the reference's DressCodeDataset
(reference: src/dataset/dresscode.py): items are dicts keyed exactly by
the requested ``outputlist``; pair lists come from per-category
``train_pairs.txt`` / ``test_pairs_{paired,unpaired}.txt``
(dresscode.py:79-91); cached warped cloths are read from
``data/warped_cloths{,_unpaired}/dresscode/<category>/<im>_<c>.jpg``
(dresscode.py:139-156); CLIP cloth features from the precomputed cache
(dresscode.py:97-104).

Differences by design: arrays are numpy float32 NHWC (channel-last), and
the mask/pose geometry runs through ``data.agnostic.compose_agnostic``.

The port's copy of ``ladi_vton_tpu/data/dresscode.py``, with the same
items bit for bit: images are read by ``data/imageio.py`` (JPEGs from
their decoded sidecars) and resized by ``data/resample.py``, which
compute what PIL computes; ``dense_uv`` is resized by
``resize_chw`` (``F.interpolate``) in place of ``cv2.resize``.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ladi_vton_tpu_torch.data import resample
from ladi_vton_tpu_torch.data.agnostic import compose_agnostic
from ladi_vton_tpu_torch.data.features import ClothFeatureCache
from ladi_vton_tpu_torch.data.imageio import Image, open_image

POSSIBLE_OUTPUTS = (
    "c_name", "im_name", "cloth", "image", "im_cloth", "shape", "im_head",
    "im_pose", "pose_map", "parse_array", "dense_labels", "dense_uv",
    "skeleton", "im_mask", "inpaint_mask", "parse_mask_total", "captions",
    "category", "hands", "parse_head_2", "warped_cloth",
    "clip_cloth_features",
)


def _to_float(img: Image) -> np.ndarray:
    """HWC float32 in [-1, 1] (reference's ToTensor+Normalize(0.5))."""
    arr = np.asarray(img.pixels, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr * 2.0 - 1.0


class DressCodeDataset:
    def __init__(
        self,
        dataroot_path: str,
        phase: str,  # 'train' | 'test'
        radius: float = 5,
        caption_file: Optional[str] = None,
        order: str = "paired",  # | 'unpaired'
        outputlist: Sequence[str] = ("c_name", "im_name", "cloth", "image",
                                     "pose_map", "inpaint_mask", "im_mask",
                                     "category"),
        category: Sequence[str] = ("dresses", "upper_body", "lower_body"),
        size: tuple[int, int] = (512, 384),
        cache_root: Optional[str] = None,
    ):
        unknown = set(outputlist) - set(POSSIBLE_OUTPUTS)
        if unknown:
            raise ValueError(f"unknown output keys: {sorted(unknown)}")
        self.dataroot = dataroot_path
        self.phase = phase
        self.radius = radius
        self.order = order
        self.outputlist = tuple(outputlist)
        self.height, self.width = size
        self.cache_root = Path(cache_root) if cache_root else (
            Path(dataroot_path).parent / "cache")

        self.captions_dict = {}
        if "captions" in self.outputlist and caption_file:
            try:
                with open(caption_file) as f:
                    self.captions_dict = json.load(f)
            except FileNotFoundError:
                print(f"caption file {caption_file} not found; no captions")

        self.im_names: list[str] = []
        self.c_names: list[str] = []
        self.categories: list[str] = []
        for c in category:
            assert c in ("dresses", "upper_body", "lower_body")
            croot = os.path.join(dataroot_path, c)
            pairs = (f"{phase}_pairs.txt" if phase == "train"
                     else f"{phase}_pairs_{order}.txt")
            with open(os.path.join(croot, pairs)) as f:
                for line in f:
                    im_name, c_name = line.strip().split()
                    self.im_names.append(im_name)
                    self.c_names.append(c_name)
                    self.categories.append(c)

        self.features = None
        if "clip_cloth_features" in self.outputlist:
            self.features = ClothFeatureCache(
                self.cache_root / "clip_cloth_embeddings" / "dresscode",
                phase)

    def __len__(self) -> int:
        return len(self.im_names)

    def _category_root(self, idx: int) -> str:
        return os.path.join(self.dataroot, self.categories[idx])

    def _open_resized(self, path: str, nearest: bool = False) -> Image:
        method = resample.NEAREST if nearest else resample.BICUBIC
        return open_image(path).resize((self.height, self.width), method)

    def _warped_cloth_path(self, idx: int) -> str:
        sub = ("warped_cloths_unpaired" if self.order == "unpaired"
               else "warped_cloths")
        name = (self.im_names[idx].replace(".jpg", "") + "_"
                + self.c_names[idx])
        return str(self.cache_root / sub / "dresscode"
                   / self.categories[idx] / name)

    def __getitem__(self, index: int) -> dict:
        want = set(self.outputlist)
        out: dict = {}
        croot = self._category_root(index)
        c_name = self.c_names[index]
        im_name = self.im_names[index]
        category = self.categories[index]

        if "c_name" in want:
            out["c_name"] = c_name
        if "im_name" in want:
            out["im_name"] = im_name
        if "category" in want:
            out["category"] = category

        if "captions" in want:
            caps = list(self.captions_dict.get(c_name.split("_")[0], []))
            if self.phase == "train":
                random.shuffle(caps)
            out["captions"] = ", ".join(caps)

        if "clip_cloth_features" in want:
            out["clip_cloth_features"] = self.features.get(c_name)

        if "cloth" in want:
            cloth = open_image(os.path.join(croot, "images", c_name))
            mask = open_image(
                os.path.join(croot, "masks", c_name.replace(".jpg", ".png")))
            # background removal via inverted-mask composite
            # (reference dresscode.py:123-131)
            inv = resample.invert(mask.convert_l().pixels)
            cloth = Image(resample.composite(inv, cloth.pixels, inv),
                          cloth.mode)
            cloth = cloth.resize((self.height, self.width), resample.BICUBIC)
            out["cloth"] = _to_float(cloth)

        image = None
        if want & {"image", "im_head", "im_cloth", "im_mask"}:
            image = _to_float(
                self._open_resized(os.path.join(croot, "images", im_name)))
            if "image" in want:
                out["image"] = image

        if "warped_cloth" in want:
            wc = open_image(self._warped_cloth_path(index)).resize(
                (self.height, self.width), resample.BICUBIC)
            out["warped_cloth"] = _to_float(wc)

        if "skeleton" in want:
            sk = self._open_resized(
                os.path.join(croot, "skeletons", im_name.replace("_0", "_5")))
            out["skeleton"] = _to_float(sk)

        mask_keys = {"im_pose", "im_mask", "parse_mask_total", "parse_array",
                     "pose_map", "shape", "im_head", "inpaint_mask",
                     "im_cloth", "hands", "parse_head_2"}
        if want & mask_keys:
            parse = self._open_resized(
                os.path.join(croot, "label_maps",
                             im_name.replace("_0.jpg", "_4.png")),
                nearest=True).pixels
            with open(os.path.join(
                    croot, "keypoints",
                    im_name.replace("_0.jpg", "_2.json"))) as f:
                kp_raw = np.asarray(
                    json.load(f)["keypoints"], np.float32).reshape(-1, 4)
            # heatmap/rect coords scale per-axis (dresscode.py:262-263)
            kps = kp_raw[:, :2].copy()
            kps[:, 0] *= self.width / 384.0
            kps[:, 1] *= self.height / 512.0
            # arm-geometry coords use the reference's H/512 both-axis
            # scaling quirk (dresscode.py:295-300)
            arm_kps = kp_raw[:, :2] * (self.height / 512.0)

            res = compose_agnostic(
                parse, kps,
                dataset="dresscode", category=category,
                height=self.height, width=self.width, radius=self.radius,
                arm_keypoints=arm_kps,
            )

            if "parse_array" in want:
                out["parse_array"] = parse
            if "pose_map" in want:
                out["pose_map"] = np.transpose(res.pose_map, (1, 2, 0))
            if "im_pose" in want:
                out["im_pose"] = res.im_pose[..., None]
            if "shape" in want:
                out["shape"] = (res.shape * 2.0 - 1.0)[..., None]
            if "im_head" in want:
                out["im_head"] = (image * res.parse_head[..., None]
                                  - (1 - res.parse_head[..., None]))
            if "im_cloth" in want:
                out["im_cloth"] = (image * res.parse_cloth[..., None]
                                   + (1 - res.parse_cloth[..., None]))
            if "im_mask" in want:
                out["im_mask"] = image * res.keep_mask[..., None]
            if "inpaint_mask" in want:
                out["inpaint_mask"] = res.inpaint_mask[..., None]
            if "parse_mask_total" in want:
                out["parse_mask_total"] = res.labeled_keep
            if "parse_head_2" in want:
                out["parse_head_2"] = res.parse_head_2
            if "hands" in want:
                out["hands"] = res.hands

        if "dense_uv" in want:
            uv = np.load(os.path.join(
                croot, "dense", im_name.replace("_0.jpg", "_5_uv.npz")))["uv"]
            out["dense_uv"] = resize_chw(uv, (self.height, self.width))

        if "dense_labels" in want:
            lbl = self._open_resized(
                os.path.join(croot, "dense",
                             im_name.replace("_0.jpg", "_5.png")),
                nearest=True)
            out["dense_labels"] = lbl.pixels

        return out


def resize_chw(arr: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a (C, H, W) float array (dense UV maps): half-
    pixel centres, no antialiasing, what ``cv2.resize(INTER_LINEAR)``
    computes on float data (to float32 rounding)."""
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))[None]
    out = F.interpolate(x, size=tuple(hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].numpy()
