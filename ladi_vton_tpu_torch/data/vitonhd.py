"""VITON-HD dataset (upper_body only).

Same data contract as the reference's VitonHDDataset
(reference: src/dataset/vitonhd.py): pair file format differs from
DressCode — train/paired use ``<im> <c>`` with c := im, unpaired uses
the listed cloth (vitonhd.py:80-94); parse maps come from
``image-parse-v3`` with VITON-HD's own label vocabulary
(vitonhd.py:155-212); OpenPose body-25 keypoints are mapped to COCO-18
and rescaled from 768x1024 (vitonhd.py:244-248).

The port's copy of ``ladi_vton_tpu/data/vitonhd.py``, reading and
resizing images as ``data/dresscode.py`` does (``data/imageio.py``,
``data/resample.py``), with the same items bit for bit.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ladi_vton_tpu_torch.data import resample
from ladi_vton_tpu_torch.data.agnostic import (
    coco_body25_mapping,
    compose_agnostic,
)
from ladi_vton_tpu_torch.data.dresscode import POSSIBLE_OUTPUTS, _to_float
from ladi_vton_tpu_torch.data.features import ClothFeatureCache
from ladi_vton_tpu_torch.data.imageio import Image, open_image


class VitonHDDataset:
    def __init__(
        self,
        dataroot_path: str,
        phase: str,
        radius: float = 5,
        caption_file: Optional[str] = None,
        order: str = "paired",
        outputlist: Sequence[str] = ("c_name", "im_name", "cloth", "image",
                                     "pose_map", "inpaint_mask", "im_mask",
                                     "category"),
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
        with open(os.path.join(dataroot_path, f"{phase}_pairs.txt")) as f:
            for line in f:
                fields = line.strip().split()
                if phase == "train" or order == "paired":
                    im_name = fields[0]
                    c_name = fields[0]
                else:
                    im_name, c_name = fields[0], fields[1]
                self.im_names.append(im_name)
                self.c_names.append(c_name)

        self.features = None
        if "clip_cloth_features" in self.outputlist:
            self.features = ClothFeatureCache(
                self.cache_root / "clip_cloth_embeddings" / "vitonhd", phase)

    def __len__(self) -> int:
        return len(self.im_names)

    def _open_resized(self, path: str, nearest: bool = False) -> Image:
        method = resample.NEAREST if nearest else resample.BICUBIC
        return open_image(path).resize((self.height, self.width), method)

    def _warped_cloth_path(self, idx: int) -> str:
        sub = ("warped_cloths_unpaired" if self.order == "unpaired"
               else "warped_cloths")
        name = (self.im_names[idx].replace(".jpg", "") + "_"
                + self.c_names[idx])
        return str(self.cache_root / sub / "vitonhd" / "upper_body" / name)

    def __getitem__(self, index: int) -> dict:
        want = set(self.outputlist)
        out: dict = {}
        c_name = self.c_names[index]
        im_name = self.im_names[index]
        phase_root = os.path.join(self.dataroot, self.phase)

        if "c_name" in want:
            out["c_name"] = c_name
        if "im_name" in want:
            out["im_name"] = im_name
        if "category" in want:
            out["category"] = "upper_body"

        if "captions" in want:
            caps = list(self.captions_dict.get(c_name.split("_")[0], []))
            if self.phase == "train":
                random.shuffle(caps)
            out["captions"] = ", ".join(caps)

        if "clip_cloth_features" in want:
            out["clip_cloth_features"] = self.features.get(c_name)

        if "cloth" in want:
            out["cloth"] = _to_float(self._open_resized(
                os.path.join(phase_root, "cloth", c_name)))

        image = None
        if want & {"image", "im_head", "im_cloth", "im_mask"}:
            image = _to_float(self._open_resized(
                os.path.join(phase_root, "image", im_name)))
            if "image" in want:
                out["image"] = image

        if "warped_cloth" in want:
            wc = open_image(self._warped_cloth_path(index)).resize(
                (self.height, self.width), resample.BICUBIC)
            out["warped_cloth"] = _to_float(wc)

        if "skeleton" in want:
            out["skeleton"] = _to_float(self._open_resized(os.path.join(
                phase_root, "openpose_img",
                im_name.replace(".jpg", "_rendered.png"))))

        mask_keys = {"im_pose", "im_mask", "parse_mask_total", "parse_array",
                     "pose_map", "shape", "im_head", "inpaint_mask",
                     "im_cloth", "hands", "parse_head_2"}
        if want & mask_keys:
            parse = self._open_resized(
                os.path.join(phase_root, "image-parse-v3",
                             im_name.replace(".jpg", ".png")),
                nearest=True).pixels
            with open(os.path.join(
                    phase_root, "openpose_json",
                    im_name.replace(".jpg", "_keypoints.json"))) as f:
                body25 = np.asarray(
                    json.load(f)["people"][0]["pose_keypoints_2d"],
                    np.float32).reshape(-1, 3)[:, :2]
            body25[:, 0] *= self.width / 768.0
            body25[:, 1] *= self.height / 1024.0
            kps = body25[coco_body25_mapping()]

            res = compose_agnostic(
                parse, kps, dataset="vitonhd", category="upper_body",
                height=self.height, width=self.width, radius=self.radius,
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

        return out
