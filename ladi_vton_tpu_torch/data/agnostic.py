"""Garment-agnostic person composition (masks + pose maps).

The port's copy of ``ladi_vton_tpu/data/agnostic.py``: the same function
over numpy arrays, with the PIL and cv2 calls replaced.  The silhouette's
BILINEAR down- and upsample runs through ``data/resample.py`` (PIL-exact),
and the keypoint heatmaps, the arm polyline and the 5x5 box dilation run
through the host C++ (``data/native.py``), which raises if it cannot be
built: there is no fallback.

This is the shared core of the two datasets' heavy CPU preprocessing
(reference: src/dataset/dresscode.py:167-360, src/dataset/vitonhd.py:
178-358): parse map + keypoints -> {pose heatmaps, garment-agnostic
keep-mask, inpaint mask, head mask, shape silhouette}.

Dataset quirks preserved on purpose:
* DressCode scales arm-line keypoints by H/512 on BOTH axes
  (dresscode.py:295-300) and uses a constant 45px arm line width;
  VITON-HD pre-scales by (W/768, H/1024) and uses 90/512*H
  (vitonhd.py:303-313).
* keypoints with coords <= 1 are treated as missing, selecting which
  arm polyline is drawn (dresscode.py:301-322).
* neck removal via least-squares shoulder line only for
  dresses/upper_body on DressCode (dresscode.py:330-343); VITON-HD
  skips it (parse_head_2 == parse_head).
* the dilated garment mask is intersected with the *changeable* region
  and unioned with the *fixed* region (dresscode.py:350-353), so
  hair/shoes/etc. always survive inpainting.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ladi_vton_tpu_torch.data import native, resample
from ladi_vton_tpu_torch.data.raster import pose_keypoint_rects

pose_heatmaps = native.pose_heatmaps
box_dilate = native.box_dilate
draw_polyline = native.draw_polyline


@dataclasses.dataclass
class AgnosticResult:
    pose_map: np.ndarray          # (18, H, W) gaussian heatmaps
    im_pose: np.ndarray           # (H, W) union of keypoint squares
    keep_mask: np.ndarray         # (H, W) float 1 = preserved pixel
    inpaint_mask: np.ndarray      # (H, W) float 1 = to inpaint
    parse_head: np.ndarray        # (H, W)
    parse_cloth: np.ndarray       # (H, W)
    shape: np.ndarray             # (H, W) blurred body silhouette in [0,1]
    labeled_keep: np.ndarray      # (H, W) parse_array * keep_mask
    hands: np.ndarray             # (H, W) arms minus drawn arm-lines
    parse_head_2: np.ndarray      # (H, W) head mask after neck removal


def _mask_of(parse: np.ndarray, ids) -> np.ndarray:
    out = np.zeros(parse.shape, np.float32)
    for i in ids:
        out += parse == i
    return out


def _shape_silhouette(parse: np.ndarray, height: int,
                      width: int) -> np.ndarray:
    """Downsample-upsample blur of the body silhouette
    (reference dresscode.py:239-242), PIL's BILINEAR both ways
    (antialiased on the 16x downsample)."""
    sil = ((parse > 0) * 255).astype(np.uint8)
    small = resample.resize(sil, (height // 16, width // 16),
                            resample.BILINEAR)
    big = resample.resize(small, (height, width), resample.BILINEAR)
    return np.asarray(big, np.float32) / 255.0


def _arm_polyline(kp: dict[str, np.ndarray]) -> np.ndarray:
    """Choose the arm polyline by wrist/elbow availability."""
    wl, el, sl = kp["wrist_l"], kp["elbow_l"], kp["shoulder_l"]
    wr, er, sr = kp["wrist_r"], kp["elbow_r"], kp["shoulder_r"]

    def missing(p):
        return p[0] <= 1.0 and p[1] <= 1.0

    if missing(wr):
        pts = ([wl, el, sl, sr] if missing(er) else [wl, el, sl, sr, er])
    elif missing(wl):
        pts = ([sl, sr, er, wr] if missing(el) else [el, sl, sr, er, wr])
    else:
        pts = [wl, el, sl, sr, er, wr]
    return np.asarray(pts, np.float32)


def compose_agnostic(
    parse_array: np.ndarray,
    keypoints: np.ndarray,
    *,
    dataset: str,
    category: str,
    height: int,
    width: int,
    radius: float = 5.0,
    arm_keypoints: np.ndarray | None = None,
) -> AgnosticResult:
    """Build the garment-agnostic masks and pose maps.

    ``parse_array``: (H, W) integer parse labels (dataset vocabulary).
    ``keypoints``: (18, >=2) xy in *target pixel* coordinates (COCO
    order; VITON-HD's body25 must be pre-mapped via
    ``coco_body25_mapping``).  ``arm_keypoints`` optionally overrides the
    coordinates used for arm lines / neck removal (DressCode's H/512
    both-axis scaling quirk).
    """
    H, W = height, width
    parse = parse_array
    kps = keypoints[:, :2].astype(np.float32)
    arm_src = (arm_keypoints[:, :2].astype(np.float32)
               if arm_keypoints is not None else kps)

    if dataset == "dresscode":
        parse_head = _mask_of(parse, (1, 2, 3, 11))
        fixed = _mask_of(parse, (1, 2, 3, 9, 10, 16, 17))
        changeable = _mask_of(parse, (0,))
        arms = _mask_of(parse, (14, 15))
        if category == "dresses":
            parse_cloth = _mask_of(parse, (7,))
            parse_mask = _mask_of(parse, (7, 12, 13))
        elif category == "upper_body":
            parse_cloth = _mask_of(parse, (4,))
            parse_mask = _mask_of(parse, (4,))
            fixed = fixed + _mask_of(parse, (5, 6))
        elif category == "lower_body":
            parse_cloth = _mask_of(parse, (6,))
            parse_mask = _mask_of(parse, (6, 12, 13))
            fixed = fixed + _mask_of(parse, (4, 14, 15))
        else:
            raise ValueError(category)
        changeable = changeable + np.logical_and(
            parse != 0, np.logical_not(fixed > 0))
        arm_width = 45.0
        add_arms = category in ("dresses", "upper_body")
        remove_neck = category in ("dresses", "upper_body")
    elif dataset == "vitonhd":
        parse_head = _mask_of(parse, (1, 2, 4, 13))
        fixed = _mask_of(parse, (1, 2, 18, 19, 9, 12))
        changeable = _mask_of(parse, (0,))
        arms = _mask_of(parse, (14, 15))
        parse_cloth = _mask_of(parse, (5, 6, 7))
        parse_mask = _mask_of(parse, (5, 6, 7))
        changeable = changeable + np.logical_and(
            parse != 0, np.logical_not(fixed > 0))
        arm_width = float(int(90 / 512 * H))
        add_arms = True
        remove_neck = False
    else:
        raise ValueError(dataset)

    r = radius * (H / 512.0)
    pose_rects = pose_keypoint_rects(kps, (H, W), r)
    im_pose = pose_rects.max(axis=0)
    pose_map = pose_heatmaps(kps, (H, W), sigma=9.0)

    # arm lines + hands
    arm_kp = {
        "shoulder_r": arm_src[2], "elbow_r": arm_src[3],
        "wrist_r": arm_src[4], "shoulder_l": arm_src[5],
        "elbow_l": arm_src[6], "wrist_l": arm_src[7],
    }
    im_arms = draw_polyline(H, W, _arm_polyline(arm_kp), arm_width)
    hands = np.logical_and(np.logical_not(im_arms > 0), arms > 0)
    if add_arms:
        parse_mask = parse_mask + im_arms
        fixed = fixed + hands

    # neck removal: zero the head mask below the shoulder line
    parse_head_2 = parse_head.copy()
    if remove_neck:
        sx = np.array([arm_kp["shoulder_r"][0], arm_kp["shoulder_l"][0]])
        sy = np.array([arm_kp["shoulder_r"][1], arm_kp["shoulder_l"][1]])
        A = np.vstack([sx, np.ones(2)]).T
        m, c = np.linalg.lstsq(A, sy, rcond=None)[0]
        offset = 20 * (H / 512.0)
        for i in range(W):
            # NB: no clamping — negative values wrap like the reference's
            # tensor slicing (dresscode.py:343)
            y = int(i * m + c - offset)
            parse_head_2[y:, i] = 0

    fixed = np.logical_or(fixed > 0, parse_head_2 > 0)
    parse_mask = parse_mask + np.logical_or(
        parse_mask > 0,
        np.logical_and(parse_head > 0, np.logical_not(parse_head_2 > 0)),
    )

    parse_mask = box_dilate(parse_mask.astype(np.float32), 5, 5)
    parse_mask = np.logical_and(changeable > 0, np.logical_not(parse_mask > 0))
    keep = np.logical_or(parse_mask, fixed).astype(np.float32)

    return AgnosticResult(
        pose_map=pose_map,
        im_pose=im_pose,
        keep_mask=keep,
        inpaint_mask=(1.0 - keep).astype(np.float32),
        parse_head=parse_head,
        parse_cloth=parse_cloth,
        shape=_shape_silhouette(parse, H, W),
        labeled_keep=(parse.astype(np.float32) * keep),
        hands=hands.astype(np.float32),
        parse_head_2=parse_head_2,
    )


def coco_body25_mapping() -> list[int]:
    """COCO-18 index -> body25 index (reference posemap.py:36-57)."""
    return [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]
