"""Parse-map label vocabularies for DressCode and VITON-HD.

The port's copy of ``ladi_vton_tpu/data/labels.py``.  DressCode's
18-class map mirrors reference src/utils/labelmap.py; the VITON-HD
grouping and per-category mask rules follow
src/dataset/vitonhd.py:155-212 and src/dataset/dresscode.py:167-227.
"""

from __future__ import annotations

DRESSCODE_LABELS = {
    "background": 0,
    "hat": 1,
    "hair": 2,
    "sunglasses": 3,
    "upper_clothes": 4,
    "skirt": 5,
    "pants": 6,
    "dress": 7,
    "belt": 8,
    "left_shoe": 9,
    "right_shoe": 10,
    "head": 11,
    "left_leg": 12,
    "right_leg": 13,
    "left_arm": 14,
    "right_arm": 15,
    "bag": 16,
    "scarf": 17,
}

# VITON-HD image-parse-v3 raw label ids (reference vitonhd.py:155-169)
VITONHD_GROUPS = {
    "background": (0, 10),
    "hair": (1, 2),
    "face": (4, 13),
    "upper": (5, 6, 7),
    "bottom": (9, 12),
    "left_arm": (14,),
    "right_arm": (15,),
    "left_leg": (16,),
    "right_leg": (17,),
    "left_shoe": (18,),
    "right_shoe": (19,),
    "socks": (8,),
    "noise": (3, 11),
}

CATEGORIES = ("dresses", "upper_body", "lower_body")

# prompt category text used by train_vto/inference
# (reference src/train_vto.py:548-552)
CATEGORY_PROMPT_TEXT = {
    "dresses": "a dress",
    "upper_body": "an upper body garment",
    "lower_body": "a lower body garment",
}
