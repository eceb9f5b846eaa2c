"""Write the PNG fixtures of the port's PNG reader, with PIL's arrays.

    python tools/make_png_fixtures.py [--out tests/fixtures/png]

One small file per kind of PNG that ``ladi_vton_tpu_torch``'s reader
(``data/imageio.py decode_png``) reads beyond 8-bit L, LA, P, RGB and
RGBA without interlacing: an Adam7-interlaced RGB file, a 4-bit palette
label map of a VITON-HD item (16 classes, as ``optipng`` or ``pngquant``
store a parse map), 1-bit and 16-bit grey, and 16-bit grey+alpha (PIL's
``RGBA``).  The files come from the tests' writer
(``tests/torch_port_png.py``), with random row filters.

Beside each ``<kind>.png`` goes ``<kind>.npy``: the array
``np.asarray(PIL.Image.open(<kind>.png))`` gives, dtype included (bool
for ``1``, uint16 for ``I;16``), and ``fixtures.json`` lists every kind
with PIL's mode and what the file holds.  ``chip_smoke.py`` decodes each
fixture on a machine without PIL and holds it to its array bit for bit;
``tests/test_torch_port_imageio.py`` holds the committed files to PIL.
Needs PIL; the output is deterministic.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import torch_port_png as writer  # noqa: E402

from ladi_vton_tpu_torch.data import resample  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "png"
# the VITON-HD item chip_smoke.py reads: its label map (128x96)
LABEL_MAP = "palette_4bit_label_map"


def _smooth(rng, h: int, w: int, channels: int, top: int) -> np.ndarray:
    coarse = rng.integers(0, 256, (max(h // 12, 2), max(w // 12, 2),
                                   channels), dtype=np.uint8)
    img = resample.resize(coarse, (h, w), resample.BICUBIC).astype(np.int64)
    img = img * top // 255 + rng.integers(0, max(top // 64, 1) + 1,
                                          img.shape)
    return np.clip(img, 0, top)


def fixtures() -> dict:
    """{kind: (PNG bytes, what it holds)}."""
    rng = np.random.default_rng(16)
    coarse = rng.integers(0, 16, (16, 12), dtype=np.uint8)
    labels = resample.resize(coarse, (128, 96), resample.NEAREST)
    i = np.arange(16)
    palette = np.stack([(i * 37) % 256, (i * 91) % 256, (i * 53) % 256],
                       axis=1)
    mask = _smooth(rng, 40, 56, 1, 255)[..., 0] > 127
    return {
        "interlaced_rgb": (
            writer.encode(_smooth(rng, 40, 56, 3, 255), 2, 8,
                          interlace=True, rng=rng),
            "RGB, 8 bits, Adam7-interlaced"),
        LABEL_MAP: (
            writer.encode(labels, 3, 4, palette=palette, rng=rng),
            "palette, 4 bits: a VITON-HD label map of 16 classes"),
        "gray_1bit": (
            writer.encode(mask, 0, 1, rng=rng),
            "grey, 1 bit (PIL's 1): a mask"),
        "gray_16bit": (
            writer.encode(_smooth(rng, 40, 56, 1, 65535)[..., 0], 0, 16,
                          interlace=True, rng=rng),
            "grey, 16 bits (PIL's I;16), Adam7-interlaced"),
        "gray_alpha_16bit": (
            writer.encode(_smooth(rng, 40, 56, 2, 65535), 4, 16, rng=rng),
            "grey+alpha, 16 bits (PIL's RGBA of the high bytes)"),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for kind, (data, what) in fixtures().items():
        (args.out / f"{kind}.png").write_bytes(data)
        im = Image.open(io.BytesIO(data))
        np.save(args.out / f"{kind}.npy", np.asarray(im))
        manifest[kind] = {"mode": im.mode, "what": what}
    (args.out / "fixtures.json").write_text(
        json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.iterdir())
    print(f"{len(manifest)} fixtures in {args.out}, {total} bytes")


if __name__ == "__main__":
    main()
