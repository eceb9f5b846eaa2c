"""Write the JPEG fixtures of the port's decoder, with PIL's pixels.

    python tools/make_jpeg_fixtures.py [--out tests/fixtures/jpeg]

One small file per kind of JPEG that ``ladi_vton_tpu_torch``'s decoder
(``csrc/host/jpeg_decode.cpp``) reads beyond baseline: progressive files
from PIL's writer (its default scan script, grey with restart rows, the
person and cloth of a VITON-HD item), progressive files under other scan
scripts (two that stop early, whose blocks libjpeg smooths),
arithmetic-coded files (SOF9 with a DAC segment and restarts, SOF10),
4:4:0 and 4:1:1 sampling, CMYK from PIL's writer, YCCK,
Adobe-RGB and RGB-labelled colour, a baseline file, and lossless (SOF3)
files: predictors 1 and 7, a point transform of 2 with restarts over
4:2:0, three components in scans of their own (RGB: libjpeg-turbo reads
a lossless frame without a marker so), and the person of a VITON-HD item.
The files PIL cannot write come from the tests' writer
(``tests/torch_port_jpeg.py``).

Beside each ``<kind>.jpg`` goes ``<kind>.png``: the pixels
``np.asarray(PIL.Image.open(<kind>.jpg))`` gives (a CMYK image's four
bytes stored as RGBA), and ``fixtures.json`` lists every kind with PIL's
mode and what the file holds.  ``chip_smoke.py`` decodes each fixture on
a machine without PIL and holds it to its PNG bit for bit;
``tests/test_torch_port_jpeg.py`` holds the committed files to PIL.
Needs PIL; the output is deterministic for a given PIL.
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
import torch_port_jpeg as writer  # noqa: E402

from ladi_vton_tpu_torch.data import resample  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "jpeg"
# the VITON-HD items chip_smoke.py reads: their persons and cloth
PERSON, CLOTH = "progressive_person", "progressive_cloth"
LOSSLESS_PERSON = "lossless_person"


def _smooth(rng, h: int, w: int, channels: int = 3,
            noise: int = 6) -> np.ndarray:
    coarse = rng.integers(0, 256, (max(h // 12, 2), max(w // 12, 2),
                                   channels), dtype=np.uint8)
    img = resample.resize(coarse, (h, w), resample.BICUBIC).astype(np.int16)
    img += rng.integers(-noise, noise + 1, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil(img: np.ndarray, mode=None, **kw) -> bytes:
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def fixtures() -> dict:
    """{kind: (JPEG bytes, what it holds)}."""
    rng = np.random.default_rng(15)
    ycc420 = [(2, 2), (1, 1), (1, 1)]
    w = writer

    def frame(h, wd, sampling, quality=85, ycc=True, channels=3):
        img = _smooth(rng, h, wd, channels)
        planes = w.rgb_to_ycc(img) if ycc else img
        return w.coefficients(planes, sampling, quality)

    gray = frame(40, 56, [(1, 1)], ycc=False, channels=1)
    return {
        "baseline": (_pil(_smooth(rng, 40, 56), quality=90),
                     "baseline 4:2:0, PIL's writer"),
        PERSON: (_pil(_smooth(rng, 128, 96), quality=90, progressive=True),
                 "progressive 4:2:0, PIL's default script (a person)"),
        CLOTH: (_pil(_smooth(rng, 128, 96), quality=90, progressive=True,
                     optimize=True),
                "progressive 4:2:0, PIL's default script (a cloth)"),
        "progressive_gray_restarts": (
            _pil(_smooth(rng, 37, 51), "L", quality=80, progressive=True,
                 restart_marker_rows=1),
            "progressive grey, a restart every MCU row, PIL's writer"),
        "progressive_spectral": (
            w.write(frame(40, 56, ycc420), "progressive",
                    script=w.spectral_selection(3)),
            "progressive 4:2:0, spectral selection only"),
        "progressive_separate_dc": (
            w.write(frame(40, 56, [(2, 1), (1, 1), (1, 1)]), "progressive",
                    script=w.separate_dc(3), restart=2),
            "progressive 4:2:2, a DC scan per component, restarts"),
        "progressive_approximations": (
            w.write(gray, "progressive", script=w.many_approximations(1)),
            "progressive grey, three successive-approximation steps"),
        "progressive_smoothed": (
            w.write(frame(40, 56, ycc420), "progressive",
                    script=w.stops_early(3)),
            "progressive 4:2:0 stopping before its last AC bit (smoothed)"),
        "arithmetic_dc_only": (
            w.write(frame(40, 56, ycc420), "arithmetic_progressive",
                    script=[((0, 1, 2), 0, 0, 0, 1)]),
            "progressive arithmetic, one DC scan (DC and AC smoothed)"),
        "arithmetic": (
            w.write(frame(40, 56, ycc420), "arithmetic", restart=3,
                    dac={("dc", 0): (1, 4), ("ac", 0): 12}),
            "sequential arithmetic (SOF9) 4:2:0, DAC, restarts"),
        "arithmetic_progressive": (
            w.write(frame(40, 56, ycc420), "arithmetic_progressive"),
            "progressive arithmetic (SOF10) 4:2:0, libjpeg's script"),
        "sampling_440": (
            w.write(frame(40, 56, [(1, 2), (1, 1), (1, 1)]), "progressive"),
            "progressive 4:4:0 (h1v2 fancy upsampling)"),
        "sampling_411": (
            w.write(frame(40, 56, [(4, 1), (1, 1), (1, 1)])),
            "baseline 4:1:1 (integral upsampling)"),
        "cmyk": (_pil(_smooth(rng, 40, 56), "CMYK", quality=90),
                 "CMYK with an Adobe marker, PIL's writer"),
        "ycck": (
            w.write(frame(40, 56, [(2, 2), (1, 1), (1, 1), (2, 2)],
                          ycc=False, channels=4), "progressive",
                    markers=w.adobe(2)),
            "progressive YCCK 4:2:0 (Adobe transform 2)"),
        "adobe_rgb": (
            w.write(frame(40, 56, [(1, 1)] * 3, ycc=False),
                    markers=w.adobe(0)),
            "RGB under an Adobe marker with transform 0"),
        "rgb_labelled": (
            w.write(frame(40, 56, [(1, 1)] * 3, ycc=False), "arithmetic",
                    markers=b"", ids=b"RGB"),
            "arithmetic RGB, component ids 'R', 'G', 'B' without JFIF"),
        **lossless_fixtures(np.random.default_rng(16)),
    }


def lossless_fixtures(rng) -> dict:
    """{kind: (JPEG bytes, what it holds)} of the lossless (SOF3) files."""
    w = writer
    gray = w.lossless_frame(_smooth(rng, 40, 56, 1)[..., 0])
    rgb = w.lossless_frame(_smooth(rng, 40, 56))
    sub = w.lossless_frame(_smooth(rng, 40, 56), [(2, 2), (1, 1), (1, 1)])
    ids = w.lossless_frame(_smooth(rng, 40, 56))
    person = w.lossless_frame(_smooth(rng, 128, 96))
    return {
        "lossless_predictor1": (
            w.lossless(gray, psv=1), "lossless grey, predictor 1"),
        "lossless_predictor7": (
            w.lossless(rgb, psv=7, markers=w.adobe(0)),
            "lossless Adobe RGB, predictor 7"),
        "lossless_pt2_restarts": (
            w.lossless(sub, psv=5, pt=2, markers=b"", ids=b"RGB",
                       restart=sub.mcus()[1]),
            "lossless RGB 4:2:0 (replicated), predictor 5, point "
            "transform 2, a restart every MCU row"),
        "lossless_3_components": (
            w.lossless(ids, psv=6, markers=b"", scans=[(0,), (1,), (2,)]),
            "lossless, ids 1, 2, 3 without a marker (RGB in lossless "
            "mode), a scan per component, predictor 6"),
        LOSSLESS_PERSON: (
            w.lossless(person, psv=4, markers=w.adobe(0)),
            "lossless Adobe RGB, predictor 4 (a person)"),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for kind, (data, what) in fixtures().items():
        (args.out / f"{kind}.jpg").write_bytes(data)
        im = Image.open(io.BytesIO(data))
        pixels = np.asarray(im)
        png = Image.fromarray(pixels, "RGBA" if im.mode == "CMYK" else None)
        png.save(args.out / f"{kind}.png", "PNG", optimize=True)
        manifest[kind] = {"mode": im.mode, "what": what}
    (args.out / "fixtures.json").write_text(
        json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.iterdir())
    print(f"{len(manifest)} fixtures in {args.out}, {total} bytes")


if __name__ == "__main__":
    main()
