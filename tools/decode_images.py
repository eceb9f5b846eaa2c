"""Decode a dataset's JPEGs once, for the PyTorch port.

    python tools/decode_images.py <dataset root> [<more roots>] [--force]

The port (``ladi_vton_tpu_torch``) reads images without PIL.  Its own
decoder reads baseline JPEGs (the datasets' and the mains' own files)
bit for bit as PIL does; a progressive, arithmetic-coded, 12-bit or
Adobe/CMYK JPEG needs a sidecar.  This tool walks each root, and the
warped-cloth and CLIP-feature cache the datasets read beside it
(``<root>/../cache``, their default ``cache_root``), and writes beside
every file with JPEG content a lossless PNG of the pixels exactly as
``PIL.Image.open`` decodes them: ``000000_0.jpg`` gets
``000000_0.jpg.png``.  The port's ``data/imageio.py`` reads a sidecar
in place of a JPEG its decoder does not read, so its datasets give the
JAX package's pixels bit for bit.

Run it once where PIL is installed, then copy the tree (sidecars
included) to the machine that runs the port; it decodes in one process
per CPU core.  It is idempotent: a sidecar newer than its JPEG is kept,
unless ``--force``.  A sidecar, being lossless, is several times the
size of its JPEG.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from PIL import Image

JPEG_SOI = b"\xff\xd8\xff"
SIDECAR_SUFFIX = ".png"


def is_jpeg(path: Path) -> bool:
    with open(path, "rb") as f:
        return f.read(3) == JPEG_SOI


def _decode(path: Path, side: Path) -> None:
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB"):
            raise ValueError(f"{path}: a {im.mode} JPEG; the port reads L "
                             f"and RGB images")
        tmp = side.with_name(side.name + ".tmp")
        im.save(tmp, format="PNG")
    os.replace(tmp, side)


def decode_tree(root, *, force: bool = False,
                workers: int = 1) -> tuple[int, int]:
    """Write the missing or stale sidecars under ``root`` with ``workers``
    processes (1: in this one); returns (written, kept)."""
    todo, kept = [], 0
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            path = Path(dirpath) / name
            if not is_jpeg(path):
                continue
            side = Path(str(path) + SIDECAR_SUFFIX)
            if (not force and side.exists()
                    and side.stat().st_mtime >= path.stat().st_mtime):
                kept += 1
            else:
                todo.append((path, side))
    if workers > 1 and len(todo) > 1:
        with ProcessPoolExecutor(workers) as pool:
            list(pool.map(_decode, *zip(*todo), chunksize=16))
    else:
        for path, side in todo:
            _decode(path, side)
    return len(todo), kept


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+",
                        help="dataset roots (a DressCode or VITON-HD tree)")
    parser.add_argument("--force", action="store_true",
                        help="rewrite every sidecar")
    parser.add_argument("--no_cache", action="store_true",
                        help="skip the cache directory beside each root")
    args = parser.parse_args(argv)
    for root in args.roots:
        trees = [Path(root)]
        cache = Path(root).parent / "cache"
        if not args.no_cache and cache.is_dir():
            trees.append(cache)
        for tree in trees:
            written, kept = decode_tree(tree, force=args.force,
                                        workers=os.cpu_count() or 1)
            print(f"{tree}: {written} sidecars written, {kept} up to date")


if __name__ == "__main__":
    main()
