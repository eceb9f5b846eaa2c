"""Decode a dataset's JPEGs once, for the PyTorch port.

    python tools/decode_images.py <dataset root> [<more roots>] [--force]

The port (``ladi_vton_tpu_torch``) reads images without PIL.  Its own
decoder reads bit for bit as PIL does every JPEG PIL reads, lossless
(SOF3) ones included, so no dataset needs a sidecar any more; it refuses
only 12-bit, DNL, hierarchical and lossless arithmetic (SOF11) frames,
which PIL cannot decode either.  This tool walks each root, and the
warped-cloth and CLIP-feature cache the datasets read beside it
(``<root>/../cache``, their default ``cache_root``), and writes beside
every other file with JPEG content a lossless PNG of the pixels exactly
as ``PIL.Image.open`` decodes them: ``000000_0.jpg`` gets
``000000_0.jpg.png``.  It writes none for an 8-bit lossless (SOF3) JPEG,
which the port reads itself, and counts those apart.  The port's
``data/imageio.py`` reads a sidecar in place of a JPEG its decoder does
not read, and ignores one beside a JPEG it reads.

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


def port_reads(path: Path) -> bool:
    """Whether the port's decoder reads this JPEG where earlier ones
    needed a sidecar: its frame (the first SOFn marker, before any scan)
    is lossless Huffman (SOF3) with 8-bit samples."""
    data = path.read_bytes()
    pos = 2
    while pos + 5 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker == 0xC3 and data[pos + 4] == 8
        if marker == 0xDA:
            break
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return False


def _decode(path: Path, side: Path) -> None:
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB"):
            raise ValueError(f"{path}: a {im.mode} JPEG; sidecars hold L "
                             f"and RGB images")
        tmp = side.with_name(side.name + ".tmp")
        im.save(tmp, format="PNG")
    os.replace(tmp, side)


def decode_tree(root, *, force: bool = False,
                workers: int = 1) -> tuple[int, int, int]:
    """Write the missing or stale sidecars under ``root`` with ``workers``
    processes (1: in this one); returns (written, kept, lossless), the
    last the 8-bit lossless JPEGs left without one."""
    todo, kept, lossless = [], 0, 0
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            path = Path(dirpath) / name
            if not is_jpeg(path):
                continue
            if port_reads(path):
                lossless += 1
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
    return len(todo), kept, lossless


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
            written, kept, lossless = decode_tree(
                tree, force=args.force, workers=os.cpu_count() or 1)
            print(f"{tree}: {written} sidecars written, {kept} up to date, "
                  f"{lossless} lossless JPEGs need none (the port reads "
                  f"them)")


if __name__ == "__main__":
    main()
