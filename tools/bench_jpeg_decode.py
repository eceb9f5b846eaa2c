"""Time the port's JPEG decoder on the host, by kind of file.

    python tools/bench_jpeg_decode.py [--repo DIR] [--reps 20]
    python tools/bench_jpeg_decode.py --against OTHER [--against ...]
        [--rounds 200]

One 1024x768 image (the datasets' size, ``data/synthetic.py``'s smooth
content) is quantised once at quality 95, 4:2:0, and the same
coefficients are written three ways by the tests' writer
(``tests/torch_port_jpeg.py``): baseline (the standard Huffman tables, as
PIL writes by default), progressive (libjpeg's default script with
optimised tables, as PIL writes with ``progressive=True``) and sequential
arithmetic-coded.  The same image's pixels are also written lossless
(SOF3, predictor 1, RGB under an Adobe marker, Huffman tables fitted to
it); ``interlaced_png`` gives them as an Adam7-interlaced PNG
(``tests/torch_port_png.py``), which ``chip_smoke.py`` times beside.

Alone, each file is decoded ``--reps`` times by
``ladi_vton_tpu_torch/data/native.py jpeg_decode`` of the checkout at
``--repo`` (default: this one; its host library is built there at first
use), on the host clock, after one untimed decode; one JSON line per
kind gives the file's bytes and the decode's median, minimum and maximum
milliseconds, or ``"refused"`` where that checkout's decoder does not
read the kind.

With ``--against OTHER`` (another checkout, for example the parent
commit unpacked by ``git archive``; repeated for several) the decoders
are loaded in this one process and timed in turn, decode by decode:
``--rounds`` rounds of one decode each, the order rotated from one round
to the next.  One JSON line per kind and other checkout that reads it
gives both sides' quartiles (first, median, third) and those of the
rounds' ratios ``repo / against``.

Needs no PIL; ``chip_smoke.py`` times the same files.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SIZE = (1024, 768)
QUALITY = 95
KINDS = ("baseline", "progressive", "arithmetic")
LOSSLESS = "lossless"


def load(path: Path, name: str):
    """The module at ``path``, registered as ``name`` (its dataclasses
    look themselves up there), leaving ``sys.path`` as it is."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def native(repo: Path, name: str = "bench_native"):
    """The checkout's ``data/native.py``, which builds its own library."""
    return load(repo / "ladi_vton_tpu_torch" / "data" / "native.py", name)


def timing_image(seed: int = 0) -> np.ndarray:
    """The (1024, 768, 3) uint8 image every timing file holds."""
    from ladi_vton_tpu_torch.data import synthetic

    return synthetic._smooth(np.random.default_rng(seed), SIZE)


def _writer(name: str):
    return load(ROOT / "tests" / f"torch_port_{name}.py",
                f"bench_{name}_writer")


def timing_files(seed: int = 0) -> dict:
    """{kind: JPEG bytes}: one image's coefficients in each kind."""
    w = _writer("jpeg")
    frame = w.coefficients(w.rgb_to_ycc(timing_image(seed)),
                           [(2, 2), (1, 1), (1, 1)], QUALITY)
    return {kind: w.write(frame, kind) for kind in KINDS}


def lossless_file(seed: int = 0) -> bytes:
    """The image's pixels as a lossless JPEG, which decodes to them."""
    w = _writer("jpeg")
    return w.lossless(w.lossless_frame(timing_image(seed)), psv=1,
                      markers=w.adobe(0))


def interlaced_png(seed: int = 0) -> bytes:
    """The image's pixels as an Adam7-interlaced 8-bit RGB PNG, each row
    with the filter of the least sum of absolute bytes."""
    return _writer("png").encode(timing_image(seed), 2, 8, interlace=True)


def decode_ms(decode, data: bytes, reps: int) -> list:
    """Milliseconds of each of ``reps`` decodes, after an untimed one."""
    decode(data)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode(data)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def rotating_ms(decoders: list, data: bytes, rounds: int) -> list:
    """[[ms of each round] for each decoder]: ``rounds`` rounds of one
    decode each, round i starting with decoder i mod n, after one untimed
    decode each."""
    for decode in decoders:
        decode(data)
    n = len(decoders)
    out = [[] for _ in decoders]
    for i in range(rounds):
        for j in range(n):
            side = (i + j) % n
            t0 = time.perf_counter()
            decoders[side](data)
            out[side].append((time.perf_counter() - t0) * 1e3)
    return out


def quartiles(xs: list) -> list:
    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def summary(ms: list) -> dict:
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "reps": len(ms)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", type=Path, default=ROOT,
                        help="the checkout whose decoder is timed")
    parser.add_argument("--against", type=Path, action="append",
                        default=[], help="another checkout, timed in turn "
                        "with this one (repeatable)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=200)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))  # run as a script: the port's package
    ours = native(args.repo.resolve())
    others = [native(p.resolve(), f"bench_native_{i}")
              for i, p in enumerate(args.against)]

    files = dict(timing_files(), **{LOSSLESS: lossless_file()})
    for kind, data in files.items():
        row = {"repo": str(args.repo), "kind": kind, "bytes": len(data),
               "size": list(SIZE)}
        if kind != LOSSLESS:
            row["quality"] = QUALITY
        want = ours.jpeg_decode(data)
        if want is None:
            print(json.dumps(dict(row, refused=True)), flush=True)
            continue
        if not others:
            row.update(summary(decode_ms(ours.jpeg_decode, data,
                                         args.reps)))
            print(json.dumps(row), flush=True)
            continue
        reading = [(p, o) for p, o in zip(args.against, others)
                   if o.jpeg_decode(data) is not None]
        for p, o in reading:
            if not np.array_equal(o.jpeg_decode(data), want):
                raise AssertionError(f"{kind}: {p}'s decode differs")
        ms = rotating_ms([ours.jpeg_decode] + [o.jpeg_decode
                                               for _, o in reading],
                         data, args.rounds)
        for p in args.against:
            line = dict(row, against=str(p))
            if p not in [q for q, _ in reading]:
                line["against_refused"] = True
            else:
                b = ms[1 + [q for q, _ in reading].index(p)]
                line.update({
                    "rounds": args.rounds,
                    "q1_median_q3_ms": quartiles(ms[0]),
                    "against_q1_median_q3_ms": quartiles(b),
                    "ratio_q1_median_q3": quartiles(
                        [x / y for x, y in zip(ms[0], b)])})
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
