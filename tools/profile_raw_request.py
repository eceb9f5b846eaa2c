#!/usr/bin/env python3
"""Profile one raw try-on request through the PyTorch port on one GPU.

    python3 tools/profile_raw_request.py [--images 2] [--out DIR]

Builds what ``chip_smoke.py`` phase 5 builds (full-width towers with
seeded random weights, ``ConditionService`` -> ``TryOnService`` at
512x384, DDIM-50, CFG 7.5, batch 2), answers one warm-up request, then
for each stage of one request (the conditioning's warp and embeddings,
then the try-on) reports:

- seconds on the host clock after ``torch.cuda.synchronize()``, without
  the profiler;
- peak device memory (``max_memory_allocated`` after a reset);
- under ``torch.profiler``: wall seconds, device kernel time, the busy
  share (kernel time over wall), the number of kernels, device time by
  kernel class and the heaviest kernels by name.

Then K5's (LayerNorm) calls and device microseconds per shape in the
conditioning and in the try-on, from a trace of the device alone: a
shape's calls are told apart by the kernel instantiation, grid and block
that ``layer_norm_plan`` gives it.

It runs with PyTorch's default math modes (cuDNN TF32 allowed, matmul
TF32 off), as a user of the port would, and adds one diagnostic stage:
the refinement alone with cuDNN TF32 off.

Prints one line per stage and writes everything to
``<out>/profile_raw_request.json`` (default ``build/profile``, which git
ignores).  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ladi_vton_tpu_torch.pipelines.serving import (  # noqa: E402
    ConditionService,
    TryOnService,
    pad_batch,
)

# kernel name fragments -> class, first match wins
CLASSES = (
    ("K1 flash attention", ("flash_fwd",)),
    ("K2 GroupNorm", ("gn_cluster", "gn_split")),
    ("K4 GEGLU", ("geglu",)),
    ("K5 LayerNorm", ("ln_kernel",)),
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "fft",
                     "nchw", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "gemv", "cublas",
                         "nvjet")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy / layout", ("copy", "cat", "transpose", "permute", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def device_kernels(prof) -> list[tuple[str, int, float]]:
    """(name, calls, device ms) of every device kernel."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key, evt.count,
                         evt.self_device_time_total / 1e3))
    return rows


def measure(fn, label: str) -> dict:
    """Host seconds, peak memory, then the same call under the profiler."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(ms for _, _, ms in kernels)
    by_class: dict[str, float] = {}
    for name, _, ms in kernels:
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    ranked = sorted(kernels, key=lambda r: -r[2])
    top = ranked[:12]
    result = {
        "stage": label, "seconds": seconds, "peak_gib": peak,
        "profiled_wall_ms": wall * 1e3, "device_kernel_ms": busy,
        "busy_share": busy / (wall * 1e3),
        "kernels": sum(n for _, n, _ in kernels),
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top": [{"name": n[:120], "calls": c, "ms": ms} for n, c, ms in top],
        "all": [{"name": n[:160], "calls": c, "ms": ms}
                for n, c, ms in ranked],
    }
    print(f"{label}: {seconds:.4f} s, peak {peak:.2f} GiB; profiled wall "
          f"{wall * 1e3:.2f} ms, device kernels {busy:.2f} ms (busy share "
          f"{busy / (wall * 1e3):.4f}), {result['kernels']} kernels; by "
          f"class (ms): " + ", ".join(
              f"{k} {v:.2f}" for k, v in result["by_class_ms"].items()),
          flush=True)
    for row in result["top"]:
        print(f"    {row['ms']:9.3f} ms {row['calls']:6d} x {row['name']}")
    return result


def layer_norm_by_shape(fn, label: str, out: pathlib.Path) -> list:
    """K5's calls and device time per path shape in one call of fn."""
    shapes: dict = {}
    for M, C, cls in chip_smoke.LN_SHAPES[:7]:
        p = chip_smoke.ln_plan(M, C, 257 * C if cls else C)
        shapes.setdefault((p.lanes, p.vectors, p.grid, 32 * p.warps),
                          []).append(f"{M}x{C}" + (" strided" if cls else ""))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = out / "layer_norm_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    found: dict = {}
    for e in events:
        m = re.search(r"ln_kernel<(\d+), (\d+)>", e.get("name", ""))
        if e.get("cat") == "kernel" and m:
            args = e.get("args", {})
            key = (int(m[1]), int(m[2]), args.get("grid", [0])[0],
                   args.get("block", [0])[0])
            calls, us = found.get(key, (0, 0.0))
            found[key] = (calls + 1, us + e["dur"])
    rows = []
    for (lanes, vectors, grid, block), (calls, us) in sorted(
            found.items(), key=lambda kv: -kv[1][1]):
        shape = " or ".join(shapes.get((lanes, vectors, grid, block),
                                       ["not a path shape"]))
        rows.append({"shape": shape, "lanes": lanes, "vectors": vectors,
                     "grid": grid, "block": block, "calls": calls,
                     "us_each": us / calls, "ms": us / 1e3})
        print(f"    K5 in {label}: {calls:5d} x {shape} (ln_kernel<{lanes}, "
              f"{vectors}>, {grid} x {block}): {us / calls:.2f} us each, "
              f"{us / 1e3:.3f} ms", flush=True)
    return rows


@torch.no_grad()
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--images", type=int, default=2)
    parser.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_raw_request: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    service = TryOnService(chip_smoke.full_width_pipeline(), batch_size=2,
                           height=512, width=384, num_inference_steps=50,
                           guidance_scale=7.5, context_dim=1024, seed=0)
    tokenizer = chip_smoke.synthetic_tokenizer(
        pathlib.Path(tempfile.mkdtemp(prefix="profile_tokenizer_")))
    cond = ConditionService(
        chip_smoke.conditioner("cuda", (512, 384), tokenizer), tokenizer,
        batch_size=2, num_vstar=chip_smoke.NUM_VSTAR)
    raw = chip_smoke.raw_request(np.random.default_rng(1), args.images, 512,
                                 384)
    c = cond.conditioner
    pose, cloth, mask = (torch.from_numpy(
        pad_batch(raw[k], cond.batch_size)).cuda()
        for k in ("pose_map", "cloth", "im_mask"))
    ids = torch.from_numpy(pad_batch(tokenizer(
        cond.prompts(raw["categories"])), cond.batch_size)).cuda()
    ref_in = torch.cat([mask, pose, cloth], dim=-1).permute(0, 3, 1, 2)
    state = {}

    def refinement_no_tf32():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            c.refinement(ref_in)

    def condition():
        state["out"] = cond.run(cloth=raw["cloth"], pose_map=raw["pose_map"],
                                im_mask=raw["im_mask"],
                                categories=raw["categories"])

    def try_on():
        warped, embeds, negative = state["out"]
        service.generate(image=raw["image"],
                         inpaint_mask=raw["inpaint_mask"],
                         pose_map=raw["pose_map"], warped_cloth=warped,
                         prompt_embeds=embeds,
                         negative_prompt_embeds=negative)

    condition()
    try_on()  # warm-up
    results = [measure(lambda: c.warp(pose, cloth, mask),
                       "conditioning: warp (TPS, grid sample, refinement)"),
               measure(lambda: c.refinement(ref_in),
                       "conditioning: refinement alone, fp32"),
               measure(refinement_no_tf32,
                       "diagnostic: refinement alone, fp32, cuDNN TF32 off"),
               measure(lambda: c.embeddings(cloth, ids),
                       "conditioning: embeddings (CLIP vision, adapter, "
                       "text x2)"),
               measure(condition, "conditioning (ConditionService.run)"),
               measure(try_on, "try-on (TryOnService.generate)")]
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    k5 = {"conditioning": layer_norm_by_shape(condition, "conditioning", out),
          "try-on": layer_norm_by_shape(try_on, "try-on", out)}
    (out / "profile_raw_request.json").write_text(json.dumps(
        {"card": card, "images": args.images, "stages": results,
         "layer_norm_by_shape": k5}, indent=1))


if __name__ == "__main__":
    main()
