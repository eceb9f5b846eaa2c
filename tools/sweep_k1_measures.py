#!/usr/bin/env python3
"""Time K1's two softmax measures at the SD-1.5 head dims, each alone.

    python3 tools/sweep_k1_measures.py

``csrc/flash_attention.cu`` fixes two measures of the D = 40, 80, 160
kernel as constants: ``kPolyShare``, of every 16 exponentials a consumer
thread takes, the number computed on the FMA pipes (``poly_exp2``), and
``Fit::TURNS``, where two consumers take turns on the softmax.  This
script copies the source with one of those lines rewritten (the FMA
share at 0 and 4; the turns nowhere and only at items of one 80-row key
tile), builds each copy and the source as it stands with their own
``nvcc`` in parallel under ``build/kernels/sweep-k1-<hash>/``, and times
each build
at ``chip_smoke.K1_SWEEP_SHAPES`` with the plan's tiling: device ms a
call from a CUDA graph of 20 calls, the builds in turns forward then
backward, each output within ``ATTN_LIMIT`` of the plain version.  It
prints the card's name and power limit first.  Needs CUDA; imports no
JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ladi_vton_tpu_torch.ops import _build  # noqa: E402
from ladi_vton_tpu_torch.ops.attention import attention_ref  # noqa: E402
from ladi_vton_tpu_torch.ops.flash_attention import flash_plan  # noqa: E402

SHARE = "constexpr int kPolyShare = 2;"
TURNS = "static constexpr bool TURNS = NC == 2;"
# (label, line of the source, its replacement)
VARIANTS = [("built", None, None),
            ("share 0", SHARE, "constexpr int kPolyShare = 0;"),
            ("share 4", SHARE, "constexpr int kPolyShare = 4;"),
            ("no turns", TURNS, "static constexpr bool TURNS = false;"),
            ("turns at 80-row tiles", TURNS,
             "static constexpr bool TURNS = NC == 2 && BK == 80;")]


def build_variants() -> dict:
    """Each ``VARIANTS`` entry's ``ladi_flash_attention_fwd``, from a copy
    of ``csrc/flash_attention.cu`` with its line replaced."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = _build.BUILD_ROOT / f"sweep-k1-{_build.source_hash()}"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (label, line, new) in enumerate(VARIANTS):
        if line is not None and src.count(line) != 1:
            raise RuntimeError(f"{label}: {line!r} is not once in the source")
        cu = out / f"k1_{i}.cu"
        cu.write_text(src if line is None else src.replace(line, new))
        lib = out / f"libk1_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        jobs.append((label, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for label, lib, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for K1 {label}:\n{output}")
        fn = ctypes.CDLL(str(lib)).ladi_flash_attention_fwd
        fn.argtypes = _build.SIGNATURES["ladi_flash_attention_fwd"]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("sweep_k1_measures: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    fns = build_variants()
    gen = chip_smoke.Gen(0)
    for B, Sq, Sk, H, D in chip_smoke.K1_SWEEP_SHAPES:
        q, k, v = (gen.normal(B, S, H, D) for S in (Sq, Sk, Sk))
        ref = attention_ref(q.float(), k.float(), v.float())
        plan = flash_plan(D, Sq, Sk, B * H, _build.sm_count(q.device))
        out = torch.empty_like(q)
        times = {label: [] for label in fns}
        for label in list(fns) + list(reversed(fns)):
            def call(fn=fns[label]):
                chip_smoke.k1_launch(fn, q, k, v, out, plan.block_q,
                                     plan.block_k)

            call()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not err <= chip_smoke.ATTN_LIMIT:
                raise AssertionError(f"K1 {label} disagrees: {err}")
            times[label].append(chip_smoke.graph_ms(call, 20))
        print(f"measures B={B} Sq={Sq} Sk={Sk} H={H} D={D} (block_q "
              f"{plan.block_q}, block_k {plan.block_k}): " + ", ".join(
                  f"{label} {sum(ts) / len(ts):.4f} ms ({min(ts):.4f}-"
                  f"{max(ts):.4f})" for label, ts in times.items()),
              flush=True)


if __name__ == "__main__":
    main()
