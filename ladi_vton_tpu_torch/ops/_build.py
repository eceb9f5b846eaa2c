"""Build and bind the hand-written Hopper kernels under ``csrc/``.

Each ``.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``; the
compilers run side by side, one process per source.  The build happens
at first use, into ``build/kernels/<hash>/`` at the repository root
(git-ignored), keyed by a hash of the sources and the flags, so an
edited kernel rebuilds and an unchanged one loads at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception, because a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
F = ctypes.c_float

# C signatures of the entry points (csrc/*.cu, extern "C"); every one
# returns the cudaError_t of its launches as an int
SIGNATURES = {
    # q, k, v, o, B, H, Sq, Sk, D, 4 x (stride_b, stride_h, stride_s),
    # scale, block_q, block_k, stream
    "ladi_flash_attention_fwd": [P, P, P, P, I, I, I, I, I]
    + [I64] * 12 + [F, I, I, P],
    # x, weight, bias, weight is fp32, out, B, N, C, G, eps, silu,
    # cluster, channels per range, rows per CTA, threads, smem, stream
    "ladi_group_norm_cluster": [P, P, P, I, P, I, I, I, I, F, I, I, I, I, I,
                                I, P],
    # x, weight, bias, weight is fp32, workspace, counters, coeffs, out,
    # B, N, C, G, eps, silu, chunks, rows per chunk, threads, smem, stream
    "ladi_group_norm_split": [P, P, P, I, P, P, P, P, I, I, I, I, F, I, I,
                              I, I, I, P],
    # split, channels per range, cluster, threads, smem -> clusters the
    # card holds at once
    "ladi_group_norm_max_clusters": [I, I, I, I, I],
    # x, w1, b1, b1 is fp32, a, M, C, I, accumulator width, stream
    "ladi_geglu_proj": [P, P, P, I, P, I, I, I, I, P],
    # a, w2, b2, b2 is fp32, y, fp32 partials, M, I, C, tile width,
    # splits, stream
    "ladi_geglu_out": [P, P, P, I, P, P, I, I, I, I, I, P],
    # x, out, rows, x row stride, prepared weight, bias, C, eps and
    # launch mode (LadiLnParams), lanes | vectors << 8 | warps << 16, grid,
    # stream
    "ladi_layer_norm_fwd": [P, P, I, I64, P, I, I, P],
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels under ladi_vton_tpu_torch/csrc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile each ``csrc/*.cu`` whose hashed library is missing.

    Returns (build directory, seconds spent compiling; 0.0 when cached).
    The compilers' output, with the ``-Xptxas -v`` report of registers,
    shared memory and spills per kernel, is kept in ``nvcc.log`` there.
    """
    out_dir = BUILD_ROOT / source_hash()
    todo = [p for p in _sources() if p.suffix == ".cu"
            and not (out_dir / f"lib{p.stem}.so").exists()]
    if not todo:
        return out_dir, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        # compile to a private name, then rename: a concurrent loader
        # never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, cmd, proc))
    log, failed = [], []
    for src, tmp, cmd, proc in jobs:
        output, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src.name} ({proc.returncode}):\n{output}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    seconds = time.perf_counter() - t0
    with open(out_dir / "nvcc.log", "a") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out_dir, seconds


_library = None
_library_lock = threading.Lock()


def library() -> types.SimpleNamespace:
    """The entry points of all kernel libraries (built on first call).
    Threads that reach it together (a server's first requests) wait for
    one build and one load; later calls take no lock."""
    global _library
    if _library is None:
        with _library_lock:
            if _library is None:
                _library = _load_library()
    return _library


def _load_library() -> types.SimpleNamespace:
    out_dir, _ = build()
    found = {}
    for src in _sources():
        if src.suffix != ".cu":
            continue
        lib = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        for name, argtypes in SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                found[name] = fn
    missing = sorted(set(SIGNATURES) - set(found))
    if missing:
        raise RuntimeError(f"kernel entry points not found: {missing}")
    return types.SimpleNamespace(**found)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(t) -> int:
    """The raw handle of the current stream on t's device (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream or a device object on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
