"""Tracing and throughput helpers.

Counterpart of ``ladi_vton_tpu/utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace of a region (host and CUDA activity) into a
directory, ``annotate`` names a span in it (``record_function``), and
``Throughput`` counts images per second with the card synchronised
(``torch.cuda.synchronize``) before each count, so queued work is not
counted as done.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace into ``log_dir`` (a no-op where it
    is None), readable by TensorBoard's profiler plugin or Perfetto."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield


def annotate(name: str):
    """A named span on the profiler's timeline."""
    return torch.profiler.record_function(name)


def _synchronize(result) -> None:
    tensors = [result] if torch.is_tensor(result) else (
        list(result.values()) if isinstance(result, dict)
        else list(result) if isinstance(result, (list, tuple)) else [])
    devices = {t.device for t in tensors if torch.is_tensor(t) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


class Throughput:
    """Synchronised images/sec measurement."""

    def __init__(self):
        self.images = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        self.images = 0

    def add(self, result, n_images: int):
        """Count ``n_images`` once ``result`` (tensors on the card) is
        computed."""
        _synchronize(result)
        self.images += n_images

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self.images / dt if dt > 0 else 0.0
