"""Data-parallel sampling over the mesh.

Counterpart of ``ladi_vton_tpu/parallel/sharding.py``.  The JAX package
places the weights replicated and the batch sharded over ``data`` and
lets XLA run every program data-parallel; the port's ranks each run
their rows, and this is the one mechanism for that, which the mains
(``pipelines.drivers``, ``cli.inference``) and the dry run share:

* ``local_batch(mesh, batch)``: this rank's rows of a global batch and
  the global batch size;
* ``sample_draws(mesh, seed, step, ...)``: batch ``step``'s latent noise
  drawn for the **global** batch and cut to this rank's rows, so a
  W-rank run makes the single process's images up to the numerics of a
  smaller batch (``sample_noise`` is the draw itself);
* each data rank then saves its own items (``drivers.run_batches``),
  where the JAX sampler gathers the batch to every host;
* ``make_sampler(pipe, mesh, ...)``: the run's sampler,
  ``pipe.jit_sample(split=True, denoise_mode="host")`` (CUDA graphs on
  the card) at every mesh: at a model axis above 1 the tensor-parallel
  UNet's ``all_reduce``s cut its step into pieces, one graph each, with
  the ``all_reduce``s run eagerly between them (``pipelines.graphs.
  Graph``), the JAX ``tensor_parallel_sampler``'s one program with the
  per-block all-reduces inside it.

The global batch must divide by ``data``, as in JAX.  The JAX
``eval_placement`` gives the UNet the Megatron plan: here each rank
swaps in its tensor-parallel modules (``parallel.tp.unet_tp``), and the
other weights need no placement, since every rank loads the same ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ladi_vton_tpu_torch.core.mesh import Mesh, shard_batch
from ladi_vton_tpu_torch.core.rng import batch_generator
from ladi_vton_tpu_torch.pipelines.tryon import NOISE_KEYS, VAE_SCALE


def local_batch(mesh: Optional[Mesh], batch: dict) -> tuple:
    """(this rank's rows of ``batch``, the global batch size)."""
    return shard_batch(mesh, batch), len(batch["im_name"])


def sample_noise(generator: torch.Generator, batch_size: int, height: int,
                 width: int, rows: slice = slice(None)) -> dict:
    """The try-on sampler's N(0, 1) draws (``TryOnPipeline._draw``'s order
    and shapes) for a global batch of ``batch_size``, NHWC, cut to
    ``rows``: ``pipe.sample(noise=...)`` then makes those rows' images."""
    lh, lw = height // VAE_SCALE, width // VAE_SCALE
    draws = {k: torch.randn((batch_size, 4, lh, lw), generator=generator,
                            device=generator.device, dtype=torch.float32)
             for k in NOISE_KEYS}
    return {k: v[rows].permute(0, 2, 3, 1) for k, v in draws.items()}


def sample_draws(mesh: Optional[Mesh], seed: int, step: int, device,
                 n: int, height: int, width: int) -> dict:
    """Batch ``step``'s sampler noise (``core.rng.batch_generator(seed,
    step)``) for a global batch of ``n``, cut to this rank's rows."""
    rows = mesh.rows(n) if mesh is not None else slice(None)
    return sample_noise(batch_generator(seed, step, device), n, height,
                        width, rows)


def make_sampler(pipe, mesh: Optional[Mesh], **static) -> Callable:
    """The sampler of a run over ``mesh``: ``TryOnPipeline.jit_sample``'s
    with the static keys ``static``.  Build it after the modules are
    placed and the tensor-parallel UNet swapped in: its graphs read their
    storage.

    The JAX callers take ``split=True`` with the scan; this one takes the
    JAX package's other split mode, ``denoise_mode="host"`` (one step
    graph replayed a step), whose stated use is where building the whole
    loop is impractical: its images are the scan's bit for bit and take
    as long, and its capture takes a step's time, not the loop's, which
    every run, service start and new batch shape pays.  At a model axis
    above 1 that step is in pieces, one for each ``all_reduce`` of the
    UNet and one more."""
    return pipe.jit_sample(split=True, denoise_mode="host", **static)
