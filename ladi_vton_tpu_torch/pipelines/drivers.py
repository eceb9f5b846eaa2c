"""Batch drivers of the CLIs: generate images over a loader and save them.

Counterpart of ``ladi_vton_tpu/pipelines/drivers.py`` (the reference's
src/utils/image_from_pipe.py):

* ``generate_images_from_tryon_pipe`` (:26-136): per batch, the prompt's
  text embeddings (inversion-adapter pseudo-words from the cloth's CLIP
  features or a feature cache, noun chunks, or no text), the try-on
  pipeline, the per-category save;
* ``extract_save_vae_images`` (:221-258): VAE + EMASC reconstructions;
* ``run_batches``, the loop both use, and the ``inference`` CLI with the
  conditioning stage in front of the try-on.

Batch ``step``'s noise comes from ``core.rng.batch_generator(seed,
step)`` in place of the JAX ``fold_in(root_key, step)``.  Images are
quantised to uint8 on their device (round half to even, as ``np.round``)
and written by ``_PipelinedSaver`` from a thread: batch N's images are
copied without blocking into pinned host memory behind a CUDA event, and
fetched and written while batch N+1 runs.  Files are PNG (``--use_png``)
or the port's baseline JPEG at quality 95 (``data/imageio.py``); a name
seen before in the run (``pad_last``'s repeats) is skipped.

Each run builds its programs once, as the JAX package's ``drivers.py``
jits them (``pipelines.graphs.Program``: CUDA graphs captured at the
first batch of each shape and replayed on the card, the eager call on
the CPU, the same images either way): the prompts' encoding
(``prompt_program``, the JAX ``encode_text``, one per ``text_usage``),
the vision tower on the cloth (``condition.vision_program``, the JAX
``vision_feats``), the try-on sampler (``parallel.sharding.make_sampler``:
``TryOnPipeline.jit_sample``) and the VAE reconstruction (the JAX
``recon``, whose posterior draw is made eagerly and copied in).  The
uint8 quantisation stays an eager pass over the program's output.
Over a mesh (``core.mesh``, the JAX ``mesh=`` argument) ``step_fn`` gets
the global batch and returns its rank's rows (``parallel.sharding``'s
``local_batch`` and ``sample_draws`` cut the batch and the global
batch's noise), each data rank saves its own items, and only model rank 0 of
each data rank writes; the batch size must divide by ``data``.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.core.mesh import Mesh, shard_batch
from ladi_vton_tpu_torch.core.rng import batch_generator
from ladi_vton_tpu_torch.data import imageio
from ladi_vton_tpu_torch.diffusion.text import encode_text_word_embedding
from ladi_vton_tpu_torch.models.emasc import mask_features
from ladi_vton_tpu_torch.models.vae import DiagonalGaussian
from ladi_vton_tpu_torch.parallel.sharding import (
    local_batch,
    make_sampler,
    sample_draws,
)
from ladi_vton_tpu_torch.pipelines.condition import vision_program
from ladi_vton_tpu_torch.pipelines.graphs import Program
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.pipelines.tryon import EMASC_INT_LAYERS

JPEG_QUALITY = 95


def _quantize_u8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images -> uint8 on their device (the fetch moves 4x
    fewer bytes); ``torch.round`` rounds half to even."""
    x = images.float().clamp(0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)


def _save_images(images: np.ndarray, names, categories, save_dir: str,
                 seen: set, use_png: bool = False) -> None:
    for img, name, cat in zip(images, names, categories):
        if (cat, name) in seen:  # pad_last repeats
            continue
        seen.add((cat, name))
        cat_dir = os.path.join(save_dir, cat)
        os.makedirs(cat_dir, exist_ok=True)
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (img * 255).round().astype(np.uint8)
        if use_png:
            imageio.write_png(
                os.path.join(cat_dir, name.replace(".jpg", ".png")), img)
        else:
            imageio.write_jpeg(os.path.join(cat_dir, name), img,
                               JPEG_QUALITY)


class _PipelinedSaver:
    """Fetch and write batch N while batch N+1 runs.

    ``push`` starts a non-blocking copy of the (device) uint8 images into
    pinned host memory, records a CUDA event behind it, and hands both to
    a writer thread, which waits on the event and writes the files.  At
    most one batch is in the writer's hands: ``push`` first waits for the
    previous one.  ``flush`` waits for the last; a writer's exception is
    raised from ``push`` or ``flush``.
    """

    def __init__(self, save_dir: str, use_png: bool = False):
        self.save_dir = save_dir
        self.use_png = use_png
        self.seen: set = set()
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def _write(self, host: torch.Tensor, event, names, cats) -> None:
        if event is not None:
            event.synchronize()
        _save_images(host.numpy(), names, cats, self.save_dir, self.seen,
                     self.use_png)

    def push(self, images: torch.Tensor, names, categories) -> None:
        self._wait()
        event = None
        if images.is_cuda:
            host = torch.empty(images.shape, dtype=images.dtype,
                               pin_memory=True)
            host.copy_(images, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = images
        self._pending = self._pool.submit(self._write, host, event,
                                          list(names), list(categories))

    def _wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def flush(self) -> None:
        self._wait()

    def close(self) -> None:
        self.flush()
        self._pool.shutdown()


def _to(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)


def run_batches(loader, step_fn: Callable, save_dir: str, *,
                use_png: bool = False, what: str = "generate",
                mesh: Optional[Mesh] = None) -> dict:
    """``step_fn(step, batch)`` -> float images in [0, 1] (B, H, W, 3) for
    every batch of ``loader``, saved under ``save_dir/<category>/``; over
    a ``mesh``, the images of this rank's rows, saved by model rank 0.

    Prints a progress line per batch and returns the run's numbers: the
    distinct items of the run, the wall seconds and images per second
    of the whole loop (host clock, the last write included), and the
    seconds the loop waited for the loader, per batch."""
    os.makedirs(save_dir, exist_ok=True)
    writes = mesh is None or mesh.model_index == 0
    saver = _PipelinedSaver(save_dir, use_png)
    seen: set = set()  # (category, name) of every global batch so far
    t0 = time.perf_counter()
    waited, steps = 0.0, 0
    batches = iter(loader)
    total = len(loader)
    try:
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            waited += time.perf_counter() - t
            if batch is None:
                break
            images = step_fn(steps, batch)
            # a pad_last repeat is saved by no rank
            first = []
            for key in zip(batch["category"], batch["im_name"]):
                first.append(key not in seen)
                seen.add(key)
            local = shard_batch(mesh, {"first": first, **batch})
            keep = [i for i, f in enumerate(local["first"]) if f]
            if writes and keep:
                saver.push(_quantize_u8(images[keep]),
                           [local["im_name"][i] for i in keep],
                           [local["category"][i] for i in keep])
            steps += 1
            print(f"{what}: batch {steps}/{total} "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
    finally:
        saver.close()
    seconds = time.perf_counter() - t0
    return {"images": len(seen), "batches": steps, "seconds": seconds,
            "images_per_second": len(seen) / seconds,
            "loader_seconds_per_batch": waited / max(steps, 1)}


@torch.no_grad()
def encode_prompts(text_model, input_ids: torch.Tensor,
                   empty_ids: torch.Tensor, *, adapter=None,
                   clip_features: Optional[torch.Tensor] = None,
                   num_vstar: int = 16):
    """(prompt_embeds, negative_prompt_embeds): with an ``adapter``, its
    pseudo-words from ``clip_features`` are spliced into the prompt's
    ``$`` run; the negative prompt is the empty one."""
    if adapter is not None:
        ptes = adapter(clip_features)
        ehs, _ = encode_text_word_embedding(text_model, input_ids, ptes,
                                            num_vstar)
    else:
        ehs, _ = text_model(input_ids)
    neg, _ = text_model(empty_ids.to(input_ids.device).expand_as(input_ids))
    return ehs, neg


def prompt_program(text_model, empty_ids: torch.Tensor, *, adapter=None,
                   num_vstar: int = 16) -> Program:
    """``encode_prompts`` as the JAX ``encode_text`` program:
    ``program(input_ids, clip_features)`` with an ``adapter``,
    ``program(input_ids)`` without."""
    device = text_model.text_model.final_layer_norm.weight.device
    if adapter is None:
        return Program(lambda ids: encode_prompts(text_model, ids, empty_ids),
                       device=device, modules=(text_model,))
    return Program(
        lambda ids, feats: encode_prompts(
            text_model, ids, empty_ids, adapter=adapter,
            clip_features=feats, num_vstar=num_vstar),
        device=device, modules=(text_model, adapter))


def generate_images_from_tryon_pipe(
    pipe,
    text_model,
    tokenizer,
    loader,
    save_dir: str,
    *,
    inversion_adapter=None,
    vision=None,
    text_usage: str = "inversion_adapter",
    num_vstar: int = 16,
    seed: int = 1234,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    use_png: bool = False,
    cloth_input_type: str = "warped",
    cloth_cond_rate: float = 1.0,
    no_pose: bool = False,
    mesh: Optional[Mesh] = None,
) -> dict:
    """Generate try-on images for every batch in ``loader``.

    Batches carry image, inpaint_mask, pose_map, im_name and category,
    with warped_cloth for ``cloth_input_type="warped"``, and for the
    inversion adapter clip_cloth_features, or cloth for the ``vision``
    tower; captions for ``text_usage="noun_chunks"``.  ``mesh``: each
    data rank generates its rows of every batch (``run_batches``).
    Returns ``run_batches``' numbers."""
    if text_usage not in ("inversion_adapter", "noun_chunks", "none"):
        raise ValueError(f"unknown text_usage {text_usage!r}")
    if cloth_input_type not in ("warped", "none"):
        raise ValueError(f"unknown cloth_input_type {cloth_input_type!r}")
    device = pipe.device
    towers = text_model.text_model.final_layer_norm.weight.dtype
    empty_ids = torch.from_numpy(
        np.asarray(tokenizer([""]))[0].astype(np.int64)).to(device)
    # the run's programs, their graphs captured at the first batch (and
    # again for a last batch of another size), as the JAX package jits
    # them once
    sampler = make_sampler(pipe, mesh,
                           num_inference_steps=num_inference_steps,
                           guidance_scale=guidance_scale,
                           cloth_cond_rate=cloth_cond_rate, no_pose=no_pose)
    adapter = inversion_adapter if text_usage == "inversion_adapter" else None
    encode = prompt_program(text_model, empty_ids, adapter=adapter,
                            num_vstar=num_vstar)
    vision_feats = (vision_program(vision, towers)
                    if adapter is not None and vision is not None else None)

    def step_fn(step: int, batch: dict) -> torch.Tensor:
        batch, total = local_batch(mesh, batch)
        n = len(batch["im_name"])
        feats = ()
        if text_usage == "inversion_adapter":
            if "clip_cloth_features" in batch:
                feats = (_to(batch["clip_cloth_features"], device, towers),)
            else:
                feats = (vision_feats(_to(batch["cloth"], device)),)
            prompts = category_prompts(batch["category"], num_vstar)
        elif text_usage == "noun_chunks":
            prompts = list(batch["captions"])
        else:
            prompts = [""] * n
        input_ids = _to(np.asarray(tokenizer(prompts)), device, torch.long)
        ehs, neg = encode(input_ids, *feats)
        warped = (_to(batch["warped_cloth"], device)
                  if cloth_input_type == "warped" else None)
        _, H, W, _ = batch["image"].shape
        return sampler(
            _to(batch["image"], device), _to(batch["inpaint_mask"], device),
            _to(batch["pose_map"], device), warped, ehs, neg,
            noise=sample_draws(mesh, seed, step, device, total, H, W))

    return run_batches(loader, step_fn, save_dir, use_png=use_png,
                       what="eval", mesh=mesh)


def extract_save_vae_images(vae, emasc, loader, save_dir: str, *,
                            int_layers=EMASC_INT_LAYERS, seed: int = 0,
                            noise: Optional[Callable] = None,
                            use_png: bool = False) -> dict:
    """VAE (+EMASC) reconstructions of every batch (reference
    image_from_pipe.py:221-258), through one program for the run (the
    JAX ``recon``).  The posterior noise of batch ``step`` is
    ``noise(step, shape)`` (NCHW) where given, else drawn from
    ``batch_generator(seed, step)``."""
    device = vae.quant_conv.weight.device
    scale = 2 ** (len(vae.config.block_out_channels) - 1)

    def recon(image, im_mask, inpaint_mask, draw):
        image, im_mask, inpaint_mask = (
            x.permute(0, 3, 1, 2) for x in (image, im_mask, inpaint_mask))
        moments, _ = vae.encode(image)
        latents = DiagonalGaussian(moments).sample(draw)
        _, feats = vae.encode(im_mask)
        adapted = mask_features(emasc([feats[i] for i in int_layers]),
                                inpaint_mask)
        out = vae.decode(latents, adapted, tuple(int_layers))
        return (out.float() / 2 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    program = Program(recon, device=device, modules=(vae, emasc))

    def step_fn(step: int, batch: dict) -> torch.Tensor:
        image, im_mask, inpaint_mask = (
            _to(batch[k], device) for k in ("image", "im_mask",
                                            "inpaint_mask"))
        B, H, W, _ = image.shape
        # the posterior's shape: (B, latent, H / scale, W / scale)
        shape = torch.Size((B, vae.config.latent_channels, H // scale,
                            W // scale))
        draw = (noise(step, shape) if noise is not None else torch.randn(
            shape, generator=batch_generator(seed, step, device),
            device=device))
        return program(image, im_mask, inpaint_mask, draw.to(device))

    return run_batches(loader, step_fn, save_dir, use_png=use_png,
                       what="vae")
