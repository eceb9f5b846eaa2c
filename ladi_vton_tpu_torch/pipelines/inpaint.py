"""The plain Stable-Diffusion inpainting pipeline (9-channel UNet).

Counterpart of ``ladi_vton_tpu/pipelines/inpaint.py``: the reference
validates the inversion adapter through diffusers' stock inpainting
pipeline, with no pose or cloth channels and no EMASC.  VAE encode of
the masked image, the 9-channel concat, the sampler's loop under
classifier-free guidance, decode; fp32 NHWC images in [0, 1].  The
initial latents and the masked image's posterior noise come from a
``torch.Generator`` (in that order), or as ``noise`` (NCHW) from a test.

``generate_images_inversion_adapter`` is the adapter trainer's
validation dump, batch by batch through ``drivers.run_batches``.  Each
batch goes through one program of the run, the JAX ``run``: the vision
tower (where the batch has no cached features), the adapter, the
pseudo-word text encoding and the inpainting sample
(``pipelines.graphs.LoopProgram``: on the card a prepare graph, one step
graph replayed a step and a decode graph per batch shape; on the CPU the
same stages eagerly).  Its draws are made eagerly, in ``sample``'s
order, and copied in, so its images are the eager loop's bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.core.rng import batch_generator
from ladi_vton_tpu_torch.diffusion.text import encode_text_word_embedding
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian
from ladi_vton_tpu_torch.ops.resize import resize_nearest
from ladi_vton_tpu_torch.pipelines.condition import clip_pixels
from ladi_vton_tpu_torch.pipelines.drivers import _to, run_batches
from ladi_vton_tpu_torch.pipelines.graphs import LoopProgram
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.pipelines.tryon import (
    VAE_SCALE,
    _nchw,
    _nhwc,
    prepare_mask_and_masked_image,
)

NOISE_KEYS = ("latents", "masked")  # the draws, in the generator's order


@dataclasses.dataclass(frozen=True)
class InpaintPipeline:
    unet: UNet2DCondition
    vae: AutoencoderKL
    scheduler: Any

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def draws(self, B: int, H: int, W: int, *,
              generator: Optional[torch.Generator] = None,
              noise: Optional[dict] = None) -> dict:
        """The sample's N(0, 1) draws for a (B, H, W) batch, NCHW:
        ``noise``'s where given, else from ``generator`` in
        ``NOISE_KEYS``' order."""
        dev = self.device
        if noise is not None:
            return {k: noise[k].to(dev) for k in NOISE_KEYS}
        shape = (B, 4, H // VAE_SCALE, W // VAE_SCALE)
        return {k: torch.randn(shape, generator=generator, device=dev)
                for k in NOISE_KEYS}

    def loop_inputs(self, *, image, mask_image, prompt_embeds,
                    negative_prompt_embeds, draws: dict,
                    guidance_scale: float) -> tuple:
        """What the loop starts from: (latents scaled by the scheduler's
        ``init_noise_sigma``, the scheduler's first state, the keyword
        inputs of every ``denoise_one_step``).  Call it after
        ``set_timesteps``."""
        dev = self.device
        image, mask_image = image.to(dev), mask_image.to(dev)
        _, H, W, _ = image.shape
        sf = self.vae.config.scaling_factor
        mask, masked_image = prepare_mask_and_masked_image(image, mask_image)
        moments, _ = self.vae.encode(_nchw(masked_image))
        masked = DiagonalGaussian(moments).sample(draws["masked"]) * sf
        mask_lat = resize_nearest(_nchw(mask),
                                  (H // VAE_SCALE, W // VAE_SCALE))
        latents = draws["latents"] * self.scheduler.init_noise_sigma
        context = prompt_embeds.to(dev)
        if guidance_scale > 1.0:
            mask_lat = torch.cat([mask_lat] * 2)
            masked = torch.cat([masked] * 2)
            context = torch.cat([negative_prompt_embeds.to(dev), context])
        return latents, self.scheduler.init_loop_state(latents), dict(
            mask_lat=mask_lat, masked=masked, context=context)

    def denoise_one_step(self, latents, state, step_i, t, *, mask_lat,
                         masked, context, guidance_scale: float) -> tuple:
        """One update of the loop: (latents, scheduler state)."""
        do_cfg = guidance_scale > 1.0
        scaled = self.scheduler.scale_input(latents, step_i, t)
        lmi = torch.cat([scaled] * 2) if do_cfg else scaled
        model_in = torch.cat([lmi, mask_lat.to(lmi.dtype),
                              masked.to(lmi.dtype)], dim=1)
        pred = self.unet(model_in, t.expand(model_in.shape[0]), context)
        if do_cfg:
            uncond, text = pred.chunk(2)
            pred = uncond + guidance_scale * (text - uncond)
        state, latents = self.scheduler.loop_step(state, pred, step_i, t,
                                                  latents)
        return latents, state

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        decoded = self.vae.decode(latents / self.vae.config.scaling_factor)
        return _nhwc((decoded.float() / 2 + 0.5).clamp(0.0, 1.0))

    @torch.no_grad()
    def sample(self, *, image: torch.Tensor, mask_image: torch.Tensor,
               prompt_embeds: torch.Tensor,
               negative_prompt_embeds: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[dict] = None, num_inference_steps: int = 50,
               guidance_scale: float = 7.5) -> torch.Tensor:
        """image (B,H,W,3) in [-1,1], mask_image (B,H,W,1) with 1 =
        inpaint, prompt embeds (B,77,D); ``noise``: {"latents", "masked"}
        NCHW draws in place of the generator's."""
        B, H, W, _ = image.shape
        draws = self.draws(B, H, W, generator=generator, noise=noise)
        timesteps = self.scheduler.set_timesteps(num_inference_steps,
                                                 device=self.device)
        latents, state, inputs = self.loop_inputs(
            image=image, mask_image=mask_image, prompt_embeds=prompt_embeds,
            negative_prompt_embeds=negative_prompt_embeds, draws=draws,
            guidance_scale=guidance_scale)
        steps = torch.arange(len(timesteps), device=self.device)
        for i in range(len(timesteps)):
            latents, state = self.denoise_one_step(
                latents, state, steps[i], timesteps[i],
                guidance_scale=guidance_scale, **inputs)
        return self.decode(latents)


class AdapterValidation:
    """The stages of the JAX validation ``run`` (a ``LoopProgram`` plan)
    on a batch ``x``: image, mask_image, input_ids, the draws, and
    clip_features or the cloth for the vision tower.  It has its own copy
    of the pipeline's scheduler, whose plan it sets once."""

    def __init__(self, pipe: InpaintPipeline, text_model, adapter, vision,
                 empty_ids: torch.Tensor, *, num_vstar: int,
                 num_inference_steps: int, guidance_scale: float):
        self.pipe = dataclasses.replace(pipe,
                                        scheduler=copy.copy(pipe.scheduler))
        self.text_model, self.adapter, self.vision = (text_model, adapter,
                                                      vision)
        self.towers = text_model.text_model.final_layer_norm.weight.dtype
        self.empty_ids = empty_ids
        self.num_vstar = num_vstar
        self.guidance_scale = guidance_scale
        self.device = pipe.device
        self.timesteps = self.pipe.scheduler.set_timesteps(
            num_inference_steps, device=self.device)
        self.steps = torch.arange(len(self.timesteps), device=self.device)

    def prepare_loop(self, x: dict) -> tuple:
        feats = x.get("clip_features")
        if feats is None:
            feats = self.vision(clip_pixels(x["cloth"], self.towers))
        ptes = self.adapter(feats.to(self.towers))
        input_ids = x["input_ids"]
        ehs, _ = encode_text_word_embedding(self.text_model, input_ids, ptes,
                                            self.num_vstar)
        neg, _ = self.text_model(self.empty_ids.expand_as(input_ids))
        return (None, *self.pipe.loop_inputs(
            image=x["image"], mask_image=x["mask_image"], prompt_embeds=ehs,
            negative_prompt_embeds=neg, draws=x["draws"],
            guidance_scale=self.guidance_scale))

    def step(self, latents, state, step_i, t, inputs: dict) -> tuple:
        return self.pipe.denoise_one_step(
            latents, state, step_i, t, guidance_scale=self.guidance_scale,
            **inputs)

    def decode_loop(self, latents: torch.Tensor, carry=None) -> torch.Tensor:
        return self.pipe.decode(latents)


def generate_images_inversion_adapter(
        pipe: InpaintPipeline, text_model, tokenizer, inversion_adapter,
        vision, loader, save_dir: str, *, num_vstar: int = 16,
        seed: int = 1234, num_inference_steps: int = 50,
        guidance_scale: float = 7.5, use_png: bool = False) -> dict:
    """The adapter's validation images through the plain inpainting
    pipeline: the category prompt with its ``$`` run filled by the
    adapter's pseudo-words (from the batch's ``clip_cloth_features``, or
    the ``vision`` tower on its cloth); batch ``step``'s noise from
    ``batch_generator(seed, step)``.  Returns ``run_batches``' numbers."""
    device = pipe.device
    towers = text_model.text_model.final_layer_norm.weight.dtype
    empty_ids = torch.from_numpy(
        np.asarray(tokenizer([""]))[0].astype(np.int64)).to(device)
    program = LoopProgram(
        AdapterValidation(pipe, text_model, inversion_adapter, vision,
                          empty_ids, num_vstar=num_vstar,
                          num_inference_steps=num_inference_steps,
                          guidance_scale=guidance_scale),
        modules=(pipe.unet, pipe.vae, text_model, inversion_adapter,
                 vision))

    def step_fn(step: int, batch: dict) -> torch.Tensor:
        image = _to(batch["image"], device)
        B, H, W, _ = image.shape
        x = {"image": image, "mask_image": _to(batch["inpaint_mask"], device),
             "input_ids": _to(np.asarray(tokenizer(category_prompts(
                 batch["category"], num_vstar))), device, torch.long),
             "draws": pipe.draws(B, H, W, generator=batch_generator(
                 seed, step, device))}
        if "clip_cloth_features" in batch:
            x["clip_features"] = _to(batch["clip_cloth_features"], device,
                                     towers)
        else:
            x["cloth"] = _to(batch["cloth"], device)
        return program(x)

    return run_batches(loader, step_fn, save_dir, use_png=use_png,
                       what="adapter validation")
