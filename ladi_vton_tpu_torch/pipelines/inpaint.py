"""The plain Stable-Diffusion inpainting pipeline (9-channel UNet).

Counterpart of ``ladi_vton_tpu/pipelines/inpaint.py``: the reference
validates the inversion adapter through diffusers' stock inpainting
pipeline, with no pose or cloth channels and no EMASC.  VAE encode of
the masked image, the 9-channel concat, the sampler's loop under
classifier-free guidance, decode; fp32 NHWC images in [0, 1].  The
initial latents and the masked image's posterior noise come from a
``torch.Generator`` (in that order), or as ``noise`` (NCHW) from a test.
``generate_images_inversion_adapter`` is the adapter trainer's
validation dump, batch by batch through ``drivers.run_batches``.
"""

from __future__ import annotations

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
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.pipelines.tryon import (
    VAE_SCALE,
    _nchw,
    _nhwc,
    prepare_mask_and_masked_image,
)


@dataclasses.dataclass(frozen=True)
class InpaintPipeline:
    unet: UNet2DCondition
    vae: AutoencoderKL
    scheduler: Any

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

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
        dev = self.device
        image, mask_image = image.to(dev), mask_image.to(dev)
        B, H, W, _ = image.shape
        lh, lw = H // VAE_SCALE, W // VAE_SCALE
        sf = self.vae.config.scaling_factor
        if noise is None:
            noise = {k: torch.randn((B, 4, lh, lw), generator=generator,
                                    device=dev) for k in ("latents", "masked")}
        mask, masked_image = prepare_mask_and_masked_image(image, mask_image)
        moments, _ = self.vae.encode(_nchw(masked_image))
        masked = DiagonalGaussian(moments).sample(noise["masked"].to(dev)) * sf
        mask_lat = resize_nearest(_nchw(mask), (lh, lw))

        timesteps = self.scheduler.set_timesteps(num_inference_steps,
                                                 device=dev)
        latents = noise["latents"].to(dev) * self.scheduler.init_noise_sigma
        do_cfg = guidance_scale > 1.0
        context = prompt_embeds.to(dev)
        if do_cfg:
            mask_lat = torch.cat([mask_lat] * 2)
            masked = torch.cat([masked] * 2)
            context = torch.cat([negative_prompt_embeds.to(dev), context])
        steps = torch.arange(len(timesteps), device=dev)
        state = self.scheduler.init_loop_state(latents)
        for i in range(len(timesteps)):
            step, t = steps[i], timesteps[i]
            scaled = self.scheduler.scale_input(latents, step, t)
            lmi = torch.cat([scaled] * 2) if do_cfg else scaled
            model_in = torch.cat([lmi, mask_lat.to(lmi.dtype),
                                  masked.to(lmi.dtype)], dim=1)
            pred = self.unet(model_in, t.expand(model_in.shape[0]), context)
            if do_cfg:
                uncond, text = pred.chunk(2)
                pred = uncond + guidance_scale * (text - uncond)
            state, latents = self.scheduler.loop_step(state, pred, step, t,
                                                      latents)
        decoded = self.vae.decode(latents / sf)
        return _nhwc((decoded.float() / 2 + 0.5).clamp(0.0, 1.0))


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

    @torch.no_grad()
    def step_fn(step: int, batch: dict) -> torch.Tensor:
        input_ids = _to(np.asarray(tokenizer(category_prompts(
            batch["category"], num_vstar))), device, torch.long)
        if "clip_cloth_features" in batch:
            feats = _to(batch["clip_cloth_features"], device, towers)
        else:
            feats = vision(clip_pixels(_to(batch["cloth"], device), towers))
        ptes = inversion_adapter(feats.to(towers))
        ehs, _ = encode_text_word_embedding(text_model, input_ids, ptes,
                                            num_vstar)
        neg, _ = text_model(empty_ids.expand_as(input_ids))
        return pipe.sample(
            image=_to(batch["image"], device),
            mask_image=_to(batch["inpaint_mask"], device),
            prompt_embeds=ehs, negative_prompt_embeds=neg,
            generator=batch_generator(seed, step, device),
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale)

    return run_batches(loader, step_fn, save_dir, use_png=use_png,
                       what="adapter validation")
