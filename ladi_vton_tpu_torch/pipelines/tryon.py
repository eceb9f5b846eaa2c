"""The try-on engine: latent-diffusion inpainting conditioned on pose,
warped garment and text embeddings.

Counterpart of ``ladi_vton_tpu/pipelines/tryon.py``.  The same three
stages, eagerly:

1. ``prepare``: one batched VAE encode of warped cloth plus masked image
   (with the EMASC feature taps), latent sampling, EMASC and
   ``mask_features``;
2. ``denoise``: the sampler's plan of UNet calls under classifier-free
   guidance (batch 2B; the uncond half has zeroed pose and cloth), with
   the warped-cloth gate ``step_i >= cloth_gate_from``; the JAX
   ``lax.scan`` is a Python loop over the plan here, and every scheduler
   (DDIM, PNDM, LMS, DPM-Solver++) is driven through the JAX package's
   loop protocol (``init_loop_state`` / ``scale_input`` / ``loop_step``)
   with the step index and timestep as device tensors;
3. ``decode``: the EMASC-aware VAE decode, fp32 clipped to [0, 1].

The options of the JAX pipeline: ``warped_cloth=None`` (the reference's
``cloth_input_type='none'``: no cloth channels, a 27-channel UNet),
``no_pose``, ``emasc=None`` (decode without injection), a ``latents=``
override, and ``hoist_context_kv`` (the cross-attention K/V projections
of the prompt computed once, before the loop).

Public inputs and outputs are NHWC, as in the JAX package; the towers run
NCHW in channels-last memory.  Random draws come from an explicit
``torch.Generator``, or ``prepare`` takes them as ``noise`` (NHWC
tensors) so a test can hand it the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ladi_vton_tpu_torch.models.emasc import EMASC, mask_features
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian
from ladi_vton_tpu_torch.ops.resize import resize_bilinear, resize_nearest

NOISE_KEYS = ("latents", "masked", "cloth")
VAE_SCALE = 8  # image pixels per latent pixel
EMASC_INT_LAYERS = (1, 2, 3, 4, 5)  # encoder taps EMASC adapts


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def prepare_mask_and_masked_image(image: torch.Tensor, mask: torch.Tensor):
    """Binarize the mask and zero the region to inpaint (NHWC)."""
    mask = (mask >= 0.5).to(image.dtype)
    return mask, image * (mask < 0.5)


def cloth_gate_start(num_inference_steps: int,
                     cloth_cond_rate: float) -> float:
    """First denoise-loop index at which warped-cloth conditioning is
    zeroed.  Computed from ``num_inference_steps``, as the reference
    does, not from the plan's length: a PNDM plan is one step longer."""
    return cloth_cond_rate * num_inference_steps


@dataclasses.dataclass(frozen=True)
class TryOnPipeline:
    unet: UNet2DCondition
    vae: AutoencoderKL
    scheduler: Any  # DDIM | PNDM | LMS | DPMSolverMultistep
    emasc: Optional[EMASC] = None
    hoist_context_kv: bool = False

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @torch.no_grad()
    def sample(self, *, image: torch.Tensor, mask_image: torch.Tensor,
               pose_map: torch.Tensor, prompt_embeds: torch.Tensor,
               negative_prompt_embeds: torch.Tensor,
               warped_cloth: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[dict] = None, num_inference_steps: int = 50,
               guidance_scale: float = 7.5, cloth_cond_rate: float = 1.0,
               no_pose: bool = False,
               latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Generate try-on images: float32 NHWC in [0, 1].

        image (B,H,W,3) in [-1,1]; mask_image (B,H,W,1), 1 = inpaint;
        pose_map (B,H,W,18); warped_cloth (B,H,W,3) in [-1,1] or None;
        prompt embeds (B,77,D); latents (B,H/8,W/8,4) replaces the
        initial N(0, 1) draw.
        """
        prepared = self.prepare(image=image, mask_image=mask_image,
                                pose_map=pose_map, warped_cloth=warped_cloth,
                                generator=generator, noise=noise,
                                no_pose=no_pose)
        if latents is not None:
            prepared["latents"] = _nchw(latents).to(self.device,
                                                    torch.float32)
        intermediate = prepared.pop("intermediate")
        latents = self.denoise(
            prepared, prompt_embeds=prompt_embeds,
            negative_prompt_embeds=negative_prompt_embeds,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, cloth_cond_rate=cloth_cond_rate)
        return self.decode(latents, intermediate)

    def _draw(self, B: int, lh: int, lw: int, generator, noise) -> dict:
        """N(0,1) latent draws in a fixed order, NCHW fp32."""
        if noise is not None:
            return {k: _nchw(noise[k]).to(self.device, torch.float32)
                    for k in NOISE_KEYS}
        return {k: torch.randn((B, 4, lh, lw), generator=generator,
                               device=self.device, dtype=torch.float32)
                for k in NOISE_KEYS}

    @torch.no_grad()
    def prepare(self, *, image, mask_image, pose_map, warped_cloth=None,
                generator=None, noise=None, no_pose: bool = False) -> dict:
        dev = self.device
        image, mask_image, pose_map = (
            t.to(dev) for t in (image, mask_image, pose_map))
        B, H, W, _ = image.shape
        lh, lw = H // VAE_SCALE, W // VAE_SCALE
        sf = self.vae.config.scaling_factor
        draws = self._draw(B, lh, lw, generator, noise)

        mask, masked_image = prepare_mask_and_masked_image(image, mask_image)
        pose_lat = resize_bilinear(_nchw(pose_map), (lh, lw))
        if no_pose:
            pose_lat = torch.zeros_like(pose_lat)
        if warped_cloth is not None:
            # one batched encoder pass for cloth + masked image; the cloth
            # half's feature taps are simply unused
            both = torch.cat([warped_cloth.to(dev, masked_image.dtype),
                              masked_image])
            moments2, feats2 = self.vae.encode(_nchw(both))
            cloth_moments, moments = moments2.chunk(2, dim=0)
            feats = [f[B:] for f in feats2]
            cloth_latents = DiagonalGaussian(cloth_moments).sample(
                draws["cloth"]) * sf
        else:
            cloth_latents = None
            moments, feats = self.vae.encode(_nchw(masked_image))
        masked_latents = DiagonalGaussian(moments).sample(draws["masked"]) * sf
        mask_lat = resize_nearest(_nchw(mask), (lh, lw))
        intermediate = None
        if self.emasc is not None:
            adapted = self.emasc([feats[i] for i in EMASC_INT_LAYERS])
            intermediate = mask_features(adapted, _nchw(mask_image))
        return {
            "latents": draws["latents"],
            "mask_lat": mask_lat,
            "masked_latents": masked_latents,
            "pose_lat": pose_lat,
            "cloth_latents": cloth_latents,
            "intermediate": intermediate,
        }

    @torch.no_grad()
    def denoise(self, prepared: dict, *, prompt_embeds,
                negative_prompt_embeds, num_inference_steps: int = 50,
                guidance_scale: float = 7.5,
                cloth_cond_rate: float = 1.0) -> torch.Tensor:
        dev = self.device
        do_cfg = guidance_scale > 1.0
        timesteps = self.scheduler.set_timesteps(num_inference_steps,
                                                 device=dev)
        steps = torch.arange(len(timesteps), device=dev)
        gate_from = cloth_gate_start(num_inference_steps, cloth_cond_rate)
        # scaled after set_timesteps: LMS knows its sigma_max only then
        latents = prepared["latents"] * self.scheduler.init_noise_sigma
        mask_in = prepared["mask_lat"]
        masked_in = prepared["masked_latents"]
        pose_in = prepared["pose_lat"]
        cloth_in = prepared["cloth_latents"]
        context = prompt_embeds.to(dev)
        if do_cfg:
            mask_in = torch.cat([mask_in] * 2)
            masked_in = torch.cat([masked_in] * 2)
            pose_in = torch.cat([torch.zeros_like(pose_in), pose_in])
            context = torch.cat([negative_prompt_embeds.to(dev), context])
            if cloth_in is not None:
                cloth_in = torch.cat([torch.zeros_like(cloth_in), cloth_in])
        context_kv = (self.unet.precompute_context_kv(context)
                      if self.hoist_context_kv else None)

        state = self.scheduler.init_loop_state(latents)
        for i in range(len(timesteps)):
            step, t = steps[i], timesteps[i]
            scaled = self.scheduler.scale_input(latents, step, t)
            lmi = torch.cat([scaled] * 2) if do_cfg else scaled
            parts = [lmi, mask_in.to(lmi.dtype), masked_in.to(lmi.dtype),
                     pose_in.to(lmi.dtype)]
            if cloth_in is not None:
                parts.append(torch.zeros_like(lmi) if i >= gate_from
                             else cloth_in.to(lmi.dtype))
            model_in = torch.cat(parts, dim=1)
            noise_pred = self.unet(model_in, t.expand(model_in.shape[0]),
                                   context, context_kv=context_kv)
            if do_cfg:
                uncond, text = noise_pred.chunk(2)
                noise_pred = uncond + guidance_scale * (text - uncond)
            state, latents = self.scheduler.loop_step(state, noise_pred, step,
                                                      t, latents)
        return latents

    @torch.no_grad()
    def decode(self, latents: torch.Tensor,
               intermediate=None) -> torch.Tensor:
        z = latents / self.vae.config.scaling_factor
        if self.emasc is not None and intermediate is not None:
            decoded = self.vae.decode(z, intermediate, EMASC_INT_LAYERS)
        else:
            decoded = self.vae.decode(z)
        return _nhwc((decoded.float() / 2 + 0.5).clamp(0.0, 1.0))
