"""Training steps of the warping stage (TPS, refinement) and of the
inversion adapter.

Counterpart of ``ladi_vton_tpu/train/tps_steps.py``:

* phase A, TPS at 256x192: L1(grid-sampled cloth, im_cloth) +
  const_weight * mean(rx + ry + cx + cy + rg + cg), Adam(0.5, 0.99);
* phase B, the refinement at full size: TPS frozen (running statistics)
  at 256x192, its grid bilinearly upsampled, the warped cloth, masked
  person and pose through ``UNetVanilla``, l1_weight * L1 + vgg_weight *
  VGG;
* ``warp_and_refine``, the deterministic forward of the extraction;
* the inversion adapter through the frozen stock 9-channel UNet, MSE on
  the noise, only the adapter training.  The JAX step applies the
  adapter without its dropout (flax ``deterministic=True``), and so does
  this one: the adapter stays in eval mode.

TPS and the refinement train their BatchNorm as flax does
(``models.layers.BatchNorm2d``): batch statistics with the biased
variance, running statistics moved at momentum 0.9; the step puts the
trained tower in train mode and the frozen one in eval mode.  Batches
are NHWC, as the loader gives them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ladi_vton_tpu_torch.diffusion.schedulers import DDPMScheduler
from ladi_vton_tpu_torch.diffusion.text import encode_text_word_embedding
from ladi_vton_tpu_torch.models.vae import DiagonalGaussian
from ladi_vton_tpu_torch.models.vgg import vgg_loss
from ladi_vton_tpu_torch.ops.grid_sample import grid_sample
from ladi_vton_tpu_torch.ops.resize import resize_nearest
from ladi_vton_tpu_torch.pipelines.condition import _resize as resize_nhwc
from ladi_vton_tpu_torch.pipelines.tryon import _nchw as nchw
from ladi_vton_tpu_torch.pipelines.tryon import _nhwc as nhwc
from ladi_vton_tpu_torch.train.steps import (
    Optimizer,
    _latent_shape,
    _towers,
    build_train_step,
)

TPS_SIZE = (256, 192)


def tps_optimizer(params, lr: float = 1e-4) -> Optimizer:
    """Adam with betas (0.5, 0.99), as the reference (optax.adam there)."""
    return Optimizer(params, lambda count: lr, betas=(0.5, 0.99))


def make_tps_loss(*, tps, const_weight: float = 0.01) -> Callable:
    """Phase A: batch cloth, im_cloth, im_mask (B,256,192,3) and pose
    (B,256,192,18); TPS in train mode."""

    def loss_fn(batch: dict, draws: Optional[dict] = None):
        tps.train()
        agnostic = torch.cat([batch["im_mask"], batch["pose"]], dim=-1)
        grid, _, rx, ry, cx, cy, rg, cg = tps(nchw(batch["cloth"]),
                                              nchw(agnostic))
        warped = grid_sample(batch["cloth"], grid, padding_mode="border")
        l1 = torch.mean(torch.abs(warped - batch["im_cloth"]))
        const = torch.mean(rx + ry + cx + cy + rg + cg)
        return l1 + const * const_weight, {"l1": l1, "const": const}

    return loss_fn


def make_tps_train_step(*, tps, optimizer: Optimizer,
                        const_weight: float = 0.01) -> Callable:
    return build_train_step(make_tps_loss(tps=tps, const_weight=const_weight),
                            optimizer, modules=(tps,))


def warp(tps, batch: dict, height: int, width: int) -> torch.Tensor:
    """TPS (as it is, train or eval) at 256x192 on the full-size batch,
    its grid resized to (height, width), the cloth grid-sampled; NHWC."""
    agnostic = torch.cat([resize_nhwc(batch["im_mask"], TPS_SIZE),
                          resize_nhwc(batch["pose"], TPS_SIZE)], dim=-1)
    grid = tps(nchw(resize_nhwc(batch["cloth"], TPS_SIZE)), nchw(agnostic))[0]
    grid_hr = resize_nhwc(grid, (height, width))
    return grid_sample(batch["cloth"], grid_hr, padding_mode="border")


def make_refinement_loss(*, tps, refinement, vgg, l1_weight: float = 1.0,
                         vgg_weight: float = 0.25, height: int = 512,
                         width: int = 384) -> Callable:
    """Phase B: TPS frozen in eval mode, the refinement in train mode."""

    def loss_fn(batch: dict, draws: Optional[dict] = None):
        tps.eval()
        refinement.train()
        with torch.no_grad():
            warped = warp(tps, batch, height, width)
        ref_in = torch.cat([batch["im_mask"], batch["pose"], warped], dim=-1)
        refined = nhwc(refinement(nchw(ref_in)))
        l1 = torch.mean(torch.abs(refined - batch["im_cloth"]))
        perc = vgg_loss(vgg, nchw(refined), nchw(batch["im_cloth"]))
        return l1 * l1_weight + perc * vgg_weight, {"l1": l1, "vgg": perc}

    return loss_fn


def make_refinement_train_step(*, optimizer: Optimizer, **kwargs) -> Callable:
    return build_train_step(make_refinement_loss(**kwargs), optimizer,
                            modules=_towers(kwargs))


@torch.no_grad()
def warp_and_refine(tps, refinement, *, cloth, im_mask, pose,
                    height: int = 512, width: int = 384,
                    clamp: bool = True) -> torch.Tensor:
    """The deterministic warp + refine forward (both towers in eval mode),
    fp32 NHWC in [-1, 1] (the extraction and inference path)."""
    tps.eval()
    refinement.eval()
    f32 = torch.float32
    batch = {"cloth": cloth.to(f32), "im_mask": im_mask.to(f32),
             "pose": pose.to(f32)}
    warped = warp(tps, batch, height, width)
    ref_in = torch.cat([batch["im_mask"], batch["pose"], warped], dim=-1)
    refined = nhwc(refinement(nchw(ref_in)))
    return refined.clamp(-1.0, 1.0) if clamp else refined


def eval_batch(tps, refinement, vgg, batch: dict, *, refined: bool,
               height: int = 512, width: int = 384) -> tuple:
    """One test batch of the per-epoch evaluation (the JAX main's
    ``_eval_batch_tps`` and ``_eval_batch_refined``): (warped cloth, its
    L1 and VGG losses against ``im_cloth``), the warped cloth clamped to
    [-1, 1].  ``refined``: warped and refined (``warp_and_refine``), else
    TPS alone.  Both towers in eval mode."""
    if refined:
        warped = warp_and_refine(tps, refinement, cloth=batch["cloth"],
                                 im_mask=batch["im_mask"],
                                 pose=batch["pose"], height=height,
                                 width=width)
    else:
        tps.eval()
        warped = warp(tps, batch, height, width)
    l1 = torch.mean(torch.abs(warped - batch["im_cloth"]))
    perc = vgg_loss(vgg, nchw(warped), nchw(batch["im_cloth"]))
    return warped.clamp(-1.0, 1.0), l1, perc


def extraction_pixels(tps, refinement, cloth, im_mask, pose, *,
                      height: int = 512, width: int = 384) -> torch.Tensor:
    """The extraction's refined warped cloths (the JAX main's
    ``extract_fn``) as uint8 NHWC pixels."""
    warped = warp_and_refine(tps, refinement, cloth=cloth, im_mask=im_mask,
                             pose=pose, height=height, width=width)
    return torch.round(((warped + 1) / 2).clamp(0, 1) * 255).to(torch.uint8)


def adapter_draws(batch: dict, generator: torch.Generator, *,
                  num_train_timesteps: int = 1000) -> dict:
    """The adapter loss's draws: the image's and the masked image's
    posterior noise, the diffusion noise and the timesteps."""
    B, lh, lw = _latent_shape(batch)
    dev = generator.device
    draw = {k: torch.randn((B, 4, lh, lw), generator=generator, device=dev)
            for k in ("latents", "masked", "noise")}
    draw["timesteps"] = torch.randint(0, num_train_timesteps, (B,),
                                      generator=generator, device=dev)
    return draw


def make_inversion_adapter_loss(*, unet9, vae, text_model, inversion_adapter,
                                noise_scheduler: Optional[DDPMScheduler]
                                = None, num_vstar: int = 16) -> Callable:
    """Stage 3: batch image, im_mask, inpaint_mask (NHWC), input_ids,
    clip_cloth_features; gradients reach the adapter through the frozen
    text encoder and UNet."""
    scheduler = noise_scheduler or DDPMScheduler()
    sf = vae.config.scaling_factor

    def loss_fn(batch: dict, draws: dict):
        B, lh, lw = _latent_shape(batch)
        moments, _ = vae.encode(nchw(batch["image"]))
        latents = DiagonalGaussian(moments).sample(draws["latents"]) * sf
        noise = draws["noise"].to(latents.dtype)
        timesteps = draws["timesteps"]
        noisy = scheduler.add_noise(latents, noise, timesteps)
        mask = resize_nearest(nchw(batch["inpaint_mask"]), (lh, lw))
        m_moments, _ = vae.encode(nchw(batch["im_mask"]))
        masked = DiagonalGaussian(m_moments).sample(draws["masked"]) * sf
        ptes = inversion_adapter(batch["clip_cloth_features"])
        ehs, _ = encode_text_word_embedding(text_model, batch["input_ids"],
                                            ptes, num_vstar)
        unet_in = torch.cat([noisy, mask.to(noisy.dtype), masked], dim=1)
        pred = unet9(unet_in, timesteps, ehs)
        loss = torch.mean(torch.square(pred.float() - noise.float()))
        return loss, {}

    return loss_fn


def make_inversion_adapter_train_step(
        *, optimizer: Optimizer, gradient_accumulation_steps: int = 1,
        autocast: Callable = contextlib.nullcontext, mesh=None,
        **kwargs) -> Callable:
    """``step(batch, draws)`` of the adapter stage, over ``mesh``."""
    return build_train_step(make_inversion_adapter_loss(**kwargs), optimizer,
                            gradient_accumulation_steps, autocast, mesh,
                            _towers(kwargs))
