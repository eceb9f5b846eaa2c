"""Conditioning stage: TPS warp -> refinement -> CLIP vision / PTE text.

Counterpart of ``ladi_vton_tpu/pipelines/condition.py
build_condition_fn``: the in-shop cloth is warped by the TPS
module at low resolution, the grid is resized and applied at full
resolution with ``grid_sample``, the refinement UNet cleans the warp, and
CLIP ViT-H/14 features of the cloth go through the inversion adapter to
pseudo-word embeddings that are spliced into the SD-2 text encoding of
the prompt; the unconditional embeddings encode the empty prompt.

Inputs and outputs are NHWC, as in the JAX package.  TPS and refinement
run in fp32; CLIP, adapter and text run in the towers' dtype (bf16 on
the card), and the warped cloth is cast to that dtype after its clip.

``Conditioner.__call__`` runs the stage eagerly; ``Conditioner.jit()``
is the JAX ``condition`` program: a ``pipelines.graphs.Program`` of the
same call, captured as a CUDA graph per input signature on the card and
replayed (the eager call on the CPU), whose outputs are the eager
call's bit for bit.  Its graph reads the towers' parameters in place:
``to()`` onto another device or a reload makes new modules, which need
a new ``jit()``.
"""

from __future__ import annotations

import dataclasses

import torch

from ladi_vton_tpu_torch.diffusion.text import encode_text_word_embedding
from ladi_vton_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModel
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.models.tps import ConvNetTPS
from ladi_vton_tpu_torch.ops.grid_sample import grid_sample
from ladi_vton_tpu_torch.ops.resize import device_cached, resize_bilinear
from ladi_vton_tpu_torch.pipelines.graphs import Program

# openai CLIP preprocessing constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_SIZE = (224, 224)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor (fp32 inside, x's dtype out)."""
    return _nhwc(resize_bilinear(_nchw(x), tuple(out_hw)))


def clip_pixels(cloth: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The vision tower's input from an NHWC cloth in [-1, 1]: resized to
    224x224, in [0, 1], normalised with CLIP's mean and std; NCHW in
    ``dtype``."""
    clip_in = _resize((cloth + 1.0) * 0.5, CLIP_SIZE).clamp(0.0, 1.0)
    mean, std = device_cached(
        ("clip", clip_in.dtype, clip_in.device),
        lambda: tuple(clip_in.new_tensor(v) for v in (CLIP_MEAN, CLIP_STD)))
    return _nchw(((clip_in - mean) / std).to(dtype))


def vision_program(vision: CLIPVisionModel, dtype: torch.dtype) -> Program:
    """The vision tower on ``clip_pixels`` as a program (the JAX
    drivers' ``vision_feats``): NHWC cloth in [-1, 1] -> the tower's
    features."""
    return Program(lambda cloth: vision(clip_pixels(cloth, dtype)),
                   device=next(vision.parameters()).device,
                   modules=(vision,))


@dataclasses.dataclass(frozen=True)
class Conditioner:
    """``(pose_map, cloth, im_mask, input_ids) -> (warped_cloth,
    prompt_embeds, negative_prompt_embeds)``.

    pose_map (B, H, W, 18), cloth (B, H, W, 3) in [-1, 1], im_mask
    (B, H, W, 3) masked person, input_ids (B, S) token ids; ``empty_ids``
    (S,) are the tokenizer's ids of the empty prompt.
    """

    tps: ConvNetTPS
    refinement: UNetVanilla
    vision: CLIPVisionModel
    adapter: InversionAdapter
    text_model: CLIPTextModel
    num_vstar: int
    empty_ids: torch.Tensor
    image_size: tuple = (512, 384)
    tps_size: tuple = (256, 192)

    def to(self, device) -> "Conditioner":
        """The conditioner with its towers and ids on ``device``."""
        moved = {f: getattr(self, f).to(device) for f in (
            "tps", "refinement", "vision", "adapter", "text_model",
            "empty_ids")}
        return dataclasses.replace(self, **moved)

    @property
    def device(self) -> torch.device:
        return self.text_model.text_model.final_layer_norm.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.text_model.text_model.final_layer_norm.weight.dtype

    @torch.no_grad()
    def warp(self, pose_map, cloth, im_mask) -> torch.Tensor:
        """TPS warp at ``tps_size``, full-size grid sample, refinement;
        fp32 NHWC in [-1, 1]."""
        f32 = torch.float32
        low_cloth = _resize(cloth, self.tps_size).to(f32)
        low_mask = _resize(im_mask, self.tps_size).to(f32)
        low_pose = _resize(pose_map, self.tps_size).to(f32)
        agnostic = torch.cat([low_mask, low_pose], dim=-1)
        low_grid = self.tps(_nchw(low_cloth), _nchw(agnostic))[0]
        grid = _resize(low_grid, self.image_size)
        warped = grid_sample(cloth.to(f32), grid, padding_mode="border")
        ref_in = torch.cat([im_mask.to(f32), pose_map.to(f32), warped],
                           dim=-1)
        warped = _nhwc(self.refinement(_nchw(ref_in)))
        return warped.clamp(-1.0, 1.0)

    @torch.no_grad()
    def embeddings(self, cloth, input_ids):
        """(prompt_embeds, negative_prompt_embeds) in the towers' dtype."""
        ptes = self.adapter(self.vision(clip_pixels(cloth, self.dtype)))
        ehs, _ = encode_text_word_embedding(self.text_model, input_ids, ptes,
                                            self.num_vstar)
        uncond_ids = self.empty_ids.to(input_ids.device).expand_as(input_ids)
        neg, _ = self.text_model(uncond_ids)
        return ehs, neg

    @torch.no_grad()
    def __call__(self, pose_map, cloth, im_mask, input_ids):
        dev = self.device
        pose_map, cloth, im_mask = (t.to(dev)
                                    for t in (pose_map, cloth, im_mask))
        input_ids = input_ids.to(device=dev, dtype=torch.long)
        warped = self.warp(pose_map, cloth, im_mask).to(self.dtype)
        ehs, neg = self.embeddings(cloth, input_ids)
        return warped, ehs, neg

    def jit(self) -> Program:
        """The JAX ``build_condition_fn``'s program: ``program(pose_map,
        cloth, im_mask, input_ids) -> (warped_cloth, prompt_embeds,
        negative_prompt_embeds)``, as ``__call__`` computes them, from
        inputs on any device."""
        return Program(self, device=self.device, modules=(
            self.tps, self.refinement, self.vision, self.adapter,
            self.text_model))
