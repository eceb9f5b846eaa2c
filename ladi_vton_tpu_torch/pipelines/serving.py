"""Serving wrappers around the conditioning stage and the try-on pipeline.

Counterparts of ``ladi_vton_tpu/pipelines/serving.py`` ``TryOnService``
(without a mesh) and ``ConditionService``.  Requests of up to
``batch_size`` images are padded to the fixed batch (repeating the last
sample), run, and returned unpadded as float32 numpy arrays.  A raw
try-on request goes through both: ``ConditionService.run`` turns cloth,
pose, masked person and category into warped cloth and prompt
embeddings, which ``TryOnService.generate`` takes with the person image
and inpainting mask.  The try-on runs under whichever scheduler its
pipeline holds (``diffusion.schedulers.make_scheduler``); the prompts
are tokenized by the caller's tokenizer, the port's
``utils.tokenizer.CLIPTokenizer`` for the SD-2 vocabulary.  Each try-on
request without an explicit generator gets its own, seeded from (seed,
request count) in place of the JAX ``fold_in``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.core.rng import request_seed
from ladi_vton_tpu_torch.data.labels import CATEGORY_PROMPT_TEXT
from ladi_vton_tpu_torch.pipelines.condition import Conditioner
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline


def category_prompts(categories, num_vstar: int) -> list[str]:
    """The try-on prompt of each garment category, with ``num_vstar``
    ``$`` placeholders for the inversion adapter's pseudo-words
    (reference src/inference.py:281-283)."""
    return [f"a photo of a model wearing {CATEGORY_PROMPT_TEXT[str(c)]} "
            f"{' $ ' * num_vstar}" for c in categories]


def pad_batch(x: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a request to ``batch_size`` by repeating its last sample."""
    n = x.shape[0]
    if n > batch_size:
        raise ValueError(f"request batch {n} exceeds the service batch "
                         f"{batch_size}; split the request")
    if n < batch_size:
        x = np.concatenate([x] + [x[-1:]] * (batch_size - n))
    return x


class TryOnService:
    def __init__(self, pipe: TryOnPipeline, *, batch_size: int = 8,
                 height: int = 512, width: int = 384,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 context_dim: int = 1024, seed: int = 0):
        self.pipe = pipe
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.context_dim = context_dim
        self.seed = seed
        self._count = 0
        self._lock = threading.Lock()

    def warmup(self) -> None:
        """Run one full-batch request ahead of the first real one."""
        b, h, w = self.batch_size, self.height, self.width
        z = np.zeros((b, h, w, 3), np.float32)
        self.generate(
            image=z, inpaint_mask=np.ones((b, h, w, 1), np.float32),
            pose_map=np.zeros((b, h, w, 18), np.float32), warped_cloth=z,
            prompt_embeds=np.zeros((b, 77, self.context_dim), np.float32),
            negative_prompt_embeds=np.zeros((b, 77, self.context_dim),
                                            np.float32))

    def _pad(self, x: np.ndarray) -> torch.Tensor:
        x = pad_batch(np.asarray(x, np.float32), self.batch_size)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.pipe.device)

    def generate(self, *, image, inpaint_mask, pose_map, warped_cloth,
                 prompt_embeds, negative_prompt_embeds,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Run one request (<= batch_size). Returns float32 NHWC images in
        [0, 1], unpadded."""
        n = image.shape[0]
        with self._lock:
            if generator is None:
                generator = torch.Generator(self.pipe.device).manual_seed(
                    request_seed(self.seed, self._count))
                self._count += 1
            out = self.pipe.sample(
                image=self._pad(image), mask_image=self._pad(inpaint_mask),
                pose_map=self._pad(pose_map),
                warped_cloth=self._pad(warped_cloth),
                prompt_embeds=self._pad(prompt_embeds),
                negative_prompt_embeds=self._pad(negative_prompt_embeds),
                generator=generator,
                num_inference_steps=self.num_inference_steps,
                guidance_scale=self.guidance_scale)
        return out[:n].cpu().numpy()


class ConditionService:
    """In-shop cloth + pose + masked person + category strings ->
    warped cloth and prompt embeddings, ready for ``TryOnService``.

    ``tokenizer`` maps a list of prompts to (n, S) token ids, as the CLIP
    tokenizer does (S = 77 for SD-2).  The conditioner's towers are
    placed on ``device``."""

    def __init__(self, conditioner: Conditioner, tokenizer, *,
                 batch_size: int = 8, num_vstar: int = 16,
                 device: str = "cuda"):
        self.conditioner = conditioner.to(device)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.num_vstar = num_vstar
        self._lock = threading.Lock()

    def prompts(self, categories) -> list[str]:
        return category_prompts(categories, self.num_vstar)

    def _pad(self, x, dtype) -> torch.Tensor:
        x = pad_batch(np.asarray(x, dtype), self.batch_size)
        return torch.from_numpy(np.ascontiguousarray(x))

    def run(self, *, cloth, pose_map, im_mask, categories):
        """Returns float32 (warped_cloth, prompt_embeds,
        negative_prompt_embeds), unpadded to the request's n samples."""
        n = cloth.shape[0]
        input_ids = np.asarray(self.tokenizer(self.prompts(categories)))
        with self._lock:
            out = self.conditioner(
                self._pad(pose_map, np.float32), self._pad(cloth, np.float32),
                self._pad(im_mask, np.float32),
                self._pad(input_ids, np.int64))
        return tuple(t[:n].float().cpu().numpy() for t in out)
