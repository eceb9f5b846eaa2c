"""Serving wrapper around the try-on pipeline.

Counterpart of ``ladi_vton_tpu/pipelines/serving.py TryOnService``
without a mesh: requests of up to ``batch_size`` images are padded to
the fixed batch (repeating the last sample), run through
``TryOnPipeline.sample`` and returned unpadded.  Each request without an
explicit generator gets its own, seeded from (seed, request count) in
place of the JAX ``fold_in``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline


def request_seed(seed: int, count: int) -> int:
    """A 63-bit generator seed derived from (service seed, request)."""
    state = np.random.SeedSequence([seed, count]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


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
        n = x.shape[0]
        if n > self.batch_size:
            raise ValueError(f"request batch {n} exceeds the service batch "
                             f"{self.batch_size}; split the request")
        if n < self.batch_size:
            x = np.concatenate([x] + [x[-1:]] * (self.batch_size - n))
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.pipe.device)

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
