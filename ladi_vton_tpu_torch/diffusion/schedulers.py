"""DDIM sampling scheduler.

Counterpart of ``ladi_vton_tpu/diffusion/schedulers.py`` (the
``SchedulerConfig``, the beta schedule and ``DDIMScheduler``).  SD-2
configuration: scaled_linear betas 0.00085 -> 0.012 over 1000 steps,
epsilon prediction, steps_offset 1, no clip_sample, set_alpha_to_one
False.  The timestep plan is passed explicitly: ``step`` takes
``num_inference_steps`` instead of reading state left by
``set_timesteps``.  PNDM, LMS and DPM-Solver++ are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # 'epsilon' | 'v_prediction'
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    clip_sample: bool = False


def _make_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")
    return np.cumprod(1.0 - betas).astype(np.float32)


class DDIMScheduler:
    """Deterministic DDIM (eta = 0) with diffusers' timestep spacing."""

    init_noise_sigma = 1.0

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.alphas_cumprod = _make_alphas_cumprod(config)
        self.final_alpha_cumprod = (np.float32(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])

    def set_timesteps(self, num_inference_steps: int) -> list[int]:
        """The plan: stride T // n, descending, plus steps_offset."""
        ratio = self.config.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1]
        return [int(t) + self.config.steps_offset for t in ts]

    def step(self, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor, num_inference_steps: int) -> torch.Tensor:
        """One x_t -> x_{t - stride} update, in fp32."""
        cfg = self.config
        prev_t = timestep - cfg.num_train_timesteps // num_inference_steps
        a_t = np.float32(self.alphas_cumprod[timestep])
        a_prev = np.float32(self.alphas_cumprod[prev_t] if prev_t >= 0
                            else self.final_alpha_cumprod)
        # coefficients in fp32 as numpy scalars, applied as Python floats
        # (exact in fp32) so the tensor arithmetic stays fp32
        sa = float(np.sqrt(a_t))
        sb = float(np.sqrt(np.float32(1.0) - a_t))
        x = sample.float()
        out = model_output.float()
        if cfg.prediction_type == "epsilon":
            x0 = (x - sb * out) / sa
            eps = out
        elif cfg.prediction_type == "v_prediction":
            x0 = sa * x - sb * out
            eps = sa * out + sb * x
        else:
            raise ValueError(cfg.prediction_type)
        if cfg.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        dir_xt = float(np.sqrt(max(np.float32(1.0) - a_prev,
                                   np.float32(0.0)))) * eps
        prev = float(np.sqrt(a_prev)) * x0 + dir_xt
        return prev.to(sample.dtype)
