"""Typed configuration objects for the public entry points.

Counterpart of ``ladi_vton_tpu/core/config.py``, with the same
dataclasses, fields and defaults.  The reference configures everything
through per-script argparse with defaults that are de-facto architecture
config (num_vstar=16, num_encoder_layers=1, emasc nonlinear k3/p1,
int_layers=[1..5], guidance 7.5, DDIM 50, 512x384, uncond 0.2).  The
CLIs in ``ladi_vton_tpu_torch.cli`` keep that flag surface; these
dataclasses are the programmatic API, so library users don't need
argparse.  ``DebugConfig.apply`` maps ``debug_nans`` (and
``debug_infs``) to ``torch.autograd.set_detect_anomaly``, which raises
where a backward produces a NaN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class DataConfig:
    dataset: str = "vitonhd"  # | 'dresscode'
    dresscode_dataroot: Optional[str] = None
    vitonhd_dataroot: Optional[str] = None
    size: Tuple[int, int] = (512, 384)
    category: str = "all"
    test_order: str = "paired"
    num_workers: int = 8
    caption_file: Optional[str] = None

    @property
    def dataroot(self) -> str:
        root = (self.dresscode_dataroot if self.dataset == "dresscode"
                else self.vitonhd_dataroot)
        if root is None:
            raise ValueError(f"{self.dataset} dataroot must be provided")
        return root


@dataclasses.dataclass
class WeightsConfig:
    """Local weight routing (no network downloads by default)."""

    checkpoint_dir: Optional[str] = None        # ladi-vton .pth bundles
    sd2_model_dir: Optional[str] = None         # diffusers SD-2 layout
    clip_vision_dir: Optional[str] = None       # CLIP ViT-H/14
    tokenizer_dir: Optional[str] = None         # vocab.json + merges.txt
    metric_weights_dir: Optional[str] = None    # inception / lpips


@dataclasses.dataclass
class GenerationConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    num_vstar: int = 16
    cloth_input_type: str = "warped"  # | 'none'
    cloth_cond_rate: float = 1.0
    no_pose: bool = False
    emasc_int_layers: Sequence[int] = (1, 2, 3, 4, 5)
    emasc_type: str = "nonlinear"  # | 'linear' | 'none'
    seed: int = 1234
    batch_size: int = 8
    mixed_precision: str = "bf16"
    use_png: bool = False


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-5
    train_batch_size: int = 16
    max_train_steps: int = 200001
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lr_warmup_steps: int = 500
    checkpointing_steps: int = 50000
    resume_from_checkpoint: Optional[str] = None
    seed: int = 1234
    uncond_fraction: float = 0.2
    text_usage: str = "inversion_adapter"
    train_inversion_adapter: bool = False
    use_clip_cloth_features: bool = False
    mixed_precision: str = "bf16"
    report_to: Optional[str] = "wandb"


@dataclasses.dataclass
class DebugConfig:
    """Debug toggles (the JAX package's debug_nans/debug_infs in place of
    the reference's cudnn.deterministic knob)."""

    debug_nans: bool = False
    debug_infs: bool = False
    profile_dir: Optional[str] = None

    def apply(self):
        import torch

        if self.debug_nans or self.debug_infs:
            torch.autograd.set_detect_anomaly(True, check_nan=True)
