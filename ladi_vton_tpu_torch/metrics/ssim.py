"""SSIM matching torchmetrics' defaults, in PyTorch.

Counterpart of ``ladi_vton_tpu/metrics/ssim.py``.  The reference computes
SSIM with torchmetrics ``StructuralSimilarityIndexMeasure(data_range=1.0)``
(reference: src/utils/val_metrics.py:188): an 11x11 Gaussian kernel,
sigma 1.5, k1=0.01, k2=0.03, VALID windows, averaged over channels and
batch.  The filter is a depthwise convolution in fp32; run it under
``metrics.inception.strict_fp32`` on the card, so cuDNN does not take
TF32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ladi_vton_tpu_torch.ops.resize import device_cached


def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred: torch.Tensor, target: torch.Tensor, *,
         data_range: float = 1.0, kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of two NHWC batches (a 0-d fp32 tensor)."""
    C = pred.shape[-1]
    # made once a device: a copy from the host cannot be captured
    kernel = device_cached(
        ("ssim", kernel_size, sigma, pred.device),
        lambda: torch.from_numpy(gaussian_kernel(kernel_size, sigma)).to(
            pred.device))
    weight = kernel[None, None].expand(C, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x, weight, groups=C)

    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x, mu_y = filt(x), filt(y)
    mu_xx, mu_yy, mu_xy = filt(x * x), filt(y * y), filt(x * y)
    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)
