"""LPIPS (AlexNet backbone) in PyTorch.

Counterpart of ``ladi_vton_tpu/metrics/lpips.py``: torchmetrics'
``LearnedPerceptualImagePatchSimilarity(net='alex', normalize=True)``
(reference: src/utils/val_metrics.py:191).  AlexNet's relu1-5 features,
each unit-normalised over channels, squared difference, a learned 1x1
head per layer (bias-free), spatial mean, summed over layers, mean over
the batch.  Inputs in [0, 1] are rescaled to [-1, 1], then through
LPIPS's scaling layer.

The module's own names are the lpips package's (``net.features.{idx}``
at torchvision's AlexNet indices 0, 3, 6, 8, 10, and
``lins.{i}.model.1``); ``lpips_state`` also takes the ``net.slice{K}``
and ``lin{i}`` layouts.  Run it under ``metrics.inception.strict_fp32``
on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ladi_vton_tpu_torch.ops.resize import device_cached

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
ALEX_INDICES = (0, 3, 6, 8, 10)
CHANNELS = (64, 192, 384, 256, 256)


class AlexNetFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, stride=2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, stride=2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i - 1 in ALEX_INDICES:  # after each conv's ReLU
                feats.append(x)
        return feats


class NetLinLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        self.lins = nn.ModuleList(NetLinLayer(c) for c in CHANNELS)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, *,
                normalize: bool = True) -> torch.Tensor:
        """Mean LPIPS distance of two NHWC batches (a 0-d tensor)."""
        if normalize:  # [0, 1] -> [-1, 1]
            img0 = img0 * 2.0 - 1.0
            img1 = img1 * 2.0 - 1.0
        # made once a device: a copy from the host cannot be captured
        shift, scale = device_cached(
            ("lpips", img0.dtype, img0.device),
            lambda: (img0.new_tensor(SHIFT), img0.new_tensor(SCALE)))
        f0 = self.net(((img0 - shift) / scale).permute(0, 3, 1, 2))
        f1 = self.net(((img1 - shift) / scale).permute(0, 3, 1, 2))
        total = img0.new_zeros(img0.shape[0])
        for lin, a, b in zip(self.lins, f0, f1):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            head = lin.model[1]((a - b) ** 2)
            total = total + head.mean(dim=(1, 2, 3))
        return total.mean()


def lpips_state(state: dict) -> dict:
    """An LPIPS-Alex checkpoint in the module's names: AlexNet convs from
    ``net.features.{idx}`` or ``net.slice{K}.{idx}``, heads from
    ``lins.{i}.model.1`` or ``lin{i}.model.1``."""
    out = {}
    for i, idx in enumerate(ALEX_INDICES):
        for prefix in (f"net.features.{idx}", f"net.slice{i + 1}.{idx}"):
            if f"{prefix}.weight" in state:
                for p in ("weight", "bias"):
                    out[f"net.features.{idx}.{p}"] = state[f"{prefix}.{p}"]
                break
    for i in range(len(CHANNELS)):
        for key in (f"lins.{i}.model.1.weight", f"lin{i}.model.1.weight"):
            if key in state:
                out[f"lins.{i}.model.1.weight"] = state[key]
                break
    return out
