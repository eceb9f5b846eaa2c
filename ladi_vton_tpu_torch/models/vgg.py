"""VGG19 feature tower and the perceptual loss of the trainers.

Counterpart of ``ladi_vton_tpu/models/vgg.py`` (the reference's
torchvision-based ``VGGLoss``): the loss taps the ReLU after
torchvision ``features`` convs 0, 5, 10, 19 and 28 (relu1_1 ... relu5_1)
and sums the L1 distances of the five taps with weights
[1/32, 1/16, 1/8, 1/4, 1], on inputs resized to a short side of 256 and
ImageNet-normalised.  Written by hand, since torchvision is not a
dependency: ``VGG19Features.features`` is torchvision's ``vgg19().features``
Sequential, layer for layer, so a torchvision VGG19 state dict's
``features.<i>`` entries load with ``load_state_dict(strict=True)``
(``load_vgg19`` drops the classifier).  The forward stops after the last
tap.  The loss runs in fp32 with autocast off, its convolutions in cuDNN,
as the reference runs it; the target's features carry no gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ladi_vton_tpu_torch.ops.resize import resize_bilinear

# torchvision vgg19's configuration "E": conv widths, "M" a max pool
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
# the features index of each tapped conv; the tap is the ReLU after it
TAP_CONVS = (0, 5, 10, 19, 28)
LOSS_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """``forward(x)`` (NCHW, normalised) -> the five tapped activations."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1),
                           nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i - 1 in TAP_CONVS:  # the ReLU after a tapped conv
                taps.append(x)
                if i - 1 == TAP_CONVS[-1]:
                    break
        return taps


def load_vgg19(path, device="cpu") -> VGG19Features:
    """``VGG19Features`` from a torchvision VGG19 ``.pth`` state dict (its
    ``features.*`` entries, strictly), fp32 on ``device``, eval mode."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    vgg = VGG19Features()
    vgg.load_state_dict({k: v for k, v in state.items()
                         if k.startswith("features.")}, strict=True)
    return vgg.to(device).eval().requires_grad_(False)


def vgg_preprocess(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW image -> short side 256 (bilinear, as the JAX
    package's ``resize_bilinear``), in [0, 1], ImageNet-normalised; fp32.
    """
    H, W = x.shape[-2:]
    scale = 256 / min(H, W)
    x = resize_bilinear(x.float(), (int(round(H * scale)),
                                    int(round(W * scale))))
    x = (x + 1.0) * 0.5
    mean = x.new_tensor(IMAGENET_MEAN)[None, :, None, None]
    std = x.new_tensor(IMAGENET_STD)[None, :, None, None]
    return (x - mean) / std


def vgg_loss(vgg: VGG19Features, pred: torch.Tensor, target: torch.Tensor,
             weights: Sequence[float] = LOSS_WEIGHTS) -> torch.Tensor:
    """Weighted L1 over the five taps (NCHW images in [-1, 1]); fp32."""
    with torch.autocast(pred.device.type, enabled=False):
        f_pred = vgg(vgg_preprocess(pred))
        with torch.no_grad():
            f_tgt = vgg(vgg_preprocess(target))
        total = pred.new_zeros((), dtype=torch.float32)
        for w, a, b in zip(weights, f_pred, f_tgt):
            total = total + w * F.l1_loss(a.float(), b.float())
    return total
