"""Thin-plate-spline geometric matching module (the garment warper).

Counterpart of ``ladi_vton_tpu/models/tps.py`` (the reference's
``ConvNet_TPS``): two strided-conv feature extractors (cloth, 3 channels;
agnostic, 21 = masked person 3 + pose 18), channelwise L2 norm, all-pairs
feature correlation, a bounded regression to a 5x5 control-point grid,
the TPS solve to a dense warp grid, and six grid regularisers.

Towers take NCHW tensors.  Module names are the reference's
(``extractionA.model.N``, ``loc_net.regression.conv.N``,
``loc_net.regression.linear``), so ``core.checkpoint.tps_key_map`` carries
a converted JAX state dict over with ``load_state_dict(strict=True)``.
BatchNorm (eps 1e-5) uses its running statistics in eval mode, as the
try-on path runs it; in train mode it follows flax's ``nn.BatchNorm``
(``models.layers.BatchNorm2d``), as the JAX package trains it.

The TPS system is inverted once on the host in float64, as the JAX
module does.  Its two products at run time are numerically sensitive
(the JAX module asks for ``Precision.HIGHEST``); here they run in
float64, which TF32 never touches, so the grid does not depend on
``torch.backends.cuda.matmul.allow_tf32``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ladi_vton_tpu_torch.models.layers import BatchNorm2d


def _tps_radial_np(dist_sq: np.ndarray) -> np.ndarray:
    """U(r) = r^2 log r = 0.5 * d2 * log(d2), with U(0) = 0."""
    safe = np.where(dist_sq == 0.0, 1.0, dist_sq)
    return np.where(dist_sq == 0.0, 0.0, 0.5 * safe * np.log(safe))


def make_control_points(grid_size: int = 5, span: float = 0.9) -> np.ndarray:
    """(N, 2) xy control points on a regular grid in [-span, span],
    row-major (a row has constant y)."""
    axis = np.linspace(-span, span, grid_size)
    yy, xx = np.meshgrid(axis, axis, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], axis=-1).astype(np.float32)


def tps_inverse_kernel(control_points: np.ndarray) -> np.ndarray:
    """Inverse of the padded (N+3)x(N+3) TPS system, on the host in
    float64, returned as float32."""
    cp = control_points.astype(np.float64)
    N = cp.shape[0]
    d2 = np.sum((cp[:, None, :] - cp[None, :, :]) ** 2, axis=-1)
    K = _tps_radial_np(d2)
    P = np.concatenate([np.ones((N, 1)), cp], axis=1)  # (N, 3)
    forward = np.block([[K, P], [P.T, np.zeros((3, 3))]])
    return np.linalg.inv(forward).astype(np.float32)


def tps_coordinate_repr(height: int, width: int,
                        control_points: np.ndarray) -> np.ndarray:
    """(H*W, N+3) dense-grid representation [U(d), 1, x, y]."""
    ys = np.linspace(-1.0, 1.0, height)
    xs = np.linspace(-1.0, 1.0, width)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel()], axis=-1)  # (HW, 2) xy
    d2 = np.sum((coords[:, None, :].astype(np.float64)
                 - control_points[None, :, :].astype(np.float64)) ** 2,
                axis=-1)
    U = _tps_radial_np(d2)
    ones = np.ones((coords.shape[0], 1))
    return np.concatenate([U, ones, coords], axis=1).astype(np.float32)


class TPSGridGen(nn.Module):
    """Control-point targets -> dense warp grid, with the solver
    precomputed (non-persistent buffers: not part of the state dict)."""

    def __init__(self, height: int, width: int,
                 control_points: Optional[np.ndarray] = None):
        super().__init__()
        if control_points is None:
            control_points = make_control_points()
        self.height = height
        self.width = width
        self.register_buffer("inverse_kernel", torch.from_numpy(
            tps_inverse_kernel(control_points)), persistent=False)
        self.register_buffer("coord_repr", torch.from_numpy(
            tps_coordinate_repr(height, width, control_points)),
            persistent=False)

    def forward(self, source_control_points: torch.Tensor) -> torch.Tensor:
        """(B, N, 2) source points -> (B, H, W, 2) sampling grid (xy)."""
        B = source_control_points.shape[0]
        Y = torch.cat([source_control_points.double(),
                       source_control_points.new_zeros(
                           (B, 3, 2), dtype=torch.float64)], dim=1)
        mapping = torch.matmul(self.inverse_kernel.double(), Y)
        coords = torch.matmul(self.coord_repr.double(), mapping)
        return coords.to(source_control_points.dtype).reshape(
            B, self.height, self.width, 2)


def _conv(cin: int, cout: int, k: int, s: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=1)


class FeatureExtraction(nn.Module):
    """Four stride-2 convs and two 3x3 convs, each followed by ReLU and
    (but the last) BatchNorm: (B, C, H, W) -> (B, 512, H/16, W/16)."""

    def __init__(self, input_nc: int, ngf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [_conv(input_nc, ngf, 4, 2), nn.ReLU(), BatchNorm2d(ngf)]
        ch = ngf
        for i in range(n_layers):
            out_ch = min(2 ** (i + 1) * ngf, 512)
            layers += [_conv(ch, out_ch, 4, 2), nn.ReLU(),
                       BatchNorm2d(out_ch)]
            ch = out_ch
        layers += [_conv(ch, 512, 3, 1), nn.ReLU(), BatchNorm2d(512),
                   _conv(512, 512, 3, 1), nn.ReLU()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def feature_l2norm(feat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Channelwise L2 normalisation over dim 1 (NCHW)."""
    return feat / torch.sqrt((feat * feat).sum(dim=1, keepdim=True) + eps)


def feature_correlation(feat_a: torch.Tensor,
                        feat_b: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation, NCHW in, (B, W*H, H, W) out.

    The spatial axes index B positions; the channel axis enumerates A
    positions width-major (k = w * H + h), as the reference flattens A,
    so converted regression weights see the same channel order.
    """
    B, C, H, W = feat_a.shape
    a_flat = feat_a.permute(0, 3, 2, 1).reshape(B, W * H, C)
    b_flat = feat_b.permute(0, 2, 3, 1).reshape(B, H * W, C)
    corr = torch.bmm(b_flat.float(), a_flat.float().transpose(1, 2))
    return corr.reshape(B, H, W, W * H).permute(0, 3, 1, 2).to(feat_a.dtype)


class FeatureRegression(nn.Module):
    """conv-BN-ReLU x4, flatten in NCHW order, linear, tanh.

    Like the JAX module's init, the linear starts at zero weight and
    ``arctanh(target)`` bias, so tanh(linear(.)) is the identity warp."""

    def __init__(self, input_nc: int, output_dim: int, flat_features: int,
                 target_bias: Optional[np.ndarray] = None):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(input_nc, 512, 4, stride=2, padding=1),
            BatchNorm2d(512), nn.ReLU(),
            nn.Conv2d(512, 256, 4, stride=2, padding=1),
            BatchNorm2d(256), nn.ReLU(),
            nn.Conv2d(256, 128, 3, padding=1), BatchNorm2d(128), nn.ReLU(),
            nn.Conv2d(128, 64, 3, padding=1), BatchNorm2d(64), nn.ReLU())
        self.linear = nn.Linear(flat_features, output_dim)
        with torch.no_grad():
            self.linear.weight.zero_()
            if target_bias is None:
                self.linear.bias.zero_()
            else:
                self.linear.bias.copy_(torch.from_numpy(
                    np.asarray(target_bias, np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return torch.tanh(self.linear(h.reshape(h.shape[0], -1)))


class LocNet(nn.Module):
    """Holds the regression under the reference's ``loc_net`` name."""

    def __init__(self, regression: FeatureRegression):
        super().__init__()
        self.regression = regression


def grid_regularization_losses(coor: torch.Tensor, grid_size: int = 5):
    """Second-difference and collinearity regularisers on control points.

    ``coor`` is (B, N, 2), row-major.  Returns the six scalars (rx, ry,
    cx, cy, rg, cg): rows/columns take |second difference| of squared
    consecutive differences floored at 0.08 and averaged; rg/cg sum the
    collinearity cross products of consecutive triples of the first batch
    element, floored at 0.02.
    """
    g = grid_size
    B = coor.shape[0]
    pts = coor.reshape(B, g, g, 2)

    def second_diff(p):
        diff = (p[:, :, 1:, :] - p[:, :, :-1, :]) ** 2
        return (diff[:, :, 1:, :] - diff[:, :, :-1, :]).abs().reshape(B, -1, 2)

    row = second_diff(pts)
    col = second_diff(pts.transpose(1, 2))
    floor = torch.tensor(0.08, dtype=coor.dtype, device=coor.device)
    rx = torch.maximum(floor, row[..., 0]).mean()
    ry = torch.maximum(floor, row[..., 1]).mean()
    cx = torch.maximum(floor, col[..., 0]).mean()
    cy = torch.maximum(floor, col[..., 1]).mean()

    def collinearity(p):  # (g, g, 2), one batch element
        p0, p1, p2 = p[:, :-2], p[:, 1:-1], p[:, 2:]
        cross = ((p1[..., 1] - p0[..., 1]) * (p1[..., 0] - p2[..., 0])
                 - (p1[..., 1] - p2[..., 1]) * (p1[..., 0] - p0[..., 0]))
        return cross.abs().sum()

    lo = torch.tensor(0.02, dtype=coor.dtype, device=coor.device)
    rg = torch.maximum(collinearity(pts[0]), lo)
    cg = torch.maximum(collinearity(pts[0].transpose(0, 1)), lo)
    return rx, ry, cx, cy, rg, cg


class ConvNetTPS(nn.Module):
    """``forward(cloth, agnostic)`` -> (grid (B, H, W, 2), control points
    (B, N, 2), rx, ry, cx, cy, rg, cg); inputs NCHW at (height, width),
    which must be at least 64 in each dimension (the regression's second
    stride-2 conv needs a 2-pixel input)."""

    def __init__(self, height: int = 256, width: int = 192,
                 input_nc_b: int = 21, grid_size: int = 5):
        super().__init__()
        self.grid_size = grid_size
        cp = make_control_points(grid_size)
        self.grid_gen = TPSGridGen(height, width, cp)
        self.extractionA = FeatureExtraction(3)
        self.extractionB = FeatureExtraction(input_nc_b)
        fh, fw = height // 16, width // 16
        rh, rw = fh // 4, fw // 4  # two k4/s2/p1 convs
        self.loc_net = LocNet(FeatureRegression(
            fh * fw, grid_size * grid_size * 2, 64 * rh * rw,
            target_bias=np.arctanh(cp).reshape(-1)))

    def forward(self, cloth: torch.Tensor, agnostic: torch.Tensor):
        feat_a = feature_l2norm(self.extractionA(cloth))
        feat_b = feature_l2norm(self.extractionB(agnostic))
        corr = feature_correlation(feat_a, feat_b)
        points = self.loc_net.regression(corr)
        coor = points.reshape(points.shape[0], -1, 2)
        losses = grid_regularization_losses(coor, self.grid_size)
        return (self.grid_gen(coor), coor, *losses)
