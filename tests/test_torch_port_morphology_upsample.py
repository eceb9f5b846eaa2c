"""The port's ``ops.morphology`` and ``ops.upsample`` against the JAX
package's, on the CPU.

* ``dilate`` and ``erode`` on seeded masks, float32 and int32 (the JAX
  op pads an integer mask with its dtype's minimum in the mask's own
  dtype; JAX's default integer is int32), kernel 3 and 5, iterations 0,
  1 and 5, at every rank of shape it takes ((H, W), HWC, NHWC): bitwise
  equal, dtype and shape included.  A max is exact, so any difference is
  a wrong window or padding.
* ``nearest_up2_conv3x3`` against the JAX op with the same weights (HWIO
  -> OIHW) and against ``F.interpolate`` (nearest, 2x) then the 3x3
  convolution, at C = 8 and 16, odd and even H and W, fp32: within 1e-5,
  the re-association of sums over 9 C products (weights scaled by
  1/sqrt(fan in), as a convolution's are, so outputs are of unit scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ladi_vton_tpu.ops import morphology as jax_morphology
from ladi_vton_tpu.ops.upsample import nearest_up2_conv3x3 as jax_up2
from ladi_vton_tpu_torch import ops
from ladi_vton_tpu_torch.ops import morphology
from ladi_vton_tpu_torch.ops.upsample import nearest_up2_conv3x3

SHAPES = {"hw": (17, 13), "hwc": (17, 13, 2), "nhwc": (2, 17, 13, 3)}
UP_ATOL = 1e-5


def mask(rng, shape, dtype) -> np.ndarray:
    if dtype == np.float32:
        # a binary mask with a few soft values, as a resized mask has
        m = (rng.uniform(0, 1, shape) > 0.8).astype(np.float32)
        return np.where(rng.uniform(0, 1, shape) > 0.9,
                        rng.uniform(0, 1, shape), m).astype(np.float32)
    return rng.integers(-5, 20, shape).astype(dtype)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["float32", "int32"])
def test_dilate_and_erode_are_bitwise_jax(shape, dtype):
    rng = np.random.default_rng(70)
    m = mask(rng, SHAPES[shape], dtype)
    for kernel_size in (3, 5):
        for iterations in (0, 1, 5):
            for name in ("dilate", "erode"):
                ref = np.asarray(getattr(jax_morphology, name)(
                    jnp.asarray(m), kernel_size, iterations))
                ours = getattr(morphology, name)(
                    torch.from_numpy(m), kernel_size, iterations).numpy()
                assert ours.dtype == ref.dtype and ours.shape == ref.shape
                np.testing.assert_array_equal(
                    ours, ref, err_msg=f"{name} k={kernel_size} "
                                       f"n={iterations}")


def test_dilate_is_exported_and_refuses_other_ranks():
    assert ops.dilate is morphology.dilate
    with pytest.raises(ValueError, match="ndim"):
        ops.dilate(torch.zeros(1, 1, 1, 4, 4))


@pytest.mark.parametrize("C,H,W", [(8, 5, 7), (8, 6, 4), (16, 7, 8),
                                   (16, 4, 6)])
def test_nearest_up2_conv3x3_matches_jax_and_interpolate(C, H, W):
    rng = np.random.default_rng(71 + C + H)
    O = 12
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, C, O))
              / np.sqrt(9 * C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(O)).astype(np.float32)
    ref = np.asarray(jax_up2(jnp.asarray(x), jnp.asarray(kernel),
                             jnp.asarray(bias)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    weight = torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous()
    b = torch.from_numpy(bias)
    ours = nearest_up2_conv3x3(xt, weight, b)
    assert ours.shape == (2, O, 2 * H, 2 * W)
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=UP_ATOL)
    conv = F.conv2d(F.interpolate(xt, scale_factor=2.0, mode="nearest"),
                    weight, b, padding=1)
    np.testing.assert_allclose(ours.numpy(), conv.numpy(), rtol=0,
                               atol=UP_ATOL)
