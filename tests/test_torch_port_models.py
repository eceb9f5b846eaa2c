"""Parity of the PyTorch port's towers with the JAX package, on the CPU.

The tiny configurations of ``bench.py``'s CPU mode: UNet (32, 64, 64,
64) with head_dim 8 and a 64-wide context, VAE (32, 32, 64, 64), EMASC
(32, 32, 32, 32, 64) -> (32, 32, 64, 64, 64).  Random parameters are
made with numpy from a seed, in the JAX module's tree (taken from
``eval_shape``, so nothing is initialised twice), and carried to the
port through ``state_dict_from_jax`` and ``load_state_dict(strict=True)``.
Everything runs in fp32.  Tolerance: 1e-4, for fp32 sums taken in
another order through a few dozen layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.emasc import mask_features as jax_mask_features
from ladi_vton_tpu.models.layers import Transformer2D as JaxTransformer2D
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu.models.vae import AutoencoderKL as JaxVAE
from ladi_vton_tpu.models.vae import VAEConfig as JaxVAEConfig
from ladi_vton_tpu_torch.core.checkpoint import (
    emasc_key_map,
    state_dict_from_jax,
    unet_key_map,
)
from ladi_vton_tpu_torch.models.emasc import EMASC, mask_features
from ladi_vton_tpu_torch.models.layers import Transformer2D
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition, UNetConfig
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig

ATOL = RTOL = 1e-4
EMASC_IN = (32, 32, 32, 32, 64)
EMASC_OUT = (32, 32, 64, 64, 64)


def random_params(module, *init_args, seed: int):
    """(flax variables, flat numpy dict) of random parameters: kernels
    N(0, 1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
    shapes = flatten_dict(jax.eval_shape(module.init, jax.random.key(0),
                                         *init_args))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, s in shapes.items():
        z = rng.standard_normal(s.shape).astype(np.float32)
        if path[-1] == "kernel":
            flat[path] = z / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1] == "scale":
            flat[path] = 1.0 + 0.1 * z
        else:
            flat[path] = 0.1 * z
    return unflatten_dict(flat), flat


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def test_unet_matches_jax():
    cfg = dict(in_channels=31, block_out_channels=(32, 64, 64, 64),
               head_dim=8, cross_attention_dim=64)
    junet = JaxUNet(JaxUNetConfig(**cfg), attn_impl="xla")
    params, flat = random_params(junet, jnp.zeros((1, 8, 8, 31)),
                                 jnp.asarray([0]), jnp.zeros((1, 7, 64)),
                                 seed=10)
    unet = UNet2DCondition(UNetConfig(**cfg))
    unet.load_state_dict(state_dict_from_jax(flat, unet_key_map), strict=True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 31)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    t = np.asarray([21, 981])
    ref = np.asarray(jax.jit(junet.apply)(params, jnp.asarray(x),
                                          jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        ours = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(ours), ref, rtol=RTOL, atol=ATOL)


def test_transformer2d_matches_jax():
    jt = JaxTransformer2D(num_heads=2, head_dim=32)
    x = np.random.default_rng(12).standard_normal((2, 4, 6, 64)).astype(
        np.float32)
    ctx = np.random.default_rng(13).standard_normal((2, 5, 48)).astype(
        np.float32)
    params, flat = random_params(jt, jnp.asarray(x), jnp.asarray(ctx),
                                 seed=14)
    ours_mod = Transformer2D(2, 32, 64, 48)
    ours_mod.load_state_dict(state_dict_from_jax(flat, unet_key_map),
                             strict=True)
    ref = np.asarray(jt.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    with torch.no_grad():
        ours = ours_mod(_nchw(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(_nhwc(ours), ref, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def vae_pair():
    cfg = dict(block_out_channels=(32, 32, 64, 64))
    jvae = JaxVAE(JaxVAEConfig(**cfg))
    params, flat = random_params(jvae, jnp.zeros((1, 64, 64, 3)), seed=20)
    vae = AutoencoderKL(VAEConfig(**cfg))
    vae.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jvae, params, vae


def test_vae_encode_taps_match_jax(vae_pair):
    jvae, params, vae = vae_pair
    x = np.random.default_rng(21).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref_m, ref_f = jax.jit(lambda p, a: jvae.apply(p, a, method="encode"))(
        params, jnp.asarray(x))
    with torch.no_grad():
        moments, feats = vae.encode(_nchw(x))
    np.testing.assert_allclose(_nhwc(moments), np.asarray(ref_m), rtol=RTOL,
                               atol=ATOL)
    assert len(feats) == len(ref_f) == 6
    for ours, ref in zip(feats, ref_f):
        np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("int_layers", [(1, 2, 3, 4, 5), (0, 1, 2, 3, 4)])
def test_vae_decode_with_injection_matches_jax(vae_pair, int_layers):
    jvae, params, vae = vae_pair
    rng = np.random.default_rng(22)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    # injected features at the decoder's resolutions, in encoder order
    shapes = [(64, 64, 32), (64, 64, 32), (32, 32, 64), (16, 16, 64),
              (8, 8, 64)]
    if 0 in int_layers:
        shapes[0] = (64, 64, 3)
    feats = [0.1 * rng.standard_normal((1,) + s).astype(np.float32)
             for s in shapes]
    ref = jax.jit(lambda p, a, f: jvae.apply(p, a, f, int_layers,
                                             method="decode"))(
        params, jnp.asarray(z), [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        ours = vae.decode(_nchw(z), [_nchw(f) for f in feats], int_layers)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_vae_tiled_encode_matches_jax(vae_pair):
    """Tiles of 32 pixels at a stride of 24 over 56x48, the last row and
    column of tiles partial (8 and 24 pixels), blended over 1 latent
    pixel."""
    jvae, params, vae = vae_pair
    x = np.random.default_rng(23).uniform(-1, 1, (1, 56, 48, 3)).astype(
        np.float32)
    ref = jax.jit(lambda p, a: jvae.apply(p, a, tile=32, overlap=0.25,
                                          method="tiled_encode"))(
        params, jnp.asarray(x))
    with torch.no_grad():
        ours = vae.tiled_encode(_nchw(x), tile=32, overlap=0.25)
    assert ours.shape == (1, 8, 7, 6) and ours.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_vae_tiled_decode_matches_jax(vae_pair):
    """Latent tiles of 4 at a stride of 3 over 7x6 (tiles of 1 and 3
    latent pixels at the edges), blended over 8 pixels."""
    jvae, params, vae = vae_pair
    z = np.random.default_rng(24).standard_normal((1, 7, 6, 4)).astype(
        np.float32)
    ref = jax.jit(lambda p, a: jvae.apply(p, a, tile=4, overlap=0.25,
                                          method="tiled_decode"))(
        params, jnp.asarray(z))
    with torch.no_grad():
        ours = vae.tiled_decode(_nchw(z), tile=4, overlap=0.25)
    assert ours.shape == (1, 3, 56, 48) and ours.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["nonlinear", "linear"])
def test_emasc_and_mask_features_match_jax(kind):
    jemasc = JaxEMASC(in_channels=EMASC_IN, out_channels=EMASC_OUT,
                      kind=kind)
    sizes = (64, 64, 32, 16, 8)
    rng = np.random.default_rng(30)
    feats = [rng.standard_normal((1, s, s, c)).astype(np.float32)
             for s, c in zip(sizes, EMASC_IN)]
    params, flat = random_params(jemasc, [jnp.asarray(f) for f in feats],
                                 seed=31)
    emasc = EMASC(EMASC_IN, EMASC_OUT, kind=kind)
    emasc.load_state_dict(state_dict_from_jax(flat, emasc_key_map(kind)),
                          strict=True)
    mask = (rng.uniform(size=(1, 64, 64, 1)) > 0.5).astype(np.float32)
    ref = jax_mask_features(
        jemasc.apply(params, [jnp.asarray(f) for f in feats]),
        jnp.asarray(mask))
    with torch.no_grad():
        ours = mask_features(emasc([_nchw(f) for f in feats]), _nchw(mask))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(_nhwc(o), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
