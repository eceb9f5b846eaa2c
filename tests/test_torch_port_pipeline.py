"""The port's try-on slice as a whole against the JAX package, on the CPU.

``TryOnPipeline.sample`` at 64x64, B=1, 2 DDIM steps, CFG 7.5, with warped
cloth and EMASC, on the tiny towers of ``bench.py``'s CPU mode with the
same random parameters on both sides.  The JAX pipeline's three normal
draws (``jax.random.split(rng, 3)``: initial latents, masked-image
latents, cloth latents) are reproduced here and handed to the port's
``prepare``.  Then the same request goes through the port's
``TryOnService``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ladi_vton_tpu.diffusion.schedulers import DDIMScheduler as JaxDDIM
from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu.models.vae import AutoencoderKL as JaxVAE
from ladi_vton_tpu.models.vae import VAEConfig as JaxVAEConfig
from ladi_vton_tpu.pipelines.tryon import TryOnPipeline as JaxTryOnPipeline
from ladi_vton_tpu_torch.core.checkpoint import state_dict_from_jax, unet_key_map
from ladi_vton_tpu_torch.diffusion.schedulers import DDIMScheduler
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition, UNetConfig
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ladi_vton_tpu_torch.pipelines.serving import TryOnService, request_seed
from ladi_vton_tpu_torch.pipelines.tryon import (
    TryOnPipeline,
    prepare_mask_and_masked_image,
)

H = W = 64
CTX = 64
UNET = dict(in_channels=31, block_out_channels=(32, 64, 64, 64), head_dim=8,
            cross_attention_dim=CTX)
VAE = dict(block_out_channels=(32, 32, 64, 64))
EMASC_IN = (32, 32, 32, 32, 64)
EMASC_OUT = (32, 32, 64, 64, 64)


def random_params(module, *init_args, seed: int):
    """(flax variables, flat numpy dict): kernels N(0, 1/fan_in), biases
    N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
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


@pytest.fixture(scope="module")
def pipelines():
    junet = JaxUNet(JaxUNetConfig(**UNET), attn_impl="xla")
    jvae = JaxVAE(JaxVAEConfig(**VAE))
    jemasc = JaxEMASC(in_channels=EMASC_IN, out_channels=EMASC_OUT)
    pu, fu = random_params(junet, jnp.zeros((1, H // 8, W // 8, 31)),
                           jnp.asarray([0]), jnp.zeros((1, 7, CTX)), seed=40)
    pv, fv = random_params(jvae, jnp.zeros((1, H, W, 3)), seed=41)
    pe, fe = random_params(jemasc, [jnp.zeros((1, 8, 8, c))
                                    for c in EMASC_IN], seed=42)
    jpipe = JaxTryOnPipeline(unet=junet, vae=jvae, emasc=jemasc,
                             scheduler=JaxDDIM())
    unet = UNet2DCondition(UNetConfig(**UNET))
    unet.load_state_dict(state_dict_from_jax(fu, unet_key_map), strict=True)
    vae = AutoencoderKL(VAEConfig(**VAE))
    vae.load_state_dict(state_dict_from_jax(fv), strict=True)
    emasc = EMASC(EMASC_IN, EMASC_OUT)
    emasc.load_state_dict(state_dict_from_jax(fe), strict=True)
    pipe = TryOnPipeline(unet=unet, vae=vae, emasc=emasc,
                         scheduler=DDIMScheduler())
    return jpipe, {"unet": pu, "vae": pv, "emasc": pe}, pipe


def _request(seed: int, n: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, H, W, 1), np.float32)
    mask[:, 16:56, 12:52] = 1.0
    f = np.float32
    return dict(
        image=rng.uniform(-1, 1, (n, H, W, 3)).astype(f),
        mask_image=mask,
        pose_map=rng.uniform(0, 1, (n, H, W, 18)).astype(f),
        warped_cloth=rng.uniform(-1, 1, (n, H, W, 3)).astype(f),
        prompt_embeds=rng.standard_normal((n, 77, CTX)).astype(f),
        negative_prompt_embeds=rng.standard_normal((n, 77, CTX)).astype(f),
    )


def _jax_noise(rng, n: int) -> dict:
    """The JAX pipeline's normal draws, as tryon.prepare makes them."""
    k_lat, k_masked, k_cloth = jax.random.split(rng, 3)
    shape = (n, H // 8, W // 8, 4)
    return {name: torch.from_numpy(np.array(jax.random.normal(k, shape)))
            for name, k in (("latents", k_lat), ("masked", k_masked),
                            ("cloth", k_cloth))}


def test_prepare_mask_and_masked_image():
    image = torch.ones(1, 4, 4, 3)
    mask = torch.tensor([0.1, 0.6, 0.4, 0.9]).reshape(1, 1, 4, 1).expand(
        1, 4, 4, 1)
    m, mi = prepare_mask_and_masked_image(image, mask)
    assert m[0, 0, :, 0].tolist() == [0, 1, 0, 1]
    assert mi[0, 0, :, 0].tolist() == [1, 0, 1, 0]


def test_sample_matches_jax_pipeline(pipelines):
    jpipe, params, pipe = pipelines
    req = _request(50)
    rng = jax.random.key(51)
    sampler = jpipe.jit_sample(split=True, num_inference_steps=2,
                               guidance_scale=7.5)
    ref = np.asarray(sampler(
        params, *(jnp.asarray(req[k]) for k in (
            "image", "mask_image", "pose_map", "warped_cloth",
            "prompt_embeds", "negative_prompt_embeds")), rng))
    ours = pipe.sample(**{k: torch.from_numpy(v) for k, v in req.items()},
                       noise=_jax_noise(rng, 1), num_inference_steps=2,
                       guidance_scale=7.5).numpy()
    assert ours.shape == (1, H, W, 3) and ours.dtype == np.float32
    assert np.isfinite(ours).all() and ours.min() >= 0 and ours.max() <= 1
    # fp32 differences of ~1e-6 in the UNet's output grow by the CFG
    # factor 7.5 over two DDIM steps and through the decoder (7.5e-6
    # seen): 1e-4 on the [0, 1] image, 1/39 of one 8-bit grey level
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_service_request_matches_pipeline(pipelines):
    _, _, pipe = pipelines
    service = TryOnService(pipe, batch_size=2, height=H, width=W,
                           num_inference_steps=2, guidance_scale=7.5,
                           context_dim=CTX, seed=7)
    req = _request(60)
    keys = ("image", "inpaint_mask", "pose_map", "warped_cloth",
            "prompt_embeds", "negative_prompt_embeds")
    args = dict(zip(keys, (req[k] for k in (
        "image", "mask_image", "pose_map", "warped_cloth", "prompt_embeds",
        "negative_prompt_embeds"))))
    out = service.generate(**args)
    assert out.shape == (1, H, W, 3)
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    # the service pads the request to its batch by repeating the last
    # sample and draws from a generator seeded by (seed, request count)
    padded = {k: torch.from_numpy(np.concatenate([v, v])) for k, v in
              req.items()}
    gen = torch.Generator().manual_seed(request_seed(7, 0))
    ref = pipe.sample(**padded, generator=gen, num_inference_steps=2,
                      guidance_scale=7.5).numpy()
    np.testing.assert_array_equal(out, ref[:1])
    with pytest.raises(ValueError, match="exceeds"):
        service.generate(**{k: np.concatenate([v] * 3) for k, v in
                            args.items()})
