"""The port's try-on slice as a whole against the JAX package, on the CPU.

``TryOnPipeline.sample`` at 64x64, B=1, CFG 7.5, with warped cloth and
EMASC, on the tiny towers of ``bench.py``'s CPU mode with the same random
parameters on both sides: under each scheduler (2 steps; PNDM runs the
UNet 3 times), and with each option of the JAX pipeline
(``warped_cloth=None`` with a 27-channel UNet, ``no_pose``,
``emasc=None``, a ``latents=`` override and ``hoist_context_kv``).  The
JAX pipeline's three normal draws (``jax.random.split(rng, 3)``: initial
latents, masked-image latents, cloth latents) are reproduced here and
handed to the port's ``prepare``.  The JAX side runs as
``jit_sample(split=True)`` does, prepare, denoise and decode jitted
apart; the jitted stages are shared between cases where a case does not
change them.  Then the same request goes through the port's
``TryOnService``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ladi_vton_tpu.diffusion import schedulers as jax_schedulers
from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu.models.vae import AutoencoderKL as JaxVAE
from ladi_vton_tpu.models.vae import VAEConfig as JaxVAEConfig
from ladi_vton_tpu.pipelines.tryon import TryOnPipeline as JaxTryOnPipeline
from ladi_vton_tpu_torch.core.checkpoint import state_dict_from_jax, unet_key_map
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
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
STEPS = 2
UNET = dict(block_out_channels=(32, 64, 64, 64), head_dim=8,
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


def unet_pair(in_channels: int, seed: int):
    junet = JaxUNet(JaxUNetConfig(in_channels=in_channels, **UNET),
                    attn_impl="xla")
    params, flat = random_params(
        junet, jnp.zeros((1, H // 8, W // 8, in_channels)), jnp.asarray([0]),
        jnp.zeros((1, 7, CTX)), seed=seed)
    unet = UNet2DCondition(UNetConfig(in_channels=in_channels, **UNET))
    unet.load_state_dict(state_dict_from_jax(flat, unet_key_map), strict=True)
    return junet, params, unet


class JaxStages:
    """A JAX pipeline's prepare, denoise and decode, jitted apart as
    ``jit_sample(split=True)`` jits them, each compiled once per static
    option and shared by every case that reuses it."""

    def __init__(self, jpipe):
        self.jpipe = jpipe
        self.jits = {}

    def jit(self, name: str, **static):
        key = (name, tuple(sorted(static.items())))
        if key not in self.jits:
            self.jits[key] = jax.jit(functools.partial(
                getattr(self.jpipe, name), **static))
        return self.jits[key]


@pytest.fixture(scope="module")
def pipelines():
    junet, pu, unet = unet_pair(31, seed=40)
    jvae = JaxVAE(JaxVAEConfig(**VAE))
    jemasc = JaxEMASC(in_channels=EMASC_IN, out_channels=EMASC_OUT)
    pv, fv = random_params(jvae, jnp.zeros((1, H, W, 3)), seed=41)
    pe, fe = random_params(jemasc, [jnp.zeros((1, 8, 8, c))
                                    for c in EMASC_IN], seed=42)
    jpipe = JaxTryOnPipeline(unet=junet, vae=jvae, emasc=jemasc,
                             scheduler=jax_schedulers.DDIMScheduler())
    vae = AutoencoderKL(VAEConfig(**VAE))
    vae.load_state_dict(state_dict_from_jax(fv), strict=True)
    emasc = EMASC(EMASC_IN, EMASC_OUT)
    emasc.load_state_dict(state_dict_from_jax(fe), strict=True)
    pipe = TryOnPipeline(unet=unet, vae=vae, emasc=emasc,
                         scheduler=make_scheduler("ddim"))
    return JaxStages(jpipe), {"unet": pu, "vae": pv, "emasc": pe}, pipe


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


def jax_sample(stages: JaxStages, denoise: JaxStages, params, req, rng, *,
               no_pose=False, latents=None) -> np.ndarray:
    """``TryOnPipeline.sample`` of the JAX package, stage by stage:
    ``stages`` prepares and decodes, ``denoise`` (a pipeline that differs
    at most in its scheduler, UNet or hoisting) denoises."""
    a = {k: (None if v is None else jnp.asarray(v)) for k, v in req.items()}
    prepared = stages.jit("prepare", no_pose=no_pose)(
        params, image=a["image"], mask_image=a["mask_image"],
        pose_map=a["pose_map"], warped_cloth=a["warped_cloth"], rng=rng)
    if latents is not None:
        prepared["latents"] = jnp.asarray(latents)
    intermediate = prepared.pop("intermediate")
    lat = denoise.jit("denoise", num_inference_steps=STEPS,
                      guidance_scale=7.5)(
        params, prepared, prompt_embeds=a["prompt_embeds"],
        negative_prompt_embeds=a["negative_prompt_embeds"])
    return np.asarray(stages.jit("decode")(params, lat, intermediate))


def port_sample(pipe, req, rng, **options) -> np.ndarray:
    out = pipe.sample(**{k: (None if v is None else torch.from_numpy(v))
                         for k, v in req.items()},
                      noise=_jax_noise(rng, 1), num_inference_steps=STEPS,
                      guidance_scale=7.5, **options).numpy()
    assert out.shape == (1, H, W, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    return out


def test_prepare_mask_and_masked_image():
    image = torch.ones(1, 4, 4, 3)
    mask = torch.tensor([0.1, 0.6, 0.4, 0.9]).reshape(1, 1, 4, 1).expand(
        1, 4, 4, 1)
    m, mi = prepare_mask_and_masked_image(image, mask)
    assert m[0, 0, :, 0].tolist() == [0, 1, 0, 1]
    assert mi[0, 0, :, 0].tolist() == [1, 0, 1, 0]


# fp32 differences of ~1e-6 in the UNet's output grow by the CFG factor
# 7.5 over two steps and through the decoder (7.5e-6 seen under DDIM):
# 1e-4 on the [0, 1] image, 1/39 of one 8-bit grey level, under every
# scheduler and option (2.9e-5 seen, under DPM-Solver++)
ATOL = 1e-4


@pytest.mark.parametrize("scheduler", ["ddim", "pndm", "lms", "dpm"])
def test_sample_matches_jax_pipeline(pipelines, scheduler):
    stages, params, pipe = pipelines
    req = _request(50)
    rng = jax.random.key(51)
    denoise = (stages if scheduler == "ddim" else JaxStages(
        dataclasses.replace(stages.jpipe,
                            scheduler=jax_schedulers.make_scheduler(
                                scheduler))))
    ref = jax_sample(stages, denoise, params, req, rng)
    ours = port_sample(dataclasses.replace(
        pipe, scheduler=make_scheduler(scheduler)), req, rng)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("option", ["no_pose", "latents", "no_emasc",
                                    "hoist_context_kv", "no_warped_cloth"])
def test_sample_options_match_jax_pipeline(pipelines, option):
    stages, params, pipe = pipelines
    req = _request(52)
    rng = jax.random.key(53)
    jax_kw, port_kw = {}, {}
    denoise = stages
    if option == "no_pose":
        jax_kw["no_pose"] = port_kw["no_pose"] = True
    elif option == "latents":
        lat = np.random.default_rng(54).standard_normal(
            (1, H // 8, W // 8, 4)).astype(np.float32)
        jax_kw["latents"] = lat
        port_kw["latents"] = torch.from_numpy(lat)
    elif option == "no_emasc":
        stages = denoise = JaxStages(dataclasses.replace(stages.jpipe,
                                                         emasc=None))
        params = {k: v for k, v in params.items() if k != "emasc"}
        pipe = dataclasses.replace(pipe, emasc=None)
    elif option == "hoist_context_kv":
        denoise = JaxStages(dataclasses.replace(stages.jpipe,
                                                hoist_context_kv=True))
        pipe = dataclasses.replace(pipe, hoist_context_kv=True)
    else:  # the reference's cloth_input_type='none': a 27-channel UNet
        junet, pu, unet = unet_pair(27, seed=55)
        denoise = JaxStages(dataclasses.replace(stages.jpipe, unet=junet))
        params = {**params, "unet": pu}
        pipe = dataclasses.replace(pipe, unet=unet)
        req["warped_cloth"] = None
    ref = jax_sample(stages, denoise, params, req, rng, **jax_kw)
    ours = port_sample(pipe, req, rng, **port_kw)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    if option == "hoist_context_kv":
        inline = port_sample(dataclasses.replace(pipe, hoist_context_kv=False),
                             req, rng)
        np.testing.assert_array_equal(ours, inline)


def test_unet_takes_hoisted_context_kv_as_inline(pipelines):
    _, _, pipe = pipelines
    rng = np.random.default_rng(56)
    x = torch.from_numpy(rng.standard_normal((2, 31, 8, 8)).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, CTX)).astype(
        np.float32))
    t = torch.tensor([981, 981])
    with torch.no_grad():
        kv = pipe.unet.precompute_context_kv(ctx)
        assert len(kv) == 16  # 3 down blocks x 2, the mid block, 3 up x 3
        np.testing.assert_array_equal(
            pipe.unet(x, t, ctx, context_kv=kv).numpy(),
            pipe.unet(x, t, ctx).numpy())
        with pytest.raises(ValueError, match="more entries"):
            pipe.unet(x, t, ctx, context_kv=kv + kv[:1])


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
