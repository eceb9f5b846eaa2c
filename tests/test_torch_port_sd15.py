"""The port's SD-1.5 family of the extended UNet against the JAX package,
on the CPU.

SD-1.5-inpainting differs from SD-2 in three places: 1x1-conv
``proj_in``/``proj_out`` (``use_linear_projection=False``), eight heads at
every width (``head_dim=-1``: head dims 40, 80 and 160 at full width) and a
768-wide context from the ``quick_gelu`` ViT-L/14 text tower.  Random
parameters are made with numpy from a seed in the JAX module's tree and
carried to the port through ``state_dict_from_jax(flat, unet_key_map)``
and ``load_state_dict(strict=True)``, or through the two zoos from the
files the JAX package writes.  Everything runs in fp32; tolerances are
those of the port's tower tests (1e-4) and of its pipeline test.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladi_vton_tpu.core.checkpoint import export_torch_state, unet_torch_key_map
from ladi_vton_tpu.diffusion import schedulers as jax_schedulers
from ladi_vton_tpu.hub import zoo as jzoo
from ladi_vton_tpu.models import clip as jclip
from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.layers import Transformer2D as JaxTransformer2D
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.models.unet_condition import UNetConfig as JaxUNetConfig
from ladi_vton_tpu.models.unet_condition import (
    precompute_context_kv as jax_precompute_context_kv,
)
from ladi_vton_tpu.models.unet_condition import (
    sd15_unet_config as jax_sd15_unet_config,
)
from ladi_vton_tpu.models.vae import AutoencoderKL as JaxVAE
from ladi_vton_tpu.models.vae import VAEConfig as JaxVAEConfig
from ladi_vton_tpu.pipelines.tryon import TryOnPipeline as JaxTryOnPipeline
from ladi_vton_tpu_torch.core.checkpoint import (
    clip_text_key_map,
    state_dict_from_jax,
    unet_key_map,
)
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models import clip
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.layers import Transformer2D
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    UNetConfig,
    sd15_unet_config,
)
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from test_torch_port_pipeline import (
    EMASC_IN,
    EMASC_OUT,
    VAE,
    JaxStages,
    _request,
    jax_sample,
    port_sample,
    random_params,
)
from test_torch_port_pipeline import ATOL as SAMPLE_ATOL
from test_torch_port_pipeline import H, W

ATOL = RTOL = 1e-4
T = torch.from_numpy
# the tiny SD-1.5 UNet of tests/test_models.py: eight heads of 4 and 8
TINY = dict(block_out_channels=(32, 32, 64, 64), head_dim=-1,
            cross_attention_dim=48, use_linear_projection=False)
# the SD-1.5 text tower at depth 1 with a small vocabulary: 768 wide, 12
# heads, quick_gelu, 77 positions
TEXT = dict(vocab_size=300, num_hidden_layers=1)
CTX = 768


def _nchw(x: np.ndarray) -> torch.Tensor:
    return T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def unet_pair(in_channels: int, seed: int, **cfg):
    cfg = {**TINY, **cfg, "in_channels": in_channels}
    junet = JaxUNet(JaxUNetConfig(**cfg), attn_impl="xla")
    params, flat = random_params(
        junet, jnp.zeros((1, 8, 8, in_channels)), jnp.asarray([0]),
        jnp.zeros((1, 7, cfg["cross_attention_dim"])), seed=seed)
    unet = UNet2DCondition(UNetConfig(**cfg))
    unet.load_state_dict(state_dict_from_jax(flat, unet_key_map), strict=True)
    return junet, params, unet.eval()


def test_sd15_configs_match_jax():
    assert (dataclasses.asdict(sd15_unet_config())
            == dataclasses.asdict(jax_sd15_unet_config()))
    assert (dataclasses.asdict(clip.sd15_text_config())
            == dataclasses.asdict(jclip.sd15_text_config()))
    # at full width, on the meta device: eight heads of 40, 80 and 160,
    # (C, C, 1, 1) projections, a 768-wide context
    with torch.device("meta"):
        unet = UNet2DCondition(sd15_unet_config(31))
    assert unet.config.use_linear_projection is False
    attn = [m for m in unet.modules() if isinstance(m, Transformer2D)]
    assert len(attn) == 16
    got = sorted({(m.transformer_blocks[0].attn1.heads,
                   m.transformer_blocks[0].attn1.dim_head,
                   tuple(m.proj_in.weight.shape),
                   m.transformer_blocks[0].attn2.to_k.weight.shape[1])
                  for m in attn})
    assert got == [(8, 40, (320, 320, 1, 1), CTX),
                   (8, 80, (640, 640, 1, 1), CTX),
                   (8, 160, (1280, 1280, 1, 1), CTX)]


def test_transformer2d_conv_projection_matches_jax():
    jt = JaxTransformer2D(num_heads=2, head_dim=32,
                          use_linear_projection=False)
    x = np.random.default_rng(12).standard_normal((2, 4, 6, 64)).astype(
        np.float32)
    ctx = np.random.default_rng(13).standard_normal((2, 5, 48)).astype(
        np.float32)
    params, flat = random_params(jt, jnp.asarray(x), jnp.asarray(ctx),
                                 seed=14)
    ours_mod = Transformer2D(2, 32, 64, 48, linear=False)
    ours_mod.load_state_dict(state_dict_from_jax(flat, unet_key_map),
                             strict=True)
    assert ours_mod.proj_in.weight.shape == (64, 64, 1, 1)
    ref = np.asarray(jt.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    with torch.no_grad():
        ours = ours_mod(_nchw(x), T(ctx))
    np.testing.assert_allclose(_nhwc(ours), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("in_channels", [9, 31])
def test_sd15_unet_and_hoisted_kv_match_jax(in_channels):
    junet, params, unet = unet_pair(in_channels, seed=20 + in_channels)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 8, 8, in_channels)).astype(np.float32)
    t = np.asarray([1, 981])
    ctx = rng.standard_normal((2, 7, 48)).astype(np.float32)
    ref = np.asarray(jax.jit(junet.apply)(params, jnp.asarray(x),
                                          jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        ours = unet(_nchw(x), T(t), T(ctx))
        kv = unet.precompute_context_kv(T(ctx))
        hoisted = unet(_nchw(x), T(t), T(ctx), context_kv=kv)
    np.testing.assert_allclose(_nhwc(ours), ref, rtol=RTOL, atol=ATOL)
    # 3 down blocks x 2, the mid block, 3 up blocks x 3
    assert len(kv) == 16
    np.testing.assert_array_equal(hoisted.numpy(), ours.numpy())
    jkv = jax_precompute_context_kv(params, jnp.asarray(ctx), junet.config)
    assert len(jkv) == len(kv)
    for (k, v), (jk, jv) in zip(kv, jkv):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL,
                                   atol=ATOL)


def test_zoo_sidecar_release_loads_in_both_packages(tmp_path, monkeypatch):
    """A ``.pth`` the JAX package exports, with a sidecar that says
    ``use_linear_projection: false`` and ``head_dim: -1``, loads through
    both ``extended_unet``s into the same SD-1.5 UNet."""
    monkeypatch.setenv("LADI_VTON_NO_CONVERT_CACHE", "1")
    junet, params, _ = unet_pair(31, seed=30)
    path = tmp_path / "unet_vitonhd.pth"
    export_torch_state(params, path, unet_torch_key_map)
    side = {"in_channels": 31, "block_out_channels": [32, 32, 64, 64],
            "head_dim": -1, "cross_attention_dim": 48,
            "use_linear_projection": False}
    path.with_suffix(".config.json").write_text(json.dumps(side))
    junet2, jvars = jzoo.extended_unet(checkpoint=str(path),
                                       dtype=jnp.float32)
    unet = zoo.extended_unet(checkpoint=str(path), device="cpu")
    assert (dataclasses.asdict(unet.config)
            == dataclasses.asdict(junet2.config))
    assert isinstance(unet.down_blocks[0].attentions[0].proj_in,
                      torch.nn.Conv2d)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 8, 8, 31)).astype(np.float32)
    t = np.asarray([981, 21])
    ctx = rng.standard_normal((2, 77, 48)).astype(np.float32)
    ref = jax.jit(lambda v, a, b, c: JaxUNet(
        junet2.config, dtype=jnp.float32, attn_impl="xla").apply(
        v, a, b, c))(jvars, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        ours = unet(_nchw(x), T(t), T(ctx))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_zoo_diffusers_config_gives_the_same_unet(tmp_path, monkeypatch):
    """A diffusers-style SD-1.5 ``unet/config.json``: both packages keep
    ``cross_attention_dim`` and ``use_linear_projection`` and drop
    diffusers' ``attention_head_dim`` (a caveat of the reference: the
    heads stay 64 wide), so ``sd2_unet`` gives the same ``UNetConfig`` and
    the same UNet in both."""
    monkeypatch.setenv("LADI_VTON_NO_CONVERT_CACHE", "1")
    cfg = dict(block_out_channels=(64, 64, 128, 128), head_dim=64,
               cross_attention_dim=CTX, use_linear_projection=False)
    junet, params, _ = unet_pair(9, seed=40, **cfg)
    unet_dir = tmp_path / "sd15" / "unet"
    unet_dir.mkdir(parents=True)
    export_torch_state(params, unet_dir / "diffusion_pytorch_model.bin",
                       unet_torch_key_map)
    (unet_dir / "config.json").write_text(json.dumps({
        "_class_name": "UNet2DConditionModel", "in_channels": 9,
        "out_channels": 4, "block_out_channels": [64, 64, 128, 128],
        "layers_per_block": 2, "attention_head_dim": 8,
        "cross_attention_dim": CTX, "use_linear_projection": False,
        "sample_size": 64}))
    jcfg, jvars = jzoo.sd2_unet(str(tmp_path / "sd15"), in_channels=31)
    unet = zoo.sd2_unet(str(tmp_path / "sd15"), in_channels=31,
                        device="cpu")
    assert dataclasses.asdict(unet.config) == dataclasses.asdict(jcfg)
    assert (jcfg.cross_attention_dim, jcfg.use_linear_projection,
            jcfg.head_dim, jcfg.in_channels) == (CTX, False, 64, 31)
    rng = np.random.default_rng(41)
    x = rng.standard_normal((1, 8, 8, 31)).astype(np.float32)
    t = np.asarray([500])
    ctx = rng.standard_normal((1, 7, CTX)).astype(np.float32)
    ref = jax.jit(JaxUNet(jcfg, attn_impl="xla").apply)(
        jvars, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        ours = unet(_nchw(x), T(t), T(ctx))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def sd15_pipelines():
    """The tiny SD-1.5 UNet at a 768-wide context and the SD-1.5 text
    tower at depth 1, beside the pipeline test's tiny VAE and EMASC, in
    both packages."""
    junet, pu, unet = unet_pair(31, seed=50, cross_attention_dim=CTX)
    jvae = JaxVAE(JaxVAEConfig(**VAE))
    jemasc = JaxEMASC(in_channels=EMASC_IN, out_channels=EMASC_OUT)
    pv, fv = random_params(jvae, jnp.zeros((1, H, W, 3)), seed=51)
    pe, fe = random_params(jemasc, [jnp.zeros((1, 8, 8, c))
                                    for c in EMASC_IN], seed=52)
    jpipe = JaxTryOnPipeline(unet=junet, vae=jvae, emasc=jemasc,
                             scheduler=jax_schedulers.DDIMScheduler())
    vae = AutoencoderKL(VAEConfig(**VAE))
    vae.load_state_dict(state_dict_from_jax(fv), strict=True)
    emasc = EMASC(EMASC_IN, EMASC_OUT)
    emasc.load_state_dict(state_dict_from_jax(fe), strict=True)
    pipe = TryOnPipeline(unet=unet, vae=vae, emasc=emasc,
                         scheduler=make_scheduler("ddim"))
    jtext = jclip.CLIPTextModel(dataclasses.replace(
        jclip.sd15_text_config(), **TEXT))
    ptext, ftext = random_params(jtext, jnp.zeros((1, 77), jnp.int32),
                                 seed=53)
    text = clip.CLIPTextModel(dataclasses.replace(clip.sd15_text_config(),
                                                  **TEXT))
    text.load_state_dict(state_dict_from_jax(ftext, clip_text_key_map),
                         strict=True)
    return (JaxStages(jpipe), {"unet": pu, "vae": pv, "emasc": pe}, pipe,
            (jtext, ptext, text.eval()))


def _prompt_ids(seed: int) -> np.ndarray:
    """Two rows of CLIP-style ids (start 298, words, end 299, padding 0)
    over 77 positions: the prompt and the negative prompt."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((2, 77), np.int64)
    for i, n in enumerate((9, 3)):
        ids[i, :n + 2] = [298, *rng.integers(1, 259, n), 299]
    return ids


@pytest.mark.parametrize("hoist", [False, True], ids=["inline", "hoisted"])
def test_sd15_sample_matches_jax_pipeline(sd15_pipelines, hoist):
    """``TryOnPipeline.sample`` at 64x64, DDIM-2, CFG 7.5, with the
    prompts encoded by each package's quick_gelu text tower, the context
    K/V inline or hoisted (16 cross-attentions at 768 wide)."""
    stages, params, pipe, (jtext, ptext, text) = sd15_pipelines
    ids = _prompt_ids(55)
    jembeds = np.asarray(jtext.apply(ptext, jnp.asarray(ids))[0])
    with torch.no_grad():
        embeds = text(T(ids))[0].numpy()
    np.testing.assert_allclose(embeds, jembeds, rtol=RTOL, atol=ATOL)
    req = _request(56)
    rng = jax.random.key(57)
    denoise = stages
    if hoist:
        denoise = JaxStages(dataclasses.replace(stages.jpipe,
                                                hoist_context_kv=True))
        pipe = dataclasses.replace(pipe, hoist_context_kv=True)
    ref = jax_sample(stages, denoise, params,
                     {**req, "prompt_embeds": jembeds[:1],
                      "negative_prompt_embeds": jembeds[1:]}, rng)
    ours = port_sample(pipe, {**req, "prompt_embeds": embeds[:1],
                              "negative_prompt_embeds": embeds[1:]}, rng)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SAMPLE_ATOL)
