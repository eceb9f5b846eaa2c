"""Parity of the port's conditioning path with the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX module
and its port counterpart, both in fp32.  Random parameters are made with
numpy in the JAX module's tree (``params`` and ``batch_stats``, shapes
from ``eval_shape``) and carried to the port through
``state_dict_from_jax`` and ``load_state_dict(strict=True)``.  Sizes are
those of ``tests/test_pipeline.py``'s tiny conditioning test (vision
hidden 16, text hidden 32, ``num_vstar`` 2), except the TPS size: at
64x48 the features are 4x3 and the regression's second stride-2 conv
gets a 1-pixel-wide input, which flax turns into a zero-width output
(the linear then sees no features) and torch refuses, so the TPS runs at
128x96 (features 8x6).  Each tolerance is stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

import ladi_vton_tpu.core.checkpoint as jax_ckpt
from ladi_vton_tpu.diffusion.text import encode_text_word_embedding as jax_encode
from ladi_vton_tpu.diffusion.text import splice_word_embeddings as jax_splice
from ladi_vton_tpu.hub.convert import convert_emasc
from ladi_vton_tpu.models import clip as jclip
from ladi_vton_tpu.models import tps as jtps
from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.inversion_adapter import InversionAdapter as JaxAdapter
from ladi_vton_tpu.models.refinement import UNetVanilla as JaxUNetVanilla
from ladi_vton_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from ladi_vton_tpu.ops.resize import resize_bilinear as jax_bilinear
from ladi_vton_tpu.pipelines.condition import build_condition_fn
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.diffusion.text import (
    encode_text_word_embedding,
    splice_word_embeddings,
)
from ladi_vton_tpu_torch.models import clip, tps
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.ops.grid_sample import grid_sample
from ladi_vton_tpu_torch.ops.resize import resize_bilinear
from ladi_vton_tpu_torch.pipelines.condition import Conditioner
from ladi_vton_tpu_torch.pipelines.serving import ConditionService

T = torch.from_numpy
# fp32 towers of a few layers, sums in another order: 1e-4 (as the
# port's UNet/VAE tests)
ATOL = RTOL = 1e-4
TH, TW = 128, 96          # TPS size (see the module docstring)
H, W = 128, 96            # image size of the whole-conditioner test
NUM_VSTAR = 2
VISION = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
              intermediate_size=32)
TEXT = dict(vocab_size=300, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16)


def random_variables(module, *init_args, seed: int):
    """(flax variables, flat numpy dict) of random values: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), BatchNorm variances in
    [0.5, 1.5], everything else N(0, 0.1^2)."""
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
        elif path[-1] == "var":
            flat[path] = rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        else:
            flat[path] = 0.1 * z
    return unflatten_dict(flat), flat


def load(module: torch.nn.Module, flat: dict, key_map) -> torch.nn.Module:
    module.load_state_dict(ckpt.state_dict_from_jax(flat, key_map),
                           strict=True)
    return module.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return T(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _ids(rng, n: int, with_vstar) -> np.ndarray:
    """CLIP-style ids: start 298, words, a '$' run, end 299, padding 0."""
    ids = np.zeros((n, 16), np.int64)
    for i in range(n):
        words = list(rng.integers(1, 259, 5))
        if with_vstar[i]:
            words += [259] * NUM_VSTAR
        ids[i, :len(words) + 2] = [298, *words, 299]
    return ids


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_matches_jax(padding_mode, align_corners):
    rng = np.random.default_rng(40)
    image = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    # reaching past [-1, 1]: the two clamp at different places in border
    # mode, and zeros mode drops the corners outside
    grid = rng.uniform(-1.3, 1.3, (2, 7, 9, 2)).astype(np.float32)
    grid[0, 0, :4] = [[-1, -1], [1, 1], [-1.3, 0.2], [1.3, -1.3]]
    ours = grid_sample(T(image), T(grid), padding_mode=padding_mode,
                       align_corners=align_corners).numpy()
    ref = np.asarray(jax_grid_sample(jnp.asarray(image), jnp.asarray(grid),
                                     padding_mode=padding_mode,
                                     align_corners=align_corners))
    # fp32 bilinear weights from the same coordinates: 1e-5
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_shape,out_hw,align_corners", [
    ((1, 512, 384, 3), (224, 224), False),   # cloth -> CLIP input
    ((1, 256, 192, 2), (512, 384), False),   # TPS grid -> full size
    ((1, 512, 384, 21), (256, 192), False),  # mask + pose -> TPS size
    ((2, 9, 7, 16), (18, 14), True),         # refinement's 2x upsample
])
def test_conditioning_resizes_match_jax(in_shape, out_hw, align_corners):
    x = np.random.default_rng(41).uniform(-1, 1, in_shape).astype(np.float32)
    ours = _nhwc(resize_bilinear(_nchw(x), out_hw,
                                 align_corners=align_corners))
    ref = np.asarray(jax_bilinear(jnp.asarray(x), out_hw,
                                  align_corners=align_corners))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- CLIP


def text_pair(act: str = "gelu", seed: int = 50):
    jcfg = jclip.CLIPTextConfig(hidden_act=act, **TEXT)
    jmodel = jclip.CLIPTextModel(jcfg)
    variables, flat = random_variables(jmodel, jnp.zeros((1, 16), jnp.int32),
                                       seed=seed)
    model = clip.CLIPTextModel(clip.CLIPTextConfig(**dataclasses.asdict(jcfg)))
    return jmodel, variables, load(model, flat, ckpt.clip_text_key_map)


def vision_pair(seed: int = 51):
    jcfg = jclip.CLIPVisionConfig(**VISION)
    jmodel = jclip.CLIPVisionModel(jcfg)
    variables, flat = random_variables(jmodel, jnp.zeros((1, 224, 224, 3)),
                                       seed=seed)
    model = clip.CLIPVisionModel(
        clip.CLIPVisionConfig(**dataclasses.asdict(jcfg)))
    return jmodel, variables, load(model, flat, ckpt.clip_vision_key_map)


def adapter_pair(seed: int = 52):
    jcfg = jclip.CLIPVisionConfig(**VISION)
    kw = dict(input_dim=16, hidden_dim=32, output_dim=32 * NUM_VSTAR,
              num_encoder_layers=1)
    jmodel = JaxAdapter(vision_config=jcfg, **kw)
    variables, flat = random_variables(jmodel, jnp.zeros((1, 257, 16)),
                                       seed=seed)
    model = InversionAdapter(
        vision_config=clip.CLIPVisionConfig(**dataclasses.asdict(jcfg)), **kw)
    return jmodel, variables, load(model, flat,
                                   ckpt.inversion_adapter_key_map)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_matches_jax(act):
    jmodel, variables, model = text_pair(act)
    ids = _ids(np.random.default_rng(53), 3, [True, False, True])
    ref_h, ref_pooled = jmodel.apply(variables, jnp.asarray(ids))
    with torch.no_grad():
        h, pooled = model(T(ids))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled),
                               rtol=RTOL, atol=ATOL)


def test_splice_matches_jax_and_leaves_rows_without_vstar():
    rng = np.random.default_rng(54)
    ids = _ids(rng, 3, [True, False, True])
    ids[2, 13:16] = 259  # a second run at the end: only the first counts
    embeds = rng.standard_normal((3, 16, 8)).astype(np.float32)
    words = rng.standard_normal((3, NUM_VSTAR * 8)).astype(np.float32)
    ours = splice_word_embeddings(T(embeds), T(ids), T(words),
                                  NUM_VSTAR).numpy()
    ref = np.asarray(jax_splice(jnp.asarray(embeds), jnp.asarray(ids),
                                jnp.asarray(words), NUM_VSTAR))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[1], embeds[1])  # no '$'
    np.testing.assert_array_equal(ours[0, 6:8], words[0].reshape(2, 8))
    np.testing.assert_array_equal(ours[2, 13:16], embeds[2, 13:16])


def test_pte_text_encoding_matches_jax():
    jmodel, variables, model = text_pair()
    rng = np.random.default_rng(55)
    ids = _ids(rng, 2, [True, False])
    words = rng.standard_normal((2, NUM_VSTAR * 32)).astype(np.float32)
    ref_h, ref_pooled = jax_encode(jmodel, variables, jnp.asarray(ids),
                                   jnp.asarray(words), NUM_VSTAR)
    with torch.no_grad():
        h, pooled = encode_text_word_embedding(model, T(ids), T(words),
                                               NUM_VSTAR)
        plain, _ = model(T(ids))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled),
                               rtol=RTOL, atol=ATOL)
    # the row without '$' encodes as the plain prompt, bit for bit
    np.testing.assert_array_equal(h[1].numpy(), plain[1].numpy())


def test_clip_vision_matches_jax():
    jmodel, variables, model = vision_pair()
    x = np.random.default_rng(56).standard_normal((2, 224, 224, 3)).astype(
        np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(_nchw(x)).numpy()
    assert ours.shape == (2, 257, 16)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_inversion_adapter_matches_jax():
    jmodel, variables, model = adapter_pair()
    x = np.random.default_rng(57).standard_normal((2, 257, 16)).astype(
        np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(T(x)).numpy()
    assert ours.shape == (2, 32 * NUM_VSTAR)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_layer_norm_against_flax_layer_norm():
    """flax's ``nn.LayerNorm`` (0.12: ``use_fast_variance=True``) takes
    E[x^2] - mean^2; the port, K5 and ``layer_norm_xla`` the centred
    variance.  At |mean| / std = 1/3, as here, the two differ by a few
    fp32 ulps of the output: 1e-5."""
    rng = np.random.default_rng(58)
    x = (rng.standard_normal((2, 77, 32)) * 3 + 1).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-5)
    variables = {"params": {
        "scale": (1 + 0.1 * rng.standard_normal(32)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(32)).astype(np.float32)}}
    ref = np.asarray(ln.apply(variables, jnp.asarray(x)))
    port_ln = clip.LayerNorm(32)
    port_ln.load_state_dict(ckpt.state_dict_from_jax(
        flatten_dict(variables)), strict=True)
    with torch.no_grad():
        ours = port_ln(T(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- TPS


def tps_pair(seed: int = 60):
    jmodel = jtps.ConvNetTPS(height=TH, width=TW, input_nc_b=21)
    variables, flat = random_variables(jmodel, jnp.zeros((1, TH, TW, 3)),
                                       jnp.zeros((1, TH, TW, 21)), seed=seed)
    model = tps.ConvNetTPS(height=TH, width=TW, input_nc_b=21)
    return jmodel, variables, load(model, flat, ckpt.tps_key_map)


def test_tps_matches_jax():
    jmodel, variables, model = tps_pair()
    rng = np.random.default_rng(61)
    cloth = rng.uniform(-1, 1, (2, TH, TW, 3)).astype(np.float32)
    agnostic = rng.uniform(-1, 1, (2, TH, TW, 21)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(cloth), jnp.asarray(agnostic))
    with torch.no_grad():
        ours = model(_nchw(cloth), _nchw(agnostic))
    assert ours[0].shape == (2, TH, TW, 2) and ours[1].shape == (2, 25, 2)
    # grid, control points and the six regularisers (rx, ry, cx, cy, rg,
    # cg): fp32 convs and a float64 TPS solve against HIGHEST-precision
    # fp32 products
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def test_tps_grid_gen_and_regularisers_match_jax():
    cp = jtps.make_control_points()
    np.testing.assert_array_equal(tps.make_control_points(), cp)
    np.testing.assert_array_equal(tps.tps_inverse_kernel(cp),
                                  jtps.tps_inverse_kernel(cp))
    rng = np.random.default_rng(62)
    pts = (cp[None] + rng.uniform(-0.1, 0.1, (2, 25, 2))).astype(np.float32)
    ref = np.asarray(jtps.TPSGridGen(33, 21, cp)(jnp.asarray(pts)))
    ours = tps.TPSGridGen(33, 21, cp)(T(pts)).numpy()
    # float64 products against fp32 HIGHEST: a few fp32 ulps of |grid| ~ 1
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    for o, r in zip(tps.grid_regularization_losses(T(pts)),
                    jtps.grid_regularization_losses(jnp.asarray(pts))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_feature_correlation_is_width_major_like_jax():
    rng = np.random.default_rng(63)
    a = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    b = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    ref = np.asarray(jtps.feature_correlation(jnp.asarray(a), jnp.asarray(b)))
    ours = _nhwc(tps.feature_correlation(_nchw(a), _nchw(b)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    # channel k = w * H + h of A at B's position (0, 0)
    np.testing.assert_allclose(ours[0, 0, 0, 2 * 4 + 1],
                               a[0, 1, 2] @ b[0, 0, 0], rtol=1e-5)


# ---------------------------------------------------------------- refinement


@pytest.mark.parametrize("hw", [(32, 32), (36, 28)])
def test_refinement_matches_jax(hw):
    jmodel = JaxUNetVanilla()
    variables, flat = random_variables(jmodel, jnp.zeros((1, *hw, 24)),
                                       seed=70)
    model = load(UNetVanilla(), flat, ckpt.refinement_key_map)
    x = np.random.default_rng(71).uniform(-1, 1, (2, *hw, 24)).astype(
        np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = _nhwc(model(_nchw(x)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- bridge


TOWERS = {
    "clip_text": (lambda: jclip.CLIPTextModel(jclip.CLIPTextConfig(**TEXT)),
                  (jnp.zeros((1, 16), jnp.int32),),
                  jax_ckpt.clip_text_torch_key_map, ckpt.clip_text_key_map),
    "clip_vision": (lambda: jclip.CLIPVisionModel(
        jclip.CLIPVisionConfig(**VISION)), (jnp.zeros((1, 224, 224, 3)),),
        jax_ckpt.clip_vision_torch_key_map, ckpt.clip_vision_key_map),
    "inversion_adapter": (lambda: JaxAdapter(
        input_dim=16, hidden_dim=32, output_dim=64,
        vision_config=jclip.CLIPVisionConfig(**VISION)),
        (jnp.zeros((1, 257, 16)),), jax_ckpt.inversion_adapter_torch_key_map,
        ckpt.inversion_adapter_key_map),
    "tps": (lambda: jtps.ConvNetTPS(height=TH, width=TW),
            (jnp.zeros((1, TH, TW, 3)), jnp.zeros((1, TH, TW, 21))),
            jax_ckpt.tps_torch_key_map, ckpt.tps_key_map),
    "refinement": (JaxUNetVanilla, (jnp.zeros((1, 32, 32, 24)),),
                   jax_ckpt.refinement_torch_key_map,
                   ckpt.refinement_key_map),
}


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_state_dict_from_jax_matches_export_torch_state(tower):
    factory, init_args, jax_map, port_map = TOWERS[tower]
    variables, flat = random_variables(factory(), *init_args, seed=80)
    ours = ckpt.state_dict_from_jax(flat, port_map)
    ref = jax_ckpt.export_torch_state(variables, None, key_map=jax_map)
    # the port adds torch's BatchNorm counter, which the export omits
    extra = {k for k in ours if k.endswith(".num_batches_tracked")}
    assert sorted(set(ours) - extra) == sorted(ref)
    assert {k[:-len("num_batches_tracked")] + "running_var"
            for k in extra} <= set(ref)
    assert bool(extra) == (tower in ("tps", "refinement"))
    for key, value in ref.items():
        assert ours[key].shape == value.shape, key
        np.testing.assert_array_equal(ours[key].numpy(), value.numpy())


@pytest.mark.parametrize("kind", ["nonlinear", "linear"])
def test_state_dict_from_jax_matches_export_for_both_emasc_kinds(kind):
    """The export writes ``conv.<i>.0.*`` for both kinds; the port's map
    gives the linear kind the reference's ``conv.<i>.*``, which the JAX
    package's own reader (``convert_emasc``) takes back to the same flax
    variables."""
    jemasc = JaxEMASC(in_channels=(8, 16), out_channels=(16, 8), kind=kind)
    variables, flat = random_variables(
        jemasc, [jnp.zeros((1, 4, 4, 8)), jnp.zeros((1, 4, 4, 16))],
        seed=81)
    port_map = ckpt.emasc_key_map(kind)
    ours = ckpt.state_dict_from_jax(flat, port_map)
    ref = jax_ckpt.export_torch_state(variables, None,
                                      key_map=jax_ckpt.emasc_torch_key_map)
    assert sorted(ours) == sorted(port_map(k) for k in ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[port_map(key)].numpy(),
                                      value.numpy())
    EMASC((8, 16), (16, 8), kind=kind).load_state_dict(ours, strict=True)
    back = flatten_dict(convert_emasc({k: v.numpy() for k, v in ours.items()},
                                      kind=kind))
    assert sorted(back) == sorted(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(back[path], value)


# ---------------------------------------------------------------- stage


class FakeTokenizer:
    """Ids of the prompts as ``test_pipeline.py``'s conditioning test
    makes them: '$' (259) at positions 4 and 5 when the prompt has one,
    plus CLIP-style start/end ids so the pooled position is defined."""

    def __call__(self, texts):
        ids = np.zeros((len(texts), 16), np.int32)
        for i, t in enumerate(texts):
            ids[i, 0], ids[i, 7] = 298, 299
            ids[i, 1:4] = [17 + len(t) % 50, 42, 7]
            if "$" in t:
                ids[i, 4:4 + NUM_VSTAR] = 259
        return ids


@pytest.fixture(scope="module")
def stage():
    """The JAX conditioning program and the port's conditioner over the
    same random weights."""
    jt, tps_vars, tps_mod = tps_pair(seed=90)
    jr = JaxUNetVanilla()
    ref_vars, ref_flat = random_variables(jr, jnp.zeros((1, H, W, 24)),
                                          seed=91)
    jv, vision_vars, vision_mod = vision_pair(seed=92)
    ja, adapter_vars, adapter_mod = adapter_pair(seed=93)
    jtext, text_vars, text_mod = text_pair(seed=94)
    empty_ids = FakeTokenizer()([""])[0]
    condition = build_condition_fn(
        tps=jt, refinement=jr, vision=jv, adapter=ja, text_model=jtext,
        num_vstar=NUM_VSTAR, dtype=jnp.float32,
        empty_ids=jnp.asarray(empty_ids), image_size=(H, W),
        tps_size=(TH, TW))
    cond_params = {"tps": tps_vars, "ref": ref_vars, "vision": vision_vars,
                   "adapter": adapter_vars, "text": text_vars}
    conditioner = Conditioner(
        tps=tps_mod,
        refinement=load(UNetVanilla(), ref_flat, ckpt.refinement_key_map),
        vision=vision_mod, adapter=adapter_mod, text_model=text_mod,
        num_vstar=NUM_VSTAR, empty_ids=T(empty_ids.astype(np.int64)),
        image_size=(H, W), tps_size=(TH, TW))
    return condition, cond_params, conditioner


def _request(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        cloth=rng.uniform(-1, 1, (n, H, W, 3)).astype(np.float32),
        pose_map=rng.uniform(0, 1, (n, H, W, 18)).astype(np.float32),
        im_mask=rng.uniform(-1, 1, (n, H, W, 3)).astype(np.float32))


def test_conditioner_matches_build_condition_fn(stage):
    condition, cond_params, conditioner = stage
    req = _request(100, 2)
    ids = FakeTokenizer()(["a $ prompt", "no vstar"])
    ref = condition(cond_params, jnp.asarray(req["pose_map"]),
                    jnp.asarray(req["cloth"]), jnp.asarray(req["im_mask"]),
                    jnp.asarray(ids))
    ours = conditioner(T(req["pose_map"]), T(req["cloth"]),
                       T(req["im_mask"]), T(ids.astype(np.int64)))
    assert ours[0].shape == (2, H, W, 3)
    assert ours[1].shape == ours[2].shape == (2, 16, 32)
    # warped cloth: the TPS grid (1e-4) moves a bilinear sample of a
    # uniform-noise image by up to |grad| * 1e-4 before the refinement;
    # embeddings: fp32 towers, 1e-4
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    assert float((ours[1] - ours[2]).abs().max()) > 1e-3  # the splice


def test_condition_service_pads_and_strips_like_the_conditioner(stage):
    _, _, conditioner = stage
    svc = ConditionService(conditioner, FakeTokenizer(), batch_size=2,
                           num_vstar=NUM_VSTAR, device="cpu")
    req = _request(101, 1)
    warped, ehs, neg = svc.run(categories=["upper_body"], **req)
    assert warped.shape == (1, H, W, 3) and ehs.shape == (1, 16, 32)
    prompt = svc.prompts(["upper_body"])[0]
    assert prompt == ("a photo of a model wearing an upper body garment "
                      + " $ " * NUM_VSTAR)
    ids = T(FakeTokenizer()([prompt]).astype(np.int64))
    direct = conditioner(T(req["pose_map"]), T(req["cloth"]),
                         T(req["im_mask"]), ids)
    # the padded batch row is computed as in a batch of one, up to fp32
    # sums taken over another batch size
    for o, r in zip((warped, ehs, neg), direct):
        np.testing.assert_allclose(o, r.numpy(), rtol=1e-5, atol=1e-5)
