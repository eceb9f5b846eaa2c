"""The port's model zoo and hub entry points against the JAX zoo, on the
CPU.

``tools/make_weights.make_weights(tiny=True)`` writes the reference's
file layout once for the module: the four ``.pth`` releases with their
``.config.json`` sidecars (the UNet stock 9-channel, so the conv_in
surgery runs), the SD-2 model directory (``vae/``, ``unet/``,
``text_encoder/``, ``tokenizer/``) and a CLIP vision directory, each
with its ``config.json``.  Each file is loaded through the JAX
``hub.zoo`` (in fp32) and through the port's zoo (``device="cpu"``);
the same inputs, made with numpy from a seed, must give the same outputs
within the tolerance the port's tower tests use (1e-4, fp32 sums in
another order).  Also here: the port's hub entry points through
``torch.hub.load(source="local")``, its ``.safetensors`` reader against
``safetensors.torch``, the CLIP loaders on files holding entries the
towers do not model, the ids of the port's tokenizer on the tree's
vocabulary, and fault 3.1: the reference's linear EMASC layout
(``conv.<i>.*``) loads into the port and computes what the JAX linear
EMASC computes, and a file whose keys match nothing raises.
"""

import dataclasses
import os
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
from flax.traverse_util import flatten_dict

import chip_smoke
from ladi_vton_tpu.hub import convert as jconvert
from ladi_vton_tpu.hub import zoo as jzoo
from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer
from ladi_vton_tpu_torch.core.checkpoint import emasc_key_map, state_dict_from_jax
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = jnp.float32
ATOL = RTOL = 1e-4
T = torch.from_numpy


def _nchw(x: np.ndarray) -> torch.Tensor:
    return T(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _close(ours, ref):
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    sys.path.insert(0, str(ROOT / "tools"))
    from make_weights import make_weights

    out = tmp_path_factory.mktemp("tiny_weights")
    before = os.environ.get("LADI_VTON_CACHE")
    # the JAX zoo's torch->flax conversion cache stays inside the tree
    os.environ["LADI_VTON_CACHE"] = str(out / "convert_cache")
    make_weights(out, tiny=True, dataset="vitonhd", verbose=False)
    yield out
    if before is None:
        os.environ.pop("LADI_VTON_CACHE")
    else:
        os.environ["LADI_VTON_CACHE"] = before


def test_extended_unet_and_sd2_unet_match_jax(tree):
    junet, jvars = jzoo.extended_unet(checkpoint_dir=tree / "ladi",
                                      dtype=F32)
    jcfg, jvars_sd2 = jzoo.sd2_unet(str(tree / "sd2"), in_channels=31)
    assert jcfg == junet.config
    unet = zoo.extended_unet(checkpoint_dir=tree / "ladi", device="cpu")
    unet_sd2 = zoo.sd2_unet(str(tree / "sd2"), in_channels=31,
                            device="cpu")
    # the file is the stock 9-channel UNet: channels 9..30 start at zero
    w = unet.conv_in.weight.detach()
    assert w.shape[1] == 31 and w.abs()[:, :9].sum() > 0
    assert (w[:, 9:] == 0).all()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 31)).astype(np.float32)
    t = np.asarray([981, 21])
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    apply = jax.jit(lambda v, a, b, c: JaxUNet(
        junet.config, dtype=F32, attn_impl="xla").apply(v, a, b, c))
    for variables, module in ((jvars, unet), (jvars_sd2, unet_sd2)):
        ref = apply(variables, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(ctx))
        with torch.no_grad():
            _close(_nhwc(module(_nchw(x), T(t), T(ctx))), ref)


def test_emasc_matches_jax(tree):
    jemasc, jvars = jzoo.emasc(checkpoint_dir=tree / "ladi", dtype=F32)
    emasc = zoo.emasc(checkpoint_dir=tree / "ladi", device="cpu")
    assert [c.in_channels for c in emasc.conv.modules()
            if isinstance(c, torch.nn.Conv2d)][::2] == [32, 32, 32, 32, 64]
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((1, s, s, c)).astype(np.float32)
             for s, c in zip((32, 32, 16, 8, 4), (32, 32, 32, 32, 64))]
    ref = jemasc.apply(jvars, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        ours = emasc([_nchw(f) for f in feats])
    for o, r in zip(ours, ref):
        _close(_nhwc(o), r)


def test_inversion_adapter_matches_jax(tree):
    jadapter, jvars = jzoo.inversion_adapter(checkpoint_dir=tree / "ladi",
                                             dtype=F32)
    adapter = zoo.inversion_adapter(checkpoint_dir=tree / "ladi",
                                    device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 50, 32)).astype(
        np.float32)
    ref = jadapter.apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        ours = adapter(T(x))
    assert ours.shape == (2, 64 * 16)
    _close(ours.numpy(), ref)


def test_warping_module_matches_jax(tree):
    (jtps, jtps_vars), (jref, jref_vars) = jzoo.warping_module(
        checkpoint_dir=tree / "ladi")
    tps, refinement = zoo.warping_module(checkpoint_dir=tree / "ladi",
                                         device="cpu")
    # the BatchNorm statistics travel with the weights
    assert "running_var" in str(list(tps.state_dict()))
    assert refinement.inc.double_conv[1].running_var.shape == (64,)
    rng = np.random.default_rng(3)
    cloth = rng.uniform(-1, 1, (1, 256, 192, 3)).astype(np.float32)
    agnostic = rng.uniform(-1, 1, (1, 256, 192, 21)).astype(np.float32)
    ref_grid = jtps.apply(jtps_vars, jnp.asarray(cloth),
                          jnp.asarray(agnostic))[0]
    x = rng.uniform(-1, 1, (1, 64, 48, 24)).astype(np.float32)
    ref_out = jref.apply(jref_vars, jnp.asarray(x))
    with torch.no_grad():
        _close(tps(_nchw(cloth), _nchw(agnostic))[0].numpy(), ref_grid)
        _close(_nhwc(refinement(_nchw(x))), ref_out)


def test_sd2_vae_matches_jax(tree):
    jvae, jvars = jzoo.sd2_vae(str(tree / "sd2"), dtype=F32)
    vae = zoo.sd2_vae(str(tree / "sd2"), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (1, 64, 48, 3)).astype(np.float32)
    z = rng.standard_normal((1, 8, 6, 4)).astype(np.float32)
    ref_m, _ = jvae.apply(jvars, jnp.asarray(x), method="encode")
    ref_x = jvae.apply(jvars, jnp.asarray(z), method="decode")
    with torch.no_grad():
        _close(_nhwc(vae.encode(_nchw(x))[0]), ref_m)
        _close(_nhwc(vae.decode(_nchw(z))), ref_x)


def test_sd2_text_encoder_matches_jax(tree):
    jtext, jvars = jzoo.sd2_text_encoder(str(tree / "sd2"), dtype=F32)
    text = zoo.sd2_text_encoder(str(tree / "sd2"), device="cpu")
    assert text.config.hidden_size == 64
    ids = CLIPTokenizer.from_dir(tree / "sd2" / "tokenizer")(
        ["a photo of a model wearing a dress " + " $ " * 16, ""])
    ref_h, ref_pooled = jtext.apply(jvars, jnp.asarray(ids))
    with torch.no_grad():
        h, pooled = text(T(ids.astype(np.int64)))
    _close(h.numpy(), ref_h)
    _close(pooled.numpy(), ref_pooled)


def test_clip_vision_matches_jax(tree):
    jvision, jvars = jzoo.clip_vit_h_vision(str(tree / "clip_vision"),
                                            dtype=F32)
    cfg = zoo.clip_vision_config(str(tree / "clip_vision"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jzoo.clip_vision_config(str(tree / "clip_vision")))
    assert (cfg.hidden_size, cfg.patch_size) == (32, 32)
    assert zoo.clip_vision_config(None).hidden_size == 1280
    vision = zoo.clip_vit_h_vision(str(tree / "clip_vision"), device="cpu")
    x = np.random.default_rng(5).standard_normal((1, 224, 224, 3)).astype(
        np.float32)
    ref = jvision.apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        _close(vision(_nchw(x)).numpy(), ref)


def test_towers_drop_the_entries_they_do_not_model(tree, tmp_path):
    """A transformers CLIP checkout holds the text tower, the projections,
    the vision ``post_layernorm`` and ``position_ids`` buffers beside the
    vision tower; the loaders keep what the towers model."""
    shutil.copytree(tree / "clip_vision", tmp_path / "clip_vision")
    shutil.copytree(tree / "sd2" / "text_encoder",
                    tmp_path / "sd2" / "text_encoder")
    vision_file = tmp_path / "clip_vision" / "pytorch_model.bin"
    text_file = tmp_path / "sd2" / "text_encoder" / "pytorch_model.bin"
    extra = {"text_model.final_layer_norm.weight": torch.ones(4),
             "visual_projection.weight": torch.ones(2, 32),
             "logit_scale": torch.tensor(1.0),
             "vision_model.post_layernorm.weight": torch.ones(32),
             "vision_model.post_layernorm.bias": torch.zeros(32),
             "vision_model.embeddings.position_ids": torch.arange(50)[None]}
    torch.save({**zoo.load_state(vision_file), **extra}, vision_file)
    torch.save({**zoo.load_state(text_file),
                "text_model.embeddings.position_ids": torch.arange(77)[None]},
               text_file)
    for ours, ref in (
            (zoo.clip_vit_h_vision(str(tmp_path / "clip_vision"),
                                   device="cpu"),
             zoo.clip_vit_h_vision(str(tree / "clip_vision"), device="cpu")),
            (zoo.sd2_text_encoder(str(tmp_path / "sd2"), device="cpu"),
             zoo.sd2_text_encoder(str(tree / "sd2"), device="cpu"))):
        a, b = ours.state_dict(), ref.state_dict()
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_tokenizer_matches_jax_on_the_tree_vocabulary(tree):
    jtok = JaxTokenizer.from_dir(tree / "sd2" / "tokenizer")
    tok = CLIPTokenizer.from_dir(tree / "sd2" / "tokenizer")
    prompts = [f"a photo of a model wearing {c} {' $ ' * 16}" for c in
               ("a dress", "an upper body garment", "a lower body garment")]
    prompts += ["", "Crème ² ½ Ⅻ x_y \x1c it'ſ &amp; 東京 ͅ"]
    ids = tok(prompts)
    np.testing.assert_array_equal(ids, jtok(prompts))
    assert (ids[0] == 259).sum() == 16 and ids.max() < 49408


HUB_ENTRIES = {
    "extended_unet": lambda t: zoo.extended_unet(checkpoint_dir=t,
                                                 device="cpu"),
    "emasc": lambda t: zoo.emasc(checkpoint_dir=t, device="cpu"),
    "inversion_adapter": lambda t: zoo.inversion_adapter(checkpoint_dir=t,
                                                         device="cpu"),
    "warping_module": lambda t: zoo.warping_module(checkpoint_dir=t,
                                                   device="cpu"),
}


def _states(modules) -> list:
    modules = modules if isinstance(modules, tuple) else (modules,)
    return [m.state_dict() for m in modules]


@pytest.mark.parametrize("name", sorted(HUB_ENTRIES))
def test_hub_entry_points_load_through_torch_hub(tree, name):
    loaded = torch.hub.load(str(ROOT / "ladi_vton_tpu_torch"), name,
                            source="local", checkpoint_dir=tree / "ladi",
                            device="cpu")
    for ours, ref in zip(_states(loaded),
                         _states(HUB_ENTRIES[name](tree / "ladi"))):
        assert list(ours) == list(ref)
        for key in ref:
            assert torch.equal(ours[key], ref[key]), key


def test_zoo_asked_for_cuda_without_a_card_raises(tree):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.emasc(checkpoint_dir=tree / "ladi")


def test_safetensors_reader_agrees_with_the_package(tmp_path):
    rng = np.random.default_rng(6)
    tensors = {
        "f32": T(rng.standard_normal((3, 5)).astype(np.float32)),
        "f64": T(rng.standard_normal(4)),
        "f16": T(rng.standard_normal((2, 3)).astype(np.float16)),
        "bf16": T(rng.standard_normal((7,)).astype(np.float32)).bfloat16(),
        "i64": T(rng.integers(-9, 9, (2, 2))),
        "i32": T(rng.integers(-9, 9, 3).astype(np.int32)),
        "i16": T(rng.integers(-9, 9, 3).astype(np.int16)),
        "i8": T(rng.integers(-9, 9, 3).astype(np.int8)),
        "u8": T(rng.integers(0, 255, 3).astype(np.uint8)),
        "bool": T(rng.integers(0, 2, 5).astype(bool)),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }
    path = tmp_path / "t.safetensors"
    safetensors.torch.save_file(tensors, str(path),
                                metadata={"format": "pt"})
    ours = zoo.load_safetensors(path)
    ref = safetensors.torch.load_file(str(path))
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        assert ours[key].shape == ref[key].shape, key
        assert torch.equal(ours[key], ref[key]), key
    # chip_smoke's few-line writer, read back by the package
    mine = tmp_path / "mine.safetensors"
    chip_smoke.save_safetensors(tensors, mine)
    back = safetensors.torch.load_file(str(mine))
    assert sorted(back) == sorted(tensors)
    for key in tensors:
        assert torch.equal(back[key], tensors[key]), key


def test_zoo_loads_a_safetensors_subfolder(tree, tmp_path):
    sd2 = tmp_path / "sd2"
    shutil.copytree(tree / "sd2" / "vae", sd2 / "vae")
    state = zoo.load_state(sd2 / "vae" / "diffusion_pytorch_model.bin")
    (sd2 / "vae" / "diffusion_pytorch_model.bin").unlink()
    safetensors.torch.save_file(
        state, str(sd2 / "vae" / "diffusion_pytorch_model.safetensors"))
    ours = zoo.sd2_vae(str(sd2), device="cpu").state_dict()
    ref = zoo.sd2_vae(str(tree / "sd2"), device="cpu").state_dict()
    for key in ref:
        assert torch.equal(ours[key], ref[key]), key


# ------------------------------------------------- fault 3.1: linear EMASC

EMASC_IN = (32, 32, 32, 32, 64)
EMASC_OUT = (32, 32, 64, 64, 64)


def _linear_emasc_release(tmp_path):
    """A linear EMASC in the reference's layout (``conv.<i>.weight`` /
    ``.bias``), random, with its channel sidecar; and its flax vars."""
    jemasc = JaxEMASC(in_channels=EMASC_IN, out_channels=EMASC_OUT,
                      kind="linear", dtype=F32)
    shapes = flatten_dict(jax.eval_shape(
        jemasc.init, jax.random.key(0),
        [jnp.zeros((1, 8, 8, c)) for c in EMASC_IN]))
    rng = np.random.default_rng(7)
    flat = {p: (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
            for p, s in shapes.items()}
    state = state_dict_from_jax(flat, emasc_key_map("linear"))
    assert sorted(state) == sorted(
        f"conv.{i}.{leaf}" for i in range(5) for leaf in ("weight", "bias"))
    torch.save(state, tmp_path / "emasc_vitonhd.pth")
    zoo_json = tmp_path / "emasc_vitonhd.config.json"
    zoo_json.write_text('{"in_channels": [32, 32, 32, 32, 64], '
                        '"out_channels": [32, 32, 64, 64, 64]}')
    return jemasc, state


def test_reference_linear_emasc_loads_and_matches_jax(tmp_path):
    jemasc, state = _linear_emasc_release(tmp_path)
    emasc = zoo.emasc(checkpoint_dir=tmp_path, kind="linear", device="cpu")
    assert sorted(emasc.state_dict()) == sorted(state)
    variables = jconvert.convert_emasc(
        {k: v.numpy() for k, v in state.items()}, kind="linear")
    rng = np.random.default_rng(8)
    feats = [rng.standard_normal((1, s, s, c)).astype(np.float32)
             for s, c in zip((16, 16, 8, 4, 4), EMASC_IN)]
    ref = jemasc.apply(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        ours = emasc([_nchw(f) for f in feats])
    for o, r in zip(ours, ref):
        _close(_nhwc(o), r)


def test_emasc_file_whose_keys_match_nothing_raises(tree, tmp_path):
    # the nonlinear layout of the tiny tree, asked for as linear
    with pytest.raises(RuntimeError, match="Missing key"):
        zoo.emasc(checkpoint_dir=tree / "ladi", kind="linear", device="cpu")
    # the JAX export's linear layout (conv.<i>.0.*) is not the reference's
    _, state = _linear_emasc_release(tmp_path)
    torch.save({k.replace(".weight", ".0.weight").replace(".bias", ".0.bias"):
                v for k, v in state.items()}, tmp_path / "emasc_vitonhd.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        zoo.emasc(checkpoint_dir=tmp_path, kind="linear", device="cpu")
