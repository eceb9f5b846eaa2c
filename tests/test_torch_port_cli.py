"""The port's ``inference`` and ``eval`` mains and drivers, on the CPU.

A tiny weight tree in the reference's layout is written once for the
module with the port's own modules (seeded; the SD-2 and CLIP towers at
the widths of ``tools/make_weights.py --tiny``, TPS and refinement at
their fixed size, config sidecars and ``config.json`` files for the
zoo), with the synthetic byte-level tokenizer of ``chip_smoke.py``; the
data are ``test_torch_port_data.py``'s DressCode and VITON-HD splits
(PIL JPEGs with sidecars).  ``cli.inference.main`` and ``cli.eval.main``
run on ``--device cpu``, 2 steps, batch 2 over 3 items (so the last
batch is padded), saving PNGs; every image must equal, bit for bit, what
the port's ``Conditioner`` and ``TryOnPipeline`` give when called
directly on the same dataset batch with a generator seeded with
``request_seed(seed, batch index)``.  The JAX pipeline's parity is held
by ``test_torch_port_pipeline.py`` and ``test_torch_port_condition.py``.

Also: the refusals (``--tensor_parallel 2`` in one process, whose mesh
of one rank has no model axis of 2, with or without
``--compute_metrics``, and ``--device cuda`` without a card), the
``pad_last`` de-duplication of the saver, the JPEG default output, and
``extract_save_vae_images`` against the JAX driver with the same
posterior noise fed to both (uint8 images within one level: fp32 on both
sides, summed in other orders).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import test_torch_port_data as port_data
from ladi_vton_tpu.data import BatchLoader as JaxBatchLoader
from ladi_vton_tpu.data import DressCodeDataset as JaxDressCode
from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.vae import AutoencoderKL as JaxVAE
from ladi_vton_tpu.models.vae import VAEConfig as JaxVAEConfig
from ladi_vton_tpu.pipelines import drivers as jax_drivers
from ladi_vton_tpu_torch.cli import eval as eval_cli
from ladi_vton_tpu_torch.cli import inference as inference_cli
from ladi_vton_tpu_torch.core.checkpoint import state_dict_from_jax
from ladi_vton_tpu_torch.core.rng import request_seed
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
    imageio,
)
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.diffusion.text import encode_text_word_embedding
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPVisionConfig,
    CLIPVisionModel,
)
from ladi_vton_tpu_torch.models.emasc import EMASC
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.models.tps import ConvNetTPS
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    UNetConfig,
)
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ladi_vton_tpu_torch.pipelines import drivers
from ladi_vton_tpu_torch.pipelines.condition import Conditioner, clip_pixels
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer

H, W = 128, 64  # divisible by 64: three UNet downsamples below the latent
SEED = 5
STEPS = 2
UNET = dict(block_out_channels=(32, 64, 64, 64), head_dim=8,
            cross_attention_dim=64)
VAE = dict(block_out_channels=(32, 32, 64, 64))
TEXT = CLIPTextConfig(hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128)
VISION = CLIPVisionConfig(hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=2, intermediate_size=64,
                          patch_size=32)
EMASC_CH = dict(in_channels=(32, 32, 32, 32, 64),
                out_channels=(32, 32, 64, 64, 64))
ADAPTER = dict(input_dim=32, hidden_dim=64, output_dim=64 * 16,
               num_encoder_layers=1)
# the feature cache holds the vision tower's last hidden state
CLIP_SHAPE = ((VISION.image_size // VISION.patch_size) ** 2 + 1, 32)


def _state(module: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _write_json(path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


def write_tiny_tree(root, datasets=("dresscode", "vitonhd")):
    """The reference's file layout with tiny seeded port modules."""
    torch.manual_seed(0)
    ladi, sd2, clip = root / "ladi", root / "sd2", root / "clip_vision"
    for d in (ladi, sd2 / "vae", sd2 / "text_encoder", clip):
        d.mkdir(parents=True, exist_ok=True)
    modules = {
        "unet": UNet2DCondition(UNetConfig(in_channels=31, **UNET)),
        "unet27": UNet2DCondition(UNetConfig(in_channels=27, **UNET)),
        "emasc": EMASC(**EMASC_CH),
        "inversion_adapter": InversionAdapter(**ADAPTER,
                                              vision_config=VISION),
        "tps": ConvNetTPS(256, 192, 21),
        "refinement": UNetVanilla(in_channels=24, out_channels=3),
    }
    torch.nn.init.normal_(modules["tps"].loc_net.regression.linear.weight,
                          std=1e-3)
    sidecars = {
        "unet": {"in_channels": 31, **UNET},
        "emasc": {k: list(v) for k, v in EMASC_CH.items()},
        "inversion_adapter": {**ADAPTER,
                              "vision_config": dataclasses.asdict(VISION)},
    }
    for ds in datasets:
        for name, side in sidecars.items():
            torch.save(_state(modules[name]), ladi / f"{name}_{ds}.pth")
            _write_json(ladi / f"{name}_{ds}.config.json", side)
        torch.save({"tps": _state(modules["tps"]),
                    "refinement": _state(modules["refinement"])},
                   ladi / f"warping_{ds}.pth")
    # a 27-channel UNet for --cloth_input_type none
    (ladi / "unet27").mkdir()
    torch.save(_state(modules["unet27"]), ladi / "unet27" / "unet_7.pth")
    _write_json(ladi / "unet27" / "unet_7.config.json",
                {"in_channels": 27, **UNET})
    vae_cfg = VAEConfig(**VAE)
    torch.save(_state(AutoencoderKL(vae_cfg)),
               sd2 / "vae" / "diffusion_pytorch_model.bin")
    _write_json(sd2 / "vae" / "config.json", dataclasses.asdict(vae_cfg))
    torch.save(_state(CLIPTextModel(TEXT)),
               sd2 / "text_encoder" / "pytorch_model.bin")
    _write_json(sd2 / "text_encoder" / "config.json",
                dataclasses.asdict(TEXT))
    torch.save(_state(CLIPVisionModel(VISION)), clip / "pytorch_model.bin")
    _write_json(clip / "config.json",
                {"vision_config": dataclasses.asdict(VISION)})
    chip_smoke.synthetic_tokenizer(sd2 / "tokenizer")
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tiny_tree(tmp_path_factory.mktemp("tiny_port_tree"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # three pairs: batch 2 pads the last batch with a repeat
    return port_data.make_trees(tmp_path_factory.mktemp("cli_data"),
                                n_pairs=3, clip_shape=CLIP_SHAPE)


def _common(data, dataset: str, out) -> list:
    root = ["--dresscode_dataroot", str(data["dresscode"]), "--category",
            "upper_body"] if dataset == "dresscode" else [
        "--vitonhd_dataroot", str(data["vitonhd"])]
    return ["--dataset", dataset, *root, "--test_order", "paired",
            "--output_dir", str(out), "--batch_size", "2",
            "--num_inference_steps", str(STEPS), "--num_workers", "0",
            "--height", str(H), "--width", str(W), "--seed", str(SEED),
            "--mixed_precision", "no", "--device", "cpu"]


def _dataset(data, dataset: str, outputlist):
    kw = dict(phase="test", order="paired", outputlist=outputlist,
              size=(H, W))
    if dataset == "dresscode":
        return DressCodeDataset(str(data["dresscode"]),
                                category=("upper_body",), **kw)
    return VitonHDDataset(str(data["vitonhd"]), **kw)


def _batches(dataset):
    return list(BatchLoader(dataset, 2, num_workers=0, pad_last=True))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _u8(images: torch.Tensor) -> np.ndarray:
    return torch.round(images.clamp(0, 1) * 255).to(torch.uint8).numpy()


def _check_saved(save_dir, batches, expected) -> int:
    """Every saved PNG equals the direct path's image; returns the count
    of distinct items."""
    seen = {}
    for batch, images in zip(batches, expected):
        for img, name, cat in zip(images, batch["im_name"],
                                  batch["category"]):
            seen.setdefault((cat, name), img)
    for (cat, name), img in seen.items():
        path = save_dir / cat / name.replace(".jpg", ".png")
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img,
                                      err_msg=str(path))
    files = sorted(p.name for p in save_dir.rglob("*.png"))
    assert len(files) == len(seen)
    return len(seen)


def _tokens(tokenizer, prompts) -> torch.Tensor:
    return _t(np.asarray(tokenizer(prompts)), torch.long)


@pytest.mark.parametrize("dataset", ["dresscode", "vitonhd"])
def test_inference_main_equals_the_direct_path(tree, data, dataset,
                                               tmp_path):
    out = tmp_path / "out"
    stats = inference_cli.main(_common(data, dataset, out) + [
        "--checkpoint_dir", str(tree / "ladi"),
        "--sd2_model_dir", str(tree / "sd2"),
        "--clip_vision_dir", str(tree / "clip_vision"), "--use_png"])
    assert stats["images"] == 3 and stats["batches"] == 2

    ladi, sd2 = tree / "ladi", str(tree / "sd2")
    tokenizer = CLIPTokenizer.from_dir(tree / "sd2" / "tokenizer")
    on = dict(dtype=torch.float32, device="cpu")
    tps, refinement = zoo.warping_module(dataset, checkpoint_dir=ladi,
                                         device="cpu")
    cond = Conditioner(
        tps=tps, refinement=refinement,
        vision=zoo.clip_vit_h_vision(str(tree / "clip_vision"), **on),
        adapter=zoo.inversion_adapter(dataset, checkpoint_dir=ladi, **on),
        text_model=zoo.sd2_text_encoder(sd2, **on), num_vstar=16,
        empty_ids=_t(np.asarray(tokenizer([""]))[0], torch.long),
        image_size=(H, W))
    pipe = TryOnPipeline(
        unet=zoo.extended_unet(dataset, checkpoint_dir=ladi, **on),
        vae=zoo.sd2_vae(sd2, **on),
        emasc=zoo.emasc(dataset, checkpoint_dir=ladi, **on),
        scheduler=make_scheduler("ddim"))
    batches = _batches(_dataset(data, dataset, (
        "image", "pose_map", "inpaint_mask", "im_mask", "category",
        "im_name", "cloth")))
    expected = []
    for step, b in enumerate(batches):
        ids = _tokens(tokenizer, category_prompts(b["category"], 16))
        warped, ehs, neg = cond(_t(b["pose_map"]), _t(b["cloth"]),
                                _t(b["im_mask"]), ids)
        expected.append(_u8(pipe.sample(
            image=_t(b["image"]), mask_image=_t(b["inpaint_mask"]),
            pose_map=_t(b["pose_map"]), warped_cloth=warped,
            prompt_embeds=ehs, negative_prompt_embeds=neg,
            generator=torch.Generator().manual_seed(request_seed(SEED, step)),
            num_inference_steps=STEPS)))
    assert _check_saved(out / "paired", batches, expected) == 3
    assert expected[0].std() > 0


EVAL_CASES = {
    # the eval path chip_smoke.py runs on the card: cached warped cloths
    # and cached CLIP features, DPM-Solver++
    "vitonhd_cached": ("vitonhd", "dpm", [
        "--use_clip_cloth_features", "--inversion_adapter_dir", "{ladi}",
        "--inversion_adapter_name", "inversion_adapter_vitonhd.pth",
        "--emasc_dir", "{ladi}", "--emasc_name", "emasc_vitonhd.pth",
        "--unet_dir", "{ladi}", "--unet_name", "unet_vitonhd.pth"]),
    # the adapter on the vision tower's features, EMASC absent, no cloth
    # channels (a 27-channel UNet resolved as 'latest')
    "dresscode_vision": ("dresscode", "ddim", [
        "--clip_vision_dir", "{clip}", "--inversion_adapter_dir", "{ladi}",
        "--inversion_adapter_name", "inversion_adapter_dresscode.pth",
        "--emasc_type", "none", "--cloth_input_type", "none",
        "--unet_dir", "{ladi}/unet27"]),
    # noun-chunk captions as the prompt
    "dresscode_captions": ("dresscode", "pndm", [
        "--text_usage", "noun_chunks", "--caption_file", "{captions}",
        "--emasc_dir", "{ladi}", "--emasc_name", "emasc_dresscode.pth",
        "--unet_dir", "{ladi}", "--unet_name", "unet_dresscode.pth"]),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_main_equals_the_direct_path(tree, data, case, tmp_path):
    dataset, scheduler, extra = EVAL_CASES[case]
    captions = tmp_path / "captions.json"
    captions.write_text('{"000000": ["red", "shirt"], "000001": ["blue"]}')
    fill = dict(ladi=tree / "ladi", clip=tree / "clip_vision",
                captions=captions)
    extra = [a.format(**fill) for a in extra]
    out = tmp_path / "out"
    stats = eval_cli.main(_common(data, dataset, out) + [
        "--save_name", "run", "--scheduler", scheduler,
        "--sd2_model_dir", str(tree / "sd2"), "--use_png"] + extra)
    assert stats["images"] == 3

    args = eval_cli.parse_args(_common(data, dataset, out) + [
        "--save_name", "run", "--sd2_model_dir", str(tree / "sd2")] + extra)
    tokenizer = CLIPTokenizer.from_dir(tree / "sd2" / "tokenizer")
    on = dict(dtype=torch.float32, device="cpu")
    text = zoo.sd2_text_encoder(str(tree / "sd2"), **on)
    unet = zoo.extended_unet(checkpoint=eval_cli._latest_pth(
        args.unet_dir, "unet", args.unet_name), **on)
    emasc = (zoo.emasc(checkpoint=eval_cli._latest_pth(
        args.emasc_dir, "emasc", args.emasc_name), **on)
        if args.emasc_type != "none" else None)
    pipe = TryOnPipeline(unet=unet, vae=zoo.sd2_vae(str(tree / "sd2"), **on),
                         emasc=emasc, scheduler=make_scheduler(scheduler))
    adapter = vision = None
    if args.text_usage == "inversion_adapter":
        adapter = zoo.inversion_adapter(checkpoint=eval_cli._latest_pth(
            args.inversion_adapter_dir, "inversion_adapter",
            args.inversion_adapter_name), **on)
        if not args.use_clip_cloth_features:
            vision = zoo.clip_vit_h_vision(str(tree / "clip_vision"), **on)
    keys = ["image", "pose_map", "inpaint_mask", "im_mask", "category",
            "im_name", "cloth"]
    keys += ["warped_cloth"] if args.cloth_input_type == "warped" else []
    keys += ["captions"] if args.text_usage == "noun_chunks" else []
    keys += (["clip_cloth_features"] if args.use_clip_cloth_features
             else [])
    ds = _dataset(data, dataset, tuple(keys))
    ds.captions_dict = json.loads(captions.read_text())
    batches = _batches(ds)
    empty = _t(np.asarray(tokenizer([""]))[0], torch.long)
    expected = []
    for step, b in enumerate(batches):
        if adapter is not None:
            feats = (_t(b["clip_cloth_features"]) if vision is None else
                     vision(clip_pixels(_t(b["cloth"]),
                                                   torch.float32)))
            ids = _tokens(tokenizer, category_prompts(b["category"], 16))
            with torch.no_grad():
                ehs, _ = encode_text_word_embedding(
                    text, ids, adapter(feats), 16)
        else:
            ids = _tokens(tokenizer, b["captions"])
            with torch.no_grad():
                ehs, _ = text(ids)
        with torch.no_grad():
            neg, _ = text(empty.expand_as(ids))
        expected.append(_u8(pipe.sample(
            image=_t(b["image"]), mask_image=_t(b["inpaint_mask"]),
            pose_map=_t(b["pose_map"]),
            warped_cloth=(_t(b["warped_cloth"]) if "warped_cloth" in b
                          else None),
            prompt_embeds=ehs, negative_prompt_embeds=neg,
            generator=torch.Generator().manual_seed(request_seed(SEED, step)),
            num_inference_steps=STEPS)))
    assert _check_saved(out / "run" / "paired", batches, expected) == 3


@pytest.mark.parametrize("flags,match", [
    (["--compute_metrics", "--tensor_parallel", "2"], "does not cover"),
    (["--tensor_parallel", "2"], "does not cover")])
def test_refusals_before_any_work(data, flags, match, tmp_path):
    base = _common(data, "vitonhd", tmp_path / "out")
    for main, extra in ((inference_cli.main, []),
                        (eval_cli.main, ["--save_name", "x",
                                         "--unet_dir", str(tmp_path)])):
        with pytest.raises(ValueError, match=match):
            main(base + extra + flags)
    assert not (tmp_path / "out").exists()


def test_cuda_without_a_card_raises(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _common(data, "vitonhd", tmp_path / "out")
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference_cli.main(argv)


def test_saver_skips_pad_last_repeats_and_writes_jpeg(tmp_path):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (3, 32, 16, 3),
                                           dtype=np.uint8))
    saver = drivers._PipelinedSaver(str(tmp_path))
    saver.push(images[:2], ["a.jpg", "b.jpg"], ["upper_body"] * 2)
    # the padded batch repeats a.jpg: its second image (here another one)
    # must not overwrite the first
    saver.push(images[[2, 1]], ["c.jpg", "a.jpg"], ["upper_body"] * 2)
    saver.close()
    names = sorted(p.name for p in (tmp_path / "upper_body").iterdir())
    assert names == ["a.jpg", "b.jpg", "c.jpg"]
    for name, i in (("a.jpg", 0), ("b.jpg", 1), ("c.jpg", 2)):
        written = (tmp_path / "upper_body" / name).read_bytes()
        assert written == imageio.encode_jpeg(images[i].numpy(), 95)
        markers = imageio.jpeg_markers(written)
        assert markers[0] == 0xD8 and markers[-1] == 0xD9
        assert Image.open(tmp_path / "upper_body" / name).size == (16, 32)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, 254.5]) / 255.0
    np.testing.assert_array_equal(drivers._quantize_u8(x).numpy(),
                                  np.round(x.numpy() * 255.0))


def _jax_vae_pair(seed: int):
    from test_torch_port_pipeline import random_params

    jvae = JaxVAE(JaxVAEConfig(**VAE))
    jemasc = JaxEMASC(**EMASC_CH)
    pv, fv = random_params(jvae, jnp.zeros((1, 64, 64, 3)), seed=seed)
    pe, fe = random_params(jemasc, [jnp.zeros((1, 8, 8, c))
                                    for c in EMASC_CH["in_channels"]],
                           seed=seed + 1)
    vae = AutoencoderKL(VAEConfig(**VAE))
    vae.load_state_dict(state_dict_from_jax(fv), strict=True)
    emasc = EMASC(**EMASC_CH)
    emasc.load_state_dict(state_dict_from_jax(fe), strict=True)
    return (jvae, pv, jemasc, pe), (vae.eval(), emasc.eval())


def test_extract_save_vae_images_matches_the_jax_driver(data, tmp_path,
                                                        monkeypatch):
    (jvae, pv, jemasc, pe), (vae, emasc) = _jax_vae_pair(seed=60)
    keys = ("image", "im_mask", "inpaint_mask", "im_name", "category")
    size = (64, 64)
    root = str(data["dresscode"])
    kw = dict(phase="test", order="paired", outputlist=keys, size=size,
              category=("upper_body",))
    captured = {}

    def capture(images, names, categories, save_dir, seen, use_png=False):
        for img, name in zip(images, names):
            captured.setdefault(name, np.asarray(img))

    monkeypatch.setattr(jax_drivers, "_save_images", capture)
    jax_drivers.extract_save_vae_images(
        jvae, pv, jemasc, pe,
        JaxBatchLoader(JaxDressCode(root, **kw), 2, num_workers=1,
                       workers_mode="thread", pad_last=True),
        str(tmp_path / "jax"), seed=SEED)

    def jax_noise(step, shape):
        b, c, h, w = shape
        z = jax.random.normal(jax.random.fold_in(jax.random.key(SEED), step),
                              (b, h, w, c), jnp.float32)
        return torch.from_numpy(np.array(z)).permute(0, 3, 1, 2)

    stats = drivers.extract_save_vae_images(
        vae, emasc, BatchLoader(DressCodeDataset(root, **kw), 2,
                                num_workers=0, pad_last=True),
        str(tmp_path / "port"), noise=jax_noise, use_png=True)
    assert stats["images"] == len(captured) == 3
    for name, want in captured.items():
        got = np.asarray(Image.open(tmp_path / "port" / "upper_body"
                                    / name.replace(".jpg", ".png")))
        assert got.shape == want.shape == size + (3,)
        assert np.abs(got.astype(int) - want).max() <= 1, name
