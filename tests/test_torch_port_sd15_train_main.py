"""``cli.train_vto`` on SD-1.5 model directories, on ``--device cpu``, in
both forms the JAX trainer trains (``test_torch_port_sd15_train.FORMS``):
the eight-head form (``"head_dim": -1`` in ``unet/config.json``) and a
diffusers SD-1.5 ``unet/config.json`` (``attention_head_dim: 8``, which
both zoos drop: 64-wide heads), each with 1x1-conv projections
(``use_linear_projection: false``) and a quick_gelu text tower whose
width is the UNet's ``cross_attention_dim``.

Over ``test_torch_port_cli.write_tiny_tree``'s files with the SD-1.5
``sd2/unet`` and a synthetic VITON-HD train split, at 128x64, batch 1,
fp32, for each form:

* two steps, a checkpoint and a ``unet_{step}.pth`` export each, their
  losses those of the step loop built directly from the port's modules
  (``test_torch_port_train_mains.direct_vto``);
* a run from ``checkpoint-1`` alone resumed to step 2: its loss and its
  ``unet_2.pth`` bitwise the uninterrupted run's;
* the ``.config.json`` sidecar is what the JAX main writes for the same
  directory (``dataclasses.asdict`` of the JAX zoo's ``sd2_unet``
  config); the export loads through both zoos' ``extended_unet`` into the
  same ``UNetConfig`` and the same forward (1e-4), and ``cli.eval``
  samples with it.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_port_cli as port_cli
from ladi_vton_tpu.hub import zoo as jzoo
from ladi_vton_tpu.models.unet_condition import UNet2DCondition as JaxUNet
from ladi_vton_tpu_torch.cli import eval as eval_cli
from ladi_vton_tpu_torch.cli import train_vto
from ladi_vton_tpu_torch.data import synthetic
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition, UNetConfig
from test_torch_port_sd15_train import FORMS
from test_torch_port_train_mains import H, W, direct_vto, vto_args

torch.set_num_threads(2)


def write_sd15_tree(root, form: str):
    """The tiny tree with an SD-1.5 ``sd2/unet`` (9 channels, the stock
    inpainting UNet) in ``form`` and a quick_gelu text tower, and a
    VITON-HD split with two train pairs."""
    port_cli.write_tiny_tree(root, datasets=("vitonhd",))
    cfg = {k: v for k, v in FORMS[form].items() if k != "head_dim"}
    unet9 = UNet2DCondition(UNetConfig(in_channels=9, **FORMS[form]))
    unet_dir = root / "sd2" / "unet"
    unet_dir.mkdir()
    torch.save(port_cli._state(unet9),
               unet_dir / "diffusion_pytorch_model.bin")
    config = {"_class_name": "UNet2DConditionModel", "in_channels": 9,
              "out_channels": 4, "attention_head_dim": 8,
              "sample_size": 64, **cfg}
    if form == "eight-heads":
        config["head_dim"] = -1
    port_cli._write_json(unet_dir / "config.json", config)
    text_cfg = root / "sd2" / "text_encoder" / "config.json"
    port_cli._write_json(text_cfg, {**json.loads(text_cfg.read_text()),
                                    "hidden_act": "quick_gelu"})
    synthetic.write_vitonhd(root / "vh" / "vitonhd", n_pairs=1, seed=4,
                            train_pairs=2, size=(256, 192),
                            clip_shape=port_cli.CLIP_SHAPE)
    return root


@pytest.fixture(scope="module", params=sorted(FORMS))
def tree(request, tmp_path_factory):
    form = request.param
    return form, write_sd15_tree(tmp_path_factory.mktemp(f"sd15_{form}"),
                                 form)


def losses(out) -> list:
    return [json.loads(line)["loss"]
            for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_sd15_main_trains_resumes_and_exports(tree, tmp_path, monkeypatch):
    form, root = tree
    full, part = tmp_path / "full", tmp_path / "part"
    assert train_vto.main(vto_args(root, full, steps_=2)) == 2
    ref = losses(full)
    assert len(ref) == 2 and all(np.isfinite(ref))
    assert direct_vto(root) == ref

    part.mkdir()
    shutil.copytree(full / "checkpoint-1", part / "checkpoint-1")
    assert train_vto.main(vto_args(root, part, steps_=2)
                          + ["--resume_from_checkpoint", "latest"]) == 2
    assert losses(part) == ref[1:]
    a = torch.load(full / "unet_2.pth", weights_only=True)
    b = torch.load(part / "unet_2.pth", weights_only=True)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)

    # the sidecar says what the JAX main's says for this directory
    monkeypatch.setenv("LADI_VTON_NO_CONVERT_CACHE", "1")
    jcfg, _ = jzoo.sd2_unet(str(root / "sd2"), in_channels=31)
    side = json.loads((full / "unet_2.config.json").read_text())
    assert side == json.loads(json.dumps(dataclasses.asdict(jcfg)))
    assert (side["head_dim"], side["use_linear_projection"],
            side["cross_attention_dim"]) == (
        -1 if form == "eight-heads" else 64, False, 64)

    # both zoos build the same UNet from the export
    unet = zoo.extended_unet(checkpoint=str(full / "unet_2.pth"),
                             device="cpu")
    junet, jvars = jzoo.extended_unet(checkpoint=str(full / "unet_2.pth"),
                                      dtype=jnp.float32)
    assert (dataclasses.asdict(unet.config)
            == dataclasses.asdict(junet.config))
    assert isinstance(unet.down_blocks[0].attentions[0].proj_in,
                      torch.nn.Conv2d)
    rng = np.random.default_rng(90)
    x = rng.standard_normal((1, H // 8, W // 8, 31)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 64)).astype(np.float32)
    ref_out = jax.jit(JaxUNet(junet.config, attn_impl="xla").apply)(
        jvars, jnp.asarray(x), jnp.asarray([500]), jnp.asarray(ctx))
    with torch.no_grad():
        ours = unet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                    torch.tensor([500]), torch.from_numpy(ctx))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_out), rtol=1e-4, atol=1e-4)

    # cli.eval samples with the export
    stats = eval_cli.main([
        "--dataset", "vitonhd", "--vitonhd_dataroot",
        str(root / "vh" / "vitonhd"), "--test_order", "paired",
        "--output_dir", str(tmp_path / "eval"), "--save_name", "run",
        "--unet_dir", str(full), "--unet_name", "unet_2.pth",
        "--inversion_adapter_dir", str(root / "ladi"),
        "--inversion_adapter_name", "inversion_adapter_vitonhd.pth",
        "--use_clip_cloth_features", "--emasc_type", "none",
        "--sd2_model_dir", str(root / "sd2"), "--batch_size", "1",
        "--num_inference_steps", "2", "--num_workers", "0", "--height",
        str(H), "--width", str(W), "--seed", "5", "--mixed_precision",
        "no", "--device", "cpu", "--use_png"])
    assert stats["images"] == 1
    (png,) = (tmp_path / "eval").rglob("*.png")
    assert np.asarray(Image.open(png)).std() > 0
