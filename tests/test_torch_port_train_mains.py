"""The port's ``train_vto``, ``train_emasc`` and ``train_inversion_adapter``
mains, on ``--device cpu`` (``train_emasc``'s run in
``test_torch_port_train_emasc_main.py``).

A tiny reference-layout tree (``test_torch_port_cli.write_tiny_tree``,
plus the stock 9-channel ``sd2/unet``) and synthetic train splits
(``data/synthetic.py``: VITON-HD, and DressCode over its three
categories), read at 128x64 with batch 1 and no worker processes, fp32.
For each main:

* three steps checkpointing every step: ``checkpoint-2`` and
  ``checkpoint-3`` are left (keep 2), one ``metrics.jsonl`` line a step,
  the ``.pth`` export of every boundary;
* its first two losses equal, bit for bit, those of the step loop built
  directly from the port's modules (``train.steps``), the same loader
  and ``batch_generator(seed, step)``;
* two steps, then ``--resume_from_checkpoint latest`` to three: the
  losses and the last export bitwise equal to the uninterrupted run's;
* the export loads strictly through the port's zoo, and through the JAX
  zoo into a variables tree of exactly its module's shapes.

Also the refusals (``--tensor_parallel 2`` in one process, whose mesh of
one rank has no model axis of 2; ``--shard_optimizer_states`` with
``--tensor_parallel``, which the JAX main refuses too; ``--device cuda``
without a card, ``--mixed_precision no`` on the card).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import test_torch_port_cli as port_cli
from ladi_vton_tpu.hub import zoo as jax_zoo
from ladi_vton_tpu_torch.cli import train_emasc, train_inversion_adapter
from ladi_vton_tpu_torch.cli import train_vto
from ladi_vton_tpu_torch.core.rng import batch_generator, set_seed
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
    synthetic,
)
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models.emasc import EMASC, emasc_channels
from ladi_vton_tpu_torch.models.unet_condition import UNet2DCondition, UNetConfig
from ladi_vton_tpu_torch.models.vgg import VGG19Features, load_vgg19
from ladi_vton_tpu_torch.pipelines.serving import category_prompts
from ladi_vton_tpu_torch.train import steps, tps_steps
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer

torch.set_num_threads(2)
H, W = 128, 64
SEED = 3
LR = 1e-3


def write_train_tree(root: Path) -> Path:
    """The tiny weight tree, the stock UNet, a torchvision-layout VGG19,
    and the two datasets with train splits."""
    port_cli.write_tiny_tree(root)
    unet9 = UNet2DCondition(UNetConfig(in_channels=9, **port_cli.UNET))
    (root / "sd2" / "unet").mkdir()
    torch.save(port_cli._state(unet9),
               root / "sd2" / "unet" / "diffusion_pytorch_model.bin")
    port_cli._write_json(root / "sd2" / "unet" / "config.json",
                         {"in_channels": 9, **port_cli.UNET})
    torch.save(VGG19Features().state_dict(), root / "vgg19.pth")
    kw = dict(size=(256, 192), clip_shape=port_cli.CLIP_SHAPE)
    synthetic.write_vitonhd(root / "vh" / "vitonhd", n_pairs=1, seed=4,
                            train_pairs=2, **kw)
    synthetic.write_dresscode(root / "dc" / "dresscode", n_pairs=1, seed=3,
                              train_pairs=1, categories=(
                                  "dresses", "upper_body", "lower_body"),
                              **kw)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_train_tree(tmp_path_factory.mktemp("train_tree"))


def common(tree, out, dataset="vitonhd", steps_=3) -> list:
    root = tree / ("vh/vitonhd" if dataset == "vitonhd" else "dc/dresscode")
    return ["--dataset", dataset, f"--{dataset}_dataroot", str(root),
            "--output_dir", str(out), "--sd2_model_dir", str(tree / "sd2"),
            "--device", "cpu", "--mixed_precision", "no", "--seed",
            str(SEED), "--train_batch_size", "1", "--test_batch_size", "1",
            "--num_workers", "0", "--num_workers_test", "0", "--height",
            str(H), "--width", str(W), "--max_train_steps", str(steps_),
            "--checkpointing_steps", "1", "--learning_rate", str(LR),
            "--lr_warmup_steps", "0", "--report_to", "none",
            "--test_order", "paired"]


def vto_args(tree, out, steps_=3):
    return common(tree, out, steps_=steps_) + [
        "--inversion_adapter_dir", str(tree / "ladi"),
        "--use_clip_cloth_features"]


def emasc_args(tree, out, steps_=3):
    return common(tree, out, "dresscode", steps_) + [
        "--vgg_weights", str(tree / "vgg19.pth"), "--emasc_type",
        "nonlinear"]


def adapter_args(tree, out, steps_=3):
    return common(tree, out, steps_=steps_) + [
        "--use_clip_cloth_features", "--clip_vision_dir", str(tree / "clip_vision")]


def to_t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def loader_of(dataset) -> BatchLoader:
    return BatchLoader(dataset, 1, shuffle=True, drop_last=True,
                       num_workers=0, seed=SEED)


def direct_vto(tree) -> list:
    """The VTO step loop from the port's modules, as the main wires it."""
    set_seed(SEED)
    sd2 = str(tree / "sd2")
    on = dict(dtype=torch.float32, device="cpu")
    vae = zoo.sd2_vae(sd2, **on).requires_grad_(False)
    text = zoo.sd2_text_encoder(sd2, **on).requires_grad_(False)
    unet = zoo.sd2_unet(sd2, in_channels=31, **on)
    adapter = zoo.inversion_adapter(
        "vitonhd", checkpoint=str(tree / "ladi"
                                  / "inversion_adapter_vitonhd.pth"),
        **on).requires_grad_(False)
    tok = CLIPTokenizer.from_dir(tree / "sd2" / "tokenizer")
    ids = lambda p: to_t(np.asarray(tok(p)), torch.long)  # noqa: E731
    opt = steps.make_optimizer(list(unet.parameters()), LR, warmup_steps=0)
    step = steps.make_vto_train_step(
        optimizer=opt, config=steps.VTOStepConfig(num_vstar=16),
        unet=unet, vae=vae, text_model=text, inversion_adapter=adapter,
        empty_prompt_ids=ids([""])[0])
    keys = ("image", "pose_map", "inpaint_mask", "im_mask", "category",
            "im_name", "cloth", "warped_cloth", "clip_cloth_features")
    data = VitonHDDataset(str(tree / "vh/vitonhd"), phase="train",
                          order="paired", outputlist=keys, size=(H, W))
    losses = []
    for s, raw in zip(range(2), loader_of(data)):
        batch = {k: to_t(raw[k]) for k in keys[:4] + keys[-2:]}
        batch["input_ids"] = ids(category_prompts(raw["category"], 16))
        m = step(batch, steps.vto_draws(batch, batch_generator(SEED, s,
                                                               "cpu")))
        losses.append(float(m["loss"]))
    return losses


def direct_emasc(tree) -> list:
    set_seed(SEED)
    vae = zoo.sd2_vae(str(tree / "sd2"), device="cpu").requires_grad_(False)
    in_ch, out_ch = emasc_channels(vae.config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        emasc = EMASC(in_ch, out_ch).eval()
    opt = steps.make_optimizer(list(emasc.parameters()), LR, warmup_steps=0)
    step = steps.make_emasc_train_step(
        optimizer=opt, vae=vae, emasc=emasc,
        vgg=load_vgg19(tree / "vgg19.pth"), vgg_weight=0.5)
    keys = ("image", "im_mask", "inpaint_mask", "im_name", "category")
    data = DressCodeDataset(str(tree / "dc/dresscode"), phase="train",
                            order="paired", outputlist=keys, size=(H, W))
    losses = []
    for s, raw in zip(range(2), loader_of(data)):
        batch = {k: to_t(raw[k]) for k in keys[:3]}
        m = step(batch, steps.emasc_draws(batch, batch_generator(SEED, s,
                                                                 "cpu")))
        losses.append(float(m["loss"]))
    return losses


def direct_adapter(tree) -> list:
    set_seed(SEED)
    sd2 = str(tree / "sd2")
    vae = zoo.sd2_vae(sd2, device="cpu").requires_grad_(False)
    text = zoo.sd2_text_encoder(sd2, device="cpu").requires_grad_(False)
    unet9 = zoo.sd2_unet(sd2, in_channels=9, device="cpu").requires_grad_(
        False)
    args = train_inversion_adapter.parse_args(adapter_args(tree, tree))
    adapter = train_vto.new_adapter(
        args, zoo.clip_vision_config(str(tree / "clip_vision")),
        text.text_model.final_layer_norm.weight.shape[0]).eval()
    tok = CLIPTokenizer.from_dir(tree / "sd2" / "tokenizer")
    opt = steps.make_optimizer(list(adapter.parameters()), LR,
                               warmup_steps=0)
    step = tps_steps.make_inversion_adapter_train_step(
        optimizer=opt, unet9=unet9, vae=vae, text_model=text,
        inversion_adapter=adapter)
    keys = ("image", "im_mask", "inpaint_mask", "category", "im_name",
            "cloth", "clip_cloth_features")
    data = VitonHDDataset(str(tree / "vh/vitonhd"), phase="train",
                          order="paired", outputlist=keys, size=(H, W))
    losses = []
    for s, raw in zip(range(2), loader_of(data)):
        batch = {k: to_t(raw[k]) for k in keys[:3] + keys[-1:]}
        batch["input_ids"] = to_t(np.asarray(tok(category_prompts(
            raw["category"], 16))), torch.long)
        m = step(batch, tps_steps.adapter_draws(
            batch, batch_generator(SEED, s, "cpu")))
        losses.append(float(m["loss"]))
    return losses


def jax_shapes(module, *init_args) -> dict:
    return {k: v.shape for k, v in flatten_dict(jax.eval_shape(
        module.init, jax.random.key(0), *init_args)).items()}


def check_unet(tree, path):
    zoo.extended_unet(checkpoint=str(path), device="cpu")
    module, variables = jax_zoo.extended_unet(checkpoint=str(path),
                                              dtype=jnp.float32)
    return module, variables, (jnp.zeros((1, H // 8, W // 8, 31)),
                               jnp.asarray([0]), jnp.zeros((1, 77, 64)))


def check_emasc(tree, path):
    zoo.emasc(checkpoint=str(path), device="cpu")
    module, variables = jax_zoo.emasc(checkpoint=str(path),
                                      dtype=jnp.float32)
    return module, variables, ([jnp.zeros((1, 8, 8, c))
                                for c in module.in_channels],)


def check_adapter(tree, path):
    zoo.inversion_adapter(checkpoint=str(path), device="cpu")
    module, variables = jax_zoo.inversion_adapter(checkpoint=str(path),
                                                  dtype=jnp.float32)
    return module, variables, (jnp.zeros(
        (1,) + port_cli.CLIP_SHAPE),)


MAINS = {
    "vto": (train_vto.main, vto_args, direct_vto, "unet", check_unet),
    "emasc": (train_emasc.main, emasc_args, direct_emasc, "emasc",
              check_emasc),
    "inversion_adapter": (train_inversion_adapter.main, adapter_args,
                          direct_adapter, "inversion_adapter",
                          check_adapter),
}


def losses(out: Path) -> list:
    return [json.loads(line)["loss"]
            for line in (out / "metrics.jsonl").read_text().splitlines()]


# train_emasc's case runs in test_torch_port_train_emasc_main.py, so that
# the two files spread over the test workers
@pytest.mark.parametrize("name", ["inversion_adapter", "vto"])
def test_main_trains_checkpoints_resumes_and_exports(tree, tmp_path, name,
                                                     monkeypatch):
    check_main(tree, tmp_path, name, monkeypatch)


def check_main(tree, tmp_path, name, monkeypatch) -> None:
    """Train, GC, hold to the direct loop, resume bitwise, export."""
    main, args, direct, export, check = MAINS[name]
    full, part = tmp_path / "full", tmp_path / "part"
    assert main(args(tree, full)) == 3
    assert sorted(p.name for p in full.glob("checkpoint-*")) == [
        "checkpoint-2", "checkpoint-3"]
    assert all((full / f"{export}_{s}.pth").exists() for s in (1, 2, 3))
    ref = losses(full)
    assert len(ref) == 3 and all(np.isfinite(ref))
    assert direct(tree) == ref[:2]

    assert main(args(tree, part, steps_=2)) == 2
    assert main(args(tree, part) + ["--resume_from_checkpoint",
                                    "latest"]) == 3
    assert losses(part) == ref
    a = torch.load(full / f"{export}_3.pth", weights_only=True)
    b = torch.load(part / f"{export}_3.pth", weights_only=True)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)

    monkeypatch.setenv("LADI_VTON_NO_CONVERT_CACHE", "1")
    module, variables, init_args = check(tree, full / f"{export}_3.pth")
    got = {k: v.shape for k, v in flatten_dict(variables).items()}
    assert got == jax_shapes(module, *init_args)


@pytest.mark.parametrize("flags,match", [
    (["--tensor_parallel", "2"], "does not cover"),
    (["--shard_optimizer_states", "--tensor_parallel", "2"],
     "mutually exclusive"),
])
def test_vto_refuses_distribution(tree, tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        train_vto.main(vto_args(tree, tmp_path) + flags)
    assert not (tmp_path / "metrics.jsonl").exists()


@pytest.mark.parametrize("name", sorted(MAINS))
def test_card_refusals(tree, tmp_path, name, monkeypatch):
    main, args, *_ = MAINS[name]
    argv = args(tree, tmp_path)
    cuda = argv[:argv.index("--device")] + ["--device", "cuda"] + argv[
        argv.index("--device") + 2:]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(cuda)
    # with a card, fp32 is refused before any work: the kernels take bf16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="bf16 only"):
        main(cuda)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_manager_keeps_finished_checkpoints(tmp_path, monkeypatch,
                                                       async_save):
    """keep-2 GC over finished checkpoints only; a write that fails
    (in the background with ``async_save``) leaves the two finished ones
    and no partial directory, and its error surfaces; restore reads the
    latest or a given step."""
    from ladi_vton_tpu_torch.core import checkpoint as ckpt

    manager = ckpt.CheckpointManager(tmp_path, keep=2, async_save=async_save)
    for step in (1, 2, 3):
        manager.save(step, {"step": step, "w": torch.full((3,), step)})
    manager.wait()
    assert manager.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint-2", "checkpoint-3"]
    assert manager.restore(2)["step"] == 2

    def crash(obj, path):
        Path(path).write_bytes(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError, match="disk full"):
        manager.save(4, {"step": 4})
        manager.wait()
    monkeypatch.undo()
    names = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.startswith("checkpoint-"))
    assert names == ["checkpoint-2", "checkpoint-3"]
    assert torch.equal(manager.restore("latest")["w"], torch.full((3,), 3))
