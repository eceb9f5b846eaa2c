"""The port's ``train_tps`` main, on ``--device cpu``.

Over ``test_torch_port_train_mains.py``'s VITON-HD train split (two
pairs, batch 1) at 64x48, with its torchvision-layout VGG19: two TPS
epochs and one refinement epoch leave ``checkpoint-2`` and
``checkpoint-3`` (keep 2) and one ``metrics.jsonl`` line an epoch; the
first epoch's mean train loss equals, bit for bit, that of the step loop
built from ``train.tps_steps`` on the same loader; a run of the two TPS
epochs resumed for the refinement epoch ends with the same losses and a
bitwise-equal ``warping_vitonhd.pth``, which loads through the port's zoo
and, shape for shape, through the JAX zoo; the extraction writes the
refined warped cloths of the train and test splits (paired) and of the
test split (unpaired) where the datasets read them.  ``--only_extraction``
without a checkpoint refuses.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ladi_vton_tpu.hub import zoo as jax_zoo
from ladi_vton_tpu_torch.cli import train_tps
from ladi_vton_tpu_torch.core.rng import set_seed
from ladi_vton_tpu_torch.data import BatchLoader, VitonHDDataset
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.models.tps import ConvNetTPS
from ladi_vton_tpu_torch.train import tps_steps
from test_torch_port_train_mains import jax_shapes, to_t, write_train_tree

torch.set_num_threads(2)
H, W = 64, 48
SEED = 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_train_tree(tmp_path_factory.mktemp("tps_tree"))


def argv(tree, out, cache, epochs_tps=2, epochs_refinement=1) -> list:
    return ["--dataset", "vitonhd", "--vitonhd_dataroot",
            str(tree / "vh/vitonhd"), "--checkpoints_dir", str(out),
            "--exp_name", "warp", "-b", "1", "-j", "0", "--height", str(H),
            "--width", str(W), "--epochs_tps", str(epochs_tps),
            "--epochs_refinement", str(epochs_refinement), "--seed",
            str(SEED), "--vgg_weights", str(tree / "vgg19.pth"),
            "--save_path", str(cache), "--device", "cpu"]


def lines(out) -> list:
    return [json.loads(line) for line in
            (out / "warp" / "metrics.jsonl").read_text().splitlines()]


def direct_first_epoch(tree) -> float:
    """Phase A's first epoch from the port's modules, as the main wires
    it: its mean loss."""
    set_seed(SEED)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        tps = ConvNetTPS(256, 192, input_nc_b=21)
        UNetVanilla(in_channels=24, out_channels=3)
    step = tps_steps.make_tps_train_step(
        tps=tps, optimizer=tps_steps.tps_optimizer(tps.parameters(), 1e-4))
    keys = ("c_name", "im_name", "cloth", "image", "im_cloth", "im_mask",
            "category", "pose_map")
    data = VitonHDDataset(str(tree / "vh/vitonhd"), phase="train",
                          order="paired", outputlist=keys, size=(256, 192))
    loader = BatchLoader(data, 1, shuffle=True, drop_last=True,
                         num_workers=0, seed=SEED)
    loader.start_at(0)
    out = []
    for raw in loader:
        batch = {k: to_t(raw[k]) for k in ("cloth", "im_cloth", "im_mask")}
        batch["pose"] = to_t(raw["pose_map"])
        out.append(float(step(batch)["loss"]))
    return float(np.mean(out))


def test_train_tps_trains_resumes_exports_and_extracts(tree, tmp_path,
                                                       monkeypatch):
    full, part = tmp_path / "full", tmp_path / "part"
    cache = tmp_path / "cache"
    assert train_tps.main(argv(tree, full, cache)) == {"epochs": 3,
                                                       "extracted": 4}
    assert sorted(p.name for p in (full / "warp").glob("checkpoint-*")) == [
        "checkpoint-2", "checkpoint-3"]
    ref = lines(full)
    assert [r["step"] for r in ref] == [0, 1, 2]
    assert ref[0]["train/loss"] == direct_first_epoch(tree)
    assert ref[2]["train/vgg_loss"] > 0

    train_tps.main(argv(tree, part, tmp_path / "cache2",
                        epochs_refinement=0))
    assert train_tps.main(argv(tree, part, tmp_path / "cache2"))[
        "epochs"] == 1
    assert lines(part) == ref
    a, b = (torch.load(d / "warp" / "warping_vitonhd.pth", weights_only=True)
            for d in (full, part))
    for tower in ("tps", "refinement"):
        assert all(torch.equal(a[tower][k], b[tower][k]) for k in a[tower])

    bundle = full / "warp" / "warping_vitonhd.pth"
    zoo.warping_module(checkpoint=str(bundle), device="cpu")
    monkeypatch.setenv("LADI_VTON_NO_CONVERT_CACHE", "1")
    (jt, tv), (jr, rv) = jax_zoo.warping_module(checkpoint=str(bundle))
    for module, variables, init_args in (
            (jt, tv, (jnp.zeros((1, 256, 192, 3)),
                      jnp.zeros((1, 256, 192, 21)))),
            (jr, rv, (jnp.zeros((1, 32, 32, 24)),))):
        got = {k: v.shape for k, v in flatten_dict(variables).items()}
        assert got == jax_shapes(module, *init_args)

    # the extraction's files, where the datasets read them
    for phase, order in (("train", "paired"), ("test", "paired"),
                         ("test", "unpaired")):
        data = VitonHDDataset(str(tree / "vh/vitonhd"), phase=phase,
                              order=order, size=(H, W), cache_root=str(cache),
                              outputlist=("warped_cloth", "im_name"))
        for i in range(len(data)):
            assert data[i]["warped_cloth"].shape == (H, W, 3)


def test_only_extraction_needs_a_checkpoint(tree, tmp_path):
    with pytest.raises(SystemExit, match="train the model first"):
        train_tps.main(argv(tree, tmp_path, tmp_path / "cache") +
                       ["--only_extraction"])
