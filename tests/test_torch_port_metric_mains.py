"""The port's cloth-feature main and ``--compute_metrics``, on the CPU.

* ``compute_cloth_clip_features`` against the JAX main on the tiny CLIP
  vision tower of ``test_torch_port_cli.write_tiny_tree`` in fp32: the
  towers to 1e-4, the stored features (rounded to float16 by both)
  within one float16 step.
* ``inference --compute_metrics --device cpu`` (seeded metric weights
  written from the port's own modules, as ``chip_smoke.py`` writes them)
  writes the JSON that ``val_metrics`` gives over the same folder.

The metric functions, towers and ``val_metrics``/``generate_fid_stats``
against the JAX package are ``test_torch_port_metrics.py``.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
import test_torch_port_cli as port_cli
import test_torch_port_data as port_data
from ladi_vton_tpu.cli import compute_cloth_clip_features as jax_clip_main
from ladi_vton_tpu.hub import zoo as jax_zoo
from ladi_vton_tpu.ops.resize import resize_bilinear
from ladi_vton_tpu_torch.cli import compute_cloth_clip_features as clip_main
from ladi_vton_tpu_torch.cli import inference as inference_cli
from ladi_vton_tpu_torch.cli import val_metrics as val_main
from ladi_vton_tpu_torch.data.features import ClothFeatureCache
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.pipelines.condition import clip_pixels

TOWER_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two BLAS and two torch threads for the module: the suite runs six
    workers on one CPU, where more threads only contend (the FID's
    2048-d ``sqrtm`` barely gains from them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2):
        yield
    torch.set_num_threads(n)


def max_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    return port_cli.write_tiny_tree(tmp_path_factory.mktemp("metric_tree"),
                                    datasets=("vitonhd",))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return port_data.make_trees(tmp_path_factory.mktemp("metric_data"),
                                n_pairs=3, clip_shape=port_cli.CLIP_SHAPE)


def test_cloth_clip_features_equal_jax(tiny_tree, data, tmp_path,
                                       monkeypatch):
    clip_dir = str(tiny_tree / "clip_vision")
    argv = ["--dataset", "vitonhd", "--vitonhd_dataroot",
            str(data["vitonhd"]), "--phase", "test", "--batch_size", "2",
            "--num_workers", "0", "--clip_vision_dir", clip_dir]
    # the JAX main's tower in fp32 (its zoo defaults to bf16 compute)
    monkeypatch.setattr(jax_zoo, "clip_vit_h_vision", functools.partial(
        jax_zoo.clip_vit_h_vision, dtype=jnp.float32))
    jax_clip_main.main(argv + ["--cache_root", str(tmp_path / "jax")])
    target = clip_main.main(argv + ["--cache_root", str(tmp_path / "port"),
                                    "--mixed_precision", "no",
                                    "--device", "cpu"])
    assert target == tmp_path / "port" / "clip_cloth_embeddings" / "vitonhd"
    ours = ClothFeatureCache(target, "test")
    ref = ClothFeatureCache(tmp_path / "jax" / "clip_cloth_embeddings"
                            / "vitonhd", "test")
    assert ours._names == ref._names and len(ours._names) == 3
    for name in ref._names:
        got, want = ours.get(name), ref.get(name)
        # both rounded to float16: equal, or one float16 step apart
        step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
        assert (np.abs(got - want) <= step).all(), name

    # the towers themselves, before the float16 store
    cloth = np.random.default_rng(2).uniform(
        -1, 1, (2, 512, 384, 3)).astype(np.float32)
    vision = zoo.clip_vit_h_vision(clip_dir, dtype=torch.float32,
                                   device="cpu")
    with torch.no_grad():
        got = vision(clip_pixels(torch.from_numpy(cloth), torch.float32))
    model, variables = jax_zoo.clip_vit_h_vision(clip_dir)
    x = jnp.clip(resize_bilinear((jnp.asarray(cloth) + 1.0) * 0.5,
                                 (224, 224)), 0, 1)
    x = (x - jnp.asarray([0.48145466, 0.4578275, 0.40821073])) / \
        jnp.asarray([0.26862954, 0.26130258, 0.27577711])
    want = np.asarray(model.apply(variables, x))
    assert max_rel(got.numpy(), want) <= TOWER_RTOL


def test_inference_compute_metrics_equals_val_metrics(tiny_tree, data,
                                                      tmp_path, monkeypatch):
    weights = chip_smoke.write_metric_weights(tmp_path / "weights")
    monkeypatch.setenv("LADI_VTON_METRIC_WEIGHTS", str(weights))
    out = tmp_path / "out"
    argv = port_cli._common(data, "vitonhd", out) + [
        "--checkpoint_dir", str(tiny_tree / "ladi"),
        "--sd2_model_dir", str(tiny_tree / "sd2"),
        "--clip_vision_dir", str(tiny_tree / "clip_vision"),
        "--compute_metrics"]
    stats = inference_cli.main(argv)
    assert stats["images"] == 3
    written = json.loads((out / "paired" / "metrics_paired_all.json")
                         .read_text())
    assert sorted(written) == sorted(
        ["ssim_score", "lpips_score", "fid_score", "kid_score", "is_score"])
    assert all(np.isfinite(v) for v in written.values())
    again = val_main.main(["--gen_folder", str(out / "paired"), "--dataset",
                           "vitonhd", "--vitonhd_dataroot",
                           str(data["vitonhd"]), "--test_order", "paired",
                           "--device", "cpu"])
    assert again == written
