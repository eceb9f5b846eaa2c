"""The port's metrics against the JAX package's, on the CPU.

* ``metrics/fid.py`` (the port's own copy): ``gaussian_stats``,
  ``frechet_distance`` (its ``eps`` branch too: a few features in many
  dimensions make the covariances singular), ``kid_mmd2``,
  ``inception_score`` equal the JAX functions to 1e-10 on seeded
  features, and a ``StatsCache`` written by either package reads in the
  other.
* SSIM against the JAX ``ssim`` to 1e-6; ``clean_resize_to_299`` bit for
  bit equal to the JAX one (PIL bicubic) over hypothesis sizes.
* InceptionV3 (pool3 and logits, a batch of 4 at 299x299) and LPIPS (both
  checkpoint layouts) against the JAX towers on the weights
  ``tools/make_metric_weights.py`` writes, to 1e-4 of the largest value.
  The JAX Inception runs once for the module.
* The mains on a tiny VITON-HD test split of PIL JPEGs (read by the
  port's decoder): ``generate_fid_stats`` writes the cache the JAX
  ``val_metrics`` builds (mean, covariance and features to 1e-4 of the
  largest value), each package reads either cache, and ``val_metrics``
  gives every metric of the JAX main to rtol 1e-4; ``fid_between_folders``
  gives the same FID.  The mains default to the card.

``compute_cloth_clip_features`` and ``--compute_metrics`` are
``test_torch_port_metric_mains.py``.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
from threadpoolctl import threadpool_limits

from ladi_vton_tpu.cli import val_metrics as jax_val_main
from ladi_vton_tpu.metrics import fid as jax_fid
from ladi_vton_tpu.metrics.compute import MetricModels as JaxModels
from ladi_vton_tpu.metrics.inception import (
    clean_resize_to_299 as jax_resize_299,
)
from ladi_vton_tpu.metrics.ssim import ssim as jax_ssim
from ladi_vton_tpu_torch.cli import generate_fid_stats as stats_main
from ladi_vton_tpu_torch.cli import val_metrics as val_main
from ladi_vton_tpu_torch.metrics import fid
from ladi_vton_tpu_torch.metrics.compute import (
    MetricModels,
    fid_between_folders,
)
from ladi_vton_tpu_torch.metrics.inception import clean_resize_to_299
from ladi_vton_tpu_torch.metrics.lpips import lpips_state
from ladi_vton_tpu_torch.metrics.ssim import ssim

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_metric_weights import make_metric_weights  # noqa: E402

import torch  # noqa: E402

FID_RTOL = 1e-10
SSIM_ATOL = 1e-6
TOWER_RTOL = 1e-4
METRIC_RTOL = 1e-4


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
def weights(tmp_path_factory):
    return make_metric_weights(tmp_path_factory.mktemp("metric_weights"))


@pytest.fixture(scope="module")
def inception_pair(weights):
    """A batch of 4 at 299x299 through the JAX and the port's Inception."""
    x = np.random.default_rng(0).uniform(-1, 1, (4, 299, 299, 3)).astype(
        np.float32)
    model, variables = JaxModels(str(weights)).inception()
    ref = [np.asarray(t) for t in model.apply(variables, jnp.asarray(x))]
    ours = MetricModels(str(weights), "cpu").inception_features(x)
    return ours, ref


# --------------------------------------------------------------- fid.py


@pytest.mark.parametrize("n,d", [(3, 64), (40, 16)])
def test_fid_functions_equal_jax(n, d, tmp_path):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, d)) * 0.3 + 0.1
    b = rng.standard_normal((n + 2, d)) * 0.5
    mu_a, s_a = fid.gaussian_stats(a)
    mu_b, s_b = fid.gaussian_stats(b)
    for ours, ref in zip((mu_a, s_a), jax_fid.gaussian_stats(a)):
        np.testing.assert_allclose(ours, ref, rtol=FID_RTOL)
    with np.errstate(all="ignore"):
        ours = fid.frechet_distance(mu_a, s_a, mu_b, s_b)
        ref = jax_fid.frechet_distance(mu_a, s_a, mu_b, s_b)
    np.testing.assert_allclose(ours, ref, rtol=FID_RTOL)
    np.testing.assert_allclose(fid.kid_mmd2(a, b), jax_fid.kid_mmd2(a, b),
                               rtol=FID_RTOL)
    logits = rng.standard_normal((n * 3, 10))
    np.testing.assert_allclose(fid.inception_score(logits),
                               jax_fid.inception_score(logits),
                               rtol=FID_RTOL)
    # a cache written by one package reads in the other
    fid.StatsCache(tmp_path / "port").save("x", mu_a, s_a, a)
    jax_fid.StatsCache(tmp_path / "jax").save("x", mu_a, s_a, a)
    for written, reader in (("port", jax_fid), ("jax", fid)):
        for got, want in zip(reader.StatsCache(tmp_path / written).load("x"),
                             (mu_a, s_a, a)):
            np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- ssim, resize


@pytest.mark.parametrize("shape", [(2, 32, 24, 3), (3, 64, 48, 3)])
def test_ssim_equals_jax(shape):
    rng = np.random.default_rng(shape[1])
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    ours = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(ours - ref) <= SSIM_ATOL, (ours, ref)


@settings(max_examples=12, deadline=None)
@given(h=st.integers(8, 96), w=st.integers(8, 96),
       seed=st.integers(0, 2 ** 16))
def test_clean_resize_to_299_is_bitwise(h, w, seed):
    u8 = np.random.default_rng(seed).integers(0, 256, (2, h, w, 3),
                                              dtype=np.uint8)
    np.testing.assert_array_equal(clean_resize_to_299(u8),
                                  jax_resize_299(u8))


# ---------------------------------------------------------------- towers


@pytest.mark.parametrize("output", ["pool3", "logits"])
def test_inception_equals_jax(inception_pair, output):
    i = ("pool3", "logits").index(output)
    ours, ref = inception_pair[0][i], inception_pair[1][i]
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert max_rel(ours, ref) <= TOWER_RTOL


@pytest.mark.parametrize("layout", ["features", "slice"])
def test_lpips_equals_jax(weights, layout, tmp_path):
    state = torch.load(weights / "lpips_alex.pth")
    if layout == "slice":  # the lpips package's own layout
        state = {k.replace("net.features.0.", "net.slice1.0.")
                 .replace("net.features.3.", "net.slice2.3.")
                 .replace("net.features.6.", "net.slice3.6.")
                 .replace("net.features.8.", "net.slice4.8.")
                 .replace("net.features.10.", "net.slice5.10."): v
                 for k, v in state.items()}
        assert set(lpips_state(state)) == set(torch.load(
            weights / "lpips_alex.pth"))
    torch.save(state, tmp_path / "lpips_alex.pth")
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    model, variables = JaxModels(str(weights)).lpips()
    ref = float(model.apply(variables, jnp.asarray(a), jnp.asarray(b),
                            normalize=True))
    ours = MetricModels(str(tmp_path), "cpu").lpips_distance(a, b)
    assert abs(ours - ref) <= TOWER_RTOL * abs(ref), (ours, ref)


# ----------------------------------------------------------------- mains


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A VITON-HD test split of 6 PIL JPEGs (no sidecars: the port's
    decoder reads them) and generated images beside it."""
    base = tmp_path_factory.mktemp("metric_split")
    root, gen = base / "vitonhd", base / "gen"
    (root / "test" / "image").mkdir(parents=True)
    gen.mkdir()
    rng = np.random.default_rng(5)
    pairs = []
    for i in range(6):
        im = f"{i:06d}_00.jpg"
        pairs.append(f"{im} {i:06d}_00.jpg")
        gt = rng.integers(0, 255, (64, 48, 3), dtype=np.uint8)
        Image.fromarray(gt).save(root / "test" / "image" / im, quality=95)
        noisy = np.clip(gt + rng.normal(0, 30, gt.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(gen / im, quality=90)
    (root / "test_pairs.txt").write_text("\n".join(pairs) + "\n")
    return root, gen


def _metric_args(split, weights, device=True) -> list:
    root, gen = split
    argv = ["--gen_folder", str(gen), "--dataset", "vitonhd",
            "--vitonhd_dataroot", str(root), "--test_order", "paired",
            "--batch_size", "8", "--workers", "2", "--height", "64",
            "--width", "48", "--weights_dir", str(weights)]
    return argv + (["--device", "cpu"] if device else [])


def test_metric_mains_equal_jax(split, weights, tmp_path):
    root, gen = split
    # the JAX main first: it builds the GT stats cache beside the root
    jax_val_main.main(_metric_args(split, weights, device=False))
    ref_path = gen / "metrics_paired_all.json"
    ref = json.loads(ref_path.read_text())
    port_stats = tmp_path / "port_stats"
    assert stats_main.main([
        "--vitonhd_dataroot", str(root), "--batch_size", "8",
        "--weights_dir", str(weights), "--stats_root", str(port_stats),
        "--device", "cpu"]) == ["vitonhd_all"]
    # either package reads either cache, and the two agree
    for reader in (fid, jax_fid):
        ours = reader.StatsCache(port_stats).load("vitonhd_all")
        theirs = reader.StatsCache(root.parent / "fid_stats").load(
            "vitonhd_all")
        for got, want in zip(ours, theirs):
            assert got.shape == want.shape
            assert max_rel(got, want) <= METRIC_RTOL

    # the port's main, reading the JAX main's cache
    ours = val_main.main(_metric_args(split, weights))
    assert json.loads(ref_path.read_text()) == ours
    assert sorted(ours) == sorted(ref) == sorted(
        ["ssim_score", "lpips_score", "fid_score", "kid_score", "is_score"])
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=METRIC_RTOL,
                                   err_msg=key)
    # the clean-fid folder-to-folder surface, from the port's own GT
    # features, gives the same FID
    np.testing.assert_allclose(
        fid_between_folders(str(gen), str(root / "test" / "image"),
                            batch_size=8, weights_dir=str(weights),
                            device="cpu"),
        ours["fid_score"], rtol=METRIC_RTOL)


def test_metric_mains_default_to_the_card(split, weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        val_main.main(_metric_args(split, weights, device=False))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stats_main.main(["--vitonhd_dataroot", str(split[0])])
