"""The port's data layer against the JAX package's, on the CPU.

Two small test splits, made with ``ladi_vton_tpu_torch.data.synthetic``
from a seed: DressCode (one category) and VITON-HD, 256x192 sources read
at 128x96.  Their images are JPEGs written by PIL (quality 95), decoded
once into sidecars by ``tools/decode_images.py``; label maps are P-mode
PNGs, masks and dense labels L-mode PNGs, all written by PIL.  Every item
of ``ladi_vton_tpu_torch.data.DressCodeDataset`` and ``VitonHDDataset``
must equal the JAX package's, key for key and bit for bit, except
``pose_map`` and ``im_pose`` (within 1e-6: the pose heatmaps come from a
separately built copy of the same C++) and ``dense_uv`` (``F.interpolate``
against ``cv2.resize``, within 5e-5, as ``test_torch_port_imageio.py``
states).  The same splits with progressive JPEGs (PIL's default script)
and no sidecars, read by the port's decoder, and a VITON-HD split with
CMYK JPEGs, give the JAX datasets' items too, and so do the splits
rewritten in the kinds PIL reads beyond those, with no sidecars: lossless
JPEG persons and cloths, 4-bit palette label maps (interlaced or not),
skeletons interlaced (16-bit or 8-bit RGB), 1-bit or 16-bit grey (PIL's
``1`` and ``I;16`` through ``_to_float``), 16-bit and 1-bit DressCode
cloth masks, 16-bit and 4-bit grey dense labels, a 16-bit RGB VITON-HD
cloth.  Also: ``BatchLoader``
against the
JAX loader (order, ``shuffle``, ``pad_last``, collation, worker
processes), the host C++ against ``data/raster.py`` and ``cv2.dilate``,
``tools/decode_images.py``'s idempotence, and the synthetic train split
(pairs, warped cloths, CLIP features, captions) read by both packages.
"""

import functools
import random
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ladi_vton_tpu.data import BatchLoader as JaxBatchLoader
from ladi_vton_tpu.data import DressCodeDataset as JaxDressCode
from ladi_vton_tpu.data import VitonHDDataset as JaxVitonHD
from ladi_vton_tpu_torch.data import (
    BatchLoader,
    DressCodeDataset,
    VitonHDDataset,
    native,
    raster,
    synthetic,
)
from ladi_vton_tpu_torch.data.dresscode import POSSIBLE_OUTPUTS

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import decode_images  # noqa: E402
import torch_port_jpeg as jpeg_writer  # noqa: E402
import torch_port_png as png_writer  # noqa: E402

SOURCE = (256, 192)
SIZE = (128, 96)
APPROX = {"pose_map": 1e-6, "im_pose": 1e-6, "dense_uv": 5e-5}
DRESSCODE_KEYS = POSSIBLE_OUTPUTS
# VITON-HD has no dense maps
VITONHD_KEYS = tuple(k for k in POSSIBLE_OUTPUTS
                     if k not in ("dense_labels", "dense_uv"))


def pil_jpeg(path, rgb, mode="RGB", **kw) -> None:
    """JPEG content under a .jpg name (quality 95, converted to ``mode``,
    PIL's ``save`` options ``kw``), PNG otherwise, as the datasets store
    them."""
    if str(path).endswith(".jpg"):
        Image.fromarray(rgb).convert(mode).save(path, "JPEG", quality=95,
                                                **kw)
    else:
        Image.fromarray(rgb).save(path, "PNG")


def pil_png(path, pixels, mode, palette=None) -> None:
    h, w = pixels.shape
    im = Image.frombytes(mode, (w, h), np.ascontiguousarray(pixels).tobytes())
    if mode == "P":
        im.putpalette(np.asarray(palette, np.uint8).ravel().tolist())
    im.save(path, "PNG")


def make_trees(base: Path, size=SOURCE, n_pairs=2, clip_shape=(5, 8),
               train_pairs=0, write_image=pil_jpeg,
               sidecars=True) -> dict:
    """DressCode and VITON-HD test splits (and train splits of
    ``train_pairs``) with PIL-written files and, unless not
    ``sidecars``, their sidecars; {"dresscode": root, "vitonhd": root}."""
    kw = dict(size=size, n_pairs=n_pairs, clip_shape=clip_shape,
              write_image=write_image, write_png=pil_png,
              train_pairs=train_pairs)
    roots = {
        "dresscode": synthetic.write_dresscode(base / "dc" / "dresscode",
                                               seed=3, **kw),
        "vitonhd": synthetic.write_vitonhd(base / "vh" / "vitonhd", seed=4,
                                           **kw),
    }
    if sidecars:
        for root in roots.values():
            for tree in (root, root.parent / "cache"):
                decode_images.decode_tree(tree)
    return roots


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return make_trees(tmp_path_factory.mktemp("port_data"))


def _datasets(trees, name, order, keys):
    caption = trees[name].parent / "captions.json"
    caption.write_text('{"000000": ["red", "shirt"], "000001": ["blue"]}')
    kw = dict(phase="test", order=order, outputlist=keys, size=SIZE,
              caption_file=str(caption))
    if name == "dresscode":
        kw["category"] = ("upper_body",)
        return (DressCodeDataset(str(trees[name]), **kw),
                JaxDressCode(str(trees[name]), **kw))
    return (VitonHDDataset(str(trees[name]), **kw),
            JaxVitonHD(str(trees[name]), **kw))


def _assert_items_equal(ours: dict, ref: dict) -> None:
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        got = ours[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if key in APPROX:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=APPROX[key], err_msg=key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key


@pytest.mark.parametrize("order", ["paired", "unpaired"])
@pytest.mark.parametrize("name,keys", [("dresscode", DRESSCODE_KEYS),
                                       ("vitonhd", VITONHD_KEYS)])
def test_dataset_items_equal_the_jax_datasets(trees, name, keys, order):
    ours, ref = _datasets(trees, name, order, keys)
    assert len(ours) == len(ref) == 2
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        _assert_items_equal(a, b)
        assert a["image"].shape == SIZE + (3,)
        # the masks are not trivial: something to inpaint, something kept
        assert 0 < a["inpaint_mask"].mean() < 1


@pytest.fixture(scope="module")
def train_trees(tmp_path_factory):
    return make_trees(tmp_path_factory.mktemp("port_train_data"),
                      n_pairs=1, train_pairs=2)


@pytest.mark.parametrize("name,keys", [("dresscode", DRESSCODE_KEYS),
                                       ("vitonhd", VITONHD_KEYS)])
def test_train_split_items_equal_the_jax_datasets(train_trees, name, keys):
    """The synthetic train split (its pair list, warped cloths, CLIP
    features and noun-chunk captions) read by both packages' datasets:
    every key equal, the captions' train-time shuffle from the same
    ``random`` state."""
    kw = dict(phase="train", order="paired", outputlist=keys, size=SIZE,
              caption_file=str(train_trees[name] / "captions.json"))
    if name == "dresscode":
        kw["category"] = ("upper_body",)
        ours = DressCodeDataset(str(train_trees[name]), **kw)
        ref = JaxDressCode(str(train_trees[name]), **kw)
    else:
        ours = VitonHDDataset(str(train_trees[name]), **kw)
        ref = JaxVitonHD(str(train_trees[name]), **kw)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        random.seed(i)
        a = ours[i]
        random.seed(i)
        b = ref[i]
        _assert_items_equal(a, b)
        assert a["captions"] and a["clip_cloth_features"].shape == (5, 8)
        assert 0 < a["inpaint_mask"].mean() < 1


def test_a_jpeg_without_its_sidecar_raises(trees, tmp_path):
    from ladi_vton_tpu_torch.data import imageio

    src = trees["vitonhd"] / "test" / "image" / "000000_00.jpg"
    lone = tmp_path / "lone.jpg"
    # baseline and progressive JPEGs decode without their sidecars; one
    # whose frame says 12-bit samples (PIL refuses it too) not
    img = np.asarray(Image.open(src))
    frame = jpeg_writer.coefficients(jpeg_writer.rgb_to_ycc(img),
                                     [(2, 2), (1, 1), (1, 1)])
    lone.write_bytes(jpeg_writer.write(frame, precision=12, sof=0xC1))
    with pytest.raises(FileNotFoundError, match="tools/decode_images.py"):
        imageio.open_image(lone)


@pytest.fixture(scope="module")
def progressive_trees(tmp_path_factory):
    roots = make_trees(tmp_path_factory.mktemp("port_progressive"),
                       write_image=functools.partial(pil_jpeg,
                                                     progressive=True),
                       sidecars=False)
    for root in roots.values():
        assert not list(root.parent.rglob("*.jpg.png"))
        assert Image.open(next(root.rglob("*.jpg"))).info.get("progressive")
    return roots


@pytest.mark.parametrize("order", ["paired", "unpaired"])
@pytest.mark.parametrize("name,keys", [("dresscode", DRESSCODE_KEYS),
                                       ("vitonhd", VITONHD_KEYS)])
def test_progressive_trees_without_sidecars_equal_the_jax_datasets(
        progressive_trees, name, keys, order):
    ours, ref = _datasets(progressive_trees, name, order, keys)
    assert len(ours) == len(ref) == 2
    for i in range(len(ref)):
        _assert_items_equal(ours[i], ref[i])


def test_cmyk_jpegs_read_as_the_jax_dataset_reads_them(tmp_path):
    """PIL gives a CMYK JPEG four channels and the JAX dataset keeps them
    (``_to_float``); so does the port."""
    roots = make_trees(tmp_path, size=(64, 48), n_pairs=1,
                       write_image=functools.partial(pil_jpeg, mode="CMYK"),
                       sidecars=False)
    keys = ("c_name", "im_name", "cloth", "image", "warped_cloth")
    ours, ref = _datasets(roots, "vitonhd", "paired", keys)
    a, b = ours[0], ref[0]
    _assert_items_equal(a, b)
    assert a["image"].shape == SIZE + (4,)


def test_cmyk_dresscode_cloth_reads_as_the_jax_dataset_reads_it(tmp_path):
    """The DressCode cloth's background goes through ``Image.composite``,
    which pastes the inverted L mask in the cloth's mode: for a CMYK
    cloth PIL converts it to (0, 0, 0, 255 - l) first."""
    roots = make_trees(tmp_path, size=(64, 48), n_pairs=1,
                       write_image=functools.partial(pil_jpeg, mode="CMYK"),
                       sidecars=False)
    keys = ("c_name", "im_name", "cloth", "image", "warped_cloth")
    ours, ref = _datasets(roots, "dresscode", "paired", keys)
    a, b = ours[0], ref[0]
    _assert_items_equal(a, b)
    assert a["cloth"].shape == SIZE + (4,)


def _rewrite(path: Path, kind: str, rng) -> None:
    """The file at ``path`` rewritten, pixels kept, as a kind PIL reads:
    a lossless JPEG (``lossless_rgb``, ``lossless_422``), a 4-bit palette
    PNG of its labels clipped to 15 (``palette4``, ``palette4_interlaced``),
    an interlaced RGB PNG at 8 or 16 bits (``interlaced``,
    ``interlaced16``), a 16-bit RGB PNG (``rgb16``), 16-bit grey
    (``gray16``: 0 and 255 become 0 and 65535, a few pixels small values
    that pass PIL's clamp), 1-bit grey (``gray1``), or 4-bit grey labels
    (``gray4``); the grey kinds take an RGB file's first channel."""
    im = Image.open(path)
    px = np.asarray(im)
    if kind.startswith("gray") and px.ndim == 3:
        px = px[..., 0]
    if kind == "lossless_rgb":
        data = jpeg_writer.lossless(jpeg_writer.lossless_frame(px), psv=4,
                                    markers=jpeg_writer.adobe(0))
    elif kind == "lossless_422":
        frame = jpeg_writer.lossless_frame(px, [(2, 1), (1, 1), (1, 1)])
        data = jpeg_writer.lossless(frame, psv=7, pt=1, markers=b"",
                                    ids=b"RGB", restart=frame.mcus()[1])
    elif kind.startswith("palette4"):
        palette = np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)[:16]
        data = png_writer.encode(np.minimum(px, 15), 3, 4, palette=palette,
                                 interlace=kind.endswith("interlaced"),
                                 rng=rng)
    elif kind in ("interlaced", "interlaced16", "rgb16"):
        sixteen = kind != "interlaced"
        samples = px.astype(np.int64) * (257 if sixteen else 1)
        data = png_writer.encode(samples, 2, 16 if sixteen else 8,
                                 interlace=kind != "rgb16", rng=rng)
    elif kind == "gray16":
        samples = px.astype(np.int64) * 257
        few = rng.random(px.shape) < 0.05
        samples[few] = rng.integers(0, 300, few.sum())
        data = png_writer.encode(samples, 0, 16, rng=rng)
    elif kind == "gray1":
        data = png_writer.encode(px > 127, 0, 1, interlace=True, rng=rng)
    else:  # gray4
        data = png_writer.encode(np.minimum(px, 15), 0, 4, rng=rng)
    path.write_bytes(data)


# (path pattern under the root, kind of item 0, kind of item 1)
NEW_KINDS = {
    "vitonhd": [("test/image/{i:06d}_00.jpg", "lossless_rgb",
                 "lossless_422"),
                ("test/image-parse-v3/{i:06d}_00.png", "palette4",
                 "palette4_interlaced"),
                ("test/openpose_img/{i:06d}_00_rendered.png",
                 "interlaced16", "gray1"),
                ("test/cloth/{i:06d}_00.jpg", "lossless_422", "rgb16")],
    "dresscode": [("upper_body/images/{i:06d}_0.jpg", "lossless_rgb",
                   "lossless_422"),
                  ("upper_body/images/{i:06d}_1.jpg", "lossless_422",
                   "lossless_rgb"),
                  ("upper_body/label_maps/{i:06d}_4.png", "palette4",
                   "palette4_interlaced"),
                  ("upper_body/skeletons/{i:06d}_5.jpg", "interlaced",
                   "gray16"),
                  ("upper_body/masks/{i:06d}_1.png", "gray16", "gray1"),
                  ("upper_body/dense/{i:06d}_5.png", "gray16", "gray4")],
}


@pytest.fixture(scope="module")
def new_kind_trees(tmp_path_factory):
    roots = make_trees(tmp_path_factory.mktemp("port_new_kinds"),
                       sidecars=False)
    rng = np.random.default_rng(6)
    for name, files in NEW_KINDS.items():
        for pattern, *kinds in files:
            for i, kind in enumerate(kinds):
                _rewrite(roots[name] / pattern.format(i=i), kind, rng)
    for root in roots.values():
        assert not list(root.parent.rglob("*.jpg.png"))
    return roots


@pytest.mark.parametrize("order", ["paired", "unpaired"])
@pytest.mark.parametrize("name,keys", [("dresscode", DRESSCODE_KEYS),
                                       ("vitonhd", VITONHD_KEYS)])
def test_new_kinds_without_sidecars_equal_the_jax_datasets(
        new_kind_trees, name, keys, order):
    """Every key of both splits, rewritten in the new kinds, against the
    JAX datasets, which read the same files with PIL."""
    ours, ref = _datasets(new_kind_trees, name, order, keys)
    assert len(ours) == len(ref) == 2
    for i in range(len(ref)):
        _assert_items_equal(ours[i], ref[i])
    if name == "dresscode":  # the 16-bit dense labels stay 16-bit
        assert ours[0]["dense_labels"].dtype == np.uint16
        # a 16-bit skeleton, resampled in 16 bits, over 255 / 255
        assert ours[1]["skeleton"].max() > 1.0


def test_decode_images_is_idempotent(trees, capsys):
    root = trees["dresscode"]
    side = root / "upper_body" / "images" / "000000_0.jpg.png"
    before = side.stat().st_mtime_ns
    written, kept, lossless = decode_images.decode_tree(root)
    assert written == 0 and kept > 0 and lossless == 0
    assert side.stat().st_mtime_ns == before
    decode_images.main([str(root)])
    assert "0 sidecars written" in capsys.readouterr().out
    assert np.array_equal(np.asarray(Image.open(side)),
                          np.asarray(Image.open(str(side)[:-4])))


def test_decode_images_writes_no_sidecar_for_a_lossless_jpeg(tmp_path,
                                                            capsys):
    """An 8-bit lossless (SOF3) JPEG, which the port reads, gets no
    sidecar and is counted apart; a baseline one beside it still gets
    its sidecar, and a 12-bit lossless one is not taken for SOF3."""
    rgb = np.random.default_rng(7).integers(0, 256, (9, 11, 3), np.uint8)
    frame = jpeg_writer.lossless_frame(rgb)
    (tmp_path / "a.jpg").write_bytes(jpeg_writer.lossless(frame))
    Image.fromarray(rgb).save(tmp_path / "b.jpg", "JPEG")
    (tmp_path / "c.jpg").write_bytes(jpeg_writer.lossless(frame,
                                                          precision=12))
    assert [decode_images.port_reads(tmp_path / f"{n}.jpg")
            for n in "abc"] == [True, False, False]
    (tmp_path / "c.jpg").unlink()  # PIL refuses it: no sidecar to write
    decode_images.main([str(tmp_path)])
    assert ("1 sidecars written, 0 up to date, 1 lossless JPEGs need none"
            in capsys.readouterr().out)
    assert not (tmp_path / "a.jpg.png").exists()
    assert (tmp_path / "b.jpg.png").exists()


@pytest.mark.parametrize("batch_size,shuffle,pad_last,drop_last", [
    (3, False, True, False), (3, True, False, False),
    (2, True, True, False), (3, False, False, True)])
def test_batch_loader_matches_the_jax_loader(trees, batch_size, shuffle,
                                             pad_last, drop_last):
    keys = ("im_name", "c_name", "category", "image", "inpaint_mask")
    ours, ref = _datasets(trees, "dresscode", "paired", keys)
    # 5 items: the 2 pairs, repeated
    for ds in (ours, ref):
        for attr in ("im_names", "c_names", "categories"):
            setattr(ds, attr, (getattr(ds, attr) * 3)[:5])
    kw = dict(shuffle=shuffle, pad_last=pad_last, drop_last=drop_last,
              seed=7)
    loader = BatchLoader(ours, batch_size, num_workers=0, **kw)
    jloader = JaxBatchLoader(ref, batch_size, num_workers=1,
                             workers_mode="thread", **kw)
    assert len(loader) == len(jloader)
    for _ in range(2):  # a second epoch reshuffles the same way
        assert loader._batch_indices() == jloader._batch_indices()
        got, want = list(loader), list(jloader)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_items_equal(a, b)


def test_batch_loader_worker_processes(trees):
    keys = ("im_name", "category", "image", "pose_map")
    ours, _ = _datasets(trees, "vitonhd", "paired", keys)
    inline = list(BatchLoader(ours, 2, num_workers=0, pad_last=True))
    workers = list(BatchLoader(ours, 2, num_workers=2, pad_last=True,
                               multiprocessing_context="forkserver"))
    assert len(inline) == len(workers) == 1
    _assert_items_equal(workers[0], inline[0])


def test_host_library_matches_raster_and_cv2():
    rng = np.random.default_rng(0)
    kps = np.concatenate([rng.uniform(2, 30, (6, 2)),
                          np.zeros((1, 2))]).astype(np.float32)
    np.testing.assert_allclose(native.pose_heatmaps(kps, (32, 24), 9.0),
                               raster.pose_heatmaps(kps, (32, 24), 9.0),
                               rtol=1e-4, atol=1e-5)
    for pts in ([[3, 4], [20, 18], [28, 6]], [[1.7, 30.2], [22.9, 3.1]],
                [[5, 5], [5, 5], [18, 25], [2, 29]]):
        pts = np.asarray(pts, np.float32)
        np.testing.assert_array_equal(native.draw_polyline(32, 24, pts, 7.0),
                                      raster.draw_polyline(32, 24, pts, 7.0))
    m = (rng.uniform(size=(40, 30)) > 0.92).astype(np.float32)
    np.testing.assert_array_equal(
        native.box_dilate(m, 5, 5),
        cv2.dilate(m, np.ones((5, 5), np.uint16), iterations=5))


def test_a_failed_host_build_raises(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
