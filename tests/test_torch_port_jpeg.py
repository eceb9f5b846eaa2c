"""The port's baseline JPEG decoder against PIL, on the CPU.

``data/imageio.open_image`` decodes a baseline JPEG with the host C++
(``csrc/host/jpeg_decode.cpp``); every case here must equal
``np.asarray(PIL.Image.open(path))`` bit for bit (PIL on libjpeg-turbo:
islow IDCT, fancy upsampling, fixed-point YCbCr -> RGB):

* hypothesis-drawn images of sizes that are not multiples of 8 or 16
  (1 to 70 pixels a side), quality 30 to 100, 4:4:4, 4:2:2 and 4:2:0,
  grayscale, with and without restart intervals and ``optimize=True``
  Huffman tables;
* the datasets' 1024x768 at quality 95 (PIL's default 4:2:0), and PIL's
  files with the edges that fall back to plain replication (a chroma
  plane 1 or 2 samples wide);
* the port's own writer's files (``imageio.write_jpeg``);
* a progressive JPEG goes to its sidecar, or raises naming
  ``tools/decode_images.py`` without one; a truncated one raises.
"""

import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ladi_vton_tpu_torch.data import imageio, native, resample

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _photo(rng, h: int, w: int, noise: int = 40) -> np.ndarray:
    """Smooth content with noise: every coefficient band is used."""
    coarse = rng.integers(0, 256, (max(1, h // 5), max(1, w // 5), 3),
                          dtype=np.uint8)
    img = resample.resize(coarse, (h, w), resample.BICUBIC).astype(np.int16)
    img = img + rng.integers(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img: np.ndarray, gray: bool = False, **kw) -> bytes:
    im = Image.fromarray(img)
    if gray:
        im = im.convert("L")
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _check(data: bytes, tmp_path, name="x.jpg") -> np.ndarray:
    want = np.asarray(Image.open(io.BytesIO(data)))
    path = tmp_path / name
    path.write_bytes(data)
    got = imageio.open_image(path)
    assert got.mode == ("L" if want.ndim == 2 else "RGB")
    assert got.pixels.dtype == np.uint8 and got.pixels.shape == want.shape
    np.testing.assert_array_equal(got.pixels, want)
    return got.pixels


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(30, 100),
       sampling=st.sampled_from(list(SUBSAMPLING) + ["gray"]),
       restart=st.sampled_from([0, 1, 3]), optimize=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_jpeg_decoder_equals_pil_over_draws(h, w, quality, sampling, restart,
                                           optimize, seed, tmp_path_factory):
    kw = dict(quality=quality, optimize=optimize)
    if sampling != "gray":
        kw["subsampling"] = SUBSAMPLING[sampling]
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _pil_jpeg(_photo(np.random.default_rng(seed), h, w),
                     gray=sampling == "gray", **kw)
    _check(data, tmp_path_factory.mktemp("jpeg"))


@pytest.mark.parametrize("sampling", list(SUBSAMPLING) + ["gray"])
def test_jpeg_decoder_equals_pil_at_the_datasets_size(sampling, tmp_path):
    img = _photo(np.random.default_rng(1), 1024, 768)
    kw = {} if sampling == "gray" else {"subsampling": SUBSAMPLING[sampling]}
    _check(_pil_jpeg(img, gray=sampling == "gray", quality=95, **kw),
           tmp_path)


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 4), (3, 17), (17, 2)])
@pytest.mark.parametrize("sampling", ["4:2:2", "4:2:0"])
def test_jpeg_decoder_narrow_chroma_edges(hw, sampling, tmp_path):
    img = _photo(np.random.default_rng(2), *hw)
    _check(_pil_jpeg(img, quality=90, subsampling=SUBSAMPLING[sampling]),
           tmp_path)


@pytest.mark.parametrize("hw", [(512, 384), (37, 53), (1, 9)])
def test_jpeg_decoder_reads_the_ports_writer(hw, tmp_path):
    img = _photo(np.random.default_rng(3), *hw, noise=4)
    data = imageio.encode_jpeg(img, quality=95)
    pixels = _check(data, tmp_path)
    if hw == (512, 384):  # a generated image: close to what was written
        mse = np.mean((pixels.astype(np.float64) - img) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 30.0


def test_a_progressive_jpeg_goes_to_its_sidecar(tmp_path):
    img = _photo(np.random.default_rng(4), 40, 30)
    data = _pil_jpeg(img, quality=90, progressive=True)
    assert native.jpeg_decode(data) is None
    path = tmp_path / "p.jpg"
    path.write_bytes(data)
    with pytest.raises(FileNotFoundError, match="tools/decode_images.py"):
        imageio.open_image(path)
    Image.open(path).save(imageio.sidecar_path(path), "PNG")
    np.testing.assert_array_equal(imageio.open_image(path).pixels,
                                  np.asarray(Image.open(path)))


def test_a_truncated_jpeg_raises():
    data = _pil_jpeg(_photo(np.random.default_rng(5), 16, 16), quality=90)
    with pytest.raises(ValueError, match="JPEG"):
        native.jpeg_decode(data[:40])
