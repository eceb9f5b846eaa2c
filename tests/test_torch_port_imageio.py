"""The port's image I/O and resampling against PIL and cv2, on the CPU.

* PNG: PIL writes and the port reads, and the port writes and PIL reads,
  for L, LA, P, RGB and RGBA (PIL's ``optimize`` picks adaptive filters,
  so every filter type occurs), bit for bit, over hypothesis sizes.
* Resampling: ``data/resample.py`` bit for bit equal to ``Image.resize``
  for NEAREST, BILINEAR and BICUBIC on L, P and RGB images, at the
  datasets' 1024x768 -> 512x384, the silhouette's /16 and x16, and over
  hypothesis sizes down and up; ``invert``, ``composite`` and
  ``convert("L")`` bit for bit equal to PIL.
* JPEG writer: PIL opens the port's file; its quantisation tables and
  sampling factors equal those of PIL's own file at quality 95, and the
  PSNR of its decode against the source is at most 0.1 dB below the PSNR
  of PIL's own file (the test prints both and the largest pixel
  difference between the two decodes).
* A JPEG the port's decoder does not read (progressive) is read from its
  decoded sidecar only, and raises without one, naming the tool.
* ``dense_uv``'s resize (``F.interpolate``) against ``cv2.resize``
  (INTER_LINEAR) on float32 data in [0, 1], within 5e-5: the two
  interpolate between the same source pixels, but cv2 rounds its source
  positions and weights to float32 in another order (1.4e-5 seen at
  256x192 -> 100x77).
"""

import io

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageOps

from ladi_vton_tpu_torch.data import imageio, resample
from ladi_vton_tpu_torch.data.dresscode import resize_chw

METHODS = {resample.NEAREST: Image.NEAREST,
           resample.BILINEAR: Image.BILINEAR,
           resample.BICUBIC: Image.BICUBIC}
CHANNELS = {"L": 1, "LA": 2, "P": 1, "RGB": 3, "RGBA": 4}
PSNR_SLACK_DB = 0.1
DENSE_UV_ATOL = 5e-5


def _image(rng, h, w, mode) -> np.ndarray:
    shape = (h, w) if CHANNELS[mode] == 1 else (h, w, CHANNELS[mode])
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    arr[: h // 3] = arr[: h // 3, :1]   # flat rows favour other filters
    return arr


def _pil(arr: np.ndarray, mode: str, palette=None) -> Image.Image:
    h, w = arr.shape[:2]
    im = Image.frombytes(mode, (w, h), np.ascontiguousarray(arr).tobytes())
    if mode == "P":
        im.putpalette(palette.ravel().tolist())
    return im


def _roundtrip(arr, mode):
    palette = (np.random.default_rng(0).integers(0, 256, (256, 3))
               .astype(np.uint8) if mode == "P" else None)
    buf = io.BytesIO()
    _pil(arr, mode, palette).save(buf, "PNG", optimize=True)
    ours = imageio.decode_png(buf.getvalue())
    assert ours.mode == mode
    np.testing.assert_array_equal(ours.pixels, arr)
    if mode == "P":
        np.testing.assert_array_equal(ours.palette, palette)
    back = Image.open(io.BytesIO(imageio.encode_png(arr, mode, palette)))
    assert back.mode == mode
    np.testing.assert_array_equal(np.asarray(back), arr)


@pytest.mark.parametrize("mode", list(CHANNELS))
def test_png_both_ways(mode):
    _roundtrip(_image(np.random.default_rng(1), 37, 29, mode), mode)


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       mode=st.sampled_from(list(CHANNELS)), seed=st.integers(0, 2 ** 16))
def test_png_both_ways_over_sizes(h, w, mode, seed):
    _roundtrip(_image(np.random.default_rng(seed), h, w, mode), mode)


def test_png_refuses_what_it_does_not_read(tmp_path):
    buf = io.BytesIO()
    Image.new("I;16", (4, 3)).save(buf, "PNG")
    with pytest.raises(ValueError, match="unsupported"):
        imageio.decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.new("L", (4, 3)).save(buf, "GIF")
    (tmp_path / "x.png").write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        imageio.open_image(tmp_path / "x.png")


def _check_resize(arr, mode, out_hw, method):
    im = _pil(arr, mode, np.zeros((256, 3), np.uint8) if mode == "P"
              else None)
    want = np.asarray(im.resize(out_hw[::-1], METHODS[method]))
    ours = imageio.Image(arr, mode).resize(out_hw, method).pixels
    np.testing.assert_array_equal(ours, want,
                                  err_msg=f"{mode} {method} {out_hw}")


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("src,dst", [
    ((1024, 768), (512, 384)),    # the datasets' native size to the model's
    ((512, 384), (32, 24)),       # the silhouette's /16
    ((32, 24), (512, 384)),       # and back, x16
    ((300, 200), (512, 384))])    # upsampling
def test_resize_equals_pil(method, src, dst):
    rng = np.random.default_rng(2)
    for mode in ("L", "RGB", "P"):
        _check_resize(_image(rng, *src, mode), mode, dst, method)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 120), w=st.integers(1, 120),
       oh=st.integers(1, 120), ow=st.integers(1, 120),
       mode=st.sampled_from(["L", "RGB", "P"]),
       method=st.sampled_from(list(METHODS)), seed=st.integers(0, 2 ** 16))
def test_resize_equals_pil_over_sizes(h, w, oh, ow, mode, method, seed):
    _check_resize(_image(np.random.default_rng(seed), h, w, mode), mode,
                  (oh, ow), method)


def test_invert_composite_and_convert_l_equal_pil():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (33, 27, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (33, 27), dtype=np.uint8)
    pil_rgb, pil_mask = Image.fromarray(rgb), Image.fromarray(mask)
    np.testing.assert_array_equal(resample.invert(mask),
                                  np.asarray(ImageOps.invert(pil_mask)))
    np.testing.assert_array_equal(resample.invert(rgb),
                                  np.asarray(ImageOps.invert(pil_rgb)))
    np.testing.assert_array_equal(resample.convert_l(rgb),
                                  np.asarray(pil_rgb.convert("L")))
    # the DressCode cloth: the inverted mask pasted over the cloth
    inv = resample.invert(mask)
    pil_inv = ImageOps.invert(pil_mask)
    np.testing.assert_array_equal(
        resample.composite(inv, rgb, inv),
        np.asarray(Image.composite(pil_inv, pil_rgb, pil_inv)))
    other = rng.integers(0, 256, (33, 27, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        resample.composite(other, rgb, mask),
        np.asarray(Image.composite(Image.fromarray(other), pil_rgb,
                                   pil_mask)))
    # convert("L") of the modes a mask may come in
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    for mode in ("RGB", "RGBA", "LA", "P"):
        arr = _image(rng, 9, 7, mode)
        im = _pil(arr, mode, palette)
        ours = imageio.Image(arr, mode, palette if mode == "P" else None)
        np.testing.assert_array_equal(ours.convert_l().pixels,
                                      np.asarray(im.convert("L")))


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


@pytest.mark.parametrize("hw", [(512, 384), (37, 53)])
def test_jpeg_writer_against_pil(hw, tmp_path):
    rng = np.random.default_rng(4)
    h, w = hw
    coarse = rng.integers(0, 256, (8, 6, 3), dtype=np.uint8)
    src = resample.resize(coarse, hw, resample.BICUBIC).astype(np.int16)
    src = np.clip(src + rng.integers(-12, 13, src.shape), 0, 255).astype(
        np.uint8)
    ours_path = tmp_path / "ours.jpg"
    imageio.write_jpeg(ours_path, src)
    buf = io.BytesIO()
    Image.fromarray(src).save(buf, "JPEG", quality=95)
    ours, pil = Image.open(ours_path), Image.open(buf)
    assert ours.format == "JPEG" and ours.size == (w, h)
    assert ours.quantization == pil.quantization
    assert ours.layer == pil.layer  # 4:2:0: Y 2x2, Cb and Cr 1x1
    a, b = np.asarray(ours), np.asarray(pil)
    p_ours, p_pil = _psnr(a, src), _psnr(b, src)
    print(f"JPEG quality 95 at {h}x{w}: PSNR port {p_ours:.3f} dB, PIL "
          f"{p_pil:.3f} dB, largest difference between the decodes "
          f"{np.abs(a.astype(int) - b).max()}")
    assert p_ours >= p_pil - PSNR_SLACK_DB
    markers = imageio.jpeg_markers(ours_path.read_bytes())
    assert markers[0] == 0xD8 and markers[-1] == 0xD9
    assert {0xDB, 0xC0, 0xC4, 0xDA} <= set(markers)


def test_a_jpeg_is_read_from_its_sidecar_only(tmp_path):
    rgb = np.random.default_rng(5).integers(0, 256, (12, 10, 3),
                                            dtype=np.uint8)
    path = tmp_path / "x.jpg"
    Image.fromarray(rgb).save(path, "JPEG", quality=95, progressive=True)
    with pytest.raises(FileNotFoundError, match="tools/decode_images.py"):
        imageio.open_image(path)
    Image.open(path).save(imageio.sidecar_path(path), "PNG")
    np.testing.assert_array_equal(imageio.open_image(path).pixels,
                                  np.asarray(Image.open(path)))
    # content decides, not the name: PNG content under a .jpg name
    png_named_jpg = tmp_path / "y.jpg"
    Image.fromarray(rgb).save(png_named_jpg, "PNG")
    np.testing.assert_array_equal(imageio.open_image(png_named_jpg).pixels,
                                  rgb)


def test_dense_uv_resize_against_cv2():
    uv = np.random.default_rng(6).uniform(0, 1, (2, 256, 192)).astype(
        np.float32)
    for hw in ((128, 96), (512, 384), (100, 77)):
        want = np.stack([cv2.resize(c, hw[::-1],
                                    interpolation=cv2.INTER_LINEAR)
                         for c in uv])
        np.testing.assert_allclose(resize_chw(uv, hw), want, rtol=0,
                                   atol=DENSE_UV_ATOL)
