"""The port's image I/O and resampling against PIL and cv2, on the CPU.

* PNG: PIL writes and the port reads, and the port writes and PIL reads,
  for L, LA, P, RGB and RGBA (PIL's ``optimize`` picks adaptive filters,
  so every filter type occurs), bit for bit, over hypothesis sizes.
  Every legal (colour type, bit depth) pair, Adam7-interlaced or not,
  with ``PLTE`` and ``tRNS`` where the type allows them and random row
  filters, from the tests' writer (``torch_port_png``): the port's mode,
  dtype and array are PIL's, also over hypothesis sizes; ``resize``
  (NEAREST, BILINEAR, BICUBIC), ``convert_l`` and the metrics'
  ``rgb_pixels`` on modes ``1`` and ``I;16`` and on 16-bit files equal
  PIL's, with PIL's 16-bit resample wrapping its overshoot above 65535
  as it does; the committed fixtures (``tests/fixtures/png``) against
  PIL; an illegal pair raises.
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
* A JPEG the port's decoder does not read (a lossless arithmetic one,
  which PIL refuses too) is read from its decoded sidecar only, and
  raises without one, naming the tool.
* ``dense_uv``'s resize (``F.interpolate``) against ``cv2.resize``
  (INTER_LINEAR) on float32 data in [0, 1], within 5e-5: the two
  interpolate between the same source pixels, but cv2 rounds its source
  positions and weights to float32 in another order (1.4e-5 seen at
  256x192 -> 100x77).
"""

import io
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageOps

import torch_port_jpeg as jpeg_writer
import torch_port_png as png_writer
from ladi_vton_tpu_torch.data import imageio, resample
from ladi_vton_tpu_torch.data.dresscode import resize_chw
from ladi_vton_tpu_torch.metrics.compute import rgb_pixels

PNG_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "png"

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
    # an illegal (colour type, bit depth) pair: RGB at 4 bits
    header = png_writer.encode(np.zeros((3, 4), np.uint8), 0, 4)
    bad = header.replace(png_writer.chunk(b"IHDR", bytes.fromhex(
        "00000004000000030400000000")), png_writer.chunk(
        b"IHDR", bytes.fromhex("00000004000000030402000000")))
    assert bad != header
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).load()
    with pytest.raises(ValueError, match="unsupported"):
        imageio.decode_png(bad)
    buf = io.BytesIO()
    Image.new("L", (4, 3)).save(buf, "GIF")
    (tmp_path / "x.png").write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        imageio.open_image(tmp_path / "x.png")


def _png_case(rng, h: int, w: int, color_type: int, depth: int,
              interlace: bool, smooth: bool = False) -> bytes:
    """A PNG of one kind with random row filters; a palette image gets a
    ``PLTE`` shorter than its largest index at times (PIL's missing
    entries are black), and every type that allows one a ``tRNS``."""
    samples = png_writer.draw(rng, h, w, color_type, depth, smooth)
    palette = trns = None
    top = (1 << depth) - 1
    if color_type == 3:
        palette = rng.integers(0, 256, (int(rng.integers(1, top + 2)), 3))
        trns = bytes(rng.integers(0, 256, len(palette) // 2 + 1).tolist())
    elif color_type in (0, 2):
        value = rng.integers(0, top + 1, 1 if color_type == 0 else 3)
        trns = b"".join(int(v).to_bytes(2, "big") for v in value)
    return png_writer.encode(samples, color_type, depth, interlace=interlace,
                             palette=palette, trns=trns, rng=rng)


def _check_png(data: bytes, tmp_path=None) -> imageio.Image:
    im = Image.open(io.BytesIO(data))
    want = np.asarray(im)
    got = imageio.decode_png(data)
    assert got.mode == im.mode
    assert got.pixels.dtype == want.dtype and got.pixels.shape == want.shape
    np.testing.assert_array_equal(got.pixels, want)
    return got


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("kind", png_writer.LEGAL,
                         ids=[f"type{c}_{d}bit" for c, d in png_writer.LEGAL])
def test_every_legal_png_equals_pil(kind, interlace):
    """Each (colour type, bit depth) at sizes smaller than, equal to and
    larger than an Adam7 tile, random and smooth content: PIL's mode,
    dtype and array."""
    rng = np.random.default_rng(30)
    for h, w in ((1, 1), (3, 5), (8, 8), (13, 21), (40, 9)):
        for smooth in (False, True):
            _check_png(_png_case(rng, h, w, *kind, interlace, smooth))


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       kind=st.sampled_from(png_writer.LEGAL), interlace=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_every_legal_png_equals_pil_over_sizes(h, w, kind, interlace, seed):
    _check_png(_png_case(np.random.default_rng(seed), h, w, *kind,
                         interlace))


# the modes and files the new kinds bring: (colour type, bit depth)
NEW_MODES = {"1": (0, 1), "L_4bit": (0, 4), "P_4bit": (3, 4),
             "I;16": (0, 16), "RGB_16bit": (2, 16),
             "RGBA_from_LA_16bit": (4, 16), "RGBA_16bit": (6, 16)}


@pytest.mark.parametrize("kind", list(NEW_MODES))
def test_new_modes_resize_convert_and_rgb_equal_pil(kind, tmp_path):
    """``resize`` (PIL forces NEAREST on 1 and P, resamples I;16 in
    16 bits), ``convert_l`` (1 to 0/255, I;16 clamped at 255) and the
    metrics' ``rgb_pixels`` (PIL's ``convert("RGB")``), against PIL, at
    the datasets' 1024x768 -> 512x384 and over odd sizes up and down."""
    rng = np.random.default_rng(31)
    color_type, depth = NEW_MODES[kind]
    # 28 -> 10 and 14 -> 11: where PIL's NEAREST on I;16 (a fresh product
    # a pixel) and on 8-bit images (a running sum) pick other pixels
    for (h, w), sizes in (((1024, 768), [(512, 384)]),
                          ((29, 17), [(13, 40), (41, 9), (1, 1)]),
                          ((28, 14), [(10, 11)])):
        data = _png_case(rng, h, w, color_type, depth, interlace=h < 100,
                         smooth=True)
        got = _check_png(data)
        im = Image.open(io.BytesIO(data))
        for out_hw in sizes:
            for method in METHODS:
                if im.mode in ("LA", "RGBA") and method != resample.NEAREST:
                    continue  # premultiplied alpha: no path resizes them
                want = np.asarray(im.resize(out_hw[::-1], METHODS[method]))
                ours = got.resize(out_hw, method).pixels
                assert ours.dtype == want.dtype, (kind, method)
                np.testing.assert_array_equal(ours, want,
                                              err_msg=f"{kind} {method}")
        np.testing.assert_array_equal(got.convert_l().pixels,
                                      np.asarray(im.convert("L")))
        path = tmp_path / "x.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(rgb_pixels(str(path)),
                                      np.asarray(im.convert("RGB")))


def test_i16_resize_wraps_its_overshoot_as_pil():
    """Bicubic overshoot above 65535 keeps its low byte under a high byte
    of 255 in PIL's 16bpc resample (``CLIP8(n % 256)``, ``CLIP8(n >>
    8)``), and one below 0 gives 0: the port computes the same."""
    rng = np.random.default_rng(32)
    img = rng.choice(np.array([0, 65535, 65500], np.uint16), (20, 20))
    want = np.asarray(Image.fromarray(img).resize((33, 7), Image.BICUBIC))
    ours = resample.resize(img, (7, 33), resample.BICUBIC)
    np.testing.assert_array_equal(ours, want)
    # some sums passed 65535: a plain clip would give 65535 there
    assert ((want >= 0xFF00) & (want < 0xFFFF)).any()


def test_committed_png_fixtures_equal_pil():
    """The PNG files ``chip_smoke.py`` checks on the card: PIL's array of
    each is its committed ``.npy``, and so is the port's, in PIL's
    mode."""
    manifest = json.loads((PNG_FIXTURES / "fixtures.json").read_text())
    assert len(manifest) == len(list(PNG_FIXTURES.glob("*.png")))
    for kind, entry in manifest.items():
        im = Image.open(PNG_FIXTURES / f"{kind}.png")
        want = np.load(PNG_FIXTURES / f"{kind}.npy")
        assert np.asarray(im).dtype == want.dtype, kind
        np.testing.assert_array_equal(np.asarray(im), want, err_msg=kind)
        got = imageio.open_image(PNG_FIXTURES / f"{kind}.png")
        assert got.mode == im.mode == entry["mode"], kind
        assert got.pixels.dtype == want.dtype, kind
        np.testing.assert_array_equal(got.pixels, want, err_msg=kind)


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


def test_cmyk_conversions_and_composite_equal_pil():
    """A CMYK JPEG's pixels (PIL's mode for four components): PIL's
    ``convert`` to RGB and L, and the DressCode cloth's composite, whose
    L mask PIL converts to the cloth's mode (``l2cmyk``: 0, 0, 0, 255 -
    l) before it blends; and the L mask over an RGBA image."""
    rng = np.random.default_rng(5)
    mask = rng.integers(0, 256, (19, 23), dtype=np.uint8)
    pil_inv = ImageOps.invert(Image.fromarray(mask))
    inv = resample.invert(mask)
    for mode in ("RGBA", "CMYK"):  # the CMYK one stays for the converts
        px = rng.integers(0, 256, (19, 23, 4), dtype=np.uint8)
        im = Image.fromarray(px, mode)
        np.testing.assert_array_equal(
            resample.composite(inv, px, inv, mode),
            np.asarray(Image.composite(pil_inv, im, pil_inv)))
        np.testing.assert_array_equal(resample.from_l(mask, mode),
                                      np.asarray(Image.fromarray(
                                          mask).convert(mode)))
    np.testing.assert_array_equal(resample.cmyk_to_rgb(px),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(
        imageio.Image(px, "CMYK").convert_l().pixels,
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
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    path = tmp_path / "x.jpg"
    # a lossless arithmetic-coded JPEG (SOF11): the port's decoder refuses
    # it, and so does PIL, so the sidecar holds pixels made another way
    path.write_bytes(jpeg_writer.lossless(jpeg_writer.lossless_frame(rgb),
                                          sof=0xCB, markers=b""))
    with pytest.raises(FileNotFoundError, match="tools/decode_images.py"):
        imageio.open_image(path)
    known = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    imageio.write_png(imageio.sidecar_path(path), known)
    got = imageio.open_image(path)
    assert got.mode == "RGB"
    np.testing.assert_array_equal(got.pixels, known)
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
