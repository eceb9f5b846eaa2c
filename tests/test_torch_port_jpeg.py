"""The port's JPEG decoder against PIL, on the CPU.

``data/imageio.open_image`` decodes a JPEG with the host C++
(``csrc/host/jpeg_decode.cpp``); every case here must equal
``np.asarray(PIL.Image.open(path))`` bit for bit (PIL on libjpeg-turbo:
islow IDCT, fancy upsampling, fixed-point YCbCr -> RGB):

* hypothesis-drawn images of sizes that are not multiples of 8 or 16
  (1 to 70 pixels a side), quality 30 to 100, 4:4:4, 4:2:2 and 4:2:0,
  grayscale, with and without restart intervals and ``optimize=True``
  Huffman tables, baseline and progressive (PIL's default script, with
  ``restart_marker_blocks`` or ``restart_marker_rows``);
* the datasets' 1024x768 at quality 95 (PIL's default 4:2:0), baseline
  and progressive, and PIL's files with the edges that fall back to
  plain replication (a chroma plane 1 or 2 samples wide);
* the port's own writer's files (``imageio.write_jpeg``) and CMYK files
  from PIL's writer;
* what PIL cannot write, from the tests' writer (``torch_port_jpeg``):
  other scan scripts (spectral selection only, a DC scan per component,
  several successive-approximation steps), arithmetic coding (SOF9,
  SOF10, DAC conditioning, restarts), 4:4:0, 4:1:1 and other integral
  sampling ratios, YCCK, Adobe-RGB and RGB-labelled colour, each also
  held to PIL's decode of the same coefficients written as a baseline
  file (which checks the writer); an arithmetic file larger than PIL's
  read block, which PIL does not decode, held to that baseline decode;
* libjpeg-turbo's block smoothing, where a progressive script leaves
  coefficients inexact: fixed scripts and random valid ones;
* the committed fixtures (``tools/make_jpeg_fixtures.py``) against PIL;
* damaged files against PIL, for each entropy coder with and without
  restarts: scans cut short before the EOI, entropy bytes overwritten
  (markers made or broken among them), files that end before their EOI
  (which PIL reports truncated), and blocks whose coefficients overflow
  the IDCT's 16-bit lanes;
* lossless (SOF3) files from the tests' writer: every predictor at
  point transforms 0 to 3, restarts, interleaved or one scan per
  component, grey, RGB (Adobe, ``R``/``G``/``B`` ids, or no marker) and
  CMYK, subsampled or not, over hypothesis draws; differences taken
  modulo 2^16 (category 16 among them); damaged and truncated copies as
  above; and the colours libjpeg-turbo will not convert in lossless mode
  (JFIF or Adobe YCbCr, YCCK), which PIL and the port both refuse;
* the kinds that stay refused (lossless arithmetic SOF11, 12-bit
  samples, lossless ones too, a height left to DNL, hierarchical frames,
  two components) go to their sidecar, or raise naming
  ``tools/decode_images.py`` without one; a damaged file raises.
"""

import io
import itertools
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import torch_port_jpeg as writer
from ladi_vton_tpu_torch.data import imageio, native, resample

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
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
    im = Image.open(io.BytesIO(data))
    want = np.asarray(im)
    path = tmp_path / name
    path.write_bytes(data)
    got = imageio.open_image(path)
    assert got.mode == im.mode
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


def _twelve_bit(img: np.ndarray) -> bytes:
    """A frame whose SOF says 12-bit samples (PIL refuses to open it)."""
    frame = writer.coefficients(writer.rgb_to_ycc(img), [(1, 1)] * 3)
    return writer.write(frame, precision=12, sof=0xC1)


def test_a_progressive_jpeg_goes_to_its_sidecar(tmp_path):
    """A progressive JPEG now decodes without a sidecar (and one present is
    not read); a 12-bit one, which the decoder refuses, goes to its
    sidecar, or raises naming ``tools/decode_images.py`` without one."""
    img = _photo(np.random.default_rng(4), 40, 30)
    data = _pil_jpeg(img, quality=90, progressive=True)
    prog = tmp_path / "p.jpg"
    prog.write_bytes(data)
    imageio.write_png(imageio.sidecar_path(prog), np.zeros_like(img))
    np.testing.assert_array_equal(imageio.open_image(prog).pixels,
                                  np.asarray(Image.open(prog)))
    data = _twelve_bit(img)
    assert native.jpeg_decode(data) is None
    path = tmp_path / "t.jpg"
    path.write_bytes(data)
    with pytest.raises(FileNotFoundError, match="tools/decode_images.py"):
        imageio.open_image(path)
    # PIL cannot decode it: the sidecar holds known pixels
    imageio.write_png(imageio.sidecar_path(path), img)
    got = imageio.open_image(path)
    assert got.mode == "RGB"
    np.testing.assert_array_equal(got.pixels, img)


def test_a_truncated_jpeg_raises():
    data = _pil_jpeg(_photo(np.random.default_rng(5), 16, 16), quality=90)
    with pytest.raises(ValueError, match="JPEG"):
        native.jpeg_decode(data[:40])


# -------------------------------------------------------------- progressive


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(30, 100),
       sampling=st.sampled_from(list(SUBSAMPLING) + ["gray"]),
       restart=st.sampled_from([None, ("blocks", 1), ("blocks", 3),
                                ("rows", 1)]),
       optimize=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_progressive_jpeg_equals_pil_over_draws(h, w, quality, sampling,
                                                restart, optimize, seed,
                                                tmp_path_factory):
    kw = dict(quality=quality, optimize=optimize, progressive=True)
    if sampling != "gray":
        kw["subsampling"] = SUBSAMPLING[sampling]
    if restart:
        kw[f"restart_marker_{restart[0]}"] = restart[1]
    data = _pil_jpeg(_photo(np.random.default_rng(seed), h, w),
                     gray=sampling == "gray", **kw)
    _check(data, tmp_path_factory.mktemp("jpeg"))


def test_progressive_jpeg_equals_pil_at_the_datasets_size(tmp_path):
    img = _photo(np.random.default_rng(6), 1024, 768)
    _check(_pil_jpeg(img, quality=95, progressive=True), tmp_path)


@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_jpeg_from_pils_writer_equals_pil(progressive, tmp_path):
    """PIL writes CMYK with an Adobe marker and reads every CMYK JPEG
    inverted ("CMYK;I"); the port gives the same (H, W, 4) bytes."""
    im = Image.fromarray(_photo(np.random.default_rng(7), 29, 43))
    buf = io.BytesIO()
    im.convert("CMYK").save(buf, "JPEG", quality=90, progressive=progressive)
    assert imageio.jpeg_markers(buf.getvalue())[1] == 0xEE  # Adobe
    assert _check(buf.getvalue(), tmp_path).shape == (29, 43, 4)


# ------------------------------------------- files only the tests' writer makes

YCC_420 = [(2, 2), (1, 1), (1, 1)]
# kind: (sampling, colour, write() arguments); colour "ycc" converts an
# RGB photo, "raw" stores its channels as they are
WRITTEN = {
    "spectral_selection": (YCC_420, "ycc", dict(
        mode="progressive", script=writer.spectral_selection(3))),
    "separate_dc": ([(2, 1), (1, 1), (1, 1)], "ycc", dict(
        mode="progressive", script=writer.separate_dc(3))),
    "approximations_restarts": ([(1, 1)] * 3, "ycc", dict(
        mode="progressive", script=writer.many_approximations(3),
        restart=2)),
    "gray_approximations": ([(1, 1)], "raw", dict(
        mode="progressive", script=writer.many_approximations(1))),
    "arithmetic": (YCC_420, "ycc", dict(mode="arithmetic")),
    "arithmetic_dac_restarts": ([(2, 1), (1, 1), (1, 1)], "ycc", dict(
        mode="arithmetic", restart=3,
        dac={("dc", 0): (2, 5), ("ac", 0): 12, ("dc", 1): (0, 0),
             ("ac", 1): 1})),
    "arithmetic_progressive": (YCC_420, "ycc", dict(
        mode="arithmetic_progressive")),
    "arithmetic_progressive_approximations": ([(1, 1)] * 3, "ycc", dict(
        mode="arithmetic_progressive",
        script=writer.many_approximations(3), restart=5)),
    "arithmetic_gray_separate_dc": ([(1, 1)], "raw", dict(
        mode="arithmetic_progressive", script=writer.separate_dc(1))),
    "sampling_440": ([(1, 2), (1, 1), (1, 1)], "ycc", {}),
    "sampling_440_progressive": ([(1, 2), (1, 1), (1, 1)], "ycc", dict(
        mode="progressive")),
    "sampling_411": ([(4, 1), (1, 1), (1, 1)], "ycc", {}),
    "sampling_411_arithmetic": ([(4, 1), (1, 1), (1, 1)], "ycc", dict(
        mode="arithmetic")),
    "sampling_mixed": ([(2, 2), (1, 2), (2, 1)], "ycc", {}),
    "sampling_h3": ([(3, 1), (1, 1), (1, 1)], "ycc", {}),
    "sampling_v4": ([(1, 4), (1, 1), (1, 1)], "ycc", {}),
    "gray_sampled_2x2": ([(2, 2)], "raw", dict(mode="progressive")),
    "ycck": ([(1, 1)] * 4, "raw", dict(markers=writer.adobe(2))),
    "ycck_420_arithmetic_progressive": (
        [(2, 2), (1, 1), (1, 1), (2, 2)], "raw", dict(
            mode="arithmetic_progressive", markers=writer.adobe(2))),
    "cmyk_without_marker": ([(1, 1)] * 4, "raw", dict(markers=b"")),
    "adobe_rgb": ([(1, 1)] * 3, "raw", dict(markers=writer.adobe(0))),
    "adobe_ycc": (YCC_420, "ycc", dict(markers=writer.adobe(1),
                                       mode="progressive")),
    "rgb_labelled": ([(1, 1)] * 3, "raw", dict(markers=b"", ids=b"RGB")),
    "rgb_labelled_under_jfif": ([(1, 1)] * 3, "ycc", dict(ids=b"RGB")),
}


def _written(kind: str, rng, h: int, w: int, quality: int,
             restart: int = 0) -> tuple[bytes, bytes]:
    """(the kind's file, the same coefficients and markers as a baseline
    file)."""
    sampling, colour, kw = WRITTEN[kind]
    channels = len(sampling)
    img = _photo(rng, h, w) if channels < 4 else np.concatenate(
        [_photo(rng, h, w), _photo(rng, h, w)[..., :1]], axis=2)
    planes = writer.rgb_to_ycc(img) if colour == "ycc" else img[
        ..., :channels]
    frame = writer.coefficients(planes, sampling, quality)
    kw = dict(kw)
    if restart:
        kw["restart"] = restart
    base = {k: kw[k] for k in ("markers", "ids") if k in kw}
    return writer.write(frame, **kw), writer.write(frame, **base)


def _check_written(data: bytes, base: bytes, tmp_path) -> None:
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  np.asarray(Image.open(io.BytesIO(base))))
    _check(data, tmp_path)


@pytest.mark.parametrize("kind", list(WRITTEN))
def test_written_jpeg_equals_pil(kind, tmp_path):
    data, base = _written(kind, np.random.default_rng(8), 45, 37, 85)
    _check_written(data, base, tmp_path)


@settings(max_examples=40, deadline=None)
@given(kind=st.sampled_from(list(WRITTEN)), h=st.integers(1, 70),
       w=st.integers(1, 70), quality=st.integers(30, 100),
       restart=st.sampled_from([0, 0, 1, 4]), seed=st.integers(0, 2 ** 16))
def test_written_jpeg_equals_pil_over_draws(kind, h, w, quality, restart,
                                            seed, tmp_path_factory):
    data, base = _written(kind, np.random.default_rng(seed), h, w, quality,
                          restart)
    _check_written(data, base, tmp_path_factory.mktemp("jpeg"))


def test_an_arithmetic_jpeg_larger_than_pils_read_block():
    """PIL feeds libjpeg 64 KB at a time, and jdarith.c cannot wait for
    more, so PIL does not decode this file; the port decodes it to PIL's
    pixels of the same coefficients written as a baseline file."""
    data, base = _written("arithmetic", np.random.default_rng(9), 300, 300,
                          95)
    assert len(data) > 65536
    np.testing.assert_array_equal(native.jpeg_decode(data),
                                  np.asarray(Image.open(io.BytesIO(base))))


def test_committed_fixtures_equal_pil():
    """The files ``chip_smoke.py`` checks on the card: PIL's decode of
    each is its committed PNG, and so is the port's."""
    manifest = json.loads((FIXTURES / "fixtures.json").read_text())
    assert len(manifest) == len(list(FIXTURES.glob("*.jpg")))
    for kind, entry in manifest.items():
        im = Image.open(FIXTURES / f"{kind}.jpg")
        want = imageio.decode_png((FIXTURES / f"{kind}.png").read_bytes())
        np.testing.assert_array_equal(np.asarray(im), want.pixels,
                                      err_msg=kind)
        got = imageio.open_image(FIXTURES / f"{kind}.jpg")
        assert got.mode == im.mode == entry["mode"], kind
        np.testing.assert_array_equal(got.pixels, want.pixels, err_msg=kind)


# ------------------------------------------------------- lossless (SOF3)

# a lossless frame's colour: (channels, lossless() arguments).  Without a
# marker libjpeg-turbo takes a lossless frame for RGB, whatever its ids.
LOSSLESS_COLOURS = {
    "gray": (1, {}),
    "adobe_rgb": (3, dict(markers=writer.adobe(0))),
    "rgb_labelled": (3, dict(markers=b"", ids=b"RGB")),
    "ids_123_no_marker": (3, dict(markers=b"")),
    "cmyk": (4, dict(markers=b"")),
    "adobe_cmyk": (4, dict(markers=writer.adobe(0))),
}
# colours libjpeg-turbo would have to convert, which it refuses in
# lossless mode (jdcolor.c): PIL raises, and so does the port
LOSSLESS_CONVERTED = {
    "jfif_ycc": (3, dict(markers=writer.JFIF)),
    "adobe_ycc": (3, dict(markers=writer.adobe(1))),
    "adobe_ycck": (4, dict(markers=writer.adobe(2))),
}


def _lossless_planes(rng, h: int, w: int, channels: int) -> np.ndarray:
    img = _photo(rng, h, w, noise=8)
    if channels == 4:
        img = np.concatenate([img, _photo(rng, h, w)[..., :1]], axis=2)
    return img[..., 0] if channels == 1 else img[..., :channels]


def _lossless(rng, h: int, w: int, colour: str, sampling=None,
              **kw) -> bytes:
    channels, marks = {**LOSSLESS_COLOURS, **LOSSLESS_CONVERTED}[colour]
    frame = writer.lossless_frame(_lossless_planes(rng, h, w, channels),
                                  sampling)
    return writer.lossless(frame, **marks, **kw)


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_predictors_and_point_transforms_equal_pil(psv, tmp_path):
    """Each predictor (the scan's Ss) at point transforms 0-3: grey with
    a restart every MCU row, RGB 4:2:0 with a restart every two (each
    resetting the predictor), and grey decoding to its samples shifted
    by Pt, exactly."""
    rng = np.random.default_rng(40 + psv)
    for pt in range(4):
        gray = _lossless_planes(rng, 23, 29, 1)
        data = writer.lossless(writer.lossless_frame(gray), psv=psv, pt=pt,
                               restart=29)
        np.testing.assert_array_equal(_check(data, tmp_path),
                                      (gray >> pt) << pt)
        data = _lossless(rng, 23, 29, "adobe_rgb", YCC_420, psv=psv, pt=pt,
                         restart=30)
        _check(data, tmp_path)


@pytest.mark.parametrize("colour", list(LOSSLESS_COLOURS))
def test_lossless_colours_and_scans_equal_pil(colour, tmp_path):
    """Each colour convention, in one interleaved scan, one scan per
    component, and scans of components out of the frame's order (as far
    as libjpeg takes them), subsampled where there is more than one
    component (replicated, never fancy: libjpeg's lossless DCT size of
    1)."""
    rng = np.random.default_rng(50)
    channels = LOSSLESS_COLOURS[colour][0]
    sampling = None if channels == 1 else [(2, 2)] + [(1, 1)] * (
        channels - 2) + [(1, 2)]
    shuffled = {1: [(0,)], 3: [(2, 1), (0,)], 4: [(3, 1), (0, 2)]}
    for scans in (None, shuffled[channels],
                  [(c,) for c in range(channels)]):
        _check(_lossless(rng, 31, 27, colour, psv=4, scans=scans),
               tmp_path)
        _check(_lossless(rng, 31, 27, colour, sampling, psv=6, pt=2,
                         scans=scans), tmp_path)


@pytest.mark.parametrize("lossless", [False, True])
def test_scan_component_order_equals_pil(lossless):
    """Scans listing the frame's components in every order: libjpeg's
    get_sos matches scan component i only to a frame component at or
    after position i, and refuses the others."""
    rng = np.random.default_rng(72)
    img = _photo(rng, 16, 16)
    frame = (writer.lossless_frame(img) if lossless else
             writer.coefficients(writer.rgb_to_ycc(img), [(1, 1)] * 3))
    for order in itertools.permutations(range(3)):
        for split in (3, 2, 1):
            scans = [order[:split], order[split:]] if split < 3 else [order]
            if lossless:
                data = writer.lossless(frame, scans=scans, markers=b"")
            else:
                data = writer.write(frame, script=[(c, 0, 63, 0, 0)
                                                   for c in scans])
            _equals_pil_or_both_raise(data)


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       colour=st.sampled_from(list(LOSSLESS_COLOURS)),
       sampling=st.sampled_from([None, "2x2", "2x1", "1x2", "4x1", "mixed"]),
       psv=st.integers(1, 7), pt=st.integers(0, 7),
       restart_rows=st.sampled_from([0, 0, 1, 3]),
       separate=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_lossless_equals_pil_over_draws(h, w, colour, sampling, psv, pt,
                                        restart_rows, separate, seed,
                                        tmp_path_factory):
    """Sizes, colours, sampling factors (the first component's, or a
    mix), predictors, point transforms, restarts every few MCU rows and
    one scan per component, drawn together."""
    channels = LOSSLESS_COLOURS[colour][0]
    first = {None: (1, 1), "2x2": (2, 2), "2x1": (2, 1), "1x2": (1, 2),
             "4x1": (4, 1), "mixed": (2, 2)}[sampling]
    factors = [first] + [(1, 1)] * (channels - 1)
    if sampling == "mixed" and channels > 2:
        factors[1:3] = [(2, 1), (1, 2)]
    rng = np.random.default_rng(seed)
    frame = writer.lossless_frame(_lossless_planes(rng, h, w, channels),
                                  factors)
    scans = [(c,) for c in range(channels)] if separate else None
    # a whole number of MCU rows in every scan (a scan of one component
    # has an MCU a sample)
    widths = ([s.shape[1] for s in frame.samples]
              if separate or channels == 1 else [frame.mcus()[1]])
    restart = restart_rows * int(np.lcm.reduce(widths))
    data = writer.lossless(frame, psv=psv, pt=pt, scans=scans,
                           restart=restart if restart < 65536 else 0,
                           **LOSSLESS_COLOURS[colour][1])
    _check(data, tmp_path_factory.mktemp("jpeg"))


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_differences_wrap_as_pil(psv):
    """Differences given outright, of every category to 16 (the
    difference 32768, coded without bits): libjpeg undifferences them
    to 16 bits and keeps the low byte of each value shifted by Pt; the
    dummy samples of partial MCUs are decoded and dropped."""
    rng = np.random.default_rng(60 + psv)
    frame = writer.lossless_frame(_lossless_planes(rng, 13, 11, 3),
                                  [(2, 2), (1, 1), (1, 1)])
    rows, cols = frame.mcus()
    for pt in (0, 3):
        differences = {}
        for c, (h, v) in enumerate(frame.comps):
            shape = (rows * v, cols * h)
            differences[c] = np.where(
                rng.random(shape) < 0.3,
                rng.choice([32768, -32767, 32767, 255, -256], shape),
                rng.integers(-32767, 32769, shape))
        data = writer.lossless(frame, psv=psv, pt=pt, restart=2 * cols,
                               differences=differences, markers=b"")
        np.testing.assert_array_equal(
            native.jpeg_decode(data), np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("colour", list(LOSSLESS_CONVERTED))
def test_lossless_in_a_converted_colour_raises_as_pil(colour):
    """libjpeg-turbo converts no colour in lossless mode, so PIL cannot
    read a lossless YCbCr or YCCK frame; the port raises too."""
    data = _lossless(np.random.default_rng(70), 9, 12, colour)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="lossless frame in YCbCr or YCCK"):
        native.jpeg_decode(data)


def test_lossless_scan_headers_libjpeg_rejects_raise_as_pil():
    """A predictor outside 1-7, Se or Ah not 0, a point transform of 8
    bits or more, a restart interval that is not whole MCU rows, a
    table symbol above 16, more than 10 samples an MCU: PIL raises, and
    so does the port; a point transform of 7 and a symbol of 16 decode."""
    rng = np.random.default_rng(71)
    data = _lossless(rng, 9, 12, "gray", psv=3)
    sos = data.index(b"\xff\xda") + 7
    dht = data.index(b"\xff\xc4")
    last = dht + 2 + struct.unpack(">H", data[dht + 2:dht + 4])[0] - 1
    variants = [(sos, 0), (sos, 8), (sos + 1, 1), (sos + 2, 0x10),
                (sos + 2, 7), (sos + 2, 8), (last, 16), (last, 17)]
    cases = []
    for at, value in variants:
        damaged = bytearray(data)
        damaged[at] = value
        cases.append(bytes(damaged))
    cases.append(_lossless(rng, 9, 12, "gray", restart=5))
    cases.append(_lossless(rng, 9, 12, "rgb_labelled",
                           [(4, 4), (1, 1), (1, 1)]))
    for case in cases:
        _equals_pil_or_both_raise(case)


# ------------------------------------------------------------ still refused


SMOOTHED = {"stops_early": writer.stops_early,
            "dc_only": lambda n: [(tuple(range(n)), 0, 0, 0, 1)],
            "ac_two_bits_short": lambda n: [(tuple(range(n)), 0, 0, 0, 0)] + [
                ((c,), 1, 63, 0, 2) for c in range(n)]}


def _as_coded(frame, script) -> "writer.Frame":
    """The coefficients a script leaves known: each at its last scan's Al
    (the DC floored, AC toward zero), uncoded ones zero."""
    coef = []
    for c, full in enumerate(frame.coef):
        bits = np.full(64, -1)
        for comps, ss, se, _, al in script:
            if c in comps:
                bits[ss:se + 1] = al
        al = np.maximum(bits, 0)
        ac = np.sign(full) * ((np.abs(full) >> al) << al)
        ac[..., 0] = (full[..., 0] >> al[0]) << al[0]
        coef.append(np.where(bits < 0, 0, ac).astype(np.int32))
    return writer.Frame(frame.height, frame.width, frame.comps, coef,
                        frame.quant)


@pytest.mark.parametrize("script", list(SMOOTHED))
@pytest.mark.parametrize("mode", ["progressive", "arithmetic_progressive"])
def test_block_smoothing_equals_pil(script, mode, tmp_path):
    """Coefficients 1..9 still inexact after the last scan make libjpeg
    smooth the blocks (jdcoefct.c): PIL's pixels differ from the baseline
    decode of the coefficients the scans leave known, and the port gives
    PIL's.  With no AC coefficient coded (``dc_only``) the DC is
    estimated too."""
    rng = np.random.default_rng(10)
    frame = writer.coefficients(writer.rgb_to_ycc(_photo(rng, 40, 48, 10)),
                                YCC_420, 75)
    scans = SMOOTHED[script](3)
    pil = _check(writer.write(frame, mode, script=scans), tmp_path)
    plain = writer.write(_as_coded(frame, scans))
    assert not np.array_equal(pil, np.asarray(Image.open(io.BytesIO(plain))))


@settings(max_examples=40, deadline=None)
@given(sampling=st.sampled_from([YCC_420, [(1, 1)], [(2, 2)],
                                 [(1, 2), (1, 1), (1, 1)], [(1, 1)] * 4]),
       h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(20, 100),
       mode=st.sampled_from(["progressive", "arithmetic_progressive"]),
       restart=st.sampled_from([0, 0, 1, 5]), seed=st.integers(0, 2 ** 16))
def test_random_progressions_equal_pil_over_draws(sampling, h, w, quality,
                                                  mode, restart, seed,
                                                  tmp_path_factory):
    """Valid scripts of random length (``writer.random_progression``):
    any mix of exact, inexact and uncoded coefficients, smoothed or not."""
    rng = np.random.default_rng(seed)
    img = _photo(rng, h, w)
    n = len(sampling)
    planes = {1: img[..., 0], 3: writer.rgb_to_ycc(img)}.get(
        n, np.concatenate([img, img[..., :1]], axis=2))
    frame = writer.coefficients(planes, sampling, quality)
    data = writer.write(frame, mode, restart=restart,
                        script=writer.random_progression(rng, n))
    _check(data, tmp_path_factory.mktemp("jpeg"))


def _refused(kind: str) -> bytes:
    img = _photo(np.random.default_rng(11), 16, 24)
    frame = writer.coefficients(writer.rgb_to_ycc(img), [(1, 1)] * 3)
    lossless = writer.lossless_frame(img[..., 0])
    if kind == "12-bit":
        return _twelve_bit(img)
    if kind == "dnl":
        return writer.write(frame, height=0)
    if kind == "hierarchical":
        return writer.write(frame, sof=0xC5)
    if kind == "two_components":
        two = writer.Frame(16, 24, frame.comps[:2], frame.coef[:2],
                           frame.quant)
        return writer.write(two)
    if kind == "lossless_12_bit":
        return writer.lossless(lossless, precision=12)
    if kind == "lossless_dnl":
        return writer.lossless(lossless, height=0)
    # lossless arithmetic (SOF11): libjpeg has no decoder for it
    return writer.lossless(lossless, sof=0xCB)


@pytest.mark.parametrize("kind", ["12-bit", "dnl", "hierarchical",
                                  "two_components", "lossless",
                                  "lossless_12_bit", "lossless_dnl"])
def test_refused_kinds_take_the_sidecar_route(kind, tmp_path):
    """Kinds PIL refuses too (``lossless`` is SOF11, lossless arithmetic
    coding): no PIL decode can write their sidecar, so the test writes
    known pixels there."""
    data = _refused(kind)
    assert native.jpeg_decode(data) is None
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    path = tmp_path / "r.jpg"
    path.write_bytes(data)
    with pytest.raises(FileNotFoundError, match="tools/decode_images.py"):
        imageio.open_image(path)
    want = np.full((3, 5), 7, np.uint8)
    imageio.write_png(imageio.sidecar_path(path), want)
    np.testing.assert_array_equal(imageio.open_image(path).pixels, want)


# --------------------------------------------------- damaged entropy data

# files of each entropy coder, with and without restarts, whose damaged
# copies are held to PIL: (PIL's save options) or (the tests' writer kind)
DAMAGED = {
    "baseline": dict(quality=85), "baseline_gray": dict(quality=85),
    "baseline_restarts": dict(quality=85, restart_marker_blocks=2),
    "progressive": dict(quality=85, progressive=True),
    "progressive_restarts": dict(quality=85, progressive=True,
                                 restart_marker_blocks=2),
    "approximations_restarts": "approximations_restarts",
    "arithmetic": "arithmetic",
    "arithmetic_dac_restarts": "arithmetic_dac_restarts",
    "arithmetic_progressive": "arithmetic_progressive",
    "lossless": lambda rng: _lossless(rng, 40, 45, "adobe_rgb", [
        (2, 1), (1, 1), (1, 1)], psv=int(rng.integers(1, 8)), pt=1),
    "lossless_restarts": lambda rng: _lossless(
        rng, 40, 45, "gray", psv=int(rng.integers(1, 8)), restart=45),
    "lossless_scans_restarts": lambda rng: _lossless(
        rng, 40, 45, "rgb_labelled", psv=int(rng.integers(1, 8)),
        scans=[(2,), (0,), (1,)], restart=90),
}


def _damageable(kind: str, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    how = DAMAGED[kind]
    if callable(how):
        return how(rng)
    if isinstance(how, str):
        return _written(how, rng, 40, 45, 85)[0]
    return _pil_jpeg(_photo(rng, 40, 45), gray=kind.endswith("gray"), **how)


def _equals_pil_or_both_raise(data: bytes) -> None:
    try:
        want = np.asarray(Image.open(io.BytesIO(data)))
    except OSError:
        with pytest.raises(ValueError, match="JPEG"):
            native.jpeg_decode(data)
        return
    np.testing.assert_array_equal(native.jpeg_decode(data), want)


@pytest.mark.parametrize("kind", list(DAMAGED))
def test_a_scan_cut_short_equals_pil(kind):
    """The entropy data cut at points in every scan, the EOI kept: the
    segment runs into a marker, libjpeg feeds zeros, leaves the
    segment's later MCUs alone once a read took them (Huffman), and
    smooths iMCU rows past the last one decoded whole by the progression
    before the cut scan (libjpeg-turbo's last_good_iMCU_row)."""
    data = _damageable(kind, 20)
    rng = np.random.default_rng(21)
    for start, end in writer.entropy_spans(data):
        for cut in rng.integers(start, end, 3):
            _equals_pil_or_both_raise(data[:cut] + b"\xff\xd9")


@pytest.mark.parametrize("kind", list(DAMAGED))
def test_corrupted_entropy_data_equals_pil(kind):
    """Bytes of the entropy data overwritten at random, markers made or
    broken among them: bad Huffman codes (17 bits read, zero taken),
    runs past the block, DC overflow, arithmetic decoding errors, a
    restart marker out of its order (jpeg_resync_to_restart), and
    coefficients that overflow the IDCT."""
    rng = np.random.default_rng(22)
    for i in range(12):
        data = bytearray(_damageable(kind, 30 + i))
        spans = writer.entropy_spans(bytes(data))
        for _ in range(int(rng.integers(1, 4))):
            start, end = spans[rng.integers(len(spans))]
            data[int(rng.integers(start, end))] = int(rng.integers(256))
        _equals_pil_or_both_raise(bytes(data))


@pytest.mark.parametrize("kind", [k for k in DAMAGED if "restarts" in k])
def test_restart_markers_out_of_order_equal_pil(kind):
    """A restart marker renumbered, dropped, or turned into another
    marker: libjpeg resynchronises (jdmarker.c jpeg_resync_to_restart:
    a later restart stays unread and leaves its segments empty, an
    earlier one or another code is skipped), and a table segment it
    then meets is read as far as the file goes."""
    data = _damageable(kind, 24)
    rsts = [i for i in range(len(data) - 1) if data[i] == 0xFF
            and 0xD0 <= data[i + 1] <= 0xD7]
    rng = np.random.default_rng(25)
    for _ in range(16):
        damaged = bytearray(data)
        i = rsts[rng.integers(len(rsts))]
        how = rng.integers(3)
        if how == 0:
            damaged[i + 1] = 0xD0 + int(rng.integers(8))
        elif how == 1:
            del damaged[i:i + 2]
        else:
            damaged[i + 1] = int(rng.choice([0x01, 0x80, 0xC4, 0xE1, 0xFE]))
        _equals_pil_or_both_raise(bytes(damaged))


@pytest.mark.parametrize("kind", ["baseline", "progressive", "arithmetic",
                                  "lossless"])
def test_a_jpeg_without_its_eoi_raises(kind):
    """PIL reports a file that ends before its EOI truncated, wherever
    it ends; the port's decoder says it is damaged."""
    data = _damageable(kind, 23)
    for cut in (1, 2, len(data) - writer.entropy_spans(data)[-1][0] - 5):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data[:-cut])).load()
        with pytest.raises(ValueError, match="JPEG"):
            native.jpeg_decode(data[:-cut])


@pytest.mark.parametrize("seed", range(3))
def test_idct_of_extreme_coefficients_equals_pil(seed):
    """Blocks of large, sparse or dense coefficients under random tables:
    PIL's libjpeg-turbo runs the islow IDCT on 16-bit SIMD lanes, whose
    dequantisation and sums wrap and whose outputs saturate where
    jidctint.c's range-limit table wraps; the port computes as it does
    (what a damaged file's coefficients reach)."""
    rng = np.random.default_rng(seed)
    rows, cols = 4, 25
    coef = np.zeros((rows, cols, 64), np.int64)
    for block in coef.reshape(-1, 64):
        density = rng.choice([0.0, 0.05, 0.2, 1.0])
        mag = int(rng.choice([3, 50, 1023]))
        if rng.random() < 0.3:  # the first row of coefficients alone
            picked = np.isin(writer.ZIGZAG, np.arange(8))
        else:
            picked = rng.random(64) < density
        block[picked] = rng.integers(-mag, mag + 1, picked.sum())
    # DC as a walk in steps a baseline file can code (|diff| <= 2047)
    dc = np.cumsum(rng.integers(-2047, 2048, rows * cols))
    coef[..., 0] = np.clip(dc, -32000, 32000).reshape(rows, cols)
    quant = rng.integers(1, 256, 64)
    if seed == 1:
        quant = np.minimum(quant, 8)
    frame = writer.Frame(rows * 8, cols * 8, [(1, 1, 0)],
                         [coef.astype(np.int32)], {0: quant})
    data = writer.write(frame, markers=b"")
    np.testing.assert_array_equal(native.jpeg_decode(data),
                                  np.asarray(Image.open(io.BytesIO(data))))


def _bad_script(mode: str) -> bytes:
    """A progressive file whose first scan asks for DC with Se = 5, which
    libjpeg rejects (JERR_BAD_PROGRESSION)."""
    frame = writer.coefficients(_photo(np.random.default_rng(12), 16, 16)[
        ..., 0], [(1, 1)])
    return writer.write(frame, mode, script=[((0,), 0, 0, 0, 0),
                                             ((0,), 1, 63, 0, 0)]).replace(
        bytes([0xFF, 0xDA, 0, 8, 1, 1, 0, 0, 0, 0]),
        bytes([0xFF, 0xDA, 0, 8, 1, 1, 0, 0, 5, 0]), 1)


@pytest.mark.parametrize("mode", ["progressive", "arithmetic_progressive"])
def test_a_damaged_progressive_or_arithmetic_jpeg_raises(mode):
    bad = _bad_script(mode)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).load()
    with pytest.raises(ValueError, match="JPEG"):
        native.jpeg_decode(bad)
    data, _ = _written("arithmetic_progressive" if mode.startswith("arith")
                       else "spectral_selection",
                       np.random.default_rng(13), 16, 16, 90)
    with pytest.raises(ValueError, match="JPEG"):
        native.jpeg_decode(data[:data.index(b"\xff\xda") + 4])
